"""The traced run: ``torch.profiler`` over the measured window, reduced
in memory to what the per-layer readers and the result's breakdown
need.  Nothing is written to disk.

The benchmark opens its own host ranges around what the host does
(:data:`HOST_RANGES`); the window itself is the range
:data:`WINDOW`.  Device time comes from the profiler's device events
(kernels, copies, sets) clipped to the window; the device is busy
where any of them runs.  A launch of one of the program's kernel ops
(``repro_torch::matmul``, ``repro_torch::grouped_matmul``, ...) is the
op's host event with its input shapes and the device events linked to
it, or to a host event inside it on its thread."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import sys
import time

#: the benchmark's host ranges that label the device's idle gaps
HOST_RANGES = ("sched.step", "client", "ops.call", "sync")
#: the host range that spans the measured window
WINDOW = "bench.window"
#: entries of each list in the result's breakdown
TOP = 10
#: seconds at the end of the window a traced run profiles: the
#: profiler's own processing grows with the events (about 5 million in
#: 50 s of mixtral's decode loop, over 150 s to process), and a run has
#: 360 s in all; it runs once the window has closed
TRACE_S = 20.0


@dataclasses.dataclass
class Launch:
    """One call of a kernel op inside the window: its input shapes and
    the device seconds of the device events it launched."""

    shapes: list
    device_s: float
    kernels: set


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: list          # [[name, seconds]], most time first
    idle_gaps: list           # [[host range, seconds]], most first
    launches: dict            # op name -> [Launch]
    events: int


class Tracer:
    """Host ranges and the profiled window, or nothing at all when off
    (the untraced runs pay no range and no profiler)."""

    def __init__(self, on: bool, ops: tuple[str, ...] = ()):
        self.on = on
        self.ops = ops
        self.summary: Summary | None = None

    def head(self, seconds: float) -> float:
        """The seconds at the start of a window of ``seconds`` that this
        run does not profile (all but the last TRACE_S; none untraced)."""
        return max(0.0, seconds - TRACE_S) if self.on else 0.0

    def range(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        """Profile the body (the end of the measured window); reduce on
        exit."""
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts, record_shapes=True)
        prof.__enter__()
        try:
            with torch.profiler.record_function(WINDOW):
                yield
                if cuda:
                    torch.cuda.synchronize()
        finally:
            prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        self.summary = reduce_events(prof.profiler.kineto_results.events(),
                                     self.ops)
        del prof
        print(f"[bench] trace: {self.summary.events} events reduced in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(events, ops: tuple[str, ...] = ()) -> Summary:
    """Reduce the profiler's raw events (``kineto_results.events()``)."""
    from torch.autograd import DeviceType

    window = None
    ranges: list[tuple[int, int, str]] = []
    op_events: dict[int, tuple[str, int, int, int, list]] = {}
    cpu_at: dict[int, tuple[int, int]] = {}
    device: list[tuple[int, int, str, int]] = []
    n = 0
    for ev in events:
        n += 1
        if ev.device_type() == DeviceType.CPU:
            name = ev.name()
            start, end = ev.start_ns(), ev.end_ns()
            corr = ev.correlation_id()
            tid = ev.start_thread_id()
            if not name.startswith("cu"):     # runtime calls: CUPTI ids
                cpu_at[corr] = (tid, start)
            if name == WINDOW:
                window = (start, end)
            elif name in HOST_RANGES:
                ranges.append((start, end, name))
            elif name in ops:
                op_events[corr] = (name, tid, start, end,
                                   [list(s) for s in ev.shapes()])
        elif not ev.is_user_annotation():
            # device events; a host range's mirror on the device
            # timeline is a user annotation, no device work
            device.append((ev.start_ns(), ev.end_ns(), ev.name(),
                           ev.linked_correlation_id()))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    w0, w1 = window

    clipped = [(max(s, w0), min(e, w1), name)
               for s, e, name, _ in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in clipped])
    by_name: dict[str, float] = {}
    for s, e, name in clipped:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9

    # idle gaps, each labelled by the host range around its midpoint
    # (the benchmark's ranges follow one another, none nests)
    ranges.sort()
    starts = [r[0] for r in ranges]
    idle: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = ranges[i][2] if i >= 0 and mid < ranges[i][1] else "other"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-9

    # launches: device events linked to the op or to a host event that
    # started inside the op on the same thread
    by_tid: dict[int, list[tuple[int, int, int]]] = {}
    for corr, (_, tid, s, e, _) in op_events.items():
        by_tid.setdefault(tid, []).append((s, e, corr))
    for v in by_tid.values():
        v.sort()
    tid_starts = {t: [x[0] for x in v] for t, v in by_tid.items()}
    acc: dict[int, Launch] = {}
    for s, e, name, link in device:
        corr = link if link in op_events else None
        if corr is None and link in cpu_at:
            tid, at = cpu_at[link]
            v = by_tid.get(tid)
            if v:
                i = bisect.bisect_right(tid_starts[tid], at) - 1
                if i >= 0 and v[i][0] <= at <= v[i][1]:
                    corr = v[i][2]
        if corr is None:
            continue
        lo = acc.get(corr)
        if lo is None:
            lo = acc[corr] = Launch(op_events[corr][4], 0.0, set())
        lo.device_s += (e - s) * 1e-9
        lo.kernels.add(name)
    launches: dict[str, list[Launch]] = {name: [] for name in ops}
    for corr, (name, _, s, _, _) in sorted(op_events.items(),
                                           key=lambda kv: kv[1][2]):
        if w0 <= s <= w1 and corr in acc:
            launches[name].append(acc[corr])

    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        device_ops=[[k, v] for k, v in top_ops],
        idle_gaps=[[k, v] for k, v in top_idle],
        launches=launches, events=n)
