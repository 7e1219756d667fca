"""The trace reduction on events made by hand: busy and idle time, the
idle gaps by host range, and each kernel op's launches."""

from torch.autograd import DeviceType

from benchlib import readers, trace


class Ev:
    def __init__(self, name, start, end, *, cpu=True, corr=0, link=0,
                 tid=1, shapes=(), annotation=False):
        self._n, self._s, self._e = name, start, end
        self._cpu, self._c, self._l, self._t = cpu, corr, link, tid
        self._shapes, self._a = shapes, annotation

    def device_type(self):
        return DeviceType.CPU if self._cpu else DeviceType.CUDA

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._t

    def shapes(self):
        return self._shapes

    def is_user_annotation(self):
        return self._a


OP = "repro_torch::matmul"


def events():
    s = 10 ** 9   # ns a second
    return [
        Ev(trace.WINDOW, 0, 10 * s, corr=1),
        Ev("ops.call", 0, 4 * s, corr=2),
        Ev("sync", 4 * s, 6 * s, corr=3),
        Ev("client", 6 * s, 10 * s, corr=4),
        Ev(OP, 1 * s, 2 * s, corr=5, shapes=[[64, 32], [32, 16], [], []]),
        Ev("aten::empty", 1 * s, 1 * s + 10, corr=6),
        Ev(OP, 7 * s, 8 * s, corr=7, shapes=[[8, 8], [8, 8], [], []]),
        Ev("aten::copy_", int(7.5 * s), int(7.6 * s), corr=8),
        # kernels: one linked to the op, one to a host event inside the
        # other op, one to nothing we track, and a range's mirror
        Ev("gemm_kernel", 2 * s, 3 * s, cpu=False, link=5),
        Ev("copy_kernel", 8 * s, int(8.5 * s), cpu=False, link=8),
        Ev("gemm_kernel", int(8.5 * s), 9 * s, cpu=False, link=7),
        Ev("memset", -s, int(0.5 * s), cpu=False, link=99),
        Ev("ops.call", 0, 4 * s, cpu=False, annotation=True),
    ]


def test_busy_idle_and_gaps():
    out = trace.reduce_events(events(), (OP,))
    assert out.window_s == 10.0
    # busy: [0, .5] clipped, [2, 3], [8, 9]
    assert abs(out.busy_s - 2.5) < 1e-9
    assert out.device_ops[0] == ["gemm_kernel", 1.5]
    assert ["ops.call", 0.0] not in out.device_ops
    gaps = dict(out.idle_gaps)
    # idle gaps, each by the range at its midpoint: [.5, 2] (ops.call),
    # [3, 8] (5.5: sync), [9, 10] (client)
    assert abs(gaps["ops.call"] - 1.5) < 1e-9
    assert abs(gaps["sync"] - 5.0) < 1e-9
    assert abs(gaps["client"] - 1.0) < 1e-9


def test_launches_follow_links_and_nesting():
    out = trace.reduce_events(events(), (OP,))
    first, second = out.launches[OP]
    assert first.shapes[:2] == [[64, 32], [32, 16]]
    assert abs(first.device_s - 1.0) < 1e-9
    assert first.kernels == {"gemm_kernel"}
    assert abs(second.device_s - 1.0) < 1e-9      # its copy and its gemm
    assert second.kernels == {"copy_kernel", "gemm_kernel"}


def test_roofline_share_of_launches():
    out = trace.reduce_events(events(), (OP,))
    run = type("R", (), {"tracer": type("T", (), {"summary": out})()})()
    from benchlib import counts

    want = 100 * (counts.gemm_least_s(64, 32, 16)
                  + counts.gemm_least_s(8, 8, 8)) / 2.0
    assert abs(readers.roofline_pct(run, OP, readers.gemm_least) - want) \
        < 1e-12
    assert readers.idle_pct(run) == 75.0
    run.tracer.summary = None
    assert readers.roofline_pct(run, OP, readers.gemm_least) is None


def test_a_traced_run_profiles_the_end_of_its_window(monkeypatch):
    from conftest import TINY_BLAS, cpu_run

    assert trace.Tracer(False).head(50.0) == 0.0
    assert trace.Tracer(True).head(50.0) == 50.0 - trace.TRACE_S
    assert trace.Tracer(True).head(trace.TRACE_S / 2) == 0.0
    monkeypatch.setattr(trace, "TRACE_S", 1.5)
    run, res = cpu_run("blas3.paper_100mb", mix=TINY_BLAS, seconds=3.0,
                       trace=True)
    # the profiler takes part of its span to start
    assert res["correct"] and 0.0 < res["device"]["window_s"] < 1.6
