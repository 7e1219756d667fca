"""Dispatch observability: which BLAS-3 routine did each contraction use?

``DispatchRecorder`` is a context manager backed by a thread-local
registry.  While one is active, every routine-aware call site —
:func:`repro.kernels.ops.matmul` / ``syrk`` / ``trsm`` /
``grouped_matmul`` and the ``dispatch_hint`` family — reports a
:class:`DispatchEvent` carrying ``(routine, m, k, n, chosen_config,
cache_hit, site)``.  The reporting path is compiled into the ops
permanently: when no recorder is active, :func:`record` is a two-lookup
no-op, cheap enough to leave on the serving hot path.

Semantics worth knowing:

* **Trace-time recording.**  Under ``jit`` / ``lax.scan`` / ``vmap`` the
  call sites run once at trace time, so a recorder sees one event per
  call site per compilation — the dispatch *decision* (which is made on
  static shapes anyway), not the per-step execution count.  Eager calls
  record once per call; a scanned layer stack records once per unit
  layer.
* **Nesting.**  Recorders stack: an event reaches every recorder active
  on the current thread, so an outer recorder can aggregate a whole run
  while an inner one isolates a single step.
* **Thread isolation.**  The registry is ``threading.local`` — a
  recorder never observes another thread's dispatches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterable

from repro_torch.core.costmodel import ROUTINES
from repro_torch.core.features import ROUTINE_FLOP_SCALE

__all__ = ["DispatchEvent", "DispatchRecorder", "record", "active",
           "active_event_count", "record_backward", "suppressed"]


@dataclasses.dataclass(frozen=True)
class DispatchEvent:
    """One observed contraction dispatch.

    ``config`` is the tuner-chosen worker configuration (``None`` when
    the call ran untuned) and ``cache_hit`` says whether the tuner
    served it from its memo cache without a model evaluation.
    """

    routine: str
    m: int
    k: int
    n: int
    config: Any = None
    cache_hit: bool = False
    site: str = ""
    #: dispatch multiplicity: a vmapped call site traces once but
    #: stands for ``count`` identical contractions (e.g. the per-head
    #: attention score product records count = B*H), so flops and
    #: event-weighted mixes don't under-count batched sites
    count: int = 1

    @property
    def flops(self) -> float:
        """Routine-adjusted flop volume (count * 2mkn per ROUTINES)."""
        scale = ROUTINE_FLOP_SCALE[ROUTINES.index(self.routine)]
        return 2.0 * self.count * self.m * self.k * self.n * scale


_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def active() -> bool:
    """True when at least one recorder is active on this thread."""
    return bool(getattr(_tls, "stack", None))


def record(routine: str, m: int, k: int, n: int, *,
           config: Any = None, cache_hit: bool = False,
           site: str = "", count: int = 1) -> None:
    """Report one dispatch to every active recorder (no-op when none)."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    event = DispatchEvent(routine, int(m), int(k), int(n), config,
                          bool(cache_hit), site, int(count))
    for rec in stack:
        rec.events.append(event)


@contextlib.contextmanager
def suppressed():
    """Hide this thread's active recorders for the block: nothing inside
    is recorded and :func:`active` is False there.

    Activation recomputation (``torch.utils.checkpoint``) replays a
    layer's Python in the backward pass; the replay runs here, so each
    dispatch is recorded once, as the reference's ``jax.checkpoint``
    traces the layer once.
    """
    saved = getattr(_tls, "stack", None)
    _tls.stack = []
    try:
        yield
    finally:
        _tls.stack = saved


def active_event_count() -> int:
    """Events seen so far by the innermost active recorder (0 if none).

    Pair with :func:`record_backward` to bracket a forward pass.
    """
    stack = getattr(_tls, "stack", None)
    return len(stack[-1].events) if stack else 0


def record_backward(since: int = 0, tuner: Any = None) -> None:
    """Tag the backward-pass contractions of a just-traced forward pass.

    For every forward event the innermost recorder collected from index
    ``since`` on, records the two AD-transposed contractions — dX
    ``(m, n, k)`` and dW ``(k, m, n)`` — as ``gemm`` events (the
    adjoint of a triangular product is a general contraction).  When a
    ``tuner`` is given the backward shapes are resolved through it so
    the events carry worker configurations like their forward twins.
    """
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    forward = [e for e in stack[-1].events[since:]
               if not e.site.startswith("bwd")]
    for e in forward:
        for (m, k, n), which in (((e.m, e.n, e.k), "dx"),
                                 ((e.k, e.m, e.n), "dw")):
            cfg, hit = None, False
            if tuner is not None:
                hit = tuner.peek(m, k, n, "gemm")
                cfg = tuner.select(m, k, n, "gemm")
            record("gemm", m, k, n, config=cfg, cache_hit=hit,
                   site=f"bwd.{which}[{e.site or e.routine}]",
                   count=e.count)


class DispatchRecorder:
    """Collects :class:`DispatchEvent`s on this thread while active.

    >>> with DispatchRecorder() as rec:
    ...     model.prefill(params, tokens, ctx)
    >>> rec.routine_mix()
    {'gemm': 0.72, 'syrk': 0.28}
    """

    def __init__(self) -> None:
        self.events: list[DispatchEvent] = []

    # -- context management -------------------------------------------
    def __enter__(self) -> "DispatchRecorder":
        _stack().append(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:                       # out-of-order exit: still detach
            stack.remove(self)

    def clear(self) -> None:
        self.events.clear()

    # -- aggregation ---------------------------------------------------
    def summary(self) -> dict[str, dict[str, float]]:
        """Per-routine totals: traced events, dispatches (count-
        weighted), flops, tuned calls, cache hits."""
        out: dict[str, dict[str, float]] = {}
        for e in self.events:
            row = out.setdefault(e.routine, {
                "events": 0, "dispatches": 0, "flops": 0.0, "tuned": 0,
                "cache_hits": 0})
            row["events"] += 1
            row["dispatches"] += e.count
            row["flops"] += e.flops
            row["tuned"] += e.config is not None
            row["cache_hits"] += e.cache_hit
        return out

    def routine_mix(self, by: str = "flops") -> dict[str, float]:
        """Fraction of dispatch volume per routine (sums to 1).

        ``by="flops"`` weights by routine-adjusted flop volume (the
        default — what the roofline cares about); ``by="events"``
        weights every dispatch equally (count-weighted, so a vmapped
        site traced once still contributes its batch multiplicity).
        """
        if by not in ("flops", "events"):
            raise ValueError(f"by={by!r}; expected 'flops' or 'events'")
        totals: dict[str, float] = {}
        for e in self.events:
            w = e.flops if by == "flops" else float(e.count)
            totals[e.routine] = totals.get(e.routine, 0.0) + w
        denom = sum(totals.values())
        if denom <= 0:
            return {}
        return {r: v / denom for r, v in sorted(totals.items())}

    def assert_only(self, routines: Iterable[str]) -> None:
        """Raise AssertionError if any event used a routine outside
        ``routines`` (the legacy-artifact fallback check)."""
        allowed = set(routines)
        bad = [e for e in self.events if e.routine not in allowed]
        if bad:
            seen = sorted({e.routine for e in bad})
            sites = sorted({e.site for e in bad})[:5]
            raise AssertionError(
                f"recorded routines {seen} outside allowed "
                f"{sorted(allowed)} ({len(bad)} events, e.g. at sites "
                f"{sites})")

    def sites(self, prefix: str = "") -> list[DispatchEvent]:
        """Events whose call-site label starts with ``prefix``."""
        return [e for e in self.events if e.site.startswith(prefix)]

    def shape_table(self) -> list[dict]:
        """Aggregated totals per distinct ``(routine, m, k, n)``, sorted
        by descending flop volume.

        This is the shape-level view a
        :class:`~repro.core.workload.WorkloadProfile` is built from
        (``dispatches`` carries the count-weighted multiplicity), and
        what ``repro.launch.dryrun`` persists per cell so install grids
        can be weighted by recorded workloads offline.
        """
        agg: dict[tuple, dict] = {}
        for e in self.events:
            key = (e.routine, e.m, e.k, e.n)
            row = agg.setdefault(key, {
                "routine": e.routine, "m": e.m, "k": e.k, "n": e.n,
                "events": 0, "dispatches": 0, "flops": 0.0})
            row["events"] += 1
            row["dispatches"] += e.count
            row["flops"] += e.flops
        return sorted(agg.values(), key=lambda r: -r["flops"])
