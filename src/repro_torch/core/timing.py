"""Timing backends for install-time data gathering (paper Fig 2, left box).

Two backends:

* ``SimulatedBackend`` — the TPU v5e analytic model (costmodel.py).  The
  default on this CPU-only container; see DESIGN.md §Hardware adaptation.
  Covers every ROUTINES entry (gemm / syrk / trsm / attn).
* ``MeasuredCPUBackend`` — real wall-clock timing of K-blocked numpy
  BLAS-3 routines (plus a KV-chunked causal attention) on the host.  The tunable knob with measurable effect
  on a single CPU core is the K-panel chunk (cache blocking); it
  demonstrates the full ADSALA pipeline against genuine measurements,
  reproducing the paper's install procedure 1:1 (repeat loop, median,
  separate configurations per run).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Protocol

import numpy as np

from repro_torch.core.costmodel import (
    DEFAULT_TILES,
    GemmConfig,
    TPUSpec,
    estimate_batch_terms,
    estimate_routine_time,
    routine_ids,
    ROUTINES,
)

__all__ = ["TimingBackend", "SimulatedBackend", "MeasuredCPUBackend",
           "time_gemm_grid", "time_routine_grid", "time_routine_cells",
           "describe_backend", "backend_from_dict"]


class TimingBackend(Protocol):
    def time_gemm(self, m: int, k: int, n: int, cfg: GemmConfig) -> float:
        """One timed GEMM execution (seconds)."""
        ...


def time_routine_grid(backend: "TimingBackend", dims: np.ndarray,
                      cfgs: list[GemmConfig], repeats: int, *,
                      routines=None) -> np.ndarray:
    """Median-of-``repeats`` timing matrix, shape (D, C), for any backend.

    ``routines`` is ``None`` (all gemm), one routine name, or one
    name/id per dim.  Uses the backend's whole-grid batched path when it
    has one (the simulated backend times every (dim x config) cell per
    call); falls back to a scalar per-cell loop for measured backends,
    where each execution is genuinely sequential wall-clock.
    """
    dims = np.asarray(dims, dtype=np.int64)
    rids = routine_ids(routines, len(dims))
    batch = getattr(backend, "time_routine_batch", None)
    if batch is not None:
        reps = np.stack([batch(dims, cfgs, routines=rids)
                         for _ in range(repeats)])
        return np.median(reps, axis=0)
    legacy_batch = getattr(backend, "time_gemm_batch", None)
    if legacy_batch is not None and not rids.any():
        reps = np.stack([legacy_batch(dims, cfgs) for _ in range(repeats)])
        return np.median(reps, axis=0)
    scalar = getattr(backend, "time_routine", None)
    times = np.empty((len(dims), len(cfgs)))
    for i, (m, k, n) in enumerate(dims):
        routine = ROUTINES[int(rids[i])]
        for j, c in enumerate(cfgs):
            if scalar is not None:
                reps = [scalar(int(m), int(k), int(n), c, routine=routine)
                        for _ in range(repeats)]
            elif routine == "gemm":
                reps = [backend.time_gemm(int(m), int(k), int(n), c)
                        for _ in range(repeats)]
            else:
                raise TypeError(
                    f"backend {type(backend).__name__} cannot time "
                    f"routine {routine!r}: it has neither "
                    "time_routine(_batch) nor a gemm-only grid")
            times[i, j] = float(np.median(reps))
    return times


def time_routine_cells(backend: "TimingBackend", dims: np.ndarray,
                       cfgs: list[GemmConfig], mask: np.ndarray,
                       repeats: int, *, routines=None) -> np.ndarray:
    """Median-of-``repeats`` timing of only the ``mask``-selected
    (dim, config) cells; the rest of the (D, C) matrix is +inf.

    The sparse counterpart of :func:`time_routine_grid` for budgeted
    installs: a beam search has already decided which cells are worth
    measuring, so a backend with a batched path gets one per-dim batch
    over that dim's selected columns per repeat, and scalar backends
    loop only the selected cells — timing cost scales with
    ``mask.sum()``, not ``D * C``.
    """
    dims = np.asarray(dims, dtype=np.int64)
    rids = routine_ids(routines, len(dims))
    mask = np.asarray(mask, dtype=bool)
    if mask.shape != (len(dims), len(cfgs)):
        raise ValueError(f"mask shape {mask.shape} != "
                         f"({len(dims)}, {len(cfgs)})")
    times = np.full((len(dims), len(cfgs)), np.inf)
    batch = getattr(backend, "time_routine_batch", None)
    scalar = getattr(backend, "time_routine", None)
    for i, (m, k, n) in enumerate(dims):
        js = np.flatnonzero(mask[i])
        if not len(js):
            continue
        if batch is not None:
            sub = [cfgs[j] for j in js]
            reps = np.stack([batch(dims[i:i + 1], sub,
                                   routines=rids[i:i + 1])[0]
                             for _ in range(repeats)])
            times[i, js] = np.median(reps, axis=0)
            continue
        routine = ROUTINES[int(rids[i])]
        for j in js:
            if scalar is not None:
                reps = [scalar(int(m), int(k), int(n), cfgs[j],
                               routine=routine) for _ in range(repeats)]
            elif routine == "gemm":
                reps = [backend.time_gemm(int(m), int(k), int(n), cfgs[j])
                        for _ in range(repeats)]
            else:
                raise TypeError(
                    f"backend {type(backend).__name__} cannot time "
                    f"routine {routine!r}: it has neither "
                    "time_routine(_batch) nor a gemm-only grid")
            times[i, j] = float(np.median(reps))
    return times


def time_gemm_grid(backend: "TimingBackend", dims: np.ndarray,
                   cfgs: list[GemmConfig], repeats: int) -> np.ndarray:
    """GEMM-only grid timing (the pre-routine API, kept for callers that
    never mix routines)."""
    return time_routine_grid(backend, dims, cfgs, repeats, routines=None)


@dataclasses.dataclass
class SimulatedBackend:
    """Analytic TPU model with measurement noise."""

    spec: TPUSpec = dataclasses.field(default_factory=TPUSpec)
    dtype_bytes: int = 2
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    # -- routine-aware API -------------------------------------------------
    def time_routine(self, m: int, k: int, n: int, cfg: GemmConfig, *,
                     routine: str = "gemm") -> float:
        return estimate_routine_time(m, k, n, cfg, self.spec,
                                     routine=routine,
                                     dtype_bytes=self.dtype_bytes,
                                     rng=self._rng).total_s

    def time_routine_batch(self, dims: np.ndarray,
                           cfgs: list[GemmConfig], *,
                           routines=None) -> np.ndarray:
        """One noisy timing of every (dim x config) cell, shape (D, C).

        A single vectorised pass over the grid — the batched analogue of
        calling :meth:`time_routine` D*C times, drawing noise from the
        same backend stream.  Rows may mix routines.
        """
        return estimate_batch_terms(dims, cfgs, self.spec,
                                    dtype_bytes=self.dtype_bytes,
                                    rng=self._rng,
                                    routines=routines).total_s

    def time_routine_clean(self, m: int, k: int, n: int, cfg: GemmConfig,
                           *, routine: str = "gemm") -> float:
        """Noise-free ground truth (used by benchmarks for ideal speedup)."""
        return estimate_routine_time(m, k, n, cfg, self.spec,
                                     routine=routine,
                                     dtype_bytes=self.dtype_bytes).total_s

    def time_routine_clean_batch(self, dims: np.ndarray,
                                 cfgs: list[GemmConfig], *,
                                 routines=None) -> np.ndarray:
        """Noise-free (D, C) ground-truth grid."""
        return estimate_batch_terms(dims, cfgs, self.spec,
                                    dtype_bytes=self.dtype_bytes,
                                    routines=routines).total_s

    # -- GEMM-only wrappers (pre-routine API) ------------------------------
    def time_gemm(self, m: int, k: int, n: int, cfg: GemmConfig) -> float:
        return self.time_routine(m, k, n, cfg, routine="gemm")

    def time_gemm_batch(self, dims: np.ndarray,
                        cfgs: list[GemmConfig]) -> np.ndarray:
        return self.time_routine_batch(dims, cfgs, routines=None)

    def time_gemm_clean(self, m: int, k: int, n: int,
                        cfg: GemmConfig) -> float:
        return self.time_routine_clean(m, k, n, cfg, routine="gemm")

    def time_gemm_clean_batch(self, dims: np.ndarray,
                              cfgs: list[GemmConfig]) -> np.ndarray:
        return self.time_routine_clean_batch(dims, cfgs, routines=None)


@dataclasses.dataclass
class MeasuredCPUBackend:
    """Wall-clock timing of blocked numpy BLAS-3 routines on the host CPU.

    cfg.tile (bm, bk) selects the M/K panel sizes of an explicitly
    blocked routine — the single-core analogue of cache-blocking
    parameters.  cfg.n_chips is ignored (one physical core in the
    container); the candidate set used with this backend holds
    n_chips=1.

    ``repeats``/``warmup`` harden every sample against timing noise on
    shared boxes: each :meth:`time_routine` call runs ``warmup``
    untimed executions (operand/page cache warm, BLAS thread spin-up)
    and returns the **median** of ``repeats`` timed ones.  The
    defaults keep the historical single-execution behaviour; measured
    installs and transfer-calibration samples should raise ``repeats``
    (the grid-level repeat loop in :func:`time_routine_grid` then
    medians *those* medians).
    """

    max_dim: int = 2048
    seed: int = 0
    #: timed executions per sample (median taken); 1 = one raw timing
    repeats: int = 1
    #: untimed executions before the timed ones
    warmup: int = 1

    def __post_init__(self) -> None:
        if self.repeats < 1:
            raise ValueError(f"repeats={self.repeats} < 1")
        if self.warmup < 0:
            raise ValueError(f"warmup={self.warmup} < 0")
        self._rng = np.random.default_rng(self.seed)
        self._buffers: dict[tuple[int, int], np.ndarray] = {}

    def _operand(self, r: int, c: int) -> np.ndarray:
        key = (r, c)
        if key not in self._buffers:
            self._buffers[key] = self._rng.standard_normal(
                (r, c)).astype(np.float32)
        return self._buffers[key]

    def _triangular(self, d: int) -> np.ndarray:
        """Well-conditioned lower-triangular operand for TRSM."""
        key = (-d, d)
        if key not in self._buffers:
            a = np.tril(self._rng.standard_normal((d, d))).astype(
                np.float32)
            np.fill_diagonal(a, np.abs(np.diag(a)) + float(d))
            self._buffers[key] = a
        return self._buffers[key]

    def time_routine(self, m: int, k: int, n: int, cfg: GemmConfig, *,
                     routine: str = "gemm") -> float:
        """Median of ``repeats`` timed executions after ``warmup``
        untimed ones (noise hardening for shared CI boxes)."""
        for _ in range(self.warmup):
            self._run_once(m, k, n, cfg, routine)
        if self.repeats == 1:
            return self._run_once(m, k, n, cfg, routine)
        return float(np.median([self._run_once(m, k, n, cfg, routine)
                                for _ in range(self.repeats)]))

    def _run_once(self, m: int, k: int, n: int, cfg: GemmConfig,
                  routine: str) -> float:
        m, k, n = (min(d, self.max_dim) for d in (m, k, n))
        bk = max(8, min(cfg.tile[1], k))
        if routine == "gemm":
            bm = max(8, min(cfg.tile[0], m))
            a, b = self._operand(m, k), self._operand(k, n)
            t0 = time.perf_counter()
            c = np.zeros((m, n), dtype=np.float32)
            for m0 in range(0, m, bm):
                am = a[m0:m0 + bm]
                for k0 in range(0, k, bk):
                    c[m0:m0 + bm] += am[:, k0:k0 + bk] @ b[k0:k0 + bk, :]
            dt = time.perf_counter() - t0
        elif routine == "syrk":
            a = self._operand(m, k)
            t0 = time.perf_counter()
            c = np.zeros((m, m), dtype=np.float32)
            for k0 in range(0, k, bk):
                panel = a[:, k0:k0 + bk]
                c += panel @ panel.T
            c = np.tril(c)
            dt = time.perf_counter() - t0
        elif routine == "trsm":
            # blocked forward substitution L X = B, panel size bk along M
            bm = max(8, min(cfg.tile[1], m))
            ell = self._triangular(m)
            b = self._operand(m, n)
            t0 = time.perf_counter()
            x = b.copy()
            for i0 in range(0, m, bm):
                i1 = min(i0 + bm, m)
                if i0:
                    x[i0:i1] -= ell[i0:i1, :i0] @ x[:i0]
                x[i0:i1] = np.linalg.solve(ell[i0:i1, i0:i1], x[i0:i1])
            dt = time.perf_counter() - t0
            c = x
        elif routine == "attn":
            # causal single-head attention on (Sq=m, Dh=k, Skv=n): the
            # config's flash_bkv chunks the KV axis (cache blocking);
            # its tri grid stops each row's chunk loop at the diagonal
            bkv = max(8, min(cfg.flash_block[1], n))
            q = self._operand(m, k)
            kv = self._operand(n, k)
            v = self._operand(n, k + 1)[:, :k]
            tri = cfg.flash_grid != "dense"
            t0 = time.perf_counter()
            c = np.zeros((m, k), dtype=np.float32)
            qi = np.arange(m, dtype=np.int64)[:, None]
            num = np.zeros((m, k), dtype=np.float32)
            den = np.zeros((m, 1), dtype=np.float32)
            for n0 in range(0, n, bkv):
                n1 = min(n0 + bkv, n)
                rows = slice(0, m)
                if tri and n0 > 0:
                    first = int(np.searchsorted(qi[:, 0], n0))
                    if first >= m:
                        break
                    rows = slice(first, m)
                s = q[rows] @ kv[n0:n1].T
                # finite mask value: a fully-masked row (dense grid,
                # chunk past the diagonal) stays NaN-free garbage that
                # costs the same FLOPs instead of warning on inf - inf
                s = np.where(qi[rows] >= np.arange(n0, n1)[None, :],
                             s, np.float32(-1e30))
                p = np.exp(s - s.max(axis=1, keepdims=True))
                num[rows] += p @ v[n0:n1]
                den[rows] += p.sum(axis=1, keepdims=True)
            c = num / np.maximum(den, 1e-30)
            dt = time.perf_counter() - t0
        else:
            raise ValueError(f"unknown routine {routine!r}")
        del c
        return dt

    def time_gemm(self, m: int, k: int, n: int, cfg: GemmConfig) -> float:
        return self.time_routine(m, k, n, cfg, routine="gemm")


# port-only begin: the device counterpart of MeasuredCPUBackend
__all__ += ["MeasuredCUDABackend", "attn_timing_heads"]

#: bytes written before every timed run to evict the H100's 50 MB L2
L2_FLUSH_BYTES = 64 * 2**20


def attn_timing_heads(head_dim: int) -> tuple[int, int]:
    """(batch-heads, kernel head dim) an ``attn`` row of head dim
    ``head_dim`` is timed at on the card.

    The installer samples an attn row's head dim (k) freely; the flash
    kernel takes the dims of ``SUPPORTED_HEAD_DIMS``.  A row at a dim
    the kernel lacks is timed at the smallest kernel dim above it
    (zero-padding a head dim leaves attention's result unchanged, and
    is what a call at that dim would cost); above the largest, it is
    timed as ceil(k / largest) heads of the largest dim, the same
    products over the same (Sq, Skv) pairs.  Every attn row is timed
    on the kernel; none is refused or sent to a plain version."""
    from repro_torch.kernels.flash_attention import SUPPORTED_HEAD_DIMS

    k = max(int(head_dim), 1)
    for d in sorted(SUPPORTED_HEAD_DIMS):
        if k <= d:
            return 1, d
    top = max(SUPPORTED_HEAD_DIMS)
    return -(-k // top), top


@dataclasses.dataclass
class MeasuredCUDABackend:
    """CUDA-event timing of the port's own BLAS-3 kernels on the card.

    Each sample runs :mod:`repro_torch.kernels.ops` on the CUDA backend
    with the config's explicit tile (``cfg.tile``; ``cfg.flash_block``
    and ``cfg.flash_grid`` for attn): ``warmup`` untimed executions,
    then the **median** of ``repeats`` timed ones, each between a pair
    of CUDA events after the L2 cache was flushed.  The time includes
    the host's work between the events, so a TRSM's panel loop is
    charged as its caller would see it.  cfg.n_chips and cfg.partition
    are ignored (one card; the candidate set used with this backend
    holds n_chips=1), as :class:`MeasuredCPUBackend` ignores them.

    Operands are fp32 views into one pool on the card, filled from a
    ``torch.Generator`` seeded with ``seed`` and regrown only when a
    sample needs more, so memory holds one sample's operands however
    many shapes are timed.  TRSM solves against a well-conditioned
    lower-triangular operand (|diag| + m).  ``attn`` times causal flash
    attention on (Sq=m, Dh=k, Skv=n) on the kernel, at the head dims
    :func:`attn_timing_heads` gives: the installer samples Dh freely,
    the kernel takes a few.  Dims are clamped at ``max_dim``.

    Every timing call runs on the backend's own CUDA stream, after that
    stream waited for the work already queued on the caller's current
    stream, and waits for its own last event only: a server queueing
    work on the card meanwhile (a background re-install beside serving)
    neither enters the reading nor is waited for, and no autograd state
    is built (the calls run under ``torch.inference_mode``, which is
    per thread).

    Building the object needs no card; the first timing call raises
    ``RuntimeError`` without one.  There is no CPU fallback.
    """

    max_dim: int = 65536
    seed: int = 0
    #: timed executions per sample (median taken)
    repeats: int = 1
    #: untimed executions before the timed ones
    warmup: int = 1

    def __post_init__(self) -> None:
        if self.repeats < 1:
            raise ValueError(f"repeats={self.repeats} < 1")
        if self.warmup < 0:
            raise ValueError(f"warmup={self.warmup} < 0")
        self._gen = None
        self._pool = None
        self._flush = None
        self._tri = None              # (m, lower-triangular operand)
        self._stream = None           # the backend's own CUDA stream

    @staticmethod
    def _torch():
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "MeasuredCUDABackend needs a CUDA device: it times the "
                "port's kernels on the card and has no CPU fallback")
        return torch

    def _views(self, *shapes: tuple[int, int]) -> list:
        torch = self._torch()
        need = sum(r * c for r, c in shapes)
        if self._pool is None or self._pool.numel() < need:
            if self._gen is None:
                self._gen = torch.Generator(device="cuda")
                self._gen.manual_seed(self.seed)
            self._pool = self._tri = None
            self._pool = torch.randn(need, generator=self._gen,
                                     device="cuda")
        views, off = [], 0
        for r, c in shapes:
            views.append(self._pool[off:off + r * c].view(r, c))
            off += r * c
        return views

    def _run(self, m: int, k: int, n: int, cfg: GemmConfig,
             routine: str):
        """A closure that runs the routine once on pooled operands."""
        from repro_torch.kernels import ops

        tile = cfg.tile
        if routine == "gemm":
            a, b = self._views((m, k), (k, n))
            return lambda: ops.matmul(a, b, tile=tile, backend="cuda")
        if routine == "syrk":
            a, = self._views((m, k))
            return lambda: ops.syrk(a, tile=tile, backend="cuda")
        if routine == "trsm":
            src, b = self._views((m, m), (m, n))
            if self._tri is None or self._tri[0] != m:
                ell = self._torch().tril(src)
                diag = ell.diagonal()
                diag.copy_(diag.abs() + float(m))
                self._tri = (m, ell)
            ell = self._tri[1]
            return lambda: ops.trsm(ell, b, tile=tile, backend="cuda")
        if routine == "attn":
            bh, d = attn_timing_heads(k)
            q, kk, v = (t.view(bh, -1, d) for t in self._views(
                (bh * m, d), (bh * n, d), (bh * n, d)))
            bq, bkv = cfg.flash_block
            return lambda: ops.flash_attention(
                q, kk, v, causal=True, bq=bq, bkv=bkv,
                grid=cfg.flash_grid, backend="cuda")
        raise ValueError(f"unknown routine {routine!r}")

    def time_routine(self, m: int, k: int, n: int, cfg: GemmConfig, *,
                     routine: str = "gemm") -> float:
        """Median of ``repeats`` timed executions (seconds) after
        ``warmup`` untimed ones, the L2 flushed before each timed one."""
        torch = self._torch()
        m, k, n = (min(int(d), self.max_dim) for d in (m, k, n))
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream())
        events = []
        with torch.inference_mode(), torch.cuda.stream(stream):
            run = self._run(m, k, n, cfg, routine)
            for _ in range(self.warmup):
                run()
            if self._flush is None:
                self._flush = torch.empty(L2_FLUSH_BYTES // 4,
                                          device="cuda")
            for _ in range(self.repeats):
                self._flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                run()
                end.record(stream)
                events.append((start, end))
        events[-1][1].synchronize()     # in stream order: all are done
        return float(np.median([s.elapsed_time(e) for s, e in events])) \
            * 1e-3

    def time_gemm(self, m: int, k: int, n: int, cfg: GemmConfig) -> float:
        return self.time_routine(m, k, n, cfg, routine="gemm")
# port-only end


# ---------------------------------------------------------------------------
# backend provenance (per-arch artifact registry)
# ---------------------------------------------------------------------------
#
# Artifacts record WHICH backend timed their grid ("backend" block in
# config.json, written by installer.install) so the serving re-install
# loop can rebuild the same kind of backend — a measured install must
# re-install measured, not silently fall back to the simulator.

def describe_backend(backend: Any) -> dict:
    """JSON-able description of a timing backend (round-trips through
    :func:`backend_from_dict` for the built-in kinds).  Backends outside
    this module can implement ``describe() -> dict``; anything else
    degrades to a kind-only record that cannot be reconstructed."""
    if isinstance(backend, SimulatedBackend):
        return {"kind": "simulated", "seed": backend.seed,
                "dtype_bytes": backend.dtype_bytes,
                "spec": dataclasses.asdict(backend.spec)}
    if isinstance(backend, MeasuredCPUBackend):
        return {"kind": "measured-cpu", "max_dim": backend.max_dim,
                "seed": backend.seed, "repeats": backend.repeats,
                "warmup": backend.warmup}
    # port-only begin
    if isinstance(backend, MeasuredCUDABackend):
        return {"kind": "measured-cuda", "max_dim": backend.max_dim,
                "seed": backend.seed, "repeats": backend.repeats,
                "warmup": backend.warmup}
    # port-only end
    describe = getattr(backend, "describe", None)
    if callable(describe):
        return dict(describe())
    return {"kind": type(backend).__name__}


def backend_from_dict(d: dict) -> "TimingBackend":
    """Reconstruct a timing backend from its persisted description.
    Raises ``ValueError`` for kinds this process cannot rebuild (the
    caller decides whether to fall back or refuse)."""
    kind = d.get("kind")
    if kind == "simulated":
        spec = TPUSpec(**d["spec"]) if d.get("spec") else TPUSpec()
        return SimulatedBackend(spec=spec,
                                dtype_bytes=int(d.get("dtype_bytes", 2)),
                                seed=int(d.get("seed", 0)))
    if kind == "measured-cpu":
        return MeasuredCPUBackend(max_dim=int(d.get("max_dim", 2048)),
                                  seed=int(d.get("seed", 0)),
                                  repeats=int(d.get("repeats", 1)),
                                  warmup=int(d.get("warmup", 1)))
    # port-only begin
    if kind == "measured-cuda":
        return MeasuredCUDABackend(max_dim=int(d.get("max_dim", 65536)),
                                   seed=int(d.get("seed", 0)),
                                   repeats=int(d.get("repeats", 1)),
                                   warmup=int(d.get("warmup", 1)))
    # port-only end
    raise ValueError(
        f"cannot reconstruct a timing backend of kind {kind!r} — "
        "pass one explicitly (backend=...)")
