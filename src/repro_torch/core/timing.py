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
    raise ValueError(
        f"cannot reconstruct a timing backend of kind {kind!r} — "
        "pass one explicitly (backend=...)")
