"""Tuned kernel dispatch + ADSALA tuner integration.

``matmul`` / ``syrk`` / ``trsm`` (the paper's BLAS-3 loop) and
``flash_attention`` are the entry points; the ``observe`` /
``dispatch_hint`` sites report the plain contractions the model layers
leave to ``torch.matmul``.  Backend selection:

  * ``cuda``  — the hand-written Hopper kernels; a CPU tensor raises;
  * ``torch`` — the kernels' plain PyTorch versions, on any device;
  * ``auto``  — ``ADSALA_BACKEND`` when set (``cuda`` or ``torch``,
    anything else raises), else the tensor's device: CUDA tensors take
    the kernel, CPU tensors the plain version.

When an :class:`~repro_torch.core.tuner.AdsalaTuner` is supplied, the
call's (routine, m, k, n) is looked up per call (memoised inside the
tuner) and the chosen worker configuration supplies the GEMM tile, or
the flash blocks and KV grid.  An explicit ``tile`` (or flash knob)
skips the tuner.  Every entry point reports its dispatch — the
*resolved* routine, shape, chosen config and whether the tuner served
it from cache — to any active :class:`~repro_torch.kernels.recorder.
DispatchRecorder`, exactly as the reference does; a routine the
artifact carries no signal for falls back to gemm.
"""

from __future__ import annotations

import os
from typing import Literal

import torch

from repro_torch.core.costmodel import (
    DEFAULT_ROUTINE,
    DEFAULT_TILES,
    ROUTINES,
    GemmConfig,
)
from repro_torch.core.tuner import AdsalaTuner
from repro_torch.kernels import recorder
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_torch,
)
from repro_torch.kernels.matmul import (
    check_gemm_shapes,
    matmul_cuda,
    matmul_torch,
)

__all__ = ["matmul", "syrk", "trsm", "flash_attention", "dispatch_hint",
           "observe", "resolve_backend", "supported_routine"]

Backend = Literal["auto", "cuda", "torch"]

_BACKENDS = ("auto", "cuda", "torch")


def resolve_backend(backend: Backend = "auto",
                    device: torch.device | None = None) -> str:
    """``cuda`` or ``torch`` for a call on tensors living on ``device``."""
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {_BACKENDS}")
    if backend == "auto":
        env = os.environ.get("ADSALA_BACKEND")
        if env:
            if env not in ("cuda", "torch"):
                raise ValueError(
                    f"ADSALA_BACKEND={env!r}; expected 'cuda' or 'torch'")
            backend = env
        else:
            backend = ("cuda" if device is not None
                       and device.type == "cuda" else "torch")
    if backend == "cuda" and (device is None or device.type != "cuda"):
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {device}")
    return backend


def supported_routine(routine: str, tuner: AdsalaTuner | None) -> str:
    """The routine a call site can actually dispatch.

    Validates the name against :data:`ROUTINES` (unknown strings raise
    here, at the ops boundary, with the full expected set), then falls
    back to the explicit gemm :data:`DEFAULT_ROUTINE` when the tuner's
    artifact was installed without ``routine``.
    """
    if routine not in ROUTINES:
        raise ValueError(
            f"unknown routine {routine!r}; expected one of {ROUTINES}")
    if tuner is not None and routine not in tuner.routines:
        return DEFAULT_ROUTINE
    return routine


def _select(m: int, k: int, n: int, routine: str,
            tuner: AdsalaTuner | None, *, need_config: bool
            ) -> tuple[str, GemmConfig | None, bool]:
    """(resolved routine, tuner config | None, cache_hit) for one call.

    The tuner is consulted when the kernel needs a config
    (``need_config``) or a recorder wants the chosen config on the
    event; otherwise the lookup is skipped so untuned dispatch stays
    free.
    """
    routine = supported_routine(routine, tuner)
    if tuner is None or not (need_config or recorder.active()):
        return routine, None, False
    hit = tuner.peek(m, k, n, routine)
    return routine, tuner.select(m, k, n, routine), hit


def dispatch_hint(m: int, k: int, n: int,
                  tuner: AdsalaTuner | None,
                  routine: str = DEFAULT_ROUTINE,
                  site: str = "", count: int = 1) -> GemmConfig | None:
    """Worker configuration the tuner recommends for this call (or None),
    reported to any active DispatchRecorder with the gemm fallback
    applied when the artifact has no signal for ``routine``."""
    routine = supported_routine(routine, tuner)
    cfg, hit = None, False
    if tuner is not None:
        hit = tuner.peek(m, k, n, routine)
        cfg = tuner.select(m, k, n, routine)
    recorder.record(routine, m, k, n, config=cfg, cache_hit=hit,
                    site=site, count=count)
    return cfg


def observe(m: int, k: int, n: int,
            tuner: AdsalaTuner | None,
            routine: str = DEFAULT_ROUTINE,
            site: str = "", count: int = 1) -> None:
    """Observability-only twin of :func:`dispatch_hint`: consults the
    tuner only while a recorder is active, so unwatched dispatch pays
    nothing beyond the routine-name validation."""
    if not recorder.active():
        supported_routine(routine, tuner)   # still fail loudly on typos
        return
    dispatch_hint(m, k, n, tuner, routine, site, count)


def _gemm(be: str):
    return matmul_cuda if be == "cuda" else matmul_torch


def _tile(tile: tuple[int, int, int] | None,
          cfg: GemmConfig | None) -> tuple[int, int, int]:
    return (tile if tile is not None
            else cfg.tile if cfg is not None else DEFAULT_TILES[3])


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           tuner: AdsalaTuner | None = None,
           tile: tuple[int, int, int] | None = None,
           backend: Backend = "auto",
           site: str = "", count: int = 1) -> torch.Tensor:
    """Tuned GEMM C = A @ B: the tuner's tile for (gemm, m, k, n) (or an
    explicit ``tile``, which skips the tuner) drives the kernel."""
    check_gemm_shapes(a, b)
    be = resolve_backend(backend, a.device)
    m, k, n = int(a.shape[0]), int(a.shape[1]), int(b.shape[1])
    # an explicit tile overrides the tuner entirely: don't consult it,
    # and don't label the event with a config that was never dispatched
    rt, cfg, hit = _select(m, k, n, DEFAULT_ROUTINE,
                           tuner if tile is None else None,
                           need_config=True)
    recorder.record(rt, m, k, n, config=cfg, cache_hit=hit, site=site,
                    count=count)
    bm, bk, bn = _tile(tile, cfg)
    return _gemm(be)(a, b, bm=bm, bk=bk, bn=bn)


def syrk(a: torch.Tensor, b: torch.Tensor | None = None, *,
         tuner: AdsalaTuner | None = None,
         tile: tuple[int, int, int] | None = None,
         lower: bool = True,
         backend: Backend = "auto",
         site: str = "", count: int = 1) -> torch.Tensor:
    """Symmetric rank-k update C = tril/triu(A @ Aᵀ), A of shape (m, k).

    With ``b`` (same shape as A) this is the SYRK-*shaped* product
    C = tril/triu(A @ Bᵀ).  The kernel computes the full square in fp32
    from A and a transposed view of B (no copy), then one triangle is
    kept and cast to A's dtype.  Tuner lookups use routine="syrk" on the
    (m, k, m) shape, degrading to gemm on artifacts without syrk signal.
    """
    if a.ndim != 2:
        raise ValueError(f"bad SYRK operand shape {tuple(a.shape)}")
    if b is not None and b.shape != a.shape:
        raise ValueError(
            f"bad SYRK-shaped operands {tuple(a.shape)} x "
            f"{tuple(b.shape)}; B must match A (square output, shared k)")
    m, k = int(a.shape[0]), int(a.shape[1])
    be = resolve_backend(backend, a.device)
    rt, cfg, hit = _select(m, k, m, "syrk",
                           tuner if tile is None else None,
                           need_config=True)
    recorder.record(rt, m, k, m, config=cfg, cache_hit=hit, site=site,
                    count=count)
    bm, bk, bn = _tile(tile, cfg)
    c = _gemm(be)(a, (a if b is None else b).T, bm=bm, bk=bk, bn=bn,
                  out_dtype=torch.float32)
    c = torch.tril(c) if lower else torch.triu(c)
    return c.to(a.dtype)


def trsm(a: torch.Tensor, b: torch.Tensor, *,
         tuner: AdsalaTuner | None = None,
         tile: tuple[int, int, int] | None = None,
         lower: bool = True,
         unit_diag: bool = False,
         backend: Backend = "auto",
         site: str = "", count: int = 1) -> torch.Tensor:
    """Triangular solve A X = B (A (m, m) triangular, B (m, n)).

    A blocked substitution, as in the reference: row panels of ``bm``
    (from the tuned tile) retire in order; each one subtracts the
    already-solved prefix (suffix when ``upper``) with one tuned GEMM
    over the concatenated panels, then solves its diagonal block with
    ``torch.linalg.solve_triangular``.  So the GEMM launches once per
    panel after the first.  Tuner lookups use routine="trsm" on the
    (m, m, n) shape, degrading to gemm on artifacts without trsm signal.
    """
    if a.ndim != 2 or a.shape[0] != a.shape[1] or b.ndim != 2 \
            or b.shape[0] != a.shape[0]:
        raise ValueError(f"bad TRSM shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    m = int(a.shape[0])
    n = int(b.shape[1])
    be = resolve_backend(backend, a.device)
    rt, cfg, hit = _select(m, m, n, "trsm",
                           tuner if tile is None else None,
                           need_config=True)
    recorder.record(rt, m, m, n, config=cfg, cache_hit=hit, site=site,
                    count=count)
    bm, bk, bn = _tile(tile, cfg)
    gemm = _gemm(be)
    a32 = a.float()
    b32 = b.float()
    starts = list(range(0, m, bm))
    if not lower:                 # backward substitution: bottom-up
        starts = starts[::-1]
    blocks: dict[int, torch.Tensor] = {}
    for i0 in starts:
        i1 = min(i0 + bm, m)
        rhs = b32[i0:i1]
        # subtract the already-solved panels' contribution in one tuned
        # GEMM over the concatenated prefix (suffix for upper)
        done = sorted(j0 for j0 in blocks if (j0 < i0 if lower else j0 > i0))
        if done:
            cols = torch.cat(
                [a32[i0:i1, j0:min(j0 + bm, m)] for j0 in done], dim=1)
            solved = torch.cat([blocks[j0] for j0 in done], dim=0)
            rhs = rhs - gemm(cols, solved, bm=bm, bk=bk, bn=bn)
        blocks[i0] = torch.linalg.solve_triangular(
            a32[i0:i1, i0:i1], rhs, upper=not lower, left=True,
            unitriangular=unit_diag)
    x = torch.cat([blocks[i0] for i0 in sorted(blocks)], dim=0)
    return x.to(b.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    sm_scale: float | None = None,
                    bq: int | None = None, bkv: int | None = None,
                    grid: str | None = None,
                    tuner: AdsalaTuner | None = None,
                    backend: Backend = "auto",
                    site: str = "attn.core",
                    count: int | None = None) -> torch.Tensor:
    """Tuned attention: softmax(q kᵀ, causal/windowed) v on (BH, S, D).

    Masked (causal or windowed) attention dispatches as routine="attn"
    on the per-head (Sq, Dh, Skv) triple with ``count`` (default BH)
    multiplicity; non-causal unwindowed attention keeps the gemm
    identity.  The tuner's chosen :class:`GemmConfig` supplies the
    flash blocks (``flash_block``) and the KV walk (``flash_grid``:
    dense vs block-sparse triangular).  Explicit ``bq``/``bkv``/``grid``
    overrides skip the tuner entirely.  One attn/gemm event carrying the
    resolved config is reported to any active DispatchRecorder.

    The reference's XLA-only SYRK-scores and chunked paths are not part
    of this port: both backends here run the flash function.
    """
    if q.ndim != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"bad attention shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)}")
    be = resolve_backend(backend, q.device)
    bh, sq, d = (int(s) for s in q.shape)
    skv = int(k.shape[1])
    count = bh if count is None else count
    masked = causal or window is not None
    explicit = bq is not None or bkv is not None or grid is not None
    rt = supported_routine("attn" if masked else DEFAULT_ROUTINE,
                           None if explicit else tuner)
    cfg, hit = None, False
    if tuner is not None and not explicit:
        hit = tuner.peek(sq, d, skv, rt)
        cfg = tuner.select(sq, d, skv, rt)
    if cfg is not None and rt == "attn":
        fbq, fbkv = cfg.flash_block
        fgrid = cfg.flash_grid
    else:
        # untuned defaults: under a causal/window mask the block-sparse
        # walk only drops all-masked tiles; without a mask the two walks
        # visit the same tile list anyway
        fbq, fbkv, fgrid = 512, 512, ("tri" if masked else "dense")
    bq = bq if bq is not None else fbq
    bkv = bkv if bkv is not None else fbkv
    grid = grid if grid is not None else fgrid
    recorder.record(rt, sq, d, skv, config=cfg, cache_hit=hit,
                    site=site, count=count)
    fn = flash_attention_cuda if be == "cuda" else flash_attention_torch
    return fn(q, k, v, bq=bq, bkv=bkv, causal=causal, window=window,
              sm_scale=sm_scale, grid=grid)
