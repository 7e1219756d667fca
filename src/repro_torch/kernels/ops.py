"""Tuned kernel dispatch + ADSALA tuner integration.

``matmul`` / ``syrk`` / ``trsm`` (the paper's BLAS-3 loop),
``grouped_matmul`` (the MoE expert products) and ``flash_attention``
are the entry points; the ``observe`` / ``dispatch_hint`` /
``grouped_dispatch_hint`` sites report the plain contractions the model
layers leave to ``torch.matmul``.  Backend selection:

  * ``cuda``    — the hand-written Hopper kernels; a CPU tensor raises,
    and so does an input that requires grad (no kernel has a backward);
  * ``torch``   — the kernels' plain PyTorch versions, on any device;
  * ``library`` — the reference's ``xla`` backend: the oracles of
    :mod:`repro_torch.kernels.ref` for the BLAS-3 and grouped
    products, and for attention the reference's XLA paths
    (SYRK-materialised scores or chunked softmax), all differentiable
    by autograd — the training backend;
  * ``auto``    — ``ADSALA_BACKEND`` when set (``cuda``, ``torch`` or
    ``library``, anything else raises), else the tensor's device: CUDA
    tensors take the kernel, CPU tensors the plain version.

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

import numpy as np
import torch

from repro_torch.core.costmodel import (
    DEFAULT_ROUTINE,
    DEFAULT_TILES,
    ROUTINES,
    GemmConfig,
)
from repro_torch.core.tuner import AdsalaTuner
from repro_torch.kernels import _build, recorder, ref
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_torch,
)
from repro_torch.kernels.grouped_matmul import (
    check_grouped_shapes,
    grouped_matmul_cuda,
    grouped_matmul_torch,
)
from repro_torch.kernels.matmul import (
    check_gemm_shapes,
    matmul_cuda,
    matmul_torch,
)

__all__ = ["matmul", "syrk", "trsm", "grouped_matmul", "flash_attention",
           "chunked_attention", "dispatch_hint", "grouped_dispatch_hint",
           "observe", "resolve_backend", "supported_routine", "BACKENDS"]

Backend = Literal["auto", "cuda", "torch", "library"]

BACKENDS = ("auto", "cuda", "torch", "library")


def resolve_backend(backend: Backend = "auto",
                    device: torch.device | None = None,
                    *inputs: torch.Tensor) -> str:
    """``cuda``, ``torch`` or ``library`` for a call on tensors living on
    ``device``.  ``cuda`` under autograd (an ``inputs`` tensor requires
    grad) raises before the device is checked: the kernels have no
    backward, and nothing falls back."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        env = os.environ.get("ADSALA_BACKEND")
        if env:
            if env not in BACKENDS[1:]:
                raise ValueError(f"ADSALA_BACKEND={env!r}; expected one "
                                 f"of {BACKENDS[1:]}")
            backend = env
        else:
            backend = ("cuda" if device is not None
                       and device.type == "cuda" else "torch")
    if backend == "cuda":
        _build.refuse_grad("ops (backend 'cuda')", *inputs)
        if device is None or device.type != "cuda":
            raise ValueError(
                f"backend 'cuda' needs CUDA tensors, got {device}")
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


def grouped_dispatch_hint(shapes: list[tuple[int, int, int]],
                          tuner: AdsalaTuner | None, *,
                          n_experts: int | None = None,
                          routine: str = DEFAULT_ROUTINE,
                          site: str = "grouped"
                          ) -> list[GemmConfig] | None:
    """Per-expert worker configurations for a grouped (MoE) dispatch.

    All expert GEMMs go through ONE batched tuner lookup
    (:meth:`AdsalaTuner.select_many`).  ``n_experts`` (when known)
    guards against a shape list covering only a prefix of the experts.
    One event per expert shape is reported to any active recorder.
    """
    shapes = list(shapes)
    if n_experts is not None and len(shapes) != n_experts:
        raise ValueError(
            f"grouped dispatch got {len(shapes)} GEMM shapes for "
            f"{n_experts} experts; every expert needs a shape")
    routine = supported_routine(routine, tuner)
    cfgs = None
    if tuner is not None:
        hits = [tuner.peek(m, k, n, routine) for m, k, n in shapes]
        cfgs = tuner.select_many(shapes, routines=routine)
    else:
        hits = [False] * len(shapes)
    if recorder.active():
        for (m, k, n), hit, cfg in zip(
                shapes, hits, cfgs or [None] * len(shapes)):
            recorder.record(routine, m, k, n, config=cfg, cache_hit=hit,
                            site=site)
    return cfgs


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
    be = resolve_backend(backend, a.device, a, b)
    m, k, n = int(a.shape[0]), int(a.shape[1]), int(b.shape[1])
    # an explicit tile overrides the tuner entirely: don't consult it,
    # and don't label the event with a config that was never dispatched
    rt, cfg, hit = _select(m, k, n, DEFAULT_ROUTINE,
                           tuner if tile is None else None,
                           need_config=be != "library")
    recorder.record(rt, m, k, n, config=cfg, cache_hit=hit, site=site,
                    count=count)
    if be == "library":
        return ref.matmul_ref(a, b)
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
    be = resolve_backend(backend, a.device, a, b)
    rt, cfg, hit = _select(m, k, m, "syrk",
                           tuner if tile is None else None,
                           need_config=be != "library")
    recorder.record(rt, m, k, m, config=cfg, cache_hit=hit, site=site,
                    count=count)
    if be == "library":
        return ref.syrk_ref(a, b, lower=lower)
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
    be = resolve_backend(backend, a.device, a, b)
    rt, cfg, hit = _select(m, m, n, "trsm",
                           tuner if tile is None else None,
                           need_config=be != "library")
    recorder.record(rt, m, m, n, config=cfg, cache_hit=hit, site=site,
                    count=count)
    if be == "library":
        return ref.trsm_ref(a, b, lower=lower, unit_diag=unit_diag)
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


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   tuner: AdsalaTuner | None = None,
                   tile: tuple[int, int, int] | None = None,
                   group_sizes: list[int] | None = None,
                   routine: str = DEFAULT_ROUTINE,
                   site: str = "grouped",
                   backend: Backend = "auto") -> torch.Tensor:
    """Y[e] = X[e] @ W[e] with tuner-selected tiling, x (E, C, d), w
    (E, d, f).

    ``group_sizes`` (actual tokens routed per expert, <= capacity)
    refines the per-expert GEMM shapes the tuner sees; with or without
    it, all E experts resolve through a single batched ``select_many``
    lookup.  Each per-expert shape is reported to any active recorder
    as its own event.  One kernel tile serves every expert: the one
    chosen for the cost-dominant expert (largest m*k*n), or
    ``DEFAULT_TILES[3]`` without a tuner.  An explicit ``tile`` skips
    the tuner.
    """
    check_grouped_shapes(x, w)
    be = resolve_backend(backend, x.device, x, w)
    e, c, d = (int(s) for s in x.shape)
    f = int(w.shape[2])
    if group_sizes is not None:
        group_sizes = [int(g) for g in group_sizes]
        if len(group_sizes) != e:
            raise ValueError(
                f"group_sizes has {len(group_sizes)} entries for {e} "
                "experts; a prefix is not allowed — pass one size per "
                "expert (0 for an idle expert)")
        if any(g < 0 or g > c for g in group_sizes):
            raise ValueError(
                f"group_sizes {group_sizes} outside [0, capacity={c}]")
    # an expert with zero routed tokens still runs its capacity bucket;
    # query the tuner with at least one row so the shape stays sensible
    shapes = ([(max(g, 1), d, f) for g in group_sizes]
              if group_sizes is not None else [(c, d, f)] * e)
    if be == "library":
        # the reference's xla branch: the tuner is consulted only when a
        # recorder wants the configs on its events
        consult = tuner if tile is None else None
        if recorder.active():
            grouped_dispatch_hint(shapes, consult, routine=routine,
                                  site=site)
        else:
            supported_routine(routine, consult)
        return ref.grouped_matmul_ref(x, w)
    cfgs = grouped_dispatch_hint(shapes, tuner if tile is None else None,
                                 routine=routine, site=site)
    if tile is not None:
        bm, bk, bn = tile
    elif cfgs is not None:
        big = max(range(len(shapes)),
                  key=lambda i: shapes[i][0] * shapes[i][1] * shapes[i][2])
        bm, bk, bn = cfgs[big].tile
    else:
        bm, bk, bn = DEFAULT_TILES[3]
    fn = grouped_matmul_cuda if be == "cuda" else grouped_matmul_torch
    return fn(x, w, bm=bm, bk=bk, bn=bn)


def _fp32_up(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or wider (float64 stays float64: gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


#: untuned library-backend fallback: the longest causal self-attention
#: whose scores the SYRK materialisation path serves when no tuner is
#: available to price the choice (the reference's value)
SYRK_FALLBACK_MAX_SEQ = 512

#: hard memory guard on the SYRK score path (tuned or not): the full
#: fp32 (Sq, Sq) score triangle must fit this budget per head
SYRK_SCORES_BYTES_MAX = 64 * 1024 * 1024


def _syrk_scores_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, sm_scale: float | None, *,
                           tuner: AdsalaTuner | None, site: str,
                           count: int) -> torch.Tensor:
    """Causal self-attention with materialised SYRK-shaped scores.

    Only the lower triangle of QKᵀ is consumed under the causal mask —
    SYRK's output shape — so the score product is recorded as ONE
    routine="syrk" event on the per-head (Sq, Dh, Sq) triple with
    multiplicity ``count``, as the reference's vmapped ``syrk`` records
    it; the product itself is one batched ``tril(q @ kᵀ)`` in fp32
    (or wider).
    q/k/v: (BH, Sq, Dh).
    """
    _, sq, d = q.shape
    scale = sm_scale if sm_scale is not None else float(d) ** -0.5
    rt, cfg, hit = _select(sq, d, sq, "syrk", tuner, need_config=False)
    recorder.record(rt, sq, d, sq, config=cfg, cache_hit=hit, site=site,
                    count=count)
    scores = torch.tril(torch.bmm(_fp32_up(q),
                                  _fp32_up(k).transpose(1, 2)))
    ids = torch.arange(sq, device=q.device)
    mask = ids[None, :] <= ids[:, None]
    scores = torch.where(mask[None], scores * scale, ref.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.bmm(probs, _fp32_up(v)).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, window: int | None,
                      sm_scale: float | None, chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Softmax attention over query chunks, (BH, S, D) in and out: the
    reference's ``_chunked_attention_flat`` (and, with ``q_offset`` and
    a value width other than the key's, the core of its
    ``layers.chunked_attention_xla``).

    Never materialises the full (Sq, Skv) score matrix: per chunk the
    live block is (BH, chunk, Skv), the long-sequence path.  Query row
    i sits at position ``q_offset + i``.  Computed in fp32 (or wider).
    """
    sq, d = q.shape[1], q.shape[2]
    skv = k.shape[1]
    scale = sm_scale if sm_scale is not None else float(d) ** -0.5
    kv_ids = torch.arange(skv, device=q.device)
    k32, v32 = _fp32_up(k), _fp32_up(v)
    outs = []
    for i0 in range(0, sq, chunk):
        qi = q[:, i0:i0 + chunk]
        s = torch.bmm(_fp32_up(qi), k32.transpose(1, 2)) * scale
        q_ids = q_offset + i0 + torch.arange(qi.shape[1], device=q.device)
        mask = torch.ones((qi.shape[1], skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kv_ids[None, :] <= q_ids[:, None]
        if window is not None:
            mask &= kv_ids[None, :] > q_ids[:, None] - window
        s = torch.where(mask[None], s, ref.NEG_INF)
        outs.append(torch.bmm(torch.softmax(s, dim=-1), v32).to(q.dtype))
    return torch.cat(outs, dim=1)


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
    overrides skip the tuner entirely.

    The ``cuda`` and ``torch`` backends run the flash function; the
    ``library`` backend runs the reference's XLA paths: the SYRK
    score-materialisation path (:func:`_syrk_scores_attention`) for
    causal self-attention when the tuner's predicted times favour it
    over the attn routine (untuned: up to
    :data:`SYRK_FALLBACK_MAX_SEQ`), within the
    :data:`SYRK_SCORES_BYTES_MAX` guard, else :func:`chunked_attention`.
    Every path reports its dispatch to any active DispatchRecorder: the
    SYRK path as one syrk event, the others as one attn/gemm event
    carrying the resolved config.
    """
    if q.ndim != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"bad attention shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)}")
    be = resolve_backend(backend, q.device, q, k, v)
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
    if be == "library":
        if causal and window is None and sq == skv \
                and sq * sq * 4 <= SYRK_SCORES_BYTES_MAX:
            if cfg is not None and rt == "attn" \
                    and "syrk" in tuner.routines:
                _, t_attn = tuner.select_with_times(sq, d, skv, "attn")
                _, t_syrk = tuner.select_with_times(sq, d, sq, "syrk")
                use_syrk = float(np.min(t_syrk)) < float(np.min(t_attn))
            else:
                use_syrk = (tuner is None or rt != "attn") \
                    and sq <= SYRK_FALLBACK_MAX_SEQ
            if use_syrk:
                return _syrk_scores_attention(q, k, v, sm_scale,
                                              tuner=tuner, site=site,
                                              count=count)
        recorder.record(rt, sq, d, skv, config=cfg, cache_hit=hit,
                        site=site, count=count)
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 sm_scale=sm_scale,
                                 chunk=min(512, max(1, sq)))
    recorder.record(rt, sq, d, skv, config=cfg, cache_hit=hit,
                    site=site, count=count)
    fn = flash_attention_cuda if be == "cuda" else flash_attention_torch
    return fn(q, k, v, bq=bq, bkv=bkv, causal=causal, window=window,
              sm_scale=sm_scale, grid=grid)
