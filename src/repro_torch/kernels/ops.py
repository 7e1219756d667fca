"""Tuned kernel dispatch + ADSALA tuner integration (the serving slice).

``flash_attention`` is the entry point the model layers call; the
``observe`` / ``dispatch_hint`` sites report the plain contractions the
layers leave to ``torch.matmul``.  Backend selection:

  * ``cuda``  — the hand-written Hopper kernels; a CPU tensor raises;
  * ``torch`` — the kernels' plain PyTorch versions, on any device;
  * ``auto``  — ``ADSALA_BACKEND`` when set (``cuda`` or ``torch``,
    anything else raises), else the tensor's device: CUDA tensors take
    the kernel, CPU tensors the plain version.

When an :class:`~repro_torch.core.tuner.AdsalaTuner` is supplied, the
call's (routine, m, k, n) is looked up per call (memoised inside the
tuner) and the chosen worker configuration supplies the flash blocks
and KV grid.  Every entry point reports its dispatch — the *resolved*
routine, shape, chosen config and whether the tuner served it from
cache — to any active :class:`~repro_torch.kernels.recorder.
DispatchRecorder`, exactly as the reference does.
"""

from __future__ import annotations

import os
from typing import Literal

import torch

from repro_torch.core.costmodel import DEFAULT_ROUTINE, ROUTINES, GemmConfig
from repro_torch.core.tuner import AdsalaTuner
from repro_torch.kernels import recorder
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_torch,
)

__all__ = ["flash_attention", "dispatch_hint", "observe",
           "resolve_backend", "supported_routine"]

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
