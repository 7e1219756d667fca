"""Blocked (flash) attention: the Hopper kernel, its launch planner, its
wrapper and its plain PyTorch version.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas`` (both
of its KV grids).  The kernel is CUDA C++ for ``sm_90a`` in
``csrc/flash_attention.cu``, compiled with ``nvcc`` into a shared
library at first use and bound through ``ctypes`` (see
:mod:`repro_torch.kernels._build`).  Its header comment gives the
design: a cp.async ring of K/V sub-tiles, CTAs of up to 128 query rows
(16 a warp), register-tiled fp32 products read along d, P through a
per-warp slice of shared memory, exp2 with the scale folded in, and
causal launches heaviest row block first.  fp32 on the CUDA cores bounds
it: at the serving shape (128, 1024, 64), causal, 17.2 GFLOP take
0.257 ms at 67 TFLOP/s; the rate at which shared memory feeds the
register tiles is what keeps it from that bound.

* :func:`flash_launch` — the launch plan: CTA rows, sub-tile columns,
  ring stages and shared bytes, for a head dim, dtype and the tuner's
  (bq, bkv).  The C entry refuses any plan it does not compile.
* :func:`flash_attention_cuda` — the wrapper: checks, plans, allocates
  the output, launches on the current stream, raises on a CUDA error,
  and counts its launches in ``flash_attention_cuda.launches``.
* :func:`flash_attention_torch` — the plain version of the same
  function (fp32 math, the same masks, and the reference's value on a
  row with no visible key: see :func:`_visible`).

:func:`repro_torch.kernels.ops.flash_attention` picks between them:
CUDA tensors launch the kernel (or raise), CPU tensors take the plain
version, and there is no fallback from one to the other.

The host helpers :func:`flash_tile_map`, :func:`flash_grid_counts`,
``_clamp_blocks`` and ``_visible`` are the reference's, unchanged, so
both packages build the same tile maps from the tuner's ``(bq, bkv)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_cuda", "flash_attention_torch",
           "flash_tile_map", "flash_grid_counts", "flash_launch",
           "FlashLaunch", "FLASH_GRID_KINDS", "SUPPORTED_HEAD_DIMS"]

_NEG_INF = -1e30

FLASH_GRID_KINDS = ("dense", "tri")

#: head dims the CUDA kernel is instantiated for
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: CTA rows the kernel compiles (16 a warp), largest first
FLASH_CTA_ROWS = (128, 64, 32, 16)
#: (dtype, head dim) -> (sub-tile columns, ring stages, most CTA rows):
#: the table in ``csrc/flash_attention.cu``'s header, whose C entry
#: refuses any other plan
FLASH_PLANS = {
    (torch.float32, 16): (64, 3, 128), (torch.float32, 32): (64, 3, 128),
    (torch.float32, 64): (32, 3, 128), (torch.float32, 128): (32, 2, 64),
    (torch.bfloat16, 16): (64, 3, 128), (torch.bfloat16, 32): (64, 3, 128),
    (torch.bfloat16, 64): (64, 3, 128), (torch.bfloat16, 128): (64, 2, 64),
}


class FlashLaunch(NamedTuple):
    """One flash launch: the clamped logical blocks, the CTA's query rows
    (16 a warp), the KV sub-tile's columns, the K/V ring's depth and the
    CTA's shared memory in bytes."""
    bq: int
    bkv: int
    cta_rows: int
    sub_cols: int
    stages: int
    smem: int


def flash_launch(sq: int, skv: int, d: int, bq: int, bkv: int, *,
                 dtype: torch.dtype = torch.float32,
                 grid: str = "dense") -> FlashLaunch:
    """The kernel's launch for (Sq, Skv, D) under the tuner's (bq, bkv).

    The blocks are clamped as in the reference.  A CTA takes the largest
    of :data:`FLASH_CTA_ROWS` that is at most the clamped bq and the
    plan's most rows (16 when bq is below 16); the sub-tile, ring depth
    and most rows come from :data:`FLASH_PLANS`.  Both walks get the same
    plan: their bitwise equality rests on it."""
    if grid not in FLASH_GRID_KINDS:
        raise ValueError(f"unknown flash grid {grid!r}; "
                         f"expected one of {FLASH_GRID_KINDS}")
    if (dtype, d) not in FLASH_PLANS:
        raise ValueError(f"no flash plan for dtype {dtype}, head dim {d} "
                         f"(head dims {SUPPORTED_HEAD_DIMS}; float32, "
                         "bfloat16)")
    if min(sq, skv, bq, bkv) <= 0:
        raise ValueError(f"bad flash extents sq={sq} skv={skv} bq={bq} "
                         f"bkv={bkv}")
    bq_, bkv_ = _clamp_blocks(sq, skv, bq, bkv)
    sub_cols, stages, most = FLASH_PLANS[dtype, d]
    rows = next((r for r in FLASH_CTA_ROWS if r <= min(bq_, most)),
                FLASH_CTA_ROWS[-1])
    es = torch.empty((), dtype=dtype).element_size()
    pad = 16 // es
    smem = (es * (rows + 2 * stages * sub_cols) * (d + pad)
            + 4 * rows * (sub_cols + 8 + 1))
    return FlashLaunch(bq_, bkv_, rows, sub_cols, stages, smem)


def _clamp_blocks(sq: int, skv: int, bq: int, bkv: int) -> tuple[int, int]:
    """The effective (bq, bkv) the kernels run: never larger than the
    (sublane-padded) sequence extents."""
    return min(bq, max(8, sq)), min(bkv, max(8, skv))


def _visible(q_start, kv_start, *, bq: int, bkv: int, skv: int,
             padded: bool, causal: bool, window: int | None):
    """Does this logical tile intersect the mask at all?  Works on ints
    and on numpy arrays of tile starts alike."""
    visible = np.bool_(True)
    if padded:
        visible = visible & (kv_start < skv)
    if causal:
        visible = visible & (kv_start <= q_start + bq - 1)
    if window is not None:
        visible = visible & (kv_start + bkv - 1 > q_start - window)
    return visible


def flash_tile_map(sq: int, skv: int, bq: int, bkv: int, *,
                   causal: bool = True, window: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
    """Block-sparse tile list for the triangular/banded flash grid.

    Returns ``(qt, kvt, first, last)`` int32 arrays, one entry per
    launched tile, in row-major (Q row outer, KV ascending) order:
    ``qt[t]``/``kvt[t]`` are the block indices the sequential grid step
    ``t`` loads, ``first[t]``/``last[t]`` flag the row's scratch init /
    output write.  Per Q row ``i`` (blocks over the *padded* Sq so every
    output row is written):

    * causal bounds the KV axis above at the diagonal,
      ``hi = min(gkv-1, (i*bq + bq - 1) // bkv)`` — tiles past it are
      fully masked and never emitted;
    * a sliding window bounds it below at the band edge,
      ``lo = max(0, (i*bq - window + 1) // bkv)``;
    * the KV-length bound caps ``hi`` at the last block holding a real
      (< skv) key, so fully-padded KV tiles are never emitted either.

    A row whose band is empty (window entirely in the future relative
    to every key) degenerates to one flagged-first-and-last tile whose
    body the kernel masks out entirely — init + finish still run, so
    the row's output is written (as zeros, matching the dense grid).
    """
    gq = -(-sq // bq)
    gkv = -(-skv // bkv)
    kv_hi = (skv - 1) // bkv          # last block with a real key
    qt, kvt, first, last = [], [], [], []
    for i in range(gq):
        hi = kv_hi
        if causal:
            hi = min(hi, (i * bq + bq - 1) // bkv)
        lo = 0
        if window is not None:
            lo = max(0, (i * bq - window + 1) // bkv)
        if lo > hi:                   # fully-masked row: degenerate tile
            lo = hi = min(lo, gkv - 1)
        for j in range(lo, hi + 1):
            qt.append(i)
            kvt.append(j)
            first.append(1 if j == lo else 0)
            last.append(1 if j == hi else 0)
    return (np.asarray(qt, np.int32), np.asarray(kvt, np.int32),
            np.asarray(first, np.int32), np.asarray(last, np.int32))


def flash_grid_counts(sq: int, skv: int, bq: int, bkv: int, *,
                      causal: bool = True, window: int | None = None
                      ) -> tuple[int, int]:
    """(triangular grid steps, dense grid steps) per batch-head, after
    the same block clamping :func:`flash_attention_pallas` applies —
    the launch saving the cost model prices and bench_flash measures."""
    bq_, bkv_ = _clamp_blocks(sq, skv, bq, bkv)
    gq, gkv = -(-sq // bq_), -(-skv // bkv_)
    qt, _, _, _ = flash_tile_map(sq, skv, bq_, bkv_,
                                 causal=causal, window=window)
    return len(qt), gq * gkv


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           grid: str) -> None:
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"bad attention shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if grid not in FLASH_GRID_KINDS:
        raise ValueError(f"unknown flash grid {grid!r}; "
                         f"expected one of {FLASH_GRID_KINDS}")


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, bq: int = 512, bkv: int = 512,
                          causal: bool = True, window: int | None = None,
                          sm_scale: float | None = None,
                          grid: str = "dense") -> torch.Tensor:
    """Plain PyTorch version of the kernel's function, on (BH, S, D).

    Materialises the (BH, Sq, Skv) fp32 scores.  The grid does not
    change the result (the kernel's dense and tri walks are bitwise
    equal).  The blocks matter only on a row with no visible key, where
    the reference's online softmax (finite -1e30 mask, so p = exp(0) = 1
    before any real score seeds the running max) averages ``v`` over
    every column of every visible logical (bq, bkv) tile of the row's
    Q block, padded columns (zero ``v``) included; a row whose logical
    tiles are all invisible gives 0.
    """
    _check(q, k, v, grid)
    _, sq, d = q.shape
    skv = k.shape[1]
    sm_scale = sm_scale if sm_scale is not None else float(d) ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    q_ids = torch.arange(sq, device=q.device)[:, None]
    kv_ids = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_ids <= q_ids
    if window is not None:
        mask &= kv_ids > q_ids - window
    s = torch.where(mask, s, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    empty = ~mask.any(dim=-1)
    if bool(empty.any()):
        bq_, bkv_ = _clamp_blocks(sq, skv, bq, bkv)
        gq, gkv = -(-sq // bq_), -(-skv // bkv_)
        vis = _visible(np.arange(gq)[:, None] * bq_,
                       np.arange(gkv)[None, :] * bkv_, bq=bq_, bkv=bkv_,
                       skv=skv, padded=True, causal=causal, window=window)
        vis = torch.from_numpy(np.asarray(vis)).to(q.device)
        cols = vis[:, torch.arange(skv, device=q.device) // bkv_]
        n_cols = vis.sum(dim=1).clamp_min(1) * bkv_          # (gq,)
        vbar = torch.einsum("gk,bkd->bgd", cols.float(), v.float()) \
            / n_cols[None, :, None]
        rows = torch.nonzero(empty).squeeze(1)
        out[:, rows] = vbar[:, rows // bq_]
    return out.to(q.dtype)


@functools.lru_cache(maxsize=64)
def _tri_walk(sq: int, skv: int, bq: int, bkv: int, causal: bool,
              window: int | None, device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The tri grid's tile list as device CSR: (row offsets (gq + 1),
    KV tile per entry), built once per shape and device."""
    qt, kvt, _, _ = flash_tile_map(sq, skv, bq, bkv,
                                   causal=causal, window=window)
    gq = -(-sq // bq)
    row_ptr = np.zeros(gq + 1, np.int32)
    np.cumsum(np.bincount(qt, minlength=gq), out=row_ptr[1:])
    return (torch.from_numpy(row_ptr).to(device),
            torch.from_numpy(kvt).to(device))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, bq: int = 512, bkv: int = 512,
                         causal: bool = True, window: int | None = None,
                         sm_scale: float | None = None,
                         grid: str = "dense") -> torch.Tensor:
    """Launch the Hopper flash-attention kernel on (BH, S, D) CUDA
    tensors: q (BH, Sq, D), k/v (BH, Skv, D), contiguous, one dtype
    (float32 or bfloat16), D in :data:`SUPPORTED_HEAD_DIMS`.

    ``bq``/``bkv`` are the tuner's logical blocks, planned by
    :func:`flash_launch`; ``grid`` picks the dense or tri KV walk.
    Raises on any input the kernel does not take and on a failed launch.
    """
    _check(q, k, v, grid)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k, v on different "
                             f"devices ({q.device}, {t.device})")
        if t.dtype != q.dtype:
            raise ValueError("flash_attention_cuda: mixed dtypes "
                             f"{q.dtype} / {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} is not "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} is not "
                             "16-byte aligned")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype} not "
                         "supported (float32, bfloat16)")
    bh, sq, d = (int(s) for s in q.shape)
    skv = int(k.shape[1])
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if not (0 < bh <= 65535) or sq == 0 or skv == 0:
        raise ValueError(f"flash_attention_cuda: unsupported extents "
                         f"BH={bh} Sq={sq} Skv={skv}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_cuda: window {window} <= 0")
    sm_scale = sm_scale if sm_scale is not None else float(d) ** -0.5
    plan = flash_launch(sq, skv, d, bq, bkv, dtype=q.dtype, grid=grid)
    if -(-sq // plan.bq) * -(-plan.bq // plan.cta_rows) > 65535:
        raise ValueError(f"flash_attention_cuda: Sq={sq} needs more than "
                         "65535 row blocks")
    row_ptr = kv_list = None
    if grid == "tri":
        row_ptr, kv_list = _tri_walk(sq, skv, plan.bq, plan.bkv,
                                     bool(causal), window, q.device)
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, sq, skv, d, plan.bq, plan.bkv, int(bool(causal)),
        0 if window is None else int(window), ctypes.c_float(sm_scale),
        _DTYPE_CODES[q.dtype],
        None if row_ptr is None else row_ptr.data_ptr(),
        None if kv_list is None else kv_list.data_ptr(), plan.cta_rows,
        plan.sub_cols, plan.stages, stream)
    if err != 0:
        raise RuntimeError(
            "flash_attention_cuda launch failed: "
            f"{lib.flash_attention_error_string(err).decode()} "
            f"(cudaError {err})")
    flash_attention_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
flash_attention_cuda.launches = 0

