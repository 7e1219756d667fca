"""Tiled GEMM: the Hopper kernel, its wrapper and its plain PyTorch
version.

Replaces ``repro.kernels.matmul.matmul_pallas``, the compute object
ADSALA tunes: the (bm, bk, bn) tile triple is one axis of the tuner's
worker configuration.  The kernel is CUDA C++ for ``sm_90a`` in
``csrc/matmul.cu``, compiled with ``nvcc`` into a shared library at
first use and bound through ``ctypes`` (see
:mod:`repro_torch.kernels._build`); its header comment says what bounds
it on the H100 and how the TPU tile becomes a launch shape
(:func:`launch_shape`).

* :func:`matmul_cuda` — the wrapper: checks, allocates the output,
  launches on the current stream, raises on a CUDA error, and counts
  its launches in ``matmul_cuda.launches``.  Operands are read through
  their strides, so a transposed view launches without a copy, and the
  ragged edge is masked in the kernel instead of padded.
* :func:`matmul_torch` — the plain version of the same function: fp32
  accumulation over K chunks of ``bk``, on any device.

:mod:`repro_torch.kernels.ops` picks between them: CUDA tensors launch
the kernel (or raise), CPU tensors take the plain version, and there is
no fallback from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["matmul_cuda", "matmul_torch", "launch_shape",
           "ring_stages", "check_gemm_shapes"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_gemm_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")


def _check_tile(bm: int, bk: int, bn: int) -> None:
    if min(bm, bk, bn) <= 0:
        raise ValueError(f"bad GEMM tile {(bm, bk, bn)}")


#: shared memory a block may use on the H100 (232,448 bytes), and the
#: share that leaves room for two blocks an SM
SMEM_MAX = 232448
SMEM_TWO_CTAS = SMEM_MAX // 2


def stage_bytes(cta_m: int, cta_n: int, k_step: int, itemsize: int = 4
                ) -> int:
    """Bytes of one K step of the CTA tile in shared memory: A as
    [k_step][cta_m] and B as [k_step][cta_n], rows padded by 16 bytes."""
    pad = 16 // itemsize
    return k_step * (cta_m + pad + cta_n + pad) * itemsize


def ring_stages(cta_m: int, cta_n: int, k_step: int) -> int:
    """Depth of the cp.async ring: 4 when four fp32 K steps fit in half
    of the shared memory (two CTAs an SM), else 3."""
    return 4 if 4 * stage_bytes(cta_m, cta_n, k_step) <= SMEM_TWO_CTAS \
        else 3


def launch_shape(bm: int, bk: int, bn: int
                 ) -> tuple[int, int, int, int, int, int]:
    """The kernel's launch shape for the tuner's logical tile:
    ``(cta_m, cta_n, k_step, stages, group_m, group_n)`` (the table in
    ``csrc/gemm_tile.cuh``'s header).  The CTA tile is 128 a side from a
    logical side of 128 up, else 64; the K step grows with ``bk``; the
    ring's depth follows from the CTA tile and the K step
    (:func:`ring_stages`; the kernel refuses any other depth); the logical
    (bm, bn) tile is the raster group of CTAs that run together."""
    _check_tile(bm, bk, bn)
    cta_m = 128 if bm >= 128 else 64
    cta_n = 128 if bn >= 128 else 64
    k_step = 8 if bk <= 128 else 16 if bk <= 256 else 32
    return (cta_m, cta_n, k_step, ring_stages(cta_m, cta_n, k_step),
            max(1, bm // cta_m), max(1, bn // cta_n))


def matmul_torch(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                 bk: int = 128, bn: int = 128,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = A @ B, accumulated in fp32 over K chunks of ``bk`` (the
    kernel's function; ``bm``/``bn`` do not change the result)."""
    check_gemm_shapes(a, b)
    _check_tile(bm, bk, bn)
    m, k = a.shape
    c = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, bk):
        c += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return c.to(out_dtype or a.dtype)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                bk: int = 128, bn: int = 128,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the Hopper GEMM kernel on 2-D CUDA tensors of one dtype
    (float32 or bfloat16), any strides; the output (float32 or
    bfloat16, default A's dtype) is a new contiguous tensor.

    ``bm``/``bk``/``bn`` are the tuner's logical tile, mapped to a
    launch by :func:`launch_shape`.  Raises on any input the kernel
    does not take and on a failed launch.
    """
    check_gemm_shapes(a, b)
    for name, t in (("a", a), ("b", b)):
        if not t.is_cuda:
            raise ValueError(f"matmul_cuda: {name} is on {t.device}, not "
                             "a CUDA device")
    if a.device != b.device:
        raise ValueError("matmul_cuda: a and b on different devices "
                         f"({a.device}, {b.device})")
    if a.dtype != b.dtype:
        raise ValueError(f"matmul_cuda: mixed dtypes {a.dtype} / {b.dtype}")
    out_dtype = out_dtype or a.dtype
    for name, dt in (("dtype", a.dtype), ("out_dtype", out_dtype)):
        if dt not in _DTYPE_CODES:
            raise ValueError(f"matmul_cuda: {name} {dt} not supported "
                             "(float32, bfloat16)")
    m, k = (int(s) for s in a.shape)
    n = int(b.shape[1])
    if min(m, k, n) <= 0 or max(m, k, n) >= 2 ** 31:
        raise ValueError(f"matmul_cuda: unsupported extents m={m} k={k} "
                         f"n={n}")
    cta_m, cta_n, k_step, stages, group_m, group_n = launch_shape(bm, bk,
                                                                   bn)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.matmul_forward(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        cta_m, cta_n, k_step, stages, group_m, group_n,
        _DTYPE_CODES[a.dtype],
        _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(
            "matmul_cuda launch failed: "
            f"{lib.matmul_error_string(err).decode()} (cudaError {err})")
    matmul_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
matmul_cuda.launches = 0
