"""Expert-grouped GEMM: the Hopper kernel, its wrapper and its plain
PyTorch version.

Replaces ``repro.kernels.grouped_matmul.grouped_matmul_pallas``: Y[e] =
X[e] @ W[e] for every expert e over fixed-capacity token buckets, the
three expert products of an MoE layer.  The per-expert GEMMs are the
paper's "small and irregular" regime, tuned with the same (bm, bk, bn)
tile as the plain GEMM.  The kernel is CUDA C++ for ``sm_90a`` in
``csrc/grouped_matmul.cu``, on the GEMM body of ``csrc/gemm_tile.cuh``
with the expert on a grid axis, compiled at first use and bound through
``ctypes`` (see :mod:`repro_torch.kernels._build`).

* :func:`grouped_matmul_cuda` — the wrapper: checks, allocates the
  output, launches all experts in one launch on the current stream,
  raises on a CUDA error, and counts its launches in
  ``grouped_matmul_cuda.launches``.  Operands are read through their
  strides (an expert-transposed weight launches without a copy), and
  the ragged edges in C, d and f are masked in the kernel instead of
  padded.
* :func:`grouped_matmul_torch` — the plain version of the same
  function: fp32 accumulation over K chunks of ``bk``, on any device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul import _DTYPE_CODES, _check_tile, launch_shape

__all__ = ["grouped_matmul_cuda", "grouped_matmul_torch",
           "check_grouped_shapes"]

#: the kernel's grid axis for the expert (CUDA's gridDim.y limit)
MAX_EXPERTS = 65535


def check_grouped_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"bad grouped shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")


def grouped_matmul_torch(x: torch.Tensor, w: torch.Tensor, *,
                         bm: int = 128, bk: int = 128, bn: int = 128,
                         out_dtype: torch.dtype | None = None
                         ) -> torch.Tensor:
    """Y[e, c, f] = X[e, c, d] @ W[e, d, f], accumulated in fp32 over K
    chunks of ``bk`` (the kernel's function; ``bm``/``bn`` do not change
    the result)."""
    check_grouped_shapes(x, w)
    _check_tile(bm, bk, bn)
    e, c, d = x.shape
    y = torch.zeros((e, c, w.shape[2]), dtype=torch.float32,
                    device=x.device)
    for k0 in range(0, d, bk):
        y += x[:, :, k0:k0 + bk].float() @ w[:, k0:k0 + bk].float()
    return y.to(out_dtype or x.dtype)


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor, *, bm: int = 128,
                        bk: int = 128, bn: int = 128,
                        out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """Launch the Hopper grouped GEMM on 3-D CUDA tensors of one dtype
    (float32 or bfloat16), any strides: x (E, C, d), w (E, d, f); the
    output (E, C, f) (float32 or bfloat16, default x's dtype) is a new
    contiguous tensor.

    ``bm``/``bk``/``bn`` are the tuner's logical tile, mapped to a
    launch by :func:`repro_torch.kernels.matmul.launch_shape`.  Raises
    on any input the kernel does not take and on a failed launch.
    """
    check_grouped_shapes(x, w)
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda:
            raise ValueError(f"grouped_matmul_cuda: {name} is on "
                             f"{t.device}, not a CUDA device")
    if x.device != w.device:
        raise ValueError("grouped_matmul_cuda: x and w on different "
                         f"devices ({x.device}, {w.device})")
    if x.dtype != w.dtype:
        raise ValueError(f"grouped_matmul_cuda: mixed dtypes {x.dtype} / "
                         f"{w.dtype}")
    out_dtype = out_dtype or x.dtype
    for name, dt in (("dtype", x.dtype), ("out_dtype", out_dtype)):
        if dt not in _DTYPE_CODES:
            raise ValueError(f"grouped_matmul_cuda: {name} {dt} not "
                             "supported (float32, bfloat16)")
    e, c, d = (int(s) for s in x.shape)
    f = int(w.shape[2])
    if min(c, d, f) <= 0 or max(c, d, f) >= 2 ** 31 \
            or not 0 < e <= MAX_EXPERTS:
        raise ValueError(f"grouped_matmul_cuda: unsupported extents e={e} "
                         f"c={c} d={d} f={f}")
    cta_m, cta_n, k_step, group_m, group_n = launch_shape(bm, bk, bn)
    out = torch.empty((e, c, f), dtype=out_dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.grouped_matmul_forward(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
        *x.stride(), *w.stride(), cta_m, cta_n, k_step, group_m, group_n,
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(
            "grouped_matmul_cuda launch failed: "
            f"{lib.grouped_matmul_error_string(err).decode()} "
            f"(cudaError {err})")
    grouped_matmul_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
grouped_matmul_cuda.launches = 0
