"""Expert-grouped GEMM: the Hopper kernel, its wrapper and its plain
PyTorch version.

Replaces ``repro.kernels.grouped_matmul.grouped_matmul_pallas``: Y[e] =
X[e] @ W[e] for every expert e over fixed-capacity token buckets, the
three expert products of an MoE layer.  The per-expert GEMMs are the
paper's "small and irregular" regime, tuned with the same (bm, bk, bn)
tile as the plain GEMM.  The kernel is CUDA C++ for ``sm_90a`` in
``csrc/grouped_matmul.cu``, with the expert on a grid axis, compiled at
first use and bound through ``ctypes`` (see
:mod:`repro_torch.kernels._build`).  It has two bodies:
:func:`grouped_launch` plans which one a call runs and how.

* prefill buckets (more than :data:`THIN_ROWS` rows) run the tiled,
  cp.async-pipelined GEMM body of ``csrc/gemm_tile.cuh``, its CTA rows
  fitted to the bucket;
* decode buckets (at most :data:`THIN_ROWS` rows) run the
  weight-streaming body of ``csrc/gemm_thin.cuh``: a CTA covers the
  bucket's rows by 256 columns and streams W through a deep ring, with
  split-K where the CTAs would not fill the card.

* :func:`grouped_matmul_cuda` — the wrapper: checks, then calls the
  torch op ``repro_torch::grouped_matmul``, whose real implementation
  allocates the output and the split-K workspace, launches all experts
  in one launch on the current stream, raises on a CUDA error, and
  counts its launches in ``grouped_matmul_cuda.launches`` (and by body
  in ``grouped_matmul_cuda.launches_by_variant``); its fake
  implementation and FLOP formula (:func:`grouped_flops`) let a trace
  on fake tensors see the kernel without launching it.  Operands are read
  through their strides (an expert-transposed weight launches without a
  copy), and the ragged edges in C, d and f are masked in the kernel
  instead of padded.
* :func:`grouped_matmul_torch` — the plain version of the same
  function: fp32 accumulation over K chunks of ``bk``, on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.matmul import (_DTYPE_CODES, _check_tile,
                                        launch_shape, ring_stages)

__all__ = ["grouped_matmul_cuda", "grouped_matmul_torch", "grouped_flops",
           "check_grouped_shapes", "grouped_launch", "GroupedLaunch"]

#: the kernel's grid axis for the expert (CUDA's gridDim.y limit)
MAX_EXPERTS = 65535
#: SMs of the H100 SXM: a thin launch with fewer CTAs splits K
SMS = 132
#: the thin body (csrc/gemm_thin.cuh): the largest bucket it takes, its
#: CTA's columns, its K step and its ring's depth; the C entry refuses a
#: launch whose values differ from the kernel's
THIN_ROWS, THIN_BN, THIN_BK, THIN_STAGES = 16, 256, 16, 6
#: a split covers at least this many K steps; at most this many splits
MIN_SPLIT_STEPS, MAX_SPLITS = 8, 16
#: CTA rows of the tiled body for a grouped launch, largest first
GROUPED_CTA_ROWS = (128, 96, 64)


class GroupedLaunch(NamedTuple):
    """One grouped launch: the body (``"thin"`` or ``"tiled"``), the
    CTA tile, K step, ring depth, raster group, the split-K count with
    the K rows a split covers, and the fp32 workspace it needs
    (elements; 0 without split-K)."""
    variant: str
    cta_m: int
    cta_n: int
    k_step: int
    stages: int
    group_m: int
    group_n: int
    splits: int
    k_split: int
    workspace: int

    def ctas(self, e: int, c: int, f: int) -> int:
        """CTAs of the launch's main kernel (before raster padding)."""
        return (e * -(-c // self.cta_m) * -(-f // self.cta_n)
                * self.splits)


def _fit_rows(c: int, cta_m: int) -> int:
    """Of GROUPED_CTA_ROWS up to ``cta_m``, the CTA row count that leaves
    the fewest dead rows in ceil(c / rows) * rows; the largest on a tie."""
    cands = [r for r in GROUPED_CTA_ROWS if r <= cta_m] or [cta_m]
    return min(cands, key=lambda r: (-(-c // r) * r, -r))


def grouped_launch(e: int, c: int, d: int, f: int, bm: int, bk: int,
                   bn: int) -> GroupedLaunch:
    """The grouped kernel's launch for E buckets of (c, d) x (d, f) on
    the tuner's tile (the table in ``csrc/gemm_tile.cuh``'s header).

    A bucket of at most :data:`THIN_ROWS` rows takes the thin body: CTA
    rows 8 or 16, 256 columns, K step 16, and split-K only where
    ``e * ceil(f / 256)`` CTAs would not fill :data:`SMS` SMs: the
    fewest splits that do, each of at least :data:`MIN_SPLIT_STEPS` K
    steps, at most :data:`MAX_SPLITS`, none empty.  Any other bucket
    takes the tiled body at the plain GEMM's launch shape, with the CTA
    rows fitted to the bucket (:func:`_fit_rows`)."""
    _check_tile(bm, bk, bn)
    if min(e, c, d, f) <= 0:
        raise ValueError(f"bad grouped extents e={e} c={c} d={d} f={f}")
    if c <= THIN_ROWS:
        cta_m = 8 if c <= 8 else 16
        ctas = e * -(-f // THIN_BN)
        steps = -(-d // THIN_BK)
        splits = max(1, min(-(-SMS // ctas), steps // MIN_SPLIT_STEPS,
                            MAX_SPLITS))
        k_split = -(-steps // splits) * THIN_BK
        splits = -(-d // k_split)
        return GroupedLaunch("thin", cta_m, THIN_BN, THIN_BK, THIN_STAGES,
                             1, 1, splits, k_split,
                             splits * e * c * f if splits > 1 else 0)
    cta_m, cta_n, k_step, _, group_m, group_n = launch_shape(bm, bk, bn)
    rows = _fit_rows(c, cta_m)
    return GroupedLaunch("tiled", rows, cta_n, k_step,
                         ring_stages(rows, cta_n, k_step),
                         max(1, bm // rows), group_n, 1, d, 0)


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
    launch by :func:`grouped_launch`.  Raises on any input the kernel
    does not take, under autograd (it has no backward) and on a failed
    launch.
    """
    check_grouped_shapes(x, w)
    _build.refuse_grad("grouped_matmul_cuda", x, w)
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
    _check_tile(bm, bk, bn)
    return torch.ops.repro_torch.grouped_matmul(x, w, bm, bk, bn, out_dtype)


def grouped_flops(e: int, c: int, d: int, f: int) -> int:
    """The operations of E products (c, d) @ (d, f): 2ecdf."""
    return 2 * e * c * d * f


@torch.library.custom_op("repro_torch::grouped_matmul", mutates_args=())
def _grouped_op(x: torch.Tensor, w: torch.Tensor, bm: int, bk: int, bn: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """The launch, as a torch op (checked by :func:`grouped_matmul_cuda`):
    a trace on fake tensors takes the fake implementation below and
    launches nothing, so only this function counts launches."""
    e, c, d = x.shape
    f = w.shape[2]
    plan = grouped_launch(e, c, d, f, bm, bk, bn)
    out = torch.empty((e, c, f), dtype=out_dtype, device=x.device)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
          if plan.workspace else None)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.grouped_matmul_forward(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
        *x.stride(), *w.stride(), plan.cta_m, plan.cta_n, plan.k_step,
        plan.stages, plan.group_m, plan.group_n, plan.splits,
        ws.data_ptr() if ws is not None else None, _DTYPE_CODES[x.dtype],
        _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(
            "grouped_matmul_cuda launch failed: "
            f"{lib.grouped_matmul_error_string(err).decode()} "
            f"(cudaError {err})")
    grouped_matmul_cuda.launches += 1
    grouped_matmul_cuda.launches_by_variant[plan.variant] += 1
    return out


@_grouped_op.register_fake
def _(x, w, bm, bk, bn, out_dtype):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]),
                       dtype=out_dtype)


@register_flop_formula(torch.ops.repro_torch.grouped_matmul)
def _grouped_op_flops(x_shape, w_shape, *args, out_shape=None, **kwargs
                      ) -> int:
    return grouped_flops(*x_shape, w_shape[2])


#: launches of the CUDA kernel since the count was last set to 0
grouped_matmul_cuda.launches = 0
#: the same launches by body (``"thin"``, ``"tiled"``)
grouped_matmul_cuda.launches_by_variant = {"thin": 0, "tiled": 0}
