"""Plain-torch oracles for every kernel of the reference package.

Each computes in fp32 and casts to the output dtype, like
``repro.kernels.ref``.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_ref", "syrk_ref", "trsm_ref", "grouped_matmul_ref",
           "flash_attention_ref"]

#: the finite masked-score value (``-inf`` would make exp(-inf - -inf)
#: NaN on a fully masked row)
NEG_INF = -1e30


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    out = a.float() @ b.float()
    return out.to(out_dtype or a.dtype)


def syrk_ref(a: torch.Tensor, b: torch.Tensor | None = None, *,
             lower: bool = True,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The ``lower`` (or upper) triangle of A @ Bᵀ (B defaults to A);
    the other triangle is zero."""
    b = a if b is None else b
    c = a.float() @ b.float().T
    c = torch.tril(c) if lower else torch.triu(c)
    return c.to(out_dtype or a.dtype)


def trsm_ref(a: torch.Tensor, b: torch.Tensor, *, lower: bool = True,
             unit_diag: bool = False,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Triangular solve A X = B for X."""
    x = torch.linalg.solve_triangular(a.float(), b.float(), upper=not lower,
                                      left=True, unitriangular=unit_diag)
    return x.to(out_dtype or b.dtype)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    return out.to(out_dtype or x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        sm_scale: float | None = None) -> torch.Tensor:
    bh, sq, d = q.shape
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
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
