"""The BLAS-3 routines in plain PyTorch, float32.  ``mm`` is the product
they are built from (``reference.mm_fp32``, or ``mm_tf32`` for the
control)."""

from __future__ import annotations

import torch

from reference import mm_fp32

#: rows of a substitution panel
PANEL = 512


def gemm(a: torch.Tensor, b: torch.Tensor, mm=mm_fp32) -> torch.Tensor:
    return mm(a, b)


def syrk(a: torch.Tensor, mm=mm_fp32) -> torch.Tensor:
    """The lower triangle of A A^T."""
    return torch.tril(mm(a, a.T))


def trsm(ell: torch.Tensor, b: torch.Tensor, mm=mm_fp32) -> torch.Tensor:
    """X with L X = B, L lower triangular with its diagonal: forward
    substitution by panels of PANEL rows, each panel's right side less
    the solved rows' product, then its diagonal block solved."""
    m = ell.shape[0]
    x = torch.empty_like(b)
    for i0 in range(0, m, PANEL):
        i1 = min(i0 + PANEL, m)
        rhs = b[i0:i1]
        if i0:
            rhs = rhs - mm(ell[i0:i1, :i0], x[:i0])
        x[i0:i1] = torch.linalg.solve_triangular(
            ell[i0:i1, i0:i1], rhs, upper=False)
    return x


def call(routine: str, operands: tuple, mm=mm_fp32) -> torch.Tensor:
    return {"gemm": gemm, "syrk": syrk, "trsm": trsm}[routine](
        *operands, mm=mm)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / max |ref|; inf for a wrong shape or a
    non-finite output."""
    if tuple(out.shape) != tuple(ref.shape):
        return float("inf")
    diff = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if diff != diff or diff == float("inf"):
        return float("inf")
    return diff / scale if scale > 0 else diff
