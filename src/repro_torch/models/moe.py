"""Mixture-of-Experts layer: top-k routing, sort-based dispatch, three
grouped expert GEMMs, combine.

The reference's single-device ``apply_moe`` builds its buckets with a
one-hot einsum (``td,tke,tkc->ecd``), O(T·E·C·D) flops: about 2.6e14 a
layer at mixtral's full width and 4 x 1024 tokens.  The port's
:func:`apply_moe` computes the same function with the reference's
sort-based gather/scatter (:func:`_dispatch` / :func:`_combine`, zero
flops).  Both keep the first ``capacity`` (token, choice) pairs of each
expert in flat (token-major) order, so the buckets are the same rows.

The expert products are three :func:`repro_torch.kernels.ops.
grouped_matmul` dispatches (sites ``moe.wi`` / ``moe.wg`` /
``moe.wo``), into the Hopper grouped GEMM on CUDA tensors.  The
expert-parallel and expert-TP paths (``apply_moe_ep`` / ``apply_moe_tp``)
need collectives and wait for the port of ``dist/``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import linear
from repro_torch.models.params import ParamDef

__all__ = ["MoESpec", "moe_defs", "apply_moe", "apply_moe_ep",
           "apply_moe_tp"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    #: mesh axis name carrying expert parallelism in the EP path
    ep_axis: str = "model"

    def capacity(self, n_tokens: int) -> int:
        cap = int(self.capacity_factor * n_tokens * self.top_k
                  / self.n_experts)
        return max(8, -(-cap // 8) * 8)


def moe_defs(s: MoESpec) -> dict:
    e, d, f = s.n_experts, s.d_model, s.d_ff
    defs = {
        "router": ParamDef((d, e), ("embed", None), scale=0.02),
        "wi": ParamDef((e, d, f), ("experts", "embed", "expert_ff")),
        "wg": ParamDef((e, d, f), ("experts", "embed", "expert_ff")),
        "wo": ParamDef((e, f, d), ("experts", "expert_ff", "embed")),
    }
    if s.n_shared:
        defs["shared_wi"] = ParamDef((d, s.n_shared * f), ("embed", "ff"))
        defs["shared_wg"] = ParamDef((d, s.n_shared * f), ("embed", "ff"))
        defs["shared_wo"] = ParamDef((s.n_shared * f, d), ("ff", "embed"))
    return defs


def _route(p: dict, xf: torch.Tensor, s: MoESpec
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gate_vals, gate_idx, aux_loss) for flat tokens xf (T, D)."""
    logits = linear(xf, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, s.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    frac_tokens = F.one_hot(gate_idx[:, 0], s.n_experts).float().mean(0)
    aux = s.n_experts * torch.sum(frac_tokens * probs.mean(0))
    return gate_vals, gate_idx, aux


def _shared_ffn(p: dict, xf: torch.Tensor, tuner=None) -> torch.Tensor:
    ops.observe(xf.shape[0], xf.shape[1],
                2 * p["shared_wi"].shape[-1], tuner,
                site="moe.shared_in")
    ops.observe(xf.shape[0], p["shared_wo"].shape[-2],
                p["shared_wo"].shape[-1], tuner, site="moe.shared_out")
    sh = F.silu(linear(xf, p["shared_wg"])) * linear(xf, p["shared_wi"])
    return linear(sh, p["shared_wo"])


def _dispatch(xf: torch.Tensor, gate_idx: torch.Tensor, s: MoESpec,
              cap: int):
    """Sort-based bucket build: gathers/scatters only, zero flops.

    Returns (buckets (E, cap, D), dest (T*k,), order, valid) where dest
    maps each sorted (token, choice) to its bucket row (``E * cap``, a
    discarded row, for pairs past an expert's capacity).
    """
    n_tok = xf.shape[0]
    flat_expert = gate_idx.reshape(-1)                     # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = torch.bincount(flat_expert, minlength=s.n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n_tok * s.top_k, device=xf.device) \
        - starts[sorted_expert]
    token_of = order // s.top_k
    valid = rank < cap
    dest = torch.where(valid, sorted_expert * cap + rank,
                       s.n_experts * cap)
    buckets = torch.zeros((s.n_experts * cap + 1, xf.shape[1]),
                          dtype=xf.dtype, device=xf.device)
    buckets[dest] = xf[token_of]
    return buckets[:-1].reshape(s.n_experts, cap, -1), dest, order, valid


def _combine(y: torch.Tensor, dest: torch.Tensor, order: torch.Tensor,
             valid: torch.Tensor, gate_vals: torch.Tensor, n_tok: int,
             s: MoESpec) -> torch.Tensor:
    d = y.shape[-1]
    yf = torch.cat([y.reshape(s.n_experts * y.shape[1], d),
                    y.new_zeros((1, d))], dim=0)
    per_choice = yf[dest]                                  # (T*k, D) sorted
    unsort = torch.argsort(order)
    per_choice = per_choice[unsort].reshape(n_tok, s.top_k, d)
    keep = valid[unsort].reshape(n_tok, s.top_k)
    w = (gate_vals * keep).to(y.dtype)
    return torch.einsum("tkd,tk->td", per_choice, w)


def apply_moe(p: dict, x: torch.Tensor, s: MoESpec, tuner=None,
              backend: str = "auto"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss): route, sort-based dispatch into
    (E, capacity, D) buckets, three grouped expert GEMMs on ``backend``,
    combine."""
    b, sl, d = x.shape
    n_tok = b * sl
    xf = x.reshape(n_tok, d)
    cap = s.capacity(n_tok)
    gate_vals, gate_idx, aux = _route(p, xf, s)
    buckets, dest, order, valid = _dispatch(xf, gate_idx, s, cap)

    hi = ops.grouped_matmul(buckets, p["wi"], tuner=tuner, site="moe.wi",
                            backend=backend)
    hg = ops.grouped_matmul(buckets, p["wg"], tuner=tuner, site="moe.wg",
                            backend=backend)
    y = ops.grouped_matmul(F.silu(hg) * hi, p["wo"], tuner=tuner,
                           site="moe.wo", backend=backend)

    out = _combine(y, dest, order, valid, gate_vals, n_tok, s)
    if s.n_shared:
        out = out + _shared_ffn(p, xf, tuner)
    return out.reshape(b, sl, d), aux


def apply_moe_ep(p: dict, x: torch.Tensor, s: MoESpec, tuner=None):
    """Expert-parallel MoE (``all_to_all`` over the expert axis)."""
    raise NotImplementedError(
        "apply_moe_ep is not ported yet: it needs the expert-axis "
        "all_to_all of the dist/ port")


def apply_moe_tp(p: dict, x: torch.Tensor, s: MoESpec, tuner=None):
    """Expert-TP MoE (experts sharded on the FF dim, one psum)."""
    raise NotImplementedError(
        "apply_moe_tp is not ported yet: it needs the tensor-parallel "
        "psum of the dist/ port")
