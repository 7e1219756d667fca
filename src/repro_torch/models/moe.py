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
``moe.wo``), into the Hopper grouped GEMM on CUDA tensors.  On a mesh
(:func:`repro_torch.models.transformer._moe_apply` picks the path) the
same kernel runs on each rank's local experts: behind an expert-axis
``all_to_all`` in :func:`apply_moe_ep`, or on an FF slice of every
expert ahead of one all-reduce in :func:`apply_moe_tp`; the
collectives' gradients follow :mod:`repro_torch.dist.collectives`.  A
decode step on a mesh (:func:`apply_moe_decode`) routes the whole
batch, as the reference's one-hot path does under GSPMD, and runs each
rank's stored experts and FF slice on its block of their slot rows
(:func:`slot_block`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import linear
from repro_torch.models.params import ParamDef

__all__ = ["MoESpec", "moe_defs", "apply_moe", "apply_moe_ep",
           "apply_moe_tp", "apply_moe_decode", "slot_block",
           "is_expert_weight", "is_shared_weight"]

#: the expert weights, which a mesh path lays out by expert (EP) or by
#: FF slice (TP); the router and, in train and prefill, the shared
#: experts are replicated
EXPERT_WEIGHTS = ("wi", "wg", "wo")
#: the shared experts' weights, which a decode step on a mesh computes
#: where they are stored (their FF width over 'model')
SHARED_WEIGHTS = ("shared_wi", "shared_wg", "shared_wo")


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


def is_expert_weight(path: tuple) -> bool:
    """Is the parameter at ``path`` (dict keys and list indices from the
    model's root) an MoE layer's expert weight?"""
    return len(path) > 1 and path[-2] == "moe" \
        and path[-1] in EXPERT_WEIGHTS


def is_shared_weight(path: tuple) -> bool:
    """Is the parameter at ``path`` an MoE layer's shared-expert
    weight?"""
    return len(path) > 1 and path[-2] == "moe" \
        and path[-1] in SHARED_WEIGHTS


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


def _shared_ffn(p: dict, xf: torch.Tensor, tuner=None,
                tp=None) -> torch.Tensor:
    """The shared experts on flat tokens xf (T, D); with ``tp`` the
    weights are this rank's FF slice (``shared_wi`` / ``shared_wg``
    columns, ``shared_wo`` rows) and the partial output is summed over
    the group, as :func:`~repro_torch.models.layers.apply_mlp` does.
    The recorder sees the whole width."""
    from repro_torch.dist import collectives as C

    f = p["shared_wi"].shape[-1] * (1 if tp is None else tp.size)
    ops.observe(xf.shape[0], xf.shape[1], 2 * f, tuner,
                site="moe.shared_in")
    ops.observe(xf.shape[0], f, p["shared_wo"].shape[-1], tuner,
                site="moe.shared_out")
    if tp is not None:
        xf = C.copy_to(xf, tp.group)
    sh = F.silu(linear(xf, p["shared_wg"])) * linear(xf, p["shared_wi"])
    out = linear(sh, p["shared_wo"])
    return out if tp is None else C.reduce_from(out, tp.group)


def _shared_at(p: dict, mesh) -> tuple[dict, object]:
    """(the shared experts' weights a decode rank computes with, the
    :class:`~repro_torch.dist.collectives.TPGroup` that sums them or
    None): each rank's FF slice over 'model' where they are stored cut
    so (the reference's 'ff' rule), with no copy; else whole."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import TP_AXIS, to_placements

    wi = p["shared_wi"]
    m = list(mesh.mesh_dim_names).index(TP_AXIS)
    if isinstance(wi, DTensor) and wi.placements[m] == Shard(1):
        at = {"shared_wi": (None, TP_AXIS), "shared_wg": (None, TP_AXIS),
              "shared_wo": (TP_AXIS, None)}
        return ({k: C.local_at(p[k], mesh, to_placements(spec, mesh))
                 for k, spec in at.items()}, C.TPGroup.of(mesh, TP_AXIS))
    return {k: C.local_at(p[k], mesh, C.replicated(mesh))
            for k in SHARED_WEIGHTS}, None


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
    # bincount's length depends on the data; a scatter's does not, so a
    # trace on fake tensors can run it
    counts = torch.zeros(s.n_experts, dtype=torch.long,
                         device=xf.device).scatter_add_(
        0, flat_expert.long(), torch.ones_like(flat_expert, dtype=torch.long))
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


def apply_moe_ep(p: dict, x: torch.Tensor, s: MoESpec, tuner=None, *,
                 mesh, backend: str = "auto"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE (n_experts divisible by the ep axis).

    Runs on one rank of ``mesh`` with ``x`` this rank's shard (B_loc,
    S_loc, D), the expert weights this rank's experts (E/ep, ...) and
    the router whole — the reference's ``shard_map`` body.

    Steps: local top-k route -> sort-based bucket build -> all_to_all
    over ``s.ep_axis`` (experts) -> grouped GEMM on the local experts ->
    all_to_all back -> combine.  The aux loss is averaged over the ep
    axis; each rank's term depends on its own tokens, so its gradient
    is 1/ep of the mean's (:mod:`repro_torch.dist.collectives`).
    """
    from repro_torch.dist import collectives as C

    group = mesh.get_group(s.ep_axis)
    ep = C.axis_size(mesh, s.ep_axis)
    b, sl, d = x.shape
    n_tok = b * sl
    xf = x.reshape(n_tok, d)
    cap = s.capacity(n_tok)
    gate_vals, gate_idx, aux = _route(p, xf, s)
    aux = C.pmean(aux, group, grad_scale=1.0 / ep)

    buckets, dest, order, valid = _dispatch(xf, gate_idx, s, cap)

    # (E, C, D) -> (E/ep, ep*C, D): rows for my local experts from all
    # peers, peer-major
    e_loc = s.n_experts // ep
    recv = C.all_to_all(buckets, group)
    buckets = recv.reshape(ep, e_loc, cap, d).transpose(0, 1) \
        .reshape(e_loc, ep * cap, d)
    hi = ops.grouped_matmul(buckets, p["wi"], tuner=tuner, site="moe.wi",
                            backend=backend)
    hg = ops.grouped_matmul(buckets, p["wg"], tuner=tuner, site="moe.wg",
                            backend=backend)
    y = ops.grouped_matmul(F.silu(hg) * hi, p["wo"], tuner=tuner,
                           site="moe.wo", backend=backend)
    # (E/ep, ep*C, D) -> peer-major blocks -> (E, C, D) of my tokens
    y = y.reshape(e_loc, ep, cap, d).transpose(0, 1).contiguous()
    y = C.all_to_all(y, group).reshape(s.n_experts, cap, d)

    out = _combine(y, dest, order, valid, gate_vals, n_tok, s)
    if s.n_shared:
        out = out + _shared_ffn(p, xf, tuner)
    return out.reshape(b, sl, d), aux


def apply_moe_tp(p: dict, x: torch.Tensor, s: MoESpec, tuner=None, *,
                 mesh, backend: str = "auto"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-TP MoE for small expert counts (mixtral: 8 experts on a
    16-way model axis).  Runs on one rank of ``mesh`` with ``x``
    replicated over the tp axis ``s.ep_axis`` (tokens sharded over the
    data axes only) and the expert weights this rank's FF slice
    (wi/wg last dim, wo middle dim).

    Every tp member computes all experts on its FF slice; a single
    all-reduce (sum) over the tp axis rebuilds the expert outputs — the
    standard Megatron-style tensor parallelism applied per expert.
    """
    from repro_torch.dist import collectives as C

    group = mesh.get_group(s.ep_axis)
    b, sl, d = x.shape
    n_tok = b * sl
    xf = x.reshape(n_tok, d)
    cap = s.capacity(n_tok)
    gate_vals, gate_idx, aux = _route(p, xf, s)
    aux = C.pmean(aux, group)

    buckets, dest, order, valid = _dispatch(xf, gate_idx, s, cap)
    # each rank's FF slice sees the same buckets: their gradients sum
    buckets = C.copy_to(buckets, group)
    hi = ops.grouped_matmul(buckets, p["wi"], tuner=tuner,
                            site="moe.wi", backend=backend)  # (E, C, F/tp)
    hg = ops.grouped_matmul(buckets, p["wg"], tuner=tuner, site="moe.wg",
                            backend=backend)
    y = ops.grouped_matmul(F.silu(hg) * hi, p["wo"], tuner=tuner,
                           site="moe.wo", backend=backend)  # partial sums
    y = C.reduce_from(y, group)

    out = _combine(y, dest, order, valid, gate_vals, n_tok, s)
    if s.n_shared:
        out = out + _shared_ffn(p, xf, tuner)
    return out.reshape(b, sl, d), aux


def slot_block(n_experts: int, cap: int, n: int, r: int
               ) -> tuple[int, int, int, int]:
    """(e_lo, e_hi, c_lo, c_hi): the block of the (n_experts, cap) slot
    rows that rank ``r`` of ``n`` computes.  The experts fall into g =
    gcd(n_experts, n) groups, n_experts / g each, and each expert's
    capacity into n / g pieces of ⌈cap / (n / g)⌉ rows; rank r takes
    group r // (n / g) and piece r % (n / g).  The n blocks are equal
    and cover every row of the (n_experts, ⌈cap / (n / g)⌉ x n / g)
    padded rows once; ``c_hi`` may pass ``cap`` (rows of zeros)."""
    g = math.gcd(n_experts, n)
    per_e, pieces = n_experts // g, n // g
    rows = -(-cap // pieces)
    grp, piece = divmod(r, pieces)
    return grp * per_e, (grp + 1) * per_e, piece * rows, (piece + 1) * rows


def apply_moe_decode(p: dict, x: torch.Tensor, s: MoESpec, tuner=None, *,
                     mesh, row_axes: tuple, backend: str = "auto"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE of a decode step on ``mesh``: ``x`` is this rank's rows
    (B_loc, S, D) of a batch cut over ``row_axes`` (whole over the
    others), the expert and shared-expert weights are as stored
    (DTensors: the experts cut over the data axes, their FF width and
    the shared experts' over 'model'; a plain tensor is whole), the
    router whole.

    The reference runs its one-hot ``apply_moe`` on the global batch
    under GSPMD, so its capacity and each expert's (token, choice) order
    count every row.  Here the rows are gathered over ``row_axes`` and
    routed and dispatched as one batch (the same buckets on every rank).
    The mesh axes of size > 1 that cut no expert weight (``split``:
    'data' for mixtral's 8 experts on (16, 16)) would otherwise repeat
    one another's work: each of their n ranks runs the grouped GEMMs on
    its :func:`slot_block` of its stored experts' slot rows only, on its
    FF slice, and the blocks' outputs are all-gathered over ``split``
    (exact) into the (E, C, D) partial output.  Each rank combines what
    it gives every token, the partial outputs are summed over the mesh
    axes that cut the experts or FF, and the rank keeps its rows.  The
    shared experts run on the rank's rows and its FF slice, summed over
    'model' (:func:`_shared_at`).  No weight moves.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import collectives as C

    b_loc, sl, d = x.shape
    xf = C.gather_rows(x, mesh, row_axes).reshape(-1, d)
    n_tok = xf.shape[0]
    cap = s.capacity(n_tok)
    gate_vals, gate_idx, aux = _route(p, xf, s)
    buckets, dest, order, valid = _dispatch(xf, gate_idx, s, cap)

    names = tuple(mesh.mesh_dim_names)
    cuts, w = set(), {}
    for k in EXPERT_WEIGHTS:
        t = p[k]
        if isinstance(t, DTensor):
            cuts |= {names[i] for i, pl in enumerate(t.placements)
                     if pl.is_shard() and mesh.size(i) > 1}
            t = t.to_local()
        w[k] = t
    e_loc = w["wi"].shape[0]
    e0 = 0
    if e_loc < s.n_experts:
        by = [names[i] for i, pl in enumerate(p["wi"].placements)
              if pl.is_shard(0) and mesh.size(i) > 1]
        e0 = C.row_index(mesh, by) * e_loc
    split = tuple(a for i, a in enumerate(names)
                  if mesh.size(i) > 1 and a not in cuts)
    n = math.prod(mesh.size(names.index(a)) for a in split)
    e_lo, e_hi, c_lo, c_hi = slot_block(e_loc, cap, n,
                                        C.row_index(mesh, split))
    mine = buckets[e0 + e_lo:e0 + e_hi, c_lo:c_hi]
    if mine.shape[1] < c_hi - c_lo:
        mine = F.pad(mine, (0, 0, 0, c_hi - c_lo - mine.shape[1]))
    mine = mine.contiguous()
    w = {k: t[e_lo:e_hi] for k, t in w.items()}
    hi = ops.grouped_matmul(mine, w["wi"], tuner=tuner, site="moe.wi",
                            backend=backend)
    hg = ops.grouped_matmul(mine, w["wg"], tuner=tuner, site="moe.wg",
                            backend=backend)
    y = ops.grouped_matmul(F.silu(hg) * hi, w["wo"], tuner=tuner,
                           site="moe.wo", backend=backend)
    if split:
        # (n, experts, rows, D) in rank order -> (e_loc, padded C, D)
        g = math.gcd(e_loc, n)
        y = C.gather_rows(y[None], mesh, split)
        y = y.reshape(g, n // g, *y.shape[1:]).transpose(1, 2) \
            .reshape(e_loc, -1, d)[:, :cap]
    y = F.pad(y, (0, 0, 0, 0, e0, s.n_experts - e0 - e_loc))
    out = _combine(y, dest, order, valid, gate_vals, n_tok, s)
    for a in names:
        if a in cuts:
            out = C.reduce_from(out, mesh.get_group(a))
    i = C.row_index(mesh, row_axes)
    out = out.reshape(-1, sl, d)[i * b_loc:(i + 1) * b_loc]
    if s.n_shared:
        shared, tp = _shared_at(p, mesh)
        out = out + _shared_ffn(shared, x.reshape(-1, d), tuner,
                                tp).reshape(b_loc, sl, d)
    return out, aux
