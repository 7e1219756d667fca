"""Collectives of the mesh paths, with the gradients a sharded train
step needs, and the moves of a DTensor between layouts.

The reference runs its expert- and tensor-parallel MoE inside
``shard_map`` and lets GSPMD partition its dense blocks, and JAX
transposes the collectives.  Here each collective is an autograd
function whose backward follows one rule, the **replicated-loss
convention**: every rank of a data-parallel group computes the same
loss (activations are replicated over ``model`` between the
tensor-parallel blocks and the MoE layers), ranks of different data
groups hold different batches, and a rank's backward gives the
gradient of its own group's loss with respect to its local tensors.
The sharded train step then averages the gradients over the data
axes.  Under that rule:

* :func:`all_to_all` — equal blocks along dim 0 to every rank; its
  backward is the same exchange, reversed.
* :func:`copy_to` — identity forward; the gradient summed over the
  group: a tensor replicated over the group that each rank uses on its
  own share of the work (the router on a sequence shard, an
  activation against an FF slice of the experts).
* :func:`reduce_from` — a sum over the group forward; the gradient
  passes unchanged (it is already the same on every rank).
* :func:`pmean` — a mean over the group forward; the gradient is
  scaled by ``grad_scale``: ``1 / size`` where each rank's term depends
  on its own shard and the shared weights' gradients are summed by
  :func:`copy_to`, 1 where every rank holds the same term;
* :func:`all_gather` — the group's pieces joined along a dim; the
  gradient is this rank's piece of the (replicated) output's.

The tensor-parallel dense layers (Megatron's f / g: :func:`copy_to` on
a block's input, :func:`reduce_from` on its output) run on a rank's
:class:`TPGroup` of the 'model' axis, and the vocab-parallel pieces of
the embedding and the loss are here too: :func:`vocab_embed` (the rows
of the rank's vocab range, summed over the group), :func:`vocab_logz`
(the log-partition over the whole vocab from the local logits: the max
and the sum of exponentials over the group) and :func:`vocab_gold` (the
label's logit, held by one rank, summed over the group).

:func:`local_at` moves a DTensor (or a full tensor, taken as
replicated) to the placements a computation wants and returns the local
piece, differentiably, without a copy where only mesh dims of size 1
differ; :func:`distribute` lays a whole tensor out by a spec.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_to_all", "copy_to", "reduce_from", "pmean", "all_gather",
           "TPGroup", "vocab_embed", "vocab_logz", "vocab_gold",
           "local_at", "local_rows", "distribute", "replicated",
           "partial_over", "axis_size"]


def axis_size(mesh, axis: str) -> int:
    """The size of one named mesh axis."""
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """A rank's tensor-parallel group: the process group of one mesh
    axis, its size and the rank's place in it."""
    group: Any
    size: int
    rank: int

    @classmethod
    def of(cls, mesh, axis: str) -> "TPGroup":
        return cls(mesh.get_group(axis), axis_size(mesh, axis),
                   int(mesh.get_local_rank(axis)))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rank r's block i of ``x`` (dim 0 cut into group-size equal
    blocks) becomes rank i's block r."""
    return _AllToAll.apply(x, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over ``group``."""
    return _CopyTo.apply(x, group)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passes unchanged."""
    return _ReduceFrom.apply(x, group)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.grad_scale = grad_scale
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None


def pmean(x: torch.Tensor, group, grad_scale: float = 1.0) -> torch.Tensor:
    """The mean of ``x`` over ``group``; the gradient times
    ``grad_scale`` (see the module's convention)."""
    return _PMean.apply(x, group, grad_scale)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((dist.get_world_size(group) * xt.shape[0],
                            *xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` joined along ``dim`` in rank order (every rank's
    piece the same shape); the gradient is this rank's piece."""
    return _AllGather.apply(x, group, dim)


def vocab_embed(w: torch.Tensor, ids: torch.Tensor, tp: TPGroup
                ) -> torch.Tensor:
    """Rows of an embedding cut on the vocab over ``tp`` (``w``: this
    rank's (V / size, D) rows): each rank looks up the ids of its range
    and zeroes the others, the sum over the group is the lookup."""
    n = w.shape[0]
    local = ids.long() - tp.rank * n
    hit = (local >= 0) & (local < n)
    rows = torch.where(hit[..., None], w[local.clamp(0, n - 1)],
                       torch.zeros((), dtype=w.dtype, device=w.device))
    return reduce_from(rows, tp.group)


class _VocabLogZ(torch.autograd.Function):
    """log sum exp over the last dim, cut over ``group``: the steps of
    ``torch.logsumexp`` (the max, masked where infinite; the sum of
    exponentials; log plus the max) with the max and the sum taken over
    the group, so on one rank it is ``logsumexp`` bit for bit, and so is
    its gradient, g x exp(logits - logz)."""

    @staticmethod
    def forward(ctx, logits, group):
        m = logits.amax(dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        m.masked_fill_(m.abs() == float("inf"), 0)
        se = (logits - m).exp_().sum(dim=-1)
        dist.all_reduce(se, group=group)
        logz = se.log_().add_(m[..., 0])
        ctx.save_for_backward(logits, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        logits, logz = ctx.saved_tensors
        return g[..., None] * (logits - logz[..., None]).exp(), None


def vocab_logz(logits: torch.Tensor, group) -> torch.Tensor:
    """The log-partition of logits cut on their last dim over ``group``
    (this rank's columns); the same on every rank of the group."""
    return _VocabLogZ.apply(logits, group)


def vocab_gold(logits: torch.Tensor, labels: torch.Tensor, tp: TPGroup
               ) -> torch.Tensor:
    """The logit of each label from logits cut on their last dim over
    ``tp`` (this rank's columns): the rank whose range holds the label
    gives it, the others 0, summed over the group."""
    n = logits.shape[-1]
    local = labels.long() - tp.rank * n
    hit = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = torch.where(hit, gold, torch.zeros((), dtype=gold.dtype,
                                              device=gold.device))
    return reduce_from(gold, tp.group)


def _same_layout(mesh, a: Sequence, b: Sequence) -> bool:
    """Do two placement lists cut the tensor alike (a mesh dim of size 1
    cuts nothing, whatever its placement)?"""
    return all(pa == pb or mesh.size(i) == 1
               for i, (pa, pb) in enumerate(zip(a, b)))


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in range(mesh.ndim))


def partial_over(mesh, placements: Sequence, axis: str) -> tuple:
    """``placements`` with mesh axis ``axis`` a pending sum
    (``Partial``): the layout of a gradient that each rank of ``axis``
    holds a term of."""
    from torch.distributed.tensor import Partial

    i = list(mesh.mesh_dim_names).index(axis)
    return tuple(Partial() if j == i else p
                 for j, p in enumerate(placements))


def local_at(t: torch.Tensor, mesh, placements: Sequence) -> torch.Tensor:
    """The local piece of ``t`` laid out by ``placements`` on ``mesh``.

    ``t`` is a DTensor, or a plain tensor taken as the whole (replicated)
    value.  The move is a DTensor redistribute, so it is differentiable
    with DTensor's own rule (a gradient of a replicated layout is the
    same on every rank); it is skipped, with no copy, when the layouts
    differ only on mesh dims of size 1.
    """
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, replicated(mesh), run_check=False)
    if _same_layout(mesh, t.placements, placements):
        return t.to_local()
    return t.redistribute(mesh, tuple(placements)).to_local()


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a batch input: a DTensor's piece cut on dim 0
    as its layout cuts it and whole along every other dim (a spec may
    also cut a wider dim over 'model', as the audio frame embeddings'
    does, where the computation wants the rows whole).  A plain tensor
    passes unchanged."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    rows = tuple(p if not p.is_shard() or p.dim == 0 else Replicate()
                 for p in t.placements)
    return local_at(t, t.device_mesh, rows)


def distribute(t: torch.Tensor, mesh, spec: tuple):
    """A DTensor laid out by ``spec`` from the whole tensor ``t``, which
    every rank holds: each keeps its own piece (no communication, and
    no copy where the mesh does not cut ``t``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import to_placements

    placements = to_placements(spec, mesh)
    return DTensor.from_local(local_at(t, mesh, placements).contiguous(),
                              mesh, placements, run_check=False)
