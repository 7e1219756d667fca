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
  gradient is this rank's piece of the (replicated) output's;
* :func:`reduce_scatter` — the group's sum cut along a dim, each rank
  keeping its block; the gradient is the group's blocks of it joined
  (an all-gather), :func:`all_gather`'s dual.

The tensor-parallel dense layers (Megatron's f / g: :func:`copy_to` on
a block's input, :func:`reduce_from` on its output) run on a rank's
:class:`TPGroup` of the 'model' axis, and the vocab-parallel pieces of
the embedding and the loss are here too: :func:`vocab_range` (a
rank's ⌈V / size⌉ rows, the last range shorter where the axis does not
divide V), :func:`vocab_embed` (the rows of the rank's vocab range,
summed over the group), :func:`vocab_logz`
(the log-partition over the whole vocab from the local logits: the max
and the sum of exponentials over the group) and :func:`vocab_gold` (the
label's logit, held by one rank, summed over the group).

A decode step reads a cache cut on its sequence over 'model', or a page
pool cut on its pages over the data axes, as a split softmax
(split-KV): each rank attends over its own slots and
:func:`softmax_combine` merges the ranks' partial outputs;
:func:`softmax_combine_local` is its collective-free twin over a list
of chunks.  Neither has a gradient (a decode runs under ``no_grad``).
:func:`gather_rows` joins the ranks' rows of a batch over the axes
that cut it, :func:`row_index` gives a rank's place in that order.

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
           "reduce_scatter", "TPGroup", "vocab_range", "vocab_embed", "vocab_logz",
           "vocab_gold",
           "softmax_combine", "softmax_combine_local", "gather_rows",
           "row_index", "local_at", "local_rows", "rows_placements",
           "relay_rows", "distribute", "replicated", "partial_over",
           "axis_size"]


def axis_size(mesh, axis: str) -> int:
    """The size of one named mesh axis (of a torch ``DeviceMesh`` or a
    :class:`~repro_torch.dist.sharding.MeshShape`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return int(mesh.shape[axis])
    return int(mesh.size(list(names).index(axis)))


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


def _gather_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((dist.get_world_size(group) * xt.shape[0],
                        *xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return _gather_along(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` joined along ``dim`` in rank order (every rank's
    piece the same shape); the gradient is this rank's piece."""
    return _AllGather.apply(x, group, dim)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((xt.shape[0] // dist.get_world_size(group),
                            *xt.shape[1:]))
        dist.reduce_scatter_tensor(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g, ctx.group, ctx.dim), None, None


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of the sum of ``x`` over ``group``: dim ``dim``
    of the sum cut into group-size equal blocks in rank order, rank r
    keeping block r; the gradient is every rank's block of it joined
    along ``dim`` (an all-gather: the output's gradient differs between
    ranks, and each rank's ``x`` fed every block)."""
    return _ReduceScatter.apply(x, group, dim)


def vocab_range(vocab: int, size: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of the vocabulary rows rank ``rank`` of a ``size``-way
    cut computes: ⌈V / size⌉ a rank in rank order, the last range
    shorter where size does not divide V (empty past V: the model takes
    a range only where no rank's is)."""
    per = -(-vocab // size)
    lo = min(rank * per, vocab)
    return lo, min(lo + per, vocab)


def vocab_embed(w: torch.Tensor, ids: torch.Tensor, tp: TPGroup,
                lo: int | None = None) -> torch.Tensor:
    """Rows of an embedding cut on the vocab over ``tp`` (``w``: this
    rank's rows, the ids ``[lo, lo + len(w))``; ``lo`` defaults to
    ``tp.rank * len(w)``, the even cut's): each rank looks up the ids of
    its range and zeroes the others, the sum over the group is the
    lookup."""
    n = w.shape[0]
    local = ids.long() - (tp.rank * n if lo is None else lo)
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


def vocab_gold(logits: torch.Tensor, labels: torch.Tensor, tp: TPGroup,
               lo: int | None = None) -> torch.Tensor:
    """The logit of each label from logits cut on their last dim over
    ``tp`` (this rank's columns, the labels ``[lo, lo + n)``; ``lo``
    defaults to ``tp.rank * n``, the even cut's): the rank whose range
    holds the label gives it, the others 0, summed over the group."""
    n = logits.shape[-1]
    local = labels.long() - (tp.rank * n if lo is None else lo)
    hit = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = torch.where(hit, gold, torch.zeros((), dtype=gold.dtype,
                                              device=gold.device))
    return reduce_from(gold, tp.group)


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: a decode step runs "
                           "under torch.no_grad()")


def softmax_combine(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                    group) -> torch.Tensor:
    """The softmax-weighted output over the slots of every rank of
    ``group`` from each rank's partial over its own slots: ``o`` (...,
    Dv) the fp32 sum of exp(score - m) x value, not normalised, ``m``
    (...) the max score, ``l`` (...) the sum of exp(score - m).
    ``group`` is a process group, or a sequence of them (the slots cut
    over several mesh axes: the max and the sums are taken over each in
    turn; an empty one combines nothing).

    M is the max of ``m`` over the group; o·exp(m - M) and l·exp(m - M)
    are summed over it (one all-reduce), then divided.  A rank whose
    slots are all masked (m = -1e30, the decode's mask value) weighs
    exp(m - M) = 0 beside any rank with a valid slot.  The division
    comes after the value product, so one rank is not bitwise
    ``torch.softmax``'s result.  No gradient: raises under grad.
    """
    _refuse_grad("softmax_combine", o, m, l)
    groups = tuple(group) if isinstance(group, (list, tuple)) else (group,)
    top = m.clone()
    for g in groups:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
    w = torch.exp(m - top)
    both = torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1)
    for g in groups:
        dist.all_reduce(both, group=g)
    return both[..., :-1] / both[..., -1:]


def softmax_combine_local(parts: Sequence[tuple]) -> torch.Tensor:
    """:func:`softmax_combine` over a list of ``(o, m, l)`` partials of
    one tensor's chunks, with no collective."""
    _refuse_grad("softmax_combine_local", *(t for p in parts for t in p))
    top = parts[0][1]
    for _, m, _ in parts[1:]:
        top = torch.maximum(top, m)
    num = sum(o * torch.exp(m - top)[..., None] for o, m, _ in parts)
    den = sum(l * torch.exp(m - top) for _, m, l in parts)
    return num / den[..., None]


def row_index(mesh, axes: Sequence[str]) -> int:
    """This rank's block of a batch cut over ``axes`` (mesh order, the
    first outermost): the batch's rows ``[i * b_loc, (i + 1) * b_loc)``."""
    i = 0
    for a in axes:
        i = i * axis_size(mesh, a) + int(mesh.get_local_rank(a))
    return i


def gather_rows(x: torch.Tensor, mesh, axes: Sequence[str]
                ) -> torch.Tensor:
    """The whole batch from each rank's rows ``x`` (dim 0) cut over
    ``axes``, in the batch's order (:func:`row_index`)."""
    for a in reversed(tuple(axes)):
        x = all_gather(x, mesh.get_group(a), dim=0)
    return x


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
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    return local_at(t, t.device_mesh, rows_placements(t.placements))


def distribute(t: torch.Tensor, mesh, spec: tuple):
    """A DTensor laid out by ``spec`` from the whole tensor ``t``, which
    every rank holds: each keeps its own piece (no communication, and
    no copy where the mesh does not cut ``t``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import to_placements

    placements = to_placements(spec, mesh)
    return DTensor.from_local(local_at(t, mesh, placements).contiguous(),
                              mesh, placements, run_check=False)


def rows_placements(placements: Sequence) -> tuple:
    """``placements`` with every cut but that of dim 0 (the rows)
    replaced by ``Replicate``: the layout :func:`local_rows` gives."""
    from torch.distributed.tensor import Replicate

    return tuple(p if not p.is_shard() or p.dim == 0 else Replicate()
                 for p in placements)


def relay_rows(rows: torch.Tensor, mesh, placements: Sequence):
    """The DTensor laid out by ``placements`` from this rank's rows
    ``rows`` of it (cut on dim 0 as ``placements`` cut it, whole along
    the other dims): each rank keeps its piece of the rows, with no
    communication (:func:`local_rows`'s inverse)."""
    from torch.distributed.tensor import DTensor

    at = DTensor.from_local(rows, mesh, rows_placements(placements),
                            run_check=False)
    return DTensor.from_local(local_at(at, mesh, placements).contiguous(),
                              mesh, tuple(placements), run_check=False)
