"""Serving-step builders: prefill and single-token decode, mesh-aware.

The reference's builders and stand-ins: ``*_sds`` give ``meta``-device
tensors (shapes and dtypes, no storage), ``cache_specs`` the cache
layout (batch over the data axes, the largest divisible dim — the
cache sequence/width dim — over 'model'; page pools page-sharded).

On a mesh the built functions take the parameters as DTensors laid out
by the param specs and this rank's rows of the batch (the batch specs'
layout).  The dense blocks' weights move to the layout of
:func:`repro_torch.models.transformer.dense_mesh_layout` (the rank's
heads, FF slice and vocab range), and every weight neither they nor
the MoE place is gathered whole.  A prefill returns this rank's rows of
the logits and caches, whole: the MoE experts move to their expert- or
tensor-parallel layout (:func:`repro_torch.models.transformer.
_moe_apply`), the K/V of the local heads and the logits of the local
vocab are gathered over 'model'.  A decode step takes the caches as
DTensors in the layout of :func:`cache_specs` (:func:`shard_cache` lays
a prefill's out so) and returns them in it: an attention cache cut on
its sequence is read split-KV in place, the RG-LRU's state and the
mLSTM's matrix memory cut as the layer computes are read in place, as
are the encoder-decoder's cross K/V cut on their frames or head dim,
every other cache with its rows whole.  A decode step computes only
the rank's share: GQA attention on the rank's heads, or on the stored
columns of ``wq``, ``wk`` and ``wv`` where 'model' does not divide the
heads or the KV heads (no weight moved), and the MoE routes the whole
batch onto each rank's experts where they are stored, the mesh axes
that do not cut the experts splitting their slot rows
(:func:`repro_torch.models.moe.apply_moe_decode`).  A
paged decode step takes its page pools in :func:`cache_specs`' layout
and reads each split-KV over its pages, in place
(:func:`build_decode_paged`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.dist.sharding import (
    auto_spec,
    batch_specs,
    data_axes,
    divisible_axes,
    paged_spec,
    partition_params,
)
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.moe import is_expert_weight, is_shared_weight
from repro_torch.models.params import tree_map, tree_paths
from repro_torch.train.step import make_ctx

__all__ = ["build_prefill", "build_decode", "build_decode_paged",
           "prefill_batch_sds", "decode_inputs_sds", "cache_specs",
           "cache_sds", "paged_cache_sds", "forward_specs", "forward_params",
           "shard_cache"]


def prefill_batch_sds(cfg: ArchConfig, shape: ShapeSpec,
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    b, s = shape.global_batch, shape.seq_len
    sds = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    if cfg.family == "audio":
        sds["audio_emb"] = torch.empty((b, cfg.encoder_len, cfg.d_model),
                                       dtype=dtype, device="meta")
    return sds


def cache_sds(model, cfg: ArchConfig, shape: ShapeSpec,
              dtype: torch.dtype = torch.bfloat16) -> Any:
    """The decode cache on the ``meta`` device (no allocation): one
    entry per layer, batch at dim 0."""
    ctx = make_ctx("decode", cache_len=shape.seq_len)
    return model.init_cache(shape.global_batch, ctx, dtype, device="meta")


def paged_cache_sds(model, n_pages: int, page_size: int,
                    dtype: torch.dtype = torch.bfloat16) -> Any:
    """The page pools on the ``meta`` device (no allocation)."""
    ctx = make_ctx("decode", cache_len=0)
    return model.init_paged_cache(n_pages, page_size, ctx, dtype,
                                  device="meta")


def _is_pool(x: Any) -> bool:
    from repro_torch.serve.kv_cache import PagedKV, PagedLatent
    return isinstance(x, (PagedKV, PagedLatent))


def _map_arrays(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` on every tensor of a cache tree (dicts, lists and the cache
    dataclasses' tensor fields; ``None`` and flags kept), with the
    matching leaves of the trees ``rest`` of the same structure (a
    spec tree's leaves are its specs)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_arrays(fn, getattr(tree, f.name),
                                *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_arrays(fn, v, *rs)
                          for v, *rs in zip(tree, *rest))
    return tree


def _segment_specs(tree: Any, mesh, *, batch_dim: int,
                   page_dim: int) -> Any:
    """Leaf specs for one cache segment: contiguous caches batch-shard
    via auto_spec, paged pools (batch-dim-free) page-shard via
    paged_spec — both 2D (data x model) on the same array."""
    def node_spec(node):
        if _is_pool(node):
            return _map_arrays(
                lambda t: paged_spec(t.shape, mesh, page_dim=page_dim), node)
        return _map_arrays(
            lambda t: auto_spec(t.shape, mesh, batch_dim=batch_dim), node)
    if isinstance(tree, list):
        return [node_spec(n) for n in tree]
    return node_spec(tree)


def cache_specs(cache_abstract: Any, mesh) -> Any:
    """Spec tree for decode caches (contiguous or paged).

    The port's caches are one entry per layer, batch (or the page dim)
    at dim 0.  A tree in the reference's segment layout (``prefix`` /
    ``scan`` / ``suffix``, the scanned unit's caches stacked (R, B,
    ...)) takes the reference's rule: batch (or page) dim 1 in ``scan``,
    0 elsewhere.
    """
    if isinstance(cache_abstract, dict) and "scan" in cache_abstract:
        return {
            "prefix": _segment_specs(cache_abstract["prefix"], mesh,
                                     batch_dim=0, page_dim=0),
            "scan": _segment_specs(cache_abstract["scan"], mesh,
                                   batch_dim=1, page_dim=1),
            "suffix": _segment_specs(cache_abstract["suffix"], mesh,
                                     batch_dim=0, page_dim=0),
        }
    return _segment_specs(cache_abstract, mesh, batch_dim=0, page_dim=0)


def decode_inputs_sds(model, cfg: ArchConfig, shape: ShapeSpec,
                      dtype: torch.dtype = torch.bfloat16) -> tuple:
    """(token, cache, pos) stand-ins for the decode serve_step."""
    b = shape.global_batch
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    cache = cache_sds(model, cfg, shape, dtype)
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return token, cache, pos


def forward_specs(paths: Any, mesh, *, keep_experts: bool,
                  model=None, decode: bool = False) -> list:
    """The spec a rank computes each parameter with, by its path in
    ``paths``: None for a MoE routed or shared expert with
    ``keep_experts`` (left where it is stored, for the MoE's mesh path:
    a prefill moves the routed experts to their EP or TP layout and
    gathers the shared experts whole, as the reference's ``shard_map``
    takes them; a decode computes both where they are stored); with
    ``model``, a dense block's weight at its
    :func:`~repro_torch.models.transformer.dense_mesh_layout` spec (a
    decode step's with ``decode``); every other weight ``()``, whole.
    The rule :func:`forward_params` applies; ``mesh`` may be a
    :class:`~repro_torch.dist.sharding.MeshShape`."""
    from repro_torch.models.transformer import dense_mesh_layout, \
        dense_weight_key

    dense = {} if model is None else dense_mesh_layout(model.cfg, mesh,
                                                       decode=decode)
    return [None if keep_experts and (is_expert_weight(path)
                                      or is_shared_weight(path)) else
            dense.get(dense_weight_key(model, path), ((), False))[0]
            for path in paths]


def forward_params(params: Any, mesh, *, keep_experts: bool,
                   model=None, decode: bool = False) -> Any:
    """The parameters a rank computes with: each DTensor moved to its
    :func:`forward_specs` spec, the local piece (no copy where the mesh
    does not cut it), or left as it is where that is None.  Plain
    tensors pass unchanged."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import to_placements

    if mesh is None:
        return params
    specs = iter(forward_specs(tree_paths(params), mesh,
                               keep_experts=keep_experts, model=model,
                               decode=decode))

    def one(t):
        spec = next(specs)
        if not isinstance(t, DTensor) or spec is None:
            return t
        return C.local_at(t, mesh, to_placements(spec, mesh))
    return tree_map(one, params)


def _rows_cut(ctx, entry) -> Any:
    """``ctx`` whose ``batch_axes`` are the axes of the batch's spec entry
    ``entry``: the decode's MoE (and a paged step's page read) gathers
    the rows over them."""
    axes = () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)
    return dataclasses.replace(ctx, batch_axes=axes)


def _rows(t: Any) -> Any:
    """This rank's rows of a batch input (whole along its other dims)."""
    from repro_torch.dist.collectives import local_rows
    return local_rows(t)


def shard_cache(cache: Any, mesh, specs: Any) -> Any:
    """A prefill's caches (this rank's rows, whole along the other dims,
    as :func:`build_prefill` returns them) as DTensors laid out by
    ``specs`` (:func:`build_decode`'s cache specs): each rank keeps its
    piece of its rows, with no communication."""
    from repro_torch.dist.collectives import relay_rows
    from repro_torch.dist.sharding import to_placements

    return _map_arrays(lambda t, spec: relay_rows(
        t, mesh, to_placements(spec, mesh)), cache, specs)


def _split_view(cache: Any, tp) -> Any:
    """An attention layer's cache as the decode reads it split-KV: a
    :class:`~repro_torch.models.layers.SplitKV` of its local pieces when
    'model' cuts every tensor of it on the sequence (dim 1), or cuts
    nothing on a one-rank axis; else None."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.dist.sharding import TP_AXIS
    from repro_torch.models.layers import KVCache, SplitKV
    from repro_torch.models.mla import MLACache

    if tp is None or not isinstance(cache, (KVCache, MLACache)):
        return None
    ts = [getattr(cache, f.name) for f in dataclasses.fields(cache)
          if isinstance(getattr(cache, f.name), torch.Tensor)]
    if not all(isinstance(t, DTensor) for t in ts):
        return None
    i = list(ts[0].device_mesh.mesh_dim_names).index(TP_AXIS)
    if tp.size > 1 and any(t.placements[i] != Shard(1) for t in ts):
        return None
    return SplitKV(_map_arrays(lambda t: t.to_local(), cache), tp)


def _state_view(state: Any, tp, cuts: dict[str, int]
                ) -> tuple[Any, dict[str, str]]:
    """A recurrent layer's state as its cut mixer's decode reads it
    (``cuts``: field -> the dim the rank computes on its slice of,
    :func:`~repro_torch.models.transformer.state_slices`), and how each
    field was taken: ``local``, a field of ``cuts`` that 'model' cuts
    on that dim (or cuts nothing on a one-rank axis), its local piece
    read in place; ``slice``, such a field laid out otherwise, its rows
    gathered whole and narrowed to the rank's slice; ``rows``, any
    other field, its rows whole."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.dist.collectives import local_rows, rows_placements
    from repro_torch.dist.sharding import TP_AXIS

    out, how = {}, {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        dim = cuts.get(f.name)
        if not isinstance(t, torch.Tensor):
            continue
        if dim is None:
            out[f.name], how[f.name] = local_rows(t), "rows"
            continue
        if isinstance(t, DTensor):
            i = list(t.device_mesh.mesh_dim_names).index(TP_AXIS)
            want = list(rows_placements(t.placements))
            want[i] = Shard(dim)
            if list(t.placements) == want or (
                    tp.size == 1 and list(rows_placements(t.placements))
                    == list(t.placements)):
                out[f.name], how[f.name] = t.to_local(), "local"
                continue
        n = t.shape[dim] // tp.size
        out[f.name] = local_rows(t).narrow(dim, tp.rank * n, n)
        how[f.name] = "slice"
    return dataclasses.replace(state, **out), how


def _cross_view(k: Any, v: Any, tp) -> dict:
    """The encoder-decoder's cross K/V (B, Sk, H, Dh) as its decode reads
    them: ``{"cross": CrossKV}`` of their local pieces where 'model' cuts
    both alike on the frames (dim 1) or the head dim (dim 3) — a
    one-rank axis, which cuts nothing, counts as cutting the head dim —,
    read in place; else ``{"cross_k", "cross_v"}`` with their rows
    whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.collectives import rows_placements
    from repro_torch.dist.sharding import TP_AXIS
    from repro_torch.models.encdec import CrossKV

    if tp is not None and isinstance(k, DTensor) and isinstance(v, DTensor):
        i = list(k.device_mesh.mesh_dim_names).index(TP_AXIS)
        pk, pv = k.placements[i], v.placements[i]
        if pk == pv and pk.is_shard() and pk.dim in (1, 3):
            return {"cross": CrossKV(k.to_local(), v.to_local(), pk.dim, tp)}
        if tp.size == 1 and all(tuple(rows_placements(t.placements))
                                == tuple(t.placements) for t in (k, v)):
            return {"cross": CrossKV(k.to_local(), v.to_local(), 3, tp)}
    return {"cross_k": _rows(k), "cross_v": _rows(v)}


def _layer_view(cache: Any, tp, cuts: dict[str, int]
                ) -> tuple[Any, dict[str, str] | None]:
    """(a layer's cache as its decode reads it, how a recurrent state's
    fields were taken): a :class:`~repro_torch.models.layers.SplitKV`
    (:func:`_split_view`), a cut mixer's state (:func:`_state_view`), the
    encoder-decoder's ``{"self", "cross_k", "cross_v"}`` as its self
    cache's view beside its cross K/V's (:func:`_cross_view`), or the
    cache with its rows whole."""
    if isinstance(cache, dict) and "self" in cache:
        own, _ = _layer_view(cache["self"], tp, {})
        return {"self": own, **_cross_view(cache["cross_k"],
                                           cache["cross_v"], tp)}, None
    split = _split_view(cache, tp)
    if split is not None:
        return split, None
    if cuts:
        return _state_view(cache, tp, cuts)
    return _map_arrays(_rows, cache), None


def _laid_back(new: Any, old: Any, how: dict[str, str] | None = None,
               tp=None, cuts: dict[str, int] | None = None) -> Any:
    """A layer's cache after the step in ``old``'s layout: a split-KV
    cache was updated in place (the encoder-decoder's self cache too;
    its cross K/V are as they were); a recurrent state's field read in place
    (``how``: :func:`_state_view`'s) is the rank's new local piece, one
    narrowed to the rank's slice is gathered back over ``tp`` on its dim
    (``cuts``); any other is this rank's rows, each tensor laid out as
    ``old``'s (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.collectives import all_gather, relay_rows
    from repro_torch.models.layers import SplitKV

    if isinstance(new, SplitKV):
        return old
    if isinstance(old, dict) and "self" in old:
        # the encoder's K/V are read, never written, by a decode step
        return {"self": _laid_back(new["self"], old["self"]),
                "cross_k": old["cross_k"], "cross_v": old["cross_v"]}
    if how is None:
        return _map_arrays(lambda n, o: relay_rows(n, o.device_mesh,
                                                   o.placements)
                           if isinstance(o, DTensor) else n, new, old)
    out = {}
    for name, h in how.items():
        n, o = getattr(new, name), getattr(old, name)
        if h == "slice":
            n = all_gather(n, tp.group, dim=cuts[name])
        if not isinstance(o, DTensor):
            out[name] = n
        elif h == "local":
            out[name] = DTensor.from_local(n.contiguous(), o.device_mesh,
                                           o.placements, run_check=False)
        else:
            out[name] = relay_rows(n, o.device_mesh, o.placements)
    return dataclasses.replace(new, **out)


def build_prefill(model, cfg: ArchConfig, shape: ShapeSpec, mesh,
                  tuner=None):
    """Returns (prefill_fn, param_specs, batch_specs); the specs are
    ``None`` without a mesh.

    ``tuner`` reaches every routine-aware call site through the Ctx, so
    a DispatchRecorder around the built function observes the
    prefill's routine mix — causal self-attention scores dispatch as
    SYRK, projections/MoE as GEMM.
    """
    ctx = make_ctx("prefill", mesh=mesh, cache_len=shape.seq_len,
                   remat=False, tuner=tuner)

    def prefill(params, batch):
        params = forward_params(params, mesh, keep_experts=True,
                                model=model)
        batch = {k: _rows(v) for k, v in batch.items()}
        if cfg.family == "audio":
            return model.prefill(params, batch, ctx)
        return model.prefill(params, batch["tokens"], ctx)

    if mesh is None:
        return prefill, None, None
    return (prefill, partition_params(model, cfg, mesh),
            batch_specs(cfg, shape, mesh))


def build_decode(model, cfg: ArchConfig, shape: ShapeSpec, mesh,
                 tuner=None):
    """Returns (decode_fn, param_specs, (token, cache, pos) specs).

    ``tuner`` reaches the decode call sites through the Ctx; the
    per-layer KV/latent cache updates dispatch as TRSM-adjacent events
    (sequential along the cache axis), observable by a recorder.

    On a mesh ``decode_fn(params, token, cache, pos)`` takes the
    parameters and the caches as DTensors laid out by the returned specs
    and the token as this rank's rows (or a DTensor by its spec), and
    returns this rank's rows of the logits and the caches in the layout
    it took them in, so that step n + 1 takes step n's output.  The
    decoder LM computes tensor-parallel (``Ctx.tp``): the embedding,
    the MLP and the logits on the rank's vocab range and FF slice, GQA
    attention on its heads (where 'model' does not divide them or the
    KV heads, on the stored columns of its weights, no weight moved);
    the MoE routes the whole batch onto the experts where they are
    stored, and a rank runs the grouped GEMMs on its block of their slot
    rows only (the mesh axes that do not cut the experts split the rows,
    :func:`~repro_torch.models.moe.slot_block`).  An attention layer's
    cache that the
    layout cuts on its sequence over 'model' (every tensor of it on dim
    1; on a one-rank axis the rank holds every slot) is read split-KV
    (:class:`~repro_torch.models.layers.SplitKV`) and written in place
    by the rank that holds the slot.  Where the RG-LRU and the xLSTM
    blocks compute on their widths, the sLSTM takes its stored columns
    of ``w_in``, ``w_rec`` and ``b``, and the RG-LRU's ``h`` and
    ``conv`` (cut on W) and the mLSTM's ``c`` and ``n`` (on their key
    dim) are read and replaced in place where the layout cuts them so
    (:func:`~repro_torch.models.transformer.state_slices`).  The
    encoder-decoder computes as the decoder LM does (its three
    attentions on the stored columns, its MLP on its FF slice, its
    lookup and logits on the rank's vocab rows) and reads its self
    cache split-KV and its cross K/V in place, cut on the frames or the
    head dim (:class:`~repro_torch.models.encdec.CrossKV`).  Every
    other cache (another cut dim, the mLSTM's ``m``, the sLSTM's state)
    is taken with its rows whole (gathered over 'model') and its update
    laid back out.
    """
    ctx = make_ctx("decode", mesh=mesh, cache_len=shape.seq_len,
                   tuner=tuner)
    if mesh is None:
        def decode(params, token, cache, pos):
            return model.decode_step(params, token, cache, pos, ctx)
        return decode, None, None

    from repro_torch.models.transformer import state_slices

    t_entry = divisible_axes(shape.global_batch, data_axes(mesh), mesh)
    ctx = _rows_cut(ctx, t_entry)
    plan = getattr(model, "plan", None)
    cuts = [state_slices(cfg, s.kind, ctx.tp.size) for s in plan] \
        if plan is not None and ctx.tp is not None else None

    def decode(params, token, cache, pos):
        params = forward_params(params, mesh, keep_experts=True,
                                model=model, decode=True)
        at = cuts or [{}] * len(cache)
        views = [_layer_view(c, ctx.tp, k) for c, k in zip(cache, at)]
        logits, new = model.decode_step(params, _rows(token),
                                        [v for v, _ in views], pos, ctx)
        return logits, [_laid_back(n, c, how, ctx.tp, k)
                        for n, c, (_, how), k in zip(new, cache, views, at)]

    p_specs = partition_params(model, cfg, mesh)
    c_specs = cache_specs(cache_sds(model, cfg, shape), mesh)
    return decode, p_specs, ((t_entry, None), c_specs, ())


def _page_view(pool: Any, mesh, ctx) -> Any:
    """A layer's page pool (DTensors in ``paged_spec``'s layout; a plain
    tensor is taken as whole on every rank) as the paged decode reads
    it: a :class:`~repro_torch.serve.kv_cache.PagedSplit` of its local
    pieces, with the axes that cut its pages read from its placements
    and, per field, the dim 'model' cuts."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.dist.collectives import replicated, row_index
    from repro_torch.dist.sharding import TP_AXIS
    from repro_torch.serve.kv_cache import PagedSplit

    names = tuple(mesh.mesh_dim_names)
    m = names.index(TP_AXIS)
    fields = {f.name: getattr(pool, f.name)
              for f in dataclasses.fields(pool)}
    where = {k: t.placements if isinstance(t, DTensor) else
             replicated(mesh) for k, t in fields.items()}
    # paged_spec cuts every field's pages alike
    first = next(iter(fields))
    axes = tuple(a for a, pl in zip(names, where[first]) if pl == Shard(0))
    cuts = {}
    for k, t in fields.items():
        pl = where[k][m]
        cuts[k] = pl.dim if pl.is_shard() else \
            t.dim() - 1 if mesh.size(m) == 1 else None
    local = dataclasses.replace(pool, **{
        k: t.to_local() if isinstance(t, DTensor) else t
        for k, t in fields.items()})
    return PagedSplit(local, lo=row_index(mesh, axes) * local.n_pages,
                      total=fields[first].shape[0],
                      pages=tuple(mesh.get_group(a) for a in axes),
                      mesh=mesh, rows=ctx.batch_axes, tp=ctx.tp, cuts=cuts)


def build_decode_paged(model, cfg: ArchConfig, *, slots: int,
                       n_pages: int, page_size: int, table_pages: int,
                       mesh, tuner=None):
    """Paged twin of :func:`build_decode` for the continuous-batching
    scheduler's step shapes.

    Returns (decode_fn, param_specs, (token, pool, pos, table) specs).
    ``pos`` is (slots,) per-sequence positions and ``table``
    (slots, table_pages) the page table — both batch-sharded over the
    data axes; the pool is page-sharded 2D via cache_specs/paged_spec.

    On a mesh ``decode_fn(params, token, pool, pos, table)`` takes the
    parameters and the pools as DTensors laid out by the returned specs,
    and token, ``pos`` and ``table`` as this rank's rows (or DTensors by
    their specs); it returns this rank's rows of the logits and the
    pools in their layout, written in place, so that step n + 1 takes
    step n's output.  The dense blocks compute on their shards and the
    MoE routes the whole batch onto the experts where they are stored
    (its capacity counts every slot), as in :func:`build_decode`; each
    pool is read split-KV over its pages
    (:class:`~repro_torch.serve.kv_cache.PagedSplit`): every slot's rows
    are gathered, each rank writes the new rows of the slots whose pages
    it stores and attends every slot over its pages, on its cut of the
    head dim (or latent widths, or KV heads) over 'model', and the
    partial softmaxes are merged over the axes that cut the pages.  No
    pool is gathered.  Any page table: a slot may read pages another
    rank stores, a hole reads page 0 as on one device, an inactive slot
    (pos -1) writes nothing.
    """
    cache_len = table_pages * page_size
    ctx = make_ctx("decode", mesh=mesh, cache_len=cache_len, tuner=tuner)
    if mesh is None:
        def decode(params, token, pool, pos, table):
            return model.decode_step(params, token, pool, pos, ctx, table)
        return decode, None, None

    slot_entry = divisible_axes(slots, data_axes(mesh), mesh)
    ctx = _rows_cut(ctx, slot_entry)

    def decode(params, token, pool, pos, table):
        params = forward_params(params, mesh, keep_experts=True,
                                model=model, decode=True)
        views = [_page_view(c, mesh, ctx) for c in pool]
        logits, _ = model.decode_step(params, _rows(token), views,
                                      _rows(pos), ctx, _rows(table))
        return logits, pool

    p_specs = partition_params(model, cfg, mesh)
    pool_specs = cache_specs(paged_cache_sds(model, n_pages, page_size),
                             mesh)
    return decode, p_specs, ((slot_entry, None), pool_specs,
                             (slot_entry,), (slot_entry, None))
