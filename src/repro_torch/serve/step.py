"""Serving-step builders: prefill and single-token decode, mesh-aware.

The reference's builders and stand-ins: ``*_sds`` give ``meta``-device
tensors (shapes and dtypes, no storage), ``cache_specs`` the cache
layout (batch over the data axes, the largest divisible dim — the
cache sequence/width dim — over 'model'; page pools page-sharded).

On a mesh the built functions take the parameters as DTensors laid out
by the param specs and this rank's rows of the batch (the batch specs'
layout), and return this rank's rows of the logits and caches, whole.
A prefill computes tensor-parallel: the dense blocks' weights move to
the layout of :func:`repro_torch.models.transformer.dense_mesh_layout`
(the rank's heads, FF slice and vocab range), the MoE experts to their
expert- or tensor-parallel layout
(:func:`repro_torch.models.transformer._moe_apply`), every other weight
is gathered whole; the K/V of the local heads and the logits of the
local vocab are gathered over 'model'.  A decode step gathers every
weight whole and takes the MoE's single-device path, as the
reference's does.
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
from repro_torch.models.moe import is_expert_weight
from repro_torch.models.params import tree_map, tree_paths
from repro_torch.train.step import make_ctx

__all__ = ["build_prefill", "build_decode", "build_decode_paged",
           "prefill_batch_sds", "decode_inputs_sds", "cache_specs",
           "cache_sds", "paged_cache_sds", "forward_params"]


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


def _map_arrays(fn, tree: Any) -> Any:
    """``fn`` on every tensor of a cache tree: dicts, lists and the
    cache dataclasses (their tensor fields; ``None`` and flags kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_arrays(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_arrays(fn, v) for v in tree)
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


def forward_params(params: Any, mesh, *, keep_experts: bool,
                   model=None) -> Any:
    """The parameters a rank computes with: every DTensor gathered whole
    (no copy where the mesh does not cut it), except, with
    ``keep_experts``, the MoE experts, left as DTensors for the MoE's
    mesh path to move, and, with ``model``, the dense blocks' weights,
    moved to :func:`~repro_torch.models.transformer.dense_mesh_layout`'s
    layout (the local pieces).  Plain tensors pass unchanged."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import to_placements
    from repro_torch.models.transformer import dense_mesh_layout, \
        dense_weight_key

    if mesh is None:
        return params
    dense = {} if model is None else dense_mesh_layout(model.cfg, mesh)
    paths = iter(tree_paths(params))

    def one(t):
        path = next(paths)
        if not isinstance(t, DTensor):
            return t
        if keep_experts and is_expert_weight(path):
            return t
        spec, _ = dense.get(dense_weight_key(model, path), ((), False))
        return C.local_at(t, mesh, to_placements(spec, mesh))
    return tree_map(one, params)


def _rows(t: Any) -> Any:
    """This rank's rows of a batch input (whole along its other dims)."""
    from repro_torch.dist.collectives import local_rows
    return local_rows(t)


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
    """
    ctx = make_ctx("decode", mesh=mesh, cache_len=shape.seq_len,
                   tuner=tuner)

    def decode(params, token, cache, pos):
        params = forward_params(params, mesh, keep_experts=False)
        return model.decode_step(params, _rows(token), cache, pos, ctx)

    if mesh is None:
        return decode, None, None
    p_specs = partition_params(model, cfg, mesh)
    c_specs = cache_specs(cache_sds(model, cfg, shape), mesh)
    t_spec = (divisible_axes(shape.global_batch, data_axes(mesh), mesh),
              None)
    return decode, p_specs, (t_spec, c_specs, ())


def build_decode_paged(model, cfg: ArchConfig, *, slots: int,
                       n_pages: int, page_size: int, table_pages: int,
                       mesh, tuner=None):
    """Paged twin of :func:`build_decode` for the continuous-batching
    scheduler's step shapes.

    Returns (decode_fn, param_specs, (token, pool, pos, table) specs).
    ``pos`` is (slots,) per-sequence positions and ``table``
    (slots, table_pages) the page table — both batch-sharded over the
    data axes; the pool is page-sharded 2D via cache_specs/paged_spec.
    """
    cache_len = table_pages * page_size
    ctx = make_ctx("decode", mesh=mesh, cache_len=cache_len, tuner=tuner)

    def decode(params, token, pool, pos, table):
        params = forward_params(params, mesh, keep_experts=False)
        return model.decode_step(params, _rows(token), pool, _rows(pos),
                                 ctx, _rows(table))

    if mesh is None:
        return decode, None, None
    p_specs = partition_params(model, cfg, mesh)
    pool_specs = cache_specs(paged_cache_sds(model, n_pages, page_size),
                             mesh)
    slot_entry = divisible_axes(slots, data_axes(mesh), mesh)
    return decode, p_specs, ((slot_entry, None), pool_specs,
                             (slot_entry,), (slot_entry, None))
