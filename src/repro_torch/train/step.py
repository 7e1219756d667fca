"""Train-step builder (loss -> grad -> AdamW), mesh-aware, and the
runtime context.

``build_train_step`` returns ``(step_fn, state_specs, batch_specs)``
with a mesh, ``(step_fn, None, None)`` without one, as the reference's
does.  On a mesh the state is a tree of DTensors laid out by the state
specs and the batch DTensors laid out by the batch specs; the step
computes as :func:`sharded_train_step` says.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from repro_torch.dist.sharding import TP_AXIS, data_axes
from repro_torch.kernels import recorder
from repro_torch.kernels.ops import BACKENDS
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.params import abstract_params, is_spec, \
    tree_leaves, tree_map, tree_paths
from repro_torch.models.transformer import Ctx
from repro_torch.train.optim import STATE_MOMENTS, AdamWConfig, \
    adamw_update, init_state

__all__ = ["make_ctx", "build_train_step", "init_train_state",
           "abstract_state", "train_batch_sds"]


def make_ctx(mode: str, *, mesh=None, cache_len: int = 0,
             remat: bool = True, tuner=None, backend: str = "auto") -> Ctx:
    """Ctx for ``mode`` (train | prefill | decode), on one device or on
    ``mesh`` (a torch ``DeviceMesh``, or a ``MeshShape`` for deriving
    specs only; its data axes are every axis but 'model').  On a
    ``DeviceMesh`` every mode carries the rank's 'model' group
    (``Ctx.tp``): the dense blocks compute on their shards, and a decode
    step reads its sequence-cut caches split-KV over the group.

    Training runs on the ``library`` backend on any device, whatever
    ``backend`` says: no CUDA kernel has a backward.
    ``ADSALA_KV_INT8=1`` switches the serving caches (prefill and
    decode) to int8, as in the reference.
    """
    kv_q = (os.environ.get("ADSALA_KV_INT8") == "1"
            and mode in ("prefill", "decode"))
    if mode == "train":
        backend = "library"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if mesh is None:
        return Ctx(mode=mode, cache_len=cache_len, remat=remat,
                   tuner=tuner, kv_quantized=kv_q, backend=backend)
    tp = None
    if hasattr(mesh, "get_group"):
        from repro_torch.dist.collectives import TPGroup
        tp = TPGroup.of(mesh, TP_AXIS)
    return Ctx(mode=mode, mesh=mesh, dp_axes=data_axes(mesh),
               tp_axis=TP_AXIS, tp=tp,
               cache_len=cache_len, remat=remat, tuner=tuner,
               kv_quantized=kv_q, backend=backend)


def abstract_state(model, cfg: ArchConfig, opt_cfg: AdamWConfig,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The train state as tensors on the ``meta`` device (no storage):
    parameters in ``dtype``, fp32 moments (and ``ef`` when compressing),
    an int32 step."""
    p = abstract_params(model.defs, dtype)

    def f32() -> Any:
        return tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                              device="meta"), p)

    state: dict = {"params": p}
    for key in STATE_MOMENTS:
        state[key] = f32()
    state["step"] = torch.empty((), dtype=torch.int32, device="meta")
    if opt_cfg.compress:
        state["ef"] = f32()
    return state


def train_batch_sds(cfg: ArchConfig, shape: ShapeSpec,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """One global training batch as ``meta`` tensors."""
    b, s = shape.global_batch, shape.seq_len
    sds = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta"),
           "labels": torch.empty((b, s), dtype=torch.int32, device="meta")}
    if cfg.family == "audio":
        sds["audio_emb"] = torch.empty((b, cfg.encoder_len, cfg.d_model),
                                       dtype=dtype, device="meta")
    return sds


def build_train_step(model, cfg: ArchConfig,
                     opt_cfg: AdamWConfig | None = None, tuner=None, *,
                     shape: ShapeSpec | None = None, mesh=None):
    """Returns ``(train_step, state_specs, batch_specs)``: the specs are
    ``None`` without ``mesh``; with one, ``shape`` gives the batch.

    ``train_step(state, batch) -> (state, metrics)``: the loss on
    ``batch`` (``tokens`` / ``labels`` (B, S) int tensors on the state's
    device), its gradients by autograd, then one in-place
    :func:`~repro_torch.train.optim.adamw_update`.  Metrics: ``loss``,
    ``grad_norm``, ``lr`` (scalar tensors).

    ``tuner`` is threaded to every routine-aware call site via the Ctx;
    the step also tags the backward-pass contractions: for each forward
    event the recorder collected during the loss, the two transposed
    gemm shapes (dX, dW) are recorded, so a recorded train step shows
    forward *and* backward dispatch volume.  Each layer is recomputed
    in the backward pass (remat), and the recomputation records nothing
    (see :func:`~repro_torch.kernels.recorder.suppressed`).
    """
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh is not None:
        if shape is None:
            raise ValueError("build_train_step on a mesh needs the batch "
                             "shape")
        return sharded_train_step(model, cfg, shape, mesh, opt_cfg, tuner)
    ctx = make_ctx("train", tuner=tuner)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        # fresh leaves that share the state's storage: the state's own
        # tensors never require grad, so the in-place update needs no
        # bookkeeping
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state["params"])
        n0 = recorder.active_event_count()
        loss = model.loss(params, batch, ctx)
        leaves = tree_leaves(params)
        grad_leaves = torch.autograd.grad(loss, leaves)
        del params, leaves
        recorder.record_backward(since=n0, tuner=tuner)
        it = iter(grad_leaves)
        grads = tree_map(lambda _: next(it), state["params"])
        new_state, metrics = adamw_update(state, grads, opt_cfg)
        metrics["loss"] = loss.detach()
        return new_state, metrics

    return train_step, None, None


def sharded_train_step(model, cfg: ArchConfig, shape: ShapeSpec, mesh,
                       opt_cfg: AdamWConfig, tuner=None):
    """The mesh half of :func:`build_train_step`: ``(step, state specs,
    batch specs)``; ``step.value_and_grad(state, batch)`` is the step
    without its update.

    The state's DTensors keep the reference's layout (its state specs);
    a rank computes the decoder LM's dense blocks as the reference's
    GSPMD partitions them:

    * each weight is moved to the layout it is computed with and the
      model sees the local piece: the dense blocks' weights to
      :func:`~repro_torch.models.transformer.dense_mesh_layout`'s (the
      vocab, whole heads and the FF width cut over 'model'), the MoE
      experts to their expert- or tensor-parallel path's
      (:func:`~repro_torch.models.transformer.moe_mesh_layout`), every
      other weight gathered whole;
    * each rank differentiates its own group's loss
      (:mod:`repro_torch.dist.collectives`: activations are whole on
      every rank of 'model' between the blocks, so a rank's gradient of
      a whole weight it uses as the others do is the whole gradient);
      each gradient is averaged over the data axes and moved to its
      parameter's stored layout; a gradient the layout marks partial
      (each rank's term from its own heads: picked KV columns, the qk
      norms, the columns and rows of an uneven head range) is summed
      over 'model' on the way (a reduce-scatter where
      the stored layout cuts it); MLA's weights need no such sum (its
      heads' columns and rows are computed and stored alike, and its
      latents' gradients are summed where they fork into the heads);
    * AdamW runs on the local shards, with the clipping norm and the
      int8 scales taken over whole tensors.

    Under remat each layer's forward runs again in the backward pass,
    and its collectives with it.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import batch_specs, partition_params, \
        state_specs, to_placements
    from repro_torch.models.moe import is_expert_weight
    from repro_torch.models.transformer import dense_mesh_layout, \
        dense_weight_key, moe_mesh_layout

    p_specs = partition_params(model, cfg, mesh)
    s_specs = state_specs(p_specs, compress=opt_cfg.compress)
    b_specs = batch_specs(cfg, shape, mesh)
    ctx = make_ctx("train", mesh=mesh, tuner=tuner)
    names = tuple(mesh.mesh_dim_names)
    dp_groups = [mesh.get_group(a) for a in ctx.dp_axes]
    n_dp = 1
    for a in ctx.dp_axes:
        n_dp *= C.axis_size(mesh, a)
    paths = tree_paths(model.defs)
    stored = [to_placements(sp, mesh)
              for sp in tree_leaves(p_specs, is_leaf=is_spec)]
    # the mesh dims that cut each parameter (sums and maxes over them)
    cuts = [[names[i] for i, pl in enumerate(pls)
             if pl.is_shard() and mesh.size(i) > 1] for pls in stored]
    _, w_specs, _ = moe_mesh_layout(cfg, mesh, shape.seq_len) \
        if cfg.n_experts else (None, {}, None)
    dense = dense_mesh_layout(cfg, mesh)
    expert = [is_expert_weight(path) for path in paths]
    laid = [(w_specs[path[-1]], False) if ex
            else dense.get(dense_weight_key(model, path), ((), False))
            for path, ex in zip(paths, expert)]
    compute = [to_placements(spec, mesh) for spec, _ in laid]
    # the layout of each gradient as autograd leaves it on a rank
    grad_at = [C.partial_over(mesh, pl, TP_AXIS) if part else pl
               for pl, (_, part) in zip(compute, laid)]

    def reduce(value: torch.Tensor, i: int, op: str) -> torch.Tensor:
        for axis in cuts[i]:
            dist.all_reduce(value, op=dist.ReduceOp.SUM if op == "sum"
                            else dist.ReduceOp.MAX,
                            group=mesh.get_group(axis))
        return value

    def value_and_grad(state: dict, batch: dict
                       ) -> tuple[torch.Tensor, dict]:
        """(this rank's loss, the gradients averaged over the data axes
        as local tensors in the stored layout)."""
        stored_leaves = tree_leaves(state["params"])
        local = [C.local_at(t, mesh, pl).detach().requires_grad_(True)
                 for t, pl in zip(stored_leaves, compute)]
        # the MoE moves its experts itself: they go in as DTensors
        fwd = [DTensor.from_local(t, mesh, pl, run_check=False) if ex
               else t for t, pl, ex in zip(local, compute, expert)]
        it = iter(fwd)
        params = tree_map(lambda _: next(it), state["params"])
        rows = {k: C.local_rows(v) for k, v in batch.items()}
        n0 = recorder.active_event_count()
        loss = model.loss(params, rows, ctx)
        grad_leaves = torch.autograd.grad(loss, local)
        del params, fwd, local
        recorder.record_backward(since=n0, tuner=tuner)
        grads = []
        with torch.no_grad():
            for g, pl_g, pl_s in zip(grad_leaves, grad_at, stored):
                g = g.contiguous()
                for group in dp_groups:
                    dist.all_reduce(g, group=group)
                if n_dp > 1:
                    g.div_(n_dp)
                grads.append(C.local_at(DTensor.from_local(
                    g, mesh, pl_g, run_check=False), mesh, pl_s))
        del grad_leaves
        it = iter(grads)
        return loss, tree_map(lambda _: next(it), state["params"])

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        loss, grads_tree = value_and_grad(state, batch)
        local_state = {k: tree_map(lambda t: t.to_local(), v)
                       for k, v in state.items()}
        new_local, metrics = adamw_update(local_state, grads_tree, opt_cfg,
                                          reduce=reduce)
        new_state = dict(state)
        new_state["step"] = DTensor.from_local(
            new_local["step"], mesh, C.replicated(mesh), run_check=False)
        loss = loss.detach().clone()
        for group in dp_groups:
            dist.all_reduce(loss, group=group)
        metrics["loss"] = loss / n_dp
        return new_state, metrics

    step.value_and_grad = value_and_grad
    return step, s_specs, b_specs


def init_train_state(model, cfg: ArchConfig, opt_cfg: AdamWConfig,
                     gen: torch.Generator,
                     dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters from ``gen`` (on ``gen``'s device) and zero
    AdamW moments."""
    return init_state(model.init(gen, dtype), opt_cfg)
