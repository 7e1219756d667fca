"""Port vs reference: the device-free spec derivation of the
distribution layer (``repro_torch.dist.sharding``, the spec half of
``models/params.py``, ``serve/step.py``'s cache specs), and the step
from a spec to DTensor placements.

Both packages read a mesh only through ``.shape`` / ``.axis_names``:
the reference gets the ``_FakeMesh`` stand-in of
tests/test_sharding_serving.py (its ``abstract_mesh`` fails under jax
0.9), the port its own ``MeshShape``.  A port spec is a tuple and must
equal ``tuple()`` of the reference's ``PartitionSpec`` entry for entry:

* every arch of the registry on both production meshes and two small
  ones: the rule table, the parameter specs (the reference's scanned
  unit unstacked into the port's per-layer list: its leading ``layers``
  entry is ``None``), the AdamW state specs with and without ``ef``,
  the train and prefill batch specs, the contiguous decode caches and
  the paged pools;
* the cases of tests/test_dist_sharding.py (which fails at collection
  under jax 0.9) and the spec cases of tests/test_sharding_serving.py;
* ``to_placements`` on a ``fake`` 512-rank (2, 16, 16) world: each
  rank's local shape and offset, and the piece ``distribute`` keeps,
  against the reference's ``NamedSharding`` index map on a 512-device
  JAX CPU mesh (one subprocess).
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.dist import sharding as JS
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import ShapeSpec as JShapeSpec
from repro.serve import step as JSTEP
from repro.train.step import train_batch_sds as jax_train_batch_sds
from repro_torch.configs import build_model, get_config, get_smoke_config
from repro_torch.dist import sharding as S
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.models.params import ParamDef, count_params, is_spec, \
    tree_leaves
from repro_torch.models.transformer import _segments
from repro_torch.serve import step as STEP
from repro_torch.train import step as TSTEP
from repro_torch.train.optim import AdamWConfig, init_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
MESHES = [SINGLE, MULTI, {"data": 2, "model": 4}, {"data": 1, "model": 2}]
MESH_IDS = ["16x16", "2x16x16", "2x4", "1x2"]


class _FakeMesh:
    """Just enough mesh surface for the reference's rule tables (no jax
    devices): tests/test_sharding_serving.py's stand-in."""

    def __init__(self, shape: dict[str, int]):
        self.shape = shape
        self.axis_names = tuple(shape)


def _jspecs(tree):
    """The reference's spec leaves as tuples, in jax's leaf order."""
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=JS.is_partition_spec)]


def _is_tuple_spec(x) -> bool:
    return isinstance(x, tuple) and is_spec(x)


def _tuple_leaves(tree):
    """Spec leaves (tuples) of a converted reference tree, in jax's
    order (cache dataclasses by their data fields)."""
    return jax.tree.leaves(tree, is_leaf=_is_tuple_spec)


def _pspecs(tree):
    return tree_leaves(tree, is_leaf=is_spec)


@functools.lru_cache(maxsize=None)
def _models(arch: str, smoke: bool = False):
    if smoke:
        return (jax_build_model(jax_smoke_config(arch)),
                build_model(get_smoke_config(arch)))
    return jax_build_model(jax_get_config(arch)), build_model(get_config(arch))


class _OnRepeatDim:
    """A reference cache spec that shards its scanned unit's repeat dim,
    a dim the port's per-layer caches do not have."""

    def __init__(self, spec):
        self.spec = spec


def _unstack(tree: dict, repeats: int, *, cache: bool = False) -> dict:
    """A reference spec (or cache) tree in prefix / scan / suffix layout
    -> the port's per-layer list, the scanned unit's leading entry
    dropped (it must be the replicated repeat dim; a cache spec that
    shards it is marked :class:`_OnRepeatDim`)."""
    def drop(spec):
        if cache and spec[0] is not None:
            return _OnRepeatDim(spec)
        assert spec[0] is None, spec
        return spec[1:]

    layers = list(tree["prefix"])
    unit = tree["scan"]
    for _ in range(repeats if unit else 0):
        layers += [jax.tree.map(drop, u, is_leaf=_is_tuple_spec)
                   for u in unit]
    layers += list(tree["suffix"])
    return layers


def _ref_param_leaves(jmodel, specs) -> list:
    """Reference param specs in the port's leaf order."""
    if "prefix" not in specs:
        return _jspecs(specs)
    as_tuples = jax.tree.map(tuple, specs, is_leaf=JS.is_partition_spec)
    port_layout = {k: v for k, v in as_tuples.items()
                   if k not in ("prefix", "scan", "suffix")}
    port_layout["layers"] = _unstack(as_tuples, jmodel.repeats)
    return _tuple_leaves(port_layout)


# ---------------------------------------------------------------------------
# every arch x mesh: rules, params, state, batch, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rules_and_specs_match_reference(arch, mesh_shape):
    jmodel, model = _models(arch)
    cfg = get_config(arch)
    rules = S.param_rules(cfg, S.MeshShape(mesh_shape), model.defs)
    jrules = JS.param_rules(jax_get_config(arch), _FakeMesh(mesh_shape),
                            jmodel.defs)
    assert jrules.pop("layers", None) is None
    assert rules == jrules
    got = _pspecs(S.partition_params(model, cfg, S.MeshShape(mesh_shape)))
    want = _ref_param_leaves(jmodel, JS.partition_params(
        jmodel, jax_get_config(arch), _FakeMesh(mesh_shape)))
    assert got == want
    assert _pspecs(model.param_partition_specs(rules)) == got
    assert count_params(model.defs) == sum(
        int(np.prod(d.shape)) for d in jax.tree.leaves(
            jmodel.defs, is_leaf=lambda x: hasattr(x, "axes")))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_match_reference(arch, mesh_shape, compress):
    jmodel, model = _models(arch)
    cfg = get_config(arch)
    p = S.partition_params(model, cfg, S.MeshShape(mesh_shape))
    jp = JS.partition_params(jmodel, jax_get_config(arch),
                             _FakeMesh(mesh_shape))
    got = S.state_specs(p, compress=compress)
    want = JS.state_specs(jp, compress=compress)
    assert set(got) == set(want)
    for key in got:
        if key == "step":
            assert got[key] == tuple(want[key]) == ()
        else:
            assert _pspecs(got[key]) == _ref_param_leaves(jmodel, want[key])
    # the abstract state carries the same keys and a leaf per spec
    state = TSTEP.abstract_state(model, cfg, AdamWConfig(compress=compress))
    assert set(state) == set(got)
    for key in got:
        leaves = tree_leaves(state[key])
        specs = _pspecs(got[key]) if key != "step" else [()]
        assert len(leaves) == len(specs)
        assert all(t.device.type == "meta" and len(s) == t.ndim
                   for t, s in zip(leaves, specs))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_reference(arch, mesh_shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in ("train_4k", "prefill_32k", "long_500k"):
        got = S.batch_specs(cfg, SHAPES[name], S.MeshShape(mesh_shape))
        want = JS.batch_specs(jcfg, JSHAPES[name], _FakeMesh(mesh_shape))
        assert got == {k: tuple(v) for k, v in want.items()}
    sds = TSTEP.train_batch_sds(cfg, SHAPES["train_4k"])
    jsds = jax_train_batch_sds(jcfg, JSHAPES["train_4k"])
    assert {k: tuple(v.shape) for k, v in sds.items()} == \
        {k: tuple(v.shape) for k, v in jsds.items()}
    pre = STEP.prefill_batch_sds(cfg, SHAPES["prefill_32k"])
    jpre = JSTEP.prefill_batch_sds(jcfg, JSHAPES["prefill_32k"])
    assert {k: tuple(v.shape) for k, v in pre.items()} == \
        {k: tuple(v.shape) for k, v in jpre.items()}


def _ref_cache_leaves(jmodel, specs) -> list:
    if isinstance(specs, dict) and "scan" in specs:
        as_tuples = jax.tree.map(tuple, specs, is_leaf=JS.is_partition_spec)
        return _tuple_leaves(_unstack(as_tuples, jmodel.repeats,
                                      cache=True))
    return _jspecs(specs)


def _cache_spec_leaves(tree) -> list:
    """Spec leaves of a port cache spec tree (dataclass fields in
    declaration order, None fields skipped), in the reference's order."""
    import dataclasses

    out = []

    def walk(node):
        if is_spec(node):
            out.append(node)
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                if v is not None and not isinstance(v, bool):
                    walk(v)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(tree)
    return out


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh_shape):
    """The decode cache at the production decode shape (128 x 32768),
    the port's per-layer list against the reference's segments."""
    jmodel, model = _models(arch)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape = SHAPES["decode_32k"]
    abs_ = STEP.cache_sds(model, cfg, shape)
    assert all(t.device.type == "meta" for t in _meta_leaves(abs_))
    got = _cache_spec_leaves(STEP.cache_specs(abs_, S.MeshShape(
        mesh_shape)))
    jabs = JSTEP.cache_sds(jmodel, jcfg, JSHAPES["decode_32k"])
    want = _ref_cache_leaves(jmodel, JSTEP.cache_specs(
        jabs, _FakeMesh(mesh_shape)))
    assert_cache_specs(got, want, _meta_leaves(abs_), mesh_shape)
    # the decode builder's token spec
    _, _, (t_spec, c_specs, pos) = STEP.build_decode(
        model, cfg, shape, S.MeshShape(mesh_shape))
    _, _, (jt, jc, jpos) = JSTEP.build_decode(
        jmodel, jcfg, JSHAPES["decode_32k"], _FakeMesh(mesh_shape))
    assert t_spec == tuple(jt) and pos == tuple(jpos) == ()
    assert _cache_spec_leaves(c_specs) == got


def assert_cache_specs(got: list, want: list, leaves: list,
                       mesh_shape: dict) -> None:
    """Port per-layer cache specs against the reference's, leaf for
    leaf.  Where the reference shards the scanned unit's repeat dim
    (xlstm's per-head states on a 2-way model axis: the repeat count is
    their largest dim), the per-layer leaf has no such dim and takes the
    same rule on its own dims (a recorded departure)."""
    assert len(got) == len(want) == len(leaves)
    for g, w, t in zip(got, want, leaves):
        if isinstance(w, _OnRepeatDim):
            assert w.spec[0] == "model"
            assert g == S.auto_spec(t.shape, S.MeshShape(mesh_shape))
        else:
            assert g == w


def _meta_leaves(tree) -> list:
    import dataclasses
    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(tree)
    return out


_PAGED = ["stablelm-1.6b", "granite-8b", "chatglm3-6b", "starcoder2-3b",
          "chameleon-34b", "deepseek-v2-236b"]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", _PAGED)
def test_paged_pool_specs_match_reference(arch, mesh_shape):
    jmodel, model = _models(arch)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    got = _cache_spec_leaves(STEP.cache_specs(
        STEP.paged_cache_sds(model, 256, 16), S.MeshShape(mesh_shape)))
    want = _ref_cache_leaves(jmodel, JSTEP.cache_specs(
        JSTEP.paged_cache_sds(jmodel, 256, 16), _FakeMesh(mesh_shape)))
    assert got == want
    _, p_specs, (tok, pool, pos, table) = STEP.build_decode_paged(
        model, cfg, slots=32, n_pages=256, page_size=16, table_pages=8,
        mesh=S.MeshShape(mesh_shape))
    _, jp_specs, (jtok, jpool, jpos, jtable) = JSTEP.build_decode_paged(
        jmodel, jcfg, slots=32, n_pages=256, page_size=16, table_pages=8,
        mesh=_FakeMesh(mesh_shape))
    assert (tok, pos, table) == (tuple(jtok), tuple(jpos), tuple(jtable))
    assert _cache_spec_leaves(pool) == got
    assert _pspecs(p_specs) == _ref_param_leaves(jmodel, jp_specs)


def _stack_like_reference(model, caches: list) -> dict:
    """The port's per-layer caches regrouped into the reference's
    prefix / scan / suffix layout, the unit's caches stacked (R, ...)
    as meta tensors."""
    import dataclasses

    pre, unit, reps, suf = _segments(model.plan)
    n0, nu = len(pre), len(unit)

    def stack(node):
        if isinstance(node, torch.Tensor):
            return torch.empty((reps,) + tuple(node.shape),
                               dtype=node.dtype, device="meta")
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{
                f.name: stack(getattr(node, f.name))
                for f in dataclasses.fields(node)
                if isinstance(getattr(node, f.name), torch.Tensor)})
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        return node

    return {"prefix": caches[:n0],
            "scan": [stack(c) for c in caches[n0:n0 + nu]] if reps else [],
            "suffix": caches[n0 + nu * reps:]}


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-2b",
                                  "deepseek-v2-236b", "xlstm-125m"])
def test_cache_specs_reference_layout_branch(arch, mesh_shape):
    """``cache_specs`` on a tree in the reference's segment layout takes
    the reference's rule (batch / page dim 1 in ``scan``) and gives the
    reference's specs, contiguous and (where the arch pages) paged."""
    jmodel, model = _models(arch)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    stacked = _stack_like_reference(model, STEP.cache_sds(
        model, cfg, SHAPES["decode_32k"]))
    got = STEP.cache_specs(stacked, S.MeshShape(mesh_shape))
    want = JSTEP.cache_specs(JSTEP.cache_sds(
        jmodel, jcfg, JSHAPES["decode_32k"]), _FakeMesh(mesh_shape))
    for seg in ("prefix", "scan", "suffix"):
        assert _cache_spec_leaves(got[seg]) == _jspecs(want[seg]), seg
    if arch in _PAGED:
        got = STEP.cache_specs(_stack_like_reference(
            model, STEP.paged_cache_sds(model, 256, 16)),
            S.MeshShape(mesh_shape))
        want = JSTEP.cache_specs(JSTEP.paged_cache_sds(jmodel, 256, 16),
                                 _FakeMesh(mesh_shape))
        for seg in ("prefix", "scan", "suffix"):
            assert _cache_spec_leaves(got[seg]) == _jspecs(want[seg]), seg


# ---------------------------------------------------------------------------
# tests/test_dist_sharding.py, case for case
# ---------------------------------------------------------------------------

M_SINGLE, M_MULTI = S.MeshShape(SINGLE), S.MeshShape(MULTI)


def test_divisible_axes_demotes_outermost_first():
    assert S.divisible_axes(48, ("pod", "data"), M_MULTI) == "data"
    assert S.divisible_axes(24, ("pod", "data"), M_MULTI) is None
    assert S.divisible_axes(64, ("pod", "data"), M_MULTI) == ("pod", "data")
    assert S.divisible_axes(51865, ("model",), M_SINGLE) is None
    assert S.divisible_axes({64, 24}, ("pod", "data"), M_MULTI) is None
    for dims, axes, mesh in ((48, ("pod", "data"), MULTI),
                             ({64, 24}, ("pod", "data"), MULTI),
                             (51865, ("model",), SINGLE)):
        assert S.divisible_axes(dims, axes, S.MeshShape(mesh)) == \
            JS.divisible_axes(dims, axes, _FakeMesh(mesh))


def test_param_rules_demote_per_arch():
    rules = S.param_rules(get_config("mixtral-8x22b"), M_SINGLE)
    assert rules["experts"] is None
    assert rules["expert_ff"] == "model"
    rules = S.param_rules(get_config("deepseek-v2-236b"), M_MULTI)
    assert rules["experts"] == ("pod", "data")
    rules = S.param_rules(get_config("whisper-tiny"), M_SINGLE)
    assert rules["vocab"] is None


def test_param_rules_on_tiny_mesh_adapt():
    mesh = S.MeshShape({"data": 2, "model": 4})
    rules = S.param_rules(get_config("mixtral-8x22b"), mesh)
    assert rules["experts"] == "data"
    assert rules["heads"] == "model"


@pytest.mark.parametrize("mesh", [M_SINGLE, M_MULTI],
                         ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_have_no_duplicate_mesh_axes(arch, mesh):
    cfg = get_config(arch)
    _, model = _models(arch)
    specs = S.partition_params(model, cfg, mesh)
    for spec in _pspecs(specs):
        flat = []
        for entry in spec:
            if entry is None:
                continue
            flat.extend(entry if isinstance(entry, tuple) else (entry,))
        assert len(flat) == len(set(flat)), f"{arch}: duplicate in {spec}"
        assert all(a in mesh.axis_names for a in flat), spec


def test_auto_spec_batch_demotes_on_pod_mesh():
    assert S.auto_spec((16, 4096, 8, 128), M_MULTI, batch_dim=0)[0] == "data"
    assert S.auto_spec((64, 4096, 8, 128), M_MULTI, batch_dim=0)[0] == \
        ("pod", "data")


def test_auto_spec_model_axis_prefers_largest_divisible():
    s = S.auto_spec((128, 1000, 512, 256), M_SINGLE, batch_dim=0)
    assert s == ("data", None, "model", None)
    assert s == tuple(JS.auto_spec((128, 1000, 512, 256),
                                   _FakeMesh(SINGLE), batch_dim=0))


def test_auto_spec_without_model_axis():
    s = S.auto_spec((64, 4096), S.MeshShape({"data": 8}), batch_dim=0)
    assert s == ("data", None)


def test_batch_specs_match_batch_sds_keys():
    cfg = get_config("whisper-tiny")
    train = S.batch_specs(cfg, SHAPES["train_4k"], M_MULTI)
    sds = TSTEP.train_batch_sds(cfg, SHAPES["train_4k"])
    assert set(train) == set(sds)
    assert train["tokens"] == (("pod", "data"), None)
    prefill = S.batch_specs(cfg, SHAPES["prefill_32k"], M_SINGLE)
    assert set(prefill) == set(STEP.prefill_batch_sds(
        cfg, SHAPES["prefill_32k"]))
    assert "labels" not in prefill


def test_batch_specs_single_sequence_replicates():
    specs = S.batch_specs(get_config("xlstm-125m"), SHAPES["long_500k"],
                          M_SINGLE)
    assert specs["tokens"] == (None, None)


def test_state_specs_mirror_param_specs_for_both_moments():
    cfg = get_config("granite-8b")
    _, model = _models("granite-8b")
    p_specs = S.partition_params(model, cfg, M_SINGLE)
    s = S.state_specs(p_specs)
    p_leaves = _pspecs(p_specs)
    for key in ("m", "v"):
        assert _pspecs(s[key]) == p_leaves
    assert s["step"] == ()
    assert "ef" not in s
    assert "ef" in S.state_specs(p_specs, compress=True)


def test_state_specs_match_init_state_layout():
    params = {"w": torch.zeros(4, 4)}
    state = init_state(params, AdamWConfig(compress=True))
    specs = S.state_specs({"w": (None, None)}, compress=True)
    assert set(state) == set(specs)


def test_logical_axis_dims_collects_every_tagged_dim():
    defs = {"a": ParamDef((8, 16), ("ff", "heads")),
            "b": ParamDef((24,), ("ff",)),
            "c": ParamDef((5,), (None,))}
    assert S.logical_axis_dims(defs) == {"ff": {8, 24}, "heads": {16}}


def test_data_axes_excludes_model():
    assert S.data_axes(M_MULTI) == ("pod", "data")
    assert S.data_axes(M_SINGLE) == ("data",)


# ---------------------------------------------------------------------------
# tests/test_sharding_serving.py's spec cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_shape", [SINGLE, MULTI],
                         ids=["16x16", "2x16x16"])
def test_param_specs_divisible(arch, mesh_shape):
    cfg = get_config(arch)
    _, model = _models(arch)
    rules = S.param_rules(cfg, S.MeshShape(mesh_shape))
    specs = model.param_partition_specs(rules)
    defs = tree_leaves(model.defs)
    spec_leaves = _pspecs(specs)
    assert len(defs) == len(spec_leaves)
    for d, spec in zip(defs, spec_leaves):
        for dim, axis in zip(d.shape, spec):
            if axis is None:
                continue
            axes = axis if isinstance(axis, tuple) else (axis,)
            size = int(np.prod([mesh_shape[a] for a in axes]))
            assert dim % size == 0, f"{arch}: {dim} vs {axes}"


def test_auto_spec_heuristics():
    assert S.auto_spec((128, 32768, 8, 128), M_SINGLE) == \
        ("data", "model", None, None)
    s = S.auto_spec((59, 128, 32768, 576), M_SINGLE, batch_dim=1)
    assert s[1] == "data" and "model" in s
    assert S.auto_spec((1, 4096, 8, 128), M_SINGLE)[0] is None


_SMALL = [{"data": 1, "model": 2}, {"data": 2, "model": 4}]


def _size(mesh_shape, entry) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    return int(np.prod([mesh_shape[a] for a in axes]))


@pytest.mark.parametrize("mesh_shape", _SMALL, ids=["1x2", "2x4"])
@pytest.mark.parametrize("arch,batch", [("stablelm-1.6b", 4),
                                        ("recurrentgemma-2b", 4)])
def test_cache_specs_per_layer_layout(arch, batch, mesh_shape):
    """The port's per-layer caches: batch at dim 0 everywhere, every
    sharded dim divisible, equal to the reference's smoke-config specs
    with its scanned unit unstacked."""
    jmodel, model = _models(arch, smoke=True)
    cfg = get_smoke_config(arch)
    mesh = S.MeshShape(mesh_shape)
    shape = ShapeSpec("t", seq_len=32, global_batch=batch, kind="decode")
    cache = STEP.cache_sds(model, cfg, shape)
    specs = STEP.cache_specs(cache, mesh)
    assert isinstance(specs, list) and len(specs) == cfg.n_layers
    want = S.divisible_axes(batch, S.data_axes(mesh), mesh)
    for t, s in zip(_meta_leaves(cache), _cache_spec_leaves(specs)):
        assert len(s) == t.ndim and s[0] in (want, None)
        assert all(d % _size(mesh_shape, e) == 0 for d, e in zip(t.shape, s))
    jshape = JShapeSpec("t", seq_len=32, global_batch=batch,
                        kind="decode")
    jspecs = JSTEP.cache_specs(JSTEP.cache_sds(
        jmodel, jax_smoke_config(arch), jshape), _FakeMesh(mesh_shape))
    assert_cache_specs(_cache_spec_leaves(specs),
                       _ref_cache_leaves(jmodel, jspecs),
                       _meta_leaves(cache), mesh_shape)


@pytest.mark.parametrize("mesh_shape", _SMALL, ids=["1x2", "2x4"])
def test_cache_specs_whisper_plain_list(mesh_shape):
    jmodel, model = _models("whisper-tiny", smoke=True)
    cfg = get_smoke_config("whisper-tiny")
    mesh = S.MeshShape(mesh_shape)
    shape = ShapeSpec("t", seq_len=32, global_batch=4, kind="decode")
    cache = STEP.cache_sds(model, cfg, shape)
    specs = STEP.cache_specs(cache, mesh)
    assert isinstance(specs, list) and len(specs) == cfg.n_layers
    assert set(specs[0]) == {"self", "cross_k", "cross_v"}
    want = S.divisible_axes(4, S.data_axes(mesh), mesh)
    for s in _cache_spec_leaves(specs):
        assert s[0] in (want, None)
    jshape = JShapeSpec("t", 32, 4, "decode")
    jspecs = JSTEP.cache_specs(JSTEP.cache_sds(
        jmodel, jax_smoke_config("whisper-tiny"), jshape),
        _FakeMesh(mesh_shape))
    assert _cache_spec_leaves(specs) == _jspecs(jspecs)


@pytest.mark.parametrize("mesh_shape", _SMALL, ids=["1x2", "2x4"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-236b"])
def test_cache_specs_paged_pools(arch, mesh_shape):
    jmodel, model = _models(arch, smoke=True)
    mesh = S.MeshShape(mesh_shape)
    n_pages, page_size = 16, 4
    pools = STEP.paged_cache_sds(model, n_pages, page_size)
    specs = STEP.cache_specs(pools, mesh)
    for t, s in zip(_meta_leaves(pools), _cache_spec_leaves(specs)):
        assert t.shape[0] == n_pages and t.shape[1] == page_size
        if mesh_shape["data"] > 1:
            assert s[0] is not None
        assert s[1] is None                  # the page-offset dim
        assert all(d % _size(mesh_shape, e) == 0 for d, e in zip(t.shape, s))
    jspecs = JSTEP.cache_specs(JSTEP.paged_cache_sds(
        jmodel, n_pages, page_size), _FakeMesh(mesh_shape))
    assert_cache_specs(_cache_spec_leaves(specs),
                       _ref_cache_leaves(jmodel, jspecs),
                       _meta_leaves(pools), mesh_shape)


def test_paged_spec_rules():
    assert S.paged_spec((256, 16, 8, 128), M_SINGLE) == \
        ("data", None, None, "model")
    assert S.paged_spec((12, 256, 16, 8, 128), M_SINGLE, page_dim=1) == \
        (None, "data", None, None, "model")
    assert S.paged_spec((30, 16, 8, 128), M_SINGLE) == \
        (None, None, None, "model")
    assert S.paged_spec((256, 4096, 8, 24), M_SINGLE)[1] is None
    for shape, pd in (((256, 16, 8, 128), 0), ((12, 256, 16, 8, 128), 1),
                      ((256, 4096, 8, 24), 0)):
        assert S.paged_spec(shape, M_SINGLE, page_dim=pd) == tuple(
            JS.paged_spec(shape, _FakeMesh(SINGLE), page_dim=pd))


# ---------------------------------------------------------------------------
# to_placements on a fake 512-rank world
# ---------------------------------------------------------------------------

_PLACE_CASES = [
    ((64, 32), (("pod", "data"), "model")),
    ((32, 48, 64), ("data", None, "model")),
    ((16, 64), (None, ("pod", "data"))),
    ((32, 32), ("model", "data")),
    ((8, 16), (None, None)),
    ((160, 32, 48), (("pod", "data"), None, "model")),
]
_RANKS = [0, 37, 300, 511]


@pytest.fixture(scope="module")
def reference_index_map():
    """The reference's NamedSharding index map on a (2, 16, 16) mesh of
    512 JAX CPU devices, at each tested rank's mesh coordinate."""
    code = textwrap.dedent(f"""
        import json
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = jax.make_mesh((2, 16, 16), ("pod", "data", "model"))
        out = {{}}
        for i, (shape, spec) in enumerate({_PLACE_CASES!r}):
            idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
            for r in {_RANKS!r}:
                c = (r // 256, (r // 16) % 16, r % 16)
                sl = idx[mesh.devices[c]]
                out[f"{{i}}/{{r}}"] = [[s.start or 0,
                                       (s.stop or n) - (s.start or 0)]
                                      for s, n in zip(sl, shape)]
        print(json.dumps(out))
    """)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout)


@pytest.fixture(params=_RANKS)
def fake_world(request):
    """One rank of a fake 512-rank world and its (2, 16, 16) mesh,
    destroyed after the test (other files share the worker)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=request.param,
                            world_size=512)
    try:
        yield request.param, init_device_mesh(
            "cpu", (2, 16, 16), mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def test_to_placements_matches_reference_shards(fake_world,
                                                reference_index_map):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.dist.collectives import distribute

    rank, mesh = fake_world
    assert tuple(mesh.get_coordinate()) == (rank // 256, (rank // 16) % 16,
                                            rank % 16)
    assert S.mesh_view(mesh).shape == MULTI
    assert S.to_placements(("data", None, "model"), mesh) == (
        Replicate(), Shard(0), Shard(2))
    for i, (shape, spec) in enumerate(_PLACE_CASES):
        placements = S.to_placements(spec, mesh)
        local, offset = compute_local_shape_and_global_offset(
            shape, mesh, placements)
        want = reference_index_map[f"{i}/{rank}"]
        assert [[o, n] for o, n in zip(offset, local)] == want, (spec, rank)
        full = torch.arange(int(np.prod(shape)),
                            dtype=torch.float32).reshape(shape)
        piece = distribute(full, mesh, spec).to_local()
        want_piece = full[tuple(slice(o, o + n) for o, n in want)]
        assert torch.equal(piece, want_piece), (spec, rank)


def test_to_placements_refuses_out_of_order_and_duplicate_axes(fake_world):
    _, mesh = fake_world
    with pytest.raises(ValueError, match="out of the mesh's order"):
        S.to_placements((("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="used twice"):
        S.to_placements(("model", "model"), mesh)


@pytest.mark.parametrize("multi_pod,tp,shape", [
    (False, None, (16, 16)), (True, None, (2, 16, 16)),
    (False, "8", (32, 8)), (True, "4", (2, 64, 4))])
def test_production_mesh_on_a_fake_world(monkeypatch, multi_pod, tp, shape):
    """``make_production_mesh``: the reference's 16x16 and 2x16x16 meshes,
    ``ADSALA_TP`` moving the model-axis degree at a fixed chip count;
    built over a fake world of that many ranks, destroyed after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import dp_axes, make_production_mesh, \
        tp_axis

    if tp is None:
        monkeypatch.delenv("ADSALA_TP", raising=False)
    else:
        monkeypatch.setenv("ADSALA_TP", tp)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = int(np.prod(shape))
    dist.init_process_group("fake", store=FakeStore(), rank=size - 1,
                            world_size=size)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert tuple(mesh.shape) == shape
        assert tuple(mesh.mesh_dim_names) == names
        assert dp_axes(mesh) == names[:-1] and tp_axis(mesh) == "model"
        assert S.mesh_view(mesh).shape == dict(zip(names, shape))
        assert S.data_axes(mesh) == JS.data_axes(_FakeMesh(
            dict(zip(names, shape))))
    finally:
        dist.destroy_process_group()
