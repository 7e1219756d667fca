"""Port vs reference: the MoE slice (routing, dispatch/combine, the
grouped GEMM, the ring KV cache and the mixtral smoke model) on the CPU.

* ``_route``: ``gate_idx`` equal, ``gate_vals`` and the auxiliary loss
  within 1e-6 (fp32 softmax of the same logits);
* ``_dispatch`` / ``_combine`` against the reference's: buckets, row
  map and validity equal, the combine within 1e-6;
* the port's sort-based ``apply_moe`` against the reference's one-hot
  ``apply_moe`` within 1e-5 (fp32, a layer), with and without tokens
  dropped at capacity, and with equal recorder events (one per expert
  and site);
* ``ops.grouped_matmul`` (the kernel's plain version) against
  ``grouped_matmul_pallas(interpret=True)`` on the cases of
  tests/test_kernels.py: 5e-5 in fp32, 1e-1 in bf16, as there;
* ``group_sizes`` validation with the reference's errors, and the
  batched tuner lookup;
* the ring KV cache: seeding with the prompt longer than, equal to and
  shorter than the window, and decode steps that wrap it;
* the whole mixtral-8x22b smoke model: prefill and greedy decode past
  the window, logits within 1e-4 and the same tokens.

The CUDA kernel itself is tested on the card by
tests/test_torch_grouped_cuda.py.  Inputs are made with numpy from a
seed and handed to both packages; nothing here is timed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import AdsalaTuner as JaxTuner
from repro.core import InstallConfig as JaxInstallConfig
from repro.core import SimulatedBackend as JaxSimulatedBackend
from repro.core import install as jax_install
from repro.kernels import ops as jops
from repro.kernels.grouped_matmul import grouped_matmul_pallas
from repro.kernels.recorder import DispatchRecorder as JaxRecorder
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models.params import init_params as jax_init_params
from repro.train.step import make_ctx as jax_make_ctx
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import AdsalaTuner, candidate_configs
from repro_torch.kernels import grouped_matmul as G
from repro_torch.kernels import ops
from repro_torch.kernels.recorder import DispatchRecorder
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.train.step import make_ctx

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

ROUTE_TOL = 1e-6
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
TOL = {"float32": 5e-5, "bfloat16": 1e-1}
#: tests/test_kernels.py::test_grouped_matmul_matches_oracle
GROUPED_CASES = [(4, 64, 32, 48), (2, 100, 64, 64), (8, 16, 16, 96)]

ARCH = "mixtral-8x22b"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _spec(cfg) -> dict:
    return dict(d_model=cfg.d_model, n_experts=cfg.n_experts,
                top_k=cfg.top_k, d_ff=cfg.d_ff_expert)


@pytest.fixture(scope="module")
def moe():
    """The smoke config's MoE block: (jax spec, port spec, jax params,
    port params)."""
    kw = _spec(jax_smoke_config(ARCH))
    jspec, spec = JMOE.MoESpec(**kw), MOE.MoESpec(**kw)
    jp = jax.tree.map(np.asarray, jax_init_params(JMOE.moe_defs(jspec),
                                                  jax.random.PRNGKey(7)))
    return jspec, spec, jp, {k: _t(v) for k, v in jp.items()}


def _tokens(rng, b, s, d, offset=0.0):
    return (rng.standard_normal((b, s, d)) + offset).astype(np.float32)


def _biased(p, jp):
    """Router weights that send every token to expert 0 (and one more),
    so expert 0 overflows its capacity."""
    router = np.array(jp["router"], copy=True)
    router[:, 0] = 0.5
    return ({**p, "router": _t(router)},
            {**jp, "router": router})


# ---------------------------------------------------------------------------
# routing, dispatch, combine
# ---------------------------------------------------------------------------

def test_capacity_matches_reference(moe):
    jspec, spec, _, _ = moe
    for n in (1, 4, 13, 64, 80, 4096):
        assert spec.capacity(n) == jspec.capacity(n)
    full = MOE.MoESpec(d_model=6144, n_experts=8, top_k=2, d_ff=16384)
    assert full.capacity(4 * 1024) == 1280 and full.capacity(4) == 8


@pytest.mark.parametrize("seed", range(3))
def test_route_matches_reference(moe, seed):
    jspec, spec, jp, p = moe
    xf = _tokens(np.random.default_rng(seed), 1, 48, spec.d_model)[0]
    vals, idx, aux = MOE._route(p, _t(xf), spec)
    jvals, jidx, jaux = JMOE._route(jp, jnp.asarray(xf), jspec)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(vals, jvals, ROUTE_TOL)
    _close(aux, jaux, ROUTE_TOL)


@pytest.mark.parametrize("biased", [False, True])
def test_dispatch_and_combine_match_reference(moe, biased):
    jspec, spec, jp, p = moe
    if biased:
        p, jp = _biased(p, jp)
    rng = np.random.default_rng(10)
    xf = _tokens(rng, 1, 64, spec.d_model, 2.0 if biased else 0.0)[0]
    cap = spec.capacity(64)
    vals, idx, _ = MOE._route(p, _t(xf), spec)
    buckets, dest, order, valid = MOE._dispatch(_t(xf), idx, spec, cap)
    jb, jdest, jorder, jvalid = JMOE._dispatch(
        jnp.asarray(xf), jnp.asarray(idx.numpy()), jspec, cap)
    np.testing.assert_array_equal(buckets.numpy(), np.asarray(jb))
    for got, want in ((dest, jdest), (order, jorder), (valid, jvalid)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((~valid).any()) == biased          # capacity drops
    y = rng.standard_normal((spec.n_experts, cap, spec.d_model)).astype(
        np.float32)
    got = MOE._combine(_t(y), dest, order, valid, vals, 64, spec)
    want = JMOE._combine(jnp.asarray(y), jdest, jorder, jvalid,
                         jnp.asarray(vals.numpy()), 64, jspec)
    _close(got, want, ROUTE_TOL)


@pytest.mark.parametrize("b,s,biased", [(2, 24, False), (2, 32, True),
                                        (3, 1, False)])
def test_apply_moe_matches_one_hot_reference(moe, b, s, biased):
    jspec, spec, jp, p = moe
    if biased:
        p, jp = _biased(p, jp)
    x = _tokens(np.random.default_rng(11), b, s, spec.d_model,
                2.0 if biased else 0.0)
    out, aux = MOE.apply_moe(p, _t(x), spec)
    jout, jaux = JMOE.apply_moe(jp, jnp.asarray(x), jspec)
    assert tuple(out.shape) == (b, s, spec.d_model)
    _close(out, jout, LAYER_TOL)
    _close(aux, jaux, ROUTE_TOL)
    if biased:          # expert 0 got every token and dropped some
        _, idx, _ = MOE._route(p, _t(x).reshape(-1, spec.d_model), spec)
        assert int((idx == 0).sum()) > spec.capacity(b * s)


@pytest.fixture(scope="module")
def moe_artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_artifact")
    cfg = JaxInstallConfig(n_samples=48, repeats=2, tile_ids=(0, 3),
                           models=("linear_regression",),
                           routines=("gemm", "attn"), grid_budget="small",
                           cv_splits=3, seed=0)
    jax_install(JaxSimulatedBackend(seed=0), cfg, artifact_dir=str(d))
    return str(d)


def _event(e):
    cfg = None if e.config is None else dataclasses.astuple(e.config)
    return (e.routine, e.m, e.k, e.n, cfg, e.count, e.cache_hit, e.site)


@pytest.mark.parametrize("tuned", [False, True])
def test_apply_moe_records_one_event_per_expert(moe, moe_artifact, tuned):
    jspec, spec, jp, p = moe
    x = _tokens(np.random.default_rng(12), 2, 16, spec.d_model)
    jt = JaxTuner.from_artifact(moe_artifact) if tuned else None
    tt = AdsalaTuner.from_artifact(moe_artifact) if tuned else None
    with JaxRecorder() as jrec:
        JMOE.apply_moe(jp, jnp.asarray(x), jspec, tuner=jt)
    with DispatchRecorder() as trec:
        MOE.apply_moe(p, _t(x), spec, tuner=tt)
    events = list(map(_event, trec.events))
    assert events == list(map(_event, jrec.events))
    cap, e = spec.capacity(32), spec.n_experts
    assert [ev[7] for ev in events] == \
        ["moe.wi"] * e + ["moe.wg"] * e + ["moe.wo"] * e
    assert [ev[1:4] for ev in events] == \
        [(cap, spec.d_model, spec.d_ff)] * 2 * e \
        + [(cap, spec.d_ff, spec.d_model)] * e
    assert all((ev[4] is not None) == tuned for ev in events)


def test_ep_and_tp_paths_are_not_ported(moe):
    """The expert-parallel and expert-TP paths (which raised before the
    distribution layer was ported) need a mesh, and on a one-rank mesh
    equal the single-device path bit for bit: one rank holds every
    expert and the whole FF width.  Multi-rank worlds:
    tests/test_torch_dist.py."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _, spec, _, p = moe
    x = torch.from_numpy(_tokens(np.random.default_rng(3), 2, 8,
                                 spec.d_model))
    with pytest.raises(TypeError, match="mesh"):
        MOE.apply_moe_ep(p, x, spec)
    with pytest.raises(TypeError, match="mesh"):
        MOE.apply_moe_tp(p, x, spec)
    want, want_aux = MOE.apply_moe(p, x, spec)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        for fn in (MOE.apply_moe_ep, MOE.apply_moe_tp):
            out, aux = fn(p, x, spec, mesh=mesh)
            assert torch.equal(out, want) and torch.equal(aux, want_aux)
    finally:
        dist.destroy_process_group()


def test_shared_experts_match_reference():
    kw = dict(d_model=32, n_experts=4, top_k=2, d_ff=48, n_shared=2)
    jspec, spec = JMOE.MoESpec(**kw), MOE.MoESpec(**kw)
    jp = jax.tree.map(np.asarray, jax_init_params(JMOE.moe_defs(jspec),
                                                  jax.random.PRNGKey(8)))
    x = _tokens(np.random.default_rng(13), 2, 8, 32)
    with JaxRecorder() as jrec:
        jout, _ = JMOE.apply_moe(jp, jnp.asarray(x), jspec)
    with DispatchRecorder() as trec:
        out, _ = MOE.apply_moe({k: _t(v) for k, v in jp.items()}, _t(x),
                               spec)
    _close(out, jout, LAYER_TOL)
    assert list(map(_event, trec.events)) == list(map(_event, jrec.events))


# ---------------------------------------------------------------------------
# ops.grouped_matmul and its plain kernel version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,c,d,f", GROUPED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_matches_pallas(e, c, d, f, dtype):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    want = grouped_matmul_pallas(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                                 bm=32, bk=32, bn=32, interpret=True)
    tdt = getattr(torch, dtype)
    got = ops.grouped_matmul(_t(x).to(tdt), _t(w).to(tdt), tile=(32, 32, 32),
                             backend="torch")
    assert got.dtype == tdt and tuple(got.shape) == (e, c, f)
    _close(got.float(), np.asarray(want, np.float32), TOL[dtype])


@pytest.mark.parametrize("e,c,d,f,tile", [
    (3, 33, 257, 65, (16, 128, 16)), (2, 8, 300, 130, (256, 256, 256)),
    (5, 100, 7, 1, (512, 512, 512))])
def test_grouped_matmul_torch_matches_pallas_tile_for_tile(e, c, d, f, tile):
    rng = np.random.default_rng(15)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    bm, bk, bn = tile
    want = grouped_matmul_pallas(jnp.asarray(x), jnp.asarray(w), bm=bm,
                                 bk=bk, bn=bn, interpret=True)
    got = G.grouped_matmul_torch(_t(x), _t(w), bm=bm, bk=bk, bn=bn)
    _close(got, want, TOL["float32"])
    # an expert-transposed weight view gives the same result
    wt = _t(np.ascontiguousarray(w.transpose(0, 2, 1))).transpose(1, 2)
    _close(G.grouped_matmul_torch(_t(x), wt, bm=bm, bk=bk, bn=bn), want,
           TOL["float32"])


def test_group_sizes_are_validated_as_in_the_reference():
    x, w = torch.zeros(3, 32, 16), torch.zeros(3, 16, 24)
    jx, jw = jnp.zeros((3, 32, 16)), jnp.zeros((3, 16, 24))
    for bad, match in (([32, 8], "entries for"), ([32, 8, -1], "outside"),
                       ([32, 8, 33], "outside")):
        with pytest.raises(ValueError, match=match) as got:
            ops.grouped_matmul(x, w, group_sizes=bad, backend="torch")
        with pytest.raises(ValueError, match=match) as want:
            jops.grouped_matmul(jx, jw, group_sizes=bad, backend="xla")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="bad grouped shapes"):
        ops.grouped_matmul(x, torch.zeros(3, 15, 24))
    with pytest.raises(ValueError, match="bad grouped shapes"):
        G.grouped_matmul_torch(x, torch.zeros(2, 16, 24))
    with pytest.raises(ValueError, match="every expert needs a shape"):
        ops.grouped_dispatch_hint([(4, 4, 4)], None, n_experts=2)


def _stub_tuner():
    class _Model:
        def predict(self, X):
            return np.log(1e-6 * (X[:, 3] + 1e-3 * X[:, 0]))

    class _Pipe:
        def transform(self, X):
            return X

    return AdsalaTuner(_Model(), _Pipe(), candidate_configs(8, tiles=(0,)))


def test_grouped_matmul_single_batched_tuner_lookup():
    tuner = _stub_tuner()
    rng = np.random.default_rng(16)
    x = _t(rng.standard_normal((4, 32, 16)).astype(np.float32))
    w = _t(rng.standard_normal((4, 16, 24)).astype(np.float32))
    out = ops.grouped_matmul(x, w, tuner=tuner, backend="torch")
    assert tuner.stats["calls"] == 4          # one per expert shape...
    assert tuner.stats["evaluations"] == 1    # ...but a single evaluation
    _close(out, np.einsum("ecd,edf->ecf", x.numpy(), w.numpy()), 1e-4)
    tuner = _stub_tuner()
    ops.grouped_matmul(x[:3], w[:3], tuner=tuner, group_sizes=[32, 8, 0],
                       backend="torch")
    assert tuner.stats["evaluations"] == 3    # three distinct shapes
    assert ("gemm", 32, 16, 24) in tuner._cache
    assert ("gemm", 1, 16, 24) in tuner._cache   # idle expert: one row


def test_grouped_matmul_uses_the_cost_dominant_experts_tile(monkeypatch):
    seen = []
    monkeypatch.setattr(ops, "grouped_matmul_torch",
                        lambda x, w, **kw: seen.append(kw) or x @ w)
    x, w = torch.zeros(3, 32, 16), torch.zeros(3, 16, 24)
    ops.grouped_matmul(x, w, backend="torch")
    ops.grouped_matmul(x, w, tile=(64, 32, 16), backend="torch")
    tuner = _stub_tuner()
    ops.grouped_matmul(x, w, tuner=tuner, group_sizes=[4, 32, 8],
                       backend="torch")
    want = tuner.select(32, 16, 24).tile
    assert seen == [dict(bm=256, bk=256, bn=256),
                    dict(bm=64, bk=32, bn=16),
                    dict(zip(("bm", "bk", "bn"), want))]


def test_grouped_cuda_backend_on_cpu_tensors_raises():
    x, w = torch.ones(2, 8, 8), torch.ones(2, 8, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.grouped_matmul(x, w, backend="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        G.grouped_matmul_cuda(x, w)


def test_grouped_cuda_kernel_under_autograd_raises():
    """No backward: refused before the device check, by the wrapper and
    by ops on the cuda backend; the MoE layer trains on the library
    backend."""
    x, w = torch.ones(2, 8, 8), torch.ones(2, 8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward.*'library'"):
        G.grouped_matmul_cuda(x, w)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.grouped_matmul(x, w, backend="cuda")
    with torch.no_grad():
        with pytest.raises(ValueError, match="not a CUDA device"):
            G.grouped_matmul_cuda(x, w)
    out = ops.grouped_matmul(x, w, backend="library")
    assert out.grad_fn is not None


# ---------------------------------------------------------------------------
# the ring KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq", [11, 8, 5])
def test_ring_cache_seeding_matches_reference(sq):
    cap = 8
    rng = np.random.default_rng(17)
    k = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    got = L.seed_kv_cache(_t(k), _t(v), cap, windowed=True)
    want = JL.seed_kv_cache(jnp.asarray(k), jnp.asarray(v), cap,
                            windowed=True)
    assert got.windowed and want.windowed
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    # position p of the prompt sits in slot p % cap when it is kept
    for pos in range(max(0, sq - cap), sq):
        np.testing.assert_array_equal(got.k[:, pos % cap].numpy(),
                                      k[:, pos])


@pytest.mark.parametrize("sq", [11, 3])
def test_ring_decode_matches_reference(sq):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              rope_fraction=1.0, window=8)
    jspec, spec = JL.AttnSpec(**kw), L.AttnSpec(**kw)
    jp = jax.tree.map(np.asarray, jax_init_params(
        JL.attention_defs(jspec), jax.random.PRNGKey(9)))
    p = {n: _t(a) for n, a in jp.items()}
    rng = np.random.default_rng(18)
    k = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    cache = L.seed_kv_cache(_t(k), _t(v), 8, windowed=True)
    jcache = JL.seed_kv_cache(jnp.asarray(k), jnp.asarray(v), 8,
                              windowed=True)
    for pos in range(sq, sq + 12):                 # wraps the ring
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        out, cache = L.attention_decode(p, _t(x), spec, cache, pos)
        jout, jcache = JL.attention_decode(jp, jnp.asarray(x), jspec,
                                           jcache, jnp.int32(pos))
        _close(out, jout, LAYER_TOL)
        _close(cache.k, jcache.k, LAYER_TOL)
        _close(cache.v, jcache.v, LAYER_TOL)


# ---------------------------------------------------------------------------
# the whole mixtral smoke model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixtral():
    jcfg = jax_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jm, jp, build_model(cfg), params_from_jax(
        jax.tree.map(np.asarray, jp))


def test_moe_params_unstack_from_the_reference_scan(mixtral):
    jm, jp, model, state = mixtral
    assert len(state["layers"]) == model.cfg.n_layers == 2
    for i, layer in enumerate(state["layers"]):
        assert sorted(layer["moe"]) == ["router", "wg", "wi", "wo"]
        for name, t in layer["moe"].items():
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jp["scan"][0]["moe"][name][i]))


def test_forward_carries_the_aux_loss_as_the_reference(mixtral):
    jm, jp, model, state = mixtral
    tokens = np.random.default_rng(19).integers(0, model.cfg.vocab, (2, 12))
    x, aux, caches = model.forward(state, torch.from_numpy(tokens),
                                   make_ctx("train"))
    jx, jaux, _ = jm.forward(jp, jnp.asarray(tokens, jnp.int32),
                             jax_make_ctx(None, "train", remat=False))
    assert caches is None and aux.dtype == torch.float32
    _close(x, jx, LOGIT_TOL)
    _close(aux, jaux, ROUTE_TOL)
    assert float(aux) > 0


def test_prefill_and_greedy_decode_past_the_window(mixtral):
    jm, jp, model, state = mixtral
    cfg = model.cfg
    b, s, steps = 2, 40, 16
    assert s > cfg.window                          # the ring wraps
    tokens = np.random.default_rng(20).integers(0, cfg.vocab, (b, s))
    cache_len = s + steps
    jlogits, jcache = jm.prefill(
        jp, jnp.asarray(tokens, jnp.int32),
        jax_make_ctx(None, "prefill", cache_len=cache_len, remat=False))
    logits, cache = model.prefill(state, torch.from_numpy(tokens),
                                  make_ctx("prefill", cache_len=cache_len))
    _close(logits, jlogits, LOGIT_TOL)
    assert all(c.windowed and c.k.shape[1] == cfg.window for c in cache)
    empty = model.init_cache(b, make_ctx("decode", cache_len=cache_len))
    assert [tuple(c.k.shape) for c in empty] == \
        [tuple(c.k.shape) for c in cache]
    assert all(c.windowed for c in empty)
    jdctx = jax_make_ctx(None, "decode", cache_len=cache_len)
    dctx = make_ctx("decode", cache_len=cache_len)
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlogits, jcache = jm.decode_step(jp, jtok, jcache,
                                         jnp.int32(s + i), jdctx)
        logits, cache = model.decode_step(state, tok, cache, s + i, dctx)
        _close(logits, jlogits, LOGIT_TOL)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for i, c in enumerate(cache):
        _close(c.k, jcache["scan"][0].k[i], LAYER_TOL)
        _close(c.v, jcache["scan"][0].v[i], LAYER_TOL)
