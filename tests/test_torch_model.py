"""Port vs reference: the decoder LM on the CPU, with shared weights.

The reference's ``init`` parameters go through
:func:`repro_torch.convert.params_from_jax`; inputs are made with numpy
from a seed.  Smoke configs of stablelm-1.6b (MHA, layernorm, partial
RoPE), the GQA configs granite-8b (rmsnorm, swiglu) and starcoder2-3b
(layernorm, gelu), and mixtral-8x22b (MoE, sliding window; its ring
cache past the window is tested in tests/test_torch_moe.py).  Everything is fp32: single layers are
held to 1e-5, logits after the whole stack to 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models.params import init_params as jax_init_params
from repro.train.step import make_ctx as jax_make_ctx
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.train.step import make_ctx

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCHS = ["stablelm-1.6b", "granite-8b", "starcoder2-3b", "mixtral-8x22b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    _close(L.rmsnorm(_t(x), _t(scale)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale)), LAYER_TOL)
    _close(L.layernorm(_t(x), _t(scale), _t(bias)),
           JL.layernorm(jnp.asarray(x), jnp.asarray(scale),
                        jnp.asarray(bias)), LAYER_TOL)


@pytest.mark.parametrize("fraction", [0.25, 0.5, 1.0])
def test_rope_matches_reference(fraction):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.arange(3, 10)
    rot = int(32 * fraction)
    sin, cos = L.rope_angles(torch.from_numpy(pos), rot)
    jsin, jcos = JL.rope_angles(jnp.asarray(pos), rot)
    _close(sin, jsin, LAYER_TOL)
    _close(cos, jcos, LAYER_TOL)
    _close(L.apply_rope(_t(x), sin, cos, fraction),
           JL.apply_rope(jnp.asarray(x), jsin, jcos, fraction), LAYER_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "geglu"])
def test_mlp_matches_reference(kind):
    defs = JL.mlp_defs(32, 64, kind)
    p = _np(jax_init_params(defs, jax.random.PRNGKey(2)))
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(
        np.float32)
    got = L.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), kind)
    want = JL.apply_mlp(p, jnp.asarray(x), kind)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("n_kv,fraction", [(4, 0.25), (2, 1.0), (1, 0.5)])
def test_attention_train_matches_reference(n_kv, fraction):
    spec_kw = dict(d_model=64, n_heads=4, n_kv_heads=n_kv, head_dim=16,
                   rope_fraction=fraction)
    jspec = JL.AttnSpec(**spec_kw)
    spec = L.AttnSpec(**spec_kw)
    p = _np(jax_init_params(JL.attention_defs(jspec), jax.random.PRNGKey(3)))
    x = np.random.default_rng(3).standard_normal((2, 24, 64)).astype(
        np.float32)
    out, (k, v) = L.attention_train({n: _t(a) for n, a in p.items()},
                                    _t(x), spec)
    jout, (jk, jv) = JL.attention_train(p, jnp.asarray(x), jspec)
    _close(out, jout, LAYER_TOL)
    _close(k, jk, LAYER_TOL)
    _close(v, jv, LAYER_TOL)


def test_unported_paths_raise():
    for arch in ("whisper-tiny", "xlstm-125m", "recurrentgemma-2b",
                 "chameleon-34b"):
        with pytest.raises(NotImplementedError, match="not ported"):
            build_model(get_smoke_config(arch))


# ---------------------------------------------------------------------------
# the whole model: prefill + greedy decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = jax_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = build_model(cfg)
    state = params_from_jax(_np(jp))
    return jm, jp, model, state


def test_params_convert_one_to_one(pair):
    jm, jp, model, state = pair
    assert len(state["layers"]) == model.cfg.n_layers
    # every reference leaf lands in the port, nothing extra or missing
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    n_port = 0

    def add(t):
        nonlocal n_port
        n_port += t.numel()

    from repro_torch.models.params import tree_map
    tree_map(add, state)
    assert n_port == n_ref
    # layer i of the port is slice i of the reference's scan stack
    np.testing.assert_array_equal(
        state["layers"][1]["mixer"]["wq"].numpy(),
        np.asarray(jp["scan"][0]["mixer"]["wq"][1]))


def test_prefill_and_greedy_decode_match_reference(pair):
    jm, jp, model, state = pair
    cfg = model.cfg
    b, s, steps = 2, 12, 4
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (b, s))
    cache_len = s + steps
    jlogits, jcache = jm.prefill(
        jp, jnp.asarray(tokens, jnp.int32),
        jax_make_ctx(None, "prefill", cache_len=cache_len, remat=False))
    logits, cache = model.prefill(state, torch.from_numpy(tokens),
                                  make_ctx("prefill", cache_len=cache_len))
    _close(logits, jlogits, LOGIT_TOL)
    for i, c in enumerate(cache):
        _close(c.k, jcache["scan"][0].k[i], LAYER_TOL)
        _close(c.v, jcache["scan"][0].v[i], LAYER_TOL)
    empty = model.init_cache(b, make_ctx("decode", cache_len=cache_len))
    jempty = jm.init_cache(b, jax_make_ctx(None, "decode",
                                           cache_len=cache_len))
    assert len(empty) == cfg.n_layers
    assert tuple(empty[0].k.shape) == jempty["scan"][0].k.shape[1:]
    assert not any(c.k.any() or c.v.any() for c in empty)

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
