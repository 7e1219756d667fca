"""Port vs reference: the decoder LM on the CPU, with shared weights.

The reference's ``init`` parameters go through
:func:`repro_torch.convert.params_from_jax`; inputs are made with numpy
from a seed.  Smoke configs of stablelm-1.6b (MHA, layernorm, partial
RoPE), the GQA configs granite-8b (rmsnorm, swiglu) and starcoder2-3b
(layernorm, gelu), mixtral-8x22b (MoE, sliding window; its ring
cache past the window is tested in tests/test_torch_moe.py) and
chameleon-34b (qk-norm).  Everything is fp32: single layers are held to
1e-5, logits after the whole stack to 1e-4.  Every arch builds, and the
layers that have no paged cache (recurrent states, rings) and the
encoder-decoder refuse continuous batching with the reference's
messages.  The recurrent, xLSTM and encoder-decoder families have their
own files (tests/test_torch_{recurrent,xlstm,encdec}.py).
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
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.train.step import make_ctx as jax_make_ctx
from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.params import tree_leaves
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from repro_torch.train.step import make_ctx

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCHS = ["stablelm-1.6b", "granite-8b", "starcoder2-3b", "mixtral-8x22b",
         "chameleon-34b"]


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


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_like_the_reference(arch):
    """The reference's family dispatch: the encoder-decoder LM for the
    audio family, the decoder-only LM for every other; the smoke
    parameter tree holds the reference's leaves, and the full config
    builds (its definitions only: nothing is allocated)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    jm = jax_build_model(jax_smoke_config(arch))
    assert isinstance(model, EncDecLM) == (cfg.family == "audio")
    assert type(model).__name__ == type(jm).__name__
    shapes = sorted(tuple(d.shape) for d in tree_leaves(model.defs))
    jshapes = []
    for d in jax.tree.leaves(jm.defs, is_leaf=lambda v: hasattr(v, "axes")):
        scanned = d.axes[:1] == ("layers",)
        reps = d.shape[0] if scanned else 1
        jshapes += [tuple(d.shape[1:] if scanned else d.shape)] * reps
    assert shapes == sorted(jshapes)
    full = build_model(get_config(arch))
    assert type(full) is type(model)


def _refusal(fn):
    with pytest.raises(NotImplementedError) as e:
        fn()
    return str(e.value)


def _scheduler_refusal(arch):
    """(the port's, the reference's) message when each builds the
    scheduler on its smoke model."""
    kw = dict(slots=1, n_pages=4, page_size=4, max_seq_len=8)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    jcfg = jax_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return (_refusal(lambda: ContinuousBatchingScheduler(
                model, cfg, params, **kw)),
            _refusal(lambda: JScheduler(jm, jcfg, jp, **kw)))


def test_scheduler_refuses_rglru_layers_like_the_reference():
    got, want = _scheduler_refusal("recurrentgemma-2b")
    assert got == want and "'rglru'" in got and "not paged" in got


def test_scheduler_refuses_mlstm_layers_like_the_reference():
    got, want = _scheduler_refusal("xlstm-125m")
    assert got == want and "'mlstm'" in got and "not paged" in got


def test_scheduler_refuses_the_encoder_decoder_like_the_reference():
    got, want = _scheduler_refusal("whisper-tiny")
    assert got == want and "decoder-only" in got


@pytest.mark.parametrize("kind", ["local", "slstm"])
def test_paged_cache_refuses_ring_and_slstm_layers_like_the_reference(
        kind):
    """recurrentgemma's local layers keep a ring (its window bounds
    their memory); sLSTM carries a recurrent state."""
    arch = "recurrentgemma-2b" if kind == "local" else "xlstm-125m"
    cfg = get_smoke_config(arch)
    jcfg = jax_smoke_config(arch)
    got = _refusal(lambda: T._init_layer_paged(
        cfg, T.LayerSpec(kind, "none"), 4, 4,
        make_ctx("decode", cache_len=8), torch.float32, "cpu"))
    want = _refusal(lambda: JT._init_layer_paged(
        jcfg, JT.LayerSpec(kind, "none"), 4, 4,
        jax_make_ctx(None, "decode", cache_len=8), jnp.float32))
    assert got == want
    assert ("sliding-window" if kind == "local" else "recurrent") in got


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
