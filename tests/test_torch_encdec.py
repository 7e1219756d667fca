"""Port vs reference: the encoder-decoder LM (whisper-tiny) on the CPU.

The reference's parameters go through
:func:`repro_torch.convert.params_from_jax`; tokens and the stub's frame
embeddings ``audio_emb`` are made with numpy from a seed.  fp32: the
encoder output and the caches are held to 1e-5, logits to 1e-4.

* ``encode``, ``prefill`` (logits, self-attention caches, projected
  cross K/V) and greedy ``decode_step`` of the whisper smoke model;
* ``params_from_jax`` one to one on the encoder-decoder tree (no
  invented ``layers``);
* the prefill's dispatch events equal the reference's (routine, shape,
  count, site): both run their layers as a Python loop.  The reference
  runs its pallas backend here, whose events are the flash dispatches
  the port records (its xla backend may take the SYRK-scores path);
* the decode caches from ``init_cache`` match the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.recorder import DispatchRecorder as JaxRecorder
from repro.train.step import make_ctx as jax_make_ctx
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.recorder import DispatchRecorder
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.params import tree_leaves, tree_paths
from repro_torch.train.step import make_ctx

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCH = "whisper-tiny"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


def _event(e):
    cfg = None if e.config is None else dataclasses.astuple(e.config)
    return (e.routine, e.m, e.k, e.n, cfg, e.count, e.cache_hit, e.site)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = build_model(cfg)
    assert isinstance(model, EncDecLM)
    return jm, jp, model, params_from_jax(_np(jp))


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s))
    audio = rng.standard_normal((b, cfg.encoder_len, cfg.d_model)).astype(
        np.float32)
    return tokens, audio


def test_params_convert_one_to_one(pair):
    jm, jp, model, state = pair
    assert "layers" not in state
    assert sorted(state) == sorted(jp)
    ref = _np(jp)
    assert tree_paths(state) == tree_paths(ref)
    for a, b in zip(tree_leaves(state), tree_leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert len(state["encoder"]) == model.cfg.n_encoder_layers
    assert len(state["decoder"]) == model.cfg.n_layers
    own = model.init(torch.Generator().manual_seed(0))
    assert tree_paths(own) == tree_paths(state)
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [tuple(t.shape) for t in tree_leaves(state)]


def test_encode_matches_reference(pair):
    jm, jp, model, state = pair
    _, audio = _batch(model.cfg, 2, 4, 1)
    got = model.encode(state, torch.from_numpy(audio))
    want = jm.encode(jp, jnp.asarray(audio))
    _close(got, want, LAYER_TOL)


def test_prefill_and_greedy_decode_match_reference(pair):
    jm, jp, model, state = pair
    cfg = model.cfg
    b, s, steps = 2, 10, 6
    tokens, audio = _batch(cfg, b, s, 2)
    cache_len = s + steps
    jlogits, jcache = jm.prefill(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32),
             "audio_emb": jnp.asarray(audio)},
        jax_make_ctx(None, "prefill", cache_len=cache_len, remat=False))
    logits, cache = model.prefill(
        state, {"tokens": torch.from_numpy(tokens),
                "audio_emb": torch.from_numpy(audio)},
        make_ctx("prefill", cache_len=cache_len))
    _close(logits, jlogits, LOGIT_TOL)

    def check(cache, jcache):
        assert len(cache) == len(jcache) == cfg.n_layers
        for c, jc in zip(cache, jcache):
            _close(c["self"].k, jc["self"].k, LAYER_TOL)
            _close(c["self"].v, jc["self"].v, LAYER_TOL)
            _close(c["cross_k"], jc["cross_k"], LAYER_TOL)
            _close(c["cross_v"], jc["cross_v"], LAYER_TOL)

    check(cache, jcache)
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
    check(cache, jcache)


def test_prefill_records_the_reference_events(pair, monkeypatch):
    jm, jp, model, state = pair
    cfg = model.cfg
    tokens, audio = _batch(cfg, 2, 8, 3)
    with monkeypatch.context() as env:
        env.setenv("ADSALA_BACKEND", "pallas")
        with JaxRecorder() as jrec:
            jm.prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32),
                            "audio_emb": jnp.asarray(audio)},
                       jax_make_ctx(None, "prefill", cache_len=12,
                                    remat=False))
    with DispatchRecorder() as rec:
        model.prefill(state, {"tokens": torch.from_numpy(tokens),
                              "audio_emb": torch.from_numpy(audio)},
                      make_ctx("prefill", cache_len=12))
    assert [_event(e) for e in rec.events] == \
        [_event(e) for e in jrec.events]
    sites = [e.site for e in rec.events]
    assert sites.count("attn.core") == cfg.n_encoder_layers + cfg.n_layers
    assert sites.count("attn.cross_qk") == cfg.n_layers
    cross = [e for e in rec.events if e.site == "attn.cross_qk"]
    assert {(e.routine, e.m, e.k, e.n, e.count) for e in cross} == {
        ("gemm", 8, cfg.resolved_head_dim, cfg.encoder_len,
         2 * cfg.n_heads)}
    core = [e for e in rec.events if e.site == "attn.core"]
    # the encoder attends unmasked (gemm), the decoder causally (attn)
    assert [e.routine for e in core] == \
        ["gemm"] * cfg.n_encoder_layers + ["attn"] * cfg.n_layers


def test_empty_cache_matches_reference(pair):
    jm, _, model, _ = pair
    empty = model.init_cache(3, make_ctx("decode", cache_len=9))
    jempty = jm.init_cache(3, jax_make_ctx(None, "decode", cache_len=9))
    assert len(empty) == len(jempty)
    for c, jc in zip(empty, jempty):
        for got, want in ((c["self"].k, jc["self"].k),
                          (c["self"].v, jc["self"].v),
                          (c["cross_k"], jc["cross_k"]),
                          (c["cross_v"], jc["cross_v"])):
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
