"""Port vs reference: the RG-LRU block and recurrentgemma on the CPU.

Inputs are made with numpy from a seed; the reference's parameters
(``init_params`` / ``LM.init``) are carried across with numpy.  The
port's scan is the reference's ``jax.lax.associative_scan`` order
written out in torch, so the reference's tolerances hold: single blocks
and states 1e-5, logits after the whole stack 1e-4 (fp32).

* ``rglru_block_train`` (output, final h, conv state) at sequence
  lengths that are not powers of two, and ``rglru_block_decode``
  continuing it;
* the conv state carried across a split sequence, and the scan against
  the plain sequential recurrence;
* the recurrentgemma smoke LM (5 layers: rglru, rglru, local, rglru,
  rglru; window 32): parameters in model order, prefill and greedy
  decode of 40 + 16 tokens (the local layer's ring of 32 wraps when it
  is seeded and again while decoding), every recurrent state and the
  ring cache against the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import recurrent as JR
from repro.models.params import init_params as jax_init_params
from repro.train.step import make_ctx as jax_make_ctx
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import recurrent as R
from repro_torch.models.layers import KVCache
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import LayerSpec
from repro_torch.train.step import make_ctx

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCH = "recurrentgemma-2b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


def _model_order(jm, tree):
    """A reference tree of per-layer entries (parameters or caches) as
    the port's list: prefix, the scanned unit unstacked repeat by
    repeat, suffix."""
    out = list(tree["prefix"])
    for r in range(jm.repeats):
        out += [jax.tree.map(lambda a, r=r: a[r], u) for u in tree["scan"]]
    return out + list(tree["suffix"])


@pytest.fixture(scope="module")
def block():
    spec_kw = dict(d_model=32, width=48, conv_width=4)
    jspec, spec = JR.RGLRUSpec(**spec_kw), R.RGLRUSpec(**spec_kw)
    jp = _np(jax_init_params(JR.rglru_block_defs(jspec),
                             jax.random.PRNGKey(1)))
    return jspec, spec, jp, {k: _t(v) for k, v in jp.items()}


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 2, 7, 37, 100])
def test_rglru_block_train_matches_reference(block, seq):
    jspec, spec, jp, p = block
    x = _x(2, seq, 32, seq)
    out, st = R.rglru_block_train(p, _t(x))
    jout, jst = JR.rglru_block_train(jp, jnp.asarray(x))
    assert out.shape == jout.shape and st.h.dtype == torch.float32
    _close(out, jout, LAYER_TOL)
    _close(st.h, jst.h, LAYER_TOL)
    _close(st.conv, jst.conv, LAYER_TOL)


def test_rglru_block_decode_continues_the_reference(block):
    jspec, spec, jp, p = block
    x = _x(3, 21, 32, 5)
    _, st = R.rglru_block_train(p, _t(x[:, :13]))
    _, jst = JR.rglru_block_train(jp, jnp.asarray(x[:, :13]))
    for t in range(13, 21):
        out, st = R.rglru_block_decode(p, _t(x[:, t:t + 1]), st)
        jout, jst = JR.rglru_block_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                          jst)
        _close(out, jout, LAYER_TOL)
        _close(st.h, jst.h, LAYER_TOL)
        _close(st.conv, jst.conv, LAYER_TOL)
    # prefill + decode is the whole sequence through the block
    full, fst = R.rglru_block_train(p, _t(x))
    _close(out, full[:, -1:], LAYER_TOL)
    _close(st.h, fst.h, LAYER_TOL)


def test_conv_state_carries_across_a_split(block):
    _, _, jp, p = block
    u = _t(_x(2, 11, 48, 6))
    whole, wst = R._conv1d(p, u, None)
    first, st = R._conv1d(p, u[:, :6], None)
    rest, st2 = R._conv1d(p, u[:, 6:], st)
    _close(torch.cat([first, rest], dim=1), whole, 1e-6)
    torch.testing.assert_close(st2, wst, rtol=0, atol=0)
    jwhole, jst = JR._conv1d(jp, jnp.asarray(u.numpy()), None)
    _close(whole, jwhole, LAYER_TOL)
    _close(wst, jst, LAYER_TOL)


@pytest.mark.parametrize("seq", [1, 5, 64, 129])
def test_scan_is_the_sequential_recurrence(seq):
    rng = np.random.default_rng(seq)
    log_a = _t(-np.abs(rng.standard_normal((2, seq, 8))).astype(np.float32))
    gx = _t(rng.standard_normal((2, seq, 8)).astype(np.float32))
    h0 = _t(rng.standard_normal((2, 8)).astype(np.float32))
    got = R._rglru_scan(log_a, gx, h0)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-12)) * gx
    h, want = h0, []
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(got, torch.stack(want, dim=1), LAYER_TOL)
    jgot = JR._rglru_scan(jnp.asarray(log_a.numpy()),
                          jnp.asarray(gx.numpy()), jnp.asarray(h0.numpy()))
    _close(got, jgot, LAYER_TOL)


# ---------------------------------------------------------------------------
# the recurrentgemma smoke LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = build_model(cfg)
    return jm, jp, model, params_from_jax(_np(jp))


def test_layer_plan_and_params_in_model_order(pair):
    jm, jp, model, state = pair
    cfg = model.cfg
    kinds = [s.kind for s in model.plan]
    assert kinds == ["rglru", "rglru", "local", "rglru", "rglru"]
    assert all(s == LayerSpec(s.kind, "mlp", cfg.d_ff) for s in model.plan)
    # the reference scans (rglru, rglru, local) once beside a 2-layer
    # suffix; unstacking keeps model order
    assert (len(jm.prefix), len(jm.unit), jm.repeats, len(jm.suffix)) == \
        (0, 3, 1, 2)
    for mine, ref in zip(state["layers"], _model_order(jm, jp),
                         strict=True):
        assert sorted(mine) == sorted(ref)
        for a, b in zip(tree_leaves(mine), tree_leaves(_np(ref))):
            np.testing.assert_array_equal(a.numpy(), b)
    assert sum(t.numel() for t in tree_leaves(state)) == \
        sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    own = model.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [tuple(t.shape) for t in tree_leaves(state)]


def _check_caches(cache, jcache, jm):
    for c, jc in zip(cache, _model_order(jm, jcache), strict=True):
        if isinstance(c, KVCache):
            assert c.windowed and jc.windowed
            _close(c.k, jc.k, LAYER_TOL)
            _close(c.v, jc.v, LAYER_TOL)
        else:
            assert isinstance(c, R.RGLRUState)
            _close(c.h, jc.h, LAYER_TOL)
            _close(c.conv, jc.conv, LAYER_TOL)


def test_prefill_and_greedy_decode_match_reference(pair):
    """40 prompt tokens + 16 new against a window of 32: the ring is
    seeded rolled (40 >= 32) and keeps wrapping while decoding."""
    jm, jp, model, state = pair
    cfg = model.cfg
    assert cfg.local_window == 32
    b, s, steps = 2, 40, 16
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (b, s))
    cache_len = s + steps
    jlogits, jcache = jm.prefill(
        jp, jnp.asarray(tokens, jnp.int32),
        jax_make_ctx(None, "prefill", cache_len=cache_len, remat=False))
    logits, cache = model.prefill(state, torch.from_numpy(tokens),
                                  make_ctx("prefill", cache_len=cache_len))
    _close(logits, jlogits, LOGIT_TOL)
    assert cache[2].k.shape[1] == cfg.local_window
    _check_caches(cache, jcache, jm)

    jdctx = jax_make_ctx(None, "decode", cache_len=cache_len)
    dctx = make_ctx("decode", cache_len=cache_len)
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(steps - 1):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlogits, jcache = jm.decode_step(jp, jtok, jcache,
                                         jnp.int32(s + i), jdctx)
        logits, cache = model.decode_step(state, tok, cache, s + i, dctx)
        _close(logits, jlogits, LOGIT_TOL)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _check_caches(cache, jcache, jm)


def test_empty_caches_match_reference(pair):
    jm, _, model, _ = pair
    cache_len = 56
    empty = model.init_cache(3, make_ctx("decode", cache_len=cache_len))
    jempty = jm.init_cache(3, jax_make_ctx(None, "decode",
                                           cache_len=cache_len))
    for c, jc in zip(empty, _model_order(jm, jempty), strict=True):
        assert type(c).__name__ == type(jc).__name__
        for f in dataclasses.fields(c):
            got, want = getattr(c, f.name), getattr(jc, f.name)
            if isinstance(got, torch.Tensor):
                assert tuple(got.shape) == want.shape
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                assert got == want
