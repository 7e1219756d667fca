"""Port vs reference: the mLSTM and sLSTM blocks and xlstm-125m on the
CPU.

Inputs are made with numpy from a seed; the reference's parameters are
carried across with numpy.  The port keeps the reference's chunked
mLSTM form and its sequential sLSTM, so the reference's tolerances
hold: blocks and states 1e-5, logits after the whole stack 1e-4 (fp32).

* ``mlstm_train`` with chunk 8 at sequence 20 (three chunks, the last
  one padded) and at 16 (whole chunks), its state, and ``mlstm_decode``
  continuing it; the chunked form against the port's own step
  recurrence on whole chunks;
* ``slstm_train`` and ``slstm_decode``;
* the xlstm smoke LM (mlstm, slstm, mlstm, slstm; no MLP): parameters,
  prefill and greedy decode against the reference, every state too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import xlstm as JX
from repro.models.params import init_params as jax_init_params
from repro.train.step import make_ctx as jax_make_ctx
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import xlstm as X
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import LayerSpec
from repro_torch.train.step import make_ctx

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCH = "xlstm-125m"
SPEC = dict(d_model=32, n_heads=2, chunk=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


def _close_state(st, jst, tol=LAYER_TOL):
    assert type(st).__name__ == type(jst).__name__
    for f in dataclasses.fields(st):
        got = getattr(st, f.name)
        assert got.dtype == torch.float32
        _close(got, getattr(jst, f.name), tol)


def _model_order(jm, tree):
    out = list(tree["prefix"])
    for r in range(jm.repeats):
        out += [jax.tree.map(lambda a, r=r: a[r], u) for u in tree["scan"]]
    return out + list(tree["suffix"])


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _block(defs, seed):
    jp = _np(jax_init_params(defs(JX.XLSTMSpec(**SPEC)),
                             jax.random.PRNGKey(seed)))
    return jp, {k: _t(v) for k, v in jp.items()}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [20, 16, 3])
def test_mlstm_train_and_decode_match_reference(seq):
    """20 crosses two chunk boundaries and pads the last chunk; 3 is one
    short chunk (the chunk shrinks to the sequence)."""
    jspec, spec = JX.XLSTMSpec(**SPEC), X.XLSTMSpec(**SPEC)
    jp, p = _block(JX.mlstm_defs, 2)
    x = _x(2, seq, 32, seq)
    out, st = X.mlstm_train(p, _t(x), spec)
    jout, jst = JX.mlstm_train(jp, jnp.asarray(x), jspec)
    _close(out, jout, LAYER_TOL)
    _close_state(st, jst)
    for i in range(3):
        x1 = _x(2, 1, 32, 100 + i)
        out, st = X.mlstm_decode(p, _t(x1), spec, st)
        jout, jst = JX.mlstm_decode(jp, jnp.asarray(x1), jspec, jst)
        _close(out, jout, LAYER_TOL)
        _close_state(st, jst)


def test_mlstm_chunked_form_is_the_step_recurrence():
    """On whole chunks the parallel form equals the decode recurrence
    run token by token from the empty state."""
    spec = X.XLSTMSpec(**SPEC)
    _, p = _block(JX.mlstm_defs, 3)
    x = _t(_x(2, 24, 32, 7))
    out, st = X.mlstm_train(p, x, spec)
    step = X.init_mlstm_state(2, spec)
    outs = []
    for t in range(24):
        o, step = X.mlstm_decode(p, x[:, t:t + 1], spec, step)
        outs.append(o)
    _close(out, torch.cat(outs, dim=1), LAYER_TOL)
    for f in ("c", "n", "m"):
        _close(getattr(st, f), getattr(step, f), LAYER_TOL)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 13])
def test_slstm_train_and_decode_match_reference(seq):
    jspec, spec = JX.XLSTMSpec(**SPEC), X.XLSTMSpec(**SPEC)
    jp, p = _block(JX.slstm_defs, 4)
    x = _x(3, seq, 32, seq)
    out, st = X.slstm_train(p, _t(x), spec)
    jout, jst = JX.slstm_train(jp, jnp.asarray(x), jspec)
    _close(out, jout, LAYER_TOL)
    _close_state(st, jst)
    for i in range(3):
        x1 = _x(3, 1, 32, 200 + i)
        out, st = X.slstm_decode(p, _t(x1), spec, st)
        jout, jst = JX.slstm_decode(jp, jnp.asarray(x1), jspec, jst)
        _close(out, jout, LAYER_TOL)
        _close_state(st, jst)


def test_empty_states_match_reference():
    jspec, spec = JX.XLSTMSpec(**SPEC), X.XLSTMSpec(**SPEC)
    for mine, ref in ((X.init_mlstm_state(3, spec),
                       JX.init_mlstm_state(3, jspec)),
                      (X.init_slstm_state(3, spec),
                       JX.init_slstm_state(3, jspec))):
        for f in dataclasses.fields(mine):
            np.testing.assert_array_equal(getattr(mine, f.name).numpy(),
                                          np.asarray(getattr(ref, f.name)))


# ---------------------------------------------------------------------------
# the xlstm smoke LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jm, jp, build_model(cfg), params_from_jax(_np(jp))


def test_layer_plan_and_params_carry_over(pair):
    jm, jp, model, state = pair
    assert model.plan == [LayerSpec("mlstm", "none", 0),
                          LayerSpec("slstm", "none", 0)] * 2
    # no MLP: no ln2 either
    assert all(sorted(layer) == ["ln1", "mixer"]
               for layer in state["layers"])
    for mine, ref in zip(state["layers"], _model_order(jm, jp),
                         strict=True):
        for a, b in zip(tree_leaves(mine), tree_leaves(_np(ref))):
            np.testing.assert_array_equal(a.numpy(), b)
    assert sum(t.numel() for t in tree_leaves(state)) == \
        sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))


def test_prefill_and_greedy_decode_match_reference(pair):
    jm, jp, model, state = pair
    cfg = model.cfg
    b, s, steps = 2, 20, 6
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (b, s))
    cache_len = s + steps
    jlogits, jcache = jm.prefill(
        jp, jnp.asarray(tokens, jnp.int32),
        jax_make_ctx(None, "prefill", cache_len=cache_len, remat=False))
    logits, cache = model.prefill(state, torch.from_numpy(tokens),
                                  make_ctx("prefill", cache_len=cache_len))
    _close(logits, jlogits, LOGIT_TOL)
    for c, jc in zip(cache, _model_order(jm, jcache), strict=True):
        _close_state(c, jc)

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
    for c, jc in zip(cache, _model_order(jm, jcache), strict=True):
        _close_state(c, jc)
    empty = model.init_cache(b, dctx)
    jempty = jm.init_cache(b, jdctx)
    for c, jc in zip(empty, _model_order(jm, jempty), strict=True):
        _close_state(c, jc, 0)
