"""Port vs reference: the training slice on the CPU.

* ``ops.flash_attention(backend="library")`` against the reference's
  ``backend="xla"``: the SYRK-scores path (causal, Sq <= 512 untuned),
  the chunked path (Sq 768, Sq not a multiple of the chunk), windowed,
  non-causal and the memory guard — outputs within 2e-5 in fp32 and the
  same dispatch events, untuned and with one tuned artifact at lengths
  where its prediction picks each path; gradients of both paths against
  ``jax.grad`` (normwise 1e-4) and ``gradcheck`` in float64;
* ``layers.chunked_attention_xla`` with a query offset and a value width
  other than the key's;
* the ``library`` backend of ``matmul`` / ``syrk`` / ``trsm`` /
  ``grouped_matmul`` runs the oracles and records the reference's
  events;
* on the smoke configs of stablelm-1.6b and mixtral-8x22b, with the
  reference's train state carried by ``convert.state_from_jax``:
  ``chunked_cross_entropy`` and ``LM.loss`` within 1e-5 relative,
  every gradient within 1e-4 normwise of ``jax.grad``, one train step
  (loss, ``grad_norm``, ``lr``, params and moments) and one
  ``adamw_update`` with and without compression within 1e-5 normwise;
  remat on and off give the same loss and gradients and record the same
  events (the recomputation records nothing); a recorded step has the
  reference's routine mix;
* the launcher: ``--scale smoke --device cpu`` trains, checkpoints and
  resumes; ``--device cuda`` without a card raises.

Inputs are made with numpy from a seed; the reference runs on the JAX
CPU backend.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import AdsalaTuner as JaxTuner
from repro.kernels import ops as jops
from repro.kernels.recorder import DispatchRecorder as JaxRecorder
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ShapeSpec
from repro.train import optim as jopt
from repro.train.step import build_train_step as jax_build_train_step
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_ctx as jax_make_ctx
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import (AdsalaTuner, InstallConfig, SimulatedBackend,
                              install)
from repro_torch.core.costmodel import ROUTINES
from repro_torch.kernels import ops
from repro_torch.kernels.recorder import DispatchRecorder
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import optim
from repro_torch.train.step import build_train_step, make_ctx

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

FP32_TOL = 2e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
OPT_TOL = 1e-5
ARCHS = ["stablelm-1.6b", "mixtral-8x22b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _qkv(sq, skv, d=16, bh=3, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((bh, sq, d), (bh, skv, d), (bh, skv, d)))


def _event(e):
    cfg = None if e.config is None else dataclasses.astuple(e.config)
    return (e.routine, e.m, e.k, e.n, cfg, e.count, e.cache_hit, e.site)


def _normwise(got, want):
    """||got - want|| / ||want|| (0 when both are 0)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return num / den if den > 0 else num


def _attend_both(q, k, v, *, tuner=None, jtuner=None, **kw):
    """(port out, port events, reference out, reference events)."""
    with DispatchRecorder() as rec:
        out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), tuner=tuner,
                                  backend="library", **kw)
    with JaxRecorder() as jrec:
        jout = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), tuner=jtuner,
                                    backend="xla", **kw)
    return (out.numpy(), [_event(e) for e in rec.events],
            np.asarray(jout), [_event(e) for e in jrec.events])


# ---------------------------------------------------------------------------
# attention on the library backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,causal,window,path", [
    (256, True, None, "syrk"),        # untuned: Sq <= 512 materialises
    (768, True, None, "attn"),        # chunked, 2 chunks
    (600, True, None, "attn"),        # Sq not a multiple of the chunk
    (200, True, 48, "attn"),          # windowed -> chunked
    (100, False, None, "gemm"),       # non-causal -> chunked, gemm tag
])
def test_library_attention_matches_xla(sq, causal, window, path):
    q, k, v = _qkv(sq, sq, seed=sq)
    out, ev, jout, jev = _attend_both(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out, jout, atol=FP32_TOL, rtol=FP32_TOL)
    assert ev == jev
    assert [e[0] for e in ev] == [path]
    assert ev[0][5] == 3                      # count = BH


def test_library_attention_memory_guard(monkeypatch):
    """Past SYRK_SCORES_BYTES_MAX the score path is inadmissible even
    where the untuned threshold would take it."""
    for mod in (ops, jops):
        monkeypatch.setattr(mod, "SYRK_SCORES_BYTES_MAX", 64 * 64 * 4 - 1)
    q, k, v = _qkv(64, 64, seed=5)
    out, ev, jout, jev = _attend_both(q, k, v, causal=True)
    assert ev == jev and [e[0] for e in ev] == ["attn"]
    np.testing.assert_allclose(out, jout, atol=FP32_TOL, rtol=FP32_TOL)
    # one byte more of budget and the same call materialises the scores
    for mod in (ops, jops):
        monkeypatch.setattr(mod, "SYRK_SCORES_BYTES_MAX", 64 * 64 * 4)
    out2, ev2, _, jev2 = _attend_both(q, k, v, causal=True)
    assert ev2 == jev2 and [e[0] for e in ev2] == ["syrk"]
    np.testing.assert_allclose(out2, out, atol=FP32_TOL, rtol=FP32_TOL)


class _ShortSyrk(SimulatedBackend):
    """The simulated backend with syrk timings scaled by (m / 512)^1.5:
    cheaper than the model below 512 rows, dearer above, so a tuner
    installed on it prices the SYRK score path in at short lengths and
    out at long ones."""

    def time_routine_batch(self, dims, cfgs, *, routines=None):
        t = super().time_routine_batch(dims, cfgs, routines=routines)
        rids = np.broadcast_to(np.asarray(routines), (len(dims),))
        f = (np.asarray(dims)[:, 0] / 512.0) ** 1.5
        return np.where((rids == ROUTINES.index("syrk"))[:, None],
                        t * f[:, None], t)


@pytest.fixture(scope="module")
def syrk_artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("syrk_artifact")
    install(_ShortSyrk(seed=0),
            InstallConfig(n_samples=48, repeats=2, tile_ids=(0, 3),
                          models=("decision_tree",),
                          routines=("gemm", "syrk", "attn"),
                          grid_budget="small", cv_splits=3, seed=0),
            artifact_dir=str(d))
    return str(d)


@pytest.mark.parametrize("sq,path", [(256, "syrk"), (768, "attn")])
def test_tuned_library_attention_matches_xla(syrk_artifact, sq, path):
    tuner = AdsalaTuner.from_artifact(syrk_artifact)
    jtuner = JaxTuner.from_artifact(syrk_artifact)
    t_attn = np.min(tuner.select_with_times(sq, 16, sq, "attn")[1])
    t_syrk = np.min(tuner.select_with_times(sq, 16, sq, "syrk")[1])
    assert (t_syrk < t_attn) == (path == "syrk"), "artifact premise"
    tuner = AdsalaTuner.from_artifact(syrk_artifact)     # fresh caches
    q, k, v = _qkv(sq, sq, seed=sq + 1)
    evs, jevs = [], []
    for _ in range(2):                        # second pass: cache hits
        out, ev, jout, jev = _attend_both(q, k, v, tuner=tuner,
                                          jtuner=jtuner, causal=True)
        evs += ev
        jevs += jev
        np.testing.assert_allclose(out, jout, atol=FP32_TOL, rtol=FP32_TOL)
    assert evs == jevs
    assert [e[0] for e in evs] == [path, path]
    assert all(e[4] is not None for e in evs)


@pytest.mark.parametrize("sq,window", [(40, None), (520, None), (60, 24)])
def test_library_attention_gradients_match_jax(sq, window):
    """Both paths (SYRK scores at 40, chunked at 520 and windowed)."""
    q, k, v = _qkv(sq, sq, bh=2, seed=sq + 7)
    dout = np.random.default_rng(sq).standard_normal(q.shape).astype(
        np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              backend="library")
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))

    def f(q_, k_, v_):
        o = jops.flash_attention(q_, k_, v_, causal=True, window=window,
                                 backend="xla")
        return jnp.sum(o * dout)

    jgrads = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, jg in zip(grads, jgrads):
        assert _normwise(g.numpy(), jg) < GRAD_TOL


def test_library_attention_gradcheck_float64():
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_(
            True)

    q, k, v = t(2, 6, 4), t(2, 6, 4), t(2, 6, 4)
    for kw in (dict(causal=True), dict(causal=True, window=3),
               dict(causal=False)):
        assert torch.autograd.gradcheck(
            lambda a, b, c: ops.flash_attention(a, b, c, backend="library",
                                                **kw), (q, k, v))
    # several chunks, an offset and a wider value
    v5 = t(2, 9, 5)
    k9 = t(2, 9, 4)
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.chunked_attention(
            a, b, c, causal=True, window=None, sm_scale=None, chunk=4,
            q_offset=3), (q, k9, v5))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_chunked_attention_xla_matches_reference(causal, window):
    rng = np.random.default_rng(11)
    b, h, sq, skv, dh, dv, off = 2, 3, 13, 20, 8, 6, 7
    q = rng.standard_normal((b, h, sq, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, skv, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, dv)).astype(np.float32)
    out = L.chunked_attention_xla(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=off, chunk=4)
    jout = JL.chunked_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=off, chunk=4)
    assert out.shape == (b, h, sq, dv)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("name", ["matmul", "syrk", "trsm", "grouped"])
def test_library_blas_runs_the_oracles_with_reference_events(
        tiny_artifact, name):
    rng = np.random.default_rng(17)
    a = rng.standard_normal((48, 40)).astype(np.float32)
    b = rng.standard_normal((40, 24)).astype(np.float32)
    tri = (np.tril(rng.standard_normal((48, 48))) + 8 * np.eye(48)).astype(
        np.float32)
    rhs = rng.standard_normal((48, 24)).astype(np.float32)
    x = rng.standard_normal((3, 16, 40)).astype(np.float32)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)
    calls = {
        "matmul": ((a, b), {}),
        "syrk": ((a,), {}),
        "trsm": ((tri, rhs), {}),
        "grouped": ((x, w), {"group_sizes": [5, 16, 0]}),
    }
    args, kw = calls[name]
    fn = ops.grouped_matmul if name == "grouped" else getattr(ops, name)
    jfn = jops.grouped_matmul if name == "grouped" else getattr(jops, name)
    tuner = AdsalaTuner.from_artifact(tiny_artifact.dir)
    jtuner = JaxTuner.from_artifact(tiny_artifact.dir)
    calls_before = tuner.stats["calls"]
    out = fn(*map(torch.from_numpy, args), tuner=tuner, backend="library",
             **kw)
    # nobody watching: the library path consults no tuner
    assert tuner.stats["calls"] == calls_before
    with DispatchRecorder() as rec:
        out = fn(*map(torch.from_numpy, args), tuner=tuner,
                 backend="library", **kw)
    with JaxRecorder() as jrec:
        jout = jfn(*map(jnp.asarray, args), tuner=jtuner, backend="xla",
                   **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=1e-4)
    assert [_event(e) for e in rec.events] == \
        [_event(e) for e in jrec.events]
    assert rec.events and all(e.config is not None for e in rec.events)


def test_library_backend_from_the_environment(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _qkv(32, 32))
    monkeypatch.setenv("ADSALA_BACKEND", "library")
    with DispatchRecorder() as rec:
        out = ops.flash_attention(q, k, v)
    assert [e.routine for e in rec.events] == ["syrk"]
    monkeypatch.delenv("ADSALA_BACKEND")
    np.testing.assert_allclose(out.numpy(), ops.flash_attention(
        q, k, v).numpy(), atol=FP32_TOL, rtol=FP32_TOL)


def test_make_ctx_trains_on_library():
    assert make_ctx("train").backend == "library"
    assert make_ctx("train", backend="cuda").backend == "library"
    assert make_ctx("prefill").backend == "auto"
    assert make_ctx("train", remat=False).remat is False
    with pytest.raises(ValueError, match="unknown backend"):
        make_ctx("prefill", backend="xla")


# ---------------------------------------------------------------------------
# loss, gradients, the train step
# ---------------------------------------------------------------------------

def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], 1)
    labels[rng.random((b, s)) < 0.1] = -1           # ignored positions
    return {"tokens": tokens, "labels": labels.astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = jax_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jopt_cfg = jopt.AdamWConfig(warmup_steps=2, total_steps=20)
    jstate = jax_init_train_state(jm, jcfg, jopt_cfg, jax.random.PRNGKey(0))
    model = build_model(get_smoke_config(arch))
    return jm, jstate, model


def test_chunked_cross_entropy_matches_reference():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 520, 32)).astype(np.float32)
    w = rng.standard_normal((32, 50)).astype(np.float32) * 0.3
    labels = rng.integers(0, 50, (2, 520)).astype(np.int32)
    labels[:, ::7] = -1
    ce = T.chunked_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(labels))
    jce = JT.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(labels))
    np.testing.assert_allclose(float(ce), float(jce), rtol=LOSS_TOL)
    # every label ignored: the mean over no positions is 0, not NaN
    none = T.chunked_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.full((2, 520), -1))
    assert float(none) == 0.0


@pytest.mark.parametrize("seq", [40, 520])
def test_loss_and_gradients_match_jax(pair, seq):
    """S 40 takes the SYRK-scores attention, 520 the chunked one (and
    two cross-entropy chunks)."""
    jm, jstate, model = pair
    batch = _batch(model.cfg.vocab, 2, seq, seed=seq)
    jctx = jax_make_ctx(None, "train")
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch), jctx))(
        jstate["params"])
    params = params_from_jax(_np(jstate["params"]))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss = model.loss(params, _tb(batch), make_ctx("train"))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    want = tree_leaves(params_from_jax(_np(jgrads)))
    assert len(grads) == len(want)
    for g, jg in zip(grads, want):
        assert _normwise(g.numpy(), jg.numpy()) < GRAD_TOL


def test_remat_gives_the_same_loss_gradients_and_events(pair):
    _, jstate, model = pair
    batch = _tb(_batch(model.cfg.vocab, 2, 24, seed=1))
    out = {}
    for remat in (False, True):
        params = params_from_jax(_np(jstate["params"]))
        leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
        with DispatchRecorder() as rec:
            loss = model.loss(params, batch, make_ctx("train", remat=remat))
            grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss, grads, [_event(e) for e in rec.events])
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # the backward recomputation ran the layers again and recorded nothing
    assert out[True][2] == out[False][2]
    assert len(out[True][2]) > 0


def _jax_step(jm, jcfg, jopt_cfg, jstate, batch):
    step, _, _ = jax_build_train_step(
        jm, jcfg, ShapeSpec("t", batch["tokens"].shape[1],
                            batch["tokens"].shape[0], "train"), None,
        jopt_cfg)
    return step(jstate, jax.tree.map(jnp.asarray, batch))


def test_train_step_matches_reference(pair):
    jm, jstate, model = pair
    jopt_cfg = jopt.AdamWConfig(warmup_steps=2, total_steps=20)
    opt_cfg = optim.AdamWConfig(warmup_steps=2, total_steps=20)
    batch = _batch(model.cfg.vocab, 2, 32, seed=4)
    jnew, jmet = _jax_step(jm, jm.cfg, jopt_cfg, jstate, batch)
    state = state_from_jax(_np(jstate))
    step, specs, bspecs = build_train_step(model, model.cfg, opt_cfg)
    assert specs is None and bspecs is None
    new, met = step(state, _tb(batch))
    assert int(new["step"]) == 1
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=LOSS_TOL)
    jnew_t = state_from_jax(_np(jnew))
    for key in ("params", "m", "v"):
        for a, b in zip(tree_leaves(new[key]), tree_leaves(jnew_t[key])):
            assert _normwise(a.numpy(), b.numpy()) < OPT_TOL, key
    # the state's own tensors stay plain: no grad, updated in place
    assert not any(t.requires_grad for t in tree_leaves(new["params"]))
    assert new["params"] is state["params"]


def test_train_step_records_the_reference_routine_mix(pair, syrk_artifact):
    """Forward and backward events: the reference's scan records its
    unit layer once, the port every layer, so the port's events are the
    reference's repeated per layer and the routine mix is the same."""
    jm, jstate, model = pair
    jopt_cfg = jopt.AdamWConfig()
    batch = _batch(model.cfg.vocab, 2, 32, seed=6)
    jtuner = JaxTuner.from_artifact(syrk_artifact)
    tuner = AdsalaTuner.from_artifact(syrk_artifact)
    step, _, _ = jax_build_train_step(
        jm, jm.cfg, ShapeSpec("t", 32, 2, "train"), None, jopt_cfg,
        tuner=jtuner)
    with JaxRecorder() as jrec:
        step(jstate, jax.tree.map(jnp.asarray, batch))
    pstep, _, _ = build_train_step(model, model.cfg, optim.AdamWConfig(),
                                   tuner=tuner)
    with DispatchRecorder() as rec:
        pstep(state_from_jax(_np(jstate)), _tb(batch))
    key = lambda e: (e[0], e[1], e[2], e[3], e[4], e[5], e[7])
    n_layers = model.cfg.n_layers
    want = collections.Counter()
    for e in jrec.events:
        want[key(_event(e))] += n_layers
    assert collections.Counter(key(_event(e)) for e in rec.events) == want
    # the tuner prices the score path in at S 32; a window rules it out
    core = "attn" if model.cfg.window else "syrk"
    assert {e.routine for e in rec.events} >= {"gemm", core}
    mix, jmix = rec.routine_mix(), jrec.routine_mix()
    assert mix.keys() == jmix.keys()
    for r in mix:
        assert mix[r] == pytest.approx(jmix[r], rel=1e-9)


def _random_opt_state(jstate, compress, seed):
    rng = np.random.default_rng(seed)
    like = _np(jstate["params"])
    rand = lambda scale, pos=False: jax.tree.map(
        lambda a: (np.abs if pos else np.asarray)(
            rng.standard_normal(a.shape) * scale).astype(np.float32), like)
    st = {"params": like, "m": rand(1e-2), "v": rand(1e-3, pos=True),
          "step": np.int32(3)}
    if compress:
        st["ef"] = rand(1e-3)
    return st, rand(0.3)


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_reference(pair, compress):
    """With compression the clip is left inactive (scale exactly 1): the
    int8 rounding is discontinuous, and a last-ulp difference between
    the two packages' global norms would move elements across a
    rounding boundary (a whole quantisation step each).  Without it the
    clip is active."""
    _, jstate, _ = pair
    st, grads = _random_opt_state(jstate, compress, seed=int(compress))
    cfg_kw = dict(warmup_steps=2, total_steps=20, compress=compress,
                  clip_norm=1e6 if compress else 1.0)
    jnew, jmet = jopt.adamw_update(jax.tree.map(jnp.asarray, st),
                                   jax.tree.map(jnp.asarray, grads),
                                   jopt.AdamWConfig(**cfg_kw))
    state = state_from_jax(st)
    tgrads = params_from_jax(grads)
    new, met = optim.adamw_update(state, tgrads,
                                  optim.AdamWConfig(**cfg_kw))
    assert (float(met["grad_norm"]) > cfg_kw["clip_norm"]) != compress
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=OPT_TOL)
    assert int(new["step"]) == int(jnew["step"]) == 4
    jnew_t = state_from_jax(_np(jnew))
    keys = ("params", "m", "v") + (("ef",) if compress else ())
    assert ("ef" in new) == compress
    for key in keys:
        for a, b in zip(tree_leaves(new[key]), tree_leaves(jnew_t[key])):
            assert _normwise(a.numpy(), b.numpy()) < OPT_TOL, key
    # the gradients are left as they were
    for a, b in zip(tree_leaves(tgrads),
                    tree_leaves(params_from_jax(grads))):
        assert torch.equal(a, b)


def test_state_from_jax_carries_every_leaf(pair):
    jm, jstate, model = pair
    state = state_from_jax(_np(jstate))
    assert set(state) == {"params", "m", "v", "step"}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for key in ("params", "m", "v"):
        n = sum(t.numel() for t in tree_leaves(state[key]))
        assert n == sum(int(np.prod(a.shape))
                        for a in jax.tree.leaves(jstate[key]))
        assert len(state[key]["layers"]) == model.cfg.n_layers
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["m"]))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_checkpoints_and_resumes(tmp_path):
    from repro_torch.ckpt.checkpoint import latest_step
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    base = ["--scale", "smoke", "--device", "cpu", "--ckpt-dir", ck,
            "--batch", "2", "--seq", "24", "--ckpt-every", "2"]
    res = train.run(base + ["--steps", "3"])
    assert res.summary["step"] == 3 and res.resumed_from is None
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert latest_step(ck) == 3 and res.ckpt_bytes > 0
    saved = tree_map(torch.clone, res.driver.state)
    res2 = train.run(base + ["--steps", "5", "--resume"])
    assert res2.resumed_from == 3 and res2.summary["step"] == 5
    assert len(res2.losses) == 2 and latest_step(ck) == 5
    assert int(res2.driver.state["step"]) == 5
    # the resumed run started from the saved state, not a fresh one
    assert not torch.equal(res2.driver.state["params"]["embed"],
                           saved["params"]["embed"])


def test_launcher_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(["--device", "cuda", "--ckpt-dir", str(tmp_path)])


def test_train_cli_runs_on_cpu_without_jax(tmp_path):
    """``python -m repro_torch.launch.train`` with jax and the reference
    unimportable: trains, then resumes from its checkpoint."""
    import os
    import subprocess
    import sys
    import textwrap

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    code = textwrap.dedent("""
        import sys, runpy
        sys.modules['jax'] = None; sys.modules['repro'] = None
        sys.argv = ['train'] + sys.argv[1:]
        runpy.run_module('repro_torch.launch.train', run_name='__main__')
        """)
    args = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
            "--batch", "2", "--seq", "16"]
    for extra in (["--steps", "2"], ["--steps", "3", "--resume"]):
        res = subprocess.run([sys.executable, "-c", code, *args, *extra],
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 0, res.stderr
    assert "resumed from step 2" in res.stdout
    assert "done: step=3" in res.stdout
