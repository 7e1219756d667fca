"""Port vs reference: training the recurrent, xLSTM, encoder-decoder and
VLM families on the CPU.

On the smoke configs of recurrentgemma-2b (RG-LRU blocks and local MQA
attention), xlstm-125m (mLSTM and sLSTM blocks), whisper-tiny (the
encoder-decoder) and chameleon-34b (qk-norm), with the reference's
train state carried by ``convert.state_from_jax``:

* ``loss`` within 1e-5 relative and every gradient within 1e-4 normwise
  of ``jax.grad`` at S 40 (the SYRK-scores attention) and 520 (the
  chunked attention, two cross-entropy chunks), under the noise-leaf
  rule below;
* remat on and off: the same loss, gradients and events;
* one train step (loss, ``grad_norm``, ``lr``, params and moments)
  within 1e-5, with and without int8 compression;
* the recorded train step's events against the reference's segments:
  the reference's scan records its unit once, its prefix and suffix
  layers once each, while the port records every layer;
* ``adamw_update`` with compression against the reference on the
  hybrid and MoE layer lists, whose int8 scale groups are the
  reference's scan-stacked tensors (the layers at one position of the
  unit share a scale, prefix and suffix layers keep their own);
* the launcher trains, checkpoints and resumes each family.

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
from repro.kernels import recorder as jrecorder
from repro.kernels.recorder import DispatchRecorder as JaxRecorder
from repro.models import transformer as JT
from repro.models.config import ShapeSpec
from repro.train import optim as jopt
from repro.train.step import build_train_step as jax_build_train_step
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_ctx as jax_make_ctx
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import AdsalaTuner
from repro_torch.kernels.recorder import DispatchRecorder
from repro_torch.models.params import tree_leaves, tree_map, tree_paths
from repro_torch.train import optim
from repro_torch.train.step import build_train_step, make_ctx

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
OPT_TOL = 1e-5
#: A leaf whose reference gradient norm is below this fraction of the
#: whole gradient's norm is rounding noise on both sides, and is compared
#: only inside the whole-vector comparison.  The one such leaf is the
#: mLSTM's input-gate bias ``mixer/b_igate``: the max-stabiliser makes
#: the output insensitive to a shift shared by all input gates, so its
#: gradient is 2e-9 – 6e-9 in the port and 9e-10 – 4e-9 in the reference
#: against a whole-gradient norm of 1.33 (xlstm-125m smoke, S 40 and
#: 520), and the two differ by 0.78 – 6.3 normwise.  AdamW's first step,
#: lr·g/(|g|+eps), carries that noise into the leaf's ``params`` and
#: ``m`` (2.1 normwise there).
NOISE_FRACTION = 1e-6
FAMILIES = ["recurrentgemma-2b", "xlstm-125m", "whisper-tiny",
            "chameleon-34b"]
#: layer lists whose int8 scale groups the old per-name rule got wrong:
#: a unit of several layers with a suffix (recurrentgemma), a unit of
#: two kinds that share parameter names (xlstm), a dense layer before
#: the MoE layers (deepseek)
COMPRESS_ARCHS = ["recurrentgemma-2b", "xlstm-125m", "deepseek-v2-236b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


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


def _flat(leaves):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in leaves])


def _noise_leaves(jgrads, paths):
    """Indices of the leaves under NOISE_FRACTION (see there); asserts
    that they are mLSTM input-gate biases, the leaf the rule is for."""
    norms = [np.linalg.norm(np.asarray(g, np.float64)) for g in jgrads]
    whole = np.sqrt(sum(n * n for n in norms))
    noise = {i for i, n in enumerate(norms) if n < NOISE_FRACTION * whole}
    assert all(paths[i][-1] == "b_igate" for i in noise), \
        [paths[i] for i in noise]
    return noise


def _assert_leaves_close(got, want, tol, noise=frozenset(), what=""):
    """Every leaf within ``tol`` normwise, except the ``noise`` leaves;
    all of them, the noise leaves included, within ``tol`` as one
    vector."""
    got = [np.asarray(a) for a in got]
    want = [np.asarray(a) for a in want]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if i not in noise:
            assert _normwise(a, b) < tol, (what, i)
    assert _normwise(_flat(got), _flat(want)) < tol, what


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], 1)
    labels[rng.random((b, s)) < 0.1] = -1           # ignored positions
    out = {"tokens": tokens, "labels": labels.astype(np.int32)}
    if cfg.family == "audio":
        out["audio_emb"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_grads(jm, jparams, batch):
    jctx = jax_make_ctx(None, "train")
    return jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch), jctx))(
        jparams)


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    arch = request.param
    jcfg = jax_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jopt_cfg = jopt.AdamWConfig(warmup_steps=2, total_steps=20)
    jstate = jax_init_train_state(jm, jcfg, jopt_cfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jm, jstate, build_model(cfg)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [40, 520])
def test_loss_and_gradients_match_jax(pair, seq):
    jm, jstate, model = pair
    batch = _batch(model.cfg, 2, seq, seed=seq)
    jloss, jgrads = _jax_grads(jm, jstate["params"], batch)
    params = params_from_jax(_np(jstate["params"]))
    paths = tree_paths(params)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss = model.loss(params, _tb(batch), make_ctx("train"))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    want = [t.numpy() for t in tree_leaves(params_from_jax(_np(jgrads)))]
    noise = _noise_leaves(want, paths)
    assert bool(noise) == (model.cfg.name == "xlstm-125m")
    _assert_leaves_close([g.numpy() for g in grads], want, GRAD_TOL, noise,
                         "grads")


def test_loss_without_ctx_trains_on_the_library_backend(pair):
    _, jstate, model = pair
    params = params_from_jax(_np(jstate["params"]))
    batch = _tb(_batch(model.cfg, 1, 12, seed=2))
    with DispatchRecorder() as rec:
        loss = model.loss(params, batch)
    with DispatchRecorder() as rec2:
        want = model.loss(params, batch, make_ctx("train"))
    assert torch.equal(loss, want)
    assert [_event(e) for e in rec.events] == \
        [_event(e) for e in rec2.events]


def test_remat_gives_the_same_loss_gradients_and_events(pair):
    _, jstate, model = pair
    batch = _tb(_batch(model.cfg, 2, 24, seed=1))
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
    assert out[True][2] == out[False][2]
    # xLSTM's blocks dispatch nothing through the recorder (nor do the
    # reference's)
    assert bool(out[True][2]) == (model.cfg.name != "xlstm-125m")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _to_reference(tree, jm):
    """A port tree of tensors -> the reference's layout in numpy: the
    layer list regrouped into prefix / scan (stacked across the repeats)
    / suffix."""
    tree = tree_map(lambda t: t.detach().numpy(), tree)
    if "layers" not in tree:
        return tree
    layers = tree.pop("layers")
    pre, n, reps = len(jm.prefix), len(jm.unit), jm.repeats
    tree["prefix"] = layers[:pre]
    tree["scan"] = [jax.tree.map(lambda *a: np.stack(a), *[
        layers[pre + r * n + k] for r in range(reps)]) for k in range(n)]
    tree["suffix"] = layers[pre + n * reps:]
    return tree


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_reference(pair, compress):
    """The step's metrics against the reference's step; its state
    against the reference's ``adamw_update`` on the port's gradients,
    leaf by leaf, and without compression against the reference's whole
    step, each state tree as one vector.

    Not leaf by leaf against the reference's step: two autograd
    implementations give gradients 1e-6 apart, and AdamW's first step
    and the int8 rounding are discontinuous in them.  The first step is
    lr·g/(|g|+eps) elementwise, so an element whose gradient is near 0
    moves by up to 2 lr with a sign flip (the sLSTM's bias, an RG-LRU
    gate bias); and with compression, one element in about 4 000 crosses
    a rounding boundary and moves a whole quantisation step.  With
    compression the clip is left inactive, as in
    tests/test_torch_train.py."""
    jm, jstate, model = pair
    kw = dict(warmup_steps=2, total_steps=20, compress=compress,
              clip_norm=1e6 if compress else 1.0)
    batch = _batch(model.cfg, 2, 32, seed=4)
    jstart = _np(jstate)
    if compress:
        jstart["ef"] = jax.tree.map(np.zeros_like, jstart["params"])
    step, _, _ = jax_build_train_step(
        jm, jm.cfg, ShapeSpec("t", 32, 2, "train"), None,
        jopt.AdamWConfig(**kw))
    jnew, jmet = step(jax.tree.map(jnp.asarray, jstart),
                      jax.tree.map(jnp.asarray, batch))

    # the gradients the port's step computes
    params = params_from_jax(jstart["params"])
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    it = iter(torch.autograd.grad(
        model.loss(params, _tb(batch), make_ctx("train")), leaves))
    grads = tree_map(lambda _: next(it), params)
    pstep, _, _ = build_train_step(model, model.cfg,
                                   optim.AdamWConfig(**kw))
    new, met = pstep(state_from_jax(jstart), _tb(batch))
    assert int(new["step"]) == 1
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=LOSS_TOL)
    keys = ("params", "m", "v") + (("ef",) if compress else ())
    want, _ = jopt.adamw_update(jax.tree.map(jnp.asarray, jstart),
                                jax.tree.map(jnp.asarray,
                                             _to_reference(grads, jm)),
                                jopt.AdamWConfig(**kw))
    want = state_from_jax(_np(want))
    for key in keys:
        _assert_leaves_close(tree_leaves(new[key]), tree_leaves(want[key]),
                             OPT_TOL, what=key)
    if not compress:
        jnew_t = state_from_jax(_np(jnew))
        for key in keys:
            assert _normwise(_flat(tree_leaves(new[key])),
                             _flat(tree_leaves(jnew_t[key]))) < OPT_TOL, key


def _unit_events(jm, batch_shape, jtuner):
    """The reference's events of one pass of its scanned unit, forward
    and backward (traced abstractly)."""
    b, s = batch_shape
    ctx = jax_make_ctx(None, "train", tuner=jtuner)
    x = jax.ShapeDtypeStruct((b, s, jm.cfg.d_model), jnp.float32)
    unit_p = jax.eval_shape(lambda: jax.tree.map(
        lambda a: a[0], jm.init(jax.random.PRNGKey(0))["scan"]))
    with JaxRecorder() as rec:
        def run(ps, h):
            for p, spec in zip(ps, jm.unit):
                h, _, _ = JT._apply_layer_train(p, h, jm.cfg, spec, ctx)
            return h
        jax.eval_shape(run, unit_p, x)
        jrecorder.record_backward(0, tuner=jtuner)
    return rec.events


def test_train_step_records_the_reference_events(pair, tiny_artifact):
    """The port records every layer: the reference's events with its
    scanned unit's events repeated ``repeats`` times (prefix and suffix
    once each, as in the reference); the encoder-decoder's per-layer
    lists record one for one."""
    jm, jstate, model = pair
    batch = _batch(model.cfg, 2, 32, seed=6)
    jtuner = JaxTuner.from_artifact(tiny_artifact.dir)
    tuner = AdsalaTuner.from_artifact(tiny_artifact.dir)
    step, _, _ = jax_build_train_step(
        jm, jm.cfg, ShapeSpec("t", 32, 2, "train"), None,
        jopt.AdamWConfig(), tuner=jtuner)
    with JaxRecorder() as jrec:
        step(jstate, jax.tree.map(jnp.asarray, batch))
    pstep, _, _ = build_train_step(model, model.cfg, optim.AdamWConfig(),
                                   tuner=tuner)
    with DispatchRecorder() as rec:
        pstep(state_from_jax(_np(jstate)), _tb(batch))
    key = lambda e: (e[0], e[1], e[2], e[3], e[4], e[5], e[7])
    want = collections.Counter(key(_event(e)) for e in jrec.events)
    if model.cfg.family != "audio" and jm.repeats > 1:
        for e in _unit_events(jm, (2, 32), jtuner):
            want[key(_event(e))] += jm.repeats - 1
    got = collections.Counter(key(_event(e)) for e in rec.events)
    assert got == want
    assert bool(got) == (model.cfg.name != "xlstm-125m")
    assert all(e.config is not None for e in rec.events)


# ---------------------------------------------------------------------------
# the int8 compression's scale groups
# ---------------------------------------------------------------------------

def _random_opt_state(jparams, seed):
    rng = np.random.default_rng(seed)
    like = _np(jparams)
    rand = lambda scale, pos=False: jax.tree.map(
        lambda a: (np.abs if pos else np.asarray)(
            rng.standard_normal(a.shape) * scale).astype(np.float32), like)
    st = {"params": like, "m": rand(1e-2), "v": rand(1e-3, pos=True),
          "step": np.int32(3), "ef": rand(1e-3)}
    return st, rand(0.3)


@pytest.mark.parametrize("arch", COMPRESS_ARCHS)
def test_compressed_adamw_update_matches_reference(arch):
    """The reference quantises each tensor of its prefix / scan / suffix
    tree with its own int8 scale; a scan tensor stacks the layers at one
    position of the unit.  The clip is inactive (see the step test)."""
    jm = jax_build_model(jax_smoke_config(arch))
    st, grads = _random_opt_state(jm.init(jax.random.PRNGKey(1)), seed=7)
    kw = dict(warmup_steps=2, total_steps=20, compress=True, clip_norm=1e6)
    jnew, _ = jopt.adamw_update(jax.tree.map(jnp.asarray, st),
                                jax.tree.map(jnp.asarray, grads),
                                jopt.AdamWConfig(**kw))
    new, _ = optim.adamw_update(state_from_jax(st), params_from_jax(grads),
                                optim.AdamWConfig(**kw))
    jnew_t = state_from_jax(_np(jnew))
    for key in ("params", "m", "v", "ef"):
        for a, b in zip(tree_leaves(new[key]), tree_leaves(jnew_t[key])):
            assert _normwise(a.numpy(), b.numpy()) < OPT_TOL, key


def test_scale_groups_follow_the_reference_segments():
    """Over every arch at full size (the trees of ParamDefs: no tensor
    is made), the groups are the reference's scan-stacked tensors."""
    from repro_torch.configs import ARCH_IDS, get_config

    for arch in ARCH_IDS:
        model = build_model(get_config(arch))
        if "layers" not in model.defs:
            continue
        jm = jax_build_model(get_config(arch))
        paths = tree_paths(model.defs)
        pre, unit, reps = len(jm.prefix), len(jm.unit), jm.repeats

        def owner(path):
            if path[0] != "layers":
                return path
            i = path[1]
            if pre <= i < pre + unit * reps:
                return ("scan", (i - pre) % unit) + path[2:]
            return path
        want = collections.defaultdict(list)
        for i, p in enumerate(paths):
            want[owner(p)].append(i)
        got = optim._scale_groups(model.defs)
        assert sorted(got) == sorted(want.values()), arch


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_trains_checkpoints_and_resumes(tmp_path, monkeypatch,
                                                 arch):
    """The checkpoint and the driver on the encoder-decoder tree and the
    hybrid layer lists: the saved state restores bitwise, and a resumed
    run reads its data stream (frame embeddings included) from the
    restored step on."""
    from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train

    asked = []

    class Recorded(SyntheticLM):
        def batch_at(self, step):
            out = super().batch_at(step)
            asked.append((step, sorted(out)))
            return out

    monkeypatch.setattr(train, "SyntheticLM", Recorded)
    ck = str(tmp_path / "ck")
    base = ["--arch", arch, "--scale", "smoke", "--device", "cpu",
            "--ckpt-dir", ck, "--batch", "2", "--seq", "24",
            "--ckpt-every", "2"]
    res = train.run(base + ["--steps", "3"])
    assert res.summary["step"] == 3 and res.resumed_from is None
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert latest_step(ck) == 3 and res.ckpt_bytes > 0
    saved = tree_map(torch.clone, res.driver.state)
    back = restore_checkpoint(ck, 3, saved)
    assert tree_paths(back) == tree_paths(saved)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(saved)))
    keys = ["labels", "tokens"] + (
        ["audio_emb"] if res.cfg.family == "audio" else [])
    assert asked[0] == (0, sorted(keys))
    del asked[:]
    res2 = train.run(base + ["--steps", "5", "--resume"])
    assert res2.resumed_from == 3 and res2.summary["step"] == 5
    assert asked[0] == (3, sorted(keys))
    assert len(res2.losses) == 2 and all(np.isfinite(res2.losses))
    assert latest_step(ck) == 5
    assert int(res2.driver.state["step"]) == 5


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_refuses_cuda_without_a_card(monkeypatch, tmp_path, arch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(["--arch", arch, "--device", "cuda", "--ckpt-dir",
                   str(tmp_path)])
