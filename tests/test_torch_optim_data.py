"""Port of tests/test_optim_data.py: the optimizer and the data pipeline,
against the port's functions; the synthetic batches are the reference's
bit for bit, and the int8 compression of per-layer parameters shares
the scale the reference's stacked layer tensors give."""

import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.train import optim as jopt
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models.params import tree_leaves
from repro_torch.train.optim import (
    AdamWConfig,
    adamw_update,
    clip_by_global_norm,
    compress_int8,
    compressed_grads,
    cosine_lr,
    decompress_int8,
    init_state,
)

torch.set_num_threads(1)


def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0, clip_norm=10.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    state = init_state({"w": torch.zeros(3)}, cfg)
    for _ in range(150):
        grads = {"w": 2 * (state["params"]["w"] - target)}
        state, _ = adamw_update(state, grads, cfg)
    np.testing.assert_allclose(state["params"]["w"].numpy(),
                               target.numpy(), atol=0.05)


def test_clip_by_global_norm():
    grads = {"a": torch.full((4,), 10.0), "b": torch.full((9,), 10.0)}
    clipped, gn = clip_by_global_norm(grads, 1.0)
    new_norm = torch.sqrt(sum(torch.sum(g ** 2)
                              for g in tree_leaves(clipped)))
    assert float(gn) > 1.0
    np.testing.assert_allclose(float(new_norm), 1.0, rtol=1e-5)
    # the input is left as it was
    assert torch.equal(grads["a"], torch.full((4,), 10.0))


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    i32 = lambda s: torch.tensor(s, dtype=torch.int32)
    assert float(cosine_lr(cfg, i32(0))) == 0.0
    np.testing.assert_allclose(float(cosine_lr(cfg, i32(10))), 1.0)
    assert float(cosine_lr(cfg, i32(100))) < 1e-6


@pytest.mark.parametrize("step", [0, 1, 5, 10, 57, 100, 130])
def test_cosine_schedule_matches_reference(step):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    np.testing.assert_allclose(
        float(cosine_lr(AdamWConfig(**kw),
                        torch.tensor(step, dtype=torch.int32))),
        float(jopt.cosine_lr(jopt.AdamWConfig(**kw), np.int32(step))),
        rtol=1e-6)


def test_int8_compression_bounded_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1000) * 3)
    q, s = compress_int8(x)
    assert q.dtype == torch.int8
    err = (decompress_int8(q, s) - x).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-6


def test_error_feedback_accumulates_residual():
    """EF guarantees the *running sum* of quantised grads tracks the
    running sum of true grads (residual never lost)."""
    rng = np.random.default_rng(1)
    g_true = [torch.from_numpy(rng.standard_normal(50) * 0.01).float()
              for _ in range(30)]
    ef = {"g": torch.zeros(50)}
    total_sent = torch.zeros(50)
    for g in g_true:
        sent, new_ef = compressed_grads({"g": g}, ef)
        total_sent = total_sent + sent["g"]
        ef = new_ef
    total_true = sum(g_true)
    resid = (total_true - total_sent).abs().numpy()
    # residual bounded by one quantisation step, not growing with T
    assert resid.max() < 0.01


def test_compressed_training_still_converges():
    cfg = AdamWConfig(lr=0.05, warmup_steps=2, total_steps=300,
                      weight_decay=0.0, compress=True)
    target = torch.tensor([0.5, -1.5])
    state = init_state({"w": torch.zeros(2)}, cfg)
    assert "ef" in state
    for _ in range(250):
        grads = {"w": 2 * (state["params"]["w"] - target)}
        state, _ = adamw_update(state, grads, cfg)
    np.testing.assert_allclose(state["params"]["w"].numpy(),
                               target.numpy(), atol=0.1)


def test_compression_scale_spans_the_layer_stack():
    """Per-layer parameters quantise like the reference's stacked
    tensor: one scale for ``layers[*]["w"]``, bitwise."""
    rng = np.random.default_rng(4)
    g = [rng.standard_normal((6, 5)).astype(np.float32) * (i + 1)
         for i in range(3)]
    e = [rng.standard_normal((6, 5)).astype(np.float32) * 1e-2
         for _ in range(3)]
    b = rng.standard_normal(7).astype(np.float32)
    tree = lambda ws, bias: {"layers": [{"w": w} for w in ws],
                             "head": bias}
    t = lambda a: torch.from_numpy(a)
    sent, ef = compressed_grads(tree([t(a) for a in g], t(b)),
                                tree([t(a) for a in e], t(b * 0)))
    jsent, jef = jopt.compressed_grads(
        {"scan": np.stack(g), "head": b},
        {"scan": np.stack(e), "head": b * 0})
    for i in range(3):
        np.testing.assert_array_equal(sent["layers"][i]["w"].numpy(),
                                      np.asarray(jsent["scan"][i]))
        np.testing.assert_array_equal(ef["layers"][i]["w"].numpy(),
                                      np.asarray(jef["scan"][i]))
    np.testing.assert_array_equal(sent["head"].numpy(),
                                  np.asarray(jsent["head"]))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_data_deterministic_per_step():
    src = SyntheticLM(vocab=100, seq_len=16, global_batch=4, seed=3)
    a = src.batch_at(5)
    b = src.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = src.batch_at(6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_synthetic_labels_are_shifted_tokens():
    src = SyntheticLM(vocab=50, seq_len=8, global_batch=2, seed=0)
    b = src.batch_at(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250),
                                       (2 ** 31, 3)])
def test_synthetic_batches_are_the_reference_bit_for_bit(seed, step):
    kw = dict(vocab=100_352, seq_len=64, global_batch=3, seed=seed)
    got = SyntheticLM(**kw).batch_at(step)
    want = JaxSyntheticLM(**kw).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    # with the audio stream too
    kw.update(audio_dim=8, audio_len=5)
    got = SyntheticLM(**kw).batch_at(step)
    want = JaxSyntheticLM(**kw).batch_at(step)
    np.testing.assert_array_equal(got["audio_emb"], want["audio_emb"])


def test_prefetcher_yields_in_order():
    src = SyntheticLM(vocab=10, seq_len=4, global_batch=2, seed=1)
    it = iter(src)
    pf = Prefetcher((next(it) for _ in range(5)), depth=2)
    batches = list(pf)
    assert len(batches) == 5
    ref = [JaxSyntheticLM(vocab=10, seq_len=4, global_batch=2,
                          seed=1).batch_at(i) for i in range(5)]
    for got, want in zip(batches, ref):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
