"""Port vs reference: flash attention on the CPU.

* the host helpers ``flash_tile_map`` / ``flash_grid_counts`` give the
  reference's arrays exactly;
* the plain PyTorch version matches ``flash_attention_pallas(...,
  interpret=True)`` in both grids on the cases of tests/test_flash.py
  and tests/test_kernels.py (2e-5 in fp32, 5e-2 in bf16, the bounds
  those tests hold the reference to);
* ``ops.flash_attention`` records the same dispatch events as the
  reference's ``backend="pallas", interpret=True`` with one tuner loaded
  from one artifact;
* a CUDA backend on CPU tensors raises.

The CUDA kernel itself is tested on the card by
tests/test_torch_flash_cuda.py.  Inputs are made with numpy from a
seed and handed to both packages.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import AdsalaTuner as JaxTuner
from repro.kernels import ops as jops
from repro.kernels.flash_attention import (
    flash_attention_pallas,
    flash_grid_counts as jax_grid_counts,
    flash_tile_map as jax_tile_map,
)
from repro.kernels.recorder import DispatchRecorder as JaxRecorder
from repro_torch.core import AdsalaTuner
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import ops
from repro_torch.kernels.recorder import DispatchRecorder
from repro_torch.kernels.ref import flash_attention_ref

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

FP32_TOL = 2e-5
BF16_TOL = 5e-2


def _qkv(sq, skv, d=16, bh=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, sq, d)).astype(np.float32),
            rng.standard_normal((bh, skv, d)).astype(np.float32),
            rng.standard_normal((bh, skv, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

_MAP_CASES = [
    (96, 96, 32, 32, True, None), (100, 64, 32, 32, True, None),
    (64, 100, 32, 32, True, None), (96, 96, 32, 32, True, 40),
    (80, 80, 32, 32, False, None), (96, 96, 32, 32, False, 24),
    (1024, 1024, 512, 512, True, None), (1024, 1024, 128, 512, True, None),
    (1024, 1024, 1024, 512, True, None), (600, 37, 64, 16, False, 8),
    (130, 70, 32, 32, True, None), (8, 600, 16, 128, True, 200),
]


@pytest.mark.parametrize("sq,skv,bq,bkv,causal,window", _MAP_CASES)
def test_tile_map_and_counts_match_reference(sq, skv, bq, bkv, causal,
                                             window):
    kw = dict(causal=causal, window=window)
    for got, want in zip(F.flash_tile_map(sq, skv, bq, bkv, **kw),
                         jax_tile_map(sq, skv, bq, bkv, **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert F.flash_grid_counts(sq, skv, bq, bkv, **kw) == \
        jax_grid_counts(sq, skv, bq, bkv, **kw)
    assert F._clamp_blocks(sq, skv, bq, bkv) == (
        min(bq, max(8, sq)), min(bkv, max(8, skv)))


def test_tile_map_matches_reference_on_random_shapes():
    rng = np.random.default_rng(5)
    for _ in range(60):
        sq, skv = (int(x) for x in rng.integers(1, 700, 2))
        bq, bkv = (int(x) for x in rng.choice([8, 16, 64, 128, 512], 2))
        causal = bool(rng.integers(2))
        window = [None, 1, 16, 200][int(rng.integers(4))]
        for got, want in zip(
                F.flash_tile_map(sq, skv, bq, bkv, causal=causal,
                                 window=window),
                jax_tile_map(sq, skv, bq, bkv, causal=causal,
                             window=window)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# plain version vs the Pallas kernel (interpret mode), both grids
# ---------------------------------------------------------------------------

_PARITY_CASES = [
    # (sq, skv, d, bh, bq, bkv, causal, window, seed) — tests/test_flash.py
    (96, 96, 16, 2, 32, 32, True, None, 0),
    (100, 64, 16, 2, 32, 32, True, None, 0),
    (64, 100, 16, 2, 32, 32, True, None, 0),
    (96, 96, 16, 2, 32, 32, True, 40, 0),
    (80, 80, 16, 2, 32, 32, False, None, 0),
    (96, 96, 16, 2, 32, 32, False, 24, 0),
    (100, 64, 16, 2, 32, 32, True, None, 7),
    (130, 70, 16, 2, 32, 32, True, None, 7),
    (96, 33, 16, 2, 32, 32, True, None, 7),
    (64, 50, 16, 2, 32, 32, False, None, 9),
    # tests/test_kernels.py
    (128, 128, 64, 3, 32, 32, True, None, 1),
    (96, 96, 64, 3, 32, 64, True, None, 1),
    (64, 64, 64, 3, 64, 64, True, None, 1),
    (128, 128, 64, 3, 32, 32, True, 48, 1),
    (96, 96, 64, 3, 32, 64, True, 48, 1),
    (64, 64, 64, 3, 64, 64, True, 48, 1),
]


@pytest.mark.parametrize("sq,skv,d,bh,bq,bkv,causal,window,seed",
                         _PARITY_CASES)
def test_plain_matches_pallas_both_grids(sq, skv, d, bh, bq, bkv, causal,
                                         window, seed):
    q, k, v = _qkv(sq, skv, d, bh, seed)
    kw = dict(bq=bq, bkv=bkv, causal=causal, window=window)
    got = F.flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw).numpy()
    for grid in F.FLASH_GRID_KINDS:
        want = np.asarray(flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
            grid=grid, **kw))
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    # the port's oracle agrees too
    ref = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window).numpy()
    np.testing.assert_allclose(got, ref, atol=FP32_TOL, rtol=FP32_TOL)


def test_plain_matches_pallas_gqa_broadcast_kv():
    """8 query heads sharing 2 KV heads, broadcast before the flat call
    (tests/test_flash.py::test_tri_grid_matches_dense_gqa_broadcast_kv)."""
    rng = np.random.default_rng(3)
    b, h, hk, s, d = 2, 8, 2, 72, 16
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kv = rng.standard_normal((2, b, hk, s, d)).astype(np.float32)
    k, v = (np.repeat(a, h // hk, axis=1) for a in kv)
    flat = (b * h, s, d)
    q, k, v = (a.reshape(flat) for a in (q, k, v))
    got = F.flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), bq=32,
                                  bkv=32).numpy()
    for grid in F.FLASH_GRID_KINDS:
        want = np.asarray(flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=32, bkv=32,
            interpret=True, grid=grid))
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("sq,d,same_qkv", [(64, 16, False), (64, 32, True)])
def test_plain_matches_pallas_bf16(sq, d, same_qkv):
    """bf16 inputs (tests/test_flash.py::test_bf16_tri_parity and
    tests/test_kernels.py::test_flash_attention_bf16)."""
    q, k, v = _qkv(sq, sq, d, 2, seed=4)
    if same_qkv:
        k = v = q
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = F.flash_attention_torch(qb, kb, vb, bq=32, bkv=32)
    assert got.dtype == torch.bfloat16
    # hand the reference the same bf16-rounded values
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (qb, kb, vb))
    for grid in F.FLASH_GRID_KINDS:
        want = np.asarray(flash_attention_pallas(
            jq, jk, jv, bq=32, bkv=32, interpret=True, grid=grid),
            np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=BF16_TOL, rtol=BF16_TOL)


def test_plain_fully_masked_rows_give_zero():
    """A row with no visible key outputs 0 (the kernel's clamped
    denominator): non-causal, window 4, Sq > Skv + window."""
    q, k, v = _qkv(40, 16, 16, 1, seed=2)
    out = F.flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False,
                                  window=4, bq=8, bkv=8).numpy()
    assert np.all(out[:, 19:] == 0)
    assert np.all(np.abs(out[:, :19]).sum(-1) > 0)


def test_plain_rejects_bad_shapes_and_grids():
    q = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="bad attention shapes"):
        F.flash_attention_torch(q, torch.zeros(3, 64, 32),
                                torch.zeros(3, 64, 32))
    with pytest.raises(ValueError, match="unknown flash grid"):
        F.flash_attention_torch(q, q, q, grid="banded")


# ---------------------------------------------------------------------------
# tuned dispatch through ops.flash_attention
# ---------------------------------------------------------------------------

def _event(e):
    cfg = None if e.config is None else dataclasses.astuple(e.config)
    return (e.routine, e.m, e.k, e.n, cfg, e.count, e.cache_hit, e.site)


@pytest.mark.parametrize("sq,causal,window,explicit", [
    (40, True, None, False),       # attn, tuned blocks + grid
    (64, True, 24, False),         # windowed attn
    (40, False, None, False),      # unmasked keeps the gemm identity
    (64, True, None, True),        # explicit knobs skip the tuner
])
def test_ops_records_the_reference_events(tiny_artifact, sq, causal,
                                          window, explicit):
    jt = JaxTuner.from_artifact(tiny_artifact.dir)
    tt = AdsalaTuner.from_artifact(tiny_artifact.dir)
    q, k, v = _qkv(sq, sq, 16, 3, seed=13)
    kw = dict(causal=causal, window=window)
    if explicit:
        kw.update(bq=32, bkv=32, grid="tri")
    outs = {}
    events = {}
    for _ in range(2):                       # second pass: cache hits
        with JaxRecorder() as jrec:
            outs["jax"] = np.asarray(jops.flash_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tuner=jt,
                backend="pallas", interpret=True, **kw))
        with DispatchRecorder() as trec:
            outs["torch"] = ops.flash_attention(
                torch.from_numpy(q), torch.from_numpy(k),
                torch.from_numpy(v), tuner=tt, backend="torch",
                **kw).numpy()
        events.setdefault("jax", []).extend(map(_event, jrec.events))
        events.setdefault("torch", []).extend(map(_event, trec.events))
    assert events["torch"] == events["jax"]
    assert len(events["torch"]) == 2
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_cuda_backend_on_cpu_tensors_raises(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _qkv(32, 32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        F.flash_attention_cuda(q, k, v)
    monkeypatch.setenv("ADSALA_BACKEND", "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention(q, k, v)
    monkeypatch.setenv("ADSALA_BACKEND", "pallas")
    with pytest.raises(ValueError, match="ADSALA_BACKEND"):
        ops.flash_attention(q, k, v)
    monkeypatch.setenv("ADSALA_BACKEND", "torch")
    out = ops.flash_attention(q, k, v)
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="unknown backend"):
        ops.resolve_backend("pallas")


def test_auto_backend_follows_the_device():
    assert ops.resolve_backend("auto", torch.device("cpu")) == "torch"
    assert ops.resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    assert ops.resolve_backend("torch", torch.device("cuda", 0)) == "torch"


def test_hint_observe_and_select_match_reference(tiny_artifact):
    """The observability sites and the routine fallback give the
    reference's events and configs (an artifact without ``trsm`` signal
    would degrade to gemm; this one has it)."""
    jt = JaxTuner.from_artifact(tiny_artifact.dir)
    tt = AdsalaTuner.from_artifact(tiny_artifact.dir)
    calls = [(4096, 2048, 6144, "gemm"), (2048, 64, 128, "trsm"),
             (512, 64, 512, "syrk"), (4096, 2048, 6144, "gemm")]
    with JaxRecorder() as jrec, DispatchRecorder() as trec:
        for m, k, n, rt in calls:
            jc = jops.dispatch_hint(m, k, n, jt, rt, site="s", count=3)
            tc = ops.dispatch_hint(m, k, n, tt, rt, site="s", count=3)
            assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
            jops.observe(m, k, n, jt, rt, site="o")
            ops.observe(m, k, n, tt, rt, site="o")
    assert list(map(_event, trec.events)) == list(map(_event, jrec.events))
    for m, k, n, rt in calls:
        jr, jc, jh = jops._select(m, k, n, rt, jt, need_config=True)
        tr, tc, th = ops._select(m, k, n, rt, tt, need_config=True)
        assert (tr, th) == (jr, jh)
        assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
    assert ops._select(8, 8, 8, "gemm", tt, need_config=False) == \
        ("gemm", None, False)
    for bad in ("gemmm", "attention"):
        with pytest.raises(ValueError, match="unknown routine"):
            ops.supported_routine(bad, tt)
        with pytest.raises(ValueError, match="unknown routine"):
            ops.observe(8, 8, 8, None, bad)


@pytest.mark.parametrize("name", ["matmul", "syrk", "trsm", "grouped",
                                  "flash"])
def test_oracles_match_reference(name):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(6)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if name == "matmul":
        args, kw = (arr(33, 17), arr(17, 29)), {}
    elif name == "syrk":
        args, kw = (arr(24, 16), arr(24, 16)), {"lower": False}
    elif name == "trsm":
        a = np.tril(arr(20, 20)) + 8 * np.eye(20, dtype=np.float32)
        args, kw = (a, arr(20, 7)), {"lower": True}
    elif name == "grouped":
        args, kw = (arr(3, 10, 8), arr(3, 8, 6)), {}
    else:
        args, kw = (arr(2, 40, 16), arr(2, 40, 16), arr(2, 40, 16)), \
            {"causal": True, "window": 12}
    fn = {"matmul": "matmul_ref", "syrk": "syrk_ref", "trsm": "trsm_ref",
          "grouped": "grouped_matmul_ref", "flash": "flash_attention_ref"}
    got = getattr(tref, fn[name])(*map(torch.from_numpy, args), **kw)
    want = getattr(jref, fn[name])(*map(jnp.asarray, args), **kw)
    assert got.dtype == torch.float32
    tol = 1e-3 if name == "trsm" else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
