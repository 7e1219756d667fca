"""Port vs reference: flash attention on the CPU.

* the host helpers ``flash_tile_map`` / ``flash_grid_counts`` give the
  reference's arrays exactly;
* the plain PyTorch version matches ``flash_attention_pallas(...,
  interpret=True)`` in both grids on the cases of tests/test_flash.py
  and tests/test_kernels.py (2e-5 in fp32, 5e-2 in bf16, the bounds
  those tests hold the reference to);
* on rows with no visible key it gives the reference's value: the
  uniform average of v over the visible logical tiles, else 0;
* ``ops.flash_attention`` records the same dispatch events as the
  reference's ``backend="pallas", interpret=True`` with one tuner loaded
  from one artifact;
* a CUDA backend on CPU tensors raises;
* the launch planner ``flash_launch``: every plan fits shared memory,
  CTA rows never exceed the clamped bq, both walks get one plan, the
  tuner's blocks give 128-row CTAs at D <= 64 (64 at D = 128, 32 in
  fp32 at D = 256), and ``FLASH_PLANS`` is the table the kernel
  compiles;
* at head dim 256 (recurrentgemma's MQA local attention) the plain
  version matches the Pallas kernel, causal and windowed on ragged Sq.

The CUDA kernel itself is tested on the card by
tests/test_torch_flash_cuda.py.  Inputs are made with numpy from a
seed and handed to both packages.
"""

import dataclasses
import pathlib
import re

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
from repro_torch.core.costmodel import FLASH_BLOCKS
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


@pytest.mark.parametrize("sq,bq,bkv,window", [(100, 32, 32, 40),
                                               (77, 64, 32, 48),
                                               (96, 32, 64, None)])
def test_plain_matches_pallas_d256_mqa(sq, bq, bkv, window):
    """recurrentgemma's local attention: head dim 256, one KV head shared
    by every query head (MQA, broadcast before the flat call), causal
    with a window, Sq not a multiple of bq."""
    rng = np.random.default_rng(sq)
    b, h, d = 2, 3, 256
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    kv = rng.standard_normal((2, b, 1, sq, d)).astype(np.float32)
    k, v = (np.repeat(a, h, axis=1) for a in kv)
    q, k, v = (a.reshape(b * h, sq, d) for a in (q, k, v))
    kw = dict(bq=bq, bkv=bkv, causal=True, window=window)
    got = F.flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw).numpy()
    for grid in F.FLASH_GRID_KINDS:
        want = np.asarray(flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
            grid=grid, **kw))
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


_FULLY_MASKED_CASES = [
    # (bh, sq, skv, d, bq, bkv, window), non-causal: rows with no
    # visible key inside a visible logical tile, and rows without one
    (1, 96, 40, 16, 32, 16, 8),        # rows 47-63 average, 64-95 zero
    (2, 64, 16, 16, 32, 16, 8),        # rows 23-31 average, 32-63 zero
    (1, 40, 16, 16, 8, 8, 4),          # rows 19-23 average, 24-39 zero
]


def _fully_masked_parity(bh, sq, skv, d, bq, bkv, window, seed=2):
    q, k, v = _qkv(sq, skv, d, bh, seed=seed)
    kw = dict(bq=bq, bkv=bkv, causal=False, window=window)
    got = F.flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw).numpy()
    for grid in F.FLASH_GRID_KINDS:
        want = np.asarray(flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
            grid=grid, **kw))
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    return got


def test_plain_fully_masked_rows_give_zero():
    """Non-causal, window 4, Sq > Skv + window, blocks (8, 8): rows 19-23
    see no key but lie in Q block 2, whose KV tile 1 is visible, so the
    reference averages v over that tile's 8 columns; rows 24-39 lie in Q
    blocks with no visible tile and give 0.  The plain version matches
    the Pallas kernel in both walks."""
    out = _fully_masked_parity(*_FULLY_MASKED_CASES[2])
    assert np.all(out[:, 24:] == 0)
    _, _, v = _qkv(40, 16, 16, 1, seed=2)
    np.testing.assert_allclose(out[:, 19:24],
                               np.broadcast_to(v[:, None, 8:16].mean(2),
                                               (1, 5, 16)),
                               atol=FP32_TOL, rtol=FP32_TOL)
    assert np.all(np.abs(out[:, :24]).sum(-1) > 0)


@pytest.mark.parametrize("bh,sq,skv,d,bq,bkv,window", _FULLY_MASKED_CASES)
def test_plain_fully_masked_rows_match_pallas(bh, sq, skv, d, bq, bkv,
                                              window):
    """Rows with no visible key take the reference's value in both
    walks: the uniform average of v over every column of the visible
    logical tiles (padded columns count, with v = 0), else 0."""
    out = _fully_masked_parity(bh, sq, skv, d, bq, bkv, window)
    first_empty = skv + window - 1
    assert np.abs(out[:, first_empty:]).sum() > 0  # not all zero


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


def test_cuda_kernel_under_autograd_raises(monkeypatch):
    """No backward: an input that requires grad is refused before the
    device is checked, by the wrapper and by ops on the cuda backend
    (explicit, through the environment, or auto on a CUDA device); the
    library and torch backends differentiate."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(32, 32))
    kg = k.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*'library'"):
        F.flash_attention_cuda(q, kg, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, kg, v, backend="cuda")
    monkeypatch.setenv("ADSALA_BACKEND", "cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, kg, v)
    monkeypatch.delenv("ADSALA_BACKEND")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.resolve_backend("auto", torch.device("cuda", 0), q, kg)
    with torch.no_grad():
        with pytest.raises(ValueError, match="not a CUDA device"):
            F.flash_attention_cuda(q, kg, v)
    for be in ("torch", "library"):
        assert ops.flash_attention(q, kg, v, backend=be).grad_fn is not None


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


# ---------------------------------------------------------------------------
# the launch planner (flash_launch) and the C table it mirrors
# ---------------------------------------------------------------------------

_PLAN_KEYS = sorted(F.FLASH_PLANS, key=lambda k: (str(k[0]), k[1]))
#: shared memory a block may use on the H100 (bytes)
SMEM_MAX = 232448
_CU = (pathlib.Path(F.__file__).parent / "csrc" / "flash_attention.cu"
       ).read_text()


@pytest.mark.parametrize("dtype,d", _PLAN_KEYS)
def test_flash_plan_fits_shared_memory(dtype, d):
    """Every plan, at its largest CTA, fits the 232,448 bytes a block may
    take, and two such CTAs fit an SM (half of it, as the C entry
    asserts)."""
    for bq in (16, 32, 64, 128, 256, 512, 1024):
        plan = F.flash_launch(1024, 1024, d, bq, 512, dtype=dtype)
        assert plan.smem <= SMEM_MAX // 2 <= SMEM_MAX, (bq, plan)


@pytest.mark.parametrize("sq,bq", [(1024, 1024), (1024, 512), (300, 512),
                                   (200, 1024), (256, 96), (256, 64),
                                   (256, 32), (40, 512), (12, 512),
                                   (5, 512)])
@pytest.mark.parametrize("dtype,d", _PLAN_KEYS)
def test_flash_plan_rows_never_exceed_the_clamped_block(dtype, d, sq, bq):
    plan = F.flash_launch(sq, sq, d, bq, 512, dtype=dtype)
    assert (plan.bq, plan.bkv) == F._clamp_blocks(sq, sq, bq, 512)
    assert plan.cta_rows in F.FLASH_CTA_ROWS
    assert plan.cta_rows % 16 == 0                # whole warps
    if plan.bq >= 16:
        assert plan.cta_rows <= plan.bq
    else:                                         # one warp is the least
        assert plan.cta_rows == 16
    # the largest that fits: twice the rows would exceed bq or the plan
    assert 2 * plan.cta_rows > min(plan.bq, F.FLASH_PLANS[dtype, d][2]) \
        or plan.cta_rows == 128


@pytest.mark.parametrize("dtype,d", _PLAN_KEYS)
def test_flash_plan_is_the_same_for_both_walks(dtype, d):
    for sq, bq, bkv in ((1024, 1024, 512), (777, 256, 128), (96, 32, 32)):
        plans = {g: F.flash_launch(sq, sq, d, bq, bkv, dtype=dtype, grid=g)
                 for g in F.FLASH_GRID_KINDS}
        assert plans["dense"] == plans["tri"]


@pytest.mark.parametrize("block", FLASH_BLOCKS)
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tuner_blocks_give_128_row_ctas(block, d, dtype):
    plan = F.flash_launch(1024, 1024, d, *block, dtype=dtype)
    assert plan.cta_rows == 128
    # mixtral's head dim: 64 rows keep two CTAs an SM (64 accumulators a
    # lane cap 128-row CTAs at 128 registers)
    assert F.flash_launch(1024, 1024, 128, *block,
                          dtype=dtype).cta_rows == 64
    # recurrentgemma's: 128 accumulators a lane; 32 rows in fp32 (64 in
    # bf16) keep two CTAs an SM within its shared memory
    assert F.flash_launch(1024, 1024, 256, *block, dtype=dtype).cta_rows \
        == (32 if dtype == torch.float32 else 64)


@pytest.mark.parametrize("dtype,d", _PLAN_KEYS)
def test_flash_plan_table_matches_the_kernel(dtype, d):
    """FLASH_PLANS is the table the C entry compiles (Plan<D> in each
    dtype's half of flash_attention.cu), and the header's shared bytes
    are the planner's."""
    table = _CU.split("struct Plan;\n#if FLASH_DTYPE == 0\n")[1]
    f32, bf16 = table.split("#endif")[0].split("#else")
    src = f32 if dtype == torch.float32 else bf16
    m = re.search(rf"Plan<{d}> {{ static constexpr int BN = (\d+), "
                  rf"STAGES = (\d+), ROWS = (\d+); }}", src)
    assert m is not None
    assert tuple(map(int, m.groups())) == F.FLASH_PLANS[dtype, d]
    name = "fp32" if dtype == torch.float32 else "bf16"
    bn, stages, rows = F.FLASH_PLANS[dtype, d]
    plan = F.flash_launch(1024, 1024, d, 1024, 512, dtype=dtype)
    row = re.search(rf"//   {name}\s+{d}\s+{bn}\s+{stages}\s+{rows}\s+"
                    r"([\d,]+) B", _CU)
    assert row is not None and int(row.group(1).replace(",", "")) == \
        plan.smem


def test_flash_planner_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no flash plan"):
        F.flash_launch(64, 64, 48, 32, 32)
    with pytest.raises(ValueError, match="no flash plan"):
        F.flash_launch(64, 64, 64, 32, 32, dtype=torch.float16)
    with pytest.raises(ValueError, match="unknown flash grid"):
        F.flash_launch(64, 64, 64, 32, 32, grid="diag")
    with pytest.raises(ValueError, match="bad flash extents"):
        F.flash_launch(0, 64, 64, 32, 32)


# ---------------------------------------------------------------------------
# head dims between the kernel's: zero-padded to the next one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,kd", [(24, 32), (80, 128), (96, 128),
                                  (192, 256)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_padded_plain_call_matches_unpadded(d, kd, causal, window):
    """The wrapper's repair of a head dim the kernel lacks: q, k, v
    zero-padded to ``kernel_head_dim(d)`` at the true d**-0.5 scale,
    the output sliced back, agree with the unpadded call within the
    flash bound; at d = 80 both agree with the reference's kernel."""
    assert F.kernel_head_dim(d) == kd
    q, k, v = (torch.from_numpy(a) for a in _qkv(70, 90, d=d, bh=3,
                                                 seed=d))
    kw = dict(bq=32, bkv=32, causal=causal, window=window)
    want = F.flash_attention_torch(q, k, v, **kw)
    padded = [F.pad_head_dim(t, kd) for t in (q, k, v)]
    assert all(t.shape[-1] == kd and t.is_contiguous() for t in padded)
    assert torch.equal(padded[0][..., d:], torch.zeros_like(
        padded[0][..., d:]))
    got = F.flash_attention_torch(*padded, sm_scale=d ** -0.5, **kw)
    assert torch.equal(got[..., d:], torch.zeros_like(got[..., d:]))
    np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(),
                               atol=FP32_TOL, rtol=FP32_TOL)
    if d == 80:
        ref = np.asarray(flash_attention_pallas(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()), interpret=True, **kw))
        np.testing.assert_allclose(got[..., :d].numpy(), ref,
                                   atol=FP32_TOL, rtol=FP32_TOL)


def test_head_dim_above_256_is_refused():
    """No plan past 256: the wrapper's argument check refuses it before
    it looks at the device (a deliberate departure from the reference's
    kernel, which takes any head dim)."""
    assert F.kernel_head_dim(256) == 256
    assert F.kernel_head_dim(1) == 16
    for d in (257, 320, 512):
        with pytest.raises(ValueError, match="above 256"):
            F.kernel_head_dim(d)
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 16, d=320, bh=1))
    with pytest.raises(ValueError, match=r"head dim 320 above 256"):
        F.flash_attention_cuda(q, k, v)
    # the plain version takes any head dim
    assert F.flash_attention_torch(q, k, v).shape == q.shape
