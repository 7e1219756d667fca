"""Port vs reference: the GEMM slice (``ops.matmul`` / ``syrk`` /
``trsm`` on the tiled GEMM) on the CPU.

* the port's ``ops.matmul`` / ``syrk`` / ``trsm`` on CPU tensors (the
  plain version of the kernel) match the reference's
  ``backend="pallas", interpret=True`` on the cases of
  tests/test_kernels.py, at that file's tolerances: matmul 5e-5 in fp32
  and 1e-1 in bf16, random shapes and syrk 1e-4, trsm 1e-3;
* ``matmul_torch`` matches ``matmul_pallas`` tile for tile, ragged
  shapes included;
* the slice as a whole: one artifact written by the reference's
  ``install`` is served by both tuners, and a mixed sequence of calls
  gives equal results and equal recorder events (the gemm fallback on a
  gemm-only artifact included);
* bad shapes and a CUDA backend on CPU tensors raise;
* the launch tables: the tuner's 8 DEFAULT_TILES stay 8 launches whose
  cp.async ring fits two CTAs an SM, and the grouped kernel's planner
  (``grouped_launch``) streams thin decode buckets, splits K only where
  the card would idle and covers K exactly once, and fits the CTA rows
  to the bucket;
* ``MeasuredCUDABackend`` round-trips through ``describe_backend`` /
  ``backend_from_dict`` and refuses to time without a card.

The CUDA kernel itself is tested on the card by
tests/test_torch_gemm_cuda.py.  Inputs are made with numpy from a seed
and handed to both packages; nothing here is timed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AdsalaTuner as JaxTuner
from repro.core import InstallConfig as JaxInstallConfig
from repro.core import SimulatedBackend as JaxSimulatedBackend
from repro.core import install as jax_install
from repro.kernels import ops as jops
from repro.kernels.matmul import matmul_pallas
from repro.kernels.recorder import DispatchRecorder as JaxRecorder
from repro_torch.core import (
    DEFAULT_TILES,
    AdsalaTuner,
    GemmConfig,
    MeasuredCUDABackend,
    backend_from_dict,
    describe_backend,
)
from repro_torch.kernels import grouped_matmul as G
from repro_torch.kernels import matmul as M
from repro_torch.kernels import ops, ref
from repro_torch.kernels.recorder import DispatchRecorder

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

TOL = {"float32": 5e-5, "bfloat16": 1e-1}
RANDOM_TOL = 1e-4          # random-shape matmul and syrk
TRSM_TOL = 1e-3

_MATMUL_CASES = [          # tests/test_kernels.py
    # (m, k, n, bm, bk, bn)
    (64, 64, 64, 64, 64, 64),
    (128, 256, 128, 64, 128, 64),
    (100, 130, 70, 32, 64, 32),          # ragged
    (8, 8, 8, 32, 32, 32),               # tile > dims
    (256, 64, 512, 128, 64, 128),
    (33, 257, 65, 16, 128, 16),
]


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array of ``dtype``
    (bf16 rounded once, by torch, and handed to jax as those values)."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy(), getattr(jnp, dtype))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# ops vs the reference's Pallas path (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bm,bk,bn", _MATMUL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(m, k, n, bm, bk, bn, dtype):
    rng = np.random.default_rng(m * 1000 + n)
    (ta, ja), (tb, jb) = (_both(_arr(rng, m, k), dtype),
                          _both(_arr(rng, k, n), dtype))
    got = ops.matmul(ta, tb, tile=(bm, bk, bn))
    want = jops.matmul(ja, jb, tile=(bm, bk, bn), backend="pallas",
                       interpret=True)
    assert got.dtype == ta.dtype and tuple(got.shape) == (m, n)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(ref.matmul_ref(ta, tb)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas_random_shapes(seed, dtype):
    """tests/test_kernels.py::test_matmul_property_random_shapes: dims in
    [8, 96], tile 32 (1e-4 in fp32; bf16 keeps its 1e-1)."""
    rng = np.random.default_rng(100 + seed)
    m, k, n = (int(x) for x in rng.integers(8, 97, 3))
    (ta, ja), (tb, jb) = (_both(_arr(rng, m, k), dtype),
                          _both(_arr(rng, k, n), dtype))
    got = ops.matmul(ta, tb, tile=(32, 32, 32), backend="torch")
    want = matmul_pallas(ja, jb, bm=32, bk=32, bn=32, interpret=True)
    tol = RANDOM_TOL if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("m,k,n,tile", [
    (100, 130, 70, (32, 64, 32)),
    (33, 257, 65, (16, 128, 16)),
    (8, 8, 8, (32, 32, 32)),
    (129, 300, 200, (128, 256, 128)),
    (300, 129, 70, (256, 128, 64)),
])
def test_matmul_torch_matches_matmul_pallas_tile_for_tile(m, k, n, tile):
    rng = np.random.default_rng(m + k + n)
    a, b = _arr(rng, m, k), _arr(rng, k, n)
    bm, bk, bn = tile
    got = M.matmul_torch(torch.from_numpy(a), torch.from_numpy(b), bm=bm,
                         bk=bk, bn=bn)
    want = matmul_pallas(jnp.asarray(a), jnp.asarray(b), bm=bm, bk=bk,
                         bn=bn, interpret=True)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=TOL["float32"],
                               rtol=TOL["float32"])
    out = M.matmul_torch(torch.from_numpy(a), torch.from_numpy(b), bm=bm,
                         bk=bk, bn=bn, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("m,k", [(64, 32), (100, 130), (33, 65), (8, 8)])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("with_b", [False, True])
def test_syrk_matches_pallas(m, k, lower, with_b):
    rng = np.random.default_rng(m * 7 + k)
    a = _arr(rng, m, k)
    b = _arr(rng, m, k) if with_b else None
    got = ops.syrk(torch.from_numpy(a),
                   None if b is None else torch.from_numpy(b), lower=lower,
                   tile=(32, 32, 32))
    want = jops.syrk(jnp.asarray(a), None if b is None else jnp.asarray(b),
                     lower=lower, backend="pallas", interpret=True,
                     tile=(32, 32, 32))
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=RANDOM_TOL,
                               rtol=RANDOM_TOL)
    oracle = ref.syrk_ref(torch.from_numpy(a),
                          None if b is None else torch.from_numpy(b),
                          lower=lower)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=RANDOM_TOL,
                               rtol=RANDOM_TOL)


def _triangular(rng, m: int, lower: bool, unit_diag: bool) -> np.ndarray:
    """Well-conditioned triangular operand: |diag| + m, or (unit
    diagonal) off-diagonal entries scaled by 1/m."""
    if unit_diag:
        ell = np.tril(rng.standard_normal((m, m)), -1) / m + np.eye(m)
    else:
        ell = np.tril(rng.standard_normal((m, m)))
        np.fill_diagonal(ell, np.abs(np.diag(ell)) + m)
    ell = ell.astype(np.float32)
    return ell if lower else ell.T.copy()


@pytest.mark.parametrize("m,n,lower", [(64, 48, True), (100, 32, True),
                                       (64, 48, False), (33, 17, False),
                                       (16, 8, True)])
@pytest.mark.parametrize("unit_diag", [False, True])
def test_trsm_matches_pallas(m, n, lower, unit_diag):
    rng = np.random.default_rng(m * 31 + n)
    a = _triangular(rng, m, lower, unit_diag)
    b = _arr(rng, m, n)
    kw = dict(lower=lower, unit_diag=unit_diag, tile=(32, 32, 32))
    got = ops.trsm(torch.from_numpy(a), torch.from_numpy(b), **kw)
    want = jops.trsm(jnp.asarray(a), jnp.asarray(b), backend="pallas",
                     interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=TRSM_TOL,
                               rtol=TRSM_TOL)
    oracle = ref.trsm_ref(torch.from_numpy(a), torch.from_numpy(b),
                          lower=lower, unit_diag=unit_diag)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=TRSM_TOL,
                               rtol=TRSM_TOL)


# ---------------------------------------------------------------------------
# the slice as a whole: one artifact, two tuners, one call sequence
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemm_only_artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("gemm_only_artifact")
    cfg = JaxInstallConfig(n_samples=48, repeats=2, tile_ids=(0, 3),
                           models=("linear_regression",),
                           routines=("gemm",), grid_budget="small",
                           cv_splits=3, seed=0)
    jax_install(JaxSimulatedBackend(seed=0), cfg, artifact_dir=str(d))
    return str(d)


def _event(e):
    cfg = None if e.config is None else dataclasses.astuple(e.config)
    return (e.routine, e.m, e.k, e.n, cfg, e.count, e.cache_hit, e.site)


def _calls(rng):
    """A mixed sequence: (name, numpy args, kwargs, tolerance)."""
    a, b = _arr(rng, 96, 40), _arr(rng, 40, 72)
    s, s2 = _arr(rng, 48, 24), _arr(rng, 48, 24)
    lo = _triangular(rng, 300, True, False)
    up = _triangular(rng, 150, False, True)
    rhs, rhs2 = _arr(rng, 300, 12), _arr(rng, 150, 20)
    return [
        ("matmul", (a, b), dict(site="g"), TOL["float32"]),
        ("syrk", (s,), dict(site="s"), RANDOM_TOL),
        ("trsm", (lo, rhs), dict(site="t"), TRSM_TOL),
        ("matmul", (a, b), dict(site="g", count=4), TOL["float32"]),
        ("syrk", (s, s2), dict(lower=False, site="s"), RANDOM_TOL),
        ("trsm", (up, rhs2), dict(lower=False, unit_diag=True, site="t"),
         TRSM_TOL),
        ("trsm", (lo, rhs), dict(site="t"), TRSM_TOL),
        ("matmul", (a, b), dict(tile=(64, 64, 64), site="x"),
         TOL["float32"]),
    ]


@pytest.mark.parametrize("which", ["mixed", "gemm_only"])
def test_one_artifact_serves_both_tuners_alike(tiny_artifact,
                                               gemm_only_artifact, which):
    art = tiny_artifact.dir if which == "mixed" else gemm_only_artifact
    jt = JaxTuner.from_artifact(art)
    tt = AdsalaTuner.from_artifact(art)
    calls = _calls(np.random.default_rng(21))
    with JaxRecorder() as jrec, DispatchRecorder() as trec:
        for name, args, kw, tol in calls:
            want = getattr(jops, name)(*map(jnp.asarray, args), tuner=jt,
                                       backend="pallas", interpret=True,
                                       **kw)
            got = getattr(ops, name)(*map(torch.from_numpy, args), tuner=tt,
                                     backend="torch", **kw)
            np.testing.assert_allclose(got.numpy(), _f32(want), atol=tol,
                                       rtol=tol, err_msg=name)
    events = list(map(_event, trec.events))
    assert events == list(map(_event, jrec.events))
    assert len(events) == len(calls)
    routines = [e[0] for e in events]
    if which == "mixed":
        assert routines[:7] == ["gemm", "syrk", "trsm", "gemm", "syrk",
                                "trsm", "trsm"]
        assert events[6][6]                       # the repeat hits
    else:                                         # no syrk/trsm signal
        assert set(routines) == {"gemm"}
    assert events[-1][4] is None                  # explicit tile
    for name, m, k, n in (("gemm", 96, 40, 72), ("syrk", 48, 24, 48),
                          ("trsm", 300, 300, 12)):
        rt = ops.supported_routine(name, tt)
        assert rt == jops.supported_routine(name, jt)
        assert dataclasses.astuple(tt.select(m, k, n, rt)) == \
            dataclasses.astuple(jt.select(m, k, n, rt))


# ---------------------------------------------------------------------------
# what must raise
# ---------------------------------------------------------------------------

def test_bad_shapes_raise_as_in_the_reference():
    t = torch.zeros
    with pytest.raises(ValueError, match="SYRK"):
        ops.syrk(t(2, 4, 4))
    with pytest.raises(ValueError, match="SYRK"):
        ops.syrk(t(4, 4), t(4, 5))
    with pytest.raises(ValueError, match="TRSM"):
        ops.trsm(t(4, 5), t(4, 3))
    with pytest.raises(ValueError, match="TRSM"):
        ops.trsm(t(4, 4), t(5, 3))
    with pytest.raises(ValueError, match="bad GEMM shapes"):
        ops.matmul(t(4, 8), t(9, 4))
    with pytest.raises(ValueError, match="bad GEMM shapes"):
        M.matmul_torch(t(4, 8), t(9, 4))
    with pytest.raises(ValueError, match="bad GEMM tile"):
        M.matmul_torch(t(4, 8), t(8, 4), bk=0)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.matmul(t(4, 4), t(4, 4), backend="pallas")


def test_cuda_backend_on_cpu_tensors_raises(monkeypatch):
    a = torch.ones(8, 8)
    for call in (lambda: ops.matmul(a, a, backend="cuda"),
                 lambda: ops.syrk(a, backend="cuda"),
                 lambda: ops.trsm(a, a, backend="cuda")):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="not a CUDA device"):
        M.matmul_cuda(a, a)
    monkeypatch.setenv("ADSALA_BACKEND", "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.matmul(a, a)


def test_launch_shapes_of_the_default_tiles_are_all_different():
    shapes = [M.launch_shape(*t) for t in DEFAULT_TILES]
    assert len(set(shapes)) == len(DEFAULT_TILES) == 8
    # (cta_m, cta_n, k_step, stages, group_m, group_n)
    assert shapes[0] == (128, 128, 8, 4, 1, 1)
    assert shapes[3] == (128, 128, 16, 4, 2, 2)
    assert shapes[5] == (128, 128, 32, 3, 4, 4)
    for cta_m, cta_n, k_step, stages, _, _ in \
            shapes + [M.launch_shape(16, 64, 32)]:
        # the ring of fp32 K steps, padded rows, within 227 KB, and
        # within half of it so that two CTAs fit an SM
        ring = stages * 4 * k_step * (cta_m + 4 + cta_n + 4)
        assert stages in (3, 4) and ring <= 232448 // 2
        assert ring <= 227 * 1024
    assert M.launch_shape(16, 64, 32) == (64, 64, 8, 4, 1, 1)


# ---------------------------------------------------------------------------
# the grouped kernel's launch planner (grouped_matmul.grouped_launch)
# ---------------------------------------------------------------------------

#: mixtral-8x22b's expert products (E, C, d, f) in decode (4 tokens top-2
#: over 8 experts: 8-row buckets) and prefill (4 x 1024 tokens: 1280)
_MIXTRAL_DECODE = {"wi": (8, 8, 6144, 16384), "wo": (8, 8, 16384, 6144)}
_MIXTRAL_PREFILL = {"wi": (8, 1280, 6144, 16384),
                    "wo": (8, 1280, 16384, 6144)}


@pytest.mark.parametrize("tile", DEFAULT_TILES)
@pytest.mark.parametrize("site", sorted(_MIXTRAL_DECODE))
def test_grouped_plan_streams_mixtral_decode_buckets(tile, site):
    e, c, d, f = _MIXTRAL_DECODE[site]
    plan = G.grouped_launch(e, c, d, f, *tile)
    assert plan.variant == "thin" and plan.cta_m == 8
    assert (plan.cta_n, plan.k_step) == (G.THIN_BN, G.THIN_BK)
    # one wave of 132 SMs at least, without split-K
    assert plan.ctas(e, c, f) >= G.SMS
    assert plan.splits == 1 and plan.workspace == 0


@pytest.mark.parametrize("tile", DEFAULT_TILES)
@pytest.mark.parametrize("site", sorted(_MIXTRAL_PREFILL))
def test_grouped_plan_tiles_mixtral_prefill_buckets(tile, site):
    e, c, d, f = _MIXTRAL_PREFILL[site]
    plan = G.grouped_launch(e, c, d, f, *tile)
    cta_m, cta_n, k_step, stages, group_m, group_n = M.launch_shape(*tile)
    assert plan.variant == "tiled" and plan.splits == 1
    assert plan == (  # 1280 rows fill 10 CTA rows of 128
        "tiled", cta_m, cta_n, k_step, stages, group_m, group_n, 1, d, 0)


@pytest.mark.parametrize("c,rows", [(1, 8), (8, 8), (9, 16), (16, 16)])
def test_grouped_plan_thin_rows_cover_the_bucket(c, rows):
    plan = G.grouped_launch(8, c, 6144, 16384, 256, 256, 256)
    assert plan.variant == "thin" and plan.cta_m == rows >= c


@pytest.mark.parametrize("e,c,d,f", [
    (2, 8, 4096, 300), (5, 1, 1000, 3), (1, 16, 257, 1), (3, 3, 130, 700),
    (8, 8, 16384, 6144), (1, 4, 16, 256), (4, 12, 100000, 20),
])
def test_grouped_plan_splits_cover_k_exactly_once(e, c, d, f):
    plan = G.grouped_launch(e, c, d, f, 256, 256, 256)
    assert plan.k_split % plan.k_step == 0
    bounds = [(s * plan.k_split, min(d, (s + 1) * plan.k_split))
              for s in range(plan.splits)]
    # contiguous, in order, none empty, the last ends at d
    assert bounds[0][0] == 0 and bounds[-1][1] == d
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert 1 <= plan.splits <= G.MAX_SPLITS
    if plan.splits > 1:
        assert plan.k_split >= G.MIN_SPLIT_STEPS * plan.k_step
        # split only where the N tiles alone would not fill the card
        assert e * -(-f // plan.cta_n) < G.SMS
    assert plan.workspace == (plan.splits * e * c * f
                              if plan.splits > 1 else 0)


def test_grouped_plan_splits_k_where_the_card_would_idle():
    plan = G.grouped_launch(2, 8, 4096, 300, 256, 256, 256)
    assert plan.variant == "thin" and plan.splits > 1
    assert plan.workspace == plan.splits * 2 * 8 * 300
    assert plan.ctas(2, 8, 300) > 2 * 2


@pytest.mark.parametrize("tile", DEFAULT_TILES)
def test_grouped_plan_fits_cta_rows_to_deepseek_buckets(tile):
    # deepseek-v2: 160 experts of d_ff 1536, 192-row buckets
    e, c, d, f = 160, 192, 5120, 1536
    plan = G.grouped_launch(e, c, d, f, *tile)
    assert plan.variant == "tiled"
    assert c % plan.cta_m == 0            # no dead CTA row block
    assert plan.cta_m == 96 and plan.cta_m <= M.launch_shape(*tile)[0]
    assert plan.stages == M.ring_stages(96, plan.cta_n, plan.k_step)


@pytest.mark.parametrize("c,rows", [(17, 64), (64, 64), (100, 128),
                                    (128, 128), (192, 96), (200, 128),
                                    (288, 96), (320, 64), (1280, 128)])
def test_grouped_plan_rows_leave_the_fewest_dead_rows(c, rows):
    plan = G.grouped_launch(4, c, 512, 512, 256, 256, 256)
    assert plan.cta_m == rows
    best = min(-(-c // r) * r for r in G.GROUPED_CTA_ROWS)
    assert -(-c // rows) * rows == best


def test_grouped_plan_keeps_a_small_tiles_cta_rows():
    # the tuner's bm below 128 keeps 64-row CTAs whatever the bucket
    plan = G.grouped_launch(4, 192, 512, 512, 64, 64, 64)
    assert (plan.variant, plan.cta_m, plan.cta_n) == ("tiled", 64, 64)
    with pytest.raises(ValueError, match="bad grouped extents"):
        G.grouped_launch(0, 8, 8, 8, 64, 64, 64)


# ---------------------------------------------------------------------------
# the measured CUDA timing backend
# ---------------------------------------------------------------------------

def test_measured_cuda_backend_round_trips_and_needs_a_card():
    be = MeasuredCUDABackend(max_dim=4096, seed=3, repeats=3, warmup=2)
    d = describe_backend(be)
    assert d == {"kind": "measured-cuda", "max_dim": 4096, "seed": 3,
                 "repeats": 3, "warmup": 2}
    back = backend_from_dict(d)
    assert isinstance(back, MeasuredCUDABackend)
    assert describe_backend(back) == d
    with pytest.raises(ValueError, match="repeats"):
        MeasuredCUDABackend(repeats=0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA device"):
        be.time_routine(64, 64, 64, GemmConfig(1, "M", 3))
