"""The Hopper GEMM kernel against its plain version, on the card, and a
short measured install.  Marked ``cuda``: without a CUDA device every
test here skips (the kernel has no CPU mode).  Imports no jax, so it runs
on a GPU host that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gemm_cuda.py

The plain version is itself held to the JAX reference on the CPU by
tests/test_torch_gemm.py.  Tolerances are the reference's
(tests/test_kernels.py): matmul 5e-5 in fp32 (TF32 off) and 1e-1 in
bf16, syrk 1e-4, trsm 1e-3.
"""

import pytest
import torch

from repro_torch.core import (
    DEFAULT_TILES,
    AdsalaTuner,
    ConfigSpace,
    GemmConfig,
    InstallConfig,
    MeasuredCUDABackend,
    install,
)
from repro_torch.kernels import matmul as M
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-1}


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU "
                    "mode (its plain version is tested on the CPU)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _rand(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


@pytest.mark.parametrize("tile", DEFAULT_TILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(300, 257, 130), (1024, 512, 768)])
def test_kernel_matches_plain_on_every_default_tile(gpu, tile, dtype, m, k,
                                                    n):
    a, b = _rand(m, k, dtype=dtype), _rand(k, n, dtype=dtype, seed=1)
    bm, bk, bn = tile
    got = M.matmul_cuda(a, b, bm=bm, bk=bk, bn=bn)
    want = M.matmul_torch(a, b, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_bits_do_not_depend_on_the_tile_or_the_run(gpu):
    # every thread sums over k in order (no split-K): each launch shape
    # gives the same bits, and a second launch repeats them
    a, b = _rand(700, 1500), _rand(1500, 900, seed=1)
    first = M.matmul_cuda(a, b, bm=128, bk=128, bn=128)
    torch.cuda.synchronize()
    for bm, bk, bn in list(DEFAULT_TILES) + [(64, 64, 64), (64, 512, 128),
                                             (128, 256, 64)]:
        got = M.matmul_cuda(a, b, bm=bm, bk=bk, bn=bn)
        torch.cuda.synchronize()
        assert torch.equal(got, first), (bm, bk, bn)
    # the same on a transposed B (the copies transpose, not the sums)
    bt = b.T.contiguous().T
    assert torch.equal(M.matmul_cuda(a, bt, bm=256, bk=256, bn=256), first)


@pytest.mark.parametrize("m,k,n,tile", [
    (64, 64, 64, (64, 64, 64)), (100, 130, 70, (32, 64, 32)),
    (8, 8, 8, (32, 32, 32)), (33, 257, 65, (16, 128, 16)),
    (1, 1000, 3, (128, 128, 128)), (2049, 7, 1, (256, 512, 256)),
])
def test_kernel_on_ragged_shapes(gpu, m, k, n, tile):
    a, b = _rand(m, k), _rand(k, n, seed=1)
    got = M.matmul_cuda(a, b, bm=tile[0], bk=tile[1], bn=tile[2])
    torch.testing.assert_close(got, M.matmul_torch(a, b, bk=tile[1]),
                               atol=5e-5, rtol=5e-5)


def test_kernel_reads_strided_operands_without_a_copy(gpu):
    a, base = _rand(200, 96), _rand(300, 96, seed=1)
    pairs = [
        (a, base.T),                                # B^T view (syrk's)
        (a, base[::2].T),                           # B^T of every 2nd row
        (a[:, ::3], _rand(64, 50, seed=2)[::2]),    # strided columns/rows
        (_rand(96, 200, seed=3).T, base.T),         # A^T view
    ]
    for at, bt in pairs:
        got = M.matmul_cuda(at, bt, bm=128, bk=128, bn=128)
        want = M.matmul_torch(at, bt)
        torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)
    out = M.matmul_cuda(a, base.T, out_dtype=torch.bfloat16)
    assert out.shape == (200, 300) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("lower", [True, False])
def test_syrk_and_trsm_through_the_kernel(gpu, lower):
    a = _rand(300, 200)
    got = ops.syrk(a, lower=lower, tile=(128, 128, 128))
    want = ops.syrk(a, lower=lower, tile=(128, 128, 128), backend="torch")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    m = 700
    ell = torch.tril(_rand(m, m, seed=2))
    ell.diagonal().copy_(ell.diagonal().abs() + m)
    if not lower:
        ell = ell.T.contiguous()
    b = _rand(m, 40, seed=3)
    for unit in (False, True):
        if unit:
            ell = ell / m
            ell.diagonal().fill_(1.0)
        before = M.matmul_cuda.launches
        x = ops.trsm(ell, b, lower=lower, unit_diag=unit,
                     tile=(256, 128, 256))
        assert M.matmul_cuda.launches == before + 2     # panels 2 and 3
        want = ops.trsm(ell, b, lower=lower, unit_diag=unit,
                        tile=(256, 128, 256), backend="torch")
        torch.testing.assert_close(x, want, atol=1e-3, rtol=1e-3)


def test_launch_counter_and_wrapper_checks(gpu):
    a = _rand(64, 64)
    before = M.matmul_cuda.launches
    ops.matmul(a, a)                                     # auto -> cuda
    ops.matmul(a, a, backend="torch")
    torch.cuda.synchronize()
    assert M.matmul_cuda.launches == before + 1
    with pytest.raises(ValueError, match="mixed dtypes"):
        M.matmul_cuda(a, a.bfloat16())
    with pytest.raises(ValueError, match="not supported"):
        M.matmul_cuda(a.half(), a.half())
    with pytest.raises(ValueError, match="not a CUDA device"):
        M.matmul_cuda(a.cpu(), a)
    with pytest.raises(ValueError, match="bad GEMM shapes"):
        M.matmul_cuda(a, a[:3])


def test_c_entry_refuses_a_ring_depth_it_does_not_compile(gpu):
    """The ring's depth is planned in Python (launch_shape) and compiled
    in C: the C entry takes the planner's value and refuses any other."""
    from repro_torch.kernels import _build

    a, b = _rand(64, 64), _rand(64, 64, seed=1)
    c = torch.empty(64, 64, device="cuda")
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for tile in DEFAULT_TILES:
        cta_m, cta_n, k_step, stages, gm, gn = M.launch_shape(*tile)
        codes = [lib.matmul_forward(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), 64, 64, 64, 64, 1, 64,
            1, cta_m, cta_n, k_step, st, gm, gn, 0, 0, stream)
            for st in (stages, stages - 1, stages + 1)]
        assert codes[0] == 0 and codes[1] != 0 and codes[2] != 0, tile
    torch.cuda.synchronize()
    torch.testing.assert_close(c, M.matmul_torch(a, b), atol=TOL[
        torch.float32], rtol=TOL[torch.float32])


def test_short_measured_install_serves_a_tuner(gpu, tmp_path):
    tiles = (0, 3)
    cfg = InstallConfig(
        n_samples=16, repeats=1, mem_limit_mb=16, dtype_bytes=4,
        routines=("gemm", "syrk", "trsm"), max_chips=1, tile_ids=tiles,
        space=ConfigSpace.default(1, tiles=tiles, partitions=("M",)),
        default_config=GemmConfig(1, "M", 3), dim_max=2048,
        models=("linear_regression",), cv_splits=2, seed=0)
    backend = MeasuredCUDABackend(repeats=2, warmup=1)
    rep = install(backend, cfg, artifact_dir=str(tmp_path))
    assert rep.selected
    tuner = AdsalaTuner.from_artifact(str(tmp_path))
    a = _rand(256, 128)
    before = M.matmul_cuda.launches
    out = ops.matmul(a, a.T.contiguous(), tuner=tuner)
    assert M.matmul_cuda.launches == before + 1
    assert tuner.select(256, 128, 256, "gemm").tile_id in tiles
    torch.testing.assert_close(out, a @ a.T, atol=1e-4, rtol=1e-4)
