"""The Hopper grouped GEMM kernel against its plain version, on the card,
and the MoE layer through it.  Marked ``cuda``: without a CUDA device
every test here skips (the kernel has no CPU mode).  Imports no jax, so
it runs on a GPU host that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_grouped_cuda.py

The plain version is itself held to the JAX reference on the CPU by
tests/test_torch_moe.py.  Tolerances are the reference's
(tests/test_kernels.py): 5e-5 in fp32 (TF32 off) and 1e-1 in bf16.
"""

import pytest
import torch

from repro_torch.core import DEFAULT_TILES
from repro_torch.kernels import grouped_matmul as G
from repro_torch.kernels import matmul as M
from repro_torch.kernels import ops
from repro_torch.models import moe as MOE
from repro_torch.models.params import init_params

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


def _check(x, w, tile, dtype=torch.float32):
    bm, bk, bn = tile
    got = G.grouped_matmul_cuda(x, w, bm=bm, bk=bk, bn=bn)
    want = G.grouped_matmul_torch(x, w, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("tile", DEFAULT_TILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_every_default_tile(gpu, tile, dtype):
    _check(_rand(4, 300, 257, dtype=dtype),
           _rand(4, 257, 130, dtype=dtype, seed=1), tile, dtype)


@pytest.mark.parametrize("e,c,d,f,tile", [
    (4, 64, 32, 48, (32, 32, 32)), (2, 100, 64, 64, (32, 32, 32)),
    (8, 16, 16, 96, (32, 32, 32)), (3, 33, 257, 65, (16, 128, 16)),
    (8, 8, 300, 130, (256, 256, 256)), (5, 1, 1000, 3, (128, 128, 128)),
    (2, 2049, 7, 1, (512, 512, 512)), (160, 12, 40, 24, (64, 64, 64)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_on_ragged_shapes(gpu, e, c, d, f, tile, dtype):
    _check(_rand(e, c, d, dtype=dtype), _rand(e, d, f, dtype=dtype, seed=1),
           tile, dtype)


def test_kernel_reads_strided_operands_without_a_copy(gpu):
    x = _rand(4, 96, 200)
    wt = _rand(4, 130, 200, seed=1)               # (E, f, d) storage
    pairs = [
        (x, wt.transpose(1, 2)),                  # expert-transposed W
        (x[:, ::2], _rand(4, 200, 64, seed=2)),   # every 2nd bucket row
        (_rand(4, 200, 96, seed=3).transpose(1, 2), wt.transpose(1, 2)),
        (x[::2], _rand(2, 200, 64, seed=4)),      # every 2nd expert
        (x, _rand(1, 200, 64, seed=5).expand(4, 200, 64)),  # stride 0
    ]
    for xs, ws in pairs:
        _check(xs, ws, (128, 128, 128))
    out = G.grouped_matmul_cuda(x, wt.transpose(1, 2),
                                out_dtype=torch.bfloat16)
    assert out.shape == (4, 96, 130) and out.dtype == torch.bfloat16


def test_launch_counter_and_wrapper_checks(gpu):
    x, w = _rand(3, 16, 32), _rand(3, 32, 24, seed=1)
    before = G.grouped_matmul_cuda.launches
    gemm_before = M.matmul_cuda.launches
    ops.grouped_matmul(x, w)                                  # auto -> cuda
    ops.grouped_matmul(x, w, backend="torch")
    torch.cuda.synchronize()
    assert G.grouped_matmul_cuda.launches == before + 1
    assert M.matmul_cuda.launches == gemm_before
    with pytest.raises(ValueError, match="mixed dtypes"):
        G.grouped_matmul_cuda(x, w.bfloat16())
    with pytest.raises(ValueError, match="not supported"):
        G.grouped_matmul_cuda(x.half(), w.half())
    with pytest.raises(ValueError, match="not a CUDA device"):
        G.grouped_matmul_cuda(x.cpu(), w)
    with pytest.raises(ValueError, match="bad grouped shapes"):
        G.grouped_matmul_cuda(x, w[:2])


def test_moe_layer_through_the_kernel(gpu, monkeypatch):
    spec = MOE.MoESpec(d_model=256, n_experts=8, top_k=2, d_ff=512)
    p = init_params(MOE.moe_defs(spec),
                    torch.Generator(device="cuda").manual_seed(0))
    x = _rand(4, 64, 256, seed=6)
    before = G.grouped_matmul_cuda.launches
    out, aux = MOE.apply_moe(p, x, spec)
    assert G.grouped_matmul_cuda.launches == before + 3
    monkeypatch.setenv("ADSALA_BACKEND", "torch")
    want, want_aux = MOE.apply_moe(p, x, spec)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux, want_aux)
