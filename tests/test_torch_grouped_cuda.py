"""The Hopper grouped GEMM kernel against its plain version, on the card,
and the MoE layer through it.  Marked ``cuda``: without a CUDA device
every test here skips (the kernel has no CPU mode).  Imports no jax, so
it runs on a GPU host that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_grouped_cuda.py

Thin buckets (at most 16 rows: the weight-streaming body) and split-K
launches are held to the plain version as the tiled body is, and two
launches on the same inputs must give the same bits.  The plain version
is itself held to the JAX reference on the CPU by
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


#: thin buckets (C <= 16) and shapes whose planner splits K
THIN_CASES = [
    # e, c, d, f
    (8, 1, 300, 130), (8, 3, 300, 130), (8, 8, 300, 130),
    (8, 16, 300, 130), (8, 17, 300, 130),       # 17: the tiled body
    (4, 8, 257, 513), (3, 5, 1000, 3),          # ragged d and f
    (2, 8, 4096, 300), (1, 16, 2000, 256),      # split-K
]


@pytest.mark.parametrize("e,c,d,f", THIN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_on_thin_buckets_and_split_k(gpu, e, c, d, f, dtype):
    plan = G.grouped_launch(e, c, d, f, 256, 256, 256)
    assert plan.variant == ("thin" if c <= G.THIN_ROWS else "tiled")
    _check(_rand(e, c, d, dtype=dtype), _rand(e, d, f, dtype=dtype, seed=1),
           (256, 256, 256), dtype)


def test_thin_kernel_reads_strided_operands_without_a_copy(gpu):
    x = _rand(4, 16, 600)
    wt = _rand(4, 300, 600, seed=1)               # (E, f, d) storage
    for xs, ws in [(x[:, :8], wt.transpose(1, 2)),   # expert-transposed W
                   (x[:, ::2], _rand(4, 600, 300, seed=2)),  # strided rows
                   (x[:, ::2], wt.transpose(1, 2))]:
        assert G.grouped_launch(4, xs.shape[1], 600, 300, 256, 256,
                                256).variant == "thin"
        _check(xs, ws, (256, 256, 256))
    # split-K with an expert-transposed W
    x, wt = _rand(2, 8, 4096), _rand(2, 200, 4096, seed=3)
    assert G.grouped_launch(2, 8, 4096, 200, 256, 256, 256).splits > 1
    _check(x, wt.transpose(1, 2), (256, 256, 256))


@pytest.mark.parametrize("e,c,d,f", [(8, 8, 6144, 2048), (2, 8, 4096, 300),
                                     (4, 192, 1024, 384)])
def test_two_launches_give_the_same_bits(gpu, e, c, d, f):
    x, w = _rand(e, c, d), _rand(e, d, f, seed=1)
    first = G.grouped_matmul_cuda(x, w, bm=256, bk=256, bn=256)
    second = G.grouped_matmul_cuda(x, w, bm=256, bk=256, bn=256)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_thin_launch_without_split_gives_the_tiled_bits(gpu):
    # both bodies sum over k in order with fmaf: the same bits, whether
    # the 8-row bucket streams (thin) or sits in a 128-row tile (tiled)
    # 8 experts x 17 N tiles of 256 fill the card without split-K
    x, w = _rand(8, 8, 1000), _rand(8, 1000, 4352, seed=1)
    assert G.grouped_launch(8, 8, 1000, 4352, 256, 256, 256).splits == 1
    thin = G.grouped_matmul_cuda(x, w, bm=256, bk=256, bn=256)
    pad = torch.zeros(8, 17, 1000, device="cuda")
    pad[:, :8] = x
    tiled = G.grouped_matmul_cuda(pad, w, bm=256, bk=256, bn=256)[:, :8]
    torch.cuda.synchronize()
    assert torch.equal(thin, tiled)


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


@pytest.mark.parametrize("c", [8, 40])
def test_c_entry_refuses_a_launch_it_does_not_compile(gpu, c):
    """The planner's copies of the kernels' constants (the ring's depth,
    the thin body's K step and columns) are checked by the C entry."""
    from repro_torch.kernels import _build

    x, w = _rand(2, c, 64), _rand(2, 64, 300, seed=1)
    y = torch.empty(2, c, 300, device="cuda")
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    plan = G.grouped_launch(2, c, 64, 300, 128, 128, 128)
    assert plan.variant == ("thin" if c <= G.THIN_ROWS else "tiled")

    def launch(**change):
        p = plan._replace(**change)
        return lib.grouped_matmul_forward(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), 2, c, 64, 300,
            *x.stride(), *w.stride(), p.cta_m, p.cta_n, p.k_step, p.stages,
            p.group_m, p.group_n, p.splits, None, 0, 0, stream)

    assert launch() == 0
    assert launch(stages=plan.stages + 1) != 0
    assert launch(stages=plan.stages - 1) != 0
    if plan.variant == "thin":
        assert launch(k_step=2 * plan.k_step) != 0
        assert launch(cta_n=plan.cta_n // 2) != 0
    torch.cuda.synchronize()
    torch.testing.assert_close(y, G.grouped_matmul_torch(x, w),
                               atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


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
