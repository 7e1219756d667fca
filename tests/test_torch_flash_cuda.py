"""The Hopper flash-attention kernel against its plain version, on the
card.  Marked ``cuda``: without a CUDA device every test here skips
(the kernel has no CPU mode).  Imports no jax, so it runs on a GPU host
that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_cuda.py

The plain version is itself held to the JAX reference on the CPU by
tests/test_torch_flash.py.  Tolerances are the reference's: 2e-5 in
fp32 (TF32 off), 5e-2 in bf16; the dense and tri walks must be bitwise
equal, and so must two launches, at every head dim the kernel takes
(16 to 256); a head dim between those runs zero-padded, and float16 in
float32 (at bf16's bound).  The C entry takes the planner's
(CTA rows, sub-tile columns, stages) and refuses any plan it does not
compile.
"""

import ctypes


import pytest
import torch

from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU "
                    "mode (its plain version is tested on the CPU)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _qkv(bh, sq, skv, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((bh, sq, d), (bh, skv, d), (bh, skv, d)))


@pytest.mark.parametrize("bh,sq,skv,d,dtype,causal,window,bq,bkv", [
    (2, 96, 96, 16, torch.float32, True, None, 32, 32),
    (2, 100, 64, 16, torch.float32, True, None, 32, 32),
    (2, 64, 100, 16, torch.float32, True, None, 32, 32),
    (2, 96, 96, 16, torch.float32, True, 40, 32, 32),
    (2, 80, 80, 16, torch.float32, False, None, 32, 32),
    (2, 96, 96, 16, torch.float32, False, 24, 32, 32),
    (2, 64, 50, 16, torch.float32, False, None, 32, 32),
    (3, 200, 200, 32, torch.float32, True, None, 128, 64),
    (2, 300, 300, 128, torch.float32, True, None, 256, 512),
    (4, 777, 777, 64, torch.float32, True, 100, 256, 128),
    (16, 1024, 1024, 64, torch.float32, True, None, 512, 512),
    (2, 64, 64, 16, torch.bfloat16, True, None, 32, 32),
    (2, 200, 150, 128, torch.bfloat16, False, None, 64, 64),
    # rows with no visible key (the reference's average, or 0)
    (1, 96, 40, 16, torch.float32, False, 8, 32, 16),
    (2, 130, 37, 32, torch.float32, True, 5, 64, 16),
    (2, 300, 40, 32, torch.float32, False, 16, 128, 64),
    # the redesigned body's edges: rows not a multiple of the CTA's,
    # fewer CTA rows (bq 32, 64; Sq 12), windows starting mid-ring, every
    # head dim in bf16, sub-tiles rejected above the diagonal mid-tile
    (2, 300, 300, 64, torch.float32, True, None, 256, 128),
    (3, 200, 200, 64, torch.float32, True, None, 1024, 512),
    (2, 256, 256, 64, torch.float32, True, None, 32, 64),
    (2, 256, 256, 128, torch.float32, True, None, 64, 128),
    (2, 12, 12, 64, torch.float32, True, None, 512, 512),
    (2, 1024, 1024, 64, torch.float32, True, 300, 512, 512),
    (2, 1024, 1024, 128, torch.float32, True, 200, 256, 512),
    (4, 600, 600, 16, torch.float32, True, None, 128, 512),
    (2, 700, 700, 32, torch.float32, True, 333, 256, 256),
    (2, 300, 300, 16, torch.bfloat16, True, 50, 32, 512),
    (4, 600, 600, 32, torch.bfloat16, True, None, 128, 512),
    (8, 1024, 1024, 64, torch.bfloat16, True, None, 128, 512),
    (2, 1024, 1024, 128, torch.bfloat16, True, 700, 512, 512),
    # head dim 256 (recurrentgemma's local attention): its window, ragged
    # rows, 16-row CTAs (fewer threads than a row has 16-byte chunks),
    # unmasked and fully masked rows, in both dtypes
    (10, 1024, 1024, 256, torch.float32, True, 2048, 512, 512),
    (4, 700, 700, 256, torch.float32, True, 256, 256, 128),
    (2, 12, 12, 256, torch.float32, True, None, 512, 512),
    (3, 200, 150, 256, torch.float32, False, None, 64, 64),
    (1, 96, 40, 256, torch.float32, False, 8, 32, 16),
    (4, 700, 700, 256, torch.bfloat16, True, 256, 256, 128),
    (2, 12, 12, 256, torch.bfloat16, True, None, 512, 512),
    (3, 200, 150, 256, torch.bfloat16, False, None, 64, 64),
])
def test_kernel_matches_plain_and_walks_are_bitwise_equal(
        gpu, bh, sq, skv, d, dtype, causal, window, bq, bkv):
    q, k, v = _qkv(bh, sq, skv, d, dtype)
    kw = dict(bq=bq, bkv=bkv, causal=causal, window=window)
    want = F.flash_attention_torch(q, k, v, **kw).float()
    dense = F.flash_attention_cuda(q, k, v, grid="dense", **kw)
    tri = F.flash_attention_cuda(q, k, v, grid="tri", **kw)
    again = F.flash_attention_cuda(q, k, v, grid="tri", **kw)
    torch.cuda.synchronize()
    assert torch.equal(dense, tri)
    assert torch.equal(tri, again)              # run to run
    assert dense.dtype == dtype
    torch.testing.assert_close(tri.float(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_launch_counter_and_dispatch(gpu):
    q, k, v = _qkv(4, 64, 64, 64, torch.float32)
    before = F.flash_attention_cuda.launches
    out = ops.flash_attention(q, k, v, causal=True)       # auto -> cuda
    plain = ops.flash_attention(q, k, v, causal=True, backend="torch")
    torch.cuda.synchronize()
    assert F.flash_attention_cuda.launches == before + 1
    torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(gpu):
    q, k, v = _qkv(2, 32, 32, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim 320 above 256"):
        wide = _qkv(2, 32, 32, 320, torch.float32)
        F.flash_attention_cuda(*wide)
    with pytest.raises(ValueError, match="dtype"):
        F.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="mixed dtypes"):
        F.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="not contiguous"):
        F.flash_attention_cuda(q.transpose(1, 2).contiguous()
                               .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="not a CUDA device"):
        F.flash_attention_cuda(q.cpu(), k, v)
    off = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        F.flash_attention_cuda(off, k, v)


@pytest.mark.parametrize("d", [24, 48, 80, 96, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None)])
def test_padded_head_dims_and_fp16_match_plain(gpu, d, dtype, causal,
                                               window):
    """A head dim between the kernel's runs zero-padded to the next one
    and sliced back; float16 runs in float32 and is cast back.  One
    launch a call, counted under the caller's head dim, the caller's
    dtype and shape, the plain version's values within the flash bounds
    (fp16 at bf16's)."""
    q, k, v = _qkv(3, 300, 300, d, dtype, seed=d)
    kw = dict(bq=128, bkv=128, causal=causal, window=window)
    want = F.flash_attention_torch(q, k, v, **kw).float()
    before = F.flash_attention_cuda.launches
    by_d = F.flash_attention_cuda.launches_by_head_dim.get(d, 0)
    dense = F.flash_attention_cuda(q, k, v, grid="dense", **kw)
    tri = F.flash_attention_cuda(q, k, v, grid="tri", **kw)
    torch.cuda.synchronize()
    assert F.flash_attention_cuda.launches == before + 2
    assert F.flash_attention_cuda.launches_by_head_dim[d] == by_d + 2
    assert dense.dtype == dtype and dense.shape == q.shape
    assert torch.equal(dense, tri)
    tol = TOL.get(dtype, TOL[torch.bfloat16])
    torch.testing.assert_close(tri.float(), want, atol=tol, rtol=tol)


def test_c_entry_refuses_a_plan_it_does_not_compile(gpu):
    """The plan is made in Python (flash_launch) and compiled in C: the C
    entry runs the planner's plan and refuses other sub-tiles, ring
    depths and CTA rows."""
    from repro_torch.kernels import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float32, torch.bfloat16):
        for d in F.SUPPORTED_HEAD_DIMS:
            q, k, v = _qkv(2, 64, 64, d, dtype)
            out = torch.empty_like(q)
            plan = F.flash_launch(64, 64, d, 64, 64, dtype=dtype)

            def launch(rows, cols, stages, o=out):
                return lib.flash_attention_forward(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    2, 64, 64, d, 64, 64, 1, 0, ctypes.c_float(d ** -0.5),
                    F._DTYPE_CODES[dtype], None, None, rows, cols, stages,
                    stream)

            assert launch(plan.cta_rows, plan.sub_cols, plan.stages) == 0
            torch.cuda.synchronize()
            torch.testing.assert_close(
                out.float(), F.flash_attention_torch(q, k, v, bq=64,
                                                     bkv=64).float(),
                atol=TOL[dtype], rtol=TOL[dtype])
            most = F.FLASH_PLANS[dtype, d][2]
            for bad in ((plan.cta_rows, plan.sub_cols // 2, plan.stages),
                        (plan.cta_rows, plan.sub_cols, plan.stages + 1),
                        (plan.cta_rows, plan.sub_cols, plan.stages - 1),
                        (48, plan.sub_cols, plan.stages),
                        (2 * most, plan.sub_cols, plan.stages)):
                assert launch(*bad) != 0, (dtype, d, bad)
            # a pointer off the 16-byte grid the copies need
            assert launch(plan.cta_rows, plan.sub_cols, plan.stages,
                          o=out.view(-1)[1:]) != 0
