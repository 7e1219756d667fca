"""The Hopper flash-attention kernel against its plain version, on the
card.  Marked ``cuda``: without a CUDA device every test here skips
(the kernel has no CPU mode).  Imports no jax, so it runs on a GPU host
that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_cuda.py

The plain version is itself held to the JAX reference on the CPU by
tests/test_torch_flash.py.  Tolerances are the reference's: 2e-5 in
fp32 (TF32 off), 5e-2 in bf16; the dense and tri walks must be bitwise
equal.
"""

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
])
def test_kernel_matches_plain_and_walks_are_bitwise_equal(
        gpu, bh, sq, skv, d, dtype, causal, window, bq, bkv):
    q, k, v = _qkv(bh, sq, skv, d, dtype)
    kw = dict(bq=bq, bkv=bkv, causal=causal, window=window)
    want = F.flash_attention_torch(q, k, v, **kw).float()
    dense = F.flash_attention_cuda(q, k, v, grid="dense", **kw)
    tri = F.flash_attention_cuda(q, k, v, grid="tri", **kw)
    torch.cuda.synchronize()
    assert torch.equal(dense, tri)
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
    with pytest.raises(ValueError, match="head dim"):
        F.flash_attention_cuda(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               v[..., :48].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        F.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="mixed dtypes"):
        F.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="not contiguous"):
        F.flash_attention_cuda(q.transpose(1, 2).contiguous()
                               .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="not a CUDA device"):
        F.flash_attention_cuda(q.cpu(), k, v)
