"""The kernels' torch ops on the card, and the dry run's trace on a
one-rank NCCL mesh.  Marked ``cuda``: without a CUDA device every test
here skips.  Imports no jax, so it runs on a GPU host that has only
torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dryrun_cuda.py

* ``torch.library.opcheck`` on ``repro_torch::matmul``,
  ``::grouped_matmul`` and ``::flash_attention`` (schema, fake
  implementation against the real one, autograd registration, a
  dynamic-shape trace);
* each op against its plain version, at the reference's tolerances
  (TF32 off): 5e-5 for the GEMMs in fp32, 1e-1 in bf16; 2e-5 for flash
  in fp32, 5e-2 in bf16 and fp16;
* the sLSTM op (``repro_torch::slstm_scan`` and its backward, no
  kernel: the step loop on the card) against its CPU result, forward
  and gradients, and against the plain loop on the card: forward
  bitwise, gradients within 1e-6 normwise;
* a smoke deepseek-v2 prefill traced on a (1, 1) NCCL mesh under
  ``FakeTensorMode`` (the expert-parallel MoE behind a one-rank
  ``all_to_all``): the grouped op traced 3 times per MoE layer, nothing
  launched; and a smoke stablelm prefill traced on the card: the flash
  op once per layer.
"""

import dataclasses

import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import grouped_matmul as G
from repro_torch.kernels import matmul as M

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(their fake implementations are tested on the CPU)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.Generator(device="cuda").manual_seed(0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


GEMM_TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-1}
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2,
             torch.float16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_matmul(card, dtype):
    a, b = _rand(card, (96, 40), dtype), _rand(card, (40, 72), dtype)
    torch.library.opcheck(torch.ops.repro_torch.matmul.default,
                          (a, b, 128, 128, 128, dtype))


@pytest.mark.parametrize("c", [3, 100])
def test_opcheck_grouped_matmul(card, c):
    x = _rand(card, (4, c, 64), torch.float32)
    w = _rand(card, (4, 64, 48), torch.float32)
    torch.library.opcheck(torch.ops.repro_torch.grouped_matmul.default,
                          (x, w, 128, 128, 128, torch.float32))


@pytest.mark.parametrize("d,grid,window", [(64, "dense", None),
                                           (80, "tri", 24)])
def test_opcheck_flash_attention(card, d, grid, window):
    q, k, v = (_rand(card, (4, 70, d), torch.float32) for _ in range(3))
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                          (q, k, v, 32, 32, True, window, d ** -0.5, grid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_match_their_plain_versions(card, dtype):
    a, b = _rand(card, (200, 130), dtype), _rand(card, (130, 90), dtype)
    n = M.matmul_cuda.launches
    got = torch.ops.repro_torch.matmul(a, b, 64, 128, 64, dtype)
    want = M.matmul_torch(a, b, bk=128)
    assert M.matmul_cuda.launches == n + 1
    assert (got.float() - want.float()).abs().max().item() \
        <= GEMM_TOL[dtype]
    x, w = _rand(card, (8, 5, 96), dtype), _rand(card, (8, 96, 300), dtype)
    n = G.grouped_matmul_cuda.launches
    got = torch.ops.repro_torch.grouped_matmul(x, w, 128, 128, 128, dtype)
    want = G.grouped_matmul_torch(x, w)
    assert G.grouped_matmul_cuda.launches == n + 1
    assert (got.float() - want.float()).abs().max().item() \
        <= GEMM_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("grid", ["dense", "tri"])
def test_flash_op_matches_plain_version(card, dtype, grid):
    q, k, v = (_rand(card, (6, 150, 96), dtype) for _ in range(3))
    n = FA.flash_attention_cuda.launches
    got = torch.ops.repro_torch.flash_attention(q, k, v, 64, 64, True, 40,
                                                96 ** -0.5, grid)
    want = FA.flash_attention_torch(q, k, v, bq=64, bkv=64, window=40,
                                    grid=grid)
    assert FA.flash_attention_cuda.launches == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() \
        <= FLASH_TOL[dtype]


@pytest.fixture
def nccl_mesh(card):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_dryrun_traces_a_moe_prefill_on_a_one_rank_nccl_mesh(nccl_mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models.config import SHAPES

    cfg = get_smoke_config("deepseek-v2-236b")
    model = build_model(cfg)
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                global_batch=2)
    before = G.grouped_matmul_cuda.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = D.build_cell(model, cfg, shape, nccl_mesh, "cuda",
                                torch.float32)
        seen = D.trace_cell(fn, args, "cuda")
    moe_layers = sum(s.mlp == "moe" for s in model.plan)
    assert seen["kernel_ops"]["repro_torch::grouped_matmul"] == \
        3 * moe_layers
    assert G.grouped_matmul_cuda.launches == before
    assert seen["peak_bytes"] >= seen["argument_bytes"] > 0


def test_dryrun_traces_the_flash_op_on_the_card(card):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models.params import abstract_params, tree_map
    from repro_torch.serve.step import build_prefill
    from repro_torch.models.config import SHAPES

    cfg = get_smoke_config("stablelm-1.6b")
    model = build_model(cfg)
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                global_batch=2)
    fn, _, _ = build_prefill(model, cfg, shape, None)
    before = FA.flash_attention_cuda.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="cuda"),
            abstract_params(model.defs, torch.bfloat16))
        batch = {"tokens": torch.zeros((2, 64), dtype=torch.int32,
                                       device="cuda")}
        seen = D.trace_cell(fn, (params, batch), "cuda")
    assert seen["kernel_ops"] == {"repro_torch::flash_attention":
                                  cfg.n_layers}
    assert FA.flash_attention_cuda.launches == before


#: the sLSTM on the card against the CPU: the reference's block
#: tolerance (tests/test_torch_xlstm.py) on the forward, its gradient
#: tolerance (tests/test_torch_train_families.py) normwise
SLSTM_LAYER_TOL = 1e-5
SLSTM_GRAD_TOL = 1e-4
#: the op's gradients against autograd through the loop (fp32)
SLSTM_LOOP_TOL = 1e-6


def _slstm_run(fn, inputs, dhs):
    """(hs, gradients of x, w_in, w_rec, b) of ``fn(x, w_in, w_rec, b)``
    with ``dhs`` as the gradient of hs."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    hs = fn(*leaves)
    grads = torch.autograd.grad(hs, leaves, dhs)
    return hs.detach(), grads


def _normwise(got, want):
    return ((got.double() - want.double()).norm()
            / want.double().norm()).item()


def test_slstm_op_on_the_card_matches_the_cpu(card):
    from repro_torch.models import xlstm as X

    b, s, d = 4, 96, 128
    gen = torch.Generator().manual_seed(0)
    inputs = [torch.randn((b, s, d), generator=gen),
              torch.randn((d, 4 * d), generator=gen) * d ** -0.5,
              torch.randn((d, 4 * d), generator=gen) * 0.5 * d ** -0.5,
              torch.randn((4 * d,), generator=gen) * 0.5]
    dhs = torch.randn((b, s, d), generator=gen)
    x, w_in, w_rec, bias = (t.cuda() for t in inputs)
    torch.library.opcheck(
        torch.ops.repro_torch.slstm_scan.default,
        (x @ w_in, w_rec, bias, True),
        test_utils=("test_schema", "test_autograd_registration",
                    "test_faketensor"))

    # the op and the loop over the same hoisted input product x @ w_in
    def op(x, w_in, w_rec, bias):
        xw = X._slstm_xw({"w_in": w_in}, x)
        return X.slstm_scan(xw, w_rec, bias)[0]

    def loop(x, w_in, w_rec, bias):
        st = X.init_slstm_state(b, X.XLSTMSpec(d_model=d, n_heads=2),
                                x.device)
        xw = X._slstm_xw({"w_in": w_in}, x)
        hs = []
        for t in range(s):
            st, _ = X._slstm_step(xw[:, t], w_rec, bias, st)
            hs.append(st.h)
        return torch.stack(hs, dim=1)

    cpu_hs, cpu_g = _slstm_run(op, inputs, dhs)
    card_in = [t.cuda() for t in inputs]
    hs, grads = _slstm_run(op, card_in, dhs.cuda())
    loop_hs, loop_g = _slstm_run(loop, card_in, dhs.cuda())
    assert hs.is_cuda and torch.equal(hs, loop_hs)
    assert (hs.cpu() - cpu_hs).abs().max().item() <= SLSTM_LAYER_TOL
    for name, g, gl, gc in zip(("x", "w_in", "w_rec", "b"), grads, loop_g,
                               cpu_g):
        assert g.is_cuda, name
        assert _normwise(g, gl) < SLSTM_LOOP_TOL, name
        assert _normwise(g.cpu(), gc) < SLSTM_GRAD_TOL, name
