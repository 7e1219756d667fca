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
