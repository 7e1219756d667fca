"""The mesh paths on the card: a one-rank NCCL world, a (1, 1) ("data",
"model") mesh; the MoE's expert-parallel path (the grouped-GEMM kernel
behind a one-rank ``all_to_all``) and the dense blocks tensor-parallel
over 'model' (on one rank: the whole weights, one-rank collectives,
bitwise the single-device path).  Marked ``cuda``: without a CUDA device
every test here skips.  Imports no jax, so it runs on a GPU host that has only
torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dist_cuda.py

The multi-rank paths are held to the JAX reference on gloo worlds on
the CPU by tests/test_torch_dist.py.  Tolerance: the grouped oracle's
5e-5 in fp32 (TF32 off); one rank holds every expert, so the buckets are
the single-device path's and the kernel's bits are too.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import build_model, get_smoke_config
from repro_torch.kernels import grouped_matmul as G
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grouped kernel has no CPU "
                    "mode (the mesh paths are tested on gloo on the CPU)")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_ep_moe_on_a_one_rank_mesh_matches_the_dense_path(nccl_mesh):
    from repro_torch.train.step import make_ctx

    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"),
                              d_model=256, d_ff_expert=512, n_experts=16)
    spec = T._moe_spec(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = init_params(MOE.moe_defs(spec), gen)
    x = torch.randn((4, 64, cfg.d_model), generator=gen, device="cuda")
    assert T.moe_mesh_layout(cfg, nccl_mesh, 64)[0] == "ep"
    with torch.no_grad():
        want, want_aux = MOE.apply_moe(p, x, spec)
        before = G.grouped_matmul_cuda.launches
        got, aux = T._moe_apply(p, x, cfg, make_ctx("prefill",
                                                    mesh=nccl_mesh))
        torch.cuda.synchronize()
    assert G.grouped_matmul_cuda.launches - before == 3
    torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(aux, want_aux, atol=1e-6, rtol=1e-6)


def test_mesh_prefill_of_a_smoke_model_on_the_card(nccl_mesh):
    """build_prefill on the (1, 1) mesh: DTensor weights laid out by the
    param specs, the EP path on the kernel, the single-device logits."""
    from repro_torch.dist.collectives import distribute
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve.step import build_prefill
    from repro_torch.train.step import make_ctx

    cfg = get_smoke_config("deepseek-v2-236b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    prefill, p_specs, _ = build_prefill(model, cfg,
                                        ShapeSpec("p", 32, 2, "prefill"),
                                        nccl_mesh)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, nccl_mesh, next(it)), params)
    assert all(a.to_local().data_ptr() == b.data_ptr() for a, b in zip(
        tree_leaves(sharded), tree_leaves(params)))      # no copy
    tokens = torch.randint(0, cfg.vocab, (2, 32), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    with torch.no_grad():
        before = G.grouped_matmul_cuda.launches
        logits, _ = prefill(sharded, {"tokens": tokens})
        moe = sum(s.mlp == "moe" for s in model.plan)
        assert G.grouped_matmul_cuda.launches - before == 3 * moe
        want, _ = model.prefill(params, tokens,
                                make_ctx("prefill", cache_len=32))
    torch.testing.assert_close(logits, want, atol=1e-5, rtol=1e-5)


def test_vocab_logz_is_logsumexp_bit_for_bit_on_the_card(nccl_mesh):
    """The vocab-parallel log-partition on a one-rank group: the steps
    of ``torch.logsumexp``, so its value and gradient are the same
    bits."""
    from repro_torch.dist.collectives import vocab_logz

    gen = torch.Generator(device="cuda").manual_seed(3)
    logits = (5 * torch.randn((2, 512, 4000), generator=gen, device="cuda")
              ).requires_grad_(True)
    w = torch.randn((2, 512), generator=gen, device="cuda")
    want = torch.logsumexp(logits, dim=-1)
    g_want, = torch.autograd.grad((want * w).sum(), logits)
    got = vocab_logz(logits, nccl_mesh.get_group("model"))
    g_got, = torch.autograd.grad((got * w).sum(), logits)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-8b",
                                  "chameleon-34b"])
def test_tp_step_and_prefill_on_a_one_rank_mesh_are_bitwise(nccl_mesh,
                                                            arch):
    """Two sharded train steps (the dense blocks on their 'model'
    shards, the vocab-parallel loss) and the built prefill (flash on the
    local heads, their K/V and the logits gathered over the group) on
    the one-rank mesh: the single-device step's state and the
    single-device prefill's logits and caches, bit for bit."""
    from repro_torch.data.pipeline import SyntheticLM, make_global_batch
    from repro_torch.dist.collectives import distribute
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve.step import build_prefill
    from repro_torch.train.optim import AdamWConfig, init_state
    from repro_torch.train.step import build_train_step, make_ctx

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    state = init_state(model.init(torch.Generator(device="cuda")
                                  .manual_seed(0)), opt)
    step, s_specs, b_specs = build_train_step(
        model, cfg, opt, shape=ShapeSpec("t", 64, 4, "train"),
        mesh=nccl_mesh)
    one, _, _ = build_train_step(model, cfg, opt)
    leaves = {k: tree_leaves(v, is_leaf=is_spec) for k, v in s_specs.items()}
    sharded = {}
    for k, v in state.items():
        it = iter(leaves[k]) if k != "step" else iter([()])
        sharded[k] = tree_map(lambda t: distribute(t.clone(), nccl_mesh,
                                                   next(it)), v)
    data = SyntheticLM(cfg.vocab, 64, 4, seed=3)
    for i in range(2):
        batch = data.batch_at(i)
        sharded, m = step(sharded, make_global_batch(batch, nccl_mesh,
                                                     b_specs))
        state, m1 = one(state, make_global_batch(batch, None))
        assert torch.equal(m["loss"], m1["loss"])
    assert all(torch.equal(a.to_local(), b) for a, b in zip(
        tree_leaves(sharded), tree_leaves(state)))
    params = state["params"]
    prefill, p_specs, pb_specs = build_prefill(
        model, cfg, ShapeSpec("p", 48, 4, "prefill"), nccl_mesh)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    on_mesh = tree_map(lambda t: distribute(t, nccl_mesh, next(it)), params)
    tokens = torch.randint(0, cfg.vocab, (4, 32), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    with torch.no_grad():
        before = FA.flash_attention_cuda.launches
        logits, cache = prefill(on_mesh, {"tokens": distribute(
            tokens, nccl_mesh, pb_specs["tokens"])})
        torch.cuda.synchronize()
        assert FA.flash_attention_cuda.launches - before == cfg.n_layers
        want, cache1 = model.prefill(params, tokens,
                                     make_ctx("prefill", cache_len=48))
    assert torch.equal(logits, want)
    assert all(torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
               for a, b in zip(cache, cache1))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_mesh_decode_of_a_smoke_model_on_the_card(nccl_mesh, arch):
    """build_decode on the (1, 1) mesh from a prefill's caches laid out by
    ``shard_cache``: every attention cache read split-KV (one shard
    holding every slot), the MoE through ``apply_moe_decode`` on the
    grouped kernel's thin body (3 launches a MoE layer a step), 4 greedy
    steps against the single-device decode: the same tokens, logits
    within 1e-5 (the combine divides after the value product, so not
    bitwise)."""
    from repro_torch.dist.collectives import distribute
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.layers import SplitKV
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve import step as S
    from repro_torch.train.step import make_ctx

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(3))
    prompt, steps = 40, 4
    cap = prompt + steps
    decode, p_specs, (_, c_specs, _) = S.build_decode(
        model, cfg, ShapeSpec("d", cap, 2, "decode"), nccl_mesh)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, nccl_mesh, next(it)), params)
    tokens = torch.randint(0, cfg.vocab, (2, prompt), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4))
    split = []
    orig = S._split_view
    S._split_view = lambda c, tp: split.append(orig(c, tp)) or split[-1]
    dctx = make_ctx("decode", cache_len=cap)
    moe = sum(s.mlp == "moe" for s in model.plan)
    try:
        with torch.no_grad():
            logits, cache1 = model.prefill(params, tokens,
                                           make_ctx("prefill",
                                                    cache_len=cap))
            cache = S.shard_cache(S._map_arrays(lambda t: t.clone(),
                                                cache1), nccl_mesh, c_specs)
            tok1 = tok = logits.argmax(-1, keepdim=True)
            for i in range(steps):
                want, cache1 = model.decode_step(params, tok1, cache1,
                                                 prompt + i, dctx)
                before = dict(G.grouped_matmul_cuda.launches_by_variant)
                got, cache = decode(sharded, tok, cache, prompt + i)
                torch.cuda.synchronize()
                after = G.grouped_matmul_cuda.launches_by_variant
                assert after["thin"] - before["thin"] == 3 * moe
                assert after["tiled"] == before["tiled"]
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
                tok1, tok = want.argmax(-1, keepdim=True), \
                    got.argmax(-1, keepdim=True)
                assert torch.equal(tok, tok1)
    finally:
        S._split_view = orig
    assert split and all(isinstance(v, SplitKV) for v in split)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-236b"])
def test_paged_mesh_decode_of_a_smoke_model_on_the_card(nccl_mesh, arch):
    """build_decode_paged on the (1, 1) mesh over random pools laid out by
    its pool specs (each read split-KV over its pages, one rank holding
    every page), an inactive slot and a hole past a prefix; the MoE
    through ``apply_moe_decode`` on the grouped kernel's thin body (3
    launches a MoE layer a step); 4 greedy steps against the
    single-device paged decode on a copy of the pools: the same tokens,
    logits and pools within 1e-5, the pools returned in place."""
    from repro_torch.dist.collectives import distribute
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve import step as S
    from repro_torch.train.step import make_ctx

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = model.init(gen)
    slots, page, width, steps = 4, 4, 4, 4
    cap, n_pages = page * width, slots * width
    decode, p_specs, (_, pool_specs, _, _) = S.build_decode_paged(
        model, cfg, slots=slots, n_pages=n_pages, page_size=page,
        table_pages=width, mesh=nccl_mesh)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, nccl_mesh, next(it)), params)
    dctx = make_ctx("decode", cache_len=cap)
    pool1 = S._map_arrays(
        lambda t: torch.randn(t.shape, generator=gen, device="cuda"),
        model.init_paged_cache(n_pages, page, dctx, device="meta"))
    pools = S._map_arrays(
        lambda t, spec: distribute(t.clone(), nccl_mesh, spec), pool1,
        pool_specs)
    table = torch.randperm(n_pages, device="cuda", generator=gen).view(
        slots, width)
    table[1, 2:] = -1
    pos = torch.tensor([9, 3, -1, 11], device="cuda")
    tok1 = tok = torch.randint(0, cfg.vocab, (slots, 1), device="cuda",
                               generator=gen)
    moe = sum(s.mlp == "moe" for s in model.plan)
    with torch.no_grad():
        for _ in range(steps):
            want, _ = model.decode_step(params, tok1, pool1, pos, dctx, table)
            before = dict(G.grouped_matmul_cuda.launches_by_variant)
            got, out = decode(sharded, tok, pools, pos, table)
            torch.cuda.synchronize()
            after = G.grouped_matmul_cuda.launches_by_variant
            assert after["thin"] - before["thin"] == 3 * moe
            assert after["tiled"] == before["tiled"]
            assert out is pools
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            tok1, tok = want.argmax(-1, keepdim=True), \
                got.argmax(-1, keepdim=True)
            assert torch.equal(tok, tok1)
            pos = torch.where(pos >= 0, pos + 1, pos)
    mine, single = [], []
    S._map_arrays(lambda t: mine.append(t.to_local()), pools)
    S._map_arrays(single.append, pool1)
    for a, b in zip(mine, single):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
