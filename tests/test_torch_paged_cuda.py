"""The paged decode and the continuous-batching scheduler on the card.
Marked ``cuda``: without a CUDA device every test here skips (prefill
runs the flash kernel, which has no CPU mode).  Imports no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_cuda.py

On the CPU, tests/test_torch_kv_cache.py and
tests/test_torch_scheduler.py hold the same paths to the reference.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import build_model, get_smoke_config
from repro_torch.kernels import flash_attention as F
from repro_torch.models import layers as L
from repro_torch.serve.kv_cache import HOLE, PagedKV, gather_pages
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from repro_torch.train.step import make_ctx

pytestmark = [pytest.mark.cuda, pytest.mark.timeout(300)]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: prefill runs the Hopper flash "
                    "kernel, which has no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def test_paged_decode_is_contiguous_decode_on_the_card(gpu):
    """Rows scattered over pages decode bit for bit like the contiguous
    cache holding them, and the new rows land in the same places."""
    g = torch.Generator(device="cuda").manual_seed(0)
    s = L.AttnSpec(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
                   rope_fraction=0.25)
    p = {n: torch.randn(shape, generator=g, device="cuda") * 0.05
         for n, shape in (("wq", (256, 256)), ("wk", (256, 256)),
                          ("wv", (256, 256)), ("wo", (256, 256)))}
    b, n_pages, page, tpages = 4, 40, 16, 6
    k = torch.randn((n_pages, page, 4, 64), generator=g, device="cuda")
    v = torch.randn((n_pages, page, 4, 64), generator=g, device="cuda")
    perm = torch.randperm(n_pages, generator=torch.Generator()
                          .manual_seed(1))[: b * tpages]
    table = perm.view(b, tpages).to(torch.int32).cuda()
    x = torch.randn((b, 1, 256), generator=g, device="cuda")
    pos = 50
    with torch.inference_mode():
        contig = L.KVCache(gather_pages(k, table).clone(),
                           gather_pages(v, table).clone())
        want, contig = L.attention_decode(p, x, s, contig, pos)
        pool = PagedKV(k, v)
        got, pool = L.attention_decode_paged(
            p, x, s, pool, table, torch.full((b,), pos, device="cuda"))
    assert torch.equal(got, want)
    assert torch.equal(gather_pages(pool.k, table), contig.k)
    assert torch.equal(gather_pages(pool.v, table), contig.v)


def test_inactive_slots_write_nothing_on_the_card(gpu):
    pool = PagedKV(torch.zeros((3, 2, 1, 1), device="cuda"),
                   torch.zeros((3, 2, 1, 1), device="cuda"))
    from repro_torch.serve.kv_cache import append_token

    table = torch.tensor([[HOLE, HOLE], [1, 0], [0, HOLE]],
                         dtype=torch.int32, device="cuda")
    pos = torch.tensor([-1, 3, 0], device="cuda")
    new = torch.tensor([[[9.0]], [[7.0]], [[5.0]]], device="cuda")
    append_token(pool.k, table, pos, new, pos >= 0)
    assert pool.k[0, 1, 0, 0].item() == 7.0
    assert pool.k[0, 0, 0, 0].item() == 5.0
    assert (pool.k == 9.0).sum().item() == 0


def test_scheduler_decodes_like_the_fixed_batch_path_on_the_card(gpu):
    cfg = get_smoke_config("stablelm-1.6b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(7)
    trace = [(rng.integers(0, cfg.vocab, int(rng.integers(3, 40)))
              .tolist(), int(rng.integers(1, 9))) for _ in range(6)]
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=3, n_pages=48, page_size=8,
        max_seq_len=48, keep_logits=True)
    F.flash_attention_cuda.launches = 0
    rids = [sched.submit(pr, n) for pr, n in trace]
    sched.run_until_drained()
    assert F.flash_attention_cuda.launches == cfg.n_layers * len(trace)
    sched.alloc.check()
    assert sched.alloc.live_pages == 0
    pctx = make_ctx("prefill", cache_len=sched.cap)
    dctx = make_ctx("decode", cache_len=sched.cap)
    for rid, (prompt, max_new) in zip(rids, trace):
        with torch.inference_mode():
            logits, cache = model.prefill(
                params, torch.tensor([prompt], device="cuda"), pctx)
            toks, rows = [int(logits[0].argmax())], [logits[0]]
            for i in range(max_new - 1):
                logits, cache = model.decode_step(
                    params, torch.tensor([[toks[-1]]], device="cuda"),
                    cache, len(prompt) + i, dctx)
                toks.append(int(logits[0].argmax()))
                rows.append(logits[0])
        assert list(sched.finished[rid].tokens) == toks
        err = (torch.stack(sched.logits[rid])
               - torch.stack(rows).float().cpu()).abs().max().item()
        assert err <= 1e-4, err
