"""The plain references against the program at a small size on the CPU
(the reference must not import the program; this test may), and the
BLAS-3 routines against float64."""

import pytest
import torch

from benchlib import registry
from conftest import ROOT, TINY_MIXTRAL
from reference import blas3, mixtral


def tiny_cfg(**kw) -> dict:
    bench = registry.benchmark(ROOT)
    return dict(registry.config(ROOT, bench, "mixtral-8x22b"),
                **TINY_MIXTRAL, **kw)


def port_logits(cfg, w, prompt, served):
    """The program's logits at the served positions: one prefill of the
    prompt, then one decode step a token, batch 1."""
    from drivers.lm_serve import arch_config
    from repro_torch.configs import build_model
    from repro_torch.train.step import make_ctx

    model = build_model(arch_config(cfg))
    cap = len(prompt) + len(served)
    with torch.inference_mode():
        logits, caches = model.prefill(
            w, torch.tensor([prompt]), make_ctx("prefill", cache_len=cap))
        rows = [logits[0]]
        dctx = make_ctx("decode", cache_len=cap)
        cache = model.init_cache(1, dctx)
        for src, dst in zip(caches, cache):
            n = src.k.shape[1]
            dst.k[:, :n] = src.k
            dst.v[:, :n] = src.v
        for i, tok in enumerate(served[:-1]):
            logits, cache = model.decode_step(
                w, torch.tensor([[tok]]), cache, len(prompt) + i, dctx)
            rows.append(logits[0])
    return torch.stack(rows)


@pytest.mark.parametrize("router_scale", [1.0, 60.0])
def test_mixtral_reference_matches_the_program(router_scale):
    cfg = tiny_cfg()
    w = mixtral.make_weights(cfg, 2 ** 31 + 3, "cpu")
    for layer in w["layers"]:
        layer["moe"]["router"].mul_(router_scale)
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg["vocab_size"], (48,), generator=gen)
    served = torch.randint(0, cfg["vocab_size"], (12,), generator=gen)
    prompt, served = prompt.tolist(), served.tolist()
    want = mixtral.served_logits(w, cfg, prompt, served)
    got = port_logits(cfg, w, prompt, served)
    assert got.shape == want.shape == (12, cfg["vocab_size"])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_capacity_drops_are_the_programs():
    """A peaked router overflows experts in the prompt: the reference's
    first-come token-major keep matches the program's buckets."""
    from repro_torch.models import moe as port_moe

    cfg = tiny_cfg()
    w = mixtral.make_weights(cfg, 9, "cpu")
    p = w["layers"][0]["moe"]
    p["router"].mul_(60.0)
    g = torch.Generator().manual_seed(1)
    # tokens alike: the router sends most of them to the same experts
    x = torch.randn(1, cfg["hidden_size"], generator=g) \
        + 0.3 * torch.randn(40, cfg["hidden_size"], generator=g)
    cap = mixtral.capacity(cfg, 40)
    _, idx = torch.topk(torch.softmax(x @ p["router"], -1), 2)
    assert torch.bincount(idx.reshape(-1), minlength=4).max() > cap
    spec = port_moe.MoESpec(d_model=cfg["hidden_size"], n_experts=4,
                            top_k=2, d_ff=cfg["intermediate_size"])
    assert spec.capacity(40) == cap
    want = mixtral.moe(p, x, cfg, 40, mixtral.mm_fp32)
    got, _ = port_moe.apply_moe(p, x[None], spec, backend="torch")
    torch.testing.assert_close(got[0], want, atol=1e-5, rtol=1e-5)
    # without the cap the rows differ: the drops are real
    free = mixtral.moe(p, x, cfg, 0, mixtral.mm_fp32)
    assert (free - want).abs().max() > 1e-2


def test_decode_batches_never_reach_a_capacity():
    cfg = registry.config(ROOT, registry.benchmark(ROOT), "mixtral-8x22b")
    slots = registry.mix("serve_prefill_heavy")["slots"]
    assert mixtral.capacity(cfg, slots) >= slots
    # a decode step of 16 slots can drop pairs: no 16-slot cell yet
    assert mixtral.capacity(cfg, 16) < 16


def test_weights_follow_the_seed_and_the_programs_layout():
    from drivers.lm_serve import arch_config, check_program
    from repro_torch.configs import build_model

    cfg = tiny_cfg()
    a, b = (mixtral.make_weights(cfg, 17, "cpu") for _ in range(2))
    c = mixtral.make_weights(cfg, 18, "cpu")
    assert torch.equal(a["layers"][1]["moe"]["wo"], b["layers"][1]["moe"]["wo"])
    assert not torch.equal(a["embed"], c["embed"])
    check_program(cfg, build_model(arch_config(cfg)), mixtral)


@pytest.mark.parametrize("m,k,n", [(300, 70, 40), (1100, 33, 90)])
def test_blas_reference_against_float64(m, k, n):
    gen = torch.Generator().manual_seed(m)
    a = torch.randn(m, k, generator=gen)
    b = torch.randn(k, n, generator=gen)
    ell = torch.randn(m, m, generator=gen).tril_()
    ell.diagonal().copy_(ell.diagonal().abs() + m)
    rhs = torch.randn(m, n, generator=gen)
    d = torch.float64
    assert blas3.rel_err(blas3.gemm(a, b), a.to(d) @ b.to(d)) < 1e-6
    assert blas3.rel_err(blas3.syrk(a), torch.tril(a.to(d) @ a.to(d).T)) \
        < 1e-6
    x64 = torch.linalg.solve_triangular(ell.to(d), rhs.to(d), upper=False)
    assert blas3.rel_err(blas3.trsm(ell, rhs), x64) < 1e-6
    assert blas3.rel_err(blas3.gemm(a, b)[:-1], a @ b) == float("inf")


def test_a_tied_routing_may_go_either_way(monkeypatch):
    """Rows whose k-th and (k+1)-th router logits tie are found, taking
    the other expert changes only those rows, and the gap a position
    reads is its smallest over the routings tried."""
    cfg = tiny_cfg()
    w = mixtral.make_weights(cfg, 4, "cpu")
    p = w["layers"][0]["moe"]
    x = torch.randn(12, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(2))
    ties: list = []
    base = mixtral.moe(p, x, cfg, 0, mixtral.mm_fp32, ties=ties)
    assert ties == []               # random rows tie at no router margin
    monkeypatch.setattr(mixtral, "TIE", 1e9)
    mixtral.moe(p, x, cfg, 0, mixtral.mm_fp32, ties=ties)
    assert ties == list(range(12))
    other = mixtral.moe(p, x, cfg, 0, mixtral.mm_fp32, swap=(3,))
    changed = (other - base).abs().amax(dim=1) > 0
    assert changed.tolist() == [i == 3 for i in range(12)]

    prompt, served = list(range(5, 25)), list(range(30, 36))
    strict = float(mixtral.gaps(mixtral.served_logits(
        w, cfg, prompt, served), served).max())
    assert mixtral.widest_gap(w, cfg, prompt, served) <= strict
