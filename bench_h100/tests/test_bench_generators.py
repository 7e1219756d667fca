"""The traffic generators: the same seed gives the same inputs, every
seed the same sizes (BLAS calls in an order of the seed's own, served
requests in the mix's one order)."""

import numpy as np

from benchlib import registry
from generators import blas_calls, closed_loop


def test_blas_calls_come_from_the_shape_seed_alone():
    mix = registry.mix("paper_mix_100mb")
    calls = blas_calls.calls(mix)
    assert calls == blas_calls.calls(dict(mix))
    assert len(calls) == 96
    assert [c[0] for c in calls] == ["gemm"] * 32 + ["syrk"] * 32 \
        + ["trsm"] * 32
    for r, m, k, n in calls:
        assert 4 * (m * k + k * n + m * n) <= 100 * 2 ** 20
        assert 8 <= min(m, k, n) and max(m, k, n) <= 65536


def test_blas_order_is_a_permutation_each_cycle_and_follows_the_seed():
    def first(seed, n):
        it = blas_calls.order(96, seed)
        return [next(it) for _ in range(n)]

    a, b = first(2 ** 31 + 5, 192), first(2 ** 31 + 5, 192)
    assert a == b
    assert sorted(a[:96]) == list(range(96)) == sorted(a[96:])
    assert first(2 ** 31 + 6, 96) != a[:96]


def test_serving_pool_is_the_same_for_every_seed():
    mix = registry.mix("serve_prefill_heavy")
    t1 = closed_loop.Traffic(mix, 32768, 2 ** 31 + 1)
    t2 = closed_loop.Traffic(mix, 32768, 3 ** 20)
    assert t1.pool == t2.pool == closed_loop.pool(mix)
    assert len(t1.lengths) == mix["distinct_prompts"]
    p, a = mix["prompt"], mix["answer"]
    assert all(p["lo"] <= x <= p["hi"] for x, _ in t1.pool)
    assert all(a["lo"] <= y <= a["hi"] for _, y in t1.pool)
    assert max(x + y - 1 for x, y in t1.pool) <= mix["max_seq_len"]


def test_serving_requests_follow_the_seed():
    mix = registry.mix("serve_prefill_heavy")

    def draw(seed):
        t = closed_loop.Traffic(mix, 32768, seed)
        return [t.first() for _ in range(3)] + [t.next() for _ in range(40)]

    def sizes(reqs):
        return [(len(p), n) for p, n in reqs]

    a, b, c = draw(2 ** 31 + 9), draw(2 ** 31 + 9), draw(2 ** 31 + 10)
    assert a == b and a != c
    # the seed draws the token ids; sizes and order are the mix's own
    assert sizes(a) == sizes(c)
    # one pass over the pool serves each of its sizes once
    def one_pass(seed):
        t = closed_loop.Traffic(mix, 32768, seed)
        return sizes(t.next() for _ in range(mix["pool"]))

    s7, s8 = one_pass(7), one_pass(8)
    assert s7 == s8 and sorted(s7) == sorted(closed_loop.pool(mix))


def test_log_uniform_lengths_stay_in_bounds():
    rng = np.random.default_rng(0)
    x = closed_loop.draw({"dist": "log_uniform", "lo": 512, "hi": 4064},
                         10000, rng)
    assert x.min() >= 512 and x.max() <= 4064
    # log-uniform: about as many below the geometric middle as above
    mid = (512 * 4064) ** 0.5
    assert 0.45 < (x < mid).mean() < 0.55
