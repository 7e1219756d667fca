"""The frozen yardstick: counts against hand-worked shapes, the
percentiles over every sample, the frozen sampler against the
program's."""

import statistics

import numpy as np
import pytest

from benchlib import counts, halton, peaks, stats


def test_blas_flops_by_hand():
    assert counts.routine_flops("gemm", 2, 3, 4) == 48          # 2mkn
    assert counts.routine_flops("syrk", 3, 5, 999) == 60        # m(m+1)k
    assert counts.routine_flops("trsm", 4, 999, 5) == 80        # m^2 n
    with pytest.raises(ValueError):
        counts.routine_flops("gemv", 1, 1, 1)


def test_least_time_takes_the_larger_bound():
    # 2048^3: compute bound, 2 * 2048^3 / 67e12 s
    assert counts.gemm_least_s(2048, 2048, 2048) == pytest.approx(
        2 * 2048 ** 3 / 67e12)
    # a decode bucket of mixtral: 8 experts (8, 6144) x (6144, 16384):
    # bytes bound, the weights dominate
    e, c, d, f = 8, 8, 6144, 16384
    want = 4 * e * (c * d + d * f + c * f) / 3.35e12
    assert counts.grouped_least_s(e, c, d, f) == pytest.approx(want)
    assert want * 1e3 == pytest.approx(0.9633, rel=1e-3)     # 0.963 ms
    assert peaks.FP32_FLOPS == 67e12 and peaks.HBM_BYTES == 3.35e12


def test_lm_flops_by_hand():
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "intermediate_size": 16,
           "num_local_experts": 4, "num_experts_per_tok": 2,
           "num_hidden_layers": 3, "vocab_size": 10}
    # a token: q (8x8), k, v (8x4 each), o (8x8) -> 2*8*16 + 2*8*8;
    # router 2*8*4; two experts, 3 products of 8x16 -> 2*3*2*8*16
    per_layer = 2 * 8 * 16 + 2 * 8 * 8 + 2 * 8 * 4 + 2 * 3 * 2 * 8 * 16
    assert counts.lm_token_flops(cfg, 0) == 3 * per_layer
    # attention: 4 * heads * head_dim a position attended
    assert counts.lm_token_flops(cfg, 5) - counts.lm_token_flops(cfg, 0) \
        == 3 * 4 * 2 * 4 * 5
    head = 2 * 8 * 10
    assert counts.lm_decode_flops(cfg, 5) == \
        counts.lm_token_flops(cfg, 5) + head
    # a prompt of 3: positions attend 1, 2, 3
    assert counts.lm_prefill_flops(cfg, 3) == pytest.approx(
        sum(counts.lm_token_flops(cfg, i) for i in (1, 2, 3)) + head)


def test_percentile_is_over_every_sample():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == pytest.approx(np.percentile(xs, 90))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile([5.0], 90) == 5.0
    # one far sample moves the tail: nothing is dropped or averaged away
    assert stats.percentile(xs[:-1] + [10 ** 6], 100) == 10 ** 6
    rng = np.random.default_rng(1)
    v = rng.exponential(size=1001)
    assert stats.percentile(v, 90) == pytest.approx(np.percentile(v, 90))
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_quartile_spread_uses_statistics_quantiles():
    v = [10.0, 11.0, 9.0, 10.5, 9.5, 10.2]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.quartile_spread(v) == pytest.approx((q3 - q1) / med)


def test_frozen_sampler_matches_the_program():
    from repro_torch.core.halton import sample_gemm_dims

    for log_space in (False, True):
        ours = halton.sample_dims(40, mem_limit_bytes=100 * 2 ** 20,
                                  seed=1, log_space=log_space)
        theirs = sample_gemm_dims(40, mem_limit_bytes=100 * 2 ** 20,
                                  dtype_bytes=4, seed=1,
                                  log_space=log_space)
        np.testing.assert_array_equal(ours, theirs)
