"""The control, and the faults a run must catch, on the CPU.

The control is the plain reference computed in TF32 (operands rounded
to TF32, products summed in float32), the nearest precision below the
configurations' float32, put in the program's place; each cell's
numbers must read it as not correct.  On the card it is read at the
cells' own sizes (``control.py``); here at sizes a test run holds, with
as many compared positions as a run at the cell's size has.  The faults
are planted under the timed path and the whole run must come out
``correct: false``."""

import pytest
import torch

from conftest import TINY_BLAS, TINY_MIXTRAL, TINY_SERVE, cpu_run

#: BLAS calls whose triangular solves span several reference panels
BLAS_PANELS = {"calls_per_routine": 3, "mem_limit_mb": 12, "dim_min": 600,
               "dim_max": 1100}
#: a model wide enough, and answers long enough, for TF32 to move some
#: served tokens
WIDE_MIXTRAL = dict(TINY_MIXTRAL, hidden_size=256, intermediate_size=512,
                    num_local_experts=8, vocab_size=8192)
LONG_ANSWERS = dict(TINY_SERVE, max_seq_len=512,
                    prompt={"dist": "uniform", "lo": 32, "hi": 64},
                    answer={"dist": "uniform", "lo": 300, "hi": 400},
                    check_requests=16)
#: the faults' runs compare every request they finished
EVERY_REQUEST = dict(TINY_SERVE, check_requests=10 ** 4)


def not_correct(run, readings: dict) -> bool:
    from benchlib import cli

    return not cli.within_limits(run, readings)


def test_blas_control_is_not_correct():
    from drivers import blas3

    run, res = cpu_run("blas3.paper_100mb", mix=BLAS_PANELS, seconds=0.5)
    assert res["correct"]
    ctrl = blas3.control(run)
    assert not_correct(run, ctrl), (ctrl, run.checks)


def test_serving_control_is_not_correct():
    from drivers import lm_serve

    run, res = cpu_run("mixtral.prefill_heavy", config=WIDE_MIXTRAL,
                       mix=LONG_ANSWERS, seconds=16.0)
    assert res["correct"]
    assert sum(len(x.tokens) for x in run.extra["sample"]) >= 1000
    ctrl = lm_serve.control(run)
    assert not_correct(run, ctrl), (ctrl, run.checks)


def test_an_altered_answer_is_caught(monkeypatch):
    from repro_torch.kernels import ops

    real = ops.matmul

    def altered(*a, **k):
        out = real(*a, **k)
        out[0, 0] += 1.0
        return out

    monkeypatch.setattr(ops, "matmul", altered)
    run, res = cpu_run("blas3.paper_100mb", mix=TINY_BLAS, seconds=0.3)
    assert not res["correct"] and run.checks["gemm_err"][0] > 1e-3


def serve_with(monkeypatch, patch) -> dict:
    from repro_torch.models import transformer

    real = transformer.LM.decode_step
    calls = []

    def step(self, params, token, cache, pos, ctx, page_table=None):
        logits, cache = real(self, params, token, cache, pos, ctx,
                             page_table)
        calls.append(1)
        return patch(logits, len(calls)), cache

    monkeypatch.setattr(transformer.LM, "decode_step", step)
    run, res = cpu_run("mixtral.prefill_heavy", config=TINY_MIXTRAL,
                       mix=EVERY_REQUEST, seconds=1.5)
    return res


def test_an_altered_token_is_caught(monkeypatch):
    def bump(logits, n):
        if n % 5 == 0:
            logits = logits.clone()
            logits[0, (int(logits[0].argmax()) + 1) % logits.shape[1]] += 1e3
        return logits

    assert not serve_with(monkeypatch, bump)["correct"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    def half(logits, n):
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0.0
        return logits

    assert not serve_with(monkeypatch, half)["correct"]


def test_a_state_left_unchanged_is_caught(monkeypatch):
    from repro_torch.serve import kv_cache

    monkeypatch.setattr(kv_cache, "append_token",
                        lambda pages, *a, **k: pages)
    run, res = cpu_run("mixtral.prefill_heavy", config=TINY_MIXTRAL,
                       mix=EVERY_REQUEST, seconds=1.5)
    assert not res["correct"]


@pytest.mark.parametrize("d", [8, 64])
def test_tf32_rounding(d):
    from reference import round_tf32

    x = torch.randn(d, d, generator=torch.Generator().manual_seed(d))
    r = round_tf32(x)
    bits = r.view(torch.int32)
    assert (bits & 0x1FFF).eq(0).all()                 # 10 mantissa bits
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal(round_tf32(-x), -r)
