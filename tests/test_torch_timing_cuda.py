"""``MeasuredCUDABackend`` beside a server on one card.  Marked
``cuda``: without a CUDA device every test here skips (it times the
port's kernels, which have no CPU mode).  Imports no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_timing_cuda.py

A background re-install times kernels while the serving thread keeps
queueing work on the card.  The backend times on its own stream: work
queued before the call on the caller's stream does not enter its
reading, work on other streams is neither read nor waited for (no
device-wide sync), and every ``attn`` row is timed on the flash kernel
whatever head dim the installer sampled.
"""

import threading
import time

import pytest
import torch

from repro_torch.core import GemmConfig, MeasuredCUDABackend
from repro_torch.core.timing import attn_timing_heads
from repro_torch.kernels import flash_attention as F

pytestmark = [pytest.mark.cuda, pytest.mark.timeout(300)]

CFG = GemmConfig(1, "M", 3)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the measured backend times the "
                    "Hopper kernels, which have no CPU mode")
    yield torch.device("cuda")
    torch.cuda.synchronize()


def _cycles_per_second() -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    end.synchronize()
    return 50_000_000 / (start.elapsed_time(end) * 1e-3)


def test_reading_leaves_out_work_queued_before_on_the_callers_stream(gpu):
    backend = MeasuredCUDABackend(repeats=3, warmup=1)
    quiet = backend.time_routine(256, 256, 256, CFG)
    torch.cuda._sleep(int(0.5 * _cycles_per_second()))  # default stream
    busy = backend.time_routine(256, 256, 256, CFG)
    assert busy < 0.05 and busy < 20 * quiet + 1e-3, (quiet, busy)


def test_does_not_wait_for_other_streams(gpu):
    backend = MeasuredCUDABackend(repeats=3, warmup=1)
    backend.time_routine(256, 256, 256, CFG)           # pool, stream
    server = torch.cuda.Stream()
    with torch.cuda.stream(server):
        torch.cuda._sleep(int(3.0 * _cycles_per_second()))
    t0 = time.perf_counter()
    reading = backend.time_routine(512, 512, 512, CFG)
    took = time.perf_counter() - t0
    still_busy = not server.query()
    server.synchronize()
    assert still_busy and took < 1.5, took
    assert reading < 0.05


def test_times_from_a_background_thread(gpu):
    backend = MeasuredCUDABackend(repeats=2, warmup=1)
    out: list = []

    def install_thread():
        out.append(backend.time_routine(300, 200, 100, CFG,
                                        routine="trsm"))
        out.append(torch.is_inference_mode_enabled())

    t = threading.Thread(target=install_thread)
    t.start()
    t.join(60)
    assert out and 0 < out[0] < 1 and out[1] is False


@pytest.mark.parametrize("head_dim", [8, 16, 24, 64, 100, 128, 200, 700])
def test_attn_rows_time_on_the_kernel_at_any_sampled_head_dim(gpu,
                                                              head_dim):
    backend = MeasuredCUDABackend(repeats=2, warmup=1)
    cfg = GemmConfig(1, "M", 3, flash_grid="tri")
    before = F.flash_attention_cuda.launches
    t = backend.time_routine(256, head_dim, 300, cfg, routine="attn")
    assert 0 < t < 1
    assert F.flash_attention_cuda.launches - before == 3
    bh, d = attn_timing_heads(head_dim)
    assert d in F.SUPPORTED_HEAD_DIMS and bh * d >= head_dim
