"""The benchmark's own device timer, frozen: CUDA events around one call
on the current stream after the L2 cache was flushed, ``warmup``
untimed calls first, the median of ``repeats`` timed ones (the method
of the program's measured install backend, not its code)."""

from __future__ import annotations

import statistics

#: bytes zeroed before each timed call: more than the H100's 50 MB L2
FLUSH_BYTES = 64 * 2 ** 20


class DeviceTimer:
    def __init__(self, repeats: int = 3, warmup: int = 1):
        import torch

        self.torch = torch
        self.repeats, self.warmup = repeats, warmup
        self.flush = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def seconds(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.repeats):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        return statistics.median(times)
