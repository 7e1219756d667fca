"""The paper's metric: every distinct call of the window timed through
``ops.<routine>(..., tile=...)`` at the install's default tile and at
the tile the tuner picked, by the benchmark's own timer (CUDA events, L2
flushed, median of 3 after one warm-up); the summed time at the default
tile over the summed time at the tuned tile."""


def read(run):
    x = run.extra
    if run.device != "cuda" or "calls" not in x:
        return None
    import torch

    from benchlib.timer import DeviceTimer

    timer = DeviceTimer(repeats=3, warmup=1)
    default_s = tuned_s = 0.0
    with torch.inference_mode():
        for (routine, m, k, n), args in zip(x["calls"], x["operands"]):
            fn = x["entry"][routine]
            tile = x["tuned_tile"](routine, m, k, n)
            tuned_s += timer.seconds(lambda: fn(*args, tile=tile))
            default_s += timer.seconds(
                lambda: fn(*args, tile=x["default_tile"]))
    return default_s / tuned_s
