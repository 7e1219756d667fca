"""The paper's deployment: a library caller's BLAS-3 calls served by an
ADSALA install.

Set-up loads (or, first in a checkout, builds and installs) the tuner,
makes every call's operands on the device from the run seed and makes
each call once.  The window is one caller in a closed loop: it calls
``ops.<routine>(..., tuner=tuner)`` and waits for the result before the
next call, in an order the seed shuffles.  ``blas_gflop_s`` is the
nominal FLOPs of every call completed in the window over the window.
After the window each distinct call's last output is held against the
plain reference (``max |out - ref| / max |ref|``, the worst call of each
routine)."""

from __future__ import annotations

import sys
import time

from benchlib import counts, install, registry

ENTRY = {"gemm": "matmul", "syrk": "syrk", "trsm": "trsm"}


def dispatch_dims(routine: str, m: int, k: int, n: int) -> tuple:
    """The (m, k, n) the tuner is asked about for a call."""
    return {"gemm": (m, k, n), "syrk": (m, k, m), "trsm": (m, m, n)}[routine]


def make_operands(calls, seed: int, device: str) -> list[tuple]:
    """Every call's operands, drawn in one call from ``seed`` on the
    device: gemm A (m, k), B (k, n); syrk A (m, k); trsm a lower
    triangle L (m, m) with |diag| + m on its diagonal (well conditioned,
    as the install's backend builds it) and B (m, n)."""
    import torch

    shapes = []
    for r, m, k, n in calls:
        shapes.append({"gemm": [(m, k), (k, n)], "syrk": [(m, k)],
                       "trsm": [(m, m), (m, n)]}[r])
    total = sum(a * b for s in shapes for a, b in s)
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.randn(total, generator=gen, device=device)
    out, off = [], 0
    for (r, m, _, _), s in zip(calls, shapes):
        views = []
        for a, b in s:
            views.append(pool[off:off + a * b].view(a, b))
            off += a * b
        if r == "trsm":
            ell = views[0].tril_()
            diag = ell.diagonal()
            diag.copy_(diag.abs() + float(m))
        out.append(tuple(views))
    return out


def run(r) -> None:
    import torch

    from repro_torch.core.costmodel import DEFAULT_TILES
    from repro_torch.kernels import ops

    gen = registry.module("generators", r.mix["generator"])
    ref = registry.module("reference", r.config["reference"])
    spec = r.extra.get("install_spec") or registry.install_spec(
        r.config["install"], r.here)
    t_in = time.perf_counter()
    tuner, r.first_setup = install.load_tuner(r.root, spec)
    t_tuner = time.perf_counter()
    calls = gen.calls(r.mix)
    operands = make_operands(calls, r.seed, r.device)
    t_ops = time.perf_counter()
    entry = {k: getattr(ops, v) for k, v in ENTRY.items()}
    cuda = r.device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with torch.inference_mode():
        for (routine, *_), args in zip(calls, operands):
            entry[routine](*args, tuner=tuner)
        sync()
        nominal = [counts.routine_flops(*c) for c in calls]
        outputs: list = [None] * len(calls)
        order = gen.order(len(calls), r.seed)
        flops, done, failed = 0.0, 0, 0
        tr = r.tracer
        r.setup_s = time.perf_counter() - r.t_start

        def calls_until(end: float) -> float:
            """Make calls until one ends at or after ``end``."""
            nonlocal flops, done, failed
            while True:
                i = next(order)
                routine = calls[i][0]
                try:
                    with tr.range("ops.call"):
                        out = entry[routine](*operands[i], tuner=tuner)
                    with tr.range("sync"):
                        sync()
                except (RuntimeError, ValueError):
                    failed += 1
                    out = None
                t = time.perf_counter()
                with tr.range("client"):
                    done += 1
                    if out is not None:
                        flops += nominal[i]
                        outputs[i] = out
                if t >= end:
                    return t

        t0 = time.perf_counter()
        if tr.head(r.seconds):
            calls_until(t0 + tr.head(r.seconds))
        with tr.window():
            t = calls_until(t0 + r.seconds)
        window_s = t - t0
    r.metrics["blas_gflop_s"] = flops / window_s / 1e9
    r.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    r.attempted, r.failed = done, failed

    # the outputs the window produced against the plain reference
    worst: dict[str, float] = {}
    from reference import fp32_highest

    with torch.inference_mode(), fp32_highest():
        for (routine, *_), args, out in zip(calls, operands, outputs):
            if out is None:
                continue
            err = ref.rel_err(out, ref.call(routine, args))
            worst[routine] = max(worst.get(routine, 0.0), err)
    print(f"[bench] blas3: set-up {r.setup_s:.1f} s (start-up "
          f"{t_in - r.t_start:.1f} s, tuner {t_tuner - t_in:.1f} s, "
          f"installed now: {r.first_setup}, operands {t_ops - t_tuner:.1f} "
          f"s, warm-up {r.t_start + r.setup_s - t_ops:.1f} s), window "
          f"{window_s:.2f} s, {done} calls, {failed} failed",
          file=sys.stderr)
    limits = r.config["checks"]
    for routine, err in worst.items():
        name = f"{routine}_err"
        r.checks[name] = (err, float(limits[name]))
    r.extra.update(
        calls=calls, operands=operands, tuner=tuner, entry=entry,
        default_tile=DEFAULT_TILES[spec["default_tile_id"]],
        tuned_tile=lambda routine, m, k, n: tuner.select(
            *dispatch_dims(routine, m, k, n),
            ops.supported_routine(routine, tuner)).tile)


def control(r) -> dict:
    """The control's readings: the reference in TF32 in the program's
    place on every call, held against the float32 reference."""
    import torch

    from reference import fp32_highest, mm_tf32

    ref = registry.module("reference", r.config["reference"])
    worst: dict[str, float] = {}
    with torch.inference_mode(), fp32_highest():
        for (routine, *_), args in zip(r.extra["calls"],
                                       r.extra["operands"]):
            err = ref.rel_err(ref.call(routine, args, mm=mm_tf32),
                              ref.call(routine, args))
            worst[f"{routine}_err"] = max(worst.get(f"{routine}_err", 0.0),
                                          err)
    return worst
