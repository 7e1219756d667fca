"""One run of one cell:
``python bench_h100/run.py --workload W --seed N --seconds S --trace 0|1``.

The run finds its cell, configuration and traffic mix by name, refuses
to run without the CUDA devices the cell asks for, lets the
configuration's driver set up, warm up, measure and check the timed
path's outputs, reads the per-layer metrics of a traced run, and prints
the result as the last line of standard output.  It exits non-zero and
prints no result when anything fails, and when the process holds JAX or
the JAX package once the window has closed."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

from benchlib import registry
from benchlib.trace import Tracer

#: top-level module names the process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the program's kernel ops whose launches the trace collects
KERNEL_OPS = ("repro_torch::matmul", "repro_torch::grouped_matmul",
              "repro_torch::flash_attention")


class RunFailed(RuntimeError):
    """The run cannot give a result."""


@dataclasses.dataclass
class Run:
    """What a driver gets, and what it fills in."""

    root: Path
    workload: str
    seed: int
    seconds: float
    trace: bool
    bench: dict
    cell: dict
    config: dict
    mix: dict
    device: str
    t_start: float
    tracer: Tracer
    here: Path              # the checkout's benchmark folder
    # filled in by the system's module (drivers/<system>.py)
    setup_s: float | None = None
    first_setup: bool = False
    metrics: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    extra: dict = dataclasses.field(default_factory=dict)


def parse_args(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_run(root: Path, args, t_start: float, device: str,
             bench: dict | None = None, config: dict | None = None,
             mix: dict | None = None) -> Run:
    here = root / registry.HERE.name
    bench = bench or registry.benchmark(root)
    cell = registry.cell(bench, args.workload)
    config = config or registry.config(root, bench, cell["config"])
    mix = mix or registry.mix(cell["traffic"], here)
    return Run(root=root, workload=args.workload,
               seed=int(args.seed) % 2 ** 63, seconds=float(args.seconds),
               trace=bool(args.trace), bench=bench, cell=cell,
               config=config, mix=mix, device=device, t_start=t_start,
               tracer=Tracer(bool(args.trace), KERNEL_OPS), here=here)


def execute(run: Run) -> dict:
    """Drive the cell and build its result (no look for a chip here)."""
    driver = registry.module("drivers", run.config["system"])
    driver.run(run)
    want = (registry.per_layer(run.bench, run.workload) if run.trace
            else registry.end_to_end(run.bench, run.workload))
    run.metrics["setup_s"] = run.setup_s
    metrics = {}
    for m in want:
        if run.trace:
            value = registry.metric_reader(m["name"], run.here).read(run)
        else:
            value = run.metrics.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": within_limits(run), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info(run)}
    s = run.tracer.summary
    if s is not None:
        result["device"]["busy_s"] = s.busy_s
        result["device"]["window_s"] = s.window_s
        result["breakdown"] = {"device_ops": s.device_ops,
                               "idle_gaps": s.idle_gaps}
    return result


def within_limits(run: Run, readings: dict | None = None) -> bool:
    """Whether every number the configuration names was compared and is
    within its limit: the run's own numbers, or ``readings`` (a control's)
    held to the run's limits."""
    if readings is None:
        readings = {k: v for k, (v, _) in run.checks.items()}
    return run.failed == 0 \
        and set(readings) == set(run.checks) == set(run.config["checks"]) \
        and all(readings[k] <= lim for k, (_, lim) in run.checks.items())


def device_info(run: Run) -> dict:
    if run.device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(run.cell["chips"]),
            "memory_peak_bytes": int(run.memory_peak)}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernel library builds into build/kernels)."""
    cache = root / "build" / "bench_h100" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv: list[str], t_start: float, root: Path) -> int:
    args = parse_args(argv)
    set_cache_dirs(root)
    if not (root / "src" / "repro_torch").is_dir():
        print(f"[bench] no src/repro_torch under {root}: the program is "
              "missing", file=sys.stderr)
        return 2
    bench = registry.benchmark(root)
    cell = registry.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"[bench] {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    run = make_run(root, args, t_start, "cuda", bench=bench)
    try:
        result = execute(run)
    except RunFailed as e:
        print(f"[bench] FAILED: {e}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"[bench] the process holds {bad} after the window: the "
              "benchmark must not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    result["card"] = card_line()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in run.checks.items()}
    for k, (v, lim) in run.checks.items():
        print(f"[bench] check {k} = {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
