"""Installs of the BLAS configuration side by side, on the card.

    python3 bench_h100/install_spread.py --installs 3 --seed N --seconds S

Each install starts from an empty artifact cache (the checkout's cached
artifact is deleted first), then one run of ``blas3.paper_100mb`` on it.
One JSON line an install: its tile picks on the cell's calls and on
mixtral's grouped shapes (the capacity buckets of the serving mix's
prompts and decode steps), and the run's ``blas_gflop_s``."""

import json
import shutil
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

CELL = "blas3.paper_100mb"
SERVE_CELLS = ("mixtral.prefill_heavy",)


def grouped_shapes(root: Path, bench: dict) -> list[tuple[int, int, int]]:
    from benchlib import registry
    from generators import closed_loop
    from reference import mixtral

    shapes = set()
    for name in SERVE_CELLS:
        cell = registry.cell(bench, name)
        cfg = registry.config(root, bench, cell["config"])
        mix = registry.mix(cell["traffic"])
        d, f = cfg["hidden_size"], cfg["intermediate_size"]
        for n in closed_loop.prompt_lengths(mix) + [mix["slots"]]:
            c = mixtral.capacity(cfg, n)
            shapes.update({(c, d, f), (c, f, d)})
    return sorted(shapes)


def main(argv: list[str]) -> int:
    import argparse

    import torch

    from benchlib import cli, install, registry

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--installs", type=int, default=3)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("[install_spread] needs a CUDA device", file=sys.stderr)
        return 2
    root = HERE.parent
    cli.set_cache_dirs(root)
    bench = registry.benchmark(root)
    cfg = registry.config(root, bench, registry.cell(bench, CELL)["config"])
    spec = registry.install_spec(cfg["install"])
    shapes = grouped_shapes(root, bench)
    for i in range(a.installs):
        shutil.rmtree(install.artifact_dir(root, spec), ignore_errors=True)
        t0 = time.perf_counter()
        args = argparse.Namespace(workload=CELL, seed=a.seed,
                                  seconds=a.seconds, trace=0)
        run = cli.make_run(root, args, time.perf_counter(), "cuda")
        result = cli.execute(run)
        tuner = run.extra["tuner"]
        picks = [tuner.select(*_dims(c), _routine(c[0], tuner)).tile_id
                 for c in run.extra["calls"]]
        grouped = [c.tile_id for c in tuner.select_many(shapes)]
        print(json.dumps({
            "install": i, "installed_now": run.first_setup,
            "seconds": time.perf_counter() - t0,
            "blas_gflop_s": result["metrics"]["blas_gflop_s"]["value"],
            "correct": result["correct"], "picks": picks,
            "grouped_shapes": shapes, "grouped_picks": grouped}),
            flush=True)
        del run, result, tuner
        torch.cuda.empty_cache()
    return 0


def _dims(call):
    from drivers.blas3 import dispatch_dims

    return dispatch_dims(*call)


def _routine(routine, tuner):
    from repro_torch.kernels import ops

    return ops.supported_routine(routine, tuner)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
