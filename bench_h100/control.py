"""The control of a cell, read on the card at the cell's own size.

    python3 bench_h100/control.py --workload NAME --seeds 11,12,13 --seconds S

For each seed, one run of the cell in this process (untraced, a window
of S seconds at the cell's own load), then the control in the program's
place on what that run compared: the plain reference computed in TF32,
the nearest precision below the configuration's float32.  One JSON line
a seed: the program's compared numbers and the control's, and whether
each comes out correct by the run's own rule (the control has to
not).  The
benchmark's own runs never run this."""

import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def main(argv: list[str]) -> int:
    import argparse

    import torch

    from benchlib import cli, registry

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("[control] needs a CUDA device", file=sys.stderr)
        return 2
    cli.set_cache_dirs(HERE.parent)
    for seed in (int(s) for s in a.seeds.split(",")):
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=a.seconds, trace=0)
        run = cli.make_run(HERE.parent, args, time.perf_counter(), "cuda")
        result = cli.execute(run)
        driver = registry.module("drivers", run.config["system"])
        ctrl = driver.control(run)
        print(json.dumps({
            "workload": a.workload, "seed": seed,
            "correct": result["correct"],
            "control_correct": cli.within_limits(run, ctrl),
            "program": {k: v for k, (v, _) in run.checks.items()},
            "control": ctrl,
            "limits": {k: lim for k, (_, lim) in run.checks.items()},
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        }), flush=True)
        del run, result
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
