"""Helpers of the benchmark's CPU tests: the harness's own folder on the
path, and a run of a cell at a tiny size on the CPU (the harness's look
for a chip skipped, the rest of the run driven as on the card).

Run them from the repository's root:
``PYTHONPATH=src python -m pytest bench_h100/tests -q``."""

import argparse
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a cheap install on the simulated backend, for runs on the CPU
CPU_INSTALL = {"n_samples": 24, "models": ["linear_regression"],
               "backend": {"kind": "simulated", "seed": 0}}

#: mixtral at a size the CPU runs in seconds
TINY_MIXTRAL = {"hidden_size": 64, "intermediate_size": 128,
                "num_attention_heads": 4, "num_key_value_heads": 2,
                "num_hidden_layers": 2, "num_local_experts": 4,
                "vocab_size": 256}
TINY_SERVE = {"clients": 2, "slots": 2, "max_seq_len": 64, "warm_s": 0.2,
              "prompt": {"dist": "uniform", "lo": 16, "hi": 40},
              "answer": {"dist": "uniform", "lo": 4, "hi": 20},
              "distinct_prompts": 4, "pool": 8, "check_requests": 4}
TINY_BLAS = {"calls_per_routine": 3, "mem_limit_mb": 0.5, "dim_max": 256}


def cpu_run(workload: str, *, config: dict | None = None,
            mix: dict | None = None, seed: int = 2 ** 31 + 11,
            seconds: float = 1.0, trace: bool = False, root: Path = ROOT):
    """(run, result) of one cell on the CPU, with the cell's configuration
    and mix updated by ``config`` and ``mix``."""
    from benchlib import cli, registry

    t0 = time.perf_counter()
    bench = registry.benchmark(root)
    cell = registry.cell(bench, workload)
    cfg = dict(registry.config(root, bench, cell["config"]), **(config or {}))
    mx = dict(registry.mix(cell["traffic"], root / HERE.name), **(mix or {}))
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=int(trace))
    run = cli.make_run(root, args, t0, "cpu", bench=bench, config=cfg,
                       mix=mx)
    run.extra["install_spec"] = dict(
        registry.install_spec(cfg["install"], run.here), **CPU_INSTALL)
    return run, cli.execute(run)


@pytest.fixture(scope="session")
def tiny_blas():
    return cpu_run("blas3.paper_100mb", mix=TINY_BLAS)


@pytest.fixture(scope="session")
def tiny_prefill():
    return cpu_run("mixtral.prefill_heavy", config=TINY_MIXTRAL,
                   mix=TINY_SERVE, seconds=2.0)
