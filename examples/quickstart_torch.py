"""Quickstart of the PyTorch port: the ADSALA workflow on one GPU.

1. install  — time the port's GEMM kernel on the card
              (``MeasuredCUDABackend``), train + select the runtime model
              (paper Fig 2),
2. runtime  — load the artifact, let the tuner pick worker configs
              (paper Fig 3),
3. verify   — tuned tiles against the default tile, both timed through
              ``ops.matmul`` on the GEMM kernel.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      PYTHONPATH=src python examples/quickstart_torch.py \
          --backend simulated --device cpu

The second form is the reference quickstart's flow (``examples/
quickstart.py``) on the CPU: the simulated TPU-v5e platform, whose
picks the port's verbatim ``core`` reproduces.  The card's install times
fp32 GEMMs within 100 MB on one device (the default config: partition M,
tile 3).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import (
    AdsalaTuner,
    ConfigSpace,
    GemmConfig,
    InstallConfig,
    MeasuredCUDABackend,
    SimulatedBackend,
    gather_data,
    install,
)

#: the reference quickstart's runtime shapes
SHAPES = [(64, 2048, 64), (64, 64, 4096), (512, 512, 512),
          (8192, 8192, 8192), (30000, 200, 30000)]
MODELS = ("linear_regression", "bayesian_regression", "decision_tree",
          "xgboost")
#: the card's install: fp32 GEMMs within this many MB, these tiles
MEM_LIMIT_MB = 100
TILES = (0, 1, 3, 5)


def install_config(backend: str, samples: int, seed: int) -> InstallConfig:
    if backend == "simulated":
        return InstallConfig(
            n_samples=samples, repeats=2, tile_ids=(0, 3), models=MODELS,
            grid_budget="small", cv_splits=3, seed=seed)
    return InstallConfig(
        n_samples=samples, repeats=1, mem_limit_mb=MEM_LIMIT_MB,
        dtype_bytes=4, max_chips=1, tile_ids=TILES,
        space=ConfigSpace.default(1, tiles=TILES, partitions=("M",)),
        default_config=GemmConfig(1, "M", 3), models=MODELS,
        grid_budget="small", cv_splits=3, seed=seed)


def _time_matmul(a, b, tile, iters: int = 5) -> float:
    """ms of one ``ops.matmul`` call on the kernel (CUDA events)."""
    from repro_torch.kernels import ops

    ops.matmul(a, b, tile=tile)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        ops.matmul(a, b, tile=tile)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="measured",
                    choices=["measured", "simulated"],
                    help="'measured' (the default) times the GEMM kernel "
                         "on the card; 'simulated' is the reference's "
                         "analytic TPU-v5e platform")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--artifact", default="/tmp/adsala_quickstart_torch")
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("[quickstart] no CUDA device; pass --backend simulated "
                 "--device cpu to run on the CPU")
    if args.backend == "measured" and args.device != "cuda":
        sys.exit("[quickstart] the measured backend times the card: "
                 "--device cuda")

    # -- 1. installation (small budget for the demo) -----------------------
    cfg = install_config(args.backend, args.samples, args.seed)
    backend = (SimulatedBackend(seed=args.seed)
               if args.backend == "simulated"
               else MeasuredCUDABackend(repeats=3, warmup=1))
    print(f"== install: {args.samples} samples on the {args.backend} "
          "backend ==")
    data = gather_data(backend, cfg)
    report = install(backend, cfg, data=data, artifact_dir=args.artifact)
    print(report.table())

    # -- 2. runtime ----------------------------------------------------------
    print("\n== runtime: tuner decisions ==")
    tuner = AdsalaTuner.from_artifact(args.artifact)
    picks = {}
    for (m, k, n) in SHAPES:
        c = tuner.select(m, k, n)
        picks[(m, k, n)] = c
        print(f"GEMM {m:>6}x{k:>6}x{n:>6} -> {c.n_chips:>3} chips, "
              f"partition {c.partition:>2}, tile {c.tile}")

    # -- 3. verify ------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    t_def = t_tuned = 0.0
    if args.backend == "simulated":
        for _ in range(30):
            m, k, n = (int(x) for x in rng.integers(64, 8192, 3))
            t_tuned += backend.time_gemm_clean(m, k, n,
                                               tuner.select(m, k, n))
            t_def += backend.time_gemm_clean(m, k, n, cfg.default_config)
        what = "all-512-chips default (simulated)"
    else:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        default = cfg.default_config.tile
        for _ in range(30):
            m, k, n = (int(x) for x in rng.integers(64, 4096, 3))
            a = torch.randn((m, k), generator=gen, device="cuda")
            b = torch.randn((k, n), generator=gen, device="cuda")
            t_tuned += _time_matmul(a, b, tuner.select(m, k, n).tile)
            t_def += _time_matmul(a, b, default)
        what = (f"default tile {default} on "
                f"{torch.cuda.get_device_name(0)} (CUDA events)")
    speedup = t_def / t_tuned
    print(f"\naggregate speedup vs {what}: {speedup:.2f}x")
    print(f"tuner stats: {tuner.stats}")
    return {"picks": picks, "speedup": speedup, "selected": report.selected}


if __name__ == "__main__":
    main()
