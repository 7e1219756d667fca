"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --scale smoke --steps 50 --ckpt-dir build/train_ckpt --device cpu

Scales:
  smoke — the reduced config (CPU-sized)
  full  — the assigned config at full width and depth on ONE card, at
          ``--batch`` x ``--seq`` (the reference trains it on its
          production mesh; the port's mesh step is
          ``train.step.build_train_step(..., shape=, mesh=)``)

As ``repro.launch.train``: the step loop runs in the fault-tolerant
driver (checkpoint/restart, preemption handling, straggler detection)
over the prefetching synthetic data pipeline.  Training runs on the
``library`` backend (``train.step.make_ctx``): no CUDA kernel of the
port has a backward.  Runs on ``cuda`` unless ``--device cpu`` is
given; asking for ``cuda`` on a host without a GPU raises.  Weights are
drawn from a seeded ``torch.Generator`` on the device; with
``--resume`` the data stream continues at the restored step.  Every
family trains: the encoder-decoder's batches carry the frontend stub's
frame embeddings ``audio_emb`` (B, encoder_len, d_model) beside the
tokens, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import time
from typing import Any

import torch

from repro_torch.configs import (
    ARCH_IDS,
    build_model,
    get_config,
    get_smoke_config,
)
from repro_torch.ckpt.checkpoint import latest_step
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.ft.driver import DriverConfig, TrainDriver
from repro_torch.launch.serve import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import tree_leaves
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.step import build_train_step, init_train_state


@dataclasses.dataclass
class TrainResult:
    """What one run produced, for callers that check it."""
    cfg: Any
    model: Any
    driver: TrainDriver            # .state, .metrics_history, .step_times
    summary: dict                  # TrainDriver.run's summary
    resumed_from: int | None       # the restored step (--resume)
    n_params: int
    losses: list                   # per step run
    wall_s: float
    #: peak device memory over the run (GiB; None off the card)
    peak_gib: float | None
    #: the final synchronous checkpoint: bytes on disk and seconds
    ckpt_bytes: int
    ckpt_s: float


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=ARCH_IDS)
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join("build",
                                                       "train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv: list[str] | None = None) -> TrainResult:
    """Parse ``argv``, train, print the report."""
    args = parse_args(argv)
    cfg = (get_config if args.scale == "full"
           else get_smoke_config)(args.arch)
    return train_config(cfg, args)


def train_config(cfg: ArchConfig, args: argparse.Namespace) -> TrainResult:
    """Train ``cfg`` with the options of ``args`` (as :func:`parse_args`
    makes them; ``--arch`` and ``--scale`` are not read) and print the
    report."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps,
                          compress=args.compress_grads)
    step_fn, _, _ = build_train_step(model, cfg, opt_cfg)

    def timed_step(state, batch):
        # the driver times the call: let it end when the device does
        out = step_fn(state, batch)
        _sync(dev)
        return out

    state = init_train_state(model, cfg, opt_cfg,
                             torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"[train] {cfg.name} layers={cfg.n_layers} params={n_params:,} "
          f"batch={args.batch}x{args.seq} device={dev}")

    start = (latest_step(args.ckpt_dir) or 0) if args.resume else 0
    data_src = SyntheticLM(
        cfg.vocab, args.seq, args.batch,
        audio_dim=cfg.d_model if cfg.family == "audio" else None,
        audio_len=cfg.encoder_len)
    prefetch = Prefetcher((data_src.batch_at(s)
                           for s in itertools.count(start)), depth=2)
    data = ({k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for b in prefetch)
    driver = TrainDriver(
        DriverConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     max_steps=args.steps),
        timed_step, state, data)
    del state
    resumed = None
    if args.resume:
        resumed = driver.maybe_resume()
        print(f"[train] resumed from step {resumed}")

    t0 = time.perf_counter()
    try:
        summary = driver.run()
    finally:
        prefetch.close()
    wall = time.perf_counter() - t0
    losses = [m["loss"] for m in driver.metrics_history]
    final = os.path.join(args.ckpt_dir, f"step_{summary['step']:08d}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(final, f))
                     for f in os.listdir(final))
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    print(f"[train] done: step={summary['step']} "
          f"loss={summary['last_metrics'].get('loss', float('nan')):.4f} "
          f"wall={wall:.1f}s stragglers={len(summary['stragglers'])}")
    print(f"[train] final checkpoint {ckpt_bytes / 1e9:.3f} GB in "
          f"{driver.final_ckpt_s:.1f}s"
          + (f"; peak device memory {peak:.2f} GiB" if peak else ""))
    return TrainResult(cfg=cfg, model=model, driver=driver,
                       summary=summary, resumed_from=resumed,
                       n_params=n_params, losses=losses, wall_s=wall,
                       peak_gib=peak, ckpt_bytes=ckpt_bytes,
                       ckpt_s=driver.final_ckpt_s)


def main(argv: list[str] | None = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
