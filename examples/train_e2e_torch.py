"""End-to-end driver of the PyTorch port: train a ~100M-param LM.

The xlstm-125m architecture at its real width (768), cut to 4 layers,
on a short sequence, through the port's production stack: synthetic
data -> prefetch -> train step (autograd + AdamW) -> fault-tolerant
driver -> checkpoints.  The loss must fall.

Run:  PYTHONPATH=src python examples/train_e2e_torch.py [--steps 200]
      PYTHONPATH=src python examples/train_e2e_torch.py --device cpu \
          --steps 20 --batch 4 --seq 32
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs import build_model, get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.ft.driver import DriverConfig, TrainDriver
from repro_torch.models.params import tree_leaves
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.step import build_train_step, init_train_state


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="/tmp/adsala_train_e2e_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("[e2e] no CUDA device; pass --device cpu to train on "
                 "the CPU")
    dev = torch.device(args.device)

    # the real 125M config, depth cut for wall-clock sanity
    cfg = dataclasses.replace(get_config("xlstm-125m"), n_layers=4)
    model = build_model(cfg)
    # the reference's 20 warmup steps at its 200; a tenth of a shorter run
    opt = AdamWConfig(lr=1e-3, warmup_steps=max(1, min(20, args.steps // 10)),
                      total_steps=args.steps)
    step_fn, _, _ = build_train_step(model, cfg, opt)

    def step(state, batch):
        out = step_fn(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    state = init_train_state(model, cfg, opt,
                             torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"[e2e] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} on {dev}")

    src = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
    prefetch = Prefetcher(iter(src), depth=2)
    data = ({k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for b in prefetch)
    driver = TrainDriver(
        DriverConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50,
                     max_steps=args.steps),
        step, state, data)
    t0 = time.perf_counter()
    try:
        summary = driver.run()
    finally:
        prefetch.close()
    dt = time.perf_counter() - t0
    losses = [float(m["loss"]) for m in driver.metrics_history]
    print(f"[e2e] loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{summary['step']} steps ({dt:.0f}s, "
          f"{summary['step'] / dt:.2f} steps/s)")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training did not learn: loss "
                           f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    print("[e2e] OK — loss decreased; checkpoints in", args.ckpt_dir)
    return {"losses": losses, "summary": summary, "n_params": n_params}


if __name__ == "__main__":
    main()
