"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --scale smoke --steps 50 --ckpt-dir build/train_ckpt --device cpu

    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train \
        --scale full --device cpu ...

Scales:
  smoke — the reduced config (CPU-sized), one device
  full  — the assigned config at full width and depth, at ``--batch`` x
          ``--seq``: under ``torchrun`` (``WORLD_SIZE`` set) on a mesh of
          the whole world (:func:`launch_mesh`: the reference's
          production mesh on 256 ranks, else (world / tp, tp) over
          ("data", "model")), each rank on its shards; without it on ONE
          card

As ``repro.launch.train``: the step loop runs in the fault-tolerant
driver (checkpoint/restart, preemption handling, straggler detection)
over the prefetching synthetic data pipeline.  Training runs on the
``library`` backend (``train.step.make_ctx``): no CUDA kernel of the
port has a backward.  Runs on ``cuda`` unless ``--device cpu`` is
given; asking for ``cuda`` on a host without a GPU raises.  Weights are
drawn from a seeded ``torch.Generator`` on the device (on a mesh every
rank draws the same and keeps its pieces by the state specs); with
``--resume`` the data stream continues at the restored step, restored
onto the mesh where there is one.  On a mesh rank 0 prints the report
and writes the checkpoints.  Every
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
import torch.distributed as dist

from repro_torch.configs import (
    ARCH_IDS,
    build_model,
    get_config,
    get_smoke_config,
)
from repro_torch.ckpt.checkpoint import latest_step
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, \
    make_global_batch
from repro_torch.dist.collectives import distribute
from repro_torch.ft.driver import DriverConfig, TrainDriver
from repro_torch.launch.serve import resolve_device
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.params import is_spec, tree_leaves, tree_map
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


def mesh_shape(world: int) -> tuple[int, int]:
    """The ("data", "model") shape a ``world``-rank mesh takes: tp from
    ``ADSALA_TP`` (as the reference's production mesh takes it), by
    default min(16, world), and world / tp data ranks; raises where tp
    does not divide the world."""
    tp = int(os.environ.get("ADSALA_TP", str(min(16, world))))
    if tp < 1 or world % tp:
        raise ValueError(f"ADSALA_TP={tp} does not divide the world of "
                         f"{world} ranks")
    return world // tp, tp


def launch_mesh(args: argparse.Namespace):
    """The mesh ``run`` trains on, or None: under ``torchrun``
    (``WORLD_SIZE`` set) at ``--scale full``, the process group (nccl on
    ``cuda``, each rank on the card of its ``LOCAL_RANK``; gloo on
    ``cpu``; initialised here from torchrun's environment unless it is
    already) and over it the reference's production mesh on 256 ranks,
    else :func:`mesh_shape`'s.  Whether a process group exists does not
    decide it: only ``WORLD_SIZE`` does."""
    world = os.environ.get("WORLD_SIZE")
    if args.scale != "full" or world is None:
        return None
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    world = int(world)
    shape = mesh_shape(world)
    dev = resolve_device(args.device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if world == 256:
        return make_production_mesh(device_type=dev.type)
    return make_mesh(shape, ("data", "model"), device_type=dev.type)


def run(argv: list[str] | None = None) -> TrainResult:
    """Parse ``argv``, train (on :func:`launch_mesh`'s mesh where there
    is one), print the report."""
    args = parse_args(argv)
    cfg = (get_config if args.scale == "full"
           else get_smoke_config)(args.arch)
    return train_config(cfg, args, mesh=launch_mesh(args))


def train_config(cfg: ArchConfig, args: argparse.Namespace,
                 mesh=None) -> TrainResult:
    """Train ``cfg`` with the options of ``args`` (as :func:`parse_args`
    makes them; ``--arch`` and ``--scale`` are not read) and print the
    report.  With ``mesh`` (a torch ``DeviceMesh`` over ("data",
    "model"), which the caller holds) as the reference does with its
    mesh: the sharded step of ``--batch`` x ``--seq``
    (``build_train_step(..., shape=, mesh=)``), the state laid out by
    its specs, each batch by ``make_global_batch`` and the driver
    restoring onto the mesh; rank 0 prints and writes."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    say = print if mesh is None or dist.get_rank() == 0 else \
        (lambda *a, **k: None)

    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps,
                          compress=args.compress_grads)
    shape = None if mesh is None else \
        ShapeSpec("custom", args.seq, args.batch, "train")
    step_fn, s_specs, b_specs = build_train_step(model, cfg, opt_cfg,
                                                 shape=shape, mesh=mesh)

    def timed_step(state, batch):
        # the driver times the call: let it end when the device does
        out = step_fn(state, batch)
        _sync(dev)
        return out

    state = init_train_state(model, cfg, opt_cfg,
                             torch.Generator(device=dev).manual_seed(0))
    if mesh is not None:
        # every rank drew the same state: each keeps its pieces
        specs = iter(tree_leaves(s_specs, is_leaf=is_spec))
        state = tree_map(lambda t: distribute(t, mesh, next(specs)), state)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    say(f"[train] {cfg.name} layers={cfg.n_layers} params={n_params:,} "
        f"batch={args.batch}x{args.seq} device={dev}"
        + ("" if mesh is None else
           f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"))

    start = (latest_step(args.ckpt_dir) or 0) if args.resume else 0
    data_src = SyntheticLM(
        cfg.vocab, args.seq, args.batch,
        audio_dim=cfg.d_model if cfg.family == "audio" else None,
        audio_len=cfg.encoder_len)
    prefetch = Prefetcher((data_src.batch_at(s)
                           for s in itertools.count(start)), depth=2)
    data = (make_global_batch(b, mesh, b_specs, device=dev)
            for b in prefetch)
    driver = TrainDriver(
        DriverConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     max_steps=args.steps),
        timed_step, state, data, mesh=mesh, specs=s_specs)
    del state
    resumed = None
    if args.resume:
        resumed = driver.maybe_resume()
        say(f"[train] resumed from step {resumed}")

    t0 = time.perf_counter()
    try:
        summary = driver.run()
    finally:
        prefetch.close()
    wall = time.perf_counter() - t0
    if mesh is not None:
        # rank 0 wrote the final checkpoint: the others wait for it
        dist.barrier()
    losses = [m["loss"] for m in driver.metrics_history]
    final = os.path.join(args.ckpt_dir, f"step_{summary['step']:08d}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(final, f))
                     for f in os.listdir(final))
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    say(f"[train] done: step={summary['step']} "
        f"loss={summary['last_metrics'].get('loss', float('nan')):.4f} "
        f"wall={wall:.1f}s stragglers={len(summary['stragglers'])}")
    say(f"[train] final checkpoint {ckpt_bytes / 1e9:.3f} GB in "
        f"{driver.final_ckpt_s:.1f}s"
        + (f"; peak device memory {peak:.2f} GiB" if peak else ""))
    return TrainResult(cfg=cfg, model=model, driver=driver,
                       summary=summary, resumed_from=resumed,
                       n_params=n_params, losses=losses, wall_s=wall,
                       peak_gib=peak, ckpt_bytes=ckpt_bytes,
                       ckpt_s=driver.final_ckpt_s)


def main(argv: list[str] | None = None) -> None:
    try:
        run(argv)
    finally:
        if os.environ.get("WORLD_SIZE") is not None \
                and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
