#!/usr/bin/env python3
"""Trace the port's whole dry-run grid (every arch x shape x mesh) in
parallel processes and print one summary row per cell.

    python3 scripts/dryrun_grid.py [--device cuda] [--jobs N] [--out DIR]
        [--summary FILE]

Runs ``python -m repro_torch.launch.dryrun --device DEVICE --mesh MESH
--arch ARCH --out DIR`` once per (arch, mesh), ``--jobs`` at a time (a
fake world is global to its process): the same cells as ``--all --mesh
both`` in one process.  Each process has ``--timeout`` seconds.  Then
each record in DIR is read back: status, trace seconds, peak GiB a
rank, FLOPs a rank against ``step_flops / n_devices``, collective
bytes a rank by kind, ``roofline_for_cell``'s terms and the kernel ops
traced; the rows go
to stdout and, as JSON, to ``--summary``.  Exits non-zero
unless every cell has a record and none is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def run_one(arch: str, mesh: str, args) -> tuple[str, str, int, float, str]:
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
           args.device, "--mesh", mesh, "--arch", arch, "--out", args.out]
    try:
        proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                              text=True, timeout=args.timeout)
        rc, log = proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as e:
        rc = 124
        log = (e.stdout or b"").decode() if isinstance(e.stdout, bytes) \
            else (e.stdout or "")
        log += f"\n[dryrun_grid] timed out after {args.timeout}s"
    return arch, mesh, rc, time.perf_counter() - t0, log


def summarise(rec: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES
    from repro_torch.roofline import roofline_for_cell, step_flops

    row = {k: rec.get(k) for k in ("arch", "shape", "mesh", "status")}
    if rec["status"] != "ok":
        row["reason"] = rec.get("reason", rec.get("error"))
        return row
    cfg, shape = get_config(rec["arch"]), SHAPES[rec["shape"]]
    terms = roofline_for_cell(cfg, shape, rec["mesh"], rec)
    ref = step_flops(cfg, shape) / rec["n_devices"]
    flops = rec["cost"]["flops_per_device"]
    row.update({"trace_s": rec["lower_s"],
                "peak_gib": rec["memory"]["peak_bytes"] / 2 ** 30,
                "flops_per_device": flops, "flops_ratio": flops / ref,
                "collective_bytes": {k: v["bytes"] for k, v in
                                     rec["collectives"].items() if v["count"]},
                "compute_s": terms.compute_s, "memory_s": terms.memory_s,
                "collective_s": terms.collective_s,
                "dominant": terms.dominant,
                "kernel_ops": rec["kernel_ops"]})
    return row


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--timeout", type=float, default=1800,
                    help="seconds for each (arch, mesh) process")
    ap.add_argument("--summary", default=None,
                    help="write the rows as JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.config import SHAPES

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("*.json"):
        old.unlink()
    jobs = [(arch, mesh) for mesh in ("single", "multi")
            for arch in ARCH_IDS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        done = [f.result() for f in [pool.submit(run_one, a, m, args)
                                     for a, m in jobs]]
    wall = time.perf_counter() - t0
    for arch, mesh, rc, secs, log in done:
        print(f"[dryrun_grid] {arch} x {mesh}: rc {rc} in {secs:.1f}s")
        for line in log.splitlines():
            print(f"[dryrun_grid]   {line}")
    rows, missing = [], []
    for mesh in ("single", "multi"):
        for arch in ARCH_IDS:
            for shape in SHAPES:
                path = out / f"{arch}_{shape}_{mesh}.json"
                if not path.exists():
                    missing.append(path.name)
                    continue
                rows.append(summarise(json.loads(path.read_text())))
    for r in rows:
        if r["status"] == "ok":
            print(f"[dryrun_grid] {r['arch']} x {r['shape']} x {r['mesh']}:"
                  f" trace {r['trace_s']} s, peak {r['peak_gib']:.1f} GiB "
                  f"a rank, FLOPs x{r['flops_ratio']:.2f} of step_flops / "
                  f"n_devices, collective GB a rank "
                  + str({k: round(v / 1e9, 3) for k, v in
                         r["collective_bytes"].items()})
                  + f", {r['dominant']}-bound (compute "
                  f"{r['compute_s']:.4e} s, memory {r['memory_s']:.4e} s, "
                  f"collective {r['collective_s']:.4e} s), kernel ops "
                  f"{r['kernel_ops']}")
        else:
            print(f"[dryrun_grid] {r['arch']} x {r['shape']} x {r['mesh']}:"
                  f" {r['status']} ({r['reason']})")
    counts = {s: sum(r["status"] == s for r in rows)
              for s in ("ok", "skipped", "error")}
    summary = {"device": args.device, "jobs": args.jobs, "wall_s": wall,
               "records": len(rows), "missing": missing, **counts,
               "process_s": {f"{a}/{m}": s for a, m, _, s, _ in done},
               "cells": rows}
    if args.summary:
        Path(args.summary).write_text(json.dumps(summary, indent=1))
    print(f"[dryrun_grid] {len(rows)} of {len(jobs) * len(SHAPES)} records"
          f" ({counts}), {len(missing)} missing, {wall:.1f}s with "
          f"{args.jobs} processes")
    bad = missing or counts["error"] or any(rc for _, _, rc, _, _ in done)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
