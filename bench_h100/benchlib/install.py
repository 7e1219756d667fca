"""The deployment's one-time install, cached in the checkout.

The paper installs once a machine.  A cell's first run in a checkout
pays for the install (timed on the card by the program's measured
backend) and keeps its artifact in a fixed directory,
``build/bench_h100/artifacts/<hash>/``; later runs load it.  The hash
covers the install's settings and the sources of the program's
``core`` and ``kernels`` packages, so a change to either installs
anew."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

#: the program's packages whose sources decide what an install picks
HASHED = ("src/repro_torch/core", "src/repro_torch/kernels")
SUFFIXES = (".py", ".cu", ".cuh")


def artifact_dir(root: Path, spec: dict) -> Path:
    h = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    for rel in HASHED:
        for path in sorted((root / rel).rglob("*")):
            if path.suffix in SUFFIXES and path.is_file():
                h.update(str(path.relative_to(root)).encode())
                h.update(path.read_bytes())
    return root / "build" / "bench_h100" / "artifacts" / h.hexdigest()[:16]


def _backend(spec: dict):
    from repro_torch.core import MeasuredCUDABackend, SimulatedBackend

    b = spec["backend"]
    if b["kind"] == "measured-cuda":
        return MeasuredCUDABackend(repeats=b["repeats"], warmup=b["warmup"],
                                   seed=b.get("seed", 0))
    if b["kind"] == "simulated":
        return SimulatedBackend(seed=b.get("seed", 0))
    raise ValueError(f"unknown install backend {b['kind']!r}")


def install_config(spec: dict):
    """The program's InstallConfig for the settings in ``spec``."""
    from repro_torch.core import ConfigSpace, GemmConfig, InstallConfig

    tiles = tuple(spec["tile_ids"])
    parts = tuple(spec["partitions"])
    return InstallConfig(
        n_samples=spec["n_samples"], repeats=spec["repeats"],
        mem_limit_mb=spec["mem_limit_mb"], dtype_bytes=spec["dtype_bytes"],
        routines=tuple(spec["routines"]), max_chips=spec["max_chips"],
        tile_ids=tiles,
        space=ConfigSpace.default(spec["max_chips"], tiles=tiles,
                                  partitions=parts),
        default_config=GemmConfig(spec["max_chips"], parts[0],
                                  spec["default_tile_id"]),
        models=tuple(spec["models"]), seed=spec["seed"])


def ensure(root: Path, spec: dict) -> tuple[Path, bool]:
    """(the artifact's directory, whether this call installed it)."""
    out = artifact_dir(root, spec)
    if (out / "config.json").is_file():
        return out, False
    from repro_torch.core import install

    partial = out.with_name(out.name + ".partial")
    shutil.rmtree(partial, ignore_errors=True)
    partial.parent.mkdir(parents=True, exist_ok=True)
    install(_backend(spec), install_config(spec), artifact_dir=str(partial))
    os.replace(partial, out)
    return out, True


def load_tuner(root: Path, spec: dict):
    """(the program's tuner on the cached artifact, installed now?).
    No online re-install is armed: the tuner is the artifact's."""
    from repro_torch.core import AdsalaTuner

    path, fresh = ensure(root, spec)
    return AdsalaTuner.from_artifact(str(path)), fresh
