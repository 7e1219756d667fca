"""Everything a cell needs, found by the names in ``BENCHMARK.json``.

* a configuration: the JSON file its ``configs`` entry names; its
  ``system`` key names the module that runs it (``drivers/<system>.py``), its
  ``reference`` key the plain reference (``reference/<name>.py``) and
  its ``install`` key the install settings
  (``installs/<install>.json``);
* a traffic mix: ``traffic/<traffic>.json``; its ``generator`` key names
  the general generator that reads it (``generators/<generator>.py``);
* a per-layer metric: ``metrics/<metric>.py``, whose ``read(run)``
  returns the number or None when it finds nothing to read; where that
  file is missing, ``metrics/<quantity>.py`` for a metric named
  ``<quantity>.<part>``, so one reader serves every cell's split of one
  quantity (``device_idle.blas``, ``device_idle.prefill``).

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries, and edits none of these."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(root: Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def install_spec(name: str, here: Path = HERE) -> dict:
    return load_json(here / "installs" / f"{name}.json")


def module(kind: str, name: str):
    """``drivers``, ``generators`` or ``reference`` module ``name``."""
    if kind not in ("drivers", "generators", "reference"):
        raise ValueError(kind)
    return importlib.import_module(f"{kind}.{name}")


def metric_reader(name: str, here: Path = HERE):
    """The reader module of per-layer metric ``name``."""
    path = here / "metrics" / f"{name}.py"
    if not path.is_file():
        path = here / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(bench: dict, workload: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(bench: dict, workload: str) -> list[dict]:
    """The cell's per-layer metrics: those that list it, and those with
    no list that move an end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
