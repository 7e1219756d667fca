"""A configuration, a traffic mix, a cell and a per-layer metric added as
files and entries only: the harness finds each by name, and no file it
had changes."""

import hashlib
import json
import shutil
from pathlib import Path

from conftest import CPU_INSTALL, TINY_BLAS, cpu_run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(folder.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


def test_cell_added_by_files_only(tmp_path):
    from benchlib import registry

    # a checkout: the benchmark's files and the program, side by side
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digest(root / "bench_h100")
    here = root / "bench_h100"

    # the new files
    cfg = registry.load_json(here / "configs" / "blas3-fp32-100mb.json")
    cfg["about"] = "the same deployment under another name"
    (here / "configs" / "blas3-twin.json").write_text(json.dumps(cfg))
    mix = dict(registry.mix("paper_mix_100mb", here), **TINY_BLAS,
               shape_seed=3)
    (here / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (here / "metrics" / "calls.blas-twin.py").write_text(
        '"""Calls the window made."""\n\n\ndef read(run):\n'
        '    return run.attempted\n')
    # the new entries
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="blas3-twin",
                                 file="bench_h100/configs/blas3-twin.json"))
    bench["workloads"].append({"name": "blas3.twin", "config": "blas3-twin",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "a twin"})
    for m in bench["end_to_end"]:
        if m["name"] == "blas_gflop_s":
            m["workloads"].append("blas3.twin")
    bench["per_layer"].append({
        "name": "calls.blas-twin", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "tuner",
        "moves": "blas_gflop_s", "workloads": ["blas3.twin"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digest(here)
    assert {k: v for k, v in after.items() if k in before} == before

    assert registry.cell(bench, "blas3.twin")["traffic"] == "tiny_mix"
    assert registry.config(root, bench, "blas3-twin")["about"] \
        .startswith("the same")
    assert registry.mix("tiny_mix", here)["shape_seed"] == 3
    assert [m["name"] for m in registry.per_layer(bench, "blas3.twin")] \
        == ["calls.blas-twin"]
    assert registry.metric_reader("calls.blas-twin", here).read(
        type("R", (), {"attempted": 7})()) == 7

    # and the run finds them all by name
    run, res = cpu_run("blas3.twin", root=root, trace=True)
    assert res["metrics"]["calls.blas-twin"]["value"] == run.attempted > 0
    run, res = cpu_run("blas3.twin", root=root)
    assert set(res["metrics"]) == {"setup_s", "blas_gflop_s"}
    assert CPU_INSTALL["backend"]["kind"] == "simulated"


def test_metrics_of_a_cell_follow_the_entries():
    from benchlib import registry

    bench = registry.benchmark(ROOT)
    names = {w["name"] for w in bench["workloads"]}
    for w in names:
        e2e = {m["name"] for m in registry.end_to_end(bench, w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = registry.per_layer(bench, w)
        assert layer and all(m["moves"] in e2e for m in layer)
    for m in bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]).read)


def test_one_reader_serves_a_quantitys_splits():
    from benchlib import registry

    a = registry.metric_reader("device_idle.blas")
    b = registry.metric_reader("device_idle.prefill")
    assert a.__file__ == b.__file__
    assert a.__file__.endswith("metrics/device_idle.py")
    # every reader loads, also those no cell lists yet
    for path in sorted((HERE / "metrics").glob("*.py")):
        assert callable(registry.metric_reader(path.stem).read)
    # a file of the metric's own name comes first
    assert registry.metric_reader("tuner.speedup_vs_default").__file__ \
        .endswith("tuner.speedup_vs_default.py")
