"""The result's last line, and the runs that must give none."""

import json
import subprocess
import sys
from pathlib import Path

from benchlib import cli, registry

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def check_schema(result: dict, names: set[str], traced: bool) -> None:
    assert KEYS <= set(result)
    assert isinstance(result["correct"], bool)
    assert set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        for lst in result["breakdown"].values():
            assert len(lst) <= 10
            assert all(isinstance(n, str) and isinstance(s, float)
                       for n, s in lst)
    json.dumps(result)


def test_blas_result(tiny_blas):
    run, res = tiny_blas
    check_schema(res, {"setup_s", "blas_gflop_s"}, traced=False)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(run.checks) == {"gemm_err", "syrk_err", "trsm_err"}


def test_serving_result(tiny_prefill):
    run, res = tiny_prefill
    check_schema(res, {"setup_s", "ttft_p90_ms", "output_tok_s"},
                 traced=False)
    assert res["correct"] and set(run.checks) == {"logit_gap"}
    assert run.extra["sample"] and run.metrics["output_tok_s"] > 0


def test_traced_result_carries_the_cells_layer_metrics():
    from conftest import TINY_MIXTRAL, TINY_SERVE, cpu_run

    run, res = cpu_run("mixtral.prefill_heavy", config=TINY_MIXTRAL,
                       mix=TINY_SERVE, seconds=1.5, trace=True)
    # on the CPU no device metric is read: those need the card's trace
    check_schema(res, {"mfu.prefill", "device_idle.prefill"}, traced=True)
    assert res["device"]["busy_s"] == 0.0
    assert res["device"]["platform"] == "cpu"


def test_main_prints_checks_last(monkeypatch, capsys, tiny_blas):
    run, res = tiny_blas

    class Torch:
        class cuda:
            is_available = staticmethod(lambda: True)
            device_count = staticmethod(lambda: 1)

    monkeypatch.setitem(sys.modules, "torch", Torch)
    monkeypatch.setattr(cli, "make_run", lambda *a, **k: run)
    monkeypatch.setattr(cli, "execute", lambda r: dict(res))
    monkeypatch.setattr(cli, "card_line", lambda: "a card")
    assert cli.main(["--workload", "blas3.paper_100mb", "--seed", "1",
                     "--seconds", "1"], 0.0, ROOT) == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert set(last["checks"]) == set(run.checks)
    tail = err.strip().splitlines()[-len(run.checks):]
    assert all(line.startswith("[bench] check ") and " limit " in line
               for line in tail)


def run_cli(cwd: Path, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(cwd / "bench_h100" / "run.py"),
                           *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_result_without_a_chip():
    import torch

    if torch.cuda.is_available():
        return
    p = run_cli(ROOT, "--workload", "blas3.paper_100mb", "--seed", "3",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_no_result_without_the_program(tmp_path):
    import shutil

    shutil.copytree(HERE, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = run_cli(tmp_path, "--workload", "blas3.paper_100mb", "--seed", "3",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_are_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert {"jax", "repro"} <= set(cli.forbidden_modules())
    assert "repro_torch" not in cli.forbidden_modules()


def test_benchmark_json_names_its_files():
    bench = registry.benchmark(ROOT)
    assert bench["paths"] == ["bench_h100"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1
