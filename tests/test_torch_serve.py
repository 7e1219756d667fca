"""The port's serving entry point on the CPU, and its independence from
jax and from the reference package.

* ``python -m repro_torch.launch.serve --device cpu --scale smoke`` with
  a tiny artifact, in a subprocess where ``import jax`` fails;
* an AST scan of every module of ``repro_torch`` (and ``chip_smoke.py``)
  for imports of jax or repro;
* an import of every module with ``sys.modules["jax"] = None`` and
  ``sys.modules["repro"] = None``.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")

_BLOCK = "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def port_artifact(tmp_path_factory):
    from repro_torch.core import InstallConfig, SimulatedBackend, install

    d = tmp_path_factory.mktemp("port_artifact")
    cfg = InstallConfig(n_samples=48, repeats=2, tile_ids=(0, 3),
                        models=("linear_regression",),
                        routines=("gemm", "attn"), grid_budget="small",
                        cv_splits=3, seed=0)
    install(SimulatedBackend(seed=0), cfg, artifact_dir=str(d))
    return str(d)


def test_serve_cli_runs_on_cpu_without_jax(port_artifact, tmp_path):
    prof = tmp_path / "profile.json"
    code = _BLOCK + textwrap.dedent("""
        import runpy
        sys.argv = ["serve"] + sys.argv[1:]
        runpy.run_module("repro_torch.launch.serve", run_name="__main__")
        """)
    res = subprocess.run(
        [sys.executable, "-c", code, "--device", "cpu", "--scale", "smoke",
         "--requests", "2", "--prompt-len", "8", "--gen-tokens", "3",
         "--artifact", port_artifact, "--profile-out", str(prof)],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert f"ADSALA tuner loaded from {port_artifact}" in out
    assert "stablelm-1.6b: 2 requests, prefill 8 toks" in out
    assert "dispatch routine mix (by events): attn=" in out
    assert "tuner stats:" in out
    assert prof.is_file()


def test_serve_run_reports_and_records(port_artifact):
    from repro_torch.launch import serve

    res = serve.run(["--device", "cpu", "--requests", "2", "--prompt-len",
                     "8", "--gen-tokens", "3", "--artifact", port_artifact])
    assert tuple(res.tokens.shape) == (2, 3)
    assert torch.isfinite(res.prefill_logits).all()
    prefill = {e.site for e in res.recs["prefill"].events}
    assert {"attn.core", "attn.qkv_proj", "mlp.in_proj"} <= prefill
    attn = [e for e in res.recs["prefill"].events if e.site == "attn.core"]
    assert len(attn) == res.cfg.n_layers
    assert {(e.routine, e.m, e.k, e.n, e.count) for e in attn} == {
        ("attn", 8, res.cfg.resolved_head_dim, 8, 2 * res.cfg.n_heads)}
    assert all(e.config is not None for e in attn)
    # decode records one step (the reference records its traced step)
    sites = [e.site for e in res.recs["decode"].events]
    assert sites.count("attn.cache_update") == res.cfg.n_layers


def test_serve_config_serves_a_depth_cut_moe_config(port_artifact, capsys):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.moe import MoESpec

    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                              n_layers=1)
    args = serve.parse_args(["--device", "cpu", "--requests", "2",
                             "--prompt-len", "40", "--gen-tokens", "3",
                             "--artifact", port_artifact])
    res = serve.serve_config(cfg, args)
    assert res.cfg is cfg and tuple(res.tokens.shape) == (2, 3)
    assert torch.isfinite(res.prefill_logits).all()
    cap = MoESpec(cfg.d_model, cfg.n_experts, cfg.top_k,
                  cfg.d_ff_expert).capacity(80)
    out = capsys.readouterr().out
    assert f"tuner GEMM {cap}x{cfg.d_model}x{cfg.d_ff_expert} ->" in out
    assert "mixtral-8x22b: 2 requests, prefill 40 toks" in out
    for phase in ("prefill", "decode"):
        sites = [e.site for e in res.recs[phase].events]
        for site in ("moe.wi", "moe.wg", "moe.wo"):
            assert sites.count(site) == cfg.n_experts


def test_cuda_device_without_gpu_raises():
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(["--device", "cuda", "--requests", "1",
                   "--prompt-len", "4", "--gen-tokens", "2"])


def _py_files():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_module_imports_jax_or_repro():
    bad = []
    n = 0
    for path in _py_files():
        n += 1
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "flax"):
                    bad.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert n > 30
    assert not bad, bad


def test_every_module_imports_with_jax_and_repro_blocked():
    code = _BLOCK + textwrap.dedent("""
        import importlib, pkgutil
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        print(len(names))
        """)
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 30
