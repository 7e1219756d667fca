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


def test_serve_deepseek_fixed_batch_and_queue(port_artifact, capsys):
    """deepseek-v2 (MLA, a dense first layer, shared experts) through
    the launcher: a fixed batch, then a ragged queue over latent page
    pools."""
    from repro_torch.launch import serve
    from repro_torch.models.mla import MLACache
    from repro_torch.serve.kv_cache import PagedLatent

    base = ["--arch", "deepseek-v2-236b", "--scale", "smoke", "--device",
            "cpu", "--artifact", port_artifact]
    res = serve.run(base + ["--requests", "2", "--prompt-len", "8",
                            "--gen-tokens", "3"])
    assert tuple(res.tokens.shape) == (2, 3)
    assert torch.isfinite(res.prefill_logits).all()
    assert "deepseek-v2-236b: 2 requests, prefill 8 toks" in \
        capsys.readouterr().out
    cfg = res.cfg
    # the artifact covers gemm and attn only: the syrk-tagged scores
    # degrade to gemm, as in the reference
    qk = [e for e in res.recs["prefill"].events if e.site == "mla.qk"]
    assert [(e.routine, e.m, e.n, e.count) for e in qk] == \
        [("gemm", 8, 8, 2 * cfg.n_heads)] * cfg.n_layers
    sites = [e.site for e in res.recs["decode"].events]
    assert sites.count("mla.cache_update") == cfg.n_layers
    assert sites.count("moe.wi") == cfg.n_experts * (cfg.n_layers - 1)
    _, cache = res.model.prefill(res.params, res.prompts[:1], serve.make_ctx(
        "prefill", cache_len=11))
    assert all(isinstance(c, MLACache) for c in cache)

    q = serve.run(base + ["--queue", "--requests", "4", "--prompt-len",
                          "10", "--gen-tokens", "4", "--slots", "2",
                          "--page-size", "4"])
    assert isinstance(q, serve.QueueResult)
    assert all(isinstance(p, PagedLatent) for p in q.sched.pool)
    assert len(q.sched.finished) == 4
    q.sched.alloc.check()
    assert q.sched.alloc.live_pages == 0
    assert "4 requests via continuous batching" in capsys.readouterr().out


def test_serve_deepseek_queue_cli_runs_on_cpu_without_jax():
    code = _BLOCK + textwrap.dedent("""
        import runpy
        sys.argv = ["serve"] + sys.argv[1:]
        runpy.run_module("repro_torch.launch.serve", run_name="__main__")
        """)
    res = subprocess.run(
        [sys.executable, "-c", code, "--arch", "deepseek-v2-236b",
         "--device", "cpu", "--scale", "smoke", "--queue", "--requests",
         "3", "--prompt-len", "8", "--gen-tokens", "4", "--slots", "2",
         "--page-size", "4"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "deepseek-v2-236b: 3 requests via continuous batching" in \
        res.stdout


def test_serve_int8_kv_cache_from_the_environment(monkeypatch):
    """ADSALA_KV_INT8=1 reaches make_ctx: the fixed batch serves on int8
    caches, and the queue refuses as the reference does (no paged int8
    cache)."""
    from repro_torch.launch import serve

    made = []

    def spy(*a, **kw):
        ctx = serve_make_ctx(*a, **kw)
        made.append(ctx)
        return ctx

    serve_make_ctx = serve.make_ctx
    monkeypatch.setattr(serve, "make_ctx", spy)
    monkeypatch.setenv("ADSALA_KV_INT8", "1")
    argv = ["--device", "cpu", "--requests", "2", "--prompt-len", "8",
            "--gen-tokens", "3"]
    res = serve.run(argv)
    assert tuple(res.tokens.shape) == (2, 3)
    assert torch.isfinite(res.prefill_logits).all()
    assert [c.mode for c in made] == ["prefill", "decode"]
    assert all(c.kv_quantized for c in made)
    _, cache = res.model.prefill(res.params, res.prompts, made[0])
    assert all(c.quantized and c.k.dtype == torch.int8 for c in cache)
    with pytest.raises(NotImplementedError,
                       match="paged decode with int8 KV cache"):
        serve.run(argv + ["--queue"])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m",
                                  "whisper-tiny", "chameleon-34b"])
def test_serve_runs_the_remaining_families_on_cpu(arch, capsys):
    """The four families of the last model slice through the launcher at
    smoke scale; whisper's prefill takes its seeded frame embeddings
    (recurrentgemma's 40-token prompt passes its window of 32)."""
    from repro_torch.launch import serve
    from repro_torch.train.step import make_ctx

    res = serve.run(["--arch", arch, "--scale", "smoke", "--device", "cpu",
                     "--requests", "2", "--prompt-len", "40",
                     "--gen-tokens", "4"])
    assert tuple(res.tokens.shape) == (2, 4)
    assert torch.isfinite(res.prefill_logits).all()
    assert f"{arch}: 2 requests, prefill 40 toks" in capsys.readouterr().out
    if arch == "whisper-tiny":
        assert tuple(res.audio_emb.shape) == (2, res.cfg.encoder_len,
                                              res.cfg.d_model)
        # the same seeded draws give the same prefill
        logits, _ = res.model.prefill(
            res.params, {"tokens": res.prompts, "audio_emb": res.audio_emb},
            make_ctx("prefill", cache_len=44))
        torch.testing.assert_close(logits, res.prefill_logits, rtol=0,
                                   atol=0)
    else:
        assert res.audio_emb is None
    attn = [e for e in res.recs["prefill"].events if e.site == "attn.core"]
    n_attn = {"recurrentgemma-2b": 1, "xlstm-125m": 0,
              "whisper-tiny": res.cfg.n_encoder_layers + res.cfg.n_layers,
              "chameleon-34b": res.cfg.n_layers}[arch]
    assert len(attn) == n_attn


@pytest.mark.parametrize("arch,match", [
    ("recurrentgemma-2b", "recurrent states are not paged"),
    ("whisper-tiny", "continuous batching needs a decoder-only LM")])
def test_serve_queue_refuses_unpageable_families(arch, match):
    from repro_torch.launch import serve

    with pytest.raises(NotImplementedError, match=match):
        serve.run(["--arch", arch, "--device", "cpu", "--queue",
                   "--requests", "2", "--prompt-len", "8",
                   "--gen-tokens", "3"])


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
    examples = os.path.join(ROOT, "examples")
    for f in sorted(os.listdir(examples)):
        if f.endswith("_torch.py"):
            yield os.path.join(examples, f)


def test_no_module_imports_jax_or_repro():
    bad = []
    n = 0
    seen = set()
    for path in _py_files():
        n += 1
        seen.add(os.path.relpath(path, PKG))
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
    # the distribution layer and the mesh-aware builders are scanned too
    assert {os.path.join("dist", "sharding.py"),
            os.path.join("dist", "collectives.py"),
            os.path.join("launch", "mesh.py"),
            os.path.join("launch", "dryrun.py"),
            os.path.join("serve", "step.py")} <= seen
    # and the port's examples
    assert {os.path.relpath(os.path.join(ROOT, "examples", f), PKG)
            for f in ("quickstart_torch.py", "serve_with_tuner_torch.py",
                      "train_e2e_torch.py",
                      "moe_expert_parallel_torch.py")} <= seen
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


# ---------------------------------------------------------------------------
# continuous batching, the closed re-install loop and the registry
# ---------------------------------------------------------------------------

def _drifting_artifact(path):
    """A simulated install weighted by a gemm profile of shapes far from
    the smoke model's: its serving mix drifts past any threshold."""
    import numpy as np

    from repro_torch.core import InstallConfig, SimulatedBackend, install
    from repro_torch.core.workload import WorkloadProfile
    from repro_torch.kernels.recorder import DispatchEvent, DispatchRecorder

    rec = DispatchRecorder()
    rng = np.random.default_rng(11)
    for _ in range(64):
        m, k, n = (int(x) for x in rng.integers(64, 512, 3))
        rec.events.append(DispatchEvent("gemm", m, k, n, site="synthetic"))
    install(SimulatedBackend(seed=0),
            InstallConfig(n_samples=48, repeats=2, tile_ids=(0, 3),
                          models=("linear_regression",),
                          routines=("gemm", "attn"), grid_budget="small",
                          cv_splits=3, seed=0,
                          workload=WorkloadProfile.from_recorder(rec)),
            artifact_dir=str(path))
    return str(path)


def test_serve_queue_cli_runs_on_cpu_without_jax(port_artifact):
    code = _BLOCK + textwrap.dedent("""
        import runpy
        sys.argv = ["serve"] + sys.argv[1:]
        runpy.run_module("repro_torch.launch.serve", run_name="__main__")
        """)
    res = subprocess.run(
        [sys.executable, "-c", code, "--device", "cpu", "--scale", "smoke",
         "--queue", "--requests", "4", "--prompt-len", "8",
         "--gen-tokens", "5", "--slots", "2", "--page-size", "4",
         "--artifact", port_artifact],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "4 requests via continuous batching (2 slots, 16 pages x 4 " \
        "tokens)" in res.stdout
    assert "goodput" in res.stdout and "tuner stats:" in res.stdout


def test_serve_queue_run_returns_the_scheduler(port_artifact):
    from repro_torch.launch import serve

    res = serve.run(["--device", "cpu", "--queue", "--requests", "5",
                     "--prompt-len", "12", "--gen-tokens", "6",
                     "--slots", "3", "--page-size", "4",
                     "--artifact", port_artifact])
    assert isinstance(res, serve.QueueResult)
    assert len(res.sched.finished) == 5 and res.manager is None
    res.sched.alloc.check()
    assert res.sched.alloc.live_pages == 0
    assert res.n_pages == 2 * 3 * 5         # 2 x slots x pages_for(18, 4)
    assert len(res.steps) == res.sched.steps
    assert not any(inst for _, _, inst in res.steps)
    # one recorded prefill per distinct prompt length, one decode step
    lengths = {len(f.prompt) for f in res.sched.finished.values()}
    core = [e for e in res.recs["prefill"].events if e.site == "attn.core"]
    assert len(core) == res.cfg.n_layers * len(lengths)
    assert all(e.config is not None for e in core)


def test_serve_queue_reinstall_fires_and_swaps(tmp_path, capsys):
    from repro_torch.launch import serve

    art = _drifting_artifact(tmp_path / "art")
    res = serve.run(["--device", "cpu", "--queue", "--requests", "4",
                     "--prompt-len", "8", "--gen-tokens", "5",
                     "--slots", "2", "--page-size", "4", "--artifact", art,
                     "--reinstall", "--reinstall-cooldown", "0",
                     "--reinstall-budget", "200"])
    out = capsys.readouterr().out
    mgr = res.manager
    assert mgr.fires == 1 and mgr.swaps == 1 and mgr.last_error is None
    assert res.fire_drifts and res.fire_drifts[0] > 0.25
    assert "crossed the threshold at decode step" in out
    assert "re-install: fires=1 swaps=1" in out
    # the re-install kept every routine and the simulated provenance
    assert set(mgr.routines) == {"gemm", "syrk", "trsm", "attn"}
    assert mgr.tuner.backend_info["kind"] == "simulated"
    res.sched.alloc.check()
    assert os.path.isdir(art + ".prev")


def test_serve_fixed_batch_reinstall_fires(tmp_path, capsys):
    from repro_torch.launch import serve

    art = _drifting_artifact(tmp_path / "art")
    res = serve.run(["--device", "cpu", "--requests", "2", "--prompt-len",
                     "8", "--gen-tokens", "4", "--artifact", art,
                     "--reinstall", "--reinstall-cooldown", "0",
                     "--reinstall-budget", "200"])
    out = capsys.readouterr().out
    assert isinstance(res, serve.ServeResult)
    assert "background re-install launched" in out
    assert "re-install: fires=1 swaps=1" in out


def test_serve_registry_adopts_the_nearest_cell(tmp_path, capsys):
    from repro_torch.core import (ArtifactRegistry, HardwareFingerprint,
                                  InstallConfig, SimulatedBackend)
    from repro_torch.launch import serve

    reg = ArtifactRegistry(str(tmp_path / "reg"))
    donor = HardwareFingerprint(cpu_model="Some Other CPU", cores=3)
    reg.install(donor, SimulatedBackend(seed=0),
                InstallConfig(n_samples=48, repeats=2, tile_ids=(0, 3),
                              models=("linear_regression",),
                              routines=("gemm", "attn"),
                              grid_budget="small", cv_splits=3, seed=0))
    args = ["--device", "cpu", "--queue", "--requests", "2",
            "--prompt-len", "8", "--gen-tokens", "3", "--slots", "2",
            "--page-size", "4", "--registry", str(tmp_path / "reg")]
    res = serve.run(args + ["--reinstall"])
    out = capsys.readouterr().out
    assert "seeded from nearest neighbour" in out
    local = HardwareFingerprint.collect(probe_sizes=())
    own = reg.resolve(local)
    assert own is not None and res.manager.artifact_dir == own
    assert res.manager.fires == 0          # a uniform install: no drift
    # the adopted cell now serves itself
    serve.run(args)
    assert "registry: serving own cell" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="mutually exclusive"):
        serve.run(args + ["--artifact", str(tmp_path)])


def test_serve_reinstall_without_artifact_refuses():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="requires --artifact"):
        serve.run(["--device", "cpu", "--queue", "--reinstall"])


def test_queue_on_cuda_without_gpu_raises():
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(["--device", "cuda", "--queue", "--requests", "1",
                   "--prompt-len", "4", "--gen-tokens", "2"])


def test_profile_cli_installs_from_a_serve_profile(tmp_path, capsys):
    from repro_torch.launch import profile, serve

    prof = tmp_path / "p.json"
    serve.run(["--device", "cpu", "--requests", "2", "--prompt-len", "8",
               "--gen-tokens", "3", "--profile-out", str(prof)])
    art = tmp_path / "art"
    profile.main(["--dryrun-dir", str(tmp_path / "none"), "--profile",
                  str(prof), "--out", str(tmp_path / "m.json"),
                  "--install", "--backend", "simulated", "--artifact",
                  str(art), "--samples", "24", "--timing-budget", "150"])
    out = capsys.readouterr().out
    assert "simulated backend" in out
    from repro_torch.core import AdsalaTuner
    t = AdsalaTuner.from_artifact(str(art))
    assert t.workload is not None and set(t.routines) == {
        "gemm", "syrk", "trsm", "attn"}


@pytest.mark.parametrize("backend", [["--backend", "measured"], []],
                         ids=["explicit", "default"])
def test_profile_measured_backend_needs_a_card(tmp_path, backend):
    """The install times the card unless --backend simulated is asked
    for: without a card it raises, explicit or by default."""
    from repro_torch.launch import profile, serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    prof = tmp_path / "p.json"
    serve.run(["--device", "cpu", "--requests", "1", "--prompt-len", "4",
               "--gen-tokens", "2", "--profile-out", str(prof)])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        profile.main(["--dryrun-dir", str(tmp_path / "none"), "--profile",
                      str(prof), "--out", str(tmp_path / "m.json"),
                      "--install", *backend, "--artifact",
                      str(tmp_path / "art"), "--samples", "8"])


@pytest.mark.parametrize("device,measured,refused", [
    ("cuda", False, True), ("cuda", True, False), ("cpu", False, False)])
def test_reinstall_on_the_card_needs_a_measured_backend(tmp_path, device,
                                                        measured, refused):
    """A server on the card re-installs only on MeasuredCUDABackend: a
    simulated artifact's manager would re-install against the v5e model,
    so the launcher refuses it there (the check needs no card)."""
    from repro_torch.core.timing import MeasuredCUDABackend
    from repro_torch.kernels.recorder import DispatchRecorder
    from repro_torch.launch import serve
    from repro_torch.serve import ReinstallManager

    art = _drifting_artifact(tmp_path / "art")
    mgr = ReinstallManager(
        art, {"decode": DispatchRecorder()},
        backend=MeasuredCUDABackend() if measured else None)
    if refused:
        with pytest.raises(SystemExit, match="simulated backend"):
            serve._require_measured_reinstall(torch.device(device), mgr)
    else:
        serve._require_measured_reinstall(torch.device(device), mgr)


def test_scan_covers_the_serving_modules():
    scanned = {os.path.relpath(p, PKG) for p in _py_files()}
    for rel in ("serve/__init__.py", "serve/kv_cache.py",
                "serve/scheduler.py", "serve/reinstall.py",
                "ft/__init__.py", "ft/heartbeat.py", "launch/profile.py",
                "launch/serve.py", "train/optim.py", "train/step.py",
                "data/__init__.py", "data/pipeline.py", "ckpt/__init__.py",
                "ckpt/checkpoint.py", "ft/driver.py", "launch/train.py",
                "models/recurrent.py", "models/xlstm.py",
                "models/encdec.py"):
        assert rel in scanned, rel
