"""Port vs reference: the carried-over tuning stack (``repro_torch.core``)
installs and selects exactly as ``repro.core`` does.

Both packages install with the same seed on ``SimulatedBackend``; the
fitted model, the preprocessing state and every pick must be identical
(the algorithms are the same code, so the tolerance is zero), and each
package's tuner must load the other's artifact.

The installer picks among several models by a score that adds each
model's *measured* evaluation time, which varies with the load on the
host.  So the zoo's deterministic scores are compared on a two-model
install, and the artifacts whose picks are compared hold one model.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore

_SHAPES = {
    "gemm": [(64, 64, 64), (4096, 2048, 2048), (4, 2048, 100_352),
             (333, 1500, 77), (8192, 64, 8192)],
    "attn": [(1024, 64, 1024), (128, 64, 128), (4096, 128, 4096),
             (40, 16, 40), (2048, 64, 2048)],
}

#: config.json blocks fixed by the algorithms alone (the "selection" and
#: "install" blocks also carry wall-clock model-evaluation times)
_DETERMINISTIC_BLOCKS = ("feature_names", "preprocess", "candidates",
                         "default_config", "space", "backend",
                         "warm_start", "selected")


def _install(pkg, path=None, models=("decision_tree",)):
    cfg = pkg.InstallConfig(
        n_samples=48, repeats=2, tile_ids=(0, 3), models=models,
        routines=("gemm", "attn"), grid_budget="small", cv_splits=3,
        seed=0)
    return pkg.install(pkg.SimulatedBackend(seed=0), cfg,
                       artifact_dir=None if path is None else str(path))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("core_parity")
    jrep = _install(jcore, root / "jax")
    trep = _install(tcore, root / "torch")
    return root / "jax", root / "torch", jrep, trep


def test_model_zoo_scores_are_bit_identical():
    models = ("linear_regression", "decision_tree")
    jrep = _install(jcore, models=models)
    trep = _install(tcore, models=models)
    assert [r.name for r in trep.reports] == list(models)
    for jr, tr in zip(jrep.reports, trep.reports):
        assert tr.name == jr.name
        assert tr.params == jr.params
        for field in ("test_rmse", "normalised_rmse", "ideal_mean_speedup",
                      "ideal_aggregate_speedup"):
            assert getattr(tr, field) == getattr(jr, field), field
        for routine, stats in jr.per_routine.items():
            assert tr.per_routine[routine]["ideal_mean_speedup"] == \
                stats["ideal_mean_speedup"]


def _cfg_tuple(c):
    return dataclasses.astuple(c)


def test_install_is_bit_identical(artifacts):
    jdir, tdir, jrep, trep = artifacts
    assert trep.selected == jrep.selected == "decision_tree"
    jm = json.loads((jdir / "model.json").read_text())
    tm = json.loads((tdir / "model.json").read_text())
    assert tm == jm
    jc = json.loads((jdir / "config.json").read_text())
    tc = json.loads((tdir / "config.json").read_text())
    for key in _DETERMINISTIC_BLOCKS:
        assert tc[key] == jc[key], key
    with np.load(jdir / "grid.npz") as jg, np.load(tdir / "grid.npz") as tg:
        assert sorted(jg.files) == sorted(tg.files)
        for name in jg.files:
            np.testing.assert_array_equal(tg[name], jg[name])


@pytest.mark.parametrize("routine", ["gemm", "attn"])
def test_select_and_select_many_pick_identically(artifacts, routine):
    jdir, tdir, _, _ = artifacts
    jt = jcore.AdsalaTuner.from_artifact(str(jdir))
    tt = tcore.AdsalaTuner.from_artifact(str(tdir))
    shapes = _SHAPES[routine]
    for m, k, n in shapes:
        assert _cfg_tuple(tt.select(m, k, n, routine)) == \
            _cfg_tuple(jt.select(m, k, n, routine))
    jt2 = jcore.AdsalaTuner.from_artifact(str(jdir))
    tt2 = tcore.AdsalaTuner.from_artifact(str(tdir))
    jm = [_cfg_tuple(c) for c in jt2.select_many(shapes, routines=routine)]
    tm = [_cfg_tuple(c) for c in tt2.select_many(shapes, routines=routine)]
    assert tm == jm
    _, jtimes = jt.select_with_times(*shapes[0], routine)
    _, ttimes = tt.select_with_times(*shapes[0], routine)
    np.testing.assert_array_equal(ttimes, jtimes)


@pytest.mark.parametrize("loader,maker", [("jax", "torch"),
                                          ("torch", "jax")])
def test_artifact_round_trips_between_packages(artifacts, loader, maker):
    """Each package's tuner serves from the other's artifact with the
    picks the maker's own tuner gives."""
    jdir, tdir, _, _ = artifacts
    pkgs = {"jax": (jcore, jdir), "torch": (tcore, tdir)}
    load_pkg = pkgs[loader][0]
    make_pkg, art = pkgs[maker]
    foreign = load_pkg.AdsalaTuner.from_artifact(str(art))
    native = make_pkg.AdsalaTuner.from_artifact(str(art))
    assert foreign.routines == native.routines
    for routine, shapes in _SHAPES.items():
        for m, k, n in shapes:
            assert _cfg_tuple(foreign.select(m, k, n, routine)) == \
                _cfg_tuple(native.select(m, k, n, routine))


def test_core_modules_are_the_reference_modulo_imports():
    """The carried-over core is the reference's source with only the
    import prefix changed."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jroot = os.path.join(here, "src", "repro", "core")
    troot = os.path.join(here, "src", "repro_torch", "core")
    n = 0
    for dirpath, _, files in os.walk(jroot):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), jroot)
            with open(os.path.join(jroot, rel)) as fh:
                want = fh.read()
            with open(os.path.join(troot, rel)) as fh:
                got = fh.read()
            want = want.replace("from repro.", "from repro_torch.")
            assert got == want, rel
            n += 1
    assert n >= 20
