"""The port's closed serving loop on the CPU, on ``SimulatedBackend``:
drift-triggered re-install with atomic artifact hot-swap.

* the reference's suites, run on :mod:`repro_torch.serve`: the
  acceptance path and fault injection at every install phase
  (tests/test_reinstall.py), swaps under a select hammer
  (tests/test_reinstall_race.py), and the drift / merge / trigger
  properties (tests/test_reinstall_property.py);
* ``serve/reinstall.py`` and ``ft/heartbeat.py`` are the reference's
  source with only the import prefix changed;
* the reference's manager and the port's, fed the same recorded trace
  against copies of one artifact, fire at the same step with the same
  drift and install the same artifact.
"""

import dataclasses
import hashlib
import os
import shutil
import threading

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core.costmodel import ROUTINES, GemmConfig
from repro_torch.core.installer import (
    ARTIFACT_COMMIT,
    InstallConfig,
    artifact_prev_dir,
    artifact_tmp_dir,
    commit_artifact,
    install,
    is_artifact,
    resolve_artifact,
)
from repro_torch.core.timing import SimulatedBackend
from repro_torch.core.tuner import AdsalaTuner
from repro_torch.core.workload import WorkloadProfile
from repro_torch.kernels.recorder import DispatchEvent, DispatchRecorder
from repro_torch.serve import (
    DriftTrigger,
    ReinstallConfig,
    ReinstallManager,
)

pytestmark = pytest.mark.timeout(300)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# tests/test_reinstall.py
# ---------------------------------------------------------------------------

_INSTALL = dict(n_samples=48, repeats=1, routines=("gemm", "syrk"),
                models=("decision_tree",), tile_ids=(0, 1, 3))
#: budget-capped template the manager re-installs with
_REINSTALL_CFG = InstallConfig(timing_budget=200, **_INSTALL)


def _synthetic_recorder(routine: str, lo: int, hi: int, n: int, *,
                        seed: int) -> DispatchRecorder:
    rec = DispatchRecorder()
    rng = np.random.default_rng(seed)
    for _ in range(n):
        m, k, nn = (int(x) for x in rng.integers(lo, hi, 3))
        rec.events.append(DispatchEvent(routine=routine, m=m, k=k, n=nn,
                                        site="synthetic"))
    return rec


def _dir_digest(d: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(d)):
        h.update(name.encode())
        with open(os.path.join(d, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


@pytest.fixture(scope="session")
def _artifact_src(tmp_path_factory):
    """One real install (gemm-heavy small-shape profile), copied per
    test so swaps/rollbacks never leak between tests."""
    src = tmp_path_factory.mktemp("torch_reinstall") / "artifact"
    prof = WorkloadProfile.from_recorder(
        _synthetic_recorder("gemm", 64, 512, 64, seed=11))
    install(SimulatedBackend(seed=0),
            InstallConfig(workload=prof, **_INSTALL),
            artifact_dir=str(src))
    return src


@pytest.fixture
def artifact(tmp_path, _artifact_src) -> str:
    dst = tmp_path / "artifact"
    shutil.copytree(_artifact_src, dst)
    return str(dst)


def _shifted_recorder(seed: int = 7) -> DispatchRecorder:
    """Serving mix disjoint from the installed profile: syrk-only and
    an order of magnitude larger shapes -> drift ~1."""
    return _synthetic_recorder("syrk", 2048, 8192, 128, seed=seed)


def _manager(artifact: str, rec, clock, **cfg_kw) -> ReinstallManager:
    kw = dict(threshold=0.25, hysteresis=0.05, cooldown_s=60.0,
              min_events=16, install=_REINSTALL_CFG)
    kw.update(cfg_kw)
    return ReinstallManager(artifact, rec,
                            backend=SimulatedBackend(seed=0),
                            cfg=ReinstallConfig(**kw),
                            clock=lambda: clock[0])


# ---------------------------------------------------------------------------
# E2E acceptance: shift -> fire once -> swap under traffic -> recover
# ---------------------------------------------------------------------------

def test_e2e_drift_triggers_swap_under_traffic(artifact, tmp_path):
    clock = [0.0]
    hb = str(tmp_path / "reinstall.hb")
    mgr = _manager(artifact, {"decode": _shifted_recorder()}, clock,
                   heartbeat_path=hb)

    shapes = [(int(m), int(k), int(n)) for m, k, n in
              np.random.default_rng(5).integers(128, 4096, (8, 3))]
    errors: list = []
    served = [0] * 4
    stop = threading.Event()

    def hammer(tid: int) -> None:
        while not stop.is_set():
            try:
                for i, (m, k, n) in enumerate(shapes):
                    r = ("gemm", "syrk")[i % 2]
                    assert isinstance(mgr.select(m, k, n, r), GemmConfig)
                    served[tid] += 1
                for c in mgr.select_many(shapes, routines="syrk"):
                    assert isinstance(c, GemmConfig)
                    served[tid] += 1
            except Exception as e:          # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    try:
        assert mgr.drift() > 0.9            # disjoint mix, before fire
        assert mgr.check()                  # fires
        assert not mgr.check()              # exactly once: in flight
        assert mgr.wait(timeout=120)
        assert mgr.last_error is None
        assert mgr.swaps == 1 and mgr.fires == 1
    finally:
        stop.set()
        for t in threads:
            t.join()

    assert not errors                       # zero dropped dispatches
    assert all(n > 0 for n in served)       # every thread kept serving
    # the re-install was mix-weighted by the live profile: drift closes
    assert mgr.drift() < 0.25
    # on disk: new artifact live, old retained for rollback
    assert is_artifact(artifact)
    assert os.path.exists(os.path.join(artifact, ARTIFACT_COMMIT))
    assert is_artifact(artifact_prev_dir(artifact))
    assert not os.path.isdir(artifact_tmp_dir(artifact))
    # below threshold now -> no re-fire, regardless of cooldown
    clock[0] += 1e6
    assert not mgr.check() and mgr.fires == 1
    # the install stamped its phases into the liveness beacon (the ft
    # heartbeat idiom) and parked on "idle" after the swap
    from repro_torch.ft import read_heartbeat
    assert read_heartbeat(hb)[0] == "idle"


def test_swap_keys_reselected_through_new_model(artifact):
    """Warm-start carry-over is per-artifact: hot *keys* survive a swap
    but their configs must equal what the new artifact would choose
    fresh — never the old tuner's cached choices."""
    clock = [0.0]
    mgr = _manager(artifact, {"all": _shifted_recorder()}, clock)
    keys = [(256, 256, 256), (1024, 512, 2048), (64, 4096, 64)]
    for m, k, n in keys:
        mgr.select(m, k, n, "syrk")
    assert mgr.check() and mgr.wait(timeout=120) and mgr.swaps == 1
    fresh = AdsalaTuner.from_artifact(artifact)
    for m, k, n in keys:
        assert mgr.peek(m, k, n, "syrk")    # key carried over (warm)
        assert mgr.select(m, k, n, "syrk") == fresh.select(m, k, n, "syrk")


# ---------------------------------------------------------------------------
# fault injection: kill the background install at every phase
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["gather", "fit", "write", "commit"])
def test_install_killed_mid_phase_keeps_serving(artifact, phase):
    clock = [0.0]
    before = _dir_digest(artifact)
    rec = _shifted_recorder()
    mgr = _manager(artifact, rec, clock)

    def bomb(p: str) -> None:
        if p == phase:
            raise RuntimeError(f"killed@{p}")

    mgr._phase_hook = bomb
    pre = mgr.select(512, 512, 512, "gemm")
    assert mgr.check() and mgr.wait(timeout=120)
    assert f"killed@{phase}" in repr(mgr.last_error)
    assert mgr.swaps == 0

    # the live tuner never noticed: same artifact, same choices
    assert mgr.select(512, 512, 512, "gemm") == pre
    assert _dir_digest(artifact) == before
    assert not os.path.isdir(artifact_prev_dir(artifact))

    tmp = artifact_tmp_dir(artifact)
    if phase == "write":
        # killed after the artifact files, before the sentinel: the tmp
        # is on disk but uncommitted — promotion must refuse it
        assert os.path.isdir(tmp)
        assert not os.path.exists(os.path.join(tmp, ARTIFACT_COMMIT))
        with pytest.raises(ValueError):
            commit_artifact(tmp, artifact)

    # restart: boot resolution keeps the live artifact, sweeps debris
    assert resolve_artifact(artifact) == artifact
    assert not os.path.isdir(tmp)
    assert _dir_digest(artifact) == before
    mgr2 = _manager(artifact, rec, clock)
    assert mgr2.select(512, 512, 512, "gemm") == pre


def test_mid_commit_crash_window_recovers(artifact):
    """Crash between commit's two renames: live dir gone, .prev holds
    the old artifact.  resolve_artifact restores it and the manager
    boots as if nothing happened."""
    pre = AdsalaTuner.from_artifact(artifact).select(512, 512, 512)
    before = _dir_digest(artifact)
    os.replace(artifact, artifact_prev_dir(artifact))
    assert resolve_artifact(artifact) == artifact
    assert _dir_digest(artifact) == before
    mgr = _manager(artifact, _shifted_recorder(), [0.0])
    assert mgr.select(512, 512, 512, "gemm") == pre


def test_boot_refuses_missing_artifact(tmp_path):
    with pytest.raises(FileNotFoundError):
        ReinstallManager(str(tmp_path / "nope"), DispatchRecorder())


# ---------------------------------------------------------------------------
# rollback
# ---------------------------------------------------------------------------

def test_rollback_restores_prev_byte_for_byte(artifact):
    clock = [0.0]
    mgr = _manager(artifact, {"all": _shifted_recorder()}, clock)
    before = _dir_digest(artifact)
    pre = mgr.select(512, 512, 512, "gemm")

    assert mgr.check() and mgr.wait(timeout=120) and mgr.swaps == 1
    assert _dir_digest(artifact) != before  # new artifact is live

    mgr.rollback()
    assert _dir_digest(artifact) == before  # byte-for-byte restore
    assert mgr.select(512, 512, 512, "gemm") == pre
    # the displaced (new) artifact sits in .prev: rollback is symmetric
    assert is_artifact(artifact_prev_dir(artifact))


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_min_events_guard_blocks_noise(artifact):
    clock = [0.0]
    rec = _synthetic_recorder("syrk", 2048, 8192, 4, seed=1)  # 4 events
    mgr = _manager(artifact, rec, clock, min_events=16)
    assert mgr.drift() > 0.9                # drifted, but too few events
    assert not mgr.check() and mgr.fires == 0


def test_uniform_artifact_never_fires(tmp_path):
    """No installed workload profile -> drift undefined -> no fire."""
    art = str(tmp_path / "uniform")
    install(SimulatedBackend(seed=0), InstallConfig(**_INSTALL),
            artifact_dir=art)
    mgr = _manager(art, _shifted_recorder(), [0.0])
    assert mgr.drift() is None
    assert not mgr.check() and mgr.fires == 0


def test_stale_tmp_swept_and_commit_refused(artifact):
    tmp = artifact_tmp_dir(artifact)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "config.json"), "w") as f:
        f.write("{}")                       # partial write, no model
    with pytest.raises(ValueError):
        commit_artifact(tmp, artifact)
    assert resolve_artifact(artifact) == artifact
    assert not os.path.isdir(tmp)           # debris swept at boot


# ---------------------------------------------------------------------------
# tests/test_reinstall_race.py
# ---------------------------------------------------------------------------

#: disjoint tile sets -> the two artifacts choose from disjoint
#: candidate pools, so "which artifact served this?" is decidable
_RACE_TILES_A = (0, 1, 2)
_RACE_TILES_B = (5, 6, 7)

KEYS = [(int(m), int(k), int(n)) for m, k, n in
        np.random.default_rng(17).integers(128, 8192, (10, 3))]
ROUTINES_CYCLE = ["gemm", "syrk"] * 5


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_race")
    dirs = {}
    for name, tiles in (("a", _RACE_TILES_A), ("b", _RACE_TILES_B)):
        d = str(root / name)
        install(SimulatedBackend(seed=0),
                InstallConfig(n_samples=48, repeats=1,
                              routines=("gemm", "syrk"),
                              models=("decision_tree",),
                              tile_ids=tiles, seed=3),
                artifact_dir=d)
        dirs[name] = d
    return dirs


def _choices(artifact: str) -> dict:
    t = AdsalaTuner.from_artifact(artifact)
    return {(r, m, k, n): t.select(m, k, n, r)
            for (m, k, n), r in zip(KEYS, ROUTINES_CYCLE)}


def test_swaps_under_select_hammer_never_tear(arts):
    choice = {name: _choices(d) for name, d in arts.items()}
    keys = list(choice["a"])
    # the contract test needs distinguishable artifacts
    differing = [k for k in keys if choice["a"][k] != choice["b"][k]]
    assert differing, "artifacts with disjoint tiles chose identically"

    mgr = ReinstallManager(arts["a"], DispatchRecorder(),
                           backend=SimulatedBackend(seed=0))
    errors: list = []
    torn: list = []
    stop = threading.Event()
    n_batches = [0] * 6

    def hammer(tid: int) -> None:
        rng = np.random.default_rng(tid)
        while not stop.is_set():
            try:
                if tid % 2 == 0:
                    # single selects: observed value must belong to one
                    # of the two artifacts' choice sets
                    i = int(rng.integers(len(KEYS)))
                    r, m, k, n = keys[i]
                    got = mgr.select(m, k, n, r)
                    if got not in (choice["a"][keys[i]],
                                   choice["b"][keys[i]]):
                        torn.append((keys[i], got))
                else:
                    # batched: the WHOLE batch must be served by a
                    # single artifact — half-and-half is a torn swap
                    got = mgr.select_many(KEYS, routines=ROUTINES_CYCLE)
                    for src in ("a", "b"):
                        if all(g == choice[src][k]
                               for g, k in zip(got, keys)):
                            break
                    else:
                        torn.append(("batch", got))
                n_batches[tid] += 1
            except Exception as e:          # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(6)]
    for t in threads:
        t.start()
    try:
        for i in range(12):                # 12 live swaps under fire,
            mgr.swap_now(arts["a"] if i % 2 == 0 else arts["b"])  # ending on B
    finally:
        stop.set()
        for t in threads:
            t.join()

    assert not errors
    assert not torn, f"torn dispatches observed: {torn[:3]}"
    assert all(n > 0 for n in n_batches)
    assert mgr.swaps == 12

    # final artifact is B: post-swap selects equal a fresh B load —
    # the cache is keyed per artifact, old choices never leak through
    for key in keys:
        r, m, k, n = key
        assert mgr.select(m, k, n, r) == choice["b"][key]


def test_warm_carry_reselects_not_copies(arts):
    """The warm-start transplant re-evaluates hot keys through the NEW
    model; for keys where the artifacts disagree, serving the old
    choice after a swap would be a cache-leak bug."""
    mgr = ReinstallManager(arts["a"], DispatchRecorder(),
                           backend=SimulatedBackend(seed=0))
    choice_a, choice_b = _choices(arts["a"]), _choices(arts["b"])
    for (r, m, k, n), want in choice_a.items():
        assert mgr.select(m, k, n, r) == want
    mgr.swap_now(arts["b"])
    for (r, m, k, n), want in choice_b.items():
        assert mgr.peek(m, k, n, r)         # hot set carried over
        assert mgr.select(m, k, n, r) == want


def test_stats_are_per_artifact_instance(arts):
    mgr = ReinstallManager(arts["a"], DispatchRecorder(),
                           backend=SimulatedBackend(seed=0))
    for (m, k, n), r in zip(KEYS, ROUTINES_CYCLE):
        mgr.select(m, k, n, r)
        mgr.select(m, k, n, r)              # memo hit on the old tuner
    assert mgr.stats["cache_hits"] > 0
    old_stats = mgr.stats
    mgr.swap_now(arts["b"])
    assert mgr.stats is not old_stats       # fresh instance, fresh LRU
    assert mgr.stats["cache_hits"] == 0


# ---------------------------------------------------------------------------
# tests/test_reinstall_property.py
# ---------------------------------------------------------------------------

def _rand_profile(seed: int, by: str = "flops") -> WorkloadProfile:
    rng = np.random.default_rng(seed)
    rec = DispatchRecorder()
    for _ in range(int(rng.integers(1, 50))):
        m, k, n = (int(x) for x in 2 ** rng.integers(3, 14, 3))
        rec.events.append(DispatchEvent(
            routine=ROUTINES[int(rng.integers(len(ROUTINES)))],
            m=m, k=k, n=n, count=int(rng.integers(1, 5)),
            site="prop"))
    return WorkloadProfile.from_recorder(rec, by=by)


# ---------------------------------------------------------------------------
# drift: bounded, symmetric, zero on self
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(sa=st.integers(0, 10**6), sb=st.integers(0, 10**6))
def test_drift_in_unit_interval_and_symmetric(sa, sb):
    a, b = _rand_profile(sa), _rand_profile(sb)
    d = a.drift(b)
    assert 0.0 <= d <= 1.0
    assert d == pytest.approx(b.drift(a), abs=1e-12)


@settings(max_examples=15, deadline=None)
@given(s=st.integers(0, 10**6))
def test_drift_zero_on_self(s):
    a = _rand_profile(s)
    assert a.drift(a) == pytest.approx(0.0, abs=1e-12)
    # the routine-mix (mapping) entry point agrees on the self case
    assert a.drift(a.routine_weights) == pytest.approx(0.0, abs=1e-12)


@settings(max_examples=15, deadline=None)
@given(sa=st.integers(0, 10**6), sb=st.integers(0, 10**6))
def test_profile_drift_dominates_routine_only_drift(sa, sb):
    """The profile-vs-profile drift (max of routine and shape-cell TV)
    can only sharpen, never soften, the routine-mix warning the serve
    loop printed before the closed loop existed."""
    a, b = _rand_profile(sa), _rand_profile(sb)
    assert a.drift(b) >= a.drift(b.routine_weights) - 1e-12


# ---------------------------------------------------------------------------
# merge: volume-weighting associative up to tolerance
# ---------------------------------------------------------------------------

def _assert_profiles_close(p: WorkloadProfile, q: WorkloadProfile):
    assert p.total == pytest.approx(q.total, rel=1e-9)
    assert set(p.routine_weights) == set(q.routine_weights)
    for r, w in p.routine_weights.items():
        assert w == pytest.approx(q.routine_weights[r], abs=1e-9)
    assert set(p.cells) == set(q.cells)
    for c, w in p.cells.items():
        assert w == pytest.approx(q.cells[c], abs=1e-9)


@settings(max_examples=15, deadline=None)
@given(sa=st.integers(0, 10**6), sb=st.integers(0, 10**6),
       sc=st.integers(0, 10**6))
def test_merge_volume_weighting_associative(sa, sb, sc):
    a, b, c = (_rand_profile(s) for s in (sa, sb, sc))
    flat = WorkloadProfile.merge([a, b, c])
    left = WorkloadProfile.merge([WorkloadProfile.merge([a, b]), c])
    right = WorkloadProfile.merge([a, WorkloadProfile.merge([b, c])])
    _assert_profiles_close(flat, left)
    _assert_profiles_close(flat, right)


@settings(max_examples=15, deadline=None)
@given(sa=st.integers(0, 10**6), sb=st.integers(0, 10**6))
def test_merge_weights_follow_recorded_volume(sa, sb):
    """Default merge weights are each profile's recorded total — the
    per-traffic-class semantics the ReinstallManager relies on."""
    a, b = _rand_profile(sa), _rand_profile(sb)
    merged = WorkloadProfile.merge([a, b])
    explicit = WorkloadProfile.merge([a, b],
                                     weights=[a.total, b.total])
    _assert_profiles_close(merged, explicit)
    assert merged.total == pytest.approx(a.total + b.total, rel=1e-9)


# ---------------------------------------------------------------------------
# trigger: hysteresis + cooldown invariants over arbitrary trajectories
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(threshold=st.floats(0.05, 0.9),
       hyst_frac=st.floats(0.0, 1.0),
       cooldown=st.floats(0.0, 50.0),
       drifts=st.lists(st.floats(0.0, 1.0), min_size=1, max_size=60),
       dt=st.floats(0.1, 5.0))
def test_trigger_cooldown_and_hysteresis_invariants(
        threshold, hyst_frac, cooldown, drifts, dt):
    trig = DriftTrigger(threshold=threshold,
                        hysteresis=hyst_frac * threshold,
                        cooldown_s=cooldown)
    fires = []
    for i, d in enumerate(drifts):
        now = i * dt
        if trig.observe(d, now):
            fires.append((now, i))
            # a fire only ever happens above threshold
            assert d > threshold
    # no two fires within the cooldown, regardless of trajectory
    for (t0, _), (t1, _) in zip(fires, fires[1:]):
        assert t1 - t0 >= cooldown
    # between consecutive fires the drift must have re-armed the
    # trigger by dipping to threshold - hysteresis or below
    rearm = max(threshold - trig.hysteresis, 0.0)
    for (_, i0), (_, i1) in zip(fires, fires[1:]):
        assert any(d <= rearm for d in drifts[i0 + 1:i1])


def test_trigger_rejects_bad_params():
    with pytest.raises(ValueError):
        DriftTrigger(threshold=0.0)
    with pytest.raises(ValueError):
        DriftTrigger(threshold=0.2, hysteresis=0.3)
    with pytest.raises(ValueError):
        DriftTrigger(cooldown_s=-1.0)


def test_trigger_oscillation_fires_once():
    """Hovering just around the threshold (the thrash scenario
    hysteresis exists for) fires exactly once."""
    trig = DriftTrigger(threshold=0.25, hysteresis=0.05, cooldown_s=0.0)
    seq = [0.26, 0.24, 0.26, 0.24, 0.26]    # never dips to 0.20
    fired = sum(trig.observe(d, float(i)) for i, d in enumerate(seq))
    assert fired == 1


# ---------------------------------------------------------------------------
# the port's source is the reference's
# ---------------------------------------------------------------------------

def _code(path: str) -> str:
    """A module's source below its docstring."""
    import ast

    with open(path) as fh:
        src = fh.read()
    first = ast.parse(src).body[0]
    assert isinstance(first, ast.Expr) and isinstance(first.value,
                                                      ast.Constant)
    return "".join(src.splitlines(keepends=True)[first.end_lineno:])


@pytest.mark.parametrize("rel", ["serve/reinstall.py", "ft/heartbeat.py"])
def test_module_is_the_reference_modulo_imports(rel):
    """Below the module docstring, the port's source is the
    reference's with only the import prefix changed."""
    want = _code(os.path.join(ROOT, "src", "repro", rel))
    got = _code(os.path.join(ROOT, "src", "repro_torch", rel))
    assert got == want.replace("from repro.", "from repro_torch.")
    assert "def " in got


# ---------------------------------------------------------------------------
# the reference's manager and the port's on one recorded trace
# ---------------------------------------------------------------------------

def _trace_events(seed: int = 3) -> list[tuple]:
    """A recorded serving trace: first traffic like the installed
    profile (gemm, 64..512), then a shift to large syrk shapes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(48):
        routine, lo, hi = (("gemm", 64, 512) if i < 20
                           else ("syrk", 2048, 8192))
        m, k, n = (int(x) for x in rng.integers(lo, hi, 3))
        out.append((routine, m, k, n, int(rng.integers(1, 4))))
    return out


def test_reference_and_port_managers_fire_together(_artifact_src,
                                                   tmp_path):
    from repro.core.installer import InstallConfig as JInstallConfig
    from repro.core.timing import SimulatedBackend as JSimulatedBackend
    from repro.core.tuner import AdsalaTuner as JAdsalaTuner
    from repro.kernels.recorder import DispatchEvent as JDispatchEvent
    from repro.kernels.recorder import DispatchRecorder as JDispatchRecorder
    from repro.serve import ReinstallConfig as JReinstallConfig
    from repro.serve import ReinstallManager as JReinstallManager

    dirs = {}
    for name in ("ref", "port"):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(_artifact_src, dirs[name])
    clock = [0.0]
    kw = dict(threshold=0.25, hysteresis=0.05, cooldown_s=60.0,
              min_events=16)
    jrec, rec = JDispatchRecorder(), DispatchRecorder()
    jmgr = JReinstallManager(
        dirs["ref"], {"decode": jrec}, backend=JSimulatedBackend(seed=0),
        cfg=JReinstallConfig(install=JInstallConfig(timing_budget=200,
                                                    **_INSTALL), **kw),
        clock=lambda: clock[0])
    mgr = ReinstallManager(
        dirs["port"], {"decode": rec}, backend=SimulatedBackend(seed=0),
        cfg=ReinstallConfig(install=_REINSTALL_CFG, **kw),
        clock=lambda: clock[0])
    fired = []
    for step, (routine, m, k, n, count) in enumerate(_trace_events()):
        jrec.events.append(JDispatchEvent(routine, m, k, n, site="trace",
                                          count=count))
        rec.events.append(DispatchEvent(routine, m, k, n, site="trace",
                                        count=count))
        clock[0] += 1.0
        got, want = mgr.check(), jmgr.check()
        assert got == want, f"step {step}"
        assert (mgr.last_drift is None) == (jmgr.last_drift is None)
        if jmgr.last_drift is not None:
            assert mgr.last_drift == pytest.approx(jmgr.last_drift,
                                                   abs=1e-12)
        if want:
            fired.append((step, jmgr.last_drift))
            assert jmgr.wait(timeout=120) and mgr.wait(timeout=120)
            assert mgr.last_error is None and jmgr.last_error is None
    assert len(fired) == 1 and fired[0][1] > kw["threshold"]
    assert mgr.swaps == jmgr.swaps == 1
    # the same install on both sides: the same picks from now on
    jt, t = JAdsalaTuner.from_artifact(dirs["ref"]), \
        AdsalaTuner.from_artifact(dirs["port"])
    for (routine, m, k, n, _) in _trace_events(seed=9)[::4]:
        a, b = jt.select(m, k, n, routine), t.select(m, k, n, routine)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert mgr.drift() == pytest.approx(jmgr.drift(), abs=1e-12)


# ---------------------------------------------------------------------------
# the card's re-install times every attn row on the flash kernel
# ---------------------------------------------------------------------------

class _PlanningBackend:
    """Stands in for MeasuredCUDABackend on the CPU: records what the
    install asks it to time and plans each attn row's kernel launch the
    way the card's backend does, without a card."""

    def __init__(self):
        self.attn = []

    def time_routine(self, m, k, n, cfg, *, routine="gemm"):
        from repro_torch.core.timing import attn_timing_heads
        from repro_torch.kernels.flash_attention import flash_launch

        if routine == "attn":
            bh, d = attn_timing_heads(k)
            bq, bkv = cfg.flash_block
            flash_launch(m, n, d, bq, bkv, grid=cfg.flash_grid)
            self.attn.append((m, k, n, bh, d))
        return 1e-6 * (1 + m * k * n / 1e9)


@pytest.mark.parametrize("workload", [False, True])
def test_every_sampled_attn_row_has_a_kernel_launch(workload):
    """The rows a measured install (launch.profile's, all routines) and
    the launcher's re-install template sample: every attn row maps to a
    head dim the kernel takes, padded by less than one kernel head dim,
    and the kernel's planner accepts its launch."""
    from repro_torch.core.installer import gather_data
    from repro_torch.kernels.flash_attention import SUPPORTED_HEAD_DIMS

    prof = WorkloadProfile.from_recorder(
        _synthetic_recorder("gemm", 64, 512, 64, seed=11)) \
        if workload else None
    backend = _PlanningBackend()
    for cfg in (InstallConfig(n_samples=160, repeats=1,
                              routines=tuple(ROUTINES), workload=prof,
                              timing_budget=400, seed=1),
                InstallConfig(n_samples=96, repeats=1,
                              routines=tuple(ROUTINES), workload=prof,
                              seed=2)):
        gather_data(backend, cfg)
    ks = {k for _, k, _, _, _ in backend.attn}
    assert len(backend.attn) > 20 and len(ks) > 10
    assert any(k not in SUPPORTED_HEAD_DIMS for k in ks)
    assert any(k > max(SUPPORTED_HEAD_DIMS) for k in ks)
    for m, k, n, bh, d in backend.attn:
        assert d in SUPPORTED_HEAD_DIMS
        assert k <= bh * d < k + d
        assert bh == 1 or d == max(SUPPORTED_HEAD_DIMS)
