"""Drift-triggered online re-install with atomic artifact hot-swap.

Closes the serving loop of the model-driven adaptive-libraries line of
work (arXiv 1806.07060): serve *measures* total-variation drift between
the live dispatch mix and the installed
:class:`~repro_torch.core.workload.WorkloadProfile`, and warns above a
threshold.  The :class:`ReinstallManager` here makes the loop closed —

    live DispatchRecorder(s)
      -> WorkloadProfile (per traffic class, volume-weighted merge)
      -> drift vs the installed profile (routine mix AND shape cells)
      -> threshold crossing, debounced by hysteresis + cooldown
      -> mix-weighted, budget-capped install() in a BACKGROUND thread
      -> atomic artifact hot-swap under traffic

The swap is atomic at both layers, reusing the write-to-tmp +
commit-sentinel + rename idiom of the checkpoint/FT stack
(``repro.ckpt.checkpoint`` / ``repro.ft.driver``):

* **on disk** — the install writes into ``<artifact>.tmp/``, a
  ``COMMIT`` sentinel lands only after both artifact files are
  complete, and :func:`~repro.core.installer.commit_artifact` promotes
  it with two ``os.replace`` renames, retaining the displaced artifact
  at ``<artifact>.prev/`` for one-call :meth:`ReinstallManager.rollback`.
  A killed install leaves an uncommitted tmp that
  :func:`~repro.core.installer.resolve_artifact` ignores and sweeps at
  the next boot.
* **in memory** — :meth:`AdsalaTuner.swap_from_artifact
  <repro.core.tuner.AdsalaTuner.swap_from_artifact>` builds a fresh
  tuner (hot working set re-selected through the NEW model), and the
  manager publishes it with a single reference assignment.  Serving
  threads read that reference once per dispatch, so every select runs
  entirely against one tuner: no dropped or blocked dispatch, never a
  torn old/new mix, and the per-instance LRU means stale cache hits
  cannot cross a swap.

The manager quacks like an :class:`~repro.core.tuner.AdsalaTuner`
(``select`` / ``select_many`` / ``select_with_times`` / ``peek`` /
``routines`` / ``workload``), so it drops into ``Ctx.tuner`` and the
``repro.kernels.ops`` dispatch path unchanged.

The reference's module (:mod:`repro.serve.reinstall`) carried over:
below this docstring the source is the reference's with only the
import prefix changed.  Torch-free, like ``launch.profile``: drift
checks and installs run anywhere the simulated/measured timing
backends do.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
import warnings
from typing import Any, Callable, Mapping

from repro_torch.core.costmodel import ROUTINES
from repro_torch.core.installer import (
    ARTIFACT_COMMIT,
    InstallConfig,
    artifact_tmp_dir,
    commit_artifact,
    gather_data,
    install,
    resolve_artifact,
    rollback_artifact,
)
from repro_torch.core.registry import ArtifactRegistry, HardwareFingerprint
from repro_torch.core.timing import SimulatedBackend, backend_from_dict
from repro_torch.core.tuner import AdsalaTuner
from repro_torch.core.workload import WorkloadProfile
from repro_torch.ft.heartbeat import write_heartbeat

__all__ = ["DriftTrigger", "ReinstallConfig", "ReinstallManager"]

#: background-install phases, in order; the fault-injection tests kill
#: the install at each of these points and assert the old artifact
#: keeps serving (see tests/test_reinstall.py)
PHASES = ("profile", "gather", "fit", "write", "commit", "swap")


@dataclasses.dataclass
class DriftTrigger:
    """Threshold crossing with hysteresis + cooldown (no thrash).

    Pure state machine — :meth:`observe` takes the measured drift and a
    caller-supplied clock so the invariants are property-testable
    without threads or installs:

    * fires only while **armed** and ``drift > threshold``;
    * firing disarms; re-arming requires drift to first fall to
      ``threshold - hysteresis`` or below (an oscillating mix that
      hovers around the threshold fires once, not per crossing);
    * two fires are always ``>= cooldown_s`` apart, regardless of the
      drift trajectory in between.
    """

    threshold: float = 0.25
    hysteresis: float = 0.05
    cooldown_s: float = 300.0
    armed: bool = True
    last_fire: float | None = None

    def __post_init__(self) -> None:
        if not 0.0 < self.threshold <= 1.0:
            raise ValueError(f"threshold={self.threshold} outside (0, 1]")
        if not 0.0 <= self.hysteresis <= self.threshold:
            raise ValueError(f"hysteresis={self.hysteresis} outside "
                             f"[0, threshold={self.threshold}]")
        if self.cooldown_s < 0.0:
            raise ValueError(f"cooldown_s={self.cooldown_s} < 0")

    def observe(self, drift: float, now: float) -> bool:
        """Feed one drift measurement; True = fire a re-install now."""
        if drift <= max(self.threshold - self.hysteresis, 0.0):
            self.armed = True
        if not self.armed or drift <= self.threshold:
            return False
        if (self.last_fire is not None
                and now - self.last_fire < self.cooldown_s):
            return False
        self.armed = False
        self.last_fire = now
        return True


def _default_install_template() -> InstallConfig:
    """Budget-capped background install: every routine keeps floor
    coverage (the manager must never narrow the tuner's routine set —
    the dispatch path consults ``tuner.routines`` and a narrowing swap
    could strand an in-flight routine check), one fast boosting model,
    beam-survivor timing instead of the dense grid."""
    return InstallConfig(
        n_samples=160, repeats=2, routines=tuple(ROUTINES),
        models=("lightgbm",), timing_budget=2000, beam_width=8,
        cv_splits=2)


@dataclasses.dataclass
class ReinstallConfig:
    """Policy knobs of the closed serving loop."""

    #: drift (total variation, [0, 1]) above which a re-install fires
    threshold: float = 0.25
    #: re-arm band: after a fire, drift must fall to
    #: ``threshold - hysteresis`` before another fire is possible
    hysteresis: float = 0.05
    #: minimum wall-clock seconds between fires
    cooldown_s: float = 300.0
    #: recorded events (across all traffic classes) below which the
    #: live mix is noise, not signal — no fire
    min_events: int = 64
    #: dispatch-volume weighting of the live profile; keep "flops" to
    #: match dryrun/profile-built install profiles
    by: str = "flops"
    #: install template for each fire; ``workload`` and ``seed`` are
    #: filled per fire (the live profile snapshot, template seed + fire
    #: count).  None = :func:`_default_install_template`.
    install: InstallConfig | None = None
    #: transplant the outgoing tuner's hot shape set into the new one
    #: (re-selected through the NEW model; see swap_from_artifact)
    carry_warm: bool = True
    #: liveness beacon stamped with the install phase (ft idiom); a
    #: coordinator watching mtimes can tell a dead install from an
    #: idle manager
    heartbeat_path: str | None = None


class ReinstallManager:
    """Watches live dispatch drift and hot-swaps the tuner artifact.

    Drop-in tuner: pass the manager wherever an
    :class:`~repro.core.tuner.AdsalaTuner` goes (``make_ctx(...,
    tuner=manager)``).  Every delegated call reads the current tuner
    reference exactly once, so a concurrent swap can never hand half a
    dispatch to each artifact.

    ``recorders`` is one live
    :class:`~repro.kernels.recorder.DispatchRecorder` or a mapping of
    traffic-class name (e.g. ``"prefill"`` / ``"decode"``) to recorder;
    per-class profiles are merged volume-weighted by recorded flops, so
    the install budget follows where serving volume actually is.

    :meth:`check` is the loop body: measure drift, debounce through the
    :class:`DriftTrigger`, and on a fire run the whole
    profile → gather → fit → write → commit → swap pipeline on a
    daemon thread while serving continues.  Injected faults / kills at
    any phase leave the live tuner serving the old artifact and at
    worst an uncommitted ``.tmp`` that the next boot sweeps.
    """

    def __init__(self, artifact_dir: str | None = None,
                 recorders: "Any | Mapping[str, Any]" = None, *,
                 backend: Any = None,
                 registry: "ArtifactRegistry | str | None" = None,
                 fingerprint: HardwareFingerprint | None = None,
                 cfg: ReinstallConfig | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 phase_hook: Callable[[str], None] | None = None,
                 **tuner_kw: Any) -> None:
        #: re-installs target this machine's registry cell when a
        #: registry is given: the loop can never overwrite a
        #: neighbour's artifact with locally-corrected timings.
        self.registry = (ArtifactRegistry(registry)
                         if isinstance(registry, str) else registry)
        self.fingerprint = fingerprint
        if self.registry is not None:
            if self.fingerprint is None:
                # key-only collection: the cell address needs the stable
                # fields, not the ~10ms timed probe
                self.fingerprint = HardwareFingerprint.collect(
                    probe_sizes=())
            artifact_dir = self.registry.register(self.fingerprint)
        if artifact_dir is None:
            raise ValueError("pass artifact_dir= or registry=")
        self.artifact_dir = artifact_dir
        if resolve_artifact(artifact_dir) is None:
            raise FileNotFoundError(
                f"no servable artifact at {artifact_dir} (and no "
                ".prev to recover from)")
        self.cfg = cfg or ReinstallConfig()
        if self.cfg.by not in ("flops", "events"):
            raise ValueError(f"by={self.cfg.by!r}; expected 'flops' or "
                             "'events'")
        self._recorders: dict[str, Any] = (
            {} if recorders is None
            else dict(recorders) if isinstance(recorders, Mapping)
            else {"all": recorders})
        self.trigger = DriftTrigger(threshold=self.cfg.threshold,
                                    hysteresis=self.cfg.hysteresis,
                                    cooldown_s=self.cfg.cooldown_s)
        self._clock = clock
        self._phase_hook = phase_hook
        self._tuner = AdsalaTuner.from_artifact(
            artifact_dir, local_fingerprint=self.fingerprint, **tuner_kw)
        # Re-install with the same KIND of backend that built the loaded
        # artifact (its "backend" provenance block): a measured install
        # must not silently drift back to the simulator on re-install.
        # An explicit backend= always wins; legacy artifacts (no block)
        # or unreconstructable kinds fall back to the simulator.
        if backend is None and self._tuner.backend_info is not None:
            try:
                backend = backend_from_dict(self._tuner.backend_info)
            except (ValueError, KeyError, TypeError) as e:
                warnings.warn(
                    f"cannot rebuild the artifact's install backend "
                    f"({e}); re-installs will use the simulated "
                    "backend", stacklevel=2)
        self.backend = backend if backend is not None else \
            SimulatedBackend(seed=0)
        self._state_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._installing = False
        #: completed hot-swaps (in-memory tuner replacements)
        self.swaps = 0
        #: fires (background installs launched, successful or not)
        self.fires = 0
        self.last_drift: float | None = None
        self.last_error: BaseException | None = None
        self.last_report: Any = None

    # -- tuner facade ---------------------------------------------------
    # Each method binds self._tuner ONCE; the swap is a reference
    # assignment, so an in-flight call completes on the tuner it bound.
    @property
    def tuner(self) -> AdsalaTuner:
        return self._tuner

    @property
    def routines(self) -> tuple[str, ...]:
        return self._tuner.routines

    @property
    def workload(self) -> WorkloadProfile | None:
        return self._tuner.workload

    @property
    def space(self) -> Any:
        return self._tuner.space

    @property
    def candidates(self) -> list:
        return self._tuner.candidates

    @property
    def stats(self) -> dict:
        return self._tuner.stats

    def select(self, m: int, k: int, n: int, routine: str = "gemm",
               **kw: Any):
        return self._tuner.select(m, k, n, routine, **kw)

    def select_many(self, shapes, routines=None, **kw: Any):
        return self._tuner.select_many(shapes, routines=routines, **kw)

    def select_with_times(self, m: int, k: int, n: int,
                          routine: str = "gemm"):
        return self._tuner.select_with_times(m, k, n, routine)

    def peek(self, m: int, k: int, n: int,
             routine: str = "gemm") -> bool:
        return self._tuner.peek(m, k, n, routine)

    def predicted_times_many(self, shapes, routines=None, **kw: Any):
        return self._tuner.predicted_times_many(shapes,
                                                routines=routines, **kw)

    def workload_drift(self, observed) -> float | None:
        return self._tuner.workload_drift(observed)

    # -- drift watch ----------------------------------------------------
    def events_total(self) -> int:
        return sum(len(rec.events) for rec in self._recorders.values())

    def live_profile(self) -> WorkloadProfile | None:
        """The recorded serving mix as one profile: per-traffic-class
        profiles merged volume-weighted (a class that dispatched 10x
        the flops pulls the install budget 10x harder).  None until any
        class has recorded an event."""
        per_class = [
            WorkloadProfile.from_recorder(
                rec, by=self.cfg.by,
                source={"kind": "serve-live", "traffic_class": name})
            for name, rec in self._recorders.items() if rec.events]
        if not per_class:
            return None
        if len(per_class) == 1:
            return per_class[0]
        return WorkloadProfile.merge(
            per_class, source={"kind": "serve-live"})

    def drift(self) -> float | None:
        """Live drift vs the installed profile (None when either side
        is missing — an uniform-install artifact never fires)."""
        installed = self._tuner.workload
        live = self.live_profile()
        if installed is None or live is None:
            return None
        return installed.drift(live)

    @property
    def installing(self) -> bool:
        return self._installing

    def check(self) -> bool:
        """One loop iteration: measure drift, maybe fire a background
        re-install.  Returns True when an install was launched.  Cheap
        and non-blocking either way — call it from the serve loop."""
        live = self.live_profile()
        installed = self._tuner.workload
        if live is None or installed is None:
            return False
        drift = installed.drift(live)
        self.last_drift = drift
        with self._state_lock:
            if self._installing:
                # still, feed the trigger so re-arming tracks recovery
                self.trigger.observe(drift, self._clock())
                return False
            if self.events_total() < self.cfg.min_events:
                return False
            if not self.trigger.observe(drift, self._clock()):
                return False
            self._installing = True
            self.fires += 1
            fire_seq = self.fires
        self._thread = threading.Thread(
            target=self._install_once, args=(live, fire_seq),
            name=f"adsala-reinstall-{fire_seq}", daemon=True)
        self._thread.start()
        return True

    def wait(self, timeout: float | None = None) -> bool:
        """Join the background install (True when none is running)."""
        t = self._thread
        if t is not None:
            t.join(timeout)
        return not self._installing

    # -- the background install -----------------------------------------
    def _phase(self, name: str) -> None:
        if self.cfg.heartbeat_path:
            write_heartbeat(self.cfg.heartbeat_path, name)
        if self._phase_hook is not None:
            self._phase_hook(name)

    def _install_template(self) -> InstallConfig:
        return (self.cfg.install if self.cfg.install is not None
                else _default_install_template())

    def _install_once(self, profile: WorkloadProfile,
                      fire_seq: int) -> None:
        """Profile -> gather -> fit -> write -> commit -> swap.

        Any exception (including an injected fault) aborts the install:
        the live tuner keeps serving the old artifact and on-disk state
        is at worst an uncommitted ``.tmp`` (a killed install's debris,
        swept by resolve_artifact at the next boot or by the next fire).
        """
        tmp = artifact_tmp_dir(self.artifact_dir)
        try:
            self._phase("profile")
            template = self._install_template()
            icfg = dataclasses.replace(
                template, workload=profile,
                seed=template.seed + fire_seq,
                # keep the cell's provenance through re-installs: the
                # new artifact is for the same machine (this one)
                fingerprint=(self.fingerprint
                             if self.fingerprint is not None
                             else self._tuner.fingerprint))
            self._phase("gather")
            data = gather_data(self.backend, icfg)
            self._phase("fit")
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)          # stale debris of a crash
            report = install(self.backend, icfg, data=data,
                             artifact_dir=tmp)
            self._phase("write")
            # sentinel last, after both artifact files are complete —
            # the checkpoint COMMIT idiom; commit_artifact refuses
            # tmp dirs without it
            with open(os.path.join(tmp, ARTIFACT_COMMIT), "w") as f:
                f.write("ok")
            self._phase("commit")
            commit_artifact(tmp, self.artifact_dir)
            self._phase("swap")
            old = self._tuner
            new = old.swap_from_artifact(
                self.artifact_dir, carry_warm=self.cfg.carry_warm,
                search_width=old.search_width)
            self._tuner = new               # THE swap: one reference
            self.last_report = report
            self.last_error = None
            self.swaps += 1
            if self.cfg.heartbeat_path:
                write_heartbeat(self.cfg.heartbeat_path, "idle")
        except BaseException as e:          # noqa: BLE001 — must never
            self.last_error = e             # take the serve loop down
        finally:
            self._installing = False

    # -- manual lifecycle ------------------------------------------------
    def swap_now(self, artifact_dir: str | None = None) -> AdsalaTuner:
        """Synchronous in-memory swap from an on-disk artifact (the
        manager's own by default).  Used by rollback, ops tooling and
        the race tests; the drift-triggered path ends in the same
        single-reference assignment."""
        src = artifact_dir if artifact_dir is not None \
            else self.artifact_dir
        old = self._tuner
        new = old.swap_from_artifact(
            src, carry_warm=self.cfg.carry_warm,
            search_width=old.search_width)
        self._tuner = new
        self.swaps += 1
        return new

    def rollback(self) -> None:
        """Swap ``<artifact>.prev/`` back in, on disk and in memory.
        Pure renames on disk — the restored artifact is byte-for-byte
        what the last commit displaced."""
        self.wait()
        rollback_artifact(self.artifact_dir)
        self.swap_now()
