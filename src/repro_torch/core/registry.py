"""Per-architecture artifact registry: fingerprint-keyed install cells.

The source paper's headline result is inherently *per-architecture* —
separate models trained on a Cascade Lake node and a Zen 3 node — and
the BLAS-3 follow-up (arXiv 2406.19621) shows the per-routine models
must be re-fit per machine.  Until now every artifact in this repo was
one anonymous directory with no record of which hardware timed it.

This module gives artifacts an address:

* :class:`HardwareFingerprint` — what this node *is*: CPU model, core
  count, cache sizes, device-mesh shape, plus a timed micro-probe
  signature (achieved GFLOP/s at a few GEMM sizes).  The stable fields
  form a deterministic :meth:`~HardwareFingerprint.key` (same machine,
  same key, across processes); the probe feeds
  :meth:`~HardwareFingerprint.distance` so *similar* machines rank near
  each other even when their keys differ.
* :class:`ArtifactRegistry` — one root directory holding one install
  cell per fingerprint key::

      <root>/<key>/fingerprint.json
      <root>/<key>/artifact/           live artifact (paper's two files)
      <root>/<key>/artifact.tmp|.prev  PR-8 lifecycle siblings

  Each cell reuses the installer's atomic tmp/COMMIT/``.prev``
  lifecycle helpers, so per-cell commit, rollback and crash-window
  repair behave exactly like the single-artifact serving loop.
* **transfer installs** — :meth:`ArtifactRegistry.nearest` picks the
  closest populated cell and :meth:`ArtifactRegistry.install` with
  ``transfer_from`` warm-starts from that donor's gathered timing rows,
  measuring only a few dozen calibration cells on the local backend
  (the model-driven adaptive-libraries line, arXiv 1806.07060: transfer
  the device model, spend a small calibration budget instead of a full
  re-install).

jax-free on purpose, like ``repro.serve.reinstall``: fingerprinting and
registry resolution must run anywhere the timing backends do.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import re
import shutil
import time
import warnings
from typing import Any

import numpy as np

from repro_torch.core.installer import (
    ARTIFACT_COMMIT,
    InstallConfig,
    InstallReport,
    artifact_tmp_dir,
    commit_artifact,
    install,
    is_artifact,
    resolve_artifact,
    rollback_artifact,
)

__all__ = ["HardwareFingerprint", "ArtifactRegistry", "ResolvedArtifact",
           "resolve_serving_artifact"]

#: sidecar naming one registry cell's hardware
FINGERPRINT_FILE = "fingerprint.json"
#: the live artifact inside a cell (tmp/prev siblings derive from it)
ARTIFACT_SUBDIR = "artifact"

#: GEMM edge sizes the micro-probe times (small on purpose: the probe
#: runs at fingerprint-collection time, e.g. serve boot)
PROBE_SIZES = (64, 128, 256)


def _read_cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform

    return platform.processor() or platform.machine() or "unknown-cpu"


def _read_cache_kb() -> tuple[int, int, int]:
    """(L1d, L2, L3) sizes in KB from sysfs; 0 when unknown."""
    sizes = {1: 0, 2: 0, 3: 0}
    for idx in glob.glob(
            "/sys/devices/system/cpu/cpu0/cache/index*"):
        try:
            with open(os.path.join(idx, "level")) as f:
                level = int(f.read().strip())
            with open(os.path.join(idx, "type")) as f:
                typ = f.read().strip()
            with open(os.path.join(idx, "size")) as f:
                raw = f.read().strip()
        except (OSError, ValueError):
            continue
        if level == 1 and typ != "Data":
            continue
        if level not in sizes:
            continue
        m = re.fullmatch(r"(\d+)([KMG]?)", raw)
        if not m:
            continue
        val = int(m.group(1))
        if m.group(2):                       # sysfs reports "32K" etc
            val *= {"K": 1, "M": 1024, "G": 1024 * 1024}[m.group(2)]
        else:                                # bare bytes, just in case
            val = max(1, val // 1024)
        sizes[level] = val
    return (sizes[1], sizes[2], sizes[3])


def _slug(text: str, max_len: int = 24) -> str:
    s = re.sub(r"[^a-z0-9]+", "-", text.lower()).strip("-")
    return s[:max_len].rstrip("-") or "cpu"


@dataclasses.dataclass(frozen=True)
class HardwareFingerprint:
    """What one node is, as install provenance and a registry address.

    The **stable** fields (CPU model, cores, caches, mesh shape) define
    :meth:`key` — deterministic across processes on the same machine,
    so a node always lands in the same registry cell.  The **probe**
    signature (achieved GFLOP/s at :data:`PROBE_SIZES`) varies slightly
    run to run and is deliberately excluded from the key; it only
    contributes to :meth:`distance`, where a few percent of timing
    noise cannot reorder machines whose hardware actually differs.
    """

    cpu_model: str
    cores: int
    cache_kb: tuple[int, int, int] = (0, 0, 0)
    mesh_shape: tuple[int, ...] = (1,)
    probe_sizes: tuple[int, ...] = ()
    probe_gflops: tuple[float, ...] = ()

    @classmethod
    def collect(cls, *, mesh_shape: tuple[int, ...] = (1,),
                probe_sizes: tuple[int, ...] = PROBE_SIZES,
                probe_repeats: int = 3, seed: int = 0
                ) -> "HardwareFingerprint":
        """Fingerprint the current host.  ``probe_sizes=()`` skips the
        timed micro-probe (key-only use, e.g. addressing a cell without
        paying ~10ms of GEMM warm-up)."""
        gflops = []
        rng = np.random.default_rng(seed)
        for s in probe_sizes:
            a = rng.standard_normal((s, s)).astype(np.float32)
            b = rng.standard_normal((s, s)).astype(np.float32)
            (a @ b).sum()                    # warmup: BLAS thread spin-up
            reps = []
            for _ in range(max(1, probe_repeats)):
                t0 = time.perf_counter()
                c = a @ b
                dt = time.perf_counter() - t0
                del c
                reps.append(max(dt, 1e-9))
            gflops.append(2.0 * s ** 3 / float(np.median(reps)) / 1e9)
        return cls(cpu_model=_read_cpu_model(),
                   cores=os.cpu_count() or 1,
                   cache_kb=_read_cache_kb(),
                   mesh_shape=tuple(int(d) for d in mesh_shape),
                   probe_sizes=tuple(int(s) for s in probe_sizes),
                   probe_gflops=tuple(round(g, 3) for g in gflops))

    def key(self) -> str:
        """Deterministic registry-cell slug from the stable fields only
        (probe timings jitter across processes; the key must not)."""
        stable = (self.cpu_model, self.cores, tuple(self.cache_kb),
                  tuple(self.mesh_shape))
        digest = hashlib.sha1(repr(stable).encode()).hexdigest()[:8]
        mesh = "x".join(str(d) for d in self.mesh_shape)
        return (f"{_slug(self.cpu_model)}-c{self.cores}"
                f"-m{mesh}-{digest}")

    def distance(self, other: "HardwareFingerprint") -> float:
        """Symmetric dissimilarity for :meth:`ArtifactRegistry.nearest`.

        Stable-field mismatches dominate (a different CPU model is a
        different architecture no matter what the probe says); the probe
        term is the mean |log2| GFLOP/s ratio over the sizes both sides
        measured, so two nodes of the same SKU under different turbo
        states stay close while a genuinely slower part drifts away.
        """
        d = 0.0
        if self.cpu_model != other.cpu_model:
            # dominates every same-SKU term below (cores/cache/probe
            # sum to < 2 for realistic same-model spreads): a different
            # microarchitecture always ranks behind any same-model node
            d += 2.0
        if tuple(self.mesh_shape) != tuple(other.mesh_shape):
            d += 0.5
        d += 0.5 * abs(np.log2(max(self.cores, 1)
                               / max(other.cores, 1)))
        for c1, c2 in zip(self.cache_kb, other.cache_kb):
            if c1 > 0 and c2 > 0:
                d += 0.25 * abs(np.log2(c1 / c2))
        common = [(g1, g2) for s1, g1 in zip(self.probe_sizes,
                                             self.probe_gflops)
                  for s2, g2 in zip(other.probe_sizes, other.probe_gflops)
                  if s1 == s2 and g1 > 0 and g2 > 0]
        if common:
            d += float(np.mean([abs(np.log2(g1 / g2))
                                for g1, g2 in common]))
        return float(d)

    def to_dict(self) -> dict:
        return {"cpu_model": self.cpu_model, "cores": self.cores,
                "cache_kb": list(self.cache_kb),
                "mesh_shape": list(self.mesh_shape),
                "probe_sizes": list(self.probe_sizes),
                "probe_gflops": list(self.probe_gflops),
                "key": self.key()}

    @classmethod
    def from_dict(cls, d: dict) -> "HardwareFingerprint":
        return cls(cpu_model=d["cpu_model"], cores=int(d["cores"]),
                   cache_kb=tuple(int(c) for c in d.get(
                       "cache_kb", (0, 0, 0))),
                   mesh_shape=tuple(int(m) for m in d.get(
                       "mesh_shape", (1,))),
                   probe_sizes=tuple(int(s) for s in d.get(
                       "probe_sizes", ())),
                   probe_gflops=tuple(float(g) for g in d.get(
                       "probe_gflops", ())))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "HardwareFingerprint":
        with open(path) as f:
            return cls.from_dict(json.load(f))


class ArtifactRegistry:
    """One artifact cell per hardware fingerprint under a shared root.

    Every cell is a full PR-8 artifact lifecycle in miniature: installs
    stage into ``artifact.tmp``, commit atomically behind the ``COMMIT``
    sentinel, keep the displaced artifact at ``artifact.prev`` for
    one-call rollback, and :meth:`resolve` repairs the mid-commit crash
    window at boot — all namespaced so a heterogeneous fleet sharing the
    root (e.g. on NFS) never mixes timings across architectures.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- addressing -----------------------------------------------------
    def cell_dir(self, fp: HardwareFingerprint) -> str:
        return os.path.join(self.root, fp.key())

    def artifact_dir(self, fp: HardwareFingerprint) -> str:
        """The cell's live-artifact path (tmp/prev siblings derive from
        it via the installer lifecycle helpers)."""
        return os.path.join(self.cell_dir(fp), ARTIFACT_SUBDIR)

    def register(self, fp: HardwareFingerprint) -> str:
        """Create the cell (idempotent), persist its fingerprint sidecar
        and return the cell's artifact path."""
        cell = self.cell_dir(fp)
        os.makedirs(cell, exist_ok=True)
        fp.save(os.path.join(cell, FINGERPRINT_FILE))
        return self.artifact_dir(fp)

    def fingerprints(self) -> list[HardwareFingerprint]:
        """Registered cell fingerprints, sorted by key (deterministic)."""
        out = []
        for path in sorted(glob.glob(os.path.join(
                self.root, "*", FINGERPRINT_FILE))):
            try:
                out.append(HardwareFingerprint.load(path))
            except (OSError, KeyError, ValueError, json.JSONDecodeError):
                warnings.warn(f"skipping unreadable registry cell "
                              f"sidecar {path}", stacklevel=2)
        return out

    def resolve(self, fp: HardwareFingerprint) -> str | None:
        """Crash-repaired live artifact path for this fingerprint's own
        cell, or None when the cell is empty (cold node)."""
        return resolve_artifact(self.artifact_dir(fp))

    def nearest(self, fp: HardwareFingerprint, *,
                exclude_self: bool = True
                ) -> tuple[HardwareFingerprint, str] | None:
        """The closest cell that actually holds a servable artifact:
        ``(cell_fingerprint, artifact_path)``, or None when the registry
        has no populated cell (other than ``fp``'s own, when excluded).
        Distance ties break by key for determinism."""
        own = fp.key()
        best: tuple[float, str, HardwareFingerprint, str] | None = None
        for cand in self.fingerprints():
            if exclude_self and cand.key() == own:
                continue
            art = resolve_artifact(self.artifact_dir(cand))
            if art is None:
                continue
            entry = (fp.distance(cand), cand.key(), cand, art)
            if best is None or entry[:2] < best[:2]:
                best = entry
        if best is None:
            return None
        return best[2], best[3]

    # -- per-cell lifecycle --------------------------------------------
    def rollback(self, fp: HardwareFingerprint) -> None:
        """Swap the cell's ``artifact.prev`` back in (pure renames)."""
        rollback_artifact(self.artifact_dir(fp))

    def install(self, fp: HardwareFingerprint, backend: Any,
                cfg: InstallConfig, *,
                transfer_from: "str | Any | None" = None,
                verbose: bool = False) -> InstallReport:
        """Run a full install into this fingerprint's cell, atomically.

        The install stages into ``artifact.tmp``, stamps the ``COMMIT``
        sentinel only after both artifact files (plus the gathered-rows
        ``grid.npz``) are complete, and promotes with
        :func:`~repro.core.installer.commit_artifact` — a killed
        install leaves the cell's previous artifact serving.

        ``transfer_from`` is a donor artifact path (or ``"nearest"`` to
        let the registry pick the closest populated cell): the install
        then warm-starts from the donor's gathered rows and only times
        calibration cells locally (see
        :func:`~repro.core.installer.transfer_gather`).
        """
        art = self.register(fp)
        if transfer_from == "nearest":
            near = self.nearest(fp)
            transfer_from = near[1] if near is not None else None
        icfg = dataclasses.replace(cfg, fingerprint=fp)
        tmp = artifact_tmp_dir(art)
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        report = install(backend, icfg, artifact_dir=tmp,
                         transfer_from=transfer_from, verbose=verbose)
        with open(os.path.join(tmp, ARTIFACT_COMMIT), "w") as f:
            f.write("ok")
        commit_artifact(tmp, art)
        report.artifact_dir = art
        return report

    def adopt(self, fp: HardwareFingerprint, donor_artifact: str) -> str:
        """Cold-start a cell by *copying* a donor artifact into it (the
        zero-measurement fallback when no local install has run yet —
        e.g. serve boot on a cold node that wants its own cell for the
        re-install loop to target).  Atomic like any install: copy to
        tmp, COMMIT, promote.  Returns the cell's live artifact path."""
        if not is_artifact(donor_artifact):
            raise FileNotFoundError(
                f"no donor artifact at {donor_artifact}")
        art = self.register(fp)
        tmp = artifact_tmp_dir(art)
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        shutil.copytree(donor_artifact, tmp)
        sentinel = os.path.join(tmp, ARTIFACT_COMMIT)
        if not os.path.isfile(sentinel):
            with open(sentinel, "w") as f:
                f.write("ok")
        commit_artifact(tmp, art)
        return art


@dataclasses.dataclass
class ResolvedArtifact:
    """What :func:`resolve_serving_artifact` found for this node."""

    #: servable artifact path (None: registry entirely cold)
    path: str | None
    #: this node's fingerprint (the cell it *should* serve from)
    local: HardwareFingerprint
    #: fingerprint of the cell ``path`` came from (== local on an exact
    #: hit; a neighbour's on fallback; None when nothing resolved)
    cell: HardwareFingerprint | None
    #: True when ``path`` is the local fingerprint's own cell
    exact: bool


def resolve_serving_artifact(root: str, *,
                             fingerprint: HardwareFingerprint
                             | None = None,
                             mesh_shape: tuple[int, ...] = (1,),
                             allow_fallback: bool = True
                             ) -> ResolvedArtifact:
    """Resolve the artifact a serving process on *this* machine should
    load: fingerprint the host, prefer its own registry cell, and fall
    back to the nearest populated neighbour (with a warning — neighbour
    timings transfer only approximately; run a transfer install to make
    the cell local).
    """
    reg = ArtifactRegistry(root)
    fp = fingerprint if fingerprint is not None else \
        HardwareFingerprint.collect(mesh_shape=mesh_shape)
    own = reg.resolve(fp)
    if own is not None:
        return ResolvedArtifact(path=own, local=fp, cell=fp, exact=True)
    if allow_fallback:
        near = reg.nearest(fp)
        if near is not None:
            cell, art = near
            warnings.warn(
                f"registry {root} has no artifact for this machine "
                f"({fp.key()}); serving from nearest cell {cell.key()} "
                f"at distance {fp.distance(cell):.3f} — run a transfer "
                "install (ArtifactRegistry.install(..., "
                "transfer_from='nearest')) to localise it", stacklevel=2)
            return ResolvedArtifact(path=art, local=fp, cell=cell,
                                    exact=False)
    return ResolvedArtifact(path=None, local=fp, cell=None, exact=False)
