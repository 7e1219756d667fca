"""Runtime tuner (paper §III-C Fig 3 + §IV-A).

Loads the installation artifact once, then per BLAS-3 call predicts the
runtime of every candidate worker configuration and dispatches on the
argmin.  Implements the paper's memoisation: "the software is designed to
remember the last GEMM input and ML predictions; if the current GEMM
matrix dimensions are the same as the previous, the software will read
and apply the predictions ... without re-evaluation."  Beyond the paper
we keep a bounded LRU dict of *all* seen shapes, not just the last one
(training loops interleave a handful of distinct GEMM shapes — the
last-only cache thrashes; recorded in EXPERIMENTS.md §Perf), and the
cache key is ``(routine, m, k, n)`` so gemm / syrk / trsm calls with the
same dims never alias each other's choices.

Artifact compatibility: installations written before the routine
extension carry 19-column GEMM-only features and a v1 warm-start block.
``from_artifact`` detects both (via the persisted ``feature_names``) and
keeps serving them — gemm selections use the legacy feature layout, and
asking such a tuner for syrk/trsm raises instead of silently feeding the
model columns it was never fitted on.  The same guard applies to *new*
artifacts installed over a subset of ROUTINES (the persisted
``install.routines`` list): a gemm-only install has constant routine
feature columns, so its model has no idea how syrk/trsm behave — the
tuner refuses rather than hand out gemm-quality picks for them.
"""

from __future__ import annotations

import collections
import threading
import warnings
from typing import Any, Iterable

import numpy as np

from repro_torch.core.costmodel import (
    GemmConfig,
    PARTITIONS,
    ROUTINES,
    TRSM_SEQ_CHIPS,
    routine_ids,
)
from repro_torch.core.features import build_features
from repro_torch.core.installer import load_artifact
from repro_torch.core.preprocessing import PreprocessPipeline
from repro_torch.core.search.beam import beam_search
from repro_torch.core.search.space import ConfigSpace
from repro_torch.core.workload import WorkloadProfile

__all__ = ["AdsalaTuner"]

_PARTITIONS = ("M", "N", "K", "2D")

#: cache / warm-start key: (routine, m, k, n)
Key = tuple[str, int, int, int]


def _normalise_routines(shapes: list, routines) -> list[str]:
    """One routine name per shape, via the shared costmodel validator."""
    return [ROUTINES[i] for i in routine_ids(routines, len(shapes))]


def _flash_columns(cands: list[GemmConfig]
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-candidate (flash_bq, flash_bkv, flash_tri) feature columns."""
    return (np.asarray([c.flash_block[0] for c in cands], float),
            np.asarray([c.flash_block[1] for c in cands], float),
            np.asarray([float(c.flash_grid != "dense") for c in cands]))


class AdsalaTuner:
    """Predict-then-argmin worker-configuration selector."""

    def __init__(self, model: Any, pipe: PreprocessPipeline,
                 candidates: list[GemmConfig], *,
                 max_chips: int | None = None,
                 cache_size: int = 256,
                 feature_names: list[str] | None = None,
                 routines: tuple[str, ...] | None = None,
                 workload: WorkloadProfile | None = None,
                 space: ConfigSpace | None = None,
                 search_width: int | None = None) -> None:
        if max_chips is not None:
            candidates = [c for c in candidates if c.n_chips <= max_chips]
        if not candidates:
            raise ValueError("empty candidate set")
        self.model = model
        self.pipe = pipe
        self.candidates = candidates
        self.cache_size = cache_size
        #: the ConfigSpace dispatch-time search explores.  Artifacts
        #: since the search refactor persist theirs (``"space"`` block);
        #: otherwise reconstruct the default space the candidate list
        #: implies, so ``select(search=...)`` always has one.
        if space is None:
            present = tuple(p for p in PARTITIONS
                            if any(c.partition == p for c in candidates))
            space = ConfigSpace.default(
                max(c.n_chips for c in candidates),
                tiles=tuple(sorted({c.tile_id for c in candidates})),
                partitions=present)
            # Flash-aware installs enumerate from with_flash(); when the
            # candidate list carries non-default flash knobs the implied
            # space must too, else those candidates (and any warm-start
            # entries using them) fall outside `space.contains`.
            if any(c.flash_block_id != 0 or c.flash_grid != "dense"
                   for c in candidates):
                space = space.with_flash(block_ids=tuple(
                    sorted({c.flash_block_id for c in candidates})))
        self.space = space
        #: default beam width for ``select(search=True)``; None means
        #: fixed-candidate argmin unless a call opts in.
        self.search_width = search_width
        #: the WorkloadProfile the install grid was weighted by (None =
        #: uniform install / no provenance).  Serving code compares the
        #: live recorded mix against it (see :meth:`workload_drift`).
        self.workload = workload
        #: HardwareFingerprint the artifact was installed for (None =
        #: legacy artifact / no provenance); set by from_artifact.
        self.fingerprint = None
        #: ``describe_backend`` dict of the backend that timed the
        #: install grid (None = legacy artifact).  The serving
        #: re-install loop uses it to rebuild the same kind of backend.
        self.backend_info = None
        #: ``"transfer"`` provenance block for transfer-installed
        #: artifacts (donor path + fitted correction); None otherwise.
        self.transfer_info = None
        # fingerprint-mismatch warning latch: warn once per tuner, not
        # once per dispatch (see check_fingerprint)
        self._fp_warned = False
        # Three feature generations (see repro.core.features): gen-1
        # GEMM-only artifacts predate the routine columns, gen-2 BLAS-3
        # artifacts predate the flash columns.  Keep feeding each model
        # the exact layout it was fitted on.
        self._legacy_features = (feature_names is not None
                                 and "routine_syrk" not in feature_names)
        self._flash_features = (feature_names is None
                                or "routine_attn" in feature_names)
        # Routines the model was actually trained on (None = all):
        # selections outside this set would be extrapolation the model
        # has zero signal for, so they raise instead.
        if self._legacy_features and routines is None:
            routines = ("gemm",)
        elif not self._flash_features and routines is None:
            routines = ("gemm", "syrk", "trsm")
        self.routines = tuple(ROUTINES) if routines is None \
            else tuple(routines)
        for r in self.routines:
            if r not in ROUTINES:
                raise ValueError(f"unknown routine {r!r}; "
                                 f"expected one of {ROUTINES}")
        # key -> (config, predicted times).  times is None for warm-start
        # entries restored from the install artifact (only the argmin is
        # persisted); select_with_times lazily re-evaluates those.
        self._cache: collections.OrderedDict[
            Key, tuple[GemmConfig, np.ndarray | None]] = \
            collections.OrderedDict()
        # Guards the LRU dict + stats counters: serving threads hammer
        # select/select_many while a background re-install swaps tuners
        # (repro.serve.reinstall), and OrderedDict mutation is not safe
        # under concurrent move_to_end/popitem.  Model prediction runs
        # OUTSIDE the lock — concurrent selects never serialise on the
        # expensive part, and a duplicated evaluation of the same key is
        # benign (deterministic model, both writes agree).
        self._lock = threading.RLock()
        self.stats = {"calls": 0, "cache_hits": 0, "evaluations": 0}
        # pre-built candidate feature columns (constant across calls)
        self._chips = np.asarray([c.n_chips for c in candidates], float)
        self._tiles = np.asarray([c.tile_id for c in candidates], float)
        self._parts = np.asarray(
            [_PARTITIONS.index(c.partition) for c in candidates], float)
        self._flash = _flash_columns(candidates)

    @classmethod
    def from_artifact(cls, artifact_dir: str, *,
                      local_fingerprint: Any | None = None,
                      **kw: Any) -> "AdsalaTuner":
        """Load a persisted install.  ``local_fingerprint`` (a
        :class:`~repro.core.registry.HardwareFingerprint`) triggers a
        provenance check: an artifact installed for different hardware
        warns once.  Artifacts predating the ``"fingerprint"`` block
        load exactly as before (no provenance, no check)."""
        model, pipe, cands, config = load_artifact(artifact_dir)
        kw.setdefault("feature_names", config.get("feature_names"))
        installed = config.get("install", {}).get("routines")
        if installed is not None:
            kw.setdefault("routines", tuple(installed))
        if config.get("workload") is not None:
            kw.setdefault("workload",
                          WorkloadProfile.from_dict(config["workload"]))
        # Post-refactor artifacts persist the exact space the install
        # searched; legacy ones fall back to the constructor's implied
        # default space (reconstructed from the candidate list).
        if config.get("space") is not None:
            kw.setdefault("space", ConfigSpace.from_dict(config["space"]))
        tuner = cls(model, pipe, cands, **kw)
        ws = config.get("warm_start")
        # A max_chips filter renumbers/narrows the candidate set, so the
        # persisted warm choices no longer describe this tuner's search
        # space — start cold in that case.
        if ws and kw.get("max_chips") is None:
            if "cache_size" not in kw:
                # default capacity (256) is smaller than the default
                # install budget (400 dims): grow so the whole persisted
                # warm set survives; an explicit cache_size wins.
                tuner.cache_size = max(tuner.cache_size, len(ws["dims"]))
            # v1 blocks (pre-routine artifacts) carry no "routines" list:
            # every entry is a gemm choice.  v2 stores argmin indices
            # into the candidate list; v3 stores explicit config dicts
            # (beam-found configs need not sit in a fixed list).
            routines = ws.get("routines") or ["gemm"] * len(ws["dims"])
            # Validate against what the model has signal for: a
            # hand-edited or mixed-version artifact can carry warm
            # entries for routines outside the installed set, argmin
            # indices outside the candidate list, or configs outside
            # the persisted space.  Preloading those would serve stale
            # predictions from cache hits where live dispatch degrades
            # to gemm / raises — drop them instead.
            entries, dropped = [], 0
            if int(ws.get("version", 1)) >= 3:
                for r, d, cd in zip(routines, ws["dims"], ws["configs"]):
                    try:
                        c = GemmConfig(cd["n_chips"], cd["partition"],
                                       cd["tile_id"],
                                       cd.get("trsm_seq_chips",
                                              TRSM_SEQ_CHIPS),
                                       cd.get("flash_block_id", 0),
                                       cd.get("flash_grid", "dense"))
                    except (KeyError, TypeError):
                        dropped += 1
                        continue
                    if (r not in tuner.routines or len(d) != 3
                            or not tuner.space.contains(c)):
                        dropped += 1
                        continue
                    entries.append(((r, *d), c))
            else:
                for r, d, j in zip(routines, ws["dims"], ws["best"]):
                    if (r not in tuner.routines or len(d) != 3
                            or not 0 <= int(j) < len(cands)):
                        dropped += 1
                        continue
                    entries.append(((r, *d), cands[int(j)]))
            if dropped:
                warnings.warn(
                    f"{artifact_dir}: dropped {dropped}/{len(routines)} "
                    f"warm-start entries outside the installed routines "
                    f"{tuner.routines} / candidate space (hand-edited "
                    "or mixed-version artifact?)", stacklevel=2)
            tuner.warm_start(entries)
        # provenance (absent on legacy artifacts — loading must still
        # work, the tuner just has nothing to check against)
        if config.get("fingerprint") is not None:
            from repro_torch.core.registry import HardwareFingerprint  # no cycle
            tuner.fingerprint = HardwareFingerprint.from_dict(
                config["fingerprint"])
        tuner.backend_info = config.get("backend")
        tuner.transfer_info = config.get("transfer")
        if local_fingerprint is not None:
            tuner.check_fingerprint(local_fingerprint)
        return tuner

    def check_fingerprint(self, local: Any) -> bool:
        """True when the artifact's installed fingerprint matches this
        machine's (same registry key), or when the artifact carries no
        provenance.  A mismatch warns ONCE per tuner — dispatch-path
        callers may check freely without flooding the log."""
        if self.fingerprint is None or local is None:
            return True
        if self.fingerprint.key() == local.key():
            return True
        if not self._fp_warned:
            self._fp_warned = True
            warnings.warn(
                f"artifact was installed for "
                f"{self.fingerprint.key()} but is being served on "
                f"{local.key()} (distance "
                f"{self.fingerprint.distance(local):.3f}) — timings "
                "transfer only approximately; run a transfer install "
                "for this machine", stacklevel=2)
        return False

    def workload_drift(self, observed_mix: dict[str, float]
                       ) -> float | None:
        """Total-variation distance between the artifact's installed
        workload-profile routine mix and an observed serving mix (e.g.
        ``DispatchRecorder.routine_mix()``); None when the artifact
        carries no profile.  Large values mean the install budget was
        spent on a different workload than the one being served."""
        if self.workload is None:
            return None
        return self.workload.drift(observed_mix)

    # ------------------------------------------------------------------
    def _key(self, m: int, k: int, n: int, routine: str = "gemm") -> Key:
        return (routine, int(m), int(k), int(n))

    def peek(self, m: int, k: int, n: int,
             routine: str = "gemm") -> bool:
        """True when ``(routine, m, k, n)`` is already memoised — the
        next :meth:`select` for it will be a cache hit with no model
        evaluation.  Observability only: touches neither the LRU
        recency order nor the stats counters (the DispatchRecorder uses
        this to label events without perturbing what it measures)."""
        return self._key(m, k, n, routine) in self._cache

    def warm_start(self, entries: Iterable[
            tuple[tuple, GemmConfig]]) -> None:
        """Seed the memo cache with (shape -> config) choices computed at
        install time (persisted in the artifact's ``warm_start`` block).
        Keys are ``(routine, m, k, n)``; bare 3-tuples mean gemm."""
        with self._lock:
            for key, cfg in entries:
                if len(key) == 3:
                    key = ("gemm", *key)
                routine, m, k, n = key
                key = self._key(m, k, n, routine)
                self._cache[key] = (cfg, None)
                self._cache.move_to_end(key)
            self._evict()

    def _evict(self) -> None:
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    #: shapes per model-predict chunk.  Tree-ensemble predictors walk
    #: (rows x trees) working sets depth-many times; past ~16 shapes the
    #: set falls out of cache and one huge predict is *slower* than the
    #: scalar loop (measured 118ms vs 60ms for 64 shapes x 76 candidates).
    _PREDICT_CHUNK = 16

    def predicted_times_many(self, shapes: Iterable[tuple[int, int, int]],
                             routines=None, *,
                             candidates: list[GemmConfig] | None = None
                             ) -> np.ndarray:
        """Predicted runtimes for every (shape x candidate), shape (S, C).

        Batched feature build + preprocess + model predict; chunked to
        ``_PREDICT_CHUNK`` shapes per predict call to stay cache-resident.
        ``routines`` is None (all gemm), one name, or one name/id per
        shape.  ``candidates`` overrides the tuner's fixed list — this is
        how beam search prices arbitrary frontier configs with the same
        model (the feature set carries no ``trsm_seq_chips`` column, so
        configs differing only in that knob predict identically).
        """
        if candidates is None:
            cands = self.candidates
            chips, tiles, parts = self._chips, self._tiles, self._parts
            flash = self._flash
        else:
            cands = list(candidates)
            chips = np.asarray([c.n_chips for c in cands], float)
            tiles = np.asarray([c.tile_id for c in cands], float)
            parts = np.asarray(
                [_PARTITIONS.index(c.partition) for c in cands], float)
            flash = _flash_columns(cands)
        C = len(cands)
        shapes = list(shapes)
        if not shapes:
            return np.empty((0, C))
        names = _normalise_routines(shapes, routines)
        unseen = sorted({r for r in names if r not in self.routines})
        if unseen:
            raise ValueError(
                f"this artifact was installed for routines "
                f"{self.routines}; it has no training signal for "
                f"{unseen} — re-install with InstallConfig(routines=...) "
                "to tune them")
        rids = np.asarray([ROUTINES.index(r) for r in names], float)
        d = np.atleast_2d(np.asarray(shapes, dtype=np.float64))
        S = len(d)
        out = np.empty((S, C))
        for lo in range(0, S, self._PREDICT_CHUNK):
            chunk = d[lo:lo + self._PREDICT_CHUNK]
            B = len(chunk)
            X = build_features(
                np.repeat(chunk[:, 0], C), np.repeat(chunk[:, 1], C),
                np.repeat(chunk[:, 2], C),
                np.tile(chips, B), np.tile(tiles, B),
                np.tile(parts, B),
                None if self._legacy_features
                else np.repeat(rids[lo:lo + B], C).astype(np.int64),
                flash=tuple(np.tile(f, B) for f in flash)
                if self._flash_features and not self._legacy_features
                else None)
            out[lo:lo + B] = np.exp(
                self.model.predict(self.pipe.transform(X))).reshape(B, C)
        return out

    def predicted_times(self, m: int, k: int, n: int,
                        routine: str = "gemm") -> np.ndarray:
        """Predicted runtime (seconds) for every candidate config."""
        return self.predicted_times_many([(m, k, n)],
                                         routines=routine)[0]

    def select(self, m: int, k: int, n: int,
               routine: str = "gemm", *,
               search: bool | int | None = None) -> GemmConfig:
        """Optimal worker configuration for this routine call (memoised).

        ``search`` opts a cache miss into a dispatch-time beam search
        over :attr:`space` instead of the fixed-candidate argmin:
        ``True`` uses the artifact's default width (``search_width``,
        else 8), an int sets the width, ``False`` forces the fixed path,
        ``None`` defers to ``search_width``.
        """
        return self.select_many([(m, k, n)], routines=routine,
                                search=search)[0]

    def select_many(self, shapes: Iterable[tuple[int, int, int]],
                    routines=None, *,
                    search: bool | int | None = None) -> list[GemmConfig]:
        """Optimal configuration per shape, via ONE batched evaluation.

        Cache-missed shapes are deduplicated and predicted together (a
        grouped/MoE dispatch with E experts costs one model call, not E);
        hits keep the scalar path's LRU semantics.  ``routines`` follows
        :meth:`predicted_times_many`; ``search`` follows :meth:`select`
        — the beam path prices whole frontiers through the same model
        (one batched prediction per level) and can return configs
        outside the fixed candidate list when the artifact's space is
        wider.
        """
        shapes = list(shapes)
        names = _normalise_routines(shapes, routines)
        keys = [self._key(m, k, n, r)
                for (m, k, n), r in zip(shapes, names)]
        eff = search if search is not None else self.search_width
        if eff is True:
            eff = self.search_width or 8
        # Pass 1 (locked): classify hits vs misses.  Hit configs are
        # snapshotted immediately — a concurrent caller may evict them
        # from the LRU before pass 2 re-acquires the lock.
        hits: dict[Key, GemmConfig] = {}
        missing: list[Key] = []
        seen: set[Key] = set()
        with self._lock:
            self.stats["calls"] += len(keys)
            for key in keys:
                if key in self._cache:
                    hits.setdefault(key, self._cache[key][0])
                elif key not in seen:
                    seen.add(key)
                    missing.append(key)
            if missing:
                self.stats["evaluations"] += len(missing)
        # Evaluate misses OUTSIDE the lock: the model predict is the
        # expensive part and must not serialise concurrent serving
        # threads (a racing thread may duplicate an evaluation of the
        # same key — benign, the model is deterministic).
        chosen: dict[Key, tuple[GemmConfig, np.ndarray | None]] = {}
        if missing:
            if eff:
                res = beam_search(
                    np.asarray([k[1:] for k in missing], dtype=np.int64),
                    self.space,
                    cost_fn=lambda dd, cc, rr: self.predicted_times_many(
                        [tuple(int(x) for x in d) for d in dd],
                        routines=rr, candidates=cc),
                    width=int(eff), routines=[k[0] for k in missing])
                for key, cfgs in zip(missing, res.configs):
                    # beam picks are not a row over self.candidates, so
                    # there is no times vector to memoise (None = lazy
                    # re-evaluation in select_with_times, like warm start)
                    chosen[key] = (cfgs[0], None)
            else:
                times = self.predicted_times_many(
                    [k[1:] for k in missing],
                    routines=[k[0] for k in missing])
                best = np.argmin(times, axis=1)
                for key, j, t in zip(missing, best, times):
                    chosen[key] = (self.candidates[int(j)], t)
        # Pass 2 (locked): publish evaluations, refresh LRU recency.
        out = []
        served: set[Key] = set()
        with self._lock:
            for key, entry in chosen.items():
                self._cache[key] = entry
            for key in keys:
                # every occurrence beyond the one that paid an
                # evaluation is a cache hit, mirroring the scalar
                # path's per-call counters
                if key in seen and key not in served:
                    served.add(key)
                else:
                    self.stats["cache_hits"] += 1
                if key not in self._cache:
                    # hit evicted by a concurrent caller between the
                    # passes: reinsert the snapshot taken under lock
                    self._cache[key] = (hits[key], None)
                self._cache.move_to_end(key)
                out.append(self._cache[key][0])
            self._evict()
        return out

    def select_with_times(self, m: int, k: int, n: int,
                          routine: str = "gemm"
                          ) -> tuple[GemmConfig, np.ndarray]:
        key = self._key(m, k, n, routine)
        entry = None
        for _ in range(4):         # concurrent eviction between the
            self.select(m, k, n, routine)   # select and the read is
            with self._lock:                # possible; retry (bounded)
                entry = self._cache.get(key)
            if entry is not None:
                break
        if entry is None:          # pathological thrash: compute direct
            times = self.predicted_times(m, k, n, routine)
            return self.candidates[int(np.argmin(times))], times
        cfg, times = entry
        if times is None:          # warm-start entry: argmin only
            times = self.predicted_times(m, k, n, routine)
            with self._lock:
                self._cache[key] = (cfg, times)
        return cfg, times

    # ------------------------------------------------------------------
    def swap_from_artifact(self, artifact_dir: str, *,
                           carry_warm: bool = True,
                           **kw: Any) -> "AdsalaTuner":
        """Build this tuner's replacement from a freshly installed
        artifact (the in-memory half of an online re-install hot-swap).

        Returns a NEW tuner — the caller publishes it with one reference
        assignment (see :class:`repro.serve.reinstall.ReinstallManager`),
        so in-flight selects finish on whichever tuner they started on
        and a torn old/new mix is impossible.  The LRU cache lives
        inside each instance, i.e. it is keyed per-artifact by
        construction: no stale choice of the outgoing model can survive
        into the replacement.

        ``carry_warm`` transplants the *working set*, not the choices:
        the outgoing cache's hot ``(routine, m, k, n)`` keys (filtered
        to routines the new artifact has signal for) are re-selected
        through the new model in one batched pass before the swap
        becomes visible, so post-swap traffic starts on cache hits
        without ever serving the old artifact's picks.
        """
        new = type(self).from_artifact(artifact_dir, **kw)
        if carry_warm:
            with self._lock:
                hot = list(self._cache.keys())
            hot = [key for key in hot if key[0] in new.routines]
            if hot:
                new.cache_size = max(new.cache_size,
                                     len(new._cache) + len(hot))
                new.select_many([key[1:] for key in hot],
                                routines=[key[0] for key in hot])
                new.stats = {"calls": 0, "cache_hits": 0,
                             "evaluations": 0}
        return new
