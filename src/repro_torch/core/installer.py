"""ADSALA installation workflow (paper §III-B, Fig 2).

    sample GEMM domain (scrambled Halton)
      -> time every candidate worker config (separate "executions")
      -> preprocess (YJ + standardise + LOF + correlation pruning)
      -> CV hyper-tune every candidate model
      -> measure per-model evaluation latency t_eval on this host
      -> select by estimated speedup  s = t_orig / (t_ADSALA + t_eval)
      -> persist two files: config.json + model.json (paper Fig 2)

The installer returns an ``InstallReport`` whose rows are exactly the
columns of the paper's Tables III/IV.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core.costmodel import ROUTINES, GemmConfig, routine_ids
from repro_torch.core.features import FEATURE_NAMES, build_features
from repro_torch.core.halton import sample_gemm_dims
from repro_torch.core.ml import grid_search, make_model, rmse
from repro_torch.core.ml.base import normalised_rmse, stratified_train_test_split
from repro_torch.core.ml.registry import default_param_grids, model_from_dict
from repro_torch.core.preprocessing import PreprocessPipeline
from repro_torch.core.timing import (
    SimulatedBackend,
    TimingBackend,
    describe_backend,
    time_routine_cells,
    time_routine_grid,
)

__all__ = [
    "GatheredData", "InstallConfig", "ModelReport", "InstallReport",
    "gather_data", "transfer_gather", "install", "load_artifact",
    "default_config", "DEFAULT_WORKER_CONFIG",
    "artifact_tmp_dir", "artifact_prev_dir", "is_artifact",
    "commit_artifact", "rollback_artifact", "resolve_artifact",
]

_PARTITIONS = ("M", "N", "K", "2D")

#: The "use every core" default the paper benchmarks against: all chips,
#: 2D sharding, mid-size tile.
DEFAULT_WORKER_CONFIG = GemmConfig(n_chips=512, partition="2D", tile_id=3)


@dataclasses.dataclass
class InstallConfig:
    n_samples: int = 400
    mem_limit_mb: int = 500
    dtype_bytes: int = 2
    repeats: int = 3                      # paper: 10 iterations per input
    max_chips: int = 512
    #: BLAS-3 routines the install grid covers (arXiv 2406.19621:
    #: routine-aware install).  Without a workload profile the budget is
    #: split ~evenly per routine; with one, proportionally to the
    #: profile's routine weights (with an even floor).
    routines: tuple[str, ...] = ("gemm",)
    #: Recorded :class:`~repro.core.workload.WorkloadProfile` (or None):
    #: when set, routine quotas follow the profile's routine weights and
    #: ``workload_bias`` of the Halton budget is drawn from the
    #: profile's observed shape regions instead of the uniform box.
    workload: Any | None = None
    #: fraction of samples biased toward the profile's shape regions
    #: (and of the routine budget allocated proportionally); the
    #: remaining ``1 - workload_bias`` is the uniform coverage floor.
    workload_bias: float = 0.75
    tile_ids: tuple[int, ...] = (0, 1, 3, 5)
    train_cfgs_per_dim: int = 12          # row subsample for training
    models: tuple[str, ...] = (
        "linear_regression", "elasticnet", "bayesian_regression",
        "decision_tree", "random_forest", "adaboost", "xgboost",
        "lightgbm")
    grid_budget: str = "small"
    cv_splits: int = 3
    test_fraction: float = 0.3
    seed: int = 0
    #: uniform sampling of the (m,k,n) domain, as in the paper (Fig 9's
    #: contour-bounded domain); log-space is an opt-in alternative that
    #: emphasises small GEMMs.
    log_space: bool = False
    dim_min: int = 8
    dim_max: int = 65536
    #: steady-state fraction of GEMM calls whose dims hit the tuner's
    #: memo cache (paper §III-C: "GEMM usage is within a loop with the
    #: same GEMM input size").  Selection uses the warm estimate; the
    #: cold (hit rate 0) estimate is reported alongside.
    cache_hit_rate: float = 0.9
    default_config: GemmConfig = DEFAULT_WORKER_CONFIG
    #: Declarative candidate space (a repro.core.search.ConfigSpace).
    #: None means the default space implied by (max_chips, tile_ids) —
    #: whose enumeration is bit-for-bit the historical candidate list.
    space: Any | None = None
    #: Total (dim, config) cells the install may *time*.  None keeps the
    #: dense grid (every dim x every config).  A budget switches
    #: gather_data to beam-survivor timing: per dim, the analytic cost
    #: model beam-searches the space and only the leaders (plus a
    #: low-discrepancy exploration slice and the default config) are
    #: actually measured — the effective candidate space can grow 10x
    #: without 10x timing cost.
    timing_budget: int | None = None
    #: beam width for budgeted installs (and the README comparison)
    beam_width: int = 8
    #: fraction of each dim's timing quota spent on Halton-sampled
    #: exploration configs instead of beam survivors (guards the model
    #: against the prior's blind spots)
    explore_fraction: float = 0.25
    #: :class:`repro.core.registry.HardwareFingerprint` (or its dict
    #: form) of the machine this install targets; persisted under
    #: ``"fingerprint"`` in config.json so ``from_artifact`` can warn
    #: when an artifact is served on different hardware.  None keeps
    #: the legacy anonymous-artifact layout.
    fingerprint: Any | None = None
    #: transfer installs (``install(..., transfer_from=...)``): how
    #: many donor dims get re-timed on the local backend to fit the
    #: cross-arch correction.
    calibration_dims: int = 32
    #: per calibration dim, how many of the donor's fastest timed
    #: columns to re-time locally (the donor's beam survivors); the
    #: donor's default-config column is always added on top.
    calibration_top_k: int = 4

    @property
    def mem_limit_bytes(self) -> int:
        return self.mem_limit_mb * 2**20

    def resolved_space(self):
        """The ConfigSpace this install searches/enumerates.  Installs
        covering ``attn`` get the flash axes appended (idempotent) —
        the flash knobs only exist to be timed for attention rows."""
        from repro_torch.core.search.space import ConfigSpace  # local: no cycle
        space = self.space if self.space is not None \
            else ConfigSpace.default(self.max_chips, tiles=self.tile_ids)
        if "attn" in self.routines:
            space = space.with_flash()
        return space


def default_config(**overrides: Any) -> InstallConfig:
    return dataclasses.replace(InstallConfig(), **overrides)


def _config_dict(c: GemmConfig) -> dict:
    """JSON form of a config; the TRSM and flash knobs only appear when
    they left their historical defaults, so pre-search (and pre-flash)
    readers keep parsing."""
    d = {"n_chips": c.n_chips, "partition": c.partition,
         "tile_id": c.tile_id}
    if c.trsm_seq_chips != costmodel.TRSM_SEQ_CHIPS:
        d["trsm_seq_chips"] = c.trsm_seq_chips
    if c.flash_block_id != 0:
        d["flash_block_id"] = c.flash_block_id
    if c.flash_grid != "dense":
        d["flash_grid"] = c.flash_grid
    return d


def _config_from_dict(d: dict) -> GemmConfig:
    return GemmConfig(d["n_chips"], d["partition"], d["tile_id"],
                      d.get("trsm_seq_chips", costmodel.TRSM_SEQ_CHIPS),
                      d.get("flash_block_id", 0),
                      d.get("flash_grid", "dense"))


@dataclasses.dataclass
class GatheredData:
    """Long-format timing table + the full (dim x cfg) matrix."""

    dims: np.ndarray                       # (D, 3) int64
    cfgs: list[GemmConfig]                 # C candidates
    times: np.ndarray                      # (D, C) median seconds
    #: per-dim ROUTINES id; None means an all-gemm (pre-routine) grid
    routines: np.ndarray | None = None     # (D,) int64
    #: WorkloadProfile.to_dict() provenance when the grid was
    #: mix-weighted; None for uniform installs
    workload: dict | None = None
    #: (D, C) bool — which cells were actually timed.  None means a
    #: dense grid (every cell).  Budgeted installs only time beam
    #: survivors + exploration configs; un-timed cells hold +inf.
    mask: np.ndarray | None = None
    #: ConfigSpace.to_dict() provenance of the space the candidate
    #: columns came from; None for pre-search grids.
    space: dict | None = None

    def routine_ids(self) -> np.ndarray:
        """(D,) ROUTINES ids, zeros for pre-routine grids."""
        if self.routines is None:
            return np.zeros(len(self.dims), dtype=np.int64)
        return np.asarray(self.routines, dtype=np.int64)

    def routine_names(self) -> list[str]:
        return [ROUTINES[int(r)] for r in self.routine_ids()]

    def timed_mask(self) -> np.ndarray:
        """(D, C) bool of measured cells (all True for dense grids)."""
        if self.mask is None:
            return np.ones(self.times.shape, dtype=bool)
        return np.asarray(self.mask, dtype=bool)

    def optimal_worker_index(self) -> np.ndarray:
        if self.mask is None:
            return np.argmin(self.times, axis=1)
        return np.argmin(np.where(self.timed_mask(), self.times, np.inf),
                         axis=1)

    def to_rows(self, *, per_dim: int | None = None, seed: int = 0
                ) -> tuple[np.ndarray, np.ndarray]:
        """(X_features, y_log_time) long format, optionally subsampling
        configs per dim (the paper separates runs per thread count).
        Only timed cells become rows (budgeted grids are sparse).

        Flash knobs are inert off attn rows, so on a flash-extended grid
        a gemm/syrk/trsm dim sees up to ``len(FLASH_BLOCKS) * 2``
        feature-identical columns per effective config; sampling those
        duplicates would eat the per-dim quota without adding training
        diversity.  Non-attn rows therefore subsample from one
        representative column per (n_chips, partition, tile_id,
        trsm_seq_chips) — the flash-default one when the grid carries it.
        """
        rng = np.random.default_rng(seed)
        D, C = self.times.shape
        rids = self.routine_ids()
        attn_id = ROUTINES.index("attn")
        timed = self.timed_mask()
        # one representative column per non-flash config, defaults first
        rep = np.zeros(C, dtype=bool)
        seen_base: set[tuple] = set()
        for j in sorted(range(C),
                        key=lambda j: (self.cfgs[j].flash_block_id != 0
                                       or self.cfgs[j].flash_grid
                                       != "dense")):
            c = self.cfgs[j]
            base = (c.n_chips, c.partition, c.tile_id, c.trsm_seq_chips)
            if base not in seen_base:
                seen_base.add(base)
                rep[j] = True
        rows_X, rows_y = [], []
        for i in range(D):
            pool = np.flatnonzero(timed[i])
            if rids[i] != attn_id:
                dedup = pool[rep[pool]]
                if len(dedup):
                    pool = dedup
            js = (pool if per_dim is None or per_dim >= len(pool)
                  else rng.choice(pool, size=per_dim, replace=False))
            m, k, n = self.dims[i]
            for j in js:
                cfg = self.cfgs[j]
                rows_X.append((m, k, n, cfg.n_chips, cfg.tile_id,
                               _PARTITIONS.index(cfg.partition), rids[i],
                               cfg.flash_block[0], cfg.flash_block[1],
                               float(cfg.flash_grid != "dense")))
                rows_y.append(self.times[i, j])
        raw = np.asarray(rows_X, dtype=np.float64)
        X = build_features(raw[:, 0], raw[:, 1], raw[:, 2], raw[:, 3],
                           raw[:, 4], raw[:, 5],
                           raw[:, 6].astype(np.int64),
                           flash=(raw[:, 7], raw[:, 8], raw[:, 9]))
        y = np.log(np.maximum(np.asarray(rows_y), 1e-12))
        return X, y

    def save(self, path: str) -> None:
        extra = {}
        if self.workload is not None:
            extra["workload_json"] = np.asarray(json.dumps(self.workload))
        if self.mask is not None:
            extra["mask"] = self.timed_mask().astype(np.uint8)
        if self.space is not None:
            extra["space_json"] = np.asarray(json.dumps(self.space))
        np.savez_compressed(
            path, dims=self.dims, times=self.times,
            routines=self.routine_ids(),
            cfg_chips=np.asarray([c.n_chips for c in self.cfgs]),
            cfg_tile=np.asarray([c.tile_id for c in self.cfgs]),
            cfg_part=np.asarray(
                [_PARTITIONS.index(c.partition) for c in self.cfgs]),
            cfg_seq=np.asarray(
                [c.trsm_seq_chips for c in self.cfgs]),
            cfg_fblock=np.asarray(
                [c.flash_block_id for c in self.cfgs]),
            cfg_ftri=np.asarray(
                [int(c.flash_grid != "dense") for c in self.cfgs]),
            **extra)

    @classmethod
    def load(cls, path: str, config: dict | str | None = None
             ) -> "GatheredData":
        """Load a persisted grid.

        ``config`` is the install's sidecar ``config.json`` (a parsed
        dict or a path to it); when given — or when a ``config.json``
        sits next to the ``.npz`` — a grid whose npz predates the
        ``routines`` array is cross-checked against it: if the sidecar
        says the install was mixed-routine, the timing rows CANNOT all
        be gemm, and silently labelling them so would poison any model
        retrained from the file — raise instead.
        """
        z = np.load(path)
        n_cfg = len(z["cfg_chips"])
        seqs = (z["cfg_seq"] if "cfg_seq" in z.files
                else np.full(n_cfg, costmodel.TRSM_SEQ_CHIPS))
        fblocks = (z["cfg_fblock"] if "cfg_fblock" in z.files
                   else np.zeros(n_cfg, dtype=np.int64))
        ftris = (z["cfg_ftri"] if "cfg_ftri" in z.files
                 else np.zeros(n_cfg, dtype=np.int64))
        cfgs = [GemmConfig(int(c), _PARTITIONS[int(p)], int(t), int(s),
                           int(fb), "tri" if ft else "dense")
                for c, t, p, s, fb, ft in zip(
                    z["cfg_chips"], z["cfg_tile"], z["cfg_part"], seqs,
                    fblocks, ftris)]
        routines = (z["routines"].astype(np.int64)
                    if "routines" in z.files else None)
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        elif config is None:
            sidecar = os.path.join(os.path.dirname(os.path.abspath(path)),
                                   "config.json")
            if os.path.exists(sidecar):
                with open(sidecar) as f:
                    config = json.load(f)
        if routines is None and config is not None:
            installed = config.get("install", {}).get("routines")
            if installed is not None and set(installed) != {"gemm"}:
                raise ValueError(
                    f"{path} has no 'routines' array but its install "
                    f"config says the grid mixed routines {installed}; "
                    "refusing to mislabel every timing row as gemm — "
                    "re-gather the grid or load with the matching "
                    "config.json")
        workload = (json.loads(str(z["workload_json"]))
                    if "workload_json" in z.files else None)
        mask = (z["mask"].astype(bool) if "mask" in z.files else None)
        space = (json.loads(str(z["space_json"]))
                 if "space_json" in z.files else None)
        return cls(dims=z["dims"], cfgs=cfgs, times=z["times"],
                   routines=routines, workload=workload, mask=mask,
                   space=space)


def _assign_routines(cfg: InstallConfig, n: int) -> np.ndarray:
    """Per-dim ROUTINES ids for an ``n``-sample grid.

    Budget split: even across ``cfg.routines`` without a workload
    profile, quota-weighted with one.  Assignment order is a seeded
    permutation, NOT ``i % len(routines)`` cycling: the Halton sequence
    is deterministic and low-discrepancy, so a fixed index stride is
    itself low-discrepancy *within each residue class* — routine id
    becomes perfectly correlated with sample index and every routine
    trains on a systematically different stratum of the shape box (the
    base-3 column's leading digit cycles with period 3, exactly the
    stride a 3-routine install used).  The permutation decouples them
    while staying reproducible via ``cfg.seed``.
    """
    if cfg.workload is not None:
        quotas = cfg.workload.routine_quotas(
            cfg.routines, n, floor=1.0 - cfg.workload_bias)
        counts = [quotas[r] for r in cfg.routines]
    else:
        counts = [len(range(i, n, len(cfg.routines)))
                  for i in range(len(cfg.routines))]
    names = np.repeat(np.asarray(cfg.routines, dtype=object), counts)
    perm = np.random.default_rng(cfg.seed).permutation(n)
    return routine_ids(list(names[perm]), n)


def gather_data(backend: TimingBackend, cfg: InstallConfig) -> GatheredData:
    """Paper Fig 2 'data gathering': Halton-sample the domain, run each
    (input x worker-config) ``repeats`` times, keep the median.

    A mixed-routine install spreads the budget over ``cfg.routines``
    (see :func:`_assign_routines`); the whole grid is still timed in
    batched passes (one per repeat).  With ``cfg.workload`` set, the
    sampled dims are drawn from the profile's observed shape regions
    (``cfg.workload_bias`` fraction, uniform floor for the rest) and
    the routine budget follows the profile's routine weights — install
    effort goes where serving volume actually is.

    Candidate generation routes through ``cfg.resolved_space()``.
    Without a ``timing_budget`` the space is enumerated and every
    (dim x config) cell is timed — for the default space that is
    bit-for-bit the historical grid.  With a budget, an analytic-model
    beam search (:func:`repro.core.search.beam.beam_search`) picks each
    dim's most promising configs and only those — plus a Halton
    exploration slice shared across dims and the always-timed default
    config — are measured; the rest of the grid stays +inf behind
    ``GatheredData.mask``.
    """
    if cfg.workload is not None:
        dims = cfg.workload.sample_dims(
            cfg.n_samples, bias=cfg.workload_bias,
            mem_limit_bytes=cfg.mem_limit_bytes,
            dtype_bytes=cfg.dtype_bytes, seed=cfg.seed,
            dim_min=cfg.dim_min, dim_max=cfg.dim_max,
            log_space=cfg.log_space)
    else:
        dims = sample_gemm_dims(
            cfg.n_samples, mem_limit_bytes=cfg.mem_limit_bytes,
            dtype_bytes=cfg.dtype_bytes, seed=cfg.seed,
            dim_min=cfg.dim_min, dim_max=cfg.dim_max,
            log_space=cfg.log_space)
    space = cfg.resolved_space()
    rids = _assign_routines(cfg, len(dims))
    workload = None if cfg.workload is None else cfg.workload.to_dict()

    if cfg.timing_budget is None:
        cfgs = space.enumerate()
        times = time_routine_grid(backend, dims, cfgs, cfg.repeats,
                                  routines=rids)
        return GatheredData(dims=dims, cfgs=cfgs, times=times,
                            routines=rids, workload=workload,
                            space=space.to_dict())

    # --- budgeted install: time beam survivors, not the grid --------------
    from repro_torch.core.search.beam import beam_search  # local: no cycle

    D = len(dims)
    quota = max(2, cfg.timing_budget // D)     # cells per dim, >= 2
    n_explore = int(round(cfg.explore_fraction * (quota - 1)))
    n_beam = max(1, quota - 1 - n_explore)
    beam = beam_search(dims, space, width=max(cfg.beam_width, n_beam),
                       top_k=n_beam, routines=rids,
                       spec=getattr(backend, "spec", None),
                       dtype_bytes=cfg.dtype_bytes)
    explore = space.sample(n_explore, seed=cfg.seed) if n_explore else []

    col: dict[GemmConfig, int] = {}
    rows_js: list[list[int]] = []
    for d in range(D):
        js = []
        for c in [cfg.default_config] + beam.configs[d] + explore:
            if c not in col:
                col[c] = len(col)
            if col[c] not in js:
                js.append(col[c])
        rows_js.append(js)
    cfgs = list(col)
    mask = np.zeros((D, len(cfgs)), dtype=bool)
    for d, js in enumerate(rows_js):
        mask[d, js] = True
    times = time_routine_cells(backend, dims, cfgs, mask, cfg.repeats,
                               routines=rids)
    return GatheredData(dims=dims, cfgs=cfgs, times=times, routines=rids,
                        workload=workload, mask=mask,
                        space=space.to_dict())


def transfer_gather(backend: TimingBackend, cfg: InstallConfig,
                    donor_dir: str
                    ) -> tuple[GatheredData, dict]:
    """Warm-start a local grid from a donor artifact's gathered rows.

    The cross-arch transfer of the model-driven adaptive-libraries line
    (arXiv 1806.07060): instead of re-timing the donor's full
    (dim x config) grid on this machine, re-time only
    ``cfg.calibration_dims`` donor dims — per dim, the donor's
    ``calibration_top_k`` fastest timed columns (its beam survivors)
    plus the default config — via :func:`time_routine_cells`, fit a
    multiplicative correction in log space
    (``median(log t_local - log t_donor)``) per routine, refined per
    (routine, config) column where calibration measured that column,
    and apply it to every donor cell.  Locally measured cells keep
    their measured value; the
    rest carry the corrected donor estimate.  The returned grid feeds
    the standard :func:`install` machinery, so a new machine cold-starts
    at a few-dozen-sample fraction of the donor's timing budget.

    Returns ``(corrected_grid, transfer_info)`` where ``transfer_info``
    is the JSON-able provenance block persisted under ``"transfer"``.
    """
    grid_path = os.path.join(donor_dir, "grid.npz")
    if not os.path.isfile(grid_path):
        raise FileNotFoundError(
            f"donor artifact {donor_dir} has no grid.npz — it predates "
            "transfer-capable installs; re-install the donor or run a "
            "from-scratch install here")
    donor = GatheredData.load(grid_path)
    donor_config = None
    cfg_path = os.path.join(donor_dir, "config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            donor_config = json.load(f)

    D, C = donor.times.shape
    rids = donor.routine_ids()
    timed = donor.timed_mask() & np.isfinite(donor.times)
    rng = np.random.default_rng(cfg.seed)
    n_cal = max(1, min(cfg.calibration_dims, D))

    # calibration dims: stratified across the donor's routines so every
    # routine's correction is fit from its own measurements
    unique_rids = sorted(set(int(r) for r in rids))
    quota = {r: n_cal // len(unique_rids) for r in unique_rids}
    for i, r in enumerate(unique_rids):
        if i < n_cal % len(unique_rids):
            quota[r] += 1
    chosen: list[int] = []
    for r in unique_rids:
        pool = np.flatnonzero(rids == r)
        take = min(quota[r], len(pool))
        if take:
            chosen.extend(rng.choice(pool, size=take,
                                     replace=False).tolist())
    if len(chosen) < n_cal:
        rest = np.setdiff1d(np.arange(D), np.asarray(chosen, dtype=int))
        extra = min(n_cal - len(chosen), len(rest))
        if extra:
            chosen.extend(rng.choice(rest, size=extra,
                                     replace=False).tolist())
    cal_idx = np.asarray(sorted(chosen), dtype=int)

    try:
        j_default = donor.cfgs.index(cfg.default_config)
    except ValueError:
        j_default = None
    cal_mask = np.zeros((D, C), dtype=bool)
    for i in cal_idx:
        js = np.flatnonzero(timed[i])
        if not len(js):
            continue
        order = js[np.argsort(donor.times[i, js])]
        take = list(order[:max(1, cfg.calibration_top_k)])
        if (j_default is not None and timed[i, j_default]
                and j_default not in take):
            take.append(j_default)
        cal_mask[i, take] = True

    local = time_routine_cells(backend, donor.dims, donor.cfgs, cal_mask,
                               cfg.repeats, routines=rids)
    meas = cal_mask & np.isfinite(local)
    log_delta = np.zeros_like(local)      # only meas entries are read
    log_delta[meas] = (np.log(np.maximum(local[meas], 1e-12))
                       - np.log(np.maximum(donor.times[meas], 1e-12)))
    all_deltas = log_delta[meas]
    global_delta = float(np.median(all_deltas)) if len(all_deltas) else 0.0
    corrected = donor.times.copy()
    per_routine_delta: dict[str, float] = {}
    for r in unique_rids:
        sel = meas & (rids == r)[:, None]
        d_r = float(np.median(log_delta[sel])) if sel.any() \
            else global_delta
        per_routine_delta[ROUTINES[r]] = d_r
        rowsel = rids == r
        corrected[rowsel] = donor.times[rowsel] * np.exp(d_r)
        # column refinement: calibration times the donor's fastest
        # columns on *every* calibration dim, so most (routine, config)
        # pairs carry their own local measurements — a per-column
        # median captures config-level differences (a cache hierarchy
        # reordering the blocking knob) that a routine-wide scalar
        # cannot
        for j in range(C):
            cj = sel[:, j]
            n_rj = int(cj.sum())
            if n_rj:
                # shrink toward the routine median: a column delta fit
                # from one or two noisy samples should not scale the
                # whole column on its own
                w = n_rj / (n_rj + 1.0)
                d_rj = (w * float(np.median(log_delta[cj, j]))
                        + (1.0 - w) * d_r)
                corrected[rowsel, j] = donor.times[rowsel, j] \
                    * np.exp(d_rj)
    corrected[meas] = local[meas]       # measured truth beats estimates

    data = GatheredData(dims=donor.dims, cfgs=donor.cfgs,
                        times=corrected, routines=donor.routines,
                        workload=donor.workload, mask=donor.mask,
                        space=donor.space)
    info = {
        "donor": os.path.abspath(donor_dir),
        "donor_fingerprint": (donor_config or {}).get("fingerprint"),
        "donor_backend": (donor_config or {}).get("backend"),
        "calibration_dims": int(len(cal_idx)),
        "calibration_cells": int(meas.sum()),
        "donor_cells": int(timed.sum()),
        "log_delta_per_routine": per_routine_delta,
        "global_log_delta": global_delta,
    }
    return data, info


@dataclasses.dataclass
class ModelReport:
    """One row of the paper's Tables III/IV."""

    name: str
    params: dict[str, Any]
    test_rmse: float
    normalised_rmse: float
    eval_time_us: float
    ideal_mean_speedup: float
    ideal_aggregate_speedup: float
    est_mean_speedup: float          # cold: every call pays t_eval
    est_aggregate_speedup: float
    warm_est_mean_speedup: float     # steady state with memo cache
    warm_est_aggregate_speedup: float
    #: routine name -> held-out speedup stats for that routine's dims
    #: (the per-routine Tables III/IV analogue of arXiv 2406.19621)
    per_routine: dict[str, dict[str, float]] = \
        dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class InstallReport:
    selected: str
    reports: list[ModelReport]
    artifact_dir: str | None

    def table(self) -> str:
        hdr = (f"{'model':20s} {'nrmse':>7s} {'ideal_mean':>10s} "
               f"{'ideal_agg':>9s} {'t_eval_us':>9s} {'est_mean':>8s} "
               f"{'est_agg':>8s} {'warm_mean':>9s} {'warm_agg':>8s}")
        lines = [hdr]
        for r in self.reports:
            lines.append(
                f"{r.name:20s} {r.normalised_rmse:7.3f} "
                f"{r.ideal_mean_speedup:10.3f} "
                f"{r.ideal_aggregate_speedup:9.3f} {r.eval_time_us:9.1f} "
                f"{r.est_mean_speedup:8.3f} {r.est_aggregate_speedup:8.3f} "
                f"{r.warm_est_mean_speedup:9.3f} "
                f"{r.warm_est_aggregate_speedup:8.3f}")
        lines.append(f"selected: {self.selected}")
        rt = self.routine_table()
        if rt:
            lines.append(rt)
        return "\n".join(lines)

    def routine_table(self) -> str:
        """Per-routine speedup rows for the selected model (empty string
        for single-routine installs)."""
        sel = next((r for r in self.reports if r.name == self.selected),
                   None)
        if sel is None or len(sel.per_routine) <= 1:
            return ""
        lines = [f"{'routine':8s} {'n_test':>6s} {'ideal_mean':>10s} "
                 f"{'ideal_agg':>9s} {'warm_mean':>9s} {'warm_agg':>8s}"]
        for routine, s in sel.per_routine.items():
            lines.append(
                f"{routine:8s} {int(s['n_test']):6d} "
                f"{s['ideal_mean_speedup']:10.3f} "
                f"{s['ideal_aggregate_speedup']:9.3f} "
                f"{s['warm_est_mean_speedup']:9.3f} "
                f"{s['warm_est_aggregate_speedup']:8.3f}")
        return "\n".join(lines)


def _measure_eval_time(model: Any, pipe: PreprocessPipeline,
                       n_candidates: int, *, iters: int = 30) -> float:
    """Latency of one runtime tuner evaluation (features -> argmin), in µs.

    This is the paper's t_eval: it charges the *whole* per-call path —
    feature build, preprocessing transform and batched model prediction
    over the candidate set.
    """
    Xq = build_features(
        np.full(n_candidates, 512.0), np.full(n_candidates, 512.0),
        np.full(n_candidates, 512.0),
        np.maximum(1, np.arange(n_candidates) % 9),
        np.arange(n_candidates) % 8, np.arange(n_candidates) % 4,
        np.arange(n_candidates) % len(ROUTINES),
        flash=(np.full(n_candidates, 512.0),
               np.full(n_candidates, 512.0),
               np.arange(n_candidates) % 2))
    # warmup
    model.predict(pipe.transform(Xq))
    t0 = time.perf_counter()
    for _ in range(iters):
        model.predict(pipe.transform(Xq))
    return (time.perf_counter() - t0) / iters * 1e6


def _predict_best_configs(model: Any, pipe: PreprocessPipeline,
                          dims: np.ndarray, cfgs: list[GemmConfig],
                          routines: np.ndarray | None = None,
                          mask: np.ndarray | None = None) -> np.ndarray:
    """Predicted-argmin candidate index for every dim, shape (D,).

    Delegates to the runtime tuner's own batched prediction so the
    persisted warm-start choices are, by construction, exactly what the
    tuner would compute for the same artifact.  With ``mask`` (budgeted
    installs) the argmin is restricted to each dim's timed columns —
    the model may only pick configs whose ground truth exists.
    """
    from repro_torch.core.tuner import AdsalaTuner  # local: breaks import cycle

    tuner = AdsalaTuner(model, pipe, cfgs)
    times = tuner.predicted_times_many(
        [(int(m), int(k), int(n)) for m, k, n in np.asarray(dims)],
        routines=None if routines is None else list(routines))
    if mask is not None:
        times = np.where(np.asarray(mask, dtype=bool), times, np.inf)
    return np.argmin(times, axis=1)


def _speedups(model: Any, pipe: PreprocessPipeline, data: GatheredData,
              test_dims_idx: np.ndarray, cfg: InstallConfig,
              eval_time_s: float
              ) -> tuple[tuple[float, float, float, float, float, float],
                         dict[str, dict[str, float]]]:
    """Ideal / cold-estimated / warm-estimated mean + aggregate speedups
    over held-out dims (paper §IV-D), plus the same stats split per
    routine (the arXiv 2406.19621 per-routine tables)."""
    cfgs = data.cfgs
    chips = np.asarray([c.n_chips for c in cfgs], dtype=np.float64)
    try:
        j_default = cfgs.index(cfg.default_config)
    except ValueError:
        j_default = int(np.argmax(chips))
    rids = data.routine_ids()[test_dims_idx]
    t_orig = data.times[test_dims_idx, j_default]
    best_j = _predict_best_configs(
        model, pipe, data.dims[test_dims_idx], cfgs, routines=rids,
        mask=None if data.mask is None else data.mask[test_dims_idx])
    t_chosen = data.times[np.asarray(test_dims_idx), best_j]
    warm_eval = (1.0 - cfg.cache_hit_rate) * eval_time_s

    def _stats(orig: np.ndarray, chosen: np.ndarray
               ) -> tuple[float, float, float, float, float, float]:
        ideal = orig / np.maximum(chosen, 1e-12)
        est = orig / np.maximum(chosen + eval_time_s, 1e-12)
        warm = orig / np.maximum(chosen + warm_eval, 1e-12)
        return (float(ideal.mean()),
                float(orig.sum() / max(chosen.sum(), 1e-12)),
                float(est.mean()),
                float(orig.sum() / max((chosen + eval_time_s).sum(),
                                       1e-12)),
                float(warm.mean()),
                float(orig.sum() / max((chosen + warm_eval).sum(),
                                       1e-12)))

    per_routine: dict[str, dict[str, float]] = {}
    for rid in sorted(set(int(r) for r in rids)):
        sel = rids == rid
        (i_mean, i_agg, _, _, w_mean, w_agg) = _stats(t_orig[sel],
                                                      t_chosen[sel])
        per_routine[ROUTINES[rid]] = {
            "n_test": float(sel.sum()),
            "ideal_mean_speedup": i_mean,
            "ideal_aggregate_speedup": i_agg,
            "warm_est_mean_speedup": w_mean,
            "warm_est_aggregate_speedup": w_agg,
        }
    return _stats(t_orig, t_chosen), per_routine


def install(backend: TimingBackend | None = None,
            cfg: InstallConfig | None = None, *,
            artifact_dir: str | None = None,
            data: GatheredData | None = None,
            transfer_from: str | None = None,
            verbose: bool = False) -> InstallReport:
    """Run the full installation workflow; optionally persist the artifact.

    ``transfer_from`` names a donor artifact directory: the grid is
    warm-started from the donor's persisted rows via
    :func:`transfer_gather` (a few dozen locally-timed calibration
    cells instead of a full gather), and the correction provenance is
    persisted under ``"transfer"`` in config.json.
    """
    cfg = cfg or InstallConfig()
    backend = backend or SimulatedBackend(seed=cfg.seed)
    transfer_info = None
    if data is None:
        if transfer_from is not None:
            data, transfer_info = transfer_gather(backend, cfg,
                                                  transfer_from)
        else:
            data = gather_data(backend, cfg)
    elif transfer_from is not None:
        raise ValueError("pass either data= or transfer_from=, not both")

    # --- split on GEMM *inputs* (not rows) so test dims are unseen --------
    D = len(data.dims)
    dim_idx = np.arange(D)
    log_best = np.log(np.maximum(data.times.min(axis=1), 1e-12))
    _, test_dim_idx, _, _ = stratified_train_test_split(
        dim_idx[:, None], log_best, test_fraction=cfg.test_fraction,
        seed=cfg.seed)
    test_dims = set(test_dim_idx[:, 0].astype(int).tolist())
    if not test_dims:
        # tiny installs (a handful of calibration-scale dims) can leave
        # the stratified split's test side empty; hold out the slowest
        # dim so the report always has a held-out row
        test_dims = {int(np.argmax(log_best))}
    elif len(test_dims) >= D:
        # ... and per-routine strata of one dim each can put *every*
        # dim on the test side; keep at least one dim for training
        test_dims.discard(int(np.argmin(log_best)))
    train_mask = np.asarray([i not in test_dims for i in range(D)])

    rids = data.routine_ids()
    train_data = GatheredData(dims=data.dims[train_mask], cfgs=data.cfgs,
                              times=data.times[train_mask],
                              routines=rids[train_mask],
                              mask=None if data.mask is None
                              else data.mask[train_mask])
    test_idx = np.asarray(sorted(test_dims), dtype=int)

    X_train, y_train = train_data.to_rows(per_dim=cfg.train_cfgs_per_dim,
                                          seed=cfg.seed)
    test_rows = GatheredData(dims=data.dims[test_idx], cfgs=data.cfgs,
                             times=data.times[test_idx],
                             routines=rids[test_idx],
                             mask=None if data.mask is None
                             else data.mask[test_idx])
    X_test, y_test = test_rows.to_rows(per_dim=cfg.train_cfgs_per_dim,
                                       seed=cfg.seed + 1)

    pipe = PreprocessPipeline()
    Xt_train, yt_train = pipe.fit_transform(X_train, y_train)
    Xt_test = pipe.transform(X_test)

    grids = default_param_grids(cfg.grid_budget)
    reports: list[ModelReport] = []
    fitted: dict[str, Any] = {}
    for name in cfg.models:
        grid = grids.get(name, {})
        if grid:
            best_params, _ = grid_search(
                lambda **p: make_model(name, **p), grid, Xt_train, yt_train,
                n_splits=cfg.cv_splits, seed=cfg.seed)
        else:
            best_params = {}
        model = make_model(name, **best_params)
        model.fit(Xt_train, yt_train)
        fitted[name] = model
        test_pred = model.predict(Xt_test)
        t_eval_us = _measure_eval_time(model, pipe, len(data.cfgs))
        ((ideal_mean, ideal_agg, est_mean, est_agg,
          warm_mean, warm_agg), per_routine) = _speedups(
            model, pipe, data, test_idx, cfg, t_eval_us * 1e-6)
        reports.append(ModelReport(
            name=name, params=best_params,
            test_rmse=rmse(y_test, test_pred),
            normalised_rmse=normalised_rmse(y_test, test_pred),
            eval_time_us=t_eval_us,
            ideal_mean_speedup=ideal_mean,
            ideal_aggregate_speedup=ideal_agg,
            est_mean_speedup=est_mean,
            est_aggregate_speedup=est_agg,
            warm_est_mean_speedup=warm_mean,
            warm_est_aggregate_speedup=warm_agg,
            per_routine=per_routine))
        if verbose:
            print(f"[install] {name}: nrmse={reports[-1].normalised_rmse:.3f}"
                  f" est_mean={est_mean:.3f} warm={warm_mean:.3f}"
                  f" t_eval={t_eval_us:.0f}us")

    selected = max(reports, key=lambda r: r.warm_est_mean_speedup).name
    report = InstallReport(selected=selected, reports=reports,
                           artifact_dir=artifact_dir)

    if artifact_dir is not None:
        os.makedirs(artifact_dir, exist_ok=True)
        # Warm-start cache: the selected model's argmin choice for every
        # sampled GEMM dim, computed in one batched predict at install
        # time so the runtime tuner starts with a hot memo cache instead
        # of paying t_eval on first sight of the trained-on shapes.
        warm_best = _predict_best_configs(fitted[selected], pipe,
                                          data.dims, data.cfgs,
                                          routines=data.routine_ids(),
                                          mask=data.mask)
        # paper Fig 2: "two files ... the configurations together with the
        # production-ready ML model"
        with open(os.path.join(artifact_dir, "config.json"), "w") as f:
            json.dump({
                "feature_names": FEATURE_NAMES,
                "preprocess": pipe.to_dict(),
                "candidates": [_config_dict(c) for c in data.cfgs],
                "default_config": _config_dict(cfg.default_config),
                # the declarative space the candidates came from —
                # from_artifact reconstructs it exactly, so dispatch-time
                # search explores the same space the install searched
                "space": (data.space if data.space is not None
                          else cfg.resolved_space().to_dict()),
                "install": {
                    "n_samples": cfg.n_samples,
                    "mem_limit_mb": cfg.mem_limit_mb,
                    "dtype_bytes": cfg.dtype_bytes,
                    "repeats": cfg.repeats, "seed": cfg.seed,
                    "routines": list(cfg.routines),
                    "workload_bias": cfg.workload_bias,
                    "max_chips": cfg.max_chips,
                    "tile_ids": list(cfg.tile_ids),
                    "timing_budget": cfg.timing_budget,
                    "beam_width": cfg.beam_width},
                # WorkloadProfile provenance: the recorded mix this grid
                # was weighted by (None = uniform install).  Surfaced by
                # tuner.from_artifact so serve can warn when the live
                # mix drifts from what was installed.
                "workload": data.workload if data.workload is not None
                else (cfg.workload.to_dict()
                      if cfg.workload is not None else None),
                # provenance: which hardware this install targeted and
                # which backend timed the grid.  Absent/None on legacy
                # artifacts — from_artifact treats that as "unknown"
                # and skips the mismatch check.
                "fingerprint": (
                    cfg.fingerprint.to_dict()
                    if hasattr(cfg.fingerprint, "to_dict")
                    else cfg.fingerprint),
                "backend": describe_backend(backend),
                # non-None iff this was a transfer install: donor path,
                # fitted per-routine log-space correction, calibration
                # budget actually spent
                "transfer": transfer_info,
                "selection": [r.to_dict() for r in reports],
                "selected": selected,
                # v3: explicit config dicts, validated against the
                # persisted space on load (beam-found configs need not
                # sit in any fixed candidate list).  v2 stored argmin
                # *indices* with (routine, m, k, n) keys; v1 blocks (no
                # "version"/"routines") are all-gemm.  from_artifact
                # reads all three.
                "warm_start": {
                    "version": 3,
                    "dims": np.asarray(data.dims,
                                       dtype=np.int64).tolist(),
                    "routines": data.routine_names(),
                    "configs": [_config_dict(data.cfgs[int(j)])
                                for j in warm_best]},
            }, f, indent=1)
        with open(os.path.join(artifact_dir, "model.json"), "w") as f:
            json.dump(fitted[selected].to_dict(), f)
        # the gathered grid itself: transfer installs on other machines
        # warm-start from these rows (transfer_gather reads grid.npz).
        # is_artifact() deliberately ignores it — legacy artifacts stay
        # loadable, they just can't act as transfer donors.
        data.save(os.path.join(artifact_dir, "grid.npz"))
    return report


def load_artifact(artifact_dir: str) -> tuple[Any, PreprocessPipeline,
                                              list[GemmConfig], dict]:
    """Load the two installation files back (paper Fig 3, left box)."""
    with open(os.path.join(artifact_dir, "config.json")) as f:
        config = json.load(f)
    with open(os.path.join(artifact_dir, "model.json")) as f:
        model = model_from_dict(json.load(f))
    pipe = PreprocessPipeline.from_dict(config["preprocess"])
    cands = [_config_from_dict(d) for d in config["candidates"]]
    return model, pipe, cands, config


# ---------------------------------------------------------------------------
# atomic artifact lifecycle (online re-install hot-swap + crash recovery)
# ---------------------------------------------------------------------------
#
# The serving re-install loop (repro.serve.reinstall) writes a fresh
# artifact under traffic, so the on-disk transition must be atomic in
# the same write-to-tmp + commit-sentinel + rename style the checkpoint
# layer uses (repro.ckpt.checkpoint, repro.ft.driver):
#
#     <dir>.tmp/      install() output, COMMIT sentinel written last
#     <dir>/          live artifact (os.replace renames, never copies)
#     <dir>.prev/     the displaced artifact, kept for one-call rollback
#
# A crash at any point leaves either the old artifact in place (tmp
# dirs without COMMIT are ignored and swept on restart) or a recoverable
# two-rename window that resolve_artifact() repairs.

#: sentinel written into a tmp artifact dir after config.json +
#: model.json are complete; commit_artifact refuses dirs without it
ARTIFACT_COMMIT = "COMMIT"


def artifact_tmp_dir(artifact_dir: str) -> str:
    """Staging dir a re-install writes into before the atomic swap."""
    return artifact_dir.rstrip(os.sep) + ".tmp"


def artifact_prev_dir(artifact_dir: str) -> str:
    """Where the displaced artifact lands on commit (rollback source)."""
    return artifact_dir.rstrip(os.sep) + ".prev"


def is_artifact(path: str) -> bool:
    """True when ``path`` holds a loadable artifact (both paper files)."""
    return (os.path.isfile(os.path.join(path, "config.json"))
            and os.path.isfile(os.path.join(path, "model.json")))


def commit_artifact(tmp_dir: str, artifact_dir: str) -> str | None:
    """Atomically promote a committed tmp install to the live artifact.

    Requires the :data:`ARTIFACT_COMMIT` sentinel (the writer stamps it
    only after both artifact files are complete — a killed install never
    has one, so a crashed tmp can never be promoted).  The displaced
    artifact is retained at :func:`artifact_prev_dir` for rollback; its
    previous occupant is deleted.  Returns the prev path, or None when
    there was no artifact to displace.

    Both transitions are single ``os.replace`` renames.  A hard crash
    between them leaves no live dir but a complete ``.prev`` (and the
    committed tmp) — :func:`resolve_artifact` repairs that window by
    restoring ``.prev``, i.e. recovery always lands on a complete
    artifact and never serves a half-written one.
    """
    if not os.path.isfile(os.path.join(tmp_dir, ARTIFACT_COMMIT)):
        raise ValueError(
            f"{tmp_dir} has no {ARTIFACT_COMMIT} sentinel — refusing to "
            "promote a possibly half-written install")
    if not is_artifact(tmp_dir):
        raise ValueError(f"{tmp_dir} is not a complete artifact")
    prev = artifact_prev_dir(artifact_dir)
    displaced = None
    if os.path.isdir(artifact_dir):
        if os.path.isdir(prev):
            shutil.rmtree(prev)
        os.replace(artifact_dir, prev)
        displaced = prev
    os.replace(tmp_dir, artifact_dir)
    return displaced


def rollback_artifact(artifact_dir: str) -> None:
    """Swap the live artifact with ``.prev`` (one-call rollback).

    Pure renames — the restored artifact is byte-for-byte what commit
    displaced.  The rolled-back artifact becomes the new ``.prev``, so
    a second call rolls forward again.
    """
    prev = artifact_prev_dir(artifact_dir)
    if not is_artifact(prev):
        raise FileNotFoundError(f"no rollback artifact at {prev}")
    hold = artifact_dir.rstrip(os.sep) + ".rollback"
    if os.path.isdir(hold):
        shutil.rmtree(hold)
    had_live = os.path.isdir(artifact_dir)
    if had_live:
        os.replace(artifact_dir, hold)
    os.replace(prev, artifact_dir)
    if had_live:
        os.replace(hold, prev)


def resolve_artifact(artifact_dir: str) -> str | None:
    """Crash recovery at boot: return a servable artifact path or None.

    * A live artifact wins; any leftover ``.tmp`` (an install killed
      mid-write OR one killed after COMMIT but before the swap) is
      ignored and swept — an unpromoted install is an aborted install.
    * No live artifact but a complete ``.prev``: the process died inside
      commit_artifact's two-rename window — restore ``.prev``.
    """
    tmp = artifact_tmp_dir(artifact_dir)
    if not is_artifact(artifact_dir):
        prev = artifact_prev_dir(artifact_dir)
        if is_artifact(prev):
            os.replace(prev, artifact_dir)
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    return artifact_dir if is_artifact(artifact_dir) else None
