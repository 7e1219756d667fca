"""Workload profiles: what the node actually dispatches, as install input.

The paper's premise is that the installed model should reflect the GEMM
tasks the node will run (§III-B), and the BLAS-3 follow-up (arXiv
2406.19621) installs per-routine models — yet a uniform Halton grid
spreads the install budget evenly over the whole memory-limited box
regardless of where serving volume concentrates.  A
:class:`WorkloadProfile` closes that loop: it summarises recorded
dispatches (from a live :class:`~repro.kernels.recorder.DispatchRecorder`
or the per-cell ``dispatch`` blocks ``repro.launch.dryrun`` persists)
into

* **routine weights** — the fraction of dispatch volume per BLAS-3
  routine, weighted by flops (default) or by count-weighted events, and
* a **shape-region histogram** — dispatch volume bucketed into log2
  octave cells of the (m, k, n) box, i.e. region
  ``[2^i, 2^(i+1)) x [2^j, 2^(j+1)) x [2^l, 2^(l+1))`` per cell.

The installer consumes both: routine quotas replace blind round-robin
cycling, and a mixture sampler (:func:`repro.core.halton.
sample_gemm_dims_mixture`) biases a configurable fraction of the Halton
budget into the observed regions — low-discrepancy *within* each region,
with a uniform floor over the full box so coverage never collapses onto
the profile.  Profiles JSON round-trip, merge across cells/archs, and
are persisted into the install artifact so the runtime tuner can warn
when the serving mix drifts from what was installed.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Iterable, Mapping

import numpy as np

from repro_torch.core.costmodel import ROUTINES
from repro_torch.core.features import ROUTINE_FLOP_SCALE

__all__ = ["WorkloadProfile", "shape_cell", "apportion"]

#: log2 octave cell of one (m, k, n) triple
Cell = tuple[int, int, int]


def shape_cell(m: int, k: int, n: int) -> Cell:
    """The log2 octave cell containing ``(m, k, n)``."""
    return (int(math.floor(math.log2(max(int(m), 1)))),
            int(math.floor(math.log2(max(int(k), 1)))),
            int(math.floor(math.log2(max(int(n), 1)))))


def apportion(weights: Iterable[float], n: int) -> list[int]:
    """Split ``n`` units proportionally to ``weights`` (largest-remainder
    method, a.k.a. Hamilton apportionment).  Exact: the result sums to
    ``n``; all-zero/empty weights split ``n`` as evenly as possible."""
    w = np.asarray(list(weights), dtype=np.float64)
    if w.size == 0:
        return []
    if not np.any(w > 0):
        w = np.ones_like(w)
    w = np.maximum(w, 0.0)
    exact = n * w / w.sum()
    base = np.floor(exact).astype(int)
    rem = n - int(base.sum())
    if rem:
        # ties broken by index order (stable argsort) for determinism
        order = np.argsort(-(exact - base), kind="stable")
        base[order[:rem]] += 1
    return base.tolist()


def _event_weight(routine: str, m: int, k: int, n: int, count: int,
                  by: str) -> float:
    if by == "events":
        return float(count)
    scale = ROUTINE_FLOP_SCALE[ROUTINES.index(routine)]
    return 2.0 * count * m * k * n * scale


@dataclasses.dataclass
class WorkloadProfile:
    """Normalised per-routine / per-shape-region dispatch volume.

    ``routine_weights`` and ``cells`` each sum to 1 (or are empty for an
    empty profile); ``total`` keeps the raw pre-normalisation volume so
    profiles merge proportionally to how much traffic each one saw.
    ``source`` is free-form provenance (arch, cell, recorder, ...)
    persisted alongside the install artifact.
    """

    routine_weights: dict[str, float] = \
        dataclasses.field(default_factory=dict)
    cells: dict[Cell, float] = dataclasses.field(default_factory=dict)
    by: str = "flops"
    total: float = 0.0
    source: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.by not in ("flops", "events"):
            raise ValueError(f"by={self.by!r}; expected 'flops' or "
                             "'events'")
        for r in self.routine_weights:
            if r not in ROUTINES:
                raise ValueError(f"unknown routine {r!r}; "
                                 f"expected one of {ROUTINES}")

    # -- constructors --------------------------------------------------
    @classmethod
    def from_events(cls, events: Iterable[Any], *, by: str = "flops",
                    source: dict | None = None) -> "WorkloadProfile":
        """Build from DispatchEvent-shaped records (``routine``, ``m``,
        ``k``, ``n``, ``count`` attributes)."""
        routines: dict[str, float] = {}
        cells: dict[Cell, float] = {}
        total = 0.0
        for e in events:
            w = _event_weight(e.routine, e.m, e.k, e.n, e.count, by)
            routines[e.routine] = routines.get(e.routine, 0.0) + w
            cell = shape_cell(e.m, e.k, e.n)
            cells[cell] = cells.get(cell, 0.0) + w
            total += w
        return cls(routine_weights=_normalise(routines),
                   cells=_normalise(cells), by=by, total=total,
                   source=dict(source or {}))

    @classmethod
    def from_recorder(cls, recorder: Any, *, by: str = "flops",
                      source: dict | None = None) -> "WorkloadProfile":
        """Build from an (exited or still-active) DispatchRecorder."""
        src = {"kind": "recorder"}
        src.update(source or {})
        return cls.from_events(recorder.events, by=by, source=src)

    @classmethod
    def from_dispatch_block(cls, block: Mapping[str, Any], *,
                            by: str = "flops",
                            source: dict | None = None
                            ) -> "WorkloadProfile":
        """Build from the per-cell ``dispatch`` block a dry-run persists.

        Blocks written since the shape table landed carry a ``shapes``
        list (one aggregated row per distinct (routine, m, k, n)); those
        yield the full profile.  Older blocks only recorded the routine
        mix — the profile then has routine weights but no shape cells,
        and the installer falls back to uniform shape sampling.
        """
        src = {"kind": "dryrun"}
        src.update(source or {})
        shapes = block.get("shapes")
        if shapes:
            rows = [_Row(s["routine"], s["m"], s["k"], s["n"],
                         s.get("dispatches", s.get("events", 1)))
                    for s in shapes]
            return cls.from_events(rows, by=by, source=src)
        mix_key = "routine_mix" if by == "flops" else "routine_mix_events"
        mix = dict(block.get(mix_key) or {})
        summary = block.get("summary") or {}
        # "events" weighting means count-weighted dispatches everywhere
        # in this module (a vmapped site traced once still carries its
        # batch multiplicity) — summary's "events" field is raw traced
        # sites, the wrong volume for merge weights
        vol_key = "flops" if by == "flops" else "dispatches"
        total = sum(row.get(vol_key, 0.0) for row in summary.values())
        return cls(routine_weights=_normalise(mix), cells={}, by=by,
                   total=float(total), source=src)

    @classmethod
    def merge(cls, profiles: Iterable["WorkloadProfile"], *,
              weights: Iterable[float] | None = None,
              source: dict | None = None) -> "WorkloadProfile":
        """Volume-weighted combination across cells / archs.

        ``weights`` defaults to each profile's raw ``total`` (a cell
        that dispatched 10x the flops contributes 10x), falling back to
        equal weights when no profile recorded a total.
        """
        profiles = list(profiles)
        if not profiles:
            return cls(source=dict(source or {"kind": "merge"}))
        bys = {p.by for p in profiles}
        if len(bys) > 1:
            raise ValueError(f"cannot merge profiles with mixed "
                             f"weightings {sorted(bys)}")
        if weights is None:
            w = [p.total for p in profiles]
            if not any(w):
                w = [1.0] * len(profiles)
        else:
            w = list(weights)
            if len(w) != len(profiles):
                raise ValueError(f"got {len(w)} weights for "
                                 f"{len(profiles)} profiles")
        routines: dict[str, float] = {}
        cells: dict[Cell, float] = {}
        for p, wi in zip(profiles, w):
            for r, v in p.routine_weights.items():
                routines[r] = routines.get(r, 0.0) + wi * v
            for c, v in p.cells.items():
                cells[c] = cells.get(c, 0.0) + wi * v
        src = {"kind": "merge", "n_profiles": len(profiles),
               "sources": [p.source for p in profiles]}
        src.update(source or {})
        return cls(routine_weights=_normalise(routines),
                   cells=_normalise(cells), by=profiles[0].by,
                   total=float(sum(p.total for p in profiles)),
                   source=src)

    # -- install-side consumers ----------------------------------------
    def routine_quotas(self, routines: Iterable[str], n: int, *,
                       floor: float = 0.25) -> dict[str, int]:
        """Per-routine sample quotas for an ``n``-sample install budget.

        A ``floor`` fraction of the budget is split evenly across the
        requested ``routines`` (so a routine the profile never observed
        — or observed at zero weight — still gets install coverage and
        the model retains signal for it); the remainder is allocated
        proportionally to the profile's routine weights.  Quotas sum to
        exactly ``n``.
        """
        routines = list(routines)
        if not routines:
            raise ValueError("empty routine list")
        if not 0.0 <= floor <= 1.0:
            raise ValueError(f"floor={floor} outside [0, 1]")
        weights = [self.routine_weights.get(r, 0.0) for r in routines]
        if not any(weights):
            # empty profile (or no overlap): pure even split
            even = apportion([1.0] * len(routines), n)
            return dict(zip(routines, even))
        n_floor = int(round(floor * n))
        base = apportion([1.0] * len(routines), n_floor)
        prop = apportion(weights, n - n_floor)
        return {r: b + p for r, b, p in zip(routines, base, prop)}

    def region_boxes(self) -> list[tuple[tuple[float, float, float],
                                         tuple[float, float, float],
                                         float]]:
        """``(log2_lo, log2_hi, weight)`` per occupied shape cell, the
        input format of :func:`repro.core.halton.sample_gemm_dims_mixture`.
        """
        return [((float(a), float(b), float(c)),
                 (float(a + 1), float(b + 1), float(c + 1)), w)
                for (a, b, c), w in sorted(self.cells.items())]

    def sample_dims(self, n_samples: int, *, mem_limit_bytes: int,
                    bias: float = 0.75, dtype_bytes: int = 4,
                    seed: int = 0, dim_min: int = 8,
                    dim_max: int = 65536,
                    log_space: bool = False) -> np.ndarray:
        """Profile-biased (m, k, n) samples; uniform when cell-less."""
        from repro_torch.core.halton import (sample_gemm_dims,
                                       sample_gemm_dims_mixture)
        if not self.cells or bias <= 0.0:
            return sample_gemm_dims(
                n_samples, mem_limit_bytes=mem_limit_bytes,
                dtype_bytes=dtype_bytes, seed=seed, dim_min=dim_min,
                dim_max=dim_max, log_space=log_space)
        return sample_gemm_dims_mixture(
            n_samples, self.region_boxes(), bias=bias,
            mem_limit_bytes=mem_limit_bytes, dtype_bytes=dtype_bytes,
            seed=seed, dim_min=dim_min, dim_max=dim_max,
            log_space=log_space)

    # -- serve-side consumer -------------------------------------------
    def drift(self, observed: "Mapping[str, float] | WorkloadProfile"
              ) -> float:
        """Total-variation distance between this (installed) profile and
        an observed serving mix, in [0, 1].  0 = identical, 1 = disjoint
        support; symmetric in its two distributions.

        ``observed`` is either a bare routine mix (e.g.
        ``DispatchRecorder.routine_mix()``) — routine-weight TV only —
        or a full :class:`WorkloadProfile`, in which case the result is
        the max of the routine-mix TV and the shape-cell-histogram TV
        (when both profiles carry cells): a serving mix that kept its
        routine split but moved to very different GEMM shapes has
        drifted just as surely, and the re-install trigger
        (:class:`repro.serve.reinstall.ReinstallManager`) must see it.
        """
        p = _normalise(dict(self.routine_weights))
        if isinstance(observed, WorkloadProfile):
            d = _tv(p, _normalise(dict(observed.routine_weights)))
            if self.cells and observed.cells:
                d = max(d, _tv(_normalise(dict(self.cells)),
                               _normalise(dict(observed.cells))))
            return d
        return _tv(p, _normalise(dict(observed)))

    # -- serialisation -------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "version": 1,
            "by": self.by,
            "total": self.total,
            "routine_weights": dict(self.routine_weights),
            "cells": [{"cell": list(c), "weight": w}
                      for c, w in sorted(self.cells.items())],
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "WorkloadProfile":
        cells = {tuple(int(x) for x in row["cell"]): float(row["weight"])
                 for row in d.get("cells", [])}
        return cls(routine_weights={str(r): float(w) for r, w in
                                    (d.get("routine_weights") or
                                     {}).items()},
                   cells=cells, by=d.get("by", "flops"),
                   total=float(d.get("total", 0.0)),
                   source=dict(d.get("source") or {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "WorkloadProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def table(self) -> str:
        """Human-readable summary (routine mix + top shape regions)."""
        lines = [f"workload profile (by {self.by}, total "
                 f"{self.total:.3g}):"]
        for r, w in sorted(self.routine_weights.items(),
                           key=lambda kv: -kv[1]):
            lines.append(f"  {r:8s} {w:6.1%}")
        top = sorted(self.cells.items(), key=lambda kv: -kv[1])[:8]
        for (a, b, c), w in top:
            lines.append(f"  m~2^{a:<2d} k~2^{b:<2d} n~2^{c:<2d} "
                         f"{w:6.1%}")
        if len(self.cells) > 8:
            lines.append(f"  ... {len(self.cells) - 8} more regions")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class _Row:
    """Minimal event-shaped record for from_dispatch_block."""

    routine: str
    m: int
    k: int
    n: int
    count: int = 1


def _normalise(d: dict) -> dict:
    total = sum(d.values())
    if total <= 0:
        return {}
    return {k: v / total for k, v in d.items()}


def _tv(p: Mapping[Any, float], q: Mapping[Any, float]) -> float:
    """Total-variation distance between two normalised distributions.

    Clamped to 1.0: the float sum over near-disjoint supports can land
    an epsilon above it, and drift is documented as in [0, 1].
    """
    return min(1.0, 0.5 * sum(abs(p.get(k, 0.0) - q.get(k, 0.0))
                              for k in set(p) | set(q)))
