"""Compositional config space: declarative axes + admissibility gates.

The paper's tuner argmins over a flat enumerated candidate list; this
module recasts that list as the exhaustive enumeration of a declarative
:class:`ConfigSpace` — named axes (chip-count doublings, partition
choices, tile splits, routine-specific knobs like the TRSM pipeline
depth) with :class:`Gate` predicates expressing when a value is
admissible (2D sharding needs a 2D submesh; optionally, sharding must
keep a minimum local extent per chip).  The model-driven adaptive-
libraries line (arXiv 1806.07060) motivates the shape: the space is the
product of independent refinements, so a search policy can explore it
compositionally instead of materialising the whole grid.

Two spaces matter in practice:

* ``ConfigSpace.default(...)`` — exactly the historical
  ``candidate_configs`` grid.  ``enumerate()`` reproduces the old triple
  loop bit for bit (chip doublings outer, partitions with the 2D gate,
  then tiles), which is what keeps every persisted artifact and test pin
  meaningful.
* ``ConfigSpace.enlarged(...)`` — ~11x bigger: 3*2^k chip counts, the
  EXTENDED_TILES presets, and the ``trsm_seq_chips`` pipeline-depth knob
  as a fourth axis.  Too big to time exhaustively at install; meant to
  be beam-searched (see :mod:`repro.core.search.beam`).

Spaces serialise to a versioned dict (the artifact's ``"space"`` block)
and reconstruct exactly via :meth:`ConfigSpace.from_dict`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.core.costmodel import (
    DEFAULT_TILES,
    EXTENDED_TILES,
    FLASH_BLOCKS,
    FLASH_GRIDS,
    PARTITIONS,
    TRSM_SEQ_CHIPS,
    GemmConfig,
    chip_doublings,
)

__all__ = ["Axis", "ConfigSpace", "Gate"]

#: ConfigSpace axis name -> GemmConfig field, in canonical (enumeration)
#: order.  Axes absent from a space pin their field to the dataclass
#: default (``trsm_seq_chips`` -> TRSM_SEQ_CHIPS, flash knobs -> the
#: historical dense 512x512 kernel).
_FIELDS = ("n_chips", "partition", "tile_id", "trsm_seq_chips",
           "flash_block_id", "flash_grid")
_REQUIRED = ("n_chips", "partition", "tile_id")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _2d_factors(p: int) -> tuple[int, int]:
    """The cost model's 2D submesh factorisation: (pm, pn), pm*pn <= p."""
    pm = 2 ** (int(math.log2(p)) // 2)
    return pm, p // pm


@dataclasses.dataclass(frozen=True)
class Gate:
    """Admissibility predicate guarding one axis value.

    kind:
      ``min_chips`` — the guarded value needs ``n_chips >= param``
                      (e.g. 2D sharding needs a 2D submesh).
      ``min_local`` — dims-aware: the guarded partition must keep at
                      least ``param`` elements per chip along every
                      sharded extent.  A no-op when dims are unknown.
      ``flash_tri_rows`` — dims-aware: the triangular flash grid is only
                      admissible when the Q axis (m = Sq) spans at least
                      ``param`` rows of the config's ``flash_bq`` block —
                      on a single-row grid tri degenerates to dense, so
                      enumerating both would double the space for
                      nothing.  Defers while ``flash_block_id`` is
                      unassigned or dims are unknown.

    Gates referencing a not-yet-assigned axis *defer* (admit) — partial
    states stay expandable in any axis order; the predicate re-fires
    once the referenced axis is assigned and on every completion.
    """
    kind: str
    value: object
    param: int

    def admits(self, partial: dict, dims=None) -> bool:
        if self.kind == "min_chips":
            c = partial.get("n_chips")
            return c is None or c >= self.param
        if self.kind == "flash_tri_rows":
            b = partial.get("flash_block_id")
            if dims is None or b is None:
                return True
            return _ceil_div(int(dims[0]), FLASH_BLOCKS[b][0]) >= self.param
        if self.kind == "min_local":
            c = partial.get("n_chips")
            if dims is None or c is None:
                return True
            m, k, n = (int(x) for x in dims)
            if self.value == "M":
                return _ceil_div(m, c) >= self.param
            if self.value == "N":
                return _ceil_div(n, c) >= self.param
            if self.value == "K":
                return _ceil_div(k, c) >= self.param
            if self.value == "2D":
                pm, pn = _2d_factors(c)
                return (_ceil_div(m, pm) >= self.param
                        and _ceil_div(n, pn) >= self.param)
            return True
        raise ValueError(f"unknown gate kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One refinement dimension: a name, its values (in enumeration
    order), an optional canonical default (used when completing partial
    states for pricing), and the gates guarding individual values."""
    name: str
    values: tuple
    default: object = None
    gates: tuple[Gate, ...] = ()


@dataclasses.dataclass(frozen=True)
class ConfigSpace:
    """A product of gated axes over :class:`GemmConfig` fields."""
    axes: tuple[Axis, ...]

    def __post_init__(self):
        names = [ax.name for ax in self.axes]
        for req in _REQUIRED:
            if req not in names:
                raise ValueError(f"ConfigSpace needs a {req!r} axis")
        for nm in names:
            if nm not in _FIELDS:
                raise ValueError(f"unknown axis {nm!r}; "
                                 f"expected one of {_FIELDS}")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axes in {names}")

    # -- admissibility -----------------------------------------------------

    def check(self, partial: dict, dims=None) -> bool:
        """Do all gates of the values assigned in ``partial`` admit it?"""
        for ax in self.axes:
            v = partial.get(ax.name)
            if v is None:
                continue
            for g in ax.gates:
                if g.value == v and not g.admits(partial, dims):
                    return False
        return True

    def axis(self, name: str) -> Axis:
        for ax in self.axes:
            if ax.name == name:
                return ax
        raise KeyError(name)

    # -- enumeration / completion ------------------------------------------

    def _to_config(self, partial: dict) -> GemmConfig:
        return GemmConfig(partial["n_chips"], partial["partition"],
                          partial["tile_id"],
                          partial.get("trsm_seq_chips", TRSM_SEQ_CHIPS),
                          partial.get("flash_block_id", 0),
                          partial.get("flash_grid", "dense"))

    def enumerate(self, dims=None) -> list[GemmConfig]:
        """Every admissible config, in canonical axis order (the old
        ``candidate_configs`` triple-loop order for the default space)."""
        out: list[GemmConfig] = []

        def rec(i: int, partial: dict) -> None:
            if i == len(self.axes):
                out.append(self._to_config(partial))
                return
            ax = self.axes[i]
            for v in ax.values:
                nxt = dict(partial)
                nxt[ax.name] = v
                if self.check(nxt, dims):
                    rec(i + 1, nxt)

        rec(0, {})
        return out

    def size(self, dims=None) -> int:
        """Number of admissible configs (``len(enumerate(dims))``)."""
        count = 0

        def rec(i: int, partial: dict) -> None:
            nonlocal count
            if i == len(self.axes):
                count += 1
                return
            ax = self.axes[i]
            for v in ax.values:
                nxt = dict(partial)
                nxt[ax.name] = v
                if self.check(nxt, dims):
                    rec(i + 1, nxt)

        rec(0, {})
        return count

    def complete(self, partial: dict, dims=None) -> GemmConfig:
        """Canonical completion of a partial assignment: each unassigned
        axis takes its default when admissible, else its first admissible
        value.  This is how search policies price partial states with the
        (whole-config) cost model."""
        filled = dict(partial)
        for ax in self.axes:
            if ax.name in filled:
                continue
            chosen = None
            if ax.default is not None and ax.default in ax.values:
                trial = dict(filled)
                trial[ax.name] = ax.default
                if self.check(trial, dims):
                    chosen = ax.default
            if chosen is None:
                for v in ax.values:
                    trial = dict(filled)
                    trial[ax.name] = v
                    if self.check(trial, dims):
                        chosen = v
                        break
            if chosen is None:
                raise ValueError(
                    f"no admissible value for axis {ax.name!r} "
                    f"completing {partial!r}")
            filled[ax.name] = chosen
        if not self.check(filled, dims):
            raise ValueError(f"partial {partial!r} admits no completion")
        return self._to_config(filled)

    def contains(self, cfg: GemmConfig, dims=None) -> bool:
        """Is ``cfg`` an admissible member of this space?  Fields without
        an axis must sit at their dataclass default."""
        values = {"n_chips": cfg.n_chips, "partition": cfg.partition,
                  "tile_id": cfg.tile_id,
                  "trsm_seq_chips": cfg.trsm_seq_chips,
                  "flash_block_id": cfg.flash_block_id,
                  "flash_grid": cfg.flash_grid}
        names = {ax.name for ax in self.axes}
        if "trsm_seq_chips" not in names \
                and cfg.trsm_seq_chips != TRSM_SEQ_CHIPS:
            return False
        if "flash_block_id" not in names and cfg.flash_block_id != 0:
            return False
        if "flash_grid" not in names and cfg.flash_grid != "dense":
            return False
        partial = {nm: v for nm, v in values.items() if nm in names}
        for ax in self.axes:
            if partial[ax.name] not in ax.values:
                return False
        return self.check(partial, dims)

    def rank_of(self, cfg: GemmConfig) -> tuple:
        """Per-axis value indices in canonical axis order — the config's
        lexicographic position in ``enumerate()``.  Search policies break
        cost ties on this so a full-width beam reproduces the exhaustive
        argmin's first-occurrence tie-breaking exactly."""
        values = {"n_chips": cfg.n_chips, "partition": cfg.partition,
                  "tile_id": cfg.tile_id,
                  "trsm_seq_chips": cfg.trsm_seq_chips,
                  "flash_block_id": cfg.flash_block_id,
                  "flash_grid": cfg.flash_grid}
        return tuple(ax.values.index(values[ax.name]) for ax in self.axes)

    # -- sampling ----------------------------------------------------------

    def sample(self, n: int, *, seed: int = 0, dims=None
               ) -> list[GemmConfig]:
        """Up to ``n`` distinct admissible configs, low-discrepancy over
        the axis lattice (scrambled Halton, one base per axis), axes
        refined in canonical order with gate filtering.  Deterministic
        given ``seed``; used for the exploration slice of budgeted
        installs."""
        from repro_torch.core.halton import scrambled_halton
        out: list[GemmConfig] = []
        seen: set[GemmConfig] = set()
        start = 1
        while len(out) < n and start < 64 * max(n, 8):
            batch = max(64, 2 * (n - len(out)))
            u = scrambled_halton(batch, len(self.axes), seed=seed,
                                 start=start)
            start += batch
            for row in u:
                partial: dict = {}
                dead = False
                for ax, uu in zip(self.axes, row):
                    vals = []
                    for v in ax.values:
                        trial = dict(partial)
                        trial[ax.name] = v
                        if self.check(trial, dims):
                            vals.append(v)
                    if not vals:
                        dead = True
                        break
                    partial[ax.name] = vals[min(int(uu * len(vals)),
                                                len(vals) - 1)]
                if dead:
                    continue
                cfg = self._to_config(partial)
                if cfg not in seen:
                    seen.add(cfg)
                    out.append(cfg)
                    if len(out) == n:
                        break
        return out

    # -- serialisation -----------------------------------------------------

    def to_dict(self) -> dict:
        """Versioned, JSON-ready description (artifact ``"space"`` block)."""
        return {
            "version": 1,
            "axes": [
                {"name": ax.name, "values": list(ax.values),
                 "default": ax.default,
                 "gates": [{"kind": g.kind, "value": g.value,
                            "param": g.param} for g in ax.gates]}
                for ax in self.axes],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ConfigSpace":
        if d.get("version") != 1:
            raise ValueError(
                f"unsupported ConfigSpace version {d.get('version')!r}")
        axes = tuple(
            Axis(a["name"], tuple(a["values"]), a.get("default"),
                 tuple(Gate(g["kind"], g["value"], g["param"])
                       for g in a.get("gates", ())))
            for a in d["axes"])
        return cls(axes)

    # -- stock spaces ------------------------------------------------------

    @classmethod
    def default(cls, max_chips: int = 512, *,
                tiles: Iterable[int] | None = None,
                partitions: Iterable[str] = PARTITIONS) -> "ConfigSpace":
        """The historical ``candidate_configs`` grid as a space:
        enumeration reproduces the old list bit for bit."""
        chips = tuple(chip_doublings(max_chips))
        parts = tuple(partitions)
        tile_ids = tuple(tiles) if tiles is not None \
            else tuple(range(len(DEFAULT_TILES)))
        gates = (Gate("min_chips", "2D", 4),) if "2D" in parts else ()
        return cls((
            Axis("n_chips", chips, default=chips[-1]),
            Axis("partition", parts,
                 default="2D" if "2D" in parts else parts[0],
                 gates=gates),
            Axis("tile_id", tile_ids,
                 default=3 if 3 in tile_ids else tile_ids[0]),
        ))

    def with_flash(self, *, block_ids: Iterable[int] | None = None
                   ) -> "ConfigSpace":
        """This space extended with the flash-attention axes: the
        ``FLASH_BLOCKS`` (bq, bkv) preset and the dense/tri KV-grid
        knob, tri gated on the Q axis actually spanning >= 2 block rows
        (below that the grids are identical).  Idempotent.  Only the
        ``attn`` routine reads these knobs, so pre-existing axes (and
        gemm/syrk/trsm pricing) are untouched — ties on non-attn rows
        break to the dense 512x512 defaults via ``rank_of``."""
        if any(ax.name in ("flash_block_id", "flash_grid")
               for ax in self.axes):
            return self
        ids = tuple(block_ids) if block_ids is not None \
            else tuple(range(len(FLASH_BLOCKS)))
        return ConfigSpace(self.axes + (
            Axis("flash_block_id", ids, default=0),
            Axis("flash_grid", FLASH_GRIDS, default="tri",
                 gates=(Gate("flash_tri_rows", "tri", 2),)),
        ))

    @classmethod
    def enlarged(cls, max_chips: int = 512, *,
                 min_local: int = 8) -> "ConfigSpace":
        """~11x the default grid: 3*2^k chip counts interleaved with the
        doublings, the EXTENDED_TILES presets, and the TRSM pipeline
        depth as a searchable fourth axis.  ``min_local`` gates (dims-
        aware) drop partitions that would shard an extent below one
        sublane row per chip — inadmissible rather than merely slow."""
        base = chip_doublings(max_chips)
        chips = tuple(sorted(set(base)
                             | {3 * c for c in base if 3 * c <= max_chips}))
        gates = tuple([Gate("min_chips", "2D", 4)]
                      + [Gate("min_local", p, min_local)
                         for p in PARTITIONS])
        return cls((
            Axis("n_chips", chips, default=chips[-1]),
            Axis("partition", PARTITIONS, default="2D", gates=gates),
            Axis("tile_id", tuple(range(len(EXTENDED_TILES))), default=3),
            Axis("trsm_seq_chips", (1, 2, 4, 8),
                 default=TRSM_SEQ_CHIPS),
        ))
