"""Cost-model-guided beam search over a ConfigSpace, vectorised per level.

The policy the whole stack shares (installer budget mode, tuner
dispatch-time search, benchmarks): per dim, keep the ``width`` cheapest
partial states, refine one axis per level, and price **every frontier of
every dim in one batched cost call per level** — the union of unseen
canonical completions goes through ``cost_fn(dims, configs, routines)``
(default: noise-free :func:`~repro.core.costmodel.estimate_batch_terms`)
as a single (D, U) grid, exactly the vectorised pass PR 1 built.
Priced configs are cached across levels, so ``n_priced`` — the honest
"how much model work did this cost" count — only grows by genuinely new
(dim, config) cells.

Exactness: ties break on the config's lexicographic position in the
space's canonical enumeration, so at full width and depth the beam
returns bit-for-bit the exhaustive argmin (first occurrence), for every
routine.  :func:`exhaustive_best` is that baseline, shaped like a
:class:`BeamResult` for side-by-side accounting.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.costmodel import (
    GemmConfig,
    TPUSpec,
    estimate_batch_terms,
)
from repro_torch.core.search.graph import SearchGraph
from repro_torch.core.search.space import ConfigSpace

__all__ = ["BeamResult", "beam_search", "exhaustive_best"]

#: Default axis expansion order: partition first (four informative
#: branches priced at the canonical chip default) before the wide chip
#: axis, then tiles, then routine knobs.  Axes a space lacks are skipped;
#: axes not named here run afterwards in space order.
DEFAULT_ORDER = ("partition", "n_chips", "tile_id", "trsm_seq_chips",
                 "flash_block_id", "flash_grid")


@dataclasses.dataclass
class BeamResult:
    """Top-k configs per dim plus the search's cost accounting.

    ``n_priced`` counts distinct (dim, config) cells the search
    *demanded* a price for — the cells a timing backend would have to
    measure to drive the same search.  The batched ``cost_fn`` call may
    vectorise over the full (dims x union) grid and discard the
    undemanded cells; that slack is free the way idle SIMD lanes are,
    and is not counted.
    """
    configs: list          # per dim: list of top_k GemmConfig
    costs: list            # per dim: list of top_k predicted times (s)
    n_priced: int          # distinct (dim, config) cells demanded
    n_space: int           # sum over dims of admissible space size
    width: int
    depth: int

    def best(self) -> list[GemmConfig]:
        return [cfgs[0] for cfgs in self.configs]

    @property
    def priced_fraction(self) -> float:
        return self.n_priced / max(self.n_space, 1)


def _default_cost_fn(spec, dtype_bytes):
    _spec = spec if spec is not None else TPUSpec()

    def cost_fn(dims, cfgs, routines):
        return estimate_batch_terms(dims, cfgs, _spec,
                                    dtype_bytes=dtype_bytes,
                                    routines=routines).total_s
    return cost_fn


def _space_cells(dims, space: ConfigSpace) -> int:
    """Sum of per-dim admissible space sizes (dims-aware gates make the
    size shape-dependent); memoised per distinct shape."""
    sizes: dict[tuple, int] = {}
    total = 0
    for d in dims:
        key = tuple(int(x) for x in d)
        if key not in sizes:
            sizes[key] = space.size(dims=key)
        total += sizes[key]
    return total


def beam_search(dims, space: ConfigSpace, cost_fn=None, width: int = 8,
                depth: int | None = None, *, routines=None, top_k: int = 1,
                spec: TPUSpec | None = None, dtype_bytes: int = 2,
                order=DEFAULT_ORDER) -> BeamResult:
    """Beam search each dim's best config(s) out of ``space``.

    ``cost_fn(dims, configs, routines) -> (D, C) array`` prices whole
    frontiers at once; ``None`` uses the noise-free analytic model.  One
    axis is refined per level (``depth`` defaults to all axes); partial
    states price as their canonical completion.  Returns ``top_k``
    configs per dim, cheapest first, ties in enumeration order.
    """
    dims = np.atleast_2d(np.asarray(dims, dtype=np.int64))
    n_dims = len(dims)
    if width < 1 or top_k < 1:
        raise ValueError(f"width={width} and top_k={top_k} must be >= 1")
    if cost_fn is None:
        cost_fn = _default_cost_fn(spec, dtype_bytes)
    n_levels = len(space.axes) if depth is None \
        else min(depth, len(space.axes))
    graphs = [SearchGraph(space, dims=d, order=order) for d in dims]
    frontiers: list[list[tuple]] = [[g.initial()] for g in graphs]

    priced: dict[GemmConfig, np.ndarray] = {}   # cfg -> (D,) cost column
    demanded: set[tuple[int, GemmConfig]] = set()
    for _level in range(n_levels):
        expansions: list[list[tuple]] = []      # per dim: (state, cfg, rank)
        for d in range(n_dims):
            g = graphs[d]
            rows = []
            for s in frontiers[d]:
                for v in g.actions(s):
                    s2 = g.apply(s, v)
                    try:
                        cfg = g.config(s2)
                    except ValueError:
                        continue   # branch admits no completion: dead end
                    rows.append((s2, cfg, space.rank_of(cfg)))
            if not rows:
                raise ValueError(
                    f"beam frontier went empty for dims {dims[d]!r} — "
                    "the space admits no completion (over-gated)")
            expansions.append(rows)

        new: list[GemmConfig] = []
        for d, rows in enumerate(expansions):
            for _, cfg, _ in rows:
                demanded.add((d, cfg))
                if cfg not in priced:
                    priced[cfg] = None  # reserve slot, keep first-seen order
                    new.append(cfg)
        if new:
            costs = np.asarray(cost_fn(dims, new, routines),
                               dtype=np.float64)
            for j, cfg in enumerate(new):
                priced[cfg] = costs[:, j]

        for d in range(n_dims):
            rows = sorted(expansions[d],
                          key=lambda r: (float(priced[r[1]][d]), r[2]))
            frontiers[d] = [s for s, _, _ in rows[:width]]

    configs: list[list[GemmConfig]] = []
    out_costs: list[list[float]] = []
    for d in range(n_dims):
        g = graphs[d]
        rows = sorted(((s, g.config(s)) for s in frontiers[d]),
                      key=lambda r: (float(priced[r[1]][d]),
                                     space.rank_of(r[1])))
        sel = rows[:top_k]
        configs.append([cfg for _, cfg in sel])
        out_costs.append([float(priced[cfg][d]) for _, cfg in sel])

    return BeamResult(configs, out_costs, len(demanded),
                      _space_cells(dims, space), width, n_levels)


def exhaustive_best(dims, space: ConfigSpace, cost_fn=None, *,
                    routines=None, top_k: int = 1,
                    spec: TPUSpec | None = None,
                    dtype_bytes: int = 2) -> BeamResult:
    """Price the whole space and argmin — the beam's ground truth.

    Same return shape as :func:`beam_search` (``width`` = the largest
    per-dim space, ``n_priced`` = every admissible cell), same
    first-occurrence tie-breaking as ``np.argmin`` over the enumeration.
    """
    dims = np.atleast_2d(np.asarray(dims, dtype=np.int64))
    if cost_fn is None:
        cost_fn = _default_cost_fn(spec, dtype_bytes)

    per_dim: list[list[GemmConfig]] = []
    union: list[GemmConfig] = []
    col: dict[GemmConfig, int] = {}
    cache: dict[tuple, list[GemmConfig]] = {}
    for d in dims:
        key = tuple(int(x) for x in d)
        if key not in cache:
            cache[key] = space.enumerate(dims=key)
        per_dim.append(cache[key])
        for cfg in cache[key]:
            if cfg not in col:
                col[cfg] = len(union)
                union.append(cfg)
    costs = np.asarray(cost_fn(dims, union, routines), dtype=np.float64)

    configs, out_costs, n_cells = [], [], 0
    for d, cfgs in enumerate(per_dim):
        n_cells += len(cfgs)
        row = costs[d, [col[c] for c in cfgs]]
        order = sorted(range(len(cfgs)), key=lambda i: (row[i], i))[:top_k]
        configs.append([cfgs[i] for i in order])
        out_costs.append([float(row[i]) for i in order])

    return BeamResult(configs, out_costs, int(costs.size), n_cells,
                      max(len(c) for c in per_dim), len(space.axes))
