"""Calibrated TPU v5e analytic performance model for distributed BLAS-3.

This is the install-time "timing program" of the paper (§III-B) for the
TPU target: the container is CPU-only, so routine timings at every
candidate worker configuration are produced by an analytic model of a
v5e pod instead of wall-clock measurement (DESIGN.md §Hardware
adaptation).  The model is intentionally *not* smooth: it contains wave
quantisation on the MXU grid, VMEM-overflow cliffs, ICI latency floors
and lognormal noise, so the learning problem retains the character of
the paper's measured data (skewed features, heteroscedastic noise,
non-obvious optimum).

Beyond plain GEMM the model covers the two BLAS-3 routines of the
follow-up paper (arXiv 2406.19621), interpreted on the shared (m, k, n)
triple:

  gemm — C[m,n] = A[m,k] @ B[k,n].  The baseline; unchanged.
  syrk — rank-k update writing only the lower triangle of C[m,n]
         (callers use m == n).  Computes the triangular fraction of the
         output tile grid, so its FLOPs are <= GEMM's for the same
         (m, k, n); output HBM traffic and the K-partition all-reduce
         shrink by the same triangular fraction.
  trsm — blocked substitution X[m,n] against a triangular A (k = update
         panel depth): half the multiply-adds of GEMM, triangular
         operand reads, and a *sequential dependency* along M — row
         panels retire in order, so at most TRSM_SEQ_CHIPS chips help on
         the M axis and every M-panel costs a dependent kernel launch.
  attn — causal flash attention on the (Sq, Dh, Skv) triple (m = query
         length, k = head dim, n = KV length; batch x heads is dispatch
         multiplicity, not part of the priced shape).  Score + AV FLOPs
         (4*m*k*n) at the causal triangular fraction of the flash tile
         grid; online softmax means Q and O stream exactly once and no
         (Sq, Skv) score matrix ever touches HBM.  The per-config flash
         knobs (``flash_block_id`` -> a (bq, bkv) FLASH_BLOCKS preset,
         ``flash_grid`` dense/tri) decide whether K/V blocks above the
         diagonal are still *streamed* (dense: skipped on the MXU via
         pl.when but every block is copied and every grid step launches)
         or never launched at all (tri: the block-sparse triangular
         grid) — that memory/launch gap is exactly what the tuner
         learns to price.

The same formulas (without noise) are reused by the roofline analysis —
keeping the tuner's world model and the §Roofline arithmetic consistent.

Hardware constants (per chip, TPU v5e):
  197 TFLOP/s bf16 peak · 819 GB/s HBM · ~50 GB/s/link ICI ·
  128 MB VMEM · MXU 128x128 systolic array.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np

__all__ = [
    "TPUSpec", "GemmConfig", "TimeBreakdown", "BatchBreakdown",
    "candidate_configs", "chip_doublings", "config_arrays",
    "estimate_gemm_time",
    "estimate_routine_time", "estimate_batch_terms", "estimate_batch",
    "DEFAULT_TILES", "EXTENDED_TILES", "PARTITIONS",
    "ROUTINES", "DEFAULT_ROUTINE", "TRSM_SEQ_CHIPS",
    "FLASH_BLOCKS", "FLASH_GRIDS",
    "routine_ids",
]

#: Routines the stack understands; index = routine id feature.  The
#: first three are the BLAS-3 set (arXiv 2406.19621); ``attn`` is tuned
#: flash attention on the (Sq, Dh, Skv) triple.
ROUTINES: tuple[str, ...] = ("gemm", "syrk", "trsm", "attn")

#: The explicit default/fallback routine.  Call sites that don't tag a
#: routine dispatch as this, and tuners whose artifact lacks signal for
#: a requested routine fall back to it — always ROUTINES[0].
DEFAULT_ROUTINE: str = ROUTINES[0]

#: Default depth of TRSM's substitution pipeline along the sequential
#: (M) dimension: at most this many chips help on that axis; the rest
#: idle waiting on their predecessors' panels.  Since the search-space
#: refactor this is a *per-config knob* (``GemmConfig.trsm_seq_chips``,
#: an axis of the enlarged :class:`~repro.core.search.ConfigSpace`);
#: this constant is the historical default every pre-search config
#: carries.
TRSM_SEQ_CHIPS = 4

#: Flash-attention (bq, bkv) block presets; index = the
#: ``GemmConfig.flash_block_id`` knob.  Id 0 is the historical
#: hardcoded kernel block, so default-constructed configs (and every
#: persisted pre-flash artifact) keep meaning exactly what they meant.
FLASH_BLOCKS: tuple[tuple[int, int], ...] = (
    (512, 512),
    (256, 512),
    (512, 256),
    (256, 256),
    (1024, 512),
    (128, 512),
)

#: Flash KV-grid kinds: ``dense`` launches the full (gq x gkv) grid and
#: skips masked tiles on the MXU only; ``tri`` is the block-sparse
#: triangular grid that never launches (or streams) a fully-masked tile.
FLASH_GRIDS: tuple[str, ...] = ("dense", "tri")


def routine_ids(routines, n: int) -> np.ndarray:
    """Normalise a routine argument to an (n,) int array of ROUTINES ids.

    Accepts ``None`` (all gemm), a single routine name or id, or a
    sequence of names/ids with one entry per dim.
    """
    if routines is None:
        return np.zeros(n, dtype=np.int64)
    if isinstance(routines, str):
        return np.full(n, _routine_id(routines), dtype=np.int64)
    if isinstance(routines, (int, np.integer)):
        return np.full(n, _routine_id(routines), dtype=np.int64)
    ids = np.asarray([_routine_id(r) for r in routines], dtype=np.int64)
    if len(ids) != n:
        raise ValueError(
            f"got {len(ids)} routines for {n} dims; pass one per dim "
            "(or a single routine for the whole batch)")
    return ids


def _routine_id(routine) -> int:
    if isinstance(routine, (int, np.integer)):
        if not 0 <= int(routine) < len(ROUTINES):
            raise ValueError(f"unknown routine id {routine!r}; "
                             f"expected 0..{len(ROUTINES) - 1}")
        return int(routine)
    try:
        return ROUTINES.index(routine)
    except ValueError:
        raise ValueError(f"unknown routine {routine!r}; "
                         f"expected one of {ROUTINES}") from None


@dataclasses.dataclass(frozen=True)
class TPUSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # bytes/s per chip
    ici_bw: float = 50e9                # bytes/s per link
    ici_links: int = 4                  # links per chip (2D torus)
    vmem_bytes: int = 128 * 2**20
    mxu_dim: int = 128                  # systolic array edge
    launch_overhead_s: float = 2e-6       # per kernel launch
    collective_latency_s: float = 0.2e-6  # ICI per-hop latency
    collective_dispatch_s: float = 5e-6   # software cost per collective
    #: per-grid-step overhead of the flash attention pipeline (DMA issue
    #: + sequential-axis bookkeeping); what the triangular grid saves on
    #: top of K/V traffic by never launching masked tiles
    flash_step_s: float = 0.2e-6
    max_chips: int = 512

    @property
    def ici_bw_total(self) -> float:
        return self.ici_bw * self.ici_links


# Kernel tile presets (bm, bk, bn).  Index = "tile_id" feature.
DEFAULT_TILES: tuple[tuple[int, int, int], ...] = (
    (128, 128, 128),
    (256, 128, 256),
    (128, 512, 128),
    (256, 256, 256),
    (512, 128, 512),
    (512, 512, 512),
    (128, 128, 512),
    (512, 128, 128),
)

#: DEFAULT_TILES plus the presets only reachable through an explicitly
#: enlarged search space (``ConfigSpace.enlarged``).  The classic ids
#: 0..7 are unchanged, so every pre-search artifact / candidate list
#: keeps meaning exactly what it meant; ``candidate_configs`` defaults
#: stay on DEFAULT_TILES for bit-for-bit compatibility.
EXTENDED_TILES: tuple[tuple[int, int, int], ...] = DEFAULT_TILES + (
    (256, 512, 256),
    (512, 256, 512),
    (128, 256, 128),
    (1024, 128, 128),
)

PARTITIONS = ("M", "N", "K", "2D")
_PARTITIONS = PARTITIONS          # pre-refactor private alias


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    """One candidate worker configuration = the paper's 'thread count'.

    n_chips        — submesh size the GEMM is dispatched on (1..512)
    partition      — which GEMM dimension(s) the submesh shards
    tile_id        — index into EXTENDED_TILES for the per-chip Pallas
                     kernel (ids 0..7 are the classic DEFAULT_TILES)
    trsm_seq_chips — TRSM substitution-pipeline depth: how many chips the
                     kernel lets cooperate along the sequential M axis.
                     Ignored by gemm/syrk.  Defaults to the historical
                     constant so three-argument construction (and every
                     persisted artifact) keeps its exact old meaning.
    flash_block_id — index into FLASH_BLOCKS for the attention kernel's
                     (bq, bkv) split.  Ignored by gemm/syrk/trsm.
    flash_grid     — flash KV-grid kind, "dense" or "tri" (block-sparse
                     triangular).  Both flash knobs default to the
                     pre-flash kernel behaviour (512x512 dense) so every
                     persisted artifact round-trips unchanged.
    """
    n_chips: int
    partition: str
    tile_id: int
    trsm_seq_chips: int = TRSM_SEQ_CHIPS
    flash_block_id: int = 0
    flash_grid: str = "dense"

    @property
    def tile(self) -> tuple[int, int, int]:
        return EXTENDED_TILES[self.tile_id]

    @property
    def flash_block(self) -> tuple[int, int]:
        """The attention kernel's (bq, bkv) block split."""
        return FLASH_BLOCKS[self.flash_block_id]

    @property
    def config_id(self) -> int:
        """Stable integer id (used for memoisation / logging).  Flash
        knobs at their defaults contribute 0, preserving every
        historical id."""
        return ((self.tile_id * len(_PARTITIONS)
                 + _PARTITIONS.index(self.partition)) * 64
                + self.trsm_seq_chips) * 1024 + self.n_chips \
            + ((self.flash_block_id * len(FLASH_GRIDS)
                + FLASH_GRIDS.index(self.flash_grid)) << 22)


@dataclasses.dataclass
class TimeBreakdown:
    """Per-term decomposition, mirroring the paper's Table VII columns:
    kernel-call (compute), data-copy (memory), thread-sync (collective)."""
    compute_s: float
    memory_s: float
    collective_s: float
    launch_s: float

    @property
    def total_s(self) -> float:
        # compute and HBM traffic overlap inside the kernel (systolic
        # pipeline); collectives + launches serialise with the kernel.
        return max(self.compute_s, self.memory_s) + self.collective_s \
            + self.launch_s


def chip_doublings(max_chips: int) -> list[int]:
    """Power-of-two chip counts up to ``max_chips``: ``[1, 2, 4, ...]``.

    Non-power-of-two values are truncated down to the largest power of
    two ``<= max_chips`` (``6 -> [1, 2, 4]``) — the behaviour the install
    grid has always had, now documented instead of silent.  ``max_chips``
    must be a positive integer; the historical ``int(math.log2(...))``
    raised a bare ``ValueError: math domain error`` on ``max_chips <= 0``.
    """
    if isinstance(max_chips, bool) or not isinstance(
            max_chips, (int, np.integer)):
        raise ValueError(
            f"max_chips must be an integer, got {max_chips!r}")
    if max_chips < 1:
        raise ValueError(f"max_chips must be >= 1, got {max_chips}")
    return [2 ** i for i in range(int(max_chips).bit_length())]


def candidate_configs(max_chips: int = 512, *,
                      tiles: Iterable[int] | None = None,
                      partitions: Iterable[str] = _PARTITIONS
                      ) -> list[GemmConfig]:
    """The candidate set the tuner argmins over (paper: 1..n_cores).

    Since the search refactor this is a thin exhaustive enumeration of
    the *default* :class:`~repro.core.search.ConfigSpace` — bit-for-bit
    the list the historical triple loop produced (chip doublings outer,
    then partitions with the 2D >= 4-chip gate, then tiles).  Callers
    wanting a larger space (extended tiles, 3*2^k chip counts, the TRSM
    pipeline knob) build a space explicitly and search it instead of
    enumerating.
    """
    from repro_torch.core.search.space import ConfigSpace  # lazy: avoid cycle
    return ConfigSpace.default(max_chips, tiles=tiles,
                               partitions=partitions).enumerate()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _local_shape(m: int, k: int, n: int, cfg: GemmConfig,
                 routine: str = "gemm") -> tuple[int, int, int]:
    """Per-chip problem extents under the chosen partitioning.

    TRSM's substitution dependency runs along M: sharding M (directly or
    via 2D) only helps up to ``cfg.trsm_seq_chips`` chips (the config's
    pipeline-depth knob; default = the historical constant) — the rest
    wait on their predecessors' panels.
    """
    p = cfg.n_chips
    if cfg.partition == "M":
        pm = min(p, cfg.trsm_seq_chips) if routine == "trsm" else p
        return _ceil_div(m, pm), k, n
    if cfg.partition == "N":
        return m, k, _ceil_div(n, p)
    if cfg.partition == "K":
        return m, _ceil_div(k, p), n
    # 2D: factor p into the two most square factors, shard M x N
    pm = 2 ** (int(math.log2(p)) // 2)
    pn = p // pm
    if routine == "trsm":
        pm = min(pm, cfg.trsm_seq_chips)
    return _ceil_div(m, pm), k, _ceil_div(n, pn)


def _collective_bytes(m: int, k: int, n: int, cfg: GemmConfig,
                      dtype_bytes: int, routine: str = "gemm"
                      ) -> tuple[float, int]:
    """(bytes per chip moved over ICI, number of collective phases).

    Routine-aware: SYRK's K-partition all-reduce carries only the
    triangular half of C; TRSM's 2D rings use the dependency-capped M
    factor (idle chips gather nothing extra).
    """
    p = cfg.n_chips
    if p == 1:
        return 0.0, 0
    frac = (p - 1) / p
    if cfg.partition == "M":      # all-gather B
        return frac * k * n * dtype_bytes, 1
    if cfg.partition == "N":      # all-gather A
        return frac * m * k * dtype_bytes, 1
    if cfg.partition == "K":      # all-reduce partial C (2x traffic)
        coll = 2.0 * frac * m * n * dtype_bytes
        if routine == "syrk":     # only the triangle is reduced
            coll = coll * 0.5
        return coll, 2
    # 2D: all-gather A along pn ring, B along pm ring
    pm = 2 ** (int(math.log2(p)) // 2)
    pn = p // pm
    if routine == "trsm":
        pm = min(pm, cfg.trsm_seq_chips)
    bytes_a = (pn - 1) / pn * (m // max(pm, 1)) * k * dtype_bytes
    bytes_b = (pm - 1) / pm * k * (n // max(pn, 1)) * dtype_bytes
    return bytes_a + bytes_b, 2


def estimate_gemm_time(m: int, k: int, n: int, cfg: GemmConfig,
                       spec: TPUSpec = TPUSpec(), *,
                       dtype_bytes: int = 2,
                       rng: np.random.Generator | None = None
                       ) -> TimeBreakdown:
    """Analytic runtime of C[m,n] = A[m,k] @ B[k,n] under ``cfg``.

    The GEMM specialisation of :func:`estimate_routine_time` (identical
    arithmetic — the routine branches are no-ops for gemm).
    """
    return estimate_routine_time(m, k, n, cfg, spec, routine="gemm",
                                 dtype_bytes=dtype_bytes, rng=rng)


def estimate_routine_time(m: int, k: int, n: int, cfg: GemmConfig,
                          spec: TPUSpec = TPUSpec(), *,
                          routine: str = "gemm",
                          dtype_bytes: int = 2,
                          rng: np.random.Generator | None = None
                          ) -> TimeBreakdown:
    """Analytic runtime of one BLAS-3 routine call under ``cfg``.

    Terms:
      compute    — wave-quantised MXU time for the per-chip tile grid
                   (SYRK: triangular fraction of the output grid; TRSM:
                   half the multiply-adds)
      memory     — HBM traffic incl. tile re-reads (SYRK writes/re-reads
                   only triangular C tiles; TRSM reads a triangular A)
      collective — ICI ring time + per-hop latency floor (routine-aware,
                   see :func:`_collective_bytes`)
      launch     — per-kernel-invocation overhead; TRSM multiplies by the
                   M-panel dependency chain (panels retire sequentially)
    Noise (rng given): multiplicative lognormal + rare straggler spikes.

    This scalar path is the bit-for-bit reference for the vectorised
    :func:`estimate_batch_terms`.
    """
    routine = ROUTINES[_routine_id(routine)]
    lm, lk, ln = _local_shape(m, k, n, cfg, routine)
    if routine == "attn":
        # flash attention blocks along (Sq, Skv); the head dim (k) is
        # resident in VMEM, never tiled
        fbq, fbkv = cfg.flash_block
        bm, bk, bn = min(fbq, _pad(lm)), _pad(lk), min(fbkv, _pad(ln))
    else:
        bm, bk, bn = cfg.tile
        bm, bk, bn = min(bm, _pad(lm)), min(bk, _pad(lk)), min(bn, _pad(ln))

    gm, gk, gn = _ceil_div(lm, bm), _ceil_div(lk, bk), _ceil_div(ln, bn)

    # triangular fraction of the local output tile grid: the share of
    # (gm x gn) tiles a lower-triangular output actually touches.  Exact
    # for square grids (g(g+1)/2 tiles); <= 1 always, -> 1/2 as the grid
    # grows, == 1 for a single tile.
    tri_frac = 0.5 * (1.0 + 1.0 / max(gm, gn))

    # flash grid fraction: share of the (gm x gn) KV grid the kernel
    # actually *launches* — the dense grid streams every block and skips
    # masked MXU work via pl.when; the triangular grid never launches
    # above-diagonal tiles, so K/V traffic and step overhead shrink too
    grid_frac = tri_frac if cfg.flash_grid != "dense" else 1.0

    # ---- compute: padded-tile FLOPs at MXU efficiency --------------------
    mxu = spec.mxu_dim
    eff_m = bm / (_ceil_div(bm, mxu) * mxu)
    eff_n = bn / (_ceil_div(bn, mxu) * mxu)
    # sub-128 K still fills the pipeline after warmup; mild penalty
    eff_k = min(1.0, (bk + 16) / mxu) if bk < mxu else 1.0
    mxu_eff = max(eff_m * eff_n * min(eff_k, 1.0), 0.02)
    flops = 2.0 * (gm * bm) * (gk * bk) * (gn * bn)
    if routine == "syrk":
        flops = flops * tri_frac
    elif routine == "trsm":       # substitution: half the multiply-adds
        flops = flops * 0.5
    elif routine == "attn":       # score + AV matmuls, causal triangle
        # (MXU work is triangular on *both* grids — dense skips masked
        # tiles via pl.when; only traffic/launches differ)
        flops = flops * 2.0 * tri_frac
    compute_s = flops / (spec.peak_flops * mxu_eff)

    # ---- memory: blocked HBM traffic -------------------------------------
    bytes_a = lm * lk * gn * dtype_bytes          # A re-read per N block col
    bytes_b = lk * ln * gm * dtype_bytes          # B re-read per M block row
    bytes_c = lm * ln * (dtype_bytes + 2 * dtype_bytes * (gk - 1))
    if routine == "syrk":         # only triangular C tiles written/re-read
        bytes_c = bytes_c * tri_frac
    elif routine == "trsm":       # triangular operand panel reads
        bytes_a = bytes_a * 0.5
    elif routine == "attn":
        # online softmax: Q streams exactly once (resident across its KV
        # loop), K *and* V stream once per launched Q row (grid_frac of
        # the dense re-read), and the output O[m, k] is written once —
        # no (Sq, Skv) score matrix ever touches HBM
        bytes_a = lm * lk * dtype_bytes
        bytes_b = lk * ln * gm * (2 * dtype_bytes) * grid_frac
        bytes_c = lm * lk * dtype_bytes
    # VMEM overflow cliff: working set beyond VMEM spills accumulators
    working = (bm * bk + bk * bn + bm * bn) * dtype_bytes * 2  # dbl buffer
    spill = 1.0 if working <= spec.vmem_bytes else 4.0
    memory_s = spill * (bytes_a + bytes_b + bytes_c) / spec.hbm_bw

    # ---- collective: ring bandwidth + latency floor -----------------------
    coll_bytes, phases = _collective_bytes(m, k, n, cfg, dtype_bytes,
                                           routine)
    hops = max(cfg.n_chips - 1, 0)
    collective_s = (coll_bytes / spec.ici_bw_total
                    + phases * (hops * spec.collective_latency_s
                                + spec.collective_dispatch_s))

    launch_s = spec.launch_overhead_s * max(1.0, math.log2(cfg.n_chips + 1))
    if routine == "trsm":
        # dependency chain: every global M panel is a dependent launch
        launch_s = launch_s * _ceil_div(m, bm)
    elif routine == "attn":
        # per-grid-step pipeline overhead: the triangular grid pays it
        # only for launched (below-diagonal) tiles
        launch_s = launch_s + spec.flash_step_s * (gm * gn * grid_frac)

    tb = TimeBreakdown(compute_s, memory_s, collective_s, launch_s)
    if rng is not None:
        jitter = float(np.exp(rng.normal(0.0, 0.05)))
        straggler = 1.0
        if cfg.n_chips > 1 and rng.random() < 0.01:   # rare straggler
            straggler = 1.0 + float(rng.exponential(0.5))
        tb = TimeBreakdown(compute_s * jitter, memory_s * jitter,
                           collective_s * jitter * straggler, launch_s)
    return tb


def _pad(x: int) -> int:
    """Round up to the sublane multiple (8) so tiny dims stay legal."""
    return max(8, _ceil_div(x, 8) * 8)


@dataclasses.dataclass
class BatchBreakdown:
    """Vectorised :class:`TimeBreakdown`: each term is a (D, C) array over
    the dims x configs grid.  ``total_s`` applies the same overlap rule as
    the scalar path (compute/HBM overlap; collectives + launches serialise).
    """
    compute_s: np.ndarray
    memory_s: np.ndarray
    collective_s: np.ndarray
    launch_s: np.ndarray

    @property
    def total_s(self) -> np.ndarray:
        return np.maximum(self.compute_s, self.memory_s) \
            + self.collective_s + self.launch_s


def config_arrays(cfgs: list[GemmConfig]) -> dict[str, np.ndarray]:
    """Columnar view of a candidate set, shape (C,) per field."""
    tiles = np.asarray([c.tile for c in cfgs], dtype=np.int64)
    fblocks = np.asarray([c.flash_block for c in cfgs], dtype=np.int64)
    return {
        "n_chips": np.asarray([c.n_chips for c in cfgs], dtype=np.int64),
        "partition": np.asarray(
            [_PARTITIONS.index(c.partition) for c in cfgs], dtype=np.int64),
        "tile_id": np.asarray([c.tile_id for c in cfgs], dtype=np.int64),
        "trsm_seq_chips": np.asarray(
            [c.trsm_seq_chips for c in cfgs], dtype=np.int64),
        "bm": tiles[:, 0], "bk": tiles[:, 1], "bn": tiles[:, 2],
        "flash_block_id": np.asarray(
            [c.flash_block_id for c in cfgs], dtype=np.int64),
        "flash_bq": fblocks[:, 0], "flash_bkv": fblocks[:, 1],
        "flash_tri": np.asarray(
            [c.flash_grid != "dense" for c in cfgs], dtype=np.int64),
    }


def _ceil_div_f(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact ceil-division on float64-held integers.

    For integer-valued float64 operands with ``a < 2**53`` the IEEE
    quotient cannot cross an integer boundary (the gap to the nearest
    integer is >= 1/b while the rounding error is < (a/b) * 2**-53), so
    ``ceil(a / b)`` equals exact integer ceil-division — while the float
    division vectorises ~6x faster than int64 ``//``.
    """
    return np.ceil(a / b)


def _pad_f(x: np.ndarray) -> np.ndarray:
    return np.maximum(8.0, _ceil_div_f(x, 8.0) * 8.0)


def estimate_batch_terms(dims: np.ndarray, cfgs: list[GemmConfig],
                         spec: TPUSpec = TPUSpec(), *,
                         dtype_bytes: int = 2,
                         rng: np.random.Generator | None = None,
                         routines=None) -> BatchBreakdown:
    """Vectorised :func:`estimate_routine_time` over a (dims x configs)
    grid.

    One broadcasted NumPy pass instead of ``D * C`` scalar calls — the
    install-time "timing program" hot path.  ``routines`` is ``None``
    (all gemm), a single routine name, or one name/id per dim — rows of
    the grid may mix routines freely.  Noise-free output matches the
    scalar path bit-for-bit for every routine (each term applies the
    identical sequence of IEEE operations elementwise; routine
    multipliers are either exact power-of-two scalings or the same
    float64 products in the same order).  With ``rng`` the noise model is
    the same lognormal jitter + rare straggler spikes, drawn as (D, C)
    blocks (the draw order differs from the scalar loop, so noisy values
    match in distribution, not bitwise).
    """
    dims = np.atleast_2d(np.asarray(dims, dtype=np.int64))
    m = dims[:, 0:1].astype(np.float64)   # (D, 1) — broadcast against (C,)
    k = dims[:, 1:2].astype(np.float64)
    n = dims[:, 2:3].astype(np.float64)
    rids = routine_ids(routines, len(dims))
    is_syrk_d = (rids == ROUTINES.index("syrk"))[:, None]     # (D, 1)
    is_trsm_d = (rids == ROUTINES.index("trsm"))[:, None]
    is_attn_d = (rids == ROUTINES.index("attn"))[:, None]
    any_syrk = bool(is_syrk_d.any())
    any_trsm = bool(is_trsm_d.any())
    any_attn = bool(is_attn_d.any())
    ca = config_arrays(cfgs)

    # Local shapes, collectives and launch cost are tile-independent, so
    # compute them once per unique (n_chips, partition, trsm_seq_chips)
    # triple — typically ~8x fewer columns than the full candidate set —
    # and gather back to (D, C) by index afterwards.  (Routine only
    # varies along D, so the dedup over config columns survives the
    # routine axis.)
    max_seq = int(ca["trsm_seq_chips"].max())
    pp_keys = (ca["partition"] * (int(ca["n_chips"].max()) + 1)
               + ca["n_chips"]) * (max_seq + 1) + ca["trsm_seq_chips"]
    _, uniq_idx, inv = np.unique(pp_keys, return_index=True,
                                 return_inverse=True)
    p = ca["n_chips"][None, uniq_idx].astype(np.float64)    # (1, U)
    part = ca["partition"][None, uniq_idx]
    seq = ca["trsm_seq_chips"][None, uniq_idx].astype(np.float64)

    # ---- local shapes under each partitioning ----------------------------
    # 2D factorisation: p -> (pm, pn), the two most square power factors.
    pm2d = 2.0 ** np.floor(np.floor(np.log2(p)) / 2.0)
    pn2d = np.floor(p / pm2d)
    is_m = part == _PARTITIONS.index("M")
    is_n = part == _PARTITIONS.index("N")
    is_k = part == _PARTITIONS.index("K")
    is_2d = part == _PARTITIONS.index("2D")

    # TRSM: at most trsm_seq_chips chips help along the sequential M axis
    # (per-config pipeline-depth knob; every classic config carries the
    # historical default)
    if any_trsm:
        p_m = np.where(is_trsm_d, np.minimum(p, seq), p)
        pm2d_eff = np.where(is_trsm_d, np.minimum(pm2d, seq), pm2d)
    else:
        p_m, pm2d_eff = p, pm2d

    lm = np.where(is_m, _ceil_div_f(m, p_m),
                  np.where(is_2d, _ceil_div_f(m, pm2d_eff), m))  # (D, U)
    lk = np.where(is_k, _ceil_div_f(k, p), k)
    ln = np.where(is_n, _ceil_div_f(n, p),
                  np.where(is_2d, _ceil_div_f(n, pn2d), n))

    # ---- tile clamped to the (padded) local problem ----------------------
    pad_m, pad_k, pad_n = _pad_f(lm), _pad_f(lk), _pad_f(ln)
    lm, lk, ln = lm[:, inv], lk[:, inv], ln[:, inv]           # (D, C)
    bm = np.minimum(ca["bm"][None, :], pad_m[:, inv])
    bk = np.minimum(ca["bk"][None, :], pad_k[:, inv])
    bn = np.minimum(ca["bn"][None, :], pad_n[:, inv])
    if any_attn:
        # attn rows block along (Sq, Skv) via the config's flash preset;
        # the head dim is VMEM-resident, never tiled (see scalar path)
        bm = np.where(is_attn_d,
                      np.minimum(ca["flash_bq"][None, :], pad_m[:, inv]), bm)
        bk = np.where(is_attn_d, pad_k[:, inv], bk)
        bn = np.where(is_attn_d,
                      np.minimum(ca["flash_bkv"][None, :], pad_n[:, inv]), bn)
    gm = _ceil_div_f(lm, bm)
    gk = _ceil_div_f(lk, bk)
    gn = _ceil_div_f(ln, bn)

    # triangular fraction of the local output tile grid (see scalar path)
    tri_frac = 0.5 * (1.0 + 1.0 / np.maximum(gm, gn))
    if any_attn:
        # launched share of the flash KV grid (1.0 on the dense grid)
        grid_frac = np.where(ca["flash_tri"][None, :] == 1, tri_frac, 1.0)

    # ---- compute: padded-tile FLOPs at wave-quantised MXU efficiency -----
    mxu = float(spec.mxu_dim)
    eff_m = bm / (_ceil_div_f(bm, mxu) * mxu)
    eff_n = bn / (_ceil_div_f(bn, mxu) * mxu)
    eff_k = np.where(bk < mxu, np.minimum(1.0, (bk + 16) / mxu), 1.0)
    mxu_eff = np.maximum(eff_m * eff_n * np.minimum(eff_k, 1.0), 0.02)
    flops = 2.0 * (gm * bm) * (gk * bk) * (gn * bn)
    if any_syrk:
        flops = np.where(is_syrk_d, flops * tri_frac, flops)
    if any_trsm:
        flops = np.where(is_trsm_d, flops * 0.5, flops)
    if any_attn:
        flops = np.where(is_attn_d, flops * 2.0 * tri_frac, flops)
    compute_s = flops / (spec.peak_flops * mxu_eff)

    # ---- memory: blocked HBM traffic with VMEM-spill cliff ---------------
    bytes_a = lm * lk * gn * dtype_bytes
    bytes_b = lk * ln * gm * dtype_bytes
    bytes_c = lm * ln * (dtype_bytes + 2 * dtype_bytes * (gk - 1))
    if any_syrk:
        bytes_c = np.where(is_syrk_d, bytes_c * tri_frac, bytes_c)
    if any_trsm:
        bytes_a = np.where(is_trsm_d, bytes_a * 0.5, bytes_a)
    if any_attn:                  # online softmax (see scalar path)
        bytes_a = np.where(is_attn_d, lm * lk * dtype_bytes, bytes_a)
        bytes_b = np.where(is_attn_d,
                           lk * ln * gm * (2 * dtype_bytes) * grid_frac,
                           bytes_b)
        bytes_c = np.where(is_attn_d, lm * lk * dtype_bytes, bytes_c)
    working = (bm * bk + bk * bn + bm * bn) * dtype_bytes * 2
    spill = np.where(working <= spec.vmem_bytes, 1.0, 4.0)
    memory_s = spill * (bytes_a + bytes_b + bytes_c) / spec.hbm_bw

    # ---- collective: ring bandwidth + latency floor (per (p, part)) ------
    frac = (p - 1) / p
    coll_k = 2.0 * frac * m * n * dtype_bytes
    if any_syrk:                  # SYRK all-reduces only the triangle
        coll_k = np.where(is_syrk_d, coll_k * 0.5, coll_k)
    coll_bytes = np.where(
        is_m, frac * k * n * dtype_bytes,
        np.where(is_n, frac * m * k * dtype_bytes,
                 np.where(is_k, coll_k,
                          (pn2d - 1) / pn2d
                          * (m // np.maximum(pm2d_eff, 1)) * k * dtype_bytes
                          + (pm2d_eff - 1) / pm2d_eff
                          * k * (n // np.maximum(pn2d, 1)) * dtype_bytes)))
    phases = np.where(is_m | is_n, 1, 2)
    coll_bytes = np.where(p == 1, 0.0, coll_bytes)
    phases = np.where(p == 1, 0, phases)
    hops = np.maximum(p - 1, 0)
    collective_s = (coll_bytes / spec.ici_bw_total
                    + phases * (hops * spec.collective_latency_s
                                + spec.collective_dispatch_s))[:, inv]

    launch_s = spec.launch_overhead_s * np.maximum(1.0, np.log2(p + 1))
    launch_s = np.broadcast_to(launch_s[:, inv],
                               compute_s.shape).copy()
    if any_trsm:                  # dependent launch per global M panel
        launch_s = np.where(is_trsm_d, launch_s * _ceil_div_f(m, bm),
                            launch_s)
    if any_attn:                  # per-grid-step overhead, launched tiles
        launch_s = np.where(
            is_attn_d,
            launch_s + spec.flash_step_s * (gm * gn * grid_frac), launch_s)

    if rng is not None:
        jitter = np.exp(rng.normal(0.0, 0.05, size=compute_s.shape))
        straggler = np.where(
            (ca["n_chips"][None, :] > 1)
            & (rng.random(size=compute_s.shape) < 0.01),
            1.0 + rng.exponential(0.5, size=compute_s.shape), 1.0)
        return BatchBreakdown(compute_s * jitter, memory_s * jitter,
                              collective_s * jitter * straggler, launch_s)
    return BatchBreakdown(compute_s, memory_s, collective_s, launch_s)


def estimate_batch(dims: np.ndarray, cfgs: list[GemmConfig],
                   spec: TPUSpec = TPUSpec(), *, dtype_bytes: int = 2,
                   seed: int | None = 0, routines=None) -> np.ndarray:
    """Runtime matrix, shape (len(dims), len(cfgs)); noisy if seed given.

    Vectorised: one broadcasted pass over the whole grid (see
    :func:`estimate_batch_terms`) instead of the historical D*C scalar
    loop — ~2 orders of magnitude faster at install-scale grids.
    ``routines`` (None, one name, or one per dim) selects the BLAS-3
    routine each row of the grid is timed as.
    """
    rng = np.random.default_rng(seed) if seed is not None else None
    return estimate_batch_terms(dims, cfgs, spec, dtype_bytes=dtype_bytes,
                                rng=rng, routines=routines).total_s
