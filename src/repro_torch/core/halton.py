"""Scrambled Halton sequence sampling of the GEMM input domain.

The paper (§IV-B) samples (m, k, n) with a *scrambled* Halton sequence so
that the training set is low-discrepancy across the whole domain,
including slim/fat and tiny/huge matrices.  Scrambling (random digit
permutations, Mascagni & Chi 2004) breaks the inter-dimensional
correlation plain Halton suffers from in higher bases.

Deviation from the paper recorded in DESIGN.md: the paper lists bases
(2, 3, 4); base 4 is not coprime with base 2 which destroys the
low-discrepancy property the cited reference requires, so we use the
first three primes (2, 3, 5).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "halton_sequence",
    "scrambled_halton",
    "sample_gemm_dims",
    "sample_gemm_dims_mixture",
    "gemm_bytes",
]

# First six primes: (m, k, n) sampling uses the leading three; the
# config-space lattice sampler (ConfigSpace.sample) draws one base per
# axis and enlarged spaces have four axes.  Extra bases never change the
# leading columns — each dimension's stream only depends on its own base.
_DEFAULT_BASES = (2, 3, 5, 7, 11, 13)


def _digit_permutations(base: int, rng: np.random.Generator) -> np.ndarray:
    """A random permutation of {0..base-1} fixing 0.

    Fixing 0 keeps the radical-inverse map well defined (trailing zeros
    must stay zeros, otherwise the sequence escapes [0, 1)).
    """
    perm = 1 + rng.permutation(base - 1)
    return np.concatenate([[0], perm])


def _radical_inverse(indices: np.ndarray, base: int,
                     perm: np.ndarray | None) -> np.ndarray:
    """Vectorised (scrambled) radical inverse of ``indices`` in ``base``."""
    idx = indices.astype(np.int64).copy()
    out = np.zeros(idx.shape, dtype=np.float64)
    inv_base = 1.0 / base
    factor = inv_base
    while np.any(idx > 0):
        digits = idx % base
        if perm is not None:
            digits = perm[digits]
        out += digits * factor
        idx //= base
        factor *= inv_base
    return out


def halton_sequence(n: int, dims: int = 3, *, start: int = 1,
                    bases: tuple[int, ...] | None = None) -> np.ndarray:
    """Plain Halton points in [0, 1)^dims, shape (n, dims)."""
    bases = bases or _DEFAULT_BASES
    if dims > len(bases):
        raise ValueError(f"need {dims} bases, have {len(bases)}")
    indices = np.arange(start, start + n)
    cols = [_radical_inverse(indices, bases[d], None) for d in range(dims)]
    return np.stack(cols, axis=1)


def scrambled_halton(n: int, dims: int = 3, *, seed: int = 0,
                     start: int = 1,
                     bases: tuple[int, ...] | None = None) -> np.ndarray:
    """Scrambled Halton points in [0, 1)^dims, shape (n, dims)."""
    bases = bases or _DEFAULT_BASES
    if dims > len(bases):
        raise ValueError(f"need {dims} bases, have {len(bases)}")
    rng = np.random.default_rng(seed)
    indices = np.arange(start, start + n)
    cols = []
    for d in range(dims):
        perm = _digit_permutations(bases[d], rng)
        cols.append(_radical_inverse(indices, bases[d], perm))
    return np.stack(cols, axis=1)


def gemm_bytes(m: np.ndarray, k: np.ndarray, n: np.ndarray,
               dtype_bytes: int = 4) -> np.ndarray:
    """Aggregate operand footprint: dtype_bytes * (mk + kn + mn)  (§IV-B)."""
    m = np.asarray(m, dtype=np.int64)
    k = np.asarray(k, dtype=np.int64)
    n = np.asarray(n, dtype=np.int64)
    return dtype_bytes * (m * k + k * n + m * n)


def sample_gemm_dims(n_samples: int, *, mem_limit_bytes: int,
                     dim_min: int = 8, dim_max: int = 65536,
                     dtype_bytes: int = 4, seed: int = 0,
                     log_space: bool = True) -> np.ndarray:
    """Sample (m, k, n) triples under a memory budget (paper §IV-B).

    Points are drawn from a scrambled Halton sequence, mapped to the
    dimension range (log-uniformly by default — matrix dims span four
    orders of magnitude), and rejected when the aggregate operand
    footprint exceeds ``mem_limit_bytes``.  Rejection preserves the
    low-discrepancy property inside the accepted region.

    Returns an (n_samples, 3) int64 array.
    """
    accepted: list[np.ndarray] = []
    start = 1
    total = 0
    lo, hi = np.log2(dim_min), np.log2(dim_max)
    while total < n_samples:
        batch = max(256, 2 * (n_samples - total))
        u = scrambled_halton(batch, 3, seed=seed, start=start)
        start += batch
        if log_space:
            dims = np.exp2(lo + u * (hi - lo))
        else:
            dims = dim_min + u * (dim_max - dim_min)
        dims = np.maximum(dim_min, np.round(dims)).astype(np.int64)
        keep = gemm_bytes(dims[:, 0], dims[:, 1], dims[:, 2],
                          dtype_bytes) <= mem_limit_bytes
        kept = dims[keep]
        if kept.size:
            accepted.append(kept)
            total += len(kept)
        if start > 10_000_000:  # pragma: no cover - domain misconfigured
            raise RuntimeError("halton rejection sampling failed to fill")
    return np.concatenate(accepted, axis=0)[:n_samples]


def _sample_region(n: int, lo: np.ndarray, hi: np.ndarray, *,
                   mem_limit_bytes: int, dim_min: int, dim_max: int,
                   dtype_bytes: int, seed: int) -> np.ndarray:
    """Up to ``n`` accepted samples inside one log2 box (rejection on the
    memory budget; the box is clipped to the global dim range first)."""
    lo = np.maximum(lo, np.log2(dim_min))
    hi = np.minimum(hi, np.log2(dim_max))
    if np.any(hi <= lo):                    # box outside the domain
        return np.empty((0, 3), dtype=np.int64)
    accepted: list[np.ndarray] = []
    start, total, tried = 1, 0, 0
    while total < n and tried < 64 * max(n, 8):
        batch = max(64, 2 * (n - total))
        u = scrambled_halton(batch, 3, seed=seed, start=start)
        start += batch
        tried += batch
        dims = np.maximum(dim_min,
                          np.round(np.exp2(lo + u * (hi - lo)))
                          ).astype(np.int64)
        keep = gemm_bytes(dims[:, 0], dims[:, 1], dims[:, 2],
                          dtype_bytes) <= mem_limit_bytes
        kept = dims[keep]
        if kept.size:
            accepted.append(kept)
            total += len(kept)
    if not accepted:
        return np.empty((0, 3), dtype=np.int64)
    return np.concatenate(accepted, axis=0)[:n]


def sample_gemm_dims_mixture(
        n_samples: int,
        regions: list[tuple[tuple[float, float, float],
                            tuple[float, float, float], float]], *,
        mem_limit_bytes: int, bias: float = 0.75, dim_min: int = 8,
        dim_max: int = 65536, dtype_bytes: int = 4, seed: int = 0,
        log_space: bool = False) -> np.ndarray:
    """Workload-biased (m, k, n) sampling (mixture of Halton streams).

    ``regions`` is ``[(log2_lo, log2_hi, weight), ...]`` — typically a
    :meth:`WorkloadProfile.region_boxes` shape histogram.  A ``bias``
    fraction of the budget is apportioned across the regions by weight
    and drawn from an independent scrambled-Halton stream per region
    (low-discrepancy *within* each region, log-uniform over its box);
    the remaining ``1 - bias`` is the uniform floor, drawn by
    :func:`sample_gemm_dims` over the whole domain so coverage never
    collapses onto the observed workload.  Regions that cannot fill
    their quota (e.g. mostly above the memory budget) hand the
    shortfall back to the floor.  The returned rows are shuffled with a
    ``seed``-derived permutation so sample index carries no region
    structure.  All samples respect the memory budget; deterministic
    given ``seed``.
    """
    if not 0.0 <= bias <= 1.0:
        raise ValueError(f"bias={bias} outside [0, 1]")
    if not regions or bias == 0.0:
        return sample_gemm_dims(
            n_samples, mem_limit_bytes=mem_limit_bytes, dim_min=dim_min,
            dim_max=dim_max, dtype_bytes=dtype_bytes, seed=seed,
            log_space=log_space)
    from repro_torch.core.workload import apportion  # shared allocator

    n_bias = int(round(bias * n_samples))
    quotas = apportion([max(float(w), 0.0) for *_, w in regions], n_bias)
    parts: list[np.ndarray] = []
    drawn = 0
    for i, ((lo, hi, _), q) in enumerate(zip(regions, quotas)):
        if q <= 0:
            continue
        got = _sample_region(
            q, np.asarray(lo, dtype=np.float64),
            np.asarray(hi, dtype=np.float64),
            mem_limit_bytes=mem_limit_bytes, dim_min=dim_min,
            dim_max=dim_max, dtype_bytes=dtype_bytes,
            seed=seed + 100_003 * (i + 1))
        if got.size:
            parts.append(got)
            drawn += len(got)
    n_floor = n_samples - drawn
    if n_floor > 0:
        parts.append(sample_gemm_dims(
            n_floor, mem_limit_bytes=mem_limit_bytes, dim_min=dim_min,
            dim_max=dim_max, dtype_bytes=dtype_bytes, seed=seed,
            log_space=log_space))
    dims = np.concatenate(parts, axis=0)[:n_samples]
    # distinct stream from the caller's plain default_rng(seed): the
    # installer permutes its routine assignment with exactly that rng
    # over the same n, and two identical permutations cancel in the
    # (dim, routine) pairing — routine id would re-align with the
    # region block order, the very stratification this samples against
    perm = np.random.default_rng([seed, 0x5A]).permutation(len(dims))
    return dims[perm]
