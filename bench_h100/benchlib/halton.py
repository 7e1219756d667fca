"""A frozen copy of the paper's shape sampler (scrambled Halton points,
bases 2, 3, 5, mapped to dims and rejected above a memory budget), so
that the BLAS mix's shapes do not move when the program's sampler
does.  Copied from ``repro_torch.core.halton.sample_gemm_dims``; the
test ``test_frozen_sampler_matches_the_program`` holds the two equal
today."""

from __future__ import annotations

import numpy as np

_BASES = (2, 3, 5)


def _digit_permutations(base: int, rng: np.random.Generator) -> np.ndarray:
    """A random permutation of {0..base-1} fixing 0."""
    perm = 1 + rng.permutation(base - 1)
    return np.concatenate([[0], perm])


def _radical_inverse(indices: np.ndarray, base: int,
                     perm: np.ndarray) -> np.ndarray:
    idx = indices.astype(np.int64).copy()
    out = np.zeros(idx.shape, dtype=np.float64)
    factor = 1.0 / base
    while np.any(idx > 0):
        out += perm[idx % base] * factor
        idx //= base
        factor /= base
    return out


def scrambled_halton(n: int, *, seed: int, start: int = 1) -> np.ndarray:
    """Scrambled Halton points in [0, 1)^3, shape (n, 3)."""
    rng = np.random.default_rng(seed)
    indices = np.arange(start, start + n)
    cols = []
    for base in _BASES:
        perm = _digit_permutations(base, rng)
        cols.append(_radical_inverse(indices, base, perm))
    return np.stack(cols, axis=1)


def operand_bytes(m, k, n, itemsize: int = 4) -> np.ndarray:
    """itemsize * (mk + kn + mn), the paper's memory measure."""
    m, k, n = (np.asarray(x, dtype=np.int64) for x in (m, k, n))
    return itemsize * (m * k + k * n + m * n)


def sample_dims(n_samples: int, *, mem_limit_bytes: int, dim_min: int = 8,
                dim_max: int = 65536, itemsize: int = 4, seed: int = 0,
                log_space: bool = True) -> np.ndarray:
    """(n_samples, 3) int64 (m, k, n) triples within the budget."""
    accepted: list[np.ndarray] = []
    start, total = 1, 0
    lo, hi = np.log2(dim_min), np.log2(dim_max)
    while total < n_samples:
        batch = max(256, 2 * (n_samples - total))
        u = scrambled_halton(batch, seed=seed, start=start)
        start += batch
        if log_space:
            dims = np.exp2(lo + u * (hi - lo))
        else:
            dims = dim_min + u * (dim_max - dim_min)
        dims = np.maximum(dim_min, np.round(dims)).astype(np.int64)
        kept = dims[operand_bytes(dims[:, 0], dims[:, 1], dims[:, 2],
                                  itemsize) <= mem_limit_bytes]
        if kept.size:
            accepted.append(kept)
            total += len(kept)
        if start > 10_000_000:
            raise RuntimeError("the budget admits no shapes")
    return np.concatenate(accepted, axis=0)[:n_samples]
