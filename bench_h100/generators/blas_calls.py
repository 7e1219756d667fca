"""BLAS-3 call streams: the distinct calls of a mix and the order a
closed-loop caller makes them in.

A mix file gives ``routines``, ``calls_per_routine``, ``mem_limit_mb``,
``dim_min``, ``dim_max``, ``log_space`` and ``shape_seed``: the dims are
drawn as the paper draws them (scrambled Halton, rejected above the
memory budget in fp32) from the shape seed alone, so every run seed
makes the same calls.  Each routine takes the same dims: gemm (m, k) x
(k, n), syrk (m, k), trsm (m, m) against (m, n).  The run seed only
shuffles the order, one new permutation of all calls a cycle."""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from benchlib import halton


def calls(mix: dict) -> list[tuple[str, int, int, int]]:
    dims = halton.sample_dims(
        mix["calls_per_routine"],
        mem_limit_bytes=int(mix["mem_limit_mb"] * 2 ** 20),
        dim_min=mix["dim_min"], dim_max=mix["dim_max"], itemsize=4,
        seed=mix["shape_seed"], log_space=mix["log_space"])
    return [(r, int(m), int(k), int(n)) for r in mix["routines"]
            for m, k, n in dims]


def order(n_calls: int, seed: int) -> Iterator[int]:
    """Call indices, cycle after cycle, each cycle a permutation drawn
    from ``seed``."""
    rng = np.random.default_rng([seed, 2])
    while True:
        yield from (int(i) for i in rng.permutation(n_calls))
