"""Feature engineering for BLAS-3 runtime regression (paper Table II).

Group 1 (serial terms):   m, k, n, n_workers, m*k, m*n, k*n, m*k*n,
                          m*k + k*n + m*n
Group 2 (parallel terms): m/t, k/t, n/t, m*k/t, m*n/t, k*n/t, m*k*n/t,
                          (m*k + k*n + m*n)/t        with t = n_workers

On TPU the "worker" is a (submesh chips × kernel tile) configuration id;
the feature map receives the *chip count* as ``n_workers`` plus a tile
index — see DESIGN.md §Hardware adaptation.  The tile index enters as an
extra categorical-as-numeric column so the identical Table II structure
is preserved.

Routine extension (arXiv 2406.19621 analogue): when a ``routine_id`` is
given, six routine-aware columns are appended — a one-hot over
{syrk, trsm} (gemm is the all-zero baseline), the asymptotic flop scale
(gemm 1, syrk/trsm ½), the scaled work volume ``flops_scale * mkn`` and
its per-worker share, and a routine-specific aspect ratio (trsm: m/n,
the dependency-chain length per RHS column; syrk: k/m, update depth per
output row; gemm: 0).  ``routine_id=None`` emits the original 19-column
GEMM-only layout so models trained by pre-routine installations keep
receiving exactly the features they were fitted on.

Flash extension (the tuned-attention PR): when ``flash`` is also given
(the per-row ``(flash_bq, flash_bkv, flash_tri)`` config knobs), four
more columns append — a ``routine_attn`` one-hot and the three flash
knobs, zeroed on non-attn rows so gemm/syrk/trsm rows are bit-identical
to the 25-column layout plus zeros.  ``flash=None`` with a routine id
keeps emitting that 25-column layout (``ROUTINE_FEATURE_NAMES``) for
pre-flash artifacts; attn rows *require* flash knobs.  attn rides the
shared columns with m = Sq, k = head dim, n = Skv, ``seq_ratio`` = n/m
(KV length per query row — >1 on decode, 1 on square prefill).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.costmodel import ROUTINES

__all__ = ["FEATURE_NAMES", "ROUTINE_FEATURE_NAMES", "LEGACY_FEATURE_NAMES",
           "ROUTINE_FLOP_SCALE",
           "build_features", "build_features_single"]

LEGACY_FEATURE_NAMES: list[str] = [
    # Group 1 — serial terms
    "m", "k", "n", "n_workers",
    "m*k", "m*n", "k*n", "m*k*n", "m*k+k*n+m*n",
    # Group 2 — parallel terms
    "m/t", "k/t", "n/t",
    "m*k/t", "m*n/t", "k*n/t", "m*k*n/t", "(m*k+k*n+m*n)/t",
    # TPU extension: kernel tile configuration id (0 when tuning chips only)
    # and the sharded-dimension id (0=M, 1=N, 2=K, 3=2D)
    "tile_id",
    "partition_id",
]

#: The 25-column BLAS-3 layout (generation 2) — what every pre-flash
#: routine-aware artifact was fitted on; still emitted by
#: ``build_features(..., flash=None)``.
ROUTINE_FEATURE_NAMES: list[str] = LEGACY_FEATURE_NAMES + [
    # BLAS-3 routine extension (gemm = all-zero one-hot baseline)
    "routine_syrk",
    "routine_trsm",
    "flops_scale",          # asymptotic flop ratio vs gemm: 1 / 0.5 / 0.5 / 1
    "mkn_scaled",           # flops_scale * m*k*n (routine-adjusted volume)
    "mkn_scaled/t",
    "seq_ratio",            # trsm: m/n; syrk: k/m; attn: n/m; gemm: 0
]

#: Generation 3: the flash-attention extension.  Appended at the end so
#: every generation-2 column keeps its index (test stubs and persisted
#: preprocess stats address columns positionally).
FEATURE_NAMES: list[str] = ROUTINE_FEATURE_NAMES + [
    "routine_attn",
    "flash_bq",             # flash (bq, bkv) block knobs; 0 off attn rows
    "flash_bkv",
    "flash_tri",            # 1 = block-sparse triangular KV grid
]

#: asymptotic flop count relative to a GEMM of the same (m, k, n).
#: attn is 4mkn (score + AV) x the causal 1/2 triangle = 2mkn == gemm.
ROUTINE_FLOP_SCALE: tuple[float, ...] = (1.0, 0.5, 0.5, 1.0)

assert len(ROUTINE_FLOP_SCALE) == len(ROUTINES)

_SYRK = ROUTINES.index("syrk")
_TRSM = ROUTINES.index("trsm")
_ATTN = ROUTINES.index("attn")


def build_features(m: np.ndarray, k: np.ndarray, n: np.ndarray,
                   n_workers: np.ndarray,
                   tile_id: np.ndarray | int = 0,
                   partition_id: np.ndarray | int = 0,
                   routine_id: np.ndarray | int | None = None,
                   flash: tuple | None = None
                   ) -> np.ndarray:
    """Vectorised Table II feature matrix.

    Three generations, selected by the optional arguments:
    ``routine_id=None`` — the legacy (N, 19) GEMM-only layout;
    ``routine_id`` given, ``flash=None`` — the (N, 25)
    ``ROUTINE_FEATURE_NAMES`` layout (attn rows are rejected: a
    pre-flash layout cannot express them);
    ``flash=(flash_bq, flash_bkv, flash_tri)`` (scalars or per-row
    arrays) — the full (N, len(FEATURE_NAMES)) layout.
    """
    m = np.asarray(m, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    t = np.asarray(n_workers, dtype=np.float64)
    tile = np.broadcast_to(np.asarray(tile_id, dtype=np.float64), m.shape)
    part = np.broadcast_to(np.asarray(partition_id, dtype=np.float64),
                           m.shape)

    mk = m * k
    mn = m * n
    kn = k * n
    mkn = m * k * n
    tot = mk + kn + mn

    cols = [
        m, k, n, t,
        mk, mn, kn, mkn, tot,
        m / t, k / t, n / t,
        mk / t, mn / t, kn / t, mkn / t, tot / t,
        tile,
        part,
    ]
    if routine_id is not None:
        rid = np.broadcast_to(
            np.asarray(routine_id, dtype=np.int64), m.shape)
        is_syrk = (rid == _SYRK).astype(np.float64)
        is_trsm = (rid == _TRSM).astype(np.float64)
        is_attn = (rid == _ATTN).astype(np.float64)
        scale = np.asarray(ROUTINE_FLOP_SCALE, dtype=np.float64)[rid]
        mkn_scaled = scale * mkn
        seq_ratio = is_trsm * (m / n) + is_syrk * (k / m) \
            + is_attn * (n / m)
        cols += [is_syrk, is_trsm, scale, mkn_scaled, mkn_scaled / t,
                 seq_ratio]
        if flash is None:
            if bool((rid == _ATTN).any()):
                raise ValueError(
                    "attn rows need flash=(flash_bq, flash_bkv, "
                    "flash_tri); the pre-flash 25-column layout cannot "
                    "express them")
        else:
            fbq, fbkv, ftri = (
                np.broadcast_to(np.asarray(f, dtype=np.float64), m.shape)
                for f in flash)
            # zeroed off attn rows: gemm/syrk/trsm rows stay bit-equal
            # to the generation-2 layout plus zero columns
            cols += [is_attn, is_attn * fbq, is_attn * fbkv,
                     is_attn * ftri]
    elif flash is not None:
        raise ValueError("flash knobs require routine_id")
    return np.stack(cols, axis=1)


def build_features_single(m: int, k: int, n: int, n_workers: int,
                          tile_id: int = 0,
                          partition_id: int = 0,
                          routine_id: int | None = None,
                          flash: tuple | None = None) -> np.ndarray:
    """(1, F) feature row for a single routine instance."""
    return build_features(np.array([m]), np.array([k]), np.array([n]),
                          np.array([n_workers]), np.array([tile_id]),
                          np.array([partition_id]),
                          None if routine_id is None
                          else np.array([routine_id]),
                          flash=flash)
