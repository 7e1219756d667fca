"""Data preprocessing: Yeo-Johnson (MLE), standardisation, LOF, correlation pruning.

Implements the paper's §II-C / §IV-C pipeline from scratch (the container
has no sklearn/scipy):

  raw features --Yeo-Johnson(λ per feature, MLE)--> near-Gaussian
              --standardise--> zero-mean/unit-var
              --LOF--> drop local outliers
              --|ρ|>0.8 pruning--> decorrelated feature set

Order follows the paper exactly: LOF *after* standardisation ("LOF is a
density-based method and thus requires a similar scale in all
dimensions"), correlation pruning last.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "yeo_johnson_transform",
    "yeo_johnson_transform_matrix",
    "yeo_johnson_mle_lambda",
    "YeoJohnson",
    "StandardScaler",
    "local_outlier_factor",
    "correlation_prune",
    "PreprocessPipeline",
]


# ---------------------------------------------------------------------------
# Yeo-Johnson power transform
# ---------------------------------------------------------------------------

def yeo_johnson_transform(x: np.ndarray, lam: float) -> np.ndarray:
    """Yeo-Johnson transform of a 1-D array for parameter ``lam``."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    pos = x >= 0
    # x >= 0 branch
    if abs(lam) < 1e-10:
        out[pos] = np.log1p(x[pos])
    else:
        out[pos] = (np.power(x[pos] + 1.0, lam) - 1.0) / lam
    # x < 0 branch
    if abs(lam - 2.0) < 1e-10:
        out[~pos] = -np.log1p(-x[~pos])
    else:
        out[~pos] = -(np.power(1.0 - x[~pos], 2.0 - lam) - 1.0) / (2.0 - lam)
    return out


def yeo_johnson_transform_matrix(X: np.ndarray,
                                 lambdas: np.ndarray) -> np.ndarray:
    """Vectorised YJ over all columns at once (runtime tuner hot path).

    Equivalent to column-wise ``yeo_johnson_transform`` but one fused
    numpy pass — the per-call latency here is charged to t_eval by the
    paper's model-selection criterion, so it must stay in the tens of µs.
    """
    X = np.asarray(X, dtype=np.float64)
    lam = np.asarray(lambdas, dtype=np.float64)[None, :]
    pos = X >= 0
    lam_zero = np.abs(lam) < 1e-10
    lam_two = np.abs(lam - 2.0) < 1e-10
    xp = np.where(pos, X, 0.0)
    xn = np.where(pos, 0.0, X)
    lam_safe = np.where(lam_zero, 1.0, lam)
    pos_val = np.where(lam_zero, np.log1p(xp),
                       (np.power(xp + 1.0, lam) - 1.0) / lam_safe)
    two_m = np.where(lam_two, 1.0, 2.0 - lam)
    neg_val = np.where(lam_two, -np.log1p(-xn),
                       -(np.power(1.0 - xn, 2.0 - lam) - 1.0) / two_m)
    return np.where(pos, pos_val, neg_val)


def _yj_log_likelihood(x: np.ndarray, lam: float) -> float:
    """Profile log-likelihood of the YJ-transformed data under a Gaussian."""
    n = x.shape[0]
    y = yeo_johnson_transform(x, lam)
    var = y.var()
    if var <= 0 or not np.isfinite(var):
        return -np.inf
    # Jacobian term: (lam - 1) * sum(sign(x) * log1p(|x|))
    jac = (lam - 1.0) * np.sum(np.sign(x) * np.log1p(np.abs(x)))
    return -0.5 * n * np.log(var) + jac


def yeo_johnson_mle_lambda(x: np.ndarray, *, lo: float = -3.0,
                           hi: float = 3.0, tol: float = 1e-4) -> float:
    """MLE of λ via golden-section search on the profile likelihood.

    The likelihood is unimodal in λ for well-behaved data; golden-section
    on [-3, 3] matches scipy's default bracket and needs no gradients.
    """
    x = np.asarray(x, dtype=np.float64)
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc = _yj_log_likelihood(x, c)
    fd = _yj_log_likelihood(x, d)
    while abs(b - a) > tol:
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = _yj_log_likelihood(x, c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = _yj_log_likelihood(x, d)
    return 0.5 * (a + b)


@dataclasses.dataclass
class YeoJohnson:
    """Per-column Yeo-Johnson transformer with MLE-estimated λ."""

    lambdas_: np.ndarray | None = None

    def fit(self, X: np.ndarray) -> "YeoJohnson":
        X = np.asarray(X, dtype=np.float64)
        self.lambdas_ = np.array(
            [yeo_johnson_mle_lambda(X[:, j]) for j in range(X.shape[1])])
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        if self.lambdas_ is None:
            raise RuntimeError("YeoJohnson not fitted")
        return yeo_johnson_transform_matrix(X, self.lambdas_)

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)


# ---------------------------------------------------------------------------
# Standardisation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StandardScaler:
    mean_: np.ndarray | None = None
    scale_: np.ndarray | None = None

    def fit(self, X: np.ndarray) -> "StandardScaler":
        X = np.asarray(X, dtype=np.float64)
        self.mean_ = X.mean(axis=0)
        std = X.std(axis=0)
        self.scale_ = np.where(std > 1e-12, std, 1.0)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        if self.mean_ is None:
            raise RuntimeError("StandardScaler not fitted")
        return (np.asarray(X, dtype=np.float64) - self.mean_) / self.scale_

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)


# ---------------------------------------------------------------------------
# Local Outlier Factor (Breunig et al. 2000)
# ---------------------------------------------------------------------------

def local_outlier_factor(X: np.ndarray, *, k: int = 20) -> np.ndarray:
    """LOF score per row (≈1 inlier, ≫1 outlier).  Exact O(n²) kNN.

    n ~ 10³ in the paper's datasets, so the dense distance matrix is
    cheap and avoids a KD-tree implementation.
    """
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    k = min(k, n - 1)
    if k < 1:
        return np.ones(n)
    # pairwise distances
    sq = np.sum(X * X, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)
    np.maximum(d2, 0.0, out=d2)
    dist = np.sqrt(d2)
    np.fill_diagonal(dist, np.inf)
    # k nearest neighbours
    nn_idx = np.argpartition(dist, k - 1, axis=1)[:, :k]
    rows = np.arange(n)[:, None]
    nn_dist = dist[rows, nn_idx]
    k_dist = nn_dist.max(axis=1)                      # k-distance(p)
    # reachability distance r(p, o) = max(k_dist(o), d(p, o))
    reach = np.maximum(k_dist[nn_idx], nn_dist)
    lrd = 1.0 / (reach.mean(axis=1) + 1e-12)          # local reachability
    lof = (lrd[nn_idx].mean(axis=1)) / (lrd + 1e-12)
    return lof


# ---------------------------------------------------------------------------
# Correlation pruning
# ---------------------------------------------------------------------------

def correlation_prune(X: np.ndarray, *, threshold: float = 0.8,
                      names: list[str] | None = None
                      ) -> tuple[np.ndarray, list[int]]:
    """Drop one of every feature pair with |ρ| > threshold (paper §IV-C).

    "For each correlated feature pair, we remove the feature with the
    larger total correlation with the other features."

    Returns (kept column indices as list, boolean keep-mask) — callers
    index their arrays with the list.
    """
    X = np.asarray(X, dtype=np.float64)
    f = X.shape[1]
    with np.errstate(invalid="ignore"):
        corr = np.corrcoef(X, rowvar=False)
    corr = np.nan_to_num(corr, nan=0.0)
    np.fill_diagonal(corr, 0.0)
    abs_corr = np.abs(corr)
    alive = np.ones(f, dtype=bool)
    while True:
        masked = abs_corr * np.outer(alive, alive)
        i, j = np.unravel_index(np.argmax(masked), masked.shape)
        if masked[i, j] <= threshold:
            break
        # drop the one with larger total correlation to everything alive
        tot_i = masked[i].sum()
        tot_j = masked[j].sum()
        alive[i if tot_i >= tot_j else j] = False
    kept = [int(i) for i in np.nonzero(alive)[0]]
    return alive, kept


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PreprocessPipeline:
    """YJ -> standardise -> (fit-time LOF row filter) -> correlation prune.

    ``fit`` learns λ, mean/scale and the kept-feature set from training
    data and returns the filtered training matrix; ``transform`` applies
    the learned mapping to new data (no row filtering at inference).
    """

    lof_k: int = 20
    lof_threshold: float = 1.5
    corr_threshold: float = 0.8
    yj: YeoJohnson = dataclasses.field(default_factory=YeoJohnson)
    scaler: StandardScaler = dataclasses.field(default_factory=StandardScaler)
    kept_features_: list[int] | None = None
    inlier_mask_: np.ndarray | None = None

    def fit_transform(self, X: np.ndarray, y: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
        Xt = self.yj.fit_transform(X)
        Xt = self.scaler.fit_transform(Xt)
        lof = local_outlier_factor(Xt, k=self.lof_k)
        self.inlier_mask_ = lof <= self.lof_threshold
        # never drop more than 10% of rows — LOF is a cleaner, not a filter
        if self.inlier_mask_.mean() < 0.9:
            order = np.argsort(lof)
            keep_n = int(np.ceil(0.9 * len(lof)))
            self.inlier_mask_ = np.zeros(len(lof), dtype=bool)
            self.inlier_mask_[order[:keep_n]] = True
        Xt = Xt[self.inlier_mask_]
        y = np.asarray(y)[self.inlier_mask_]
        _, self.kept_features_ = correlation_prune(
            Xt, threshold=self.corr_threshold)
        return Xt[:, self.kept_features_], y

    def transform(self, X: np.ndarray) -> np.ndarray:
        if self.kept_features_ is None:
            raise RuntimeError("pipeline not fitted")
        Xt = self.scaler.transform(self.yj.transform(X))
        return Xt[:, self.kept_features_]

    # -- persistence -------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "lambdas": self.yj.lambdas_.tolist(),
            "mean": self.scaler.mean_.tolist(),
            "scale": self.scaler.scale_.tolist(),
            "kept_features": self.kept_features_,
            "lof_k": self.lof_k,
            "lof_threshold": self.lof_threshold,
            "corr_threshold": self.corr_threshold,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PreprocessPipeline":
        p = cls(lof_k=d["lof_k"], lof_threshold=d["lof_threshold"],
                corr_threshold=d["corr_threshold"])
        p.yj.lambdas_ = np.asarray(d["lambdas"])
        p.scaler.mean_ = np.asarray(d["mean"])
        p.scaler.scale_ = np.asarray(d["scale"])
        p.kept_features_ = list(d["kept_features"])
        return p
