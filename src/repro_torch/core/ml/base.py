"""Common regressor interface, metrics, splits and hyper-parameter search."""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator, Protocol, runtime_checkable

import numpy as np

__all__ = [
    "Regressor", "rmse", "normalised_rmse", "stratified_train_test_split",
    "KFold", "grid_search",
]


@runtime_checkable
class Regressor(Protocol):
    def fit(self, X: np.ndarray, y: np.ndarray) -> "Regressor": ...
    def predict(self, X: np.ndarray) -> np.ndarray: ...
    def get_params(self) -> dict[str, Any]: ...
    def to_dict(self) -> dict: ...


def rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def normalised_rmse(y_true: np.ndarray, y_pred: np.ndarray,
                    baseline_pred: np.ndarray | None = None) -> float:
    """RMSE normalised by the worst linear baseline, as in Tables III/IV.

    The paper normalises so the weakest model (ElasticNet) sits at 1.00;
    we normalise by the RMSE of predicting the training mean, which gives
    the same ordering and a scale-free number.
    """
    base = rmse(y_true, np.full_like(y_true, np.mean(y_true))
                if baseline_pred is None else baseline_pred)
    return rmse(y_true, y_pred) / max(base, 1e-30)


def _stratify_bins(y: np.ndarray, n_bins: int) -> np.ndarray:
    """Quantile-bin a continuous target for stratified splitting (§IV-C)."""
    y = np.asarray(y, dtype=np.float64)
    qs = np.quantile(y, np.linspace(0, 1, n_bins + 1)[1:-1])
    return np.searchsorted(qs, y)


def stratified_train_test_split(
    X: np.ndarray, y: np.ndarray, *, test_fraction: float = 0.3,
    n_bins: int = 10, seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stratified split on quantile bins of the (continuous) label.

    The paper uses stratified sampling "to ensure a similar distribution
    in the train set, test set, and validation sets" with a 30 % test
    fraction.
    """
    rng = np.random.default_rng(seed)
    bins = _stratify_bins(y, n_bins)
    test_idx: list[np.ndarray] = []
    for b in np.unique(bins):
        idx = np.nonzero(bins == b)[0]
        rng.shuffle(idx)
        n_test = int(round(test_fraction * len(idx)))
        test_idx.append(idx[:n_test])
    test = np.concatenate(test_idx) if test_idx else np.empty(0, dtype=int)
    mask = np.ones(len(y), dtype=bool)
    mask[test] = False
    train = np.nonzero(mask)[0]
    return X[train], X[test], np.asarray(y)[train], np.asarray(y)[test]


class KFold:
    """Stratified k-fold on label quantile bins."""

    def __init__(self, n_splits: int = 5, *, n_bins: int = 10, seed: int = 0):
        self.n_splits = n_splits
        self.n_bins = n_bins
        self.seed = seed

    def split(self, y: np.ndarray) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        bins = _stratify_bins(y, self.n_bins)
        folds: list[list[int]] = [[] for _ in range(self.n_splits)]
        for b in np.unique(bins):
            idx = np.nonzero(bins == b)[0]
            rng.shuffle(idx)
            for i, j in enumerate(idx):
                folds[i % self.n_splits].append(j)
        all_idx = np.arange(len(y))
        for f in folds:
            val = np.asarray(sorted(f))
            train = np.setdiff1d(all_idx, val, assume_unique=False)
            yield train, val


def grid_search(
    make_model: Callable[..., Regressor],
    param_grid: dict[str, list[Any]],
    X: np.ndarray, y: np.ndarray, *,
    n_splits: int = 5, seed: int = 0,
    max_candidates: int | None = None,
) -> tuple[dict[str, Any], float]:
    """Exhaustive grid search with stratified k-fold CV; returns best params.

    The paper tunes every candidate model's hyper-parameters with CV
    folds ("we use cross validation folds rather than the leave-one-out
    method ... to reduce its computational cost").
    """
    keys = list(param_grid)
    combos = list(itertools.product(*(param_grid[k] for k in keys)))
    if max_candidates is not None and len(combos) > max_candidates:
        rng = np.random.default_rng(seed)
        pick = rng.choice(len(combos), size=max_candidates, replace=False)
        combos = [combos[i] for i in pick]
    kf = KFold(n_splits=n_splits, seed=seed)
    best_params: dict[str, Any] = {}
    best_score = np.inf
    for combo in combos:
        params = dict(zip(keys, combo))
        scores = []
        for train, val in kf.split(y):
            if len(train) == 0 or len(val) == 0:
                # singleton strata all land in fold 0, so tiny
                # (calibration-scale) datasets can produce empty folds
                continue
            model = make_model(**params)
            model.fit(X[train], y[train])
            scores.append(rmse(y[val], model.predict(X[val])))
        score = float(np.mean(scores)) if scores else np.inf
        if score < best_score:
            best_score, best_params = score, params
    return best_params, best_score
