"""Random Forest regressor (paper Table I) on the shared tree engine."""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core.ml.tree import (
    PackedEnsemble,
    TreeArrays,
    build_tree,
)

__all__ = ["RandomForestRegressor"]


class RandomForestRegressor:
    """Bagged CART ensemble with per-node feature subsampling."""

    def __init__(self, n_estimators: int = 100, max_depth: int = 10,
                 min_samples_leaf: int = 1,
                 max_features: float | str = 0.5,
                 bootstrap: bool = True, seed: int = 0) -> None:
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.bootstrap = bootstrap
        self.seed = seed
        self.trees_: list[TreeArrays] = []
        self._packed: PackedEnsemble | None = None

    def get_params(self) -> dict[str, Any]:
        return {"n_estimators": self.n_estimators,
                "max_depth": self.max_depth,
                "min_samples_leaf": self.min_samples_leaf,
                "max_features": self.max_features,
                "bootstrap": self.bootstrap, "seed": self.seed}

    def _n_features_per_split(self, n_feat: int) -> int:
        if self.max_features == "sqrt":
            return max(1, int(np.sqrt(n_feat)))
        return max(1, int(round(float(self.max_features) * n_feat)))

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = X.shape[0]
        rng = np.random.default_rng(self.seed)
        mf = self._n_features_per_split(X.shape[1])
        self.trees_ = []
        for _ in range(self.n_estimators):
            idx = (rng.integers(0, n, size=n) if self.bootstrap
                   else np.arange(n))
            self.trees_.append(build_tree(
                X[idx], -y[idx], np.ones(len(idx)),
                max_depth=self.max_depth,
                min_samples_leaf=self.min_samples_leaf,
                max_features=mf, rng=rng))
        self._packed = PackedEnsemble(self.trees_)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if not self.trees_:
            raise RuntimeError("not fitted")
        if self._packed is None:
            self._packed = PackedEnsemble(self.trees_)
        return self._packed.predict_mean(X)

    def to_dict(self) -> dict:
        return {"kind": "RandomForestRegressor", "params": self.get_params(),
                "trees": [t.to_dict() for t in self.trees_]}

    @classmethod
    def from_dict(cls, d: dict) -> "RandomForestRegressor":
        obj = cls(**d["params"])
        obj.trees_ = [TreeArrays.from_dict(t) for t in d["trees"]]
        obj._packed = PackedEnsemble(obj.trees_)
        return obj
