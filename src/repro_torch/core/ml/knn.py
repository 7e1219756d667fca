"""k-nearest-neighbour regressor (paper Table I 'KNN Regressor').

Included so the model-selection benchmark can reproduce the paper's
finding that kNN's slow evaluation makes it unsuitable despite decent
accuracy.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["KNNRegressor"]


class KNNRegressor:
    def __init__(self, k: int = 5, weights: str = "distance") -> None:
        self.k = k
        self.weights = weights
        self.X_: np.ndarray | None = None
        self.y_: np.ndarray | None = None

    def get_params(self) -> dict[str, Any]:
        return {"k": self.k, "weights": self.weights}

    def fit(self, X: np.ndarray, y: np.ndarray) -> "KNNRegressor":
        self.X_ = np.asarray(X, dtype=np.float64)
        self.y_ = np.asarray(y, dtype=np.float64)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.X_ is None:
            raise RuntimeError("not fitted")
        X = np.asarray(X, dtype=np.float64)
        k = min(self.k, len(self.y_))
        sq_train = np.sum(self.X_ * self.X_, axis=1)
        out = np.empty(X.shape[0])
        for i in range(X.shape[0]):            # brute force — kNN is the
            d2 = sq_train - 2.0 * (self.X_ @ X[i]) + X[i] @ X[i]   # slow model
            nn = np.argpartition(d2, k - 1)[:k]
            if self.weights == "distance":
                w = 1.0 / (np.sqrt(np.maximum(d2[nn], 0.0)) + 1e-9)
                out[i] = float(np.sum(w * self.y_[nn]) / np.sum(w))
            else:
                out[i] = float(self.y_[nn].mean())
        return out

    def to_dict(self) -> dict:
        return {"kind": "KNNRegressor", "params": self.get_params(),
                "X": self.X_.tolist(), "y": self.y_.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "KNNRegressor":
        obj = cls(**d["params"])
        obj.X_ = np.asarray(d["X"])
        obj.y_ = np.asarray(d["y"])
        return obj
