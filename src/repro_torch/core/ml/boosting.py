"""Boosted tree family: XGBoost-style GBT, AdaBoost.R2, LightGBM-style
histogram GBT (paper Table I tree-based models)."""

from __future__ import annotations

import heapq
from typing import Any

import numpy as np

from repro_torch.core.ml.tree import (
    DecisionTreeRegressor,
    PackedEnsemble,
    TreeArrays,
    build_tree,
    tree_predict,
)

__all__ = [
    "XGBRegressor", "AdaBoostR2Regressor", "HistGradientBoostingRegressor",
]


class XGBRegressor:
    """Second-order gradient boosting with L2 leaf regularisation.

    Squared loss: g_i = pred_i - y_i, h_i = 1 (Chen & Guestrin 2016).
    Supports shrinkage (eta), row subsampling and column subsampling —
    the knobs the paper tunes via CV.
    """

    def __init__(self, n_estimators: int = 200, max_depth: int = 5,
                 learning_rate: float = 0.1, reg_lambda: float = 1.0,
                 gamma: float = 0.0, subsample: float = 1.0,
                 colsample: float = 1.0, min_child_weight: float = 1.0,
                 seed: int = 0) -> None:
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.gamma = gamma
        self.subsample = subsample
        self.colsample = colsample
        self.min_child_weight = min_child_weight
        self.seed = seed
        self.base_: float = 0.0
        self.trees_: list[TreeArrays] = []
        self._packed: PackedEnsemble | None = None

    def get_params(self) -> dict[str, Any]:
        return {"n_estimators": self.n_estimators, "max_depth": self.max_depth,
                "learning_rate": self.learning_rate,
                "reg_lambda": self.reg_lambda, "gamma": self.gamma,
                "subsample": self.subsample, "colsample": self.colsample,
                "min_child_weight": self.min_child_weight, "seed": self.seed}

    def fit(self, X: np.ndarray, y: np.ndarray) -> "XGBRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n, n_feat = X.shape
        rng = np.random.default_rng(self.seed)
        self.base_ = float(y.mean())
        pred = np.full(n, self.base_)
        self.trees_ = []
        mf = max(1, int(round(self.colsample * n_feat)))
        for _ in range(self.n_estimators):
            g = pred - y
            h = np.ones(n)
            if self.subsample < 1.0:
                idx = rng.choice(n, size=max(2, int(self.subsample * n)),
                                 replace=False)
            else:
                idx = np.arange(n)
            tree = build_tree(
                X[idx], g[idx], h[idx], max_depth=self.max_depth,
                lam=self.reg_lambda, gamma=self.gamma,
                min_child_weight=self.min_child_weight,
                max_features=mf if mf < n_feat else None, rng=rng)
            pred += self.learning_rate * tree_predict(tree, X)
            self.trees_.append(tree)
        self._packed = PackedEnsemble(self.trees_)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if not self.trees_:
            raise RuntimeError("not fitted")
        if self._packed is None:
            self._packed = PackedEnsemble(self.trees_)
        return self.base_ + self.learning_rate * self._packed.predict_sum(X)

    def to_dict(self) -> dict:
        return {"kind": "XGBRegressor", "params": self.get_params(),
                "base": self.base_,
                "trees": [t.to_dict() for t in self.trees_]}

    @classmethod
    def from_dict(cls, d: dict) -> "XGBRegressor":
        obj = cls(**d["params"])
        obj.base_ = float(d["base"])
        obj.trees_ = [TreeArrays.from_dict(t) for t in d["trees"]]
        obj._packed = PackedEnsemble(obj.trees_)
        return obj


class AdaBoostR2Regressor:
    """AdaBoost.R2 (Drucker 1997) with CART weak learners and the
    weighted-median combination rule."""

    def __init__(self, n_estimators: int = 50, max_depth: int = 4,
                 learning_rate: float = 1.0, seed: int = 0) -> None:
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.seed = seed
        self.estimators_: list[DecisionTreeRegressor] = []
        self.betas_: list[float] = []
        self._packed: PackedEnsemble | None = None

    def get_params(self) -> dict[str, Any]:
        return {"n_estimators": self.n_estimators, "max_depth": self.max_depth,
                "learning_rate": self.learning_rate, "seed": self.seed}

    def fit(self, X: np.ndarray, y: np.ndarray) -> "AdaBoostR2Regressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = X.shape[0]
        rng = np.random.default_rng(self.seed)
        w = np.full(n, 1.0 / n)
        self.estimators_, self.betas_ = [], []
        for _ in range(self.n_estimators):
            # resample according to weights (classic R2 formulation)
            idx = rng.choice(n, size=n, replace=True, p=w)
            est = DecisionTreeRegressor(max_depth=self.max_depth)
            est.fit(X[idx], y[idx])
            pred = est.predict(X)
            err = np.abs(pred - y)
            emax = err.max()
            if emax <= 0:
                self.estimators_.append(est)
                self.betas_.append(1e-10)
                break
            loss = err / emax                      # linear loss
            ebar = float(np.sum(w * loss))
            if ebar >= 0.5:
                if not self.estimators_:           # keep at least one
                    self.estimators_.append(est)
                    self.betas_.append(1.0)
                break
            beta = ebar / (1.0 - ebar)
            self.estimators_.append(est)
            self.betas_.append(beta)
            w = w * np.power(beta, self.learning_rate * (1.0 - loss))
            w /= w.sum()
        self._packed = PackedEnsemble([e.tree_ for e in self.estimators_])
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if not self.estimators_:
            raise RuntimeError("not fitted")
        if self._packed is None:
            self._packed = PackedEnsemble([e.tree_ for e in self.estimators_])
        preds = self._packed.predict_all(X)
        logw = np.log(1.0 / np.maximum(np.asarray(self.betas_), 1e-12))
        order = np.argsort(preds, axis=1)
        sorted_preds = np.take_along_axis(preds, order, axis=1)
        cum = np.cumsum(logw[order], axis=1)
        target = 0.5 * cum[:, -1:]
        pick = np.argmax(cum >= target, axis=1)
        return sorted_preds[np.arange(len(pick)), pick]

    def to_dict(self) -> dict:
        return {"kind": "AdaBoostR2Regressor", "params": self.get_params(),
                "betas": list(map(float, self.betas_)),
                "estimators": [e.to_dict() for e in self.estimators_]}

    @classmethod
    def from_dict(cls, d: dict) -> "AdaBoostR2Regressor":
        obj = cls(**d["params"])
        obj.betas_ = list(d["betas"])
        obj.estimators_ = [DecisionTreeRegressor.from_dict(e)
                           for e in d["estimators"]]
        obj._packed = PackedEnsemble([e.tree_ for e in obj.estimators_])
        return obj


class HistGradientBoostingRegressor:
    """LightGBM-style GBT: quantile-binned features + leaf-wise growth.

    Features are pre-binned into ``max_bins`` quantile buckets; each
    boosting round grows a tree *best-first* (largest-gain leaf expanded
    next, up to ``max_leaves``), with split search over histogram bins —
    the two ideas that distinguish LightGBM from depth-wise XGBoost.
    """

    def __init__(self, n_estimators: int = 200, max_leaves: int = 31,
                 learning_rate: float = 0.1, reg_lambda: float = 1.0,
                 max_bins: int = 64, min_samples_leaf: int = 5,
                 seed: int = 0) -> None:
        self.n_estimators = n_estimators
        self.max_leaves = max_leaves
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.max_bins = max_bins
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        self.base_: float = 0.0
        self.trees_: list[TreeArrays] = []
        self.bin_edges_: list[np.ndarray] = []
        self._packed: PackedEnsemble | None = None

    def get_params(self) -> dict[str, Any]:
        return {"n_estimators": self.n_estimators,
                "max_leaves": self.max_leaves,
                "learning_rate": self.learning_rate,
                "reg_lambda": self.reg_lambda, "max_bins": self.max_bins,
                "min_samples_leaf": self.min_samples_leaf, "seed": self.seed}

    # -- binning -----------------------------------------------------------
    def _fit_bins(self, X: np.ndarray) -> np.ndarray:
        self.bin_edges_ = []
        binned = np.empty(X.shape, dtype=np.int16)
        for j in range(X.shape[1]):
            qs = np.quantile(X[:, j],
                             np.linspace(0, 1, self.max_bins + 1)[1:-1])
            edges = np.unique(qs)
            self.bin_edges_.append(edges)
            binned[:, j] = np.searchsorted(edges, X[:, j]).astype(np.int16)
        return binned

    def _grow_tree(self, binned: np.ndarray, g: np.ndarray, h: np.ndarray
                   ) -> TreeArrays:
        lam = self.reg_lambda
        feature: list[int] = []
        threshold: list[float] = []
        left: list[int] = []
        right: list[int] = []
        value: list[float] = []

        def new_node(gs: float, hs: float) -> int:
            feature.append(-1)
            threshold.append(0.0)
            left.append(-1)
            right.append(-1)
            value.append(-gs / (hs + lam))
            return len(feature) - 1

        def best_split(idx: np.ndarray):
            gs, hs = g[idx].sum(), h[idx].sum()
            parent = gs * gs / (hs + lam)
            best = (0.0, -1, -1)  # gain, feat, bin
            for j in range(binned.shape[1]):
                nb = len(self.bin_edges_[j]) + 1
                if nb < 2:
                    continue
                b = binned[idx, j]
                gh = np.zeros(nb)
                hh = np.zeros(nb)
                ch = np.zeros(nb)
                np.add.at(gh, b, g[idx])
                np.add.at(hh, b, h[idx])
                np.add.at(ch, b, 1.0)
                gl = np.cumsum(gh)[:-1]
                hl = np.cumsum(hh)[:-1]
                cl = np.cumsum(ch)[:-1]
                gr, hr, cr = gs - gl, hs - hl, len(idx) - cl
                ok = (cl >= self.min_samples_leaf) & (cr >= self.min_samples_leaf)
                if not ok.any():
                    continue
                gain = np.where(
                    ok, gl * gl / (hl + lam) + gr * gr / (hr + lam) - parent,
                    -np.inf)
                i = int(np.argmax(gain))
                if gain[i] > best[0]:
                    best = (float(gain[i]), j, i)
            return best

        # best-first growth
        all_idx = np.arange(binned.shape[0])
        root = new_node(g.sum(), h.sum())
        heap: list[tuple[float, int, int, Any]] = []
        gain, feat, b = best_split(all_idx)
        counter = 0
        if feat >= 0:
            heapq.heappush(heap, (-gain, counter, root, (all_idx, feat, b)))
        n_leaves = 1
        while heap and n_leaves < self.max_leaves:
            _, _, node, (idx, feat, b) = heapq.heappop(heap)
            mask = binned[idx, feat] <= b
            li, ri = idx[mask], idx[~mask]
            feature[node] = feat
            edges = self.bin_edges_[feat]
            threshold[node] = float(edges[min(b, len(edges) - 1)])
            ln = new_node(g[li].sum(), h[li].sum())
            rn = new_node(g[ri].sum(), h[ri].sum())
            left[node], right[node] = ln, rn
            n_leaves += 1
            for child, cidx in ((ln, li), (rn, ri)):
                if len(cidx) >= 2 * self.min_samples_leaf:
                    cg, cf, cb = best_split(cidx)
                    if cf >= 0:
                        counter += 1
                        heapq.heappush(heap, (-cg, counter, child,
                                              (cidx, cf, cb)))
        return TreeArrays(
            feature=np.asarray(feature, dtype=np.int32),
            threshold=np.asarray(threshold, dtype=np.float64),
            left=np.asarray(left, dtype=np.int32),
            right=np.asarray(right, dtype=np.int32),
            value=np.asarray(value, dtype=np.float64))

    def fit(self, X: np.ndarray, y: np.ndarray
            ) -> "HistGradientBoostingRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        binned = self._fit_bins(X)
        self.base_ = float(y.mean())
        pred = np.full(len(y), self.base_)
        self.trees_ = []
        for _ in range(self.n_estimators):
            g = pred - y
            h = np.ones(len(y))
            tree = self._grow_tree(binned, g, h)
            pred += self.learning_rate * tree_predict(tree, X)
            self.trees_.append(tree)
        self._packed = PackedEnsemble(self.trees_)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if not self.trees_:
            raise RuntimeError("not fitted")
        if self._packed is None:
            self._packed = PackedEnsemble(self.trees_)
        return self.base_ + self.learning_rate * self._packed.predict_sum(X)

    def to_dict(self) -> dict:
        return {"kind": "HistGradientBoostingRegressor",
                "params": self.get_params(), "base": self.base_,
                "bin_edges": [e.tolist() for e in self.bin_edges_],
                "trees": [t.to_dict() for t in self.trees_]}

    @classmethod
    def from_dict(cls, d: dict) -> "HistGradientBoostingRegressor":
        obj = cls(**d["params"])
        obj.base_ = float(d["base"])
        obj.bin_edges_ = [np.asarray(e) for e in d["bin_edges"]]
        obj.trees_ = [TreeArrays.from_dict(t) for t in d["trees"]]
        obj._packed = PackedEnsemble(obj.trees_)
        return obj
