"""CART regression trees on a shared gradient/hessian split engine.

One vectorised builder serves the whole tree family of the paper's
Table I:

* CART / Random-Forest trees: squared loss on (optionally weighted)
  targets is the special case g = -w*y, h = w, λ = 0 — the leaf value
  becomes the weighted mean and the split gain the weighted variance
  reduction.
* XGBoost-style boosting passes true (g, h) with L2 regularisation λ and
  min-split-gain γ (Chen & Guestrin 2016, eq. 7).

Trees are stored as flat arrays (feature / threshold / children / value)
so runtime prediction — the latency the paper's model-selection criterion
charges against each model — is a handful of vectorised numpy gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["TreeArrays", "build_tree", "tree_predict", "tree_predict_row",
           "PackedEnsemble", "DecisionTreeRegressor"]


@dataclasses.dataclass
class TreeArrays:
    feature: np.ndarray    # int32, -1 for leaves
    threshold: np.ndarray  # float64
    left: np.ndarray       # int32
    right: np.ndarray      # int32
    value: np.ndarray      # float64 (leaf prediction; internal nodes too)

    @property
    def n_nodes(self) -> int:
        return len(self.feature)

    def to_dict(self) -> dict:
        return {
            "feature": self.feature.tolist(),
            "threshold": self.threshold.tolist(),
            "left": self.left.tolist(),
            "right": self.right.tolist(),
            "value": self.value.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TreeArrays":
        return cls(
            feature=np.asarray(d["feature"], dtype=np.int32),
            threshold=np.asarray(d["threshold"], dtype=np.float64),
            left=np.asarray(d["left"], dtype=np.int32),
            right=np.asarray(d["right"], dtype=np.int32),
            value=np.asarray(d["value"], dtype=np.float64),
        )


def _tree_depth(tree: TreeArrays) -> int:
    """Depth of a TreeArrays (root = depth 0)."""
    best = 0
    stack = [(0, 0)]
    while stack:
        node, d = stack.pop()
        best = max(best, d)
        if tree.feature[node] >= 0:
            stack.append((int(tree.left[node]), d + 1))
            stack.append((int(tree.right[node]), d + 1))
    return best


def _leaf_value(g_sum: float, h_sum: float, lam: float) -> float:
    return -g_sum / (h_sum + lam) if (h_sum + lam) > 0 else 0.0


def _best_split(X: np.ndarray, g: np.ndarray, h: np.ndarray, *,
                lam: float, min_child_weight: float,
                min_samples_leaf: int,
                feature_subset: np.ndarray | None = None
                ) -> tuple[float, int, float]:
    """Best (gain, feature, threshold) over all features via prefix sums."""
    n, n_feat = X.shape
    G, H = g.sum(), h.sum()
    parent_score = G * G / (H + lam)
    best_gain, best_feat, best_thr = 0.0, -1, 0.0
    feats = feature_subset if feature_subset is not None else range(n_feat)
    for j in feats:
        order = np.argsort(X[:, j], kind="stable")
        xs = X[order, j]
        gl = np.cumsum(g[order])[:-1]
        hl = np.cumsum(h[order])[:-1]
        gr = G - gl
        hr = H - hl
        # valid split positions: value actually changes + leaf constraints
        valid = xs[1:] > xs[:-1]
        pos = np.arange(1, n)
        valid &= (pos >= min_samples_leaf) & (n - pos >= min_samples_leaf)
        valid &= (hl >= min_child_weight) & (hr >= min_child_weight)
        if not valid.any():
            continue
        gain = gl * gl / (hl + lam) + gr * gr / (hr + lam) - parent_score
        gain = np.where(valid, gain, -np.inf)
        i = int(np.argmax(gain))
        if gain[i] > best_gain:
            best_gain = float(gain[i])
            best_feat = int(j)
            best_thr = 0.5 * (xs[i] + xs[i + 1])
    return best_gain, best_feat, best_thr


def build_tree(X: np.ndarray, g: np.ndarray, h: np.ndarray, *,
               max_depth: int = 6, lam: float = 0.0, gamma: float = 0.0,
               min_samples_leaf: int = 1, min_child_weight: float = 0.0,
               max_features: int | None = None,
               rng: np.random.Generator | None = None) -> TreeArrays:
    """Depth-first greedy tree construction on (g, h)."""
    X = np.asarray(X, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    n_feat = X.shape[1]

    feature: list[int] = []
    threshold: list[float] = []
    left: list[int] = []
    right: list[int] = []
    value: list[float] = []

    def new_node() -> int:
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(0.0)
        return len(feature) - 1

    def grow(idx: np.ndarray, depth: int) -> int:
        node = new_node()
        gs, hs = g[idx].sum(), h[idx].sum()
        value[node] = _leaf_value(gs, hs, lam)
        if depth >= max_depth or len(idx) < 2 * min_samples_leaf:
            return node
        subset = None
        if max_features is not None and max_features < n_feat:
            r = rng if rng is not None else np.random.default_rng(0)
            subset = r.choice(n_feat, size=max_features, replace=False)
        gain, feat, thr = _best_split(
            X[idx], g[idx], h[idx], lam=lam,
            min_child_weight=min_child_weight,
            min_samples_leaf=min_samples_leaf, feature_subset=subset)
        if feat < 0 or 0.5 * gain <= gamma:
            return node
        mask = X[idx, feat] <= thr
        feature[node] = feat
        threshold[node] = thr
        left[node] = grow(idx[mask], depth + 1)
        right[node] = grow(idx[~mask], depth + 1)
        return node

    grow(np.arange(X.shape[0]), 0)
    return TreeArrays(
        feature=np.asarray(feature, dtype=np.int32),
        threshold=np.asarray(threshold, dtype=np.float64),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        value=np.asarray(value, dtype=np.float64),
    )


class PackedEnsemble:
    """All trees of an ensemble packed into one node table for inference.

    Prediction descends every (sample, tree) pair simultaneously with
    vectorised gathers — ``max_depth`` iterations instead of a Python
    loop over trees.  This is the runtime path whose latency the paper's
    model-selection criterion (t_eval) charges; a per-tree Python loop
    would mis-measure tree ensembles by ~100x versus their compiled
    counterparts (XGBoost C++), inverting the paper's selection outcome.
    """

    def __init__(self, trees: list[TreeArrays]) -> None:
        offsets = np.cumsum([0] + [t.n_nodes for t in trees[:-1]])
        self.roots = np.asarray(offsets, dtype=np.intp)
        self.n_trees = len(trees)
        feature = np.concatenate([t.feature for t in trees]).astype(np.intp)
        threshold = np.concatenate([t.threshold for t in trees])
        self.value = np.concatenate([t.value for t in trees])
        left = np.concatenate(
            [t.left + o for t, o in zip(trees, offsets)]).astype(np.intp)
        right = np.concatenate(
            [t.right + o for t, o in zip(trees, offsets)]).astype(np.intp)
        # self-looping leaves: feature 0, threshold +inf, children = self —
        # a lane that lands on a leaf stays put if it is ever walked again.
        leaf = feature < 0
        self_idx = np.arange(len(feature), dtype=np.intp)
        self.interior = ~leaf
        self.feature = np.where(leaf, 0, feature)
        self.threshold = np.where(leaf, np.inf, threshold)
        self.left = np.where(leaf, self_idx, left)
        self.right = np.where(leaf, self_idx, right)
        depths = [_tree_depth(t) for t in trees]
        self.min_depth = min(depths)
        self.max_depth = max(depths)

    def predict_all(self, X: np.ndarray) -> np.ndarray:
        """Per-tree predictions, shape (n_samples, n_trees).

        Flat ``take``-based descent: every (sample, tree) pair is one
        lane walking one level per iteration with 4 gathers + 1 compare.
        The first ``min_depth`` levels run mask-free over all n*T lanes
        — exact even when a lane hits a shallow leaf early, because
        leaves self-loop.  Past ``min_depth`` (where whole trees start
        finishing) lanes sitting on a leaf are retired from the working
        set, so the deep tail levels (set by the single deepest tree)
        touch a shrinking fraction of the lanes.  Balanced ensembles
        keep the mask-free walk end-to-end; mixed-depth ones (AdaBoost
        stumps next to full CARTs, leaf-wise LightGBM trees) skip most
        of the tail work.
        """
        X = np.ascontiguousarray(X, dtype=np.float64)
        n, f_dim = X.shape
        T = len(self.roots)
        node = np.tile(self.roots, n)                       # (n*T,) flat
        row_off = np.repeat(np.arange(n, dtype=np.intp) * f_dim, T)
        x_flat = X.ravel()
        for _ in range(self.min_depth):
            f = self.feature.take(node)
            fv = x_flat.take(row_off + f)
            go_left = fv <= self.threshold.take(node)
            node = np.where(go_left, self.left.take(node),
                            self.right.take(node))
        lanes = np.flatnonzero(self.interior.take(node))
        for _ in range(self.max_depth - self.min_depth):
            if not lanes.size:
                break
            at = node.take(lanes)
            f = self.feature.take(at)
            fv = x_flat.take(row_off.take(lanes) + f)
            go_left = fv <= self.threshold.take(at)
            at = np.where(go_left, self.left.take(at), self.right.take(at))
            node[lanes] = at
            lanes = lanes[self.interior.take(at)]
        return self.value.take(node).reshape(n, T)

    def predict_sum(self, X: np.ndarray) -> np.ndarray:
        return self.predict_all(X).sum(axis=1)

    def predict_mean(self, X: np.ndarray) -> np.ndarray:
        return self.predict_all(X).mean(axis=1)


def tree_predict(tree: TreeArrays, X: np.ndarray) -> np.ndarray:
    """Vectorised iterative descent of all samples through one tree."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    node = np.zeros(n, dtype=np.int32)
    active = tree.feature[node] >= 0
    while active.any():
        f = tree.feature[node[active]]
        thr = tree.threshold[node[active]]
        go_left = X[active, f] <= thr
        nxt = np.where(go_left, tree.left[node[active]],
                       tree.right[node[active]])
        node[active] = nxt
        active = tree.feature[node] >= 0
    return tree.value[node]


def tree_predict_row(tree: TreeArrays, x: np.ndarray) -> float:
    """Scalar one-row descent — the reference the vectorised walkers
    (``tree_predict``, ``PackedEnsemble.predict_all``) are parity-tested
    against."""
    node = 0
    while tree.feature[node] >= 0:
        if x[tree.feature[node]] <= tree.threshold[node]:
            node = int(tree.left[node])
        else:
            node = int(tree.right[node])
    return float(tree.value[node])


class DecisionTreeRegressor:
    """CART regressor (paper Table I 'Decision Tree')."""

    def __init__(self, max_depth: int = 6, min_samples_leaf: int = 1) -> None:
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.tree_: TreeArrays | None = None

    def get_params(self) -> dict[str, Any]:
        return {"max_depth": self.max_depth,
                "min_samples_leaf": self.min_samples_leaf}

    def fit(self, X: np.ndarray, y: np.ndarray,
            sample_weight: np.ndarray | None = None
            ) -> "DecisionTreeRegressor":
        y = np.asarray(y, dtype=np.float64)
        w = (np.ones_like(y) if sample_weight is None
             else np.asarray(sample_weight, dtype=np.float64))
        # squared loss from pred=0: g = -w*y, h = w  → leaf = weighted mean
        self.tree_ = build_tree(
            X, -w * y, w, max_depth=self.max_depth,
            min_samples_leaf=self.min_samples_leaf)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.tree_ is None:
            raise RuntimeError("not fitted")
        return tree_predict(self.tree_, X)

    def to_dict(self) -> dict:
        return {"kind": "DecisionTreeRegressor", "params": self.get_params(),
                "tree": self.tree_.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "DecisionTreeRegressor":
        obj = cls(**d["params"])
        obj.tree_ = TreeArrays.from_dict(d["tree"])
        return obj
