"""Linear model family: OLS, ridge, ElasticNet (coordinate descent),
Bayesian ridge (evidence maximisation).  Paper Table I "Linear Models"."""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = [
    "LinearRegression", "RidgeRegression", "ElasticNetRegression",
    "BayesianRidgeRegression",
]


class _LinearBase:
    coef_: np.ndarray
    intercept_: float

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, dtype=np.float64) @ self.coef_ + self.intercept_

    def to_dict(self) -> dict:
        return {
            "kind": type(self).__name__,
            "params": self.get_params(),
            "coef": self.coef_.tolist(),
            "intercept": float(self.intercept_),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "_LinearBase":
        obj = cls(**d["params"])
        obj.coef_ = np.asarray(d["coef"], dtype=np.float64)
        obj.intercept_ = float(d["intercept"])
        return obj


class LinearRegression(_LinearBase):
    """Ordinary least squares via lstsq."""

    def __init__(self) -> None:
        pass

    def get_params(self) -> dict[str, Any]:
        return {}

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LinearRegression":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        Xa = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        w, *_ = np.linalg.lstsq(Xa, y, rcond=None)
        self.coef_, self.intercept_ = w[:-1], float(w[-1])
        return self


class RidgeRegression(_LinearBase):
    def __init__(self, alpha: float = 1.0) -> None:
        self.alpha = alpha

    def get_params(self) -> dict[str, Any]:
        return {"alpha": self.alpha}

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RidgeRegression":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        mu, ym = X.mean(axis=0), y.mean()
        Xc, yc = X - mu, y - ym
        f = X.shape[1]
        A = Xc.T @ Xc + self.alpha * np.eye(f)
        self.coef_ = np.linalg.solve(A, Xc.T @ yc)
        self.intercept_ = float(ym - mu @ self.coef_)
        return self


class ElasticNetRegression(_LinearBase):
    """ElasticNet by cyclic coordinate descent with soft thresholding."""

    def __init__(self, alpha: float = 1.0, l1_ratio: float = 0.5,
                 max_iter: int = 500, tol: float = 1e-6) -> None:
        self.alpha = alpha
        self.l1_ratio = l1_ratio
        self.max_iter = max_iter
        self.tol = tol

    def get_params(self) -> dict[str, Any]:
        return {"alpha": self.alpha, "l1_ratio": self.l1_ratio,
                "max_iter": self.max_iter, "tol": self.tol}

    def fit(self, X: np.ndarray, y: np.ndarray) -> "ElasticNetRegression":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n, f = X.shape
        mu, ym = X.mean(axis=0), y.mean()
        Xc, yc = X - mu, y - ym
        l1 = self.alpha * self.l1_ratio * n
        l2 = self.alpha * (1.0 - self.l1_ratio) * n
        col_sq = np.sum(Xc * Xc, axis=0) + l2
        w = np.zeros(f)
        resid = yc.copy()
        for _ in range(self.max_iter):
            w_max = 0.0
            delta_max = 0.0
            for j in range(f):
                if col_sq[j] <= l2 + 1e-30:  # constant column
                    continue
                rho = Xc[:, j] @ resid + w[j] * (col_sq[j] - l2)
                new_w = np.sign(rho) * max(abs(rho) - l1, 0.0) / col_sq[j]
                if new_w != w[j]:
                    resid -= (new_w - w[j]) * Xc[:, j]
                    delta_max = max(delta_max, abs(new_w - w[j]))
                    w[j] = new_w
                w_max = max(w_max, abs(w[j]))
            if delta_max <= self.tol * max(w_max, 1e-12):
                break
        self.coef_ = w
        self.intercept_ = float(ym - mu @ w)
        return self


class BayesianRidgeRegression(_LinearBase):
    """Bayesian ridge via evidence (type-II ML) iteration.

    Hyper-priors on weight precision α and noise precision β are updated
    with the MacKay fixed-point rules on the eigen-decomposition of XᵀX.
    """

    def __init__(self, max_iter: int = 300, tol: float = 1e-4) -> None:
        self.max_iter = max_iter
        self.tol = tol
        self.alpha_: float = 1.0
        self.beta_: float = 1.0

    def get_params(self) -> dict[str, Any]:
        return {"max_iter": self.max_iter, "tol": self.tol}

    def fit(self, X: np.ndarray, y: np.ndarray) -> "BayesianRidgeRegression":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n, f = X.shape
        mu, ym = X.mean(axis=0), y.mean()
        Xc, yc = X - mu, y - ym
        G = Xc.T @ Xc
        eigvals, eigvecs = np.linalg.eigh(G)
        eigvals = np.maximum(eigvals, 0.0)
        Xty = Xc.T @ yc
        alpha, beta = 1.0, 1.0 / max(np.var(yc), 1e-12)
        w = np.zeros(f)
        for _ in range(self.max_iter):
            # posterior mean in the eigenbasis
            denom = alpha + beta * eigvals
            w_new = eigvecs @ ((beta * (eigvecs.T @ Xty)) / denom)
            gamma = float(np.sum(beta * eigvals / denom))
            resid = yc - Xc @ w_new
            sse = float(resid @ resid)
            alpha_new = gamma / max(float(w_new @ w_new), 1e-12)
            beta_new = max(n - gamma, 1e-12) / max(sse, 1e-12)
            done = (abs(alpha_new - alpha) <= self.tol * alpha
                    and abs(beta_new - beta) <= self.tol * beta)
            alpha, beta, w = alpha_new, beta_new, w_new
            if done:
                break
        self.alpha_, self.beta_ = alpha, beta
        self.coef_ = w
        self.intercept_ = float(ym - mu @ w)
        return self
