"""Model registry: names <-> constructors <-> default CV grids <-> persistence.

The names mirror the rows of the paper's Tables III/IV.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.ml.boosting import (
    AdaBoostR2Regressor,
    HistGradientBoostingRegressor,
    XGBRegressor,
)
from repro_torch.core.ml.forest import RandomForestRegressor
from repro_torch.core.ml.knn import KNNRegressor
from repro_torch.core.ml.linear import (
    BayesianRidgeRegression,
    ElasticNetRegression,
    LinearRegression,
    RidgeRegression,
)
from repro_torch.core.ml.tree import DecisionTreeRegressor

__all__ = ["MODEL_REGISTRY", "default_param_grids", "make_model",
           "model_from_dict"]

MODEL_REGISTRY: dict[str, Callable[..., Any]] = {
    "linear_regression": LinearRegression,
    "ridge": RidgeRegression,
    "elasticnet": ElasticNetRegression,
    "bayesian_regression": BayesianRidgeRegression,
    "decision_tree": DecisionTreeRegressor,
    "random_forest": RandomForestRegressor,
    "adaboost": AdaBoostR2Regressor,
    "xgboost": XGBRegressor,
    "lightgbm": HistGradientBoostingRegressor,
    "knn": KNNRegressor,
}

_KIND_TO_CLS = {
    "LinearRegression": LinearRegression,
    "RidgeRegression": RidgeRegression,
    "ElasticNetRegression": ElasticNetRegression,
    "BayesianRidgeRegression": BayesianRidgeRegression,
    "DecisionTreeRegressor": DecisionTreeRegressor,
    "RandomForestRegressor": RandomForestRegressor,
    "AdaBoostR2Regressor": AdaBoostR2Regressor,
    "XGBRegressor": XGBRegressor,
    "HistGradientBoostingRegressor": HistGradientBoostingRegressor,
    "KNNRegressor": KNNRegressor,
}


def make_model(name: str, **params: Any) -> Any:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {list(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**params)


def model_from_dict(d: dict) -> Any:
    cls = _KIND_TO_CLS[d["kind"]]
    return cls.from_dict(d)


def default_param_grids(budget: str = "small") -> dict[str, dict[str, list]]:
    """CV grids per model.  'small' keeps install-time tuning tractable on
    one CPU core; 'full' matches a production install."""
    if budget == "small":
        return {
            "linear_regression": {},
            "elasticnet": {"alpha": [0.001, 0.1], "l1_ratio": [0.2, 0.8]},
            "bayesian_regression": {},
            "decision_tree": {"max_depth": [4, 8], "min_samples_leaf": [2, 8]},
            "random_forest": {"n_estimators": [30], "max_depth": [8, 12]},
            "adaboost": {"n_estimators": [20], "max_depth": [4]},
            "xgboost": {"n_estimators": [100], "max_depth": [4, 6],
                        "learning_rate": [0.1]},
            "lightgbm": {"n_estimators": [100], "max_leaves": [15, 31]},
            "knn": {"k": [3, 7]},
        }
    return {
        "linear_regression": {},
        "elasticnet": {"alpha": [1e-4, 1e-3, 1e-2, 0.1, 1.0],
                       "l1_ratio": [0.1, 0.5, 0.9]},
        "bayesian_regression": {},
        "decision_tree": {"max_depth": [4, 6, 8, 12],
                          "min_samples_leaf": [1, 2, 4, 8]},
        "random_forest": {"n_estimators": [50, 100, 200],
                          "max_depth": [8, 12, 16],
                          "max_features": [0.3, 0.5, 0.8]},
        "adaboost": {"n_estimators": [25, 50, 100], "max_depth": [3, 4, 6],
                     "learning_rate": [0.5, 1.0]},
        "xgboost": {"n_estimators": [100, 200, 400],
                    "max_depth": [4, 5, 6, 8],
                    "learning_rate": [0.05, 0.1, 0.2],
                    "reg_lambda": [0.5, 1.0, 2.0],
                    "subsample": [0.8, 1.0]},
        "lightgbm": {"n_estimators": [100, 200, 400],
                     "max_leaves": [15, 31, 63],
                     "learning_rate": [0.05, 0.1, 0.2]},
        "knn": {"k": [3, 5, 7, 11], "weights": ["distance", "uniform"]},
    }
