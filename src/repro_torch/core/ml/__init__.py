"""Pure-numpy ML model zoo for ADSALA (paper §II-B / Table I).

The container ships no sklearn/xgboost, so every candidate model from the
paper's comparison — linear family, tree family, kNN — is implemented
here from scratch, with a common ``fit``/``predict`` interface, flat-array
tree inference (the runtime evaluation path whose latency the paper's
model selection criterion penalises), and persistence to plain dicts.
"""

from repro_torch.core.ml.base import (
    KFold,
    Regressor,
    grid_search,
    rmse,
    stratified_train_test_split,
)
from repro_torch.core.ml.linear import (
    BayesianRidgeRegression,
    ElasticNetRegression,
    LinearRegression,
    RidgeRegression,
)
from repro_torch.core.ml.tree import DecisionTreeRegressor
from repro_torch.core.ml.forest import RandomForestRegressor
from repro_torch.core.ml.boosting import (
    AdaBoostR2Regressor,
    HistGradientBoostingRegressor,
    XGBRegressor,
)
from repro_torch.core.ml.knn import KNNRegressor
from repro_torch.core.ml.registry import MODEL_REGISTRY, default_param_grids, make_model

__all__ = [
    "Regressor", "rmse", "stratified_train_test_split", "KFold",
    "grid_search",
    "LinearRegression", "RidgeRegression", "ElasticNetRegression",
    "BayesianRidgeRegression",
    "DecisionTreeRegressor", "RandomForestRegressor",
    "AdaBoostR2Regressor", "XGBRegressor", "HistGradientBoostingRegressor",
    "KNNRegressor",
    "MODEL_REGISTRY", "default_param_grids", "make_model",
]
