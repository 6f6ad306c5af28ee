"""The classical estimators the baselines use, without sklearn.

Each keeps sklearn 1.9's defaults for the arguments
``flexynesis_tpu/utils/baselines.py`` passes:

* ``model_selection``: ``KFold`` (sklearn's folds, index for index),
  ``ParameterGrid`` and ``GridSearchCV`` (mean fold score, first of the
  best rank, refit);
* ``pca``: ``PCA`` (centred SVD, sklearn's sign convention);
* ``tree`` and ``ensemble``: CART trees grown level by level in torch on
  the caller's device (gini or squared error, float32 thresholds at
  midpoints), ``RandomForestClassifier``/``Regressor`` and
  ``GradientBoostingClassifier``/``Regressor``;
* ``svm``: ``SVC(probability=True)`` and ``SVR``: the kernel matrix in torch
  on the caller's device, the SMO solver and Platt scaling on the host.
"""

from .ensemble import (
    GradientBoostingClassifier,
    GradientBoostingRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from .model_selection import GridSearchCV, KFold, ParameterGrid
from .pca import PCA
from .svm import SVC, SVR

__all__ = ["GradientBoostingClassifier", "GradientBoostingRegressor", "GridSearchCV",
           "KFold", "PCA", "ParameterGrid", "RandomForestClassifier",
           "RandomForestRegressor", "SVC", "SVR"]
