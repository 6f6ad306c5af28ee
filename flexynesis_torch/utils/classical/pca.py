"""``PCA(n_components)`` as sklearn 1.9's ``"full"`` solver computes it (its
``"auto"`` choice below 500 x 500): the centred data's SVD (LAPACK gesdd
through scipy, in the input's float dtype, on the host), signs flipped so
the largest-magnitude entry of each component is positive."""

from __future__ import annotations

import numpy as np
from scipy import linalg


class PCA:
    def __init__(self, n_components: int):
        self.n_components = n_components

    def fit(self, X):
        X = np.asarray(X)
        X = X if X.dtype in (np.float32, np.float64) else X.astype(np.float64)
        limit = min(X.shape)
        if not 0 <= self.n_components <= limit:
            raise ValueError(f"n_components={self.n_components} must be between 0 and "
                             f"min(n_samples, n_features)={limit} with svd_solver='full'")
        self.mean_ = np.mean(X, axis=0)
        _, _, vt = linalg.svd(X - self.mean_, full_matrices=False)
        signs = np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])
        self.components_ = (vt * signs[:, None])[: self.n_components]
        return self

    def transform(self, X):
        X = np.asarray(X, dtype=self.components_.dtype)
        return X @ self.components_.T - self.mean_.reshape(1, -1) @ self.components_.T
