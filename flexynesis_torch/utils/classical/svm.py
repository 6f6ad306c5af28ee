"""``SVC(probability=True)`` and ``SVR`` as libsvm (sklearn 1.9) fits them.

The kernel matrix (``rbf``: exp(-gamma·|a-b|²), ``poly``: (gamma·a·b +
coef0)^degree; ``gamma="scale"`` = 1 / (n_features · X.var())) is computed
in float64 with torch on the estimator's device; the dual problems are
solved on the host by the port's C++ copy of libsvm's SMO solver
(``csrc/smo.cpp``, to ``tol``). SVC trains one-vs-one over the sorted
classes (class i of a pair is the positive side), predicts by votes (ties to
the first class), and fits each pair's Platt sigmoid on decision values of
an internal 5-fold split, then couples the pairwise probabilities (Wu, Lin
and Weng's method 2), as libsvm does; the 5-fold permutation comes from
``RandomState(random_state)``, not libsvm's generator. SVR is epsilon-SVR.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ...kernels import build
from ..device import resolve_device
from .model_selection import Estimator

MAX_ITER = 10_000_000


@functools.cache
def _solver():
    fn = build.load("smo").smo_solve
    dp = ctypes.POINTER(ctypes.c_double)
    fn.argtypes = [ctypes.c_long, dp, ctypes.c_long, ctypes.POINTER(ctypes.c_long), dp, dp, dp,
                   ctypes.c_double, ctypes.c_long, dp, dp]
    fn.restype = ctypes.c_long
    return fn


def solve(K: np.ndarray, idx, p, y, C, tol: float):
    """(alpha, rho) of min 0.5 a'Qa + p'a, y'a = 0, 0 <= a <= C, with
    Q_ij = y_i y_j K[idx_i, idx_j]."""
    K = np.ascontiguousarray(K, dtype=np.float64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    l = len(idx)
    p, y = (np.ascontiguousarray(a, dtype=np.float64) for a in (p, y))
    C = np.ascontiguousarray(np.broadcast_to(C, (l,)), dtype=np.float64)
    alpha, rho = np.zeros(l), np.zeros(1)
    dp = ctypes.POINTER(ctypes.c_double)
    iters = _solver()(l, K.ctypes.data_as(dp), K.shape[0],
                      idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), p.ctypes.data_as(dp),
                      y.ctypes.data_as(dp), C.ctypes.data_as(dp), tol, MAX_ITER,
                      alpha.ctypes.data_as(dp), rho.ctypes.data_as(dp))
    if iters < 0:
        print(f"[WARN] SMO stopped after {MAX_ITER} iterations")
    return alpha, float(rho[0])


def sigmoid_train(dec: np.ndarray, labels: np.ndarray):
    """Platt's (A, B) by libsvm's Newton method with backtracking."""
    prior1 = float(np.sum(labels > 0))
    prior0 = len(labels) - prior1
    hi, lo = (prior1 + 1.0) / (prior1 + 2.0), 1 / (prior0 + 2.0)
    t = np.where(labels > 0, hi, lo)

    def fval(A, B):
        f = dec * A + B
        return float(np.sum(np.where(f >= 0, t * f + np.log1p(np.exp(-np.abs(f))),
                                     (t - 1) * f + np.log1p(np.exp(-np.abs(f))))))

    A, B = 0.0, math.log((prior0 + 1.0) / (prior1 + 1.0))
    f0 = fval(A, B)
    for _ in range(100):
        f = dec * A + B
        e = np.exp(-np.abs(f))
        p = np.where(f >= 0, e / (1 + e), 1 / (1 + e))
        q = 1 - p
        d2 = p * q
        h11 = 1e-12 + float(np.sum(dec * dec * d2))
        h22 = 1e-12 + float(np.sum(d2))
        h21 = float(np.sum(dec * d2))
        d1 = t - p
        g1, g2 = float(np.sum(dec * d1)), float(np.sum(d1))
        if abs(g1) < 1e-5 and abs(g2) < 1e-5:
            break
        det = h11 * h22 - h21 * h21
        dA, dB = -(h22 * g1 - h21 * g2) / det, -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= 1e-10:
            newA, newB = A + step * dA, B + step * dB
            newf = fval(newA, newB)
            if newf < f0 + 0.0001 * step * gd:
                A, B, f0 = newA, newB, newf
                break
            step /= 2.0
        if step < 1e-10:
            break
    return A, B


def sigmoid_predict(dec, A: float, B: float):
    f = dec * A + B
    e = np.exp(-np.abs(f))
    return np.where(f >= 0, e / (1 + e), 1 / (1 + e))


def multiclass_probability(r: np.ndarray) -> np.ndarray:
    """libsvm's coupling of the pairwise probabilities r (k, k) of one sample."""
    k = r.shape[0]
    Q = -r.T * r
    np.fill_diagonal(Q, np.sum(r ** 2, axis=0) - np.diag(r) ** 2)
    p = np.full(k, 1.0 / k)
    eps = 0.005 / k
    for _ in range(max(100, k)):
        Qp = Q @ p
        pQp = p @ Qp
        if np.max(np.abs(Qp - pQp)) < eps:
            break
        for t in range(k):
            diff = (-Qp[t] + pQp) / Q[t, t]
            p[t] += diff
            pQp = (pQp + diff * (diff * Q[t, t] + 2 * Qp[t])) / (1 + diff) / (1 + diff)
            Qp = (Qp + diff * Q[t]) / (1 + diff)
            p /= 1 + diff
    return p


class _SVM(Estimator):
    DEFAULTS = dict(C=1.0, kernel="rbf", degree=3, gamma="scale", coef0=0.0, tol=1e-3,
                    device="auto")

    def __init__(self, **params):
        super().__init__(**{**self.DEFAULTS, **params})
        if self.params["kernel"] not in ("rbf", "poly"):
            raise ValueError(f"kernel {self.params['kernel']!r} is not supported (rbf, poly)")

    def _gram(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        dev = resolve_device(self.params["device"])
        a = torch.as_tensor(A, dtype=torch.float64, device=dev)
        b = torch.as_tensor(B, dtype=torch.float64, device=dev)
        dot = a @ b.t()
        if self.params["kernel"] == "rbf":
            sq = (a * a).sum(1, keepdim=True) + (b * b).sum(1).view(1, -1) - 2 * dot
            k = torch.exp(-self.gamma_ * sq)
        else:
            k = (self.gamma_ * dot + self.params["coef0"]) ** self.params["degree"]
        return k.cpu().numpy()

    def _setup(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        gamma = self.params["gamma"]
        if gamma == "scale":
            var = X.var()
            gamma = 1.0 / (X.shape[1] * var) if var != 0 else 1.0
        self.gamma_, self.X_ = float(gamma), X
        return self._gram(X, X)


class SVC(_SVM):
    classifier = True
    DEFAULTS = dict(_SVM.DEFAULTS, probability=False, random_state=None)

    def fit(self, X, y):
        K = self._setup(X)
        tol, C = self.params["tol"], self.params["C"]
        self.classes_, codes = np.unique(y, return_inverse=True)
        rng = np.random.RandomState(self.params["random_state"] or 0)
        self.pairs_ = []
        k = len(self.classes_)
        for i in range(k):
            for j in range(i + 1, k):
                sub = np.concatenate([np.flatnonzero(codes == i), np.flatnonzero(codes == j)])
                yy = np.where(codes[sub] == i, 1.0, -1.0)
                prob = (self._platt(K, sub, yy, C, tol, rng) if self.params["probability"]
                        else None)
                alpha, rho = solve(K, sub, -np.ones(len(sub)), yy, C, tol)
                self.pairs_.append((sub, yy * alpha, rho, prob))
        return self

    @staticmethod
    def _platt(K, sub, yy, C, tol, rng):
        l = len(sub)
        perm = rng.permutation(l)
        dec = np.zeros(l)
        for fold in range(5):
            test = perm[fold * l // 5:(fold + 1) * l // 5]
            train = np.concatenate([perm[:fold * l // 5], perm[(fold + 1) * l // 5:]])
            pos, neg = int(np.sum(yy[train] > 0)), int(np.sum(yy[train] < 0))
            if pos == 0 or neg == 0:
                dec[test] = 0.0 if pos == neg else (1.0 if pos else -1.0)
                continue
            alpha, rho = solve(K, sub[train], -np.ones(len(train)), yy[train], C, tol)
            dec[test] = K[np.ix_(sub[test], sub[train])] @ (yy[train] * alpha) - rho
        return sigmoid_train(dec, yy)

    def decision_values(self, X) -> np.ndarray:
        """(m, pairs) libsvm decision values, pairs (i, j), i < j, in order;
        positive favours class i."""
        Kt = self._gram(np.asarray(X, dtype=np.float64), self.X_)
        return np.stack([Kt[:, sub] @ coef - rho for sub, coef, rho, _ in self.pairs_], axis=1)

    def predict(self, X):
        dec = self.decision_values(X)
        k = len(self.classes_)
        votes = np.zeros((len(dec), k), dtype=np.int64)
        p = 0
        for i in range(k):
            for j in range(i + 1, k):
                win = dec[:, p] > 0
                votes[:, i] += win
                votes[:, j] += ~win
                p += 1
        return self.classes_[votes.argmax(1)]

    def predict_proba(self, X) -> np.ndarray:
        dec = self.decision_values(X)
        k = len(self.classes_)
        r = np.zeros((len(dec), k, k))
        p = 0
        for i in range(k):
            for j in range(i + 1, k):
                A, B = self.pairs_[p][3]
                r[:, i, j] = np.clip(sigmoid_predict(dec[:, p], A, B), 1e-7, 1 - 1e-7)
                r[:, j, i] = 1 - r[:, i, j]
                p += 1
        return np.stack([multiclass_probability(m) for m in r])


class SVR(_SVM):
    DEFAULTS = dict(_SVM.DEFAULTS, epsilon=0.1)

    def fit(self, X, y):
        K = self._setup(X)
        y = np.asarray(y, dtype=np.float64)
        n, eps = len(y), self.params["epsilon"]
        alpha, self.rho_ = solve(K, np.r_[np.arange(n), np.arange(n)],
                                 np.r_[eps - y, eps + y], np.r_[np.ones(n), -np.ones(n)],
                                 self.params["C"], self.params["tol"])
        self.coef_ = alpha[:n] - alpha[n:]
        return self

    def predict(self, X) -> np.ndarray:
        return self._gram(np.asarray(X, dtype=np.float64), self.X_) @ self.coef_ - self.rho_
