"""Integrated gradients of a plain float32 DirectPred, as Captum defines them.

Zero baseline; the path integral by Gauss-Legendre quadrature over
``steps`` nodes on [0, 1] (Captum's default method); for each class c of
the target, attr = x * sum_k w_k dlogit_c(a_k x)/dx, in eval mode (running
statistics, no dropout). The importance of a feature is the mean over the
samples of |attr|.
"""

from __future__ import annotations

import numpy as np
import torch

from . import directpred


def importances(params, stats, x, layers, target, n_classes, steps, cfg,
                block_rows: int = 4096) -> np.ndarray:
    """(n_classes, features of every layer in order) mean |attributions|."""
    nodes, weights = np.polynomial.legendre.leggauss(steps)
    alphas = (nodes + 1.0) * 0.5
    weights = weights * 0.5
    n = next(iter(x.values())).shape[0]
    out = np.zeros((n_classes, sum(v.shape[1] for v in x.values())))
    for start in range(0, n, max(block_rows // steps, 1)):
        xb = {ln: x[ln][start: start + max(block_rows // steps, 1)] for ln in layers}
        acc = [{ln: torch.zeros_like(xb[ln]) for ln in layers} for _ in range(n_classes)]
        for a, w in zip(alphas, weights):
            pts = {ln: (float(a) * xb[ln]).requires_grad_(True) for ln in layers}
            logits = directpred.forward(params, dict(stats), pts, layers, target, False, None,
                                        cfg)
            for c in range(n_classes):
                grads = torch.autograd.grad(logits[:, c].sum(), [pts[ln] for ln in layers],
                                            retain_graph=c + 1 < n_classes)
                for ln, g in zip(layers, grads):
                    acc[c][ln] += float(w) * g
        for c in range(n_classes):
            attr = torch.cat([(xb[ln] * acc[c][ln]).abs().sum(0) for ln in layers])
            out[c] += attr.double().cpu().numpy()
    return out / n
