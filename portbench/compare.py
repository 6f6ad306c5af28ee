"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out, each held against a limit.

A training number is taken by the worst leaf: the gap between the program's
norm of a leaf and the reference's, over the larger of the reference's norm
of that leaf and of the median leaf (some gradients are all but zero). A
leaf whose reference gradient is under a thousandth of the median leaf's is
nought to rounding (a loss weight that a single loss leaves unused, a key's
bias under softmax) and moves under Adam by round-off alone: it is left out
by that rule, never by name.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

NOUGHT = 1e-3  # a leaf whose reference gradient norm is under this share of the median's


@dataclass
class Check:
    name: str
    value: float
    limit: Optional[float]

    @property
    def ok(self) -> bool:
        if self.limit is None:
            return True
        return math.isfinite(self.value) and self.value <= self.limit


def rel_gap(got, want) -> float:
    """max |got - want| / |want| over matching entries (tensors or floats)."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def start_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """max over ``want``'s leaves of max |got - want| / max |want|: 0 where
    two starts are equal entry for entry (a leaf missing from ``got`` reads
    infinite)."""
    worst = 0.0
    for n, w in want.items():
        if n not in got or got[n].shape != w.shape:
            return float("inf")
        d = float((got[n].double() - w.double()).abs().max()) if w.numel() else 0.0
        worst = max(worst, d / max(float(w.double().abs().max()), 1e-30))
    return worst


def median(values: Sequence[float]) -> float:
    vals = sorted(values)
    n = len(vals)
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2]) if n else 0.0


def live_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    """The leaves the change is compared on: reference gradient at least
    ``NOUGHT`` of the median leaf's."""
    med = median(list(ref_grad_norms.values()))
    return [n for n, g in ref_grad_norms.items() if g >= NOUGHT * med]


def worst_leaf(got: Dict[str, float], want: Dict[str, float], leaves: Sequence[str]) -> float:
    """max over ``leaves`` of |got - want| / max(want, median of want)."""
    if not leaves:
        return float("nan")
    return max(leaf_gaps(got, want, leaves).values())


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves: Sequence[str]
              ) -> Dict[str, float]:
    """Each leaf's |got - want| / max(want, median of want)."""
    med = median([want[n] for n in leaves])
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in leaves}


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tree.items()}


def stderr_lines(checks: Sequence[Check]) -> List[str]:
    return [f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}"
            for c in checks]


def as_json(checks: Sequence[Check]) -> Dict[str, dict]:
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products on (the control) or off (the reference, as the
    configuration states) inside the block."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved
