"""Hyperparameter search-space dimensions + unit-cube transforms.

A copy of ``flexynesis_tpu/train/space.py`` kept in the port: ``Integer``,
``Real`` (uniform / log-uniform) and ``Categorical`` dimensions with maps to
[0, 1]^d for the GP optimizer (gp.py), and the YAML search-space override
(reference main.py:429-456). Integer dimensions take a ``quantize`` step, as
in the JAX package, so that both packages draw the same trials.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


class Dimension:
    name: str

    def to_unit(self, value) -> float:
        raise NotImplementedError

    def from_unit(self, u: float):
        raise NotImplementedError

    def sample(self, rng: np.random.Generator):
        return self.from_unit(rng.random())


@dataclass
class Integer(Dimension):
    low: int
    high: int
    name: str = ""
    quantize: int = 1

    def to_unit(self, value) -> float:
        return (float(value) - self.low) / max(self.high - self.low, 1)

    def from_unit(self, u: float) -> int:
        v = int(round(self.low + u * (self.high - self.low)))
        if self.quantize > 1:
            v = int(round(v / self.quantize) * self.quantize)
        return int(min(max(v, self.low), self.high))


@dataclass
class Real(Dimension):
    low: float
    high: float
    name: str = ""
    prior: str = "uniform"

    def to_unit(self, value) -> float:
        if self.high == self.low:
            return 0.0
        if self.prior == "log-uniform":
            return (math.log(value) - math.log(self.low)) / (
                math.log(self.high) - math.log(self.low)
            )
        return (value - self.low) / (self.high - self.low)

    def from_unit(self, u: float) -> float:
        if self.high == self.low:
            return float(self.low)
        if self.prior == "log-uniform":
            return float(
                math.exp(
                    math.log(self.low)
                    + u * (math.log(self.high) - math.log(self.low))
                )
            )
        return float(self.low + u * (self.high - self.low))


@dataclass
class Categorical(Dimension):
    categories: Sequence
    name: str = ""

    def __post_init__(self):
        self.categories = list(self.categories)

    def to_unit(self, value) -> float:
        idx = self.categories.index(value)
        return idx / max(len(self.categories) - 1, 1)

    def from_unit(self, u: float):
        idx = int(round(u * (len(self.categories) - 1)))
        return self.categories[min(max(idx, 0), len(self.categories) - 1)]


class SearchSpace:
    """Ordered set of dimensions with vectorized unit-cube transforms."""

    def __init__(self, dimensions: List[Dimension]):
        self.dimensions = list(dimensions)

    @property
    def names(self) -> List[str]:
        return [d.name for d in self.dimensions]

    def __len__(self) -> int:
        return len(self.dimensions)

    def append(self, dim: Dimension) -> None:
        self.dimensions.append(dim)

    def to_unit(self, params: dict) -> np.ndarray:
        return np.array(
            [d.to_unit(params[d.name]) for d in self.dimensions], dtype=np.float64
        )

    def from_unit(self, u: np.ndarray) -> dict:
        return {d.name: d.from_unit(float(v)) for d, v in zip(self.dimensions, u)}

    def sample(self, rng: np.random.Generator) -> dict:
        return self.from_unit(rng.random(len(self.dimensions)))


def load_and_convert_config(config_path: str, quantize: Optional[int] = None):
    """YAML search-space override (reference main.py:429-456 semantics).

    YAML schema: {model_name: [{type: Integer|Real|Categorical, ...}, ...]}.
    """
    if not (config_path.endswith(".yaml") or config_path.endswith(".yml")):
        raise ValueError("Unsupported file format. Use .yaml or .yml")
    import yaml

    with open(config_path) as fh:
        loaded = yaml.safe_load(fh)
    spaces = {}
    for model, entries in loaded.items():
        dims = []
        for entry in entries:
            entry = dict(entry)
            etype = entry.pop("type")
            if etype == "Integer":
                dims.append(Integer(**entry))
            elif etype == "Real":
                dims.append(Real(**entry))
            elif etype == "Categorical":
                dims.append(Categorical(**entry))
            else:
                raise ValueError(f"Unknown space type: {etype}")
        spaces[model] = SearchSpace(dims)
    return spaces
