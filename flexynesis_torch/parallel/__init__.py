"""Parallel execution: device meshes, stacked trials, multi-process helpers."""

from .distributed import initialize, partition_trials
from .mesh import auto_trial_mesh, data_sharding, get_mesh, replicated, trial_sharding
from .trials import ParallelTrials

__all__ = [
    "get_mesh",
    "auto_trial_mesh",
    "trial_sharding",
    "data_sharding",
    "replicated",
    "ParallelTrials",
    "initialize",
    "partition_trials",
]
