"""Lazy re-exports for the subpackage facades: a name is imported from its
submodule at first use, so importing the facade loads nothing heavy."""

from __future__ import annotations

import importlib
import sys
from typing import Dict, Sequence


def lazy_exports(package: str, names: Dict[str, Sequence[str]]):
    """(table, __getattr__, __dir__) of ``package`` re-exporting ``names``,
    {submodule: (name, ...)}; ``table`` maps each name to its submodule."""
    table = {name: module for module, group in names.items() for name in group}

    def __getattr__(name: str):
        if name in table:
            value = getattr(importlib.import_module(f"{package}.{table[name]}"), name)
            setattr(sys.modules[package], name, value)
            return value
        raise AttributeError(f"module '{package}' has no attribute '{name}'")

    def __dir__():
        return sorted(set(vars(sys.modules[package])) | set(table))

    return table, __getattr__, __dir__
