"""Device choice for the port's entry points.

``auto`` and ``cuda`` mean the CUDA card and raise when there is none: the
port never carries on on the CPU unless the caller asks for ``cpu``. ``tpu``
and ``mps`` are not targets of this package and raise.
"""

from __future__ import annotations

import torch

DEVICE_CHOICES = ("auto", "tpu", "cuda", "mps", "cpu")


def resolve_device(preference="auto") -> torch.device:
    if isinstance(preference, torch.device):
        preference = str(preference)
    if preference in ("auto", "cuda") or preference.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {preference}: no CUDA device is available. "
                "flexynesis_torch runs on the card; pass --device cpu to run "
                "on the CPU instead."
            )
        return torch.device("cuda" if preference == "auto" else preference)
    if preference == "cpu":
        return torch.device("cpu")
    raise ValueError(
        f"device '{preference}' is not supported by flexynesis_torch "
        "(use cuda or cpu; flexynesis_tpu serves TPUs)"
    )
