"""HDF5 training folders: ``H5DataImporter`` and ``folder_has_h5``.

Counterpart of ``flexynesis_tpu/data/h5.py``: each omics layer loads from
``{dt}.h5`` (``/matrix`` (samples, features) float32, ``/sample_ids`` and
``/feature_names`` byte strings, as ``csv_to_h5`` writes them) where the
split has one, else from ``{dt}.csv``; ``clin.csv`` is always CSV. The file
is read by the port's own reader (``utils/hdf5.py``), not h5py, into the
features x samples ``Layer`` that the CSV path builds. HDF5 is a training
input only: inference mode reads CSV, as in the JAX package.
"""

from __future__ import annotations

import os

from ..utils.hdf5 import read_matrix_h5
from .importer import DataImporter, Layer


class H5DataImporter(DataImporter):
    """DataImporter that prefers ``.h5`` layer files over ``.csv``."""

    def read_layer(self, folder_path: str, name: str) -> Layer:
        h5_path = os.path.join(folder_path, f"{name}.h5")
        if os.path.exists(h5_path):
            print(f"[INFO] Importing {h5_path} (HDF5)...")
            return Layer(*read_matrix_h5(h5_path))
        print(f"[INFO] No HDF5 at {h5_path}; falling back to CSV")
        return super().read_layer(folder_path, name)

    def validate_data_folders(self, training_path: str, testing_path: str) -> None:
        for split, path in (("training", training_path), ("testing", testing_path)):
            if not os.path.isdir(path):
                raise ValueError(f"{split} folder does not exist: {path}")
            missing = [] if os.path.exists(os.path.join(path, "clin.csv")) else ["clin.csv"]
            missing += [f"{dt}.h5 or {dt}.csv" for dt in self.data_types
                        if not any(os.path.exists(os.path.join(path, f"{dt}.{ext}"))
                                   for ext in ("h5", "csv"))]
            if missing:
                raise ValueError(f"Missing files in {split} folder: {', '.join(missing)}")


def folder_has_h5(data_path: str, data_types) -> bool:
    """Whether any layer of train or test is an ``.h5`` file (the CLI then
    imports with ``H5DataImporter``)."""
    return any(os.path.exists(os.path.join(data_path, split, f"{dt}.h5"))
               for split in ("train", "test") for dt in data_types)
