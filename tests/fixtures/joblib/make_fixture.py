"""Write this folder: a small DirectPred trained by the JAX package's CLI with
its defaults (so its preprocessing state is ``job.artifacts.joblib``, written
by ``joblib.dump``), the same state as JAX's JSON artifact, and a test cohort.

Run from the root of the repository, on the CPU:

    JAX_PLATFORMS=cpu python tests/fixtures/joblib/make_fixture.py

It needs JAX, joblib and scikit-learn; the files it writes are read where
neither is installed. ``VERSIONS.txt`` records the versions that wrote them.
The training folder has one missing label (the encoder's NaN category) and
so does the test cohort.
"""

import os
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

CONFIG = """DirectPred:
  - {type: Categorical, categories: [16], name: latent_dim}
  - {type: Categorical, categories: [0.3], name: hidden_dim_factor}
  - {type: Categorical, categories: [0.003], name: lr}
  - {type: Categorical, categories: [8], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [20], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
  - {type: Categorical, categories: [true], name: fused_kernels}
"""


def blank_label(clin: Path, row: int) -> None:
    """Empty the ``subtype`` cell of the ``row``-th sample of a clin.csv."""
    lines = clin.read_text().splitlines()
    col = lines[0].split(",").index("subtype")
    cells = lines[row + 1].split(",")
    cells[col] = ""
    lines[row + 1] = ",".join(cells)
    clin.write_text("\n".join(lines) + "\n")


def main() -> None:
    import jax
    import joblib
    import numpy as np
    import sklearn

    from flexynesis_torch.utils.synthetic import write_synthetic_folder
    from flexynesis_tpu.__main__ import main as jax_main
    from flexynesis_tpu.inference import load_and_sniff_artifacts, write_artifacts

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = root / "data"
        write_synthetic_folder(str(data), n_train=48, n_test=20,
                               n_features={"gex": 40, "cnv": 30}, n_classes=3, seed=7)
        blank_label(data / "train" / "clin.csv", 5)
        blank_label(data / "test" / "clin.csv", 3)
        (root / "hpo.yaml").write_text(CONFIG)
        out = root / "out"
        rc = jax_main(["--data_path", str(data), "--model_class", "DirectPred",
                       "--data_types", "gex,cnv", "--target_variables", "subtype",
                       "--config_path", str(root / "hpo.yaml"), "--hpo_iter", "1",
                       "--features_top_percentile", "50", "--features_min", "10",
                       "--disable_marker_finding", "--outdir", str(out), "--prefix", "job"])
        if rc != 0:
            raise SystemExit(f"the JAX CLI returned {rc}")
        for name in ("job.final_model.safetensors", "job.final_model_config.json",
                     "job.artifacts.joblib"):
            shutil.copy(out / name, HERE / name)
        write_artifacts(load_and_sniff_artifacts(str(out / "job.artifacts.joblib")),
                        str(HERE / "job.artifacts.json"), as_json=True)
        shutil.rmtree(HERE / "test", ignore_errors=True)
        shutil.copytree(data / "test", HERE / "test")
    (HERE / "VERSIONS.txt").write_text(
        f"joblib {joblib.__version__}\nscikit-learn {sklearn.__version__}\n"
        f"numpy {np.__version__}\njax {jax.__version__}\n"
        f"python {sys.version.split()[0]}\n")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
