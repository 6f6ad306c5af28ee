"""The port's HPO pieces against the JAX package's: search-space transforms
and the YAML override (flow style as in examples/configs, and the block
style yaml.safe_dump writes), the GP optimizer's suggestions for 15 asks and
tells from one seed (exactly equal), the batch-size space, and the default
spaces. No tolerance: the port keeps copies of the same numpy code."""

import numpy as np
import pytest
import yaml

from flexynesis_tpu import config as jax_config
from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_tpu.train import gp as jax_gp
from flexynesis_tpu.train import space as jax_space
from flexynesis_tpu.train.hpo import HyperparameterTuning as JaxTuning
from flexynesis_torch import config
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.train import gp, space
from flexynesis_torch.train.hpo import HyperparameterTuning

EXAMPLE = "examples/configs/hpo_configuration.yaml"


def _dims(s):
    return [(type(d).__name__, vars(d)) for d in s.dimensions]


@pytest.mark.parametrize("style", ["flow", "block"])
def test_yaml_override_matches_jax(style, tmp_path):
    path = EXAMPLE
    if style == "block":
        with open(EXAMPLE) as fh:
            loaded = yaml.safe_load(fh)
        path = str(tmp_path / "block.yml")
        with open(path, "w") as fh:
            yaml.safe_dump(loaded, fh, default_flow_style=False)
    ours = space.load_and_convert_config(path)
    theirs = jax_space.load_and_convert_config(path)
    assert ours.keys() == theirs.keys()
    for name in ours:
        assert _dims(ours[name]) == _dims(theirs[name])
    with pytest.raises(ValueError, match="yaml"):
        space.load_and_convert_config(str(tmp_path / "x.json"))


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    ours = config.get_search_space("DirectPred")
    theirs = jax_config.get_search_space("DirectPred")
    for _ in range(50):
        u = rng.random(len(ours))
        p = ours.from_unit(u)
        assert p == theirs.from_unit(u)
        np.testing.assert_array_equal(ours.to_unit(p), theirs.to_unit(p))
    for name in config.search_space_names:
        assert _dims(config.get_search_space(name)) == _dims(jax_config.get_search_space(name))


def objective(p):
    return (np.log10(p["lr"]) + 2.5) ** 2 + (p["latent_dim"] - 64) ** 2 / 1e3 \
        + p["hidden_dim_factor"] + p["batch_size"] / 1e3


def test_gp_suggestions_identical_to_jax():
    ours_space = config.get_search_space("DirectPred")
    theirs_space = jax_config.get_search_space("DirectPred")
    ours_space.append(space.Categorical([32, 64, 128], name="batch_size"))
    theirs_space.append(jax_space.Categorical([32, 64, 128], name="batch_size"))
    ours = gp.BayesianOptimizer(ours_space, n_initial_points=10, seed=42)
    theirs = jax_gp.BayesianOptimizer(theirs_space, n_initial_points=10, seed=42)
    for _ in range(15):
        (a,) = ours.ask(1)
        (b,) = theirs.ask(1)
        assert a == b
        ours.tell(a, objective(a))
        theirs.tell(b, objective(b))
    assert ours.best == theirs.best


def _dataset(cls, n):
    return cls(dat={"gex": np.zeros((n, 4), np.float32)},
               ann={"y": np.zeros(n, np.float32)}, variable_types={"y": "categorical"},
               features={"gex": list("abcd")}, samples=[str(i) for i in range(n)])


@pytest.mark.parametrize("n", [10, 50, 90, 200, 5000])
def test_batch_space_matches_jax(n):
    ours = HyperparameterTuning(_dataset(MultiOmicDataset, n), DirectPred, "DirectPred",
                                ["y"], device="cpu")
    theirs = JaxTuning(_dataset(JaxDataset, n), JaxDirectPred, "DirectPred", ["y"])
    assert ours.get_batch_space().categories == theirs.get_batch_space().categories
    assert _dims(ours.space) == _dims(theirs.space)
