"""The port's cBioPortal reader against flexynesis_tpu.utils.cbioportal on
the offline fixture (tests/fixtures/cbioportal/mini_study.tar.gz): the
clinical and mutation tables equal JAX's DataFrames in values, row order and
column order; the split picks the same samples; the written folders are
byte for byte JAX's files."""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from flexynesis_torch.utils.cbioportal import CBioPortalData as Port
from flexynesis_tpu.utils.cbioportal import CBioPortalData as Jax

FIXTURE = Path(__file__).parent / "fixtures" / "cbioportal" / "mini_study.tar.gz"


def _portal(cls, root):
    root.mkdir()
    shutil.copy(FIXTURE, root / "mini_study.tar.gz")
    return cls("mini_study", cache_dir=str(root))


@pytest.fixture()
def both(tmp_path):
    jp, pp = _portal(Jax, tmp_path / "jax"), _portal(Port, tmp_path / "port")
    return jp, jp.get_cbioportal_data("mini_study"), pp, pp.get_cbioportal_data("mini_study")


def _same(table, df):
    assert table.index == [str(i) for i in df.index]
    assert table.columns == [str(c) for c in df.columns]
    assert table.index_name == (df.index.name or "")
    assert table.values.shape == df.shape
    for got, want in zip(table.values.ravel().tolist(), df.to_numpy(dtype=object).ravel().tolist()):
        if isinstance(want, float) and np.isnan(want):
            assert isinstance(got, float) and np.isnan(got)
        else:
            assert got == want and isinstance(got, str) == isinstance(want, str), (got, want)


def test_tables_equal_jax(both):
    _, jdat, _, pdat = both
    assert list(pdat) == list(jdat)
    for name in jdat:
        _same(pdat[name], jdat[name])


def test_split_and_written_folders_equal_jax(both, tmp_path):
    jp, _, pp, _ = both
    jsplit, psplit = jp.split_data(ratio=0.7), pp.split_data(ratio=0.7)
    for split in ("train", "test"):
        for name in jsplit[split]:
            _same(psplit[split][name], jsplit[split][name])
    jp.print_dataset(jsplit, str(tmp_path / "jout"))
    pp.print_dataset(psplit, str(tmp_path / "pout"))
    for split in ("train", "test"):
        for name in ("clin", "mut"):
            want = (tmp_path / "jout" / split / f"{name}.csv").read_bytes()
            assert (tmp_path / "pout" / split / f"{name}.csv").read_bytes() == want


def test_cache_dir_default(monkeypatch, tmp_path):
    monkeypatch.setenv("FLEXYNESIS_CACHE", str(tmp_path / "cache"))
    p = Port("mini_study")
    assert p.cache_dir == str(tmp_path / "cache") and os.path.isdir(p.cache_dir)
    with pytest.raises(RuntimeError, match="read_data"):
        p.split_data()
