"""The port's raw synthetic CODa writer (``data/raw_synthetic.py``)
against the JAX package's: the same seed writes the same bytes (scans,
semantic ids, JPEGs, poses, timestamps), and the calibration files, which
the port writes as text without a YAML library, read to the same values
with ``yaml.safe_load``, with the port's reader and through both packages'
``load_calibration``. All exact.
"""
import filecmp
import os

import numpy as np
import pytest
import yaml

from creste_public_tpu.data.calib import load_calibration as jload
from creste_public_tpu.data.raw_synthetic import write_raw_coda_tree as jwrite
from creste_public_tpu_torch.data.calib import (
    load_calibration,
    read_calibration_yaml,
)
from creste_public_tpu_torch.data.raw_synthetic import (
    _yaml_float,
    write_raw_coda_tree,
)

CASES = {"default": {}, "moved": dict(seq="3", n_frames=3, img_hw=(48, 72),
                                      points_per_scan=1000, max_range=5.0,
                                      speed=0.4, curve=-0.03, seed=7)}


@pytest.mark.parametrize("case", list(CASES))
def test_raw_tree_matches_jax(tmp_path, case):
    kw = dict(n_frames=4, **CASES[case]) if case == "default" else CASES[case]
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    ma, mb = jwrite(a, **kw), write_raw_coda_tree(b, **kw)
    assert {k: v for k, v in ma.items() if k != "root"} == {
        k: v for k, v in mb.items() if k != "root"}
    files = []
    for dp, _, fn in os.walk(a):
        files += [os.path.relpath(os.path.join(dp, f), a) for f in fn]
    got = []
    for dp, _, fn in os.walk(b):
        got += [os.path.relpath(os.path.join(dp, f), b) for f in fn]
    assert sorted(files) == sorted(got)
    n_yaml = 0
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".yaml"):
            want = yaml.safe_load(open(pa))
            assert yaml.safe_load(open(pb)) == want, rel
            assert read_calibration_yaml(pb) == want, rel
            n_yaml += 1
        else:
            assert filecmp.cmp(pa, pb, shallow=False), rel
    assert n_yaml == 2
    seq = kw.get("seq", "0")
    cj, cp = jload(a, seq), load_calibration(b, seq)
    for k in ("K", "R", "P", "lidar2cam", "lidar2camrect"):
        np.testing.assert_array_equal(getattr(cp, k), getattr(cj, k), k)
    assert cp.img_hw == cj.img_hw


@pytest.mark.parametrize("x", [0.0, -0.0, 1.0, 57.6, 21.599999999999998,
                               1e-05, -3.5e-17, 1e22, 2.0 ** -1074])
def test_yaml_float_round_trips(x):
    """Every float reads back to itself, exponent forms included (YAML 1.1
    reads '1e-05' as a string)."""
    got = yaml.safe_load(f"v: {_yaml_float(x)}")["v"]
    assert isinstance(got, float) and got == x
