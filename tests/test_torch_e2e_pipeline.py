"""The port's raw -> served chain (``creste_public_tpu_torch.e2e_pipeline``)
on the CPU, against the JAX package's ``scripts/e2e_pipeline.py``.

One ``run_pipeline`` at the tiny size (16 frames of 64x80, grid 32 at
1.6 m, horizon 8, ``--device cpu``, serving and the libtorch host's leg
included) makes the checks of ``tests/test_e2e_pipeline.py`` (the export
and its parity, the native artifact, three checkpoints with finite losses,
every label family), and its counterfactual pickles; the host's every
output on the tree's sample meets the direct forward to ``TOL``. Then,
over that tree:

- the preprocessing steps are the JAX script's, in order and arguments
  (plus ``--device`` and the map builders' ``--workers``);
- the port's ``annotate`` wrote the pickles the JAX script's ``annotate``
  writes over a copy of the tree, exactly, and the port's reader gives the
  JAX reader's ``counterfactuals_label`` on them (``n_counterfactuals=4``:
  expert and four candidates are five, both keep the first four);
- the slice as a whole: the port's fused tiny program, exported and
  reloaded, with the weights of a seeded flax tree (jittered BatchNorms, so
  that the reward head's last relu is alive) moved by
  ``weights.from_jax_variables``, on the port reader's sample 0, meets
  JAX's ``MaxEntIRL(tiny, solve_mdp=False).apply`` on the JAX reader's
  sample 0, max|d| / max(1, max|ref|) <= 1e-3 (docs/PARITY.md);
- the release packager writes the JAX script's archive members.

The trained tiny stage-3 head's last relu is dead (random weights at the
tiny preset), so the pipeline's own parity legs read a zero reward on both
sides; the test holds every other output of the reloaded program to the
direct forward as well.
"""
import filecmp
import importlib.util
import json
import os
import pickle
import shutil
import sys
import tarfile

import numpy as np
import pytest
import torch

from creste_public_tpu.data import native_io as jnative_io
from creste_public_tpu_torch import e2e_pipeline as e2e
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, HORIZON, GRID, RANGE = 16, 8, 32, 1.6
TOL = 2e-4
PARITY_TOL = 1e-3


def jax_script(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("e2e") / "work")
    result = e2e.run_pipeline(work, frames=FRAMES, horizon=HORIZON,
                              device="cpu", workers=1)
    return work, result


def test_run_pipeline_on_cpu(pipeline):
    work, result = pipeline
    assert os.path.exists(result["export"])
    assert result["parity_dev"] <= TOL and result["serve_dev"] <= TOL
    assert result["reward_shape"] == result["reply_shape"] == [1, 8, 16, 1]
    nd = result["native_dir"]
    for f in ("program.pt2", "manifest.txt"):
        assert os.path.exists(os.path.join(nd, f))
    assert set(result["stages"]) == set(e2e.STAGES)
    for stage, info in result["stages"].items():
        d = info["ckpt"]
        assert info["steps"] == 2
        steps = [f for f in os.listdir(d) if f.startswith("step_")]
        assert steps, f"{stage}: no checkpoint written"
        rows = [json.loads(line) for line in open(os.path.join(
            d, "metrics.jsonl"))]
        assert rows and all(np.isfinite(r["loss"]) for r in rows
                            if "loss" in r)
    root = os.path.join(work, "data")
    for d in ("depth_5_LA_all/cam0/0", "2d_sam/cam0/0",
              "2d_sam_dynamic/cam0/0", "distillation/cam0/0", "3d_sam/0",
              "3d_sam_dynamic/0", "elevation/0", "counterfactuals/0"):
        assert os.listdir(os.path.join(root, d)), f"missing labels: {d}"
    assert os.path.exists(os.path.join(root, "splits", "train.txt"))
    assert os.path.exists(os.path.join(root, "traversability", "0.txt"))
    frames = list(range(0, FRAMES - HORIZON, 4))
    assert result["annotated"] == len(frames)
    assert sorted(os.listdir(os.path.join(root, "counterfactuals", "0"))) \
        == sorted(f"{f}.pkl" for f in frames)


def test_exported_program_matches_direct_forward(pipeline):
    """Every output of the reloaded program equals the direct forward's
    (the reward head is the fused one's plain version on the CPU), and the
    pipeline's own parity legs held them too."""
    from creste_public_tpu_torch.runtime.export import load_exported

    work, result = pipeline
    d = e2e.direct_forward(os.path.join(work, "data"),
                           result["stages"]["traversability"]["ckpt"], GRID,
                           RANGE, HORIZON, "cpu")
    with torch.no_grad():
        got = load_exported(result["export"]).module()(
            torch.from_numpy(d["rgbd"]), torch.from_numpy(d["p2p"]))
    shared = set(got) & set(d["outputs"])
    assert {"traversability_preds", "input_view", "bev_features"} <= shared
    for k in shared:
        ref = d["outputs"][k]
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(got[k].float().numpy() - ref).max()) / scale \
            <= TOL, k
    assert result["outputs_dev"][1] <= TOL
    assert result["head_launches"] == 0  # the plain version on the CPU


def test_native_host_matches_direct_forward(pipeline):
    """The native leg: the artifact AOT-compiled for the libtorch host and
    served by it on the tree's sample 0 (``--in``), every output it dumped
    within ``TOL`` of the direct forward's scale and its reward within
    ``TOL``; on the CPU the C++ operator runs its plain version (no
    launch), over every frame the host served."""
    _, result = pipeline
    assert result["native_dev"] <= TOL
    assert result["native_outputs_dev"][1] <= TOL, result["native_outputs_dev"]
    assert result["native_head_launches"] == 0
    assert result["native_frames"] == 1 + 3 + 1  # warm-up, timed, dumped
    assert result["native_ms"] > 0 and result["package_s"] > 0
    assert os.path.exists(os.path.join(result["native_dir"], "host.pt2"))


def test_preprocess_steps_follow_the_jax_script(monkeypatch):
    script = jax_script("scripts/e2e_pipeline.py", "_jax_e2e_steps")
    calls = []
    monkeypatch.setattr(script, "_cli", lambda path, *args: calls.append(
        (os.path.splitext(os.path.basename(path))[0], list(args))))
    script.preprocess("R", "0", GRID, RANGE, (16, 20), 16, HORIZON)
    steps = e2e.preprocess_steps("R", "0", GRID, RANGE, (16, 20), 16,
                                 HORIZON, device="cpu", workers=3)
    assert [n for n, _ in steps] == [n for n, _ in calls]
    for (name, args), (_, want) in zip(steps, calls):
        assert args[-2:] == ["--device", "cpu"]
        args = args[:-2]
        if name in ("build_sam_map", "build_feature_map"):
            assert args[-2:] == ["--workers", "3"]
            args = args[:-2]
        assert args == want, name
    assert e2e.preprocess_steps("R", "0", GRID, RANGE, (16, 20), 16,
                                HORIZON)[5][1][-2:] == ["--device", "cuda"]


@pytest.fixture(scope="module")
def jax_annotated(pipeline, tmp_path_factory):
    """The JAX script's annotate over a copy of the pipeline's tree with
    its counterfactuals removed."""
    work, _ = pipeline
    root = str(tmp_path_factory.mktemp("jax_tree") / "data")
    shutil.copytree(os.path.join(work, "data"), root)
    shutil.rmtree(os.path.join(root, "counterfactuals"))
    script = jax_script("scripts/e2e_pipeline.py", "_jax_e2e_annotate")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative_io, "available", lambda: False)
        n = script.annotate(root, "0", GRID, RANGE, HORIZON,
                            list(range(0, FRAMES - HORIZON, 4)))
    assert n == 2
    return root


def test_annotate_matches_jax(pipeline, jax_annotated):
    work, _ = pipeline
    got_dir = os.path.join(work, "data", "counterfactuals", "0")
    want_dir = os.path.join(jax_annotated, "counterfactuals", "0")
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir))
    for f in names:
        got = pickle.load(open(os.path.join(got_dir, f), "rb"))
        want = pickle.load(open(os.path.join(want_dir, f), "rb"))
        assert (got["rank"], got["seq"], got["frame"]) == (
            want["rank"], want["seq"], want["frame"])
        assert got["rank"] == [4, 3, 2, 1, 0]
        assert len(got["trajectories"]) == len(want["trajectories"]) == 5
        for a, b in zip(got["trajectories"], want["trajectories"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_counterfactuals_label_matches_jax_reader(pipeline, monkeypatch):
    from creste_public_tpu.data.coda_dataset import CodaDataset as JCoda
    from creste_public_tpu_torch.data.coda_dataset import CodaDataset

    work, _ = pipeline
    monkeypatch.setattr(jnative_io, "available", lambda: False)
    cfg = e2e.reader_config(os.path.join(work, "data"), GRID, RANGE,
                            HORIZON)
    for split in ("train", "val"):
        port, jax_ = CodaDataset(cfg, split, "cpu"), JCoda(cfg, split)
        assert port.infos == jax_.infos
        for i in range(len(port)):
            got, want = (port[i]["counterfactuals_label"],
                         jax_[i]["counterfactuals_label"])
            assert set(got) == set(want)
            for k in got:
                assert got[k].shape[0] == e2e.N_COUNTERFACTUALS
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    annotated = [i for i, (_, fr) in enumerate(port.infos) if fr % 4 == 0
                 and fr < FRAMES - HORIZON]
    for i in annotated:
        assert port[i]["counterfactuals_label"]["valid"].all()


def test_exported_tiny_program_matches_jax(pipeline, tmp_path, monkeypatch):
    import jax

    from creste_public_tpu.config import presets as jpresets
    from creste_public_tpu.data.coda_dataset import CodaDataset as JCoda
    from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
    from creste_public_tpu_torch.config import presets
    from creste_public_tpu_torch.data.coda_dataset import CodaDataset
    from creste_public_tpu_torch.runtime.export import (
        build_inference_graph,
        export_inference_graph,
        load_exported,
    )
    from creste_public_tpu_torch.weights import from_jax_variables
    from tests.test_torch_helpers import (
        jax_variables,
        jitter_bn,
        seeded_variables,
    )

    work, _ = pipeline
    monkeypatch.setattr(jnative_io, "available", lambda: False)
    cfg = e2e.reader_config(os.path.join(work, "data"), GRID, RANGE,
                            HORIZON)
    s = CodaDataset(cfg, "train", "cpu")[0]
    js = JCoda(cfg, "train")[0]
    rgbd, p2p = s["image"][None], s["p2p"][None]
    np.testing.assert_array_equal(rgbd, js["image"][None])
    np.testing.assert_array_equal(p2p, js["p2p"][None])

    jcfg = jpresets.tiny_traversability_config().to_dict()
    jcfg["solve_mdp"] = False
    jm = JMaxEntIRL(jcfg)
    flat = jitter_bn(seeded_variables(jm, rgbd, p2p, seed=3))
    want = np.asarray(jax.jit(lambda v, x, p: jm.apply(
        v, x, p, train=False)["traversability_preds"])(
        jax_variables(flat), js["image"][None], js["p2p"][None]))

    graph = build_inference_graph(presets.tiny_traversability_config(),
                                  from_jax_variables(flat), "cpu", True)
    path = str(tmp_path / "tiny.pt2")
    export_inference_graph(graph, rgbd, p2p, path)
    with torch.no_grad():
        got = load_exported(path).module()(
            torch.from_numpy(rgbd), torch.from_numpy(p2p))[
            "traversability_preds"].numpy()
    assert got.shape == want.shape == (1, 8, 16, 1)
    assert (want > 0).mean() > 0.2, "the reward head's last relu is dead"
    rel = float(np.abs(got - want).max()) / max(1.0, float(np.abs(
        want).max()))
    print(f"exported tiny program vs JAX apply on the chain's sample 0: "
          f"{rel:.3e} (bar {PARITY_TOL})")
    assert rel <= PARITY_TOL


def test_release_packager_matches_jax(pipeline, tmp_path):
    from creste_public_tpu_torch.release import package_data

    work, _ = pipeline
    root = os.path.join(work, "data")
    got = str(tmp_path / "port.tar.gz")
    n = package_data.main(["--root", root, "--out", got, "--window", "2"])
    script = jax_script("scripts/release/package_data.py", "_jax_package")
    want = str(tmp_path / "jax.tar.gz")
    old = sys.argv
    sys.argv = ["package_data.py", "--root", root, "--out", want,
                "--window", "2"]
    try:
        script.main()
    finally:
        sys.argv = old
    with tarfile.open(got) as a, tarfile.open(want) as b:
        names = a.getnames()
        assert names == b.getnames()
        assert "counterfactuals/0/4.pkl" in names
        a.extractall(tmp_path / "a", filter="data")
        b.extractall(tmp_path / "b", filter="data")
    assert n > 0
    for name in names:
        pa, pb = tmp_path / "a" / name, tmp_path / "b" / name
        if pa.is_file():
            assert filecmp.cmp(pa, pb, shallow=False), name
