"""The port's counterfactual annotation against the JAX package's.

``creste_public_tpu_torch.annotation`` (control, the app's backend and its
HTTP contract) is held to ``creste_public_tpu.annotation`` on the same
inputs, all bit for bit: the samplers, Hausdorff distances and BEV
transforms for several seeds, both samplers and odd and even counts; the
backend's ``load`` (trajectories, distances, the decoded BEV and front PNGs
per pixel), its ``regen`` and ``index`` navigation and the pickles ``save``
writes, on two trees (dense poses only, as ``tests/test_annotation.py``
writes, and a tree the port's preprocessing chain wrote from a raw
synthetic sequence); and the server's pages and replies. The JAX reader
decodes with PIL (its ``native_io.available`` patched to False), as the
port's does.
"""
import base64
import io
import json
import os
import pickle
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer

import numpy as np
import pytest
from PIL import Image

from creste_public_tpu.annotation import app as japp
from creste_public_tpu.annotation import control as jctl
from creste_public_tpu.data import native_io as jnative_io
from creste_public_tpu_torch.annotation import app as papp
from creste_public_tpu_torch.annotation import control as ctl
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

SEEDS = (0, 1, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [4, 5])
def test_unicycle_trajectories_equal(seed, n):
    got = ctl.sample_unicycle_trajectories(n, 20, seed=seed)
    want = jctl.sample_unicycle_trajectories(n, 20, seed=seed)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ctl.unicycle_step(got[:, 5], np.full(n, 0.3), np.full(n, 1.2), 0.2),
        jctl.unicycle_step(got[:, 5], np.full(n, 0.3), np.full(n, 1.2), 0.2))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [4, 5])
def test_epsilon_trajectories_and_distances_equal(seed, n):
    t = np.linspace(0, 1, 30)
    expert = np.stack([5 * t, 1.5 * np.sin(2 * t)], axis=1)
    got = ctl.sample_epsilon_trajectories(expert, n, 25, epsilon=1.5,
                                          seed=seed)
    want = jctl.sample_epsilon_trajectories(expert, n, 25, epsilon=1.5,
                                            seed=seed)
    assert got.shape == (n, 25, 3)
    np.testing.assert_array_equal(got, want)
    # the expert's first 25 points, then every candidate
    trajs = np.concatenate([expert[None, :25], got[:, :, :2]])
    np.testing.assert_array_equal(ctl.hausdorff_distances(trajs),
                                  jctl.hausdorff_distances(trajs))


def test_bev_round_trip_equal():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-12.8, 12.8, (40, 2))
    for center, res in (((12.8, 12.8), 0.1), ((1.6, 1.6), 0.1),
                        ((3.2, 3.2), 0.1)):
        rc = ctl.metric_to_bev(xy, center, res)
        np.testing.assert_array_equal(rc, jctl.metric_to_bev(xy, center,
                                                             res))
        back = ctl.bev_to_metric(rc, center, res)
        np.testing.assert_array_equal(back, jctl.bev_to_metric(rc, center,
                                                               res))
        np.testing.assert_allclose(back, xy, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ctl.metric_to_bev(np.zeros(2)),
                                  [128.0, 128.0])


def poses_tree(root) -> str:
    """tests/test_annotation.py's tree: dense poses and a train split."""
    (root / "poses" / "dense").mkdir(parents=True)
    rows = [[i * 0.1, i * 0.15, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
            for i in range(80)]
    np.savetxt(root / "poses" / "dense" / "0.txt", np.asarray(rows))
    (root / "splits").mkdir()
    (root / "splits" / "train.txt").write_text("0 0\n0 3\n0 9\n")
    return str(root)


def chain_tree(root) -> str:
    """A raw synthetic sequence through the port's eight preprocessing
    entry points (12 frames of 64x80, grid 32 at 1.6 m)."""
    from creste_public_tpu_torch.data.raw_synthetic import write_raw_coda_tree
    from creste_public_tpu_torch.e2e_pipeline import preprocess

    write_raw_coda_tree(str(root), n_frames=12, img_hw=(64, 80), speed=0.22,
                        curve=0.015, max_range=3.2)
    preprocess(str(root), "0", 32, 1.6, (16, 20), 16, 5, device="cpu",
               workers=1)
    return str(root)


# (tree, backend keyword arguments)
TREES = {"poses": (poses_tree, dict(grid=64, map_range=3.2, horizon=20)),
         "chain": (chain_tree, dict(grid=32, map_range=1.6, horizon=10))}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return {name: make(tmp_path_factory.mktemp(name))
            for name, (make, _) in TREES.items()}


@pytest.fixture(autouse=True)
def pil_decoding(monkeypatch):
    monkeypatch.setattr(jnative_io, "available", lambda: False)


def backends(root: str, tree: str, **kw):
    args = dict(TREES[tree][1], **kw)
    return (papp.AnnotationBackend(root, **args),
            japp.AnnotationBackend(root, **args))


def decoded(b64: str | None):
    if b64 is None:
        return None
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def assert_same_load(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in got:
        if k in ("image", "front_image"):
            a, b = decoded(got[k]), decoded(want[k])
            assert (a is None) == (b is None), k
            if a is not None:
                assert a.shape == b.shape and a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("sampler, n", [("epsilon", 4), ("epsilon", 5),
                                        ("unicycle", 4)])
def test_backend_load_equal(trees, tree, sampler, n):
    port, jax_ = backends(trees[tree], tree, num_candidates=n,
                          sampler=sampler)
    frames = [0, 3] if tree == "poses" else [0, 4]
    for fr in frames:
        got, want = port.load("0", fr), jax_.load("0", fr)
        assert len(got["trajectories"]) == n + 1
        assert got["distances"][0] == 0.0
        assert_same_load(got, want)
    if tree == "chain":
        # the chain's tree has the camera frames: a front view is served
        assert decoded(got["front_image"]).shape == (64, 80, 3)


@pytest.mark.parametrize("tree", list(TREES))
def test_backend_regen_and_index_navigation_equal(trees, tree):
    port, jax_ = backends(trees[tree], tree, num_candidates=4)
    for kwargs in (dict(regen=1), dict(regen=2), dict(index=0),
                   dict(index=-1), dict(index=-1), dict(index=1, regen=3)):
        got = port.load("0", 0, **kwargs)
        want = jax_.load("0", 0, **kwargs)
        assert_same_load(got, want)
    assert port._cursor == jax_._cursor
    with pytest.raises(IndexError, match="out of range"):
        port.resolve_index(len(port._ds().infos))
    a, b = port.load("0", 0), port.load("0", 0, regen=1)
    assert a["trajectories"][0] == b["trajectories"][0]
    assert a["trajectories"][1:] != b["trajectories"][1:]


def saved_record(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_same_record(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"trajectories", "rank", "seq",
                                     "frame"}
    assert (got["rank"], got["seq"], got["frame"]) == (
        want["rank"], want["seq"], want["frame"])
    assert len(got["trajectories"]) == len(want["trajectories"])
    for a, b in zip(got["trajectories"], want["trajectories"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("payload", [
    {"order": [3, 0, 1, 2, 4]},  # drag order, inverted to rank values
    {"rank": [1, 2, 0, 4, 3]},  # rank values, stored verbatim
    {"rank": [0, 1, 1, 2, 2]},
], ids=["order", "rank_permutation", "rank_ties"])
def test_backend_save_equal(trees, tmp_path, payload):
    trajectories = papp.AnnotationBackend(
        trees["poses"], **TREES["poses"][1]).load("0", 0)["trajectories"]
    paths = {}
    for side, app in (("port", papp), ("jax", japp)):
        root = tmp_path / side
        root.mkdir()
        paths[side] = app.AnnotationBackend(str(root)).save(
            {"seq": "0", "frame": 3, "trajectories": trajectories,
             **payload})
        assert os.path.relpath(paths[side], root) == os.path.join(
            "counterfactuals", "0", "3.pkl")
    got, want = saved_record(paths["port"]), saved_record(paths["jax"])
    assert_same_record(got, want)
    if "order" in payload:
        assert got["rank"] == [1, 2, 3, 0, 4]


def test_backend_refuses_a_non_permutation(tmp_path):
    for app in (papp, japp):
        with pytest.raises(ValueError, match="permutation"):
            app.AnnotationBackend(str(tmp_path)).save(
                {"seq": "0", "frame": 1, "trajectories": [[[0, 0]], [[1, 1]]],
                 "order": [0, 0]})
    assert not os.path.exists(tmp_path / "counterfactuals" / "0" / "1.pkl")


def test_page_equal():
    assert papp._PAGE == japp._PAGE


def fetch(url: str, data: bytes | None = None):
    """(status, content type, body) of a GET, or of a POST of ``data``."""
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_http_contract_equal(trees, tmp_path):
    import shutil

    servers, roots = {}, {}
    for side, app in (("port", papp), ("jax", japp)):
        roots[side] = str(tmp_path / side)
        shutil.copytree(trees["poses"], roots[side])
        be = app.AnnotationBackend(roots[side], **TREES["poses"][1],
                                   num_candidates=3)
        servers[side] = HTTPServer(("127.0.0.1", 0), app.make_handler(be))
        threading.Thread(target=servers[side].serve_forever,
                         daemon=True).start()
    try:
        replies = {}
        for side, server in servers.items():
            url = f"http://127.0.0.1:{server.server_address[1]}"
            loaded = json.loads(fetch(f"{url}/load?seq=0&frame=3")[2])
            save = json.dumps({"seq": "0", "frame": 3, "order": [2, 1, 0, 3],
                               "trajectories": loaded["trajectories"]})
            replies[side] = [
                fetch(f"{url}/"),
                fetch(f"{url}/load?seq=0&frame=3"),
                fetch(f"{url}/load?index=1&regen=2"),
                fetch(f"{url}/load?index=-1"),
                fetch(f"{url}/load?index=77"),
                fetch(f"{url}/nowhere"),
                fetch(f"{url}/elsewhere", data=b"{}"),
                fetch(f"{url}/save", data=save.encode()),
            ]
    finally:
        for server in servers.values():
            server.shutdown()
            server.server_close()
    got, want = replies["port"], replies["jax"]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert [r[0] for r in got] == [200, 200, 200, 200, 404, 404, 404, 200]
    assert got[0][2] == want[0][2] == papp._PAGE.encode()
    for i in (1, 2, 3):
        assert_same_load(json.loads(got[i][2]), json.loads(want[i][2]))
    for i in (4, 5, 6):
        assert json.loads(got[i][2]) == json.loads(want[i][2])
    assert "out of range" in json.loads(got[4][2])["error"]
    paths = {side: json.loads(r[7][2])["saved"]
             for side, r in replies.items()}
    assert paths["port"] == os.path.join(roots["port"], "counterfactuals",
                                         "0", "3.pkl")
    assert_same_record(saved_record(paths["port"]),
                       saved_record(paths["jax"]))


def test_cli_serves_the_backend(trees, monkeypatch):
    """``python -m creste_public_tpu_torch.annotation.app`` builds the
    backend from its flags and serves it until stopped."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_serve_forever(self):
        seen["address"] = self.server_address
        seen["handler"] = self.RequestHandlerClass
        raise Stop

    monkeypatch.setattr(HTTPServer, "serve_forever", fake_serve_forever)
    with pytest.raises(Stop):
        papp.main(["--root", trees["poses"], "--port", "0", "--host",
                   "127.0.0.1", "--sampler", "unicycle",
                   "--num_candidates", "3"])
    assert seen["address"][0] == "127.0.0.1"
    assert issubclass(seen["handler"], papp.BaseHTTPRequestHandler)
