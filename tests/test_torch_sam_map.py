"""The port's BEV SAM maps (``preprocessing/sam_map.py``) against the JAX
package's, and its DBSCAN against sklearn's, on seeded NumPy inputs.

Bars, all exact: the DBSCAN labels (the torch version on the CPU and the
plain NumPy one) equal ``sklearn.cluster.DBSCAN(eps, min_samples)
.fit_predict`` on clouds in f32 and f64 and on a 0.1 m lattice, where
neighbours sit at exactly eps and the f64 comparison decides; the
ensemble, the dynamic map (RANSAC, DBSCAN, instance matching, majority
maps) and the static horizon maps equal the JAX package's.
"""
import numpy as np
import pytest
from sklearn.cluster import DBSCAN

from creste_public_tpu.preprocessing import sam_map as jsm
from creste_public_tpu_torch.preprocessing import sam_map as sm
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401


def blobs(seed: int, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-3, 3, (6, 3))
    pts = np.concatenate([c + rng.normal(size=(int(rng.integers(5, 120)), 3))
                          * rng.uniform(0.03, 0.3) for c in centres])
    noise = rng.uniform(-4, 4, (40, 3))
    return rng.permutation(np.concatenate([pts, noise])).astype(dtype)


def lattice(seed: int, offset: float = 0.0, dtype=np.float32) -> np.ndarray:
    """A 0.1 m lattice with holes: axis neighbours at exactly eps=0.1 in
    decimal, on either side of it in binary."""
    g = np.stack(np.meshgrid(np.arange(7), np.arange(6), np.arange(3),
                             indexing="ij"), -1).reshape(-1, 3)
    keep = np.random.default_rng(seed).uniform(size=len(g)) > 0.3
    return (g[keep] * 0.1 + offset).astype(dtype)


CLOUDS = {
    "blobs32": lambda: blobs(0), "blobs64": lambda: blobs(1, np.float64),
    "lattice32": lambda: lattice(2), "lattice64": lambda: lattice(
        3, dtype=np.float64), "lattice_off": lambda: lattice(4, 0.3,
                                                             np.float64)}


@pytest.mark.parametrize("eps", [0.1, 0.2, 0.3])
@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_dbscan_matches_sklearn(cloud, eps):
    pts = CLOUDS[cloud]()
    for min_samples in (3, 5):
        want = DBSCAN(eps=eps, min_samples=min_samples).fit_predict(pts)
        got = sm.dbscan(pts, eps, min_samples, device="cpu")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            sm.dbscan_plain(pts, eps, min_samples), want)


def test_dbscan_lattice_ties_decide():
    """On the lattice eps=0.1 sits at the neighbour distance: the clusters
    there differ from those at eps slightly above it, so the tie rule is
    what the equality above checks."""
    pts = lattice(3, dtype=np.float64)
    at = DBSCAN(eps=0.1, min_samples=3).fit_predict(pts)
    above = DBSCAN(eps=0.1 + 1e-9, min_samples=3).fit_predict(pts)
    assert not np.array_equal(at, above)


def test_dbscan_edge_cases():
    assert sm.dbscan(np.zeros((0, 3)), 0.1, device="cpu").shape == (0,)
    np.testing.assert_array_equal(
        sm.dbscan(np.eye(3), 0.1, device="cpu"), [-1, -1, -1])


def dynamic_scene(seed: int):
    """A ground plane, boxes and labels as the dynamic path sees them."""
    rng = np.random.default_rng(seed)
    ground = np.stack([rng.uniform(-3, 3, 3000), rng.uniform(-3, 3, 3000),
                       rng.normal(size=3000) * 0.02], -1)
    boxes = np.concatenate([
        c + rng.uniform(-0.3, 0.3, (250, 3)) * [1, 1, 2]
        for c in ([1.0, 1.0, 0.6], [-1.5, 0.5, 0.6], [0.5, -2.0, 0.4])])
    pts = np.concatenate([ground, boxes]).astype(np.float32)
    inst = np.zeros(len(pts), np.int64)
    cls = np.zeros(len(pts), np.int64)
    for k in range(3):
        sl = slice(3000 + 250 * k, 3000 + 250 * (k + 1))
        inst[sl] = np.where(rng.uniform(size=250) < 0.8, k + 1, 0)
        cls[sl] = k + 2
    return pts, inst, cls


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_sam_map_matches_jax(seed):
    pts, inst, cls = dynamic_scene(seed)
    clusters_j = jsm.dbscan_ensemble(pts)
    np.testing.assert_array_equal(
        sm.dbscan_ensemble(pts, device="cpu"), clusters_j)
    assert clusters_j.max() >= 3
    want = jsm.dynamic_sam_map(pts, inst, cls, 32, 3.2)
    got = sm.dynamic_sam_map(pts, inst, cls, 32, 3.2, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(want[..., 0])) >= {1, 2, 3}


def test_host_helpers_match_jax():
    """RANSAC with its seeded generator, cluster-instance matching, the
    majority map's tie-break, merging and compaction."""
    pts, inst, cls = dynamic_scene(2)
    np.testing.assert_array_equal(sm.remove_ground_plane(pts),
                                  jsm.remove_ground_plane(pts))
    rng = np.random.default_rng(5)
    clusters = rng.integers(0, 9, len(pts))
    np.testing.assert_array_equal(
        sm.match_clusters_to_instances(clusters, inst),
        jsm.match_clusters_to_instances(clusters, inst))
    labels = rng.integers(0, 4, len(pts))
    np.testing.assert_array_equal(sm.majority_label_map(pts, labels, 16, 3.2),
                                  jsm.majority_label_map(pts, labels, 16, 3.2))
    a = rng.integers(0, 5, (16, 16)).astype(np.int32)
    b = rng.integers(0, 7, (16, 16)).astype(np.int32)
    got, want = sm.merge_instance_maps(a, b, 9), jsm.merge_instance_maps(a, b,
                                                                         9)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(sm.make_labels_contiguous(b * 3),
                                  jsm.make_labels_contiguous(b * 3))


def test_static_horizon_map_matches_jax():
    """Three frames of per-pixel instances lifted through their depth and
    pose-chained p2p, merged anchor-first, with a static mask."""
    rng = np.random.default_rng(6)
    H, W = 16, 20
    p2p = np.linalg.inv(np.array([[0, -18.0, 10, 0], [0, 0, -18, 8],
                                  [1.0, 0, 0, 0], [0, 0, 0, 1]]))
    frames, masks = [], []
    for k in range(3):
        sam = np.repeat(np.repeat(rng.integers(0, 5, (4, 5)), 4, 0), 4, 1)
        depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
        pose = np.eye(4)
        pose[0, 3] = 0.2 * k
        frames.append((sam, depth, pose @ p2p))
        masks.append(rng.uniform(size=(H, W)) > 0.2)
    for kw in ({}, {"static_masks": masks}):
        want = jsm.static_bev_map_horizon(frames, 16, 3.2, **kw)
        got = sm.static_bev_map_horizon(frames, 16, 3.2, **kw)
        np.testing.assert_array_equal(got, want)
        assert (want > 0).sum() > 20
