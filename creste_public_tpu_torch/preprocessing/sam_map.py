"""BEV SAM instance maps (static and dynamic labels).

Counterpart of ``creste_public_tpu/preprocessing/sam_map.py`` (reference
scripts/preprocessing/build_sam_map.py):
  * static path (:906, loop 736-783): per-frame image instances are lifted
    to the BEV grid through the depth horizon, then merged across the
    horizon by greedy label overlap (``compute_label_mapping``:158,
    ``merge_maps``:233);
  * dynamic path (:635, ``cluster_xyz_labels``:413-588): ground-plane
    removal, a multi-eps DBSCAN ensemble over the LiDAR points, clusters
    matched to image instances by majority label -> a 3-channel map
    (instance, class, occupancy).

The reference ran DBSCAN on the GPU with cuml and the JAX package runs
sklearn's. Here it runs in torch on ``device`` (``dbscan``), numbered
exactly as sklearn numbers it; ``dbscan_plain`` is the same algorithm in
NumPy, sklearn's own loop, kept for the tests. The rest is host NumPy:
RANSAC keeps its seeded generator.
"""
from __future__ import annotations

import numpy as np
import torch

from creste_public_tpu_torch.utils.device import resolve_device

Array = np.ndarray


def bev_cell_ids(
    points: Array, grid: int, map_range: float
) -> tuple[Array, Array]:
    """LiDAR xy -> linearised BEV cell ids + in-range mask."""
    voxel = 2 * map_range / grid
    row = np.floor((points[:, 0] + map_range) / voxel).astype(np.int64)
    col = np.floor((points[:, 1] + map_range) / voxel).astype(np.int64)
    ok = (row >= 0) & (row < grid) & (col >= 0) & (col < grid)
    return row * grid + col, ok


def majority_label_map(
    points: Array, labels: Array, grid: int, map_range: float,
    ignore: int = 0,
) -> Array:
    """[N,3] points + [N] int labels -> [grid, grid] majority-vote label map
    (0 = empty/ignore)."""
    cell, ok = bev_cell_ids(points, grid, map_range)
    ok = ok & (labels != ignore)
    if not ok.any():
        return np.zeros((grid, grid), np.int32)
    cell, labels = cell[ok], labels[ok]
    # majority by counting (cell, label) pairs
    key = cell * (labels.max() + 1) + labels
    uniq, counts = np.unique(key, return_counts=True)
    u_cell = uniq // (labels.max() + 1)
    u_label = uniq % (labels.max() + 1)
    # later writes win: ascending count, and within equal counts descending
    # label so the SMALLEST label lands last — the reference's argmax
    # tie-break (utils.py:105-123), pinned by the reference-exec golden
    order = np.lexsort((-u_label, counts))
    out = np.zeros((grid * grid,), np.int32)
    out[u_cell[order]] = u_label[order]
    return out.reshape(grid, grid)


def label_overlap_mapping(
    anchor: Array, new: Array, ignore: int = 0
) -> dict[int, int]:
    """For each label in ``new``, the anchor label it overlaps most
    (build_sam_map.py:158-204). Labels with zero overlap are absent."""
    mask = (anchor != ignore) & (new != ignore)
    if not mask.any():
        return {}
    pairs = np.stack([new[mask], anchor[mask]], axis=1)
    uniq, counts = np.unique(pairs, axis=0, return_counts=True)
    mapping: dict[int, int] = {}
    best: dict[int, int] = {}
    for (nl, al), c in zip(uniq, counts):
        if c > best.get(int(nl), 0):
            best[int(nl)] = int(c)
            mapping[int(nl)] = int(al)
    return mapping


def merge_instance_maps(
    anchor: Array, new: Array, next_label: int, ignore: int = 0
) -> tuple[Array, int]:
    """Merge ``new`` into ``anchor``: overlapping labels adopt the anchor
    id, novel labels get fresh ids from ``next_label`` upward; anchor
    pixels win on conflict (build_sam_map.py:233-310 semantics)."""
    mapping = label_overlap_mapping(anchor, new, ignore)
    out = anchor.copy()
    remapped = np.zeros_like(new)
    for label in np.unique(new):
        if label == ignore:
            continue
        if int(label) in mapping:
            remapped[new == label] = mapping[int(label)]
        else:
            remapped[new == label] = next_label
            next_label += 1
    fill = (out == ignore) & (remapped != ignore)
    out[fill] = remapped[fill]
    return out, next_label


def accumulate_instance_maps(maps: list[Array], ignore: int = 0) -> Array:
    """Temporal greedy merge over a frame horizon (loop at
    build_sam_map.py:736-783)."""
    if not maps:
        raise ValueError("no maps")
    out = maps[0].astype(np.int32).copy()
    next_label = int(out.max()) + 1
    for m in maps[1:]:
        out, next_label = merge_instance_maps(
            out, m.astype(np.int32), next_label, ignore
        )
    return out


def make_labels_contiguous(label_map: Array, ignore: int = 0) -> Array:
    """Compact label ids to 0..K (reference utils.make_labels_contiguous_
    vectorized); ignore stays 0."""
    uniq = np.unique(label_map)
    uniq = uniq[uniq != ignore]
    out = np.zeros_like(label_map)
    for new, old in enumerate(uniq, start=1):
        out[label_map == old] = new
    return out


def backproject_depth_image(depth_m: Array, p2p: Array) -> Array:
    """Dense depth image -> LiDAR-frame points (Camera2World semantics,
    splat_projection.py:12-51, NumPy host-side).

    depth_m: [H, W] metres; p2p: [4, 4]. Returns [H, W, 3].
    """
    H, W = depth_m.shape
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d = depth_m.astype(np.float64)
    pix = np.stack([u * d, v * d, d, np.ones_like(d)], axis=-1)
    xyz = np.einsum("ij,hwj->hwi", p2p.astype(np.float64), pix)
    return xyz[..., :3]


def static_bev_map(
    sam_img: Array,
    depth_m: Array,
    p2p: Array,
    grid: int,
    map_range: float,
    height_range: tuple[float, float] = (-1.5, 1.0),
    depth_range: tuple[float, float] = (0.0, 12.8),
    static_mask: Array | None = None,
) -> Array:
    """One frame's per-pixel SAM instances lifted to the BEV grid through
    the depth horizon (compute_sam_map_single, build_sam_map.py:720-760).

    Args:
      sam_img: [H, W] per-pixel instance ids (0 = unlabeled).
      depth_m: [H, W] dense metric depth (metres) at the same resolution.
      p2p: [4, 4] pixel->anchor-LiDAR transform (pose-chained for horizon
        frames: inv(pose_anchor) @ pose_frame @ p2p_frame).
      static_mask: optional [H, W] bool — True where the pixel is static
        (the reference's mv_mask = dynamic_label == 0, :742).

    Returns [grid, grid] contiguous instance labels (0 = empty).
    """
    xyz = backproject_depth_image(depth_m, p2p).reshape(-1, 3)
    labels = sam_img.reshape(-1).astype(np.int64)
    mask = (
        (depth_m.reshape(-1) > depth_range[0])
        & (depth_m.reshape(-1) < depth_range[1])
        & (xyz[:, 2] > height_range[0])
        & (xyz[:, 2] < height_range[1])
    )
    if static_mask is not None:
        mask &= static_mask.reshape(-1)
    m = majority_label_map(xyz[mask], labels[mask], grid, map_range)
    return make_labels_contiguous(m)


def static_bev_map_horizon(
    frames: list[tuple[Array, Array, Array]],
    grid: int,
    map_range: float,
    static_masks: list[Array] | None = None,
    **kwargs,
) -> Array:
    """Depth-horizon static SAM map: per-frame BEV lifts greedily merged,
    anchor (frames[0]) first (the loop at build_sam_map.py:736-783).

    frames: [(sam_img, depth_m, p2p_into_anchor), ...] with the anchor at
    index 0 (the reference reorders horizon_ids anchor-first, :734-736).
    """
    maps = []
    for i, (sam_img, depth_m, p2p) in enumerate(frames):
        sm = static_masks[i] if static_masks is not None else None
        maps.append(static_bev_map(sam_img, depth_m, p2p, grid, map_range,
                                   static_mask=sm, **kwargs))
    return accumulate_instance_maps(maps)


def remove_ground_plane(
    points: Array, z_threshold: float = 0.15, iterations: int = 50,
    seed: int = 0,
) -> Array:
    """RANSAC plane removal (open3d equivalent, build_sam_map.py:330):
    returns a boolean mask of NON-ground points."""
    rng = np.random.default_rng(seed)
    n = len(points)
    if n < 10:
        return np.ones((n,), bool)
    best_inliers = np.zeros((n,), bool)
    for _ in range(iterations):
        idx = rng.choice(n, 3, replace=False)
        p0, p1, p2 = points[idx, :3]
        normal = np.cross(p1 - p0, p2 - p0)
        nn = np.linalg.norm(normal)
        if nn < 1e-9:
            continue
        normal = normal / nn
        if abs(normal[2]) < 0.8:  # require near-horizontal plane
            continue
        dist = np.abs((points[:, :3] - p0) @ normal)
        inliers = dist < z_threshold
        if inliers.sum() > best_inliers.sum():
            best_inliers = inliers
    return ~best_inliers


def _neighbour_pairs(x: torch.Tensor, eps: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every pair (i, j), i == j included, whose squared distance in f64,
    summed as sklearn's KD tree sums it ((dx*dx + dy*dy) + dz*dz, each
    product rounded), is at most ``eps * eps``.

    The points are hashed to cubic cells a hair wider than eps, so every
    such pair lies in one of the 27 cells around a point; the candidates
    of each offset are enumerated from the cell-sorted order and tested
    exactly."""
    n = x.shape[0]
    r2 = float(eps) * float(eps)
    g = torch.floor(x / (float(eps) * (1.0 + 1e-6))).long()
    g = g - g.min(dim=0).values + 1
    dims = g.max(dim=0).values + 2
    key = (g[:, 0] * dims[1] + g[:, 1]) * dims[2] + g[:, 2]
    order = torch.argsort(key)
    skey = key[order]
    rows, cols = [], []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                nk = key + (ox * dims[1] + oy) * dims[2] + oz
                lo = torch.searchsorted(skey, nk)
                cnt = torch.searchsorted(skey, nk, right=True) - lo
                i = torch.repeat_interleave(
                    torch.arange(n, device=x.device), cnt)
                first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt,
                                                cnt)
                j = order[torch.repeat_interleave(lo, cnt)
                          + torch.arange(i.numel(), device=x.device) - first]
                d = x[i] - x[j]
                d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                d2 = d2 + d[:, 2] * d[:, 2]
                near = d2 <= r2
                rows.append(i[near])
                cols.append(j[near])
    return torch.cat(rows), torch.cat(cols)


def dbscan(points, eps: float, min_samples: int = 5,
           device: str | torch.device = "cuda") -> Array:
    """sklearn's ``DBSCAN(eps, min_samples).fit_predict(points)`` on
    ``device``: [N] int64 labels, -1 = noise.

    A point is core when at least ``min_samples`` points (itself counted)
    lie within ``eps``: the squared distance in f64 at most ``eps**2``, as
    sklearn's KD tree compares (``_neighbour_pairs``). Clusters are the
    connected components of the core points (min-label propagation over
    the neighbour pairs, with pointer jumping) numbered in the order of
    each component's smallest core index, and a border point takes the
    lowest-numbered cluster among its core neighbours: the order in which
    sklearn's loop labels them. (Below 12 points sklearn searches by brute
    force, whose GEMM rounds the distances otherwise; only a pair at
    exactly eps can tell the two apart.)
    """
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(points)[:, :3]).to(dev).double()
    n = x.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    i, j = _neighbour_pairs(x, eps)
    core = torch.bincount(i, minlength=n) >= min_samples
    core_idx = torch.nonzero(core).squeeze(1)
    if core_idx.numel() == 0:
        return np.full((n,), -1, np.int64)
    to_core = core[j]
    i, j = i[to_core], j[to_core]
    cc = core[i]
    ci, cj = i[cc], j[cc]
    lab = torch.arange(n, device=dev)
    while True:
        new = lab.clone()
        new.scatter_reduce_(0, ci, lab[cj], "amin")
        new = new[new]
        if torch.equal(new, lab):
            break
        lab = new
    _, cluster = torch.unique(lab[core_idx], return_inverse=True)
    out = torch.full((n,), -1, dtype=torch.long, device=dev)
    out[core_idx] = cluster
    bi, bj = i[~cc], j[~cc]
    border = torch.full((n,), n, dtype=torch.long, device=dev)
    border.scatter_reduce_(0, bi, out[bj], "amin")
    out = torch.where(~core & (border < n), border, out)
    return out.cpu().numpy()


def dbscan_plain(points, eps: float, min_samples: int = 5) -> Array:
    """The same labels in NumPy, a witness independent of ``dbscan``:
    neighbourhoods by the same f64 squared distances, the candidates of
    each row taken from a window of the x-sorted order a hair wider than
    eps, then sklearn's own loop (``_dbscan_inner``): clusters grown
    depth-first from each unlabelled core point in index order."""
    x = np.asarray(points, np.float64)[:, :3]
    n = len(x)
    r2 = float(eps) * float(eps)
    reach = float(eps) * (1.0 + 1e-6)
    order = np.argsort(x[:, 0], kind="stable")
    xs = x[order, 0]
    hoods: list = [None] * n
    for s in range(0, n, 1024):
        rows = order[s:s + 1024]
        lo = np.searchsorted(xs, xs[s] - reach)
        hi = np.searchsorted(xs, xs[s + len(rows) - 1] + reach, side="right")
        cand = order[lo:hi]
        d2 = None
        for k in range(x.shape[1]):
            d = x[rows, k, None] - x[None, cand, k]
            d2 = d * d if d2 is None else d2 + d * d
        for r, row in zip(rows, d2):
            hoods[r] = cand[row <= r2]
    core = np.array([len(h) >= min_samples for h in hoods], bool)
    labels = np.full((n,), -1, np.int64)
    label = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        stack = [i]
        while stack:
            k = stack.pop()
            if labels[k] != -1:
                continue
            labels[k] = label
            if core[k]:
                h = hoods[k]
                stack.extend(h[labels[h] == -1].tolist())
        label += 1
    return labels


def dbscan_ensemble(points: Array, eps_list=(0.1, 0.2, 0.3),
                    min_samples: int = 5,
                    device: str | torch.device = "cuda") -> Array:
    """Multi-eps DBSCAN ensemble (build_sam_map.py:413-588): clusters from
    the finest eps; points that are noise at a finer eps take the label of
    the next coarser clustering, offset to stay unique. Returns [N]
    cluster ids, 0 = noise."""
    n = len(points)
    out = np.zeros((n,), np.int64)
    offset = 1
    unassigned = np.ones((n,), bool)
    for eps in eps_list:
        if not unassigned.any():
            break
        sub = np.nonzero(unassigned)[0]
        labels = dbscan(points[sub, :3], eps, min_samples, device)
        got = labels >= 0
        out[sub[got]] = labels[got] + offset
        if got.any():
            offset = int(out.max()) + 1
        unassigned[sub[got]] = False
    return out


def match_clusters_to_instances(
    cluster_ids: Array, point_instance: Array, ignore: int = 0
) -> Array:
    """Assign each 3-D cluster the image-instance id its points vote for
    (IoU-majority matching, build_sam_map.py:413-588)."""
    out = np.zeros_like(point_instance)
    for cid in np.unique(cluster_ids):
        if cid == 0:
            continue
        members = cluster_ids == cid
        votes = point_instance[members]
        votes = votes[votes != ignore]
        if len(votes) == 0:
            continue
        vals, counts = np.unique(votes, return_counts=True)
        out[members] = vals[np.argmax(counts)]
    return out


def dynamic_sam_map(
    points: Array,
    point_instance: Array,
    point_class: Array,
    grid: int,
    map_range: float,
    eps_list=(0.1, 0.2, 0.3),
    device: str | torch.device = "cuda",
) -> Array:
    """Full dynamic-label pipeline -> [grid, grid, 3]
    (instance, class, occupancy) (build_sam_map.py:635-712)."""
    keep = remove_ground_plane(points)
    pts = points[keep]
    inst = point_instance[keep]
    cls = point_class[keep]
    clusters = dbscan_ensemble(pts, eps_list, device=device)
    inst_clean = match_clusters_to_instances(clusters, inst)
    inst_map = majority_label_map(pts, inst_clean, grid, map_range)
    cls_map = majority_label_map(pts, cls, grid, map_range)
    occ = (inst_map > 0).astype(np.int32)
    return np.stack([inst_map, cls_map, occ], axis=-1)
