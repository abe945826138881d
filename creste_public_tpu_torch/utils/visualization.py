"""Visualization library: BEV labels/policies/poses, depth colorizers,
feature PCA-RGB.

A copy of ``creste_public_tpu/utils/visualization.py`` (reference
creste/utils/visualization.py: visualize_bev_label:317,
visualize_bev_poses:986, visualize_bev_policy:1025, depth colorizers
:113-198, DINO PCA-RGB :1176), without matplotlib: the colormaps are the
tables of ``utils/colormaps.py`` (the values matplotlib gives), and
``visualize_elevation_3d`` draws its heightfield with PIL. Every function
but that one returns the JAX function's image exactly; every function
returns an HWC uint8 image suitable for MetricLogger.log_image / PNG
writing.
"""
from __future__ import annotations

import numpy as np
import torch
from PIL import Image, ImageDraw

from creste_public_tpu_torch.utils.colormaps import COLORMAPS
from creste_public_tpu_torch.utils.geometry import backproject_depth

Array = np.ndarray

# 8-connected action deltas, matching ops.value_iteration.DYNAMICS order
_ACTIONS = np.array(
    [[-1, -1], [-1, 0], [-1, 1], [0, -1], [0, 1], [1, -1], [1, 0], [1, 1]]
)


def _colormap(name: str, n: int = 256) -> np.ndarray:
    """matplotlib's ``name`` at ``n`` entries as uint8 RGB, from the
    tables of ``utils/colormaps.py``."""
    lut = COLORMAPS.get(name)
    if lut is None or len(lut) != n:
        raise ValueError(f"colormap {name!r} at {n} entries is not "
                         f"tabulated (utils/colormaps.py)")
    return lut.copy()


def instance_cmap(n: int, seed: int = 0) -> np.ndarray:
    """Stable random colors per instance id; id 0 is black."""
    rng = np.random.default_rng(seed)
    cmap = rng.integers(40, 255, (max(n, 1), 3)).astype(np.uint8)
    cmap[0] = 0
    return cmap


def colorize_depth(
    depth_m: Array, max_depth: float = 25.6, cmap: str = "turbo"
) -> Array:
    """[H, W] metres -> uint8 RGB; invalid (0) pixels black
    (visualization.py:113-198)."""
    lut = _colormap(cmap)
    idx = np.clip(depth_m / max_depth * 255, 0, 255).astype(np.uint8)
    img = lut[idx]
    img[depth_m <= 0] = 0
    return img


def colorize_scalar(
    x: Array, vmin: float | None = None, vmax: float | None = None,
    cmap: str = "viridis",
) -> Array:
    """Generic [H, W] scalar map -> uint8 RGB (reward/value/SVF renders)."""
    finite = np.isfinite(x)
    if vmin is None:
        vmin = float(np.min(x[finite])) if finite.any() else 0.0
    if vmax is None:
        vmax = float(np.max(x[finite])) if finite.any() else 1.0
    vmin, vmax = float(vmin), float(vmax)
    t = np.clip((x - vmin) / max(vmax - vmin, 1e-9), 0, 1)
    img = _colormap(cmap)[np.clip((t * 255), 0, 255).astype(np.uint8)]
    img[~finite] = 0
    return img


def visualize_bev_label(
    label: Array, kind: str = "instance", num_classes: int | None = None
) -> Array:
    """BEV label map -> RGB (visualize_bev_label:317 dispatcher).

    kind: 'instance' (random per-id colors), 'semantic' (tab20 classes),
    'elevation' (2-ch min/max -> red/green ramp).
    """
    if kind == "elevation":
        lo = colorize_scalar(label[..., 0], cmap="viridis")
        hi = colorize_scalar(label[..., 1], cmap="magma")
        return np.concatenate([lo, hi], axis=1)
    label = np.asarray(label)
    if label.ndim == 3:
        label = label[..., 0]
    label = label.astype(np.int64)
    n = int(label.max()) + 1 if num_classes is None else num_classes
    if kind == "semantic":
        base = _colormap("tab20", 20)
        cmap = base[np.arange(max(n, 1)) % 20]
        cmap[0] = 0
    else:
        cmap = instance_cmap(n)
    return cmap[np.clip(label, 0, len(cmap) - 1)]


def overlay_trajectory(
    img: Array, traj_rc: Array, color=(255, 40, 40), radius: int = 1
) -> Array:
    """Draw (row, col) waypoints onto an RGB image
    (visualize_bev_poses:986)."""
    out = img.copy()
    H, W = out.shape[:2]
    for r, c in np.asarray(traj_rc).reshape(-1, 2):
        r, c = int(round(r)), int(round(c))
        r0, r1 = max(r - radius, 0), min(r + radius + 1, H)
        c0, c1 = max(c - radius, 0), min(c + radius + 1, W)
        if r0 < r1 and c0 < c1:
            out[r0:r1, c0:c1] = color
    return out


def visualize_bev_poses(
    bev_rgb: Array, poses: Array, color=(255, 40, 40)
) -> Array:
    """SE(2) pose chain [T, 3, 3] drawn on a BEV render."""
    traj = poses[:, :2, 2]
    return overlay_trajectory(bev_rgb, traj, color)


def visualize_bev_policy(
    policy: Array, stride: int = 4
) -> Array:
    """[H, W, A] softmax policy -> RGB with argmax-action arrows rendered
    as directional strokes (visualize_bev_policy:1025)."""
    H, W, A = policy.shape
    conf = policy.max(-1)
    img = colorize_scalar(conf, 0, 1, cmap="viridis")
    act = policy.argmax(-1)
    for r in range(0, H, stride):
        for c in range(0, W, stride):
            dr, dc = _ACTIONS[act[r, c]]
            for s in range(stride // 2):
                rr, cc = r + dr * s, c + dc * s
                if 0 <= rr < H and 0 <= cc < W:
                    img[rr, cc] = (255, 255, 255)
    return img


def visualize_reward(reward: Array, fov_mask: Array | None = None) -> Array:
    img = colorize_scalar(reward, cmap="inferno")
    if fov_mask is not None:
        img[~fov_mask.astype(bool)] //= 4
    return img


def features_to_rgb(feats: Array) -> Array:
    """[H, W, D] features -> PCA-RGB uint8 (visualization.py:1176)."""
    H, W, D = feats.shape
    flat = feats.reshape(-1, D)
    flat = flat - flat.mean(0)
    # top-3 principal directions
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    rgb = flat @ vt[:3].T
    lo, hi = rgb.min(0), rgb.max(0)
    rgb = (rgb - lo) / np.maximum(hi - lo, 1e-8)
    return (rgb.reshape(H, W, 3) * 255).astype(np.uint8)


def show_elevation_map(
    elevation: Array, color_scale: str = "relative",
    abs_range: tuple[float, float] = (-2.0, 8.0),
) -> Array:
    """[H, W] elevation -> TURBO-colorized uint8 RGB
    (reference visualization.py:484-530; inf/nan cells zeroed).

    color_scale 'relative' normalises to the current min/max; 'absolute'
    clips to ``abs_range`` first.
    """
    e = np.asarray(elevation, np.float32).copy()
    e[~np.isfinite(e)] = 0.0
    if color_scale == "relative":
        lo, hi = float(e.min()), float(e.max())
    elif color_scale == "absolute":
        lo, hi = abs_range
        e = np.clip(e, lo, hi)
    else:
        raise ValueError(color_scale)
    norm = (e - lo) / max(hi - lo, 1e-8)
    return (_colormap("turbo")[np.clip(norm * 255, 0, 255).astype(np.uint8)])


# the panel of one map: matplotlib's figsize 4 at dpi 80 in the JAX package
_PANEL = 320
# matplotlib's default 3-D box aspect (x : y : z = 4 : 4 : 3)
_BOX = (1.0, 1.0, 0.75)


def visualize_elevation_3d(
    elevation_pred: Array,
    elevation_gt: Array | None = None,
    fill_value: float = -0.8,
    elev_deg: float = 55.0,
    azim_deg: float = -90.0,
) -> Array:
    """3-D heightfield render of (pred[, gt]) elevation maps -> uint8 RGB
    [320, 320 * n_maps, 3], pred left, GT right, on white.

    Reference: visualize_elevation_3d_wrapper (visualization.py:811-880)
    renders TURBO-colored heightfield meshes for pred and GT side by side.
    The JAX package draws a matplotlib 3-D surface; this draws the same
    surface with PIL, with the same shape: per map a 320x320 panel, the
    surface on the ``rstride = cstride = 2`` grid (the last row and column
    included, as matplotlib samples it) as flat quads, each in the turbo
    colour of its first corner over the maps' common (min, max), in
    matplotlib's 4 : 4 : 3 box, seen orthographically from ``elev_deg``
    above the grid at ``azim_deg`` (-90: row 0 nearest the viewer, at the
    bottom), painted back to front without shading or antialiasing, no
    axes and no titles. Its pixels are not matplotlib's. Non-finite cells
    are filled with ``fill_value`` (the reference's -0.8 floor).
    """
    maps = [np.asarray(elevation_pred, np.float32)]
    if elevation_gt is not None:
        maps.append(np.asarray(elevation_gt, np.float32))
    maps = [np.where(np.isfinite(m), m, fill_value) for m in maps]
    lo = min(float(m.min()) for m in maps)
    hi = max(float(m.max()) for m in maps)
    lut = _colormap("turbo")
    panels = [_heightfield_panel(m, lo, hi, lut, elev_deg, azim_deg)
              for m in maps]
    return np.concatenate(panels, axis=1)


def _heightfield_panel(m: Array, lo: float, hi: float, lut: Array,
                       elev_deg: float, azim_deg: float) -> Array:
    H, W = m.shape
    norm = (m - lo) / max(hi - lo, 1e-8)
    colors = lut[np.clip(norm * 255, 0, 255).astype(np.uint8)]
    rows = np.array(sorted(set(range(0, H - 1, 2)) | {H - 1}))
    cols = np.array(sorted(set(range(0, W - 1, 2)) | {W - 1}))
    # the grid in the unit box: x along columns, y along rows, z up, each
    # centred; z over matplotlib's zlim (lo, hi + 1e-3)
    x = (cols / max(W - 1, 1) - 0.5) * _BOX[0]
    y = (rows / max(H - 1, 1) - 0.5) * _BOX[1]
    z = ((m[np.ix_(rows, cols)] - lo) / (hi + 1e-3 - lo) - 0.5) * _BOX[2]
    X, Y = np.meshgrid(x, y)
    # rotate the azimuth to -90 (the viewer on the -y side), then tilt
    a = np.deg2rad(azim_deg + 90.0)
    e = np.deg2rad(elev_deg)
    xr = X * np.cos(a) + Y * np.sin(a)
    yr = -X * np.sin(a) + Y * np.cos(a)
    sx = xr
    sy = yr * np.sin(e) + z * np.cos(e)
    depth = yr * np.cos(e) - z * np.sin(e)
    half = 0.5 * np.hypot(_BOX[0], _BOX[1]) * 1.02
    scale = (_PANEL / 2) / max(half, half * np.sin(e)
                               + 0.5 * _BOX[2] * np.cos(e))
    px = _PANEL / 2 + sx * scale
    py = _PANEL / 2 - sy * scale
    # quads between neighbouring grid points, farthest first
    qd = (depth[:-1, :-1] + depth[:-1, 1:] + depth[1:, :-1]
          + depth[1:, 1:]) / 4
    order = np.argsort(-qd, axis=None, kind="stable")
    nc = len(cols) - 1
    img = Image.new("RGB", (_PANEL, _PANEL), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    for q in order:
        i, j = divmod(int(q), nc)
        corners = [(px[i, j], py[i, j]), (px[i, j + 1], py[i, j + 1]),
                   (px[i + 1, j + 1], py[i + 1, j + 1]),
                   (px[i + 1, j], py[i + 1, j])]
        fill = tuple(int(c) for c in colors[rows[i], cols[j]])
        draw.polygon(corners, fill=fill)
    return np.asarray(img)


def draw_bev_heatmap(
    heatmap: Array, img: Array, cmap: str = "inferno", alpha: float = 0.6
) -> Array:
    """Blend a scalar BEV heatmap over an RGB image
    (reference visualization.py:939-957)."""
    base = np.asarray(img)
    if base.ndim == 2:
        base = np.stack([base] * 3, -1)
    base = base.astype(np.float32)
    if base.max() <= 1.0:
        base = base * 255.0
    hm = colorize_scalar(np.asarray(heatmap, np.float32), cmap=cmap)
    out = (1 - alpha) * base + alpha * hm.astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


def visualize_dino_feature(rgb: Array, feats: Array) -> Array:
    """RGB | PCA-RGB feature composite (visualization.py:1176-1221)."""
    img = np.asarray(rgb)
    if img.max() <= 1.0:
        img = (img * 255).astype(np.uint8)
    fr = features_to_rgb(np.asarray(feats))
    if fr.shape[:2] != img.shape[:2]:
        fr = np.asarray(Image.fromarray(fr).resize(
            (img.shape[1], img.shape[0]), Image.BILINEAR))
    return side_by_side(img.astype(np.uint8), fr)


def save_preds_composite(
    rgb: Array, depth: Array, reward: Array | None = None,
    fov_mask: Array | None = None,
) -> Array:
    """Multi-panel input/prediction composite (save_preds_image,
    visualization.py:69-111): RGB | colorized depth [| reward]."""
    panels = [
        (np.asarray(rgb) * 255).astype(np.uint8)
        if np.asarray(rgb).max() <= 1.0 else np.asarray(rgb).astype(np.uint8),
        colorize_depth(np.asarray(depth)),
    ]
    if reward is not None:
        panels.append(visualize_reward(np.asarray(reward), fov_mask))
    return side_by_side(*panels)


def draw_sparse_depth_on_image(
    rgb: Array, depth_m: Array, max_depth: float = 25.6, radius: int = 1
) -> Array:
    """Scatter colorized sparse-depth pixels over an RGB image
    (visualization.py:163-198)."""
    img = np.asarray(rgb)
    img = ((img * 255) if img.max() <= 1.0 else img).astype(np.uint8).copy()
    d = np.asarray(depth_m, np.float32)
    colors = colorize_depth(d, max_depth)
    ys, xs = np.nonzero(d > 0)
    H, W = d.shape
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            yy = np.clip(ys + dy, 0, H - 1)
            xx = np.clip(xs + dx, 0, W - 1)
            img[yy, xx] = colors[ys, xs]
    return img


def show_bev_map(
    bev_features: Array, bev_densities: Array | None = None
) -> Array:
    """BEV feature-map inspection panel: PCA-RGB features | density
    (reference show_bev_map, visualization.py:228-307)."""
    feats = np.asarray(bev_features)
    if feats.ndim == 4:
        feats = feats[0]
    panels = [features_to_rgb(feats)]
    if bev_densities is not None:
        dens = np.asarray(bev_densities)
        while dens.ndim > 2:
            dens = dens[0] if dens.shape[0] <= 4 else dens[..., 0]
        panels.append(colorize_scalar(dens, cmap="magma"))
    return side_by_side(*panels)


def visualize_action_label(
    pred_actions: Array, gt_actions: Array
) -> Array:
    """Per-step predicted-vs-expert action distribution strips
    (visualization.py:1124-1174): [T, A] each -> stacked heat rows."""
    p = np.asarray(pred_actions, np.float32)
    g = np.asarray(gt_actions, np.float32)
    rows = []
    for m in (p, g):
        m = (m - m.min()) / max(float(m.max() - m.min()), 1e-8)
        img = _colormap("viridis")[np.clip(m * 255, 0, 255).astype(np.uint8)]
        rows.append(np.repeat(np.repeat(img, 8, 0), 8, 1))
    sep = np.full((4, rows[0].shape[1], 3), 255, np.uint8)
    return np.concatenate([rows[0], sep, rows[1]], axis=0)


def visualize_rgbd_bev(
    rgbd: Array, xyz: Array, map_range: float = 12.8, grid: int = 256
) -> Array:
    """Top-down scatter of backprojected RGBD points colored by RGB
    (reference visualize_rgbd_bev, visualization.py:577-667)."""
    img = np.asarray(rgbd)[..., :3].reshape(-1, 3)
    pts = np.asarray(xyz).reshape(-1, 3)
    voxel = 2 * map_range / grid
    r = ((map_range - pts[:, 0]) / voxel).astype(np.int64)
    c = ((map_range - pts[:, 1]) / voxel).astype(np.int64)
    ok = (r >= 0) & (r < grid) & (c >= 0) & (c < grid)
    out = np.zeros((grid, grid, 3), np.uint8)
    colors = ((img * 255) if img.max() <= 1.0 else img).astype(np.uint8)
    out[r[ok], c[ok]] = colors[ok]
    return out


def numpy_to_pcd(points: Array, path: str) -> None:
    """Write an ASCII .pcd point cloud (reference numpy_to_pcd,
    visualization.py:200-226) — viewable in any PCL/CloudCompare tool."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {len(pts)}\nDATA ascii\n"
    )
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, pts, fmt="%.6f")


def show_masks_on_image(
    img: Array, labels: Array, alpha: float = 0.5, seed: int = 0
) -> Array:
    """Blend per-pixel instance labels over an RGB image
    (reference show_masks_on_image, visualization.py:1272-1302)."""
    base = np.asarray(img)
    base = ((base * 255) if base.max() <= 1.0 else base).astype(np.float32)
    lab = np.asarray(labels).astype(np.int64)
    cmap = instance_cmap(int(lab.max()) + 1, seed)
    overlay = cmap[lab].astype(np.float32)
    keep = (lab == 0)[..., None]
    out = np.where(keep, base, (1 - alpha) * base + alpha * overlay)
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_bev_bbox(
    img: Array, bbox: tuple[int, int, int, int],
    color: tuple[int, int, int] = (255, 0, 0), thickness: int = 1,
) -> Array:
    """Draw an axis-aligned box (r0, c0, r1, c1) on a BEV image
    (reference draw_bev_bbox, visualization.py:960-984)."""
    out = np.asarray(img).astype(np.uint8).copy()
    r0, c0, r1, c1 = [int(v) for v in bbox]
    H, W = out.shape[:2]
    r0, r1 = np.clip([r0, r1], 0, H - 1)
    c0, c1 = np.clip([c0, c1], 0, W - 1)
    for t in range(thickness):
        out[np.clip(r0 + t, 0, H - 1), c0:c1 + 1] = color
        out[np.clip(r1 - t, 0, H - 1), c0:c1 + 1] = color
        out[r0:r1 + 1, np.clip(c0 + t, 0, W - 1)] = color
        out[r0:r1 + 1, np.clip(c1 - t, 0, W - 1)] = color
    return out


def draw_text_on_image(
    img: Array, text: str, location: tuple[int, int] = (10, 15),
    color: tuple[int, int, int] = (255, 255, 255),
) -> Array:
    """Rasterize a small text label onto an image (reference
    draw_text_on_image, visualization.py:883-904; PIL replaces cv2)."""
    base = np.asarray(img)
    base = ((base * 255) if base.max() <= 1.0 else base).astype(np.uint8)
    pil = Image.fromarray(base)
    ImageDraw.Draw(pil).text((location[0], location[1] - 10), text,
                             fill=tuple(color))
    return np.asarray(pil)


def side_by_side(*images: Array, pad: int = 2) -> Array:
    """Horizontally concat images of equal height with a divider."""
    h = max(im.shape[0] for im in images)
    parts = []
    for im in images:
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        if im.shape[0] != h:
            reps = np.zeros((h, im.shape[1], 3), im.dtype)
            reps[: im.shape[0]] = im
            im = reps
        parts.append(im)
        parts.append(np.full((h, pad, 3), 255, im.dtype))
    return np.concatenate(parts[:-1], axis=1)


def save_png(path: str, img: Array) -> None:
    Image.fromarray(img).save(path)


def resize_and_pad_image(
    image: Array, max_height: int, max_width: int
) -> Array:
    """Aspect-preserving resize into (max_height, max_width) with centered
    black padding (reference resize_and_pad_image, visualization.py:29-75)."""
    img = np.asarray(image)
    oh, ow = img.shape[:2]
    ratio = min(max_height / oh, max_width / ow)
    nh, nw = int(oh * ratio), int(ow * ratio)
    resized = np.asarray(
        Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    )
    top = (max_height - nh) // 2
    left = (max_width - nw) // 2
    out_shape = (max_height, max_width) + img.shape[2:]
    out = np.zeros(out_shape, img.dtype)
    out[top : top + nh, left : left + nw] = resized
    return out


def _minmax_u8(x: Array) -> Array:
    """Whole-array min-max normalization to uint8 [0, 255] (the cv2
    NORM_MINMAX the reference uses at visualization.py:144-148)."""
    x = np.asarray(x, np.float64)
    lo, hi = x.min(), x.max()
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    return np.round((x - lo) * scale).astype(np.uint8)


def save_depth_color_image(
    rgb: Array, depth: Array, img_path: str, debug: bool = False
) -> Array:
    """Depth-over-RGB composite: depth clipped to 12.8 m, turbo-colored,
    blended 0.8/0.2 over the normalized RGB, written to ``img_path``;
    returns the colorized depth (reference save_depth_color_image,
    visualization.py:133-159)."""
    depth = np.asarray(depth).clip(0, 12.8)
    norm_rgb = _minmax_u8(rgb)
    if norm_rgb.ndim == 2:
        norm_rgb = np.stack([norm_rgb] * 3, -1)
    norm_depth = _colormap("turbo")[_minmax_u8(depth)]
    alpha = 0.2
    blend = np.clip(
        np.round(alpha * norm_rgb.astype(np.float64)
                 + (1 - alpha) * norm_depth.astype(np.float64)),
        0, 255,
    ).astype(np.uint8)
    if debug:
        print("Saving depth color image to", img_path)
    save_png(img_path, blend)
    return norm_depth


def apply_alpha_to_image(
    image: Array, alpha_mask: Array, background: Array
) -> Array:
    """Per-pixel alpha blend of ``image`` over a background color/image
    (reference apply_alpha_to_image, visualization.py:918-937)."""
    alpha = np.expand_dims(np.asarray(alpha_mask), -1)
    return alpha * np.asarray(image) + (1 - alpha) * np.asarray(background)


# LiDAR -> BEV-display transform shared by the 3-D debug views
# (reference visualization.py:540-546 / :725-731): reflect x, then swap
# and negate x/y so forward points up in the rendered image.
_LIDAR2MAP_VIS = np.array(
    [[0, -1, 0, 0], [-1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32
)


def _to_vis_frame(xyz: Array) -> Array:
    pts = np.asarray(xyz, np.float32).reshape(-1, 3).copy()
    pts[:, 0] = -pts[:, 0]
    return pts @ _LIDAR2MAP_VIS[:3, :3].T


def _scatter_topdown(
    xyz: Array, colors: Array | None, size_px: int, half_extent: float,
    center: tuple[float, float] = (0.0, 0.0),
) -> Array:
    """Orthographic top-down rasterization of a colored point cloud (the
    deterministic stand-in for the reference's vispy elevation=90 camera)."""
    pts = np.asarray(xyz, np.float32).reshape(-1, 3)
    scale = size_px / (2 * half_extent)
    cx = (pts[:, 0] - center[0]) * scale + size_px / 2
    cy = size_px / 2 - (pts[:, 1] - center[1]) * scale
    ix = np.floor(cx).astype(np.int64)
    iy = np.floor(cy).astype(np.int64)
    ok = (ix >= 0) & (ix < size_px) & (iy >= 0) & (iy < size_px)
    img = np.zeros((size_px, size_px, 3), np.uint8)
    if colors is None:
        lut = _colormap("turbo")
        z = pts[:, 2]
        zi = _minmax_u8(z) if len(z) else np.zeros(0, np.uint8)
        col = lut[zi]
    else:
        col = np.asarray(colors).reshape(-1, 3)
        if col.dtype != np.uint8:
            col = np.clip(
                col * 255 if col.max() <= 1.0 + 1e-6 else col, 0, 255
            ).astype(np.uint8)
    # later points overwrite earlier ones (painter order, like the scatter)
    img[iy[ok], ix[ok]] = col[ok]
    return img


def visualize_pc_3d(pc: Array, filepath: str | None = None) -> Array:
    """Top-down render of a LiDAR point cloud in the BEV display frame
    (reference visualize_pc_3d, visualization.py:531-577 — vispy camera
    at elevation 90 replaced by a deterministic orthographic raster)."""
    pts = _to_vis_frame(np.asarray(pc)[:, :3])
    img = _scatter_topdown(pts, None, 256, half_extent=20.9,
                           center=(0.0, 10.0))
    if filepath is not None:
        save_png(filepath, img)
    return img


def visualize_rgbd_3d(
    rgbd: Array,
    p2p: Array,
    num_scans: int = 1,
    num_cams: int = 2,
    filepath: str | None = None,
    do_z_filtering: bool = False,
    z_max: float = 2.0,
) -> Array:
    """Backproject RGBD frames and render the colored cloud top-down
    (reference visualize_rgbd_3d, visualization.py:669-816).

    rgbd: [B*T*S, 4, H, W] with depth in mm in channel 3 and BGR color in
    channels 0-2; p2p: [B*T*S, 4, 4] pixel->point transforms. All frames'
    points are aggregated into one view labelled 'Input'. The points come
    from the port's ``geometry.backproject_depth`` on the CPU.
    """
    rgbd = np.asarray(rgbd)
    p2p = np.asarray(p2p, np.float32)
    BTS, C, H, W = rgbd.shape
    assert C == 4, f"expected 4 channels, got {C}"
    assert BTS % num_cams == 0, (
        f"frames ({BTS}) must divide cameras ({num_cams})"
    )
    all_xyz, all_rgb = [], []
    for i in range(BTS):
        depth_m = rgbd[i, 3].astype(np.float32) / 1000.0
        mask = depth_m > 0
        xyz = backproject_depth(torch.from_numpy(depth_m),
                                torch.from_numpy(p2p[i])).numpy()
        if do_z_filtering:
            xyz = xyz * (xyz[..., 2:3] < z_max)
        rgb = rgbd[i, [2, 1, 0]].transpose(1, 2, 0)  # BGR -> RGB
        all_xyz.append(_to_vis_frame(xyz[mask]))
        all_rgb.append(rgb[mask])
    pts = np.concatenate(all_xyz, 0)
    cols = np.concatenate(all_rgb, 0)
    img = _scatter_topdown(pts, cols, 256, half_extent=9.0,
                           center=(0.0, 4.0))
    img = draw_text_on_image(img, "Input", (10, 15))
    if filepath is not None:
        save_png(filepath, img)
    return img


def visualize_action_image(img, actions_in, transform, batch_idx=0):
    """Parity stub: the reference's visualize_action_image
    (visualization.py:1111-1121) has an empty body (``pass``) — kept so
    callers porting from the reference find the same no-op surface."""
    return None
