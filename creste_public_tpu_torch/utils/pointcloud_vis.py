"""Point-cloud / elevation-mesh visualisation without matplotlib.

The counterpart of ``creste_public_tpu/utils/pointcloud_vis.py`` (parity
target: creste/utils/pointcloud_vis.py:101, vispy's LaserScanVis). The JAX
package draws on matplotlib's 3-D axes, which the card's machine does not
have, so ``PointCloudFigure`` draws the same primitives itself, headless,
to a PNG:

- the scene is scaled into matplotlib's 4 : 4 : 3 box over the limits of
  everything drawn, and seen through a pinhole camera on a sphere around
  the box's centre at matplotlib's ``elev`` / ``azim`` (the box fills the
  frame with a 5% margin on each side);
- points are square splats of ``round(sqrt(size))`` pixels, coloured by
  height, intensity, per-point scalars (``utils/colormaps.py``'s turbo,
  viridis, magma or inferno tables) or explicit RGB(A); trajectories are
  lines of ``round(lw)``-pixel splats, one per pixel of their length;
- an elevation map is a height-field of quads (invalid and non-finite
  cells removed), each coloured by its mean height and shaded by the cosine
  of its normal with a light from above the viewer's left shoulder,
  painted far to near;
- one z-buffer, resolved in torch on the figure's ``device`` (the card
  unless the caller asks for ``device="cpu"``; a scatter
  ``amin`` of the depths per pixel; of equal depths the last drawn wins),
  decides which primitive shows at each pixel.

Its pixels are not matplotlib's (another rasteriser, no antialiasing, no
axes, ticks or panes), so the tests hold its geometry (where a point lands,
occlusion, the colour scale) rather than pixel equality with the JAX
package's figures. ``export_html_viewer`` is the JAX package's, byte for
byte.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image, ImageColor, ImageDraw

from creste_public_tpu_torch.utils.colormaps import COLORMAPS
from creste_public_tpu_torch.utils.device import resolve_device

# matplotlib's default 3-D box aspect (x : y : z = 4 : 4 : 3)
BOX = np.array([1.0, 1.0, 0.75])
# the camera's distance from the box's centre, in box units
EYE_DISTANCE = 3.0
MARGIN = 0.05
BACKGROUND = (255, 255, 255)
# the mesh's light, in box coordinates, and its ambient share
LIGHT = np.array([-1.0, -1.0, 2.0]) / np.sqrt(6.0)
AMBIENT = 0.35


def _lut(name: str) -> np.ndarray:
    lut = COLORMAPS.get(name)
    if lut is None or len(lut) != 256:
        raise ValueError(f"colormap {name!r} is not tabulated "
                         "(utils/colormaps.py)")
    return lut


def scalar_colors(values: np.ndarray, cmap: str = "turbo") -> np.ndarray:
    """uint8 RGB of ``values`` through ``cmap`` over their (min, max), as
    matplotlib's ``Normalize`` and a 256-entry colormap index them."""
    v = np.asarray(values, np.float64)
    lo, hi = float(v.min()), float(v.max())
    norm = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    return _lut(cmap)[np.clip((norm * 256).astype(np.int64), 0, 255)]


def _single_color(color) -> np.ndarray:
    if isinstance(color, str):
        return np.asarray(ImageColor.getrgb(color)[:3], np.uint8)
    c = np.asarray(color, np.float64)[:3]
    return (c * 255 if c.max() <= 1.0 else c).round().astype(np.uint8)


def _rgb(colors: np.ndarray) -> np.ndarray:
    c = np.asarray(colors)[:, :3]
    if np.issubdtype(c.dtype, np.floating):
        c = np.clip(c * 255 if c.max() <= 1.0 else c, 0, 255).round()
    return c.astype(np.uint8)


def _is_single_color(colors, n: int) -> bool:
    if isinstance(colors, str):
        return True
    c = np.asarray(colors)
    return c.ndim == 1 and len(c) in (3, 4) and len(c) != n


class PointCloudFigure:
    """A 3-D figure of point clouds, elevation meshes and trajectories,
    rendered to an RGB image of ``figsize * dpi`` pixels (width, height)."""

    def __init__(self, figsize=(8, 8), elev: float = 35.0,
                 azim: float = -60.0, dpi: int = 100,
                 device: str | torch.device = "cuda"):
        self.width = int(round(figsize[0] * dpi))
        self.height = int(round(figsize[1] * dpi))
        self.elev, self.azim = float(elev), float(azim)
        self.device = resolve_device(device)
        # ("splats", xyz [N, 3], rgb [N, 3], side) and
        # ("mesh", corners [H, W, 3], rgb [H-1, W-1, 3], valid [H-1, W-1])
        self._items: list[tuple] = []

    # -- drawing -----------------------------------------------------------
    def draw_points(
        self, points: np.ndarray, colors=None, color_by: str = "height",
        size: float = 1.0, max_points: int = 100_000, cmap: str = "turbo",
    ) -> "PointCloudFigure":
        """points [N, >=3]; colors: explicit RGB(A) per point, per-point
        scalars, one colour, or None -> colour by ``color_by`` ('height' |
        'intensity'). Points with a non-finite coordinate or scalar are
        not drawn."""
        pts = np.asarray(points)
        if len(pts) > max_points:
            idx = np.random.default_rng(0).choice(
                len(pts), max_points, replace=False
            )
            pts = pts[idx]
            if colors is not None and np.ndim(colors) >= 1 and len(colors) == len(points):
                colors = np.asarray(colors)[idx]
        xyz = np.asarray(pts[:, :3], np.float64)
        keep = np.isfinite(xyz).all(axis=1)
        if colors is None:
            scal = pts[:, 2] if color_by == "height" else (
                pts[:, 3] if pts.shape[1] > 3 else pts[:, 2]
            )
            keep &= np.isfinite(scal)
            rgb = scalar_colors(scal[keep], cmap) if keep.any() else \
                np.zeros((0, 3), np.uint8)
        elif _is_single_color(colors, len(pts)):
            rgb = np.tile(_single_color(colors), (int(keep.sum()), 1))
        elif np.ndim(colors) == 1:
            scal = np.asarray(colors, np.float64)
            keep &= np.isfinite(scal)
            rgb = scalar_colors(scal[keep], cmap) if keep.any() else \
                np.zeros((0, 3), np.uint8)
        else:
            rgb = _rgb(colors)[keep]
        side = max(1, int(round(np.sqrt(size))))
        self._items.append(("splats", xyz[keep], rgb, side))
        return self

    def draw_mesh_grid(
        self, height_map: np.ndarray, valid: np.ndarray | None = None,
        cell: float = 0.1, cmap: str = "viridis",
    ) -> "PointCloudFigure":
        """Elevation map [H, W] as a surface (NaN/invalid cells removed)."""
        H, W = height_map.shape
        ys, xs = np.mgrid[0:H, 0:W].astype(float) * cell
        z = np.asarray(height_map, float).copy()
        bad = ~np.isfinite(z)
        if valid is not None:
            bad |= ~np.asarray(valid, bool)
        z[bad] = np.nan
        corners = np.stack([xs, ys, z], axis=-1)
        face_z = (z[:-1, :-1] + z[:-1, 1:] + z[1:, :-1] + z[1:, 1:]) / 4
        ok = np.isfinite(face_z)
        rgb = np.zeros((H - 1, W - 1, 3), np.uint8)
        if ok.any():
            rgb[ok] = scalar_colors(face_z[ok], cmap)
        self._items.append(("mesh", corners, rgb, ok))
        return self

    def draw_trajectory(self, xyz: np.ndarray, color="red", lw: float = 2.0):
        """A polyline through [T, 2] or [T, 3] points (z = 0 for 2-D)."""
        xyz = np.asarray(xyz, np.float64)
        z = xyz[:, 2] if xyz.shape[1] > 2 else np.zeros(len(xyz))
        pts = np.stack([xyz[:, 0], xyz[:, 1], z], axis=1)
        self._items.append(("line", pts, _single_color(color),
                            max(1, int(round(lw)))))
        return self

    # -- the camera ----------------------------------------------------------
    def _limits(self) -> tuple[np.ndarray, np.ndarray]:
        chunks = []
        for item in self._items:
            xyz = item[1].reshape(-1, 3)
            chunks.append(xyz[np.isfinite(xyz).all(axis=1)])
        allp = np.concatenate(chunks) if chunks else np.zeros((0, 3))
        if not len(allp):
            return np.full(3, -0.5), np.full(3, 0.5)
        lo, hi = allp.min(axis=0), allp.max(axis=0)
        flat = hi - lo <= 0
        lo[flat] -= 0.5
        hi[flat] += 0.5
        return lo, hi

    def _camera(self):
        a, e = np.deg2rad(self.azim), np.deg2rad(self.elev)
        toward_eye = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                               np.sin(e)])
        right = np.array([-np.sin(a), np.cos(a), 0.0])
        up = np.array([-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a),
                       np.cos(e)])
        return EYE_DISTANCE * toward_eye, -toward_eye, right, up

    def _project_box(self, b: np.ndarray):
        """Box coordinates [..., 3] -> (u, v, depth) on the unit image
        plane."""
        eye, fwd, right, up = self._camera()
        d = b - eye
        depth = d @ fwd
        return (d @ right) / depth, (d @ up) / depth, depth

    def project(self, xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
        """Data coordinates [..., 3] -> (column, row, depth): where a point
        lands in the image of everything drawn so far (pixel centres at
        integer + 0.5)."""
        lo, hi = self._limits()
        b = ((np.asarray(xyz, np.float64) - lo) / (hi - lo) - 0.5) * BOX
        corners = (np.stack(np.meshgrid(*[[-0.5, 0.5]] * 3, indexing="ij"),
                            -1).reshape(-1, 3) * BOX)
        cu, cv, _ = self._project_box(corners)
        scale = min((1 - 2 * MARGIN) * self.width / (cu.max() - cu.min()),
                    (1 - 2 * MARGIN) * self.height / (cv.max() - cv.min()))
        u, v, depth = self._project_box(b)
        col = self.width / 2 + (u - (cu.max() + cu.min()) / 2) * scale
        row = self.height / 2 - (v - (cv.max() + cv.min()) / 2) * scale
        return col, row, depth

    # -- rasterising -----------------------------------------------------------
    def _splats(self, xyz: np.ndarray, rgb: np.ndarray, side: int):
        col, row, depth = self.project(xyz)
        c0 = np.floor(col).astype(np.int64) - side // 2
        r0 = np.floor(row).astype(np.int64) - side // 2
        cols, rows, depths, colors = [], [], [], []
        for dr in range(side):
            for dc in range(side):
                cols.append(c0 + dc)
                rows.append(r0 + dr)
                depths.append(depth)
                colors.append(rgb)
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(depths), np.concatenate(colors))

    def _line(self, pts: np.ndarray, rgb: np.ndarray, side: int):
        col, row, _ = self.project(pts)
        samples = []
        for i in range(len(pts) - 1):
            n = int(np.ceil(np.hypot(col[i + 1] - col[i],
                                     row[i + 1] - row[i]))) + 1
            t = np.linspace(0.0, 1.0, n)[:, None]
            samples.append(pts[i] + t * (pts[i + 1] - pts[i]))
        samples = np.concatenate(samples) if samples else pts
        return self._splats(samples, np.tile(rgb, (len(samples), 1)), side)

    def _mesh(self, corners: np.ndarray, rgb: np.ndarray, ok: np.ndarray):
        """The height-field's quads, painted far to near into an index
        image; each covered pixel takes its quad's depth and shaded
        colour."""
        col, row, depth = self.project(corners)
        lo, hi = self._limits()
        b = ((corners - lo) / (hi - lo) - 0.5) * BOX
        normal = np.cross(b[1:, :-1] - b[:-1, :-1], b[:-1, 1:] - b[:-1, :-1])
        normal /= np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True),
                             1e-12)
        lit = np.where(ok, AMBIENT + (1 - AMBIENT) * np.abs(
            np.nan_to_num(normal) @ LIGHT), 0.0)
        shaded = np.clip(rgb * lit[..., None], 0, 255).astype(np.uint8)
        qd = (depth[:-1, :-1] + depth[:-1, 1:] + depth[1:, :-1]
              + depth[1:, 1:]) / 4
        faces = np.flatnonzero(ok)
        faces = faces[np.argsort(-qd.reshape(-1)[faces], kind="stable")]
        ids = Image.new("I", (self.width, self.height), 0)
        draw = ImageDraw.Draw(ids)
        nc = ok.shape[1]
        for f in faces:
            i, j = divmod(int(f), nc)
            draw.polygon([(col[i, j], row[i, j]), (col[i, j + 1],
                                                   row[i, j + 1]),
                          (col[i + 1, j + 1], row[i + 1, j + 1]),
                          (col[i + 1, j], row[i + 1, j])], fill=int(f) + 1)
        ids = np.asarray(ids).astype(np.int64)
        rr, cc = np.nonzero(ids)
        f = ids[rr, cc] - 1
        return rr, cc, qd.reshape(-1)[f], shaded.reshape(-1, 3)[f]

    def to_array(self) -> np.ndarray:
        """The figure as uint8 RGB [height, width, 3]."""
        parts = []
        for item in self._items:
            if item[0] == "splats" and len(item[1]):
                parts.append(self._splats(*item[1:]))
            elif item[0] == "line" and len(item[1]):
                parts.append(self._line(*item[1:]))
            elif item[0] == "mesh" and item[3].any():
                parts.append(self._mesh(*item[1:]))
        H, W = self.height, self.width
        img = torch.tensor(BACKGROUND, dtype=torch.uint8).repeat(H * W, 1)
        if parts:
            rows, cols, depths, colors = (np.concatenate(p) for p in
                                          zip(*parts))
            inside = ((rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
                      & (depths > 0))
            dev = self.device
            pix = torch.from_numpy(rows[inside] * W + cols[inside]).to(dev)
            depth = torch.from_numpy(depths[inside]).to(dev)
            rgb = torch.from_numpy(colors[inside]).to(dev)
            zmin = torch.full((H * W,), float("inf"), dtype=depth.dtype,
                              device=dev).scatter_reduce(
                0, pix, depth, "amin")
            win = depth == zmin[pix]
            order = torch.arange(len(pix), device=dev)
            last = torch.full((H * W,), -1, dtype=torch.int64,
                              device=dev).scatter_reduce(
                0, pix[win], order[win], "amax")
            hit = last >= 0
            img = img.to(dev)
            img[hit] = rgb[last[hit]]
        return img.reshape(H, W, 3).cpu().numpy()

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        Image.fromarray(self.to_array()).save(path)

    def show(self) -> None:
        """Opens the image in the platform's viewer; raises when there is
        no display to show it on."""
        if os.name == "posix" and not (os.environ.get("DISPLAY")
                                       or os.environ.get("WAYLAND_DISPLAY")):
            raise RuntimeError(
                "PointCloudFigure.show: no display (DISPLAY and "
                "WAYLAND_DISPLAY are unset); use save(path) instead")
        Image.fromarray(self.to_array()).show()


def render_scan(points: np.ndarray, path: str,
                device: str | torch.device = "cuda", **kwargs) -> None:
    """One-call scan render to PNG (the LaserScanVis quick path)."""
    PointCloudFigure(device=device).draw_points(points, **kwargs).save(path)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { margin:0; background:#101014; color:#ddd; font:13px monospace;
        overflow:hidden; }
 #hud { position:fixed; top:8px; left:10px; user-select:none;
        text-shadow:0 0 4px #000; }
 canvas { display:block; }
</style></head><body>
<div id="hud"></div><canvas id="cv"></canvas>
<script>
"use strict";
// ---- embedded scans: base64 little-endian float32 [N, stride] ----
const SCANS_B64 = __SCANS__;
const STRIDES = __STRIDES__;
const LABELS_B64 = __LABELS__;   // per-scan base64 uint32 or null
const TITLE = __TITLE_JS__;
function decodeF32(b64) {
  const bin = atob(b64), n = bin.length;
  const buf = new ArrayBuffer(n), u8 = new Uint8Array(buf);
  for (let i = 0; i < n; i++) u8[i] = bin.charCodeAt(i);
  return new Float32Array(buf);
}
function decodeU32(b64) {
  const bin = atob(b64), n = bin.length;
  const buf = new ArrayBuffer(n), u8 = new Uint8Array(buf);
  for (let i = 0; i < n; i++) u8[i] = bin.charCodeAt(i);
  return new Uint32Array(buf);
}
const scans = SCANS_B64.map(decodeF32);
const labels = LABELS_B64.map(b => b === null ? null : decodeU32(b));
// ---- turbo-ish colormap ----
function cmap(t) {
  t = Math.min(1, Math.max(0, t));
  return [Math.floor(255*Math.min(1, Math.max(0, 1.6-Math.abs(4*t-3.2)))),
          Math.floor(255*Math.min(1, Math.max(0, 1.6-Math.abs(4*t-1.8)))),
          Math.floor(255*Math.min(1, Math.max(0, 1.6-Math.abs(4*t-0.6))))];
}
function labColor(l) {  // deterministic label palette
  const h = (l * 2654435761 >>> 0);
  return [64 + (h & 0xbf), 64 + ((h >> 8) & 0xbf), 64 + ((h >> 16) & 0xbf)];
}
// ---- state ----
let si = 0, colorMode = 0;  // 0 height, 1 intensity, 2 label
let yaw = -0.9, pitch = 0.5, dist = 28, cx = 6, cy = 0, cz = 0;
let ps = __POINT_SIZE__;
const cv = document.getElementById("cv"), hud = document.getElementById("hud");
const ctx = cv.getContext("2d");
let W, H, img, data32, zbuf;
function resize() {
  W = cv.width = window.innerWidth; H = cv.height = window.innerHeight;
  img = ctx.createImageData(W, H);
  data32 = new Uint32Array(img.data.buffer);
  zbuf = new Float32Array(W * H);
  draw();
}
window.addEventListener("resize", resize);
// ---- software projection + z-buffer splat (no WebGL dependency) ----
function draw() {
  data32.fill(0xff18140f); zbuf.fill(1e30);
  const f = scans[si], st = STRIDES[si], n = (f.length / st) | 0;
  const lab = labels[si];
  const cyaw = Math.cos(yaw), syaw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const foc = 1.2 * Math.min(W, H);
  // color scaling
  let lo = 1e30, hi = -1e30;
  const ch = colorMode === 1 && st > 3 ? 3 : 2;
  for (let i = 0; i < n; i++) {
    const v = f[i * st + ch];
    if (v < lo) lo = v; if (v > hi) hi = v;
  }
  const span = Math.max(1e-6, hi - lo);
  for (let i = 0; i < n; i++) {
    const x = f[i*st] - cx, y = f[i*st+1] - cy, z = f[i*st+2] - cz;
    // world -> camera: yaw about z, pitch about x', camera at -dist
    const x1 = x * cyaw - y * syaw, y1 = x * syaw + y * cyaw;
    const y2 = y1 * cp - z * sp, z2 = y1 * sp + z * cp;
    const depth = x1 + dist;
    if (depth <= 0.2) continue;
    const u = (W >> 1) + (foc * y2 / depth) | 0;
    const v = (H >> 1) - (foc * z2 / depth) | 0;
    if (u < 0 || u >= W || v < 0 || v >= H) continue;
    let rgb;
    if (colorMode === 2 && lab) rgb = labColor(lab[i]);
    else rgb = cmap((f[i*st+ch] - lo) / span);
    const col = 0xff000000 | (rgb[2] << 16) | (rgb[1] << 8) | rgb[0];
    for (let dy = 0; dy < ps; dy++) for (let dx = 0; dx < ps; dx++) {
      const uu = u + dx, vv = v + dy;
      if (uu >= W || vv >= H) continue;
      const o = vv * W + uu;
      if (depth < zbuf[o]) { zbuf[o] = depth; data32[o] = col; }
    }
  }
  ctx.putImageData(img, 0, 0);
  hud.textContent = TITLE + "  scan " + (si+1) + "/" + scans.length +
    "  color:" + ["height","intensity","label"][colorMode] +
    "  [drag orbit / shift-drag pan / wheel zoom / N,B scan / C color]";
}
// ---- controls (LaserScanVis key map: N/B next/back) ----
let dragging = false, panning = false, lx = 0, ly = 0;
cv.addEventListener("mousedown", e => {
  dragging = true; panning = e.shiftKey || e.button === 2;
  lx = e.clientX; ly = e.clientY;
});
window.addEventListener("mouseup", () => dragging = false);
window.addEventListener("mousemove", e => {
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  lx = e.clientX; ly = e.clientY;
  if (panning) {
    const s = dist / (1.2 * Math.min(W, H));
    const cyaw = Math.cos(yaw), syaw = Math.sin(yaw);
    cy -= dx * s * cyaw; cx += dx * s * syaw; cz += dy * s;
  } else { yaw += dx * 0.008; pitch += dy * 0.008; }
  draw();
});
cv.addEventListener("wheel", e => {
  dist *= Math.exp(e.deltaY * 0.001); e.preventDefault(); draw();
}, { passive: false });
cv.addEventListener("contextmenu", e => e.preventDefault());
window.addEventListener("keydown", e => {
  const k = e.key.toLowerCase();
  if (k === "n") si = (si + 1) % scans.length;
  else if (k === "b") si = (si + scans.length - 1) % scans.length;
  else if (k === "c") colorMode = (colorMode + 1) % 3;
  else if (k === "+") ps = Math.min(6, ps + 1);
  else if (k === "-") ps = Math.max(1, ps - 1);
  else return;
  draw();
});
resize();
</script></body></html>
"""


def export_html_viewer(
    path: str,
    scans,
    labels=None,
    point_size: int = 2,
    title: str = "creste scan viewer",
) -> str:
    """Self-contained interactive 3-D scan viewer (single HTML file).

    The reference ships a vispy interactive LaserScanVis
    (creste/utils/pointcloud_vis.py:101: orbit camera, N/B scan stepping,
    color modes); vispy/OpenGL are not available here, so the interactive
    surface is a zero-dependency HTML file: scans embedded as base64
    float32, software-projected with a JS z-buffer splat at interactive
    rates, drag-orbit / shift-drag-pan / wheel-zoom, N/B scan stepping and
    C color-mode cycling (height / intensity / label). Open in any
    browser — robot field laptops included; nothing to install.

    Args:
      path: output .html path.
      scans: one [N, >=3] array or a list of them (xyz [+ intensity]).
      labels: optional per-scan int label arrays (length N each) for the
        'label' color mode.
      point_size: splat size in pixels.
    Returns the path.
    """
    import base64
    import json
    from html import escape as html_escape
    import os

    if isinstance(scans, np.ndarray):
        scans = [scans]
    if labels is not None and isinstance(labels, np.ndarray):
        labels = [labels]

    b64s, strides, lab_b64 = [], [], []
    for i, s in enumerate(scans):
        s = np.ascontiguousarray(np.asarray(s, np.float32))
        assert s.ndim == 2 and s.shape[1] >= 3, "scan must be [N, >=3]"
        b64s.append(base64.b64encode(s.tobytes()).decode())
        strides.append(int(s.shape[1]))
        if labels is not None and labels[i] is not None:
            lab = np.ascontiguousarray(np.asarray(labels[i], np.uint32))
            assert len(lab) == len(s)
            lab_b64.append(base64.b64encode(lab.tobytes()).decode())
        else:
            lab_b64.append(None)

    html = (
        _HTML_TEMPLATE
        .replace("__SCANS__", json.dumps(b64s))
        .replace("__STRIDES__", json.dumps(strides))
        .replace("__LABELS__", json.dumps(lab_b64))
        .replace("__POINT_SIZE__", str(int(point_size)))
        # JS constant via json.dumps (escapes quotes, backslashes and
        # `</script>` via <...), <title> element via html.escape —
        # a title like `</script><script>` must not break the page.
        .replace("__TITLE_JS__",
                 json.dumps(title).replace("</", "<\\/"))
        .replace("__TITLE__", html_escape(title))
    )
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
