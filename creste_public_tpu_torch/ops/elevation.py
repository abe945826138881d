"""BEV elevation labels: grid binning and ground/overhang separation.

Counterpart of ``creste_public_tpu/ops/elevation.py`` (reference
creste/utils/elevation_utils.py:44-303 and the gap-scan kernel of
scripts/preprocessing/build_feature_map.py:456-561). The per-cell scans are
one global sort by (cell, value) plus masks that read each point's
predecessor inside its segment, and scatter reductions over the cells.

torch sorts by one key: the (cell, value) order is a stable sort by the
value followed by a stable sort by the cell. Min and max reduce with
``scatter_reduce_`` (independent of the order of the card's atomics); the
sums (counts, first and second moments) go through atomics on the card, so
they meet the CPU's to a tolerance, not to the bit. The 3x3 window
reductions are shifted-slice sums in XLA's row-major window order and
min/max over the same slices: no convolution (cuDNN would run a
convolution of ones in TF32).

Divisions by a constant divide by a tensor on the data's device: the card
turns a division by a host scalar into a multiplication by its reciprocal,
which moves points across cell edges.
"""
from __future__ import annotations

import torch

PROJ_GROUND, PROJ_CEILING, PROJ_SKY = 0, 1, 2


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as XLA fuses it (emulated in
    f64, where the product of two f32 numbers is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _sort2(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts by (k1, k2), stable."""
    o2 = torch.sort(k2, stable=True).indices
    o1 = torch.sort(k1[o2], stable=True).indices
    return o2[o1]


def bin_min_max_var(z: torch.Tensor, cell: torch.Tensor, valid: torch.Tensor,
                    n_cells: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Per-cell (min, max, variance, count) of point heights.

    z [N] heights, cell [N] linearised cell ids, valid [N] bool. Empty
    cells: min and max NaN, variance 0."""
    dev = z.device
    z = z.float()
    idx = torch.where(valid, cell.long(), torch.zeros_like(cell.long()))
    inf = float("inf")
    zmin = torch.full((n_cells,), inf, device=dev).scatter_reduce_(
        0, idx, torch.where(valid, z, _const(inf, z)), "amin")
    zmax = torch.full((n_cells,), -inf, device=dev).scatter_reduce_(
        0, idx, torch.where(valid, z, _const(-inf, z)), "amax")
    zero = _const(0.0, z)
    cnt = torch.zeros(n_cells, device=dev).index_add_(0, idx, valid.float())
    s1 = torch.zeros(n_cells, device=dev).index_add_(
        0, idx, torch.where(valid, z, zero))
    s2 = torch.zeros(n_cells, device=dev).index_add_(
        0, idx, torch.where(valid, z * z, zero))
    c1 = torch.clamp(cnt, min=1.0)
    mean = s1 / c1
    var = torch.clamp(_fma(-mean, mean, s2 / c1), min=0.0)
    nan = _const(float("nan"), z)
    zmin = torch.where(cnt > 0, zmin, nan)
    zmax = torch.where(cnt > 0, zmax, nan)
    return zmin, zmax, var, cnt


def lower_upper_elevation(z: torch.Tensor, cell: torch.Tensor,
                          valid: torch.Tensor, ground: torch.Tensor,
                          n_cells: int, sky_thres: float = 2.0,
                          gap_thres: float = 0.1, min_overhang: float = 0.5,
                          first_gate: float = 0.3
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Ground/overhang split per BEV cell.

    Args:
      z: [N] point heights; cell: [N] cell ids; valid: [N] point mask.
      ground: [n_cells] ground elevation (NaN = skip the cell).

    Returns:
      lower: [n_cells] top of the ground structure (NaN where undetermined).
      upper: [n_cells] bottom of the overhang, or sky_thres when none.
      proj_class: [N] per point, {GROUND, CEILING, SKY}.
    """
    dev = z.device
    N = z.shape[0]
    z = z.float()
    cell = cell.long()
    g = ground[cell.clamp(0, n_cells - 1)]
    e = z - g
    ok = valid & torch.isfinite(g)
    inf = _const(float("inf"), z)
    e_eff = torch.where(ok, torch.clamp(e, min=0.0), inf)
    key = torch.where(ok, cell, torch.full_like(cell, n_cells))
    order = _sort2(key, e_eff)
    sc, se = key[order], e_eff[order]

    pos = torch.arange(N, device=dev)
    seg_first = torch.ones(N, dtype=torch.bool, device=dev)
    seg_first[1:] = sc[1:] != sc[:-1]
    shifted = torch.cat([se[:1] * 0, se[:-1]])
    prev = torch.where(seg_first, torch.zeros_like(se), shifted)
    fin = torch.isfinite(se)

    is_first_pos = fin & (prev == 0.0) & (se > 0.0)
    breaks = is_first_pos & (se > first_gate)
    cell_broken = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
    cell_broken.scatter_reduce_(0, sc, breaks.int(), "amax")
    cell_broken = cell_broken[:n_cells] > 0

    gap_here = fin & (se > min_overhang) & (se - prev > gap_thres) & ~breaks
    big = N
    gap_pos = torch.where(gap_here, pos, torch.full_like(pos, big))
    first_gap = torch.full((n_cells + 1,), big, dtype=torch.long, device=dev)
    first_gap.scatter_reduce_(0, sc, gap_pos, "amin")
    first_gap = first_gap[:n_cells]
    has_gap = (first_gap < big) & ~cell_broken

    zero1 = torch.zeros(1, device=dev)
    se_pad = torch.cat([se, zero1])
    prev_pad = torch.cat([prev, zero1])
    gp = first_gap.clamp(0, N)
    lower_gap = torch.clamp(prev_pad[gp], max=sky_thres)
    upper_gap = torch.clamp(se_pad[gp], max=sky_thres)

    max_e = torch.zeros(n_cells + 1, device=dev)
    max_e.scatter_reduce_(0, sc, torch.where(fin, se, torch.zeros_like(se)),
                          "amax")
    max_e = max_e[:n_cells]
    nan = _const(float("nan"), z)
    lower_nogap = torch.where((max_e > 0.0) & ~cell_broken,
                              torch.clamp(max_e, max=sky_thres), nan)
    sky = _const(sky_thres, z)
    lower = torch.where(has_gap, lower_gap, lower_nogap)
    upper = torch.where(has_gap, upper_gap, sky)
    known = torch.isfinite(ground)
    lower = torch.where(known, lower, nan)
    upper = torch.where(known, upper, nan)

    scc = sc.clamp(0, n_cells - 1)
    fg = first_gap[scc]
    broken_pt = cell_broken[scc]
    # the gap-discovery point itself stays SKY (the reference scan exits
    # through its gap branch without classifying it)
    cls_sorted = torch.where(
        ~fin | broken_pt, PROJ_SKY,
        torch.where(pos < fg, PROJ_GROUND,
                    torch.where((pos > fg) & (se < sky_thres), PROJ_CEILING,
                                PROJ_SKY)))
    proj_class = torch.zeros(N, dtype=torch.int32, device=dev)
    proj_class[order] = cls_sorted.int()
    proj_class = torch.where(ok, proj_class,
                             torch.full_like(proj_class, PROJ_SKY))
    return lower, upper, proj_class


def elevation_maps_from_points(points: torch.Tensor, grid_hw: tuple[int, int],
                               map_range: float, sky_thres: float = 2.0,
                               gap_thres: float = 0.1,
                               min_overhang: float = 0.5
                               ) -> dict[str, torch.Tensor]:
    """Points [N, 3] (LiDAR frame) -> dict of [H, W] maps {elevation_min,
    elevation_max, variance, lower, upper} (x forward -> row, as
    geometry.lidar_to_map)."""
    H, W = grid_hw
    p = points.float()
    voxel = _const(2 * map_range / H, p)
    col = torch.floor((p[:, 1] + map_range) / voxel).to(torch.int64)
    row = torch.floor((p[:, 0] + map_range) / voxel).to(torch.int64)
    valid = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    cell = torch.where(valid, row * W + col, torch.zeros_like(row))
    z = p[:, 2]
    zmin, zmax, var, _ = bin_min_max_var(z, cell, valid, H * W)
    lower, upper, _ = lower_upper_elevation(
        z, cell, valid, zmin, H * W, sky_thres, gap_thres, min_overhang)
    return {"elevation_min": zmin.reshape(H, W),
            "elevation_max": zmax.reshape(H, W),
            "variance": var.reshape(H, W),
            "lower": lower.reshape(H, W),
            "upper": upper.reshape(H, W)}


def _window(x: torch.Tensor, op: str, k: tuple[int, int], stride: int
            ) -> torch.Tensor:
    """XLA's ``reduce_window`` over [H, W] with padding ``stride`` on each
    side (0 for sums, +-inf for min/max) and window ``k``; the sum adds the
    window's elements in row-major order, starting from 0."""
    fill = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[op]
    H, W = x.shape
    xp = torch.nn.functional.pad(x[None], (stride,) * 4, value=fill)[0]
    Ho = (H + 2 * stride - k[0]) // stride + 1
    Wo = (W + 2 * stride - k[1]) // stride + 1
    out = torch.full((Ho, Wo), fill, dtype=x.dtype, device=x.device)
    for i in range(k[0]):
        for j in range(k[1]):
            s = xp[i:i + stride * (Ho - 1) + 1:stride,
                   j:j + stride * (Wo - 1) + 1:stride]
            if op == "sum":
                out = out + s
            elif op == "min":
                out = torch.minimum(out, s)
            else:
                out = torch.maximum(out, s)
    return out


def reference_elevation_maps(points: torch.Tensor, labels: torch.Tensor,
                             grid_dims: tuple[int, int], grid_width: float,
                             grid_height: float,
                             ignore_classes: tuple[int, ...] = (0,),
                             nlowest: int | None = None,
                             kernel: tuple[int, int] = (3, 3),
                             stride: int = 1, post_min_count: int = 3
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's shipped elevation labels (build_feature_map
    get_elevation_from_pose driving elevation_utils BinningPostprocess and
    Map2D), with the JAX package's quirks: x and y swapped before binning,
    cells by truncating ``(x / width + 0.5) * res``, the per-cell value the
    plain min (``nlowest=None``, the shipped default) or the lower median
    of the ``nlowest`` smallest z, a 3x3 neighbourhood min / max / variance
    over valid cells, cells with fewer than ``post_min_count`` points
    cleared, unknown cells +inf (min, max) and 0 (variance), both maps
    flipped on both axes.

    Args:
      points: [N, 3] in the semantic-map frame (before the swap).
      labels: [N] int classes; ``ignore_classes`` are dropped.
      grid_dims: (resx, resy).

    Returns elevation [resy, resx, 2] f32 (min, max) and variance
    [resy, resx] f32.
    """
    resx, resy = grid_dims
    n_cells = resx * resy
    p = points.float()
    dev = p.device
    N = p.shape[0]
    keep = torch.ones(N, dtype=torch.bool, device=dev)
    for c in ignore_classes:
        keep &= labels != c
    x, y, z = p[:, 1], p[:, 0], p[:, 2]
    fx = (x / _const(grid_width, p) + 0.5) * resx
    fy = (y / _const(grid_height, p) + 0.5) * resy
    projx = torch.trunc(fx).clamp(-2.0, 2.0 ** 30).to(torch.int64)
    projy = torch.trunc(fy).clamp(-2.0, 2.0 ** 30).to(torch.int64)
    inrange = (projx >= 0) & (projx < resx) & (projy >= 0) & (projy < resy)
    valid = keep & inrange
    cell = (projx + projy * resx).clamp(0, n_cells - 1)

    counts = torch.zeros(n_cells, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(valid, cell, torch.zeros_like(cell)), valid.long())
    min_ppc = max(nlowest, 1) if nlowest else 1
    good = counts >= min_ppc
    valid = valid & good[cell]
    counts_post = torch.where(good, counts, torch.zeros_like(counts))

    rank_want = ((nlowest - 1) // 2) if nlowest else 0
    cellv = torch.where(valid, cell, torch.full_like(cell, n_cells))
    order = _sort2(cellv, z)
    sc, sz = cellv[order], z[order]
    pos = torch.arange(N, device=dev)
    seg_first = torch.ones(N, dtype=torch.bool, device=dev)
    seg_first[1:] = sc[1:] != sc[:-1]
    seg_start = torch.cummax(torch.where(seg_first, pos,
                                         torch.zeros_like(pos)), 0).values
    rank = pos - seg_start
    pick = (rank == rank_want) & (sc < n_cells)
    ninf = _const(float("-inf"), p)
    map_val = torch.full((n_cells,), float("-inf"), device=dev)
    map_val.scatter_reduce_(0, torch.where(pick, sc, torch.zeros_like(sc)),
                            torch.where(pick, sz, ninf), "amax")
    zero = _const(0.0, p)
    map_val = torch.where(good, map_val, zero)
    mask = good.float()

    val2 = (map_val * mask).reshape(resy, resx)
    m2 = mask.reshape(resy, resx)
    cnt_w = _window(m2, "sum", kernel, stride)
    any_w = cnt_w > 0
    inf = _const(float("inf"), p)
    minv = _window(torch.where(m2 == 1, val2, inf), "min", kernel, stride)
    maxv = _window(torch.where(m2 == 1, val2, ninf), "max", kernel, stride)
    s1 = _window(val2 * m2, "sum", kernel, stride)
    s2 = _window(val2 * val2 * m2, "sum", kernel, stride)
    den = cnt_w + 1e-6
    mean = s1 / den
    # (s2 - 2 mean s1 + mean^2 cnt) / den with XLA's two fused steps
    var = _fma(mean * mean, cnt_w, _fma(-(2.0 * mean), s1, s2)) / den
    minv = torch.where(any_w, minv, zero)
    maxv = torch.where(any_w, maxv, zero)
    var = torch.where(any_w, var, zero)

    low = (counts_post < post_min_count).reshape(resy, resx)
    keep_cell = any_w & ~low
    minv = torch.where(keep_cell, minv, inf)
    maxv = torch.where(keep_cell, maxv, inf)
    var = torch.where(keep_cell, var, zero)
    elev = torch.stack([minv, maxv], dim=-1).flip(0, 1)
    return elev, var.flip(0, 1)
