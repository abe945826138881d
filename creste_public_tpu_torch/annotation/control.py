"""Counterfactual trajectory samplers + BEV/metric transforms.

A copy of ``creste_public_tpu/annotation/control.py`` (NumPy and scipy on
the host): the same ``default_rng`` draws give the same arrays, bit for
bit.

Parity target: scripts/traversability/planner_utils/control.py —
  * `sample_unicycle_trajectories` (:101 sampleTrajectory): random
    curvature/velocity unicycle rollouts from the ego pose,
  * `sample_epsilon_trajectories` (:75 sampleEpsilonTrajectory): spline
    perturbations of the expert path at increasing lateral magnitudes
    (left/right pairs per epsilon band),
  * `hausdorff_distances` (:34): symmetric Hausdorff of each candidate to
    the expert,
  * metric<->BEV-grid transforms (:120-146) with the (-1,-1) axis flip and
    grid-centre offset.
"""
from __future__ import annotations

import numpy as np


def unicycle_step(state: np.ndarray, curvature: np.ndarray,
                  velocity: np.ndarray, dt: float) -> np.ndarray:
    """state [N, 3] (x, y, theta) -> delta for one dt step."""
    theta = state[:, 2]
    dx = velocity * np.cos(theta) * dt
    dy = velocity * np.sin(theta) * dt
    dtheta = velocity * curvature * dt
    return np.stack([dx, dy, dtheta], axis=1)


def sample_unicycle_trajectories(
    num_traj: int, num_iter: int,
    cmin: float = -0.5, cmax: float = 0.5,
    vmin: float = 0.5, vmax: float = 2.0,
    dt: float = 0.2, seed: int | None = None,
) -> np.ndarray:
    """[num_traj, num_iter, 3] random unicycle rollouts from the origin."""
    rng = np.random.default_rng(seed)
    traj = np.zeros((num_traj, num_iter, 3))
    for t in range(num_iter - 1):
        c = rng.uniform(cmin, cmax, num_traj)
        v = rng.uniform(vmin, vmax, num_traj)
        traj[:, t + 1] = traj[:, t] + unicycle_step(traj[:, t], c, v, dt)
    return traj


def sample_epsilon_trajectories(
    expert_xy: np.ndarray, num_traj: int, num_iter: int,
    num_samples: int = 6, epsilon: float = 2.0, seed: int | None = None,
) -> np.ndarray:
    """Left/right spline perturbations of the expert path at increasing
    lateral magnitude bands (control.py:75-99)."""
    from scipy.interpolate import make_interp_spline

    rng = np.random.default_rng(seed)
    # pair loop writes two rows per band: round the allocation up so an odd
    # num_traj still fills its last row (surplus row sliced off at return)
    n_pairs = (num_traj + 1) // 2
    bands = np.linspace(0, epsilon, n_pairs + 1)
    out = np.zeros((2 * n_pairs, num_iter, 3))
    T = len(expert_xy)
    # arc-length parameterisation of the expert
    s = np.linspace(0, 1, T)
    # path normals (perpendicular to local heading)
    d = np.gradient(expert_xy, axis=0)
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    d = d / np.maximum(norm, 1e-9)
    normals = np.stack([-d[:, 1], d[:, 0]], axis=1)

    k = min(3, num_samples - 1)
    for i in range(n_pairs):
        lo, hi = bands[i], bands[i + 1]
        for j, side in enumerate((1.0, -1.0)):
            picks = np.sort(rng.choice(T, num_samples, replace=False))
            picks[0], picks[-1] = 0, T - 1
            mags = rng.uniform(lo, hi, num_samples)
            mags[0] = 0.0  # anchored at the ego pose
            ctrl = expert_xy[picks] + side * mags[:, None] * normals[picks]
            t = s[picks]
            t, uniq = np.unique(t, return_index=True)
            ctrl = ctrl[uniq]
            kk = min(k, len(t) - 1)
            spline = make_interp_spline(t, ctrl, k=max(kk, 1))
            ts = np.linspace(0, 1, num_iter)
            out[2 * i + j, :, :2] = spline(ts)
    return out[:num_traj]


def hausdorff_distances(
    trajectories: np.ndarray, expert_idx: int = 0
) -> np.ndarray:
    """[N] symmetric Hausdorff distance of each trajectory to the expert
    (control.py:34-72). Uses ALL point columns like the reference
    function; callers choose the columns by what they pass. NOTE: in the
    reference's actual pipeline (rlhf/app.py:163-166) candidates go
    through transformToBEV first, which emits xy only — so pass
    [N, T, 2] (as annotation/app.py does) for pipeline-faithful
    distances."""
    from scipy.spatial.distance import directed_hausdorff

    ref = trajectories[expert_idx]
    out = np.zeros(len(trajectories))
    for i, t in enumerate(trajectories):
        a = directed_hausdorff(ref, t)[0]
        b = directed_hausdorff(t, ref)[0]
        out[i] = max(a, b)
    return out


def metric_to_bev(
    xy: np.ndarray, center=(12.8, 12.8), res: float = 0.1
) -> np.ndarray:
    """Metric ego-frame (x fwd, y left) -> BEV grid (row, col) with the
    reference's axis flip (control.py:136-146)."""
    rc = np.empty_like(xy)
    rc[..., 0] = center[0] / res - xy[..., 0] / res
    rc[..., 1] = center[1] / res - xy[..., 1] / res
    return rc


def bev_to_metric(
    rc: np.ndarray, center=(12.8, 12.8), res: float = 0.1
) -> np.ndarray:
    xy = np.empty_like(rc)
    xy[..., 0] = (center[0] / res - rc[..., 0]) * res
    xy[..., 1] = (center[1] / res - rc[..., 1]) * res
    return xy
