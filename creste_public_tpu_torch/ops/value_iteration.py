"""Value iteration over the BEV reward grid (the VIN MDP solver).

Counterpart of ``creste_public_tpu/ops/value_iteration.py``. The MDP is an
8-connected grid; each action's Bellman backup is a fixed 3x3 stencil with
taps (0.1 left, 0.8 centre, 0.1 right) around the action direction. The
solve runs until the sup-norm value change over the whole batch is at most
``threshold``, or for ``max_iters`` sweeps, from V = 0.

``value_iteration`` solves V on the device of its input: the plain PyTorch
version for a CPU tensor, the hand-written CUDA kernel
(``ops/vi_kernel.py``, ``csrc/value_iteration.cu``) for a CUDA tensor. The
policy/Q tail then runs in PyTorch on either device.

Every stencil here is an explicit f32 sum of shifted slices in the taps'
order, not ``F.conv2d``: cuDNN runs f32 convolutions in TF32 unless told
otherwise, and the JAX package asks for ``Precision.HIGHEST``. The sums are
separate multiplies and adds, as the kernel does them (no FMA), so kernel
and plain version agree to the bit.
"""
from __future__ import annotations

import numpy as np
import torch

from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda

# Per-action (left, centre, right) tap positions in the 3x3 stencil,
# row-major (ky, kx); the JAX package's ``_LEFT``/``_CENTER``/``_RIGHT``.
_LEFT = [[1, 0], [0, 0], [0, 1], [2, 0], [0, 2], [2, 1], [2, 2], [1, 2]]
_CENTER = [[0, 0], [0, 1], [0, 2], [1, 0], [1, 2], [2, 0], [2, 1], [2, 2]]
_RIGHT = [[0, 1], [0, 2], [1, 2], [0, 0], [2, 2], [1, 0], [2, 0], [2, 1]]

# 8-connected action displacements (row, col), in the policy's action order.
DYNAMICS = np.array(
    [[-1, -1], [-1, 0], [-1, 1], [0, -1], [0, 1], [1, -1], [1, 0], [1, 1]],
    dtype=np.int32,
)

# Per action, the three (ky, kx, weight) taps in summation order.
ACTION_TAPS = tuple(
    tuple((pos[0], pos[1], w)
          for pos, w in ((_LEFT[a], 0.1), (_CENTER[a], 0.8),
                         (_RIGHT[a], 0.1)))
    for a in range(8)
)


def bellman_kernels(num_actions: int = 8) -> np.ndarray:
    """[3, 3, 1, A] HWIO kernels of the 8-action Bellman backup."""
    w = np.zeros((3, 3, 1, num_actions), np.float32)
    for a in range(num_actions):
        w[_LEFT[a][0], _LEFT[a][1], 0, a] += 0.1
        w[_CENTER[a][0], _CENTER[a][1], 0, a] += 0.8
        w[_RIGHT[a][0], _RIGHT[a][1], 0, a] += 0.1
    return w


def action_values(r: torch.Tensor, v: torch.Tensor,
                  discount: float) -> list[torch.Tensor]:
    """Q of each action, [B, H, W] each, from r and v [B, H, W]:
    ``0.1 L + 0.8 C + 0.1 R`` over the zero-padded ``r + discount * v``."""
    H, W = r.shape[-2:]
    p = torch.nn.functional.pad(r + discount * v, (1, 1, 1, 1))
    return [sum(w * p[:, ky:ky + H, kx:kx + W] for ky, kx, w in taps)
            for taps in ACTION_TAPS]


def value_iteration_plain(r: torch.Tensor, discount: float = 0.99,
                          threshold: float = 1e-3,
                          max_iters: int = 2000) -> torch.Tensor:
    """The plain PyTorch solve, r [B, H, W, 1] -> V [B, H, W, 1] f32, on
    any device. The convergence test is batch-global, as the JAX package's
    XLA ``while_loop``. The number of sweeps run is kept in
    ``value_iteration_plain.sweeps``."""
    r = r[..., 0].float()
    v = torch.zeros_like(r)
    limit = float(np.float32(threshold))  # JAX compares in f32
    it = 0
    delta = float("inf")
    while delta > limit and it < max_iters:
        qs = action_values(r, v, discount)
        new_v = qs[0]
        for q in qs[1:]:
            new_v = torch.maximum(new_v, q)
        delta = float((new_v - v).abs().max())
        v = new_v
        it += 1
    value_iteration_plain.sweeps = it
    return v[..., None]


value_iteration_plain.sweeps = 0


def policy_and_q(r: torch.Tensor, v: torch.Tensor, discount: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The tail after the solve (JAX ``value_iteration.py:120-123``):
    Q [B, H, W, A] from r, v [B, H, W, 1], and the softmax policy over
    actions."""
    q = torch.stack(action_values(r[..., 0].float(), v[..., 0], discount),
                    dim=-1)
    policy = torch.softmax(q - q.amax(dim=-1, keepdim=True), dim=-1)
    return policy, q


def value_iteration(r: torch.Tensor, discount: float = 0.99,
                    threshold: float = 1e-3, max_iters: int = 2000
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve the grid MDP: r [B, H, W, 1] -> (v [B, H, W, 1], policy and
    q [B, H, W, 8]). V comes from the plain version for a CPU tensor and
    from the CUDA kernel for a CUDA tensor; anything else raises."""
    if r.device.type == "cpu":
        v = value_iteration_plain(r, discount, threshold, max_iters)
    else:
        v = value_iteration_cuda(r.float().contiguous(), discount, threshold,
                                 max_iters)
    policy, q = policy_and_q(r, v, discount)
    return v, policy, q
