"""Expected state-visitation frequency (SVF) propagation and greedy rollout.

Counterpart of ``creste_public_tpu/ops/svf.py``. Probability mass starts at
s0 and is pushed along the policy for ``horizon`` steps; each action moves
it by one cell of ``DYNAMICS`` with a zero border, and the visitation is
summed over time.

``expected_svf`` runs the plain PyTorch version for a CPU tensor and the
hand-written CUDA kernel (``ops/svf_kernel.py``, ``csrc/svf.cu``) for a CUDA
tensor. Forward only: the policy is detached upstream and the MaxEnt-IRL
gradient flows through ``reward * svf``, never through the propagation.
"""
from __future__ import annotations

import torch

from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
from creste_public_tpu_torch.ops.value_iteration import DYNAMICS


def _propagate(policy_mu: torch.Tensor) -> torch.Tensor:
    """One step: ``new_mu[y, x] = sum_a policy_mu[y - dy_a, x - dx_a, a]``
    with a zero border; [B, H, W, A] -> [B, H, W], summed in a = 0..7."""
    B, H, W, A = policy_mu.shape
    padded = torch.nn.functional.pad(policy_mu, (0, 0, 1, 1, 1, 1))
    out = policy_mu.new_zeros(B, H, W)
    for a in range(A):
        dy, dx = int(DYNAMICS[a, 0]), int(DYNAMICS[a, 1])
        out = out + padded[:, 1 - dy:1 - dy + H, 1 - dx:1 - dx + W, a]
    return out


def sharpen_policy(policy: torch.Tensor, temperature: float) -> torch.Tensor:
    """Temperature-sharpened policy (reference lfd.py:190-194)."""
    logits = policy - policy.amax(dim=-1, keepdim=True)
    return torch.softmax(logits / temperature, dim=-1)


def expected_svf_plain(policy: torch.Tensor, s0: torch.Tensor,
                       s1: torch.Tensor, horizon: int,
                       zero_terminal_state: bool = False) -> torch.Tensor:
    """The plain PyTorch propagation on any device: policy [B, H, W, A],
    s0/s1 [B] linear indices (row * W + col) -> mu [B, H, W] f32.

    Rows 0..T-2 of the visitation enter the sum after the terminal state's
    mass is zeroed (when ``zero_terminal_state``); the last row enters as it
    is, as in the JAX ``scan``."""
    B, H, W, A = policy.shape
    policy = policy.float()
    rows = torch.arange(B, device=policy.device)
    mu = policy.new_zeros(B, H * W)
    mu[rows, s0.long()] = 1.0
    total = torch.zeros_like(mu)
    for _ in range(horizon - 1):
        if zero_terminal_state:
            mu = mu.clone()
            mu[rows, s1.long()] = 0.0
        total = total + mu
        mu = _propagate(policy * mu.reshape(B, H, W, 1)).reshape(B, H * W)
    return (total + mu).reshape(B, H, W)


@torch.no_grad()
def expected_svf(policy: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor,
                 horizon: int, zero_terminal_state: bool = False
                 ) -> torch.Tensor:
    """Summed visitation mass [B, H, W] over ``horizon`` steps: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor; anything
    else raises."""
    if policy.device.type == "cpu":
        return expected_svf_plain(policy, s0, s1, horizon,
                                  zero_terminal_state)
    return expected_svf_cuda(policy, s0, s1, horizon, zero_terminal_state)


@torch.no_grad()
def greedy_rollout(policy: torch.Tensor, s0: torch.Tensor, horizon: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy argmax rollout (reference lfd.py:230-248): policy
    [B, H, W, A], s0 [B] -> states [B, T, 2] (row, col) and the visit counts
    [B, H, W]. ``torch.argmax`` takes the first maximal action, like
    ``jnp.argmax``."""
    B, H, W, A = policy.shape
    dev = policy.device
    flat_best = policy.argmax(dim=-1).reshape(B, H * W)
    dyn = torch.as_tensor(DYNAMICS, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)
    s0 = s0.long()
    coord = torch.stack([s0 // W, s0 % W], dim=1)
    traj = [coord]
    for _ in range(horizon - 1):
        action = flat_best[rows, coord[:, 0] * W + coord[:, 1]]
        nxt = coord + dyn[action]
        coord = torch.stack([nxt[:, 0].clamp(0, H - 1),
                             nxt[:, 1].clamp(0, W - 1)], dim=1)
        traj.append(coord)
    states = torch.stack(traj, dim=1)
    grid = torch.zeros(B, H, W, device=dev)
    grid.index_put_((rows[:, None].expand(B, horizon), states[..., 0],
                     states[..., 1]), torch.ones(B, horizon, device=dev),
                    accumulate=True)
    return states, grid
