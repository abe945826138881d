"""Temporal BEV aggregation: stacked ConvGRU / MRU cells and the MergeUnit.

Counterpart of ``creste_public_tpu/models/blocks/convgru.py`` (reference
convgru.py:13-349 and rnn.py:8-146):

  * GRU cell: gates = sigmoid(conv([x, h])); candidate = tanh(conv([x,
    reset * h])); h' = (1 - update) h + update * candidate. MRU: one gate
    is both reset and update. 'simple': h' = x + h.
  * ConvGRU: the layers run over the frame axis; with ``use_pose`` the
    hidden state is warped into each incoming frame by the relative SE(2)
    affine ``inv(_2d(pose_t)) @ _2d(pose_{t-1})`` (noisified with
    ``noisy_pose``, offset by the z-MLP with ``use_z``) before the cell
    update, and a hidden entry is ``(h, cell_pose, valid)``: a fresh
    sequence has no previous pose, so its first frame keeps h unwarped.
  * MergeUnit: an optional 1x1 conv + BN + ReLU before the RNN, channel
    groups folded into the batch, the begin-of-sequence reset of the hidden
    state, and the returned hidden state out of the graph (the reference's
    detached cross-chunk state).

Maps are NHWC at the interfaces, as in the JAX package. Pose noise comes
from an explicit source: a ``torch.Generator`` (drawn on the CPU, so that a
seed gives the same noise on the card and on the CPU) or fed draws; a
noisy-pose forward without one raises, as the JAX module does without its
'noise' rng. The submodules carry the flax scope names.
"""
from __future__ import annotations

from typing import Any, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    Conv2d,
    Linear,
    SameConv2d,
)
from creste_public_tpu_torch.ops.warp import (
    affine_warp,
    noisify_affine,
    relative_bev_affine,
)

# a generator, or per recurrent layer the fed standard-normal draws
# (rotation [B, T], translation [B, T, 2])
PoseNoise = Union[torch.Generator,
                  Sequence[tuple[torch.Tensor, torch.Tensor]], None]


def _conv(in_ch: int, out_ch: int, kernel: Sequence[int]) -> Conv2d:
    """flax ``nn.Conv(padding="SAME")``: an odd kernel pads ``k // 2`` on
    both sides of its axis; an even one pads as lax does, ``(k - 1) // 2``
    before and ``k // 2`` after (``SameConv2d``)."""
    kh, kw = (int(k) for k in kernel)
    if kh % 2 == 0 or kw % 2 == 0:
        return SameConv2d(in_ch, out_ch, (kh, kw))
    return Conv2d(in_ch, out_ch, (kh, kw), padding=(kh // 2, kw // 2))


class ConvGRUCell(nn.Module):
    """One recurrent cell over NHWC maps; cell_type 'GRU', 'MRU' or
    'simple' (no parameters)."""

    def __init__(self, in_ch: int, hidden_dim: int,
                 kernel: Sequence[int] = (1, 1), cell_type: str = "GRU"):
        super().__init__()
        if cell_type not in ("GRU", "MRU", "simple"):
            raise ValueError(f"Unknown cell_type: {cell_type}")
        self.hidden_dim = hidden_dim
        self.cell_type = cell_type
        if cell_type != "simple":
            n_gates = 2 if cell_type == "GRU" else 1
            self.conv_gates = _conv(in_ch + hidden_dim, hidden_dim * n_gates,
                                    kernel)
            self.conv_can = _conv(in_ch + hidden_dim, hidden_dim, kernel)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        if self.cell_type == "simple":
            return x + h
        xc = x.permute(0, 3, 1, 2)
        hc = h.permute(0, 3, 1, 2)
        gates = self.conv_gates(torch.cat([xc, hc], 1))
        if self.cell_type == "GRU":
            reset = torch.sigmoid(gates[:, :self.hidden_dim])
            update = torch.sigmoid(gates[:, self.hidden_dim:])
        else:
            reset = update = torch.sigmoid(gates)
        cand = torch.tanh(self.conv_can(torch.cat([xc, reset * hc], 1)))
        return ((1.0 - update) * hc + update * cand).permute(0, 2, 3, 1)


def pose_noise_draws(noise: PoseNoise, layer: int, B: int, T: int,
                     device: torch.device
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer ``layer``'s standard-normal pose noise: (rotation [B, T],
    translation [B, T, 2]) from a generator, or the fed pair."""
    if noise is None:
        raise ValueError(
            "ConvGRU(noisy_pose=True) needs a noise source (a "
            "torch.Generator or fed draws): the reference noisifies the "
            "pose on every forward (convgru.py:289-290)")
    if isinstance(noise, torch.Generator):
        rot = torch.randn((B, T), generator=noise)
        trans = torch.randn((B, T, 2), generator=noise)
    else:
        rot, trans = noise[layer]
        if tuple(rot.shape) != (B, T) or tuple(trans.shape) != (B, T, 2):
            raise ValueError(f"pose noise of shapes {tuple(rot.shape)}, "
                             f"{tuple(trans.shape)}; expected ({B}, {T}) "
                             f"and ({B}, {T}, 2)")
    return rot.to(device, torch.float32), trans.to(device, torch.float32)


class ConvGRU(nn.Module):
    """Stacked ConvGRU layers over the frame axis: x [B, T, H, W, C] ->
    (outputs [B, T, H, W, C_last], the last hidden entry of each layer).
    With ``use_pose``, ``pose`` is [B, T, 4, 4] (or [B, T, L, 4, 4] per
    layer) and a hidden entry is (h [B, H, W, C_l], cell_pose [B, 4, 4],
    valid [B] bool)."""

    def __init__(self, in_ch: int, hidden_dims: Sequence[int],
                 kernel: Sequence[int] = (1, 1), cell_type: str = "GRU",
                 use_pose: bool = False, noisy_pose: bool = False,
                 use_z: bool = False):
        super().__init__()
        self.hidden_dims = [int(h) for h in hidden_dims]
        self.use_pose = use_pose
        self.noisy_pose = noisy_pose
        self.use_z = use_z and use_pose
        c = in_ch
        for li, hdim in enumerate(self.hidden_dims):
            self.add_module(f"cell_{li}", ConvGRUCell(c, hdim, kernel,
                                                      cell_type))
            c = hdim
        if self.use_z:
            # one z-conditioning MLP, as the reference has (convgru.py:
            # 172-178)
            if len(self.hidden_dims) != 1:
                raise ValueError("use_z supports a single recurrent layer")
            hdim = self.hidden_dims[0]
            self.z_map_0 = Linear(1, hdim)
            self.z_map_2 = Linear(hdim, hdim)

    def forward(self, x: torch.Tensor, hidden: Sequence[Any] | None = None,
                pose: torch.Tensor | None = None, noise: PoseNoise = None
                ) -> tuple[torch.Tensor, list[Any]]:
        B, T, H, W, _ = x.shape
        L = len(self.hidden_dims)
        dev = x.device
        if self.use_pose:
            if pose is None:
                raise ValueError("use_pose requires per-step poses")
            if pose.dim() == 4:  # [B, T, 4, 4] shared across layers
                pose = pose[:, :, None].expand(B, T, L, 4, 4)
        finals: list[Any] = []
        for li, hdim in enumerate(self.hidden_dims):
            cell = getattr(self, f"cell_{li}")
            carried = hidden[li] if hidden is not None else None
            ys = []
            if not self.use_pose:
                h = (carried if carried is not None
                     else x.new_zeros((B, H, W, hdim)))
                for t in range(T):
                    h = cell(x[:, t], h)
                    ys.append(h)
                finals.append(h)
                x = torch.stack(ys, 1)
                continue

            if carried is not None:
                h, cp0, valid0 = carried
                # an invalid entry's cell pose is never used (its frame
                # keeps h unwarped); the identity keeps the inverse
                # defined where a zero template stands in for it
                cp0 = torch.where(valid0[:, None, None], cp0,
                                  torch.eye(4, dtype=cp0.dtype, device=dev))
            else:
                h = x.new_zeros((B, H, W, hdim))
                cp0 = torch.eye(4, dtype=x.dtype, device=dev).expand(B, 4, 4)
                valid0 = torch.zeros(B, dtype=torch.bool, device=dev)
            pl = pose[:, :, li]  # [B, T, 4, 4]
            # the cell pose at step t is pose_{t-1} (the carried one at t=0)
            prev = torch.cat([cp0[:, None], pl[:, :-1]], 1)
            M = relative_bev_affine(pl, prev)  # [B, T, 2, 3]
            if self.noisy_pose:
                rot, trans = pose_noise_draws(noise, li, B, T, dev)
                M = noisify_affine(M, rot, trans)
            valid = torch.cat([valid0[:, None],
                               torch.ones((B, T - 1), dtype=torch.bool,
                                          device=dev)], 1)
            zadd = None
            if self.use_z:
                dz = (-pl[:, :, 2, 3] + prev[:, :, 2, 3])[..., None]
                zadd = torch.tanh(self.z_map_2(F.relu(self.z_map_0(dz))))
            for t in range(T):
                warped, _ = affine_warp(h, M[:, t], with_mask=False)
                if zadd is not None:
                    warped = warped + zadd[:, t, None, None, :].to(h.dtype)
                h = torch.where(valid[:, t, None, None, None], warped, h)
                h = cell(x[:, t], h)
                ys.append(h)
            finals.append((h, pl[:, -1],
                           torch.ones(B, dtype=torch.bool, device=dev)))
            x = torch.stack(ys, 1)
        return x, finals


def detach_hidden(hidden: Sequence[Any]) -> list[Any]:
    """A hidden-state list with every tensor out of the graph."""
    return [tuple(t.detach() for t in h) if isinstance(h, tuple)
            else h.detach() for h in hidden]


class MergeUnit(nn.Module):
    """Temporal merge of BEV feature chunks (reference rnn.py:8-146).

    cfg keys: rnn_input_channels (an optional 1x1 conv + BN + ReLU first),
    rnn_config {hidden_dims, kernel_size, groups, cell_type, force_bos,
    use_pose, noisy_pose, use_z}; no rnn_config passes through. ``in_ch``
    is the BEV features' channel count."""

    def __init__(self, cfg: Any, in_ch: int):
        super().__init__()
        rnn_in = cfg.get("rnn_input_channels", None)
        self.pre_rnn = rnn_in is not None
        if self.pre_rnn:
            self.pre_rnn_conv = Conv2d(in_ch, int(rnn_in), 1, bias=False)
            self.pre_rnn_bn = BatchNorm(int(rnn_in))
            in_ch = int(rnn_in)
        self.rnn_cfg = cfg.get("rnn_config", None)
        if self.rnn_cfg is None:
            return
        self.groups = int(self.rnn_cfg.get("groups", 1))
        if in_ch % self.groups:
            raise ValueError("channels must divide groups")
        self.use_pose = bool(self.rnn_cfg.get("use_pose", False))
        self.rnn = ConvGRU(
            in_ch // self.groups,
            [int(h) // self.groups for h in self.rnn_cfg["hidden_dims"]],
            kernel=tuple(self.rnn_cfg.get("kernel_size", (1, 1))),
            cell_type=self.rnn_cfg.get("cell_type", "GRU"),
            use_pose=self.use_pose,
            noisy_pose=bool(self.rnn_cfg.get("noisy_pose", False)),
            use_z=bool(self.rnn_cfg.get("use_z", False)))

    def forward(self, x: torch.Tensor, t: int = 1,
                hidden: Sequence[Any] | None = None, bos: bool = True,
                pose: torch.Tensor | None = None, noise: PoseNoise = None):
        """x [B*T, H, W, C] BEV features, ``t`` frames per chunk; ``hidden``
        the previous chunk's hidden state (ignored at ``bos``); ``pose``
        [B*T, 4, 4] with ``use_pose``. Returns the merged features
        [B*T, H, W, C'] and, with an RNN, the next chunk's hidden state
        (out of the graph)."""
        if self.pre_rnn:
            y = self.pre_rnn_conv(x.permute(0, 3, 1, 2).contiguous())
            x = F.relu(self.pre_rnn_bn(y)).permute(0, 2, 3, 1)
        if self.rnn_cfg is None:
            return x
        if self.rnn_cfg.get("force_bos", False):
            t, bos = 1, True
        bt, H, W, C = x.shape
        b, g = bt // t, self.groups
        # groups folded into the batch: [b, t, H, W, g, C/g] -> [b*g, ...]
        xg = x.reshape(b, t, H, W, g, C // g).permute(0, 4, 1, 2, 3, 5)
        xg = xg.reshape(b * g, t, H, W, C // g)
        pose_g = None
        if self.use_pose:
            if pose is None:
                raise ValueError("rnn_config.use_pose requires poses")
            # the fold is b-major (row b*g + i), so each row's pose repeats
            pose_g = torch.repeat_interleave(pose.reshape(b, t, 4, 4), g,
                                             dim=0)
        ys, finals = self.rnn(xg, None if bos else hidden, pose=pose_g,
                              noise=noise)
        Cl = ys.shape[-1]
        ys = ys.reshape(b, g, t, H, W, Cl).permute(0, 2, 3, 4, 1, 5)
        return ys.reshape(bt, H, W, g * Cl), detach_hidden(finals)
