"""Behaviour-cloning action head: conv trunk + MLP (NHWC at its
interface).

Counterpart of ``creste_public_tpu/models/blocks/cnnmlp.py`` (reference
creste/models/blocks/cnnmlp.py:8-74): early-fusion concat of the
configured input maps, a MultiLayerConv trunk (``conv``), flatten, an MLP
(``mlp.fc_i``) with a ReLU after every layer. As flax's ``nn.Dense``
infers its input width, the first layer reads whatever the flattened trunk
gives (``dims[0]`` is not read): ``fc_0`` is a lazy linear layer, sized by
the first call or by the weights loaded into it.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    Linear,
    MultiLayerConv,
    promoted,
)


class _LazyLinear(nn.LazyLinear):
    """``nn.LazyLinear`` computing in the promotion of its input's and
    weights' dtypes, as ``convnets.Linear``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*promoted(x, self.weight, self.bias))


class MultiLayerPerceptron(nn.Module):
    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.n = len(dims) - 1
        for i, d in enumerate(dims[1:]):
            self.add_module(f"fc_{i}", _LazyLinear(d) if i == 0
                            else Linear(dims[i], d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = F.relu(getattr(self, f"fc_{i}")(x))
        return x


class CnnMLP(nn.Module):
    """cfg keys: input_keys, cnn_cfg {net_kwargs: MultiLayerConv cfg},
    mlp_cfg {net_kwargs: {dims}}."""

    def __init__(self, cfg: Any):
        super().__init__()
        self.input_keys = list(cfg["input_keys"])
        self.conv = MultiLayerConv(cfg["cnn_cfg"]["net_kwargs"])
        self.mlp = MultiLayerPerceptron(
            tuple(cfg["mlp_cfg"]["net_kwargs"]["dims"]))

    def forward(self, inputs: dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([inputs[k] for k in self.input_keys], dim=-1)
        x = self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.mlp(x.reshape(x.shape[0], -1))
