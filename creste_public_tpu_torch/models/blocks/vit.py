"""DINOv2-style Vision Transformer (PyTorch; NHWC at its interface).

Counterpart of ``creste_public_tpu/models/blocks/vit.py`` (reference
ViTExtractor, creste/utils/feature_extractor.py:111-343): patch 14 by
default, a cls token, pre-norm blocks with LayerScale, and the learned
position embeddings of the pretraining grid resized to the input's patch
grid (``patch_vit_resolution``, feature_extractor.py:236). Submodules and
parameters carry the flax names (``patch_embed``, ``cls_token``,
``pos_embed``, ``block_i`` with ``norm1``, ``attn.qkv``, ``attn.proj``,
``ls1``, ``norm2``, ``fc1``, ``fc2``, ``ls2``, and ``norm``).

As flax: LayerNorm epsilon 1e-6; exact (erf) GELU; the attention logits
and softmax in f32; the patch convolution reads the input cropped to a
multiple of the patch; the position grid is resized with
``jax.image.resize(..., "bilinear")``'s antialiased kernel
(``convnets.resize_bilinear_antialiased``), a downsample when the patch
grid is smaller than the pretraining grid.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    Conv2d,
    Linear,
    resize_bilinear_antialiased,
)

LN_EPS = 1e-6  # flax nn.LayerNorm's default


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, h, D // h).permute(
            2, 0, 3, 1, 4)
        dt = torch.promote_types(x.dtype, torch.float32)
        attn = torch.einsum("bhnd,bhmd->bhnm", q.to(dt), k.to(dt)
                            ) / math.sqrt(D // h)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhnm,bhmd->bhnd", attn, v.to(attn.dtype))
        out = out.permute(0, 2, 1, 3).reshape(B, N, D)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layerscale: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = Linear(dim, int(dim * mlp_ratio))
        self.fc2 = Linear(int(dim * mlp_ratio), dim)
        self.layerscale = layerscale
        if layerscale:
            self.ls1 = nn.Parameter(torch.full((dim,), 1e-5))
            self.ls2 = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attn(self.norm1(x))
        x = x + (self.ls1 * y if self.layerscale else y)
        z = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="none"))
        return x + (self.ls2 * z if self.layerscale else z)


class VisionTransformer(nn.Module):
    """DINOv2-shaped ViT returning patch-token features.

    cfg keys: embed_dim (768), depth (12), num_heads (12), patch_size (14),
    pos_grid (pretraining grid, 37 for 518/14), layerscale (True).
    """

    def __init__(self, cfg: Any, in_ch: int = 3):
        super().__init__()
        D = int(cfg.get("embed_dim", 768))
        self.depth = int(cfg.get("depth", 12))
        heads = int(cfg.get("num_heads", 12))
        self.patch = int(cfg.get("patch_size", 14))
        self.pos_grid = int(cfg.get("pos_grid", 37))
        self.patch_embed = Conv2d(in_ch, D, self.patch, self.patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(
            0.02 * torch.randn(1, self.pos_grid ** 2 + 1, D))
        for i in range(self.depth):
            self.add_module(f"block_{i}", Block(
                D, heads, layerscale=bool(cfg.get("layerscale", True))))
        self.norm = nn.LayerNorm(D, eps=LN_EPS)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] (ImageNet-normalised) -> [B, hp, wp, D]."""
        B, H, W, _ = images.shape
        p, G = self.patch, self.pos_grid
        hp, wp = H // p, W // p
        x = self.patch_embed(
            images[:, :hp * p, :wp * p].permute(0, 3, 1, 2))
        D = x.shape[1]
        x = x.flatten(2).transpose(1, 2)  # [B, hp*wp, D]
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        pos_patch = resize_bilinear_antialiased(
            pos_patch.reshape(1, G, G, D).permute(0, 3, 1, 2), (hp, wp))
        pos_patch = pos_patch.permute(0, 2, 3, 1).reshape(1, hp * wp, D)
        x = x + pos_patch
        cls = (self.cls_token + pos_cls).expand(B, 1, D)
        x = torch.cat([cls, x], dim=1)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        x = self.norm(x)
        return x[:, 1:].reshape(B, hp, wp, D)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    mean = images.new_tensor(IMAGENET_MEAN)
    std = images.new_tensor(IMAGENET_STD)
    return (images - mean) / std
