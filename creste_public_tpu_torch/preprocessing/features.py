"""Foundation-model feature labels: the extractor interface and PCA.

Counterpart of ``creste_public_tpu/preprocessing/features.py`` (reference
scripts/preprocessing/create_pe_dataset.py:420-526: DINOv2 patch features
-> PCA to 128 dims -> bilinear resize to the backbone's feature resolution
-> .npy labels; creste/utils/feature_extractor.py:54-109
``compute_pca_reduction`` over <= 100k sampled feature vectors).

The PCA (an economy SVD), the projection and the resize run in torch on a
device. Two things differ by solver and by library, and are pinned here:

  * the sign of each principal component: LAPACK and cuSOLVER choose it
    differently, so each component is flipped to make its entry of
    largest magnitude positive; the JAX package keeps LAPACK's sign, so
    the two agree up to a sign per component;
  * the resize: ``jax.image.resize`` antialiases when it shrinks, as
    ``convnets.resize_bilinear_antialiased`` does; ``F.interpolate``
    alone would not.

The foundation model sits behind ``FeatureExtractor``: DINOv2 through HF
transformers when its weights are on disk (they are never fetched),
otherwise a seeded random projection at the same stride-dense grid
(``build_extractor("auto")``).
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from creste_public_tpu_torch.models.blocks.convnets import (
    resize_bilinear_antialiased,
)
from creste_public_tpu_torch.utils.device import resolve_device
from creste_public_tpu_torch.utils.hf_weights import weights_on_disk


class FeatureExtractor(Protocol):
    feature_dim: int

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] float images -> [B, hp, wp, D] patch features."""
        ...


def pca_fit(samples: torch.Tensor, k: int = 128
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit a k-dim PCA basis on [N, D] feature samples (on their device).
    Returns (mean [D], components [D, k]) in f32, each component's entry of
    largest magnitude positive.

    The samples are centred in f32, as the JAX package centres them, and
    decomposed in f64: cuSOLVER's f32 SVD of a 100k x 768 matrix returns
    components orthonormal only to ~4e-4 on an H100."""
    x = samples.float()
    mean = x.mean(dim=0)
    _, _, vt = torch.linalg.svd((x - mean).double(), full_matrices=False)
    comps = vt[:k].T.float()
    big = comps.abs().argmax(dim=0)
    sign = torch.sign(comps[big, torch.arange(comps.shape[1],
                                              device=comps.device)])
    return mean, comps * torch.where(sign == 0, 1.0, sign)


def pca_project_resize(feats: torch.Tensor, mean: torch.Tensor,
                       components: torch.Tensor, out_hw: tuple[int, int]
                       ) -> torch.Tensor:
    """[B, hp, wp, D] -> the centred PCA projection [B, H, W, k], resized
    bilinearly (antialiased when it shrinks) to the backbone's feature
    resolution (create_pe_dataset.py:441-510)."""
    proj = (feats.float() - mean) @ components
    out = resize_bilinear_antialiased(proj.permute(0, 3, 1, 2), out_hw)
    return out.permute(0, 2, 3, 1)


def sample_features(
    feats_list: list[np.ndarray], max_samples: int = 100_000, seed: int = 0
) -> np.ndarray:
    """Uniformly sample <= max_samples feature vectors across frames."""
    flat = np.concatenate([f.reshape(-1, f.shape[-1]) for f in feats_list])
    if len(flat) <= max_samples:
        return flat
    rng = np.random.default_rng(seed)
    return flat[rng.choice(len(flat), max_samples, replace=False)]


def pca_rgb_visualization(proj: np.ndarray) -> np.ndarray:
    """First 3 PCA channels -> [0,1] RGB (VIS_FEATS, create_pe_dataset.py:513)."""
    rgb = proj[..., :3]
    lo = rgb.min(axis=tuple(range(rgb.ndim - 1)), keepdims=True)
    hi = rgb.max(axis=tuple(range(rgb.ndim - 1)), keepdims=True)
    return (rgb - lo) / np.maximum(hi - lo, 1e-8)


def patch_grid_shape(h: int, w: int, patch: int, stride: int) -> tuple[int, int]:
    """Dense-ViT patch grid for an input: 1 + (dim - patch) // stride
    (feature_extractor.py:204-206; the stride-7 chain behind the
    reference's DINO_OUTPUT_SHAPES table, create_pe_dataset.py:247-266)."""
    return 1 + (h - patch) // stride, 1 + (w - patch) // stride


def dino_input_shape(model: str, img_hw: tuple[int, int]) -> tuple[int, int]:
    """The reference's INPUT_SHAPES crop (create_pe_dataset.py:247-258):
    images are shrunk to a patch-size-aligned size minus one patch."""
    h, w = img_hw
    if model == "dinov2":
        patch = 14
        return (h // patch * patch - patch, w // patch * patch - patch)
    if model == "dinov1":
        return (h - 8, w - 8)
    raise ValueError(model)


class RandomProjectionExtractor:
    """Seeded stand-in extractor (tests, machines without the weights):
    patch features are a fixed random projection of the patch pixels at
    the same stride-dense grid the real extractor gives, so they are
    deterministic, spatially coherent and at the label resolution. The
    projection runs in torch on ``device``; the matrix is the JAX
    package's (the same NumPy draw)."""

    def __init__(self, feature_dim: int = 768, patch: int = 14, seed: int = 0,
                 stride: int | None = None,
                 device: str | torch.device = "cuda"):
        self.feature_dim = feature_dim
        self.patch = patch
        self.stride = stride or patch
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        # f32 draws over an f64 scale: NumPy promotes to f64, and the JAX
        # package projects in f64 with it
        w = rng.normal(size=(patch * patch * 3, feature_dim)).astype(
            np.float32) / np.sqrt(patch * patch * 3)
        self._w = torch.from_numpy(w).to(self.device)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        p, s = self.patch, self.stride
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        B, H, W, C = x.shape
        hp, wp = patch_grid_shape(H, W, p, s)
        # [B, hp, wp, C, p, p] windows -> rows of (py, px, c)
        x = x.unfold(1, p, s).unfold(2, p, s)[:, :hp, :wp]
        x = x.permute(0, 1, 2, 4, 5, 3).reshape(B, hp, wp, p * p * C)
        return (x.to(self._w.dtype) @ self._w).cpu().numpy()


def patch_vit_stride(model, stride: int):
    """Patch an HF DINOv2/ViT model for dense stride-s extraction.

    Reference: ViTExtractor.patch_vit_resolution + _fix_pos_enc
    (feature_extractor.py:196-261): the patch-embedding conv's stride is
    reduced and the positional embeddings are bicubic-interpolated to the
    1 + (dim - patch)//stride grid. Returns the model (modified in place).
    """
    import math
    import types

    import torch.nn.functional as F

    patch = model.config.patch_size
    if stride == patch:
        return model
    assert (patch // stride) * stride == patch, (
        f"stride {stride} should divide patch_size {patch}")
    emb = model.embeddings
    emb.patch_embeddings.projection.stride = (stride, stride)

    def interpolate_pos_encoding(self, embeddings, height, width):
        npatch = embeddings.shape[1] - 1
        N = self.position_embeddings.shape[1] - 1
        class_pos = self.position_embeddings[:, :1]
        patch_pos = self.position_embeddings[:, 1:]
        dim = embeddings.shape[-1]
        h0, w0 = patch_grid_shape(height, width, patch, stride)
        assert h0 * w0 == npatch, (h0, w0, npatch)
        side = int(math.sqrt(N))
        patch_pos = F.interpolate(
            patch_pos.reshape(1, side, side, dim).permute(0, 3, 1, 2),
            size=(h0, w0), mode="bicubic", align_corners=False,
        )
        patch_pos = patch_pos.permute(0, 2, 3, 1).reshape(1, -1, dim)
        return torch.cat((class_pos, patch_pos), dim=1)

    emb.interpolate_pos_encoding = types.MethodType(
        interpolate_pos_encoding, emb)
    return model


class DinoV2Extractor:
    """DINOv2 patch features via HF transformers, on ``device``, with
    the reference's dense-extraction settings: stride-7 patch conv +
    interpolated positional embeddings, layer-11 'key' facet descriptors
    (feature_extractor.py:236,286-343; create_pe_dataset.py:420-439).

    Used for real label generation when the pretrained weights are present
    in the local HF cache; raises ImportError/OSError otherwise (callers
    fall back to RandomProjectionExtractor at the same stride)."""

    def __init__(self, model_name: str = "facebook/dinov2-base",
                 stride: int = 7, layer: int = 11, facet: str = "key",
                 model=None, device: str | torch.device = "cuda"):
        from transformers import AutoModel

        self.device = resolve_device(device)
        self.model = (model if model is not None
                      else AutoModel.from_pretrained(
                          model_name, local_files_only=True)).eval()
        self.model.to(self.device)
        self.patch = self.model.config.patch_size
        self.stride = stride
        self.layer = layer
        self.facet = facet
        patch_vit_stride(self.model, stride)
        self.feature_dim = self.model.config.hidden_size
        self._mean = np.array([0.485, 0.456, 0.406], np.float32)
        self._std = np.array([0.229, 0.224, 0.225], np.float32)
        self._feats: list = []
        if facet != "token":
            self._register_facet_hook()

    def _register_facet_hook(self):
        """Capture per-head q/k/v of the attention block (the reference's
        _get_hook 'key' facet, feature_extractor.py:286-316)."""
        idx = {"query": 0, "key": 1, "value": 2}[self.facet]
        block = self.model.encoder.layer[self.layer].attention.attention

        def hook(module, args, kwargs, output):
            x = args[0] if args else kwargs["hidden_states"]
            B, N, C = x.shape
            if idx == 0:
                f = module.query(x)
            elif idx == 1:
                f = module.key(x)
            else:
                f = module.value(x)
            self._feats.append(f.reshape(B, N, C))

        block.register_forward_hook(hook, with_kwargs=True)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        B, H, W, C = images.shape
        h, w = dino_input_shape("dinov2", (H, W))
        if (h, w) != (H, W):
            # the reference shrinks the WHOLE frame to the DINO input size
            # (transforms.Resize, feature_extractor.py:276-283) — cropping
            # would misalign the feature grid against the image
            from PIL import Image

            images = np.stack([
                np.asarray(Image.fromarray(
                    (im * 255).astype(np.uint8)).resize(
                    (w, h), Image.BILINEAR), np.float32) / 255.0
                for im in images
            ])
        with torch.no_grad():
            x = torch.from_numpy(
                ((images - self._mean) / self._std)
                .transpose(0, 3, 1, 2).astype(np.float32)).to(self.device)
            self._feats = []
            out = self.model(x, interpolate_pos_encoding=True)
            if self.facet == "token":
                feats = out.last_hidden_state[:, 1:]
            else:
                feats = self._feats[-1][:, 1:]
            hp, wp = patch_grid_shape(h, w, self.patch, self.stride)
            return feats.reshape(B, hp, wp, -1).cpu().numpy()


def build_extractor(name: str = "auto", stride: int = 7,
                    device: str | torch.device = "cuda",
                    **kwargs) -> FeatureExtractor:
    if name in ("auto", "dinov2"):
        # CRESTE_DINOV2_MODEL points at a local HF checkpoint dir (or an
        # alternate hub id); unset -> facebook/dinov2-base from the hub
        # cache (reference torch.hub dinov2_vitb14,
        # feature_extractor.py:176-178)
        import os

        kwargs.setdefault("model_name", os.environ.get(
            "CRESTE_DINOV2_MODEL") or "facebook/dinov2-base")
        if (name == "dinov2" or "model" in kwargs
                or weights_on_disk(kwargs["model_name"])):
            try:
                return DinoV2Extractor(stride=stride, device=device,
                                       **kwargs)
            except Exception:
                if name == "dinov2":
                    raise
    # fallback keeps the reference's stride-dense label resolution
    return RandomProjectionExtractor(stride=stride, device=device)
