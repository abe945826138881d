"""Supervised pixel-contrastive loss: capped per-class sampling and the
multi-positive contrastive loss.

Counterpart of ``creste_public_tpu/losses/supcon.py`` (reference
loss_utils.py:203-286 and supcon_loss.py:56-116): labels made distinct per
batch element, up to min(median class count, 1000) samples per class drawn
into a static budget of ``max_samples`` slots with a validity mask, and the
soft cross-entropy against the normalised positive distribution. Under
data parallelism the anchors of each rank are contrasted with the features
of every rank (``multi_pos_con_loss``'s ``group``).

Given the same priorities the selection equals the JAX package's to the
bit. Torch cannot reproduce ``jax.random.uniform``'s bits, so a priority
source is a ``torch.Generator`` (drawn on the CPU, as the drop-connect
masks are) or a fed tensor; ``None`` gives zeros (the deterministic
selection of ``rng=None``).
"""
from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from creste_public_tpu_torch.parallel import (
    Group,
    all_gather_rows,
    all_gather_with_grad,
    rank,
    world_size,
)

PrioritySource = Union[torch.Generator, torch.Tensor, None]

# sorts after every valid label: labels are int32, the sort key int64
_INVALID_KEY = 2 ** 40


def remap_labels_per_batch(labels: torch.Tensor,
                           ignore_idx: int = 0) -> torch.Tensor:
    """Instance labels made distinct across batch elements: row ``b`` is
    offset by ``b * 2**20``; ``ignore_idx`` stays ``ignore_idx``."""
    B = labels.shape[0]
    offsets = (torch.arange(B, dtype=labels.dtype, device=labels.device)
               * 2 ** 20).reshape((B,) + (1,) * (labels.dim() - 1))
    return torch.where(labels == ignore_idx,
                       torch.full_like(labels, ignore_idx), labels + offsets)


def _kth_smallest_positive(values: torch.Tensor,
                           k: torch.Tensor) -> torch.Tensor:
    """The k-th smallest (0-based) of the positive entries of the integer
    ``values``; the caller guarantees k + 1 of them. A sort, with the
    non-positive entries pushed past every positive one."""
    big = torch.iinfo(values.dtype).max
    ordered = torch.sort(torch.where(values > 0, values,
                                     torch.full_like(values, big))).values
    return ordered.gather(0, k.reshape(1))[0]


def priorities(source: PrioritySource, n: int,
               device: torch.device) -> torch.Tensor:
    """[n] f32 sampling priorities on ``device`` from ``source``."""
    if source is None:
        return torch.zeros(n, device=device)
    if isinstance(source, torch.Generator):
        return torch.rand(n, generator=source).to(device)
    if tuple(source.shape) != (n,):
        raise ValueError(f"priorities of shape {tuple(source.shape)}, "
                         f"expected ({n},)")
    return source.to(device=device, dtype=torch.float32)


def capped_class_sample(labels: torch.Tensor, valid: torch.Tensor,
                        max_samples: int, cap: int = 1000,
                        rng: PrioritySource = None, use_median: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Select up to min(median class count, cap) elements per class (only
    ``cap`` when ``use_median`` is off).

    Elements are ordered by (valid first, label, priority, index); the first
    k of each class are kept, and the first ``max_samples`` kept ones fill
    the slots in that order. Returns idx [max_samples] (int64 indices into
    the flat arrays, 0 in empty slots) and the slot-validity mask."""
    N = labels.shape[0]
    dev = labels.device
    pri = priorities(rng, N, dev)
    key = torch.where(valid, labels.long(),
                      torch.full((N,), _INVALID_KEY, dtype=torch.long,
                                 device=dev))
    # two stable sorts: by priority, then by key, ties kept in index order
    by_pri = torch.sort(pri, stable=True).indices
    order = by_pri[torch.sort(key[by_pri], stable=True).indices]
    sorted_key = key[order]
    sorted_valid = valid[order]

    pos = torch.arange(N, device=dev)
    change = sorted_key[1:] != sorted_key[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_first = torch.cat([one, change])
    is_last = torch.cat([change, one])
    first_pos = torch.cummax(torch.where(is_first, pos, -1), 0).values
    last_pos = torch.cummin(torch.where(is_last, pos, N).flip(0),
                            0).values.flip(0)
    rank = pos - first_pos
    sizes = last_pos - first_pos + 1

    # the lower median of the class sizes (torch's .median() in the
    # reference), capped
    class_sizes = torch.where(is_first & sorted_valid, sizes, 0)
    n_classes = (class_sizes > 0).sum()
    med_idx = torch.where(n_classes % 2 == 0,
                          torch.clamp(n_classes // 2 - 1, min=0),
                          n_classes // 2)
    median = torch.where(n_classes > 0,
                         _kth_smallest_positive(class_sizes, med_idx),
                         torch.zeros_like(n_classes))
    k = torch.clamp(median, max=cap) if use_median else cap

    keep = sorted_valid & (rank < k)
    # kept elements score distinct descending values in position order, so
    # the top m_eff come out in slot order
    m_eff = min(max_samples, N)
    score = torch.where(keep, N - pos, 0)
    top, ti = torch.topk(score, m_eff)
    idx = torch.where(top > 0, order[ti], 0)
    sel_valid = torch.arange(m_eff, device=dev) < keep.sum()
    if m_eff < max_samples:
        pad = max_samples - m_eff
        idx = torch.cat([idx, idx.new_zeros(pad)])
        sel_valid = torch.cat([sel_valid, sel_valid.new_zeros(pad)])
    return idx, sel_valid


def multi_pos_con_loss(feats: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, temperature: float = 0.1,
                       class_weights: torch.Tensor | None = None,
                       group: Group = None) -> torch.Tensor:
    """Multi-positive contrastive loss of this rank's [M, Z] features, [M]
    labels and [M] slot validity as anchors against the features of every
    rank of ``group`` (gathered with a gradient, labels and validity
    without one, as the JAX package's ``axis_name``); ``group=None``: this
    process's features only."""
    # rsqrt(sumsq + eps): the norm's gradient at a zero vector would be NaN
    feats = feats * torch.rsqrt((feats * feats).sum(-1, keepdim=True)
                                + 1e-12)
    M = feats.shape[0]
    if group is not None:
        all_feats = all_gather_with_grad(feats, group)  # [D * M, Z]
        all_labels = all_gather_rows(labels, group)
        all_valid = all_gather_rows(valid, group)
    else:
        all_feats, all_labels, all_valid = feats, labels, valid

    # self-exclusion at this rank's diagonal block
    self_idx = torch.arange(M, device=feats.device) + rank(group) * M
    logits_mask = torch.ones(M, world_size(group) * M, device=feats.device)
    logits_mask[torch.arange(M, device=feats.device), self_idx] = 0.0
    pair_valid = valid[:, None] & all_valid[None, :]
    mask = ((labels[:, None] == all_labels[None, :]).float() * logits_mask
            * pair_valid)

    logits = feats @ all_feats.T / temperature
    logits = logits - (1.0 - logits_mask) * 1e9
    logits = logits - (~pair_valid).float() * 1e9
    logits = logits - logits.max(dim=-1, keepdim=True).values.detach()

    p = mask / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    per_anchor = (p * F.log_softmax(logits, dim=-1)).sum(-1)
    if class_weights is not None:
        w = class_weights[torch.clamp(labels, 0, class_weights.shape[0] - 1)]
        per_anchor = per_anchor * w
    per_anchor = per_anchor * valid
    n = torch.clamp(valid.sum(), min=1.0)
    return -per_anchor.sum() / n
