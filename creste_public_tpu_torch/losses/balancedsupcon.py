"""Balanced supervised contrastive loss (the l_spread variant).

Counterpart of ``creste_public_tpu/losses/balancedsupcon.py`` (reference
balancedsupcon_loss.py:32-143): the anchor-vs-anchor supervised term
``lsup``, whose denominator holds only the negatives, plus the spread term
``lspread``, which compares each anchor with augmented views and normalises
by the logsumexp over its positives; combined as
``(a_lc * lsup + a_spread * lspread) / (a_lc + a_spread)``. The ``type``
presets set the coefficients as the reference does ('sup_con': no spread,
'l_repel': no lsup, 'sim_clr': lsup on the real labels).

The rows run on static shapes with a validity mask; the valid rows are
packed to the front first (stable), because the spread term's pairing
depends on the true row count. Both stability maxima are out of the
gradient.
"""
from __future__ import annotations

import torch


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def bal_contrastive_loss(feats: torch.Tensor, labels: torch.Tensor,
                         temperature: float = 0.5, a_lc: float = 1.0,
                         a_spread: float = 1.0, loss_type: str = "l_spread",
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """feats [B, V, Z] (view 0 the anchor), labels [B] int, valid [B]
    bool (optional) -> the scalar loss."""
    if loss_type == "sup_con":
        a_spread = 0.0
    elif loss_type == "l_repel":
        a_lc, a_spread = 0.0, 1.0
    elif loss_type == "sim_clr":
        # the reference's sim_clr preset computes lsup on the real labels
        a_lc, a_spread = 1.0, 0.0

    B, V, _ = feats.shape
    dev = feats.device
    if valid is None:
        valid = torch.ones(B, dtype=torch.bool, device=dev)
    else:
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
        feats, labels, valid = feats[order], labels[order], valid[order]
    anchor = feats[:, 0]

    logits = anchor @ anchor.T / temperature
    # the stability max over the valid columns only, out of the gradient
    row_max = torch.where(valid[None, :], logits,
                          torch.full_like(logits, -torch.inf)
                          ).amax(1, keepdim=True)
    logits = logits - _finite_or_zero(row_max).detach()
    exp_logits = torch.exp(logits)

    eye = torch.eye(B, dtype=torch.bool, device=dev)
    pair_valid = valid[:, None] & valid[None, :]
    same = labels[:, None] == labels[None, :]
    posmask = same & ~eye & pair_valid
    negmask = ~same & ~eye & pair_valid

    # lsup: own exp plus the negatives in the denominator; a row with no
    # positive adds 0 but stays in the mean's count
    o_neg = (exp_logits * negmask).sum(1, keepdim=True)
    log_prob = logits - torch.log(exp_logits + o_neg + 1e-12)
    n_pos = torch.clamp(posmask.sum(1), min=1)
    mean_log_prob_pos = (log_prob * posmask).sum(1) / n_pos
    row_ok = valid & (posmask.sum(1) > 0)
    lsup = -(mean_log_prob_pos * row_ok).sum() / torch.clamp(valid.sum(),
                                                             min=1)

    if V > 1:
        # the reference's three quirks (see the JAX module): view-major
        # augment columns paired sample-major against the true row count
        # n, a stability max over every valid augmented feature that the
        # normaliser does not cancel, and a normaliser over logits *
        # posmask in which a valid non-positive column adds exp(0)
        n = torch.clamp(valid.sum(), min=1)
        aug_all = torch.einsum("bz,svz->bsv", anchor,
                               feats[:, 1:]) / temperature
        aug_all = torch.where(valid[None, :, None], aug_all,
                              torch.full_like(aug_all, -torch.inf))
        row_max = _finite_or_zero(aug_all.amax((1, 2))).detach()
        k = torch.arange(V - 1, device=dev)
        col = torch.arange(B, device=dev)[:, None] * (V - 1) + k[None, :]
        s = col % n
        v = torch.clamp(1 + torch.div(col, n, rounding_mode="floor"), 1,
                        V - 1)
        pair_feats = feats[s, v]  # [B, V-1, Z]
        lp = torch.einsum("bz,bkz->bk", anchor, pair_feats) / temperature
        lp = lp - row_max[:, None]
        pos_lse = torch.logsumexp(
            torch.where(valid[None, :], logits * posmask,
                        torch.full_like(logits, -torch.inf)),
            dim=1, keepdim=True)
        log_prob_sp = (lp - _finite_or_zero(pos_lse)) * valid[:, None]
        lspread = -log_prob_sp.sum() / n
    else:
        lspread = torch.zeros((), device=dev)

    denom = a_lc + a_spread
    assert denom != 0
    return (a_lc * lsup + a_spread * lspread) / denom
