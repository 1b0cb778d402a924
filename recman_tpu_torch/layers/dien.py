"""Interest extraction + evolution layers for DIEN (arXiv:1809.03672).

Counterpart of ``recman_tpu/layers/dien.py``. Two stages:

1. Interest extractor: a GRU over the behavior-sequence embeddings;
   padded positions carry the hidden state through unchanged.
2. Interest evolution: an AUGRU, a second GRU whose update gate is scaled
   by the attention score between each extracted state and the candidate
   item embedding.

Each of the reference's ``lax.scan`` recurrences is a loop over the L
positions in Python here, one packed (B, 3H) matmul pair a step.

GRU convention (paper eq. 1-4): u=update, r=reset,
h' = (1-u)*h + u*h_tilde.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import glorot_normal, l2_loss, split_rng

__all__ = ["InterestEvolution"]

_NEG_INF = -1e9


def _gru_step(wx, wh, b, h, x, u_scale=None, mask=None):
    """One (A)GRU step. x (B, k); h (B, H); u_scale (B, 1) or None scales
    the update gate (AUGRU); mask (B, 1) bool keeps h at padded
    positions."""
    hdim = h.shape[1]
    gx = x @ wx + b  # (B, 3H)
    gh = h @ wh
    u = torch.sigmoid(gx[:, :hdim] + gh[:, :hdim])
    r = torch.sigmoid(gx[:, hdim:2 * hdim] + gh[:, hdim:2 * hdim])
    n = torch.tanh(gx[:, 2 * hdim:] + r * gh[:, 2 * hdim:])
    if u_scale is not None:
        u = u * u_scale  # AUGRU: attention scales the update gate
    h_new = (1.0 - u) * h + u * n
    if mask is not None:
        h_new = torch.where(mask, h_new, h)
    return h_new


class InterestEvolution:
    """GRU interest extractor + attentional-update-gate AUGRU evolution.

    Params (all ``{prefix}``-scoped): ``gru_wx`` (k, 3H), ``gru_wh``
    (H, 3H), ``gru_b`` (3H,), ``augru_wx`` (H, 3H), ``augru_wh`` (H, 3H),
    ``augru_b`` (3H,), ``att_w`` (H, k), the bilinear attention against
    the candidate embedding (masked softmax over positions).
    """

    def __init__(self, embedding_size: int, hidden_size: int | None = None,
                 l2_reg: float = 0.0, prefix: str = ""):
        self.k = embedding_size
        self.h = hidden_size or embedding_size
        self.l2_reg = l2_reg
        self.prefix = prefix

    def init(self, generator, device=None) -> dict:
        # the reference splits its key five ways (jax.random.split)
        k1, k2, k3, k4, k5 = split_rng(generator, 5)
        p, k, h = self.prefix, self.k, self.h

        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32, device=device)

        return {
            f"{p}gru_wx": glorot_normal(k1, (k, 3 * h), device=device),
            f"{p}gru_wh": glorot_normal(k2, (h, 3 * h), device=device),
            f"{p}gru_b": zeros(3 * h),
            f"{p}augru_wx": glorot_normal(k3, (h, 3 * h), device=device),
            f"{p}augru_wh": glorot_normal(k4, (h, 3 * h), device=device),
            f"{p}augru_b": zeros(3 * h),
            f"{p}att_w": glorot_normal(k5, (h, k), device=device),
        }

    def extract(self, params, seq, mask):
        """Stage 1: GRU over (B, L, k) -> all hidden states (B, L, H)."""
        p = self.prefix
        h = torch.zeros((seq.shape[0], self.h), dtype=seq.dtype, device=seq.device)
        hs = []
        for t in range(seq.shape[1]):
            h = _gru_step(params[f"{p}gru_wx"], params[f"{p}gru_wh"], params[f"{p}gru_b"],
                          h, seq[:, t], mask=mask[:, t, None])
            hs.append(h)
        return torch.stack(hs, dim=1)

    def evolve(self, params, states, mask, query):
        """Stage 2: AUGRU over the interest states (B, L, H) with attention
        scores against the candidate ``query`` (B, k) -> final interest
        (B, H)."""
        p = self.prefix
        scores = torch.einsum("blh,hk,bk->bl", states, params[f"{p}att_w"], query)
        att = torch.softmax(torch.where(mask, scores, _NEG_INF), dim=1)  # (B, L)
        h = torch.zeros((states.shape[0], self.h), dtype=states.dtype, device=states.device)
        for t in range(states.shape[1]):
            h = _gru_step(params[f"{p}augru_wx"], params[f"{p}augru_wh"], params[f"{p}augru_b"],
                          h, states[:, t], u_scale=att[:, t, None], mask=mask[:, t, None])
        return h

    def apply(self, params, seq, mask, query):
        """(B, L, k) behaviors + (B, L) mask + (B, k) candidate ->
        ((B, H) final interest, (B, L, H) extracted states)."""
        states = self.extract(params, seq, mask)
        return self.evolve(params, states, mask, query), states

    def aux_loss(self, params, states, seq, mask):
        """Auxiliary next-behavior loss (paper §4.2, eq. 7): state h_t
        should score the actual next behavior e_{t+1} above an in-batch
        negative, the next-behavior column rolled by one row. A mean over
        the valid (t, t+1) pairs; 0 when none is valid."""
        h_t = states[:, :-1, :]
        e_next = seq[:, 1:, :]
        e_neg = torch.roll(e_next, 1, dims=0)
        valid = (mask[:, :-1] & mask[:, 1:]).to(states.dtype)
        w = params[f"{self.prefix}att_w"]
        pos = torch.einsum("blh,hk,blk->bl", h_t, w, e_next)
        neg = torch.einsum("blh,hk,blk->bl", h_t, w, e_neg)
        ll = F.logsigmoid(pos) + F.logsigmoid(-neg)
        return -(ll * valid).sum() / valid.sum().clamp_min(1.0)

    def l2(self, params):
        p = self.prefix
        total = 0.0
        for name in ("gru_wx", "gru_wh", "augru_wx", "augru_wh", "att_w"):
            total = total + self.l2_reg * l2_loss(params[f"{p}{name}"])
        return total
