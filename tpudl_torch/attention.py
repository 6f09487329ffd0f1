"""Dense attention oracle.

Copied from ``tpudl/attention.py`` (``attention_reference`` only; the ring
path over ``torch.distributed`` is a later ROADMAP item).
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_reference"]


def attention_reference(q, k, v, causal: bool = False):
    """Dense single-device softmax attention ``softmax(QKᵀ/√d)V``.
    q, k, v: ``[batch, seq, heads, head_dim]``; the causal mask is the
    lower triangle of ``[Sq, Sk]`` (positions start at 0 on both)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
