"""Shared transformer blocks (counterpart of ``isfusion_tpu/models/transformer.py``).

``MultiheadAttention`` keeps ``nn.MultiheadAttention``'s parameter names
(``in_proj_weight``, ``in_proj_bias``, ``out_proj``) so reference
checkpoints load, and computes flax ``MultiHeadDotProductAttention``'s
function: separate q/k/v inputs, query scaled by 1/sqrt(head_dim), masked
logits set to the dtype's lowest value, softmax in float32. In train mode
its ``dropout`` drops attention weights with one mask shared over batch
and heads (flax's ``broadcast_dropout``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BatchNorm, Conv1x1, LayerNorm, Linear, compute_dtype,
                     dropout)


class PositionEmbeddingLearned(nn.Module):
    """Conv1d(in->C) + BN1d + ReLU + Conv1d(C->C) over (B, N, in) coords
    (reference ``position_embedding_head`` naming)."""

    def __init__(self, input_channel: int, num_pos_feats: int, dtype=None):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            Conv1x1(input_channel, num_pos_feats, dtype=dtype),
            BatchNorm(num_pos_feats, dtype=dtype),
            nn.ReLU(),
            Conv1x1(num_pos_feats, num_pos_feats, dtype=dtype))

    def forward(self, xyz):
        return self.position_embedding_head(xyz)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 dtype=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = float(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.cdtype = dtype

    def forward(self, q_in, k_in, v_in, mask: Optional[torch.Tensor] = None):
        """q_in (B, Lq, E), k_in/v_in (B, Lk, E); mask broadcastable to
        (B, heads, Lq, Lk), True = attend. Returns (B, Lq, E)."""
        dt = compute_dtype(q_in, self.cdtype)
        e, h = self.embed_dim, self.num_heads
        w = self.in_proj_weight.to(dt)
        b = self.in_proj_bias.to(dt)

        def proj(x, i):
            y = F.linear(x.to(dt), w[i * e:(i + 1) * e], b[i * e:(i + 1) * e])
            return y.reshape(*y.shape[:-1], h, e // h).transpose(-3, -2)

        q = proj(q_in, 0) / math.sqrt(e // h)
        k, v = proj(k_in, 1), proj(v_in, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)).float()
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(dt).min)
        attn = torch.softmax(logits, -1).to(dt)
        attn = dropout(attn, self.dropout, self.training,
                       broadcast_leading=attn.dim() - 2)
        out = torch.matmul(attn, v).transpose(-3, -2)
        return self.out_proj(out.reshape(*out.shape[:-2], e))


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer (``transfusion_head_v2.py:42``): self-attn
    with q = k = v = query + pos, cross-attn with k = v = key + key pos,
    FFN. Train mode drops (``dropout``) the attention weights and each
    residual branch and the FFN's hidden activations, as the JAX layer.

    ``with_posembed``: the layer holds the query's and the key's
    ``PositionEmbeddingLearned`` over TransFusion's 2-wide BEV positions;
    False (Group-Free 3D, whose head holds its embeddings): ``query_pos``
    / ``key_pos`` are the embeddings themselves (None: nothing added).
    ``key_mask`` (B, M) and ``query_mask`` (B, N), True = valid, mask the
    cross-attention's keys and the self-attention's keys as flax's
    ``mask`` does: a masked key's logit is the dtype's lowest value, so a
    row whose every key is masked takes uniform weights."""

    def __init__(self, d_model, nhead, dim_feedforward=256, activation="relu",
                 dropout=0.0, dtype=None, with_posembed: bool = True):
        super().__init__()
        self.p = float(dropout)
        self.self_attn = MultiheadAttention(d_model, nhead, dropout,
                                            dtype=dtype)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout,
                                                 dtype=dtype)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.norm3 = LayerNorm(d_model, dtype=dtype)
        self.self_posembed = self.cross_posembed = None
        if with_posembed:
            self.self_posembed = PositionEmbeddingLearned(2, d_model,
                                                          dtype=dtype)
            self.cross_posembed = PositionEmbeddingLearned(2, d_model,
                                                           dtype=dtype)
        self.act = {"relu": nn.ReLU(), "gelu": nn.GELU()}[activation]
        self.cdtype = dtype

    def forward(self, query, key, query_pos, key_pos,
                key_mask: Optional[torch.Tensor] = None,
                query_mask: Optional[torch.Tensor] = None):
        qp = query_pos if self.self_posembed is None or query_pos is None \
            else self.self_posembed(query_pos)
        kp = key_pos if self.cross_posembed is None or key_pos is None \
            else self.cross_posembed(key_pos)
        if self.cdtype is not None:
            query, key = query.to(self.cdtype), key.to(self.cdtype)
        p, train = self.p, self.training

        def add(t, pos):
            return t if pos is None else t + pos

        def keys(m):
            return None if m is None else m.bool()[:, None, None, :]

        q = add(query, qp)
        query = self.norm1(query + dropout(self.self_attn(
            q, q, q, keys(query_mask)), p, train))
        kk = add(key, kp)
        query = self.norm2(query + dropout(
            self.multihead_attn(add(query, qp), kk, kk, keys(key_mask)), p,
            train))
        ff = self.linear2(dropout(self.act(self.linear1(query)), p, train))
        return self.norm3(query + dropout(ff, p, train))
