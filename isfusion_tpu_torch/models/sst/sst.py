"""SSTv2 regional attention over dense BEV maps (counterpart of
``isfusion_tpu/models/sst/sst.py``: ``SSTv2``, ``SRABlock``,
``CosineMultiHeadAttention``, dense windows).

Every BEV cell is a token; windows of ws x ws tokens (6 x 6 for the
flagship) attend within themselves, then a shifted pass offsets the grid
by ws // 2 and masks the zero-padded border. ``dropout`` (0 in the
flagship, whose ISFusionEncoder leaves SSTv2's default) drops attention
weights and residual branches in train mode. ``layer_cfg=dict(cosine=True[,
tau_min, non_shared_tau])`` takes the scaled-cosine attention, and
``normalize_pos`` scales the in-window offsets to [-pi, pi). Reference
parameter names: ``linear0``, ``block_list.{b}.encoder_list.{l}.
{win_attn.self_attn, norm1, norm2, linear1, linear2}`` (the cosine
attention's ``self_attn`` also holds ``tau``); an SRABlock's two layers
are ``encoder_list.{0, 1}``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (LayerNorm, Linear, compute_dtype, dropout,
                      resolve_dtype)
from ..transformer import MultiheadAttention


def sst_window_pos_embed(window_shape: Tuple[int, int], feat_dim: int,
                         pos_temperature: float = 1000.0,
                         normalize_pos: bool = False) -> np.ndarray:
    """(wy*wx, feat_dim) in-window sinusoidal embedding: offsets from the
    window centre (scaled to [-pi, pi) with ``normalize_pos``), per-axis
    interleaved sin/cos, x half then y half."""
    win_x, win_y = int(window_shape[0]), int(window_shape[1])
    yy, xx = np.meshgrid(np.arange(win_y), np.arange(win_x), indexing="ij")
    x = (xx.reshape(-1) - win_x / 2).astype(np.float32)
    y = (yy.reshape(-1) - win_y / 2).astype(np.float32)
    if normalize_pos:
        x = x / win_x * 2 * np.pi
        y = y / win_y * 2 * np.pi
    pos_length = feat_dim // 2
    inv_freq = pos_temperature ** (
        2 * (np.arange(pos_length, dtype=np.float32) // 2) / pos_length)

    def interleave(e):
        return np.stack([np.sin(e[:, 0::2]), np.cos(e[:, 1::2])],
                        axis=-1).reshape(e.shape[0], -1)

    return np.concatenate([interleave(x[:, None] / inv_freq[None]),
                           interleave(y[:, None] / inv_freq[None])],
                          axis=-1).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int, shift: bool):
    """(B, H, W, C) -> tokens (B*nW, ws*ws, C), valid (B*nW, ws*ws)."""
    b, h, w, c = x.shape
    s = ws // 2 if shift else 0
    hp = int(np.ceil((h + s) / ws)) * ws
    wp = int(np.ceil((w + s) / ws)) * ws
    x = F.pad(x, (0, 0, s, wp - w - s, s, hp - h - s))
    valid = F.pad(torch.ones((b, h, w), dtype=torch.bool, device=x.device),
                  (s, wp - w - s, s, hp - h - s))
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    valid = valid.reshape(b, hp // ws, ws, wp // ws, ws).permute(0, 1, 3, 2,
                                                                 4)
    return (x.reshape(-1, ws * ws, c), valid.reshape(-1, ws * ws), (hp, wp))


def window_reverse(tokens, shape_bhwc, ws, shift, padded_hw):
    b, h, w, c = shape_bhwc
    hp, wp = padded_hw
    s = ws // 2 if shift else 0
    x = tokens.reshape(b, hp // ws, wp // ws, ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    return x[:, s:s + h, s:s + w]


class CosineMultiheadAttention(nn.Module):
    """Scaled-cosine attention (``cosine_msa.py``; the JAX package's
    ``CosineMultiHeadAttention``): q and k L2-normalised per head (+ 1e-12)
    in float32, logits their dot product over a learned ``tau`` clamped at
    ``tau_min`` (one shared, or one a head with ``non_shared_tau``),
    masked logits -1e9, softmax in float32; no 1/sqrt(head_dim). Its
    train-mode dropout drops each weight on its own. ``nn.MultiheadAttention``'s
    parameter names plus ``tau``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 tau_min: float = 0.01, non_shared_tau: bool = False,
                 dtype=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.tau_min = float(dropout), float(tau_min)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.tau = nn.Parameter(torch.ones(num_heads if non_shared_tau
                                           else 1))
        self.cdtype = dtype

    def reset_special_parameters(self):
        """``tau`` starts at 1 (the reference's and flax's init)."""
        with torch.no_grad():
            self.tau.fill_(1.0)

    def forward(self, q_in, k_in, v_in, mask: Optional[torch.Tensor] = None):
        """q_in (B, Lq, E), k_in / v_in (B, Lk, E); mask broadcastable to
        (B, heads, Lq, Lk), True = attend. Returns (B, Lq, E)."""
        dt = compute_dtype(q_in, self.cdtype)
        e, h = self.embed_dim, self.num_heads
        w = self.in_proj_weight.to(dt)
        b = self.in_proj_bias.to(dt)

        def proj(x, i):
            y = F.linear(x.to(dt), w[i * e:(i + 1) * e], b[i * e:(i + 1) * e])
            return y.reshape(*y.shape[:-1], h, e // h).transpose(-3, -2)

        q, k = proj(q_in, 0).float(), proj(k_in, 1).float()
        v = proj(v_in, 2)
        q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.norm(k, dim=-1, keepdim=True) + 1e-12)
        logits = torch.matmul(q, k.transpose(-1, -2)) / torch.clamp_min(
            self.tau.float(), self.tau_min).reshape(-1, 1, 1)
        if mask is not None:
            logits = logits.masked_fill(~mask, -1e9)
        attn = dropout(torch.softmax(logits, -1).to(v.dtype), self.dropout,
                       self.training)
        out = torch.matmul(attn, v).transpose(-3, -2)
        return self.out_proj(out.reshape(*out.shape[:-2], e))


def make_window_attention(layer_cfg: Optional[dict], d_model: int,
                          nhead: int, dropout: float = 0.0,
                          dtype=None) -> nn.Module:
    """The attention of ``layer_cfg`` (``sst_basic_block_v2.py:14-35``):
    ``dict(cosine=True[, tau_min, non_shared_tau])`` the scaled-cosine
    attention, ``linear=True`` unimplemented (as in the reference), else
    dot-product attention."""
    cfg = dict(layer_cfg or {})
    if cfg.get("cosine", False):
        return CosineMultiheadAttention(
            d_model, nhead, dropout, tau_min=float(cfg.get("tau_min", 0.01)),
            non_shared_tau=bool(cfg.get("non_shared_tau", False)),
            dtype=dtype)
    if cfg.get("linear", False):
        raise NotImplementedError("linear window attention is not "
                                  "implemented in the reference either")
    return MultiheadAttention(d_model, nhead, dropout, dtype=dtype)


class _WinAttn(nn.Module):
    """Holder giving the reference key ``win_attn.self_attn``."""

    def __init__(self, d_model, nhead, dropout=0.0, dtype=None,
                 layer_cfg=None):
        super().__init__()
        self.self_attn = make_window_attention(layer_cfg, d_model, nhead,
                                               dropout, dtype)


class SSTEncoderLayer(nn.Module):
    """Window MHA (q = k = feat + pos, v = feat) + FFN, post-norm."""

    def __init__(self, d_model, nhead, dim_feedforward, window_size, shift,
                 pos_temperature=1000.0, dropout=0.0, dtype=None,
                 normalize_pos: bool = False, layer_cfg=None):
        super().__init__()
        self.p = float(dropout)
        self.win_attn = _WinAttn(d_model, nhead, dropout, dtype=dtype,
                                 layer_cfg=layer_cfg)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.ws, self.shift, self.cdtype = window_size, shift, dtype
        self.register_buffer("pos", torch.from_numpy(sst_window_pos_embed(
            (window_size, window_size), d_model, pos_temperature,
            normalize_pos)), persistent=False)

    def encode(self, tokens, q, valid):
        """(N, T, C) tokens, their queries / keys ``q`` and (N, T) valid
        flags -> the attended, post-norm tokens, zero where not valid."""
        mask = valid[:, None, None, :] & valid[:, None, :, None]
        attn = self.win_attn.self_attn(q, q, tokens, mask=mask)
        attn = attn * valid[..., None]
        p, train = self.p, self.training
        tokens = self.norm1(tokens + dropout(attn, p, train))
        tokens = self.norm2(tokens + dropout(self.linear2(torch.relu(
            self.linear1(tokens))), p, train))
        return tokens * valid[..., None]

    def forward(self, x):
        if self.cdtype is not None:
            x = x.to(self.cdtype)
        shape = x.shape
        tokens, valid, padded = window_partition(x, self.ws, self.shift)
        tokens = self.encode(tokens, tokens + self.pos.to(tokens.dtype)[None],
                             valid)
        return window_reverse(tokens, shape, self.ws, self.shift, padded)


class _Block(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.encoder_list = nn.ModuleList(layers)


class SSTv2(nn.Module):
    """Shifted-window BEV attention over (B, H, W, C): ``num_blocks``
    blocks of (no-shift, shift) layers, optional input projection."""

    def __init__(self, d_model=(128,), nhead=(8,), num_blocks=1,
                 dim_feedforward=(128,), window_shape=(6, 6, 1),
                 in_channel: Optional[int] = None,
                 pos_temperature: float = 1000.0, dropout: float = 0.0,
                 compute_dtype=None, normalize_pos: bool = False,
                 layer_cfg=None):
        super().__init__()

        def first(v):
            return int(v[0]) if isinstance(v, (tuple, list)) else int(v)

        d, nh, ff = first(d_model), first(nhead), first(dim_feedforward)
        dt = resolve_dtype(compute_dtype)
        self.linear0 = Linear(in_channel, d, dtype=dt) \
            if in_channel is not None else None
        self.block_list = nn.ModuleList(_Block(
            [SSTEncoderLayer(d, nh, ff, int(window_shape[0]), shift,
                             pos_temperature, dropout, dtype=dt,
                             normalize_pos=normalize_pos,
                             layer_cfg=layer_cfg)
             for shift in (False, True)]) for _ in range(num_blocks))

    def forward(self, x):
        if self.linear0 is not None:
            x = self.linear0(x)
        for blk in self.block_list:
            for layer in blk.encoder_list:
                x = layer(x)
        return x


class SRABlock(nn.Module):
    """Sparse-regional-attention block (``sra_block.py:101-137``; the JAX
    package's ``SRABlock``): two encoder layers over (B, H, W, C), no
    shift then shift, as a BasicShiftBlockV2's ``encoder_list``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 window_shape=(6, 6, 1), dropout: float = 0.0,
                 layer_cfg=None):
        super().__init__()
        self.encoder_list = nn.ModuleList(
            SSTEncoderLayer(d_model, nhead, dim_feedforward,
                            int(window_shape[0]), shift, dropout=dropout,
                            layer_cfg=layer_cfg)
            for shift in (False, True))

    def forward(self, x):
        for layer in self.encoder_list:
            x = layer(x)
        return x
