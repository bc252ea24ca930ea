"""SSTv2 regional attention over dense BEV maps (counterpart of
``isfusion_tpu/models/sst/sst.py``: ``SSTv2``, dense windows).

Every BEV cell is a token; windows of ws x ws tokens (6 x 6 for the
flagship) attend within themselves, then a shifted pass offsets the grid
by ws // 2 and masks the zero-padded border. Reference parameter names:
``linear0``, ``block_list.{b}.encoder_list.{l}.{win_attn.self_attn,
norm1, norm2, linear1, linear2}``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import LayerNorm, Linear, resolve_dtype
from ..transformer import MultiheadAttention


def sst_window_pos_embed(window_shape: Tuple[int, int], feat_dim: int,
                         pos_temperature: float = 1000.0) -> np.ndarray:
    """(wy*wx, feat_dim) in-window sinusoidal embedding: offsets from the
    window centre, per-axis interleaved sin/cos, x half then y half."""
    win_x, win_y = int(window_shape[0]), int(window_shape[1])
    yy, xx = np.meshgrid(np.arange(win_y), np.arange(win_x), indexing="ij")
    x = (xx.reshape(-1) - win_x / 2).astype(np.float32)
    y = (yy.reshape(-1) - win_y / 2).astype(np.float32)
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


class _WinAttn(nn.Module):
    """Holder giving the reference key ``win_attn.self_attn``."""

    def __init__(self, d_model, nhead, dtype=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dtype=dtype)


class SSTEncoderLayer(nn.Module):
    """Window MHA (q = k = feat + pos, v = feat) + FFN, post-norm."""

    def __init__(self, d_model, nhead, dim_feedforward, window_size, shift,
                 pos_temperature=1000.0, dtype=None):
        super().__init__()
        self.win_attn = _WinAttn(d_model, nhead, dtype=dtype)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.ws, self.shift, self.cdtype = window_size, shift, dtype
        self.register_buffer("pos", torch.from_numpy(sst_window_pos_embed(
            (window_size, window_size), d_model, pos_temperature)),
            persistent=False)

    def forward(self, x):
        if self.cdtype is not None:
            x = x.to(self.cdtype)
        shape = x.shape
        tokens, valid, padded = window_partition(x, self.ws, self.shift)
        q = tokens + self.pos.to(tokens.dtype)[None]
        mask = valid[:, None, None, :] & valid[:, None, :, None]
        attn = self.win_attn.self_attn(q, q, tokens, mask=mask)
        attn = attn * valid[..., None]
        tokens = self.norm1(tokens + attn)
        tokens = self.norm2(tokens + self.linear2(torch.relu(
            self.linear1(tokens))))
        tokens = tokens * valid[..., None]
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
                 pos_temperature: float = 1000.0, compute_dtype=None):
        super().__init__()

        def first(v):
            return int(v[0]) if isinstance(v, (tuple, list)) else int(v)

        d, nh, ff = first(d_model), first(nhead), first(dim_feedforward)
        dt = resolve_dtype(compute_dtype)
        self.linear0 = Linear(in_channel, d, dtype=dt) \
            if in_channel is not None else None
        self.block_list = nn.ModuleList(_Block(
            [SSTEncoderLayer(d, nh, ff, int(window_shape[0]), shift,
                             pos_temperature, dtype=dt)
             for shift in (False, True)]) for _ in range(num_blocks))

    def forward(self, x):
        if self.linear0 is not None:
            x = self.linear0(x)
        for blk in self.block_list:
            for layer in blk.encoder_list:
                x = layer(x)
        return x
