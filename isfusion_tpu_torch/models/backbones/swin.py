"""Swin Transformer image backbone (counterpart of
``isfusion_tpu/models/backbones/swin.py``) over NHWC images.

Reference mmdet Swin naming: ``patch_embed.{projection,norm}``,
``stages.{i}.blocks.{d}.{norm1, attn.w_msa.{qkv, proj,
relative_position_bias_table, relative_position_index}, norm2,
ffn.layers.{0.0, 1}}``, ``stages.{i}.downsample.{norm, reduction}``,
``norm{i}``. Inference only (no drop path, no dropout).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, LayerNorm, Linear, resolve_dtype


def _rel_pos_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    return np.where(win[:, :, None] != win[:, None, :], -100.0,
                    0.0).astype(np.float32)


class WindowMSA(nn.Module):
    def __init__(self, dim, num_heads, window_size, qkv_bias=True,
                 qk_scale=None, dtype=None):
        super().__init__()
        self.dim, self.num_heads, self.ws = dim, num_heads, window_size
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            _rel_pos_index(window_size)))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        """x (B_, N, C); mask (nW, N, N) additive or None."""
        b, n, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = torch.matmul(q, k.transpose(-1, -2)).float()
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(n, n, nh)
        attn = attn + bias.permute(2, 0, 1).float()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b // nw, nw, nh, n, n) +
                    mask[None, :, None]).reshape(b, nh, n, n)
        attn = torch.softmax(attn, -1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out.to(x.dtype))


class ShiftWindowMSA(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size=0,
                 qkv_bias=True, qk_scale=None, dtype=None):
        super().__init__()
        self.ws, self.shift_size = window_size, shift_size
        self.w_msa = WindowMSA(dim, num_heads, window_size, qkv_bias,
                               qk_scale, dtype=dtype)

    def forward(self, x, hw):
        h, w = hw
        b, _, c = x.shape
        ws = self.ws
        x = x.reshape(b, h, w, c)
        hp = int(np.ceil(h / ws)) * ws
        wp = int(np.ceil(w / ws)) * ws
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        shift = self.shift_size if (hp > ws or wp > ws) else 0
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(_shift_attn_mask(hp, wp, ws, shift)).to(
                x.device)
        x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        x = self.w_msa(x, mask)
        x = x.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        return x[:, :h, :w].reshape(b, h * w, c)


class FFN(nn.Module):
    """mmcv FFN naming: ``layers.0.0`` (fc1 + GELU), ``layers.1`` (fc2)."""

    def __init__(self, dim, hidden, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Sequential(Linear(dim, hidden, dtype=dtype), nn.GELU()),
            Linear(hidden, dim, dtype=dtype)])

    def forward(self, x):
        return self.layers[1](self.layers[0](x))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size=7, shift=False,
                 mlp_ratio=4.0, qkv_bias=True, qk_scale=None, dtype=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size,
                                   window_size // 2 if shift else 0,
                                   qkv_bias, qk_scale, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.ffn = FFN(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, hw):
        x = x + self.attn(self.norm1(x), hw)
        return x + self.ffn(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 patch concat (TL, TR, BL, BR, channels innermost) + LN + linear
    4C -> 2C, as the JAX package orders it."""

    def __init__(self, dim, out_dim, dtype=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype=dtype)
        self.reduction = Linear(4 * dim, out_dim, bias=False, dtype=dtype)

    def forward(self, x, hw):
        h, w = hw
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        hp, wp = h + (h % 2), w + (w % 2)
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        x = x.reshape(b, hp // 2, 2, wp // 2, 2, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, -1, 4 * c)
        return self.reduction(self.norm(x)), (hp // 2, wp // 2)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels, embed_dims, patch_size, patch_norm,
                 dtype=None):
        super().__init__()
        self.projection = Conv2d(in_channels, embed_dims, patch_size,
                                 stride=patch_size, dtype=dtype)
        self.norm = LayerNorm(embed_dims, dtype=dtype) if patch_norm \
            else None


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """(B, H, W, 3) NHWC images -> NHWC maps at ``out_indices``."""

    def __init__(self, in_channels=3, embed_dims=96, patch_size=4,
                 window_size=7, mlp_ratio=4.0, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), out_indices=(0, 1, 2, 3),
                 qkv_bias=True, qk_scale=None, patch_norm=True,
                 compute_dtype=None, **unused):
        super().__init__()
        dt = resolve_dtype(compute_dtype)
        self.cdtype, self.patch_size = dt, patch_size
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(in_channels, embed_dims, patch_size,
                                      patch_norm, dtype=dt)
        stages = []
        dim = embed_dims
        for i, depth in enumerate(depths):
            blocks = [SwinBlock(dim, num_heads[i], window_size,
                                shift=(d % 2 == 1), mlp_ratio=mlp_ratio,
                                qkv_bias=qkv_bias, qk_scale=qk_scale,
                                dtype=dt) for d in range(depth)]
            ds = PatchMerging(dim, 2 * dim, dtype=dt) \
                if i < len(depths) - 1 else None
            stages.append(_Stage(blocks, ds))
            if i in self.out_indices:
                self.add_module(f"norm{i}", LayerNorm(dim, dtype=dt))
            if ds is not None:
                dim *= 2
        self.stages = nn.ModuleList(stages)

    def forward(self, img: torch.Tensor):
        if self.cdtype is not None:
            img = img.to(self.cdtype)
        b, h0, w0, _ = img.shape
        p = self.patch_size
        hp, wp = -(-h0 // p) * p, -(-w0 // p) * p
        img = F.pad(img, (0, 0, 0, wp - w0, 0, hp - h0))
        x = self.patch_embed.projection(img)
        hw = (hp // p, wp // p)
        x = x.reshape(b, hw[0] * hw[1], -1)
        if self.patch_embed.norm is not None:
            x = self.patch_embed.norm(x)
        outs = []
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x, hw)
            if i in self.out_indices:
                y = getattr(self, f"norm{i}")(x)
                outs.append(y.reshape(b, hw[0], hw[1], -1))
            if stage.downsample is not None:
                x, hw = stage.downsample(x, hw)
        return outs
