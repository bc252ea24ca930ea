"""Multi-scale deformable attention sampling (counterpart of
``isfusion_tpu/ops/deform_attn.py``): per (query, head, level, point) a
bilinear sample of the value map at ``loc * size - 0.5`` (zeros outside),
summed with the attention weights. Plain PyTorch for now (ROADMAP queue K7).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def ms_deform_attn_sample(value_maps: Sequence[torch.Tensor],
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor) -> torch.Tensor:
    """value_maps: per level (H, W, n_heads, head_dim);
    sampling_locations (Lq, nh, nl, np, 2) in [0, 1];
    attention_weights (Lq, nh, nl, np). Returns (Lq, nh * head_dim)."""
    lq, nh, nl, npts, _ = sampling_locations.shape
    out = 0
    for lvl, vm in enumerate(value_maps):
        h, w, _, hd = vm.shape
        dt = torch.promote_types(vm.dtype, sampling_locations.dtype)
        val = vm.to(dt).permute(2, 3, 0, 1)                    # (nh, hd, H, W)
        grid = (2 * sampling_locations[:, :, lvl] - 1).to(dt)  # (Lq, nh, np, 2)
        s = F.grid_sample(val, grid.permute(1, 0, 2, 3), mode="bilinear",
                          padding_mode="zeros", align_corners=False)
        # s (nh, hd, Lq, np) -> weighted sum over points -> (Lq, nh, hd)
        wgt = attention_weights[:, :, lvl].permute(1, 0, 2).to(dt)
        out = out + torch.einsum("hdqp,hqp->qhd", s, wgt)
    return out.reshape(lq, -1)
