"""Bilinear sampling and resizing (counterpart of
``isfusion_tpu/ops/interpolate.py``), channels-last.

Plain PyTorch for now: ``F.grid_sample`` with bilinear taps, zeros
padding and ``align_corners=False`` computes the JAX package's
gather-and-lerp exactly (queue K6 for the fused P2G kernel, K8 for the
resize).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img (H, W, C); grid (..., 2) normalised to [-1, 1], grid[..., 0] = x.
    Bilinear, zeros outside, ``align_corners=False``. Returns (..., C) in
    the promoted dtype of img and grid."""
    dt = torch.promote_types(img.dtype, grid.dtype)
    lead = grid.shape[:-1]
    g = grid.reshape(1, 1, -1, 2).to(dt)
    out = F.grid_sample(img.to(dt).permute(2, 0, 1)[None], g,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)             # (1, C, 1, M)
    return out[0, :, 0].transpose(0, 1).reshape(*lead, img.shape[-1])


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> torch.Tensor:
    """Sample (H, W, C) at pixel coords x, y (pixel centres at integers),
    zeros outside."""
    h, w, _ = img.shape
    gx = (2 * x + 1) / w - 1
    gy = (2 * y + 1) / h - 1
    return grid_sample(img, torch.stack([gx, gy], -1))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """F.interpolate(mode='bilinear') over NHWC tensors."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(int(v)
                                                        for v in out_hw),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1)
