"""SECONDFPN neck (counterpart of ``isfusion_tpu/models/necks/second_fpn.py``):
each scale upsampled by a deconv (or a 1x1 conv at stride 1 with
``use_conv_for_no_stride``), + BN + ReLU, concatenated. NHWC. Names:
``deblocks.{i}.{0,1}``.

The deconv computes torch's ``conv_transpose2d`` with the reference
(in, out, kh, kw) weight. The JAX package's flax ConvTranspose reads its
converted kernel spatially flipped; ``runner/convert.py`` flips it back
when carrying JAX weights across.
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import (BatchNorm, Conv2d, ConvTranspose2d, bn_args,
                      resolve_dtype)


class SECONDFPN(nn.Module):
    def __init__(self, in_channels=(128, 128, 256),
                 out_channels=(256, 256, 256), upsample_strides=(1, 2, 4),
                 norm_cfg=None, use_conv_for_no_stride=False,
                 compute_dtype=None, **unused):
        super().__init__()
        dt = resolve_dtype(compute_dtype)
        self.cdtype = dt
        norm_cfg = norm_cfg or dict(type="BN", eps=1e-3, momentum=0.01)
        bn = bn_args(norm_cfg, 1e-3, 0.01)
        blocks = []
        for cin, cout, s in zip(in_channels, out_channels, upsample_strides):
            if s == 1 and use_conv_for_no_stride:
                up = Conv2d(cin, cout, 1, bias=False, dtype=dt)
            else:
                up = ConvTranspose2d(cin, cout, s, stride=s, bias=False,
                                     dtype=dt)
            blocks.append(nn.Sequential(up, BatchNorm(cout, dtype=dt, **bn),
                                        nn.ReLU()))
        self.deblocks = nn.ModuleList(blocks)

    def forward(self, feats):
        ups = [blk(f.to(self.cdtype or f.dtype))
               for blk, f in zip(self.deblocks, feats)]
        return torch.cat(ups, -1) if len(ups) > 1 else ups[0]
