"""GeneralizedLSSFPN image neck (counterpart of
``isfusion_tpu/models/necks/generalized_lss.py``): top-down, upsample the
next level (bilinear, align_corners=True), concat, 1x1 lateral ConvModule,
3x3 fpn ConvModule. NHWC. Names: ``lateral_convs.{i}``, ``fpn_convs.{i}``.
"""
from __future__ import annotations

from torch import nn

import torch

from ...ops.interpolate import resize_bilinear
from ..layers import ConvModule, resolve_dtype


class GeneralizedLSSFPN(nn.Module):
    def __init__(self, in_channels=(192, 384, 768), out_channels=256,
                 num_outs=3, start_level=0, norm_cfg=None, act_cfg=None,
                 upsample_cfg=None, compute_dtype=None, **unused):
        super().__init__()
        self.in_channels = list(in_channels)
        self.start_level = int(start_level)
        up = dict(upsample_cfg or dict(mode="bilinear", align_corners=True))
        self.align = bool(up.get("align_corners", True))
        norm_cfg = dict(norm_cfg or dict(type="BN2d"))
        act_cfg = dict(act_cfg or dict(type="ReLU"))
        dt = resolve_dtype(compute_dtype)
        self.cdtype = dt
        n = len(self.in_channels) - self.start_level
        self.used = n - 1
        lat, fpn = [], []
        for i in range(self.used):
            cin = self.in_channels[self.start_level + i] + (
                self.in_channels[self.start_level + i + 1]
                if i == self.used - 1 else out_channels)
            lat.append(ConvModule(cin, out_channels, 1, norm_cfg=norm_cfg,
                                  act_cfg=act_cfg, dtype=dt))
            fpn.append(ConvModule(out_channels, out_channels, 3, padding=1,
                                  norm_cfg=norm_cfg, act_cfg=act_cfg,
                                  dtype=dt))
        self.lateral_convs = nn.ModuleList(lat)
        self.fpn_convs = nn.ModuleList(fpn)

    def forward(self, inputs):
        laterals = list(inputs[self.start_level:])
        if self.cdtype is not None:
            laterals = [f.to(self.cdtype) for f in laterals]
        for i in range(self.used - 1, -1, -1):
            x = resize_bilinear(laterals[i + 1], laterals[i].shape[1:3],
                                align_corners=self.align)
            x = torch.cat([laterals[i], x], -1)
            laterals[i] = self.fpn_convs[i](self.lateral_convs[i](x))
        return tuple(laterals[:self.used])
