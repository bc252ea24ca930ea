"""YOLOX path-aggregation FPN (counterpart of
``isfusion_tpu/models/necks/yolox_pafpn.py``; reference
``mmdet3d/models/necks/yolox_pafpn.py`` with mmdet's ``CSPLayer`` and
``DarknetBottleneck``), NHWC: a top-down pass (1x1 reduce, nearest 2x
upsample cropped to the finer map, concat, CSP layer), a bottom-up pass
(3x3 stride-2 downsample cropped to the coarser map, concat, CSP layer),
then a 1x1 output conv per scale; every ConvModule BN (momentum 0.03,
eps 1e-3) + Swish by default. No model of the port uses it.

Reference names: ``reduce_layers.{i}``, ``top_down_blocks.{i}``,
``downsamples.{i}``, ``bottom_up_blocks.{i}``, ``out_convs.{i}``; a CSP
layer's ``main_conv``, ``short_conv``, ``final_conv`` and
``blocks.{j}.conv1`` / ``.conv2``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..layers import ConvModule, resolve_dtype
from .fpn import upsample_nearest


class DarknetBottleneck(nn.Module):
    """1x1 then 3x3 ConvModule, plus the input when the widths agree."""

    def __init__(self, in_channels: int, out_channels: int,
                 expansion: float = 0.5, add_identity: bool = True,
                 norm_cfg=None, act_cfg=None, dtype=None):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvModule(in_channels, hidden, 1, norm_cfg=norm_cfg,
                                act_cfg=act_cfg, dtype=dtype)
        self.conv2 = ConvModule(hidden, out_channels, 3, padding=1,
                                norm_cfg=norm_cfg, act_cfg=act_cfg,
                                dtype=dtype)
        self.add_identity = add_identity and in_channels == out_channels

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.add_identity else y


class CSPLayer(nn.Module):
    """Cross-stage-partial layer: a main 1x1 branch through
    ``num_blocks`` bottlenecks and a shortcut 1x1 branch, concatenated
    (main first), then a final 1x1."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_blocks: int = 1, expand_ratio: float = 0.5,
                 norm_cfg=None, act_cfg=None, dtype=None):
        super().__init__()
        mid = int(out_channels * expand_ratio)
        kw = dict(norm_cfg=norm_cfg, act_cfg=act_cfg, dtype=dtype)
        self.main_conv = ConvModule(in_channels, mid, 1, **kw)
        self.short_conv = ConvModule(in_channels, mid, 1, **kw)
        self.blocks = nn.Sequential(*[
            DarknetBottleneck(mid, mid, expansion=1.0, **kw)
            for _ in range(num_blocks)])
        self.final_conv = ConvModule(2 * mid, out_channels, 1, **kw)

    def forward(self, x):
        return self.final_conv(torch.cat(
            [self.blocks(self.main_conv(x)), self.short_conv(x)], -1))


class YOLOXPAFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024),
                 out_channels: int = 256, num_csp_blocks: int = 3,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None, compute_dtype=None,
                 **unused):
        super().__init__()
        ch = [int(c) for c in in_channels]
        kw = dict(norm_cfg=dict(norm_cfg or dict(type="BN2d", momentum=0.03,
                                                 eps=0.001)),
                  act_cfg=dict(act_cfg or dict(type="swish")),
                  dtype=resolve_dtype(compute_dtype))
        n = len(ch)
        self.reduce_layers = nn.ModuleList()
        self.top_down_blocks = nn.ModuleList()
        for idx in range(n - 1, 0, -1):
            self.reduce_layers.append(ConvModule(ch[idx], ch[idx - 1], 1,
                                                 **kw))
            self.top_down_blocks.append(CSPLayer(
                2 * ch[idx - 1], ch[idx - 1], num_csp_blocks, **kw))
        self.downsamples = nn.ModuleList()
        self.bottom_up_blocks = nn.ModuleList()
        for idx in range(n - 1):
            self.downsamples.append(ConvModule(ch[idx], ch[idx], 3, stride=2,
                                               padding=1, **kw))
            self.bottom_up_blocks.append(CSPLayer(
                2 * ch[idx], ch[idx + 1], num_csp_blocks, **kw))
        self.out_convs = nn.ModuleList([ConvModule(c, int(out_channels), 1,
                                                   **kw) for c in ch])

    def forward(self, inputs):
        """inputs: NHWC maps, fine -> coarse; returns as many maps, each
        ``out_channels`` wide."""
        n = len(self.out_convs)
        assert len(inputs) == n
        inner = list(inputs)
        for k, idx in enumerate(range(n - 1, 0, -1)):
            high = self.reduce_layers[k](inner[idx])
            inner[idx] = high
            th, tw = inner[idx - 1].shape[1:3]
            up = upsample_nearest(high, (2 * high.shape[1],
                                         2 * high.shape[2]))[:, :th, :tw]
            inner[idx - 1] = self.top_down_blocks[k](
                torch.cat([up, inner[idx - 1]], -1))
        outs = [inner[0]]
        for idx in range(n - 1):
            th, tw = inner[idx + 1].shape[1:3]
            down = self.downsamples[idx](outs[-1])[:, :th, :tw]
            outs.append(self.bottom_up_blocks[idx](
                torch.cat([down, inner[idx + 1]], -1)))
        return [conv(o) for conv, o in zip(self.out_convs, outs)]
