"""SECOND BEV backbones (counterpart of
``isfusion_tpu/models/backbones/second.py``), NHWC.

``SECOND`` (PointPillars): per block an entry conv at the block's stride
and ``layer_nums[i]`` convs, each block's output returned.
``SECONDV2`` (IS-Fusion), staged: ``stage1`` is block 0 (entry conv +
``layer_nums[0]`` convs) and a stride-2 ``ds_layer``; ``stage2`` is block
1 (``layer_nums[1]`` convs, no entry conv). Reference names:
``blocks.{i}.{3j}`` conv, ``blocks.{i}.{3j+1}`` BN, ``ds_layer.{0,1}``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..layers import BatchNorm, Conv2d, norm_eps, norm_momentum, resolve_dtype


def _conv_bn_relu(cin, cout, stride, bn, dt):
    return [Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False,
                   dtype=dt), BatchNorm(cout, dtype=dt, **bn), nn.ReLU()]


def _bn_args(norm_cfg):
    norm_cfg = norm_cfg or dict(type="BN", eps=1e-3, momentum=0.01)
    return dict(eps=norm_eps(norm_cfg, 1e-3),
                momentum=norm_momentum(norm_cfg, 0.01))


class SECOND(nn.Module):
    def __init__(self, in_channels=128, out_channels=(128, 128, 256),
                 layer_nums=(3, 5, 5), layer_strides=(2, 2, 2), norm_cfg=None,
                 compute_dtype=None, **unused):
        super().__init__()
        dt = resolve_dtype(compute_dtype)
        self.cdtype = dt
        bn = _bn_args(norm_cfg)
        blocks, cin = [], in_channels
        for cout, n, s in zip(out_channels, layer_nums, layer_strides):
            layers = _conv_bn_relu(cin, cout, s, bn, dt)
            for _ in range(n):
                layers += _conv_bn_relu(cout, cout, 1, bn, dt)
            blocks.append(nn.Sequential(*layers))
            cin = cout
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if self.cdtype is not None:
            x = x.to(self.cdtype)
        outs = []
        for blk in self.blocks:
            x = blk(x)
            outs.append(x)
        return tuple(outs)


class SECONDV2(nn.Module):
    def __init__(self, in_channels=128, out_channels=(128, 256),
                 layer_nums=(5, 5), layer_strides=(1, 2), norm_cfg=None,
                 compute_dtype=None, **unused):
        super().__init__()
        dt = resolve_dtype(compute_dtype)
        self.cdtype = dt
        bn = _bn_args(norm_cfg)
        c0, c1 = out_channels
        b0 = _conv_bn_relu(in_channels, c0, layer_strides[0], bn, dt)
        for _ in range(layer_nums[0]):
            b0 += _conv_bn_relu(c0, c0, 1, bn, dt)
        b1 = []
        for _ in range(layer_nums[1]):
            b1 += _conv_bn_relu(c1, c1, 1, bn, dt)
        self.blocks = nn.ModuleList([nn.Sequential(*b0), nn.Sequential(*b1)])
        self.ds_layer = nn.Sequential(*_conv_bn_relu(c0, c1, 2, bn, dt))

    def forward(self, x, stage: str = "stage1"):
        if self.cdtype is not None:
            x = x.to(self.cdtype)
        if stage == "stage1":
            out = self.blocks[0](x)
            return out, self.ds_layer(out)
        if stage == "stage2":
            return self.blocks[1](x)
        raise ValueError(f"unknown SECONDV2 stage {stage!r}")
