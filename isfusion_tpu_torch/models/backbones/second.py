"""SECONDV2 staged BEV backbone (counterpart of
``isfusion_tpu/models/backbones/second.py:SECONDV2``), NHWC.

``stage1``: block 0 (entry conv + ``layer_nums[0]`` convs) and a stride-2
``ds_layer``; ``stage2``: block 1 (``layer_nums[1]`` convs, no entry
conv). Reference names: ``blocks.{i}.{3j}`` conv, ``blocks.{i}.{3j+1}`` BN,
``ds_layer.{0,1}``.
"""
from __future__ import annotations

from torch import nn

from ..layers import BatchNorm, Conv2d, norm_eps, resolve_dtype


def _conv_bn_relu(cin, cout, stride, eps, dt):
    return [Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False,
                   dtype=dt), BatchNorm(cout, eps=eps, dtype=dt), nn.ReLU()]


class SECONDV2(nn.Module):
    def __init__(self, in_channels=128, out_channels=(128, 256),
                 layer_nums=(5, 5), layer_strides=(1, 2), norm_cfg=None,
                 compute_dtype=None, **unused):
        super().__init__()
        dt = resolve_dtype(compute_dtype)
        self.cdtype = dt
        eps = norm_eps(norm_cfg or dict(type="BN", eps=1e-3), 1e-3)
        c0, c1 = out_channels
        b0 = _conv_bn_relu(in_channels, c0, layer_strides[0], eps, dt)
        for _ in range(layer_nums[0]):
            b0 += _conv_bn_relu(c0, c0, 1, eps, dt)
        b1 = []
        for _ in range(layer_nums[1]):
            b1 += _conv_bn_relu(c1, c1, 1, eps, dt)
        self.blocks = nn.ModuleList([nn.Sequential(*b0), nn.Sequential(*b1)])
        self.ds_layer = nn.Sequential(*_conv_bn_relu(c0, c1, 2, eps, dt))

    def forward(self, x, stage: str = "stage1"):
        if self.cdtype is not None:
            x = x.to(self.cdtype)
        if stage == "stage1":
            out = self.blocks[0](x)
            return out, self.ds_layer(out)
        if stage == "stage2":
            return self.blocks[1](x)
        raise ValueError(f"unknown SECONDV2 stage {stage!r}")
