"""RegNet and NoStemRegNet BEV backbones (counterpart of
``isfusion_tpu/models/backbones/regnet.py``; mmdet ``RegNet``,
mmdet3d ``NoStemRegNet``), NHWC.

``arch`` (a dict: ``w0``, ``wa``, ``wm``, ``depth``, ``group_w``,
``bot_mul``) gives the stage widths and depths (``generate_regnet``:
w0 + wa * i quantised on a log grid of ratio wm, rounded to multiples of
8; ``adjust_width_group``: widths rounded to multiples of the group
width). Each stage is a run of residual blocks: 1x1 conv, grouped 3x3
conv (the stage's stride on its first block), 1x1 conv, each with its
BatchNorm, ReLU after the first two and after the sum; a 1x1 conv + BN
shortcut where the stride or the width changes. The 3x3 conv takes
``group_w`` groups, as the JAX package builds it (its ``feature_group_count``;
the reference's RegNet takes ``width / group_w`` groups of ``group_w``
channels; ROADMAP queue 3). ``RegNet`` starts with a stride-2 3x3 stem
conv; ``NoStemRegNet`` takes the voxel encoder's (N, H, W,
``base_channels``) map instead. Returns the stage maps of
``out_indices``. Convs compute in ``compute_dtype`` (the BatchNorms'
statistics in float32). Reference names: ``conv1``, ``bn1`` (the stem),
``layer{i}.{j}.{conv1,bn1,conv2,bn2,conv3,bn3}``,
``layer{i}.{j}.downsample.{0,1}``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..layers import BatchNorm, Conv2d, bn_args, resolve_dtype


def generate_regnet(w0: float, wa: float, wm: float, depth: int,
                    quant: int = 8) -> Tuple[list, list]:
    """Per-stage (widths, depths) of the RegNet parameterisation."""
    widths_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, ks)
    widths = (np.round(widths / quant) * quant).astype(int).tolist()
    stage_widths = sorted(set(widths))
    return stage_widths, [widths.count(w) for w in stage_widths]


def adjust_width_group(widths: Sequence[int], bottleneck_ratio: float,
                       groups: int) -> Tuple[list, list]:
    """Group widths clamped to the bottleneck widths, and widths rounded
    to multiples of them (mmdet ``RegNet.adjust_width_group``)."""
    bottleneck = [int(w * bottleneck_ratio) for w in widths]
    gs = [min(groups, bw) for bw in bottleneck]
    bottleneck = [int(round(bw / g) * g) for bw, g in zip(bottleneck, gs)]
    return [int(bw / bottleneck_ratio) for bw in bottleneck], gs


class RegBottleneck(nn.Module):
    """1x1 -> grouped 3x3 (stride) -> 1x1 residual block."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 groups: int = 1, bottleneck_ratio: float = 1.0,
                 bn: Optional[dict] = None, dtype=None):
        super().__init__()
        width = int(round(cout * bottleneck_ratio / groups) * groups)
        bn = dict(bn or {})
        self.conv1 = Conv2d(cin, width, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(width, dtype=dtype, **bn)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1,
                            groups=groups, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(width, dtype=dtype, **bn)
        self.conv3 = Conv2d(width, cout, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm(cout, dtype=dtype, **bn)
        self.downsample = nn.Sequential(
            Conv2d(cin, cout, 1, stride=stride, bias=False, dtype=dtype),
            BatchNorm(cout, dtype=dtype, **bn)) \
            if stride != 1 or cin != cout else None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class RegNet(nn.Module):
    with_stem = True

    def __init__(self, arch: dict, in_channels: int = 3,
                 stem_channels: int = 32, base_channels: int = 32,
                 strides: Sequence[int] = (2, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 norm_cfg: Optional[dict] = None, compute_dtype=None,
                 **unused):
        super().__init__()
        if not isinstance(arch, dict):
            raise ValueError("RegNet: arch is a dict (w0, wa, wm, depth, "
                             "group_w, bot_mul), as in the JAX package")
        dt = resolve_dtype(compute_dtype)
        widths, depths = generate_regnet(arch["w0"], arch["wa"], arch["wm"],
                                         arch["depth"])
        bot_mul = float(arch.get("bot_mul", 1.0))
        widths, groups = adjust_width_group(widths, bot_mul,
                                            int(arch.get("group_w", 1)))
        self.stage_widths, self.stage_depths = widths, depths
        self.out_indices = tuple(int(i) for i in out_indices)
        bn = bn_args(dict(norm_cfg or dict(type="BN2d")))
        cin = base_channels
        if self.with_stem:
            self.conv1 = Conv2d(in_channels, stem_channels, 3, stride=2,
                                padding=1, bias=False, dtype=dt)
            self.bn1 = BatchNorm(stem_channels, dtype=dt, **bn)
            cin = stem_channels
        for i, (w, d) in enumerate(zip(widths, depths)):
            blocks = []
            for j in range(d):
                blocks.append(RegBottleneck(cin, w, strides[i] if j == 0
                                            else 1, groups[i], bot_mul, bn,
                                            dt))
                cin = w
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        if self.with_stem:
            x = torch.relu(self.bn1(self.conv1(x)))
        outs = []
        for i in range(len(self.stage_widths)):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


class NoStemRegNet(RegNet):
    """RegNet without the stem: the voxel encoder plays its role, and the
    input is already (N, H, W, ``base_channels``)."""

    with_stem = False
