"""ResNet image backbone (counterpart of
``isfusion_tpu/models/backbones/resnet.py``; mmdet ``ResNet``), NHWC.

BasicBlock and Bottleneck stages; ``style='caffe'`` strides a
Bottleneck's first 1x1 conv, ``'pytorch'`` its 3x3 conv. ``out_indices``
pick the stages returned. As in the reference, and unlike the JAX package
(which reads neither, so its optimizer moves those weights; ROADMAP queue
3):

- ``frozen_stages`` = k freezes the stem and ``layer1`` .. ``layerk``:
  their parameters do not require gradients and their BatchNorms stay in
  eval mode;
- ``norm_cfg.requires_grad=False`` freezes every BatchNorm's affine
  parameters;
- ``norm_eval`` keeps every BatchNorm in eval mode (running statistics)
  in train mode too.

Convs compute in ``compute_dtype`` (the BatchNorms' statistics in
float32). Reference names: ``conv1``, ``bn1``,
``layer{i}.{j}.{conv1,bn1,conv2,bn2[,conv3,bn3]}``,
``layer{i}.{j}.downsample.{0,1}``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm, Conv2d, norm_eps, norm_momentum, \
    resolve_dtype


def _bn(ch, norm_cfg, dt):
    return BatchNorm(ch, eps=norm_eps(norm_cfg), momentum=norm_momentum(
        norm_cfg), dtype=dt)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, norm_cfg=None, dtype=None,
                 style="pytorch"):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride=stride, padding=1,
                            bias=False, dtype=dtype)
        self.bn1 = _bn(planes, norm_cfg, dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False,
                            dtype=dtype)
        self.bn2 = _bn(planes, norm_cfg, dtype)
        self.downsample = nn.Sequential(
            Conv2d(cin, planes, 1, stride=stride, bias=False, dtype=dtype),
            _bn(planes, norm_cfg, dtype)) \
            if stride != 1 or cin != planes else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, norm_cfg=None, dtype=None,
                 style="pytorch"):
        super().__init__()
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        out = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1, stride=s1, bias=False,
                            dtype=dtype)
        self.bn1 = _bn(planes, norm_cfg, dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride=s2, padding=1,
                            bias=False, dtype=dtype)
        self.bn2 = _bn(planes, norm_cfg, dtype)
        self.conv3 = Conv2d(planes, out, 1, bias=False, dtype=dtype)
        self.bn3 = _bn(out, norm_cfg, dtype)
        self.downsample = nn.Sequential(
            Conv2d(cin, out, 1, stride=stride, bias=False, dtype=dtype),
            _bn(out, norm_cfg, dtype)) if stride != 1 or cin != out else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


ARCH = {18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
        152: (Bottleneck, (3, 8, 36, 3))}


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, in_channels: int = 3,
                 base_channels: int = 64, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_cfg: Optional[dict] = None,
                 norm_eval: bool = True, style: str = "pytorch",
                 compute_dtype=None, **unused):
        super().__init__()
        block, layers = ARCH[int(depth)]
        norm_cfg = dict(norm_cfg or dict(type="BN"))
        dt = resolve_dtype(compute_dtype)
        self.out_indices = tuple(int(i) for i in out_indices)
        self.frozen_stages, self.norm_eval = int(frozen_stages), \
            bool(norm_eval)
        self.num_stages = int(num_stages)
        self.conv1 = Conv2d(in_channels, base_channels, 7, stride=2,
                            padding=3, bias=False, dtype=dt)
        self.bn1 = _bn(base_channels, norm_cfg, dt)
        cin = base_channels
        for i in range(self.num_stages):
            planes = base_channels * 2 ** i
            blocks = []
            for j in range(layers[i]):
                blocks.append(block(cin, planes, strides[i] if j == 0 else 1,
                                    norm_cfg, dt, style))
                cin = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        frozen = [self.conv1, self.bn1] + [
            getattr(self, f"layer{i}") for i in range(
                1, min(self.frozen_stages, self.num_stages) + 1)]
        self._frozen = frozen
        for m in frozen:
            for p in m.parameters():
                p.requires_grad_(False)
        if not norm_cfg.get("requires_grad", True):
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    for p in m.parameters():
                        p.requires_grad_(False)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode:
            for m in self._frozen:
                m.eval()
            if self.norm_eval:
                for m in self.modules():
                    if isinstance(m, BatchNorm):
                        m.eval()
        return self

    def forward(self, x: torch.Tensor):
        """x (N, H, W, C) -> the ``out_indices`` stages' (N, h, w, C')."""
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
