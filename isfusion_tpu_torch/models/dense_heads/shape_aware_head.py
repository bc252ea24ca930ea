"""SSN's shape-aware anchor head (counterpart of
``isfusion_tpu/models/dense_heads/shape_aware_head.py``; mmdet3d
``ShapeAwareHead``).

Each task covers a slice of the anchor generator's sizes (and ranges) —
objects of one shape — and has its own branch: 3x3 ConvModules with
BatchNorm at the task's ``shared_conv_strides`` (no activation, as the
JAX package builds them), then 1x1 class, box and direction convs. A
task's outputs are one pseudo-level in Anchor3DHead's format ((B, H_t,
W_t, A_t * C) maps), so the inherited targets, losses and decode apply;
``anchors_for`` builds each task's anchors from its size slice at its
strided map size, and ``anchor_size_index`` maps each anchor to its
global size (for ``assign_per_class``). The convs compute in
``compute_dtype``. Reference names: ``heads.{t}.shared_conv.{j}.{conv,
bn}``, ``heads.{t}.conv_cls`` / ``conv_reg`` / ``conv_dir_cls``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.anchor import build_anchor_generator
from ..layers import Conv2d, ConvModule, resolve_dtype
from .anchor3d_head import Anchor3DHead


class ShapeHead(nn.Module):
    """One task's branch: strided shared convs, then 1x1 convs."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 strides: Sequence[int], num_anchors: int, num_classes: int,
                 code_size: int, use_direction_classifier: bool, dtype=None):
        super().__init__()
        convs, cin = [], in_channels
        for ch, st in zip(channels, strides):
            convs.append(ConvModule(cin, int(ch), 3, stride=int(st),
                                    padding=1, norm_cfg=dict(type="BN2d"),
                                    dtype=dtype))
            cin = int(ch)
        self.shared_conv = nn.Sequential(*convs)
        self.conv_cls = Conv2d(cin, num_anchors * num_classes, 1, dtype=dtype)
        self.conv_reg = Conv2d(cin, num_anchors * code_size, 1, dtype=dtype)
        self.conv_dir_cls = Conv2d(cin, num_anchors * 2, 1, dtype=dtype) \
            if use_direction_classifier else None

    def forward(self, x):
        x = self.shared_conv(x)
        return (self.conv_cls(x), self.conv_reg(x),
                self.conv_dir_cls(x) if self.conv_dir_cls is not None
                else None)


class ShapeAwareHead(Anchor3DHead):
    """``tasks``: dicts of ``num_class``, ``shared_conv_channels`` and
    ``shared_conv_strides``, covering the generator's sizes in order."""

    def __init__(self, tasks: Sequence[dict], in_channels: int = 384,
                 compute_dtype=None, **kwargs):
        super().__init__(in_channels=in_channels, compute_dtype=compute_dtype,
                         **kwargs)
        # the tasks' branches replace the whole-map convs
        self.conv_cls = self.conv_reg = self.conv_dir_cls = None
        gen = self.anchor_generator
        rotations = len(gen.rotations)
        self.task_specs: List[dict] = []
        ptr = 0
        for task in tasks:
            n = int(task["num_class"])
            self.task_specs.append(dict(
                first=ptr, sizes=gen.sizes[ptr:ptr + n],
                ranges=gen.ranges[ptr:ptr + n],
                channels=[int(c) for c in task.get("shared_conv_channels",
                                                   (64, 64))],
                strides=[int(v) for v in task.get("shared_conv_strides",
                                                  (1, 1))]))
            ptr += n
        dt = resolve_dtype(compute_dtype)
        self.heads = nn.ModuleList(
            ShapeHead(in_channels, spec["channels"], spec["strides"],
                      len(spec["sizes"]) * rotations, self.num_classes,
                      self.box_code_size, self.use_direction_classifier, dt)
            for spec in self.task_specs)

    def reset_special_parameters(self):
        for head in self.heads:
            nn.init.constant_(head.conv_cls.bias, -4.595)

    def forward(self, feats) -> List[tuple]:
        """feats: the neck's NHWC map (or a one-map list) -> one (cls, reg,
        dir) per task."""
        x = feats if torch.is_tensor(feats) else feats[0]
        return [head(x) for head in self.heads]

    def _task_generator(self, spec: dict):
        gen = self.anchor_generator
        return build_anchor_generator(dict(
            type=type(gen).__name__, sizes=spec["sizes"],
            ranges=spec["ranges"], scales=gen.scales,
            rotations=gen.rotations, custom_values=gen.custom_values,
            reshape_out=gen.reshape_out))

    def anchors_for(self, featmap_sizes: Sequence[Tuple[int, int]]
                    ) -> np.ndarray:
        """Each task's anchors at its own (strided) map size, in task
        order."""
        if len(featmap_sizes) != len(self.task_specs):
            raise ValueError(f"ShapeAwareHead: one map size per task "
                             f"({len(self.task_specs)}), got "
                             f"{len(featmap_sizes)}")
        out = []
        for fs, spec in zip(featmap_sizes, self.task_specs):
            lv = self._task_generator(spec).grid_anchors(
                [tuple(int(v) for v in fs)])[0]
            out.append(lv.reshape(-1, lv.shape[-1]))
        return np.concatenate(out)

    def anchor_size_index(self, featmap_sizes: Sequence[Tuple[int, int]]
                          ) -> np.ndarray:
        """(N,) the generator's size index of each anchor of
        ``anchors_for``: a task's first size plus its slice's index."""
        r = len(self.anchor_generator.rotations)
        return np.concatenate([
            spec["first"] + np.arange(int(h) * int(w) * len(spec["sizes"]) *
                                      r) // r % len(spec["sizes"])
            for (h, w), spec in zip(featmap_sizes, self.task_specs)])
