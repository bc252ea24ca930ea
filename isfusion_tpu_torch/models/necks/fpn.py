"""FPN neck (counterpart of ``isfusion_tpu/models/necks/fpn.py``; mmdet
``FPN``), NHWC.

Lateral 1x1 convs, a top-down path that adds each level to its finer
neighbour after a nearest-neighbour resize (half-pixel source index, as
``jax.image.resize``; the reference's ``F.interpolate`` picks the same
pixels at the 2x factors of a padded image), 3x3 output convs, then extra
levels up to ``num_outs``: ``max_pool(1, stride 2)`` of the last output
when ``add_extra_convs`` is False, else stride-2 3x3 convs on the last
output (ReLU before all but the first with ``relu_before_extra_convs``).
Convs compute in ``compute_dtype``. Reference names:
``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv`` (the extra convs
numbered after the output convs).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import ConvModule, resolve_dtype


def upsample_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """(N, h, w, C) -> (N, H, W, C), source index floor((i + 0.5) * h / H)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(int(v) for v in hw),
                         mode="nearest-exact").permute(0, 2, 3, 1)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (64, 128, 256),
                 out_channels: int = 256, num_outs: int = 3,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs=False, relu_before_extra_convs: bool = False,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None, compute_dtype=None,
                 **unused):
        super().__init__()
        if add_extra_convs not in (False, "on_output"):
            raise NotImplementedError(
                "the port's FPN takes its extra convs on the last output "
                "('on_output', as the JAX package) or none")
        dt = resolve_dtype(compute_dtype)
        end = len(in_channels) if end_level == -1 else int(end_level)
        self.start_level, self.num_outs = int(start_level), int(num_outs)
        self.add_extra_convs = bool(add_extra_convs)
        self.relu_before_extra_convs = bool(relu_before_extra_convs)
        kw = dict(norm_cfg=norm_cfg, act_cfg=act_cfg, dtype=dt)
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels[i], out_channels, 1, **kw)
            for i in range(self.start_level, end))
        n = len(self.lateral_convs)
        convs = [ConvModule(out_channels, out_channels, 3, padding=1, **kw)
                 for _ in range(n)]
        if self.add_extra_convs:
            convs += [ConvModule(out_channels, out_channels, 3, stride=2,
                                 padding=1, norm_cfg=norm_cfg, dtype=dt)
                      for _ in range(self.num_outs - n)]
        self.fpn_convs = nn.ModuleList(convs)

    def forward(self, inputs: Sequence[torch.Tensor]):
        laterals = [conv(inputs[self.start_level + i])
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest(
                laterals[i], laterals[i - 1].shape[1:3])
        n = len(laterals)
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n)]
        while len(outs) < self.num_outs:
            if self.add_extra_convs:
                src = outs[-1]
                if self.relu_before_extra_convs and len(outs) > n:
                    src = torch.relu(src)
                outs.append(self.fpn_convs[len(outs)](src))
            else:
                outs.append(outs[-1][:, ::2, ::2])
        return tuple(outs)
