"""PointPillarsScatter (counterpart of
``isfusion_tpu/models/middle_encoders/pillar_scatter.py``): pillar
features onto dense (B, ny, nx, C) BEV canvases (NHWC), one ``index_put_``
for the whole batch. No parameters."""
from __future__ import annotations

import torch
from torch import nn


class PointPillarsScatter(nn.Module):
    def __init__(self, in_channels: int = 64, output_shape=(496, 432),
                 **unused):
        super().__init__()
        self.in_channels = int(in_channels)
        self.ny, self.nx = int(output_shape[0]), int(output_shape[1])

    def forward(self, voxel_features: torch.Tensor, coors: torch.Tensor,
                batch_size: int) -> torch.Tensor:
        """voxel_features (V, C); coors (V, 4) int (b, z, y, x) ->
        (batch_size, ny, nx, C)."""
        c = voxel_features.shape[-1]
        canvas = voxel_features.new_zeros((batch_size * self.ny * self.nx, c))
        co = coors.long()
        idx = (co[:, 0] * self.ny + co[:, 2]) * self.nx + co[:, 3]
        canvas = canvas.index_put((idx,), voxel_features)
        return canvas.view(batch_size, self.ny, self.nx, c)
