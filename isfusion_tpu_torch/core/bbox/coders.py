"""TransFusion box coder (counterpart of ``isfusion_tpu/core/bbox/coders.py:
TransFusionBBoxCoder``), decode only: the predict path needs no targets.
Geometry stays float32."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


class TransFusionBBoxCoder:
    def __init__(self, pc_range: Sequence[float], voxel_size: Sequence[float],
                 out_size_factor: int,
                 post_center_range: Optional[Sequence[float]] = None,
                 score_threshold: float = 0.0, code_size: int = 10, **unused):
        self.pc_range = [float(v) for v in pc_range]
        self.voxel_size = [float(v) for v in voxel_size]
        self.out_size_factor = int(out_size_factor)
        self.post_center_range = None if post_center_range is None else \
            [float(v) for v in post_center_range]
        self.score_threshold = float(score_threshold)
        self.code_size = code_size

    def decode(self, heatmap: torch.Tensor, rot: torch.Tensor,
               dim: torch.Tensor, center: torch.Tensor, height: torch.Tensor,
               vel: Optional[torch.Tensor]) -> dict:
        """Batched: heatmap (B, P, num_cls), rot (B, P, 2), dim (B, P, 3),
        center (B, P, 2), height (B, P, 1), vel (B, P, 2) or None ->
        dict(bboxes (B, P, 7|9), scores (B, P), labels (B, P))."""
        heatmap = heatmap.float()
        scores, labels = heatmap.amax(-1), heatmap.argmax(-1)
        step_x = self.out_size_factor * self.voxel_size[0]
        step_y = self.out_size_factor * self.voxel_size[1]
        center, rot = center.float(), rot.float()
        xs = center[..., 0] * step_x + self.pc_range[0]
        ys = center[..., 1] * step_y + self.pc_range[1]
        dims = torch.exp(dim.float().clamp(-5.0, 5.0))
        yaw = torch.atan2(rot[..., 0], rot[..., 1])
        z_bottom = height.float()[..., 0] - dims[..., 2] * 0.5
        cols = [xs, ys, z_bottom, dims[..., 0], dims[..., 1], dims[..., 2],
                yaw]
        if vel is not None:
            cols += [vel.float()[..., 0], vel.float()[..., 1]]
        return dict(bboxes=torch.stack(cols, -1), scores=scores,
                    labels=labels)

    def valid_mask(self, bboxes: torch.Tensor, scores: torch.Tensor
                   ) -> torch.Tensor:
        """post_center_range + score filter."""
        mask = torch.ones(scores.shape, dtype=torch.bool,
                          device=scores.device)
        if self.score_threshold > 0:
            mask &= scores > self.score_threshold
        if self.post_center_range is not None:
            pcr = torch.tensor(self.post_center_range, dtype=bboxes.dtype,
                               device=bboxes.device)
            center = bboxes[..., :3]
            mask &= (center >= pcr[:3]).all(-1) & (center <= pcr[3:]).all(-1)
        return mask
