"""Box coders (counterpart of ``isfusion_tpu/core/bbox/coders.py``):
``DeltaXYZWLHRBBoxCoder`` (anchor residuals of PointPillars),
``TransFusionBBoxCoder`` (``encode`` for the training targets, ``decode``
and ``valid_mask`` for the predictions) and ``CenterPointBBoxCoder``
(CenterHead's heatmap decode). Geometry stays float32: the ``exp`` of
the size residuals overflows bf16."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...models.middle_encoders.isfusion_encoder import topk_stable


class DeltaXYZWLHRBBoxCoder:
    """Residuals against anchors: xy over the anchor's BEV diagonal, z
    (gravity centre) over its height, log sizes, additive yaw, raw
    differences of the custom values (velocity)."""

    def __init__(self, code_size: int = 7, **unused):
        self.code_size = code_size

    @staticmethod
    def encode(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        anchors, gt = anchors.float(), gt.float()
        xa, ya, za, wa, la, ha, ra = anchors[..., :7].unbind(-1)
        xg, yg, zg, wg, lg, hg, rg = gt[..., :7].unbind(-1)
        za = za + ha / 2
        zg = zg + hg / 2
        diag = torch.sqrt(la ** 2 + wa ** 2)
        out = torch.stack([(xg - xa) / diag, (yg - ya) / diag,
                           (zg - za) / ha, torch.log(wg / wa),
                           torch.log(lg / la), torch.log(hg / ha), rg - ra],
                          -1)
        return torch.cat([out, gt[..., 7:] - anchors[..., 7:]], -1)

    @staticmethod
    def decode(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        anchors, deltas = anchors.float(), deltas.float()
        xa, ya, za, wa, la, ha, ra = anchors[..., :7].unbind(-1)
        xt, yt, zt, wt, lt, ht, rt = deltas[..., :7].unbind(-1)
        za = za + ha / 2
        diag = torch.sqrt(la ** 2 + wa ** 2)
        hg = torch.exp(ht) * ha
        out = torch.stack([xt * diag + xa, yt * diag + ya,
                           zt * ha + za - hg / 2, torch.exp(wt) * wa,
                           torch.exp(lt) * la, hg, rt + ra], -1)
        return torch.cat([out, deltas[..., 7:] + anchors[..., 7:]], -1)


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

    def encode(self, dst_boxes: torch.Tensor) -> torch.Tensor:
        """(..., 9) LiDAR boxes -> (..., code_size) targets: xy in BEV
        feature cells, gravity-centre z, log dims, sin/cos yaw, velocity."""
        b = dst_boxes.float()
        step_x = self.out_size_factor * self.voxel_size[0]
        step_y = self.out_size_factor * self.voxel_size[1]
        out = [((b[..., 0] - self.pc_range[0]) / step_x)[..., None],
               ((b[..., 1] - self.pc_range[1]) / step_y)[..., None],
               (b[..., 2] + b[..., 5] * 0.5)[..., None],
               torch.log(b[..., 3:6]),
               torch.sin(b[..., 6])[..., None],
               torch.cos(b[..., 6])[..., None]]
        if self.code_size == 10:
            out.append(b[..., 7:9])
        return torch.cat(out, -1)

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


class CenterPointBBoxCoder:
    """CenterPoint's heatmap decode: the top ``max_num`` of a task's
    class-major flattened heatmap (one joint top-k over its classes, ties
    to the lower index, as ``jax.lax.top_k``), each decoded from its
    cell: x = (col + reg_x) * out_size_factor * voxel_x + pc_x (y alike),
    gravity-centre z, dims, yaw = atan2(sin, cos), velocity; masked by
    the score threshold and the post-centre range."""

    def __init__(self, pc_range: Sequence[float], out_size_factor: int,
                 voxel_size: Sequence[float],
                 post_center_range: Optional[Sequence[float]] = None,
                 max_num: int = 100, score_threshold: Optional[float] = None,
                 code_size: int = 9, **unused):
        self.pc_range = [float(v) for v in pc_range]
        self.out_size_factor = int(out_size_factor)
        self.voxel_size = [float(v) for v in voxel_size]
        self.post_center_range = None if post_center_range is None else \
            [float(v) for v in post_center_range]
        self.max_num = int(max_num)
        self.score_threshold = None if score_threshold is None else \
            float(score_threshold)
        self.code_size = code_size

    def decode(self, heat: torch.Tensor, rot_sine: torch.Tensor,
               rot_cosine: torch.Tensor, hei: torch.Tensor, dim: torch.Tensor,
               vel: Optional[torch.Tensor], reg: torch.Tensor) -> dict:
        """Batched: heat (B, H, W, C) probabilities, rot_sine, rot_cosine,
        hei (B, H, W, 1), dim (B, H, W, 3) (decoded sizes), vel (B, H, W,
        2) or None, reg (B, H, W, 2) -> dict(bboxes (B, K, 7|9), scores
        (B, K) (0 where masked), labels (B, K), mask (B, K))."""
        b, h, w, nc = heat.shape
        flat = heat.float().permute(0, 3, 1, 2).reshape(b, nc * h * w)
        topi = topk_stable(flat, self.max_num)
        topv = torch.gather(flat, 1, topi)
        labels, pix = topi // (h * w), topi % (h * w)

        def gather(m):
            m = m.float().reshape(b, h * w, -1)
            return torch.gather(m, 1, pix[..., None].expand(-1, -1,
                                                            m.shape[-1]))

        regs = gather(reg)
        xs = (pix % w).float() + regs[..., 0]
        ys = (pix // w).float() + regs[..., 1]
        rot = torch.atan2(gather(rot_sine)[..., 0], gather(rot_cosine)[..., 0])
        x = xs * self.out_size_factor * self.voxel_size[0] + self.pc_range[0]
        y = ys * self.out_size_factor * self.voxel_size[1] + self.pc_range[1]
        cols = [x[..., None], y[..., None], gather(hei)[..., :1], gather(dim),
                rot[..., None]]
        if vel is not None:
            cols.append(gather(vel))
        bboxes = torch.cat(cols, -1)
        mask = torch.ones(topv.shape, dtype=torch.bool, device=topv.device)
        if self.score_threshold is not None:
            mask &= topv > self.score_threshold
        if self.post_center_range is not None:
            pcr = torch.tensor(self.post_center_range, dtype=torch.float32,
                               device=bboxes.device)
            mask &= (bboxes[..., :3] >= pcr[:3]).all(-1) & \
                (bboxes[..., :3] <= pcr[3:]).all(-1)
        return dict(bboxes=bboxes, scores=torch.where(mask, topv, 0.0),
                    labels=labels, mask=mask)
