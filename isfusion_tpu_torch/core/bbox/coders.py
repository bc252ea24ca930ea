"""Box coders (counterpart of ``isfusion_tpu/core/bbox/coders.py``):
``DeltaXYZWLHRBBoxCoder`` (anchor residuals of PointPillars),
``TransFusionBBoxCoder`` (``encode`` for the training targets, ``decode``
and ``valid_mask`` for the predictions), ``CenterPointBBoxCoder``
(CenterHead's heatmap decode), ``PartialBinBasedBBoxCoder`` (VoteNet's
direction bins and size clusters), ``AnchorFreeBBoxCoder`` (3DSSD) and
``GroupFree3DBBoxCoder`` (Group-Free 3D). Geometry stays float32: the
``exp`` of the size residuals overflows bf16."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ...models.middle_encoders.isfusion_encoder import topk_stable
from ...registry import BBOX_CODERS


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


@BBOX_CODERS.register_module()
class PartialBinBasedBBoxCoder:
    """VoteNet's coder (the JAX package's ``coders.py:137``; reference
    ``partial_bin_based_bbox_coder.py``): the yaw as a class of
    ``num_dir_bins`` equal bins and a residual from the bin's centre, the
    size as one of ``num_sizes`` mean sizes and a residual. Boxes are
    (..., 7) gravity-centred (x, y, z, dx, dy, dz, yaw). The bin width and
    2 pi are Python floats that meet float32 tensors, so they are rounded
    to float32 as the JAX package's weak-typed constants are."""

    def __init__(self, num_dir_bins: int, num_sizes: int, mean_sizes,
                 with_rot: bool = True):
        if len(mean_sizes) != num_sizes:
            raise ValueError("PartialBinBasedBBoxCoder: one mean size a "
                             "size class")
        self.num_dir_bins = int(num_dir_bins)
        self.num_sizes = int(num_sizes)
        self.mean_sizes = torch.as_tensor(mean_sizes, dtype=torch.float32)
        self.with_rot = bool(with_rot)

    def angle2class(self, angle: torch.Tensor):
        """-> (class int64, residual): bins centred on k * 2 pi / bins."""
        two_pi = 2 * math.pi
        per = two_pi / self.num_dir_bins
        shifted = torch.remainder(torch.remainder(angle, two_pi) + per / 2,
                                  two_pi)
        # a true division (CUDA divides by a Python scalar through its
        # reciprocal, which can move a yaw on a bin's edge)
        cls = torch.remainder((shifted / torch.full(
            (), per, dtype=angle.dtype, device=angle.device)).to(torch.int32),
            self.num_dir_bins)
        res = shifted - (cls.to(angle.dtype) * per + per / 2)
        return cls.long(), res

    def class2angle(self, cls: torch.Tensor, res: torch.Tensor):
        return cls.to(res.dtype) * (2 * math.pi / self.num_dir_bins) + res

    def encode(self, gt_gravity_center, gt_dims, gt_yaw, gt_labels):
        """-> (centre, size class (the label), size residual, direction
        class, direction residual)."""
        size_res = gt_dims - self.mean_sizes.to(gt_dims.device)[gt_labels]
        if self.with_rot:
            dir_cls, dir_res = self.angle2class(gt_yaw)
        else:
            dir_cls = torch.zeros(gt_yaw.shape, dtype=torch.long,
                                  device=gt_yaw.device)
            dir_res = torch.zeros_like(gt_yaw)
        return gt_gravity_center, gt_labels, size_res, dir_cls, dir_res

    def decode(self, center, dir_class_logits, dir_res, size_class_logits,
               size_res):
        """centre (..., P, 3), direction logits and residuals (..., P,
        bins), size logits (..., P, sizes), size residuals (..., P, sizes,
        3) -> (..., P, 7) gravity-centred boxes (sizes at least 0.01)."""
        dir_cls = dir_class_logits.argmax(-1)
        dres = torch.gather(dir_res, -1, dir_cls[..., None])[..., 0]
        yaw = self.class2angle(dir_cls, dres) if self.with_rot else \
            torch.zeros(center.shape[:-1], dtype=center.dtype,
                        device=center.device)
        size_cls = size_class_logits.argmax(-1)
        sres = torch.gather(size_res, -2, size_cls[..., None, None].expand(
            *size_cls.shape, 1, 3))[..., 0, :]
        dims = (self.mean_sizes.to(center.device)[size_cls] + sres
                ).clamp_min(0.01)
        return torch.cat([center, dims, yaw[..., None]], -1)


def _per_bin(like: torch.Tensor, num_dir_bins: int) -> torch.Tensor:
    """2 pi / bins as a float32 tensor: a true division by it, as JAX
    divides by the weak-typed constant (CUDA divides by a Python scalar
    through its reciprocal)."""
    return torch.full((), 2 * math.pi / num_dir_bins, dtype=like.dtype,
                      device=like.device)


@BBOX_CODERS.register_module()
class AnchorFreeBBoxCoder(PartialBinBasedBBoxCoder):
    """3DSSD's coder (the JAX package's ``coders.py:251``; reference
    ``anchor_free_bbox_coder.py``): the size as half extents (decoded as
    twice the prediction, at least 0.1), the yaw as a bin and a residual
    normalised by the bin's width. No size classes."""

    def __init__(self, num_dir_bins: int, with_rot: bool = True, **unused):
        super().__init__(num_dir_bins, 0, [], with_rot=with_rot)

    def encode(self, gt_gravity_center, gt_dims, gt_yaw, gt_labels):
        """-> (centre, half extents, direction class, normalised
        direction residual)."""
        if self.with_rot:
            dir_cls, dir_res = self.angle2class(gt_yaw)
            dir_res = dir_res / _per_bin(dir_res, self.num_dir_bins)
        else:
            dir_cls = torch.zeros_like(gt_labels)
            dir_res = torch.zeros_like(gt_yaw)
        return gt_gravity_center, gt_dims / 2, dir_cls, dir_res

    def decode(self, center, dir_class_logits, dir_res_norm, size):
        """centre (..., P, 3), direction logits and normalised residuals
        (..., P, bins), half extents (..., P, 3) -> (..., P, 7)
        gravity-centred boxes."""
        if self.with_rot:
            dir_cls = dir_class_logits.argmax(-1)
            res = torch.gather(dir_res_norm * (2 * math.pi /
                                               self.num_dir_bins), -1,
                               dir_cls[..., None])[..., 0]
            yaw = self.class2angle(dir_cls, res)
        else:
            yaw = torch.zeros(center.shape[:-1], dtype=center.dtype,
                              device=center.device)
        dims = (size * 2).clamp_min(0.1)
        return torch.cat([center, dims, yaw[..., None]], -1)


@BBOX_CODERS.register_module()
class GroupFree3DBBoxCoder(PartialBinBasedBBoxCoder):
    """Group-Free 3D's coder (the JAX package's ``coders.py:285``;
    reference ``groupfree3d_bbox_coder.py``): the partial-bin yaw, and the
    size either regressed directly (``size_cls_agnostic``) or as a class's
    mean size plus a residual. ``decode`` reads a head's prediction dict
    under a stage's prefix."""

    def __init__(self, num_dir_bins: int, num_sizes: int, mean_sizes,
                 with_rot: bool = True, size_cls_agnostic: bool = True,
                 **unused):
        super().__init__(num_dir_bins, num_sizes, mean_sizes,
                         with_rot=with_rot)
        self.size_cls_agnostic = bool(size_cls_agnostic)

    def encode(self, gt_gravity_center, gt_dims, gt_yaw, gt_labels):
        """-> (centre, size (the dims), size class, size residual,
        direction class, normalised direction residual)."""
        center, size_cls, size_res, dir_cls, dir_res = super().encode(
            gt_gravity_center, gt_dims, gt_yaw, gt_labels)
        dir_res = dir_res / _per_bin(dir_res, self.num_dir_bins)
        return center, gt_dims, size_cls, size_res, dir_cls, dir_res

    def decode(self, bbox_out: dict, prefix: str = "") -> torch.Tensor:
        """A stage's ``{prefix}center``, direction and size predictions ->
        (..., P, 7) gravity-centred boxes."""
        center = bbox_out[f"{prefix}center"]
        if self.with_rot:
            dir_cls = bbox_out[f"{prefix}dir_class"].argmax(-1)
            res = torch.gather(bbox_out[f"{prefix}dir_res"], -1,
                               dir_cls[..., None])[..., 0]
            yaw = self.class2angle(dir_cls, res)
        else:
            yaw = torch.zeros(center.shape[:-1], dtype=center.dtype,
                              device=center.device)
        if self.size_cls_agnostic:
            dims = bbox_out[f"{prefix}size"]
        else:
            size_cls = bbox_out[f"{prefix}size_class"].argmax(-1)
            res = torch.gather(bbox_out[f"{prefix}size_res"], -2, size_cls[
                ..., None, None].expand(*size_cls.shape, 1, 3))[..., 0, :]
            dims = self.mean_sizes.to(center.device)[size_cls] + res
        return torch.cat([center, dims, yaw[..., None]], -1)
