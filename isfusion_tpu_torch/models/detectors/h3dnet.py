"""H3DNet (counterpart of ``isfusion_tpu/models/detectors/h3dnet.py``), the
JAX package's compact version: a VoteNet whose backbone's seed features
also feed two primitive vote branches (``face_vote`` and ``edge_vote``:
``VoteModule`` over a ``prim_proj`` projection to ``primitive_channels``),
supervised by the distance of each seed's vote to the nearest face centre
and vertical-edge midpoint of the GT boxes (``loss_face_vote``,
``loss_edge_vote``: the distance capped at 3 m, averaged over the valid
seeds, weighted 0.3). Its predict path is VoteNet's. These modules are the
JAX package's, not the reference's primitive heads (mmdet3d
``detectors/h3dnet.py``, ``roi_heads/h3d_roi_head.py``), so they keep the
JAX names.
"""
from __future__ import annotations

import torch
from torch import nn

from ...registry import DETECTORS
from ..dense_heads.vote_head import VoteModule, _gravity_centers, _sq_norm
from .votenet import VoteNet


def _box_axes(boxes: torch.Tensor):
    """(..., 7) -> the half extents along the box's local x and y in the
    world frame: local +x maps to (cos, -sin), +y to (sin, cos)."""
    cos, sin = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    zero = torch.zeros_like(cos)
    ex = torch.stack([cos, -sin, zero], -1) * boxes[..., 3:4] / 2
    ey = torch.stack([sin, cos, zero], -1) * boxes[..., 4:5] / 2
    return ex, ey


def box_face_centers(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) gravity-centred boxes -> (..., 6, 3) face centres."""
    c = boxes[..., :3]
    ex, ey = _box_axes(boxes)
    zero = torch.zeros_like(boxes[..., 6])
    ez = torch.stack([zero, zero, torch.ones_like(zero)], -1) * \
        boxes[..., 5:6] / 2
    return torch.stack([c + ex, c - ex, c + ey, c - ey, c + ez, c - ez], -2)


def box_edge_centers(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) gravity-centred boxes -> (..., 4, 3): the midpoints of the
    four vertical edges."""
    c = boxes[..., :3]
    ex, ey = _box_axes(boxes)
    return torch.stack([c + ex + ey, c + ex - ey, c - ex + ey, c - ex - ey],
                       -2)


@DETECTORS.register_module()
class H3DNet(VoteNet):
    def __init__(self, backbone: dict, bbox_head: dict,
                 primitive_channels: int = 64, **kwargs):
        super().__init__(backbone, bbox_head, **kwargs)
        pc = int(primitive_channels)
        seed_channels = self.bbox_head.vote_module.in_channels
        self.face_vote = VoteModule(in_channels=pc, conv_channels=(pc,))
        self.edge_vote = VoteModule(in_channels=pc, conv_channels=(pc,))
        self.prim_proj = nn.Linear(seed_channels, pc)

    def _forward(self, t: dict, mode: str):
        feat_dict = self.backbone(t["points"].float(),
                                  t["points_mask"].bool())
        seed_xyz = feat_dict["fp_xyz"][-1]
        seed_mask = feat_dict["fp_masks"][-1]
        seed_feats = self.prim_proj(feat_dict["fp_features"][-1])
        face_xyz = self.face_vote(seed_xyz, seed_feats, seed_mask)[0]
        edge_xyz = self.edge_vote(seed_xyz, seed_feats, seed_mask)[0]
        preds = self.bbox_head(feat_dict)
        if mode == "feats":
            return dict(preds, face_xyz=face_xyz, edge_xyz=edge_xyz)
        if mode == "loss":
            losses = self.bbox_head.loss(preds, t["gt_bboxes_3d"].float(),
                                         t["gt_labels_3d"], t["gt_mask"])
            losses.update(self.primitive_losses(
                face_xyz, edge_xyz, seed_mask, t["gt_bboxes_3d"].float(),
                t["gt_mask"].bool()))
            return losses
        return self.bbox_head.get_bboxes(preds)

    @staticmethod
    def primitive_losses(face_xyz, edge_xyz, seed_mask, gt: torch.Tensor,
                         gt_mask: torch.Tensor) -> dict:
        """Each seed's face and edge votes against the nearest GT face
        centre and vertical-edge midpoint: sqrt(min d2 + 1e-8), capped at
        3, averaged over the valid seeds, times 0.3."""
        grav = torch.cat([_gravity_centers(gt), gt[..., 3:7]], -1)
        w = seed_mask.float()

        def term(points, targets, per_box):
            b, g = targets.shape[:2]
            flat = targets.reshape(b, g * per_box, 3)
            tmask = gt_mask.repeat_interleave(per_box, -1)
            d2 = torch.where(tmask[:, None, :], _sq_norm(
                points[:, :, None, :] - flat[:, None, :, :]),
                torch.full((), 1e10, device=points.device))
            d = torch.sqrt(d2.amin(-1) + 1e-8)
            return 0.3 * (d.clamp_max(3.0) * w).sum() / w.sum().clamp_min(1.0)

        return dict(loss_face_vote=term(face_xyz, box_face_centers(grav), 6),
                    loss_edge_vote=term(edge_xyz, box_edge_centers(grav), 4))
