"""PartA2's RoI head (counterpart of ``isfusion_tpu/models/roi_heads/
part_aggregation_roi_head.py:PartAggregationROIHead``).

``forward(rois (B, R, 7), roi_mask (B, R), voxel_centers (B, V, 3),
voxel_feats (B, V, C_in), voxel_mask (B, V))``: K16 mean-pools the voxel
features inside each RoI onto a G x G x G grid (``ops/roiaware_pool.py``),
and an MLP over the flattened grid (``shared_{i}`` Linear + ReLU) gives an
IoU-guided score (``conv_cls``) and a residual box (``conv_reg``), all in
float32. ``loss``: each RoI's best 3D IoU with the valid GTs (K10,
``boxes_iou_3d``; the first best GT on ties, as ``argmax``) gives the
score target clip((IoU - 0.25) / 0.5, 0, 1) (sigmoid CE over the valid
RoIs) and, above ``pos_iou_thr``, the residual target (smooth L1, beta
1/9). ``get_bboxes``: the residual decode (centre by the BEV diagonal and
the height, sizes by exp of the clipped deltas, yaw + arcsin of the
clipped sine).

This is the JAX module's head: mean pooling and an MLP, not the
reference's max / avg pooling at ``out_size`` 14 and its sparse-conv bbox
head (ROADMAP queue 3). Names are the JAX module's own under the
reference's ``roi_head.`` prefix.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.box_ops import boxes_iou_3d
from ...ops.roiaware_pool import roiaware_pool
from ..layers import Linear
from ..losses import build_loss


class PartAggregationROIHead(nn.Module):
    def __init__(self, num_classes: int = 3, grid_size: int = 6,
                 in_channels: int = 20, shared_channels=(128, 128),
                 pos_iou_thr: float = 0.55, train_cfg=None, test_cfg=None,
                 **unused):
        super().__init__()
        self.num_classes = int(num_classes)
        self.grid_size = int(grid_size)
        self.pos_iou_thr = float(pos_iou_thr)
        width = self.grid_size ** 3 * int(in_channels)
        self.n_shared = len(shared_channels)
        for i, ch in enumerate(shared_channels):
            self.add_module(f"shared_{i}", Linear(width, int(ch)))
            width = int(ch)
        self.conv_cls = Linear(width, 1)
        self.conv_reg = Linear(width, 7)
        self.loss_ce = build_loss(dict(type="CrossEntropyLoss",
                                       use_sigmoid=True, reduction="none"))
        self.loss_sl1 = build_loss(dict(type="SmoothL1Loss", beta=1.0 / 9.0,
                                        reduction="none"))

    def forward(self, rois, roi_mask, voxel_centers, voxel_feats,
                voxel_mask) -> dict:
        """dict(cls_score (B, R), bbox_pred (B, R, 7), rois, roi_mask)."""
        pooled = roiaware_pool(rois[..., :7], voxel_centers, voxel_feats,
                               voxel_mask, self.grid_size)
        x = pooled.reshape(pooled.shape[0], pooled.shape[1], -1)
        for i in range(self.n_shared):
            x = torch.relu(getattr(self, f"shared_{i}")(x))
        return dict(cls_score=self.conv_cls(x)[..., 0],
                    bbox_pred=self.conv_reg(x), rois=rois, roi_mask=roi_mask)

    def loss(self, preds: dict, gt_bboxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_mask: torch.Tensor) -> dict:
        rois = preds["rois"].float()
        roi_mask = preds["roi_mask"].bool()
        gts = gt_bboxes[..., :7].float()
        iou = boxes_iou_3d(rois[..., :7], gts)               # (B, R, G)
        iou = torch.where(gt_mask.bool()[:, None, :], iou, 0.0)
        best_iou = iou.max(-1).values
        assigned = torch.argmax(iou, -1)
        cls_t = ((best_iou - 0.25) / 0.5).clamp(0.0, 1.0)
        w = roi_mask.float()
        loss_cls = (self.loss_ce(preds["cls_score"], cls_t) * w).sum() / \
            w.sum().clamp_min(1.0)
        matched = torch.gather(gts, 1, assigned[..., None].expand(-1, -1, 7))
        diag = torch.linalg.norm(rois[..., 3:5], dim=-1)
        tx = (matched[..., 0] - rois[..., 0]) / diag.clamp_min(1e-3)
        ty = (matched[..., 1] - rois[..., 1]) / diag.clamp_min(1e-3)
        tz = (matched[..., 2] - rois[..., 2]) / rois[..., 5].clamp_min(1e-3)
        tdim = torch.log(matched[..., 3:6].clamp_min(1e-3) /
                         rois[..., 3:6].clamp_min(1e-3))
        tyaw = matched[..., 6] - rois[..., 6]
        target = torch.cat([tx[..., None], ty[..., None], tz[..., None],
                            tdim, torch.sin(tyaw)[..., None]], -1)
        pw = ((best_iou > self.pos_iou_thr) & roi_mask).float()[..., None]
        loss_reg = (self.loss_sl1(preds["bbox_pred"], target) * pw).sum() / \
            pw.sum().clamp_min(1.0)
        return dict(loss_roi_cls=loss_cls, loss_roi_reg=loss_reg)

    def get_bboxes(self, preds: dict) -> dict:
        rois, reg = preds["rois"].float(), preds["bbox_pred"].float()
        diag = torch.linalg.norm(rois[..., 3:5], dim=-1)
        x = rois[..., 0] + reg[..., 0] * diag
        y = rois[..., 1] + reg[..., 1] * diag
        z = rois[..., 2] + reg[..., 2] * rois[..., 5]
        dims = rois[..., 3:6] * torch.exp(reg[..., 3:6].clamp(-2, 2))
        yaw = rois[..., 6] + torch.arcsin(reg[..., 6].clamp(-1, 1))
        boxes = torch.cat([x[..., None], y[..., None], z[..., None], dims,
                           yaw[..., None]], -1)
        scores = torch.sigmoid(preds["cls_score"].float())
        mask = preds["roi_mask"].bool()
        return dict(bboxes=boxes, scores=torch.where(mask, scores, 0.0),
                    mask=mask)
