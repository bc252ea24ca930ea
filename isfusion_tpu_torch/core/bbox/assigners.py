"""Hungarian assignment of the TransFusion head (counterpart of
``isfusion_tpu/core/bbox/assigners.py``; reference
``mmdet3d/core/bbox/assigners/hungarian_assigner.py:95``
HungarianAssigner3D with mmdet's FocalLossCost, BBoxBEVL1Cost and
IoU3DCost).

The costs are formed on the device for every sample and decoder layer at
once (IoU3DCost through one launch of the K10 kernel, ``ops/box_ops.py``);
the matching runs on the host (``ops/hungarian.py``).
Padded GT columns carry cost 1e8, and matches to them are reported as
background, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ...ops.box_ops import boxes_iou_3d
from ...ops.hungarian import assign_batch

_BIG = 1e8


def focal_loss_cost(cls_pred: torch.Tensor, gt_labels: torch.Tensor,
                    weight: float, alpha: float = 0.25, gamma: float = 2.0,
                    eps: float = 1e-12) -> torch.Tensor:
    """(..., Q, num_classes) logits x (..., G) labels -> (..., Q, G)."""
    p = torch.sigmoid(cls_pred.float())
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    lab = gt_labels.long()[..., None, :].expand(
        cls_pred.shape[:-1] + gt_labels.shape[-1:])
    return (torch.gather(pos, -1, lab) - torch.gather(neg, -1, lab)) * weight


def bbox_bev_l1_cost(bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
                     pc_range: Sequence[float], weight: float
                     ) -> torch.Tensor:
    start = torch.tensor([float(v) for v in pc_range[0:2]],
                         device=bboxes.device)
    extent = torch.tensor([float(v) for v in pc_range[3:5]],
                          device=bboxes.device) - start
    a = (bboxes[..., :2].float() - start) / extent
    b = (gt_bboxes[..., :2].float() - start) / extent
    return weight * (a[..., :, None, :] - b[..., None, :, :]).abs().sum(-1)


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor       # (Q,) int64 matched GT slot, -1 none
    max_overlaps: torch.Tensor  # (Q,) IoU with the matched GT, 0 if none
    labels: torch.Tensor        # (Q,) matched GT label, -1 background


class HungarianAssigner3D:
    def __init__(self, cls_cost=None, reg_cost=None, iou_cost=None, **unused):
        self.cls_cost = dict(cls_cost or dict(weight=1.0))
        self.reg_cost = dict(reg_cost or dict(weight=1.0))
        self.iou_cost = dict(iou_cost or dict(weight=1.0))

    def cost(self, bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_mask: torch.Tensor,
             cls_pred: torch.Tensor, train_cfg: dict):
        """(cost (..., Q, G), iou (..., Q, G)): decoded predictions (...,
        Q, >=7), padded GTs (..., G, >=7), labels and validity (..., G),
        class logits (..., Q, num_classes), with the same leading (batch)
        dims; one K10 launch for all of them."""
        cc, rc = self.cls_cost, self.reg_cost
        cost = focal_loss_cost(cls_pred, gt_labels,
                               float(cc.get("weight", 1.0)),
                               float(cc.get("alpha", 0.25)),
                               float(cc.get("gamma", 2.0)))
        cost = cost + bbox_bev_l1_cost(bboxes, gt_bboxes,
                                       train_cfg["point_cloud_range"],
                                       float(rc.get("weight", 1.0)))
        iou = boxes_iou_3d(bboxes[..., :7], gt_bboxes[..., :7])
        cost = cost - iou * float(self.iou_cost.get("weight", 1.0))
        cost = torch.where(gt_mask[..., None, :].bool(), cost,
                           torch.full_like(cost, _BIG))
        return cost, iou

    @staticmethod
    def result(col: torch.Tensor, iou: torch.Tensor, gt_labels: torch.Tensor,
               gt_mask: torch.Tensor) -> AssignResult:
        """AssignResult from the (…, Q) matched columns (-1 = none) and
        the (…, Q, G) IoUs; matches to padded GTs become background."""
        col_c = col.clamp_min(0)
        matched = (col >= 0) & torch.gather(gt_mask.bool(), -1, col_c)
        labels = torch.gather(gt_labels.long(), -1, col_c)
        ious = torch.gather(iou, -1, col_c[..., None])[..., 0]
        minus = torch.full_like(col, -1)
        return AssignResult(
            gt_inds=torch.where(matched, col_c, minus),
            max_overlaps=torch.where(matched, ious,
                                     torch.zeros_like(ious)).clamp(0, 1),
            labels=torch.where(matched, labels, minus))

    def assign(self, bboxes, gt_bboxes, gt_labels, gt_mask, cls_pred,
               train_cfg) -> AssignResult:
        """One sample and decoder layer (the head batches its matching
        through ``cost`` + ``ops.hungarian.assign_batch`` + ``result``)."""
        cost, iou = self.cost(bboxes, gt_bboxes, gt_labels, gt_mask,
                              cls_pred, train_cfg)
        return self.result(assign_batch(cost), iou, gt_labels, gt_mask)
