"""Anchor3DHead (counterpart of
``isfusion_tpu/models/dense_heads/anchor3d_head.py``): 1x1 class, box and
direction convs over the BEV map; MaxIoUAssigner targets over nearest-BEV
IoU and the focal / smooth-L1 / direction losses (``loss``); decode, yaw
snap and per-class rotated NMS (``get_bboxes``).

The outputs keep the JAX layout: an NHWC (B, H, W, A * C) map flattened
to (B, H * W * A, C), anchors ordered (H, W, size, rotation) as
``core/anchor.py`` builds them. The convs run in the config's
``compute_dtype``; assignment, losses, decode and NMS in float32. Top-k
selections run on float32 scores with a stable order (equal scores keep
the lower index first, as ``jax.lax.top_k``). The per-class NMS of a
request is one launch of the K10-NMS kernel (``ops/box_ops.py``).
With ``assigner_per_size`` (MVX-Net's KITTI head) or ``assign_per_class``
(SSN's) the anchors of size i are matched only to the GTs of class i, as
the reference's per-size and per-class assignment does; the JAX package
declares both flags but matches every anchor to every GT (ROADMAP queue
3). The size of each anchor comes from ``anchor_size_index``, which
follows the anchors' own layout (ShapeAwareHead's per-task anchors
override it).
Reference names: ``conv_cls``, ``conv_reg``, ``conv_dir_cls``.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchor import build_anchor_generator
from ...core.bbox.coders import DeltaXYZWLHRBBoxCoder
from ...ops.box_ops import limit_period, nms_bev_mask
from ..layers import Conv2d, resolve_dtype
from ..losses import build_loss
from ..middle_encoders.isfusion_encoder import topk_stable


def nearest_bev_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7+) LiDAR boxes -> axis-aligned (..., 4) BEV (x1, y1, x2, y2),
    extents swapped where |yaw mod pi| > pi / 4."""
    bev = boxes[..., [0, 1, 3, 4, 6]].float()
    rot = limit_period(bev[..., 4], 0.5, math.pi).abs()
    xywh = torch.where((rot > math.pi / 4)[..., None], bev[..., [0, 1, 3, 2]],
                       bev[..., :4])
    c, d = xywh[..., :2], xywh[..., 2:]
    return torch.cat([c - d / 2, c + d / 2], -1)


def bbox_overlaps_nearest_3d(boxes1: torch.Tensor, boxes2: torch.Tensor
                             ) -> torch.Tensor:
    """(N, K) axis-aligned nearest-BEV IoU (BboxOverlapsNearest3D)."""
    b1, b2 = nearest_bev_boxes(boxes1), nearest_bev_boxes(boxes2)
    area1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    area2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None] - inter).clamp_min(1e-8)


def max_iou_assign(ious: torch.Tensor, gt_mask: torch.Tensor,
                   pos_iou_thr: float, neg_iou_thr: float,
                   min_pos_iou: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """MaxIoUAssigner over (A, G) IoUs and (G,) valid GTs: (assigned (A,)
    with -1 negative, -2 ignored, >= 0 the matched GT; max IoU (A,)). Each
    valid GT's best anchors (IoU >= min_pos_iou) are force-assigned, an
    anchor best for several GTs taking the one of highest IoU."""
    ious = torch.where(gt_mask[None, :], ious, torch.full_like(ious, -1.0))
    max_iou = ious.max(1).values
    argmax_gt = torch.argmax(ious, 1)
    assigned = torch.full(max_iou.shape, -1, dtype=torch.long,
                          device=ious.device)
    assigned = torch.where((max_iou >= neg_iou_thr) & (max_iou < pos_iou_thr),
                           torch.full_like(assigned, -2), assigned)
    assigned = torch.where(max_iou >= pos_iou_thr, argmax_gt, assigned)
    gt_best = ious.max(0).values
    is_best = (ious == gt_best[None, :]) & gt_mask[None, :] & \
        (ious >= min_pos_iou)
    best_gt = torch.argmax(torch.where(is_best, ious,
                                       torch.full_like(ious, -1.0)), 1)
    return torch.where(is_best.any(1), best_gt, assigned), max_iou


def add_sin_difference(r_pred: torch.Tensor, r_tgt: torch.Tensor):
    """diff_rad_by_sin: regress sin(a - b) through the product identity."""
    return torch.sin(r_pred) * torch.cos(r_tgt), \
        torch.cos(r_pred) * torch.sin(r_tgt)


def get_direction_target(anchors_rot: torch.Tensor,
                         reg_target_rot: torch.Tensor,
                         dir_offset: float = 0.7854) -> torch.Tensor:
    offset_rot = limit_period(reg_target_rot + anchors_rot - dir_offset, 0,
                              2 * math.pi)
    return torch.floor(offset_rot / math.pi).long().clamp(0, 1)


class Anchor3DHead(nn.Module):
    def __init__(self, num_classes: int = 1, in_channels: int = 384,
                 feat_channels: int = 384,
                 use_direction_classifier: bool = True,
                 anchor_generator=None, diff_rad_by_sin: bool = True,
                 dir_offset: float = 0.7854, dir_limit_offset: float = 0.0,
                 bbox_coder=None, loss_cls=None, loss_bbox=None,
                 loss_dir=None, train_cfg=None, test_cfg=None,
                 assigner_per_size: bool = False,
                 assign_per_class: bool = False, compute_dtype=None,
                 **unused):
        super().__init__()
        self.num_classes = int(num_classes)
        self.assigner_per_size = bool(assigner_per_size)
        self.assign_per_class = bool(assign_per_class)
        self.use_direction_classifier = bool(use_direction_classifier)
        self.diff_rad_by_sin = bool(diff_rad_by_sin)
        self.dir_offset = float(dir_offset)
        self.dir_limit_offset = float(dir_limit_offset)
        self.anchor_generator = build_anchor_generator(
            anchor_generator or dict(
                type="Anchor3DRangeGenerator",
                ranges=[[0, -39.68, -1.78, 69.12, 39.68, -1.78]]))
        self.box_code_size = int(dict(bbox_coder or {}).get("code_size", 7))
        self.bbox_coder = DeltaXYZWLHRBBoxCoder(self.box_code_size)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.loss_cls = build_loss(loss_cls or dict(type="FocalLoss",
                                                    use_sigmoid=True))
        self.loss_bbox = build_loss(loss_bbox or dict(type="SmoothL1Loss",
                                                      beta=1.0 / 9.0))
        self.loss_dir = build_loss(loss_dir or dict(
            type="CrossEntropyLoss"))
        dt = resolve_dtype(compute_dtype)
        na = self.anchor_generator.num_base_anchors
        self.conv_cls = Conv2d(in_channels, na * self.num_classes, 1,
                               dtype=dt)
        self.conv_reg = Conv2d(in_channels, na * self.box_code_size, 1,
                               dtype=dt)
        self.conv_dir_cls = Conv2d(in_channels, na * 2, 1, dtype=dt) \
            if self.use_direction_classifier else None
        self._anchors = {}

    def reset_special_parameters(self):
        # focal-loss prior: p = 0.01
        nn.init.constant_(self.conv_cls.bias, -4.595)

    def forward(self, feats) -> List[tuple]:
        """feats: an NHWC map or a list of them -> per level (cls (B, H, W,
        A * C), reg (B, H, W, A * code), dir (B, H, W, A * 2) or None)."""
        if torch.is_tensor(feats):
            feats = [feats]
        return [(self.conv_cls(f), self.conv_reg(f),
                 self.conv_dir_cls(f) if self.conv_dir_cls is not None
                 else None) for f in feats]

    def anchors_for(self, featmap_sizes: Sequence[Tuple[int, int]]
                    ) -> np.ndarray:
        levels = self.anchor_generator.grid_anchors(
            [tuple(int(v) for v in fs) for fs in featmap_sizes])
        return np.concatenate([lv.reshape(-1, lv.shape[-1]) for lv in levels])

    def _flat(self, preds):
        """(anchors (N, code), cls (B, N, C), reg (B, N, code), dir (B, N,
        2) or None, each anchor's size index (N,)), float32."""
        sizes = tuple(tuple(p[0].shape[1:3]) for p in preds)
        dev = preds[0][0].device
        key = (sizes, str(dev))
        if key not in self._anchors:
            self._anchors[key] = (
                torch.from_numpy(self.anchors_for(sizes)).to(dev),
                torch.from_numpy(self.anchor_size_index(sizes)).to(dev))
        b = preds[0][0].shape[0]

        def cat(i, width):
            return torch.cat([p[i].reshape(b, -1, width) for p in preds],
                             1).float()

        dirs = cat(2, 2) if self.use_direction_classifier else None
        anchors, size_index = self._anchors[key]
        return (anchors, cat(0, self.num_classes),
                cat(1, self.box_code_size), dirs, size_index)

    def anchor_size_index(self, featmap_sizes: Sequence[Tuple[int, int]]
                          ) -> np.ndarray:
        """(N,) int64: the generator's size index of each anchor of
        ``anchors_for(featmap_sizes)`` (H, W, size, rotation per level)."""
        gen = self.anchor_generator
        r, s = len(gen.rotations), len(gen.sizes)
        return np.concatenate([np.arange(int(h) * int(w) * s * r) // r % s
                               for h, w in featmap_sizes])

    def assign(self, anchors: torch.Tensor, gts: torch.Tensor,
               labels: torch.Tensor, gmask: torch.Tensor,
               size_index: torch.Tensor) -> torch.Tensor:
        """MaxIoUAssigner over nearest-BEV IoUs: (A,) -1 negative, -2
        ignored, >= 0 the matched GT; per size with ``assigner_per_size``
        or ``assign_per_class`` (an anchor of size i, ``size_index`` (A,),
        sees only the GTs labelled i)."""
        cfg = dict(self.train_cfg.get("assigner", dict(
            pos_iou_thr=0.6, neg_iou_thr=0.45, min_pos_iou=0.45)))
        ious = bbox_overlaps_nearest_3d(anchors, gts)
        if self.assigner_per_size or self.assign_per_class:
            same = size_index[:, None] == labels.long()[None, :]
            ious = torch.where(same, ious, torch.full_like(ious, -1.0))
        assigned, _ = max_iou_assign(
            ious, gmask, float(cfg.get("pos_iou_thr", 0.6)),
            float(cfg.get("neg_iou_thr", 0.45)),
            float(cfg.get("min_pos_iou", 0.45)))
        return assigned

    def loss(self, preds, gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
             gt_mask: torch.Tensor) -> dict:
        """Per-sample focal, smooth-L1 (sin difference of yaw, code
        weights) and direction losses over the sample's positives, averaged
        over the batch: dict(loss_cls, loss_bbox[, loss_dir])."""
        anchors, cls_scores, bbox_preds, dir_preds, size_index = \
            self._flat(preds)
        code = self.box_code_size
        code_weight = torch.tensor(
            [float(v) for v in self.train_cfg.get("code_weight",
                                                  [1.0] * code)],
            device=anchors.device)
        per_sample = []
        for i in range(cls_scores.shape[0]):
            gts, gmask = gt_bboxes[i].float(), gt_mask[i].bool()
            assigned = self.assign(anchors, gts, gt_labels[i], gmask,
                                   size_index)
            pos, neg = assigned >= 0, assigned == -1
            safe = assigned.clamp_min(0)
            num_pos = pos.float().sum().clamp_min(1.0)
            cls_tgt = torch.where(
                pos[:, None], F.one_hot(gt_labels[i].long()[safe],
                                        self.num_classes).float(), 0.0)
            out = dict(loss_cls=self.loss_cls(
                cls_scores[i], cls_tgt, weight=(pos | neg).float()[:, None],
                avg_factor=num_pos))
            reg_tgt = self.bbox_coder.encode(anchors, gts[safe])
            bp, rt = bbox_preds[i], reg_tgt
            if self.diff_rad_by_sin:
                sp, st = add_sin_difference(bp[:, 6], rt[:, 6])
                bp = torch.cat([bp[:, :6], sp[:, None], bp[:, 7:]], -1)
                rt = torch.cat([rt[:, :6], st[:, None], rt[:, 7:]], -1)
            out["loss_bbox"] = self.loss_bbox(
                bp, rt, weight=pos.float()[:, None] * code_weight[None],
                avg_factor=num_pos)
            if dir_preds is not None:
                dir_tgt = get_direction_target(anchors[:, 6], reg_tgt[:, 6],
                                               self.dir_offset)
                out["loss_dir"] = self.loss_dir(
                    dir_preds[i], dir_tgt, weight=pos.float(),
                    avg_factor=num_pos)
            per_sample.append(out)
        return {k: torch.stack([o[k] for o in per_sample]).mean()
                for k in per_sample[0]}

    def get_bboxes(self, preds) -> dict:
        """Top-``nms_pre`` boxes by their best class score, decoded, yaw
        snapped to the predicted direction bin, per-class rotated NMS over
        the boxes scoring above ``score_thr``, then the top ``max_num`` of
        the class-major concatenation: dict(bboxes (B, max_num, code),
        scores, labels, mask = kept & score > 0)."""
        tc = self.test_cfg
        nms_pre = int(tc.get("nms_pre", 1000))
        score_thr = float(tc.get("score_thr", 0.05))
        nms_thr = float(tc.get("nms_thr", 0.2))
        max_num = int(tc.get("max_num", 500))
        anchors, cls_scores, bbox_preds, dir_preds, _ = self._flat(preds)
        b, n, nc = cls_scores.shape
        scores = torch.sigmoid(cls_scores)
        topi = topk_stable(scores.amax(-1), min(nms_pre, n))      # (B, k)
        k = topi.shape[1]
        scores_k = torch.gather(scores, 1, topi[..., None].expand(-1, -1, nc))
        boxes_k = self.bbox_coder.decode(
            anchors[topi], torch.gather(bbox_preds, 1, topi[..., None].expand(
                -1, -1, bbox_preds.shape[-1])))
        if dir_preds is not None:
            dir_lbl = torch.argmax(torch.gather(
                dir_preds, 1, topi[..., None].expand(-1, -1, 2)), -1)
            r = limit_period(boxes_k[..., 6] - self.dir_offset,
                             self.dir_limit_offset, math.pi)
            yaw = r + self.dir_offset + math.pi * dir_lbl.float()
            boxes_k = torch.cat([boxes_k[..., :6], yaw[..., None],
                                 boxes_k[..., 7:]], -1)
        per_class = scores_k.transpose(1, 2)                      # (B, C, k)
        keep = nms_bev_mask(boxes_k[..., [0, 1, 3, 4, 6]], per_class,
                            nms_thr, per_class > score_thr)
        scores_all = torch.where(keep, per_class, 0.0).reshape(b, nc * k)
        fi = topk_stable(scores_all, max_num)
        fv = torch.gather(scores_all, 1, fi)
        return dict(
            bboxes=torch.gather(boxes_k, 1, (fi % k)[..., None].expand(
                -1, -1, boxes_k.shape[-1])),
            scores=fv, labels=fi // k,
            mask=torch.gather(keep.reshape(b, nc * k), 1, fi) & (fv > 0))
