"""3DSSD's head (counterpart of ``isfusion_tpu/models/dense_heads/
ssd_3d_head.py``; reference mmdet3d ``dense_heads/ssd_3d_head.py``).

The seeds (the backbone's last level: 3DSSD has no FP levels) are moved
by a learned shift (the candidate generation layer: a shared MLP and a
1x1 conv, 3 outputs a seed), a set-abstraction level over the shifted
candidates (K14-FPS, K14-ball, K14-gather; ``normalize_xyz`` fixed on, as
the JAX package fixes it) aggregates the seeds' features around them,
and a shared MLP plus one 1x1 conv predicts, a proposal: the centre
offset, the log size (exponentiated, clipped to [-4, 4] first), the
direction bins' logits and normalised residuals, the objectness logit and
the semantic logits (that column order).

The port follows the JAX package where it differs from the reference
(ROADMAP queue 3, settled): single scale, on ``PointNet2SASSG``; the
objectness target is a proposal within 2 m of its nearest GT centre (not
the reference's inside-the-box centreness); the losses are unweighted L1
(centre, size, direction residual) and cross entropy sums over the
positives; ``get_bboxes`` takes the top ``max_num`` of sigmoid objectness
times the softmax semantic score, with no NMS.

Layer names follow the reference where it has the module: ``vote_module.
vote_conv.{i}`` (the shift MLP: Conv1d + BN1d), ``vote_module.conv_out``
(the shift), ``vote_aggregation.mlps.0.layer{i}``, ``conv_pred.
shared_convs.layer{i}``; the one prediction conv keeps the JAX package's
column order under the port's own name ``conv_pred.conv_out`` (the
reference splits it otherwise).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox import coders  # noqa: F401  (registers the coders)
from ...models.losses import cross_entropy_loss
from ...registry import BBOX_CODERS, build_from_cfg
from ..backbones.pointnet2 import PointSAModule, SharedMLP
from ..middle_encoders.isfusion_encoder import topk_stable
from .vote_head import _gravity_centers, _sq_norm, _take


class CandidateShift(nn.Module):
    """The candidate generation layer: ``vote_conv`` (shared Conv1d + BN1d
    + ReLU over the valid seeds), ``conv_out`` (Conv1d with a bias, 3
    outputs): a seed's shift."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.vote_conv = SharedMLP(in_channels, channels, ndim=1, prefix="")
        c = int(channels[-1]) if channels else in_channels
        self.conv_out = nn.Conv1d(c, 3, 1)

    def forward(self, seed_feats, seed_mask):
        x = self.vote_conv(seed_feats, seed_mask)
        return F.linear(x, self.conv_out.weight[..., 0], self.conv_out.bias)


class JointPred(nn.Module):
    """``shared_convs.layer{i}`` (Conv1d + BN1d + ReLU over the valid
    proposals), then one Conv1d with a bias (``conv_out``) for every
    output."""

    def __init__(self, in_channels: int, shared: Sequence[int],
                 num_out: int):
        super().__init__()
        self.shared_convs = SharedMLP(in_channels, shared, ndim=1)
        c = int(shared[-1]) if shared else in_channels
        self.conv_out = nn.Conv1d(c, int(num_out), 1)

    def forward(self, x, mask):
        x = self.shared_convs(x, mask)
        return F.linear(x, self.conv_out.weight[..., 0], self.conv_out.bias)


class SSD3DHead(nn.Module):
    """``forward(feat_dict)`` (the backbone's dict: its last level's points
    are the seeds, ``in_channels`` wide) -> the predictions' dict; ``loss``
    the JAX package's terms; ``get_bboxes`` the top proposals."""

    def __init__(self, num_classes: int = 10, bbox_coder: dict = None,
                 in_channels: int = 256,
                 candidate_shift_channels: Sequence[int] = (128,),
                 feat_channels: Sequence[int] = (128, 128),
                 vote_aggregation_cfg: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, **unused):
        super().__init__()
        self.num_classes = int(num_classes)
        self.bbox_coder = build_from_cfg(dict(bbox_coder), BBOX_CODERS)
        self.test_cfg = dict(test_cfg or {})
        self.vote_module = CandidateShift(int(in_channels),
                                          list(candidate_shift_channels))
        agg = dict(vote_aggregation_cfg or dict(
            num_point=256, radius=4.8, num_sample=16,
            mlp_channels=[256, 256, 256, 512]))
        mlp = list(agg.get("mlp_channels", [256, 256, 256, 512]))
        self.vote_aggregation = PointSAModule(
            num_point=int(agg.get("num_point", 256)),
            radii=[float(agg.get("radius", 4.8))],
            sample_nums=[int(agg.get("num_sample", 16))],
            mlp_channels=mlp, in_channels=int(in_channels), use_xyz=True,
            normalize_xyz=True)
        nb = self.bbox_coder.num_dir_bins
        self.conv_pred = JointPred(int(mlp[-1]), list(feat_channels),
                                   3 + 3 + nb * 2 + self.num_classes + 1)

    def forward(self, feat_dict: dict) -> dict:
        seed_xyz = feat_dict["fp_xyz"][-1]
        seed_feats = feat_dict["fp_features"][-1]
        seed_mask = feat_dict["fp_masks"][-1]
        cand_xyz = seed_xyz + self.vote_module(seed_feats, seed_mask)
        agg_xyz, agg_feats, _, agg_mask = self.vote_aggregation(
            cand_xyz, seed_feats, seed_mask)
        out = self.conv_pred(agg_feats, agg_mask)
        nb = self.bbox_coder.num_dir_bins
        return dict(
            candidate_xyz=cand_xyz, seed_xyz=seed_xyz,
            aggregated_mask=agg_mask, center=agg_xyz + out[..., :3],
            size=torch.exp(out[..., 3:6].clamp(-4, 4)),
            dir_class=out[..., 6:6 + nb],
            dir_res=out[..., 6 + nb:6 + 2 * nb] * (math.pi / nb),
            obj_score=out[..., 6 + 2 * nb], sem_scores=out[..., 7 + 2 * nb:])

    # ------------------------------------------------------------- loss
    def loss(self, preds: dict, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_mask: torch.Tensor) -> dict:
        """gt_boxes (B, G, 7) bottom-centred, gt_labels (B, G), gt_mask
        (B, G) -> the JAX package's loss terms. A proposal is positive
        within 2 m of its nearest GT centre."""
        big = torch.full((), 1e10, device=gt_boxes.device)
        grav = _gravity_centers(gt_boxes)
        gt_mask = gt_mask.bool()
        center, amask = preds["center"], preds["aggregated_mask"]
        d2 = torch.where(gt_mask[:, None, :], _sq_norm(
            center[:, :, None] - grav[:, None]), big)
        assign = d2.argmin(-1)
        pos = (torch.sqrt(d2.amin(-1)) < 2.0) & amask
        w = amask.float()
        losses = dict(objectness_loss=(cross_entropy_loss(
            preds["obj_score"], pos.float(), reduction="none",
            use_sigmoid=True) * w).sum() / w.sum().clamp_min(1.0))
        pw = pos.float()
        np_ = pw.sum().clamp_min(1.0)

        def ce(logits, target):
            return cross_entropy_loss(logits, target, reduction="none")

        losses["center_loss"] = ((center - _take(grav, assign)).abs().sum(
            -1) * pw).sum() / np_
        losses["size_loss"] = ((preds["size"] - _take(
            gt_boxes[..., 3:6], assign)).abs().sum(-1) * pw).sum() / np_
        dir_cls_t, dir_res_t = self.bbox_coder.angle2class(
            _take(gt_boxes[..., 6], assign))
        losses["dir_class_loss"] = (ce(preds["dir_class"], dir_cls_t) *
                                    pw).sum() / np_
        dres = torch.gather(preds["dir_res"], -1, dir_cls_t[..., None])[
            ..., 0]
        losses["dir_res_loss"] = ((dres - dir_res_t).abs() * pw).sum() / np_
        losses["semantic_loss"] = (ce(preds["sem_scores"], _take(
            gt_labels.long(), assign)) * pw).sum() / np_
        return losses

    # -------------------------------------------------------- inference
    def get_bboxes(self, preds: dict, max_num: Optional[int] = None) -> dict:
        """The top ``max_num`` (``test_cfg['max_output_num']``, default
        128) proposals by sigmoid objectness times their best softmax
        semantic score: boxes (B, k, 7) bottom-centred, scores, labels,
        mask (score > 0)."""
        if max_num is None:
            max_num = int(self.test_cfg.get("max_output_num", 128))
        dir_cls = preds["dir_class"].argmax(-1)
        dres = torch.gather(preds["dir_res"], -1, dir_cls[..., None])[..., 0]
        yaw = self.bbox_coder.class2angle(dir_cls, dres)
        center, size = preds["center"], preds["size"]
        boxes = torch.cat([center[..., :2], center[..., 2:3] -
                           size[..., 2:3] / 2, size, yaw[..., None]], -1)
        scores = torch.sigmoid(preds["obj_score"])[..., None] * \
            torch.softmax(preds["sem_scores"], -1)
        best, labels = scores.amax(-1), scores.argmax(-1)
        k = min(int(max_num), best.shape[-1])
        ranked = torch.where(preds["aggregated_mask"], best,
                             torch.zeros((), device=best.device))
        top = topk_stable(ranked, k)
        topv = torch.gather(ranked, 1, top)
        return dict(bboxes=_take(boxes, top), scores=topv,
                    labels=torch.gather(labels, 1, top), mask=topv > 0)
