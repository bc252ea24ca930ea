"""PartA2, the two-stage LiDAR detector (counterpart of
``isfusion_tpu/models/detectors/parta2.py:PartA2``; reference
``mmdet3d/models/detectors/parta2.py``).

The path: hard voxelization with the train or test cap -> HardSimpleVFE
-> SparseUNet (``spatial_features`` and per-voxel ``seg_features``) ->
SECOND -> SECONDFPN -> the RPN ``Anchor3DHead``. Its proposals are its
``get_bboxes`` (K10-NMS) on detached predictions, of which the top
``num_proposals`` by score are taken (a stable descending sort: the
masked scores are 0 and tie, and the lower index goes first, as
``jax.lax.top_k``); a proposal counts when the NMS kept it and its score
is above 0. ``seg_head`` (Linear to 1) and ``part_head`` (Linear to 3,
sigmoid) read the seg features; the RoI head (``PartAggregationROIHead``,
K16) pools [seg features, sigmoid(seg logit), part] inside each proposal.

``forward(batch, mode='predict' | 'feats' | 'loss')`` as VoxelNet's; batch:
points (B, P, C), points_mask (B, P); for 'loss' gt_bboxes_3d (B, G, 7+),
gt_labels_3d (B, G), gt_mask (B, G). 'loss' gives the RPN's terms (prefixed
``rpn_``), the RoI head's and the part terms: ``loss_seg`` (sigmoid CE of
the seg logit against "inside a valid GT", over every voxel) and
``loss_part`` (L1 of the part prediction against the voxel's normalised
position in the first GT that holds it, ``ops/box_ops.py:box_local_uvw``,
over those voxels). 'predict' gives the RoI head's decoded boxes with the
proposals' labels. JAX uses one proposal config (the RPN's ``test_cfg``)
in training and testing; so does the port (ROADMAP queue 3).

Names: ``voxel_encoder.``, ``middle_encoder.``, ``backbone.``, ``neck.``,
``rpn_head.`` as the reference's; ``roi_head.`` and ``seg_head``,
``part_head`` hold the JAX module's layers.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import upload
from ...ops.box_ops import box_local_uvw
from ...ops.voxel import voxelize_hard
from ...registry import DETECTORS
from ..builder import (build_backbone, build_head, build_middle_encoder,
                       build_neck, build_voxel_encoder)
from ..layers import Linear
from ..losses import build_loss
from ..middle_encoders.isfusion_encoder import topk_stable
from .mvx_two_stage import capacity


def voxel_centers(coors: torch.Tensor, voxel_layer: dict) -> torch.Tensor:
    """(N, 3) float32 (x, y, z) centres of (N, 4) (b, z, y, x) voxels."""
    vs = [float(v) for v in voxel_layer["voxel_size"]]
    low = [float(v) for v in voxel_layer["point_cloud_range"][:3]]
    c = coors.float()
    return torch.stack([(c[:, 3 - d] + 0.5) * vs[d] + low[d]
                        for d in range(3)], -1)


def pad_by_sample(batch_idx: torch.Tensor, batch_size: int, *rows):
    """Rows of a voxel table sorted by sample -> each as (B, V_max, ...)
    zero-padded, and the (B, V_max) validity mask."""
    counts = torch.bincount(batch_idx.long(), minlength=batch_size)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(batch_idx.shape[0], device=batch_idx.device) - \
        first[batch_idx.long()]
    width = int(counts.max()) if batch_idx.numel() else 0
    idx = (batch_idx.long(), pos)
    out = [r.new_zeros((batch_size, width) + tuple(r.shape[1:])).index_put(
        idx, r) for r in rows]
    mask = torch.zeros((batch_size, width), dtype=torch.bool,
                       device=batch_idx.device).index_put(
                           idx, torch.ones_like(pos, dtype=torch.bool))
    return out + [mask]


def select_proposals(det: dict, num_proposals: int):
    """The top ``num_proposals`` of the RPN's decoded boxes by score (a
    stable descending sort: equal scores, such as the masked zeros, keep
    the lower index first, as ``jax.lax.top_k``) -> (indices (B, k), rois
    (B, k, 7+), roi_mask (B, k): kept by the NMS and scoring above 0)."""
    k = min(int(num_proposals), det["bboxes"].shape[1])
    topi = topk_stable(det["scores"], k)
    topv = torch.gather(det["scores"], 1, topi)
    rois = torch.gather(det["bboxes"], 1, topi[..., None].expand(
        -1, -1, det["bboxes"].shape[-1]))
    return topi, rois, torch.gather(det["mask"], 1, topi) & (topv > 0)


@DETECTORS.register_module()
class PartA2(nn.Module):
    def __init__(self, voxel_layer, voxel_encoder, middle_encoder, backbone,
                 neck=None, rpn_head=None, roi_head=None,
                 num_proposals: int = 128, train_cfg=None, test_cfg=None,
                 **unused):
        super().__init__()
        self.voxel_layer = dict(voxel_layer)
        self.voxel_encoder = build_voxel_encoder(voxel_encoder)
        self.middle_encoder = build_middle_encoder(middle_encoder)
        self.backbone = build_backbone(backbone)
        self.neck = build_neck(neck) if neck else None
        tc, sc = dict(train_cfg or {}), dict(test_cfg or {})
        self.rpn_head = build_head(rpn_head,
                                   train_cfg=tc.get("rpn", tc) or None,
                                   test_cfg=sc.get("rpn", sc) or None)
        # the RoI head pools [seg features, seg score, part]: its width
        # follows the SparseUNet (the JAX head infers it; its
        # ``in_channels`` is read and overridden)
        seg = self.middle_encoder.seg_channels
        self.roi_head = build_head(dict(roi_head or dict(
            type="PartAggregationROIHead"), in_channels=seg + 4))
        self.num_proposals = int(num_proposals)
        self.seg_head = Linear(seg, 1)
        self.part_head = Linear(seg, 3)
        self.loss_seg = build_loss(dict(type="CrossEntropyLoss",
                                        use_sigmoid=True, reduction="none"))

    def forward(self, batch: dict, mode: str = "predict", device=None,
                stats: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
        """Runs on ``device`` (default: the CUDA card; raises if it is
        missing); ``stats`` receives the voxels per sample, the cap, the
        SparseUNet's active sites and the proposals per sample;
        ``generator`` is accepted for the train step's interface (nothing
        is drawn)."""
        if mode not in ("predict", "feats", "loss"):
            raise ValueError(f"unknown mode {mode!r} (predict, feats or "
                             "loss)")
        if mode == "loss":
            return self._forward(batch, mode, device, stats)
        with torch.no_grad():
            return self._forward(batch, mode, device, stats)

    def _forward(self, batch, mode, device, stats):
        t = upload(self, batch, device)
        points, points_mask = t["points"].float(), t["points_mask"].bool()
        b = points.shape[0]
        vl = self.voxel_layer
        cap = capacity(vl.get("max_voxels", 16000), self.training)
        vox = voxelize_hard(points, points_mask, vl["point_cloud_range"],
                            vl["voxel_size"], int(vl.get("max_num_points", 5)),
                            cap)
        feats = self.voxel_encoder(vox.voxels, vox.num_points, vox.coors)
        unet = self.middle_encoder(feats, vox.coors, b, return_stats=stats)
        x = self.backbone(unet["spatial_features"])
        if self.neck is not None:
            x = self.neck(x)
        rpn_preds = self.rpn_head(x)
        seg = unet["seg_features"].float()
        seg_logit = self.seg_head(seg)[:, 0]
        part_pred = torch.sigmoid(self.part_head(seg))
        centers = voxel_centers(vox.coors, vl)

        with torch.no_grad():
            det = self.rpn_head.get_bboxes([
                tuple(None if p is None else p.detach() for p in level)
                for level in rpn_preds])
        topi, rois, roi_mask = select_proposals(det, self.num_proposals)
        roi_feats = torch.cat([seg, torch.sigmoid(seg_logit)[:, None],
                               part_pred], -1)
        roi_preds = self.roi_head(rois[..., :7], roi_mask, *pad_by_sample(
            vox.coors[:, 0], b, centers, roi_feats))
        if stats is not None:
            stats.update(voxels=torch.bincount(
                vox.coors[:, 0].long(), minlength=b).tolist(), cap=cap,
                proposals=roi_mask.sum(1).tolist())
        if mode == "feats":
            return dict(rpn=rpn_preds, roi=roi_preds, seg=seg_logit,
                        part=part_pred)
        if mode == "loss":
            # the box's 7 columns: a loader's bundle pads GT rows to 9
            gts = t["gt_bboxes_3d"].float()[..., :7]
            labels = t["gt_labels_3d"].long()
            gmask = t["gt_mask"].bool()
            losses = {f"rpn_{key}": v for key, v in self.rpn_head.loss(
                rpn_preds, gts, labels, gmask).items()}
            losses.update(self.roi_head.loss(roi_preds, gts, labels, gmask))
            losses.update(self._part_losses(seg_logit, part_pred, centers,
                                            vox.coors[:, 0].long(), gts,
                                            gmask))
            return losses
        out = self.roi_head.get_bboxes(roi_preds)
        out["labels"] = torch.gather(det["labels"], 1, topi)
        return out

    def _part_losses(self, seg_logit, part_pred, centers, batch_idx,
                     gt_bboxes, gt_mask) -> dict:
        """Stage-1 supervision of every voxel: foreground = inside a valid
        GT; the part target is its normalised position in the first such
        GT."""
        uvw_all, inside = box_local_uvw(gt_bboxes[batch_idx, :, :7],
                                        centers[:, None, :])
        uvw_all, inside = uvw_all[:, 0], inside[:, 0] & gt_mask[batch_idx]
        fg = inside.any(-1)
        first = torch.argmax(inside.to(torch.uint8), -1)
        uvw = uvw_all[torch.arange(first.shape[0], device=first.device),
                      first]
        loss_seg = self.loss_seg(seg_logit, fg.float()).sum() / \
            max(seg_logit.shape[0], 1)
        pw = fg.float()[:, None]
        loss_part = ((part_pred - uvw).abs() * pw).sum() / \
            pw.sum().clamp_min(1.0)
        return dict(loss_seg=loss_seg, loss_part=loss_part)
