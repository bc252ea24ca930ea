"""MVXTwoStageDetector / MVXFasterRCNN / DynamicMVXFasterRCNN
(counterpart of ``isfusion_tpu/models/detectors/mvx_two_stage.py``).

``forward(batch, mode='predict' | 'feats' | 'loss')``:

- the image branch (when the config has ``img_backbone``): ``img`` (B, N,
  H, W, 3) through the backbone (ResNet) and neck (FPN) to per-level (B,
  N, h, w, C) maps, and the calibration of the batch (``lidar2img``,
  optional ``img_aug_matrix`` / ``lidar_aug_matrix``, the image's (H, W));
- the LiDAR branch: hard voxelization with the config's per-sample
  ``max_voxels`` cap (train cap in train mode, test cap in eval mode, as
  the JAX ``_capacity``) -> the voxel encoder (HardVFE; HardSimpleVFE for
  CenterPoint) — the PointPillars and CenterPoint configs; or, with
  ``max_num_points <= 0`` (MVX-Net), dynamic voxelization (K1, no cap, as
  the reference's ``DynamicVoxelization``; the JAX package caps at
  ``max_voxels``, ROADMAP queue 3) -> DynamicVFE with its PointFusion over
  the image maps; then the middle encoder (PointPillarsScatter;
  SparseEncoder) -> SECOND -> SECONDFPN -> the head (Anchor3DHead;
  CenterHead).

A detector-level ``pts_fusion_layer`` raises, as in the JAX package:
point-wise fusion lives inside the voxel encoder.

Batch contract (numpy arrays or tensors): points (B, P, C), points_mask
(B, P); with an image branch img (B, N, H, W, 3) and lidar2img (B, N, 4,
4); for ``mode='loss'`` also gt_bboxes_3d (B, G, 7 or 9), gt_labels_3d
(B, G), gt_mask (B, G).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import upload
from ...ops.voxel import voxelize_dynamic, voxelize_hard
from ...registry import DETECTORS
from ..builder import (build_backbone, build_head, build_middle_encoder,
                       build_neck, build_voxel_encoder)
from ..layers import random_source
from ..middle_encoders.sparse_encoder import SparseEncoder


def capacity(max_voxels, train: bool) -> int:
    """The voxel cap of a ``max_voxels`` entry: an int, or (train, test)."""
    if isinstance(max_voxels, (tuple, list)):
        return int(max_voxels[0] if train else max_voxels[1])
    return int(max_voxels)


@DETECTORS.register_module()
class MVXTwoStageDetector(nn.Module):
    def __init__(self, pts_voxel_layer=None, pts_voxel_encoder=None,
                 pts_middle_encoder=None, pts_fusion_layer=None,
                 img_backbone=None, pts_backbone=None, img_neck=None,
                 pts_neck=None, pts_bbox_head=None, train_cfg=None,
                 test_cfg=None, **unused):
        super().__init__()
        if pts_fusion_layer:
            raise ValueError(
                "pts_fusion_layer is not wired at the detector level; "
                "configure pts_voxel_encoder.fusion_layer (DynamicVFE "
                "PointFusion) instead")
        self.pts_voxel_layer = dict(pts_voxel_layer)
        self.img_backbone = build_backbone(img_backbone) \
            if img_backbone else None
        self.img_neck = build_neck(img_neck) if img_neck else None
        self.pts_voxel_encoder = build_voxel_encoder(pts_voxel_encoder)
        self.pts_middle_encoder = build_middle_encoder(pts_middle_encoder)
        self.pts_backbone = build_backbone(pts_backbone)
        self.pts_neck = build_neck(pts_neck) if pts_neck else None
        tc, sc = dict(train_cfg or {}), dict(test_cfg or {})
        self.pts_bbox_head = build_head(pts_bbox_head,
                                        train_cfg=tc.get("pts", tc) or None,
                                        test_cfg=sc.get("pts", sc) or None)

    def forward(self, batch: dict, mode: str = "predict", device=None,
                stats: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
        """``mode``: 'predict' (boxes), 'feats' (head outputs) or 'loss'
        (the head's loss dict). Runs on ``device`` (default: the CUDA card;
        raises if it is missing), where the parameters must already be.
        ``stats`` (a dict, optional) receives the voxels per sample and the
        cap (and a SparseEncoder's active sites per stage). The branch
        draws no random numbers; ``generator`` is accepted for the train
        step's interface."""
        if mode not in ("predict", "feats", "loss"):
            raise ValueError(f"unknown mode {mode!r} (predict, feats or "
                             "loss)")
        with random_source(generator):
            if mode == "loss":
                return self._forward(batch, mode, device, stats)
            with torch.no_grad():
                return self._forward(batch, mode, device, stats)

    def extract_img_feat(self, img: torch.Tensor):
        """img (B, N, H, W, 3) -> per level (B, N, h, w, C)."""
        b, n = img.shape[:2]
        feats = self.img_backbone(img.reshape((b * n,) + tuple(img.shape[2:])))
        if self.img_neck is not None:
            feats = self.img_neck(feats)
        if torch.is_tensor(feats):
            feats = [feats]
        return [f.reshape((b, n) + tuple(f.shape[1:])) for f in feats]

    @staticmethod
    def calib_from_batch(t: dict) -> Optional[dict]:
        if "lidar2img" not in t or "img" not in t:
            return None
        calib = dict(lidar2img=t["lidar2img"].float(),
                     img_input_shape=tuple(t["img"].shape[2:4]))
        for k in ("img_aug_matrix", "lidar_aug_matrix"):
            if k in t:
                calib[k] = t[k].float()
        return calib

    def _forward(self, batch, mode, device, stats):
        t = upload(self, batch, device)
        img_feats = self.extract_img_feat(t["img"].float()) \
            if self.img_backbone is not None and "img" in t else None
        x = lidar_features(
            t, self.pts_voxel_layer, self.training, self.pts_voxel_encoder,
            self.pts_middle_encoder, self.pts_backbone, self.pts_neck,
            img_feats, self.calib_from_batch(t), stats)
        return head_outputs(self.pts_bbox_head, x, t, mode)


def lidar_features(t: dict, voxel_layer: dict, training: bool,
                   voxel_encoder, middle_encoder, backbone, neck,
                   img_feats=None, calib=None, stats: Optional[dict] = None):
    """The LiDAR branch of a batch of tensors ``t``: voxelization (hard
    with the train or test cap, or dynamic with ``max_num_points <= 0``)
    -> the voxel encoder -> the middle encoder -> the BEV backbone -> the
    neck. ``stats`` (optional) receives the voxels per sample, the cap
    and a SparseEncoder's active sites per stage."""
    points, points_mask = t["points"].float(), t["points_mask"].bool()
    b = points.shape[0]
    vl = voxel_layer
    if int(vl.get("max_num_points", 32)) <= 0:
        cap = capacity(vl.get("max_voxels", 60000), training)
        dv = voxelize_dynamic(points, points_mask, vl["point_cloud_range"],
                              vl["voxel_size"])
        coors = dv.voxel_coors
        feats = voxel_encoder(
            points.reshape(-1, points.shape[-1]), dv.point_voxel_index,
            coors, img_feats=img_feats, calib=calib,
            layout=(dv.voxel_ptr, dv.point_order))
    else:
        cap = capacity(vl.get("max_voxels", 30000), training)
        vox = voxelize_hard(points, points_mask, vl["point_cloud_range"],
                            vl["voxel_size"], int(vl["max_num_points"]), cap)
        coors = vox.coors
        feats = voxel_encoder(vox.voxels, vox.num_points, coors)
    kw = dict(return_stats=stats) if stats is not None and isinstance(
        middle_encoder, SparseEncoder) else {}
    x = backbone(middle_encoder(feats, coors, b, **kw))
    if neck is not None:
        x = neck(x)
    if stats is not None:
        # a dynamic branch reports the config's cap without applying it
        stats.update(voxels=torch.bincount(
            coors[:, 0].long(), minlength=b).tolist(), cap=cap)
    return x


def head_outputs(head, x, t: dict, mode: str):
    """The head's maps ('feats'), its loss dict ('loss') or its boxes."""
    preds = head(x)
    if mode == "feats":
        return preds
    if mode == "loss":
        return head.loss(preds, t["gt_bboxes_3d"], t["gt_labels_3d"].long(),
                         t["gt_mask"].bool())
    return head.get_bboxes(preds)


@DETECTORS.register_module()
class MVXFasterRCNN(MVXTwoStageDetector):
    """The PointPillars nuScenes detector (LiDAR-only branch)."""


@DETECTORS.register_module()
class DynamicMVXFasterRCNN(MVXTwoStageDetector):
    """MVX-Net: dynamic voxelization with point-wise image fusion in the
    voxel encoder (``max_num_points <= 0``)."""
