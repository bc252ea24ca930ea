"""MVXTwoStageDetector / MVXFasterRCNN (counterpart of
``isfusion_tpu/models/detectors/mvx_two_stage.py``): the LiDAR
hard-voxelization branch that the PointPillars nuScenes configs run.

``forward(batch, mode='predict' | 'feats' | 'loss')``: hard voxelization
with the config's per-sample ``max_voxels`` cap (train cap in train mode,
test cap in eval mode, as the JAX ``_capacity``) -> the voxel encoder
(HardVFE; HardSimpleVFE for CenterPoint) -> the middle encoder
(PointPillarsScatter; SparseEncoder for CenterPoint) -> SECOND ->
SECONDFPN -> the head (Anchor3DHead; CenterHead).

Batch contract (numpy arrays or tensors): points (B, P, C), points_mask
(B, P); for ``mode='loss'`` also gt_bboxes_3d (B, G, 9), gt_labels_3d
(B, G), gt_mask (B, G). The image branch, the dynamic-voxelization branch
and ``DynamicMVXFasterRCNN`` are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import upload
from ...ops.voxel import voxelize_hard
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
        if img_backbone or img_neck or pts_fusion_layer:
            raise NotImplementedError("the port's MVX detectors run the "
                                      "LiDAR branch only")
        self.pts_voxel_layer = dict(pts_voxel_layer)
        if int(self.pts_voxel_layer.get("max_num_points", 32)) <= 0:
            raise NotImplementedError("the port's MVX detectors run hard "
                                      "voxelization only")
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

    def _forward(self, batch, mode, device, stats):
        t = upload(self, batch, device)
        points, points_mask = t["points"].float(), t["points_mask"].bool()
        b = points.shape[0]
        vl = self.pts_voxel_layer
        cap = capacity(vl.get("max_voxels", 30000), self.training)
        vox = voxelize_hard(points, points_mask, vl["point_cloud_range"],
                            vl["voxel_size"], int(vl["max_num_points"]), cap)
        feats = self.pts_voxel_encoder(vox.voxels, vox.num_points, vox.coors)
        kw = dict(return_stats=stats) if stats is not None and isinstance(
            self.pts_middle_encoder, SparseEncoder) else {}
        x = self.pts_backbone(self.pts_middle_encoder(feats, vox.coors, b,
                                                      **kw))
        if self.pts_neck is not None:
            x = self.pts_neck(x)
        preds = self.pts_bbox_head(x)
        if stats is not None:
            stats.update(voxels=torch.bincount(
                vox.coors[:, 0].long(), minlength=b).tolist(), cap=cap)
        if mode == "feats":
            return preds
        if mode == "loss":
            return self.pts_bbox_head.loss(
                preds, t["gt_bboxes_3d"], t["gt_labels_3d"].long(),
                t["gt_mask"].bool())
        return self.pts_bbox_head.get_bboxes(preds)


@DETECTORS.register_module()
class MVXFasterRCNN(MVXTwoStageDetector):
    """The PointPillars nuScenes detector (LiDAR-only branch)."""


@DETECTORS.register_module()
class DynamicMVXFasterRCNN(MVXTwoStageDetector):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("DynamicMVXFasterRCNN is not ported yet")
