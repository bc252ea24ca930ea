"""VoxelNet and DynamicVoxelNet (counterpart of
``isfusion_tpu/models/detectors/voxelnet.py``; reference
``mmdet3d/models/detectors/voxelnet.py``, ``dynamic_voxelnet.py``):
single-modality LiDAR detectors with the reference's top-level names
(``voxel_layer``, ``voxel_encoder``, ``middle_encoder``, ``backbone``,
``neck``, ``bbox_head``) over the MVX LiDAR branch
(``mvx_two_stage.lidar_features``): hard voxelization with the train or
test cap -> HardVFE / PillarFeatureNet / HardSimpleVFE, or dynamic
voxelization (K1, no cap, as the reference; the JAX package caps at
``max_voxels``) -> DynamicVFE / DynamicSimpleVFE /
DynamicPillarFeatureNet (K2) -> SparseEncoder (K12) or PointPillarsScatter
-> SECOND -> SECONDFPN -> Anchor3DHead (K10-NMS) or CenterHead.

``forward(batch, mode='predict' | 'feats' | 'loss')`` as
``MVXTwoStageDetector``; batch: points (B, P, C), points_mask (B, P); for
'loss' gt_bboxes_3d (B, G, 7 or 9), gt_labels_3d (B, G), gt_mask (B, G).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import upload
from ...registry import DETECTORS
from ..builder import (build_backbone, build_head, build_middle_encoder,
                       build_neck, build_voxel_encoder)
from .mvx_two_stage import head_outputs, lidar_features


@DETECTORS.register_module()
class VoxelNet(nn.Module):
    def __init__(self, voxel_layer, voxel_encoder, middle_encoder, backbone,
                 neck=None, bbox_head=None, train_cfg=None, test_cfg=None,
                 **unused):
        super().__init__()
        self.voxel_layer = dict(voxel_layer)
        self.voxel_encoder = build_voxel_encoder(voxel_encoder)
        self.middle_encoder = build_middle_encoder(middle_encoder)
        self.backbone = build_backbone(backbone)
        self.neck = build_neck(neck) if neck else None
        tc, sc = dict(train_cfg or {}), dict(test_cfg or {})
        self.bbox_head = build_head(bbox_head,
                                    train_cfg=tc.get("pts", tc) or None,
                                    test_cfg=sc.get("pts", sc) or None)

    def forward(self, batch: dict, mode: str = "predict", device=None,
                stats: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
        """As ``MVXTwoStageDetector.forward``: runs on ``device`` (default:
        the CUDA card; raises if it is missing); ``stats`` receives the
        voxels per sample, the cap and a SparseEncoder's active sites;
        ``generator`` is accepted for the train step's interface."""
        if mode not in ("predict", "feats", "loss"):
            raise ValueError(f"unknown mode {mode!r} (predict, feats or "
                             "loss)")
        if mode == "loss":
            return self._forward(batch, mode, device, stats)
        with torch.no_grad():
            return self._forward(batch, mode, device, stats)

    def _forward(self, batch, mode, device, stats):
        t = upload(self, batch, device)
        x = lidar_features(t, self.voxel_layer, self.training,
                           self.voxel_encoder, self.middle_encoder,
                           self.backbone, self.neck, stats=stats)
        return head_outputs(self.bbox_head, x, t, mode)


@DETECTORS.register_module()
class DynamicVoxelNet(VoxelNet):
    """VoxelNet on dynamic voxels (``voxel_layer.max_num_points <= 0``,
    as the JAX package selects it by the config)."""
