"""ISFusionDetector (counterpart of
``isfusion_tpu/models/detectors/isfusion.py``, with the parts of
``mvx_two_stage.py`` it needs written inline): ``forward(batch,
mode='predict' | 'feats' | 'loss')``.

Camera branch (Swin + GeneralizedLSSFPN; dropped views zeroed) and LiDAR
branch (dynamic voxelization -> DynamicVFE -> SparseEncoder dense BEV) ->
pillarization (voxel x ``out_size_factor`` in xy, full z, <= T points) ->
ISFusionEncoder (interleaved with the SECONDV2 stages) -> SECONDFPN ->
TransFusionHeadV2.

Batch contract (numpy arrays or tensors): points (B, P, C), points_mask
(B, P), img (B, Nv, H, W, 3) NHWC, lidar2img (B, Nv, 4, 4), optional
img_aug_matrix (B, Nv, 4, 4), lidar_aug_matrix (B, 4, 4), img_view_mask
(B, Nv); for ``mode='loss'`` also gt_bboxes_3d (B, G, 9), gt_labels_3d
(B, G), gt_mask (B, G). There are no capacity caps: every in-range point
is voxelized.

``model.train()`` / ``model.eval()`` select BatchNorm's and dropout's
behaviour; the predict and feats modes run under ``torch.no_grad()``.
Every random draw of a forward comes from its ``generator``. With
``detach=True`` (the flagship) the image backbone runs under
``torch.no_grad()``; dropped views (``img_view_mask``) are zeroed before
the backbone, their backbone features are severed from the backward (the
JAX package records a 1e27 blow-up through zero-variance LayerNorms
without it), and their FPN features are zeroed.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import upload
from ...ops.voxel import voxelize_dynamic, voxelize_hard
from ..layers import random_source
from ...registry import DETECTORS
from ..builder import (build_backbone, build_fusion_layer, build_head,
                       build_middle_encoder, build_neck, build_voxel_encoder)


@DETECTORS.register_module()
class ISFusionDetector(nn.Module):
    def __init__(self, img_backbone, img_neck, pts_voxel_layer,
                 pts_voxel_encoder, pts_middle_encoder, fusion_encoder,
                 pts_backbone, pts_neck, pts_bbox_head, pc_range, voxel_size,
                 out_size_factor=8, detach=False, train_cfg=None,
                 test_cfg=None, **unused):
        super().__init__()
        self.detach = bool(detach)
        self.pts_voxel_layer = dict(pts_voxel_layer)
        self.pc_range = [float(v) for v in pc_range]
        self.voxel_size = [float(v) for v in voxel_size]
        self.out_size_factor = int(out_size_factor)
        self.img_backbone = build_backbone(img_backbone)
        self.img_neck = build_neck(img_neck)
        self.pts_voxel_encoder = build_voxel_encoder(pts_voxel_encoder)
        self.pts_middle_encoder = build_middle_encoder(pts_middle_encoder)
        enc = self.pts_middle_encoder
        self.fusion_encoder = build_fusion_layer(
            fusion_encoder, img_channels=int(dict(img_neck)["out_channels"]),
            lidar_channels=enc.output_channels * enc.out_depth,
            lidar_depth=enc.out_depth)
        self.n_pillar_pts = int(dict(fusion_encoder).get(
            "num_points_in_pillar", 12))
        self.pts_backbone = build_backbone(pts_backbone)
        self.pts_neck = build_neck(pts_neck)
        tc, sc = dict(train_cfg or {}), dict(test_cfg or {})
        self.pts_bbox_head = build_head(pts_bbox_head,
                                        train_cfg=tc.get("pts", tc) or None,
                                        test_cfg=sc.get("pts", sc) or None)

    def _pillar_size(self):
        vs, pcr = self.voxel_size, self.pc_range
        return (vs[0] * self.out_size_factor, vs[1] * self.out_size_factor,
                pcr[5] - pcr[2])

    def extract_img_feat(self, img: torch.Tensor,
                         view_mask: Optional[torch.Tensor]):
        """(B, Nv, H, W, 3) -> list of (B, Nv, h, w, C) FPN maps."""
        if view_mask is not None:
            img = torch.where(view_mask[:, :, None, None, None], img, 0.0)
        b, n = img.shape[:2]
        flat = img.reshape((b * n,) + tuple(img.shape[2:]))
        if self.detach:
            with torch.no_grad():
                feats = self.img_backbone(flat)
        else:
            feats = self.img_backbone(flat)
            if view_mask is not None:
                vm = view_mask.reshape(-1)[:, None, None, None]
                feats = [torch.where(vm, f, f.detach()) for f in feats]
        feats = self.img_neck(feats)
        feats = [f.reshape((b, n) + tuple(f.shape[1:])) for f in feats]
        if view_mask is not None:
            feats = [torch.where(view_mask[:, :, None, None, None], f, 0.0)
                     for f in feats]
        return feats

    def forward(self, batch: dict, mode: str = "predict", device=None,
                stats: Optional[dict] = None,
                generator: Optional[torch.Generator] = None):
        """``mode``: 'predict' (boxes), 'feats' ((head preds, instance
        heatmap)) or 'loss' (the head's loss dict). Runs on ``device``
        (default: the CUDA card; raises if it is missing), where the
        model's parameters must already be. ``stats`` (a dict, optional)
        receives the voxel, pillar and active-site counts of the run;
        ``generator`` (on that device) feeds dropout, drop path and the
        pixel jitter of a train-mode forward."""
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
        img = t["img"].float()
        img_feats = self.extract_img_feat(img, t.get("img_view_mask"))
        calib = dict(lidar2img=t["lidar2img"].float(),
                     img_input_shape=tuple(img.shape[2:4]))
        for k in ("img_aug_matrix", "lidar_aug_matrix"):
            if k in t:
                calib[k] = t[k].float()

        points, points_mask = t["points"].float(), t["points_mask"].bool()
        b = points.shape[0]
        vl = self.pts_voxel_layer
        dv = voxelize_dynamic(points, points_mask, vl["point_cloud_range"],
                              vl["voxel_size"])
        feats = self.pts_voxel_encoder(points.reshape(-1, points.shape[-1]),
                                       dv.point_voxel_index, dv.voxel_coors)
        enc_stats = {} if stats is not None else None
        lidar_bev = self.pts_middle_encoder(feats, dv.voxel_coors, b,
                                            return_stats=enc_stats)
        pil = voxelize_hard(points, points_mask, self.pc_range,
                            self._pillar_size(), self.n_pillar_pts)
        feats_list, ins_heatmap = self.fusion_encoder(
            img_feats, lidar_bev, pil.voxels, pil.coors, pil.num_points,
            calib, self.pts_backbone)
        preds = self.pts_bbox_head(self.pts_neck(feats_list))
        if stats is not None:
            stats.update(voxels=int(dv.voxel_coors.shape[0]),
                         pillars=int(pil.coors.shape[0]), **enc_stats)
        if mode == "feats":
            return preds, ins_heatmap
        if mode == "loss":
            return self.pts_bbox_head.loss(
                preds, t["gt_bboxes_3d"], t["gt_labels_3d"].long(),
                t["gt_mask"].bool(), ins_heatmap=ins_heatmap)
        return self.pts_bbox_head.get_bboxes(preds)
