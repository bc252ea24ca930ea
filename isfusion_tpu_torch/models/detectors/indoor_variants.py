"""The indoor point detectors' variants (counterpart of
``isfusion_tpu/models/detectors/indoor_variants.py``): SSD3DNet (3DSSD:
``SSD3DHead`` on a PointNet++ backbone without FP levels), GroupFree3DNet
(``GroupFree3DHead``'s transformer decoder over the backbone's seeds) and
ImVoteNet (VoteNet whose seed features are joined by image features
sampled where the seeds project). H3DNet is ``detectors/h3dnet.py``.

The batch is VoteNet's (``detectors/votenet.py``); ImVoteNet also reads
``img`` (B, H, W, 3) float32 and ``cam2img`` (B, 4, 4), the depth frame's
points to pixels. The port follows the JAX package where it differs from
the reference (ROADMAP queue 3, settled): SSD3DNet is single scale on
``PointNet2SASSG``; ImVoteNet uses only the texture cue (no 2D detections,
no geometric or semantic cue) and trains its image branch (nothing is
frozen; its BatchNorms keep ``norm_eval``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.interpolate import grid_sample
from ...ops.projection import project_points_to_cameras
from ...registry import DETECTORS
from ..builder import build_backbone
from ..layers import random_source
from .votenet import VoteNet


@DETECTORS.register_module()
class SSD3DNet(VoteNet):
    """Single-stage 3DSSD: the head config selects ``SSD3DHead``, whose
    input width is the backbone's output width."""

    def head_cfg(self, head: dict) -> dict:
        return dict(head, in_channels=self.backbone.out_channels)


@DETECTORS.register_module()
class GroupFree3DNet(VoteNet):
    """Group-Free 3D: a PointNet++ backbone and ``GroupFree3DHead`` (type
    set by default, input width the backbone's). Its decoder's dropout
    draws from the ``generator`` a train-mode forward is given. Predict
    returns ``test_cfg['max_output_num']`` boxes (default 64)."""

    def head_cfg(self, head: dict) -> dict:
        head = dict(head, in_channels=self.backbone.out_channels)
        head.setdefault("type", "GroupFree3DHead")
        return head

    def forward(self, batch: dict, mode: str = "predict", device=None,
                generator: Optional[torch.Generator] = None):
        """As ``VoteNet.forward``; ``generator`` is the source of the
        decoder's dropout in train mode (required there)."""
        with random_source(generator):
            return super().forward(batch, mode, device)

    def _forward(self, t: dict, mode: str):
        feat_dict = self.backbone(t["points"].float(),
                                  t["points_mask"].bool())
        preds = self.bbox_head(feat_dict)
        if mode == "feats":
            return preds
        if mode == "loss":
            return self.bbox_head.loss(preds, t["gt_bboxes_3d"].float(),
                                       t["gt_labels_3d"], t["gt_mask"])
        return self.bbox_head.get_bboxes(preds, max_num=int(
            self.test_cfg.get("max_output_num", 64)))


@DETECTORS.register_module()
class ImVoteNet(VoteNet):
    """VoteNet with a texture cue a seed: the image backbone's last map
    (``img_backbone``, the port's ResNet) sampled bilinearly where the seed
    (the last FP level's point) projects by ``cam2img``, zero for a seed
    behind the camera or off the image, projected by ``img_fuse`` (a
    Linear) to ``img_feat_dim`` channels and joined to the seed's
    features. The head's vote module takes the joined width."""

    def __init__(self, backbone: dict, bbox_head: dict,
                 img_backbone: Optional[dict] = None, img_feat_dim: int = 16,
                 **kwargs):
        super().__init__(backbone, bbox_head, **kwargs)
        self.img_backbone = None
        if img_backbone:
            self.img_backbone = build_backbone(img_backbone)
            self.img_fuse = nn.Linear(self.img_backbone.out_channels[-1],
                                      int(img_feat_dim))

    @staticmethod
    def seed_cues(fmap: torch.Tensor, seed_xyz: torch.Tensor,
                  cam2img: torch.Tensor, hw) -> torch.Tensor:
        """(B, h, w, C) maps, (B, S, 3) seeds, (B, 4, 4) -> (B, S, C): each
        seed's bilinear sample (zeros outside, ``align_corners=False``) at
        its projection mapped to [-1, 1] over the (H, W) image, 0 where it
        is behind the camera or off the image."""
        h, w = hw
        cues = []
        for b in range(seed_xyz.shape[0]):
            uv, _, front = project_points_to_cameras(seed_xyz[b],
                                                     cam2img[b][None])
            gx = uv[0, :, 0] / w * 2 - 1
            gy = uv[0, :, 1] / h * 2 - 1
            valid = front[0] & (gx.abs() < 1) & (gy.abs() < 1)
            s = grid_sample(fmap[b], torch.stack([gx, gy], -1))
            cues.append(torch.where(valid[:, None], s, torch.zeros(
                (), dtype=s.dtype, device=s.device)))
        return torch.stack(cues)

    def _forward(self, t: dict, mode: str):
        feat_dict = self.backbone(t["points"].float(),
                                  t["points_mask"].bool())
        if self.img_backbone is not None and "img" in t:
            img = t["img"].float()
            fmap = self.img_backbone(img)[-1]
            cues = self.seed_cues(fmap, feat_dict["fp_xyz"][-1],
                                  t["cam2img"].float(), img.shape[1:3])
            fused = torch.cat([feat_dict["fp_features"][-1],
                               self.img_fuse(cues.float())], -1)
            feat_dict = dict(feat_dict,
                             fp_features=feat_dict["fp_features"][:-1] +
                             [fused])
        preds = self.bbox_head(feat_dict)
        if mode == "feats":
            return preds
        if mode == "loss":
            return self.bbox_head.loss(preds, t["gt_bboxes_3d"].float(),
                                       t["gt_labels_3d"], t["gt_mask"])
        return self.bbox_head.get_bboxes(preds)
