"""ImVoxelNet (counterpart of ``isfusion_tpu/models/detectors/
imvoxelnet.py``; reference ``mmdet3d/models/detectors/imvoxelnet.py``):
one camera image through the backbone (ResNet) and the neck (FPN); the
first FPN level lifted into a voxel volume by projecting every voxel
centre into the image and sampling it bilinearly (``lift``); the volume
collapsed to BEV by ``OutdoorImVoxelNeck``; ``Anchor3DHead`` detects in
the LiDAR frame.

The lift is plain PyTorch (``F.grid_sample``: bilinear, zeros outside,
``align_corners=False``, as ``ops/interpolate.py:grid_sample``; ROADMAP
queue 2 K6). A centre samples the map only when it lies in front of the
camera and strictly inside the image (``u / w * 2 - 1`` and ``v / h * 2 -
1`` in (-1, 1)); elsewhere its features are 0.

``forward(batch, mode='predict' | 'feats' | 'loss')``: the head's maps
('feats'), its loss dict ('loss') or its decoded boxes through K10-NMS
('predict'). Batch: img (B, H, W, 3), lidar2img (B, 4, 4) (or, without
it, cam2img (B, 4, 4) as the whole projection; ``KeyError`` with
neither); 'loss' gt_bboxes_3d (B, G, 7), gt_labels_3d (B, G), gt_mask
(B, G).

The volume is channels-first, (B, C, nz, ny, nx), for ``nn.Conv3d``;
the JAX package's is (B, nz, ny, nx, C).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import upload
from ...registry import DETECTORS
from ..builder import build_backbone, build_head, build_neck
from ..layers import BatchNorm3d, Conv3d, ConvModule, resolve_dtype
from ...ops.projection import project_points_to_cameras


class OutdoorImVoxelNeck(nn.Module):
    """Three 3x3x3 conv + BN + ReLU stages (widths C, 2C, 4C; z strides 1,
    2, 2; padding 1), the max over z, then a 3x3 ConvModule (BN, ReLU) to
    ``out_channels`` (the JAX package's ``OutdoorImVoxelNeck``; flax's
    BatchNorm defaults: eps 1e-5, momentum 0.01 in torch's convention).
    (B, C, nz, ny, nx) -> (B, ny, nx, out_channels) NHWC."""

    def __init__(self, in_channels: int = 64, out_channels: int = 256,
                 compute_dtype=None, **unused):
        super().__init__()
        dt = resolve_dtype(compute_dtype)
        c, cin = int(in_channels), int(in_channels)
        for i, (ch, sz) in enumerate(((c, 1), (c * 2, 2), (c * 4, 2))):
            self.add_module(f"conv{i}a", Conv3d(
                cin, ch, 3, stride=(sz, 1, 1), padding=1, bias=False,
                dtype=dt))
            self.add_module(f"bn{i}a", BatchNorm3d(ch, eps=1e-5,
                                                   momentum=0.01, dtype=dt))
            cin = ch
        self.out_conv = ConvModule(cin, int(out_channels), 3, padding=1,
                                   norm_cfg=dict(type="BN"),
                                   act_cfg=dict(type="relu"), dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # channels innermost in memory (the convs' NDHWC kernels, the
        # norms' channels-last ones); dim 1 stays the channel axis
        x = x.contiguous(memory_format=torch.channels_last_3d)
        for i in range(3):
            x = torch.relu(getattr(self, f"bn{i}a")(getattr(
                self, f"conv{i}a")(x)))
        x = x.amax(2).permute(0, 2, 3, 1)          # max over z, NHWC
        return self.out_conv(x)


def voxel_centers(n_voxels: Sequence[int], voxel_size: Sequence[float],
                  point_cloud_range: Sequence[float]) -> np.ndarray:
    """(nz, ny, nx, 3) float32 voxel centres (x, y, z) in the JAX
    package's arithmetic (float64, rounded once)."""
    nx, ny, nz = [int(v) for v in n_voxels]
    vs = np.asarray(voxel_size, np.float32)
    low = np.asarray(point_cloud_range[:3], np.float32)
    zi, yi, xi = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    return np.stack([(xi + 0.5) * vs[0] + low[0],
                     (yi + 0.5) * vs[1] + low[1],
                     (zi + 0.5) * vs[2] + low[2]], -1).astype(np.float32)


def lift(feat: torch.Tensor, proj: torch.Tensor, centers: torch.Tensor,
         img_hw: Sequence[int]) -> torch.Tensor:
    """feat (B, h, w, C) NHWC, proj (B, 4, 4) world -> image pixels,
    centers (nz, ny, nx, 3) -> volume (B, C, nz, ny, nx) float32: each
    centre's bilinear sample of its sample's map, 0 behind the camera or
    outside the image's open interior."""
    nz, ny, nx = centers.shape[:3]
    h, w = int(img_hw[0]), int(img_hw[1])
    uv, _, front = project_points_to_cameras(centers.reshape(-1, 3), proj)
    gx = uv[..., 0] / w * 2 - 1                              # (B, P)
    gy = uv[..., 1] / h * 2 - 1
    valid = front & (gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)
    grid = torch.stack([gx, gy], -1).reshape(gx.shape[0], nz, ny * nx, 2)
    s = F.grid_sample(feat.float().permute(0, 3, 1, 2), grid,
                      mode="bilinear", padding_mode="zeros",
                      align_corners=False)                   # (B, C, nz, P/nz)
    s = torch.where(valid.reshape(gx.shape[0], 1, nz, ny * nx), s, 0.0)
    return s.reshape(s.shape[0], s.shape[1], nz, ny, nx)


@DETECTORS.register_module()
class ImVoxelNet(nn.Module):
    def __init__(self, backbone, neck=None, neck_3d=None, bbox_head=None,
                 n_voxels: Sequence[int] = (216, 248, 12),
                 voxel_size: Sequence[float] = (0.32, 0.32, 0.33),
                 point_cloud_range: Sequence[float] = (
                     -34.56, -39.68, -3.08, 34.56, 39.68, 0.88),
                 train_cfg=None, test_cfg=None, **unused):
        super().__init__()
        self.backbone = build_backbone(backbone)
        self.neck = build_neck(neck) if neck else None
        self.neck_3d = OutdoorImVoxelNeck(**{
            k: v for k, v in dict(neck_3d or {}).items() if k != "type"})
        head = dict(bbox_head)
        self.bbox_head = build_head(head, train_cfg=train_cfg,
                                    test_cfg=test_cfg)
        self.register_buffer("centers", torch.from_numpy(voxel_centers(
            n_voxels, voxel_size, point_cloud_range)), persistent=False)

    def extract_feat(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 3) -> the first map of the neck (B, h, w, C)."""
        x = self.backbone(img)
        if self.neck is not None:
            x = self.neck(x)
        return x if torch.is_tensor(x) else x[0]

    @staticmethod
    def projection(t: dict) -> torch.Tensor:
        """lidar2img when the batch has it, else cam2img (the whole
        projection); ``KeyError`` with neither."""
        proj = t.get("lidar2img", t.get("cam2img"))
        if proj is None:
            raise KeyError("ImVoxelNet needs 'lidar2img' or 'cam2img'")
        return proj.float()

    def forward(self, batch: dict, mode: str = "predict", device=None,
                generator: Optional[torch.Generator] = None):
        """Runs on ``device`` (default: the CUDA card; raises if it is
        missing), where the parameters must already be. The detector draws
        no random numbers; ``generator`` is accepted for the train step's
        interface."""
        if mode not in ("predict", "feats", "loss"):
            raise ValueError(f"unknown mode {mode!r} (predict, feats or "
                             "loss)")
        if mode == "loss":
            return self._forward(batch, mode, device)
        with torch.no_grad():
            return self._forward(batch, mode, device)

    def _forward(self, batch, mode, device):
        t = upload(self, batch, device)
        img = t["img"].float()
        proj = self.projection(t)
        volume = lift(self.extract_feat(img), proj, self.centers,
                      img.shape[1:3])
        preds = self.bbox_head([self.neck_3d(volume)])
        if mode == "feats":
            return preds
        if mode == "loss":
            return self.bbox_head.loss(preds, t["gt_bboxes_3d"],
                                       t["gt_labels_3d"].long(),
                                       t["gt_mask"].bool())
        return self.bbox_head.get_bboxes(preds)
