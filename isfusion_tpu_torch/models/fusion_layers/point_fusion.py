"""PointFusion — MVX-Net's point-wise LiDAR-camera fusion (counterpart of
``isfusion_tpu/models/fusion_layers/point_fusion.py``; reference
``mmdet3d/models/fusion_layers/point_fusion.py``).

Per image level a lateral 3x3 conv (with bias, no norm, no activation)
over the (B, N, h, w, C) maps; each point is projected into every view
(``ops/projection.py``: the LiDAR augmentation undone, lidar2img, the image
augmentation) and sampled bilinearly (``align_corners=False``, zeros
outside) on every level; the samples are averaged over the views that see
the point and the levels concatenated. Then ``img_transform`` and
``pts_transform`` (Linear + BatchNorm1d, eps 1e-3, momentum 0.01, batch
statistics of the points in train mode) and their **sum**, ReLU when
``activate_out``, and the optional ``fuse_conv`` (Linear + BN + ReLU).

The sum is the reference layout, whose widths the MVX-Net config is
written for (``pts_channels`` = the VFE's last width, ``out_channels`` =
the SparseEncoder's input). The JAX package concatenates the two
transforms instead (ROADMAP queue 3). The lateral convs compute in
``compute_dtype``; sampling, the transforms and the sum in float32.
Reference names: ``lateral_convs.{i}.conv``, ``img_transform.{0,1}``,
``pts_transform.{0,1}``, ``fuse_conv.{0,1}``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.interpolate import grid_sample
from ...ops.projection import project_points_to_cameras
from ..layers import BatchNorm, ConvModule, Linear, dropout, resolve_dtype


class _LinearBN(nn.ModuleList):
    """Linear (``0``) + BatchNorm1d (``1``) over point rows, float32. The
    rows are the points in a voxel, so train-mode statistics are those of
    the JAX package's MaskedBatchNorm; the running variance takes the
    unbiased batch variance, as the reference's ``nn.BatchNorm1d``."""

    def __init__(self, cin, cout):
        super().__init__([Linear(cin, cout),
                          BatchNorm(cout, eps=1e-3, momentum=0.01)])

    def forward(self, x):
        return self[1](self[0](x.float()))


class PointFusion(nn.Module):
    def __init__(self, img_channels=256, pts_channels: int = 64,
                 mid_channels: int = 128, out_channels: int = 128,
                 img_levels=3, coord_type: str = "LIDAR", conv_cfg=None,
                 norm_cfg=None, act_cfg=None, activate_out: bool = True,
                 fuse_out: bool = False, dropout_ratio: float = 0.0,
                 aligned: bool = True, align_corners: bool = True,
                 padding_mode: str = "zeros", lateral_conv: bool = True,
                 compute_dtype=None, **unused):
        super().__init__()
        self.img_levels = [img_levels] if isinstance(img_levels, int) \
            else list(img_levels)
        if isinstance(img_channels, int):
            img_channels = [img_channels] * len(self.img_levels)
        if coord_type != "LIDAR" or align_corners or \
                padding_mode != "zeros" or not aligned or not lateral_conv:
            raise NotImplementedError(
                "the port's PointFusion samples LiDAR points bilinearly with "
                "align_corners=False and zeros padding, after lateral convs")
        self.activate_out, self.fuse_out = bool(activate_out), bool(fuse_out)
        self.dropout_ratio = float(dropout_ratio)
        dt = resolve_dtype(compute_dtype)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, mid_channels, 3, padding=1, norm_cfg=norm_cfg,
                       act_cfg=act_cfg, dtype=dt) for c in img_channels)
        self.img_transform = _LinearBN(mid_channels * len(img_channels),
                                       out_channels)
        self.pts_transform = _LinearBN(pts_channels, out_channels)
        if self.fuse_out:
            self.fuse_conv = _LinearBN(mid_channels, out_channels)

    def sample(self, img_feats: Sequence[torch.Tensor], xyz: torch.Tensor,
               batch_idx: torch.Tensor, calib: dict) -> torch.Tensor:
        """Image features at the points: (M, sum of the levels' widths),
        float32, each level the mean over the views that see the point."""
        feats = [conv(f.reshape((-1,) + tuple(f.shape[2:]))).reshape(
            f.shape[:4] + (-1,)) for conv, f in zip(
                self.lateral_convs, (img_feats[i] for i in self.img_levels))]
        h, w = (int(v) for v in calib["img_input_shape"])
        l2i = calib["lidar2img"]
        img_aug, lidar_aug = calib.get("img_aug_matrix"), \
            calib.get("lidar_aug_matrix")
        out = torch.zeros((xyz.shape[0], sum(f.shape[-1] for f in feats)),
                          dtype=torch.float32, device=xyz.device)
        for b in range(l2i.shape[0]):
            sel = torch.nonzero(batch_idx == b).squeeze(1)
            uv, _, front = project_points_to_cameras(
                xyz[sel], l2i[b], None if lidar_aug is None else lidar_aug[b],
                None if img_aug is None else img_aug[b])
            valid = front & (uv[..., 0] >= 0) & (uv[..., 0] < w) & \
                (uv[..., 1] >= 0) & (uv[..., 1] < h)             # (N, Pb)
            grid = torch.stack([uv[..., 0] / w * 2 - 1,
                                uv[..., 1] / h * 2 - 1], -1)
            cnt = valid.sum(0).clamp_min(1).float()[:, None]
            levels = []
            for f in feats:
                s = torch.stack([grid_sample(f[b, n], grid[n])
                                 for n in range(f.shape[1])]).float()
                s = torch.where(valid[..., None], s, 0.0)
                levels.append(s.sum(0) / cnt)
            out[sel] = torch.cat(levels, -1)
        return out

    def forward(self, img_feats: Sequence[torch.Tensor], xyz: torch.Tensor,
                batch_idx: torch.Tensor, pts_feats: torch.Tensor,
                calib: dict) -> torch.Tensor:
        """img_feats: per level (B, N, h, w, C); xyz (M, 3) points of any
        samples, batch_idx (M,) their sample; pts_feats (M, pts_channels);
        calib: lidar2img (B, N, 4, 4), optional img_aug_matrix (B, N, 4,
        4) and lidar_aug_matrix (B, 4, 4), img_input_shape (H, W).
        Returns (M, out_channels) float32."""
        img_pre = self.img_transform(self.sample(img_feats, xyz, batch_idx,
                                                 calib))
        if self.training and self.dropout_ratio > 0:
            img_pre = dropout(img_pre, self.dropout_ratio, True)
        out = img_pre + self.pts_transform(pts_feats)
        if self.activate_out:
            out = torch.relu(out)
        if self.fuse_out:
            out = torch.relu(self.fuse_conv(out))
        return out
