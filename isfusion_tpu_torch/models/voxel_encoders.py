"""Voxel feature encoders (counterpart of
``isfusion_tpu/models/voxel_encoders.py``): DynamicVFE (and its
DynamicPillarFeatureNet and DynamicFusionVFE forms), DynamicSimpleVFE,
and HardVFE / PillarFeatureNet / HardSimpleVFE over hard-voxelized (V, T,
C) buffers.

Per-point features [point, xyz - voxel mean, xyz - voxel centre] go
through Linear+BN+ReLU layers; after each layer the per-voxel max is
taken, and concatenated back onto the points for the next layer.
DynamicVFE works on the valid points only (dynamic shapes); its voxel
means and maxima go through K2 (``ops/scatter.py``). With a
``fusion_layer`` (MVX-Net's PointFusion) the last layer's point features
are fused with the image features before the last voxel max, the
reference layout (the JAX package fuses after the first layer; ROADMAP
queue 3). The hard
encoders keep the JAX package's padded buffers, masked BatchNorm
(statistics of the valid point slots) and zeroed padded slots. Float32
throughout: the JAX package runs its VFE without a compute dtype.
Reference names: ``vfe_layers.{i}.{linear,norm}``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.scatter import segment_max, segment_mean
from .layers import LinearNormAct


def voxel_center_xyz(coors_zyx: torch.Tensor, voxel_size,
                     point_cloud_range) -> torch.Tensor:
    """Metric centre of voxels given integer (..., 3) (z, y, x) coords."""
    vs = [float(v) for v in voxel_size]
    low = [float(v) for v in point_cloud_range[:3]]
    c = coors_zyx.float()
    return torch.stack([(c[..., 2] + 0.5) * vs[0] + low[0],
                        (c[..., 1] + 0.5) * vs[1] + low[1],
                        (c[..., 0] + 0.5) * vs[2] + low[2]], -1)


class DynamicVFE(nn.Module):
    def __init__(self, in_channels: int = 4,
                 feat_channels: Sequence[int] = (64, 64),
                 with_distance: bool = False,
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True,
                 voxel_size=(0.2, 0.2, 4), point_cloud_range=(0, -40, -3,
                                                              70.4, 40, 1),
                 norm_cfg=None, fusion_layer=None, **unused):
        super().__init__()
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.voxel_size = list(voxel_size)
        self.point_cloud_range = list(point_cloud_range)
        if fusion_layer:
            from .builder import build_fusion_layer
            self.fusion_layer = build_fusion_layer(fusion_layer)
        else:
            self.fusion_layer = None
        norm_cfg = dict(norm_cfg or dict(type="BN1d", eps=1e-3))
        cin = in_channels + 3 * with_cluster_center + \
            3 * with_voxel_center + int(with_distance)
        layers = []
        for i, c in enumerate(feat_channels):
            layers.append(LinearNormAct(cin, c, norm_cfg))
            cin = 2 * c
        self.vfe_layers = nn.ModuleList(layers)

    def forward(self, points: torch.Tensor, point_voxel_index: torch.Tensor,
                voxel_coors: torch.Tensor, img_feats=None,
                calib: Optional[dict] = None,
                layout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """points (B*P, C); point_voxel_index (B*P,) voxel row or -1;
        voxel_coors (Nv, 4) (b, z, y, x); with a fusion layer, img_feats
        (per level (B, N, h, w, C)) and calib (``PointFusion.forward``);
        layout: each voxel's points (``DynamicVoxels.voxel_ptr``,
        ``point_order``), handed to every voxel mean and max (K2 on the
        card; the CPU ignores it).
        Returns (Nv, width) voxel features: width feat_channels[-1], or the
        fusion layer's out_channels."""
        nv = voxel_coors.shape[0]
        sel = point_voxel_index >= 0
        pts = points[sel].float()
        vid = point_voxel_index[sel]
        feats = [pts]
        xyz = pts[:, :3]
        if self.with_cluster_center:
            feats.append(xyz - segment_mean(xyz, vid, nv, layout)[vid])
        if self.with_voxel_center:
            centers = voxel_center_xyz(voxel_coors[:, 1:], self.voxel_size,
                                       self.point_cloud_range)
            feats.append(xyz - centers[vid])
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        x = torch.cat(feats, -1)
        voxel_feats = None
        last = len(self.vfe_layers) - 1
        for i, layer in enumerate(self.vfe_layers):
            x = layer(x)
            if i == last and self.fusion_layer is not None and \
                    img_feats is not None:
                x = self.fusion_layer(img_feats, xyz, voxel_coors[vid, 0],
                                      x, calib)
            voxel_feats = segment_max(x, vid, nv, layout)
            if i < last:
                x = torch.cat([x, voxel_feats[vid]], -1)
        return voxel_feats


class DynamicPillarFeatureNet(DynamicVFE):
    """The JAX package's dynamic PillarFeatureNet: DynamicVFE with one
    layer (``feat_channels=(64,)``) by default."""

    def __init__(self, in_channels: int = 4, feat_channels=(64,), **kw):
        super().__init__(in_channels, feat_channels, **kw)


class DynamicFusionVFE(DynamicVFE):
    """DynamicVFE with a PointFusion ``fusion_layer``; fuses after the last
    layer and adds, as DynamicVFE does (the reference; ROADMAP queue 3)."""


class DynamicSimpleVFE(nn.Module):
    """The mean of each dynamic voxel's points over their first
    ``num_features`` channels (K2's mean on the card); no parameters."""

    def __init__(self, num_features: int = 4, **unused):
        super().__init__()
        self.num_features = int(num_features)

    def forward(self, points: torch.Tensor, point_voxel_index: torch.Tensor,
                voxel_coors: torch.Tensor, img_feats=None, calib=None,
                layout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """points (B*P, C); point_voxel_index (B*P,) voxel row or -1;
        voxel_coors (Nv, 4); layout as DynamicVFE's -> (Nv,
        num_features)."""
        sel = point_voxel_index >= 0
        return segment_mean(points[sel, :self.num_features].float(),
                            point_voxel_index[sel], voxel_coors.shape[0],
                            layout)


class HardVFE(nn.Module):
    """VFE over (V, T, C) voxel buffers with per-layer max-pool and concat
    (the JAX package's ``_PooledVFE``: HardVFE, and PillarFeatureNet with
    ``center_xy_only``)."""

    center_xy_only = False

    def __init__(self, in_channels: int = 4,
                 feat_channels: Sequence[int] = (64, 64),
                 with_distance: bool = False,
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True,
                 voxel_size=(0.2, 0.2, 4), point_cloud_range=(0, -40, -3,
                                                              70.4, 40, 1),
                 norm_cfg=None, **unused):
        super().__init__()
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.voxel_size = list(voxel_size)
        self.point_cloud_range = list(point_cloud_range)
        norm_cfg = dict(norm_cfg or dict(type="BN1d", eps=1e-3,
                                         momentum=0.01))
        cin = in_channels + 3 * with_cluster_center + int(with_distance) + \
            (2 if self.center_xy_only else 3) * with_voxel_center
        layers = []
        for c in feat_channels:
            layers.append(LinearNormAct(cin, c, norm_cfg, masked=True))
            cin = 2 * c
        self.vfe_layers = nn.ModuleList(layers)

    def forward(self, features: torch.Tensor, num_points: torch.Tensor,
                coors: torch.Tensor) -> torch.Tensor:
        """features (V, T, C) zero-padded points; num_points (V,); coors
        (V, 3 or 4) ending in (z, y, x) -> (V, feat_channels[-1])."""
        features = features.float()
        t = features.shape[-2]
        mask = torch.arange(t, device=features.device) < num_points[:, None]
        xyz = features[..., :3]
        feats = [features]
        if self.with_cluster_center:
            mean = xyz.sum(-2, keepdim=True) / \
                num_points.clamp_min(1)[:, None, None].float()
            feats.append(xyz - mean)
        if self.with_voxel_center:
            nd = 2 if self.center_xy_only else 3
            center = voxel_center_xyz(coors[:, -3:], self.voxel_size,
                                      self.point_cloud_range)
            feats.append(features[..., :nd] - center[:, None, :nd])
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        zero = torch.zeros((), device=features.device)
        x = torch.where(mask[..., None], torch.cat(feats, -1), zero)
        pooled = None
        for i, layer in enumerate(self.vfe_layers):
            x = layer(x, mask)
            pooled = torch.where(mask[..., None], x,
                                 torch.full((), float("-inf"),
                                            device=x.device)).amax(-2)
            pooled = torch.where(torch.isfinite(pooled), pooled, zero)
            if i < len(self.vfe_layers) - 1:
                x = torch.cat([x, pooled[:, None].expand_as(x)], -1)
        return pooled


class PillarFeatureNet(HardVFE):
    """PointPillars pillar encoder: pillar x/y centre offsets (2 channels)
    + cluster offsets (3)."""

    center_xy_only = True

    def __init__(self, in_channels: int = 4, feat_channels=(64,), **kw):
        super().__init__(in_channels, feat_channels, **kw)


class HardSimpleVFE(nn.Module):
    """The mean of each voxel's points over their first ``num_features``
    channels (CenterPoint's voxel encoder); no parameters."""

    def __init__(self, num_features: int = 4, **unused):
        super().__init__()
        self.num_features = int(num_features)

    def forward(self, features: torch.Tensor, num_points: torch.Tensor,
                coors: torch.Tensor) -> torch.Tensor:
        """features (V, T, C) zero-padded points; num_points (V,) ->
        (V, num_features)."""
        total = features[..., :self.num_features].float().sum(-2)
        return total / num_points.clamp_min(1)[:, None].float()
