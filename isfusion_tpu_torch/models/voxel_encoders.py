"""DynamicVFE (counterpart of ``isfusion_tpu/models/voxel_encoders.py:DynamicVFE``).

Per-point features [point, xyz - voxel mean, xyz - voxel centre] go
through Linear+BN+ReLU layers; after each layer the per-voxel max is
taken, and concatenated back onto the points for the next layer. Works on
the valid points only (dynamic shapes). Float32 throughout: the JAX
package runs its VFE without a compute dtype. Reference names:
``vfe_layers.{i}.{linear,norm}``.
"""
from __future__ import annotations

from typing import Sequence

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
                 norm_cfg=None, **unused):
        super().__init__()
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.voxel_size = list(voxel_size)
        self.point_cloud_range = list(point_cloud_range)
        norm_cfg = dict(norm_cfg or dict(type="BN1d", eps=1e-3))
        cin = in_channels + 3 * with_cluster_center + \
            3 * with_voxel_center + int(with_distance)
        layers = []
        for i, c in enumerate(feat_channels):
            layers.append(LinearNormAct(cin, c, norm_cfg))
            cin = 2 * c
        self.vfe_layers = nn.ModuleList(layers)

    def forward(self, points: torch.Tensor, point_voxel_index: torch.Tensor,
                voxel_coors: torch.Tensor) -> torch.Tensor:
        """points (B*P, C); point_voxel_index (B*P,) voxel row or -1;
        voxel_coors (Nv, 4) (b, z, y, x). Returns (Nv, feat_channels[-1])."""
        nv = voxel_coors.shape[0]
        sel = point_voxel_index >= 0
        pts = points[sel].float()
        vid = point_voxel_index[sel]
        feats = [pts]
        xyz = pts[:, :3]
        if self.with_cluster_center:
            feats.append(xyz - segment_mean(xyz, vid, nv)[vid])
        if self.with_voxel_center:
            centers = voxel_center_xyz(voxel_coors[:, 1:], self.voxel_size,
                                       self.point_cloud_range)
            feats.append(xyz - centers[vid])
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        x = torch.cat(feats, -1)
        voxel_feats = None
        for i, layer in enumerate(self.vfe_layers):
            x = layer(x)
            voxel_feats = segment_max(x, vid, nv)
            if i < len(self.vfe_layers) - 1:
                x = torch.cat([x, voxel_feats[vid]], -1)
        return voxel_feats
