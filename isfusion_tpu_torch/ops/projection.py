"""LiDAR point -> camera pixel projection (counterpart of
``isfusion_tpu/ops/projection.py``): undo the LiDAR augmentation, project
with lidar2img, perspective-divide, apply the image augmentation."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def project_points_to_cameras(
        xyz: torch.Tensor, lidar2img: torch.Tensor,
        lidar_aug_matrix: Optional[torch.Tensor] = None,
        img_aug_matrix: Optional[torch.Tensor] = None,
        eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(P, 3) points, (N, 4, 4) lidar2img -> uv (N, P, 2) pixels in
    network-input space, depth (N, P), in_front (N, P) bool."""
    xyz = xyz.float()
    if lidar_aug_matrix is not None:
        inv = torch.linalg.inv(lidar_aug_matrix.float())
        xyz = xyz @ inv[:3, :3].T + inv[:3, 3]
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1)        # (P, 4)
    cam = torch.einsum("nij,pj->npi", lidar2img.float(), hom)      # (N, P, 4)
    depth = cam[..., 2]
    in_front = depth > eps
    uv = cam[..., :2] / depth.clamp_min(eps)[..., None]
    if img_aug_matrix is not None:
        uvh = torch.cat([uv, torch.ones_like(uv)], -1)
        uv = torch.einsum("nij,npj->npi", img_aug_matrix.float(),
                          uvh)[..., :2]
    return uv, depth, in_front
