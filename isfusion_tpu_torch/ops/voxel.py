"""Voxelization (counterpart of ``isfusion_tpu/ops/voxel.py``).

Dynamic shapes. Without a ``max_voxels`` cap (the reference's
``max_voxels=-1`` semantics) every in-range valid point lands in a voxel;
``voxelize_hard`` takes the JAX package's per-sample cap. Voxel tables are
ordered by batch, then by the z-major linear id — the order of the JAX
voxelizers' dense relabelling — and carry (b, z, y, x) int32 coordinates.
Plain PyTorch for now (ROADMAP queue K1/K5 for hand-written kernels).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


def compute_voxel_coords(points: torch.Tensor,
                         point_cloud_range: Sequence[float],
                         voxel_size: Sequence[float]
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Tuple[int, int, int]]:
    """Per-point (z, y, x) int32 voxel coords, in-range mask, grid (nx, ny, nz).

    floor((xyz - low) * inv) in float32, with ``inv`` = 1/voxel_size
    rounded once from float64 to float32 — the JAX package's arithmetic, so
    points on voxel boundaries land in the same voxel."""
    pcr = tuple(float(v) for v in point_cloud_range)
    vs = tuple(float(v) for v in voxel_size)
    nx = int(round((pcr[3] - pcr[0]) / vs[0]))
    ny = int(round((pcr[4] - pcr[1]) / vs[1]))
    nz = int(round((pcr[5] - pcr[2]) / vs[2]))
    xyz = points[..., :3].float()
    low = torch.tensor(pcr[:3], dtype=torch.float32, device=points.device)
    inv = torch.tensor([1.0 / vs[0], 1.0 / vs[1], 1.0 / vs[2]],
                       dtype=torch.float32, device=points.device)
    cxyz = torch.floor((xyz - low) * inv).to(torch.int32)
    grid = torch.tensor([nx, ny, nz], dtype=torch.int32, device=points.device)
    in_range = ((cxyz >= 0) & (cxyz < grid)).all(-1)
    coors = torch.stack([cxyz[..., 2], cxyz[..., 1], cxyz[..., 0]], -1)
    return coors, in_range, (nx, ny, nz)


def _keys(coors: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
    """(B, P, 3) zyx -> (B, P) int64 batch-major linear ids."""
    nx, ny, nz = grid
    b = coors.shape[0]
    lin = (coors[..., 0].long() * ny + coors[..., 1].long()) * nx + \
        coors[..., 2].long()
    off = torch.arange(b, device=coors.device).view(b, 1) * (nz * ny * nx)
    return lin + off


def _decode_keys(keys: torch.Tensor, grid: Tuple[int, int, int]
                 ) -> torch.Tensor:
    """int64 batch-major linear ids -> (N, 4) int32 (b, z, y, x)."""
    nx, ny, nz = grid
    x = keys % nx
    r = keys // nx
    y = r % ny
    r = r // ny
    z = r % nz
    b = r // nz
    return torch.stack([b, z, y, x], -1).to(torch.int32)


class DynamicVoxels(NamedTuple):
    point_voxel_index: torch.Tensor  # (B*P,) int64 voxel row per point, -1 = none
    voxel_coors: torch.Tensor        # (Nv, 4) int32 (b, z, y, x), sorted


def voxelize_dynamic(points: torch.Tensor, points_mask: torch.Tensor,
                     point_cloud_range, voxel_size) -> DynamicVoxels:
    """points (B, P, C), points_mask (B, P) -> per-point voxel rows and the
    sorted unique voxel table (``dynamic_voxelize`` semantics)."""
    coors, in_range, grid = compute_voxel_coords(points, point_cloud_range,
                                                 voxel_size)
    valid = (points_mask.bool() & in_range).reshape(-1)
    keys = _keys(coors, grid).reshape(-1)
    uniq, inv = torch.unique(keys[valid], sorted=True, return_inverse=True)
    pvi = torch.full_like(keys, -1)
    pvi[valid] = inv
    return DynamicVoxels(pvi, _decode_keys(uniq, grid))


class HardVoxels(NamedTuple):
    voxels: torch.Tensor       # (Nv, T, C) first <= T points per voxel
    coors: torch.Tensor        # (Nv, 4) int32 (b, z, y, x), sorted
    num_points: torch.Tensor   # (Nv,) int64 points kept per voxel


def voxelize_hard(points: torch.Tensor, points_mask: torch.Tensor,
                  point_cloud_range, voxel_size, max_points: int,
                  max_voxels: Optional[int] = None) -> HardVoxels:
    """Hard voxelization: the first ``max_points`` points of each voxel in
    point order (deterministic), voxels sorted by (batch, linear id).

    ``max_voxels`` caps the voxels of each sample as the JAX package does
    (``unique_with_ranks``): the ``max_voxels`` voxels with the lowest
    linear ids are kept and the points of the others dropped (the
    reference keeps the first voxels in point order instead).
    ``num_points`` is min(points in the voxel, ``max_points``)."""
    b, p, c = points.shape
    coors, in_range, grid = compute_voxel_coords(points, point_cloud_range,
                                                 voxel_size)
    valid = (points_mask.bool() & in_range).reshape(-1)
    keys = _keys(coors, grid).reshape(-1)
    pidx = torch.nonzero(valid).squeeze(1)
    skeys, order = torch.sort(keys[pidx], stable=True)
    pidx = pidx[order]
    n = skeys.shape[0]
    start = torch.ones(n, dtype=torch.bool, device=points.device)
    if n > 1:
        start[1:] = skeys[1:] != skeys[:-1]
    if max_voxels is not None:
        # rank of each voxel within its sample; drop the points of the
        # voxels past the cap and relabel what is left
        vox_b = skeys // (grid[0] * grid[1] * grid[2])
        first = torch.zeros(b, dtype=torch.long, device=points.device)
        first[1:] = torch.cumsum(torch.bincount(vox_b[start], minlength=b),
                                 0)[:-1]
        rank_in_b = torch.cumsum(start.long(), 0) - 1 - first[vox_b]
        ok = rank_in_b < int(max_voxels)
        skeys, pidx, start = skeys[ok], pidx[ok], start[ok]
        n = skeys.shape[0]
    gid = torch.cumsum(start.long(), 0) - 1
    pos = torch.arange(n, device=points.device)
    start_pos = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)),
                             0).values
    rank = pos - start_pos
    nv = int(start.sum())
    keep = rank < max_points
    voxels = torch.zeros((nv, max_points, c), dtype=points.dtype,
                         device=points.device)
    voxels[gid[keep], rank[keep]] = points.reshape(-1, c)[pidx[keep]]
    counts = torch.bincount(gid, minlength=nv)
    return HardVoxels(voxels, _decode_keys(skeys[start], grid),
                      counts.clamp_max(max_points))
