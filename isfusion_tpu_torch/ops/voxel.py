"""Voxelization (counterpart of ``isfusion_tpu/ops/voxel.py``).

Dynamic shapes. Without a ``max_voxels`` cap (the reference's
``max_voxels=-1`` semantics) every in-range valid point lands in a voxel;
``voxelize_hard`` takes the JAX package's per-sample cap. Voxel tables are
ordered by batch, then by the z-major linear id — the order of the JAX
voxelizers' dense relabelling — and carry (b, z, y, x) int32 coordinates.

``voxelize_dynamic`` is K1: on a CUDA tensor it launches
``csrc/dynamic_voxelize.cu`` (an occupancy bitmap, a popcount prefix sum:
no sort) or raises; on a CPU tensor it takes its plain version
``voxelize_dynamic_ref`` (``torch.unique``). Both give the same rows and
the same table bit for bit. ``voxelize_hard`` is plain PyTorch (ROADMAP
queue K5).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import cuda_build


def grid_geometry(point_cloud_range: Sequence[float],
                  voxel_size: Sequence[float]):
    """(low, inv: (3,) float32 CPU tensors; grid (nx, ny, nz)): ``inv`` is
    1/voxel_size rounded once from float64 to float32."""
    pcr = tuple(float(v) for v in point_cloud_range)
    vs = tuple(float(v) for v in voxel_size)
    grid = (int(round((pcr[3] - pcr[0]) / vs[0])),
            int(round((pcr[4] - pcr[1]) / vs[1])),
            int(round((pcr[5] - pcr[2]) / vs[2])))
    low = torch.tensor(pcr[:3], dtype=torch.float32)
    inv = torch.tensor([1.0 / v for v in vs], dtype=torch.float32)
    return low, inv, grid


def compute_voxel_coords(points: torch.Tensor,
                         point_cloud_range: Sequence[float],
                         voxel_size: Sequence[float]
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Tuple[int, int, int]]:
    """Per-point (z, y, x) int32 voxel coords, in-range mask, grid (nx, ny, nz).

    floor((xyz - low) * inv) in float32, with ``inv`` = 1/voxel_size
    rounded once from float64 to float32 — the JAX package's arithmetic, so
    points on voxel boundaries land in the same voxel."""
    low, inv, (nx, ny, nz) = grid_geometry(point_cloud_range, voxel_size)
    xyz = points[..., :3].float()
    low, inv = low.to(points.device), inv.to(points.device)
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


def voxelize_dynamic_ref(points: torch.Tensor, points_mask: torch.Tensor,
                         point_cloud_range, voxel_size) -> DynamicVoxels:
    """Plain PyTorch version of ``voxelize_dynamic`` (the CPU path and
    K1's yardstick)."""
    coors, in_range, grid = compute_voxel_coords(points, point_cloud_range,
                                                 voxel_size)
    valid = (points_mask.bool() & in_range).reshape(-1)
    keys = _keys(coors, grid).reshape(-1)
    uniq, inv = torch.unique(keys[valid], sorted=True, return_inverse=True)
    pvi = torch.full_like(keys, -1)
    pvi[valid] = inv
    return DynamicVoxels(pvi, _decode_keys(uniq, grid))


def voxelize_dynamic(points: torch.Tensor, points_mask: torch.Tensor,
                     point_cloud_range, voxel_size) -> DynamicVoxels:
    """points (B, P, C) float32, points_mask (B, P) -> per-point voxel rows
    and the sorted unique voxel table (``dynamic_voxelize`` semantics, no
    cap) — K1. Finite points; C >= 3."""
    if points.dim() != 3 or points.shape[-1] < 3 or \
            tuple(points_mask.shape) != tuple(points.shape[:2]):
        raise ValueError(f"voxelize_dynamic: points (B, P, C >= 3) and mask "
                         f"(B, P), got {tuple(points.shape)} and "
                         f"{tuple(points_mask.shape)}")
    if points.device != points_mask.device:
        raise ValueError("voxelize_dynamic: points and mask on different "
                         "devices")
    if points.device.type == "cpu":
        return voxelize_dynamic_ref(points, points_mask, point_cloud_range,
                                    voxel_size)
    if points.device.type != "cuda":
        raise RuntimeError(f"voxelize_dynamic: no kernel for {points.device}")
    if points.dtype != torch.float32:
        raise TypeError("voxelize_dynamic: the kernel takes float32 points")
    low, inv, grid = grid_geometry(point_cloud_range, voxel_size)
    b, p, c = points.shape
    dev = points.device
    pts = points.contiguous()
    mask = points_mask.to(torch.bool).contiguous()
    n_words = (b * grid[0] * grid[1] * grid[2] + 31) // 32
    tiles = -(-n_words // cuda_build.PREFIX_SCAN_TILE)
    bitmap = torch.zeros(n_words, dtype=torch.int32, device=dev)
    prefix = torch.empty(n_words, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(tiles, dtype=torch.int32, device=dev)
    keys = torch.empty(b * p, dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    rows = torch.empty(b * p, dtype=torch.int64, device=dev)
    lib = cuda_build.load("dynamic_voxelize")
    stream = torch.cuda.current_stream(dev).cuda_stream
    geo = [float(v) for v in low.tolist() + inv.tolist()] + list(grid)

    def launch(stage, table):
        err = lib.dynamic_voxelize(
            stage, pts.data_ptr(), mask.data_ptr(), b, p, c, *geo,
            bitmap.data_ptr(), prefix.data_ptr(), tile_sums.data_ptr(),
            keys.data_ptr(), total.data_ptr(), rows.data_ptr(),
            table.data_ptr() if table is not None else None, stream)
        if err != 0:
            raise RuntimeError(f"dynamic_voxelize: kernel launch failed with "
                               f"CUDA error {err}")

    launch(0, None)
    nv = int(total.item())
    table = torch.empty((nv, 4), dtype=torch.int32, device=dev)
    launch(1, table)
    cuda_build.LAUNCHES["dynamic_voxelize"] += 1
    return DynamicVoxels(rows, table)


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
