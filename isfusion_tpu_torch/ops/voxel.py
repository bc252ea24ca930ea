"""Voxelization (counterpart of ``isfusion_tpu/ops/voxel.py``).

Dynamic shapes. Without a ``max_voxels`` cap (the reference's
``max_voxels=-1`` semantics) every in-range valid point lands in a voxel;
``voxelize_hard`` takes the JAX package's per-sample cap. Voxel tables are
ordered by batch, then by the z-major linear id — the order of the JAX
voxelizers' dense relabelling — and carry (b, z, y, x) int32 coordinates.

``voxelize_dynamic`` is K1: on a CUDA tensor it launches
``csrc/dynamic_voxelize.cu`` (a two-level occupancy bitmap and popcount
prefix sums: no sort of the points) or raises; on a CPU tensor it takes
its plain version ``voxelize_dynamic_ref`` (``torch.unique``). Both give
the same rows, table and point lists bit for bit: each voxel's valid
points in increasing order, as CSR offsets (``voxel_ptr``) and compacted
point indices (``point_order``), which K2 (``ops/scatter.py``) reduces
over. ``segment_layout`` builds that list from segment ids (K1's list
stage). ``voxelize_hard`` is plain PyTorch (ROADMAP queue K5).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

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
    # voxel v's points: point_order[voxel_ptr[v]:voxel_ptr[v + 1]], indices
    # into the valid points in their order (points[point_voxel_index >= 0]),
    # increasing
    voxel_ptr: torch.Tensor          # (Nv + 1,) int32
    point_order: torch.Tensor        # (n_valid,) int32


def segment_layout_ref(segment_ids: torch.Tensor, num_segments: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``segment_layout``: a stable sort of the
    ids and the offsets of their counts."""
    ids = segment_ids.long()
    order = torch.sort(ids, stable=True).indices.to(torch.int32)
    ptr = torch.zeros(int(num_segments) + 1, dtype=torch.int64,
                      device=ids.device)
    ptr[1:] = torch.bincount(ids, minlength=int(num_segments)).cumsum(0)
    return ptr.to(torch.int32), order


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
    return DynamicVoxels(pvi, _decode_keys(uniq, grid),
                         *segment_layout_ref(inv, uniq.shape[0]))


# K1's workspace, one per (device index, stream): the zeroed region (all
# zero between calls: each call clears what it set), the scratch and the
# pinned host words the totals are copied to. Calls on one stream run in
# order; another stream gets a workspace of its own. A cache of the
# process, as the compiled libraries are: the entry points keep their JAX
# counterparts' signatures.
_WORKSPACES: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]] = {}
# the regions' sizes (int32 words) by op, shape and grid, as the kernel's
# source lays them out
_SIZES: Dict[tuple, Tuple[int, int]] = {}


@functools.lru_cache(maxsize=64)
def _kernel_geometry(point_cloud_range: tuple, voxel_size: tuple) -> tuple:
    """(low x, y, z, inv x, y, z, nx, ny, nz) as the kernel takes them."""
    low, inv, grid = grid_geometry(point_cloud_range, voxel_size)
    return tuple(float(v) for v in low.tolist() + inv.tolist()) + grid


def _launch_k1(op: int, dev: torch.device, out: torch.Tensor, b: int,
               p: int, c: int = 3, s: int = 0, pts=None, mask=None,
               ids=None, geo=(0.0,) * 6 + (1, 1, 1)):
    """One call of ``csrc/dynamic_voxelize.cu`` (op 0 voxelize, op 1 the
    list of ``ids``) into ``out``. Returns the pinned (3,) int64 host
    tensor that holds op 0's totals (valid points, voxels, points listed)
    when the call returns: op 0 ends by synchronising the stream."""
    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = cuda_build.load("dynamic_voxelize")
    args = (op, ptr(pts), ptr(mask), ptr(ids), b, p, c, s, *geo)
    sizes = _SIZES.get((op, b, p, c, s) + geo[6:])
    if sizes is None:
        buf = (ctypes.c_longlong * 2)()
        err = lib.dynamic_voxelize(*args, None, None, None, None, buf, None)
        if err != 0:
            raise ValueError(f"dynamic_voxelize: invalid arguments {args}")
        sizes = _SIZES[(op, b, p, c, s) + geo[6:]] = (buf[0], buf[1])
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, stream.cuda_stream)
    zeroed, scratch, host = _WORKSPACES.get(key, (None, None, None))
    if zeroed is None or zeroed.numel() < sizes[0]:
        zeroed = torch.zeros(max(sizes[0], 1), dtype=torch.int32, device=dev)
    if scratch is None or scratch.numel() < sizes[1]:
        scratch = torch.empty(sizes[1], dtype=torch.int32, device=dev)
    if host is None:
        host = torch.zeros(3, dtype=torch.int64, pin_memory=True)
    _WORKSPACES[key] = (zeroed, scratch, host)
    err = lib.dynamic_voxelize(*args, zeroed.data_ptr(), scratch.data_ptr(),
                               out.data_ptr(), host.data_ptr(), None,
                               stream.cuda_stream)
    if err != 0:
        del _WORKSPACES[key]        # its zeroed region may be left dirty
        raise RuntimeError(f"dynamic_voxelize: kernel launch failed with "
                           f"CUDA error {err}")
    return host


def segment_layout(segment_ids: torch.Tensor, num_segments: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P,) ids in [0, num_segments) -> (voxel_ptr (S + 1,) int32,
    point_order (P,) int32): segment s holds rows
    ``point_order[voxel_ptr[s]:voxel_ptr[s + 1]]``, in increasing order —
    K1's list stage, for a K2 caller that has no list. On a CUDA tensor it
    launches ``csrc/dynamic_voxelize.cu`` (op 1) or raises."""
    if segment_ids.dim() != 1 or num_segments < 0:
        raise ValueError(f"segment_layout: ids (P,) and num_segments >= 0, "
                         f"got {tuple(segment_ids.shape)}, {num_segments}")
    if segment_ids.device.type == "cpu":
        return segment_layout_ref(segment_ids, num_segments)
    if segment_ids.device.type != "cuda":
        raise RuntimeError(f"segment_layout: no kernel for "
                           f"{segment_ids.device}")
    s, p = int(num_segments), int(segment_ids.shape[0])
    if s + 1 + p >= 2 ** 31:
        raise ValueError("segment_layout: the kernel lists < 2^31 rows")
    ids = segment_ids.to(torch.int64).contiguous()
    out = torch.empty(s + 1 + p, dtype=torch.int32, device=ids.device)
    _launch_k1(1, ids.device, out, 1, p, s=s, ids=ids)
    cuda_build.LAUNCHES["segment_layout"] += 1
    return out[:s + 1], out[s + 1:]


def voxelize_dynamic(points: torch.Tensor, points_mask: torch.Tensor,
                     point_cloud_range, voxel_size) -> DynamicVoxels:
    """points (B, P, C) float32, points_mask (B, P) -> per-point voxel rows,
    the sorted unique voxel table (``dynamic_voxelize`` semantics, no cap)
    and each voxel's points — K1. Finite points; C >= 3."""
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
    geo = _kernel_geometry(tuple(float(v) for v in point_cloud_range),
                           tuple(float(v) for v in voxel_size))
    b, p, c = points.shape
    n = b * p
    if 8 * n + 1 >= 2 ** 31:
        raise ValueError("voxelize_dynamic: the kernel takes < 2^28 points")
    # one output buffer: the table sized for the worst case (16-byte rows
    # first), the rows (int64), voxel_ptr, point_order
    out = torch.empty(8 * n + 1, dtype=torch.int32, device=points.device)
    host = _launch_k1(0, points.device, out, b, p, c,
                      pts=points.contiguous(),
                      mask=points_mask.to(torch.bool).contiguous(), geo=geo)
    cuda_build.LAUNCHES["dynamic_voxelize"] += 1
    n_valid, nv, _ = host.tolist()
    table, _, rows, ptr, _, order, _ = out.split_with_sizes(
        [4 * nv, 4 * (n - nv), 2 * n, nv + 1, n - nv, n_valid, n - n_valid])
    return DynamicVoxels(rows.view(torch.int64), table.view(nv, 4), ptr,
                         order)


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
