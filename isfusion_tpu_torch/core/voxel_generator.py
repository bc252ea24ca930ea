"""Host-side (numpy) hard voxelizer of the data pipelines (counterpart of
``isfusion_tpu/core/voxel_generator.py``; reference
``mmdet3d/core/voxel/voxel_generator.py``), used by
``VoxelBasedPointSampler``. Points outside the range are skipped, voxels
come in first-seen order, a voxel keeps its first ``max_num_points``
points (later arrivals dropped), at most ``max_voxels`` voxels are kept
(later ones dropped). Coordinates are (z, y, x)."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class VoxelGenerator:
    def __init__(self, voxel_size: Sequence[float],
                 point_cloud_range: Sequence[float],
                 max_num_points: int, max_voxels: int = 20000):
        self._voxel_size = np.asarray(voxel_size, np.float32)
        self._point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self._max_num_points = int(max_num_points)
        self._max_voxels = int(max_voxels)
        self._grid_size = np.round(
            (self._point_cloud_range[3:] - self._point_cloud_range[:3])
            / self._voxel_size).astype(np.int64)            # (nx, ny, nz)

    @property
    def voxel_size(self) -> np.ndarray:
        return self._voxel_size

    @property
    def point_cloud_range(self) -> np.ndarray:
        return self._point_cloud_range

    @property
    def grid_size(self) -> np.ndarray:
        return self._grid_size

    def generate(self, points: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """points (N, C >= 3) -> voxels (M, max_num_points, C), coors
        (M, 3) int32 zyx, num_points_per_voxel (M,) int32."""
        points = np.asarray(points)
        pcr = self._point_cloud_range
        cxyz = np.floor((points[:, :3] - pcr[:3]) / self._voxel_size) \
            .astype(np.int64)
        keep = np.all((cxyz >= 0) & (cxyz < self._grid_size), axis=1)
        pts, cxyz = points[keep], cxyz[keep]
        c = points.shape[1]
        if len(pts) == 0:
            return (np.zeros((0, self._max_num_points, c), points.dtype),
                    np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))
        nx, ny, _ = self._grid_size
        flat = (cxyz[:, 2] * ny + cxyz[:, 1]) * nx + cxyz[:, 0]
        _, first, inv = np.unique(flat, return_index=True,
                                  return_inverse=True)
        order = np.argsort(first, kind="stable")     # first-seen order
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        vox = rank[inv]                              # each point's voxel
        m = min(len(order), self._max_voxels)
        # each point's arrival index within its voxel, in point order
        by_vox = np.argsort(vox, kind="stable")
        starts = np.searchsorted(vox[by_vox], np.arange(len(order)))
        slot = np.empty(len(pts), np.int64)
        slot[by_vox] = np.arange(len(pts)) - starts[vox[by_vox]]
        take = (vox < m) & (slot < self._max_num_points)
        voxels = np.zeros((m, self._max_num_points, c), points.dtype)
        voxels[vox[take], slot[take]] = pts[take]
        num = np.minimum(np.bincount(vox, minlength=len(order))[:m],
                         self._max_num_points).astype(np.int32)
        seed = first[order[:m]]
        coors = np.stack([cxyz[seed, 2], cxyz[seed, 1], cxyz[seed, 0]],
                         -1).astype(np.int32)
        return voxels, coors, num

    def __repr__(self):
        return (f"VoxelGenerator(voxel_size={self._voxel_size.tolist()}, "
                f"point_cloud_range={self._point_cloud_range.tolist()}, "
                f"max_num_points={self._max_num_points}, "
                f"max_voxels={self._max_voxels})")
