"""Numpy box operations of the GT-paste sampler and the GT database
(counterpart of ``isfusion_tpu/core/bbox/box_np_ops.py``, the parts those
use): rotated BEV corners, points in rotated LiDAR boxes, and the
separating-axis collision test of rotated BEV boxes.

The rotation convention is the box class's (``structures.py``): a box's
local offset (lx, ly) lies at world (lx*c + ly*s, -lx*s + ly*c) from its
centre (rows times [[c, -s], [s, c]]).
"""
from __future__ import annotations

import numpy as np


def corners_nd(dims: np.ndarray, origin=0.5) -> np.ndarray:
    """(N, 2**ndim, ndim) corners of axis-aligned boxes of ``dims``."""
    ndim = int(dims.shape[1])
    corners_norm = np.stack(
        np.unravel_index(np.arange(2 ** ndim), [2] * ndim), axis=1
    ).astype(dims.dtype)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array(origin, dtype=dims.dtype)
    return dims.reshape(-1, 1, ndim) * corners_norm.reshape(1, -1, ndim)


def rotation_2d(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """(N, M, 2) points turned by (N,) angles, the box convention."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    rot_mat_T = np.stack([
        np.stack([rot_cos, -rot_sin], -1),
        np.stack([rot_sin, rot_cos], -1),
    ], axis=1)  # (N, 2, 2)
    return np.einsum("aij,ajk->aik", points, rot_mat_T)


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """(N, 4, 2) BEV corners from centres, dims and angles."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers.reshape(-1, 1, 2)


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray,
                    origin=(0.5, 0.5, 0)) -> np.ndarray:
    """(P, N) bool: which points lie in which rotated LiDAR boxes (rows
    (x, y, z, dx, dy, dz, yaw, ...), bottom-centre origin); each point's
    offset is turned into the box's frame."""
    points = np.asarray(points, dtype=np.float32)[:, :3]
    boxes = np.asarray(boxes, dtype=np.float32)
    if boxes.shape[0] == 0 or points.shape[0] == 0:
        return np.zeros((points.shape[0], boxes.shape[0]), dtype=bool)
    centers = boxes[:, :3].copy()
    dims = boxes[:, 3:6]
    centers += dims * (0.5 - np.array(origin, dtype=np.float32))
    yaw = boxes[:, 6]
    off = points[:, None, :] - centers[None, :, :]
    cos, sin = np.cos(yaw), np.sin(yaw)
    local_x = off[..., 0] * cos[None] - off[..., 1] * sin[None]
    local_y = off[..., 0] * sin[None] + off[..., 1] * cos[None]
    local_z = off[..., 2]
    return ((np.abs(local_x) <= dims[None, :, 0] / 2)
            & (np.abs(local_y) <= dims[None, :, 1] / 2)
            & (np.abs(local_z) <= dims[None, :, 2] / 2))


def box_collision_test(boxes: np.ndarray, qboxes: np.ndarray) -> np.ndarray:
    """(N, K) bool: do rotated BEV boxes (x, y, dx, dy, yaw) overlap?"""
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=bool)
    c1 = center_to_corner_box2d(boxes[:, :2], boxes[:, 2:4], boxes[:, 4])
    c2 = center_to_corner_box2d(qboxes[:, :2], qboxes[:, 2:4], qboxes[:, 4])
    return _sat_overlap(c1, c2)


def _sat_overlap(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Separating-axis overlap of convex quads (N, 4, 2) and (K, 4, 2):
    both corner sets projected on each box's four edge normals."""

    def edge_normals(c):
        edges = np.roll(c, -1, axis=1) - c  # (M, 4, 2)
        return np.stack([-edges[..., 1], edges[..., 0]], -1)

    axes1 = edge_normals(c1)  # (N, 4, 2)
    axes2 = edge_normals(c2)  # (K, 4, 2)
    p1 = np.einsum("nac,nkc->nak", axes1, c1[:, :, :])
    p2 = np.einsum("nac,kjc->nkaj", axes1, c2)
    min1, max1 = p1.min(-1)[:, None], p1.max(-1)[:, None]
    min2, max2 = p2.min(-1), p2.max(-1)
    sep1 = (max1 < min2) | (max2 < min1)  # (N, K, 4)
    p1b = np.einsum("kac,njc->nkaj", axes2, c1)
    p2b = np.einsum("kac,kjc->kaj", axes2, c2)
    min1b, max1b = p1b.min(-1), p1b.max(-1)
    min2b, max2b = p2b.min(-1)[None], p2b.max(-1)[None]
    sep2 = (max1b < min2b) | (max2b < min1b)
    return ~(sep1.any(-1) | sep2.any(-1))
