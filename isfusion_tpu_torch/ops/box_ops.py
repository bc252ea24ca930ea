"""Rotated-box geometry — K10, pairwise 3D IoU of LiDAR boxes (counterpart
of ``isfusion_tpu/ops/box_ops.py:boxes_iou_3d``).

``boxes_iou_3d(a (N, 7+), b (M, 7+)) -> (N, M)`` float32, boxes (x, y,
z_bottom, dx, dy, dz, yaw[, ...]): BEV intersection by the candidate-point
method (vertices inside the other box + the 16 edge intersections, sorted
by angle around their centroid, shoelace) x vertical overlap, over the
union clamped at 1e-8. Both boxes of a pair are moved into a frame centred
on the first one before the corners are formed, and the shoelace runs on
centroid-relative vertices: the same function as the JAX composition, with
box-sized instead of scene-sized float32 coordinates.

On a CPU tensor ``boxes_iou_3d`` takes the plain PyTorch version
(``boxes_iou_3d_ref``, the tests' and the kernel's yardstick); on a CUDA
tensor it launches ``csrc/boxes_iou_3d.cu`` (one thread per pair) or
raises. The assigner's IoU3DCost calls it once per sample and decoder
layer, on 200 x G pairs.
"""
from __future__ import annotations

import torch

from . import cuda_build

# float32 operations per pair of the kernel's straight-line part: corners
# of the moved box (2 sin/cos + 20), 8 point-in-box tests (8 x 4 x 6), 16
# segment intersections (16 x 22), centroid (2 x 24 + 2); the angle sort
# and the shoelace depend on the valid candidates and are counted per pair
# by ``iou3d_ops``
IOU3D_OPS_PER_PAIR = 22 + 8 * 4 * 6 + 16 * 22 + 50 + 16


def rotated_corners_2d(boxes_bev: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) CCW corners of (..., 5) BEV boxes (x, y, dx, dy, yaw),
    rotated as ``core.bbox.structures`` does (wx = lx cos + ly sin)."""
    x, y, dx, dy, yaw = boxes_bev.unbind(-1)
    cos, sin = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    cx = torch.stack([dx, dx, -dx, -dx], -1) * 0.5
    cy = torch.stack([-dy, dy, dy, -dy], -1) * 0.5
    rx = cx * cos + cy * sin + x[..., None]
    ry = -cx * sin + cy * cos + y[..., None]
    return torch.stack([rx, ry], -1)


def _point_in_rect(pts: torch.Tensor, quad: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """pts (..., P, 2) inside the convex CCW quad (..., 4, 2) -> (..., P)."""
    ab = (torch.roll(quad, -1, dims=-2) - quad)[..., None, :, :]
    ap = pts[..., :, None, :] - quad[..., None, :, :]
    cross = ab[..., 0] * ap[..., 1] - ab[..., 1] * ap[..., 0]
    return (cross >= -eps).all(-1)


def _segment_intersections(c1: torch.Tensor, c2: torch.Tensor):
    """The 16 edge-pair intersections of two quads (..., 4, 2) ->
    pts (..., 16, 2), valid (..., 16), index 4 * edge1 + edge2."""
    p = c1[..., :, None, :]
    q = (torch.roll(c1, -1, dims=-2) - c1)[..., :, None, :]
    r = c2[..., None, :, :]
    s = (torch.roll(c2, -1, dims=-2) - c2)[..., None, :, :]
    denom = q[..., 0] * s[..., 1] - q[..., 1] * s[..., 0]
    par = denom.abs() < 1e-8
    d = torch.where(par, torch.ones_like(denom), denom)
    pr = r - p
    t = (pr[..., 0] * s[..., 1] - pr[..., 1] * s[..., 0]) / d
    u = (pr[..., 0] * q[..., 1] - pr[..., 1] * q[..., 0]) / d
    valid = ~par & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = p + t[..., None] * q
    lead = pts.shape[:-3]
    return pts.reshape(lead + (16, 2)), valid.reshape(lead + (16,))


def _candidates(boxes1_bev: torch.Tensor, boxes2_bev: torch.Tensor):
    """(N, M, 24, 2) candidate points of each pair in a frame centred on
    the first box, and their validity (N, M, 24)."""
    n, m = boxes1_bev.shape[0], boxes2_bev.shape[0]
    b1 = torch.cat([torch.zeros_like(boxes1_bev[:, :2]), boxes1_bev[:, 2:]],
                   -1)[:, None].expand(n, m, 5)
    b2 = torch.cat([boxes2_bev[None, :, :2] - boxes1_bev[:, None, :2],
                    boxes2_bev[None, :, 2:].expand(n, m, 3)], -1)
    c1, c2 = rotated_corners_2d(b1), rotated_corners_2d(b2)
    ipts, ivalid = _segment_intersections(c1, c2)
    cand = torch.cat([c1, c2, ipts], -2)
    valid = torch.cat([_point_in_rect(c1, c2), _point_in_rect(c2, c1),
                       ivalid], -1)
    return cand, valid


def rotated_rect_intersection_area(boxes1_bev: torch.Tensor,
                                   boxes2_bev: torch.Tensor) -> torch.Tensor:
    """(N, M) intersection areas of rotated BEV rects (x, y, dx, dy, yaw)."""
    cand, valid = _candidates(boxes1_bev, boxes2_bev)
    cnt = valid.sum(-1, keepdim=True).clamp_min(1)
    centroid = torch.where(valid[..., None], cand, 0.0).sum(-2,
                                                           keepdim=True) / \
        cnt[..., None]
    rel = cand - centroid
    ang = torch.where(valid, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.full_like(rel[..., 0], 1e4))
    order = torch.argsort(ang, dim=-1, stable=True)
    v = torch.gather(rel, -2, order[..., None].expand(-1, -1, -1, 2))
    ok = torch.gather(valid, -1, order)
    v = torch.where(ok[..., None], v, v[..., :1, :])
    nxt = torch.roll(v, -1, dims=-2)
    cross = v[..., 0] * nxt[..., 1] - nxt[..., 0] * v[..., 1]
    area = 0.5 * cross.sum(-1).abs()
    return torch.where(valid.any(-1), area, torch.zeros_like(area))


def boxes_iou_3d_ref(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> torch.Tensor:
    """Plain PyTorch version of ``boxes_iou_3d``."""
    a, b = boxes1[:, :7].float(), boxes2[:, :7].float()
    cols = [0, 1, 3, 4, 6]
    inter = rotated_rect_intersection_area(a[:, cols], b[:, cols])
    hi = torch.minimum((a[:, 2] + a[:, 5])[:, None], (b[:, 2] + b[:, 5])[None])
    lo = torch.maximum(a[:, 2][:, None], b[:, 2][None])
    inter = inter * (hi - lo).clamp_min(0.0)
    vol1 = a[:, 3] * a[:, 4] * a[:, 5]
    vol2 = b[:, 3] * b[:, 4] * b[:, 5]
    return inter / (vol1[:, None] + vol2[None] - inter).clamp_min(1e-8)


def iou3d_ops(boxes1: torch.Tensor, boxes2: torch.Tensor) -> int:
    """float32 operations the kernel needs on these boxes: the fixed part
    per pair plus, per pair with k valid candidates, an angle per candidate
    (~20), k * ceil(log2 k) sort comparisons and 4 k shoelace operations."""
    cols = [0, 1, 3, 4, 6]
    _, valid = _candidates(boxes1[:, cols].float(), boxes2[:, cols].float())
    k = valid.sum(-1).double()
    log_k = torch.ceil(torch.log2(k.clamp_min(1)))
    per_pair = IOU3D_OPS_PER_PAIR + 20 * k + k * log_k + 4 * k
    return int(per_pair.sum())


def _check(boxes1: torch.Tensor, boxes2: torch.Tensor):
    if boxes1.dim() != 2 or boxes2.dim() != 2 or boxes1.shape[1] < 7 \
            or boxes2.shape[1] < 7:
        raise ValueError("boxes_iou_3d: boxes (N, >=7) and (M, >=7)")
    if boxes1.device != boxes2.device:
        raise ValueError("boxes_iou_3d: boxes on different devices")


def boxes_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, M) float32 3D IoU of LiDAR boxes (``BboxOverlaps3D``)."""
    _check(boxes1, boxes2)
    if boxes1.device.type == "cpu":
        return boxes_iou_3d_ref(boxes1, boxes2)
    if boxes1.device.type != "cuda":
        raise RuntimeError(f"boxes_iou_3d: no kernel for {boxes1.device}")
    a = boxes1[:, :7].float().contiguous()
    b = boxes2[:, :7].float().contiguous()
    n, m = a.shape[0], b.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=a.device)
    if n == 0 or m == 0:
        return out
    lib = cuda_build.load("boxes_iou_3d")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.boxes_iou_3d(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m,
                           stream)
    if err != 0:
        raise RuntimeError(f"boxes_iou_3d: kernel launch failed with CUDA "
                           f"error {err}")
    cuda_build.LAUNCHES["boxes_iou_3d"] += 1
    return out
