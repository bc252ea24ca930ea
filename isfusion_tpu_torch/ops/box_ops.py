"""Rotated-box geometry (counterpart of ``isfusion_tpu/ops/box_ops.py``):
K10, pairwise 3D IoU of LiDAR boxes, and K10-NMS, greedy rotated-BEV NMS.

``boxes_iou_3d(a (..., N, 7+), b (..., M, 7+)) -> (..., N, M)`` float32,
boxes (x, y, z_bottom, dx, dy, dz, yaw[, ...]) with equal leading (batch)
dims: BEV intersection by the candidate-point method (vertices inside the
other box + the 16 edge intersections, sorted by angle around their
centroid, shoelace) x vertical overlap, over the union clamped at 1e-8.
Both boxes of a pair are moved into a frame centred on the first one
before the corners are formed, and the shoelace runs on centroid-relative
vertices: the same function as the JAX composition, with box-sized instead
of scene-sized float32 coordinates.

``nms_bev_mask(boxes (B, K, 5), scores (B, C, K), thresh, valid (B, C,
K)) -> keep (B, C, K)``: for each sample and class, the JAX package's
``nms_bev_mask`` (``_greedy_suppress`` over ``boxes_iou_bev > thresh``):
walk the boxes by descending score (ties: lower index first); a valid box
that no kept box suppresses is kept. BEV boxes are (x, y, dx, dy, yaw).

``circle_nms_mask(centers (R, K, 2), scores (R, K), thresh (R,), valid
(R, K)) -> keep (R, K)``: K10-circle, the JAX package's
``circle_nms_mask`` for R independent sets, each with its own threshold:
the same greedy walk over ``squared centre distance <= thresh``.

``boxes_iou_bev(a (..., N, 5), b (..., M, 5)) -> (..., N, M)``: K10-BEV,
the JAX package's ``boxes_iou_bev`` (rotated BEV IoU, union clamped at
1e-8), for all leading dims at once: a tile kernel settles the pairs the
exact cuts can and lists the rest, a drain kernel computes those.
``nms_normal_bev_mask(boxes (B, K, 4), scores (B, C, K), thresh, valid
(B, C, K)) -> keep (B, C, K)``:
K10-normal, the JAX package's ``nms_normal_bev_mask`` (the greedy walk
over axis-aligned ``(x1, y1, x2, y2)`` IoU > thresh).

On a CPU tensor each function takes its plain PyTorch version
(``boxes_iou_3d_ref``, ``nms_bev_mask_ref``, ``circle_nms_mask_ref``,
``boxes_iou_bev_ref``, ``nms_normal_bev_mask_ref``: the tests' and the
kernels' yardsticks); on a CUDA tensor it launches its kernel
(``csrc/boxes_iou_3d.cu``, K10 and K10-BEV; ``csrc/nms_bev.cu``,
sharing the geometry of ``csrc/rotated_box.cuh``; K10-NMS's and
K10-normal's greedy pass is ``csrc/nms_greedy.cuh``;
``csrc/nms_normal_bev.cu``, whose pairwise pass is
``csrc/nms_pairwise.cuh``; ``csrc/nms_circle.cu`` is K10-circle in one
launch, and past 1,792 boxes a set the pairwise and greedy passes) or
raises. The assigner's IoU3DCost calls K10 once per train
step, on all samples and decoder layers; Anchor3DHead's ``get_bboxes``
and ``core/post_processing.py:box3d_multiclass_nms`` call K10-NMS once
per request, CenterHead's ``get_bboxes`` K10-circle; ``weighted_nms``
calls K10-BEV once per class it merges.

``box_local_uvw(boxes, centers)``: the world-to-box transform of points
(normalised in-box coordinates and the inside mask), shared by PartA2's
part targets and K16 (``ops/roiaware_pool.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import cuda_build

# float32 operations per pair of the kernels' straight-line part: corners
# of the moved box (2 sin/cos + 20), 8 point-in-box tests (8 x 4 x 6), 16
# segment intersections (16 x 22), centroid (2 x 24 + 2), union and ratio;
# the angle sort and the shoelace depend on the valid candidates and are
# counted per pair by ``rotated_iou_ops``
IOU3D_OPS_PER_PAIR = 22 + 8 * 4 * 6 + 16 * 22 + 50 + 16

# the greedy pass (csrc/nms_greedy.cuh) takes a block per (sample, class),
# up to 2^31 - 1 of them, and holds 4,112 bytes of gathered blocks and
# sorted indices, the class's ceil(K / 64) removed words and, where they
# fit in Hopper's 227 KB of shared memory a block (K <= 5,632), five
# chunks' staged mask rows (64 ceil(K / 64) words each); without them it
# takes K <= 1,826,688; the pairwise passes take up to 65,535 samples a
# launch
NMS_SMEM_BYTES = 227 * 1024
GREEDY_FIXED_BYTES = 4112
GREEDY_STAGES = 5
NMS_MAX_SAMPLES = 65535

# K10-NMS's pairwise pass computes a pair only when its boxes' bounding
# circles, widened by the point-in-box tolerance, meet
# (``bev_circles_meet``; why that is exact: the note of csrc/nms_bev.cu);
# the test costs ~8 float32 operations a pair. Cheaper certificates that a
# pair's bit is 0, counted by the data-dependent bound: the area ratio
# (IoU <= min(area) / max(area); min, max, a product and a comparison),
# and a separating-axis test of the two rectangles from staged cos / sin
# (relative rotation 6, centre offset 2, and for each of the 4 axes the
# offset's projection 4, the other box's half-extent 5, sum and
# comparison 2)
NMS_QUAD_TOL = 1e-5
NMS_CUT_REL, NMS_CUT_ABS = 1.0 + 1e-4, 1e-3
NMS_CIRCLE_OPS = 8
NMS_RATIO_OPS = 4
NMS_SAT_OPS = 6 + 2 + 4 * (4 + 5 + 2)

# K10 settles a pair of tame boxes (every value finite, coordinates and
# sides within 1e8 m) as IoU 0 when their vertical overlap is <= 0 (min,
# max, a difference and a comparison) or their circles do not meet
# (``iou3d_early_outs``; why both are exact: csrc/boxes_iou_3d.cu)
IOU3D_TAME = 1e8
IOU3D_Z_OPS = 4


def greedy_staged(boxes: int) -> bool:
    """Whether the greedy pass stages a class's mask rows in shared memory
    (csrc/nms_greedy.cuh ``greedy_staged``)."""
    w = (boxes + 63) // 64
    return GREEDY_FIXED_BYTES + w * 8 * (1 + 64 * GREEDY_STAGES) <= \
        NMS_SMEM_BYTES


def greedy_smem_bytes(boxes: int) -> int:
    """Shared memory of the greedy pass's block for one class of K boxes
    (``launch_greedy`` refuses more than ``NMS_SMEM_BYTES``)."""
    w = (boxes + 63) // 64
    return GREEDY_FIXED_BYTES + w * 8 * (
        1 + (64 * GREEDY_STAGES if greedy_staged(boxes) else 0))


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = math.pi) -> torch.Tensor:
    return val - torch.floor(val / period + offset) * period


def box_trig(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) cos and sin of the boxes' yaws (``boxes`` (..., N, 7+))."""
    yaw = boxes[..., 6]
    return torch.stack([torch.cos(yaw), torch.sin(yaw)], -1)


def box_local_uvw(boxes: torch.Tensor, centers: torch.Tensor):
    """Normalised in-box coordinates of points against bottom-centre
    LiDAR boxes: ``boxes`` (..., N, 7+), ``centers`` (..., P, 3) -> (uvw
    (..., P, N, 3), in [0, 1) where inside; inside (..., P, N) bool). The
    one home of the world-to-box transform (the part targets and K16
    use it), in the JAX package's order of operations, each step rounded
    once: rel = p - c, rel_z -= dz / 2, lx = rx cos - ry sin, ly = rx sin
    + ry cos, dims = max(dims, 1e-3), u = lx / dx + 0.5 (v, w alike),
    inside = all(0 <= uvw < 1); the yaws' cos and sin are ``box_trig``'s,
    which K16's wrapper hands its kernel."""
    trig = box_trig(boxes)
    b = boxes[..., None, :, :]
    rel = centers[..., :, None, :] - b[..., :3]
    rz = rel[..., 2] - b[..., 5] * 0.5
    cos, sin = trig[..., None, :, 0], trig[..., None, :, 1]
    lx = rel[..., 0] * cos - rel[..., 1] * sin
    ly = rel[..., 0] * sin + rel[..., 1] * cos
    dims = b[..., 3:6].clamp_min(1e-3)
    uvw = torch.stack([lx / dims[..., 0] + 0.5, ly / dims[..., 1] + 0.5,
                       rz / dims[..., 2] + 0.5], -1)
    inside = ((uvw >= 0) & (uvw < 1)).all(-1)
    return uvw, inside


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
    """(..., N, M, 24, 2) candidate points of each pair of (..., N, 5) x
    (..., M, 5) boxes in a frame centred on the first box, and their
    validity (..., N, M, 24)."""
    n, m = boxes1_bev.shape[-2], boxes2_bev.shape[-2]
    shape = boxes1_bev.shape[:-2] + (n, m)
    b1 = torch.cat([torch.zeros_like(boxes1_bev[..., :2]),
                    boxes1_bev[..., 2:]], -1)[..., :, None, :].expand(
                        shape + (5,))
    b2 = torch.cat([boxes2_bev[..., None, :, :2] -
                    boxes1_bev[..., :, None, :2],
                    boxes2_bev[..., None, :, 2:].expand(shape + (3,))], -1)
    c1, c2 = rotated_corners_2d(b1), rotated_corners_2d(b2)
    ipts, ivalid = _segment_intersections(c1, c2)
    cand = torch.cat([c1, c2, ipts], -2)
    valid = torch.cat([_point_in_rect(c1, c2), _point_in_rect(c2, c1),
                       ivalid], -1)
    return cand, valid


def rotated_rect_intersection_area(boxes1_bev: torch.Tensor,
                                   boxes2_bev: torch.Tensor) -> torch.Tensor:
    """(..., N, M) intersection areas of rotated BEV rects (x, y, dx, dy,
    yaw)."""
    cand, valid = _candidates(boxes1_bev, boxes2_bev)
    cnt = valid.sum(-1, keepdim=True).clamp_min(1)
    centroid = torch.where(valid[..., None], cand, 0.0).sum(-2,
                                                           keepdim=True) / \
        cnt[..., None]
    rel = cand - centroid
    ang = torch.where(valid, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.full_like(rel[..., 0], 1e4))
    order = torch.argsort(ang, dim=-1, stable=True)
    v = torch.gather(rel, -2, order[..., None].expand(order.shape + (2,)))
    ok = torch.gather(valid, -1, order)
    v = torch.where(ok[..., None], v, v[..., :1, :])
    nxt = torch.roll(v, -1, dims=-2)
    cross = v[..., 0] * nxt[..., 1] - nxt[..., 0] * v[..., 1]
    area = 0.5 * cross.sum(-1).abs()
    return torch.where(valid.any(-1), area, torch.zeros_like(area))


def boxes_iou_bev_ref(boxes1_bev: torch.Tensor, boxes2_bev: torch.Tensor
                      ) -> torch.Tensor:
    """(..., N, M) IoU of rotated BEV boxes (x, y, dx, dy, yaw) (the JAX
    package's ``boxes_iou_bev``), plain PyTorch."""
    a, b = boxes1_bev.float(), boxes2_bev.float()
    inter = rotated_rect_intersection_area(a, b)
    a1, a2 = a[..., 2] * a[..., 3], b[..., 2] * b[..., 3]
    return inter / (a1[..., :, None] + a2[..., None, :] -
                    inter).clamp_min(1e-8)


def boxes_iou_3d_ref(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> torch.Tensor:
    """Plain PyTorch version of ``boxes_iou_3d``."""
    a, b = boxes1[..., :7].float(), boxes2[..., :7].float()
    cols = [0, 1, 3, 4, 6]
    inter = rotated_rect_intersection_area(a[..., cols], b[..., cols])
    hi = torch.minimum((a[..., 2] + a[..., 5])[..., :, None],
                       (b[..., 2] + b[..., 5])[..., None, :])
    lo = torch.maximum(a[..., 2][..., :, None], b[..., 2][..., None, :])
    inter = inter * (hi - lo).clamp_min(0.0)
    vol1 = a[..., 3] * a[..., 4] * a[..., 5]
    vol2 = b[..., 3] * b[..., 4] * b[..., 5]
    return inter / (vol1[..., :, None] + vol2[..., None, :] -
                    inter).clamp_min(1e-8)


def rotated_iou_ops(boxes1_bev: torch.Tensor, boxes2_bev: torch.Tensor
                    ) -> torch.Tensor:
    """(..., N, M) float32 operations the kernels need per pair of these
    BEV boxes: the fixed part plus, for k valid candidates, an angle per
    candidate (~20), k * ceil(log2 k) sort comparisons and 4 k shoelace
    operations."""
    _, valid = _candidates(boxes1_bev.float(), boxes2_bev.float())
    k = valid.sum(-1).double()
    log_k = torch.ceil(torch.log2(k.clamp_min(1)))
    return IOU3D_OPS_PER_PAIR + 20 * k + k * log_k + 4 * k


def iou3d_ops(boxes1: torch.Tensor, boxes2: torch.Tensor) -> int:
    """float32 operations of K10's exact IoU for every pair of these
    boxes."""
    cols = [0, 1, 3, 4, 6]
    return int(rotated_iou_ops(boxes1[..., cols], boxes2[..., cols]).sum())


def iou3d_tame(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N) bool: the boxes K10 may cut, every value finite and
    |x|, |y|, |z|, |dx|, |dy|, |dz| <= ``IOU3D_TAME``: their BEV
    intersection area is finite, so that no vertical overlap makes the IoU
    exactly 0."""
    b = boxes[..., :7].float()
    return (b[..., :6].abs() <= IOU3D_TAME).all(-1) & \
        torch.isfinite(b[..., 6])


def _circles_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, M) bool: the bounding circles of float32 (..., N, 4) and
    (..., M, 4) BEV boxes (x, y, dx, dy) do not meet, in the kernels'
    arithmetic (``bev_circles_meet``'s test, centres taken b - a)."""
    def reach(x):
        return 0.5 * torch.hypot(x[..., 2], x[..., 3]) + \
            NMS_QUAD_TOL / x[..., 2].abs() + NMS_QUAD_TOL / x[..., 3].abs()

    d = b[..., None, :, :2] - a[..., :, None, :2]
    lim = (reach(a)[..., :, None] + reach(b)[..., None, :]) * NMS_CUT_REL + \
        NMS_CUT_ABS
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] > lim * lim


def iou3d_early_outs(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """(by_z, by_circle), each (..., N, M) bool: the pairs K10's kernel
    settles as IoU 0 without the exact intersection, in its float32
    arithmetic. Both boxes tame (``iou3d_tame``), and ``by_z``: the
    vertical overlap min(top) - max(bottom) is <= 0; ``by_circle``: the
    BEV bounding circles do not meet (``_circles_apart``)."""
    a, b = boxes1[..., :7].float(), boxes2[..., :7].float()
    tame = iou3d_tame(a)[..., :, None] & iou3d_tame(b)[..., None, :]
    ov = torch.minimum((a[..., 2] + a[..., 5])[..., :, None],
                       (b[..., 2] + b[..., 5])[..., None, :]) - \
        torch.maximum(a[..., 2][..., :, None], b[..., 2][..., None, :])
    cols = [0, 1, 3, 4]
    return tame & (ov <= 0), tame & _circles_apart(a[..., cols],
                                                   b[..., cols])


def iou3d_needed_ops(boxes1: torch.Tensor, boxes2: torch.Tensor) -> int:
    """float32 operations that settle every pair of these boxes, each by
    its cheapest certificate: the vertical overlap test where the boxes do
    not overlap in z, else the circle test where their circles are apart,
    else a separating-axis test where the plain BEV intersection area is
    0, else the exact IoU (``rotated_iou_ops``): K10's data-dependent
    bound."""
    by_z, by_circle = iou3d_early_outs(boxes1, boxes2)
    cols = [0, 1, 3, 4, 6]
    a = boxes1[..., cols].float()
    b = boxes2[..., cols].float()
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    n, m = a.shape[-2], b.shape[-2]
    rest = torch.nonzero(~by_z & ~by_circle, as_tuple=True)
    ai = a.expand(lead + (n, 5))[rest[:-1]][:, None]
    bj = b.expand(lead + (m, 5))[rest[:-2] + rest[-1:]][:, None]
    touch = rotated_rect_intersection_area(ai, bj)[:, 0, 0] > 0
    n_circle = int((by_circle & ~by_z).sum())
    return (IOU3D_Z_OPS * int(by_z.sum()) + NMS_CIRCLE_OPS * n_circle +
            NMS_SAT_OPS * int((~touch).sum()) +
            int(rotated_iou_ops(ai[touch], bj[touch]).sum()))


def nms_bev_ops(boxes_bev: torch.Tensor) -> int:
    """float32 operations of one IoU per unordered pair of each sample's
    (B, K, 5) boxes: K10-NMS's bound if every pair were computed (the
    greedy pass is bit operations)."""
    per_pair = rotated_iou_ops(boxes_bev, boxes_bev)
    return int(torch.triu(per_pair, diagonal=1).sum())


def bev_circles_meet(boxes_bev: torch.Tensor) -> torch.Tensor:
    """(..., K, K) bool: the circle test of K10-NMS's pairwise pass on
    (..., K, 5) BEV boxes, in its float32 arithmetic. Each box reaches
    0.5 hypot(dx, dy) + 1e-5 / |dx| + 1e-5 / |dy| from its centre; a pair
    meets unless its centres are more than (reach_a + reach_b) (1 + 1e-4)
    + 1e-3 apart (NaN meets). Where it is false the intersection area is
    0."""
    b = boxes_bev.float()
    dx, dy = b[..., 2], b[..., 3]
    reach = 0.5 * torch.hypot(dx, dy) + NMS_QUAD_TOL / dx.abs() + \
        NMS_QUAD_TOL / dy.abs()
    d = b[..., None, :, :2] - b[..., :, None, :2]
    lim = (reach[..., :, None] + reach[..., None, :]) * NMS_CUT_REL + \
        NMS_CUT_ABS
    return ~(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] > lim * lim)


def nms_bev_cut_ops(boxes_bev: torch.Tensor) -> int:
    """float32 operations of K10-NMS's pairwise pass as designed on these
    (B, K, 5) boxes: the circle test for every unordered pair, the IoU
    (``rotated_iou_ops``) for the pairs whose circles meet."""
    b = boxes_bev.float()
    k = b.shape[-2]
    s, i, j = torch.nonzero(torch.triu(bev_circles_meet(b), diagonal=1),
                            as_tuple=True)
    return NMS_CIRCLE_OPS * (b.shape[0] * k * (k - 1) // 2) + int(
        rotated_iou_ops(b[s, i][:, None], b[s, j][:, None]).sum())


def nms_bev_needed_ops(boxes_bev: torch.Tensor, thresh: float) -> int:
    """float32 operations that settle every bit (IoU > ``thresh``) of
    these (B, K, 5) boxes' unordered pairs, each pair by its cheapest
    certificate: the area ratio where min / max area <= thresh, else the
    circle test where the circles are apart, else a separating-axis test
    where the plain intersection area (in the lower-index box's frame, as
    the kernel) is 0, else the IoU (``rotated_iou_ops``): K10-NMS's
    data-dependent bound."""
    b = boxes_bev.float()
    area = b[..., 2] * b[..., 3]
    lo_a, hi_a = area[..., :, None], area[..., None, :]
    by_ratio = torch.triu(torch.minimum(lo_a, hi_a) <=
                          thresh * torch.maximum(lo_a, hi_a), diagonal=1)
    n_ratio = int(by_ratio.sum())
    k = b.shape[-2]
    s, i, j = torch.nonzero(torch.triu(bev_circles_meet(b), diagonal=1) &
                            ~by_ratio, as_tuple=True)
    lo, hi = b[s, i][:, None], b[s, j][:, None]
    n_circle = b.shape[0] * k * (k - 1) // 2 - n_ratio - len(s)
    touch = rotated_rect_intersection_area(lo, hi)[:, 0, 0] > 0
    return (NMS_RATIO_OPS * n_ratio + NMS_CIRCLE_OPS * n_circle +
            NMS_SAT_OPS * int((~touch).sum()) +
            int(rotated_iou_ops(lo[touch], hi[touch]).sum()))


def _lead_check(name: str, boxes1: torch.Tensor, boxes2: torch.Tensor,
                width: int = 7):
    s1, s2 = boxes1.shape, boxes2.shape
    if len(s1) < 2 or len(s1) != len(s2) or s1[:-2] != s2[:-2] or \
            s1[-1] < width or s2[-1] < width:
        raise ValueError(f"{name}: boxes (..., N, >={width}) and (..., M, "
                         f">={width}) with equal leading dims, got "
                         f"{tuple(boxes1.shape)} and {tuple(boxes2.shape)}")
    if boxes1.device != boxes2.device:
        raise ValueError(f"{name}: boxes on different devices")


def _raw_stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer (one call
    into the C++ runtime: a wrapper's host time bounds these kernels)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _iou_rows(boxes: torch.Tensor, n: int, width: int = 7) -> torch.Tensor:
    """(S, n, >=width) float32 rows of unit element stride: a view of
    ``boxes`` where one exists, else a copy."""
    if boxes.dim() == 3 and boxes.dtype == torch.float32 and \
            boxes.stride(-1) == 1:
        return boxes
    x = boxes.float().reshape(-1, n, boxes.shape[-1])
    return x if x.stride(-1) == 1 else x[..., :width].contiguous()


def _launch_pairwise(name: str, boxes1: torch.Tensor, boxes2: torch.Tensor,
                     width: int) -> torch.Tensor:
    """(..., N, M) float32 from kernel ``name`` (K10 or K10-BEV), which
    reads rows of ``width`` or more floats through their batch and row
    strides: float32 rows with unit element stride are not copied. K10-BEV
    also takes a list scratch: its count, then one int64 an output."""
    lead = boxes1.shape[:-2]
    n, m = boxes1.shape[-2], boxes2.shape[-2]
    a, b = (_iou_rows(x, k, width) for x, k in ((boxes1, n), (boxes2, m)))
    out = torch.empty((a.shape[0], n, m), dtype=torch.float32,
                      device=a.device)
    if out.numel() == 0:
        return out.view(lead + (n, m))
    lib = cuda_build.load(name)
    stream = _raw_stream(a)
    strides = (ctypes.c_longlong * 4)(*(a.stride()[:2] + b.stride()[:2]))
    extra = ()
    if name == "boxes_iou_bev":
        scratch = torch.empty(1 + out.numel(), dtype=torch.int64,
                              device=a.device)
        extra = (scratch.data_ptr(),)
    err = getattr(lib, name)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             a.shape[0], n, m, strides, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    cuda_build.LAUNCHES[name] += 1
    return out.view(lead + (n, m))


def boxes_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, M) float32 3D IoU of LiDAR boxes (``BboxOverlaps3D``),
    one kernel launch for all leading (batch) dims."""
    _lead_check("boxes_iou_3d", boxes1, boxes2)
    if boxes1.device.type == "cpu":
        return boxes_iou_3d_ref(boxes1, boxes2)
    if boxes1.device.type != "cuda":
        raise RuntimeError(f"boxes_iou_3d: no kernel for {boxes1.device}")
    return _launch_pairwise("boxes_iou_3d", boxes1, boxes2, 7)


def boxes_iou_bev(boxes1_bev: torch.Tensor, boxes2_bev: torch.Tensor
                  ) -> torch.Tensor:
    """(..., N, M) float32 IoU of rotated BEV boxes (x, y, dx, dy, yaw[,
    ...]; the first five columns), all leading dims at once: the list
    count's memset, the tile kernel and the drain kernel."""
    _lead_check("boxes_iou_bev", boxes1_bev, boxes2_bev, 5)
    if boxes1_bev.device.type == "cpu":
        return boxes_iou_bev_ref(boxes1_bev[..., :5], boxes2_bev[..., :5])
    if boxes1_bev.device.type != "cuda":
        raise RuntimeError(f"boxes_iou_bev: no kernel for "
                           f"{boxes1_bev.device}")
    return _launch_pairwise("boxes_iou_bev", boxes1_bev, boxes2_bev, 5)


def _nms_args(boxes_bev: torch.Tensor, scores: torch.Tensor,
              valid: Optional[torch.Tensor]):
    if boxes_bev.dim() != 3 or boxes_bev.shape[-1] != 5:
        raise ValueError(f"nms_bev_mask: boxes (B, K, 5), got "
                         f"{tuple(boxes_bev.shape)}")
    return _nms_order(boxes_bev, scores, valid)


def _nms_order(lead: torch.Tensor, scores: torch.Tensor,
               valid: Optional[torch.Tensor]):
    """(valid, order) for scores (B, C, K) over the (B, K, ...) ``lead``
    tensor (boxes or a suppression matrix)."""
    if scores.dim() != 3 or scores.shape[0] != lead.shape[0] or \
            scores.shape[2] != lead.shape[1]:
        raise ValueError(f"nms: scores (B, C, K) for (B, K, ...) boxes, "
                         f"got {tuple(scores.shape)} and "
                         f"{tuple(lead.shape)}")
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    if valid.shape != scores.shape:
        raise ValueError("nms: valid must have the scores' shape")
    if len({lead.device, scores.device, valid.device}) != 1:
        raise ValueError("nms: inputs on different devices")
    # descending scores, ties keep the lower index first (jnp.argsort of
    # the negated scores, as the JAX package orders them)
    order = torch.sort(scores.float(), dim=-1, descending=True,
                       stable=True).indices
    return valid.bool(), order


def nms_bev_mask_ref(boxes_bev: torch.Tensor, scores: torch.Tensor,
                     thresh: float, valid: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Plain PyTorch version of ``nms_bev_mask``: the plain BEV IoU and a
    sequential greedy walk per sample and class."""
    _nms_args(boxes_bev, scores, valid)
    return greedy_suppress_ref(
        boxes_iou_bev_ref(boxes_bev, boxes_bev) > thresh, scores, valid)


def greedy_suppress_ref(suppress: torch.Tensor, scores: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(B, C, K) keep masks of the greedy walk (``_greedy_suppress``)
    over a given (B, K, K) bool suppression matrix, bit (i, j) = box i
    suppresses box j: by descending score (ties: lower index first), a
    valid box that no kept box suppresses is kept."""
    if suppress.dim() != 3 or suppress.shape[1] != suppress.shape[2]:
        raise ValueError(f"greedy_suppress_ref: suppression (B, K, K), got "
                         f"{tuple(suppress.shape)}")
    valid, order = _nms_order(suppress, scores, valid)
    keep = torch.zeros_like(valid)
    for b in range(scores.shape[0]):
        for c in range(scores.shape[1]):
            removed = torch.zeros_like(valid[b, c])
            ok = valid[b, c].tolist()
            for i in order[b, c].tolist():
                if ok[i] and not bool(removed[i]):
                    keep[b, c, i] = True
                    removed |= suppress[b, i]
    return keep


def nms_bev_mask(boxes_bev: torch.Tensor, scores: torch.Tensor,
                 thresh: float, valid: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """(B, C, K) bool keep masks of greedy rotated-BEV NMS over (B, K, 5)
    boxes shared by C score rows per sample (``nms_gpu`` semantics:
    ``iou > thresh`` suppresses); one kernel launch for the batch."""
    valid, order = _nms_args(boxes_bev, scores, valid)
    if boxes_bev.device.type == "cpu":
        return nms_bev_mask_ref(boxes_bev, scores, thresh, valid)
    if boxes_bev.device.type != "cuda":
        raise RuntimeError(f"nms_bev_mask: no kernel for {boxes_bev.device}")
    b, c, k = scores.shape
    keep = torch.empty((b, c, k), dtype=torch.bool, device=scores.device)
    if keep.numel() == 0:
        return keep
    # the kernel reads the sort's int64 order and the bool (one byte) valid
    # in their own strides: no conversion or copy is launched
    _launch_nms(boxes_bev, order, valid, keep, c, thresh, True)
    return keep


def _greedy_capacity(name: str, b: int, c: int, k: int) -> None:
    """Raise unless the NMS kernels take B samples of C classes of K
    boxes: at most ``NMS_MAX_SAMPLES`` samples (the pairwise passes'
    grids), 2^31 - 1 (sample, class) blocks and ``greedy_smem_bytes(K)``
    within ``NMS_SMEM_BYTES`` (the greedy pass)."""
    if b > NMS_MAX_SAMPLES or b * c > 2 ** 31 - 1 or \
            greedy_smem_bytes(k) > NMS_SMEM_BYTES:
        raise ValueError(f"{name}: at most {NMS_MAX_SAMPLES} samples, 2^31 "
                         f"- 1 (sample, class) pairs and {NMS_SMEM_BYTES} "
                         f"bytes of shared memory a class (4,112 + 8 "
                         f"ceil(K / 64)), got B = {b}, C = {c}, K = {k}")


def _launch_nms(boxes_bev, order, valid, keep, c, thresh, greedy):
    b, k = boxes_bev.shape[:2]
    _greedy_capacity("nms_bev_mask", b, c, k)
    boxes = boxes_bev.float().contiguous()
    mask = torch.empty((b, k, (k + 63) // 64), dtype=torch.int64,
                       device=boxes.device)
    lib = cuda_build.load("nms_bev")
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    strides = (ctypes.c_longlong * 6)(
        *(order.stride() + valid.stride() if greedy else (0,) * 6))
    err = lib.nms_bev(boxes.data_ptr(), ptr(order), ptr(valid),
                      mask.data_ptr(), ptr(keep), b, c, k, float(thresh),
                      int(greedy), strides, stream)
    if err != 0:
        raise RuntimeError(f"nms_bev: kernel launch failed with CUDA error "
                           f"{err}")
    cuda_build.LAUNCHES["nms_bev"] += 1
    return mask


def nms_bev_suppression_bits(boxes_bev: torch.Tensor, thresh: float
                             ) -> torch.Tensor:
    """(B, K, K) bool: the K10-NMS kernel's pairwise pass alone, bit
    (i, j) = BEV IoU(i, j) > thresh, unpacked from its (B, K, ceil(K /
    64)) words (CUDA tensors only; the check of the kernel's geometry
    against ``boxes_iou_bev_ref``)."""
    if boxes_bev.device.type != "cuda" or boxes_bev.dim() != 3 or \
            boxes_bev.shape[-1] != 5:
        raise ValueError("nms_bev_suppression_bits: (B, K, 5) boxes on the "
                         "card")
    k = boxes_bev.shape[1]
    words = _launch_nms(boxes_bev, None, None, None, 1, thresh, False)
    shift = torch.arange(64, device=words.device)
    bits = (words[..., None] >> shift) & 1
    return bits.reshape(words.shape[0], k, -1)[..., :k].bool()


def iou_bev_tame(boxes_bev: torch.Tensor) -> torch.Tensor:
    """(..., N) bool: the BEV boxes K10-BEV may cut, every value finite and
    |x|, |y|, |dx|, |dy| <= ``IOU3D_TAME``."""
    b = boxes_bev[..., :5].float()
    return (b[..., :4].abs() <= IOU3D_TAME).all(-1) & torch.isfinite(
        b[..., 4])


def iou_bev_cut(boxes1_bev: torch.Tensor, boxes2_bev: torch.Tensor
                ) -> torch.Tensor:
    """(..., N, M) bool: the pairs K10-BEV's kernel settles as IoU 0
    without the exact intersection, in its float32 arithmetic: both boxes
    tame (``iou_bev_tame``) and their bounding circles apart
    (``_circles_apart``)."""
    a, b = boxes1_bev[..., :4].float(), boxes2_bev[..., :4].float()
    tame = iou_bev_tame(boxes1_bev)[..., :, None] & \
        iou_bev_tame(boxes2_bev)[..., None, :]
    return tame & _circles_apart(a, b)


def iou_tile_counts(listed: torch.Tensor) -> torch.Tensor:
    """(T,) int64: the listed pairs (``listed`` (..., N, M) bool, the pairs
    no exact cut settles) in each 16 x 32 tile of K10's kernel, every
    leading index its own tiles."""
    n, m = listed.shape[-2:]
    x = listed.reshape(-1, n, m).long()
    x = torch.nn.functional.pad(x, (0, -m % 32, 0, -n % 16))
    return x.reshape(x.shape[0], x.shape[1] // 16, 16, x.shape[2] // 32,
                     32).sum((2, 4)).reshape(-1)


def iou_bev_needed_ops(boxes1_bev: torch.Tensor, boxes2_bev: torch.Tensor
                       ) -> int:
    """float32 operations that settle every pair of these BEV boxes, each
    by its cheapest certificate: the circle test where the circles are
    apart, else a separating-axis test where the plain intersection area is
    0, else the exact IoU (``rotated_iou_ops``): K10-BEV's data-dependent
    bound."""
    cut = iou_bev_cut(boxes1_bev, boxes2_bev)
    a, b = boxes1_bev[..., :5].float(), boxes2_bev[..., :5].float()
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    n, m = a.shape[-2], b.shape[-2]
    rest = torch.nonzero(~cut, as_tuple=True)
    ai = a.expand(lead + (n, 5))[rest[:-1]][:, None]
    bj = b.expand(lead + (m, 5))[rest[:-2] + rest[-1:]][:, None]
    touch = rotated_rect_intersection_area(ai, bj)[:, 0, 0] > 0
    return (NMS_CIRCLE_OPS * int(cut.sum()) + NMS_SAT_OPS *
            int((~touch).sum()) + int(rotated_iou_ops(ai[touch],
                                                      bj[touch]).sum()))


# K10-normal's IoU of a pair: two max, two min, two differences, two
# clamps, the product, the union's sum, difference and floor, the ratio
# and the comparison
NORMAL_OPS_PER_PAIR = 15


def normal_iou_ref(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """(B, K, K) float32 axis-aligned IoU of each sample's (x1, y1, x2, y2)
    boxes, in the JAX package's order of operations (``nms_normal_bev_
    mask``: areas and the intersection's sides clamped at 0, the union
    floored at 1e-8)."""
    b = boxes_xyxy.float()
    area = (b[..., 2] - b[..., 0]).clamp_min(0) * \
        (b[..., 3] - b[..., 1]).clamp_min(0)
    x1 = torch.maximum(b[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(b[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(b[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(b[..., :, None, 3], b[..., None, :, 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    return inter / (area[..., :, None] + area[..., None, :] -
                    inter).clamp_min(1e-8)


def _normal_args(boxes_xyxy, scores, valid):
    if boxes_xyxy.dim() != 3 or boxes_xyxy.shape[-1] != 4:
        raise ValueError(f"nms_normal_bev_mask: boxes (B, K, 4), got "
                         f"{tuple(boxes_xyxy.shape)}")
    return _nms_order(boxes_xyxy, scores, valid)


def nms_normal_bev_mask_ref(boxes_xyxy: torch.Tensor, scores: torch.Tensor,
                            thresh: float,
                            valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of ``nms_normal_bev_mask``: the plain
    axis-aligned IoU and a sequential greedy walk per sample and class."""
    _normal_args(boxes_xyxy, scores, valid)
    return greedy_suppress_ref(normal_iou_ref(boxes_xyxy) > thresh, scores,
                               valid)


def nms_normal_bev_mask(boxes_xyxy: torch.Tensor, scores: torch.Tensor,
                        thresh: float, valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(B, C, K) bool keep masks of greedy axis-aligned BEV NMS over (B, K,
    4) boxes (x1, y1, x2, y2) shared by C score rows per sample
    (``nms_normal_gpu`` semantics: ``iou > thresh`` suppresses); one
    pairwise and one greedy launch for the batch."""
    valid, order = _normal_args(boxes_xyxy, scores, valid)
    if boxes_xyxy.device.type == "cpu":
        return nms_normal_bev_mask_ref(boxes_xyxy, scores, thresh, valid)
    if boxes_xyxy.device.type != "cuda":
        raise RuntimeError(f"nms_normal_bev_mask: no kernel for "
                           f"{boxes_xyxy.device}")
    b, c, k = scores.shape
    keep = torch.empty((b, c, k), dtype=torch.bool, device=scores.device)
    if keep.numel() == 0:
        return keep
    _greedy_capacity("nms_normal_bev_mask", b, c, k)
    # the kernel reads (x1, y1, x2, y2) as one 16-byte vector a box
    boxes = boxes_xyxy.float().contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    mask = torch.empty((b, k, (k + 63) // 64), dtype=torch.int64,
                       device=boxes.device)
    strides = (ctypes.c_longlong * 6)(*(order.stride() + valid.stride()))
    err = cuda_build.load("nms_normal_bev").nms_normal_bev(
        boxes.data_ptr(), order.data_ptr(), valid.data_ptr(),
        mask.data_ptr(), keep.data_ptr(), b, c, k, float(thresh), strides,
        _raw_stream(boxes))
    if err != 0:
        raise RuntimeError(f"nms_normal_bev: kernel launch failed with CUDA "
                           f"error {err}")
    cuda_build.LAUNCHES["nms_normal_bev"] += 1
    return keep


# K10-circle's pairwise pass: a squared distance and a comparison per pair
# (2 differences, 2 products, a sum, the comparison)
CIRCLE_OPS_PER_PAIR = 6
# the fused kernel holds a set's upper-triangle suppression words, its
# sorted centres, indices and valid flags in one block's shared memory
# (csrc/nms_circle.cu): at most 28 words a row, K <= 1,792; larger sets
# take the pairwise and greedy passes (``nms_circle_pairwise``)
CIRCLE_MAX_BOXES = 1792


def circle_kernel(k: int) -> str:
    """The kernel (``cuda_build.LAUNCHES`` key) that ``circle_nms_mask``
    launches for sets of K boxes: the one-launch kernel up to
    ``CIRCLE_MAX_BOXES``, the pairwise and greedy passes past it."""
    return "nms_circle" if k <= CIRCLE_MAX_BOXES else "nms_circle_pairwise"


def circle_nms_ops(sets: int, k: int) -> int:
    """float32 operations of K10-circle's suppression bits on ``sets``
    sets of K boxes: one squared distance per unordered pair (the greedy
    pass is bit operations)."""
    return CIRCLE_OPS_PER_PAIR * sets * (k * (k - 1) // 2)


def circle_order_ops(sets: int, k: int) -> int:
    """Comparisons that order ``sets`` sets of K scores: K ceil(log2 K) a
    set (a comparison sort's)."""
    return sets * k * max(math.ceil(math.log2(k)), 0) if k > 0 else 0


def circle_smem_bytes(k: int) -> int:
    """Shared memory of K10-circle's block for a set of K boxes: 256 W (W
    + 1) bytes of bits and 720 W of sorted arrays, removed words and
    chunk counts, W = ceil(K / 64)."""
    w = (k + 63) // 64
    return 256 * w * (w + 1) + 720 * w


def _circle_args(centers: torch.Tensor, scores: torch.Tensor, thresh,
                 valid: Optional[torch.Tensor]):
    """(thresholds (R,) float32, valid (R, K) bool) for the plain
    version."""
    _circle_shapes(centers, scores, valid)
    thr = torch.as_tensor(thresh, dtype=torch.float32).to(centers.device)
    thr = thr.expand(scores.shape[0]) if thr.dim() == 0 else thr
    if thr.shape != scores.shape[:1]:
        raise ValueError(f"circle_nms_mask: one threshold per set, got "
                         f"{tuple(thr.shape)} for {scores.shape[0]} sets")
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    return thr, valid.bool()


def _circle_shapes(centers, scores, valid):
    cs = centers.shape
    if len(cs) != 3 or cs[2] != 2 or scores.shape != cs[:2]:
        raise ValueError(f"circle_nms_mask: centres (R, K, 2) and scores "
                         f"(R, K), got {tuple(centers.shape)} and "
                         f"{tuple(scores.shape)}")
    if valid is not None and valid.shape != scores.shape:
        raise ValueError("nms: valid must have the scores' shape")
    if centers.device != scores.device or (
            valid is not None and valid.device != centers.device):
        raise ValueError("nms: inputs on different devices")


def circle_nms_mask_ref(centers: torch.Tensor, scores: torch.Tensor,
                        thresh, valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of ``circle_nms_mask``: the squared centre
    distances (x_j - x_i)^2 + (y_j - y_i)^2 in float32, each step rounded
    as the kernel rounds it, and the sequential greedy walk per set."""
    thr, valid = _circle_args(centers, scores, thresh, valid)
    c = centers.float()
    d = c[:, None, :, :] - c[:, :, None, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return greedy_suppress_ref(d2 <= thr[:, None, None], scores[:, None],
                               valid[:, None])[:, 0]


def circle_nms_mask(centers: torch.Tensor, scores: torch.Tensor, thresh,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, K) bool keep masks of greedy circle NMS over R independent sets
    of K boxes' (x, y) centres: a kept box suppresses every later box
    whose squared centre distance to it is <= the set's threshold
    (``thresh``: a number or one per set); up to ``CIRCLE_MAX_BOXES``
    boxes a set, one kernel launch for all sets and, for float32 centres,
    scores and thresholds and bool valid flags on the card, no other
    device operation (any strides); past it the score sort, the pairwise
    pass and the greedy pass (``nms_circle_pairwise``)."""
    if centers.device.type == "cpu":
        return circle_nms_mask_ref(centers, scores, thresh, valid)
    if centers.device.type != "cuda":
        raise RuntimeError(f"circle_nms_mask: no kernel for "
                           f"{centers.device}")
    _circle_shapes(centers, scores, valid)
    r, k = scores.shape
    thr_value = 0.0
    if isinstance(thresh, (int, float)):
        thr, thr_value = None, float(thresh)
    elif isinstance(thresh, torch.Tensor) and thresh.shape == (r,) and \
            thresh.dtype == torch.float32 and thresh.device == centers.device:
        thr = thresh
    else:
        thr = torch.as_tensor(thresh, device=centers.device,
                              dtype=torch.float32)
        if thr.dim() == 0:
            thr = thr.expand(r)
        if thr.shape != (r,):
            raise ValueError(f"circle_nms_mask: one threshold per set, got "
                             f"{tuple(thr.shape)} for {r} sets")
    if r > 2 ** 31 - 1:
        raise ValueError(f"circle_nms_mask: at most 2^31 - 1 sets, got "
                         f"R = {r}")
    keep = torch.empty((r, k), dtype=torch.bool, device=scores.device)
    if keep.numel() == 0:
        return keep
    c = centers if centers.dtype == torch.float32 else centers.float()
    s = scores if scores.dtype == torch.float32 else scores.float()
    v = valid if valid is None or valid.dtype == torch.bool else valid.bool()
    if circle_kernel(k) == "nms_circle_pairwise":
        _circle_wide(c, s, v, thr, thr_value, keep)
        return keep
    strides = (ctypes.c_longlong * 8)(
        *c.stride(), *s.stride(), *(v.stride() if v is not None else (0, 0)),
        thr.stride(0) if thr is not None else 0)
    lib = cuda_build.load("nms_circle")
    err = lib.nms_circle(c.data_ptr(), s.data_ptr(),
                         0 if v is None else v.data_ptr(),
                         0 if thr is None else thr.data_ptr(), thr_value,
                         keep.data_ptr(), r, k, strides, _raw_stream(c))
    if err != 0:
        raise RuntimeError(f"nms_circle: kernel launch failed with CUDA "
                           f"error {err}")
    cuda_build.LAUNCHES["nms_circle"] += 1
    return keep


def _circle_wide(c, s, v, thr, thr_value: float, keep) -> None:
    """K10-circle past ``CIRCLE_MAX_BOXES`` boxes a set: the stable
    descending score order (``torch.sort``, as the plain version orders
    them), then the pairwise and greedy passes (``nms_circle_pairwise``)
    into ``keep``."""
    r, k = s.shape
    _greedy_capacity("circle_nms_mask", r, 1, k)
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    mask = torch.empty((r, k, (k + 63) // 64), dtype=torch.int64,
                       device=c.device)
    strides = (ctypes.c_longlong * 8)(
        *c.stride(), *order.stride(),
        *(v.stride() if v is not None else (0, 0)),
        thr.stride(0) if thr is not None else 0)
    err = cuda_build.load("nms_circle_pairwise").nms_circle_pairwise(
        c.data_ptr(), order.data_ptr(), 0 if v is None else v.data_ptr(),
        0 if thr is None else thr.data_ptr(), thr_value, mask.data_ptr(),
        keep.data_ptr(), r, k, strides, _raw_stream(c))
    if err != 0:
        raise RuntimeError(f"nms_circle_pairwise: kernel launch failed with "
                           f"CUDA error {err}")
    cuda_build.LAUNCHES["nms_circle_pairwise"] += 1
