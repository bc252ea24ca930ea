"""Helpers shared by the port's checks (``chip_smoke.py``,
``tests/test_torch_cuda.py`` and the CPU tests): what makes a
PointPillars or CenterPoint prediction on the card comparable with the
same prediction on the CPU, the box sets that K10, K10-NMS and
K10-circle are held on, MVX-Net's KITTI-like camera and the voxel sets
that K1 (dynamic voxelization) is held on, ``pinned_choices``, which
makes two runs of one detector take the same discrete choices,
``pooled_sync_norms``, the one-card reference of a data-parallel step,
``recording_eval_ious``, which keeps the KITTI evaluator's IoU
inputs, ``point_op_sets`` and ``fps_large_cloud``, the clouds that
K14 (the PointNet++ ops) is held on, and ``sst_partition_sets``, the
voxel sets that K17 (SST's window partition and moves) is held on."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def bbox_head(model):
    """A detector's head: ``pts_bbox_head`` (MVX family), ``bbox_head``
    (VoxelNet, FCOS3D) or PartA2's ``rpn_head``."""
    for name in ("pts_bbox_head", "bbox_head", "rpn_head"):
        head = getattr(model, name, None)
        if head is not None:
            return head
    raise AttributeError(f"{type(model).__name__} has no box head")


def _head_convs(model, name: str):
    """The box head's 1x1 convs called ``name`` (one, or one a task for
    ShapeAwareHead)."""
    return [m for n, m in bbox_head(model).named_modules()
            if n.rsplit(".", 1)[-1] == name]


def tame_box_deltas(model, scale: float = 0.01):
    """Scale the Anchor3DHead's box-regression weights by ``scale``.
    Seeded random weights regress size residuals whose exp() decodes to
    boxes far wider than the scene; the NMS over such boxes rests on
    float32 rounding, which the card and the CPU do differently. Scaled,
    the boxes stay near their anchors (scene-sized)."""
    with torch.no_grad():
        for conv in _head_convs(model, "conv_reg"):
            conv.weight.mul_(scale)
    return model


def even_class_prior(model):
    """Zero the Anchor3DHead's class bias (the focal prior puts every
    random-weight score near 0.01, under MVX-Net's 0.1 threshold): the
    scores spread around 0.5 and NMS sees full candidate sets."""
    with torch.no_grad():
        for conv in _head_convs(model, "conv_cls"):
            conv.bias.zero_()
    return model


def pp_kept_boxes(model, batch: dict, dev: str):
    """Every box the model keeps after NMS (``max_num`` lifted so that no
    near-tie decides which ones make the cut), in a canonical order:
    (boxes, scores, sample * C + label) sorted by that key, then by x."""
    head = bbox_head(model)
    cfg = dict(head.test_cfg)
    head.test_cfg["max_num"] = int(cfg.get("nms_pre", 1000)) * \
        head.num_classes
    try:
        out = {k: v.cpu() for k, v in model(batch, device=dev).items()}
    finally:
        head.test_cfg = cfg
    m = out["mask"]
    key = (torch.arange(m.shape[0])[:, None] * head.num_classes +
           out["labels"])[m]
    boxes, scores = out["bboxes"][m], out["scores"][m]
    o = torch.argsort(boxes[:, 0], stable=True)
    o = o[torch.argsort(key[o], stable=True)]
    return boxes[o], scores[o], key[o]


# (dx, dy) of the nuScenes PointPillars config's anchors
# (AlignedAnchor3DRangeGenerator sizes)
NUS_SIZES = ((1.95, 4.60), (2.45, 6.73), (2.90, 12.01), (2.94, 11.20),
             (2.73, 6.38), (0.60, 1.68), (0.77, 2.10), (0.67, 0.73),
             (0.41, 0.41), (2.49, 0.48))


def nms_scene_set(gen, k: int = 1000, c: int = 10):
    """(boxes (1, K, 5), scores (1, C, K), valid) like a detector's NMS
    input at the request's size: K / 10 objects of the ten nuScenes
    classes' sizes over +-50 m, ten jittered proposals each (centre, size
    and yaw noise), the object's class scored highest, the first ten
    scores tied. Seed 3 at (1000, 10) leaves no pair within 1e-5 of the
    0.2 threshold, so the keep masks must equal the plain version's."""
    n = k // 10
    cls = torch.randint(0, 10, (n,), generator=gen)
    obj = torch.empty((n, 5))
    obj[:, :2] = (torch.rand((n, 2), generator=gen) * 2 - 1) * 50
    obj[:, 2:4] = torch.tensor(NUS_SIZES)[cls]
    obj[:, 4] = (torch.rand(n, generator=gen) * 2 - 1) * math.pi
    boxes = obj.repeat_interleave(10, 0)
    boxes[:, :2] += torch.randn((k, 2), generator=gen) * 0.15 * \
        boxes[:, 2:4].max(-1, keepdim=True).values
    boxes[:, 2:4] *= 1 + 0.1 * torch.randn((k, 2), generator=gen)
    boxes[:, 4] += 0.15 * torch.randn(k, generator=gen)
    scores = torch.rand((1, c, k), generator=gen) * 0.3
    own = cls.repeat_interleave(10) % c
    scores[0, own, torch.arange(k)] += 0.6 * torch.rand(k, generator=gen)
    scores[..., :10] = 0.5
    return boxes[None], scores, scores > 0.05


def _scored(gen, boxes, c):
    scores = torch.rand((1, c, boxes.shape[0]), generator=gen)
    return boxes[None], scores, scores > 0.05


def nms_cluster_set(gen, k: int = 1000, c: int = 10):
    """K boxes of sides 2.2-4.6 m with centres within a 3 m disc: every
    pair's bounding circles meet (the circle cut cuts nothing)."""
    boxes = torch.empty((k, 5))
    r = 1.5 * torch.rand(k, generator=gen).sqrt()
    t = torch.rand(k, generator=gen) * 2 * math.pi
    boxes[:, 0], boxes[:, 1] = r * torch.cos(t), r * torch.sin(t)
    boxes[:, 2:4] = 2.2 + 2.4 * torch.rand((k, 2), generator=gen)
    boxes[:, 4] = (torch.rand(k, generator=gen) * 2 - 1) * math.pi
    return _scored(gen, boxes, c)


def nms_sparse_set(gen, k: int = 1000, c: int = 10):
    """K boxes of sides 0.5-4.6 m on a 10 m grid, centres jittered by up
    to 0.5 m: no two boxes' bounding circles meet (only the diagonal is
    computed)."""
    side = math.ceil(math.sqrt(k))
    i = torch.arange(k)
    boxes = torch.empty((k, 5))
    boxes[:, 0] = (i % side).float() * 10 - 150
    boxes[:, 1] = (i // side).float() * 10 - 150
    boxes[:, :2] += (torch.rand((k, 2), generator=gen) - 0.5)
    boxes[:, 2:4] = 0.5 + 4.1 * torch.rand((k, 2), generator=gen)
    boxes[:, 4] = (torch.rand(k, generator=gen) * 2 - 1) * math.pi
    return _scored(gen, boxes, c)


def cp_kept_boxes(model, batch: dict, dev: str):
    """Every box a CenterPoint model keeps after circle NMS
    (``post_max_size`` lifted to the coder's ``max_num``, so that no
    near-tie decides which ones make the cut), in a canonical order:
    (boxes, scores, sample * C + label) sorted by that key, then by x."""
    head = bbox_head(model)
    cfg = dict(head.test_cfg)
    head.test_cfg["post_max_size"] = head.bbox_coder.max_num
    try:
        out = {k: v.cpu() for k, v in model(batch, device=dev).items()}
    finally:
        head.test_cfg = cfg
    m = out["mask"]
    key = (torch.arange(m.shape[0])[:, None] * head.task_offsets[-1] +
           out["labels"])[m]
    boxes, scores = out["bboxes"][m], out["scores"][m]
    o = torch.argsort(boxes[:, 0], stable=True)
    o = o[torch.argsort(key[o], stable=True)]
    return boxes[o], scores[o], key[o]


def circle_nms_sets(gen, r: int, k: int, thresholds=(0.25, 1.0, 4.0, 12.0)):
    """(centres (R, K, 2), scores (R, K), valid (R, K), thresholds (R,))
    for K10-circle: centres on a 0.5 m lattice over +-8 m (every squared
    distance is exact, so many pairs lie exactly on the thresholds),
    scores in steps of 0.1 (ties), 10% invalid; set r takes threshold r
    (mod the list)."""
    centers = torch.round((torch.rand((r, k, 2), generator=gen) * 2 - 1) *
                          16) * 0.5
    scores = torch.round(torch.rand((r, k), generator=gen) * 10) / 10
    valid = torch.rand((r, k), generator=gen) > 0.1
    thr = torch.tensor([thresholds[i % len(thresholds)] for i in range(r)])
    return centers, scores, valid, thr


def circle_nms_adversarial_sets(gen):
    """(name, centres (1, K, 2), scores (1, K), valid (1, K), threshold
    (1,)) sets: identical centres, all within the radius, none within,
    pairs exactly on the threshold (centres 2.0 apart against 4.0), equal
    scores, all invalid and a single box."""
    def one(name, c, scores=None, valid=None, thr=4.0):
        k = c.shape[0]
        s = torch.rand((1, k), generator=gen) if scores is None else scores
        v = torch.ones((1, k), dtype=torch.bool) if valid is None else valid
        return name, c[None].float(), s, v, torch.tensor([thr])

    lattice = torch.stack(torch.meshgrid(torch.arange(16.0),
                                         torch.arange(16.0), indexing="ij"),
                          -1).reshape(-1, 2)
    # a 1.4 m square: every squared distance under 4
    disc = (torch.rand((64, 2), generator=gen) - 0.5) * 1.4
    return [one("identical", torch.full((64, 2), 3.0)),
            one("all_within", disc),
            one("none_within", lattice * 10.0),
            one("on_threshold", lattice * 2.0),
            one("equal_scores", lattice * 1.5,
                scores=torch.full((1, 256), 0.5)),
            one("all_invalid", disc, valid=torch.zeros((1, 64),
                                                       dtype=torch.bool)),
            one("single_box", torch.zeros((1, 2)))]


def iou_test_boxes(gen, n: int = 200, m: int = 64):
    """(a (n, 7), b (m, 7), rows of a copied into b[:8]) at flagship
    range: b holds 8 copies of boxes of a (identical), 8 rotated copies,
    8 nested (shrunk) copies, 8 disjoint boxes and 32 jittered copies."""
    a = torch.empty((n, 7))
    a[:, :2] = (torch.rand((n, 2), generator=gen) * 2 - 1) * 48
    a[:, 2] = -1 - torch.rand(n, generator=gen)
    a[:, 3:6] = 0.5 + torch.rand((n, 3), generator=gen) * 4.5
    a[:, 6] = (torch.rand(n, generator=gen) * 2 - 1) * 3.14159
    src = torch.randperm(n, generator=gen)[:m]
    pick = a[src].clone()
    pick[8:16, 6] += 0.7                       # rotated
    pick[16:24, 3:6] *= 0.5                    # nested
    pick[16:24, 2] += 0.1
    pick[24:32, :2] += 500.0                   # disjoint
    pick[32:] += torch.randn((m - 32, 7), generator=gen) * 0.3
    pick[32:, 3:6] = pick[32:, 3:6].abs() + 0.1
    return a, pick, src[:8]


def iou_edge_sets():
    """(name, a (N, 7), b (M, 7)) box sets for K10's exact cuts, boxes
    (x, y, z_bottom, dx, dy, dz, yaw): side by side along an edge and
    corner to corner at gaps from -1e-3 to 1e-2 m (at several yaws),
    nested, identical, rotated by 45 degrees, stacked in z (b's bottom
    exactly on a's top, and 1 cm above), and far apart."""
    gaps = (-1e-3, 0.0, 1e-6, 1e-4, 1e-2)
    sizes = ((4.6, 1.95, 1.7), (0.7, 0.7, 1.8), (1e-3, 2.0, 1.0))
    edge_a, edge_b, corner_a, corner_b = [], [], [], []
    for dx, dy, dz in sizes:
        for yaw in (0.0, 0.3, math.pi / 4):
            c, s = math.cos(yaw), math.sin(yaw)
            for g in gaps:
                step = dx + g
                edge_a.append([3.0, 2.0, -1.0, dx, dy, dz, yaw])
                edge_b.append([3.0 + step * c, 2.0 - step * s, -1.0, dx, dy,
                               dz, yaw])
        r = 0.5 * math.hypot(dx, dy)
        yaw = math.atan2(dy, dx)
        for g in gaps:
            corner_a.append([-20.0, 5.0, -1.5, dx, dy, dz, yaw])
            corner_b.append([-20.0 + 2 * r + g, 5.0, -1.5, dx, dy, dz, yaw])
    base = torch.tensor([[3.0, -2.0, -1.0, 4.0, 2.0, 1.5, 0.3],
                         [-30.0, 12.0, -1.8, 1.0, 0.8, 1.7, -2.0],
                         [45.0, 45.0, -0.5, 10.0, 2.9, 3.4, 1.2]])
    k = torch.arange(16, dtype=torch.float32)
    nested = base[:1].repeat(16, 1)
    nested[:, 3:6] *= (0.9 ** k)[:, None]
    rot45 = base.clone()
    rot45[:, 6] += math.pi / 4
    stacked = torch.cat([base, base])
    stacked[:3, 2] = base[:, 2] + base[:, 5]          # on a's top
    stacked[3:, 2] = base[:, 2] + base[:, 5] + 0.01   # 1 cm above
    far = base.clone()
    far[:, :2] += 500.0
    t = torch.tensor
    return [("touching_edges", t(edge_a), t(edge_b)),
            ("touching_corners", t(corner_a), t(corner_b)),
            ("nested", base[:1], nested),
            ("identical", base, base.clone()),
            ("rotated_45", base, rot45),
            ("z_stacked", base, stacked),
            ("far_apart", base, far)]


def iou_bev_edge_sets():
    """(name, a (N, 5), b (M, 5)) BEV box sets (x, y, dx, dy, yaw) for
    K10-BEV: those of ``iou_edge_sets`` (touching along an edge or at a
    corner at gaps from -1e-3 to 1e-2 m, nested, identical, rotated by 45
    degrees, far apart), zero-size boxes (a side or both 0, on and off
    other boxes), and yaws near 1e4 rad (equal modulo 2 pi to small ones,
    and not)."""
    cols = [0, 1, 3, 4, 6]
    sets = [(name, a[:, cols], b[:, cols]) for name, a, b in iou_edge_sets()
            if name != "z_stacked"]
    base = torch.tensor([[3.0, -2.0, 4.0, 2.0, 0.3],
                         [-30.0, 12.0, 1.0, 0.8, -2.0],
                         [45.0, 45.0, 10.0, 2.9, 1.2]])
    zero = base.repeat(3, 1)
    zero[:3, 2] = 0.0                  # no length
    zero[3:6, 3] = 0.0                 # no width
    zero[6:, 2:4] = 0.0                # a point
    zero[::2, :2] += 0.5               # half of them off the centre
    turns = 2 * math.pi * 1591.0       # ~1e4 rad
    far_yaw = base.clone()
    far_yaw[:, 4] = base[:, 4] + turns
    odd = base.clone()
    odd[:, 4] = 1e4 + torch.arange(3.0)
    return sets + [("zero_size", base, zero), ("zero_size_pairs", zero,
                                               zero.clone()),
                   ("yaw_1e4", base, far_yaw),
                   ("yaw_1e4_both", far_yaw, torch.cat([odd, far_yaw]))]


def degenerate_box_sets(seed: int = 0):
    """(name, boxes (K, 7)) sets of the degenerate LiDAR boxes (x, y,
    z_bottom, dx, dy, dz, yaw) that an untrained detector decodes, each
    beside 32 scene boxes: zero-size boxes (both sides 0) thousands of
    metres apart; boxes with an infinite side and a zero one (a NaN
    area); boxes with sides from 1e4 to 1e20 m (areas past float32's
    range) over the scene; the first two mixed. The kernels must give what
    their plain versions give on them: IoU 0 for zero-size pairs, NaN
    where the union is NaN. (A box past 1e8 m against a zero-area one has
    an IoU that float32 leaves to rounding, as ``iou_undetermined`` says:
    the plain version on the card and on the CPU differ there by up to 94
    times, so no set pairs them.)"""
    gen = torch.Generator().manual_seed(seed)

    def scene(k):
        b = torch.empty((k, 7))
        b[:, :2] = (torch.rand((k, 2), generator=gen) * 2 - 1) * 40
        b[:, 2] = -1.5
        b[:, 3:6] = 0.6 + torch.rand((k, 3), generator=gen) * 4
        b[:, 6] = (torch.rand(k, generator=gen) * 2 - 1) * math.pi
        return b

    zero = scene(32)
    zero[:, :2] = (torch.rand((32, 2), generator=gen) * 2 - 1) * 6000
    zero[:, 3:5] = 0.0
    inf_zero = scene(32)
    inf_zero[:, :2] = (torch.rand((32, 2), generator=gen) * 2 - 1) * 2e4
    inf_zero[:, 3], inf_zero[:, 4] = math.inf, 0.0
    huge = scene(16)
    huge[:, 3:5] = 10.0 ** (4 + torch.rand((16, 2), generator=gen) * 16)
    mixed = torch.cat([zero[:8], inf_zero[:8]])
    return [(name, torch.cat([scene(32), b])[torch.randperm(
        32 + len(b), generator=gen)])
        for name, b in (("zero_size_far", zero), ("inf_by_zero", inf_zero),
                        ("huge", huge), ("mixed", mixed))]


def iou_undetermined(a, b, want, bev: bool, tol: float = 1e-5,
                     zero_area: bool = False):
    """(..., N, M) bool: the pairs whose IoU float32 does not determine to
    ``tol`` of max(1, |IoU|): a pair with an untame box (past
    ``box_ops.IOU3D_TAME`` or not finite; with ``zero_area``, also a box
    of zero area) whose float32 plain IoU ``want`` (``box_ops.
    boxes_iou_bev_ref`` of (a, b) if ``bev``, else ``boxes_iou_3d_ref``)
    lies farther than that from the same formula in float64. Corners 1e8
    m and more apart leave the shoelace's sum to rounding; a zero-area box
    accepts a whole box by the point test's tolerance, and the union is
    then the rounding of an area less itself. Two float32 evaluations in
    another order (a kernel's, or the pair's other order) may then differ
    by up to the IoU itself."""
    from .ops import box_ops

    tame = box_ops.iou_bev_tame if bev else box_ops.iou3d_tame

    def regular(x):
        t = tame(x)
        if zero_area:
            t = t & (x[..., 2:4] if bev else x[..., 3:5]).ne(0).all(-1)
        return t

    untame = ~regular(a)[..., :, None] | ~regular(b)[..., None, :]
    if not bool(untame.any()):
        return untame
    v64 = (box_ops.boxes_iou_bev_ref if bev else box_ops.boxes_iou_3d_ref)(
        a, b, dtype=torch.float64)
    off = (want.double() - v64).abs() > tol * v64.abs().clamp_min(1.0)
    return untame & off


def nms_normal_edge_sets(gen):
    """(name, boxes (1, K, 4) (x1, y1, x2, y2), scores (1, C, K), valid)
    sets for K10-normal: identical boxes, boxes touching along an edge
    (inter 0), nested, zero-size and inverted boxes, equal scores, a
    chain where each box suppresses the next, all invalid, and one box."""
    def case(name, boxes, c=2, scores=None, valid=None):
        k = boxes.shape[0]
        if scores is None:
            scores = torch.rand((1, c, k), generator=gen)
        if valid is None:
            valid = torch.ones(scores.shape, dtype=torch.bool)
        return name, boxes[None].float(), scores, valid

    unit = torch.tensor([0.0, 0.0, 2.0, 1.0])
    grid = torch.arange(40.0)
    touching = torch.stack([unit + torch.tensor([2.0 * i, 0, 2.0 * i, 0])
                            for i in grid])
    nested = torch.stack([unit * (0.9 ** i) for i in grid])
    chain = torch.stack([unit + torch.tensor([0.5 * i, 0, 0.5 * i, 0])
                         for i in grid])
    zero = unit.repeat(40, 1)
    zero[::3, 2] = zero[::3, 0]            # no width
    zero[1::3, 3] = zero[1::3, 1] - 1.0    # inverted
    k = 70
    return [case("identical", unit.repeat(k, 1)),
            case("touching", touching),
            case("nested", nested, c=3),
            case("zero_size", zero),
            case("equal_scores", chain, scores=torch.full((1, 2, 40), 0.5)),
            case("chain", chain, scores=torch.linspace(1, 0, 40).repeat(
                1, 1, 1)),
            case("all_invalid", chain, valid=torch.zeros((1, 2, 40),
                                                         dtype=torch.bool)),
            case("one_box", unit[None])]


# KITTI's P2 (the left colour camera of a 1242 x 375 frame: focal 721.54
# px, principal point (609.56, 172.85)); the reference test scale (1280,
# 384) with keep_ratio resizes it by 1.024 and pads it to 1280 x 384
KITTI_FOCAL, KITTI_CX, KITTI_CY = 721.5377, 609.5593, 172.854
KITTI_SCALE = 1.024


def kitti_lidar2img(img_hw=(384, 1280)) -> np.ndarray:
    """(4, 4) float32 lidar2img of a KITTI-like camera looking along +x
    from 0.27 m behind and 0.08 m below the LiDAR (cam x = -y, cam y =
    -z, cam z = x), P2 scaled to the test scale and then by ``img_hw[0] /
    384``."""
    s = KITTI_SCALE * img_hw[0] / 384.0
    k = np.array([[KITTI_FOCAL * s, 0, KITTI_CX * s, 0],
                  [0, KITTI_FOCAL * s, KITTI_CY * s, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    tr = np.array([[0, -1, 0, 0], [0, 0, -1, -0.08], [1, 0, 0, -0.27],
                   [0, 0, 0, 1]], np.float64)
    return (k @ tr).astype(np.float32)


def voxel_adversarial_sets(gen: np.random.Generator, point_cloud_range,
                           voxel_size, p: int = 4096, c: int = 4):
    """(name, points (B, P, C) float32, mask (B, P) bool) sets for K1:
    points exactly on voxel faces (float32 images of low + k * size, the
    range's own faces included), many duplicates of a few points, points
    out of range on every side and masked points, and a batch whose first
    and last samples are empty."""
    low = np.asarray(point_cloud_range[:3], np.float64)
    high = np.asarray(point_cloud_range[3:], np.float64)
    vs = np.asarray(voxel_size, np.float64)
    n = np.round((high - low) / vs).astype(np.int64)

    def pts(xyz):
        out = np.zeros((1, xyz.shape[0], c), np.float32)
        out[0, :, :3] = xyz
        out[0, :, 3:] = gen.uniform(0, 1, (xyz.shape[0], c - 3))
        return out

    k = gen.integers(0, n + 1, (p, 3))          # n: the far faces
    faces = (low + k * vs).astype(np.float32)
    dup = np.repeat(gen.uniform(low, high, (8, 3)), p // 8, 0).astype(
        np.float32)
    out = gen.uniform(low - 5, high + 5, (p, 3)).astype(np.float32)
    side = gen.integers(0, 3, p)
    out[np.arange(p), side] = np.where(gen.uniform(size=p) < 0.5,
                                       low[side] - gen.uniform(0, 3, p),
                                       high[side] + gen.uniform(0, 3, p))
    out[: p // 4] = gen.uniform(low, high, (p // 4, 3))   # some inside
    mixed = pts(gen.uniform(low, high, (p, 3)).astype(np.float32))
    sets = [("faces", pts(faces), np.ones((1, p), bool)),
            ("duplicates", pts(dup), np.ones((1, p), bool)),
            ("out_of_range", pts(out), np.ones((1, p), bool)),
            ("masked", mixed, gen.uniform(size=(1, p)) < 0.5)]
    empty = np.concatenate([pts(gen.uniform(low, high, (p, 3)).astype(
        np.float32)) for _ in range(3)])
    emask = np.ones((3, p), bool)
    emask[0] = emask[2] = False
    sets.append(("empty_samples", empty, emask))
    sets.append(("all_empty", empty[:1], np.zeros((1, p), bool)))
    return sets


def roiaware_case(gen: np.random.Generator, b: int, r: int, v: int, c: int,
                  span: float = 8.0):
    """(rois (B, R, 7), centers (B, V, 3), feats (B, V, C), mask (B, V))
    float32 / bool: RoIs of 1-5 m around the middle of a ``span`` m
    square (they overlap), voxel centres uniform over it, a tenth of the
    voxels masked."""
    rois = np.zeros((b, r, 7), np.float32)
    rois[..., :2] = gen.uniform(-span / 4, span / 4, (b, r, 2))
    rois[..., 2] = gen.uniform(-2.0, -1.0, (b, r))
    rois[..., 3:6] = gen.uniform(1.0, 5.0, (b, r, 3))
    rois[..., 6] = gen.uniform(-np.pi, np.pi, (b, r))
    centers = gen.uniform(-span / 2, span / 2, (b, v, 3)).astype(np.float32)
    centers[..., 2] = gen.uniform(-2.5, 2.0, (b, v))
    feats = gen.normal(size=(b, v, c)).astype(np.float32)
    return rois, centers, feats, gen.uniform(size=(b, v)) >= 0.1


def roiaware_adversarial_sets(gen: np.random.Generator, c: int = 20):
    """K16's edge cases, each (name, rois, centers, feats, mask) as
    ``roiaware_case``: an empty RoI among others, 100 RoIs stacked on one
    spot, voxel centres exactly on the faces of axis-aligned RoIs (u = 0
    inside, u = 1 outside) and at u = 1 - 2^-24 (inside, the last cell),
    masked voxels inside RoIs, V not a multiple of the 256-voxel chunk
    (1,037 over 2 samples), and one RoI holding all 40,000 voxels."""
    sets = []
    rois, centers, feats, mask = roiaware_case(gen, 2, 12, 2000, c)
    rois[0, 3, :2] = 500.0                                   # holds nothing
    sets.append(("empty_roi", rois, centers, feats, mask))
    rois, centers, feats, mask = roiaware_case(gen, 1, 100, 5000, c, 4.0)
    rois[..., :3] = rois[:, :1, :3]
    sets.append(("stacked", rois, centers, feats, mask))
    # axis-aligned RoIs of 2 x 2 x 2 m at the origin (bottom at z = -1):
    # centres on each face (u = 0 inside, u = 1 outside), at u = 1 - 2^-24
    # and in between
    rois = np.zeros((1, 3, 7), np.float32)
    rois[0, :, 2] = -1.0
    rois[0, :, 3:6] = 2.0
    rois[0, 1, 6] = np.float32(np.pi)                       # turned round
    rois[0, 2, 3] = 1.0                                      # 1 m long in x
    last = np.float32(0.5) - np.float32(2.0 ** -24)          # u = 1 - 2^-24
    grid = np.linspace(-0.95, 0.95, 9, dtype=np.float32)
    pts = []
    for axis in range(3):
        for face in (-1.0, 1.0, float(last), -float(last), 0.5, -0.5):
            for a, b2 in zip(grid, grid[::-1]):
                p = [a, b2, (a + b2) / 2]
                p[axis] = face
                pts.append(p)
    centers = np.asarray(pts, np.float32)[None]
    feats = gen.normal(size=(1, centers.shape[1], c)).astype(np.float32)
    sets.append(("faces", rois, centers, feats,
                 np.ones(centers.shape[:2], bool)))
    rois, centers, feats, mask = roiaware_case(gen, 2, 8, 3000, c, 4.0)
    mask = gen.uniform(size=mask.shape) < 0.5
    sets.append(("masked", rois, centers, feats, mask))
    sets.append(("ragged_v",) + roiaware_case(gen, 2, 20, 1037, c))
    rois, centers, feats, mask = roiaware_case(gen, 1, 3, 40000, c)
    rois[0, 0, :6] = (0.0, 0.0, -10.0, 100.0, 100.0, 100.0)
    sets.append(("one_roi_holds_all", rois, centers, feats, mask))
    return sets


@contextlib.contextmanager
def pinned_choices(recorded: dict = None):
    """The discrete choices of a LiDAR detector's forwards, in call order:
    each ReLU's sign pattern (``torch.relu``, which ``nn.ReLU`` calls), the
    heads' and PartA2's proposal top-k indices and FreeAnchor's bags
    (``topk_stable``),
    TransFusion's Hungarian
    matches (``assign_batch``) and the keep masks of K10-NMS and
    K10-circle. With ``recorded=None`` the block records them in the
    yielded dict. Given the record of an earlier run of the same weights
    and inputs (the CPU's for a card run, a float64 run's for a float32
    one), every choice is taken from it, and the yielded dict counts
    where this run's own choice differs (``flips``) and lists each
    difference that is not a tie within rounding (``unexplained``): a
    ReLU input farther than 1e-4 of its tensor's max from 0 on either
    run, top-k picks whose scores differ by more than 1e-4 of their max,
    a match costing more than 1e-4 (relative) over this run's own, or NMS
    suppression bits or score orders that differ away from the threshold
    (1e-4, relative to the threshold or the scores' max). This run's own
    choices are still computed (every kernel of the path still
    launches)."""
    tol = 1e-4
    from .core.bbox import coders
    from .models.dense_heads import (anchor3d_head, centerpoint_head,
                                     free_anchor3d_head, transfusion_head)
    from .models.detectors import parta2
    from .ops import box_ops

    out = dict(relu=[], topk=[], assign=[], nms_bev=[], nms_circle=[],
               flips={}, unexplained=[])

    def prior(kind, now):
        """The recorded entry of this call (None when recording)."""
        i = len(out[kind])
        out[kind].append(now)
        if recorded is None:
            return None
        then = recorded[kind][i]
        shapes = [tuple(t.shape) for t in now if t is not None], \
            [tuple(t.shape) for t in then if t is not None]
        if shapes[0] != shapes[1]:
            raise RuntimeError(f"pinned_choices: {kind} call {i} has shapes "
                               f"{shapes[0]}, the record {shapes[1]}")
        return then

    def flip(kind, n, margin, limit=None):
        out["flips"][kind] = out["flips"].get(kind, 0) + int(n)
        if n and margin > (tol if limit is None else limit):
            out["unexplained"].append(dict(kind=kind, call=len(out[kind]) - 1,
                                           flips=int(n), margin=margin))

    def host(t):
        return None if t is None else t.detach().to("cpu", torch.float64)

    real_relu = torch.relu

    def relu(x):
        then = prior("relu", (host(x),))
        if then is None:
            return real_relu(x)
        mine, theirs = x.detach().cpu().double(), then[0]
        differ = (mine > 0) != (theirs > 0)
        if differ.any():
            flip("relu", differ.sum(), float(torch.maximum(
                mine.abs(), theirs.abs())[differ].max()) / float(
                    theirs.abs().max()))
        return torch.where((theirs > 0).to(x.device), x, x.new_zeros(()))

    real_topk = transfusion_head.topk_stable

    def topk(x, k):
        own = real_topk(x, k)
        then = prior("topk", (host(x), own.cpu()))
        if then is None:
            return own
        idx = then[1]
        mine = x.detach().cpu().double()
        if not torch.equal(own.cpu().sort(-1)[0], idx.sort(-1)[0]):
            margin = max(float((v.gather(-1, own.cpu()).sort(-1)[0] -
                                v.gather(-1, idx).sort(-1)[0]).abs().max())
                         / float(v.abs().max().clamp_min(1e-30))
                         for v in (mine, then[0]))
            flip("topk", 1, margin)
        return idx.to(own.device)

    real_assign = transfusion_head.assign_batch

    def total(cost, cols):
        picked = cost.gather(-1, cols.clamp_min(0)[..., None])[..., 0]
        return (picked * (cols >= 0)).sum(-1)

    def assign(cost):
        own = real_assign(cost)
        then = prior("assign", (host(cost), own.cpu()))
        if then is None:
            return own
        cols, mine = then[1], cost.detach().cpu().double()
        if not torch.equal(own.cpu(), cols):
            # each run's matches cost no more than the other's on its own
            # costs, by at most rounding
            extra = max(float(((total(c, b) - total(c, a)) /
                               total(c, a).abs().clamp_min(1e-12)).max())
                        for c, a, b in ((mine, own.cpu(), cols),
                                        (then[0], cols, own.cpu())))
            flip("assign", int((own.cpu() != cols).any(-1).sum()), extra)
        return cols.to(own.device)

    def order_flips(mine, theirs, valid):
        """(…, K) scores: pairs of valid boxes that the two runs' greedy
        orders (descending, ties by index) put the other way round,
        farther apart than ``tol`` of the scores' max on either run."""
        k = mine.shape[-1]
        lower = torch.arange(k)[:, None] < torch.arange(k)[None]

        def before(s):
            d = s[..., :, None] - s[..., None, :]
            return (d > 0) | ((d == 0) & lower)

        both = valid[..., :, None] & valid[..., None, :]
        swapped = (before(mine) != before(theirs)) & both
        scale = float(theirs.abs().max().clamp_min(1e-30))
        far = ((mine[..., :, None] - mine[..., None, :]).abs() > tol * scale
               ) | ((theirs[..., :, None] - theirs[..., None, :]).abs() >
                    tol * scale)
        return int((swapped & far).sum())

    def nms_flip(kind, own, keep, bits, thr, scores, valid):
        """Differing keep masks: explained when the two runs' suppression
        bits differ only at pairs within ``tol`` of the threshold on
        either run and their score orders only among near-equal scores."""
        if torch.equal(own.cpu(), keep):
            return
        (m_mine, m_theirs), (s_mine, s_theirs), (v_mine, v_theirs) = \
            bits, scores, valid
        near = tol * max(float(thr.abs().max()), 1.0)
        tie = (m_mine - thr).abs() <= near
        tie |= (m_theirs - thr).abs() <= near
        bad = int((((m_mine > thr) != (m_theirs > thr)) & ~tie).sum())
        if not torch.equal(v_mine, v_theirs):
            bad += int((v_mine != v_theirs).sum())
        else:
            bad += order_flips(s_mine, s_theirs, v_theirs)
        flip(kind, (own.cpu() != keep).sum(), float(bad), limit=0.0)

    real_bev = anchor3d_head.nms_bev_mask

    def nms_bev(boxes, scores, thresh, valid=None):
        own = real_bev(boxes, scores, thresh, valid)
        then = prior("nms_bev", (host(boxes), host(scores), None if valid is
                                 None else valid.cpu(), own.cpu()))
        if then is None:
            return own
        mine = [host(boxes), host(scores), None if valid is None else
                valid.cpu()]
        vm = mine[2] if mine[2] is not None else torch.ones_like(
            mine[1], dtype=torch.bool)
        vt = then[2] if then[2] is not None else torch.ones_like(
            then[1], dtype=torch.bool)
        iou = [box_ops.boxes_iou_bev_ref(b.float(), b.float()).double()
               for b in (mine[0], then[0])]
        nms_flip("nms_bev", own, then[3], iou, torch.tensor(float(thresh)),
                 (mine[1], then[1]), (vm, vt))
        return then[3].to(own.device)

    real_circle = centerpoint_head.circle_nms_mask

    def nms_circle(centers, scores, thresh, valid=None):
        own = real_circle(centers, scores, thresh, valid)
        thr = torch.as_tensor(thresh, dtype=torch.float64).cpu()
        then = prior("nms_circle", (host(centers), host(scores), None if
                                    valid is None else valid.cpu(),
                                    own.cpu()))
        if then is None:
            return own
        thr = thr.reshape(-1, 1, 1) if thr.dim() else thr

        def d2(c):
            d = c[:, None, :, :] - c[:, :, None, :]
            # "suppresses" is d2 <= thr: negate so that "> thr" suppresses
            return -(d[..., 0] ** 2 + d[..., 1] ** 2)

        vm = valid.cpu() if valid is not None else torch.ones_like(
            own.cpu())
        vt = then[2] if then[2] is not None else torch.ones_like(vm)
        nms_flip("nms_circle", own, then[3],
                 (d2(host(centers)), d2(then[0])), -thr,
                 (host(scores), then[1]), (vm, vt))
        return then[3].to(own.device)

    saved = [(torch, "relu", relu), (transfusion_head, "assign_batch",
                                     assign),
             (anchor3d_head, "nms_bev_mask", nms_bev),
             (centerpoint_head, "nms_bev_mask", nms_bev),
             (centerpoint_head, "circle_nms_mask", nms_circle)] + \
        [(m, "topk_stable", topk) for m in (anchor3d_head, centerpoint_head,
                                            transfusion_head, coders,
                                            parta2, free_anchor3d_head)]
    saved = [(m, name, getattr(m, name), new) for m, name, new in saved]
    for m, name, _, new in saved:
        setattr(m, name, new)
    try:
        yield out
    finally:
        for m, name, old, _ in saved:
            setattr(m, name, old)


@contextlib.contextmanager
def pooled_sync_norms():
    """Sync-typed BatchNorms in train mode take the statistics of their
    pooled sums (count, sum x, sum x^2) on one rank too, as they do over
    several (``models/layers.py:BatchNorm.pooled``; on one rank a sync
    norm is otherwise ``F.batch_norm``, whose statistics differ from
    those sums in float32 rounding). Inside the block a one-card step is
    the reference that a data-parallel step on identical halves must
    equal bit for bit: the ranks' sums double exactly."""
    from .models.layers import BatchNorm, compute_dtype
    real = BatchNorm.forward

    def forward(self, x):
        if self.training and self.sync:
            return self.pooled(x.float(), None, unbiased=True).to(
                compute_dtype(x, self.cdtype))
        return real(self, x)

    BatchNorm.forward = forward
    try:
        yield
    finally:
        BatchNorm.forward = real


@contextlib.contextmanager
def recording_eval_ious():
    """Inside the block, each ``box_ops.boxes_iou_bev`` / ``boxes_iou_3d``
    call made through the module's names (the KITTI evaluator's, which
    imports them at each call) appends (kind, a, b), kind "bev" or "3d",
    to the yielded list; the kernel still runs."""
    from .ops import box_ops

    seen, real = [], (box_ops.boxes_iou_bev, box_ops.boxes_iou_3d)

    def wrap(kind, fn):
        def call(a, b):
            seen.append((kind, a.clone(), b.clone()))
            return fn(a, b)
        return call

    box_ops.boxes_iou_bev = wrap("bev", real[0])
    box_ops.boxes_iou_3d = wrap("3d", real[1])
    try:
        yield seen
    finally:
        box_ops.boxes_iou_bev, box_ops.boxes_iou_3d = real


# the feature rows the gather tests draw for a set of ``point_op_sets``:
# (C, storage offset in floats); the other sets take the test's own width
# at offset 0. Rows of C <= 4 take a thread a row in K14-gather, C % 4 ==
# 0 rows at a 16-byte aligned base move as float4, the others as floats.
POINT_SET_ROWS = {"rows_c1": (1, 0), "rows_c3": (3, 0), "rows_c5": (5, 0),
                  "rows_c128": (128, 0), "rows_c130": (130, 0),
                  "rows_unaligned": (128, 1)}


def slot_order_grad(idx, n: int, g, weight=None) -> torch.Tensor:
    """The features' gradient of a K14 gather of (B, R * J) slots into (B,
    n) rows, each row's sum taken in increasing slot order in float32 (the
    order K14-gather's list gives its backward): numpy's ``add.at``
    applies its updates one at a time, in order. ``g`` is the output's
    gradient (B, R, C) (a slot's value repeated over its J slots), times
    ``weight`` (B, R, J) where given. A CPU tensor."""
    b, slots = idx.shape
    c = g.shape[-1]
    j = slots // g.reshape(b, -1, c).shape[1]
    rows = (idx.cpu().numpy().astype(np.int64) + n * np.arange(b)[:, None]
            ).reshape(-1)
    vals = np.repeat(g.detach().reshape(-1, c).cpu().numpy(), j, axis=0)
    if weight is not None:
        vals = vals * weight.detach().reshape(-1, 1).cpu().numpy()
    out = np.zeros((b * n, c), np.float32)
    np.add.at(out, rows, vals)
    return torch.from_numpy(out.reshape(b, n, c))


def offset_rows(values, offset: int, device="cpu",
                requires_grad: bool = False):
    """(base, view): ``values`` (a numpy array or tensor) copied into a
    flat float32 tensor ``base`` of ``offset`` more elements, and the
    contiguous view of its shape that starts ``offset`` elements into
    ``base``'s storage (with ``offset`` % 4 != 0 its rows are not 16-byte
    aligned). With ``requires_grad`` the view's gradient lands in
    ``base.grad[offset:]``."""
    values = torch.as_tensor(values).to(device, torch.float32)
    base = torch.zeros(offset + values.numel(), device=device)
    base[offset:] = values.reshape(-1)
    base.requires_grad_(requires_grad)
    return base, base[offset:].view(values.shape)


# points far outside fps_large_cloud's 8 m cube, each farther from it
# than from the others, so that they are picked first, in this order
FPS_TIE_SPOTS = ((1000.0, 4.0, 4.0), (4.0, -800.0, 4.0), (4.0, 4.0, 600.0),
                 (-400.0, 4.0, 4.0))


def fps_large_cloud(n: int, device="cpu", clusters=(8, 16)):
    """(xyz (2, n, 3), mask (2, n), ties (2, T) int64): K14-FPS's clouds
    past a cluster's registers. Two clouds in an 8 m cube (a generator on
    ``device`` seeded by ``n``), the second's first 3 points and its last
    quarter masked, and for each cluster size C ties that the kernel's
    layout must break by the lowest index, each group of copies at one of
    ``FPS_TIE_SPOTS`` so that the groups are picks 1, 2, ..., T. Block 1
    of C owns the share [s, 2s), s = ceil(n / C); its thread t holds s + t
    + 1,024 j in registers (j < 8) and s + 8,192 + t + 1,024 j in its tail.
    - registers against the tail: s + k, the same thread's tail point s +
      8,192 + k where the share has a tail, and block 2's 2s + k; s + k
      wins;
    - within a tail, where it holds 1,025 points past k + 1: s + 8,192 + k
      against the same thread's next tail point (+ 1,024) and the next
      lane's (+ 1); the first wins.
    ``ties`` are the picks 1..T that the lowest-index rule gives, the same
    in both clouds."""
    from .ops.pointnet_ops import FPS_CLUSTER_POINTS as regs

    gen = torch.Generator(device).manual_seed(n)
    xyz = torch.rand((2, n, 3), generator=gen, device=device) * 8
    mask = torch.ones((2, n), dtype=torch.bool, device=device)
    mask[1, n - n // 4:] = False
    mask[1, :3] = False
    groups = []
    for c in clusters:
        s = -(-n // c)
        tail = min(s, n - s) - regs                 # block 1's tail points
        k = 5 * c if tail <= 0 else min(5 * c, tail - 1)
        groups.append([s + k, 2 * s + k] + ([s + regs + k] if tail > 0
                                            else []))
    for c in clusters:
        s = -(-n // c)
        k = 7 * c
        if min(s, n - s) - regs > k + 1025:
            t = s + regs + k
            groups.append([t, t + 1024, t + 1])
    assert len(groups) <= len(FPS_TIE_SPOTS)
    flat = [i for g in groups for i in g]
    assert len(set(flat)) == len(flat) and bool(mask[:, flat].all())
    for g, spot in zip(groups, FPS_TIE_SPOTS):
        xyz[:, g] = torch.tensor(spot, device=device)
    ties = torch.tensor([min(g) for g in groups], device=device)
    return xyz, mask, ties.expand(2, -1)


def point_op_sets(gen: np.random.Generator):
    """The clouds that K14 is held on: (name, xyz (B, N, 3) float32, mask
    (B, N) bool, queries (B, S, 3) float32, radius, K, num_samples) with
    random clouds, exact duplicates, masked tails, a sample with every
    point masked, more FPS samples than valid points, balls with no point,
    points at exactly the radius (and one float32 step beyond it) and
    lattices whose neighbours tie in distance. Then K14-FPS's partition
    (``ops/pointnet_ops.py``: one 256-thread block a sample up to
    FPS_BLOCK_MAX = 4,096 points, past it a cluster of 8 blocks of 1,024
    threads, one point a thread up to 8,192): N at, one below and one
    above both; the largest running distance tied between points in
    different blocks' shares (the lower index wins); a block's whole share
    masked; a sample of 50,000 points (GroupFree3D's ScanNet input). Then
    the small clouds of
    ``POINT_SET_ROWS``, whose gathers take other row widths and an
    unaligned view. Last, NaN coordinates (``NAN_SETS``). numpy."""
    f32 = np.float32

    def cloud(b, n, scale=2.0):
        return gen.uniform(-scale, scale, (b, n, 3)).astype(f32)

    sets = []
    xyz = cloud(2, 300, 1.0)
    sets.append(("random", xyz, np.ones((2, 300), bool), xyz[:, :40].copy(),
                 0.5, 16, 64))
    base = cloud(2, 40)
    dup = base[:, gen.integers(0, 40, 256)]
    sets.append(("duplicates", dup, np.ones((2, 256), bool),
                 dup[:, :32].copy(), 0.6, 32, 64))
    xyz = cloud(2, 200)
    mask = np.ones((2, 200), bool)
    mask[0, 120:] = False
    mask[1] = False
    sets.append(("masked_tail_and_all_masked", xyz, mask, cloud(2, 24),
                 0.8, 16, 48))
    xyz = cloud(1, 64)
    mask = np.zeros((1, 64), bool)
    mask[0, gen.choice(64, 10, replace=False)] = True
    sets.append(("samples_past_valid", xyz, mask, xyz[:, :8].copy(), 1.0, 8,
                 32))
    xyz = cloud(2, 128, 1.0)
    far = (gen.uniform(-1, 1, (2, 16, 3)) + 50.0).astype(f32)
    sets.append(("empty_balls", xyz, np.ones((2, 128), bool), far, 0.25, 8,
                 16))
    # points at exactly 0.5 (r^2 = 0.25 exactly) and one float32 step past
    r = f32(0.5)
    step = np.nextafter(r, f32(1))
    on = np.array([[r, 0, 0], [-r, 0, 0], [0, r, 0], [0, 0, -r],
                   [step, 0, 0], [0, -step, 0], [0.3, 0.4, 0.0],
                   [0, 0, 0]], f32)
    pad = cloud(1, 56, 3.0) + f32(3.5)
    xyz = np.concatenate([on[None], pad], 1).astype(f32)
    sets.append(("radius_boundary", xyz, np.ones((1, 64), bool),
                 np.zeros((1, 4, 3), f32), 0.5, 16, 16))
    g = np.stack(np.meshgrid(np.arange(6), np.arange(6), np.arange(4),
                             indexing="ij"), -1).reshape(1, -1, 3)
    lattice = (g * 0.5).astype(f32)[:, gen.permutation(g.shape[1])]
    q = ((gen.integers(0, 5, (1, 20, 3)) + 0.5) * 0.5).astype(f32)
    sets.append(("lattice_ties", lattice, np.ones((1, 144), bool),
                 np.concatenate([q, lattice[:, :12]], 1), 0.55, 8, 40))
    for label, edge in (("block_share", 4096), ("cluster_span", 8192)):
        for tag, n in (("below", edge - 1), ("at", edge), ("above", edge + 1)):
            xyz = cloud(1, n)
            mask = gen.uniform(size=(1, n)) > 0.1
            sets.append((f"{label}_{tag}", xyz, mask, xyz[:, :16].copy(),
                         0.3, 8, 64))
    # 40,000 points in a 2 m cube around point 0 at the origin, and four
    # points 10 m out on the axes (squared distance exactly 100 from it),
    # at indices in four blocks' shares of a cluster of 8 (5,000 points a
    # block) or 16 (2,500): the running distances tie at 100 across
    # blocks, and the lowest index must win each time
    n = 40_000
    xyz = cloud(1, n, 1.0)
    xyz[0, 0] = 0.0
    far = {3000: (10, 0, 0), 20500: (0, 10, 0), 30000: (-10, 0, 0),
           39990: (0, 0, 10)}
    for i, p in far.items():
        xyz[0, i] = p
    sets.append(("tie_across_blocks", xyz, np.ones((1, n), bool),
                 xyz[:, :16].copy(), 0.3, 8, 32))
    # sample 0: block 1's share of a cluster of 8 masked (blocks 2-3 of
    # 16); sample 1: the last block's
    xyz = cloud(2, n)
    mask = np.ones((2, n), bool)
    mask[0, 5000:10000] = False
    mask[1, 35000:] = False
    sets.append(("block_share_masked", xyz, mask, xyz[:, :16].copy(), 0.3,
                 8, 48))
    n = 50_000                          # GroupFree3D's ScanNet input
    xyz = cloud(1, n)
    sets.append(("fps_max_points", xyz, gen.uniform(size=(1, n)) > 0.2,
                 xyz[:, :16].copy(), 0.3, 8, 40))
    for name in POINT_SET_ROWS:
        xyz = cloud(2, 200)
        sets.append((name, xyz, np.ones((2, 200), bool), cloud(2, 24), 0.8,
                     16, 48))
    sets += _ball_grid_sets(gen, cloud)
    sets.append(_nan_set(gen, cloud))
    return sets


# the sets of ``point_op_sets`` with NaN coordinates: their distances,
# interpolation weights and interpolations are NaN where the plain versions
# give NaN, so the checks of values take "equal or both NaN"
NAN_SETS = ("nan_coordinates",)


def _nan_set(gen: np.random.Generator, cloud) -> tuple:
    """NaN coordinates, as K14-ball's card test makes them, for K14-FPS and
    K14-NN: sample 0 has 30 points with one NaN coordinate (the first 10
    followed by a masked row, 5 of the others masked themselves) and NaN
    queries (4 all NaN, one with a NaN y); sample 1 is NaN throughout;
    sample 2's first 5 rows are masked and NaN, its first valid row (5) is
    NaN too. The running distances of FPS take NaN from a NaN point or a
    NaN pick and rank it first (torch.minimum, torch.argmax); K-NN puts NaN
    distances after every number (a stable torch.sort). 3,000 points a
    sample: one block, or a cluster of 8 or 16, by the route."""
    b, n = 3, 3000
    xyz = cloud(b, n)
    mask = np.ones((b, n), bool)
    rows = gen.choice(np.arange(1, n - 1), 30, replace=False)
    xyz[0, rows, gen.integers(0, 3, 30)] = np.nan
    mask[0, rows[:10] + 1] = False
    mask[0, rows[10:15]] = False
    xyz[1] = np.nan
    xyz[2, :6] = np.nan
    mask[2, :5] = False
    q = xyz[:, 100:140].copy()
    q[0, :4] = np.nan
    q[0, 6, 1] = np.nan
    q[2, 7] = cloud(1, 1)[0, 0]
    return ("nan_coordinates", xyz, mask, q, 0.3, 16, 64)


def _radius_edge(q: float, r2: float, sign: int) -> tuple:
    """(inside, outside): the float32 coordinates p along one axis whose
    squared difference fl(fl(q - p)^2) from ``q`` is the last <= ``r2``,
    and the first past it, going from ``q`` in direction ``sign``."""
    f32 = np.float32
    q, r2 = f32(q), f32(r2)
    p = f32(q + sign * np.sqrt(r2))
    toward = f32(sign * np.inf)

    def d(x):
        dx = f32(q - x)
        return f32(dx * dx)

    while d(p) > r2:
        p = np.nextafter(p, -toward)
    while d(np.nextafter(p, toward)) <= r2:
        p = np.nextafter(p, toward)
    return p, np.nextafter(p, toward)


def _cell_faces(x: np.ndarray, origin: float, inv: float) -> np.ndarray:
    """For each float32 coordinate in ``x``, the float32 coordinate nearest
    it at which K14-ball's cell floor(fl(fl(x - origin) * inv)) changes,
    and the one below it: points on both sides of a cell face."""
    f32 = np.float32
    o, inv = f32(origin), f32(inv)

    def cell(v):
        return np.floor(f32(f32(v - o) * inv))

    out = []
    for v in x.astype(f32):
        target = np.ceil(f32(f32(v - o) * inv))
        p = f32(o + target / inv)
        while cell(p) >= target:
            p = np.nextafter(p, f32(-np.inf))
        while cell(p) < target:
            p = np.nextafter(p, f32(np.inf))
        out += [p, np.nextafter(p, f32(-np.inf))]
    return np.asarray(out, f32)


# the sets of ``_ball_grid_sets``: K14-ball's and K14-NN's. The gathers are
# held on the others: grid_masked's all-masked sample reads one row from
# 1,024 slots, whose float32 sum in slot order (the kernel's) and in
# autograd's atomic order differ by ~1e-6 of the max
BALL_GRID_SETS = ("grid_edges", "one_point_40k", "crowded_spots",
                  "grid_masked", "radius_past_room", "radius_below_spacing",
                  "batch8_4099", "ties_across_tiles")


def _ball_grid_sets(gen: np.random.Generator, cloud) -> list:
    """The sets of K14-ball's cell grid and K14-NN's warp merge: points on
    the grid's cell faces and at exactly r after float32 rounding (and one
    step past), queries on faces; 40,000 copies of one point; 80% of the
    points on 4 spots (balls of far more than K points); masked points, an
    all-masked sample and empty balls; a radius larger than the room and
    one smaller than the points' spacing; a batch of 8 samples of 4,099
    points (not a multiple of 32); K-NN ties at equal distance across
    lanes and staged tiles, with masked sources. Past
    ``BALL_SCAN_MAX_POINTS`` points the ball query takes the grid by
    default."""
    from .ops.pointnet_ops import _radius2, ball_grid_params

    f32 = np.float32
    sets = []
    # cell faces and the radius's float32 edge: r 0.2 (r2 is not 0.04)
    r = 0.2
    r2 = _radius2(r)
    inv, _ = ball_grid_params(r)
    base = cloud(1, 2600, 1.5)
    o = base[0, 0]
    faces = []
    for axis in range(3):
        at = base[0, 1:201].copy()
        walls = _cell_faces(at[:, axis], o[axis], inv)
        at = np.repeat(at, 2, 0)
        at[:, axis] = walls
        faces.append(at)
    qs = base[0, 1:17].copy()
    edge = []
    for qq in qs:
        for axis in range(3):
            for sign in (-1, 1):
                for v in _radius_edge(qq[axis], r2, sign):
                    p = qq.copy()
                    p[axis] = v
                    edge.append(p)
    xyz = np.concatenate([base[0], *faces, np.asarray(edge, f32)])
    xyz = np.concatenate([xyz, cloud(1, 4500 - len(xyz), 1.5)[0]])[None]
    q = np.concatenate([qs, faces[0][::25], xyz[0, 3000:3032]])[None]
    sets.append(("grid_edges", xyz.astype(f32), np.ones((1, 4500), bool),
                 q.astype(f32), r, 64, 64))
    n = 40_000
    xyz = np.broadcast_to(np.array([0.5, -0.2, 1.0], f32), (1, n, 3)).copy()
    q = (xyz[:, :4] + np.array([[0, 0, 0], [0.1, 0, 0], [0, 0.25, 0],
                                [3, 3, 3]], f32)).astype(f32)
    sets.append(("one_point_40k", xyz, np.ones((1, n), bool), q, 0.2, 64,
                 8))
    n = 20_000
    spots = gen.uniform(-2, 2, (4, 3)).astype(f32)
    crowd = spots[gen.integers(0, 4, int(n * 0.8))] + gen.normal(
        0, 0.005, (int(n * 0.8), 3)).astype(f32)
    xyz = np.concatenate([crowd, cloud(1, n - len(crowd))[0]])[
        gen.permutation(n)][None].astype(f32)
    q = np.concatenate([spots, spots + f32(0.15), spots + f32(0.3),
                        xyz[0, :20]])[None].astype(f32)
    sets.append(("crowded_spots", xyz, np.ones((1, n), bool), q, 0.2, 64,
                 32))
    xyz = cloud(2, 6000)
    mask = gen.uniform(size=(2, 6000)) > 0.5
    mask[1] = False
    q = np.concatenate([xyz[:, :24], cloud(2, 8) + f32(20)], 1)
    sets.append(("grid_masked", xyz, mask, q, 0.3, 32, 32))
    xyz = cloud(1, 5000, 1.0)
    sets.append(("radius_past_room", xyz, np.ones((1, 5000), bool),
                 np.concatenate([xyz[:, :12], cloud(1, 4, 3.0)], 1), 10.0,
                 32, 16))
    xyz = cloud(1, 5000)
    xyz[0, 4000:] = xyz[0, np.repeat(np.arange(100), 10)]
    xyz[0, 3900:4000] = xyz[0, :100] + f32(5e-5)
    q = np.concatenate([xyz[:, :16], cloud(1, 16)], 1)
    sets.append(("radius_below_spacing", xyz, np.ones((1, 5000), bool), q,
                 1e-4, 8, 16))
    xyz = cloud(8, 4099)
    sets.append(("batch8_4099", xyz, gen.uniform(size=(8, 4099)) > 0.1,
                 xyz[:, 7:39].copy(), 0.3, 16, 24))
    g = np.stack(np.meshgrid(np.arange(3), np.arange(4), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3)
    spots = (g * 0.5).astype(f32)
    xyz = spots[gen.integers(0, len(spots), (2, 3000))]
    mask = np.ones((2, 3000), bool)
    mask[1] = gen.uniform(size=3000) > 0.2
    q = np.broadcast_to(spots[None] + f32(0.25), (2, 24, 3)).astype(f32)
    sets.append(("ties_across_tiles", xyz.astype(f32), mask, q, 0.55, 32,
                 24))
    return sets


def indoor_positives(model, batch: dict, dev, shift: float = 0.06) -> dict:
    """``batch`` with each valid GT box moved onto an aggregated point of
    ``model``'s train-mode forward (``shift`` metres off in x and y, the
    box standing on it), so that VoteHead's box terms have positives:
    seeded random weights vote far from a synthetic room's boxes. The
    model is not changed (a copy runs)."""
    import copy

    agg = copy.deepcopy(model).train()(batch, mode="feats", device=dev)[
        "aggregated_points"].cpu().numpy()
    boxes = np.array(batch["gt_bboxes_3d"], copy=True)
    for b in range(boxes.shape[0]):
        for g in np.flatnonzero(np.asarray(batch["gt_mask"])[b]):
            c = agg[b, (5 * g) % agg.shape[1]] + np.float32(shift)
            boxes[b, g, :2] = c[:2]
            boxes[b, g, 2] = c[2] - boxes[b, g, 5] / 2
    return dict(batch, gt_bboxes_3d=boxes)


SST_WAYMO_TRAIN_DROP = (
    {"max_tokens": 30, "drop_range": (0, 30)},
    {"max_tokens": 60, "drop_range": (30, 60)},
    {"max_tokens": 100, "drop_range": (60, 100000)})


def _sst_voxels(rng, grid, v: int, n: int, clusters: int = 0,
                z_layers: int = 1):
    """(V, 3) int32 zyx of n unique (y, x) cells of ``grid`` (x, y, z)
    among V rows (clusters: that many discs crowded with cells first),
    random z below ``z_layers``; the V - n invalid rows hold garbage
    coordinates, some outside the grid. Returns (coords, valid)."""
    sx, sy, _ = grid
    cells = []
    for _ in range(clusters):
        c = rng.uniform((0, 0), (sx, sy))
        xy = np.round(c + rng.normal(0, 4.0, (400, 2))).astype(np.int64)
        ok = (xy >= 0).all(1) & (xy[:, 0] < sx) & (xy[:, 1] < sy)
        cells.append(xy[ok, 1] * sx + xy[ok, 0])
    cells.append(rng.permutation(sx * sy))
    lin = pd_unique(np.concatenate(cells))[:n]
    coords = rng.integers(-5, max(sx, sy) + 5, (v, 3)).astype(np.int32)
    valid = np.zeros(v, bool)
    rows = rng.choice(v, len(lin), replace=False)
    valid[rows] = True
    coords[rows] = np.stack([rng.integers(0, z_layers, len(lin)),
                             lin // sx, lin % sx], -1)
    return coords, valid


def pd_unique(a: np.ndarray) -> np.ndarray:
    """``a``'s distinct values in order of first appearance."""
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def sst_partition_sets(seed: int = 0) -> dict:
    """name -> (coords (B, V, 3) int32, valid (B, V) bool, cfg): voxel
    sets for K17 (cfg: ``sparse_shape``, ``window_shape``, ``drop_info``,
    ``win_caps``): random cells at SST's Waymo levels, clustered cells
    (every level, tokens dropped), a masked batch (one sample with no
    valid voxel), several samples, caps that bind, 3-D windows over
    several z layers (unique (y, x) cells), a 2-D window spanning z, one
    voxel."""
    rng = np.random.default_rng(seed)
    waymo = dict(sparse_shape=(200, 150, 1), window_shape=(12, 12, 1),
                 drop_info=SST_WAYMO_TRAIN_DROP, win_caps=None)

    def batch(cfg, specs, z_layers=1):
        out = [_sst_voxels(rng, cfg["sparse_shape"], *s, z_layers=z_layers)
               for s in specs]
        return (np.stack([c for c, _ in out]), np.stack([m for _, m in out]),
                cfg)

    return {
        "random": batch(waymo, [(4000, 3000), (4000, 2500)]),
        "clustered": batch(waymo, [(6000, 5000, 12), (6000, 4000, 8)]),
        "masked": batch(waymo, [(3000, 2000, 4), (3000, 0)]),
        "multi_sample": batch(waymo, [(1500, n, 3) for n in
                                      (1500, 1000, 700, 1, 1200)]),
        "cap_binding": batch(dict(waymo, win_caps=(9, 3, 2)),
                             [(5000, 4000, 10), (5000, 3000, 6)]),
        "three_d": batch(dict(sparse_shape=(60, 40, 5),
                              window_shape=(6, 6, 2), drop_info=(
                                  {"max_tokens": 8, "drop_range": (0, 10)},
                                  {"max_tokens": 14,
                                   "drop_range": (10, 100000)}),
                              win_caps=None),
                         [(1500, 1200, 4), (1500, 900)], z_layers=5),
        "window_2d": batch(dict(sparse_shape=(60, 40, 3),
                                window_shape=(8, 8), drop_info=(
                                    {"max_tokens": 64,
                                     "drop_range": (0, 100000)},),
                                win_caps=None),
                           [(1200, 1000, 3)], z_layers=3),
        "one_voxel": batch(waymo, [(1, 1)]),
    }
