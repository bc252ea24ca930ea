"""Helpers shared by the port's checks (``chip_smoke.py``,
``tests/test_torch_cuda.py`` and the CPU tests): what makes a
PointPillars or CenterPoint prediction on the card comparable with the
same prediction on the CPU, the box sets that K10, K10-NMS and
K10-circle are held on, MVX-Net's KITTI-like camera and the voxel sets
that K1 (dynamic voxelization) is held on."""
from __future__ import annotations

import math

import numpy as np
import torch


def tame_box_deltas(model, scale: float = 0.01):
    """Scale the Anchor3DHead's box-regression weights by ``scale``.
    Seeded random weights regress size residuals whose exp() decodes to
    boxes far wider than the scene; the NMS over such boxes rests on
    float32 rounding, which the card and the CPU do differently. Scaled,
    the boxes stay near their anchors (scene-sized)."""
    with torch.no_grad():
        model.pts_bbox_head.conv_reg.weight.mul_(scale)
    return model


def even_class_prior(model):
    """Zero the Anchor3DHead's class bias (the focal prior puts every
    random-weight score near 0.01, under MVX-Net's 0.1 threshold): the
    scores spread around 0.5 and NMS sees full candidate sets."""
    with torch.no_grad():
        model.pts_bbox_head.conv_cls.bias.zero_()
    return model


def pp_kept_boxes(model, batch: dict, dev: str):
    """Every box the model keeps after NMS (``max_num`` lifted so that no
    near-tie decides which ones make the cut), in a canonical order:
    (boxes, scores, sample * C + label) sorted by that key, then by x."""
    head = model.pts_bbox_head
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
    head = model.pts_bbox_head
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
