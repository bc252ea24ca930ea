"""Helpers shared by the port's checks (``chip_smoke.py``,
``tests/test_torch_cuda.py`` and the CPU tests): what makes a
PointPillars or CenterPoint prediction on the card comparable with the
same prediction on the CPU, and the NMS input sets that K10-NMS and
K10-circle are held on."""
from __future__ import annotations

import math

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
