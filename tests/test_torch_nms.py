"""The design of K10-NMS (``isfusion_tpu_torch/csrc/nms_bev.cu``) held on
the CPU, where the kernel cannot run: its bounding-circle cut
(``box_ops.bev_circles_meet``) never drops a pair whose intersection
area is above 0, a numpy mirror of its chunked greedy walk (64 sorted
boxes at a time, resolved on one 64-bit word) equals the plain greedy
walk and the JAX package's ``_greedy_suppress``, and the operation counts
of its data-dependent bound and of its circle cut. Then K10-circle's
fused launch (``csrc/nms_circle.cu``): a numpy mirror of its score order
(keys, the index-order shortcut, positions by counting), its
upper-triangle words in score order and its walk equals the plain
version and the JAX package's ``circle_nms_mask``; the order equals
``torch.sort``'s on ties, signed zeros and NaN.

The mirrors hold the algorithms (a chunk resolved as a fixed point), not
the kernels: ``nms_greedy_kernel`` and ``nms_circle_kernel`` themselves
are held exactly against their plain versions only on the card, by
``tests/test_torch_cuda.py``.

Tolerance: exact everywhere (boolean masks and integer counts). The area
is the port's plain ``rotated_rect_intersection_area``, the kernel's
arithmetic in float32 on the CPU.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.ops import box_ops as jbox
from isfusion_tpu_torch.ops import box_ops
from isfusion_tpu_torch.testing import (nms_cluster_set, nms_scene_set,
                                        nms_sparse_set)

GAPS = (-1e-3, 0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 2e-3, 1e-2, 0.1)
SIZES = ((4.6, 1.95), (0.41, 0.41), (12.01, 2.9), (1e-3, 2.0))


def _pairs(rows):
    """(P, 2, 5): each pair its own sample."""
    return torch.tensor(rows, dtype=torch.float32).view(-1, 2, 5)


def _corner_touching():
    """Pairs whose corners point at each other along the line of centres:
    the bounding circles touch at gap 0 (the cut's critical case), at the
    origin and 40 m out."""
    rows = []
    for (dx, dy) in SIZES:
        r = 0.5 * math.hypot(dx, dy)
        yaw = math.atan2(dy, dx)
        for x0 in (0.0, 40.0):
            for g in GAPS:
                rows += [[x0, -7.0, dx, dy, yaw],
                         [x0 + 2 * r + g, -7.0, dx, dy, yaw]]
    return _pairs(rows)


def _edge_touching():
    """Pairs side by side along an edge, the whole pair rotated, at each
    gap."""
    rows = []
    for (dx, dy) in SIZES:
        for yaw in (0.0, 0.3, math.pi / 4):
            c, s = math.cos(yaw), math.sin(yaw)
            for g in GAPS:
                step = dx + g
                rows += [[3.0, 2.0, dx, dy, yaw],
                         [3.0 + step * c, 2.0 - step * s, dx, dy, yaw]]
    return _pairs(rows)


def _just_apart():
    """Boxes 1e-4 m apart along an edge and at a corner, the edges
    collinear (one behind another on the same axis), at several yaws."""
    rows = []
    for yaw in np.linspace(-math.pi, math.pi, 9):
        c, s = math.cos(yaw), math.sin(yaw)
        for (dx, dy) in SIZES[:3]:
            step = dx + 1e-4
            rows += [[-20.0, 5.0, dx, dy, yaw],
                     [-20.0 + step * c, 5.0 - step * s, dx, dy, yaw]]
    return _pairs(rows)


def _huge():
    """Untamed decodes: sides up to 1e6 m, centres within 50 m, and a few
    such boxes 3e6 m away."""
    gen = torch.Generator().manual_seed(2)
    b = torch.empty((40, 5))
    b[:, :2] = (torch.rand((40, 2), generator=gen) * 2 - 1) * 50
    b[:, 2:4] = torch.exp(torch.rand((40, 2), generator=gen) * 14)
    b[:, 4] = (torch.rand(40, generator=gen) * 2 - 1) * math.pi
    b[30:, 0] += 3e6
    return b


def _nested():
    k = torch.arange(64, dtype=torch.float32)
    b = torch.tensor([3.0, -2.0, 4.0, 2.0, 0.3]).repeat(64, 1)
    b[:, 2:4] *= (0.97 ** k)[:, None]
    return b


def _rotated_45():
    b = torch.tensor([3.0, -2.0, 4.0, 2.0, 0.3]).repeat(64, 1)
    b[:, 4] += torch.arange(64) * math.pi / 4
    return b


CUT_SETS = {
    "identical": lambda: torch.tensor([3.0, -2.0, 4.0, 2.0, 0.3]).repeat(
        16, 1),
    "nested": _nested,
    "rotated_45": _rotated_45,
    "edge_touching": _edge_touching,
    "corner_touching": _corner_touching,
    "just_apart": _just_apart,
    "huge": _huge,
    "scene": lambda: nms_scene_set(torch.Generator().manual_seed(3))[0][0],
}


@pytest.mark.parametrize("name", sorted(CUT_SETS))
def test_circle_cut_is_exact(name):
    boxes = CUT_SETS[name]()
    meet = box_ops.bev_circles_meet(boxes)
    k = boxes.shape[-2]
    assert meet.shape == boxes.shape[:-2] + (k, k)
    assert torch.equal(meet, meet.transpose(-1, -2))
    # each unordered pair once, in the frame of its lower-index box, as
    # the kernel computes it
    i, j = torch.triu_indices(k, k)
    area = box_ops.rotated_rect_intersection_area(
        boxes[..., i, None, :], boxes[..., j, None, :])[..., 0, 0]
    assert area.shape == meet[..., i, j].shape
    assert not ((area > 0) & ~meet[..., i, j]).any()
    if name == "corner_touching":
        # the cut drops the pairs beyond its margin, and only those
        cut = ~meet[:, 0, 1].view(len(SIZES), 2, len(GAPS))
        assert cut[:3, :, -2:].all() and not cut[:, :, :6].any()
    if name == "scene":
        # the share of pairs the pairwise pass computes
        share = int(torch.triu(meet, 1).sum()) / (k * (k - 1) // 2)
        assert 0.01 < share < 0.03


def test_circle_cut_on_cluster_and_sparse_sets():
    dense = nms_cluster_set(torch.Generator().manual_seed(4))[0][0]
    sparse = nms_sparse_set(torch.Generator().manual_seed(5))[0][0]
    assert box_ops.bev_circles_meet(dense).all()
    assert torch.equal(box_ops.bev_circles_meet(sparse),
                       torch.eye(sparse.shape[0], dtype=torch.bool))


def test_circle_cut_keeps_degenerate_and_nan_boxes():
    b = torch.tensor([[0.0, 0.0, 0.0, 2.0, 0.0],
                      [500.0, 0.0, 2.0, 2.0, 0.0],
                      [float("nan"), 0.0, 2.0, 2.0, 0.0],
                      [-500.0, 0.0, 2.0, 2.0, 0.0]])
    meet = box_ops.bev_circles_meet(b)
    assert meet[0].all() and meet[2].all()       # zero side, NaN centre
    assert not meet[1, 3]


# ----------------------------------------------- the chunked greedy walk
MASK64 = (1 << 64) - 1


def chunked_walk(suppress, scores, valid):
    """keep (K,) of the algorithm of the greedy pass of csrc/nms_greedy.cuh,
    in Python (a copy: the kernel is tested on the card only), with its
    pipeline: the removed words (original index order) start as the
    invalid boxes; for chunk c (64 sorted positions) the helpers gathered,
    one chunk ahead, its diagonal block (word j bit i: sorted box i
    suppresses sorted box j, i < j), its off-diagonal block (bit i: chunk c
    - 1's box i suppresses its box j) and its removed bits as of chunk c -
    2; the walker takes all 64 positions, masks the removed ones and those
    that chunk c - 1's kept word suppresses, and resolves the chunk on one
    64-bit integer by applying "kept iff alive and no kept box before
    suppresses it" to all positions at once from all alive until it stops
    changing; the helpers OR chunk c - 1's kept rows into the removed words
    while chunk c is walked. Returns (keep, the most rounds a chunk
    took)."""
    k = len(scores)
    order = torch.sort(torch.from_numpy(np.asarray(scores, np.float32)),
                       descending=True, stable=True).indices.tolist()
    w = (k + 63) // 64
    sup = np.asarray(suppress, bool)
    rows = [[int(sum(1 << b for b in np.flatnonzero(sup[i, 64 * u:
                                                         64 * u + 64])))
             for u in range(w)] for i in range(k)]
    removed = [~sum(1 << b for b in range(64) if 64 * u + b < k and
                    valid[64 * u + b]) & MASK64 for u in range(w)]
    chunks = (k + 63) // 64

    def pos(c):
        return [order[64 * c + e] if 64 * c + e < k else -1
                for e in range(64)]

    def bit(i, j):
        return rows[i][j >> 6] >> (j & 63) & 1

    def blocks(c):
        q, p = pos(c), pos(c - 1) if c else [-1] * 64
        diag = [sum(bit(q[i], q[j]) << i for i in range(j) if q[i] >= 0)
                if q[j] >= 0 else 0 for j in range(64)]
        off = [sum(bit(p[i], q[j]) << i for i in range(64) if p[i] >= 0)
               if q[j] >= 0 else 0 for j in range(64)]
        return diag, off

    def removed_bits(c):
        return sum(1 << e for e, q in enumerate(pos(c))
                   if q < 0 or removed[q >> 6] >> (q & 63) & 1)

    keep = np.zeros(k, bool)
    ahead = {0: blocks(0) + (removed_bits(0),)}
    kept_of, most = {}, 0
    for c in range(chunks):
        # the walker
        diag, off, rem = ahead.pop(c)
        prev = kept_of.get(c - 1, 0)
        alive = sum(1 << j for j in range(64)
                    if not rem >> j & 1 and not off[j] & prev)
        kept, rounds = alive, 0
        while True:
            nxt = sum(1 << j for j in range(64)
                      if alive >> j & 1 and not diag[j] & kept)
            rounds += 1
            if nxt == kept:
                break
            kept = nxt
        most = max(most, rounds)
        kept_of[c] = kept
        for e, q in enumerate(pos(c)):
            if q >= 0:
                keep[q] = bool(kept >> e & 1)
        # the helpers: chunk c + 1's blocks, chunk c - 1's kept rows, then
        # chunk c + 1's removed bits
        nxt_blocks = blocks(c + 1) if c + 1 < chunks else None
        if c >= 1:
            for e, q in enumerate(pos(c - 1)):
                if kept_of[c - 1] >> e & 1:
                    removed = [r | x for r, x in zip(removed, rows[q])]
        if nxt_blocks is not None:
            ahead[c + 1] = nxt_blocks + (removed_bits(c + 1),)
    assert most <= 65
    return keep, most


def _greedy_want(suppress, scores, valid):
    return box_ops.greedy_suppress_ref(
        torch.from_numpy(np.asarray(suppress, bool))[None],
        torch.from_numpy(np.asarray(scores, np.float32))[None, None],
        torch.from_numpy(np.asarray(valid, bool))[None, None])[0, 0].numpy()


@pytest.mark.parametrize("k", [1, 63, 64, 65, 130, 1000])
def test_chunked_walk_matches_greedy(k):
    rng = np.random.default_rng(k)
    density = min(0.5, 8.0 / k)
    suppress = rng.uniform(size=(k, k)) < density
    suppress |= np.eye(k, dtype=bool)
    scores = np.round(rng.uniform(size=k), 1).astype(np.float32)   # ties
    valid = rng.uniform(size=k) > 0.2
    got, _ = chunked_walk(suppress, scores, valid)
    np.testing.assert_array_equal(got, _greedy_want(suppress, scores, valid))
    assert not (got & ~valid).any()
    if k == 130:
        jwant = np.asarray(jbox._greedy_suppress(
            jnp.asarray(scores), jnp.asarray(suppress), jnp.asarray(valid)))
        np.testing.assert_array_equal(got, jwant)
    if k > 1:
        assert 0 < got.sum() < valid.sum()


# ----------------------------------------------------- the bounds' counts
# sample 0: boxes 0 and 1 overlap, 2 and 3 are 0.5 m apart (circles meet),
# the rest far apart; sample 1: box 1 is a sixth of its neighbours' area,
# boxes 3 and 4 overlap
BOUND_SET = torch.tensor([[[0.0, 0.0, 4.0, 2.0, 0.1],
                           [1.0, 0.5, 4.0, 2.0, 0.6],
                           [30.0, 0.0, 2.0, 2.0, 0.0],
                           [32.5, 0.0, 2.0, 2.0, 0.0],
                           [-40.0, 9.0, 1.0, 3.0, 1.0]],
                          [[5.0, 5.0, 2.0, 2.0, 0.0],
                           [5.0, 5.0, 0.8, 0.8, 0.3],
                           [50.0, 5.0, 2.0, 2.0, 0.0],
                           [5.0, 90.0, 2.0, 2.0, 0.0],
                           [5.0, 93.0, 2.0, 5.0, 0.2]]])


def _pair_facts(b, i, j):
    """(circles meet, min / max area, plain intersection area, IoU ops)
    of BOUND_SET's pair (i, j) of sample b, one pair at a time."""
    (xi, yi, dxi, dyi, _), (xj, yj, dxj, dyj, _) = \
        BOUND_SET[b, i].tolist(), BOUND_SET[b, j].tolist()
    reach = (0.5 * math.hypot(dxi, dyi) + 1e-5 / dxi + 1e-5 / dyi
             + 0.5 * math.hypot(dxj, dyj) + 1e-5 / dxj + 1e-5 / dyj)
    meet = math.hypot(xj - xi, yj - yi) <= reach * (1 + 1e-4) + 1e-3
    ratio = min(dxi * dyi, dxj * dyj) / max(dxi * dyi, dxj * dyj)
    lo, hi = BOUND_SET[b, i:i + 1], BOUND_SET[b, j:j + 1]
    area = float(box_ops.rotated_rect_intersection_area(lo, hi))
    return meet, ratio, area, int(box_ops.rotated_iou_ops(lo, hi).sum())


def test_needed_ops_counts_meeting_pairs():
    """The circle cut's count: every pair's circle test, the IoU of the
    pairs whose circles meet."""
    want = 0
    for b in range(2):
        for i in range(5):
            for j in range(i + 1, 5):
                meet, _, _, iou_ops = _pair_facts(b, i, j)
                want += box_ops.NMS_CIRCLE_OPS + (iou_ops if meet else 0)
    got = box_ops.nms_bev_cut_ops(BOUND_SET)
    assert got == want
    # 4 of the 20 pairs meet
    assert box_ops.nms_bev_ops(BOUND_SET) > got > \
        20 * box_ops.NMS_CIRCLE_OPS + 4 * box_ops.IOU3D_OPS_PER_PAIR


def test_needed_ops_takes_each_pairs_cheapest_certificate():
    """The bound's count: per pair the area ratio where it rules IoU >
    0.2 out, else the circle test where the circles are apart, else the
    separating-axis test where the boxes do not intersect, else the
    IoU."""
    want, kinds = 0, {"ratio": 0, "circle": 0, "sat": 0, "iou": 0}
    for b in range(2):
        for i in range(5):
            for j in range(i + 1, 5):
                meet, ratio, area, iou_ops = _pair_facts(b, i, j)
                kind = ("ratio" if ratio <= 0.2 else "circle" if not meet
                        else "sat" if area == 0 else "iou")
                kinds[kind] += 1
                want += dict(ratio=box_ops.NMS_RATIO_OPS,
                             circle=box_ops.NMS_CIRCLE_OPS,
                             sat=box_ops.NMS_SAT_OPS, iou=iou_ops)[kind]
    assert kinds == {"ratio": 4, "circle": 13, "sat": 1, "iou": 2}
    got = box_ops.nms_bev_needed_ops(BOUND_SET, 0.2)
    assert got == want
    assert got < box_ops.nms_bev_cut_ops(BOUND_SET)
    # at threshold 0 the ratio rules nothing out
    assert box_ops.nms_bev_needed_ops(BOUND_SET, 0.0) > got


def test_chunked_walk_on_a_chain():
    """Box i suppresses only box i + 1, in score order: the greedy keeps
    every other box, and each chunk's resolution takes as many rounds as
    the chain is long."""
    k = 130
    suppress = np.eye(k, dtype=bool) | np.eye(k, k=1, dtype=bool)
    scores = np.linspace(1, 0, k).astype(np.float32)
    valid = np.ones(k, bool)
    got, most = chunked_walk(suppress, scores, valid)
    np.testing.assert_array_equal(got, _greedy_want(suppress, scores, valid))
    np.testing.assert_array_equal(got, np.arange(k) % 2 == 0)
    assert most == 64


def _walk_case(name):
    """(suppress, scores, valid) of a named case of the pipelined walk."""
    rng = np.random.default_rng(len(name))
    k = 200
    eye = np.eye(k, dtype=bool)
    scores = rng.uniform(size=k).astype(np.float32)
    valid = np.ones(k, bool)
    if name == "chain_64":
        # in score order, box p suppresses box p + 1 for p < 64 (a chain
        # as long as a chunk, the next chunk hanging on its last box) and
        # box p + 1 of the rest
        scores = np.linspace(1, 0, k).astype(np.float32)
        suppress = eye | np.eye(k, k=1, dtype=bool)
    elif name == "all_suppressing":
        suppress = np.ones((k, k), bool)
    elif name == "none_suppressing":
        suppress = eye.copy()
    elif name == "all_invalid":
        suppress = rng.uniform(size=(k, k)) < 0.05
        valid = np.zeros(k, bool)
    else:   # tied scores, some invalid, the chunks' rows dense
        scores = np.round(scores * 3) / 3
        suppress = (rng.uniform(size=(k, k)) < 0.03) | eye
        valid = rng.uniform(size=k) > 0.3
    return suppress, scores, valid


@pytest.mark.parametrize("name", ["chain_64", "all_suppressing",
                                  "none_suppressing", "all_invalid",
                                  "tied_scores"])
def test_pipelined_walk_cases(name):
    suppress, scores, valid = _walk_case(name)
    got, _ = chunked_walk(suppress, scores, valid)
    np.testing.assert_array_equal(got, _greedy_want(suppress, scores, valid))
    kept = int(got.sum())
    assert kept == dict(all_suppressing=1, none_suppressing=len(scores),
                        all_invalid=0, chain_64=len(scores) // 2).get(
                            name, kept)


def test_pipelined_walk_takes_an_asymmetric_mask():
    """Rows are suppressions "box i suppresses box j", not symmetric: a
    later box that the kept box does not suppress stays, though it would
    suppress the kept box."""
    rng = np.random.default_rng(3)
    k = 150
    suppress = rng.uniform(size=(k, k)) < 0.04
    assert not (suppress == suppress.T).all()
    scores = rng.uniform(size=k).astype(np.float32)
    valid = rng.uniform(size=k) > 0.1
    got, _ = chunked_walk(suppress, scores, valid)
    np.testing.assert_array_equal(got, _greedy_want(suppress, scores, valid))


# ------------------------------------ K10-circle's fused launch, mirrored


def score_keys(scores):
    """uint32 keys of csrc/nms_circle.cu's score order: -0.0 made +0.0,
    every NaN the largest key, else the order-preserving image of the
    float."""
    s = np.asarray(scores, np.float32).copy()
    s[s == 0] = 0.0
    u = s.view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    key[np.isnan(s)] = 0xFFFFFFFF
    return key


def circle_positions(scores, valid):
    """(positions (K,), took the index order): the kernel's step (a)."""
    key = score_keys(scores)
    k = len(key)
    vk = key[valid]
    if (vk[:-1] >= vk[1:]).all():
        return np.arange(k), True
    idx = np.arange(k)
    pos = np.array([int(((key > key[i]) | ((key == key[i]) & (idx < i)))
                        .sum()) for i in range(k)])
    return pos, False


def block_word(c, u, w):
    return 64 * (c * w - c * (c - 1) // 2 + u - c)


def fused_circle(centers, scores, thr, valid):
    """keep (K,) of csrc/nms_circle.cu's algorithm in numpy (a copy: the
    kernel is tested on the card only): the score positions, the upper
    triangle's words in the kernel's layout (each word's place decoded
    from its linear index as the kernel does), the walk chunk by chunk on
    one 64-bit word with the removed words ORed from the kept rows."""
    k = len(scores)
    w = (k + 63) // 64
    pos, _ = circle_positions(scores, valid)
    sx = np.full(64 * w, np.nan, np.float32)
    sy = sx.copy()
    sidx = np.zeros(64 * w, np.int64)
    sval = np.zeros(64 * w, bool)
    sx[pos], sy[pos] = centers[:, 0], centers[:, 1]
    sidx[pos], sval[pos] = np.arange(k), valid
    dx = sx[None, :] - sx[:, None]
    dy = sy[None, :] - sy[:, None]
    with np.errstate(invalid="ignore"):
        near = dx * dx + dy * dy <= np.float32(thr)      # float32, no FMA
    shifts = np.arange(64, dtype=np.uint64)
    bits = np.zeros(32 * w * (w + 1), np.uint64)
    for e in range(0, len(bits), 64):
        q, c = e >> 6, 0
        while q >= w - c:
            q -= w - c
            c += 1
        u = c + q
        assert e == block_word(c, u, w)
        blk = near[64 * c:64 * c + 64, 64 * u:64 * u + 64].astype(np.uint64)
        bits[e:e + 64] = np.bitwise_or.reduce(blk << shifts, axis=1)
    words = [int(x) for x in bits]
    removed = [~int(np.bitwise_or.reduce(
        sval[64 * u:64 * u + 64].astype(np.uint64) << shifts)) & MASK64
        for u in range(w)]
    keep = np.zeros(k, bool)
    for c in range(w):
        alive = ~removed[c] & MASK64
        rows = words[block_word(c, c, w):block_word(c, c, w) + 64]
        kept, rounds = alive, 0
        while True:
            nxt = sum(1 << j for j in range(64) if alive >> j & 1 and
                      not rows[j] & kept & ((1 << j) - 1))
            rounds += 1
            if nxt == kept:
                break
            kept = nxt
        assert rounds <= 65
        for u in range(c + 1, w):
            col = words[block_word(c, u, w):block_word(c, u, w) + 64]
            for j in range(64):
                if kept >> j & 1:
                    removed[u] |= col[j]
        for j in range(64):
            if 64 * c + j < k:
                keep[sidx[64 * c + j]] = bool(kept >> j & 1)
    return keep


def _circle_want(c, s, thr, v):
    return box_ops.circle_nms_mask_ref(torch.from_numpy(c)[None],
                                       torch.from_numpy(s)[None], float(thr),
                                       torch.from_numpy(v)[None])[0].numpy()


@pytest.mark.parametrize("k", [1, 63, 64, 65, 500, 1000])
def test_fused_circle_matches_plain_and_jax(k):
    from isfusion_tpu_torch.testing import circle_nms_sets

    c, s, v, thr = (t.numpy() for t in circle_nms_sets(
        torch.Generator().manual_seed(k), 2, k))
    for r in range(2):
        got = fused_circle(c[r], s[r], thr[r], v[r])
        np.testing.assert_array_equal(got, _circle_want(c[r], s[r], thr[r],
                                                        v[r]))
        assert not (got & ~v[r]).any()
    jwant = np.asarray(jbox.circle_nms_mask(jnp.asarray(c[0]),
                                            jnp.asarray(s[0]), float(thr[0]),
                                            jnp.asarray(v[0])))
    np.testing.assert_array_equal(fused_circle(c[0], s[0], thr[0], v[0]),
                                  jwant)
    # the decode's layout: top-k scores, masked boxes zeroed and invalid,
    # takes the index order and gives the same keep mask
    order = np.argsort(-s[1], kind="stable")
    cs, ss, vs = c[1][order], s[1][order], v[1][order]
    ss = np.where(vs, ss, 0).astype(np.float32)
    assert circle_positions(ss, vs)[1]
    np.testing.assert_array_equal(fused_circle(cs, ss, thr[1], vs),
                                  _circle_want(cs, ss, thr[1], vs))


def test_fused_circle_on_adversarial_sets():
    from isfusion_tpu_torch.testing import circle_nms_adversarial_sets

    for name, c, s, v, thr in circle_nms_adversarial_sets(
            torch.Generator().manual_seed(0)):
        c, s, v = c[0].numpy(), s[0].numpy(), v[0].numpy()
        np.testing.assert_array_equal(fused_circle(c, s, float(thr), v),
                                      _circle_want(c, s, float(thr), v),
                                      err_msg=name)


ODD_SCORES = np.array([0.5, np.nan, -0.0, 0.0, 0.5, np.nan, -1.0, np.inf,
                       -np.inf, 0.0, -0.0, 0.25, np.nan, 0.5],
                      np.float32)


@pytest.mark.parametrize("valid", ["all", "some"])
def test_score_positions_are_torch_sorts(valid):
    """Ties by index, -0.0 tied with +0.0, NaN first (torch.sort
    descending, stable), with and without invalid boxes in the set."""
    v = np.ones(len(ODD_SCORES), bool) if valid == "all" else \
        np.arange(len(ODD_SCORES)) % 3 != 1
    pos, fast = circle_positions(ODD_SCORES, v)
    assert not fast
    order = torch.sort(torch.from_numpy(ODD_SCORES), descending=True,
                       stable=True).indices.numpy()
    np.testing.assert_array_equal(np.argsort(pos), order)
    # NaN first, then +inf; the zeros keep their index order
    assert list(order[:4]) == [1, 5, 12, 7]
    assert [i for i in order if ODD_SCORES[i] == 0] == [2, 3, 9, 10]


def test_fused_circle_on_nan_and_signed_zero_scores():
    rng = np.random.default_rng(7)
    k = 130
    c = (np.round(rng.uniform(-4, 4, (k, 2)) * 2) / 2).astype(np.float32)
    s = np.resize(ODD_SCORES, k)
    v = rng.uniform(size=k) > 0.1
    got = fused_circle(c, s, 1.0, v)
    np.testing.assert_array_equal(got, _circle_want(c, s, 1.0, v))
    assert 0 < got.sum() < v.sum()
    # all scores equal: the index order
    eq = np.full(k, 0.5, np.float32)
    assert circle_positions(eq, v)[1]
    np.testing.assert_array_equal(fused_circle(c, eq, 1.0, v),
                                  _circle_want(c, eq, 1.0, v))


def test_circle_plain_version_matches_jax_past_the_one_launch_size():
    """K = 2,000 (the route of the pairwise and greedy passes): the plain
    version equals the JAX package's ``circle_nms_mask``, and so does the
    route's algorithm: the bits d2 <= thr in index order (symmetric bit for
    bit), walked by the greedy pass in torch.sort's order, with NaN and
    signed-zero scores."""
    from isfusion_tpu_torch.testing import circle_nms_sets

    k = 2000
    c, s, v, thr = (t.numpy() for t in circle_nms_sets(
        torch.Generator().manual_seed(k), 1, k, thresholds=(4.0,)))
    c, s, v, thr = c[0], s[0].copy(), v[0], float(thr[0])
    want = _circle_want(c, s, thr, v)
    jwant = np.asarray(jbox.circle_nms_mask(jnp.asarray(c), jnp.asarray(s),
                                            thr, jnp.asarray(v)))
    np.testing.assert_array_equal(want, jwant)
    s[::97] = np.nan
    s[1::89], s[2::89] = -0.0, 0.0
    d = c[None, :, :] - c[:, None, :]
    near = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] <= np.float32(thr)
    assert (near == near.T).all()
    got, _ = chunked_walk(near, s, v)
    np.testing.assert_array_equal(got, _circle_want(c, s, thr, v))
    assert 0 < got.sum() < v.sum()


def test_circle_route_choice():
    """Up to 1,792 boxes a set the one-launch kernel, past it the pairwise
    and greedy passes, which take 4,000 boxes a set."""
    assert box_ops.circle_kernel(1) == "nms_circle"
    assert box_ops.circle_kernel(box_ops.CIRCLE_MAX_BOXES) == "nms_circle"
    assert box_ops.circle_kernel(box_ops.CIRCLE_MAX_BOXES + 1) == \
        "nms_circle_pairwise"
    assert box_ops.circle_kernel(4000) == "nms_circle_pairwise"
    box_ops._greedy_capacity("circle_nms_mask", 24, 1, 4000)


def test_circle_shared_memory_limit():
    """K = 1,792 (28 words a row) fits a block's 227 KB; 1,793 does not."""
    assert box_ops.circle_smem_bytes(box_ops.CIRCLE_MAX_BOXES) <= 232448
    assert box_ops.circle_smem_bytes(box_ops.CIRCLE_MAX_BOXES + 1) > 232448
    assert box_ops.circle_order_ops(6, 500) == 6 * 500 * 9


def test_center_head_keeps_its_thresholds_on_the_device():
    from isfusion_tpu_torch.flagship import build_centerpoint

    model, _ = build_centerpoint(tiny=True, device="cpu", seed=0)
    head = model.pts_bbox_head
    thr = head._circle_thresholds(2, "cpu")
    assert thr is head._circle_thresholds(2, torch.device("cpu"))
    want = torch.tensor([float(r) for r in head.test_cfg["min_radius"]] * 2)
    assert thr.dtype == torch.float32 and torch.equal(thr, want)
    assert "nms_min_radius" not in head.state_dict()


def test_fused_circle_on_long_chains():
    """Centres 0.9 m apart along a line in score order, threshold 1: each
    box suppresses the next, so a chunk's fixed point takes 64 rounds
    (the most a chunk can take) and keeps every other box."""
    k = 200
    c = np.stack([np.arange(k) * 0.9, np.zeros(k)], -1).astype(np.float32)
    s = np.linspace(1, 0, k).astype(np.float32)
    v = np.ones(k, bool)
    got = fused_circle(c, s, 1.0, v)
    np.testing.assert_array_equal(got, _circle_want(c, s, 1.0, v))
    np.testing.assert_array_equal(got, np.arange(k) % 2 == 0)
