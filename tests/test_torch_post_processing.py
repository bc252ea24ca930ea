"""The port's post-processing against the JAX package:
``box3d_multiclass_nms`` (one K10-NMS call over the classes, the
class-major top ``max_num``), ``weighted_nms`` (the three cases of
``tests/test_core/test_post_processing.py``, the +-pi yaw wrap among
them, and a crowded scene), ``merge_aug_bboxes_3d`` in plain and
weighted modes over views with flips, rotation and scale, the plain
versions of K10-BEV (``boxes_iou_bev_ref``) and K10-normal
(``nms_normal_bev_mask_ref``), and K10-BEV's exact cut
(``iou_bev_cut``: only pairs whose plain IoU is exactly 0) and bound.

Tolerances: keep masks, top-k picks and labels exact; IoU 1e-5 (the port
computes each pair in a frame centred on its first box, the JAX package
in the scene's frame); merged boxes and scores 1e-6.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.core import post_processing as jpost
from isfusion_tpu.ops import box_ops as jbox
from isfusion_tpu_torch.core import post_processing as tpost
from isfusion_tpu_torch.ops import box_ops
from isfusion_tpu_torch.testing import iou_edge_sets


def boxes_at(centers, yaw=0.0):
    b = np.zeros((len(centers), 7), np.float32)
    b[:, :2] = centers
    b[:, 2] = -1
    b[:, 3:6] = 2.0
    b[:, 6] = yaw
    return b


def _scene(rng, n, spread=6.0, dims=9):
    """n boxes in clusters (duplicates a detector would emit)."""
    centers = rng.uniform(-spread, spread, (max(n // 4, 1), 2))
    b = np.zeros((n, dims), np.float32)
    b[:, :2] = centers[rng.integers(0, len(centers), n)] + rng.normal(
        0, 0.3, (n, 2))
    b[:, 2] = -1.5
    b[:, 3:6] = rng.uniform(0.6, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-math.pi, math.pi, n)
    if dims > 7:
        b[:, 7:] = rng.normal(0, 1, (n, dims - 7))
    return b


@pytest.mark.parametrize("seed", [0, 1])
def test_multiclass_nms_matches(seed):
    rng = np.random.default_rng(seed)
    boxes = _scene(rng, 80)
    scores = rng.uniform(0, 1, (80, 3)).astype(np.float32) ** 2
    valid = rng.uniform(size=80) > 0.1
    want = jpost.box3d_multiclass_nms(jnp.asarray(boxes), jnp.asarray(
        scores), 0.1, 0.2, 60, jnp.asarray(valid))
    got = tpost.box3d_multiclass_nms(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), 0.1, 0.2, 60,
                                     torch.from_numpy(valid))
    for k in ("labels", "mask", "scores", "bboxes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert 10 <= int(got["mask"].sum()) <= 60


def test_multiclass_nms_suppresses_duplicates():
    boxes = torch.from_numpy(boxes_at([[0, 0], [0.1, 0.1], [10, 10]]))
    scores = torch.tensor([[0.9, 0.0], [0.8, 0.0], [0.0, 0.7]])
    out = tpost.box3d_multiclass_nms(boxes, scores, 0.1, 0.3, 4)
    assert int(out["mask"].sum()) == 2
    assert set(out["labels"][out["mask"]].tolist()) == {0, 1}


def _weighted_cases():
    b1 = boxes_at([[0.0, 0.0], [0.3, 0.0], [20, 20]])
    b2 = boxes_at([[0.0, 0.0], [0.1, 0.0], [0.05, 0.0]])
    b2[2, 6] = 1.5
    b3 = np.array([[0, 0, 0, 4, 2, 1.5, 3.10],
                   [0.05, 0, 0, 4, 2, 1.5, -3.10]], np.float32)
    scene = _scene(np.random.default_rng(7), 120, spread=4.0)
    return [("average", b1, np.array([0.8, 0.4, 0.9], np.float32),
             dict(nms_thr=0.3, merge_thr=0.3)),
            ("yaw_outlier", b2, np.array([0.9, 0.5, 0.4], np.float32),
             dict(nms_thr=0.3, merge_thr=0.2)),
            ("yaw_wrap", b3, np.array([0.9, 0.8], np.float32),
             dict(nms_thr=0.3, merge_thr=0.3, yaw_tol=0.5)),
            ("scene", scene, np.random.default_rng(8).uniform(
                0.05, 1, 120).astype(np.float32),
             dict(nms_thr=0.25, merge_thr=0.4))]


@pytest.mark.parametrize("case", _weighted_cases(), ids=lambda c: c[0])
def test_weighted_nms_matches(case):
    name, boxes, scores, kw = case
    wb, ws, wi = jpost.weighted_nms(boxes, scores, **kw)
    gb, gs, gi = tpost.weighted_nms(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), **kw)
    assert gb.dtype == gs.dtype == torch.float64
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), wb, rtol=0,
                               atol=1e-6 * max(np.abs(wb).max(), 1.0))
    if name == "yaw_wrap":
        assert len(gb) == 1
        d = (float(gb[0, 6]) - np.pi + np.pi) % (2 * np.pi) - np.pi
        assert abs(d) < 0.1
    if name == "scene":
        assert 5 < len(gb) < 100


def _views(rng):
    """Four views of one set of detections: none, horizontal flip,
    vertical flip and both, the last also rotated and scaled."""
    base = _scene(rng, 60)
    scores = rng.uniform(0.05, 1, 60).astype(np.float32)
    labels = rng.integers(0, 3, 60)
    metas = [dict(), dict(pcd_horizontal_flip=True),
             dict(pcd_vertical_flip=True),
             dict(pcd_horizontal_flip=True, pcd_vertical_flip=True,
                  pcd_rotation=0.3, pcd_scale_factor=1.05)]
    results = []
    for i, meta in enumerate(metas):
        b = base + rng.normal(0, 0.05, base.shape).astype(np.float32)
        b[:, 3:6] = np.abs(b[:, 3:6])
        if meta.get("pcd_vertical_flip"):
            b[:, 0] = -b[:, 0]
            b[:, 6] = -b[:, 6] - np.pi
            b[:, 7] = -b[:, 7]
        if meta.get("pcd_horizontal_flip"):
            b[:, 1] = -b[:, 1]
            b[:, 6] = -b[:, 6]
            b[:, 8] = -b[:, 8]
        if meta.get("pcd_rotation"):
            th = meta["pcd_rotation"]
            c, s = math.cos(th), math.sin(th)
            rot = np.array([[c, -s], [s, c]], np.float32)
            b[:, :2] = b[:, :2] @ rot
            b[:, 7:9] = b[:, 7:9] @ rot
            b[:, 6] += th
        if meta.get("pcd_scale_factor"):
            b[:, :6] *= meta["pcd_scale_factor"]
        mask = rng.uniform(size=60) > 0.1
        results.append(dict(bboxes=b.astype(np.float32), scores=(
            scores * rng.uniform(0.8, 1.0, 60)).astype(np.float32),
            labels=labels, mask=mask))
    return results, metas


@pytest.mark.parametrize("weighted", [False, True])
def test_merge_aug_matches(weighted):
    results, metas = _views(np.random.default_rng(3))
    kw = dict(score_thr=0.1, nms_thr=0.25, max_num=100,
              use_weighted_nms=weighted, merge_thr=0.5)
    want = jpost.merge_aug_bboxes_3d(results, metas, **kw)
    got = tpost.merge_aug_bboxes_3d(
        [{k: torch.from_numpy(np.asarray(v)) for k, v in r.items()}
         for r in results], metas, **kw)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-6)
    wb = np.asarray(want["bboxes"])
    np.testing.assert_allclose(got["bboxes"].numpy(), wb, rtol=0,
                               atol=1e-6 * np.abs(wb).max())
    assert int(got["mask"].sum()) >= 10


def test_merge_aug_undoes_flip():
    base = boxes_at([[5, 3]], yaw=0.4)
    flipped = base.copy()
    flipped[:, 1] *= -1
    flipped[:, 6] *= -1
    res = [dict(bboxes=torch.from_numpy(base), scores=torch.tensor([0.9]),
                labels=torch.tensor([0])),
           dict(bboxes=torch.from_numpy(flipped), scores=torch.tensor([0.8]),
                labels=torch.tensor([0]))]
    merged = tpost.merge_aug_bboxes_3d(res, [dict(), dict(
        pcd_horizontal_flip=True)], nms_thr=0.3, max_num=4)
    assert int(merged["mask"].sum()) == 1
    np.testing.assert_allclose(merged["bboxes"][0, :2].numpy(), [5, 3],
                               atol=1e-5)


# ---------------------------------------------------- K10-BEV, K10-normal
def _bev_sets():
    """A crowded scene against itself and a second one, then the edge
    sets of K10's cuts (``testing.iou_edge_sets``: touching, nested,
    identical, rotated by 45 degrees, far apart) as BEV boxes."""
    rng = np.random.default_rng(11)
    cols = [0, 1, 3, 4, 6]
    scene, other = (_scene(rng, n)[:, cols] for n in (90, 40))
    sets = [("scene", scene, scene), ("scenes", scene, other)]
    sets += [(name, a[:, cols].numpy(), b[:, cols].numpy())
             for name, a, b in iou_edge_sets()]
    return sets


@pytest.mark.parametrize("case", _bev_sets()[:2], ids=lambda c: c[0])
def test_boxes_iou_bev_ref_matches_jax(case):
    _, a, b = case
    want = np.asarray(jbox.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got = box_ops.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (want > 0.1).sum() >= 20


@pytest.mark.parametrize("case", _bev_sets(), ids=lambda c: c[0])
def test_iou_bev_cut_is_exact(case):
    """K10-BEV's cut settles only pairs whose plain IoU is exactly 0 (the
    edge sets' touching pairs are where the scene-frame arithmetic of the
    JAX package and the box frame of the port round apart), and its
    data-dependent bound counts no more than the exact IoU of every
    pair."""
    a, b = (torch.from_numpy(x) for x in case[1:])
    plain = box_ops.boxes_iou_bev_ref(a, b)
    cut = box_ops.iou_bev_cut(a, b)
    assert (plain[cut] == 0).all()
    assert box_ops.iou_bev_needed_ops(a, b) <= int(
        box_ops.rotated_iou_ops(a, b).sum())


def test_boxes_iou_bev_batches_and_checks():
    rng = np.random.default_rng(12)
    a = torch.from_numpy(_scene(rng, 30)[:, [0, 1, 3, 4, 6]])
    b = torch.from_numpy(_scene(rng, 20)[:, [0, 1, 3, 4, 6]])
    batched = box_ops.boxes_iou_bev(torch.stack([a, b[:10].repeat(3, 1)]),
                                    torch.stack([b, a[:20]]))
    assert batched.shape == (2, 30, 20)
    torch.testing.assert_close(batched[0], box_ops.boxes_iou_bev(a, b),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="equal leading dims"):
        box_ops.boxes_iou_bev(a[None], b)
    with pytest.raises(ValueError, match=">=5"):
        box_ops.boxes_iou_bev(a[:, :4], b[:, :4])


def _xyxy(rng, n):
    c = rng.uniform(-10, 10, (n, 2))
    d = rng.uniform(0.3, 4, (n, 2))
    return np.concatenate([c - d / 2, c + d / 2], 1).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "duplicates", "degenerate"])
def test_nms_normal_ref_matches_jax(kind):
    rng = np.random.default_rng(13)
    boxes = _xyxy(rng, 70)
    if kind == "duplicates":
        boxes[35:] = boxes[:35] + rng.normal(0, 0.05, (35, 4)).astype(
            np.float32)
    elif kind == "degenerate":
        boxes[:10, 2] = boxes[:10, 0]            # zero width
        boxes[10:20] = boxes[20:30]              # identical
        boxes[30:35, 2] = boxes[30:35, 0] - 1.0  # inverted
    scores = rng.uniform(0, 1, (2, 70)).astype(np.float32)
    scores[1, :8] = 0.5                          # ties
    valid = rng.uniform(size=(2, 70)) > 0.2
    want = np.stack([np.asarray(jbox.nms_normal_bev_mask(
        jnp.asarray(boxes), jnp.asarray(scores[c]), 0.3,
        jnp.asarray(valid[c]))) for c in range(2)])
    got = box_ops.nms_normal_bev_mask(
        torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], 0.3,
        torch.from_numpy(valid)[None])
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert 0 < want.sum() < valid.sum()
    iou = box_ops.normal_iou_ref(torch.from_numpy(boxes)[None])[0]
    assert torch.equal(iou, iou.T)


def test_nms_normal_checks_shapes():
    boxes = torch.zeros((1, 5, 5))
    with pytest.raises(ValueError, match=r"\(B, K, 4\)"):
        box_ops.nms_normal_bev_mask(boxes, torch.zeros((1, 1, 5)), 0.3)
    with pytest.raises(ValueError, match="scores"):
        box_ops.nms_normal_bev_mask(torch.zeros((1, 5, 4)),
                                    torch.zeros((1, 1, 4)), 0.3)


def test_greedy_pass_takes_the_merge_size():
    """The greedy pass of K10-NMS and K10-normal holds only one class's
    removed words in a block's shared memory (``greedy_smem_bytes``), one
    block a (sample, class): four views of 500 boxes at one or ten classes,
    33 and 64 classes, and K = 58,113 at 32 classes (all refused before)
    are taken, up to K = 1,826,688; past it, or past 65,535 samples, the
    wrapper refuses before any launch. At 33 classes the pass's algorithm
    (``test_torch_nms.chunked_walk``) equals the plain walk."""
    from test_torch_nms import chunked_walk

    assert box_ops.greedy_smem_bytes(2000) == 4112 + 32 * 8 * 321
    assert box_ops.greedy_staged(5632) and not box_ops.greedy_staged(5633)
    assert box_ops.greedy_smem_bytes(5633) == 4112 + 89 * 8
    for b, c, k in ((1, 1, 2000), (1, 10, 2000), (1, 33, 64), (1, 64, 300),
                    (1, 32, 58113), (1, 1, 1826688), (65535, 1, 64)):
        box_ops._greedy_capacity("nms_bev_mask", b, c, k)
    for b, c, k in ((1, 1, 1826689), (65536, 1, 64)):
        with pytest.raises(ValueError, match="shared memory"):
            box_ops._greedy_capacity("nms_bev_mask", b, c, k)
    rng = np.random.default_rng(33)
    boxes = _xyxy(rng, 64)
    scores = rng.uniform(size=(33, 64)).astype(np.float32)
    valid = rng.uniform(size=(33, 64)) > 0.2
    bits = (box_ops.normal_iou_ref(torch.from_numpy(boxes)[None]) > 0.1)[0]
    want = box_ops.nms_normal_bev_mask(torch.from_numpy(boxes)[None],
                                       torch.from_numpy(scores)[None], 0.1,
                                       torch.from_numpy(valid)[None])[0]
    for c in range(33):
        got, _ = chunked_walk(bits.numpy(), scores[c], valid[c])
        np.testing.assert_array_equal(got, want[c].numpy())
    assert 0 < int(want.sum()) < int(valid.sum())


def _normal_sets():
    from isfusion_tpu_torch.testing import nms_normal_edge_sets

    rng = np.random.default_rng(8)
    odd = _xyxy(rng, 60)
    odd[::7] = np.nan
    odd[1::7, :2] = -0.0
    odd[2::7, 2] = np.inf
    return [("random", torch.from_numpy(_xyxy(rng, 90))[None]),
            ("nan_zero_inf", torch.from_numpy(odd)[None])] + \
        [(name, b) for name, b, _, _ in nms_normal_edge_sets(
            torch.Generator().manual_seed(5))]


@pytest.mark.parametrize("case", range(10))
def test_normal_iou_ref_is_symmetric_bit_for_bit(case):
    """The plain axis-aligned IoU equals its transpose bit for bit (int32
    views, so NaN positions and signed zeros count): K10-normal computes
    each unordered pair once and mirrors it."""
    name, boxes = _normal_sets()[case]
    iou = box_ops.normal_iou_ref(boxes)
    bits = iou.view(torch.int32)
    assert torch.equal(bits, bits.transpose(1, 2)), name
    if name == "nan_zero_inf":
        assert bool(iou.isnan().any())


def test_iou_tile_counts_find_the_crowded_tiles():
    """The listed pairs per 16 x 32 tile of K10-BEV's kernel: a sorted set
    whose near pairs lie on the diagonal gives its largest count on a
    diagonal tile, many times the mean."""
    rng = np.random.default_rng(4)
    centers = np.repeat(rng.uniform(-50, 50, (40, 2)), 4, 0)
    bev = np.zeros((160, 5), np.float32)
    bev[:, :2] = centers + rng.normal(0, 0.1, (160, 2))
    bev[:, 2:4] = 2.0
    b = torch.from_numpy(bev)
    listed = ~box_ops.iou_bev_cut(b, b)
    counts = box_ops.iou_tile_counts(listed)
    assert counts.shape == (10 * 5,)
    assert int(counts.sum()) == int(listed.sum())
    grid = counts.view(10, 5)
    assert int(grid.max()) == int(max(grid[r, r // 2] for r in range(10)))
    assert float(grid.max()) > 4 * float(counts.float().mean())


def test_collate_points_multi_variant_batches_at_the_merge():
    """A batch of several test-time variants is refused, with a message
    naming the merge of their results (as the JAX collate's does)."""
    from isfusion_tpu.datasets.builder import collate_batch as jcollate
    from isfusion_tpu_torch.datasets.builder import collate_batch

    sample = dict(points=np.zeros((3, 4), np.float32))
    batch = [[sample, sample]]
    for fn in (collate_batch, jcollate):
        with pytest.raises(NotImplementedError,
                           match=r"core\.post_processing\.merge_aug_bboxes_3d"):
            fn(batch)
    got = collate_batch([[sample]])
    assert got["points"].shape == (1, 3, 4)
