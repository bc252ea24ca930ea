"""The design of K10 (``isfusion_tpu_torch/csrc/boxes_iou_3d.cu``) held on
the CPU, where the kernel cannot run: its two exact cuts
(``box_ops.iou3d_early_outs``, the vertical overlap and the bounding
circles, written in torch as the kernel computes them) never mark a pair
whose plain IoU is not exactly 0, the data-dependent operation count
(``iou3d_needed_ops``) never exceeds the all-pairs one (``iou3d_ops``),
and the wrapper's rows reach the kernel without a copy.

The plain version against the JAX package stays in
``tests/test_torch_train.py::test_boxes_iou_3d_plain_matches_jax``; the
kernel against the plain version is held on the card by
``tests/test_torch_cuda.py``.

The plain versions on degenerate boxes (zero-size, an infinite side
times a zero one, past float32's range), the yardstick of the kernels'
card tests on such boxes.

Tolerance: exact everywhere (boolean masks, zeros and integer counts).
"""
import math

import pytest
import torch

from isfusion_tpu_torch.ops import box_ops
from isfusion_tpu_torch.testing import (degenerate_box_sets, iou_edge_sets,
                                        iou_test_boxes)

EDGE_SETS = {name: (a, b) for name, a, b in iou_edge_sets()}


def _scene(seed, n=200, m=64, r=54.0):
    """Proposals and GTs over a flagship-sized scene, z and sizes as a
    nuScenes frame's."""
    gen = torch.Generator().manual_seed(seed)

    def boxes(k):
        b = torch.empty((k, 7))
        b[:, :2] = (torch.rand((k, 2), generator=gen) * 2 - 1) * r
        b[:, 2] = -3 + torch.rand(k, generator=gen) * 3
        b[:, 3:6] = 0.3 + torch.rand((k, 3), generator=gen) * 6
        b[:, 6] = (torch.rand(k, generator=gen) * 2 - 1) * math.pi
        return b

    return boxes(n), boxes(m)


def _sets():
    out = dict(EDGE_SETS)
    a, b, _ = iou_test_boxes(torch.Generator().manual_seed(2))
    out["iou_test_boxes"] = (a, b)
    for seed in range(2):
        out[f"scene_{seed}"] = _scene(seed)
    return out


SETS = _sets()


@pytest.mark.parametrize("name", sorted(SETS))
def test_cuts_only_mark_exact_zeros(name):
    a, b = SETS[name]
    by_z, by_circle = box_ops.iou3d_early_outs(a, b)
    ref = box_ops.boxes_iou_3d_ref(a, b)
    assert by_z.shape == by_circle.shape == ref.shape
    assert bool((ref[by_z | by_circle] == 0).all())
    if name == "z_stacked":
        # b's bottom exactly on a's top: no vertical overlap, cut
        assert bool(by_z[:, :3].diagonal().all())
        assert bool(by_z[:, 3:].diagonal().all())
    if name == "far_apart":
        assert bool(by_circle.all())
    if name in ("identical", "nested", "rotated_45"):
        assert not bool((by_z | by_circle).diagonal().any())
    if name.startswith("scene") or name == "iou_test_boxes":
        # most pairs of a scene are settled without the intersection
        assert float((by_z | by_circle).float().mean()) > 0.9


def test_cuts_in_a_batch_equal_the_per_sample_cuts():
    a = torch.stack([SETS["scene_0"][0], SETS["scene_1"][0]])
    b = torch.stack([SETS["scene_0"][1], SETS["scene_1"][1]])
    by_z, by_circle = box_ops.iou3d_early_outs(a, b)
    for s, name in enumerate(("scene_0", "scene_1")):
        z1, c1 = box_ops.iou3d_early_outs(*SETS[name])
        assert torch.equal(by_z[s], z1) and torch.equal(by_circle[s], c1)


def test_untame_boxes_are_never_cut():
    """A non-finite or huge value leaves the pair to the exact path (the
    plain version may not give 0 there)."""
    a = torch.tensor([[0.0, 0.0, -1.0, 2.0, 2.0, 1.0, 0.0]]).repeat(4, 1)
    a[1, 3] = float("inf")
    a[2, 5] = float("nan")
    a[3, 0] = 2e8
    b = torch.tensor([[500.0, 0.0, 5.0, 2.0, 2.0, 1.0, 0.0]])
    assert box_ops.iou3d_tame(a).tolist() == [True, False, False, False]
    by_z, by_circle = box_ops.iou3d_early_outs(a, b)
    assert bool(by_z[0, 0]) and bool(by_circle[0, 0])
    assert not bool((by_z | by_circle)[1:].any())


# pair (0, 0) overlaps; (0, 1) lies on a's top (z cut); (0, 2) is 30 m
# away at the same height (circle cut); (0, 3) is 0.1 m past a's edge
# (circles meet, no intersection: a separating-axis certificate)
HAND_A = torch.tensor([[0.0, 0.0, -1.0, 4.0, 2.0, 1.5, 0.0]])
HAND_B = torch.tensor([[1.0, 0.5, -1.2, 4.0, 2.0, 1.5, 0.5],
                       [0.0, 0.0, 0.5, 4.0, 2.0, 1.5, 0.0],
                       [30.0, 0.0, -1.0, 2.0, 2.0, 1.5, 0.0],
                       [3.1, 0.0, -1.0, 2.0, 2.0, 1.5, 0.0]])


def test_needed_ops_takes_each_pairs_cheapest_certificate():
    cols = [0, 1, 3, 4, 6]
    iou_ops = int(box_ops.rotated_iou_ops(HAND_A[:, cols],
                                          HAND_B[:1, cols]).sum())
    want = iou_ops + box_ops.IOU3D_Z_OPS + box_ops.NMS_CIRCLE_OPS + \
        box_ops.NMS_SAT_OPS
    assert box_ops.iou3d_needed_ops(HAND_A, HAND_B) == want
    ref = box_ops.boxes_iou_3d_ref(HAND_A, HAND_B)[0]
    assert float(ref[0]) > 0 and ref[1:].eq(0).all()
    by_z, by_circle = box_ops.iou3d_early_outs(HAND_A, HAND_B)
    assert by_z[0].tolist() == [False, True, False, False]
    assert by_circle[0].tolist() == [False, False, True, False]


@pytest.mark.parametrize("name", sorted(SETS))
def test_needed_ops_at_most_all_pairs(name):
    a, b = SETS[name]
    needed, every = box_ops.iou3d_needed_ops(a, b), box_ops.iou3d_ops(a, b)
    assert 0 < needed <= every
    if name.startswith("scene") or name == "iou_test_boxes":
        assert needed * 10 < every


def test_needed_ops_over_a_batch_is_the_sum():
    a = torch.stack([SETS["scene_0"][0], SETS["scene_1"][0]])
    b = torch.stack([SETS["scene_0"][1], SETS["scene_1"][1]])
    assert box_ops.iou3d_needed_ops(a, b) == sum(
        box_ops.iou3d_needed_ops(*SETS[n]) for n in ("scene_0", "scene_1"))


def test_assigner_rows_reach_the_kernel_without_a_copy():
    """The assigner's (B, Q, 10) and (B, G, 9) rows sliced to 7: views of
    the same storage, unit element stride, the row strides kept."""
    q = torch.randn(4, 200, 10)
    g = torch.randn(4, 64, 9)
    for full, n in ((q, 200), (g, 64)):
        rows = box_ops._iou_rows(full[..., :7], n)
        assert rows.data_ptr() == full.data_ptr()
        assert rows.stride() == full.stride() and rows.shape[-1] == 7
    odd = box_ops._iou_rows(q.transpose(-1, -2).contiguous().transpose(
        -1, -2)[..., :7], 200)
    assert odd.stride(-1) == 1 and odd.shape == (4, 200, 7)


@pytest.mark.parametrize("name", [n for n, _ in degenerate_box_sets()])
def test_plain_iou_on_degenerate_boxes(name):
    """The yardstick the kernels are held to on the card on an untrained
    detector's boxes (``testing.degenerate_box_sets``): two zero-size
    boxes have IoU exactly 0 (their shoelace terms cancel exactly), and a
    box with an infinite side and a zero one has a NaN IoU with every box
    (a NaN area), in BEV and in 3D, and no other pair is NaN."""
    boxes = dict(degenerate_box_sets())[name]
    bev = boxes[:, [0, 1, 3, 4, 6]]
    zero = (bev[:, 2] == 0) & (bev[:, 3] == 0)
    nan_box = bev[:, 2].isinf() & (bev[:, 3] == 0)
    for iou in (box_ops.boxes_iou_bev_ref(bev, bev),
                box_ops.boxes_iou_3d_ref(boxes, boxes)):
        assert torch.equal(iou.isnan(), nan_box[:, None] | nan_box[None, :])
        assert not iou[zero][:, zero].any()
    assert int(zero.sum()) + int(nan_box.sum()) > 0 or name == "huge"
