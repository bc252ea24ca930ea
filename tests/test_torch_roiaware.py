"""K16's design on the CPU: the exact cut in front of the membership test
(``roiaware_cut_ref``, the plain mirror of ``csrc/roiaware_pool.cu``'s
cut) keeps every pair the plain membership puts inside, on the adversarial
sets and on seeded sets of RoIs of many sizes and yaws with centres on and
around their faces; the membership bitmap's layout; the forward's and
backward's bounds counted by hand on a small set."""
import math

import numpy as np
import pytest
import torch

from isfusion_tpu_torch.ops import roiaware_pool as rp
from isfusion_tpu_torch.testing import roiaware_adversarial_sets

# the faces of a unit cell axis: u = 0 (inside), u = 1 - 2^-24 (inside, the
# last cell), u = 1 and just below 0 (outside)
FACE_U = np.array([0.0, 1.0 - 2.0 ** -24, 1.0, -2.0 ** -24, 0.5],
                  np.float64)


def _assert_cut_keeps_inside(rois, centers, mask):
    rois, centers, mask = (torch.as_tensor(a) for a in (rois, centers, mask))
    inside = rp.roiaware_cells_ref(rois, centers, mask, 6) >= 0
    cut = rp.roiaware_cut_ref(rois, centers, mask)
    lost = inside & ~cut
    assert not lost.any(), torch.nonzero(lost)[:10]
    return int(inside.sum()), int(cut.sum()), cut.numel()


@pytest.mark.parametrize("seed", [4, 6])
def test_cut_keeps_every_inside_pair_on_adversarial_sets(seed):
    for name, rois, centers, _, mask in roiaware_adversarial_sets(
            np.random.default_rng(seed)):
        inside, through, _ = _assert_cut_keeps_inside(rois, centers, mask)
        assert through >= inside, name


def _face_set(gen: np.random.Generator, r: int = 64, per_roi: int = 125):
    """RoIs of 1e-5 to 60 m sides (a quarter below 1e-3), yaws uniform and
    on the quarter turns (and one of 1e4 rad), bottoms and centres up to
    80 m from the origin; for each, centres placed in its frame on and
    beside its faces and corners (``FACE_U`` on each axis) and at random,
    moved to the world in float32 (so rounding puts some just in, some
    just out)."""
    rois = np.zeros((1, r, 7), np.float32)
    rois[0, :, :2] = gen.uniform(-80, 80, (r, 2))
    rois[0, :, 2] = gen.uniform(-3, 3, r)
    rois[0, :, 3:6] = np.exp(gen.uniform(np.log(1e-5), np.log(60), (r, 3)))
    rois[0, : r // 4, 3:6] = gen.uniform(0.0, 1e-3, (r // 4, 3))
    yaw = gen.uniform(-np.pi, np.pi, r)
    yaw[:8] = [0, np.pi / 2, np.pi, -np.pi, -np.pi / 2, np.pi / 4, 1e4,
               3 * np.pi / 2]
    rois[0, :, 6] = yaw
    box = torch.from_numpy(rois[0])
    trig = rp.box_trig(box).numpy()
    # the plain test divides by max(d, 1e-3): the faces of the clamped box
    dims = np.maximum(rois[0, :, 3:6], np.float32(1e-3))
    pts = []
    for i in range(r):
        u = np.stack([gen.choice(FACE_U, per_roi) for _ in range(3)], -1)
        u[: per_roi // 5] = gen.uniform(-0.1, 1.1, (per_roi // 5, 3))
        local = ((u - 0.5) * dims[i]).astype(np.float32)
        c, s = trig[i]
        wx = local[:, 0] * c + local[:, 1] * s
        wy = -local[:, 0] * s + local[:, 1] * c
        wz = local[:, 2] + np.float32(rois[0, i, 5]) * np.float32(0.5)
        pts.append(np.stack([wx + rois[0, i, 0], wy + rois[0, i, 1],
                             wz + rois[0, i, 2]], -1).astype(np.float32))
    centers = np.concatenate(pts)[None]
    return rois, centers, np.ones(centers.shape[:2], bool)


@pytest.mark.parametrize("seed", range(4))
def test_cut_keeps_every_inside_pair_on_faces(seed):
    inside, through, pairs = _assert_cut_keeps_inside(
        *_face_set(np.random.default_rng(seed)))
    # the sets reach the faces: many pairs inside, and the cut still
    # settles most of the (RoI, voxel) pairs
    assert inside > 1000 and through < pairs / 4


def test_cut_needs_its_slack():
    """Without the relative and absolute slack the same circle and slab
    lose inside pairs on the face sets: the sets test the argument, not a
    loose cut."""
    old = rp.ROIAWARE_CUT_REL, rp.ROIAWARE_CUT_ABS
    lost = 0
    try:
        rp.ROIAWARE_CUT_REL, rp.ROIAWARE_CUT_ABS = 1.0, 0.0
        for seed in range(4):
            rois, centers, mask = (torch.as_tensor(a) for a in _face_set(
                np.random.default_rng(seed)))
            inside = rp.roiaware_cells_ref(rois, centers, mask, 6) >= 0
            lost += int((inside & ~rp.roiaware_cut_ref(rois, centers,
                                                       mask)).sum())
    finally:
        rp.ROIAWARE_CUT_REL, rp.ROIAWARE_CUT_ABS = old
    assert lost > 0


def test_bitmap_ref_layout():
    cells = torch.full((2, 3, 70), -1, dtype=torch.int64)
    cells[0, 0, 0] = 5
    cells[0, 0, 31] = 0
    cells[0, 1, 33] = 2
    cells[1, 2, 69] = 7
    words = rp.roiaware_bitmap_ref(cells)
    assert words.dtype == torch.int32 and words.shape == (2, 3, 3)
    want = torch.zeros((2, 3, 3), dtype=torch.int32)
    want[0, 0, 0] = -(2 ** 31) + 1
    want[0, 1, 1] = 2
    want[1, 2, 2] = 1 << 5
    assert torch.equal(words, want)
    assert rp.roiaware_bitmap_ref(cells[..., :0]).shape == (2, 3, 0)


def test_bound_counts_by_hand():
    """One sample, two RoIs (a 2 m cube at the origin, bottom at -1, and
    one 70 m away), five voxels (one masked), C 3, G 2: the cut lets
    three pairs through (the cube's two inside voxels and one within its
    circle but outside it), two are inside, both in cell 7."""
    rois = torch.tensor([[[0, 0, -1, 2, 2, 2, 0],
                          [50, 50, -1, 2, 2, 2, 0.3]]], dtype=torch.float32)
    centers = torch.tensor([[[0, 0, 0], [0.9, 0.9, 0], [1.2, 0, 0],
                             [5, 5, 0], [0, 0, 0]]], dtype=torch.float32)
    mask = torch.tensor([[True, True, True, True, False]])
    cells = rp.roiaware_cells_ref(rois, centers, mask, 2)
    cut = rp.roiaware_cut_ref(rois, centers, mask)
    assert cells[0, 0].tolist() == [7, 7, -1, -1, -1]
    assert (cells[0, 1] < 0).all()
    assert cut[0].tolist() == [[True, True, True, False, False],
                               [False] * 5]
    valid, r, c, g = 4, 2, 3, 2
    ops = rp.roiaware_pool_ops(valid, r, int(cut.sum()),
                               int((cells >= 0).sum()), c, 1 * r * g ** 3)
    assert ops == 4 * 2 * 10 + 3 * 18 + 2 * (3 + 3) + 16 * 3 == 194
    assert rp.roiaware_pool_backward_ops(2, c) == 2 * 2 * 3 == 12
    assert rp.roiaware_pool_bytes(1, r, 5, c, g, valid, 2) == \
        56 + 5 + 48 + 24 + 192
    assert rp.roiaware_pool_backward_bytes(1, r, 5, c, 2, 1) == \
        8 + 4 + 16 + 60
    ms, by = rp.roiaware_bound_ms(325, 194, 3.35e12, 67e12)
    assert by == "bytes" and math.isclose(ms, 325 / 3.35e12 * 1e3)


def test_smem_limit_refuses_what_no_block_holds():
    assert rp.roiaware_smem_bytes(6, 20) == max(34 * 216 * 4 + 256,
                                                25088 + 32 * 21 * 4)
    rois = torch.zeros((1, 1, 7))
    centers = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError, match="shared memory"):
        rp._kernel_args(rois, centers, torch.ones((1, 4), dtype=torch.bool),
                        12, 20)
    with pytest.raises(ValueError, match="shared memory"):
        rp._kernel_args(rois, centers, torch.ones((1, 4), dtype=torch.bool),
                        6, 2000)
