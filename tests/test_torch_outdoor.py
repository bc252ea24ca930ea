"""The port's host voxelizer, outdoor LiDAR transforms and YOLOX PAFPN
against the JAX package: ``VoxelGenerator`` (first-seen voxel order, the
per-voxel and voxel caps, (z, y, x) coordinates) bit for bit;
``ObjectNoise``, ``RandomJitterPoints``, ``BackgroundPointsFilter`` and
``VoxelBasedPointSampler`` bit for bit under the same draws (JAX seeded
with ``np.random.seed(s)``, the port given ``results['rng'] =
np.random.RandomState(s)``); ``YOLOXPAFPN`` (``tests/test_models/
test_extra_backbones.py``'s shapes) in outputs and gradients, train and
eval mode, on carried weights (1e-4 of the max: float32 sums in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.core.bbox.structures import \
    LiDARInstance3DBoxes as JaxBoxes
from isfusion_tpu.core.points import LiDARPoints as JaxPoints
from isfusion_tpu.core.voxel_generator import VoxelGenerator as JaxVG
from isfusion_tpu.datasets.pipelines import transforms_3d as jtrans
from isfusion_tpu.models.necks.yolox_pafpn import YOLOXPAFPN as JaxPAFPN
from isfusion_tpu_torch.core.bbox.structures import LiDARInstance3DBoxes
from isfusion_tpu_torch.core.points import LiDARPoints
from isfusion_tpu_torch.core.voxel_generator import VoxelGenerator
from isfusion_tpu_torch.datasets.pipelines import transforms_3d as ttrans
from isfusion_tpu_torch.flagship import _lidar_cloud
from isfusion_tpu_torch.models.necks.yolox_pafpn import YOLOXPAFPN
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from torch_parity import assert_close_to_max, load_from_jax, random_variables


def _scene(seed: int, n_points: int = 6000, time_dim: bool = False):
    """A ray-cast cloud (x, y, z, intensity[, time]) with 8 boxes, two
    pairs of them touching, and extra points inside each box."""
    rng = np.random.default_rng(seed)
    xyz = _lidar_cloud(rng, n_points, (-30, -30, -3, 30, 30, 1), sweeps=2,
                       sensor_height=1.73)
    boxes = np.zeros((8, 7), np.float32)
    boxes[:, 0] = rng.uniform(-20, 20, 8)
    boxes[:, 1] = rng.uniform(-20, 20, 8)
    boxes[:, 2] = -1.7
    boxes[:, 3:6] = rng.uniform([1.5, 3.5, 1.4], [2.0, 4.5, 1.7], (8, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 8)
    boxes[1, :2] = boxes[0, :2] + [0.5, 2.0]         # overlapping pairs
    boxes[3, :2] = boxes[2, :2] + [1.8, 0.0]
    inside = [b[:3] + rng.uniform(-0.4, 0.4, (60, 3)) * b[3:6] +
              [0, 0, b[5] / 2] for b in boxes]
    xyz = np.concatenate([xyz] + inside).astype(np.float32)
    cols = [xyz, rng.uniform(0, 1, (len(xyz), 1))]
    if time_dim:
        cols.append((rng.uniform(size=(len(xyz), 1)) < 0.5) * 0.05)
    pts = np.concatenate(cols, 1).astype(np.float32)
    return pts, boxes, rng.integers(0, 3, 8)


def _results(pts, boxes, labels):
    c = pts.shape[1]
    return (dict(points=JaxPoints(pts.copy(), points_dim=c),
                 gt_bboxes_3d=JaxBoxes(boxes.copy()),
                 gt_labels_3d=labels.copy()),
            dict(points=LiDARPoints(pts.copy(), points_dim=c),
                 gt_bboxes_3d=LiDARInstance3DBoxes(boxes.copy()),
                 gt_labels_3d=labels.copy()))


@pytest.mark.parametrize("caps", [(5, 20000), (1, 20000), (3, 150),
                                  (64, 50)])
def test_voxel_generator_matches_jax(caps):
    pts, _, _ = _scene(0)
    pts = pts[np.random.default_rng(1).permutation(len(pts))]
    kw = dict(voxel_size=[0.8, 0.8, 1.0],
              point_cloud_range=[-20, -20, -3, 20, 20, 1],
              max_num_points=caps[0], max_voxels=caps[1])
    want = JaxVG(**kw).generate(pts)
    got = VoxelGenerator(**kw).generate(pts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # the caps bite: a full voxel at the small per-voxel caps, the voxel
    # count at the small voxel caps
    assert want[2].max() <= caps[0] and len(want[1]) <= caps[1]
    if caps[0] <= 5:
        assert (want[2] == caps[0]).any()
    if caps[1] <= 150:
        assert len(want[1]) == caps[1]
    assert np.array_equal(VoxelGenerator(**kw).grid_size,
                          JaxVG(**kw).grid_size)


def test_voxel_generator_empty_cloud():
    kw = dict(voxel_size=[1, 1, 1], point_cloud_range=[0, 0, 0, 4, 4, 4],
              max_num_points=3, max_voxels=10)
    pts = np.full((5, 4), -1.0, np.float32)
    for g, w in zip(VoxelGenerator(**kw).generate(pts),
                    JaxVG(**kw).generate(pts)):
        assert g.shape == w.shape and g.dtype == w.dtype


TRANSFORMS = {
    "object_noise": lambda m: m.ObjectNoise(
        translation_std=[1.0, 1.0, 0.5], rot_range=[-0.78539816, 0.78539816],
        num_try=100),
    "object_noise_tight": lambda m: m.ObjectNoise(
        translation_std=[0.05, 0.05, 0.05], rot_range=[-0.01, 0.01],
        num_try=1),
    "jitter": lambda m: m.RandomJitterPoints(jitter_std=[0.01, 0.02, 0.03],
                                             clip_range=[-0.05, 0.05]),
    "jitter_unclipped": lambda m: m.RandomJitterPoints(jitter_std=0.1,
                                                       clip_range=None),
    "background_filter": lambda m: m.BackgroundPointsFilter(
        bbox_enlarge_range=[0.5, 2.0, 0.5]),
}


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, seed):
    jres, tres = _results(*_scene(seed))
    n_in = len(tres["points"])
    np.random.seed(seed)
    want = TRANSFORMS[name](jtrans)(jres)
    tres["rng"] = np.random.RandomState(seed)
    got = TRANSFORMS[name](ttrans)(tres)
    np.testing.assert_array_equal(got["points"].tensor, want["points"].tensor)
    np.testing.assert_array_equal(got["gt_bboxes_3d"].tensor,
                                  want["gt_bboxes_3d"].tensor)
    if name == "background_filter":
        assert 0 < len(got["points"]) < n_in
    elif name.startswith("object_noise"):
        moved = (got["gt_bboxes_3d"].tensor != _scene(seed)[1]).any(1)
        assert moved.any()
        if name == "object_noise_tight":
            assert not moved[:2].any()      # the overlapping pair stays


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("seed", [0, 2])
def test_voxel_based_point_sampler_matches_jax(prev, seed):
    pts, boxes, labels = _scene(seed, n_points=3000, time_dim=True)
    jres, tres = _results(pts, boxes, labels)
    sem = np.random.default_rng(seed).integers(0, 5, len(pts))
    for res in (jres, tres):
        res["pts_semantic_mask"] = sem.copy()
        res["pts_seg_fields"] = ["pts_semantic_mask"]
    # one point a voxel, as the reference's configs sample
    cur = dict(voxel_size=[1.0, 1.0, 4.0], max_voxels=300, max_num_points=1,
               point_cloud_range=[-20, -20, -3, 20, 20, 1])
    kw = dict(cur_sweep_cfg=cur, time_dim=4, prev_sweep_cfg=dict(
        cur, max_voxels=200) if prev else None)
    np.random.seed(seed)
    want = jtrans.VoxelBasedPointSampler(**kw)(jres)
    tres["rng"] = np.random.RandomState(seed)
    got = ttrans.VoxelBasedPointSampler(**kw)(tres)
    np.testing.assert_array_equal(got["points"].tensor, want["points"].tensor)
    np.testing.assert_array_equal(got["pts_semantic_mask"],
                                  want["pts_semantic_mask"])
    assert got["points"].tensor.shape == ((500 if prev else 300), 5)


@pytest.mark.parametrize("train", [False, True])
def test_yolox_pafpn_matches_jax(train):
    rng = np.random.default_rng(2)
    ins = [rng.normal(size=(2, s, s, c)).astype(np.float32)
           for s, c in [(16, 8), (8, 16), (4, 32)]]
    kw = dict(in_channels=[8, 16, 32], out_channels=8, num_csp_blocks=1)
    jneck = JaxPAFPN(**kw)
    variables = random_variables(jneck, [jnp.asarray(x) for x in ins],
                                 seed=3)
    probes = [rng.normal(size=(2, s, s, 8)).astype(np.float32)
              for s in (16, 8, 4)]

    def fn(params, xs):
        outs = jneck.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, xs,
                           train=train, mutable=["batch_stats"])[0]
        return sum(jnp.sum(o * p) for o, p in zip(outs, probes)), outs

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True))(variables["params"],
                                           [jnp.asarray(x) for x in ins])
    port = load_from_jax(YOLOXPAFPN(**kw), variables, "neck_m",
                         "neck").train(train)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    got = port(xs)
    sum((o * torch.from_numpy(p)).sum() for o, p in zip(got, probes)) \
        .backward()
    assert [tuple(o.shape) for o in got] == [(2, 16, 16, 8), (2, 8, 8, 8),
                                            (2, 4, 4, 8)]
    for g, w in zip(got, want):
        assert_close_to_max(g.detach().numpy(), np.asarray(w), 1e-4)
    for x, w in zip(xs, gx):
        assert_close_to_max(x.grad.numpy(), np.asarray(w), 1e-4)
    jg = state_dict_from_jax({"params": {"neck_m": jax.device_get(gp)}})
    names = dict(port.named_parameters())
    assert len(names) == len(jax.tree_util.tree_leaves(gp)) > 60
    for name, p in names.items():
        assert_close_to_max(p.grad.numpy(), jg[f"neck.{name}"].numpy(), 1e-4)
