"""The port's PointPillars (MVXFasterRCNN, nuScenes config) against the JAX
package: anchors, the residual box coder, capped hard voxelization,
HardVFE / PillarFeatureNet with masked BatchNorm, PointPillarsScatter,
SECOND and SECONDFPN, the smooth-L1 and cross-entropy losses, rotated-BEV
NMS (the plain version of K10-NMS), Anchor3DHead's losses and
``get_bboxes``, the whole tiny detector's predict, loss and gradients, one
train step with the ``schedule_2x`` recipe, and the step schedule.

Inputs are numpy arrays made from a seed and handed to both packages;
JAX variables are drawn with numpy (``tests/torch_parity.py``) and carried
with ``state_dict_from_jax``. The JAX detector runs eagerly, its
``make_train_step`` included (see ``test_train_step_matches_jax``: the
compiled step's VFE gradient is wrong under the suite's XLA flags).
The head and whole-detector
predict tests run ``nms_pre=200`` on both sides (the JAX NMS materialises
K x K x 24 candidate points per class, eagerly).

Tolerances (float32, CPU): anchors, voxel tables, scatter and NMS keep
masks exact; coder 1e-6 of the max; modules (VFE, SECOND, FPN) 1e-3 of the
max and BN running statistics 1e-5 (summation order differs); loss terms
1e-4 relative; detector gradients 1e-3 of each top-level module's max;
predicted boxes 1e-4 of the max on the kept entries, which must be the
same entries with the same labels; schedule 1e-7 relative.
"""
import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu import flagship as jflagship
from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.models import losses as jlosses
from isfusion_tpu.models.backbones.second import SECOND as JaxSECOND
from isfusion_tpu.models.dense_heads.anchor3d_head import \
    Anchor3DHead as JaxHead
from isfusion_tpu.models.middle_encoders.pillar_scatter import \
    PointPillarsScatter as JaxScatter
from isfusion_tpu.models.necks.second_fpn import SECONDFPN as JaxFPN
from isfusion_tpu.models.voxel_encoders import HardVFE as JaxHardVFE
from isfusion_tpu.models.voxel_encoders import \
    PillarFeatureNet as JaxPillarNet
from isfusion_tpu.ops import box_ops as jbox
from isfusion_tpu.ops import voxel as jvoxel
from isfusion_tpu.core.bbox.coders import \
    DeltaXYZWLHRBBoxCoder as JaxCoder
from isfusion_tpu.parallel.train_step import TrainState, total_loss
from isfusion_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from isfusion_tpu.runner import optim as joptim
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.core.bbox.coders import DeltaXYZWLHRBBoxCoder
from isfusion_tpu_torch.models import losses as tlosses
from isfusion_tpu_torch.models.backbones.second import SECOND
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.dense_heads.anchor3d_head import Anchor3DHead
from isfusion_tpu_torch.models.middle_encoders.pillar_scatter import \
    PointPillarsScatter
from isfusion_tpu_torch.models.necks.second_fpn import SECONDFPN
from isfusion_tpu_torch.models.voxel_encoders import HardVFE, \
    PillarFeatureNet
from isfusion_tpu_torch.ops import box_ops, voxel
from isfusion_tpu_torch.parallel.train_step import make_train_step
from isfusion_tpu_torch.runner import optim as toptim
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from torch_parity import assert_close_to_max, load_from_jax, random_variables

MODULES = ("pts_voxel_encoder", "pts_backbone", "pts_neck", "pts_bbox_head")
BN = dict(type="naiveSyncBN2d", eps=1e-3, momentum=0.01)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def _jax_cfg(cfg):
    """The port's model config for the JAX builder (no compute_dtype on
    the JAX Anchor3DHead)."""
    cfg = copy.deepcopy(cfg)
    cfg["pts_bbox_head"] = {k: v for k, v in cfg["pts_bbox_head"].items()
                            if k != "compute_dtype"}
    return cfg


@pytest.fixture(scope="module")
def tiny():
    cfg = tflagship.pointpillars_model_cfg(tiny=True)
    _, batch_fn = tflagship.build_pointpillars_flagship(tiny=True,
                                                        device="cpu")
    return cfg, batch_fn(2)


def test_tiny_cfg_matches_jax(monkeypatch):
    monkeypatch.setenv("FLAGSHIP_MODEL", "pointpillars")
    jmodel, jbatch_fn = jflagship.build_flagship(tiny=True)
    cfg = _jax_cfg(tflagship.pointpillars_model_cfg(tiny=True))
    for key in ("pts_voxel_layer", "pts_voxel_encoder", "pts_middle_encoder",
                "pts_bbox_head", "train_cfg", "test_cfg"):
        assert dict(getattr(jmodel, key)) == dict(cfg[key]), key
    for key in ("pts_backbone", "pts_neck"):
        assert dict(getattr(jmodel, key)) == {
            k: v for k, v in cfg[key].items() if k != "compute_dtype"}, key
    _, batch_fn = tflagship.build_pointpillars_flagship(tiny=True,
                                                        device="cpu")
    for k, v in jbatch_fn(2).items():
        np.testing.assert_array_equal(batch_fn(2)[k], np.asarray(v))


# ----------------------------------------------------- anchors and coder
@pytest.mark.parametrize("tiny_cfg", [True, False])
def test_anchors_match(tiny_cfg):
    cfg = tflagship.pointpillars_model_cfg(tiny=tiny_cfg)
    head_cfg = _jax_cfg(cfg)["pts_bbox_head"]
    size = (16, 16) if tiny_cfg else (200, 200)
    want = JaxHead(**{k: v for k, v in head_cfg.items()
                      if k != "type"}).anchors_for([size])
    head = Anchor3DHead(**{k: v for k, v in cfg["pts_bbox_head"].items()
                           if k != "type"})
    got = head.anchors_for([size])
    assert got.shape == (size[0] * size[1] * 14, 9)
    np.testing.assert_array_equal(got, want)


def _box_pairs(rng, n=300):
    anchors = np.zeros((n, 9), np.float32)
    anchors[:, :2] = rng.uniform(-50, 50, (n, 2))
    anchors[:, 2] = rng.uniform(-2, -1.6, n)
    anchors[:, 3:6] = rng.uniform(0.4, 12, (n, 3))
    anchors[:, 6] = rng.choice([0, 1.57], n)
    gts = anchors + rng.normal(0, 0.3, (n, 9)).astype(np.float32)
    gts[:, 3:6] = np.abs(gts[:, 3:6]) + 0.1
    return anchors, gts


@pytest.mark.parametrize("fn", ["encode", "decode"])
def test_delta_coder_matches(fn):
    rng = np.random.default_rng(0)
    anchors, gts = _box_pairs(rng)
    if fn == "encode":
        want = JaxCoder.encode(jnp.asarray(anchors), jnp.asarray(gts))
        got = DeltaXYZWLHRBBoxCoder.encode(torch.from_numpy(anchors),
                                           torch.from_numpy(gts))
    else:
        deltas = rng.normal(0, 0.5, (len(anchors), 9)).astype(np.float32)
        want = JaxCoder.decode(jnp.asarray(anchors), jnp.asarray(deltas))
        got = DeltaXYZWLHRBBoxCoder.decode(torch.from_numpy(anchors),
                                           torch.from_numpy(deltas))
    assert_close_to_max(got.numpy(), np.asarray(want), 1e-6)


# ------------------------------------------------------- voxelization
def _jax_voxels(batch, vl, cap):
    return jax.vmap(lambda p, m: jvoxel.voxelize_hard(
        p, m, vl["point_cloud_range"], vl["voxel_size"],
        vl["max_num_points"], cap))(jnp.asarray(batch["points"]),
                                    jnp.asarray(batch["points_mask"]))


@pytest.mark.parametrize("cap", [256, 2048])
def test_voxelize_hard_capped_matches(tiny, cap):
    cfg, batch = tiny
    vl = cfg["pts_voxel_layer"]
    want = _jax_voxels(batch, vl, cap)
    got = voxel.voxelize_hard(torch.from_numpy(batch["points"]),
                              torch.from_numpy(batch["points_mask"]),
                              vl["point_cloud_range"], vl["voxel_size"],
                              vl["max_num_points"], cap)
    counts = np.asarray(want.voxel_mask).sum(1)
    if cap == 256:
        # the cap binds: more occupied pillars than it keeps
        uncapped = voxel.voxelize_hard(
            torch.from_numpy(batch["points"]),
            torch.from_numpy(batch["points_mask"]), vl["point_cloud_range"],
            vl["voxel_size"], vl["max_num_points"])
        n_all = torch.bincount(uncapped.coors[:, 0].long()).numpy()
        assert (counts == cap).all() and (n_all > cap).all()
    else:
        assert (counts < cap).all()
    rows = np.cumsum([0] + list(counts))
    for b in range(len(counts)):
        sl = slice(rows[b], rows[b + 1])
        n = counts[b]
        np.testing.assert_array_equal(got.voxels[sl].numpy(),
                                      np.asarray(want.voxels[b, :n]))
        np.testing.assert_array_equal(got.coors[sl, 1:].numpy(),
                                      np.asarray(want.coors[b, :n]))
        assert (got.coors[sl, 0] == b).all()
        np.testing.assert_array_equal(got.num_points[sl].numpy(),
                                      np.asarray(want.num_points[b, :n]))


# --------------------------------------------------------- voxel encoders
@pytest.mark.parametrize("kind", ["HardVFE", "PillarFeatureNet"])
@pytest.mark.parametrize("train", [False, True])
def test_hard_vfe_matches(tiny, kind, train):
    cfg, batch = tiny
    vl = cfg["pts_voxel_layer"]
    vox = _jax_voxels(batch, vl, 256)
    enc = {k: v for k, v in cfg["pts_voxel_encoder"].items() if k != "type"}
    jcls, tcls = ((JaxHardVFE, HardVFE) if kind == "HardVFE"
                  else (JaxPillarNet, PillarFeatureNet))
    jmod = jcls(**{k: v for k, v in enc.items() if k not in ("in_channels",)},
                in_channels=enc["in_channels"])
    variables = random_variables(jmod, vox.voxels, vox.num_points, vox.coors,
                                 seed=1)
    port = load_from_jax(tcls(**enc), variables, "pts_voxel_encoder_m",
                         "pts_voxel_encoder")
    if train:
        want, mut = jmod.apply(variables, vox.voxels, vox.num_points,
                               vox.coors, train=True,
                               mutable=["batch_stats"])
        port.train()
    else:
        want = jmod.apply(variables, vox.voxels, vox.num_points, vox.coors)
    vm = np.asarray(vox.voxel_mask)
    coors = np.concatenate([np.concatenate(
        [np.full((m.sum(), 1), b), np.asarray(vox.coors[b])[m]], 1)
        for b, m in enumerate(vm)])
    got = port(torch.from_numpy(np.asarray(vox.voxels)[vm]),
               torch.from_numpy(np.asarray(vox.num_points)[vm]),
               torch.from_numpy(coors))
    assert_close_to_max(got.detach().numpy(), np.asarray(want)[vm], 1e-3)
    if train:
        stats = state_dict_from_jax({"batch_stats": {
            "pts_voxel_encoder_m": jax.device_get(
                mut["batch_stats"])}})
        for i in range(len(port.vfe_layers)):
            norm = port.vfe_layers[i].norm
            pre = f"pts_voxel_encoder.vfe_layers.{i}.norm."
            for leaf in ("running_mean", "running_var"):
                np.testing.assert_allclose(
                    getattr(norm, leaf).numpy(), stats[pre + leaf].numpy(),
                    rtol=1e-5, atol=1e-6)


def test_pillar_scatter_matches(tiny):
    cfg, batch = tiny
    vox = _jax_voxels(batch, cfg["pts_voxel_layer"], 256)
    rng = np.random.default_rng(2)
    feats = rng.normal(size=vox.voxel_mask.shape + (16,)).astype(np.float32)
    want = JaxScatter(in_channels=16, output_shape=[32, 32]).apply(
        {}, jnp.asarray(feats), vox.coors, vox.voxel_mask)
    vm = np.asarray(vox.voxel_mask)
    coors = np.concatenate([np.concatenate(
        [np.full((m.sum(), 1), b), np.asarray(vox.coors[b])[m]], 1)
        for b, m in enumerate(vm)])
    got = PointPillarsScatter(16, [32, 32])(torch.from_numpy(feats[vm]),
                                            torch.from_numpy(coors), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ SECOND and FPN
@pytest.mark.parametrize("module", ["backbone", "neck"])
@pytest.mark.parametrize("train", [False, True])
def test_second_and_fpn_match(module, train):
    rng = np.random.default_rng(3)
    if module == "backbone":
        kw = dict(in_channels=16, out_channels=[16, 32, 64],
                  layer_nums=[1, 1, 1], layer_strides=[2, 2, 2], norm_cfg=BN)
        x = rng.normal(size=(2, 32, 32, 16)).astype(np.float32)
        jmod, port, path = JaxSECOND(**kw), SECOND(**kw), "pts_backbone"
        args = (jnp.asarray(x),)
    else:
        kw = dict(in_channels=[16, 32, 64], out_channels=[16, 16, 16],
                  upsample_strides=[1, 2, 4], norm_cfg=BN)
        x = [rng.normal(size=(2, 16 // s, 16 // s, c)).astype(np.float32)
             for s, c in ((1, 16), (2, 32), (4, 64))]
        jmod, port, path = JaxFPN(**kw), SECONDFPN(**kw), "pts_neck"
        args = ([jnp.asarray(a) for a in x],)
    variables = random_variables(jmod, *args, seed=4)
    port = load_from_jax(port, variables, f"{path}_m", path)
    if train:
        want, _ = jmod.apply(variables, *args, train=True,
                             mutable=["batch_stats"])
        port.train()
    else:
        want = jmod.apply(variables, *args)
    got = port(torch.from_numpy(x) if module == "backbone"
               else [torch.from_numpy(a) for a in x])
    if module == "backbone":
        assert len(got) == 3
        for g, w in zip(got, want):
            assert_close_to_max(g.detach().numpy(), np.asarray(w), 1e-3)
    else:
        assert got.shape == (2, 16, 16, 48)
        assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-3)


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("name", ["smooth_l1", "cross_entropy"])
def test_losses_match(name):
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(60, 9)).astype(np.float32)
    if name == "smooth_l1":
        target = (pred + rng.normal(0, 0.2, pred.shape)).astype(np.float32)
        weight = rng.uniform(0, 1, pred.shape).astype(np.float32)
        fns = (lambda *a, **k: jlosses.smooth_l1_loss(*a, beta=1 / 9, **k),
               lambda *a, **k: tlosses.smooth_l1_loss(*a, beta=1 / 9, **k))
    else:
        pred = pred[:, :2]
        target = rng.integers(0, 2, 60)
        weight = (rng.uniform(size=60) > 0.5).astype(np.float32)
        fns = (jlosses.cross_entropy_loss, tlosses.cross_entropy_loss)
    for kw in (dict(weight=weight, avg_factor=7.0), dict(weight=weight),
               dict()):
        want = fns[0](jnp.asarray(pred), jnp.asarray(target),
                      **{k: (jnp.asarray(v) if k == "weight" else v)
                         for k, v in kw.items()})
        got = fns[1](torch.from_numpy(pred), torch.from_numpy(target),
                     **{k: (torch.from_numpy(v) if k == "weight" else v)
                        for k, v in kw.items()})
        assert _rel(got, want) <= 1e-6


# -------------------------------------------------- rotated BEV NMS (K10)
def _bev_boxes(rng, n, r=20.0):
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(-r, r, (n, 2))
    b[:, 2:4] = rng.uniform(0.5, 5, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


def _nms_case(kind, rng):
    """(boxes (K, 5), scores (K,), valid (K,))."""
    if kind == "random":
        boxes = _bev_boxes(rng, 200)
        scores = rng.uniform(size=200).astype(np.float32)
        valid = rng.uniform(size=200) > 0.2
    elif kind == "chains":
        # A suppresses B, B would suppress C, C does not overlap A: the
        # greedy keeps A and C; plus identical and 45-degree pairs
        rows, sc = [], []
        for i in range(12):
            x0, y0 = 12.0 * (i % 4), 12.0 * (i // 4)
            rows += [[x0, y0, 4, 2, 0.0], [x0 + 1.2, y0, 4, 2, 0.0],
                     [x0 + 3.4, y0, 4, 2, 0.0],
                     [x0 + 5, y0 + 5, 3, 3, 0.0],
                     [x0 + 5, y0 + 5, 3, 3, 0.0],
                     [x0 + 5, y0 + 5, 3, 3, np.pi / 4]]
            sc += [0.9, 0.8, 0.7, 0.6, 0.6, 0.5]
        boxes = np.asarray(rows, np.float32)
        scores = np.asarray(sc, np.float32) - \
            np.repeat(np.arange(12), 6).astype(np.float32) * 1e-3
        valid = np.ones(len(boxes), bool)
    else:                                       # equal scores, nested boxes
        boxes = _bev_boxes(rng, 60, r=4.0)
        boxes[30:] = boxes[:30] * [1, 1, 0.5, 0.5, 1]
        scores = np.round(rng.uniform(size=60), 1).astype(np.float32)
        valid = np.ones(60, bool)
    return boxes, scores, valid


@pytest.mark.parametrize("kind", ["random", "chains", "ties_nested"])
def test_nms_bev_ref_matches_jax(kind):
    rng = np.random.default_rng(6)
    boxes, scores, valid = _nms_case(kind, rng)
    want = np.asarray(jbox.nms_bev_mask(jnp.asarray(boxes),
                                        jnp.asarray(scores), 0.2,
                                        valid=jnp.asarray(valid)))
    got = box_ops.nms_bev_mask_ref(torch.from_numpy(boxes)[None],
                                   torch.from_numpy(scores)[None, None], 0.2,
                                   torch.from_numpy(valid)[None, None])
    assert 0 < want.sum() < valid.sum()
    np.testing.assert_array_equal(got[0, 0].numpy(), want)
    if kind == "chains":
        keep = want.reshape(12, 6)
        assert (keep == [1, 0, 1, 1, 0, 0]).all()


@pytest.mark.parametrize("density", [0.02, 0.3])
def test_greedy_suppress_ref_matches_jax(density):
    """The greedy walk alone, over a given (asymmetric) suppression
    matrix with tied scores and invalid boxes."""
    rng = np.random.default_rng(8)
    n = 120
    suppress = rng.uniform(size=(n, n)) < density
    scores = np.round(rng.uniform(size=n), 1).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    want = np.asarray(jbox._greedy_suppress(
        jnp.asarray(scores), jnp.asarray(suppress), jnp.asarray(valid)))
    got = box_ops.greedy_suppress_ref(torch.from_numpy(suppress)[None],
                                      torch.from_numpy(scores)[None, None],
                                      torch.from_numpy(valid)[None, None])
    assert 0 < want.sum() < valid.sum()
    np.testing.assert_array_equal(got[0, 0].numpy(), want)


def test_nms_shared_memory_limit():
    """The greedy pass's shared memory is one class's: 4,112 bytes, its ceil(K / 64)
    removed words and, up to K = 5,632, five chunks' staged rows. Whatever the class count, K = 1,344 and
    1,345 (where the whole-mask copy stopped fitting), 2,000 and 58,113
    (removed-masks of 32 classes past 227 KB) are taken, as are 33 classes
    (the card test launches them); the limit is K = 1,826,688. On the CPU
    the wrapper at 33 classes equals the JAX package's walk."""
    assert box_ops.greedy_smem_bytes(1344) == 4112 + 21 * 8 * 321
    assert box_ops.greedy_smem_bytes(1826688) == box_ops.NMS_SMEM_BYTES
    assert box_ops.greedy_smem_bytes(1826689) > box_ops.NMS_SMEM_BYTES
    for c, k in ((32, 1344), (1, 1345), (10, 2000), (32, 58113), (33, 64),
                 (64, 1000)):
        box_ops._greedy_capacity("nms_bev_mask", 1, c, k)
    rng = np.random.default_rng(33)
    boxes = np.concatenate([rng.uniform(-6, 6, (64, 2)),
                            rng.uniform(1, 4, (64, 2)),
                            rng.uniform(-3, 3, (64, 1))], 1).astype(np.float32)
    scores = rng.uniform(size=(33, 64)).astype(np.float32)
    got = box_ops.nms_bev_mask(torch.from_numpy(boxes)[None],
                               torch.from_numpy(scores)[None], 0.2)[0]
    suppress = jnp.asarray(np.asarray(jbox.boxes_iou_bev(
        jnp.asarray(boxes), jnp.asarray(boxes))) > 0.2)
    for c in (0, 32):
        want = np.asarray(jbox._greedy_suppress(
            jnp.asarray(scores[c]), suppress, jnp.ones(64, bool)))
        np.testing.assert_array_equal(got[c].numpy(), want)


def test_nms_bev_mask_batches_and_checks():
    rng = np.random.default_rng(7)
    boxes = torch.from_numpy(np.stack([_bev_boxes(rng, 80) for _ in (0, 1)]))
    scores = torch.rand((2, 3, 80), generator=torch.Generator().manual_seed(0))
    valid = scores > 0.3
    got = box_ops.nms_bev_mask(boxes, scores, 0.1, valid)
    for b in range(2):
        for c in range(3):
            one = box_ops.nms_bev_mask_ref(boxes[b:b + 1],
                                           scores[b:b + 1, c:c + 1], 0.1,
                                           valid[b:b + 1, c:c + 1])
            assert torch.equal(got[b, c], one[0, 0])
    assert not (got & ~valid).any()
    with pytest.raises(ValueError):
        box_ops.nms_bev_mask(boxes[0], scores, 0.1)


# ------------------------------------------------------------ the head
def _head_cfgs(nms_pre=200):
    cfg = tflagship.pointpillars_model_cfg(tiny=True)
    head = dict(cfg["pts_bbox_head"], train_cfg=dict(cfg["train_cfg"]["pts"]),
                test_cfg=dict(cfg["test_cfg"]["pts"], nms_pre=nms_pre))
    jhead = {k: v for k, v in head.items() if k not in ("type",
                                                        "compute_dtype")}
    return jhead, {k: v for k, v in head.items() if k != "type"}


def _head_preds(seed=8, b=2):
    rng = np.random.default_rng(seed)
    shapes = ((b, 16, 16, 140), (b, 16, 16, 126), (b, 16, 16, 28))
    scale = (2.0, 0.3, 1.0)
    out = [(rng.normal(size=s) * k).astype(np.float32)
           for s, k in zip(shapes, scale)]
    out[0] -= 2.0
    return out


def test_anchor_head_loss_matches(tiny):
    _, batch = tiny
    jkw, tkw = _head_cfgs()
    preds = _head_preds()
    gts = (batch["gt_bboxes_3d"], batch["gt_labels_3d"], batch["gt_mask"])
    want = JaxHead(**jkw).loss([tuple(jnp.asarray(p) for p in preds)],
                               *[jnp.asarray(g) for g in gts])
    got = Anchor3DHead(**tkw).loss(
        [tuple(torch.from_numpy(p) for p in preds)],
        *[torch.from_numpy(np.asarray(g)) for g in gts])
    assert set(got) == set(want) == {"loss_cls", "loss_bbox", "loss_dir"}
    for k in want:
        assert float(want[k]) > 0
        assert _rel(got[k], want[k]) <= 1e-4, k


def _assert_boxes_match(got, want):
    m = np.asarray(want["mask"])
    np.testing.assert_array_equal(got["mask"].numpy(), m)
    assert m.sum() >= 10
    np.testing.assert_array_equal(got["labels"].numpy()[m],
                                  np.asarray(want["labels"])[m])
    assert_close_to_max(got["scores"].numpy()[m],
                        np.asarray(want["scores"])[m], 1e-4)
    assert_close_to_max(got["bboxes"].numpy()[m],
                        np.asarray(want["bboxes"])[m], 1e-4)


def test_anchor_head_get_bboxes_matches():
    jkw, tkw = _head_cfgs()
    preds = _head_preds(seed=9)
    want = JaxHead(**jkw).get_bboxes([tuple(jnp.asarray(p) for p in preds)])
    got = Anchor3DHead(**tkw).get_bboxes(
        [tuple(torch.from_numpy(p) for p in preds)])
    assert got["bboxes"].shape == (2, 500, 9)
    _assert_boxes_match(got, want)


# ---------------------------------------------------- the whole detector
def _detector(tiny, nms_pre=200):
    cfg, batch = tiny
    cfg = copy.deepcopy(cfg)
    cfg["test_cfg"] = dict(pts=dict(cfg["test_cfg"]["pts"], nms_pre=nms_pre))
    jmodel = jbuild_detector(_jax_cfg(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(jmodel, jbatch, train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    return cfg, batch, jmodel, jbatch, variables, port.eval()


@pytest.fixture(scope="module")
def detector(tiny):
    return _detector(tiny)


def test_detector_predict_matches(detector):
    _, batch, jmodel, jbatch, variables, port = detector
    want = jmodel.apply(variables, jbatch, train=False, mode="predict")
    got = port(batch, device="cpu")
    _assert_boxes_match(got, want)


@pytest.fixture(scope="module")
def detector_grads(detector):
    _, batch, jmodel, jbatch, variables, port = detector

    def loss_fn(params, bs):
        losses, mut = jmodel.apply({"params": params, "batch_stats": bs},
                                   jbatch, train=True, mode="loss",
                                   mutable=["batch_stats"])
        return total_loss(losses), (losses, mut["batch_stats"])

    (_, (jl, jbs)), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], variables["batch_stats"])
    port = copy.deepcopy(port).train()
    tl = port(batch, mode="loss", device="cpu")
    sum(tl.values()).backward()
    return (({k: float(v) for k, v in jl.items()},
             state_dict_from_jax({"params": jax.device_get(jg)}),
             state_dict_from_jax({"batch_stats": jax.device_get(jbs)})),
            (port, {k: v.item() for k, v in tl.items()}))


def test_detector_loss_terms_match(detector_grads):
    (jl, _, jbs), (port, tl) = detector_grads
    assert set(tl) == set(jl) == {"loss_cls", "loss_bbox", "loss_dir"}
    for k in jl:
        assert _rel(tl[k], jl[k]) <= 1e-4, k
    sd = port.state_dict()
    checked = 0
    for k, want in jbs.items():
        if "pts_voxel_encoder" in k and "running" in k:
            # masked BN: the JAX statistics, biased variance included
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-6)
            checked += 1
    assert checked == 4


@pytest.mark.parametrize("top", MODULES)
def test_detector_gradients_match(detector_grads, top):
    (_, jg, _), (port, _) = detector_grads
    got, want = [], []
    for name, p in port.named_parameters():
        if name.split(".")[0] == top:
            want.append(jg[name].numpy().ravel())
            got.append(p.grad.numpy().ravel())
    want = np.concatenate(want)
    assert np.abs(want).max() > 0
    assert_close_to_max(np.concatenate(got), want, 1e-3)


# ------------------------------------------------ schedule and train step
def test_step_schedule_matches_jax():
    cfg = tflagship.pointpillars_optim_cfg()
    lr_cfg, base = cfg["lr_config"], cfg["optimizer"]["lr"]
    assert lr_cfg["policy"] == "step" and cfg["momentum_config"] is None
    toy = torch.nn.Linear(2, 2)
    for spe in (1, 7):
        jlr = joptim.build_lr_schedule(lr_cfg, base, 3000, spe)
        sched = toptim.build_schedule(toptim.build_optimizer(
            toy, cfg["optimizer"]), lr_cfg, None, 3000, steps_per_epoch=spe)
        assert sched.beta1 is None
        for c in (0, 1, 499, 999, 1000, 1001, 1019, 1020, 1022, 1023, 1140,
                  1161, 1200, 2999):
            assert abs(sched.lr(c) - float(jlr(c))) <= 1e-7 * base, (spe, c)


def test_train_step_matches_jax(detector, detector_grads):
    _, batch, jmodel, jbatch, variables, port0 = detector
    (_, jgrads, _), _ = detector_grads
    cfg = tflagship.pointpillars_optim_cfg()
    opt_cfg, opt_conf, lr_cfg = (cfg["optimizer"], cfg["optimizer_config"],
                                 cfg["lr_config"])
    tx = joptim.build_optimizer(variables["params"], opt_cfg, opt_conf,
                                lr_cfg, None, total_steps=100)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              tx)
    # eagerly: compiled with this suite's XLA flags (backend optimisation
    # level 0), XLA:CPU gives a VFE gradient unlike the same step traced
    # eagerly (which the port matches); the eager step is the JAX
    # package's own arithmetic
    with jax.disable_jit():
        new_state, jm = jmake_train_step(jmodel, tx, mesh=None,
                                         donate=False)(
            state, jbatch, jax.random.PRNGKey(0))
    jafter = state_dict_from_jax({"params": jax.device_get(
        new_state.params)})

    port = copy.deepcopy(port0).train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    opt = toptim.build_optimizer(port, opt_cfg)
    step = make_train_step(port, opt, toptim.build_schedule(
        opt, lr_cfg, None, 100), toptim.grad_clip_norm(opt_conf))
    tm = step(batch, torch.Generator().manual_seed(0))
    for k in ("loss", "loss_cls", "loss_bbox", "loss_dir", "grad_norm"):
        assert _rel(tm[k], jm[k]) <= 1e-4, k
    lr = toptim.step_schedule(opt_cfg["lr"], lr_cfg["step"],
                              warmup="linear", warmup_iters=1000,
                              warmup_ratio=1e-3)(0)
    clip = min(1.0, opt_conf["grad_clip"]["max_norm"] / float(
        jm["grad_norm"]))
    checked = 0
    for name, p in port.named_parameters():
        g = jgrads[name].numpy()
        # Adam's first update is ~lr * sign(g) where the clipped gradient
        # is far above its eps (1e-8)
        sel = (np.abs(g) > 1e-4 * np.abs(g).max()) & \
            (np.abs(g) * clip > 100 * 1e-8)
        d_port = (p.detach() - before[name]).numpy()[sel]
        d_jax = (jafter[name] - before[name]).numpy()[sel]
        tol = 1e-2 * lr + 2 * np.spacing(np.abs(before[name].numpy()[sel]))
        assert (np.abs(d_port - d_jax) <= tol).all(), name
        checked += int(sel.sum())
    assert checked > 5000


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tflagship.build_pointpillars_flagship(tiny=True)
    assert math.isclose(tflagship.pointpillars_optim_cfg()[
        "optimizer_config"]["grad_clip"]["max_norm"], 35)
    assert os.path.isfile(tflagship.POINTPILLARS_CFG)
