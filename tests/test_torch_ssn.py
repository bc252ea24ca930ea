"""The port's SSN against the JAX package: ShapeAwareHead (the two tasks
of ``tests/test_models/test_shape_aware.py``) in forward (eval and train
mode, on carried variables), anchors (tiny and the full-width config's
five tasks), loss and decode; ``assign_per_class`` against a numpy
oracle of the reference's per-class assignment (the JAX package declares
the flag and never reads it: with it off the port equals JAX); the tiny
SSN detector (``flagship.ssn_model_cfg(tiny=True)``) in head outputs,
predict, loss terms, gradients and one AdamW step.

Inputs are numpy arrays made from a seed and handed to both packages;
JAX variables are drawn with numpy (``tests/torch_parity.py``).
Tolerances (float32, CPU): anchors and assignments exact; head outputs
and gradients 1e-3 of the max; loss terms 1e-4 relative; kept boxes the
same entries and labels, boxes and scores 1e-4 of their max; updates
within 1e-2 of the lr (``check_step``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models.dense_heads import ShapeAwareHead as JaxHead
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.models.dense_heads.anchor3d_head import \
    bbox_overlaps_nearest_3d
from isfusion_tpu_torch.models.dense_heads.shape_aware_head import \
    ShapeAwareHead
from torch_parity import (anchor_family_case, assert_close_to_max,
                          assert_same_kept_boxes, check_step, jax_cfg,
                          load_from_jax, random_variables, tree_leaves)

TASKS = [dict(num_class=1, shared_conv_channels=(16, 16),
              shared_conv_strides=(1, 1)),
         dict(num_class=2, shared_conv_channels=(16, 16, 16),
              shared_conv_strides=(2, 1, 1))]
HEAD = dict(
    num_classes=3, in_channels=16, feat_channels=16, tasks=TASKS,
    anchor_generator=dict(
        type="Anchor3DRangeGenerator", ranges=[[-8, -8, -1.8, 8, 8, -1.8]],
        sizes=[[0.6, 0.6, 1.7], [1.9, 4.6, 1.7], [2.9, 10.5, 3.2]],
        rotations=[0, 1.57]),
    bbox_coder=dict(type="DeltaXYZWLHRBBoxCoder"),
    train_cfg=dict(assigner=dict(pos_iou_thr=0.6, neg_iou_thr=0.45,
                                 min_pos_iou=0.45)),
    test_cfg=dict(nms_pre=64, nms_thr=0.2, score_thr=0.05, max_num=32))


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


@pytest.fixture(scope="module")
def head_pair():
    jhead = JaxHead(**HEAD)
    feats = np.random.default_rng(0).normal(size=(2, 16, 16, 16)).astype(
        np.float32)
    variables = random_variables(jhead, [jnp.asarray(feats)], seed=1)
    port = load_from_jax(ShapeAwareHead(**HEAD), variables,
                         "pts_bbox_head_m", "pts_bbox_head")
    return jhead, port, variables, feats


@pytest.mark.parametrize("train", [False, True])
def test_head_forward_matches(head_pair, train):
    jhead, port, variables, feats = head_pair
    if train:
        want, _ = jhead.apply(variables, [jnp.asarray(feats)], train=True,
                              mutable=["batch_stats"])
        port = copy.deepcopy(port).train()
    else:
        want = jhead.apply(variables, [jnp.asarray(feats)])
    got = port([torch.from_numpy(feats)])
    assert len(got) == len(want) == 2
    # task 0 at full resolution, task 1 at stride 2
    assert got[0][0].shape == (2, 16, 16, 2 * 3)
    assert got[1][0].shape == (2, 8, 8, 4 * 3)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert_close_to_max(a.detach().numpy(), np.asarray(b), 1e-3)


@pytest.mark.parametrize("tiny", [True, False])
def test_anchors_match(tiny):
    if tiny:
        kw, sizes = HEAD, [(16, 16), (8, 8)]
    else:
        kw = jax_cfg(tflagship.ssn_model_cfg()["pts_bbox_head"])
        kw.pop("type")
        sizes = [(200, 200)] * 3 + [(100, 100)] * 2
    want = JaxHead(**kw).anchors_for(sizes)
    head = ShapeAwareHead(**kw)
    got = head.anchors_for(sizes)
    np.testing.assert_array_equal(got, want)
    index = head.anchor_size_index(sizes)
    assert len(index) == len(got)
    # each anchor's size index gives its (dx, dy, dz)
    gen_sizes = np.asarray(head.anchor_generator.sizes, np.float32)
    np.testing.assert_array_equal(got[:, 3:6], gen_sizes[index])
    if not tiny:
        assert len(got) == 500_000


def _preds(seed):
    rng = np.random.default_rng(seed)
    out = []
    for hw, a in (((16, 16), 2), ((8, 8), 4)):
        cls = (rng.normal(size=(2,) + hw + (a * 3,)) * 2.0 - 2.0)
        reg = rng.normal(size=(2,) + hw + (a * 7,)) * 0.3
        dirs = rng.normal(size=(2,) + hw + (a * 2,))
        out.append(tuple(x.astype(np.float32) for x in (cls, reg, dirs)))
    return out


def _gts(seed):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((2, 6, 7), np.float32)
    boxes[..., :2] = rng.uniform(-6, 6, (2, 6, 2))
    boxes[..., 2] = -1.8
    sizes = np.asarray(HEAD["anchor_generator"]["sizes"], np.float32)
    labels = rng.integers(0, 3, (2, 6))
    boxes[..., 3:6] = sizes[labels] * rng.uniform(0.9, 1.1, (2, 6, 3))
    boxes[..., 6] = rng.choice([0.0, 1.57], (2, 6)) + rng.normal(0, 0.1,
                                                                 (2, 6))
    mask = np.ones((2, 6), bool)
    mask[:, -1] = False
    return boxes, labels, mask


def test_head_loss_matches():
    preds = _preds(2)
    gts = _gts(3)
    want = JaxHead(**HEAD).loss([tuple(jnp.asarray(x) for x in p)
                                 for p in preds],
                                *[jnp.asarray(g) for g in gts])
    got = ShapeAwareHead(**HEAD).loss(
        [tuple(torch.from_numpy(x) for x in p) for p in preds],
        *[torch.from_numpy(g) for g in gts])
    assert set(got) == set(want) == {"loss_cls", "loss_bbox", "loss_dir"}
    for k in want:
        assert float(want[k]) > 0
        assert _rel(got[k], want[k]) <= 1e-4, k


def test_head_get_bboxes_matches():
    preds = _preds(4)
    want = JaxHead(**HEAD).get_bboxes([tuple(jnp.asarray(x) for x in p)
                                       for p in preds])
    got = ShapeAwareHead(**HEAD).get_bboxes(
        [tuple(torch.from_numpy(x) for x in p) for p in preds])
    assert got["bboxes"].shape == (2, 32, 7)
    assert np.asarray(want["mask"]).sum() >= 10
    assert_same_kept_boxes({k: v.numpy() for k, v in got.items()},
                           {k: np.asarray(v) for k, v in want.items()})


# --------------------------------------------------- assign_per_class
def _oracle_assign(anchors, sizes, gts, labels, n_sizes, pos, neg, min_pos):
    """The reference's per-class assignment in numpy: for each size i a
    MaxIoUAssigner over the anchors of size i and the GTs of class i only
    (an anchor best for several GTs takes the one of highest IoU),
    scattered back to the anchors' order."""
    ious = bbox_overlaps_nearest_3d(torch.from_numpy(anchors),
                                    torch.from_numpy(gts)).numpy()
    out = np.full(len(anchors), -1, np.int64)
    for i in range(n_sizes):
        a_idx, g_idx = np.nonzero(sizes == i)[0], np.nonzero(labels == i)[0]
        if len(g_idx) == 0:
            continue
        sub = ious[np.ix_(a_idx, g_idx)]
        best = sub.max(1)
        res = np.full(len(a_idx), -1, np.int64)
        res[(best >= neg) & (best < pos)] = -2
        res[best >= pos] = g_idx[sub.argmax(1)[best >= pos]]
        forced = (sub == sub.max(0)[None]) & (sub >= min_pos)
        choice = np.where(forced, sub, -1.0).argmax(1)
        res[forced.any(1)] = g_idx[choice[forced.any(1)]]
        out[a_idx] = res
    return out


@pytest.mark.parametrize("per_class", [True, False])
def test_assign_per_class_matches_numpy_oracle(per_class):
    head = ShapeAwareHead(**HEAD, assign_per_class=per_class)
    sizes_hw = [(16, 16), (8, 8)]
    anchors = head.anchors_for(sizes_hw)
    index = head.anchor_size_index(sizes_hw)
    rng = np.random.default_rng(15)
    # GTs on jittered anchors: 16 of their own class's size, 8 of another
    labels = rng.integers(0, 3, 24)
    want_size = np.where(np.arange(24) < 16, labels, (labels + 1) % 3)
    pick = np.array([rng.choice(np.nonzero(index == z)[0])
                     for z in want_size])
    gts = anchors[pick].copy()
    gts[:, :2] += rng.normal(0, 0.1, (24, 2))
    gts[:, 3:6] *= rng.uniform(0.9, 1.1, (24, 3))
    got = head.assign(torch.from_numpy(anchors), torch.from_numpy(gts),
                      torch.from_numpy(labels), torch.ones(24, dtype=bool),
                      torch.from_numpy(index)).numpy()
    if per_class:
        want = _oracle_assign(anchors, index, gts, labels, 3, 0.6, 0.45,
                              0.45)
        pos = got >= 0
        assert (labels[got[pos]] == index[pos]).all() and pos.sum() >= 10
    else:
        want = _oracle_assign(anchors, np.zeros_like(index), gts,
                              np.zeros_like(labels), 1, 0.6, 0.45, 0.45)
        assert (labels[got[got >= 0]] != index[got >= 0]).any()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- the detector
@pytest.fixture(scope="module")
def ssn_case():
    cfg = tflagship.ssn_model_cfg(tiny=True)
    assert cfg["pts_bbox_head"]["assign_per_class"]
    # the JAX head matches every anchor to every GT
    cfg["pts_bbox_head"]["assign_per_class"] = False
    cfg["test_cfg"]["pts"].update(nms_pre=64, max_num=32)
    _, batch_fn = tflagship.build_ssn(tiny=True, device="cpu")
    return anchor_family_case(cfg, batch_fn(2), tflagship.ssn_optim_cfg())


def test_detector_outputs_match(ssn_case):
    got = dict(tree_leaves(ssn_case["got_feats"]))
    want = {k: np.asarray(v) for k, v in tree_leaves(ssn_case["feats"])}
    assert set(got) == set(want) and len(want) == 6
    for k, w in want.items():
        assert_close_to_max(got[k].numpy(), w, 1e-3)
    assert np.asarray(ssn_case["decoded"]["mask"]).sum() >= 8
    assert_same_kept_boxes({k: v.numpy() for k, v in ssn_case[
        "got_pred"].items()}, {k: np.asarray(v) for k, v in ssn_case[
            "decoded"].items()})


def test_detector_losses_and_gradients_match(ssn_case):
    jl, tl = ssn_case["jl"], ssn_case["tl"]
    assert set(tl) == set(jl) == {"loss_cls", "loss_bbox", "loss_dir"}
    for k in jl:
        assert _rel(tl[k], jl[k]) <= 1e-4, k
    jg, port = ssn_case["jg"], ssn_case["trained"]
    for top in ("pts_voxel_encoder", "pts_backbone", "pts_neck",
                "pts_bbox_head"):
        got = np.concatenate([p.grad.numpy().ravel() for n, p in
                              port.named_parameters() if n.startswith(top)])
        want = np.concatenate([jg[n].numpy().ravel() for n, _ in
                               port.named_parameters() if n.startswith(top)])
        assert np.abs(want).max() > 0, top
        assert_close_to_max(got, want, 1e-3)


def test_detector_adamw_step_matches(ssn_case):
    cfg = tflagship.ssn_optim_cfg()
    lr = cfg["optimizer"]["lr"] * cfg["lr_config"]["warmup_ratio"]
    for k in ("loss_cls", "loss_bbox", "loss_dir"):
        assert _rel(ssn_case["tm"][k], ssn_case["jl"][k]) <= 1e-4
    assert check_step(ssn_case, lr, cfg["optimizer_config"]["grad_clip"][
        "max_norm"]) > 5000


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for build in (tflagship.build_ssn, tflagship.build_free_anchor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(tiny=True)
    assert tflagship.ssn_optim_cfg()["samples_per_gpu"] == 2
    assert tflagship.free_anchor_optim_cfg()["samples_per_gpu"] == 4
