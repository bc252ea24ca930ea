"""The port's MVX-Net (``configs/mvxnet/dv_mvx-fpn_second_secfpn_adamw_2x8_
80e_kitti-3d-3class.py``, ``DynamicMVXFasterRCNN``) against the JAX
package: ResNet (caffe Bottlenecks and BasicBlocks) and FPN outputs,
PointFusion against the sum of the JAX PointFusion's two halves, the fused
DynamicVFE against a composition of JAX pieces, the conv_module
SparseEncoder, the head's ``assigner_per_size`` against a numpy oracle,
the CosineAnnealing schedule, the converter's ResNet / FPN / PointFusion
/ conv_module trees, and the whole tiny detector with the VFE's fusion off
(boxes, loss terms, gradients, one AdamW + clip step of the config's
recipe); then what the port does where the JAX package does not: the
frozen ResNet parameters stay put through a step.

Two layouts differ on purpose (ROADMAP queue 3): the port fuses after
DynamicVFE's last layer and adds PointFusion's transforms (the reference;
the config's widths need it), the JAX package fuses after the first layer
and concatenates them; the port matches an anchor of size i only to GTs
of class i under ``assigner_per_size`` (the JAX package reads the flag
but matches all).

Inputs are numpy arrays made from a seed and handed to both packages; JAX
variables are drawn with numpy (``tests/torch_parity.py``) and carried
with ``state_dict_from_jax``. The JAX modules run eagerly; the JAX
detector's forward, loss gradient, decode and optimizer update, the fused
VFE's pieces and the sparse encoder are jitted (an eager walk of them
takes minutes).
The tiny model (``mvxnet_model_cfg(tiny=True)``) lifts the JAX
SparseEncoder's column caps to the whole grid and its voxel cap above the
points, so neither package drops anything.

Tolerances (float32, CPU): voxel tables and keep masks exact; features
and gradients 1e-3 of their max (sums in another order); losses 1e-4
relative; the step's updates within 1e-2 of the learning rate; the
schedule 1e-6 of the base lr (optax counts in float32).
"""
import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.models.backbones.resnet import ResNet as JaxResNet
from isfusion_tpu.models.fusion_layers.point_fusion import \
    PointFusion as JaxPointFusion
from isfusion_tpu.models.middle_encoders.sparse_encoder import \
    SparseEncoder as JaxSparseEncoder
from isfusion_tpu.models.necks.fpn import FPN as JaxFPN
from isfusion_tpu.models.voxel_encoders import DynamicVFE as JaxDynamicVFE
from isfusion_tpu.models.voxel_encoders import batched_segment_ids
from isfusion_tpu.ops import scatter as jscatter
from isfusion_tpu.ops import voxel as jvoxel
from isfusion_tpu.parallel.train_step import total_loss
from isfusion_tpu.runner import optim as joptim
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.config import Config
from isfusion_tpu_torch.models.backbones.resnet import ResNet
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.dense_heads.anchor3d_head import \
    Anchor3DHead, bbox_overlaps_nearest_3d
from isfusion_tpu_torch.models.fusion_layers.point_fusion import PointFusion
from isfusion_tpu_torch.models.middle_encoders.sparse_encoder import \
    SparseEncoder
from isfusion_tpu_torch.models.necks.fpn import FPN
from isfusion_tpu_torch.models.voxel_encoders import DynamicVFE
from isfusion_tpu_torch.ops import voxel
from isfusion_tpu_torch.parallel.train_step import make_train_step
from isfusion_tpu_torch.runner import optim as toptim
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from isfusion_tpu_torch.testing import kitti_lidar2img
from torch_parity import assert_close_to_max, load_from_jax, random_variables

MODULES = ("pts_voxel_encoder", "pts_middle_encoder", "pts_backbone",
           "pts_neck", "pts_bbox_head")


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _jax_cfg(v):
    """A port config for the JAX builder (no compute_dtype keys)."""
    if isinstance(v, dict):
        return {k: _jax_cfg(x) for k, x in v.items() if k != "compute_dtype"}
    return v


def test_full_width_cfg_is_the_config():
    want = _plain(dict(Config.fromfile(tflagship.MVXNET_CFG).model))
    got = _plain(tflagship.mvxnet_model_cfg())
    for key in ("img_backbone", "img_neck", "pts_middle_encoder",
                "pts_backbone", "pts_neck", "pts_bbox_head"):
        assert got[key].pop("compute_dtype") == "bfloat16", key
    assert got["pts_voxel_encoder"]["fusion_layer"].pop(
        "compute_dtype") == "bfloat16"
    assert got == want
    model = build_detector(tflagship.mvxnet_model_cfg())
    enc = model.pts_middle_encoder
    assert enc.out_depth == 2 and enc.output_channels * enc.out_depth == 256
    opt = tflagship.mvxnet_optim_cfg()
    assert opt["samples_per_gpu"] == 2 and opt["momentum_config"] is None
    assert opt["optimizer"] == dict(type="AdamW", lr=0.003, weight_decay=0.01)
    assert opt["lr_config"]["policy"] == "CosineAnnealing"


# ------------------------------------------------------------ image branch
@pytest.mark.parametrize("depth,style", [(50, "caffe"), (18, "pytorch")])
def test_resnet_matches(depth, style):
    kw = dict(depth=depth, base_channels=4, num_stages=3, strides=(1, 2, 2),
              out_indices=(0, 1, 2), style=style, norm_eval=True,
              norm_cfg=dict(type="BN", requires_grad=False))
    jnet = JaxResNet(**kw)
    x = np.random.default_rng(1).uniform(size=(2, 32, 64, 3)).astype(
        np.float32)
    variables = random_variables(jnet, jnp.asarray(x), seed=2)
    want = jnet.apply(variables, jnp.asarray(x))
    net = load_from_jax(ResNet(**kw), variables, "img_backbone_m",
                        "img_backbone")
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert_close_to_max(g.numpy(), np.asarray(w), 1e-4)


@pytest.mark.parametrize("extra", [False, "on_output"])
def test_fpn_matches(extra):
    kw = dict(in_channels=[8, 16], out_channels=8, num_outs=4,
              add_extra_convs=extra, relu_before_extra_convs=bool(extra))
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(2, 16, 24, 8)).astype(np.float32),
          rng.normal(size=(2, 8, 12, 16)).astype(np.float32)]
    jfpn = JaxFPN(**kw)
    variables = random_variables(jfpn, [jnp.asarray(x) for x in xs], seed=4)
    want = jfpn.apply(variables, [jnp.asarray(x) for x in xs])
    fpn = load_from_jax(FPN(**kw), variables, "img_neck_m", "img_neck")
    with torch.no_grad():
        got = fpn([torch.from_numpy(x) for x in xs])
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert_close_to_max(g.numpy(), np.asarray(w), 1e-4)


# ---------------------------------------------------------------- fusion
PF = dict(img_channels=8, pts_channels=12, mid_channels=8, out_channels=6,
          img_levels=[0, 1], align_corners=False, fuse_out=False)
IMG_HW = (48, 160)


def _fusion_inputs(b=2, p=300, seed=7):
    """Image maps of two levels and two views, points in front of and
    beside the KITTI-like camera (some outside every view), their
    features and mask, and a calibration with both augmentations."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(b, 2, IMG_HW[0] // s, IMG_HW[1] // s, 8))
             .astype(np.float32) for s in (4, 8)]
    xyz = np.stack([rng.uniform(1, 40, (b, p)), rng.uniform(-20, 20, (b, p)),
                    rng.uniform(-2, 1, (b, p))], -1).astype(np.float32)
    l2i = np.stack([kitti_lidar2img(IMG_HW)] * 2)
    l2i[1, 0, 3] += 40.0                         # the second view: shifted
    img_aug = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 2, 4, 4)).copy()
    img_aug[:, :, 0, 0] = img_aug[:, :, 1, 1] = 0.9
    img_aug[:, :, 0, 3] = 4.0
    th = 0.1
    lidar_aug = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy()
    lidar_aug[:, :2, :2] = [[np.cos(th), -np.sin(th)],
                            [np.sin(th), np.cos(th)]]
    calib = dict(lidar2img=np.broadcast_to(l2i, (b, 2, 4, 4)).copy(),
                 img_aug_matrix=img_aug, lidar_aug_matrix=lidar_aug)
    pts_feats = rng.normal(size=(b, p, 12)).astype(np.float32)
    mask = rng.uniform(size=(b, p)) > 0.1
    return feats, xyz, pts_feats, mask, calib


def _jax_calib(calib):
    return dict({k: jnp.asarray(v) for k, v in calib.items()},
                img_input_shape=IMG_HW)


def _torch_calib(calib):
    return dict({k: torch.from_numpy(v) for k, v in calib.items()},
                img_input_shape=IMG_HW)


@pytest.mark.parametrize("train", [False, True])
def test_point_fusion_is_the_sum_of_the_jax_halves(train):
    feats, xyz, pts_feats, mask, calib = _fusion_inputs()
    jpf = JaxPointFusion(**PF, activate_out=False)
    args = ([jnp.asarray(f) for f in feats], jnp.asarray(xyz),
            jnp.asarray(pts_feats), jnp.asarray(mask), _jax_calib(calib))
    variables = random_variables(jpf, *args, seed=8)
    out = jpf.apply(variables, *args, train=train,
                    mutable=["batch_stats"] if train else False)
    want = np.asarray(out[0] if train else out)
    want = (want[..., :6] + want[..., 6:])[mask]
    pf = load_from_jax(PointFusion(**PF, activate_out=False), variables,
                       "pts_voxel_encoder_m/PointFusion_0",
                       "pts_voxel_encoder.fusion_layer").train(train)
    b_idx = np.nonzero(mask)[0]
    with torch.no_grad():
        got = pf([torch.from_numpy(f) for f in feats],
                 torch.from_numpy(xyz[mask]), torch.from_numpy(b_idx),
                 torch.from_numpy(pts_feats[mask]), _torch_calib(calib))
    assert_close_to_max(got.numpy(), want, 1e-4)
    # some points lie outside every view: their image half is the bias
    sampled = pf.sample([torch.from_numpy(f) for f in feats],
                        torch.from_numpy(xyz[mask]), torch.from_numpy(b_idx),
                        _torch_calib(calib))
    assert (sampled.abs().sum(1) == 0).any() and \
        (sampled.abs().sum(1) > 0).any()


@pytest.mark.parametrize("train", [False, True])
def test_fused_dynamic_vfe_matches_jax_composition(train):
    """The port's DynamicVFE with PointFusion after its last layer against
    the JAX DynamicVFE's last point features (no fusion), the JAX
    PointFusion's halves summed, ReLU and the JAX segment max."""
    feats, _, _, _, calib = _fusion_inputs(p=400, seed=9)
    rng = np.random.default_rng(10)
    b, p = 2, 400
    pcr, vs = (0.0, -20.0, -3.0, 40.0, 20.0, 1.0), (0.8, 0.8, 1.0)
    pts = np.concatenate([np.stack([
        rng.uniform(0, 42, (b, p)), rng.uniform(-21, 21, (b, p)),
        rng.uniform(-3, 1, (b, p))], -1), rng.uniform(0, 1, (b, p, 1))],
        -1).astype(np.float32)
    pts[:, :40, :3] = pts[:, 40:80, :3]             # shared voxels
    mask = rng.uniform(size=(b, p)) > 0.1
    vfe_kw = dict(in_channels=4, feat_channels=[8, 12], voxel_size=vs,
                  point_cloud_range=pcr)
    jdv = jax.jit(jax.vmap(lambda q, m: jvoxel.voxelize_dynamic(
        q, m, pcr, vs, p)))(jnp.asarray(pts), jnp.asarray(mask))
    jvfe = JaxDynamicVFE(**vfe_kw, return_point_feats=True)
    vargs = (jnp.asarray(pts), jdv.point_voxel_index, jdv.voxel_coors)
    vvars = random_variables(jvfe, *vargs, seed=11)
    jpf = JaxPointFusion(**PF, activate_out=False)
    keep = jdv.point_voxel_index < p
    pargs = ([jnp.asarray(f) for f in feats], jnp.asarray(pts[..., :3]),
             jnp.zeros((b, p, 12)), keep, _jax_calib(calib))
    pvars = random_variables(jpf, *pargs, seed=12)
    mut = ["batch_stats"] if train else False

    def run(module, variables, *args):
        out = jax.jit(lambda v, a: module.apply(v, *a, train=train,
                                                mutable=mut))(variables, args)
        return out[0] if train else out

    point_feats = run(jvfe, vvars, *vargs)
    fused = run(jpf, pvars, *pargs[:2], point_feats, *pargs[3:])
    fused = jax.nn.relu(fused[..., :6] + fused[..., 6:])
    ids = batched_segment_ids(jdv.point_voxel_index, p)
    jmax = jscatter.segment_max(fused.reshape(b * p, -1), ids, b * (p + 1))
    jmax = np.asarray(jmax).reshape(b, p + 1, -1)
    counts = np.asarray(jdv.voxel_mask).sum(1)
    want = np.concatenate([jmax[i, :counts[i]] for i in range(b)])

    sd = state_dict_from_jax({c: {"pts_voxel_encoder_m": dict(
        vvars[c], PointFusion_0=pvars[c])} for c in ("params", "batch_stats")})
    vfe = DynamicVFE(**vfe_kw, fusion_layer=dict(type="PointFusion", **PF))
    vfe.load_state_dict({k[len("pts_voxel_encoder."):]: v
                         for k, v in sd.items()})
    dv = voxel.voxelize_dynamic(torch.from_numpy(pts), torch.from_numpy(mask),
                                pcr, vs)
    with torch.no_grad():
        got = vfe.train(train)(
            torch.from_numpy(pts).reshape(b * p, -1), dv.point_voxel_index,
            dv.voxel_coors, img_feats=[torch.from_numpy(f) for f in feats],
            calib=_torch_calib(calib))
    assert got.shape == (counts.sum(), 6)
    assert_close_to_max(got.numpy(), want, 1e-4)


# ------------------------------------------------------ sparse encoder
def test_conv_module_sparse_encoder_matches():
    cfg = tflagship.mvxnet_model_cfg(tiny=True)
    enc = {k: v for k, v in cfg["pts_middle_encoder"].items() if k != "type"}
    _, batch_fn = tflagship.build_mvxnet(tiny=True, device="cpu")
    pts = batch_fn(1, seed=2)["points"][0]
    vl = cfg["pts_voxel_layer"]
    dv = voxel.voxelize_dynamic_ref(torch.from_numpy(pts)[None],
                                    torch.ones(1, len(pts), dtype=torch.bool),
                                    vl["point_cloud_range"], vl["voxel_size"])
    coors = dv.voxel_coors[:, 1:].numpy()
    v, cap = len(coors), vl["max_voxels"][0]
    feats = np.random.default_rng(13).normal(size=(v, 16)).astype(np.float32)
    jenc = JaxSparseEncoder(**enc)
    # the JAX table holds the detector's voxel cap of slots: its column
    # caps are ratios of it
    pad = cap - v
    args = (jnp.asarray(np.pad(feats, ((0, pad), (0, 0))))[None],
            jnp.asarray(np.pad(coors, ((0, pad), (0, 0))))[None],
            jnp.asarray(np.arange(cap) < v)[None])
    variables = random_variables(jenc, *args, seed=14)
    want = np.asarray(jax.jit(jenc.apply)(variables, *args))
    tenc = load_from_jax(SparseEncoder(**enc), variables,
                         "pts_middle_encoder_m", "pts_middle_encoder")
    stats = {}
    with torch.no_grad():
        got = tenc(torch.from_numpy(feats), dv.voxel_coors, 1,
                   return_stats=stats).numpy()
    assert got.shape == want.shape == (1, 40, 32, 32)
    assert len(stats["active_sites"]) == 3 and stats["active_sites"][0] == v
    assert_close_to_max(got, want, 1e-4)


# ------------------------------------------------------------------ head
def _oracle_assign(anchors, sizes, gts, labels, n_sizes, pos, neg, min_pos):
    """mmdet3d's per-size assignment in numpy: for each size i, a
    MaxIoUAssigner over the anchors of size i and the GTs of class i only
    (an anchor best for several GTs takes the one of highest IoU); the
    results scattered back to the anchors' order."""
    ious = bbox_overlaps_nearest_3d(torch.from_numpy(anchors),
                                    torch.from_numpy(gts)).numpy()
    out = np.full(len(anchors), -1, np.int64)
    for i in range(n_sizes):
        a_idx = np.nonzero(sizes == i)[0]
        g_idx = np.nonzero(labels == i)[0]
        if len(g_idx) == 0:
            continue                          # every anchor negative
        sub = ious[np.ix_(a_idx, g_idx)]
        best = sub.max(1)
        res = np.full(len(a_idx), -1, np.int64)
        res[(best >= neg) & (best < pos)] = -2
        res[best >= pos] = g_idx[sub.argmax(1)[best >= pos]]
        gbest = sub.max(0)
        forced = (sub == gbest[None]) & (sub >= min_pos)
        choice = np.where(forced, sub, -1.0).argmax(1)
        res[forced.any(1)] = g_idx[choice[forced.any(1)]]
        out[a_idx] = res
    return out


@pytest.mark.parametrize("per_size", [True, False])
def test_assigner_per_size_matches_numpy_oracle(per_size):
    cfg = tflagship.mvxnet_model_cfg(tiny=True)["pts_bbox_head"]
    head = Anchor3DHead(**{k: v for k, v in cfg.items() if k != "type"},
                        train_cfg=dict(assigner=dict(
                            pos_iou_thr=0.6, neg_iou_thr=0.45,
                            min_pos_iou=0.45)))
    head.assigner_per_size = per_size
    anchors = torch.from_numpy(head.anchors_for([(20, 16)]))
    sizes = head.anchor_sizes(len(anchors), "cpu").numpy()
    rng = np.random.default_rng(15)
    # GTs on jittered anchors: 16 of their own class's size, 8 of another
    # size, so that every size sees close GTs of its class and of others
    labels = rng.integers(0, 3, 24)
    own = (np.arange(24) < 16)
    want_size = np.where(own, labels, (labels + 1) % 3)
    pick = np.array([rng.choice(np.nonzero(sizes == z)[0])
                     for z in want_size])
    gts = anchors[pick].numpy().copy()
    gts[:, :2] += rng.normal(0, 0.1, (24, 2))
    gts[:, 3:6] *= rng.uniform(0.9, 1.1, (24, 3))
    got = head.assign(anchors, torch.from_numpy(gts), torch.from_numpy(
        labels), torch.ones(24, dtype=torch.bool)).numpy()
    if per_size:
        want = _oracle_assign(anchors.numpy(), sizes, gts, labels, 3, 0.6,
                              0.45, 0.45)
        pos = got >= 0
        assert (labels[got[pos]] == sizes[pos]).all()
        assert pos.sum() >= 10
    else:
        want = _oracle_assign(anchors.numpy(), np.zeros_like(sizes), gts,
                              np.zeros_like(labels), 1, 0.6, 0.45, 0.45)
        assert (labels[got[got >= 0]] != sizes[got >= 0]).any()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- schedule
def test_cosine_schedule_matches_jax():
    cfg = tflagship.mvxnet_optim_cfg()
    lr, warm, total = cfg["optimizer"]["lr"], 1000, 4000
    jsched = joptim.build_lr_schedule(cfg["lr_config"], lr, total)
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=lr)
    sched = toptim.build_schedule(opt, cfg["lr_config"], None, total)
    for step in (0, warm - 1, warm, total // 2, total - 1):
        sched.apply(step)
        assert abs(opt.param_groups[0]["lr"] - float(jsched(step))) <= \
            1e-6 * lr, step
    assert cfg["lr_config"]["warmup_iters"] == warm


# ------------------------------------------------------ the whole detector
@pytest.fixture(scope="module")
def detector():
    """The tiny MVX-Net with the VFE's fusion off on both sides (the two
    packages fuse at different layers), assigner_per_size off (the JAX
    head ignores it), JAX variables drawn with numpy and carried."""
    cfg = tflagship.mvxnet_model_cfg(tiny=True)
    cfg["pts_voxel_encoder"] = dict(cfg["pts_voxel_encoder"],
                                    fusion_layer=None)
    cfg["pts_bbox_head"] = dict(cfg["pts_bbox_head"], assigner_per_size=False)
    _, batch_fn = tflagship.build_mvxnet(tiny=True, device="cpu")
    batch = batch_fn(2, seed=1)
    jmodel = jbuild_detector(_jax_cfg(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(jmodel, jbatch, train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    feats = jax.jit(lambda v, b: jmodel.apply(v, b, train=False,
                                              mode="feats"))(variables,
                                                             jbatch)
    return cfg, batch, jmodel, variables, port.eval(), feats


def test_detector_head_outputs_and_predict_match(detector):
    _, batch, jmodel, variables, port, feats = detector
    got = port(batch, mode="feats", device="cpu")
    for g, w in zip(got[0], feats[0]):
        assert_close_to_max(g.numpy(), np.asarray(w), 1e-3)
    want = jax.jit(lambda v, f: jmodel.apply(
        v, f, method=lambda m, p: m.pts_bbox_head_m.get_bboxes(p)))(
            variables, feats)
    stats = {}
    out = port(batch, device="cpu", stats=stats)
    mask = np.asarray(want["mask"])
    np.testing.assert_array_equal(out["mask"].numpy(), mask)
    assert mask.sum() >= 10
    np.testing.assert_array_equal(out["labels"].numpy()[mask],
                                  np.asarray(want["labels"])[mask])
    assert_close_to_max(out["bboxes"].numpy()[mask],
                        np.asarray(want["bboxes"])[mask], 1e-4)
    assert stats["cap"] == 4096 and max(stats["voxels"]) < 2048
    assert len(stats["active_sites"]) == 3


@pytest.fixture(scope="module")
def detector_grads(detector):
    _, batch, jmodel, variables, port, _ = detector
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, bs):
        losses, _ = jmodel.apply({"params": params, "batch_stats": bs},
                                 jbatch, train=True, mode="loss",
                                 mutable=["batch_stats"])
        return total_loss(losses), losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    port = copy.deepcopy(port).train()
    tl = port(batch, mode="loss", device="cpu")
    sum(tl.values()).backward()
    return ({k: float(v) for k, v in jl.items()}, jg,
            state_dict_from_jax({"params": jax.device_get(jg)})), \
        (port, {k: v.item() for k, v in tl.items()})


def test_detector_loss_terms_and_gradients_match(detector_grads):
    (jl, _, jg), (port, tl) = detector_grads
    assert set(tl) == set(jl) == {"loss_cls", "loss_bbox", "loss_dir"}
    for k in jl:
        assert _rel(tl[k], jl[k]) <= 1e-4, k
    for top in MODULES:
        got, want = [], []
        for name, p in port.named_parameters():
            if name.split(".")[0] == top:
                want.append(jg[name].numpy().ravel())
                got.append(p.grad.numpy().ravel())
        want = np.concatenate(want)
        assert np.abs(want).max() > 0, top
        assert_close_to_max(np.concatenate(got), want, 1e-3)


def test_train_step_matches_jax(detector, detector_grads):
    """One step of the config's recipe (AdamW, CosineAnnealing with
    warmup, clip 35): the port's ``make_train_step`` against optax's
    update of the JAX ``build_optimizer`` on the JAX gradients, on the
    parameters with a gradient (the image branch gets none with fusion
    off; optax still decays it, the port skips it, as the reference)."""
    _, batch, _, variables, port0, _ = detector
    (jl, jgrads, jg), _ = detector_grads
    cfg = tflagship.mvxnet_optim_cfg()
    opt_cfg, opt_conf, lr_cfg = cfg["optimizer"], cfg["optimizer_config"], \
        cfg["lr_config"]
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = joptim.build_optimizer(params, opt_cfg, opt_conf, lr_cfg, None,
                                total_steps=100)
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(params), params)
    jafter = state_dict_from_jax({"params": jax.device_get(
        optax.apply_updates(params, updates))})
    port = copy.deepcopy(port0).train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    opt = toptim.build_optimizer(port, opt_cfg)
    step = make_train_step(port, opt, toptim.build_schedule(
        opt, lr_cfg, None, 100), toptim.grad_clip_norm(opt_conf))
    tm = step(batch, torch.Generator().manual_seed(0))
    assert _rel(tm["loss"], sum(jl.values())) <= 1e-4
    grad_norm = math.sqrt(sum(float((g.numpy().astype(np.float64) ** 2)
                                    .sum()) for g in jg.values()))
    assert _rel(tm["grad_norm"], grad_norm) <= 1e-4
    lr = opt_cfg["lr"] * lr_cfg["warmup_ratio"]       # step 0 of the warmup
    clip = min(1.0, opt_conf["grad_clip"]["max_norm"] / grad_norm)
    checked = 0
    for name, p in port.named_parameters():
        g = jg[name].numpy()
        if not p.requires_grad or not np.abs(g).max() > 0:
            continue
        sel = (np.abs(g) > 1e-4 * np.abs(g).max()) & \
            (np.abs(g) * clip > 100 * 1e-8)
        d_port = (p.detach() - before[name]).numpy()[sel]
        d_jax = (jafter[name] - before[name]).numpy()[sel]
        tol = 1e-2 * lr + 2 * np.spacing(np.abs(before[name].numpy()[sel]))
        assert (np.abs(d_port - d_jax) <= tol).all(), name
        checked += int(sel.sum())
    assert checked > 5000


# ------------------------------------------------- frozen ResNet parameters
def test_frozen_resnet_parameters_stay_put_through_a_step():
    """The tiny MVX-Net with fusion on (the image branch gets gradients):
    after one step of the config's recipe the stem, ``layer1`` and every
    BatchNorm (affine and running statistics) of the ResNet are
    unchanged, its ``layer2`` convs, the FPN and PointFusion moved."""
    model, batch_fn = tflagship.build_mvxnet(tiny=True, device="cpu", seed=3)
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert "img_backbone.conv1.weight" in frozen and \
        "img_backbone.layer1.0.conv2.weight" in frozen and \
        "img_backbone.layer2.0.bn1.weight" in frozen and \
        "img_backbone.layer2.0.conv1.weight" not in frozen
    cfg = tflagship.mvxnet_optim_cfg()
    opt = toptim.build_optimizer(model, cfg["optimizer"])
    step = make_train_step(model, opt, toptim.build_schedule(
        opt, cfg["lr_config"], None, 100),
        toptim.grad_clip_norm(cfg["optimizer_config"]))
    m = step(batch_fn(2), torch.Generator().manual_seed(0))
    assert math.isfinite(m["loss"])
    after = model.state_dict()
    for k, v in before.items():
        still = torch.equal(after[k], v)
        if k.startswith("img_backbone.") and (
                k.split(".")[1] in ("conv1", "bn1", "layer1") or
                ".bn" in k or ".downsample.1." in k):
            assert still, k
        if k in ("img_backbone.layer2.0.conv1.weight",
                 "img_neck.fpn_convs.0.conv.weight",
                 "pts_voxel_encoder.fusion_layer.lateral_convs.0.conv.weight",
                 "pts_voxel_encoder.fusion_layer.img_transform.0.weight"):
            assert not still, k


# --------------------------------------------------------------- converter
def test_converter_carries_the_jax_mvxnet_tree():
    """The JAX tiny MVX-Net's whole tree (fusion on: its PointFusion
    after the first VFE layer) carried by ``state_dict_from_jax`` gives
    every key of the port's state_dict; the shapes agree except the second
    VFE layer's input, which the two fusion layouts make 64 (JAX: the
    concatenated halves and their voxel max) and 32 wide (the port)."""
    cfg = tflagship.mvxnet_model_cfg(tiny=True)
    _, batch_fn = tflagship.build_mvxnet(tiny=True, device="cpu")
    jbatch = {k: jnp.asarray(v) for k, v in batch_fn(1).items()}
    shapes = jax.eval_shape(lambda: jbuild_detector(_jax_cfg(cfg)).init(
        jax.random.PRNGKey(0), jbatch, train=False, mode="feats"))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    sd = state_dict_from_jax(tree)
    ref = build_detector(cfg).state_dict()
    assert set(sd) == set(ref)
    differ = [k for k in ref if tuple(sd[k].shape) != tuple(ref[k].shape)]
    assert differ == ["pts_voxel_encoder.vfe_layers.1.linear.weight"]
    assert tuple(sd[differ[0]].shape) == (16, 64)
    assert tuple(ref[differ[0]].shape) == (16, 32)


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tflagship.build_mvxnet(tiny=True)
    assert os.path.isfile(tflagship.MVXNET_CFG)


def test_detector_level_fusion_layer_raises():
    cfg = dict(tflagship.mvxnet_model_cfg(tiny=True),
               pts_fusion_layer=dict(type="PointFusion"))
    with pytest.raises(ValueError, match="pts_fusion_layer"):
        build_detector(cfg)
