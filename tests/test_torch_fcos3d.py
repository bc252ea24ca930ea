"""The port's FCOS3D (``configs/fcos3d/fcos3d_r101_caffe_fpn_gn-head_2x8_
1x_nus-mono3d.py``, ``FCOSMono3D``) against the JAX package: GroupNorm
in ConvModule, camera boxes and their LiDAR conversion, FCOSMono3DHead's
forward per level, its center-sampled targets (with tied distances), each
loss term, its decode (top-k on distinct and tied scores), the whole tiny
detector (``fcos3d_model_cfg(tiny=True)``, the JAX test's model) in head
outputs, predict, loss terms and gradients, one SGD + clip step where the
two packages compute the same thing (``weight_decay=0``, multipliers 1),
``NuScenesMonoDataset`` on an info file made here, and the carry through
the JAX package's camera converter. Then what the port does where the JAX
package does not (ROADMAP queue 3): the config's SGD (weight decay, 2x lr
and no decay on the biases of every layer but the norms) against a numpy
oracle of torch's SGD.

Inputs are numpy arrays made from a seed and handed to both packages; JAX
variables are drawn with numpy (``tests/torch_parity.py``) and carried
with ``state_dict_from_jax``. The JAX detector's forward and loss
gradient are jitted once each; the rest runs eagerly.

Tolerances (float32, CPU): GN and the head's maps 1e-4 of their max (the
detector's 1e-3: sums in another order through ResNet); target labels,
foreground, attributes and the assigned GT exact, codes 1e-5 of their
max; losses 1e-4 relative; gradients 1e-3 of each top-level module's
max; the step's updates within 1e-2 of the learning rate; decoded top-k
indices exact, boxes 1e-4 of their max; metrics 1e-12.
"""
import copy
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isfusion_tpu.core.bbox import structures as jstructures
from isfusion_tpu.datasets.nuscenes_mono_dataset import \
    NuScenesMonoDataset as JaxMonoDataset
from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.models.dense_heads.fcos_mono3d_head import \
    FCOSMono3DHead as JaxHead
from isfusion_tpu.models.layers import ConvModule as JaxConvModule
from isfusion_tpu.parallel.train_step import total_loss
from isfusion_tpu.runner import optim as joptim
from isfusion_tpu.runner.full_ckpt_convert import (
    convert_camera_torch_to_flax, convert_detector_torch_to_flax)
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.config import Config
from isfusion_tpu_torch.core.bbox import structures
from isfusion_tpu_torch.datasets import NuScenesMonoDataset
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.dense_heads.fcos_mono3d_head import \
    FCOSMono3DHead
from isfusion_tpu_torch.models.layers import ConvModule
from isfusion_tpu_torch.parallel.train_step import make_train_step
from isfusion_tpu_torch.runner import optim as toptim
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from torch_parity import assert_close_to_max, load_from_jax, random_variables

MODULES = ("backbone", "neck", "bbox_head")
KEYS = ("cls_score", "bbox_pred", "dir_cls_pred", "attr_pred", "centerness")
LOSSES = {"loss_cls", "loss_bbox", "loss_centerness", "loss_dir",
          "loss_attr"}


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def _jax_cfg(v):
    """A port config for the JAX builder (no compute_dtype keys)."""
    if isinstance(v, dict):
        return {k: _jax_cfg(x) for k, x in v.items() if k != "compute_dtype"}
    return v


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def test_full_width_cfg_is_the_config():
    want = _plain(dict(Config.fromfile(tflagship.FCOS3D_CFG).model))
    got = _plain(tflagship.fcos3d_model_cfg())
    for key in MODULES:
        assert got[key].pop("compute_dtype") == "bfloat16", key
    assert got == want
    model = build_detector(tflagship.fcos3d_model_cfg())
    head = model.bbox_head
    assert head.num_classes == 10 and head.num_attrs == 9
    assert head.strides == (8, 16, 32, 64, 128)
    assert len(model.neck.fpn_convs) == 5 and model.neck.start_level == 1
    assert model.bbox_head.cls_convs[0].gn.num_groups == 32
    assert model.test_cfg["max_per_img"] == 200
    opt = tflagship.fcos3d_optim_cfg()
    assert opt["samples_per_gpu"] == 2 and opt["max_epochs"] == 12
    assert opt["optimizer"]["type"] == "SGD"
    assert opt["optimizer"]["paramwise_cfg"] == dict(bias_lr_mult=2.0,
                                                     bias_decay_mult=0.0)
    batch = tflagship.synthetic_mono_batch(1)
    assert batch["img"].shape == (1, 928, 1600, 3)
    assert not batch["img"][:, 900:].any()
    assert batch["gt_bboxes_3d"].shape == (1, 24, 9)
    u, v = batch["centers2d"][..., 0], batch["centers2d"][..., 1]
    assert ((u > 0) & (u < 1600) & (v > 0) & (v < 900)).all()
    # the camera-frame centres project to centers2d at depth z
    k = batch["cam2img"][0, :3, :3]
    proj = batch["gt_bboxes_3d"][0, :, :3] @ k.T
    np.testing.assert_allclose(proj[:, :2] / proj[:, 2:],
                               batch["centers2d"][0], rtol=1e-4)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("groups,eps", [(4, 1e-5), (2, 1e-3)])
def test_group_norm_conv_module_matches_jax(groups, eps):
    norm = dict(type="GN", num_groups=groups, eps=eps)
    jmod = JaxConvModule(8, 3, padding=1, norm_cfg=norm,
                         act_cfg=dict(type="relu"))
    x = np.random.default_rng(1).normal(2.0, 3.0, (2, 9, 7, 5)).astype(
        np.float32)
    variables = random_variables(jmod, jnp.asarray(x), seed=2)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    sd = state_dict_from_jax({"params": {"bbox_head_m": {
        "cls_convs_0": variables["params"]}}})
    port = ConvModule(5, 8, 3, padding=1, norm_cfg=norm,
                      act_cfg=dict(type="relu"))
    port.load_state_dict({k[len("bbox_head.cls_convs.0."):]: v
                          for k, v in sd.items()})
    assert port.bn is None and port.gn.num_groups == groups
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert_close_to_max(got, want, 1e-4)
    # bf16 compute keeps GN's statistics in float32
    port_bf = ConvModule(5, 8, 3, padding=1, norm_cfg=norm,
                         act_cfg=dict(type="relu"), dtype=torch.bfloat16)
    port_bf.load_state_dict(port.state_dict())
    with torch.no_grad():
        got_bf = port_bf(torch.from_numpy(x))
    assert got_bf.dtype == torch.bfloat16
    assert_close_to_max(got_bf.float().numpy(), want, 3e-2)


def test_camera_boxes_match_jax():
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.uniform(-20, 20, (6, 3)),
                           rng.uniform(0.5, 4, (6, 3)),
                           rng.uniform(-np.pi, np.pi, (6, 1)),
                           rng.uniform(-1, 1, (6, 2))], -1).astype(np.float32)
    for origin in (None, (0.5, 0.5, 0.5)):
        kw = {} if origin is None else dict(origin=origin)
        got = structures.CameraInstance3DBoxes(rows, box_dim=9, **kw)
        want = jstructures.CameraInstance3DBoxes(rows, box_dim=9, **kw)
        np.testing.assert_array_equal(got.tensor, want.tensor)
        for attr in ("gravity_center", "bev", "height", "top_height",
                     "bottom_height", "dims", "yaw"):
            np.testing.assert_allclose(getattr(got, attr),
                                       getattr(want, attr), rtol=0,
                                       atol=1e-6, err_msg=attr)
        np.testing.assert_array_equal(got.in_range_bev([-10, 0, 10, 15]),
                                      want.in_range_bev([-10, 0, 10, 15]))
        for d in ("horizontal", "vertical"):
            g, w = got.new_box(got.tensor), want.clone()
            g.flip(d)
            w.flip(d)
            np.testing.assert_allclose(g.tensor, w.tensor, atol=1e-6)
        g, w = got.new_box(got.tensor), want.clone()
        np.testing.assert_allclose(g.rotate(0.3), w.rotate(0.3), atol=1e-7)
        np.testing.assert_allclose(g.tensor, w.tensor, atol=1e-5)
    cam = structures.CameraInstance3DBoxes(rows, box_dim=9)
    jcam = jstructures.CameraInstance3DBoxes(rows, box_dim=9)
    lidar = cam.convert_to(structures.Box3DMode.LIDAR)
    jlidar = jcam.convert_to(jstructures.Box3DMode.LIDAR)
    assert isinstance(lidar, structures.LiDARInstance3DBoxes)
    np.testing.assert_allclose(lidar.tensor, jlidar.tensor, atol=1e-6)
    rt = np.eye(4, dtype=np.float32)
    rt[:3, 3] = [0.5, -1.0, 2.0]
    back = lidar.convert_to(structures.Box3DMode.CAM, rt)
    jback = jlidar.convert_to(jstructures.Box3DMode.CAM, rt)
    np.testing.assert_allclose(back.tensor, jback.tensor, atol=1e-5)
    np.testing.assert_allclose(
        structures.Box3DMode.convert(rows[0], structures.Box3DMode.CAM,
                                     structures.Box3DMode.LIDAR),
        jstructures.Box3DMode.convert(rows[0], jstructures.Box3DMode.CAM,
                                      jstructures.Box3DMode.LIDAR),
        atol=1e-6)
    assert structures.get_box_type("Camera") == (
        structures.CameraInstance3DBoxes, structures.Box3DMode.CAM)
    assert structures.get_box_type("Depth") == (
        structures.DepthInstance3DBoxes, structures.Box3DMode.DEPTH)
    with pytest.raises(ValueError):
        structures.get_box_type("Radar")


# ------------------------------------------------------------------ head
def _head_cfg():
    cfg = dict(tflagship.fcos3d_model_cfg(tiny=True)["bbox_head"])
    cfg.pop("type")
    return cfg


def _feats(seed=5, b=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, w, 16)).astype(np.float32)
            for h, w in ((8, 12), (4, 6), (2, 3))]


@pytest.fixture(scope="module")
def head():
    """The tiny head alone (the JAX test's), JAX variables drawn with
    numpy and carried; the JAX per-level maps of one set of features."""
    jhead = JaxHead(**_head_cfg())
    feats = _feats()
    jfeats = [jnp.asarray(f) for f in feats]
    variables = random_variables(jhead, jfeats, seed=6)
    want = jhead.apply(variables, jfeats)
    port = load_from_jax(FCOSMono3DHead(**_head_cfg()), variables,
                         "bbox_head_m", "bbox_head")
    return jhead, variables, port, feats, want


def test_head_forward_per_level_matches_jax(head):
    _, _, port, feats, want = head
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats])
    assert len(got) == 3
    for g, w in zip(got, want):
        for k in KEYS:
            assert tuple(g[k].shape) == w[k].shape, k
            assert_close_to_max(g[k].numpy(), np.asarray(w[k]), 1e-4)
    assert (got[0]["bbox_pred"][..., 2:6] > 0).all()


def _tied_batch(b=2, g=6, seed=7):
    """GTs of the tiny head's image (64 x 96) with two pairs of identical
    projected centres (the assignment's distance ties) and a masked row."""
    batch = tflagship.synthetic_mono_batch(
        b, seed, img_hw=(64, 96), valid_hw=(64, 96),
        intrinsic=((50.0, 0.0, 48.0), (0.0, 50.0, 32.0), (0.0, 0.0, 1.0)),
        num_gt=g, num_classes=3, num_attrs=4, depth_range=(5.0, 40.0))
    for k in ("centers2d", "gt_bboxes"):
        batch[k][:, 1] = batch[k][:, 0]
        batch[k][:, 4] = batch[k][:, 3]
    # one large 2D box, for the coarse levels' regress ranges
    batch["gt_bboxes"][:, 2] = [2.0, 2.0, 94.0, 62.0]
    batch["gt_mask"][:] = True
    batch["gt_mask"][:, -1] = False
    return batch


def test_targets_match_jax(head):
    jhead, _, port, _, _ = head
    batch = _tied_batch()
    shapes = [(8, 12), (4, 6), (2, 3)]
    jpts, jstr = jhead._points(shapes)
    jrng = jhead._ranges(shapes)
    want = jax.vmap(lambda *a: jhead.get_targets_single(jpts, jstr, jrng, *a))(
        *[jnp.asarray(batch[k]) for k in (
            "gt_bboxes", "centers2d", "depths", "gt_bboxes_3d",
            "gt_labels_3d", "attr_labels", "gt_mask")])
    pts, strides = port.points(shapes, "cpu")
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(strides.numpy(), np.asarray(jstr))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    got = port.get_targets(pts, strides, port.ranges(shapes, "cpu"),
                           t["gt_bboxes"], t["centers2d"], t["depths"],
                           t["gt_bboxes_3d"], t["gt_labels_3d"].long(),
                           t["attr_labels"].long(), t["gt_mask"])
    labels, codes, ctr, attrs, fg = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[0].numpy(), labels)
    np.testing.assert_array_equal(got[3].numpy(), attrs)
    np.testing.assert_array_equal(got[4].numpy(), fg)
    assert fg.sum() >= 20 and (~fg).sum() > 0
    # the assigned GT of every foreground point: its depth is unique
    np.testing.assert_array_equal(got[1].numpy()[..., 2][fg], codes[..., 2][fg])
    assert_close_to_max(got[1].numpy(), codes, 1e-5)
    assert_close_to_max(got[2].numpy(), ctr, 1e-5)
    # a tie goes to the first of the two GT rows, as in the JAX package
    d = batch["depths"]
    tied = np.isin(codes[..., 2], [d[0, 0], d[0, 3], d[1, 0], d[1, 3]]) & fg
    assert tied.any()
    assert not np.isin(codes[..., 2][fg], d[:, [1, 4]]).any()


def _to_torch_preds(preds):
    return [{k: torch.from_numpy(np.array(p[k])) for k in KEYS}
            for p in preds]


def test_loss_terms_match_jax(head):
    jhead, _, port, _, want = head
    batch = _tied_batch()
    jl = jhead.loss(want, {k: jnp.asarray(v) for k, v in batch.items()})
    tl = port.loss(_to_torch_preds(want),
                   {k: torch.from_numpy(np.asarray(v))
                    for k, v in batch.items()})
    assert set(tl) == set(jl) == LOSSES
    for k in jl:
        assert _rel(tl[k], jl[k]) <= 1e-4, k
    # without attribute labels neither package has an attribute loss
    nb = {k: v for k, v in batch.items() if k != "attr_labels"}
    assert set(port.loss(_to_torch_preds(want), {
        k: torch.from_numpy(np.asarray(v)) for k, v in nb.items()})) == \
        set(jhead.loss(want, {k: jnp.asarray(v) for k, v in nb.items()})) \
        == LOSSES - {"loss_attr"}


@pytest.mark.parametrize("tied", [False, True])
def test_decode_matches_jax(head, tied):
    """Top-k indices equal on distinct and on tied scores (every point
    and class at one score: ``jax.lax.top_k`` takes the lower index
    first), boxes to 1e-4 of their max, yaws through negative angles."""
    jhead, _, port, _, want = head
    preds = [{k: np.array(p[k]) for k in KEYS} for p in want]
    for p in preds:                     # local yaws of either sign
        p["bbox_pred"][..., 6] = 3.0 * np.tanh(p["bbox_pred"][..., 6] * 4)
    if tied:
        for p in preds:
            p["cls_score"][:] = 0.3
            p["centerness"][:] = -0.2
    cam2img = tflagship.build_fcos3d(tiny=True, device="cpu")[1](2)[
        "cam2img"]
    jout = jhead.get_bboxes([{k: jnp.asarray(v) for k, v in p.items()}
                             for p in preds], jnp.asarray(cam2img), 16)
    out = port.get_bboxes(_to_torch_preds(preds), torch.from_numpy(cam2img),
                          16)
    for k in ("scores", "labels", "attrs", "mask"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    assert_close_to_max(out["bboxes"].numpy(), np.asarray(jout["bboxes"]),
                        1e-4)
    if tied:
        # the first 16 points in order: their boxes are those rows
        flat = np.concatenate([p["bbox_pred"].reshape(2, -1, 9)
                               for p in preds], 1)
        np.testing.assert_allclose(out["bboxes"].numpy()[..., 3:6],
                                   flat[:, :16, 3:6], rtol=1e-6)
    # the direction bin's floor-mod met negative angles
    assert (np.concatenate([p["bbox_pred"].reshape(2, -1, 9)[..., 6]
                            for p in preds], 1) < -1.0).any()


# -------------------------------------------------------------- detector
@pytest.fixture(scope="module")
def detector():
    cfg = tflagship.fcos3d_model_cfg(tiny=True)
    _, batch_fn = tflagship.build_fcos3d(tiny=True, device="cpu")
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
    for g, w in zip(got, feats):
        for k in KEYS:
            assert_close_to_max(g[k].numpy(), np.asarray(w[k]), 1e-3)
    want = jmodel.apply(variables, feats, jnp.asarray(batch["cam2img"]),
                        16, method=lambda m, p, c, n:
                        m.bbox_head_m.get_bboxes(p, c, max_num=n))
    out = port(batch, device="cpu")
    assert out["bboxes"].shape == (2, 16, 9)
    for k in ("labels", "attrs", "mask"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))
    assert_close_to_max(out["scores"].numpy(), np.asarray(want["scores"]),
                        1e-4)
    assert_close_to_max(out["bboxes"].numpy(), np.asarray(want["bboxes"]),
                        1e-4)


@pytest.fixture(scope="module")
def detector_grads(detector):
    _, batch, jmodel, variables, port, _ = detector
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        losses = jmodel.apply({**variables, "params": params}, jbatch,
                              train=True, mode="loss")
        return total_loss(losses), losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    port = copy.deepcopy(port).train()
    tl = port(batch, mode="loss", device="cpu")
    sum(tl.values()).backward()
    return ({k: float(v) for k, v in jl.items()}, jg,
            state_dict_from_jax({"params": jax.device_get(jg)})), \
        (port, {k: v.item() for k, v in tl.items()})


def test_detector_loss_terms_and_gradients_match(detector_grads):
    (jl, _, jg), (port, tl) = detector_grads
    assert set(tl) == set(jl) == LOSSES
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


def test_sgd_step_matches_jax(detector, detector_grads):
    """One SGD + momentum + clip step under the config's step schedule
    (step 0 of the linear warmup) with ``weight_decay=0`` and no bias
    multipliers, where optax's SGD and torch's compute the same update."""
    _, batch, _, variables, port0, _ = detector
    (jl, jgrads, jg), _ = detector_grads
    cfg = tflagship.fcos3d_optim_cfg()
    opt_cfg = dict(type="SGD", lr=cfg["optimizer"]["lr"], momentum=0.9,
                   weight_decay=0.0)
    opt_conf, lr_cfg = cfg["optimizer_config"], cfg["lr_config"]
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = joptim.build_optimizer(params, opt_cfg, opt_conf, lr_cfg, None,
                                total_steps=100)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jafter = state_dict_from_jax({"params": jax.device_get(
        optax.apply_updates(params, updates))})
    port = copy.deepcopy(port0).train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    opt = toptim.build_optimizer(port, opt_cfg)
    assert len(opt.param_groups) == 1
    step = make_train_step(port, opt, toptim.build_schedule(
        opt, lr_cfg, None, 100), toptim.grad_clip_norm(opt_conf))
    tm = step(batch, torch.Generator().manual_seed(0))
    assert _rel(tm["loss"], sum(jl.values())) <= 1e-4
    grad_norm = math.sqrt(sum(float((g.numpy().astype(np.float64) ** 2)
                                    .sum()) for g in jg.values()))
    assert _rel(tm["grad_norm"], grad_norm) <= 1e-4
    lr = opt_cfg["lr"] * lr_cfg["warmup_ratio"]
    checked = 0
    for name, p in port.named_parameters():
        d_port = (p.detach() - before[name]).numpy()
        d_jax = (jafter[name] - before[name]).numpy()
        tol = 1e-2 * lr + 2 * np.spacing(np.abs(before[name].numpy()))
        assert (np.abs(d_port - d_jax) <= tol).all(), name
        checked += d_port.size
    assert checked > 50000


def test_config_sgd_matches_the_reference_oracle():
    """The config's SGD (momentum 0.9, weight decay 1e-4, biases of every
    layer but the norms at 2x the lr and no decay; mmcv's
    DefaultOptimizerConstructor) through two steps of fixed gradients
    against numpy: ``buf = m * buf + g + wd * p``; ``p -= lr * buf``."""
    cfg = tflagship.fcos3d_optim_cfg()["optimizer"]
    model = build_detector(tflagship.fcos3d_model_cfg(tiny=True))
    opt = toptim.build_optimizer(model, cfg)
    rng = np.random.default_rng(9)
    names = dict(model.named_modules())
    state = {}
    for name, p in model.named_parameters():
        mod = names[name.rsplit(".", 1)[0]] if "." in name else model
        is_bias = name.endswith(".bias") and not isinstance(
            mod, (torch.nn.GroupNorm, torch.nn.modules.batchnorm._BatchNorm))
        lr = cfg["lr"] * (2.0 if is_bias else 1.0)
        wd = 0.0 if is_bias else cfg["weight_decay"]
        state[name] = [p.detach().numpy().astype(np.float64).copy(), None,
                       lr, wd]
    assert sum(s[3] == 0 for s in state.values()) > 10
    for _ in range(2):
        for name, p in model.named_parameters():
            g = rng.normal(size=tuple(p.shape)).astype(np.float32)
            p.grad = torch.from_numpy(g)
            w, buf, lr, wd = state[name]
            d = g + wd * w
            buf = d if buf is None else cfg["momentum"] * buf + d
            state[name] = [w - lr * buf, buf, lr, wd]
        opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), state[name][0],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    with pytest.raises(NotImplementedError, match="AdamW, Adam and SGD"):
        toptim.build_optimizer(model, dict(type="RMSprop"))


def test_adamw_takes_the_bias_multipliers():
    """AdamW reads ``bias_lr_mult`` and ``bias_decay_mult`` as SGD does
    (mmcv's rule for every optimizer): a bias of every layer but the
    norms in a group at 2x the lr and no decay, a ``custom_keys`` match
    before them, the other parameters at the base lr and decay."""
    model = build_detector(tflagship.fcos3d_model_cfg(tiny=True))
    opt = toptim.build_optimizer(model, dict(
        type="AdamW", lr=1e-3, weight_decay=0.01,
        paramwise_cfg=dict(bias_lr_mult=2.0, bias_decay_mult=0.0,
                           custom_keys={"conv_cls": dict(lr_mult=0.5)})))
    assert isinstance(opt, torch.optim.AdamW)
    group = {id(p): (g["lr"], g["weight_decay"]) for g in opt.param_groups
             for p in g["params"]}
    names = dict(model.named_modules())
    for name, p in model.named_parameters():
        mod = names[name.rsplit(".", 1)[0]]
        if "conv_cls" in name:
            want = (5e-4, 0.01)
        elif name.endswith(".bias") and not isinstance(
                mod, (torch.nn.GroupNorm,
                      torch.nn.modules.batchnorm._BatchNorm)):
            want = (2e-3, 0.0)
        else:
            want = (1e-3, 0.01)
        assert group[id(p)] == pytest.approx(want), name


# ---------------------------------------------------------------- dataset
def _mono_infos(n=3, seed=10):
    rng = np.random.default_rng(seed)
    infos = []
    for i in range(n):
        g = 5 + i
        boxes = np.concatenate([rng.uniform(-10, 10, (g, 1)),
                                rng.uniform(-1, 2, (g, 1)),
                                rng.uniform(5, 45, (g, 1)),
                                rng.uniform(0.5, 4, (g, 3)),
                                rng.uniform(-np.pi, np.pi, (g, 1)),
                                rng.uniform(-1, 1, (g, 2))], -1)
        infos.append(dict(
            img_path=f"samples/CAM_FRONT/{i}.jpg", token=f"tok{i}",
            cam_intrinsic=np.asarray(tflagship.NUSCENES_CAM_INTRINSIC),
            annos=dict(bboxes=rng.uniform(0, 900, (g, 4)),
                       bboxes_cam3d=boxes, centers2d=rng.uniform(0, 900,
                                                                 (g, 2)),
                       depths=boxes[:, 2], labels=rng.integers(0, 10, g),
                       attr_labels=rng.integers(0, 9, g),
                       names=np.array(["car"] * g))))
    return infos


def test_mono_dataset_matches_jax(tmp_path):
    path = os.path.join(tmp_path, "mono_infos.pkl")
    infos = _mono_infos()
    with open(path, "wb") as f:
        pickle.dump(dict(infos=infos, metadata=dict(version="synthetic")), f)
    got, want = NuScenesMonoDataset(path), JaxMonoDataset(path)
    assert len(got) == len(want) == 3 and got.CLASSES == want.CLASSES
    for i in range(3):
        g, w = got.get_data_info(i), want.get_data_info(i)
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["cam2img"], w["cam2img"])
        for k in ("sample_idx", "token", "img_filename", "timestamp"):
            assert g[k] == w[k], k
        ga, wa = g["ann_info"], w["ann_info"]
        assert set(ga) == set(wa)
        np.testing.assert_array_equal(ga["gt_bboxes_3d"].tensor,
                                      wa["gt_bboxes_3d"].tensor)
        for k in ("gt_labels_3d", "gt_names", "bboxes", "centers2d",
                  "depths", "attr_labels"):
            np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
    assert NuScenesMonoDataset(path, test_mode=True).get_data_info(0).get(
        "ann_info") is None
    # detections: the GT jittered, a missed box, a false one, scores
    rng = np.random.default_rng(11)
    results = []
    for i, info in enumerate(infos):
        b = np.asarray(info["annos"]["bboxes_cam3d"], np.float32).copy()
        b[:, :3] += rng.normal(0, 0.3, (len(b), 3))
        b = np.concatenate([b, b[:1] + 20.0])
        results.append(dict(bboxes=b, scores=rng.uniform(0.1, 1, len(b)),
                            labels=np.concatenate([
                                info["annos"]["labels"], [1]]),
                            mask=np.arange(len(b)) != 1))
    gm, wm = got.evaluate(results), want.evaluate(results)
    assert set(gm) == set(wm)
    for k, v in wm.items():
        if isinstance(v, float):
            assert abs(gm[k] - v) <= 1e-12, k
        else:
            assert gm[k] == v, k
    assert wm["mAP"] > 0


# -------------------------------------------------------------- converter
@pytest.mark.parametrize("converter", ["camera", "detector"])
def test_round_trip_through_the_jax_converter(detector, converter):
    """A reference-layout state_dict through the JAX package's camera
    converter (and its family router) and back through
    ``state_dict_from_jax``: every tensor of the tiny FCOS3D (ResNet, the
    FPN's laterals numbered from 0, GN, the branch towers, the per-level
    scales) comes back."""
    _, _, _, variables, port, _ = detector
    rng = np.random.default_rng(12)
    ref = {k: np.zeros(v.shape, np.int64) if k.endswith(
        "num_batches_tracked") else rng.normal(size=tuple(v.shape)).astype(
            np.float32) for k, v in port.state_dict().items()}
    convert = convert_camera_torch_to_flax if converter == "camera" \
        else convert_detector_torch_to_flax
    jax_vars, missing = convert(ref, variables)
    assert missing == []
    back = state_dict_from_jax(jax_vars)
    assert set(back) == set(ref)
    for k, want in ref.items():
        np.testing.assert_array_equal(back[k].numpy(), want, err_msg=k)
    assert "bbox_head.scales.2.1.scale" in ref
    assert "bbox_head.cls_convs.0.gn.weight" in ref


def test_converter_numbers_laterals_from_zero():
    """The full-width config's FPN starts at C3 (``start_level=1``): the
    JAX tree's ``lateral_1..3`` carry into ``neck.lateral_convs.0..2``,
    and every key and shape of the port's state_dict is given."""
    cfg = tflagship.fcos3d_model_cfg()
    jmodel = jbuild_detector(_jax_cfg(cfg))
    batch = tflagship.synthetic_mono_batch(1, img_hw=(64, 64),
                                           valid_hw=(64, 64))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()},
        train=False, mode="feats"))
    assert sorted(k for k in shapes["params"]["neck_m"]
                  if k.startswith("lateral")) == [
        "lateral_1", "lateral_2", "lateral_3"]
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    sd = state_dict_from_jax(tree)
    ref = build_detector(cfg).state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tflagship.build_fcos3d(tiny=True)
    assert os.path.isfile(tflagship.FCOS3D_CFG)
