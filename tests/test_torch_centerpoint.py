"""The port's CenterPoint (``configs/centerpoint/centerpoint_0075voxel_
second_secfpn_circlenms_4x8_cyclic_20e_nus.py``) against the JAX package:
HardSimpleVFE, the CenterPoint box coder (with tied scores), circle NMS
(the plain version of K10-circle), the batched gaussian heatmap (the
plain version of K11), CenterHead's targets, losses and ``get_bboxes``
(circle and rotated NMS), the whole tiny detector's head outputs,
predict, loss terms and gradients, one AdamW + clip step with the
config's recipe, and the carry through the JAX package's converter
(``convert_detector_torch_to_flax``: ``convert_lidar_torch_to_flax`` for
the LiDAR modules, the IS-Fusion resolver for this config's SECONDFPN of
a 1x1 conv and a deconv).

Inputs are numpy arrays made from a seed and handed to both packages;
JAX variables are drawn with numpy (``tests/torch_parity.py``) and carried
with ``state_dict_from_jax``. The tiny model (``centerpoint_model_cfg(
tiny=True)``: 16 m, 0.125 m voxels, 16 x 16 BEV, narrow widths) lifts the
JAX SparseEncoder's column caps to the whole grid and its voxel cap above
the points, so neither package drops anything. The JAX detector's forward
and loss gradient are jitted once each; its head's decode, NMS and the
optimizer step run eagerly.

Tolerances (float32, CPU): voxel features 1e-6 of the max; coder boxes
1e-6 of the max with equal labels, masks and scores; circle NMS keep
masks exact; heatmaps 1e-6 absolute with exactly equal positives (cells
at 1.0); targets' anno 1e-6 of the max, ind and masks exact; losses 1e-4
relative; head outputs 1e-3 of the max (summation order differs);
predicted boxes 1e-4 of the max on the kept entries, which must be the
same entries with the same labels; gradients 1e-3 of each top-level
module's max; the step's updates within 1e-2 of the learning rate.
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

from isfusion_tpu.core.bbox.coders import CenterPointBBoxCoder as JaxCoder
from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.models.dense_heads.centerpoint_head import \
    CenterHead as JaxHead
from isfusion_tpu.models.voxel_encoders import HardSimpleVFE as JaxVFE
from isfusion_tpu.ops import box_ops as jbox
from isfusion_tpu.ops import gaussian as jgauss
from isfusion_tpu.ops import voxel as jvoxel
from isfusion_tpu.parallel.train_step import total_loss
from isfusion_tpu.runner import optim as joptim
from isfusion_tpu.runner.full_ckpt_convert import \
    convert_detector_torch_to_flax, convert_lidar_torch_to_flax
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.config import Config
from isfusion_tpu_torch.core.bbox.coders import CenterPointBBoxCoder
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.dense_heads.centerpoint_head import CenterHead
from isfusion_tpu_torch.models.voxel_encoders import HardSimpleVFE
from isfusion_tpu_torch.ops import box_ops, gaussian
from isfusion_tpu_torch.parallel.train_step import make_train_step
from isfusion_tpu_torch.runner import optim as toptim
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from torch_parity import assert_close_to_max, random_variables

MODULES = ("pts_middle_encoder", "pts_backbone", "pts_neck", "pts_bbox_head")
BRANCHES = ("reg", "height", "dim", "rot", "vel", "heatmap")
HW = (16, 16)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def _jax_cfg(cfg):
    """The port's model config for the JAX builder (no compute_dtype on
    the JAX CenterHead)."""
    cfg = copy.deepcopy(cfg)
    cfg["pts_bbox_head"] = {k: v for k, v in cfg["pts_bbox_head"].items()
                            if k != "compute_dtype"}
    return cfg


@pytest.fixture(scope="module")
def tiny():
    cfg = tflagship.centerpoint_model_cfg(tiny=True)
    _, batch_fn = tflagship.build_centerpoint(tiny=True, device="cpu")
    return cfg, batch_fn(2)


def _plain(v):
    """Config values as plain dicts, lists and numbers."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def test_full_width_cfg_is_the_config():
    want = _plain(dict(Config.fromfile(tflagship.CENTERPOINT_CFG).model))
    got = _plain(tflagship.centerpoint_model_cfg())
    for key in ("pts_middle_encoder", "pts_backbone", "pts_neck",
                "pts_bbox_head"):
        assert got[key].pop("compute_dtype") == "bfloat16", key
    assert got == want
    opt = tflagship.centerpoint_optim_cfg()
    assert opt["samples_per_gpu"] == 4
    assert opt["optimizer"] == dict(type="AdamW", lr=1e-4, weight_decay=0.01)
    assert opt["optimizer_config"]["grad_clip"]["max_norm"] == 35
    assert opt["lr_config"]["policy"] == opt["momentum_config"][
        "policy"] == "cyclic"


# ------------------------------------------------------------ voxel encoder
def test_hard_simple_vfe_matches(tiny):
    cfg, batch = tiny
    vl = cfg["pts_voxel_layer"]
    vox = jax.jit(jax.vmap(lambda p, m: jvoxel.voxelize_hard(
        p, m, vl["point_cloud_range"], vl["voxel_size"],
        vl["max_num_points"], vl["max_voxels"][0])))(
            jnp.asarray(batch["points"]), jnp.asarray(batch["points_mask"]))
    want = JaxVFE(num_features=5).apply({}, vox.voxels, vox.num_points,
                                        vox.coors)
    vm = np.asarray(vox.voxel_mask)
    # every voxel held: the cap is above the points
    assert vm.sum(1).max() < vl["max_voxels"][0]
    got = HardSimpleVFE(num_features=5)(
        torch.from_numpy(np.asarray(vox.voxels)[vm]),
        torch.from_numpy(np.asarray(vox.num_points)[vm]), None)
    assert got.shape == (vm.sum(), 5)
    assert_close_to_max(got.numpy(), np.asarray(want)[vm], 1e-6)


# ------------------------------------------------------------------- coder
def _maps(rng, b=2, nc=2, ties=True):
    heat = rng.uniform(size=(b,) + HW + (nc,))
    if ties:                          # bf16-like: many equal scores
        heat = np.round(heat, 2)
    maps = dict(heat=heat.astype(np.float32))
    for k, c in (("reg", 2), ("hei", 1), ("dim", 3), ("rot", 2),
                 ("vel", 2)):
        maps[k] = rng.normal(size=(b,) + HW + (c,)).astype(np.float32)
    return maps


def test_coder_decode_matches_with_ties():
    rng = np.random.default_rng(1)
    m = _maps(rng)
    kw = dict(pc_range=[-8, -8, -5, 8, 8, 3], out_size_factor=8,
              voxel_size=[0.125, 0.125],
              post_center_range=[-7.0, -7.0, -10.0, 7.0, 7.0, 10.0],
              max_num=128, score_threshold=0.1, code_size=9)

    def args(t, s=slice(None)):
        return (t(m["heat"][s]), t(m["rot"][s][..., 0:1]),
                t(m["rot"][s][..., 1:2]), t(m["hei"][s]),
                t(np.exp(m["dim"][s])), t(m["vel"][s]), t(m["reg"][s]))

    got = CenterPointBBoxCoder(**kw).decode(*args(torch.from_numpy))
    jc = JaxCoder(**kw)
    for s in range(2):
        want = jc.decode(*args(jnp.asarray, s))
        for k in ("labels", "mask", "scores"):
            np.testing.assert_array_equal(got[k][s].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        assert_close_to_max(got["bboxes"][s].numpy(),
                            np.asarray(want["bboxes"]), 1e-6)
        topv = np.sort(m["heat"][s].ravel())[::-1][:128]
        # the cut at 128 falls inside a run of equal scores, and the mask
        # drops some boxes: ties and the range both decide
        assert topv[-1] == np.sort(m["heat"][s].ravel())[::-1][128]
        assert 0 < np.asarray(want["mask"]).sum() < 128


# --------------------------------------------------- circle NMS (K10-circle)
def _circle_case(kind, rng):
    """(centres (K, 2), scores (K,), valid (K,), thresh)."""
    if kind == "random":
        c = rng.uniform(-10, 10, (300, 2))
        s = rng.uniform(size=300)
        return c, s, rng.uniform(size=300) > 0.2, 1.0
    if kind == "on_threshold":
        # a 2 m grid against thresh 4: every neighbour pair exactly on the
        # threshold (exact squares), tied scores, and (3, 4) offsets
        # against 25
        g = np.stack(np.meshgrid(np.arange(8.0), np.arange(8.0)),
                     -1).reshape(-1, 2) * 2.0
        c = np.concatenate([g, g[:16] + [3.0, 4.0]])
        s = np.round(rng.uniform(size=len(c)), 1)
        return c, s, np.ones(len(c), bool), 4.0
    c = rng.uniform(-3, 3, (64, 2))
    return c, rng.uniform(size=64), np.zeros(64, bool), 4.0


@pytest.mark.parametrize("kind", ["random", "on_threshold", "all_invalid"])
def test_circle_nms_ref_matches_jax(kind):
    rng = np.random.default_rng(2)
    c, s, v, thr = _circle_case(kind, rng)
    c, s = c.astype(np.float32), s.astype(np.float32)
    want = np.asarray(jbox.circle_nms_mask(jnp.asarray(c), jnp.asarray(s),
                                           thr, jnp.asarray(v)))
    got = box_ops.circle_nms_mask_ref(torch.from_numpy(c)[None],
                                      torch.from_numpy(s)[None], thr,
                                      torch.from_numpy(v)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "all_invalid":
        assert not want.any()
    else:
        assert 0 < want.sum() < v.sum()
    if kind == "on_threshold":
        d2 = ((c[:, None] - c[None]) ** 2).sum(-1)
        assert (d2 == thr).sum() > 100


def test_circle_nms_mask_batches_sets_with_their_thresholds():
    rng = np.random.default_rng(3)
    c = torch.from_numpy(rng.uniform(-6, 6, (4, 90, 2)).astype(np.float32))
    s = torch.from_numpy(np.round(rng.uniform(size=(4, 90)), 1).astype(
        np.float32))
    v = torch.from_numpy(rng.uniform(size=(4, 90)) > 0.1)
    thr = [4.0, 12.0, 0.175, 1.0]
    got = box_ops.circle_nms_mask(c, s, thr, v)
    for r in range(4):
        one = box_ops.circle_nms_mask_ref(c[r:r + 1], s[r:r + 1], thr[r],
                                          v[r:r + 1])
        assert torch.equal(got[r], one[0])
    assert len({int(k) for k in got.sum(1)}) == 4
    with pytest.raises(ValueError):
        box_ops.circle_nms_mask(c, s, thr[:3], v)
    with pytest.raises(ValueError):
        box_ops.circle_nms_mask(c[0], s, thr, v)
    assert box_ops.circle_nms_ops(6, 500) == 6 * 6 * 500 * 499 // 2


# ------------------------------------------------ gaussian heatmap (K11)
def test_gaussian_heatmap_batch_matches_jax():
    rng = np.random.default_rng(4)
    b, n, (h, w), nc = 3, 20, (24, 20), 4
    cxy = rng.uniform(-2, 22, (b, n, 2)).astype(np.float32)
    # on the border (some centres just outside the grid) and the least
    # radius
    cxy[:, :4] = [[0.0, 0.0], [19.5, 23.9], [-0.5, 10.0], [10.0, 23.99]]
    rad = np.floor(rng.uniform(2, 5, (b, n))).astype(np.float32)
    rad[:, 4:7] = 1e-6
    labels = rng.integers(0, nc, (b, n))
    valid = rng.uniform(size=(b, n)) > 0.2
    valid[:, :7] = True
    got = gaussian.draw_heatmap_gaussian_batch(
        (h, w), torch.from_numpy(cxy), torch.from_numpy(rad),
        torch.from_numpy(valid), torch.from_numpy(labels), nc).numpy()
    want = np.stack([np.stack([np.asarray(jgauss.draw_heatmap_gaussian_batch(
        (h, w), jnp.asarray(cxy[s]), jnp.asarray(rad[s]),
        jnp.asarray(valid[s] & (labels[s] == c)))) for c in range(nc)], -1)
        for s in range(b)])
    assert got.shape == (b, h, w, nc)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got == 1.0, want == 1.0)
    assert (want == 1.0).sum() >= 3 * 12
    # a radius of 1e-6 paints its centre cell alone
    s, i = 0, 4
    x, y = (int(v) for v in np.floor(cxy[s, i]))
    if 0 <= x < w and 0 <= y < h:
        assert got[s, y, x, labels[s, i]] == 1.0


def _heatmap_case():
    """test_gaussian_heatmap_batch_matches_jax's inputs."""
    rng = np.random.default_rng(4)
    b, n, nc = 3, 20, 4
    cxy = rng.uniform(-2, 22, (b, n, 2)).astype(np.float32)
    cxy[:, :4] = [[0.0, 0.0], [19.5, 23.9], [-0.5, 10.0], [10.0, 23.99]]
    rad = np.floor(rng.uniform(2, 5, (b, n))).astype(np.float32)
    rad[:, 4:7] = 1e-6
    labels = rng.integers(0, nc, (b, n))
    valid = rng.uniform(size=(b, n)) > 0.2
    valid[:, :7] = True
    return cxy, rad, labels, valid, nc


def test_gaussian_heatmap_batch_repeats_under_the_suite_state():
    """Each side of test_gaussian_heatmap_batch_matches_jax computed again
    under each global state the suite sets (PyTorch's deterministic
    algorithms on, one intra-op thread; the JAX side eager twice and
    jitted once): the port's heatmaps equal bit for bit, the JAX eager
    ones too, and every one within 1e-6 of a float64 numpy oracle of the
    same expression, so a drift names its side."""
    cxy, rad, labels, valid, nc = _heatmap_case()
    (h, w), b = (24, 20), cxy.shape[0]
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    oracle = np.zeros((b, h, w, nc))
    for s in range(b):
        for i in np.nonzero(valid[s])[0]:
            cx, cy = np.floor(cxy[s, i].astype(np.float64))
            r = float(rad[s, i])
            sigma = (2 * r + 1) / 6
            g = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) /
                       (2 * sigma * sigma))
            g = np.where((np.abs(xs - cx) <= r) & (np.abs(ys - cy) <= r), g,
                         0.0)
            c = labels[s, i]
            oracle[s, ..., c] = np.maximum(oracle[s, ..., c], g)

    def port():
        return gaussian.draw_heatmap_gaussian_batch(
            (h, w), torch.from_numpy(cxy), torch.from_numpy(rad),
            torch.from_numpy(valid), torch.from_numpy(labels), nc).numpy()

    def jax_side(fn):
        return np.stack([np.stack([np.asarray(fn(
            (h, w), jnp.asarray(cxy[s]), jnp.asarray(rad[s]),
            jnp.asarray(valid[s] & (labels[s] == c)))) for c in range(nc)],
            -1) for s in range(b)])

    threads = torch.get_num_threads()
    ports = [port()]
    torch.use_deterministic_algorithms(True)
    try:
        ports.append(port())
        torch.set_num_threads(1)
        ports.append(port())
    finally:
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(False)
    ports.append(port())
    jitted = jax.jit(jgauss.draw_heatmap_gaussian_batch, static_argnums=0)
    jaxes = [jax_side(jgauss.draw_heatmap_gaussian_batch),
             jax_side(jgauss.draw_heatmap_gaussian_batch), jax_side(jitted)]
    for p in ports[1:]:
        np.testing.assert_array_equal(p, ports[0])
    np.testing.assert_array_equal(jaxes[1], jaxes[0])
    for name, got in [("port", ports[0]), ("jax eager", jaxes[0]),
                      ("jax jitted", jaxes[2])]:
        np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-6,
                                   err_msg=name)


# ------------------------------------------------------------------- head
def _heads(**test_cfg):
    cfg = tflagship.centerpoint_model_cfg(tiny=True)
    head = dict(cfg["pts_bbox_head"], train_cfg=dict(cfg["train_cfg"]["pts"]),
                test_cfg=dict(cfg["test_cfg"]["pts"], **test_cfg))
    jkw = {k: v for k, v in head.items() if k not in ("type",
                                                      "compute_dtype")}
    return JaxHead(**jkw), CenterHead(**{k: v for k, v in head.items()
                                         if k != "type"})


def _gts(seed=5, b=2, g=24):
    """GT boxes over +-9 m (some off the grid), every class, a zero-size
    box, a label past the classes and padded rows."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, g, 9), np.float32)
    boxes[..., :2] = rng.uniform(-9, 9, (b, g, 2))
    boxes[..., 2] = rng.uniform(-2, 0, (b, g))
    boxes[..., 3:6] = rng.uniform(0.3, 6.0, (b, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    boxes[..., 7:9] = rng.normal(0, 2, (b, g, 2))
    boxes[0, 3, 3] = 0.0
    labels = rng.integers(0, 10, (b, g))
    labels[1, 2] = 11
    mask = np.arange(g)[None] < np.array([[g - 3], [g - 1]])
    return boxes, labels, mask


def _preds(seed=6, b=2):
    """Random CenterHead outputs (one level, six tasks), float32 NHWC."""
    rng = np.random.default_rng(seed)
    cfg = tflagship.centerpoint_model_cfg(tiny=True)["pts_bbox_head"]
    out = []
    for task in cfg["tasks"]:
        d = {k: rng.normal(size=(b,) + HW + (c,)).astype(np.float32)
             for k, (c, _) in cfg["common_heads"].items()}
        d["heatmap"] = (rng.normal(size=(b,) + HW + (task["num_class"],)) -
                        1.5).astype(np.float32)
        d["dim"] *= 0.3
        out.append(d)
    return [out]


def _to(preds, t):
    return [[{k: t(v) for k, v in d.items()} for d in lvl] for lvl in preds]


def test_targets_match():
    jhead, head = _heads()
    gts = _gts()
    want = jhead.apply({}, *[jnp.asarray(a) for a in gts], HW,
                       method=lambda m, *a: m.get_targets(*a))
    heat, anno, ind, valid = head.get_targets(
        *[torch.from_numpy(a) for a in gts], HW)
    offs = head.task_offsets
    labels = torch.from_numpy(gts[1])
    for t, (wh, wa, wi, wm) in enumerate(want):
        h = heat[..., offs[t]:offs[t + 1]].numpy()
        np.testing.assert_allclose(h, np.asarray(wh), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(h == 1.0, np.asarray(wh) == 1.0)
        m = valid & (labels >= offs[t]) & (labels < offs[t + 1])
        np.testing.assert_array_equal(m.numpy(), np.asarray(wm))
        assert_close_to_max(anno.numpy(), np.asarray(wa), 1e-6)
        np.testing.assert_array_equal(ind.numpy(), np.asarray(wi))
    assert (heat == 1.0).sum() >= 20 and not valid[0, 3] and \
        not (valid & (labels >= 10)).any()


def test_loss_matches():
    jhead, head = _heads()
    preds, gts = _preds(), _gts()
    want = jhead.apply({}, _to(preds, jnp.asarray),
                       *[jnp.asarray(a) for a in gts],
                       method=lambda m, *a: m.loss(*a))
    got = head.loss(_to(preds, torch.from_numpy),
                    *[torch.from_numpy(a) for a in gts])
    assert set(got) == set(want) == {f"task{t}.loss_{k}" for t in range(6)
                                     for k in ("heatmap", "bbox")}
    for k in want:
        assert float(want[k]) > 0, k
        assert _rel(got[k], want[k]) <= 1e-4, k


def _assert_boxes_match(got, want, least=10):
    m = np.asarray(want["mask"])
    np.testing.assert_array_equal(got["mask"].numpy(), m)
    assert m.sum() >= least
    np.testing.assert_array_equal(got["labels"].numpy()[m],
                                  np.asarray(want["labels"])[m])
    assert_close_to_max(got["scores"].numpy()[m],
                        np.asarray(want["scores"])[m], 1e-4)
    assert_close_to_max(got["bboxes"].numpy()[m],
                        np.asarray(want["bboxes"])[m], 1e-4)


@pytest.mark.parametrize("nms_type", ["circle", "rotate"])
def test_get_bboxes_matches(nms_type):
    jhead, head = _heads(nms_type=nms_type)
    preds = _preds(seed=7)
    want = jhead.apply({}, _to(preds, jnp.asarray),
                       method=lambda m, p: m.get_bboxes(p))
    got = head.get_bboxes(_to(preds, torch.from_numpy))
    assert got["bboxes"].shape == (2, 6 * 83, 9)
    _assert_boxes_match(got, want, least=100)


# ---------------------------------------------------- the whole detector
@pytest.fixture(scope="module")
def detector(tiny):
    cfg, batch = tiny
    jmodel = jbuild_detector(_jax_cfg(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(jmodel, jbatch, train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    feats = jax.jit(lambda v, b: jmodel.apply(v, b, train=False,
                                              mode="feats"))(variables,
                                                             jbatch)
    return cfg, batch, jmodel, variables, port.eval(), feats


@pytest.fixture(scope="module")
def port_feats(detector):
    _, batch, _, _, port, _ = detector
    return port(batch, mode="feats", device="cpu")


@pytest.mark.parametrize("key", BRANCHES)
def test_detector_head_outputs_match(detector, port_feats, key):
    feats, got = detector[-1], port_feats
    for t in range(6):
        assert_close_to_max(got[0][t][key].numpy(),
                            np.asarray(feats[0][t][key]), 1e-3)


def test_detector_predict_matches(detector):
    _, batch, jmodel, variables, port, feats = detector
    want = jmodel.apply(variables, feats,
                        method=lambda m, p: m.pts_bbox_head_m.get_bboxes(p))
    stats = {}
    got = port(batch, device="cpu", stats=stats)
    _assert_boxes_match(got, want, least=100)
    assert stats["cap"] == 2048 and max(stats["voxels"]) < 2048
    assert len(stats["active_sites"]) == 5


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


def test_detector_loss_terms_match(detector_grads):
    (jl, _, _), (_, tl) = detector_grads
    assert set(tl) == set(jl) and len(jl) == 12
    for k in jl:
        assert _rel(tl[k], jl[k]) <= 1e-4, k


@pytest.mark.parametrize("top", MODULES)
def test_detector_gradients_match(detector_grads, top):
    (_, _, jg), (port, _) = detector_grads
    got, want = [], []
    for name, p in port.named_parameters():
        if name.split(".")[0] == top:
            want.append(jg[name].numpy().ravel())
            got.append(p.grad.numpy().ravel())
    want = np.concatenate(want)
    assert np.abs(want).max() > 0
    assert_close_to_max(np.concatenate(got), want, 1e-3)


def test_train_step_matches_jax(detector, detector_grads):
    """One step of the config's recipe (AdamW, cyclic lr and momentum,
    clip 35): the port's ``make_train_step`` against optax's update of
    the JAX package's ``build_optimizer`` on the JAX gradients."""
    _, batch, _, variables, port0, _ = detector
    (jl, jgrads, jg), _ = detector_grads
    cfg = tflagship.centerpoint_optim_cfg()
    opt_cfg, opt_conf = cfg["optimizer"], cfg["optimizer_config"]
    lr_cfg, mom_cfg = cfg["lr_config"], cfg["momentum_config"]
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = joptim.build_optimizer(params, opt_cfg, opt_conf, lr_cfg, mom_cfg,
                                total_steps=100)
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(params), params)
    jafter = state_dict_from_jax({"params": jax.device_get(
        optax.apply_updates(params, updates))})

    port = copy.deepcopy(port0).train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    opt = toptim.build_optimizer(port, opt_cfg)
    step = make_train_step(port, opt, toptim.build_schedule(
        opt, lr_cfg, mom_cfg, 100), toptim.grad_clip_norm(opt_conf))
    tm = step(batch, torch.Generator().manual_seed(0))
    assert _rel(tm["loss"], sum(jl.values())) <= 1e-4
    grad_norm = math.sqrt(sum(float((g.numpy().astype(np.float64) ** 2)
                                    .sum()) for g in jg.values()))
    assert _rel(tm["grad_norm"], grad_norm) <= 1e-4
    lr = opt_cfg["lr"]
    clip = min(1.0, opt_conf["grad_clip"]["max_norm"] / grad_norm)
    checked = 0
    for name, p in port.named_parameters():
        g = jg[name].numpy()
        sel = (np.abs(g) > 1e-4 * np.abs(g).max()) & \
            (np.abs(g) * clip > 100 * 1e-8)
        d_port = (p.detach() - before[name]).numpy()[sel]
        d_jax = (jafter[name] - before[name]).numpy()[sel]
        tol = 1e-2 * lr + 2 * np.spacing(np.abs(before[name].numpy()[sel]))
        assert (np.abs(d_port - d_jax) <= tol).all(), name
        checked += int(sel.sum())
    assert checked > 5000


# ------------------------------------------------------------- converter
@pytest.mark.parametrize("converter", ["detector", "lidar"])
def test_round_trip_through_the_jax_converter(detector, converter):
    """A reference-layout state_dict through the JAX package's converter
    and back through ``state_dict_from_jax``: every tensor comes back (the
    SECONDFPN deconv flipped, the JAX converter's known mirror; ROADMAP
    queue 3). ``convert_detector_torch_to_flax`` routes a neck with a
    ConvModule to the IS-Fusion resolver and carries everything;
    ``convert_lidar_torch_to_flax`` carries the voxel and sparse
    encoders, SECOND and CenterHead, but numbers a SECONDFPN's deconvs
    from 0, so it reads this config's deconv from the 1x1 conv's keys
    (ROADMAP queue 1 item 4)."""
    cfg, _, _, variables, port, _ = detector
    rng = np.random.default_rng(8)
    ref = {k: np.zeros(v.shape, np.int64) if k.endswith(
        "num_batches_tracked") else rng.normal(size=tuple(v.shape)).astype(
            np.float32) for k, v in port.state_dict().items()}
    convert = convert_detector_torch_to_flax if converter == "detector" \
        else convert_lidar_torch_to_flax
    jax_vars, missing = convert(ref, variables)
    assert missing == []
    if converter == "lidar":
        deconv = jax_vars["params"]["pts_neck_m"]["ConvTransposeModule_0"]
        assert deconv["ConvTranspose_0"]["kernel"].shape == \
            ref["pts_neck.deblocks.0.0.weight"].T.shape
        ref = {k: v for k, v in ref.items()
               if not k.startswith("pts_neck.")}
        jax_vars = {c: {m: t for m, t in jax_vars[c].items()
                        if m != "pts_neck_m"} for c in jax_vars}
    back = state_dict_from_jax(jax_vars)
    assert set(back) == set(ref)
    for k, want in ref.items():
        if k.startswith("pts_neck.deblocks.") and want.ndim == 4 and \
                want.shape[-1] > 1:                  # stride > 1: deconv
            want = want[:, :, ::-1, ::-1]
        np.testing.assert_array_equal(back[k].numpy(), want, err_msg=k)
    assert any(".heatmap.1.bias" in k for k in ref)


# ----------------------------------------------------------- entry points
def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tflagship.build_centerpoint(tiny=True)
    assert os.path.isfile(tflagship.CENTERPOINT_CFG)


def test_dynamic_centerpoint_raises():
    """DynamicCenterPoint is ported (``tests/test_torch_lidar_variants_
    center.py``); on this config's hard voxel layer it raises."""
    cfg = dict(tflagship.centerpoint_model_cfg(tiny=True),
               type="DynamicCenterPoint")
    with pytest.raises(ValueError, match="dynamically"):
        build_detector(cfg)
