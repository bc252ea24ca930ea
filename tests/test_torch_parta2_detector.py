"""The port's tiny PartA2 (``flagship.parta2_model_cfg(tiny=True)``)
against the JAX package's on carried weights: the head outputs, the
proposals, the seg and part predictions (eval mode), the decoded boxes,
the seven loss terms and every module's gradients (train mode: the
SparseUNet's with the inverse convs among them), one step of the
config's recipe (AdamW, cyclic lr and momentum, clip 10) against optax's,
and the converter's whole PartA2 tree.

The JAX variables are drawn with numpy (``tests/torch_parity.py``), the
RPN's box regression scaled by 0.01 on both sides so that proposals are
anchor-sized, and carried with ``state_dict_from_jax``; ``assigner_per_
size`` is off (the JAX head reads the flag but matches every anchor to
every GT, ROADMAP queue 3). The batch's GT boxes are anchors of their
class moved by a few centimetres (the RPN and the RoI head both see
positives). Voxel centres lie on a grid and the boxes are continuous, so
no centre sits within float32 rounding of a box face (the fixture checks
the margin against the RoIs and the GTs). The JAX side is one jitted call
(feats, decode, losses, gradients, the optimizer step) at XLA:CPU
backend level 1 (``torch_parity.OPTIMIZED_XLA``, as the other sparse
detectors' tests).
The port's train step runs on one CPU thread: on several, its float32
sums take another order and one ReLU input within rounding of 0 changes
sign, which moves some decoder gradients by up to 6e-3 of their max
(``test_many_threads_differ_by_a_tie_only`` holds that this is the only
difference).

Tolerances (float32, CPU): masks, labels and proposal indices exact;
head outputs, boxes and gradients 1e-3 of their max (sums in another
order through the U-Net); losses 1e-4 relative; the step's updates within
1e-2 of the learning rate.
"""
import contextlib
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.parallel.train_step import total_loss
from isfusion_tpu.runner import optim as joptim
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.ops.box_ops import box_local_uvw
from isfusion_tpu_torch.parallel.train_step import make_train_step
from isfusion_tpu_torch.runner import optim as toptim
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from torch_parity import (OPTIMIZED_XLA, assert_close_to_max, jax_cfg,
                          random_variables)

MODULES = ("middle_encoder", "backbone", "neck", "rpn_head", "roi_head",
           "seg_head", "part_head")
LOSSES = {"rpn_loss_cls", "rpn_loss_bbox", "rpn_loss_dir", "loss_roi_cls",
          "loss_roi_reg", "loss_seg", "loss_part"}


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


@contextlib.contextmanager
def one_thread():
    """The port on one CPU thread inside the block (its float32 sums in
    one order; ``test_many_threads_differ_by_a_tie_only``)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _train_loss(port, batch, pins=None):
    """The port's train-mode loss terms and gradients, the discrete
    choices recorded (or, given ``pins``, replayed)."""
    from isfusion_tpu_torch.testing import pinned_choices
    port = copy.deepcopy(port).train()
    with pinned_choices(pins) as rec:
        tl = port(batch, mode="loss", device="cpu",
                  generator=torch.Generator().manual_seed(0))
        sum(tl.values()).backward()
    return port, {k: float(v.detach()) for k, v in tl.items()}, rec


def _anchor_gts(batch, port, seed=5):
    """The batch with each GT row an anchor of its class (a random BEV
    cell and rotation) moved by up to 0.15 m and 0.1 rad, its size scaled
    by U(0.9, 1.1)."""
    rng = np.random.default_rng(seed)
    anchors = port.rpn_head.anchors_for([(8, 8)]).reshape(8, 8, 3, 2, 7)
    labels = batch["gt_labels_3d"]
    b, g = labels.shape
    cells = rng.integers(0, 8, (b, g, 2))
    rots = rng.integers(0, 2, (b, g))
    boxes = anchors[cells[..., 0], cells[..., 1], labels, rots].astype(
        np.float32)
    boxes[..., :2] += rng.uniform(-0.15, 0.15, (b, g, 2))
    boxes[..., 3:6] *= rng.uniform(0.9, 1.1, (b, g, 3))
    boxes[..., 6] += rng.uniform(-0.1, 0.1, (b, g))
    return dict(batch, gt_bboxes_3d=boxes.astype(np.float32))


@pytest.fixture(scope="module")
def case():
    cfg = tflagship.parta2_model_cfg(tiny=True)
    cfg["rpn_head"] = dict(cfg["rpn_head"], assigner_per_size=False)
    _, batch_fn = tflagship.build_parta2(tiny=True, device="cpu")
    port = build_detector(cfg)
    batch = _anchor_gts(batch_fn(2, seed=1), port)
    jmodel = jbuild_detector(jax_cfg(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(jmodel, jbatch, train=False, mode="feats")
    reg = variables["params"]["rpn_head_m"]["conv_reg"]
    reg["kernel"], reg["bias"] = reg["kernel"] * 0.01, reg["bias"] * 0.01
    sd = state_dict_from_jax(variables)
    port.load_state_dict(sd)
    k = cfg["num_proposals"]

    def loss_fn(params, bs, jb):
        losses, _ = jmodel.apply({"params": params, "batch_stats": bs}, jb,
                                 train=True, mode="loss",
                                 mutable=["batch_stats"])
        return total_loss(losses), losses

    ocfg = tflagship.parta2_optim_cfg()
    tx = joptim.build_optimizer(variables["params"], ocfg["optimizer"],
                                ocfg["optimizer_config"], ocfg["lr_config"],
                                ocfg["momentum_config"], total_steps=100)

    def run(v, jb):
        feats = jmodel.apply(v, jb, train=False, mode="feats")
        det = jmodel.apply(v, feats["rpn"], method=lambda m, p:
                           m.rpn_head_m.get_bboxes(p))
        out = jmodel.apply(v, feats["roi"], method=lambda m, p:
                           m.roi_head_m.get_bboxes(p))
        _, topi = jax.lax.top_k(det["scores"], k)
        out["labels"] = jnp.take_along_axis(det["labels"], topi, 1)
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"], v["batch_stats"], jb)
        updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
        return feats, out, losses, grads, optax.apply_updates(v["params"],
                                                              updates)

    compiled = jax.jit(run).lower(variables, jbatch).compile(OPTIMIZED_XLA)
    feats, pred, jl, jg, jafter = jax.device_get(compiled(variables, jbatch))
    port.eval()
    stats = {}
    got_feats = port(batch, mode="feats", device="cpu", stats=stats)
    got_pred = port(batch, device="cpu")
    with one_thread():
        trained, tl, choices = _train_loss(port, batch)
    return dict(cfg=cfg, batch=batch, variables=variables, sd=sd, port=port,
                feats=feats, pred=pred, jl={key: float(x) for key, x in
                                            jl.items()},
                jg=state_dict_from_jax({"params": jg}),
                jafter=state_dict_from_jax({"params": jafter}),
                got_feats=got_feats, got_pred=got_pred, stats=stats,
                trained=trained, tl=tl, choices=choices)


def test_no_voxel_centre_on_a_box_face(case):
    """The fixture's premise: every voxel centre is farther than 1e-4 (of
    a box side) from the faces of the RoIs and the GTs, so XLA:CPU's and
    PyTorch's rounding cannot put it on different sides."""
    rois = np.asarray(case["feats"]["roi"]["rois"])
    for b, n in enumerate(case["stats"]["voxels"]):
        centers = _voxel_centers(case, b)
        for boxes in (rois[b], case["batch"]["gt_bboxes_3d"][b]):
            uvw, _ = box_local_uvw(torch.from_numpy(np.asarray(boxes)),
                                   torch.from_numpy(centers))
            uvw = uvw.numpy()
            assert np.minimum(np.abs(uvw), np.abs(uvw - 1)).min() > 1e-5
        assert len(centers) == n


def _voxel_centers(case, b):
    from isfusion_tpu_torch.models.detectors.parta2 import voxel_centers
    from isfusion_tpu_torch.ops.voxel import voxelize_hard
    vl = case["cfg"]["voxel_layer"]
    batch = case["batch"]
    vox = voxelize_hard(torch.from_numpy(batch["points"][b:b + 1]),
                        torch.from_numpy(batch["points_mask"][b:b + 1]),
                        vl["point_cloud_range"], vl["voxel_size"], 5,
                        vl["max_voxels"][1])
    return voxel_centers(vox.coors, vl).numpy()


def test_head_outputs_and_proposals_match(case):
    got, want = case["got_feats"], case["feats"]
    for g, w in zip(got["rpn"], want["rpn"]):
        for a, e in zip(g, w):
            assert_close_to_max(a.numpy(), np.asarray(e), 1e-3)
    np.testing.assert_array_equal(got["roi"]["roi_mask"].numpy(),
                                  np.asarray(want["roi"]["roi_mask"]))
    assert_close_to_max(got["roi"]["rois"].numpy(),
                        np.asarray(want["roi"]["rois"]), 1e-4)
    for k in ("cls_score", "bbox_pred"):
        assert_close_to_max(got["roi"][k].numpy(), np.asarray(
            want["roi"][k]), 1e-3)
    counts = case["stats"]["voxels"]
    for name in ("seg", "part"):
        w = np.concatenate([np.asarray(want[name])[b, :n]
                            for b, n in enumerate(counts)])
        assert_close_to_max(got[name].numpy(), w, 1e-3)
    assert case["stats"]["proposals"] == [64, 64]


def test_predict_matches(case):
    got, want = case["got_pred"], case["pred"]
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    for k in ("bboxes", "scores"):
        assert_close_to_max(got[k].numpy(), np.asarray(want[k]), 1e-3)


def test_loss_terms_match(case):
    jl, tl = case["jl"], case["tl"]
    assert set(tl) == set(jl) == LOSSES
    for k in jl:
        assert jl[k] > 0, k
        assert _rel(tl[k], jl[k]) <= 1e-4, (k, tl[k], jl[k])


def test_many_threads_differ_by_a_tie_only(case):
    """On several threads the port's train forward sums in another order,
    and a ReLU input of the tiny model lies within float32 rounding of 0:
    given the one-thread run's discrete choices (``testing.
    pinned_choices``), a run on the default threads differs from it only
    in ReLU signs that are ties (none farther than 1e-4 of its tensor's
    max from 0), and then its gradients equal the one-thread run's to 1e-4
    of each parameter's max."""
    many, tl, pins = _train_loss(case["port"], case["batch"],
                                 case["choices"])
    assert set(pins["flips"]) <= {"relu"} and not pins["unexplained"]
    for k, v in tl.items():
        assert _rel(v, case["tl"][k]) <= 1e-5, k
    one = dict(case["trained"].named_parameters())
    for name, p in many.named_parameters():
        assert_close_to_max(p.grad.numpy(), one[name].grad.numpy(), 1e-4)


def test_module_gradients_match(case):
    jg, port = case["jg"], case["trained"]
    tops = sorted({n.split(".")[0] for n, _ in port.named_parameters()})
    assert tops == sorted(MODULES)
    for top in MODULES:
        got, want = [], []
        for name, p in port.named_parameters():
            if name.split(".")[0] == top:
                want.append(jg[name].numpy().ravel())
                got.append(p.grad.numpy().ravel())
        want = np.concatenate(want)
        assert np.abs(want).max() > 0, top
        assert_close_to_max(np.concatenate(got), want, 1e-3)


def test_train_step_matches_jax(case):
    """One step of the recipe: the port's ``make_train_step`` against
    optax's update of the JAX ``build_optimizer`` on the JAX gradients, in
    the fixture's jitted call (the cyclic schedules' step 0: lr 0.001,
    beta1 0.95; clip 10)."""
    cfg = tflagship.parta2_optim_cfg()
    jafter = case["jafter"]
    port = copy.deepcopy(case["port"]).train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    opt = toptim.build_optimizer(port, cfg["optimizer"])
    step = make_train_step(port, opt, toptim.build_schedule(
        opt, cfg["lr_config"], cfg["momentum_config"], 100),
        toptim.grad_clip_norm(cfg["optimizer_config"]))
    with one_thread():
        tm = step(case["batch"], torch.Generator().manual_seed(0))
    jg = case["jg"]
    assert _rel(tm["loss"], sum(case["jl"].values())) <= 1e-4
    grad_norm = math.sqrt(sum(float((g.numpy().astype(np.float64) ** 2)
                                    .sum()) for g in jg.values()))
    assert _rel(tm["grad_norm"], grad_norm) <= 1e-4
    assert grad_norm > 10          # the clip acts
    lr = cfg["optimizer"]["lr"]
    clip = min(1.0, 10 / grad_norm)
    checked = 0
    for name, p in port.named_parameters():
        g = jg[name].numpy()
        if not np.abs(g).max() > 0:
            continue
        sel = (np.abs(g) > 1e-4 * np.abs(g).max()) & \
            (np.abs(g) * clip > 100 * 1e-8)
        d_port = (p.detach() - before[name]).numpy()[sel]
        d_jax = (jafter[name] - before[name]).numpy()[sel]
        tol = 1e-2 * lr + 2 * np.spacing(np.abs(before[name].numpy()[sel]))
        assert (np.abs(d_port - d_jax) <= tol).all(), name
        checked += int(sel.sum())
    assert checked > 5000


def test_converter_carries_the_jax_parta2_tree(case):
    """The JAX tiny PartA2's whole tree gives exactly the port's keys and
    shapes: the reference's names for the encoder, SECOND, SECONDFPN and
    the RPN, the JAX module's own for the decoder and the RoI head; an
    inverse conv's kernel in the spconv layout (the forward above holds it
    unflipped)."""
    sd, ref = case["sd"], case["port"].state_dict()
    assert set(sd) == set(ref)
    assert all(tuple(sd[k].shape) == tuple(ref[k].shape) for k in ref)
    unet = case["variables"]["params"]["middle_encoder_m"]
    np.testing.assert_array_equal(
        sd["middle_encoder.decoder_up0.0.weight"].numpy(),
        np.asarray(unet["decoder_up0"]["kernel"]).transpose(4, 0, 1, 2, 3))
    for key in ("middle_encoder.conv_input.0.weight",
                "middle_encoder.encoder_layers.encoder_layer2.0.0.weight",
                "middle_encoder.conv_out.1.running_var",
                "middle_encoder.decoder_same3.1.weight",
                "middle_encoder.decoder_merge2.0.weight",
                "backbone.blocks.1.0.weight", "neck.deblocks.1.0.weight",
                "rpn_head.conv_dir_cls.weight", "roi_head.shared_1.weight",
                "roi_head.conv_reg.bias", "seg_head.weight",
                "part_head.bias"):
        assert key in sd, key

