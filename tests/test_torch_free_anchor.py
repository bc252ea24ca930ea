"""The port's FreeAnchor3DHead against the JAX package: the bag-matching
loss and its gradient with respect to the head's outputs; the tiny
PointPillars with FreeAnchor3DHead (``pre_anchor_topk`` 8, as
``tests/test_models/test_free_anchor.py``) in head outputs, predict (the
inherited Anchor3DHead decode), loss terms, gradients and one AdamW step
(the direction conv, which no JAX loss term reads, moves by weight decay
alone on both sides); the tiny FreeAnchor of ``flagship.
free_anchor_model_cfg(tiny=True)`` (RegNet + FPN, three levels) in head
outputs, predict, loss terms and the head's gradient.

On numpy-drawn variables (BN scales and biases away from 1 and 0) the
RegNet + FPN tiny model's deeper float32 gradients are ill-conditioned:
the JAX package's own eager and compiled runs put them up to ~2e-2 of
their max apart. So every module's gradient of that model (the grouped
convs and train-mode BN of RegNet included) is compared in float64 on
both sides (``jax.enable_x64``, the port in ``.double()``; the JAX
step compiled at XLA:CPU level 1, as ``anchor_family_case``), with the
tiny model's BN2d and with the full-width config's naiveSyncBN2d (eps
1e-3, momentum 0.01).

Tolerances (float32, CPU): head outputs and gradients 1e-3 of the max;
loss terms 1e-4 relative; kept boxes the same entries and labels, boxes
and scores 1e-4 of their max; updates within 1e-2 of the lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models.dense_heads.free_anchor3d_head import \
    FreeAnchor3DHead as JaxHead
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.models.dense_heads.free_anchor3d_head import \
    FreeAnchor3DHead
from torch_parity import (OPTIMIZED_XLA, anchor_family_case,
                          assert_close_to_max, assert_same_kept_boxes,
                          check_step, float64_port, jax_cfg,
                          random_variables, state_dict_from_jax, tree_leaves)

LOSSES = {"positive_bag_loss", "negative_bag_loss"}


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def _pp_free_anchor_cfg():
    """The tiny PointPillars (``tiny_pointpillars_cfg`` of the JAX tests)
    with FreeAnchor3DHead, ``pre_anchor_topk`` 8."""
    cfg = tflagship.pointpillars_model_cfg(tiny=True)
    cfg["pts_bbox_head"] = dict(cfg["pts_bbox_head"],
                                type="FreeAnchor3DHead", pre_anchor_topk=8)
    cfg["test_cfg"]["pts"].update(nms_pre=64, max_num=32)
    return cfg


def _head_kw():
    kw = jax_cfg(_pp_free_anchor_cfg()["pts_bbox_head"])
    kw.pop("type")
    return kw


def test_bag_loss_and_gradient_match():
    rng = np.random.default_rng(0)
    # the tiny PointPillars head: 7 sizes x 2 rotations, 10 classes
    preds = [((rng.normal(size=(2, 16, 16, 140)) - 3.0).astype(np.float32),
              (rng.normal(size=(2, 16, 16, 126)) * 0.3).astype(np.float32),
              rng.normal(size=(2, 16, 16, 28)).astype(np.float32))]
    head = FreeAnchor3DHead(**_head_kw())
    anchors = head.anchors_for([(16, 16)])
    # GTs on jittered anchors (so that bags hold well-localised anchors),
    # the last row of each sample padded
    gts = np.zeros((2, 6, 9), np.float32)
    labels = rng.integers(0, 10, (2, 6))
    for b in range(2):
        gts[b] = anchors[rng.choice(len(anchors), 6, replace=False)]
        gts[b, :, :2] += rng.normal(0, 0.2, (6, 2))
        gts[b, :, 3:6] *= rng.uniform(0.8, 1.2, (6, 3))
    mask = np.ones((2, 6), bool)
    mask[:, -1] = False
    jhead = JaxHead(**_head_kw())

    def jloss(p):
        out = jhead.loss([p], *[jnp.asarray(g) for g in (gts, labels,
                                                          mask)])
        return sum(out.values()), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        tuple(jnp.asarray(p) for p in preds[0]))
    tp = [torch.from_numpy(p).requires_grad_() for p in preds[0]]
    got = head.loss([tuple(tp)], *[torch.from_numpy(g) for g in (
        gts, labels, mask)])
    assert set(got) == set(want) == LOSSES
    for k in LOSSES:
        assert float(want[k]) > 0 and _rel(got[k], want[k]) <= 1e-4, k
    sum(got.values()).backward()
    for t, g in zip(tp[:2], jgrad[:2]):
        assert np.abs(np.asarray(g)).max() > 0
        assert_close_to_max(t.grad.numpy(), np.asarray(g), 1e-3)
    # no loss term reads the direction logits: a zero gradient, not None
    assert tp[2].grad is not None and not tp[2].grad.any()
    assert not np.asarray(jgrad[2]).any()


def _check_outputs(case, n_levels):
    got = dict(tree_leaves(case["got_feats"]))
    want = {k: np.asarray(v) for k, v in tree_leaves(case["feats"])}
    assert set(got) == set(want) and len(want) == 3 * n_levels
    for k, w in want.items():
        assert_close_to_max(got[k].numpy(), w, 1e-3)
    assert np.asarray(case["decoded"]["mask"]).sum() >= 8
    assert_same_kept_boxes({k: v.numpy() for k, v in case[
        "got_pred"].items()}, {k: np.asarray(v) for k, v in case[
            "decoded"].items()})
    assert set(case["tl"]) == set(case["jl"]) == LOSSES
    for k in LOSSES:
        assert _rel(case["tl"][k], case["jl"][k]) <= 1e-4, k


def _grad_err(case, top):
    port, jg = case["trained"], case["jg"]
    got = np.concatenate([p.grad.numpy().ravel() for n, p in
                          port.named_parameters() if n.startswith(top)])
    want = np.concatenate([jg[n].numpy().ravel() for n, _ in
                           port.named_parameters() if n.startswith(top)])
    assert np.abs(want).max() > 0, top
    assert_close_to_max(got, want, 1e-3)


@pytest.fixture(scope="module")
def pp_case():
    _, batch_fn = tflagship.build_pointpillars_flagship(tiny=True,
                                                        device="cpu")
    return anchor_family_case(_pp_free_anchor_cfg(), batch_fn(2),
                              tflagship.free_anchor_optim_cfg())


def test_pointpillars_free_anchor_outputs_match(pp_case):
    _check_outputs(pp_case, 1)


@pytest.mark.parametrize("top", ["pts_voxel_encoder", "pts_backbone",
                                 "pts_neck", "pts_bbox_head"])
def test_pointpillars_free_anchor_gradients_match(pp_case, top):
    _grad_err(pp_case, top)


def test_pointpillars_free_anchor_adamw_step_matches(pp_case):
    cfg = tflagship.free_anchor_optim_cfg()
    lr = cfg["optimizer"]["lr"] * cfg["lr_config"]["warmup_ratio"]
    for k in LOSSES:
        assert _rel(pp_case["tm"][k], pp_case["jl"][k]) <= 1e-4
    assert check_step(pp_case, lr, cfg["optimizer_config"]["grad_clip"][
        "max_norm"]) > 5000
    # the direction conv takes part in the step with a zero gradient
    for case in ("trained", "stepped"):
        grad = pp_case[case].pts_bbox_head.conv_dir_cls.weight.grad
        assert grad is not None and not grad.any()


@pytest.fixture(scope="module")
def regnet_case():
    cfg = tflagship.free_anchor_model_cfg(tiny=True)
    cfg["test_cfg"]["pts"].update(nms_pre=64, max_num=32)
    _, batch_fn = tflagship.build_free_anchor(tiny=True, device="cpu")
    return anchor_family_case(cfg, batch_fn(2),
                              tflagship.free_anchor_optim_cfg())


def test_regnet_free_anchor_matches(regnet_case):
    _check_outputs(regnet_case, 3)
    _grad_err(regnet_case, "pts_bbox_head")


@pytest.mark.parametrize("norm", ["BN2d", "naiveSyncBN2d"])
def test_regnet_free_anchor_float64_gradients_match(norm):
    """The tiny RegNet + FPN FreeAnchor in float64 on both sides: loss
    terms 1e-4 relative, each top-level module's gradient (voxel encoder,
    RegNet, FPN, head) 1e-3 of its max; ``naiveSyncBN2d`` with the
    full-width config's eps 1e-3 and momentum 0.01 (one process: no
    collective)."""
    from isfusion_tpu.models import build_detector as jbuild_detector
    from isfusion_tpu.parallel.train_step import total_loss
    from isfusion_tpu_torch.models.builder import build_detector

    cfg = tflagship.free_anchor_model_cfg(tiny=True)
    bn = dict(type="BN2d") if norm == "BN2d" else dict(
        type="naiveSyncBN2d", eps=1e-3, momentum=0.01)
    for key in ("pts_backbone", "pts_neck"):
        cfg[key]["norm_cfg"] = dict(bn)
    _, batch_fn = tflagship.build_free_anchor(tiny=True, device="cpu")
    batch = batch_fn(2)
    wide = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
            for k, v in batch.items()}
    jmodel = jbuild_detector(jax_cfg(cfg))
    variables = random_variables(jmodel, {k: jnp.asarray(v) for k, v in
                                          batch.items()},
                                 train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64))
            if np.asarray(x).dtype.kind == "f" else jnp.asarray(x),
            jax.device_get(variables))
        jbatch = {k: jnp.asarray(v) for k, v in wide.items()}

        def loss_fn(params, bs):
            losses, _ = jmodel.apply({"params": params, "batch_stats": bs},
                                     jbatch, train=True, mode="loss",
                                     mutable=["batch_stats"])
            return total_loss(losses), losses

        args = (v64["params"], v64["batch_stats"])
        (_, jl), jg = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True)).lower(*args).compile(OPTIMIZED_XLA)(*args)
        assert jax.tree_util.tree_leaves(jg)[0].dtype == jnp.float64
        jl = {k: float(v) for k, v in jl.items()}
        jg = state_dict_from_jax({"params": jax.device_get(jg)})
    port = port.double().train()
    with float64_port():
        tl = port(wide, mode="loss", device="cpu")
        sum(v for k, v in tl.items() if "loss" in k).backward()
    assert set(tl) == set(jl) == LOSSES
    for k in LOSSES:
        assert _rel(tl[k].detach(), jl[k]) <= 1e-4, k
    tops = sorted({n.split(".")[0] for n, _ in port.named_parameters()})
    assert tops == ["pts_backbone", "pts_bbox_head", "pts_neck",
                    "pts_voxel_encoder"]
    for top in tops:
        names = [n for n, _ in port.named_parameters()
                 if n.split(".")[0] == top]
        params = dict(port.named_parameters())
        assert all(params[n].grad.dtype == torch.float64 for n in names)
        got = np.concatenate([params[n].grad.numpy().ravel()
                              for n in names])
        want = np.concatenate([np.asarray(jg[n], np.float64).ravel()
                               for n in names])
        assert np.abs(want).max() > 0, top
        assert_close_to_max(got, want, 1e-3)
