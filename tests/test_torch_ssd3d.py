"""The port's 3DSSD (``SSD3DNet``, ``SSD3DHead``, ``AnchorFreeBBoxCoder``)
against the JAX package's on carried weights: the coder's encode and
decode (with and without rotation, yaws on the bins' edges), the head
alone (train and eval mode outputs), the JAX test's tiny detector
(``tests/test_models/test_indoor_variants.py``) in head outputs, predict,
loss terms, every module's gradients and one AdamW + clip step of the
3DSSD recipe, the tiny detector without FP levels (3DSSD's layout), the
full-width config's tree and the KITTI Car batch.

The JAX variables are drawn with numpy (``tests/torch_parity.py``) and
carried with ``state_dict_from_jax``; the JAX detector is compiled at
XLA:CPU level 1, its gradients and step in float64
(``torch_parity.indoor_variant_case``). The port's ops run their plain
versions (the CPU).

Tolerances (float32, CPU): outputs 1e-4 of their max (the modules alone
1e-5), gradients 1e-3 of their max, losses 1e-4 relative (1e-7
absolute), sampled indices, masks and labels equal, updates within 1e-2
of the lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.core.bbox.coders import AnchorFreeBBoxCoder as JCoder
from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.models import layers as jlayers
from isfusion_tpu.models.dense_heads import ssd_3d_head as jssd
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.core.bbox.coders import AnchorFreeBBoxCoder
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.dense_heads.ssd_3d_head import SSD3DHead
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from test_models.test_indoor_variants import backbone_cfg, tiny_batch
from torch_parity import (OPTIMIZED_XLA, assert_close_to_max,
                          check_indoor_gradients, check_indoor_losses,
                          check_indoor_outputs, check_indoor_predict,
                          check_indoor_step, indoor_variant_case, jax_cfg,
                          load_from_jax, random_variables)

SSD3D_LOSSES = {"objectness_loss", "center_loss", "size_loss",
                "dir_class_loss", "dir_res_loss", "semantic_loss"}
SSD3D_TOPS = ("backbone.SA_modules", "backbone.FP_modules",
              "bbox_head.vote_module", "bbox_head.vote_aggregation",
              "bbox_head.conv_pred")


@pytest.mark.parametrize("with_rot", [True, False])
def test_anchor_free_coder_matches(with_rot):
    """Encode (centre, half extents, bin, normalised residual) equal, and
    decode (twice the size clamped at 0.1, the bin's yaw) within 1e-7 of
    the max, on yaws across the circle and on the 12 bins' edges."""
    rng = np.random.default_rng(3)
    jc, tc = JCoder(12, with_rot), AnchorFreeBBoxCoder(12, with_rot)
    edges = (np.arange(-12, 13) * np.pi / 12).astype(np.float32)
    yaw = np.concatenate([rng.uniform(-7, 7, (2, 15)),
                          np.broadcast_to(edges, (2, 25))], -1).astype(
                              np.float32)
    ctr = rng.normal(size=(2, 40, 3)).astype(np.float32)
    dims = rng.uniform(0.1, 4.0, (2, 40, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 40))
    want = jc.encode(*map(jnp.asarray, (ctr, dims, yaw, labels)))
    got = tc.encode(*map(torch.from_numpy, (ctr, dims, yaw, labels)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    logits, res = (rng.normal(size=(2, 40, 12)).astype(np.float32)
                   for _ in range(2))
    size = rng.uniform(-0.5, 2.0, (2, 40, 3)).astype(np.float32)
    args = (ctr, logits, res, size)
    assert_close_to_max(tc.decode(*map(torch.from_numpy, args)).numpy(),
                        np.asarray(jc.decode(*map(jnp.asarray, args))), 1e-7)


HEAD = dict(num_classes=3,
            bbox_coder=dict(type="PartialBinBasedBBoxCoder", num_dir_bins=6,
                            num_sizes=3, with_rot=True,
                            mean_sizes=[[1, 1, 1]] * 3),
            candidate_shift_channels=(16,), feat_channels=(32,),
            vote_aggregation_cfg=dict(num_point=16, radius=2.0, num_sample=8,
                                      mlp_channels=[16, 16, 32]))


@pytest.mark.parametrize("train", [False, True])
def test_ssd3d_head_matches(train):
    """The head alone on 48 seeds of 16 channels (10% masked): candidates,
    the aggregation's mask, centres, sizes, direction and class logits
    within 1e-5 of their max (train mode: batch statistics)."""
    rng = np.random.default_rng(4)
    fd = dict(fp_xyz=[rng.uniform(-2, 2, (2, 48, 3)).astype(np.float32)],
              fp_features=[rng.normal(size=(2, 48, 16)).astype(np.float32)],
              fp_masks=[rng.uniform(size=(2, 48)) > 0.1])
    jhead = jssd.SSD3DHead(**HEAD)
    jfd = jax.tree_util.tree_map(jnp.asarray, fd)
    variables = random_variables(jhead, jfd, seed=5)
    want = jax.jit(lambda v, f: jhead.apply(
        v, f, train=train, mutable=["batch_stats"])[0]).lower(
            variables, jfd).compile(OPTIMIZED_XLA)(variables, jfd)
    port = load_from_jax(SSD3DHead(in_channels=16, **HEAD), variables,
                         "bbox_head_m", "bbox_head").train(train)
    got = port(jax.tree_util.tree_map(torch.from_numpy, fd))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].detach()
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert_close_to_max(g.numpy(), np.asarray(w), 1e-5)


@pytest.fixture(scope="module")
def case():
    batch = {k: np.asarray(v) for k, v in tiny_batch().items()}
    return indoor_variant_case(tflagship.ssd3dnet_model_cfg(tiny=True),
                               batch, tflagship.ssd3dnet_optim_cfg(),
                               widen=(jlayers, jssd))


def test_tiny_config_is_the_jax_test_model():
    """The port's tiny 3DSSD is the JAX test's model, ``in_channels`` set
    to its points' width (which the JAX package ignores)."""
    want = dict(type="SSD3DNet", backbone=dict(backbone_cfg(),
                                               in_channels=4),
                bbox_head=dict(HEAD, type="SSD3DHead"),
                test_cfg=dict(max_output_num=8))
    assert jax_cfg(tflagship.ssd3dnet_model_cfg(tiny=True)) == want


def test_head_outputs_match(case):
    check_indoor_outputs(case)


def test_predict_matches(case):
    assert case["got_pred"]["bboxes"].shape == (2, 8, 7)
    check_indoor_predict(case)


def test_loss_terms_match(case):
    check_indoor_losses(case, SSD3D_LOSSES)


def test_module_gradients_match(case):
    check_indoor_gradients(case, SSD3D_TOPS)


def test_train_step_matches_jax(case):
    check_indoor_step(case, 0.002, 35.0)


def test_backbone_without_fp_levels_matches_jax():
    """3DSSD's layout: the tiny detector with ``fp_channels=()`` (the seeds
    are the last SA level's points) runs on both sides with equal
    sampling and head outputs within 1e-4 of their max."""
    cfg = tflagship.ssd3dnet_model_cfg(tiny=True)
    cfg["backbone"]["fp_channels"] = ()
    batch = {k: np.asarray(v) for k, v in tiny_batch(seed=2).items()}
    jmodel = jbuild_detector(jax_cfg(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(jmodel, jbatch, train=False, mode="feats")
    want = jax.jit(lambda v: jmodel.apply(
        v, jbatch, train=False, mode="feats")).lower(variables).compile(
            OPTIMIZED_XLA)(variables)
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    got = port.eval()(batch, mode="feats", device="cpu")
    assert got["seed_xyz"].shape == (2, 64, 3)
    check_indoor_outputs(dict(got_feats=got, feats=want))


def test_full_width_config_carries_the_jax_tree():
    """The full-width 3DSSD (``3dssd_4x4_kitti-3d-car.py``) takes every
    variable of the JAX package's detector built from the same config,
    strictly (the JAX tree from ``jax.eval_shape``, no init), with the
    input widths the port computes and JAX infers."""
    cfg = tflagship.ssd3dnet_model_cfg()
    jmodel = jbuild_detector(jax_cfg(cfg))
    batch = {k: jnp.asarray(v) for k, v in
             tflagship.synthetic_kitti_car_batch(1, seed=0).items()}
    variables = random_variables(jmodel, batch, train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    widths = [port.backbone.SA_modules[i].mlps[0].layer0.conv.in_channels
              for i in range(3)]
    assert widths == [4, 67, 131] and not port.backbone.FP_modules
    head = port.bbox_head
    assert getattr(head.vote_module.vote_conv, "0").conv.in_channels == 256
    assert head.vote_aggregation.mlps[0].layer0.conv.in_channels == 259
    assert head.conv_pred.conv_out.out_channels == 3 + 3 + 2 * 12 + 1 + 1


def test_synthetic_kitti_car_batch_contract():
    """3DSSD's batch: 16,384 points of (x, y, z, reflectance) inside the
    config's range, every point valid; only car-sized GT rows (label 0),
    first in the padded rows; the same seed gives the same bytes."""
    b = tflagship.synthetic_kitti_car_batch(2, seed=4)
    pts = b["points"]
    assert pts.shape == (2, 16384, 4) and pts.dtype == np.float32
    lo, hi = np.array(tflagship.SSD3D_CLOUD_RANGE[:3]), \
        np.array(tflagship.SSD3D_CLOUD_RANGE[3:])
    assert ((pts[..., :3] > lo - 0.1) & (pts[..., :3] < hi + 0.1)).all()
    assert b["points_mask"].all()
    car = np.array(tflagship.KITTI_CLASS_SIZES[2])
    for s in range(2):
        g = int(b["gt_mask"][s].sum())
        assert g >= 1 and not b["gt_mask"][s, g:].any()
        size = b["gt_bboxes_3d"][s, :g, 3:6]
        assert (size >= 0.8 * car - 1e-5).all() and \
            (size <= 1.2 * car + 1e-5).all()
    assert not b["gt_labels_3d"].any()
    again = tflagship.synthetic_kitti_car_batch(2, seed=4)
    for k in b:
        np.testing.assert_array_equal(b[k], again[k])
