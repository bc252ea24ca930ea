"""The port's ImVoteNet against the JAX package's on carried weights: the
seed cue alone (projection by ``cam2img``, the [-1, 1] map, bilinear
sampling with zeros outside, the seeds behind the camera or off the image
zeroed) on SUN RGB-D's camera, the JAX test's tiny detector
(``tests/test_models/test_indoor_variants.py``: a ResNet-18 of base width
8, ``img_feat_dim`` 8) in head outputs, predict, loss terms, every
module's gradients (the image branch's among them) and one AdamW + clip
step of the ImVoteNet recipe, the full-width config's tree (ResNet-50, the
vote module 256 + 16 wide) and the SUN RGB-D batch's camera.

The JAX variables are drawn with numpy and carried with
``state_dict_from_jax``; the JAX detector is compiled at XLA:CPU level 1,
its gradients and step in float64 (``torch_parity.indoor_variant_case``);
the GT boxes are moved onto the port's train-mode proposals
(``testing.indoor_positives``) so that VoteHead's box terms have
positives.

Tolerances (float32, CPU): outputs 1e-4 of their max (the cue alone
1e-5), gradients 1e-3 of their max, losses 1e-4 relative (1e-7
absolute), indices, masks and labels equal, updates within 1e-2 of the
lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.models import layers as jlayers
from isfusion_tpu.models.dense_heads import vote_head as jvote_head
from isfusion_tpu.ops.interpolate import grid_sample as jgrid_sample
from isfusion_tpu.ops.projection import project_points_to_cameras as jproject
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.detectors.indoor_variants import ImVoteNet
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from test_models.test_indoor_variants import (backbone_cfg, tiny_batch,
                                              votehead_cfg)
from torch_parity import (assert_close_to_max, check_indoor_gradients,
                          check_indoor_losses, check_indoor_outputs,
                          check_indoor_predict, check_indoor_step,
                          indoor_variant_case, jax_cfg, random_variables)

VOTENET_LOSSES = {"vote_loss", "objectness_loss", "center_loss",
                  "dir_class_loss", "dir_res_loss", "size_class_loss",
                  "size_res_loss", "semantic_loss"}
IMVOTE_TOPS = ("backbone.SA_modules", "backbone.FP_modules",
               "bbox_head.vote_module", "bbox_head.vote_aggregation",
               "bbox_head.conv_pred", "img_backbone", "img_fuse")


def _jax_cues(fmap, xyz, c2i, h, w):
    """The JAX package's seed cue (``ImVoteNet.__call__``'s ``sample``)
    for one sample."""
    uv, _, front = jproject(xyz, c2i[None])
    gx = uv[0, :, 0] / w * 2 - 1
    gy = uv[0, :, 1] / h * 2 - 1
    valid = front[0] & (jnp.abs(gx) < 1) & (jnp.abs(gy) < 1)
    s = jgrid_sample(fmap, jnp.stack([gx, gy], -1))
    return jnp.where(valid[:, None], s, 0.0)


def test_seed_cues_match_jax():
    """Seeds of a room under SUN RGB-D's camera, and seeds behind it and
    past the image's edges: the cue within 1e-5 of the max of the JAX
    package's, zero exactly where JAX's is, and some seeds of each
    kind."""
    rng = np.random.default_rng(5)
    h, w = tflagship.SUNRGBD_IMG_HW
    room = rng.uniform([-4, -4, 0], [4, 4, 3], (2, 200, 3))
    behind = rng.uniform([-2, -9, 0], [2, -5, 3], (2, 20, 3))
    wide = rng.uniform([-30, -4, 0], [30, -3, 3], (2, 20, 3))
    xyz = np.concatenate([room, behind, wide], 1).astype(np.float32)
    fmap = rng.normal(size=(2, 17, 23, 12)).astype(np.float32)
    c2i = np.broadcast_to(tflagship.sunrgbd_cam2img(), (2, 4, 4)).copy()
    want = np.stack([np.asarray(_jax_cues(*map(jnp.asarray, (
        fmap[b], xyz[b], c2i[b])), h, w)) for b in range(2)])
    got = ImVoteNet.seed_cues(*map(torch.from_numpy, (fmap, xyz, c2i)),
                              (h, w)).numpy()
    assert_close_to_max(got, want, 1e-5)
    zero = ~want.any(-1)
    np.testing.assert_array_equal(~got.any(-1), zero)
    assert zero[:, 200:220].all() and 0 < zero.mean() < 0.9


@pytest.fixture(scope="module")
def case():
    batch = {k: np.asarray(v) for k, v in tiny_batch(with_img=True).items()}
    return indoor_variant_case(tflagship.imvotenet_model_cfg(tiny=True),
                               batch, tflagship.imvotenet_optim_cfg(),
                               widen=(jlayers, jvote_head), positives=True)


def test_tiny_config_is_the_jax_test_model():
    """The port's tiny ImVoteNet is the JAX test's model, ``in_channels``
    set to its points' width (which the JAX package ignores)."""
    want = dict(type="ImVoteNet", backbone=dict(backbone_cfg(),
                                                in_channels=4),
                img_backbone=dict(type="ResNet", depth=18, base_channels=8,
                                  out_indices=(1,)),
                img_feat_dim=8,
                bbox_head=dict(votehead_cfg(), vote_module_cfg=dict(
                    in_channels=40, conv_channels=(32,))),
                test_cfg=dict(max_output_num=8))
    assert jax_cfg(tflagship.imvotenet_model_cfg(tiny=True)) == want


def test_head_outputs_match(case):
    check_indoor_outputs(case, index_keys=("seed_indices",))


def test_predict_matches(case):
    assert case["got_pred"]["bboxes"].shape == (2, 8, 7)
    check_indoor_predict(case)


def test_loss_terms_match(case):
    check_indoor_losses(case, VOTENET_LOSSES)
    assert case["jl"]["center_loss"] > 0       # the box terms have positives


def test_module_gradients_match(case):
    check_indoor_gradients(case, IMVOTE_TOPS)


def test_train_step_matches_jax(case):
    check_indoor_step(case, 0.008, 10.0)


def test_full_width_config_carries_the_jax_tree():
    """The full-width ImVoteNet (``imvotenet_stage2_16x8_sunrgbd-3d-
    10class.py``) takes every variable of the JAX package's detector built
    from the same config, strictly (the JAX tree from ``jax.eval_shape``,
    no init): a ResNet-50, ``img_fuse`` 2,048 -> 16, the vote module 272
    wide, 10 classes and 12 bins."""
    cfg = tflagship.imvotenet_model_cfg()
    jmodel = jbuild_detector(jax_cfg(cfg))
    batch = {k: jnp.asarray(v) for k, v in tflagship.synthetic_sunrgbd_batch(
        1, num_points=4096).items()}
    variables = random_variables(jmodel, batch, train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    assert tuple(port.img_fuse.weight.shape) == (16, 2048)
    assert port.bbox_head.vote_module.in_channels == 272
    assert port.bbox_head.conv_pred.conv_reg.out_channels == \
        3 + 2 * 12 + 10 * 4
    assert len(port.img_backbone.layer3) == 6


def test_synthetic_sunrgbd_batch_contract():
    """ImVoteNet's batch: 20,000 points of xyz + height in the room, one
    530 x 730 image in [0, 1) a sample and SUN RGB-D's camera, under which
    most of the room's points are in front of the camera and on the
    image; the same seed gives the same bytes."""
    b = tflagship.synthetic_sunrgbd_batch(2, seed=3)
    assert b["points"].shape == (2, 20000, 4)
    assert b["img"].shape == (2, 530, 730, 3) and b["img"].dtype == np.float32
    assert 0 <= b["img"].min() and b["img"].max() < 1
    xyz = b["points"][..., :3].astype(np.float64)
    cam = np.einsum("bij,bpj->bpi", b["cam2img"].astype(np.float64),
                    np.concatenate([xyz, np.ones_like(xyz[..., :1])], -1))
    uv = cam[..., :2] / cam[..., 2:3]
    seen = (cam[..., 2] > 0) & (uv[..., 0] > 0) & (uv[..., 0] < 730) & \
        (uv[..., 1] > 0) & (uv[..., 1] < 530)
    assert seen.mean() > 0.5
    again = tflagship.synthetic_sunrgbd_batch(2, seed=3)
    for k in b:
        np.testing.assert_array_equal(b[k], again[k])
