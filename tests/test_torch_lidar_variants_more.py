"""The tiny LiDAR detectors of ``flagship.LIDAR_VARIANTS`` on dynamic
pillars and on the TransFusionHeadV2 against the JAX package:
DynamicVoxelNet on DynamicPillarFeatureNet (PointPillarsScatter, the
Anchor3DHead) and TransFusion-L (``TransFusionDetector``), each in head
outputs, predict, loss terms and gradients on carried weights
(``torch_parity.lidar_variant_case``: its compile and batches as
``tests/test_torch_lidar_variants.py`` says); TransFusion-L's carry
through the JAX package's ``convert_detector_torch_to_flax``.

Tolerances (float32, CPU): head outputs and gradients 1e-3 of their max;
losses 1e-4 relative; kept boxes the same entries with the same labels,
boxes and scores 1e-4 of their max (``assert_same_kept_boxes``); the
converter's round trip exact.
"""
import jax
import numpy as np
import pytest

from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.runner.full_ckpt_convert import \
    convert_detector_torch_to_flax
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from torch_parity import (check_variant_gradients, check_variant_outputs,
                          jax_cfg, lidar_variant_case)

VARIANTS = ("dynamic_pillar", "transfusion_l")


@pytest.fixture(scope="module", params=VARIANTS)
def variant(request):
    return lidar_variant_case(request.param)


def test_variant_head_outputs_and_predict_match(variant):
    check_variant_outputs(variant)


def test_variant_loss_terms_and_gradients_match(variant):
    check_variant_gradients(variant)


def test_transfusion_l_round_trip_through_the_jax_converter():
    """TransFusion-L's reference-layout state_dict through the JAX
    package's ``convert_detector_torch_to_flax`` and back: every tensor
    comes back (the SECONDFPN deconv flipped, the JAX converter's known
    mirror; ROADMAP queue 3)."""
    cfg = tflagship.lidar_variant_model_cfg("transfusion_l")
    _, batch_fn = tflagship.build_lidar_variant("transfusion_l",
                                                device="cpu")
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch_fn(1).items()}
    shapes = jax.eval_shape(lambda: jbuild_detector(jax_cfg(cfg)).init(
        jax.random.PRNGKey(0), jbatch, train=False, mode="feats"))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes)
    port = build_detector(cfg)
    rng = np.random.default_rng(8)
    ref = {k: np.zeros(v.shape, np.int64) if k.endswith(
        "num_batches_tracked") else rng.normal(size=tuple(v.shape)).astype(
            np.float32) for k, v in port.state_dict().items()}
    jax_vars, missing = convert_detector_torch_to_flax(ref, variables)
    assert missing == []
    back = state_dict_from_jax(jax_vars)
    assert set(back) == set(ref)
    for k, want in ref.items():
        if k.startswith("pts_neck.deblocks.") and want.ndim == 4 and \
                want.shape[-1] > 1:                  # stride > 1: deconv
            want = want[:, :, ::-1, ::-1]
        np.testing.assert_array_equal(back[k].numpy(), want, err_msg=k)
    assert any(k.startswith("pts_bbox_head.decoder.0.") for k in ref)
