"""The tiny LiDAR detectors of ``flagship.LIDAR_VARIANTS`` on the
CenterHead against the JAX package: DynamicVoxelNet on DynamicSimpleVFE
and DynamicCenterPoint on DynamicVFE, each in head outputs, predict, loss
terms and gradients on carried weights (``torch_parity.
lidar_variant_case``: its compile and batches as
``tests/test_torch_lidar_variants.py`` says); the DynamicCenterPoint
guard.

Tolerances (float32, CPU): head outputs and gradients 1e-3 of their max;
losses 1e-4 relative; kept boxes the same entries with the same labels,
boxes and scores 1e-4 of their max (``assert_same_kept_boxes``).
"""
import pytest

from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.models.builder import build_detector
from torch_parity import (check_variant_gradients, check_variant_outputs,
                          lidar_variant_case)

CENTER_VARIANTS = ("dynamic_simple", "dynamic_centerpoint")


@pytest.fixture(scope="module", params=CENTER_VARIANTS)
def variant(request):
    return lidar_variant_case(request.param)


def test_variant_head_outputs_and_predict_match(variant):
    check_variant_outputs(variant)


def test_variant_loss_terms_and_gradients_match(variant):
    check_variant_gradients(variant)


def test_dynamic_centerpoint_takes_dynamic_voxels_only():
    cfg = tflagship.lidar_variant_model_cfg("dynamic_centerpoint")
    assert build_detector(cfg).pts_voxel_layer["max_num_points"] == -1
    cfg["pts_voxel_layer"] = dict(cfg["pts_voxel_layer"], max_num_points=10)
    with pytest.raises(ValueError, match="dynamically"):
        build_detector(cfg)
