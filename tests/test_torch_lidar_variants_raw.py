"""The tiny DynamicSimpleVFE detector of ``flagship.LIDAR_VARIANTS`` on
nuScenes' raw 0-255 intensities, against the JAX package (the other
variant tests carry reflectance in [0, 1)).

Raw intensities pass the DynamicSimpleVFE's voxel means to the sparse
encoder as they are. Run as it is, the port's float32 gradients then lie
about 1% of their max from the JAX package's: its float32 run puts two
ReLU inputs that a float64 run of it puts on one side of 0 on the other,
both within float32 rounding of 0, and one of them carries a large
upstream gradient. Which side of a tie float32 sums land on is not a
fault of either package; given the float64 run's signs, the float32
gradients match the JAX package's. So
the port's train forward here takes the ReLU signs of a float64 run of
itself (``testing.pinned_choices``, ``torch_parity.lidar_variant_case``),
and every sign it would have taken otherwise must lie within 1e-4 of its
tensor's max of 0.

Tolerances as ``tests/test_torch_lidar_variants.py``: head outputs and
gradients 1e-3 of their max, losses 1e-4 relative, kept boxes as
``assert_same_kept_boxes``.
"""
import pytest

from torch_parity import (check_variant_gradients, check_variant_outputs,
                          lidar_variant_case)


@pytest.fixture(scope="module")
def raw_case():
    return lidar_variant_case("dynamic_simple", reflectance=False,
                              pin_float64=True)


def test_raw_intensity_head_outputs_and_predict_match(raw_case):
    check_variant_outputs(raw_case)


def test_raw_intensity_loss_terms_and_gradients_match(raw_case):
    check_variant_gradients(raw_case)


def test_float32_choices_differ_only_at_relu_ties(raw_case):
    pins = raw_case["pins"]
    assert pins["unexplained"] == []
    assert set(pins["flips"]) <= {"relu"}
    assert len(pins["relu"]) > 0
