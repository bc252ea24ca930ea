"""The LiDAR detectors the port builds from parts it already has, against
the JAX package: DynamicSimpleVFE, DynamicPillarFeatureNet and
DynamicFusionVFE, and two tiny detectors of ``flagship.LIDAR_VARIANTS``
on the Anchor3DHead (VoxelNet on hard voxels, DynamicVoxelNet on
DynamicVFE), each in head outputs, predict, loss terms and gradients on
carried weights; the other four: ``tests/test_torch_lidar_variants_
center.py`` and ``tests/test_torch_lidar_variants_more.py``.

Inputs are numpy arrays made from a seed and handed to both packages; JAX
variables are drawn with numpy (``tests/torch_parity.py``) and carried
with ``state_dict_from_jax`` (a VoxelNet tree's ``voxel_encoder_m`` ...
into the reference's ``voxel_encoder.`` ... keys). Each JAX detector's
forward, decode and loss gradient are jitted together once
(``torch_parity.lidar_variant_case``) at XLA:CPU's backend
optimisation level 1: under the suite's level 0 the JAX gradients of
these sparse detectors move 1e-3 to 4e-3 of their max (the port matches
level 1's to 1e-5). The tiny models (a 64 x 64 x 10 grid, a
2-stage SparseEncoder) keep that compile short. The JAX package caps
dynamic voxels at ``max_voxels``; the tiny scene's 2,048 points a sample
stay under its 2,048. The batches carry reflectance in [0, 1), as
KITTI's: with nuScenes' raw 0-255 intensities fed to the sparse encoder
as they are (DynamicSimpleVFE), the two packages' train-mode head outputs
agree to 4e-6 and the losses to 1e-4, but the gradients differ by 1-2%
of their max, at either optimisation level (ROADMAP queue 3, open).

Tolerances (float32, CPU): the VFEs' voxel features 1e-6 of their max;
head outputs and gradients 1e-3 of their max (sums in another order);
losses 1e-4 relative; kept boxes the same entries with the same labels,
boxes and scores 1e-4 of their max (two boxes whose scores lie within
1e-5 of the max may come in either order: ``assert_same_kept_boxes``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models.voxel_encoders import \
    DynamicPillarFeatureNet as JaxDynamicPillarFeatureNet
from isfusion_tpu.models.voxel_encoders import \
    DynamicSimpleVFE as JaxDynamicSimpleVFE
from isfusion_tpu.ops import voxel as jvoxel
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.voxel_encoders import (
    DynamicFusionVFE, DynamicPillarFeatureNet, DynamicSimpleVFE, DynamicVFE)
from isfusion_tpu_torch.ops import voxel
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from torch_parity import (assert_close_to_max, check_variant_gradients,
                          check_variant_outputs, lidar_variant_case,
                          random_variables)

PCR = tflagship.LIDAR_TINY_RANGE
ANCHOR_VARIANTS = ("voxelnet", "dynamic_voxelnet")
VS = [0.2, 0.2, 0.4]


def _points(seed=0, b=2, p=1024):
    batch = tflagship.synthetic_points_batch(b, num_points=p, num_gt=4,
                                             seed=seed, pcr=PCR)
    return batch["points"], batch["points_mask"]


def _voxelized(points, mask, vs=VS, cap=2048):
    """The same dynamic voxelization in both packages: the JAX package's
    (B, P) voxel index and (B, cap, 3) coordinates, the port's rows."""
    jdv = jax.vmap(lambda p, m: jvoxel.voxelize_dynamic(p, m, PCR, vs, cap))(
        jnp.asarray(points), jnp.asarray(mask))
    dv = voxel.voxelize_dynamic(torch.from_numpy(points),
                                torch.from_numpy(mask), PCR, vs)
    return jdv, dv


def _jax_rows(jout, jdv):
    """(B, cap, C) JAX voxel features -> the valid rows in the port's
    (b, z, y, x) order."""
    out, m = np.asarray(jout), np.asarray(jdv.voxel_mask)
    coors = np.asarray(jdv.voxel_coors)
    b, v = np.nonzero(m)
    order = np.lexsort((coors[b, v, 2], coors[b, v, 1], coors[b, v, 0], b))
    return out[b[order], v[order]]


# ------------------------------------------------------------ the VFEs
def test_dynamic_simple_vfe_matches_jax():
    points, mask = _points(1)
    jdv, dv = _voxelized(points, mask)
    want = JaxDynamicSimpleVFE(num_features=5).apply(
        {}, jnp.asarray(points), jdv.point_voxel_index, jdv.voxel_coors)
    got = DynamicSimpleVFE(num_features=5)(
        torch.from_numpy(points).reshape(-1, 5), dv.point_voxel_index,
        dv.voxel_coors, layout=(dv.voxel_ptr, dv.point_order))
    assert got.shape == (dv.voxel_coors.shape[0], 5)
    assert_close_to_max(got.numpy(), _jax_rows(want, jdv), 1e-6)


def test_dynamic_pillar_feature_net_matches_jax():
    points, mask = _points(2)
    pvs = [0.4, 0.4, PCR[5] - PCR[2]]
    jdv, dv = _voxelized(points, mask, pvs)
    kw = dict(in_channels=5, voxel_size=pvs, point_cloud_range=PCR)
    jvfe = JaxDynamicPillarFeatureNet(**kw)
    args = (jnp.asarray(points), jdv.point_voxel_index, jdv.voxel_coors)
    variables = random_variables(jvfe, *args, seed=3)
    want = jvfe.apply(variables, *args)
    port = DynamicPillarFeatureNet(**kw)
    sd = state_dict_from_jax({c: {"pts_voxel_encoder_m": variables[c]}
                              for c in variables})
    port.load_state_dict({k[len("pts_voxel_encoder."):]: v
                          for k, v in sd.items()})
    assert len(port.vfe_layers) == 1 and \
        port.vfe_layers[0].linear.out_features == 64
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(points).reshape(-1, 5),
                          dv.point_voxel_index, dv.voxel_coors)
    assert_close_to_max(got.numpy(), _jax_rows(want, jdv), 1e-5)


def test_dynamic_fusion_vfe_is_dynamic_vfe_with_its_fusion():
    """DynamicFusionVFE is DynamicVFE with a PointFusion: the same weights
    give the same voxel features (the fusion after the last layer, the
    choice settled for MVX-Net against the JAX PointFusion's halves)."""
    cfg = tflagship.mvxnet_model_cfg(tiny=True)["pts_voxel_encoder"]
    cfg = {k: v for k, v in cfg.items() if k != "type"}
    fused, plain = DynamicFusionVFE(**cfg), DynamicVFE(**cfg)
    assert isinstance(fused, DynamicVFE) and fused.fusion_layer is not None
    torch.manual_seed(0)
    for p in fused.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3)
    plain.load_state_dict(fused.state_dict())
    model, batch_fn = tflagship.build_mvxnet(tiny=True, device="cpu")
    batch = batch_fn(1, seed=2)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    dv = voxel.voxelize_dynamic(t["points"], t["points_mask"],
                                cfg["point_cloud_range"], cfg["voxel_size"])
    with torch.no_grad():
        img_feats = model.extract_img_feat(t["img"].float())
        calib = model.calib_from_batch(t)
        args = (t["points"].reshape(-1, 4), dv.point_voxel_index,
                dv.voxel_coors)
        got = fused.eval()(*args, img_feats=img_feats, calib=calib)
        want = plain.eval()(*args, img_feats=img_feats, calib=calib)
        bare = plain(*args)
    assert torch.equal(got, want)
    assert not torch.equal(got, bare)


# ---------------------------------------------------------- the detectors
@pytest.fixture(scope="module", params=ANCHOR_VARIANTS)
def variant(request):
    return lidar_variant_case(request.param)


def test_variant_head_outputs_and_predict_match(variant):
    check_variant_outputs(variant)


def test_variant_loss_terms_and_gradients_match(variant):
    check_variant_gradients(variant)


def test_voxelnet_keys_are_the_reference_names():
    model = build_detector(tflagship.lidar_variant_model_cfg("voxelnet"))
    tops = {k.split(".")[0] for k in model.state_dict()}
    assert tops == {"middle_encoder", "backbone", "neck", "bbox_head"}
    model = build_detector(tflagship.lidar_variant_model_cfg(
        "dynamic_pillar"))
    assert "voxel_encoder.vfe_layers.0.linear.weight" in model.state_dict()


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tflagship.build_lidar_variant("voxelnet")
    with pytest.raises(KeyError):
        tflagship.lidar_variant_model_cfg("second")
