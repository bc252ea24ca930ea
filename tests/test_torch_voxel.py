"""Voxelization, segment reductions and DynamicVFE: the port against the
JAX package on the same numpy inputs.

Tolerances: coordinates, voxel tables and point -> voxel indices exact
(the port repeats the JAX arithmetic: float32 floor against a reciprocal
rounded once from float64, so points on voxel boundaries land alike);
features 1e-5 of their max (float32 sums in another order; intensities up
to 255 make VFE features O(100), where float32's own step is ~1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models.voxel_encoders import DynamicVFE as JaxDynamicVFE
from isfusion_tpu.ops import scatter as jscatter
from isfusion_tpu.ops import voxel as jvoxel
from isfusion_tpu_torch.models.voxel_encoders import DynamicVFE
from isfusion_tpu_torch.ops import scatter, voxel
from torch_parity import assert_close_to_max, load_from_jax, random_variables

PCR = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
VS = (0.075, 0.075, 0.2)


def _points(b=2, p=3000, seed=0):
    """(B, P, 5) points: a dense blob (many points per voxel), points on
    voxel boundaries, out-of-range points; plus a validity mask."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, p, 5), np.float32)
    for i in range(b):
        blob = rng.normal([3.0, -2.0, -1.0], [0.3, 0.3, 0.3], (p // 2, 3))
        spread = rng.uniform([-53, -53, -4.9], [53, 53, 2.9], (p // 4, 3))
        k = rng.integers(-700, 700, (p - p // 2 - p // 4 - 20, 3))
        bound = np.asarray(PCR[:3]) + (k % [1440, 1440, 40]) * \
            np.asarray(VS)          # exactly on a voxel face (float64 -> f32)
        out = rng.uniform(-70, 70, (20, 3))
        pts[i, :, :3] = np.concatenate([blob, spread, bound, out])
    pts[..., 3] = rng.uniform(0, 255, (b, p))
    pts[..., 4] = rng.integers(0, 10, (b, p)) * 0.05
    mask = rng.uniform(size=(b, p)) > 0.05
    return pts, mask


def test_voxel_coords_match_at_boundaries():
    pts, _ = _points()
    jc, jin, jgrid = jvoxel.compute_voxel_coords(jnp.asarray(pts[0]), PCR, VS)
    tc, tin, tgrid = voxel.compute_voxel_coords(torch.from_numpy(pts[0]),
                                                PCR, VS)
    assert tgrid == jgrid
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))


def test_voxelize_dynamic_matches():
    pts, mask = _points()
    b, p, _ = pts.shape
    dv = voxel.voxelize_dynamic(torch.from_numpy(pts), torch.from_numpy(mask),
                                PCR, VS)
    base = 0
    for i in range(b):
        j = jvoxel.voxelize_dynamic(jnp.asarray(pts[i]), jnp.asarray(mask[i]),
                                    PCR, VS, max_voxels=p)
        nv = int(j.num_voxels)
        assert nv <= p                     # the JAX cap dropped nothing
        mine = dv.voxel_coors[dv.voxel_coors[:, 0] == i]
        assert mine.shape[0] == nv
        np.testing.assert_array_equal(mine[:, 1:].numpy(),
                                      np.asarray(j.voxel_coors)[:nv])
        jp = np.asarray(j.point_voxel_index)
        tp = dv.point_voxel_index[i * p:(i + 1) * p].numpy()
        np.testing.assert_array_equal(np.where(tp >= 0, tp - base, p), jp)
        base += nv


def test_voxelize_hard_matches():
    pts, mask = _points(seed=1)
    b, p, c = pts.shape
    size = (VS[0] * 8, VS[1] * 8, PCR[5] - PCR[2])    # 0.6 m pillars
    hv = voxel.voxelize_hard(torch.from_numpy(pts), torch.from_numpy(mask),
                             PCR, size, 12)
    for i in range(b):
        j = jvoxel.voxelize_hard(jnp.asarray(pts[i]), jnp.asarray(mask[i]),
                                 PCR, size, 12, max_voxels=p)
        nv = int(np.asarray(j.voxel_mask).sum())
        sel = (hv.coors[:, 0] == i).numpy()
        assert sel.sum() == nv
        np.testing.assert_array_equal(hv.coors[sel, 1:].numpy(),
                                      np.asarray(j.coors)[:nv])
        np.testing.assert_array_equal(hv.num_points[sel].numpy(),
                                      np.asarray(j.num_points)[:nv])
        np.testing.assert_array_equal(hv.voxels[sel].numpy(),
                                      np.asarray(j.voxels)[:nv])
        assert hv.num_points[sel].max() == 12   # the blob fills pillars


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_segment_reductions_match(reduce):
    rng = np.random.default_rng(3)
    data = rng.normal(size=(500, 7)).astype(np.float32)
    ids = rng.integers(0, 60, 500).astype(np.int32)
    ids[ids == 17] = 18                       # segment 17 stays empty
    fn = {"max": (scatter.segment_max, jscatter.segment_max),
          "mean": (scatter.segment_mean, jscatter.segment_mean)}[reduce]
    got = fn[0](torch.from_numpy(data), torch.from_numpy(ids), 60).numpy()
    want = np.asarray(fn[1](jnp.asarray(data), jnp.asarray(ids), 60))
    want = np.where(np.isfinite(want), want, 0.0)   # empty segments -> 0
    assert_close_to_max(got, want, 1e-5)
    assert (got[17] == 0).all()


def test_dynamic_vfe_matches():
    pts, mask = _points(seed=2)
    b, p, _ = pts.shape
    kw = dict(in_channels=5, feat_channels=[16, 16], with_cluster_center=True,
              with_voxel_center=True, voxel_size=VS, point_cloud_range=PCR,
              norm_cfg=dict(type="BN1d", eps=1e-3, momentum=0.01))
    jdv = jax.vmap(lambda q, m: jvoxel.voxelize_dynamic(q, m, PCR, VS, p))(
        jnp.asarray(pts), jnp.asarray(mask))
    jvfe = JaxDynamicVFE(**kw)
    args = (jnp.asarray(pts), jdv.point_voxel_index, jdv.voxel_coors)
    variables = random_variables(jvfe, *args, seed=4)
    want = np.asarray(jvfe.apply(variables, *args))
    vfe = load_from_jax(DynamicVFE(**kw), variables, "pts_voxel_encoder_m",
                        "pts_voxel_encoder")
    dv = voxel.voxelize_dynamic(torch.from_numpy(pts), torch.from_numpy(mask),
                                PCR, VS)
    with torch.no_grad():
        got = vfe(torch.from_numpy(pts).reshape(b * p, -1),
                  dv.point_voxel_index, dv.voxel_coors).numpy()
    counts = np.asarray(jdv.voxel_mask).sum(1)
    want = np.concatenate([want[i, :counts[i]] for i in range(b)])
    assert_close_to_max(got, want, 1e-5)
