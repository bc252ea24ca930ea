"""Voxelization, segment reductions and DynamicVFE: the port against the
JAX package on the same numpy inputs — the plain versions of K1
(``voxelize_dynamic_ref``) and K2 (``segment_max_ref``,
``segment_mean_ref``) on MVX-Net's grid and adversarial point sets
(``testing.voxel_adversarial_sets``: points on voxel faces, duplicates,
out-of-range and masked points, empty samples), the max's gradient with
ties (equal shares, as ``jax.ops.segment_max``), and the mean's fixed sum
order (rows in increasing order, the order K2 keeps on the card). K1's
point lists (``voxel_ptr``, ``point_order``, and ``segment_layout``)
against a numpy oracle (a stable argsort of the voxel ids and the offsets
of their counts); K2 and DynamicVFE given the lists against the same
calls without them and against JAX.

Tolerances: coordinates, voxel tables and point -> voxel indices exact;
the max and its gradient exact, the mean bit-equal to a sequential
float32 sum of numpy's
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
from isfusion_tpu_torch.testing import voxel_adversarial_sets
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
    _check_dynamic_vfe(with_layout=False)


def test_dynamic_vfe_with_layout_matches():
    """The layout DynamicVFE's callers hand it (K1's point lists) changes
    nothing on the CPU: the same features as the JAX DynamicVFE."""
    _check_dynamic_vfe(with_layout=True)


def _check_dynamic_vfe(with_layout):
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
    layout = (dv.voxel_ptr, dv.point_order) if with_layout else None
    with torch.no_grad():
        got = vfe(torch.from_numpy(pts).reshape(b * p, -1),
                  dv.point_voxel_index, dv.voxel_coors,
                  layout=layout).numpy()
    counts = np.asarray(jdv.voxel_mask).sum(1)
    want = np.concatenate([want[i, :counts[i]] for i in range(b)])
    assert_close_to_max(got, want, 1e-5)


MVX_PCR = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
MVX_VS = (0.05, 0.05, 0.1)
ADVERSARIAL = [name for name, *_ in voxel_adversarial_sets(
    np.random.default_rng(0), MVX_PCR, MVX_VS, p=64)]


@pytest.mark.parametrize("name", ADVERSARIAL)
def test_voxelize_dynamic_adversarial_sets_match_jax(name):
    """K1's plain version on MVX-Net's grid against the JAX voxelizer."""
    pts, mask = {n: (p, m) for n, p, m in voxel_adversarial_sets(
        np.random.default_rng(11), MVX_PCR, MVX_VS, p=2048)}[name]
    b, p, _ = pts.shape
    dv = voxel.voxelize_dynamic(torch.from_numpy(pts), torch.from_numpy(mask),
                                MVX_PCR, MVX_VS)
    ref = voxel.voxelize_dynamic_ref(torch.from_numpy(pts),
                                     torch.from_numpy(mask), MVX_PCR, MVX_VS)
    assert torch.equal(dv.point_voxel_index, ref.point_voxel_index)
    assert torch.equal(dv.voxel_coors, ref.voxel_coors)
    base = 0
    for i in range(b):
        j = jvoxel.voxelize_dynamic(jnp.asarray(pts[i]), jnp.asarray(mask[i]),
                                    MVX_PCR, MVX_VS, max_voxels=p)
        nv = int(j.num_voxels)
        mine = dv.voxel_coors[dv.voxel_coors[:, 0] == i]
        assert mine.shape[0] == nv
        np.testing.assert_array_equal(mine[:, 1:].numpy(),
                                      np.asarray(j.voxel_coors)[:nv])
        tp = dv.point_voxel_index[i * p:(i + 1) * p].numpy()
        np.testing.assert_array_equal(np.where(tp >= 0, tp - base, p),
                                      np.asarray(j.point_voxel_index))
        base += nv
    if name == "faces":          # the range's far faces lie outside it
        assert (dv.point_voxel_index < 0).any()
    if name in ("empty_samples", "all_empty"):
        assert not (dv.voxel_coors[:, 0] == 0).any()


def _ties(seed=4):
    """(data (P, C), ids, S): rows with exact ties of the maximum, a
    segment whose maximum is 0 (tied), negative-only and empty
    segments."""
    rng = np.random.default_rng(seed)
    data = rng.integers(-3, 4, (400, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 400)
    ids[ids == 7] = 8                         # segment 7 stays empty
    data[ids == 9] = -np.abs(data[ids == 9]) - 1     # all negative
    data[ids == 10] = np.minimum(data[ids == 10], 0)  # max 0, tied
    return data, ids, 50


def test_segment_max_gradient_with_ties_matches_jax():
    data, ids, s = _ties()
    w = np.random.default_rng(5).normal(size=(s, data.shape[1])).astype(
        np.float32)
    x = torch.from_numpy(data).requires_grad_(True)
    out = scatter.segment_max(x, torch.from_numpy(ids), s)
    (out * torch.from_numpy(w)).sum().backward()

    def f(d):
        o = jscatter.segment_max(d, jnp.asarray(ids), s)
        return (jnp.where(jnp.isfinite(o), o, 0.0) * w).sum(), o

    (_, jo), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(data))
    jo = np.where(np.isfinite(jo), np.asarray(jo), 0.0)
    np.testing.assert_array_equal(out.detach().numpy(), jo)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    assert (out[7] == 0).all() and (out[9] < 0).all()


def test_segment_mean_sums_rows_in_order_and_its_gradient_matches_jax():
    rng = np.random.default_rng(6)
    data = (rng.normal(size=(600, 3)) * 40).astype(np.float32)
    ids = rng.integers(0, 40, 600)
    want = np.zeros((40, 3), np.float32)
    for i in range(600):                     # one row at a time, in order
        want[ids[i]] = want[ids[i]] + data[i]
    want = want / np.maximum(np.bincount(ids, minlength=40), 1).astype(
        np.float32)[:, None]
    x = torch.from_numpy(data).requires_grad_(True)
    out = scatter.segment_mean(x, torch.from_numpy(ids), 40)
    np.testing.assert_array_equal(out.detach().numpy(), want)
    w = rng.normal(size=(40, 3)).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda d: (jscatter.segment_mean(
        d, jnp.asarray(ids), 40) * w).sum())(jnp.asarray(data))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6)


def _layout_oracle(vid, n):
    """numpy: each segment's rows in increasing order, and the offsets."""
    ptr = np.concatenate([[0], np.cumsum(np.bincount(vid, minlength=n))])
    return ptr.astype(np.int32), np.argsort(vid, kind="stable").astype(
        np.int32)


def _layout_sets():
    from isfusion_tpu_torch.flagship import synthetic_points_batch
    sets = [(name, p, m, MVX_PCR, MVX_VS) for name, p, m in
            voxel_adversarial_sets(np.random.default_rng(13), MVX_PCR,
                                   MVX_VS, p=2048)]
    cloud = synthetic_points_batch(2, num_points=20000, seed=3, pcr=PCR)
    sets.append(("flagship_cloud", cloud["points"], cloud["points_mask"],
                 PCR, VS))
    return sets


LAYOUT_SETS = ADVERSARIAL + ["flagship_cloud"]


@pytest.mark.parametrize("name", LAYOUT_SETS)
def test_voxel_layout_matches_numpy_oracle(name):
    """K1's plain point lists: voxel v's valid points in increasing order
    of their compacted index, as CSR offsets."""
    pts, mask, pcr, vs = {n: (p, m, r, v) for n, p, m, r, v in
                          _layout_sets()}[name]
    dv = voxel.voxelize_dynamic(torch.from_numpy(pts), torch.from_numpy(mask),
                                pcr, vs)
    pvi = dv.point_voxel_index.numpy()
    vid = pvi[pvi >= 0]
    nv = dv.voxel_coors.shape[0]
    ptr, order = _layout_oracle(vid, nv)
    assert dv.voxel_ptr.dtype == dv.point_order.dtype == torch.int32
    np.testing.assert_array_equal(dv.voxel_ptr.numpy(), ptr)
    np.testing.assert_array_equal(dv.point_order.numpy(), order)
    for v in range(0, nv, max(nv // 50, 1)):     # each slice is one voxel
        rows = order[ptr[v]:ptr[v + 1]]
        assert (vid[rows] == v).all() and (np.diff(rows) > 0).all()
    if name == "duplicates":                     # long slices
        assert np.diff(ptr).max() >= 2048 // 8


def test_segment_layout_matches_numpy_oracle():
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 300, 5000)
    ids[ids == 4] = 5                            # an empty segment
    ids[:700] = 9                                # a long one
    ptr, order = voxel.segment_layout(torch.from_numpy(ids), 300)
    want_ptr, want_order = _layout_oracle(ids, 300)
    np.testing.assert_array_equal(ptr.numpy(), want_ptr)
    np.testing.assert_array_equal(order.numpy(), want_order)
    assert ptr[4] == ptr[5]


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_segment_reductions_with_layout_match_jax(reduce):
    """The list changes nothing on the CPU: forward and gradient equal to
    the same call without it, and to JAX."""
    data, ids, s = _ties(seed=12)
    w = np.random.default_rng(13).normal(size=(s, data.shape[1])).astype(
        np.float32)
    fn, jfn = {"max": (scatter.segment_max, jscatter.segment_max),
               "mean": (scatter.segment_mean, jscatter.segment_mean)}[reduce]
    layout = voxel.segment_layout(torch.from_numpy(ids), s)
    res = []
    for lay in (None, layout):
        x = torch.from_numpy(data).requires_grad_(True)
        out = fn(x, torch.from_numpy(ids), s, lay)
        (out * torch.from_numpy(w)).sum().backward()
        res.append((out.detach().numpy(), x.grad.numpy()))
    (o0, g0), (o1, g1) = res
    np.testing.assert_array_equal(o1, o0)
    np.testing.assert_array_equal(g1, g0)

    def f(d):
        o = jfn(d, jnp.asarray(ids), s)
        return (jnp.where(jnp.isfinite(o), o, 0.0) * w).sum(), o

    (_, jo), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(data))
    jo = np.where(np.isfinite(jo), np.asarray(jo), 0.0)
    assert_close_to_max(o1, jo, 1e-6)
    np.testing.assert_allclose(g1, np.asarray(jg), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("call", ["voxelize", "layout", "max", "mean"])
def test_kernel_wrappers_raise_off_cpu_and_cuda(call):
    """A tensor neither on the CPU nor on a CUDA device has no kernel and
    no plain fallback."""
    dev = torch.device("meta")
    data = torch.empty((10, 4), device=dev)
    ids = torch.zeros(10, dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError, match="no kernel"):
        if call == "voxelize":
            voxel.voxelize_dynamic(torch.empty((1, 10, 4), device=dev),
                                   torch.ones((1, 10), dtype=torch.bool,
                                              device=dev), PCR, VS)
        elif call == "layout":
            voxel.segment_layout(ids, 3)
        else:
            getattr(scatter, f"segment_{call}")(data, ids, 3)
