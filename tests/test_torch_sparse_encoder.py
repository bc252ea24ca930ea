"""The port's rulebook sparse conv and SparseEncoder against the JAX
package: the site-level engine (ops/sparse.py) for single convs, the
flagship's column engine (tiny geometry) for the whole encoder.

Tolerance: 1e-4 of the output's max (float32; the port sums the 27 taps
in one matmul, the JAX engines per tap or per column). Site tables exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models.middle_encoders.sparse_encoder import \
    SparseEncoder as JaxSparseEncoder
from isfusion_tpu.ops import sparse as jsparse
from isfusion_tpu.ops import voxel as jvoxel
from isfusion_tpu_torch.flagship import flagship_model_cfg, \
    synthetic_points_batch
from isfusion_tpu_torch.models.middle_encoders.sparse_encoder import \
    SparseEncoder
from isfusion_tpu_torch.ops import sparse_conv
from torch_parity import assert_close_to_max, load_from_jax, random_variables

GRID = (9, 14, 12)      # (nz, ny, nx)


def _sites(n=150, cin=8, seed=0):
    rng = np.random.default_rng(seed)
    cells = rng.choice(np.prod(GRID), n, replace=False)
    coords = np.stack(np.unravel_index(cells, GRID), -1).astype(np.int32)
    feats = rng.normal(size=(n, cin)).astype(np.float32)
    return feats, coords


def _close(got, want):
    assert_close_to_max(got, want, 1e-4)


def test_subm_conv_matches_site_engine():
    feats, coords = _sites()
    w = np.random.default_rng(1).normal(size=(3, 3, 3, 8, 16)).astype(
        np.float32)
    g = jsparse.build_sparse_grid(jnp.asarray(feats), jnp.asarray(coords),
                                  jnp.ones(len(feats), bool), GRID)
    want = np.asarray(jsparse.subm_conv3d(g, jnp.asarray(w)))
    sp = sparse_conv.build_sparse(
        torch.from_numpy(feats),
        torch.from_numpy(np.concatenate([np.zeros_like(coords[:, :1]),
                                         coords], 1)), GRID, 1)
    rows, found = sparse_conv.subm_rulebook(sp)
    got = sparse_conv.sparse_conv(sp.feats, rows, found, torch.from_numpy(
        w.transpose(4, 0, 1, 2, 3)))
    np.testing.assert_array_equal(sp.coords[:, 1:].numpy(),
                                  np.asarray(g.coords))
    _close(got.numpy(), want)


@pytest.mark.parametrize("ksize,stride,pad", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
])
def test_strided_conv_matches_site_engine(ksize, stride, pad):
    feats, coords = _sites(seed=2)
    w = np.random.default_rng(3).normal(size=ksize + (8, 16)).astype(
        np.float32)
    g = jsparse.build_sparse_grid(jnp.asarray(feats), jnp.asarray(coords),
                                  jnp.ones(len(feats), bool), GRID)
    out = jsparse.sparse_conv3d(g, jnp.asarray(w), stride, pad,
                                out_cap=8 * len(feats))
    m = np.asarray(out.mask)
    assert not m.all()                    # the JAX cap dropped nothing
    sp = sparse_conv.build_sparse(
        torch.from_numpy(feats),
        torch.from_numpy(np.concatenate([np.zeros_like(coords[:, :1]),
                                         coords], 1)), GRID, 1)
    osp, rows, found = sparse_conv.strided_rulebook(sp, ksize, stride, pad)
    assert osp.shape == out.grid
    np.testing.assert_array_equal(osp.coords[:, 1:].numpy(),
                                  np.asarray(out.coords)[m])
    got = sparse_conv.sparse_conv(sp.feats, rows, found, torch.from_numpy(
        w.transpose(4, 0, 1, 2, 3)))
    _close(got.numpy(), np.asarray(out.feats)[m])


@pytest.fixture(scope="module")
def tiny_voxels():
    """Voxels of a ray-cast cloud at the tiny flagship geometry."""
    cfg = flagship_model_cfg(tiny=True)
    enc = dict(cfg["pts_middle_encoder"])
    vl = cfg["pts_voxel_layer"]
    pts = synthetic_points_batch(1, num_points=3072,
                                 pcr=tuple(cfg["pc_range"]))["points"][0]
    dv = jvoxel.voxelize_dynamic(jnp.asarray(pts), jnp.ones(len(pts), bool),
                                 vl["point_cloud_range"], vl["voxel_size"],
                                 len(pts))
    nv = int(dv.num_voxels)
    coors = np.asarray(dv.voxel_coors)[:nv]
    feats = np.random.default_rng(5).normal(
        size=(nv, enc["in_channels"])).astype(np.float32)
    return enc, feats, coors


@pytest.mark.parametrize("z_windows", [None, ((5, 15),)])
def test_sparse_encoder_matches_column_engine(tiny_voxels, z_windows):
    enc, feats, coors = tiny_voxels
    enc = dict(enc, z_windows=z_windows)
    nz, ny, nx = enc["sparse_shape"]
    # lift the JAX column caps to the full BEV grid of every stage table:
    # no table can overflow, so the column engine drops nothing
    v = len(feats)
    cells = [(ny >> i) * (nx >> i) for i in range(4)]
    enc.update(stage_cap_ratios=tuple(c / v + 1e-9 for c in cells),
               dilation_ratio=1.0, dilation_ratios=None)
    jenc = JaxSparseEncoder(**{k: w for k, w in enc.items() if k != "type"})
    args = (jnp.asarray(feats)[None], jnp.asarray(coors)[None],
            jnp.ones((1, v), bool))
    variables = random_variables(jenc, *args, seed=6)
    want = np.asarray(jax.jit(jenc.apply)(variables, *args))
    tenc = load_from_jax(
        SparseEncoder(**{k: w for k, w in enc.items() if k != "type"}),
        variables, "pts_middle_encoder_m", "pts_middle_encoder")
    tc = np.concatenate([np.zeros((v, 1), np.int32), coors], 1)
    stats = {}
    with torch.no_grad():
        got = tenc(torch.from_numpy(feats), torch.from_numpy(tc), 1,
                   return_stats=stats).numpy()
    assert got.shape == want.shape
    if z_windows is not None:       # the window dropped voxels
        lo, width = z_windows[0]
        assert stats["active_sites"][0] == ((coors[:, 0] >= lo) &
                                            (coors[:, 0] < lo + width)).sum()
        assert stats["active_sites"][0] < v
    _close(got, want)
