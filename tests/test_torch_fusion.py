"""ISFusionEncoder building blocks: the port against the JAX modules on
carried variables (P2G image -> BEV sampling, SSTv2 shifted windows,
deformable attention, InsContextAtt, Instane2SceneAtt).

Shapes start from tests/test_runtime/test_fusion_parity.py. Tolerance:
1e-4 of the output's max, float32 (sums and softmaxes in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models.middle_encoders import isfusion_encoder as jenc
from isfusion_tpu.models.sst.sst import SSTv2 as JaxSSTv2
from isfusion_tpu.ops.deform_attn import ms_deform_attn_sample as jsample
from isfusion_tpu.ops.interpolate import bilinear_sample as jbilinear
from isfusion_tpu_torch.models.middle_encoders import isfusion_encoder as tenc
from isfusion_tpu_torch.models.sst.sst import SSTv2
from isfusion_tpu_torch.ops.deform_attn import ms_deform_attn_sample
from isfusion_tpu_torch.ops.interpolate import bilinear_sample
from torch_parity import assert_close_to_max, load_from_jax, random_variables

TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_p2g_img_to_bev_matches():
    rng = np.random.default_rng(7)
    nv, fh, fw, c = 2, 8, 12, 4
    vp, t, bev = 10, 3, 16
    img_hw = (32, 48)
    img_feat = rng.normal(size=(1, nv, fh, fw, c)).astype(np.float32)
    pillars = rng.uniform(-6, 6, size=(1, vp, t, 4)).astype(np.float32)
    pillars[..., 2] = rng.uniform(-1, 1, (1, vp, t))
    coors = np.zeros((1, vp, 3), np.int32)
    coors[0, :, 1] = rng.choice(bev, vp, replace=False)
    coors[0, :, 2] = rng.choice(bev, vp, replace=False)
    num_points = rng.integers(1, t + 1, (1, vp)).astype(np.int32)
    l2i = np.zeros((1, nv, 4, 4), np.float32)
    for k in range(nv):
        th = 0.4 * k
        rot = np.array([[np.cos(th), -np.sin(th), 0],
                        [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
        K = np.array([[20, 0, 24], [0, 20, 16], [0, 0, 1]], np.float32)
        ax = np.array([[0, 1, 0], [0, 0, -1], [1, 0, 0]], np.float32)
        l2i[0, k, :3, :3] = K @ ax @ rot
        l2i[0, k, 3, 3] = 1
    img_aug = np.broadcast_to(np.eye(4, dtype=np.float32),
                              (1, nv, 4, 4)).copy()
    img_aug[0, :, 0, 0], img_aug[0, :, 1, 1], img_aug[0, :, 0, 3] = \
        0.9, 1.1, 2.0
    th = 0.3
    lidar_aug = np.eye(4, dtype=np.float32)[None].copy()
    lidar_aug[0, :2, :2] = [[np.cos(th), -np.sin(th)],
                            [np.sin(th), np.cos(th)]]
    lidar_aug[0, :3, 3] = [0.5, -0.2, 0.1]

    j = jenc.ISFusionEncoder(bev_size=bev, num_views=nv, random_noise=None)
    calib = dict(lidar2img=l2i, img_aug_matrix=img_aug,
                 lidar_aug_matrix=lidar_aug, img_input_shape=img_hw)
    want = np.asarray(j.apply(
        {}, jnp.asarray(img_feat), jnp.asarray(pillars), jnp.asarray(coors),
        jnp.ones((1, vp), bool), jnp.asarray(num_points),
        {k: jnp.asarray(v) if k != "img_input_shape" else v
         for k, v in calib.items()}, False,
        method=jenc.ISFusionEncoder._img_to_bev))
    port = tenc.ISFusionEncoder(bev_size=bev, num_views=nv, embed_dims=16,
                                img_channels=c, lidar_channels=8,
                                random_noise=None)
    got = port.img_to_bev(
        _t(img_feat), _t(pillars[0]),
        _t(np.concatenate([np.zeros((vp, 1), np.int32), coors[0]], 1)),
        _t(num_points[0]),
        {k: _t(v) if k != "img_input_shape" else v
         for k, v in calib.items()})
    assert np.abs(want).max() > 0
    assert_close_to_max(got.numpy(), want, TOL)


@pytest.mark.parametrize("hw,in_channel", [((12, 12), 8), ((14, 10), None)])
def test_sstv2_matches(hw, in_channel):
    d = 16
    kw = dict(d_model=[d] * 4, nhead=[8] * 4, num_blocks=1,
              dim_feedforward=[d] * 4, window_shape=(6, 6, 1),
              in_channel=in_channel)
    x = np.random.default_rng(11).normal(
        size=(1,) + hw + (in_channel or d,)).astype(np.float32)
    j = JaxSSTv2(**kw)
    variables = random_variables(j, jnp.asarray(x), seed=12)
    want = np.asarray(j.apply(variables, jnp.asarray(x)))
    port = load_from_jax(SSTv2(**kw), variables, "fusion_encoder_m/"
                         "grid2region_0", "fusion_encoder.grid2region_att.0")
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert_close_to_max(got, want, TOL)


def test_bilinear_sample_matches():
    rng = np.random.default_rng(9)
    img = rng.normal(size=(7, 9, 5)).astype(np.float32)
    x = rng.uniform(-2, 11, (40,)).astype(np.float32)   # some outside
    y = rng.uniform(-2, 9, (40,)).astype(np.float32)
    x[:4], y[:4] = [0.0, 8.0, 3.0, -0.5], [0.0, 6.0, 2.5, 3.0]
    want = np.asarray(jbilinear(jnp.asarray(img), jnp.asarray(x),
                                jnp.asarray(y)))
    got = bilinear_sample(_t(img), _t(x), _t(y))
    assert_close_to_max(got.numpy(), want, TOL)


def test_ms_deform_attn_sample_matches():
    rng = np.random.default_rng(13)
    shapes = [(6, 8), (3, 4)]
    maps = [rng.normal(size=(h, w, 2, 4)).astype(np.float32)
            for h, w in shapes]
    loc = rng.uniform(-0.2, 1.2, (5, 2, 2, 3, 2)).astype(np.float32)
    wts = rng.uniform(size=(5, 2, 2, 3)).astype(np.float32)
    want = np.asarray(jsample([jnp.asarray(m) for m in maps],
                              jnp.asarray(loc), jnp.asarray(wts)))
    got = ms_deform_attn_sample([_t(m) for m in maps], _t(loc), _t(wts))
    assert_close_to_max(got.numpy(), want, TOL)


def test_ms_deform_attn_two_levels_matches():
    rng = np.random.default_rng(14)
    c, lq, shapes = 16, 6, [(6, 8), (3, 4)]
    query = rng.normal(size=(1, lq, c)).astype(np.float32)
    ref = rng.uniform(size=(1, lq, 2, 2)).astype(np.float32)
    src = rng.normal(size=(1, sum(h * w for h, w in shapes), c)).astype(
        np.float32)
    j = jenc.MSDeformAttn(d_model=c, n_levels=2, n_heads=8, n_points=4)
    args = (jnp.asarray(query), jnp.asarray(ref), jnp.asarray(src), shapes)
    variables = random_variables(j, *args, seed=15)
    want = np.asarray(j.apply(variables, *args))
    port = load_from_jax(tenc.MSDeformAttn(c, 2, 8, 4), variables,
                         "fusion_encoder_m/instance_att/layer_0/cross_attn",
                         "fusion_encoder.instance_att.layers.0.cross_attn")
    with torch.no_grad():
        got = port(_t(query), _t(ref), _t(src), shapes).numpy()
    assert_close_to_max(got, want, TOL)


def test_ins_context_att_matches():
    rng = np.random.default_rng(21)
    c, bev, n, npts = 16, 12, 6, 4
    scene = rng.normal(size=(1, bev, bev, c)).astype(np.float32)
    x_ins = rng.normal(size=(1, n, c)).astype(np.float32)
    query_pos = np.stack([rng.choice(bev, n, replace=False) + 0.5,
                          rng.choice(bev, n, replace=False) + 0.5],
                         -1).astype(np.float32)[None]
    j = jenc.InsContextAtt(num_layers=2, embed_dims=c, bev_size=bev,
                           n_points=npts)
    args = (jnp.asarray(x_ins), jnp.asarray(query_pos), jnp.asarray(scene))
    variables = random_variables(j, *args, seed=22)
    want = np.asarray(j.apply(variables, *args))
    port = load_from_jax(tenc.InsContextAtt(2, c, bev, npts), variables,
                         "fusion_encoder_m/instance_att",
                         "fusion_encoder.instance_att")
    with torch.no_grad():
        got = port(_t(x_ins), _t(query_pos), _t(scene)).numpy()
    assert_close_to_max(got, want, TOL)


def test_instance_to_scene_att_matches():
    rng = np.random.default_rng(31)
    c, bev, n = 16, 8, 5
    scene_tokens = rng.normal(size=(1, bev * bev, c)).astype(np.float32)
    x_ins = rng.normal(size=(1, n, c)).astype(np.float32)
    query_scene = rng.normal(size=(1, bev, bev, c)).astype(np.float32)
    j = jenc.Instane2SceneAtt(d_model=c, nhead=8)
    args = (jnp.asarray(scene_tokens), jnp.asarray(x_ins),
            jnp.asarray(query_scene))
    variables = random_variables(j, *args, seed=32)
    want = np.asarray(j.apply(variables, *args))
    port = load_from_jax(tenc.Instane2SceneAtt(c, 8), variables,
                         "fusion_encoder_m/instance_to_scene_att",
                         "fusion_encoder.instance_to_scene_att")
    with torch.no_grad():
        got = port(_t(scene_tokens), _t(x_ins), _t(query_scene)).numpy()
    assert_close_to_max(got, want, TOL)
