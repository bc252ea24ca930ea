"""SST's sparse-token path, its options and TransFusion's NMS: the port
against the JAX package on the same numpy inputs and carried variables.

- K17's plain versions (``ops/sst_window.py``): ``get_window_coors`` on
  the JAX test's golden coordinates, ``group_ranks``, the partition of
  both shifts (``bucketize_shift``: every int / bool output, each level's
  window table and bucket, with a binding ``win_caps`` and garbage
  coordinates on invalid rows), ``window2flat`` and ``_rebind``,
  ``SSTInputLayerV2``'s survivors: exact. JAX's ``group_ranks`` gives an
  invalid row its distance from the last valid group's start (its
  docstring says 0), which no caller reads: ranks are compared on valid
  rows and the port's invalid ranks are 0.
- ``SSTv2Sparse`` with two drop levels, forward and the gradient of every
  parameter (the JAX gradient test's loss, the canvas's sum of squares),
  and with the scaled-cosine attention: 1e-3 of the max (float32, sums in
  another order).
- ``CosineMultiheadAttention`` (shared and per-head ``tau``, one below
  ``tau_min``), ``SRABlock`` and ``SSTv2`` with ``normalize_pos`` and
  ``layer_cfg``: 1e-5 of the max.
- On a full grid with one 36-token level every window is whole, and
  ``SSTv2Sparse`` is the dense ``SSTv2``'s function on the same weights:
  1e-3 of the max on every cell, voxels in grid order or shuffled.
- ``TransFusionHeadV2.get_bboxes`` with circle and rotate NMS, the
  nuScenes tasks and custom ones: masks and labels exact, scores 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models.dense_heads.transfusion_head import \
    TransFusionHeadV2 as JaxHead
from isfusion_tpu.models.sst import sst as jsst
from isfusion_tpu.models.sst import sst_sparse as jsp
from isfusion_tpu.ops.scatter import group_ranks as jax_group_ranks
from isfusion_tpu.ops.sparse import unique_sorted_ids
from isfusion_tpu_torch.models.dense_heads.transfusion_head import \
    TransFusionHeadV2
from isfusion_tpu_torch.models.layers import init_weights
from isfusion_tpu_torch.models.sst.sst import (CosineMultiheadAttention,
                                              SRABlock, SSTv2)
from isfusion_tpu_torch.models.sst.sst_sparse import (SSTInputLayerV2,
                                                     SSTv2Sparse)
from isfusion_tpu_torch.ops import sst_window as sw
from isfusion_tpu_torch.ops.scatter import group_ranks
from torch_parity import (OPTIMIZED_XLA, assert_close_to_max, load_from_jax,
                          random_variables)

SPARSE = (24, 18, 1)        # (x, y, z)
WS = (6, 6, 1)
DROP = ({"max_tokens": 4, "drop_range": (0, 5)},
        {"max_tokens": 16, "drop_range": (5, 10000)})
CAPS = (3, 32)              # level 0's cap binds on these samples
INT_MAX = 2 ** 31 - 1


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jit(fn, *args):
    """``fn(*args)`` compiled at XLA:CPU backend level 1 (one compile: an
    eager JAX run of these modules dispatches op by op)."""
    return jax.jit(fn).lower(*args).compile(OPTIMIZED_XLA)(*args)


def sparse_batch(c=8, v=64, valid=(40, 55), seed=0):
    """Two samples of unique (y, x) cells on SPARSE, scattered among V
    rows; invalid rows carry garbage coordinates (some outside the
    grid)."""
    rng = np.random.default_rng(seed)
    coords = rng.integers(-3, 30, (len(valid), v, 3)).astype(np.int32)
    mask = np.zeros((len(valid), v), bool)
    for b, n in enumerate(valid):
        rows = rng.choice(v, n, replace=False)
        lin = rng.choice(SPARSE[0] * SPARSE[1], n, replace=False)
        mask[b, rows] = True
        coords[b, rows] = np.stack([np.zeros(n), lin // SPARSE[0],
                                    lin % SPARSE[0]], -1)
    feats = rng.normal(size=(len(valid), v, c)).astype(np.float32)
    return feats, coords, mask


@pytest.mark.parametrize("shift", [False, True])
def test_get_window_coors_golden(shift):
    coords = np.asarray([[0, 0, 0], [0, 0, 5], [0, 0, 6], [0, 5, 7],
                         [0, 17, 23], [0, -4, -1], [0, 40, 3]], np.int32)
    win, inner = jsp.get_window_coors(jnp.asarray(coords), SPARSE, WS, shift)
    got_win, got_inner = sw.get_window_coors(_t(coords), SPARSE, WS, shift)
    np.testing.assert_array_equal(got_win.numpy(), np.asarray(win))
    np.testing.assert_array_equal(got_inner.numpy(), np.asarray(inner))
    if not shift:   # tests/test_models/test_sst_sparse.py's golden values
        nwy, nwz = 4, 2
        assert got_win[0] == nwy * nwz + nwz and got_win[1] == got_win[0]
        assert got_win[2] == 2 * nwy * nwz + nwz and got_win[3] == got_win[2]
        np.testing.assert_array_equal(got_inner[3].numpy(), [0, 5, 1])


def test_group_ranks_matches():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 9, 200).astype(np.int32)
    valid = rng.random(200) < 0.7
    want = np.asarray(_jit(jax_group_ranks, jnp.asarray(ids),
                           jnp.asarray(valid)))
    got = group_ranks(_t(ids), _t(valid)).numpy()
    np.testing.assert_array_equal(got[valid], want[valid])
    assert not got[~valid].any()


def _jax_parts(feats, coords, mask, shift, caps=CAPS, drop=DROP):
    def part(f, c, m):
        p = jsp.bucketize_shift(f, c, m, SPARSE, WS, drop, caps, shift)
        return dict(p, buckets=[{k: v for k, v in bk.items()
                                 if k != "max_tokens"}
                                for bk in p["buckets"]])

    fn = jax.jit(part).lower(*(jnp.asarray(a[0]) for a in (
        feats, coords, mask))).compile(OPTIMIZED_XLA)
    parts = [fn(jnp.asarray(feats[b]), jnp.asarray(coords[b]),
                jnp.asarray(mask[b])) for b in range(len(mask))]
    for p in parts:
        for bk, d in zip(p["buckets"], drop):
            bk["max_tokens"] = d["max_tokens"]
    return parts


@pytest.mark.parametrize("shift", [False, True])
def test_partition_matches_bucketize(shift):
    feats, coords, mask = sparse_batch()
    part = sw.sst_partition(_t(coords), _t(mask), SPARSE, WS, DROP, CAPS,
                            shift)
    toks = sw.flat_to_window(_t(feats), part)
    dropped = 0
    for b, p in enumerate(_jax_parts(feats, coords, mask, shift)):
        win, inner = jsp.get_window_coors(jnp.asarray(coords[b]), SPARSE, WS,
                                          shift)
        np.testing.assert_array_equal(part.win[b].numpy(), np.asarray(win))
        np.testing.assert_array_equal(part.inner[b].numpy(),
                                      np.asarray(inner))
        for key in ("level", "slot", "keep"):
            np.testing.assert_array_equal(getattr(part, key)[b].numpy(),
                                          np.asarray(p[key]), key)
        m = mask[b]
        np.testing.assert_array_equal(part.rank[b].numpy()[m],
                                      np.asarray(p["rank"])[m])
        assert not part.rank[b].numpy()[~m].any()
        w = np.asarray(win)
        count = np.array([(w[m] == w[i]).sum() if m[i] else 0
                          for i in range(len(m))])
        np.testing.assert_array_equal(part.count[b].numpy(), count)
        level = np.asarray(p["level"])
        dropped += int((m & ~np.asarray(p["keep"])).sum())
        for li, bk in enumerate(p["buckets"]):
            t, cap = part.levels[li]
            table, _ = unique_sorted_ids(jnp.where(
                jnp.asarray(m & (level == li)), win, INT_MAX), CAPS[li])
            np.testing.assert_array_equal(part.table(li)[b].numpy(),
                                          np.asarray(table)[:cap])
            assert (np.asarray(table)[cap:] == INT_MAX).all()
            for key, got in (("tokens", toks[li][b]),
                             ("tok_valid", part.token_valid(li)[b])):
                want = np.asarray(bk[key])
                np.testing.assert_array_equal(got.numpy(), want[:cap], key)
                assert not want[cap:].any()
            src = part.tok_src.numpy()
            off = sum(2 * c_ * t_ for t_, c_ in part.levels[:li])
            rows = src[off + b * cap * t:off + (b + 1) * cap * t]
            tv = rows >= 0
            got_inner = part.inner.reshape(-1, 3).numpy()[rows[tv]]
            np.testing.assert_array_equal(
                got_inner, np.asarray(bk["inner"])[:cap].reshape(-1, 3)[tv])
    assert dropped > 0      # the caps and max_tokens bind


@pytest.mark.parametrize("shift", [False, True])
def test_window2flat_and_rebind_match(shift):
    feats, coords, mask = sparse_batch(seed=4)
    part = sw.sst_partition(_t(coords), _t(mask), SPARSE, WS, DROP, CAPS,
                            shift)
    toks = [2.0 * t + 1.0 for t in sw.flat_to_window(_t(feats), part)]
    got = sw.window_to_flat(toks, part, _t(feats))
    new = _t(feats) * 3.0
    rebound = sw.flat_to_window(new, part)
    for b, p in enumerate(_jax_parts(feats, coords, mask, shift)):
        upd = [2.0 * bk["tokens"] + jnp.where(bk["tok_valid"][..., None],
                                               1.0, 0.0)
               for bk in p["buckets"]]
        want = jsp.window2flat(p, upd, jnp.asarray(feats[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        rb = jsp._rebind(p, jnp.asarray(new[b].numpy()))
        for li, bk in enumerate(rb["buckets"]):
            cap = part.levels[li][1]
            np.testing.assert_array_equal(rebound[li][b].numpy(),
                                          np.asarray(bk["tokens"])[:cap])
    canvas = sw.flat_to_canvas(_t(feats), part)
    want = np.zeros((2, SPARSE[1], SPARSE[0], feats.shape[-1]), np.float32)
    for b in range(2):
        m = mask[b]
        want[b, coords[b, m, 1], coords[b, m, 2]] = feats[b, m]
    np.testing.assert_array_equal(canvas.numpy(), want)


def test_input_layer_survivors_match():
    feats, coords, mask = sparse_batch(seed=5)
    drop = ({"max_tokens": 3, "drop_range": (0, 6)},
            {"max_tokens": 5, "drop_range": (6, 10000)})
    jl = jsp.SSTInputLayerV2(drop_info=drop, window_shape=WS,
                             sparse_shape=SPARSE, win_caps=(4, 8))
    port = SSTInputLayerV2(drop_info=drop, window_shape=WS,
                           sparse_shape=SPARSE, win_caps=(4, 8))
    parts, eff = port(_t(coords), _t(mask))
    fn = jax.jit(lambda f, c, m: [{k: p[k] for k in ("keep", "keep_all")}
                                  for p in jl.apply({}, f, c, m)]).lower(
        *(jnp.asarray(a[0]) for a in (feats, coords, mask))).compile(
            OPTIMIZED_XLA)
    for b in range(2):
        jparts = fn(jnp.asarray(feats[b]), jnp.asarray(coords[b]),
                    jnp.asarray(mask[b]))
        want = np.asarray(jparts[0]["keep_all"])
        np.testing.assert_array_equal(eff[b].numpy(), want)
        assert want.sum() < mask[b].sum()
        for p, jp in zip(parts, jparts):
            np.testing.assert_array_equal(p.keep[b].numpy(),
                                          np.asarray(jp["keep"]))


def _sparse_case(layer_cfg=None, seed=6):
    feats, coords, mask = sparse_batch(c=8, seed=seed)
    kw = dict(d_model=16, nhead=2, num_blocks=1, dim_feedforward=32,
              window_shape=WS, sparse_shape=SPARSE, drop_info=DROP,
              win_caps=CAPS, in_channel=8, layer_cfg=layer_cfg)
    j = jsp.SSTv2Sparse(**kw)
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask))
    variables = random_variables(j, *args, seed=seed + 1)
    if layer_cfg:
        variables["params"]["block0_layer0"]["win_attn"]["tau"] = \
            np.asarray([0.6], np.float32)
        variables["params"]["block0_layer1"]["win_attn"]["tau"] = \
            np.asarray([0.02], np.float32)     # below tau_min: clamped
    port = load_from_jax(SSTv2Sparse(**kw), variables, "pts_backbone_m",
                         "pts_backbone")
    return j, variables, args, port, (_t(feats), _t(coords), _t(mask))


def test_sstv2sparse_matches_forward_and_gradients():
    j, variables, args, port, targs = _sparse_case()

    def forward_and_grads(v):
        # the gradient of the canvas's sum of squares
        out, vjp = jax.vjp(lambda v: j.apply(v, *args), v)
        return out, vjp(2 * out)[0]

    want, grads = _jit(forward_and_grads, variables)
    want = np.asarray(want)
    out = port(*targs)
    assert_close_to_max(out.detach().numpy(), want, 1e-3)
    (out ** 2).sum().backward()
    from isfusion_tpu_torch.runner.convert import state_dict_from_jax
    gsd = state_dict_from_jax({"params": {"pts_backbone_m": grads["params"]}})
    named = dict(port.named_parameters())
    assert len(named) == len(gsd)
    for name, p in named.items():
        assert_close_to_max(p.grad.numpy(), gsd[f"pts_backbone.{name}"]
                            .numpy(), 1e-3)


def test_sstv2sparse_cosine_matches():
    j, variables, args, port, targs = _sparse_case(
        layer_cfg=dict(cosine=True, tau_min=0.05), seed=8)
    want = np.asarray(_jit(lambda v: j.apply(v, *args), variables))
    with torch.no_grad():
        got = port(*targs).numpy()
    assert_close_to_max(got, want, 1e-3)


@pytest.mark.parametrize("non_shared", [False, True])
def test_cosine_attention_matches(non_shared):
    m = jsst.CosineMultiHeadAttention(num_heads=4, qkv_features=16,
                                      out_features=16, tau_min=0.2,
                                      non_shared_tau=non_shared)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    mask = rng.random((3, 1, 7, 7)) < 0.8
    mask[..., 0] = True
    variables = random_variables(m, jnp.asarray(x), seed=10)
    variables["params"]["tau"] = np.asarray(
        [0.05, 0.3, 0.8, 1.5] if non_shared else [0.05], np.float32)
    want = np.asarray(m.apply(variables, jnp.asarray(x),
                              mask=jnp.asarray(mask)))
    port = load_from_jax(CosineMultiheadAttention(16, 4, tau_min=0.2,
                                                  non_shared_tau=non_shared),
                         variables, "pts_backbone_m/encoder_0/win_attn",
                         "pts_backbone.encoder_list.0.win_attn.self_attn")
    with torch.no_grad():
        got = port(_t(x), _t(x), _t(x), mask=_t(mask)).numpy()
    assert_close_to_max(got, want, 1e-5)


def _tau(variables, names, values):
    for name, v in zip(names, values):
        variables["params"][name]["win_attn"]["tau"] = np.asarray(
            v, np.float32)


@pytest.mark.parametrize("layer_cfg", [None, dict(cosine=True, tau_min=0.1,
                                                   non_shared_tau=True)])
def test_srablock_matches(layer_cfg):
    x = np.random.default_rng(11).normal(size=(1, 14, 10, 16)).astype(
        np.float32)
    j = jsst.SRABlock(d_model=16, nhead=2, dim_feedforward=32,
                      layer_cfg=layer_cfg)
    variables = random_variables(j, jnp.asarray(x), seed=12)
    if layer_cfg:
        _tau(variables, ("encoder_0", "encoder_1"),
             ([0.02, 0.5], [0.3, 1.2]))
    want = np.asarray(_jit(j.apply, variables, jnp.asarray(x)))
    port = load_from_jax(SRABlock(16, 2, 32, layer_cfg=layer_cfg), variables,
                         "pts_backbone_m", "pts_backbone")
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert_close_to_max(got, want, 1e-5)


@pytest.mark.parametrize("layer_cfg", [None, dict(cosine=True)])
def test_sstv2_normalize_pos_and_layer_cfg_match(layer_cfg):
    d = 16
    kw = dict(d_model=[d] * 4, nhead=[2] * 4, num_blocks=2,
              dim_feedforward=[32] * 4, window_shape=(6, 6, 1),
              normalize_pos=True, layer_cfg=layer_cfg)
    x = np.random.default_rng(13).normal(size=(1, 12, 9, d)).astype(
        np.float32)
    j = jsst.SSTv2(**kw)
    variables = random_variables(j, jnp.asarray(x), seed=14)
    if layer_cfg:
        _tau(variables, [f"block{b}_layer{li}" for b in range(2)
                         for li in range(2)], ([0.3], [0.7], [0.005], [1.0]))
    want = np.asarray(_jit(j.apply, variables, jnp.asarray(x)))
    port = load_from_jax(SSTv2(**kw), variables, "fusion_encoder_m/"
                         "grid2region_0", "fusion_encoder.grid2region_att.0")
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert_close_to_max(got, want, 1e-5)


@pytest.mark.parametrize("shuffle", [False, True])
def test_sparse_equals_dense_on_a_full_grid(shuffle):
    """Every cell of the grid a voxel, one 36-token level: every window
    is whole, and the sparse path computes the dense SSTv2's function."""
    d, (sx, sy, _) = 16, SPARSE
    torch.manual_seed(0)
    sparse = init_weights(SSTv2Sparse(
        d_model=d, nhead=2, num_blocks=2, dim_feedforward=32,
        window_shape=WS, sparse_shape=SPARSE), seed=3).eval()
    dense = SSTv2(d_model=[d] * 4, nhead=[2] * 4, num_blocks=2,
                  dim_feedforward=[32] * 4, window_shape=WS).eval()
    dense.load_state_dict(sparse.state_dict())
    grid = np.random.default_rng(15).normal(size=(2, sy, sx, d)).astype(
        np.float32)
    yy, xx = np.meshgrid(np.arange(sy), np.arange(sx), indexing="ij")
    order = np.arange(sx * sy)
    if shuffle:
        order = np.random.default_rng(16).permutation(order)
    coords = np.stack([np.zeros(sx * sy), yy.reshape(-1), xx.reshape(-1)],
                      -1)[order].astype(np.int32)
    feats = grid.reshape(2, -1, d)[:, order]
    with torch.no_grad():
        want = dense(_t(grid)).numpy()
        got = sparse(_t(feats), _t(np.broadcast_to(coords, (2,) +
                                                   coords.shape).copy()),
                     torch.ones((2, sx * sy), dtype=torch.bool)).numpy()
    assert_close_to_max(got, want, 1e-3)


TF_COMMON = dict(pc_range=[-8.0, -8.0], voxel_size=[0.25, 0.25],
                 out_size_factor=8)


def _tf_cfgs(nms_type, tasks):
    coder = dict(type="TransFusionBBoxCoder", **TF_COMMON,
                 post_center_range=[-10, -10, -10, 10, 10, 10],
                 score_threshold=0.0, code_size=10)
    test_cfg = dict(dataset="nuScenes", grid_size=[64, 64, 40],
                    nms_type=nms_type, tasks=tasks, **TF_COMMON)
    return coder, test_cfg


@pytest.mark.parametrize("nms_type", ["circle", "rotate"])
@pytest.mark.parametrize("tasks", [None, [
    dict(indices=[0, 1, 2], radius=1.0), dict(indices=[3], radius=-1),
    dict(indices=[8, 9], radius=0.1)]])
def test_transfusion_get_bboxes_nms_matches(nms_type, tasks):
    rng = np.random.default_rng(17)
    b, p, nc = 2, 48, 10
    preds = dict(
        heatmap=rng.normal(size=(b, p, nc)),
        center=rng.uniform(3.0, 5.0, (b, p, 2)),
        height=rng.normal(size=(b, p, 1)),
        dim=np.log(rng.uniform(0.5, 2.5, (b, p, 3))),
        rot=rng.normal(size=(b, p, 2)), vel=rng.normal(size=(b, p, 2)),
        query_heatmap_score=rng.uniform(0.1, 1.0, (b, p, nc)))
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    labels = rng.choice([0, 1, 2, 3, 8, 9], (b, p)).astype(np.int32)
    coder, test_cfg = _tf_cfgs(nms_type, tasks)
    jhead = JaxHead(num_proposals=p, num_classes=nc, bbox_coder=coder,
                    test_cfg=test_cfg)
    jpreds = {k: jnp.asarray(v) for k, v in preds.items()}
    jpreds["query_labels"] = jnp.asarray(labels)
    want = _jit(lambda p: jhead.apply({}, p, method=JaxHead.get_bboxes),
                jpreds)
    head = TransFusionHeadV2(num_proposals=p, num_classes=nc, in_channels=8,
                             hidden_channel=8, num_decoder_layers=1,
                             num_heads=2, ffn_channel=8, bbox_coder=coder,
                             test_cfg=test_cfg)
    tpreds = {k: _t(v) for k, v in preds.items()}
    tpreds["query_labels"] = _t(labels).long()
    got = head.get_bboxes(tpreds)
    for key in ("mask", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-6)
    plain = dict(test_cfg, nms_type=None)
    free = TransFusionHeadV2(num_proposals=p, num_classes=nc, in_channels=8,
                             hidden_channel=8, num_decoder_layers=1,
                             num_heads=2, ffn_channel=8, bbox_coder=coder,
                             test_cfg=plain).get_bboxes(tpreds)
    assert (got["mask"] != free["mask"]).any()     # NMS suppressed boxes
