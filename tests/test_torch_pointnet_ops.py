"""The plain versions of K14 (``isfusion_tpu_torch/ops/pointnet_ops.py``)
against the JAX package's PointNet++ ops, vmapped over the batch, on the
seeded sets of ``testing.point_op_sets``: random clouds, exact
duplicates, masked tails and a sample with every point masked, more FPS
samples than valid points, empty balls, points at exactly the radius and
lattices whose neighbours tie; clouds at the edges of K14-FPS's one-block
and cluster routes, ties across a cluster's blocks, a block's share
masked, a sample at ``FPS_MAX_POINTS``; gathers of rows of C = 1, 3, 5,
128 and 130 floats and of a view whose rows are not 16-byte aligned.

Tolerances: FPS, ball-query and nearest-neighbour indices and valid flags
equal; squared distances, three_nn distances, interpolation weights and
interpolations within 1e-6 of their max; the gathers' and
``three_interpolate``'s gradients (features and weights) within 1e-6 of
their max against ``jax.grad`` of the JAX ops. Also: the CSR of slots
that the gathers' backward reads, the kernels' argument checks, and that
a tensor on another device than the CPU or the card raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.ops import pointnet_ops as J
from isfusion_tpu_torch.ops import pointnet_ops as P
from isfusion_tpu_torch.testing import (POINT_SET_ROWS, offset_rows,
                                       point_op_sets)
from torch_parity import assert_close_to_max

SETS = point_op_sets(np.random.default_rng(0))
NAMES = [s[0] for s in SETS]


def _set(name):
    return next(s for s in SETS if s[0] == name)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("name", NAMES)
def test_furthest_point_sample_matches_jax(name):
    _, xyz, mask, _, _, _, s = _set(name)
    want = jax.vmap(lambda p, m: J.furthest_point_sample(p, s, m))(
        jnp.asarray(xyz), jnp.asarray(mask))
    got = P.furthest_point_sample(*_t(xyz), s, _t(mask)[0])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_ball_query_matches_jax(name):
    _, xyz, mask, q, radius, k, _ = _set(name)
    wi, wv = jax.vmap(lambda p, qq, m: J.ball_query(radius, k, p, qq, m))(
        jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(mask))
    gi, gv = P.ball_query(radius, k, *_t(xyz, q), _t(mask)[0])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_ball_query_sets_reach_their_edge_cases():
    """The sets hold what they are named for: empty balls (the nearest
    point, valid False), full balls, a point exactly at the radius kept
    and one float32 step past it left out."""
    _, xyz, mask, q, radius, k, _ = _set("empty_balls")
    idx, valid = P.ball_query(radius, k, *_t(xyz, q), _t(mask)[0])
    assert not valid.any()
    d = P.square_distance(*_t(q, xyz))
    np.testing.assert_array_equal(idx[..., 0].long().numpy(),
                                  d.argmin(-1).numpy())
    _, xyz, mask, q, radius, k, _ = _set("radius_boundary")
    idx, valid = P.ball_query(radius, k, *_t(xyz, q), _t(mask)[0])
    kept = set(idx[0, 0][valid[0, 0]].tolist())
    assert {0, 1, 2, 3, 7} <= kept and not {4, 5} & kept
    _, xyz, mask, q, radius, k, _ = _set("random")
    assert P.ball_query(radius, k, *_t(xyz, q), _t(mask)[0])[1].all(-1).any()


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("name", NAMES)
def test_knn_matches_jax(name, k):
    _, xyz, mask, q, _, _, _ = _set(name)
    wi, wd = jax.vmap(lambda p, qq, m: J.knn(k, p, qq, m))(
        jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(mask))
    gi, gd = P.knn(k, *_t(xyz, q), _t(mask)[0])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert_close_to_max(gd.numpy(), np.asarray(wd), 1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_three_nn_interpolation_matches_jax(name):
    _, xyz, mask, q, _, _, _ = _set(name)
    feats = np.random.default_rng(1).normal(
        size=xyz.shape[:2] + (5,)).astype(np.float32)

    def jax_interp(p, qq, m, f):
        d, idx = J.three_nn(qq, p, m)
        w = J.interpolation_weights(d)
        return d, idx, w, J.three_interpolate(f, idx, w)

    wd, wi, ww, wo = jax.vmap(jax_interp)(*map(jnp.asarray,
                                               (xyz, q, mask, feats)))
    d, idx = P.three_nn(*_t(q, xyz), _t(mask)[0])
    w = P.interpolation_weights(d)
    out = P.three_interpolate(_t(feats)[0], idx, w)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    for got, want in ((d, wd), (w, ww), (out, wo)):
        assert_close_to_max(got.numpy(), np.asarray(want), 1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_gathers_and_their_gradients_match_jax(name):
    """gather_points (the FPS picks), group_points (the balls) and
    three_interpolate (the 3 nearest) forward, and their gradients against
    ``jax.grad`` of a probe's dot with the JAX ops' outputs."""
    _, xyz, mask, q, radius, k, s = _set(name)
    rng = np.random.default_rng(2)
    c, offset = POINT_SET_ROWS.get(name, (6, 0))
    feats = rng.normal(size=xyz.shape[:2] + (c,)).astype(np.float32)
    fps = P.furthest_point_sample(*_t(xyz), s, _t(mask)[0])
    gi, _ = P.ball_query(radius, k, *_t(xyz, q), _t(mask)[0])
    d, ni = P.three_nn(*_t(q, xyz), _t(mask)[0])
    w = P.interpolation_weights(d).numpy()
    probes = [rng.normal(size=shape).astype(np.float32) for shape in (
        fps.shape + (c,), gi.shape + (c,), ni.shape[:2] + (c,))]

    def jax_loss(f, ww):
        outs = (jax.vmap(J.gather_points)(f, jnp.asarray(fps.numpy())),
                jax.vmap(J.group_points)(f, jnp.asarray(gi.numpy())),
                jax.vmap(J.three_interpolate)(f, jnp.asarray(ni.numpy()), ww))
        return sum(jnp.sum(o * p) for o, p in zip(outs, probes)), outs

    (_, wouts), (wgf, wgw) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(feats),
                                                jnp.asarray(w))
    base, f = offset_rows(feats, offset, requires_grad=True)
    wt = torch.from_numpy(w).requires_grad_(True)
    outs = (P.gather_points(f, fps), P.group_points(f, gi),
            P.three_interpolate(f, ni, wt))
    sum((o * torch.from_numpy(p)).sum() for o, p in zip(outs, probes)
        ).backward()
    for got, want in zip(outs, wouts):
        np.testing.assert_array_equal(got.detach().numpy()[..., :0].shape,
                                      np.asarray(want)[..., :0].shape)
        assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-6)
    assert_close_to_max(base.grad[offset:].view(feats.shape).numpy(),
                        np.asarray(wgf), 1e-6)
    assert_close_to_max(wt.grad.numpy(), np.asarray(wgw), 1e-6)


def test_gathers_copy_rows_exactly():
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.normal(size=(2, 50, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 50, (2, 7, 4)).astype(np.int32))
    got = P.group_points(feats, idx)
    for b in range(2):
        assert torch.equal(got[b], feats[b][idx[b].long()])
    assert torch.equal(P.gather_points(feats, idx[:, :, 0]), got[:, :, 0])


def test_slot_lists_group_each_rows_slots_in_order():
    rng = np.random.default_rng(4)
    n = 30
    idx = torch.from_numpy(rng.integers(0, n, (3, 200)).astype(np.int32))
    idx[1, :] = 7                       # one row read by every slot
    ptr, slots = P.slot_lists(idx, n)
    assert ptr.dtype == slots.dtype == torch.int32
    assert ptr[0] == 0 and ptr[-1] == idx.numel()
    flat = idx.reshape(-1).long() + n * torch.arange(3).repeat_interleave(
        200)
    for row in range(3 * n):
        got = slots[ptr[row]:ptr[row + 1]].tolist()
        want = torch.nonzero(flat == row)[:, 0].tolist()
        assert got == want, row


def test_ops_check_their_arguments():
    xyz = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError):
        P.furthest_point_sample(xyz.double(), 4)
    with pytest.raises(ValueError):
        P.ball_query(0.1, 4, xyz, torch.zeros((2, 3, 3)))
    with pytest.raises(ValueError):
        P.knn(9, xyz, xyz)
    with pytest.raises(RuntimeError, match="no gradient"):
        P.knn(3, xyz.requires_grad_(True), xyz)
    with pytest.raises(TypeError):
        P.gather_points(torch.zeros((1, 8, 2)), torch.zeros((1, 3),
                                                            dtype=torch.int64))


@pytest.mark.parametrize("op", ["fps", "ball", "knn", "gather"])
def test_a_tensor_off_the_cpu_and_the_card_raises(op):
    xyz = torch.zeros((1, 8, 3), device="meta")
    idx = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        if op == "fps":
            P.furthest_point_sample(xyz, 4)
        elif op == "ball":
            P.ball_query(0.1, 4, xyz, xyz)
        elif op == "knn":
            P.knn(3, xyz, xyz)
        else:
            P.gather_points(torch.zeros((1, 8, 2), device="meta"), idx)
