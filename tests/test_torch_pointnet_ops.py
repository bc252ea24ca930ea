"""The plain versions of K14 (``isfusion_tpu_torch/ops/pointnet_ops.py``)
against the JAX package's PointNet++ ops, vmapped over the batch, on the
seeded sets of ``testing.point_op_sets``: random clouds, exact
duplicates, masked tails and a sample with every point masked, more FPS
samples than valid points, empty balls, points at exactly the radius and
lattices whose neighbours tie; clouds at the edges of K14-FPS's one-block
and cluster routes, ties across a cluster's blocks, a block's share
masked, a sample of 50,000 points; gathers of rows of C = 1, 3, 5,
128 and 130 floats and of a view whose rows are not 16-byte aligned;
K14-ball's cell grid and K14-NN's warp merge (``GRID_SETS``, held
against JAX in the ball query and K-NN): points on the grid's cell faces
and at the radius's float32 edge, 40,000 copies of one point, crowded
spots, masked and all-masked samples, radii past the room and below the
points' spacing, a batch of 8, K-NN ties across tiles.

Tolerances: FPS, ball-query and nearest-neighbour indices and valid flags
equal; squared distances, three_nn distances, interpolation weights and
interpolations within 1e-6 of their max; the gathers' and
``three_interpolate``'s gradients (features and weights) within 1e-6 of
their max against ``jax.grad`` of the JAX ops; K-NN also at k = 17 and
64. Also: the CSR of slots that the gathers' backward reads, the kernels'
argument checks, that a tensor on another device than the CPU or the card
raises, and the two redesigned kernels' algorithms in numpy mirrors
against the plain versions (exact): K14-ball's cell-grid cut keeps every
point of every ball, its grid route (hashing, bucket dedupe, the
candidate buffer's limit, the rank order) with the default and a 4-bucket
table, K14-NN's lanes' lists and merge rounds at k = 1 to N.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.ops import pointnet_ops as J
from isfusion_tpu_torch.ops import pointnet_ops as P
from isfusion_tpu_torch.testing import (BALL_GRID_SETS as GRID_SETS,
                                       POINT_SET_ROWS, offset_rows,
                                       point_op_sets)
from torch_parity import assert_close_to_max

SETS = point_op_sets(np.random.default_rng(0))
NAMES = [s[0] for s in SETS]
# the sets that K14-ball's grid and K14-NN's merge added are held against
# JAX in the ball query and K-NN (FPS sees them on the card)
OTHER_NAMES = [n for n in NAMES if n not in GRID_SETS]


def _set(name):
    return next(s for s in SETS if s[0] == name)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("name", OTHER_NAMES)
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


@pytest.mark.parametrize("k", [3, 8, 17, 64])
@pytest.mark.parametrize("name", NAMES)
def test_knn_matches_jax(name, k):
    _, xyz, mask, q, _, _, _ = _set(name)
    wi, wd = jax.vmap(lambda p, qq, m: J.knn(k, p, qq, m))(
        jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(mask))
    gi, gd = P.knn(k, *_t(xyz, q), _t(mask)[0])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert_close_to_max(gd.numpy(), np.asarray(wd), 1e-6)


@pytest.mark.parametrize("name", OTHER_NAMES)
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


@pytest.mark.parametrize("name", OTHER_NAMES)
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


# ------------------------------------------- the redesigned kernels' logic
GRID_NAMES = [n for n in NAMES if P.ball_grid_params(_set(n)[4]) is not None]
F32 = np.float32


def test_ball_grid_sets_reach_their_edge_cases():
    """The grid sets hold what they are named for: points on both sides of
    a cell face, points at the last float32 step inside the radius kept
    and the first past it left out, balls of far more than K points, an
    all-masked sample, queries with an empty ball; every grid set is one
    the grid route takes by default (past ``BALL_SCAN_MAX_POINTS``)."""
    _, xyz, mask, q, radius, k, _ = _set("grid_edges")
    inv, _ = P.ball_grid_params(radius)
    o = xyz[0, 0]
    cells = np.floor(((xyz[0] - o).astype(F32) * F32(inv)).astype(F32))
    face = xyz[0, 2600:3800].reshape(3, 200, 2, 3)
    for axis in range(3):
        assert (cells[2600 + 400 * axis:3000 + 400 * axis:2, axis] ==
                cells[2601 + 400 * axis:3000 + 400 * axis:2, axis] + 1).all()
        assert (face[axis, :, 0, axis] == np.nextafter(
            face[axis, :, 1, axis], F32(np.inf))).all()
    idx, valid = P.ball_query(radius, k, *_t(xyz, q), _t(mask)[0])
    for i in range(16):               # query i: 12 edge points from 3800
        kept = set(idx[0, i][valid[0, i]].tolist())
        edge = 3800 + 12 * i + np.arange(12)
        assert set(edge[0::2]) <= kept and not set(edge[1::2]) & kept
    for name, least in (("one_point_40k", 40000), ("crowded_spots", 3000)):
        _, xyz, mask, q, radius, k, _ = _set(name)
        d = P.square_distance(*_t(q, xyz))
        assert int((d <= P._radius2(radius)).sum(-1).max()) >= least
    _, xyz, mask, q, radius, k, _ = _set("grid_masked")
    idx, valid = P.ball_query(radius, k, *_t(xyz, q), _t(mask)[0])
    assert not mask[1].any() and not valid[1].any()
    assert not valid[0, 24:].any() and valid[0, :24].any()
    for name in GRID_SETS:
        assert name in GRID_NAMES
        assert _set(name)[1].shape[1] > P.BALL_SCAN_MAX_POINTS


@pytest.mark.parametrize("name", GRID_NAMES)
def test_ball_grid_cut_keeps_every_point_in_the_ball(name):
    """``ball_grid_cut`` (the kernel's cells in its float32 arithmetic)
    holds every point that the plain version's float32 test admits, and
    a query's cube spans at most 4 cells an axis."""
    _, xyz, mask, q, radius, _, _ = _set(name)
    xyz_t, q_t = _t(xyz, q)
    for lo in range(0, q.shape[1], 16):
        qq = q_t[:, lo:lo + 16]
        within = P.square_distance(qq, xyz_t) <= P._radius2(radius)
        cut = P.ball_grid_cut(radius, xyz_t, qq)
        assert not (within & ~cut).any()
    inv, reach = P.ball_grid_params(radius)
    f = ((q - xyz[:, :1]).astype(F32) * F32(inv)).astype(F32)
    margin = (F32(reach) + F32(2 ** -12)) + np.abs(f) * F32(2 ** -18)
    span = np.floor(f + margin) - np.floor(f - margin) + 1
    assert span.max() <= 4


def _uint32(x):
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32)


def _bucket(cells, table_mask):
    """The kernel's hash of (cx, cy, cz) integer cells, uint32 wrapping."""
    with np.errstate(over="ignore"):
        c = [_uint32(cells[..., a]) for a in range(3)]
        h = (c[0] * np.uint32(0x9E3779B1)) ^ (c[1] * np.uint32(0x85EBCA77)) \
            ^ (c[2] * np.uint32(0xC2B2AE3D))
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x2C1B3C6D)
        h ^= h >> np.uint32(12)
    return h & np.uint32(table_mask)


def grid_ball_query(radius, k, xyz, q, mask, bits=None, cap=512,
                    max_cells=64):
    """A numpy mirror of K14-ball's grid route (``csrc/ball_query.cu``):
    each valid point's bucket, the buckets' lists in increasing index, a
    query's cube cells in the kernel's order, buckets already seen
    dropped, at most ``cap`` candidates; the exact float32 test, the first
    k in-radius ids in index order, slots past the count the first.
    Queries that the kernel hands to its scan route (more than
    ``max_cells`` cells or ``cap`` candidates, an empty ball) take the
    plain version's answer. Returns idx, valid and {route: queries}."""
    inv, reach = P.ball_grid_params(radius)
    b, n, _ = xyz.shape
    bits = P.ball_grid_table_bits(n) if bits is None else bits
    table_mask = (1 << bits) - 1
    r2 = F32(P._radius2(radius))
    want_i, want_v = (a.numpy() for a in P.ball_query_ref(
        radius, k, *_t(xyz, q), _t(mask)[0]))
    idx, valid = want_i.copy(), want_v.copy()
    routes = dict(grid=0, cells=0, cap=0, empty=0)

    def cell(f):
        return np.clip(np.floor(f), -2.0 ** 30, 2.0 ** 30).astype(np.int64)

    for s in range(b):
        o = xyz[s, 0]
        bucket = _bucket(cell(((xyz[s] - o).astype(F32) * F32(inv)).astype(
            F32)), table_mask).astype(np.int64)
        bucket[~mask[s]] = table_mask + 1
        order = np.argsort(bucket, kind="stable")
        ptr = np.searchsorted(bucket[order], np.arange(table_mask + 3))
        for j in range(q.shape[1]):
            f = ((q[s, j] - o).astype(F32) * F32(inv)).astype(F32)
            margin = (F32(reach) + F32(2 ** -12)) + np.abs(f) * F32(2 ** -18)
            lo, hi = cell((f - margin).astype(F32)), cell(
                (f + margin).astype(F32))
            span = hi - lo + 1
            if span.prod() > max_cells:
                routes["cells"] += 1
                continue
            c = np.arange(span.prod())
            cube = np.stack([lo[0] + c // (span[2] * span[1]),
                             lo[1] + c // span[2] % span[1],
                             lo[2] + c % span[2]], -1)
            seen = list(dict.fromkeys(_bucket(cube, table_mask).tolist()))
            cand = np.concatenate([order[ptr[t]:ptr[t + 1]] for t in seen])
            if len(cand) > cap:
                routes["cap"] += 1
                continue
            d = (q[s, j] - xyz[s, cand]).astype(F32)
            d2 = ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).astype(F32) +
                  d[:, 2] * d[:, 2]).astype(F32)
            inside = np.sort(cand[d2 <= r2])
            if not len(inside):
                routes["empty"] += 1
                continue
            routes["grid"] += 1
            found = min(len(inside), k)
            idx[s, j] = inside[0]
            idx[s, j, :found] = inside[:found]
            valid[s, j] = np.arange(k) < found
    return idx, valid, routes


@pytest.mark.parametrize("bits", [None, 2])
@pytest.mark.parametrize("name", GRID_NAMES)
def test_ball_grid_route_mirror_matches_plain(name, bits):
    """The grid route's algorithm equals the plain version on every set,
    with the default table and with 4 buckets (every cell collides)."""
    _, xyz, mask, q, radius, k, _ = _set(name)
    got_i, got_v, routes = grid_ball_query(radius, k, xyz, q, mask, bits)
    want_i, want_v = P.ball_query_ref(radius, k, *_t(xyz, q), _t(mask)[0])
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_v, want_v.numpy())
    if name == "grid_edges" and bits is None:
        assert routes == dict(grid=64, cells=0, cap=0, empty=0)
    if name in ("one_point_40k", "radius_past_room"):
        assert routes["cap"] > 0
    if name == "grid_masked":
        assert routes["empty"] > 0


def warp_knn(k, xyz, q, mask, lanes=32):
    """A numpy mirror of K14-NN (``csrc/three_nn.cu``): lane j's share is
    sources j, j + 32, ...; each round a lane keeps the KMAX smallest keys
    (distance, index) of its share above the last key written, and the
    warp takes min(KMAX, what is left) heads in order."""
    kmax = 4 if k <= 4 else 16
    b, n, _ = xyz.shape
    d = P._masked_distance(*_t(q, xyz), _t(mask)[0]).numpy()
    idx = np.zeros(q.shape[:2] + (k,), np.int32)
    dist = np.zeros(q.shape[:2] + (k,), F32)
    for s in range(b):
        for j in range(q.shape[1]):
            keys = list(zip(d[s, j].tolist(), range(n)))
            last, out = (-np.inf, -1), []
            while len(out) < k:
                lists = [sorted(x for x in keys[lane::lanes] if x > last)[
                    :kmax] for lane in range(lanes)]
                for _ in range(min(kmax, k - len(out))):
                    head = min(lst[0] for lst in lists if lst)
                    out.append(head)
                    next(lst for lst in lists if lst and lst[0] == head
                         ).pop(0)
                last = out[-1]
            dist[s, j] = [x[0] for x in out]
            idx[s, j] = [x[1] for x in out]
    return idx, dist


KNN_MIRROR = [(name, k) for name in ("duplicates", "lattice_ties",
                                     "masked_tail_and_all_masked",
                                     "samples_past_valid")
              for k in sorted({1, 3, 16, 17, 32, 64, _set(name)[1].shape[1]})]


@pytest.mark.parametrize("name,k", KNN_MIRROR)
def test_knn_warp_mirror_matches_plain(name, k):
    """K14-NN's algorithm equals the plain version bit for bit at k = 1
    to N on ties, duplicates and masked sources."""
    _, xyz, mask, q, _, _, _ = _set(name)
    got_i, got_d = warp_knn(k, xyz, q, mask)
    want_i, want_d = P.knn_ref(k, *_t(xyz, q), _t(mask)[0])
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_d, want_d.numpy())
