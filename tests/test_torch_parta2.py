"""The port's PartA2 modules against the JAX package: the world-to-box
transform (``box_local_uvw``), the sparse inverse conv with its
rulebook's injectivity, the SparseUNet's outputs, K16's
plain version (``roiaware_pool_ref``, with its gradient), the RoI head's
forward, loss and decode, the proposals' top-k on tied scores, the
samplers on pinned draws, the full-width config and the entry point's
default device. The whole tiny detector (with every module's gradients,
the SparseUNet's among them) and the converter's PartA2 tree are held in
``tests/test_torch_parta2_detector.py``.

Inputs are numpy arrays made from a seed and handed to both packages;
JAX variables are drawn with numpy (``tests/torch_parity.py``) and carried
with ``state_dict_from_jax``. Point and voxel centres are drawn
continuously, so none lies within float32 rounding of a box face (the
fixtures check the margin), and no inside test can flip between XLA:CPU
and PyTorch.

Tolerances (float32, CPU): masks, cells, counts, rulebooks and sampled
indices exact; features and gradients 1e-5 (single operations) or 1e-3
(deep stacks: sums in another order) of their max; losses 1e-4
relative.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.core.bbox import samplers as jsamplers
from isfusion_tpu.models.middle_encoders.sparse_unet import \
    SparseUNet as JaxSparseUNet
from isfusion_tpu.models.roi_heads.part_aggregation_roi_head import \
    PartAggregationROIHead as JaxROIHead
from isfusion_tpu.models.roi_heads.part_aggregation_roi_head import \
    roiaware_pool as jroiaware_pool
from isfusion_tpu.ops import box_ops as jbox_ops
from isfusion_tpu.ops import sparse as jsparse
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.core.bbox.samplers import (IoUNegPiecewiseSampler,
                                                   PseudoSampler)
from isfusion_tpu_torch.models.detectors.parta2 import select_proposals
from isfusion_tpu_torch.models.middle_encoders.sparse_unet import SparseUNet
from isfusion_tpu_torch.models.roi_heads.part_aggregation_roi_head import \
    PartAggregationROIHead
from isfusion_tpu_torch.ops import box_ops, sparse_conv
from isfusion_tpu_torch.ops.roiaware_pool import (roiaware_cells_ref,
                                                  roiaware_pool,
                                                  roiaware_pool_state)
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from torch_parity import assert_close_to_max, load_from_jax, random_variables


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def _random_boxes(rng, b, n, lo=-4.0, hi=4.0):
    boxes = np.zeros((b, n, 7), np.float32)
    boxes[..., :2] = rng.uniform(lo, hi, (b, n, 2))
    boxes[..., 2] = rng.uniform(-1.5, -0.5, (b, n))
    boxes[..., 3:6] = rng.uniform(0.8, 4.0, (b, n, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    return boxes


def _face_margin(uvw: np.ndarray) -> float:
    """The smallest distance of a normalised coordinate from 0 or 1."""
    return float(np.minimum(np.abs(uvw), np.abs(uvw - 1.0)).min())


# ------------------------------------------------------------ box_local_uvw
def test_box_local_uvw_matches_jax():
    rng = np.random.default_rng(0)
    boxes = _random_boxes(rng, 2, 6)
    boxes[0, 0, 3:6] = 0.0                  # a degenerate box: dims 1e-3
    pts = rng.uniform(-5, 5, (2, 300, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 1, (2, 300))
    want_uvw, want_in = jbox_ops.box_local_uvw(jnp.asarray(boxes),
                                               jnp.asarray(pts))
    got_uvw, got_in = box_ops.box_local_uvw(torch.from_numpy(boxes),
                                            torch.from_numpy(pts))
    assert _face_margin(np.asarray(want_uvw)) > 1e-4
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    assert 0 < int(np.asarray(want_in).sum()) < want_in.size
    assert_close_to_max(got_uvw.numpy(), np.asarray(want_uvw), 1e-6)


# -------------------------------------------------------- sparse inverse conv
def _site_sets(rng, b, v, grid, fill=(0.7, 0.9)):
    """(coords (B, V, 3) zyx sorted by linear id with the padding at the
    tail, mask (B, V)): a random number of distinct sites per sample."""
    nz, ny, nx = grid
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        n = int(v * rng.uniform(*fill))
        ids = np.sort(rng.choice(nz * ny * nx, n, replace=False))
        coords[i, :n] = np.stack([ids // (ny * nx), ids // nx % ny,
                                  ids % nx], -1)
        mask[i, :n] = True
    return coords, mask


def _port_table(coords, mask, feats, grid):
    """The port's site table of a padded (B, V, ...) set."""
    bi = np.nonzero(mask)[0]
    c = np.concatenate([bi[:, None], coords[mask]], -1)
    return sparse_conv.build_sparse(torch.from_numpy(feats[mask]),
                                    torch.from_numpy(c), grid,
                                    coords.shape[0])


def test_inverse_conv_matches_jax():
    """The inverse conv onto a saved site table (the JAX
    ``sparse_inverse_conv3d``) through ``SparseConvFunction`` (K12's
    gathers, here their plain versions), the JAX kernel carried by the
    converter's spconv layout (not flipped): outputs 1e-5 of their max,
    dX and dW against autograd of the plain version; the rulebook injective
    per tap (what the backward's transpose assumes)."""
    rng = np.random.default_rng(1)
    grid, b, v, cin, cout = (9, 14, 12), 2, 300, 8, 8
    coords, mask = _site_sets(rng, b, v, grid)
    x = rng.normal(size=(b, v, cin)).astype(np.float32)
    w_down = rng.normal(0, 0.2, (3, 3, 3, cin, cin)).astype(np.float32)
    w_up = rng.normal(0, 0.2, (3, 3, 3, cin, cout)).astype(np.float32)

    def jax_side(x, w_down, w_up):
        def one(f, c, m):
            sp = jsparse.build_sparse_grid(f, c, m, grid, assume_sorted=True)
            low = jsparse.sparse_conv3d(sp, w_down, 2, 1, 8 * v)
            return low, jsparse.sparse_inverse_conv3d(low, sp, w_up, 2, 1)
        return jax.vmap(one)(x, jnp.asarray(coords), jnp.asarray(mask))

    low, want = jax.jit(jax_side)(x, w_down, w_up)
    target = _port_table(coords, mask, x, grid)
    low_grid = tuple((g + 2 - 3) // 2 + 1 for g in grid)
    low_t, _, _ = sparse_conv.strided_rulebook(target, 3, 2, 1)
    lmask = np.asarray(low.mask)
    low_t = low_t._replace(feats=torch.from_numpy(
        np.asarray(low.feats)[lmask]).requires_grad_())
    assert low_t.shape == low_grid and low_t.feats.shape[0] == lmask.sum()
    rows, found = sparse_conv.inverse_rulebook(low_t, target, 3, 2, 1)
    assert sparse_conv.rulebook_is_injective(rows, found)
    # every found pair reads the low site l with l * 2 - 1 + k == h
    k = torch.arange(27)
    taps = torch.stack([k // 9, k // 3 % 3, k % 3], -1)
    lo = low_t.coords[rows.long()].long()
    hi = target.coords.long()[:, None, :]
    assert torch.equal(lo[..., 0][found], hi[..., 0].expand_as(found)[found])
    assert ((lo[..., 1:] * 2 - 1 + taps)[found] == hi[..., 1:].expand(
        -1, 27, -1)[found]).all()
    sd = state_dict_from_jax({"params": {"middle_encoder_m": {
        "decoder_up0": {"kernel": w_up}}}})
    weight = sd["middle_encoder.decoder_up0.0.weight"].requires_grad_()
    got = sparse_conv.SparseConvFunction.apply(low_t.feats, rows, found,
                                               weight)
    assert_close_to_max(got.detach().numpy(), np.asarray(want)[mask], 1e-5)
    plain = sparse_conv.sparse_conv_plain(low_t.feats, rows, found, weight)
    dy = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
    g_fn = torch.autograd.grad(got, (low_t.feats, weight), dy)
    g_plain = torch.autograd.grad(plain, (low_t.feats, weight), dy)
    for a, p in zip(g_fn, g_plain):
        assert_close_to_max(a.numpy(), p.numpy(), 1e-5)


def test_inverse_rulebook_of_a_strided_conv_is_its_transpose():
    """Each found (target h, tap k, low l) pair of the inverse rulebook is a
    found (output l, tap k, input h) pair of the strided rulebook that made
    the low table, and the other way round."""
    rng = np.random.default_rng(2)
    grid = (7, 10, 9)
    coords, mask = _site_sets(rng, 3, 120, grid, fill=(0.2, 0.6))
    target = _port_table(coords, mask, np.zeros((3, 120, 1), np.float32),
                         grid)
    low, srows, sfound = sparse_conv.strided_rulebook(target, 3, 2, 1)
    irows, ifound = sparse_conv.inverse_rulebook(low, target, 3, 2, 1)
    fwd = {(int(h), k, o) for o, k in zip(*torch.nonzero(sfound, as_tuple=True)
                                          ) for h in [srows[o, k]]}
    inv = {(h, k, int(irows[h, k])) for h, k in zip(
        *[t.tolist() for t in torch.nonzero(ifound, as_tuple=True)])}
    fwd = {(h, int(k), int(o)) for h, k, o in fwd}
    assert fwd == inv and len(inv) > 100
    assert sparse_conv.rulebook_is_injective(irows, ifound)
    assert sparse_conv.rulebook_is_injective(srows, sfound)


# ---------------------------------------------------------------- SparseUNet
UNET_CFG = dict(in_channels=4, sparse_shape=(9, 20, 24), base_channels=8,
                output_channels=8, encoder_channels=((8,), (8,)),
                encoder_paddings=((1,), ((0, 1, 1),)),
                decoder_channels=((8, 8, 8), (8, 8, 8)),
                stage_cap_ratios=(8.0, 8.0))


@pytest.fixture(scope="module")
def unet_case():
    """The JAX SparseUNet (2 stages: an inverse-conv level and a
    same-grid level) on 2 samples of ~200 voxels, its outputs in eval mode
    (running statistics) and in train mode (batch statistics), in one
    jit. Its gradients are held inside the whole detector's
    (``tests/test_torch_parta2_detector.py``: ``middle_encoder``)."""
    rng = np.random.default_rng(3)
    grid, b, v = UNET_CFG["sparse_shape"], 2, 256
    coords, mask = _site_sets(rng, b, v, grid)
    feats = np.where(mask[..., None], rng.normal(size=(b, v, 4)),
                     0).astype(np.float32)
    jm = JaxSparseUNet(**UNET_CFG)
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask))
    variables = random_variables(jm, *args, train=False)

    def run(v, f):
        train_out, _ = jm.apply(v, f, *args[1:], train=True,
                                mutable=["batch_stats"])
        return jm.apply(v, f, *args[1:], train=False), train_out

    outs = jax.device_get(jax.jit(run)(variables, args[0]))
    port = load_from_jax(SparseUNet(**UNET_CFG), variables,
                         "middle_encoder_m", "middle_encoder")
    bi = np.nonzero(mask)[0]
    coors = torch.from_numpy(np.concatenate([bi[:, None], coords[mask]], -1))
    return dict(mask=mask, feats=feats, coors=coors, outs=outs, port=port)


@pytest.mark.parametrize("train", [False, True])
def test_sparse_unet_outputs_match(unet_case, train):
    c = unet_case
    stats = {}
    port = c["port"].train(train)
    try:
        with torch.no_grad():
            out = port(torch.from_numpy(c["feats"][c["mask"]]), c["coors"],
                       2, return_stats=stats)
    finally:
        port.eval()
    want = c["outs"][int(train)]
    assert_close_to_max(out["spatial_features"].numpy(),
                        want["spatial_features"], 1e-4)
    assert_close_to_max(out["seg_features"].numpy(),
                        want["seg_features"][c["mask"]], 1e-4)
    assert stats["active_sites"][0] == int(c["mask"].sum())
    assert port.upsample == [True, False]


# ---------------------------------------------------------- K16, plain version
def _pool_case(seed, b=2, r=7, v=400, c=5):
    rng = np.random.default_rng(seed)
    rois = _random_boxes(rng, b, r, -3, 3)
    rois[0, 1] = rois[0, 0]                      # identical RoIs
    rois[1, 2, :2] = 40.0                        # an empty RoI
    centers = rng.uniform(-5, 5, (b, v, 3)).astype(np.float32)
    centers[..., 2] = rng.uniform(-2, 1.5, (b, v))
    feats = rng.normal(size=(b, v, c)).astype(np.float32)
    mask = rng.uniform(size=(b, v)) < 0.8
    return rois, centers, feats, mask


@pytest.mark.parametrize("grid", [4, 6])
def test_roiaware_pool_plain_matches_jax(grid):
    """Pooled means (overlapping, identical and empty RoIs, masked
    voxels) and the gradient with respect to the features: JAX's
    ``jax.grad`` against the port's autograd."""
    rois, centers, feats, mask = _pool_case(4 + grid)
    uvw, _ = jbox_ops.box_local_uvw(jnp.asarray(rois), jnp.asarray(centers))
    assert _face_margin(np.asarray(uvw) * grid) > 1e-4
    dy = np.random.default_rng(5).normal(
        size=(2, 7, grid, grid, grid, 5)).astype(np.float32)

    def jax_loss(f):
        pooled = jax.vmap(lambda r, c, f, m: jroiaware_pool(r, c, f, m, grid))(
            jnp.asarray(rois), jnp.asarray(centers), f, jnp.asarray(mask))
        return jnp.sum(pooled * dy), pooled

    (_, want), dwant = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_()
    got = roiaware_pool(torch.from_numpy(rois), torch.from_numpy(centers), f,
                        torch.from_numpy(mask), grid)
    assert got.shape == (2, 7, grid, grid, grid, 5)
    assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-6)
    assert float(got[1, 2].detach().abs().max()) == 0.0
    assert torch.equal(got[0, 0], got[0, 1])
    (got * torch.from_numpy(dy)).sum().backward()
    assert_close_to_max(f.grad.numpy(), np.asarray(dwant), 1e-6)
    assert float(f.grad[~torch.from_numpy(mask)].abs().max()) == 0.0
    # the cell map against a direct transcription of JAX's binning
    cells = roiaware_cells_ref(torch.from_numpy(rois),
                               torch.from_numpy(centers),
                               torch.from_numpy(mask), grid).numpy()
    np.testing.assert_array_equal(cells, _jax_cells(rois, centers, mask,
                                                    grid))


def _jax_cells(rois, centers, mask, grid):
    """(B, R, V) the cell of each valid voxel inside each RoI, -1
    elsewhere, binned as JAX's ``roiaware_pool`` bins."""
    uvw, inside = jbox_ops.box_local_uvw(jnp.asarray(rois),
                                         jnp.asarray(centers))
    ju = np.moveaxis(np.asarray(uvw), 1, 2)              # (B, R, V, 3)
    jin = np.moveaxis(np.asarray(inside), 1, 2) & mask[:, None, :]
    ijk = np.clip((ju * grid).astype(np.int32), 0, grid - 1)
    jcell = (ijk[..., 0] * grid + ijk[..., 1]) * grid + ijk[..., 2]
    return np.where(jin, jcell, -1)


def test_roiaware_pool_state_lists_the_inside_pairs():
    """The plain side of K16's check entry (what the forward kernel's
    counts and compacted list must equal): each RoI's cell counts, and
    its inside voxels as v G^3 + cell in voxel order, then -1, against
    JAX's binning; the pooled features are ``roiaware_pool``'s."""
    grid = 4
    rois, centers, feats, mask = _pool_case(7)
    t = [torch.from_numpy(a) for a in (rois, centers, feats, mask)]
    pooled, counts, entries = roiaware_pool_state(*t, grid)
    assert torch.equal(pooled, roiaware_pool(*t, grid))
    assert counts.dtype == torch.int32 and entries.shape == (2, 7, 400)
    jcell = _jax_cells(rois, centers, mask, grid)
    assert (jcell >= 0).sum() > 50
    for b in range(2):
        for r in range(7):
            vs = np.nonzero(jcell[b, r] >= 0)[0]
            np.testing.assert_array_equal(
                entries[b, r, :len(vs)].numpy(),
                vs * grid ** 3 + jcell[b, r, vs])
            assert (entries[b, r, len(vs):] == -1).all()
            np.testing.assert_array_equal(counts[b, r].numpy(), np.bincount(
                jcell[b, r, vs], minlength=grid ** 3))


def test_roiaware_pool_edge_cases():
    """No RoI, no voxel, every voxel masked."""
    rois, centers, feats, mask = _pool_case(9)
    t = [torch.from_numpy(a) for a in (rois, centers, feats, mask)]
    assert roiaware_pool(t[0][:, :0], *t[1:], 4).shape == (2, 0, 4, 4, 4, 5)
    empty = roiaware_pool(t[0], t[1][:, :0], t[2][:, :0], t[3][:, :0], 4)
    assert empty.shape == (2, 7, 4, 4, 4, 5) and not empty.any()
    assert not roiaware_pool(*t[:3], torch.zeros_like(t[3]), 4).any()
    with pytest.raises(ValueError, match="rois"):
        roiaware_pool(t[0][0], *t[1:], 4)


# --------------------------------------------------------------- RoI head
@pytest.fixture(scope="module")
def roi_head_case():
    rng = np.random.default_rng(11)
    b, r, v, c, g = 2, 12, 300, 12, 4
    gts = _random_boxes(rng, b, 5, -3, 3)
    gt_mask = np.array([[1, 1, 1, 0, 1], [1, 1, 0, 0, 0]], bool)
    # RoIs: jittered GTs (positives at several IoUs) and random boxes
    rois = _random_boxes(rng, b, r, -3, 3)
    pick = rng.integers(0, 5, (b, 6))
    rois[:, :6] = np.take_along_axis(gts, pick[..., None], 1)
    rois[:, :6, :3] += rng.normal(0, 0.15, (b, 6, 3)).astype(np.float32)
    rois[:, :6, 6] += rng.normal(0, 0.1, (b, 6)).astype(np.float32)
    roi_mask = rng.uniform(size=(b, r)) < 0.85
    centers = rng.uniform(-4, 4, (b, v, 3)).astype(np.float32)
    centers[..., 2] = rng.uniform(-2, 1.5, (b, v))
    feats = rng.normal(size=(b, v, c)).astype(np.float32)
    vmask = rng.uniform(size=(b, v)) < 0.9
    args = [jnp.asarray(a) for a in (rois, roi_mask, centers, feats, vmask)]
    jhead = JaxROIHead(grid_size=g, in_channels=c, shared_channels=(16, 16))
    variables = random_variables(jhead, *args)
    labels = np.zeros((b, 5), np.int64)

    def run(v, args):
        preds = jhead.apply(v, *args)
        return preds, jhead.apply(
            v, preds, jnp.asarray(gts), jnp.asarray(labels),
            jnp.asarray(gt_mask), method=JaxROIHead.loss), \
            jhead.apply(v, preds, method=JaxROIHead.get_bboxes)

    preds, jloss, jdec = jax.jit(run)(variables, args)
    port = load_from_jax(PartAggregationROIHead(
        grid_size=g, in_channels=c, shared_channels=(16, 16)), variables,
        "roi_head_m", "roi_head")
    tpreds = port(*[torch.from_numpy(a) for a in (rois, roi_mask, centers,
                                                  feats, vmask)])
    return dict(preds=preds, jloss=jloss, jdec=jdec, tpreds=tpreds,
                tloss=port.loss(tpreds, torch.from_numpy(gts),
                                torch.from_numpy(labels),
                                torch.from_numpy(gt_mask)),
                tdec=port.get_bboxes(tpreds), gts=gts, rois=rois)


def test_roi_head_forward_matches(roi_head_case):
    c = roi_head_case
    for k in ("cls_score", "bbox_pred"):
        assert_close_to_max(c["tpreds"][k].detach().numpy(),
                            np.asarray(c["preds"][k]), 1e-5)


def test_roi_head_loss_matches(roi_head_case):
    """Both terms, with positives above ``pos_iou_thr`` in the batch (the
    first best GT on ties, K10's plain version for the IoUs)."""
    c = roi_head_case
    iou = box_ops.boxes_iou_3d(torch.from_numpy(c["rois"]),
                               torch.from_numpy(c["gts"]))
    assert int((iou.max(-1).values > 0.55).sum()) >= 3
    assert set(c["tloss"]) == {"loss_roi_cls", "loss_roi_reg"}
    for k, v in c["tloss"].items():
        assert float(v) > 0 and _rel(v, c["jloss"][k]) <= 1e-4, k


def test_roi_head_decode_matches(roi_head_case):
    c = roi_head_case
    np.testing.assert_array_equal(c["tdec"]["mask"].numpy(),
                                  np.asarray(c["jdec"]["mask"]))
    for k in ("bboxes", "scores"):
        assert_close_to_max(c["tdec"][k].detach().numpy(),
                            np.asarray(c["jdec"][k]), 1e-5)


def test_proposals_top_k_on_ties_matches_jax():
    """Fewer valid proposals than ``num_proposals``: the masked scores are
    0 and tie, and the port's stable sort takes them in ``jax.lax.top_k``'s
    order (the lower index first)."""
    rng = np.random.default_rng(12)
    scores = rng.uniform(0.1, 1, (2, 40)).astype(np.float32)
    mask = rng.uniform(size=(2, 40)) < 0.3
    scores = np.where(mask, scores, 0).astype(np.float32)
    scores[1, 5] = scores[1, 9] = scores[1, 3]
    bboxes = rng.normal(size=(2, 40, 7)).astype(np.float32)
    det = dict(bboxes=torch.from_numpy(bboxes), scores=torch.from_numpy(
        scores), mask=torch.from_numpy(mask))
    topi, rois, roi_mask = select_proposals(det, 24)
    assert int(roi_mask.sum(1).max()) < 24
    topv, want = jax.lax.top_k(jnp.asarray(scores), 24)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        roi_mask.numpy(), np.take_along_axis(mask, np.asarray(want), 1) &
        (np.asarray(topv) > 0))
    np.testing.assert_array_equal(rois.numpy(), np.take_along_axis(
        bboxes, np.asarray(want)[..., None], 1))


# ------------------------------------------------------------------ samplers
def _sampler_case(seed, n=48):
    rng = np.random.default_rng(seed)
    gt_inds = rng.integers(0, 4, n)
    gt_inds[rng.uniform(size=n) < 0.5] = 0
    overlaps = rng.uniform(0, 0.7, n).astype(np.float32)
    draws = [rng.uniform(size=n).astype(np.float32) for _ in range(4)]
    return gt_inds, overlaps, draws


@pytest.mark.parametrize("num, seed", [(16, 13), (32, 14), (64, 15)])
def test_iou_neg_piecewise_sampler_matches_jax_on_pinned_draws(
        monkeypatch, num, seed):
    """The same uniform priorities on both sides (the JAX draws patched in
    call order: positives, each band, the top-off), with bands short of
    their budget at the larger ``num``: equal indices and masks."""
    gt_inds, overlaps, draws = _sampler_case(seed)
    queue = list(draws)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(queue.pop(0)))
    kw = dict(num=num, neg_piece_fractions=(0.8, 0.2),
              neg_iou_piece_thrs=(0.55, 0.1), return_iou=True)
    want = jsamplers.IoUNegPiecewiseSampler(**kw).sample(
        jax.random.PRNGKey(0), jnp.asarray(gt_inds), jnp.asarray(overlaps))
    assert not queue
    pinned = iter(draws)
    got = IoUNegPiecewiseSampler(**kw).sample(
        torch.from_numpy(gt_inds), torch.from_numpy(overlaps),
        draw=lambda size: torch.from_numpy(next(pinned)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    valid_neg = got["neg_inds"][got["neg_valid"]]
    assert valid_neg.unique().numel() == valid_neg.numel()
    assert (torch.from_numpy(gt_inds)[valid_neg] == 0).all()


def test_samplers_draw_from_their_generator():
    gt_inds, overlaps, _ = _sampler_case(16)
    s = IoUNegPiecewiseSampler(num=16)
    a, b = (s.sample(torch.from_numpy(gt_inds), torch.from_numpy(overlaps),
                     torch.Generator().manual_seed(7)) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = s.sample(torch.from_numpy(gt_inds), torch.from_numpy(overlaps),
                 torch.Generator().manual_seed(8))
    assert not all(torch.equal(a[k], c[k]) for k in a)
    want = jsamplers.PseudoSampler().sample(None, jnp.asarray(gt_inds))
    got = PseudoSampler().sample(torch.from_numpy(gt_inds))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# -------------------------------------------------------- configs, device
def test_full_width_cfg_is_mvxnets_kitti_settings():
    cfg = tflagship.parta2_model_cfg()
    assert cfg["voxel_layer"] == dict(
        max_num_points=5, point_cloud_range=[0, -40, -3, 70.4, 40, 1],
        voxel_size=[0.05, 0.05, 0.1], max_voxels=(16000, 40000))
    unet = SparseUNet(**{k: v for k, v in cfg["middle_encoder"].items()
                         if k != "type"})
    assert unet.sparse_shape == (41, 1600, 1408) and unet.out_depth == 2
    assert unet.upsample == [True, True, True, False]
    assert unet.seg_channels == 16
    assert cfg["rpn_head"]["num_classes"] == 3 and \
        cfg["rpn_head"]["in_channels"] == 512
    assert cfg["test_cfg"]["rpn"]["nms_pre"] == 1024 and \
        cfg["num_proposals"] == cfg["test_cfg"]["rpn"]["max_num"] == 100
    opt = tflagship.parta2_optim_cfg()
    assert opt["optimizer"]["betas"] == (0.95, 0.99) and \
        opt["optimizer_config"]["grad_clip"]["max_norm"] == 10


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tflagship.build_parta2(tiny=True)
    assert os.path.isfile(tflagship.MVXNET_CFG)
