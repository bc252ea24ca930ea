"""The port's kernels on the card, against their plain PyTorch versions.

Every test needs an NVIDIA GPU with nvcc and skips elsewhere. This file
imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact for the gather (a copy); 1e-5 for the rotated IoU
kernel against its plain version, batched or not; NMS keep masks equal
to the plain greedy walk over the kernel's own suppression bits, those
bits equal to the plain IoU's more than 1e-5 from the threshold, and keep
masks equal to the plain version's when no pair is that close, the bits
symmetric; circle-NMS keep masks and gaussian heatmaps equal to their
plain versions (the positives, cells at 1.0, included), circle NMS and
K10 one device operation a call, the IoU exactly 0 wherever its
plain version is; K1's rows,
voxel table and point lists (``voxel_ptr``, ``point_order``; also
``segment_layout``'s) equal to its plain version's; K2's max, forward and
backward, equal to its plain version's with or without a list, its mean
equal to the plain version's on the CPU (the same sum order), equal over
two calls, and within 1e-6 of the output's max of the plain version's on
the card (``index_add_`` sums in atomic order); 1e-5 of
the max for the sparse conv's
K12 backward against plain autograd on the CPU, 1e-3 of the max for the
tiny flagship on the card against the CPU, 1e-4 of the max for the tiny
PointPillars' and CenterPoint's kept boxes (the same entries and
labels), and 1e-4 relative for the tiny train steps' losses (float32, TF32
off: sums run in another order); the tiny MVX-Net as the tiny
PointPillars. In a process group of one NCCL rank: a sync norm launches
no collective and equals the plain norm bit for bit, and the tiny
PointPillars' DP step equals the plain step (losses 1e-4 relative,
parameters 1e-3 of each module's max) with one all-reduce. K16 (RoI-aware
pooling): the (r, v) -> cell map and the cell counts equal to the plain
version's on the card, pooled features and dfeats within 1e-6 of their
max (the plain version sums with atomics), two calls bit-equal, no host
synchronisation, the saved membership bitmap equal to the plain one; the
sparse inverse conv through K12 on the card within 1e-5 of the max of the
CPU's. The KITTI evaluator's K10-BEV and K10 calls as above (1e-5, exact
zeros, one launch a call) and its metrics equal to the CPU's to 1e-12;
the tiny ImVoxelNet's head outputs and kept boxes 1e-3 of their max. On
degenerate boxes (zero-size, an infinite side times a zero one, past
float32's range) K10 and K10-BEV within 1e-5 of the plain value (or of 1)
with NaN and infinities where the plain version has them, K10-NMS's bits
equal to the plain IoU's in both orders of each pair. K14 (the PointNet++
ops) on ``testing.point_op_sets`` and VoteNet's first-level shapes:
FPS (by every route: one block, clusters of 8 and 16), ball-query (by
every route: the scan, the cell grid, the grid with 4 buckets) and K-NN
(k = 1 to N) indices, valid flags and distances equal to the plain versions',
the gathers equal forward (rows of 1-130 floats, an unaligned view;
no-grad and grad calls alike), their gradients within 1e-6 of the max
of plain autograd's and equal over two calls, the features' gradient
equal to the sums in slot order (the backward's list, rows of up to
3,000 slots), the list counted apart from K2's; the tiny VoteNet
and H3DNet on the card against the CPU as the tiny ImVoxelNet (losses
1e-4 relative, gradients 1e-3 of their max). On the NaN set
(``testing.NAN_SETS``) K14-FPS by every route and K14-NN by both
instances and its rounds past 16: indices equal, distances NaN where the
plain version's are, every index inside [0, N). K15 (``ops/paconv.py``):
K15-bank and K15-score forward and every gradient within 1e-5 of the max
of the plain version's float64 values on adversarial sets (zero rows, M
= 1, O off the tiles, odd C, one row; repeated indices, a row named by
every slot, rows named by none), the gradients bit-equal over two calls;
the tiny segmentors on the card against the CPU as the tiny VoteNet. K17
(``ops/sst_window.py``): the partition bit-equal to its plain version on
``testing.sst_partition_sets`` (random, clustered, masked, several
samples, binding caps, 3-D and 2-D windows, one voxel; both shifts), the
three moves' forward and gradients equal to plain autograd (rows of 16-,
10- and 6-byte widths, float32 and bfloat16); the tiny SSTv2Sparse on the
card against the CPU as the tiny VoteNet (canvas and gradients 1e-3 of
their max); TransFusionHeadV2's per-task circle and rotate NMS on the card
against the CPU (masks equal, scores 1e-6).
"""
import contextlib

import pytest
import torch

import numpy as np

from isfusion_tpu_torch.ops import (box_ops, cuda_build, gaussian, scatter,
                                    sparse_conv, voxel)
from isfusion_tpu_torch.ops import pointnet_ops as pn
from isfusion_tpu_torch.ops.gather import masked_gather, masked_gather_ref
from isfusion_tpu_torch.testing import (NAN_SETS, POINT_SET_ROWS,
                                       degenerate_box_sets, fps_large_cloud,
                                       iou_undetermined, offset_rows,
                                       point_op_sets, slot_order_grad)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,f,n,kept", [(5000, 64, 27 * 4000, 0.3),
                                        (300, 8, 1, 1.0),
                                        (7, 1536, 999, 0.5)])
def test_masked_gather_kernel_matches_plain_version(card, dtype, v, f, n,
                                                    kept):
    gen = torch.Generator().manual_seed(v + n)
    src = torch.randn((v, f), generator=gen).to(getattr(torch, dtype))
    idx = torch.randint(0, v, (n,), generator=gen, dtype=torch.int32)
    fmask = torch.rand(n, generator=gen) < kept
    src, idx, fmask = src.to(card), idx.to(card), fmask.to(card)
    before = cuda_build.LAUNCHES["masked_gather"]
    got = masked_gather(src, idx, fmask)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["masked_gather"] == before + 1
    assert torch.equal(got, masked_gather_ref(src, idx, fmask))


def test_masked_gather_empty_launches_nothing(card):
    src = torch.randn((10, 8), device=card)
    idx = torch.zeros(0, dtype=torch.int32, device=card)
    fmask = torch.zeros(0, dtype=torch.bool, device=card)
    before = cuda_build.LAUNCHES["masked_gather"]
    assert masked_gather(src, idx, fmask).shape == (0, 8)
    assert cuda_build.LAUNCHES["masked_gather"] == before


def test_masked_gather_rejects_mixed_devices(card):
    src = torch.randn((10, 8), device=card)
    idx = torch.zeros(4, dtype=torch.int32)
    fmask = torch.ones(4, dtype=torch.bool, device=card)
    with pytest.raises(ValueError):
        masked_gather(src, idx, fmask)


def test_tiny_flagship_on_card_matches_cpu(card):
    from isfusion_tpu_torch.flagship import build_isfusion_flagship

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu, batch_fn = build_isfusion_flagship(tiny=True, device="cuda", seed=2)
    cpu, _ = build_isfusion_flagship(tiny=True, device="cpu", seed=2)
    batch = batch_fn(1, seed=5)
    before = dict(cuda_build.LAUNCHES)
    pg, _ = gpu(batch, mode="feats", device="cuda")
    assert cuda_build.LAUNCHES["masked_gather"] > before["masked_gather"]
    # one voxelization, whose lists every voxel mean and max take
    assert cuda_build.LAUNCHES["dynamic_voxelize"] == \
        before["dynamic_voxelize"] + 1
    assert cuda_build.LAUNCHES["dynamic_scatter"] > before["dynamic_scatter"]
    assert cuda_build.LAUNCHES["segment_layout"] == before["segment_layout"]
    pc, _ = cpu(batch, mode="feats", device="cpu")
    want = pc["dense_heatmap"]
    err = (pg["dense_heatmap"].cpu() - want).abs().max() / want.abs().max()
    assert err <= 1e-3


def _boxes(gen, n, r=50.0):
    b = torch.empty((n, 7))
    b[:, :2] = (torch.rand((n, 2), generator=gen) * 2 - 1) * r
    b[:, 2] = -torch.rand(n, generator=gen) * 2
    b[:, 3:6] = 0.5 + torch.rand((n, 3), generator=gen) * 4
    b[:, 6] = (torch.rand(n, generator=gen) * 2 - 1) * np.pi
    return b


def test_boxes_iou_3d_kernel_matches_plain_version(card):
    gen = torch.Generator().manual_seed(0)
    a = _boxes(gen, 200)
    b = a[torch.randperm(200, generator=gen)[:64]] + \
        torch.randn((64, 7), generator=gen) * 0.3
    b[:, 3:6] = b[:, 3:6].abs() + 0.1
    b[:4] = a[:4]                                  # identical pairs
    a, b = a.to(card), b.to(card)
    before = cuda_build.LAUNCHES["boxes_iou_3d"]
    got = box_ops.boxes_iou_3d(a, b)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["boxes_iou_3d"] == before + 1
    want = box_ops.boxes_iou_3d_ref(a, b)
    assert (want > 0.1).sum() >= 64
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got[range(4), range(4)] - 1).abs().max()) <= 1e-5


# cin 5: CenterPoint's point features, padded to K12's 16-byte rows
@pytest.mark.parametrize("cin", [16, 5])
@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_sparse_conv_backward_on_card_matches_cpu(card, kind, cin):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    grid = (21, 64, 64)
    cells = torch.randperm(int(np.prod(grid)), generator=gen)[:3000]
    coords = torch.stack([torch.zeros_like(cells), cells // (64 * 64),
                          (cells // 64) % 64, cells % 64], -1)
    feats = torch.randn((3000, cin), generator=gen)
    sp = sparse_conv.build_sparse(feats, coords, grid, 1)
    if kind == "subm":
        rows, found = sparse_conv.subm_rulebook(sp)
    else:
        _, rows, found = sparse_conv.strided_rulebook(sp, 3, 2, 1)
    w0 = torch.randn((32, 3, 3, 3, cin), generator=gen)
    dy = torch.randn((rows.shape[0], 32), generator=gen)
    res = []
    for dev in ("cpu", card):
        x = sp.feats.to(dev).detach().requires_grad_(True)
        w = w0.to(dev).detach().requires_grad_(True)
        before = cuda_build.LAUNCHES["masked_gather"]
        out = sparse_conv.sparse_conv(x, rows.to(dev), found.to(dev), w)
        (out * dy.to(dev)).sum().backward()
        launched = cuda_build.LAUNCHES["masked_gather"] - before
        res.append((out.detach().cpu(), x.grad.cpu(), w.grad.cpu(),
                    launched))
    assert res[0][3] == 0 and res[1][3] == 3   # forward, dX, dW
    for got, want in zip(res[1][:3], res[0][:3]):
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= 1e-5


def test_tiny_train_step_on_card_matches_cpu(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic kernels: the tiny model's top-k turns the rounding of
    # atomics into discrete choices
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        metrics = _tiny_train_step_metrics()
    finally:
        torch.use_deterministic_algorithms(False)
    for k, want in metrics[0].items():
        assert abs(metrics[1][k] - want) <= 1e-4 * max(abs(want), 1e-6), k


def _tiny_train_step_metrics():
    from isfusion_tpu_torch.flagship import build_isfusion_flagship
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer

    metrics = []
    for dev in ("cpu", "cuda"):
        # no dropout: the two devices draw different numbers
        model, batch_fn = build_isfusion_flagship(tiny=True, device=dev,
                                                  seed=3, dropout=False)
        model.train()
        opt = build_optimizer(model, dict(type="AdamW", lr=1e-4))
        step = make_train_step(model, opt)
        before = dict(cuda_build.LAUNCHES)
        m = step(batch_fn(2, seed=4), torch.Generator(dev).manual_seed(0))
        metrics.append({k: float(v) for k, v in m.items()})
        if dev == "cuda":
            assert all(cuda_build.LAUNCHES[k] > before[k]
                       for k in ("masked_gather", "boxes_iou_3d"))
    return metrics


def test_boxes_iou_3d_batched_kernel_matches_plain_version(card):
    """K10 over a step's samples in one launch: (4, 200, 7) x (4, 64, 7)."""
    gen = torch.Generator().manual_seed(5)
    a = torch.stack([_boxes(gen, 200) for _ in range(4)])
    b = a[:, torch.randperm(200, generator=gen)[:64]] + \
        torch.randn((4, 64, 7), generator=gen) * 0.3
    b[..., 3:6] = b[..., 3:6].abs() + 0.1
    a, b = a.to(card), b.to(card)
    before = cuda_build.LAUNCHES["boxes_iou_3d"]
    got = box_ops.boxes_iou_3d(a, b)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["boxes_iou_3d"] == before + 1
    want = box_ops.boxes_iou_3d_ref(a, b)
    assert got.shape == (4, 200, 64) and (want > 0.1).sum() >= 4 * 32
    assert float((got - want).abs().max()) <= 1e-5
    for s in range(4):
        assert float((box_ops.boxes_iou_3d(a[s], b[s]) - got[s]).abs()
                     .max()) == 0.0


def _nms_inputs(gen, b, c, k):
    boxes = torch.empty((b, k, 5))
    boxes[..., :2] = (torch.rand((b, k, 2), generator=gen) * 2 - 1) * 30
    boxes[..., 2:4] = 0.5 + torch.rand((b, k, 2), generator=gen) * 4
    boxes[..., 4] = (torch.rand((b, k), generator=gen) * 2 - 1) * np.pi
    boxes[:, k // 2:k // 2 + 20] = boxes[:, :20]          # identical boxes
    boxes[:, k // 2 + 20:k // 2 + 40, 4] += np.pi / 4     # 45 degrees
    scores = torch.rand((b, c, k), generator=gen)
    scores[:, :, :10] = 0.5                               # ties
    return boxes, scores, scores > 0.2


# K at the pairwise pass's tile edges and the greedy pass's chunk edges
@pytest.mark.parametrize("b,c,k", [(2, 10, 1000), (1, 3, 77), (3, 1, 1),
                                   (1, 32, 300), (1, 3, 63), (2, 2, 64),
                                   (1, 4, 65), (1, 5, 129)])
def test_nms_bev_kernel_matches_plain_version(card, b, c, k):
    gen = torch.Generator().manual_seed(k)
    boxes, scores, valid = (t.to(card) for t in _nms_inputs(gen, b, c, k))
    _check_nms(boxes, scores, valid)


@pytest.mark.parametrize("kind", ["cluster", "sparse"])
def test_nms_bev_kernel_where_every_or_no_circle_meets(card, kind):
    """1,000 boxes within 3 m (every pair computed) or on a 10 m grid (the
    circle cut drops every pair but the diagonal)."""
    from isfusion_tpu_torch.testing import nms_cluster_set, nms_sparse_set

    make = nms_cluster_set if kind == "cluster" else nms_sparse_set
    boxes, scores, valid = (t.to(card) for t in
                            make(torch.Generator().manual_seed(4)))
    meet = box_ops.bev_circles_meet(boxes)
    assert bool(meet.all()) if kind == "cluster" else \
        int(meet.sum()) == boxes.shape[1]
    got = _check_nms(boxes, scores, valid)
    if kind == "sparse":
        assert torch.equal(got, valid)


def test_nms_bev_kernel_at_the_learn_eval_shape(card):
    """The learnability config's evaluation batch: B 4 x C 2 x K 256
    (``nms_pre``), boxes over +-51.2 m, valid above ``score_thr`` 0.05."""
    gen = torch.Generator().manual_seed(256)
    boxes, scores, _ = _nms_inputs(gen, 4, 2, 256)
    boxes[..., :2] *= 51.2 / 30
    boxes, scores = boxes.to(card), scores.to(card)
    got = _check_nms(boxes, scores, scores > 0.05)
    assert got.shape == (4, 2, 256) and 0 < int(got.sum()) < 4 * 2 * 256


def _check_nms(boxes, scores, valid):
    before = cuda_build.LAUNCHES["nms_bev"]
    got = box_ops.nms_bev_mask(boxes, scores, 0.2, valid)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["nms_bev"] == before + 1
    want = box_ops.nms_bev_mask_ref(boxes, scores, 0.2, valid)
    iou = box_ops.boxes_iou_bev_ref(boxes, boxes)
    near = (iou - 0.2).abs() < 1e-5
    bits = box_ops.nms_bev_suppression_bits(boxes, 0.2)
    assert not ((bits != (iou > 0.2)) & ~near).any()
    # each unordered pair of regular boxes (tame, no zero side) is
    # computed once and mirrored
    assert torch.equal(bits, bits.transpose(1, 2))
    # the greedy pass, exactly, on the bits the kernel computed
    assert torch.equal(got, box_ops.greedy_suppress_ref(bits, scores, valid))
    if not near.any():   # a pair on the threshold may round either way
        assert torch.equal(got, want)
    assert not (got & ~valid).any()
    invalid = box_ops.nms_bev_mask(boxes, scores, 0.2,
                                   torch.zeros_like(valid))
    assert not invalid.any()
    # scores and valid in the head's (B, K, C)-major layout: the kernel
    # reads the sort's order and valid in their own strides
    strided = box_ops.nms_bev_mask(boxes, scores.mT.contiguous().mT, 0.2,
                                   valid.mT.contiguous().mT)
    assert torch.equal(strided, got)
    return got


def test_nms_bev_shared_memory_limit(card):
    """The sizes around the greedy pass's former shared-memory limits, all
    taken now, with keep masks equal to the plain walk over the kernel's
    own bits: K = 1,344 at 32 classes (the whole mask in shared memory
    before), 1,345 at one class, 2,000 at ten (a four-view merge of 500
    boxes), 2,100 (more than 32 removed words a class), and 33 and 64
    classes (refused before)."""
    assert box_ops.greedy_smem_bytes(2100) <= box_ops.NMS_SMEM_BYTES
    gen = torch.Generator().manual_seed(0)
    before = cuda_build.LAUNCHES["nms_bev"]
    for c, k in ((32, 1344), (1, 1345), (10, 2000), (3, 2100), (33, 64),
                 (64, 300)):
        boxes, scores, valid = (t.to(card) for t in _nms_inputs(gen, 1, c,
                                                                k))
        got = box_ops.nms_bev_mask(boxes, scores, 0.2, valid)
        assert cuda_build.LAUNCHES["nms_bev"] == before + 1
        bits = box_ops.nms_bev_suppression_bits(boxes, 0.2)
        assert torch.equal(got, box_ops.greedy_suppress_ref(bits, scores,
                                                            valid))
        assert 0 < int(got.sum()) < int(valid.sum())
        before += 2


@pytest.mark.parametrize("name", [n for n, _ in degenerate_box_sets()])
def test_box_kernels_match_plain_versions_on_degenerate_boxes(card, name):
    """Zero-size boxes far apart, boxes with an infinite side and a zero
    one and boxes past float32's range once squared among scene boxes
    (``testing.degenerate_box_sets``, as an untrained detector decodes
    them): K10 and K10-BEV within 1e-5 of their plain versions (of the
    plain value where it exceeds 1), exactly 0 and NaN where they are;
    K10-NMS's bits equal to the plain IoU's (in both orders of each pair)
    away from the threshold and its keep masks to the plain walk over
    them and, with no pair that close, to the plain version's, at
    thresholds 0.7 and 0.01. Left out: the pairs whose IoU float32 does
    not determine (``testing.iou_undetermined``: an untame box, for
    K10-NMS also a zero-area one, and the plain float32 value more than
    1e-5 from its float64 one; there the plain version on the card and
    on the CPU differ too)."""
    boxes = dict(degenerate_box_sets())[name].to(card)
    bev = boxes[:, [0, 1, 3, 4, 6]].contiguous()
    for a, kernel, plain, is_bev in (
            (boxes, box_ops.boxes_iou_3d, box_ops.boxes_iou_3d_ref, False),
            (bev, box_ops.boxes_iou_bev, box_ops.boxes_iou_bev_ref, True)):
        got, want = kernel(a, a), plain(a, a)
        ok = ~iou_undetermined(a, a, want, bev=is_bev)
        got, want = got[ok], want[ok]
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.isinf(), want.isinf())
        fin = torch.isfinite(want)
        err = (got - want)[fin].abs() / want[fin].abs().clamp_min(1.0)
        assert float(err.max()) <= 1e-5
        assert int((got[want == 0] != 0).sum()) == 0
    gen = torch.Generator().manual_seed(len(bev))
    scores = torch.rand((1, 3, len(bev)), generator=gen).to(card)
    valid = torch.ones_like(scores, dtype=torch.bool)
    iou = box_ops.boxes_iou_bev_ref(bev, bev)[None]
    und = iou_undetermined(bev[None], bev[None], iou, bev=True,
                           zero_area=True)
    for thr in (0.7, 0.01):
        bits = box_ops.nms_bev_suppression_bits(bev[None], thr)
        near = ((iou - thr).abs() < 1e-5) | und
        assert not ((bits != (iou > thr)) & ~near).any()
        got = box_ops.nms_bev_mask(bev[None], scores, thr, valid)
        assert torch.equal(got, box_ops.greedy_suppress_ref(bits, scores,
                                                            valid))
        if not near.any():
            assert torch.equal(got, box_ops.nms_bev_mask_ref(
                bev[None], scores, thr, valid))


def test_pointpillars_tiny_on_card_matches_cpu(card):
    from isfusion_tpu_torch.flagship import build_pointpillars_flagship
    from isfusion_tpu_torch.testing import pp_kept_boxes, tame_box_deltas

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs = []
    for dev in ("cpu", "cuda"):
        model, batch_fn = build_pointpillars_flagship(tiny=True, device=dev,
                                                      seed=2)
        before = cuda_build.LAUNCHES["nms_bev"]
        outs.append(pp_kept_boxes(tame_box_deltas(model), batch_fn(2, seed=5),
                                  dev))
        assert cuda_build.LAUNCHES["nms_bev"] - before == int(dev == "cuda")
    (cb, cs, ck), (gb, gs, gk) = outs
    assert torch.equal(ck, gk) and len(ck) > 10
    for got, want in ((gb, cb), (gs, cs)):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def _check_circle(centers, scores, valid, thr):
    name = box_ops.circle_kernel(scores.shape[1])
    before = cuda_build.LAUNCHES[name]
    got = box_ops.circle_nms_mask(centers, scores, thr, valid)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[name] == before + 1
    want = box_ops.circle_nms_mask_ref(centers, scores, thr, valid)
    assert torch.equal(got, want)
    assert not (got & ~valid).any()
    return got


# K at the greedy pass's chunk edges, a request's (6 x 500) and larger
@pytest.mark.parametrize("r,k", [(3, 1), (2, 63), (4, 64), (2, 65),
                                 (6, 500), (24, 500), (2, 1000)])
def test_nms_circle_kernel_matches_plain_version(card, r, k):
    from isfusion_tpu_torch.testing import circle_nms_sets

    centers, scores, valid, thr = (t.to(card) for t in circle_nms_sets(
        torch.Generator().manual_seed(r * k), r, k))
    c = centers
    d2 = ((c[:, :, None] - c[:, None]) ** 2).sum(-1)
    if k > 1:       # pairs exactly on their set's threshold, tied scores
        assert int((d2 == thr[:, None, None]).sum()) > 0
        assert int((scores[:, 1:] == scores[:, :1]).sum()) > 0
    got = _check_circle(centers, scores, valid, thr)
    assert 0 < int(got.sum()) <= int(valid.sum())


def test_nms_circle_adversarial_sets(card):
    from isfusion_tpu_torch.testing import circle_nms_adversarial_sets

    kept = {}
    for name, *args in circle_nms_adversarial_sets(
            torch.Generator().manual_seed(0)):
        kept[name] = int(_check_circle(*(t.to(card) for t in args)).sum())
    assert kept["identical"] == kept["all_within"] == 1
    assert kept["none_within"] == 256 and kept["all_invalid"] == 0
    assert kept["single_box"] == 1 and 0 < kept["on_threshold"] < 256


def _profiler_own(key):
    """Device-side events that are no operation of the profiled code: the
    profile step's annotation, the trace's buffer requests, and the
    synchronisations the profile waits on (recorded when the card is still
    busy as the host synchronises)."""
    return key.startswith(("ProfilerStep", "Activity Buffer Request")) or \
        "Sync" in key


def _device_ops(fn, calls=20, attempts=3):
    """({device operation: count} over ``calls`` calls of ``fn()``, the
    profiles taken) (torch.profiler, after a warm-up step under the
    profiler: a profile's first launches can go untraced; the step's own
    annotation left out). A trace that holds no device event at all lost
    its event buffer (2 of 240 profiles of 20 calls on the H100): it is
    taken again, at most ``attempts`` times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for taken in range(1, attempts + 1):
        done = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: done.append(p.key_averages())
                     ) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in done[0] if e.device_type == DeviceType.CUDA]
        if events:
            break
    return {e.key: e.count for e in events
            if e.count and not _profiler_own(e.key)}, taken


def _one_operation(fn, name, kernel, calls=20):
    """Each call of ``fn`` launches kernel ``name`` once (its counter)
    and the profile of ``calls`` calls holds that kernel and no other
    device operation (no copy, no sort); ``kernel`` a tuple: the device
    operations of one call, each once. ``fn`` runs once and the card
    drains before the profile starts, so the profile sees neither the
    library's first load nor an earlier test's work still running."""
    kernels = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    before = cuda_build.LAUNCHES[name]
    ops, taken = _device_ops(fn, calls)
    assert cuda_build.LAUNCHES[name] - before == 2 * calls * taken
    assert len(ops) == len(kernels), ops
    for k in kernels:
        hits = [n for op, n in ops.items() if k in op]
        assert len(hits) == 1 and 0 < hits[0] <= calls, ops


@pytest.mark.parametrize("kind", ["signed_zeros", "nan", "all_equal",
                                  "decode_order"])
def test_nms_circle_order_cases(card, kind):
    """Scores that torch.sort orders by its own rules: -0.0 tied with
    +0.0, NaN first, all equal (the index order), and the decode's top-k
    order with masked boxes zeroed (the kernel's index-order shortcut)."""
    from isfusion_tpu_torch.testing import circle_nms_sets

    gen = torch.Generator().manual_seed(31)
    centers, scores, valid, thr = circle_nms_sets(gen, 4, 300)
    pick = torch.rand(scores.shape, generator=gen)
    if kind == "signed_zeros":
        scores = torch.where(pick < 0.4, torch.tensor(-0.0),
                             torch.where(pick < 0.8, torch.tensor(0.0),
                                         scores))
        assert bool((torch.signbit(scores) & (scores == 0)).any())
    elif kind == "nan":
        scores = torch.where(pick < 0.2, torch.tensor(float("nan")), scores)
    elif kind == "all_equal":
        scores = torch.full_like(scores, 0.5)
    else:
        scores, order = torch.sort(scores, dim=-1, descending=True,
                                   stable=True)
        centers = torch.gather(centers, 1, order[..., None].expand(-1, -1,
                                                                   2))
        valid = torch.gather(valid, 1, order)
        scores = torch.where(valid, scores, 0.0)
    got = _check_circle(*(t.to(card) for t in (centers, scores, valid,
                                                thr)))
    assert 0 < int(got.sum()) < int(valid.sum())


def test_nms_circle_on_long_chains(card):
    """Centres 0.9 m apart along a line in score order, threshold 1: each
    box suppresses the next, so every chunk's walk takes its most rounds;
    invalid boxes break some chains."""
    k = 500
    x = torch.arange(k, dtype=torch.float32) * 0.9
    centers = torch.stack([x, torch.zeros(k)], -1).repeat(3, 1, 1)
    centers[1, :, 1] = 40.0
    scores = torch.linspace(1, 0, k).repeat(3, 1)
    valid = torch.ones((3, k), dtype=torch.bool)
    valid[2, ::7] = False
    thr = torch.ones(3)
    got = _check_circle(*(t.to(card) for t in (centers, scores, valid, thr)))
    assert got[0].tolist() == [i % 2 == 0 for i in range(k)]


def test_nms_circle_at_and_above_its_limit(card):
    """K = 1,792 fills the one-launch kernel's shared memory; 1,793 (refused
    before) takes the pairwise and greedy passes, equal to the plain
    version, and launches no one-launch kernel."""
    from isfusion_tpu_torch.testing import circle_nms_sets

    k = box_ops.CIRCLE_MAX_BOXES
    centers, scores, valid, thr = (t.to(card) for t in circle_nms_sets(
        torch.Generator().manual_seed(k), 2, k))
    _check_circle(centers, scores, valid, thr)
    before = cuda_build.LAUNCHES["nms_circle"]
    centers, scores, valid, thr = (t.to(card) for t in circle_nms_sets(
        torch.Generator().manual_seed(0), 1, k + 1))
    got = _check_circle(centers, scores, valid, thr)
    assert cuda_build.LAUNCHES["nms_circle"] == before
    assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.parametrize("k", [1793, 4000, 6000])
def test_nms_circle_past_the_one_launch_size(card, k):
    """The pairwise and greedy passes at K = 1,793, 4,000 and 6,000 (past
    the greedy pass's staged rows: its rows read through L1): two sets, one
    threshold each, with NaN scores (first in torch.sort's order) and
    scores of either zero sign (tied), and a number as the threshold."""
    from isfusion_tpu_torch.testing import circle_nms_sets

    gen = torch.Generator().manual_seed(k)
    centers, scores, valid, thr = circle_nms_sets(gen, 2, k)
    pick = torch.rand(scores.shape, generator=gen)
    scores = torch.where(pick < 0.05, torch.tensor(float("nan")), scores)
    scores = torch.where((pick > 0.5) & (pick < 0.6), torch.tensor(-0.0),
                         torch.where(pick > 0.9, torch.tensor(0.0), scores))
    centers, scores, valid, thr = (t.to(card) for t in (centers, scores,
                                                        valid, thr))
    got = _check_circle(centers, scores, valid, thr)
    assert 0 < int(got.sum()) < int(valid.sum())
    one = _check_circle(centers, scores, valid, 1.0)
    assert torch.equal(one[1], got[1])       # set 1's threshold is 1.0


def test_nms_circle_is_one_device_operation(card):
    """Contiguous inputs, a threshold tensor or a number, and the head's
    strided centres (a slice of its box rows): one launch, nothing else."""
    from isfusion_tpu_torch.testing import circle_nms_sets

    centers, scores, valid, thr = (t.to(card) for t in circle_nms_sets(
        torch.Generator().manual_seed(6), 6, 500))
    rows = torch.cat([centers, torch.randn(6, 500, 7, device=card)], -1)
    for args in ((centers, scores, thr, valid), (centers, scores, 1.0, valid),
                 (rows[..., :2], scores, thr, valid)):
        _one_operation(lambda: box_ops.circle_nms_mask(*args), "nms_circle",
                       "nms_circle_kernel")
    got = box_ops.circle_nms_mask(rows[..., :2], scores, thr, valid)
    assert torch.equal(got, box_ops.circle_nms_mask_ref(centers, scores,
                                                        thr, valid))


def _check_iou(a, b):
    got = box_ops.boxes_iou_3d(a, b)
    torch.cuda.synchronize()
    want = box_ops.boxes_iou_3d_ref(a, b)
    assert float((got - want).abs().max()) <= 1e-5
    # exactly 0 wherever the plain version is
    assert int((got[want == 0] != 0).sum()) == 0
    return got, want


# the names of testing.iou_edge_sets()
IOU_EDGE_SETS = ("touching_edges", "touching_corners", "nested", "identical",
                 "rotated_45", "z_stacked", "far_apart")


@pytest.mark.parametrize("name", IOU_EDGE_SETS)
def test_boxes_iou_3d_exact_zeros_on_edge_sets(card, name):
    from isfusion_tpu_torch.testing import iou_edge_sets

    _, a, b = next(s for s in iou_edge_sets() if s[0] == name)
    got, want = _check_iou(a.to(card), b.to(card))
    if name == "far_apart":
        assert not bool(got.any())


def test_boxes_iou_3d_reads_strided_rows_without_a_copy(card):
    """The assigner's (B, Q, 10) and (B, G, 9) rows sliced to 7: one
    launch, no copy kernel."""
    gen = torch.Generator().manual_seed(8)
    a = torch.stack([_boxes(gen, 200) for _ in range(4)])
    b = a[:, torch.randperm(200, generator=gen)[:64]] + \
        torch.randn((4, 64, 7), generator=gen) * 0.3
    b[..., 3:6] = b[..., 3:6].abs() + 0.1
    q = torch.cat([a, torch.randn(4, 200, 3, generator=gen)], -1).to(card)
    g = torch.cat([b, torch.randn(4, 64, 2, generator=gen)], -1).to(card)
    got, want = _check_iou(q[..., :7], g[..., :7])
    assert torch.equal(got, box_ops.boxes_iou_3d(q[..., :7].contiguous(),
                                                 g[..., :7].contiguous()))
    assert (want > 0.1).sum() >= 4 * 32
    _one_operation(lambda: box_ops.boxes_iou_3d(q[..., :7], g[..., :7]),
                   "boxes_iou_3d", "boxes_iou_3d_kernel")


def test_boxes_iou_3d_on_a_train_steps_assigner_inputs(card):
    """The tiny flagship's train step on the card: K10 on the assigner's
    own decoded proposals and GTs (every sample and decoder layer)."""
    from isfusion_tpu_torch.core.bbox import assigners
    from isfusion_tpu_torch.flagship import build_isfusion_flagship
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer

    model, batch_fn = build_isfusion_flagship(tiny=True, device="cuda",
                                              seed=3, dropout=False)
    model.train()
    step = make_train_step(model, build_optimizer(model, dict(
        type="AdamW", lr=1e-4)))
    real, seen = assigners.boxes_iou_3d, []

    def recording(a, b):
        seen.append((a.clone(), b.clone()))
        return real(a, b)

    assigners.boxes_iou_3d = recording
    try:
        step(batch_fn(2, seed=4), torch.Generator("cuda").manual_seed(0))
    finally:
        assigners.boxes_iou_3d = real
    assert len(seen) == 1
    a, b = seen[0]
    got, want = _check_iou(a, b)
    assert got.shape == a.shape[:-1] + b.shape[-2:-1]


def _gaussian_inputs(gen, b, g, nc, hw, step):
    """The heads' K11 inputs for B x G random boxes over +-54 m: centres
    in cells of ``step`` m, radii from ``gaussian_radius`` (overlap 0.1,
    floored, at least 2), labels over ``nc`` classes, 10% padded."""
    xy = (torch.rand((b, g, 2), generator=gen) * 2 - 1) * 54
    size = 0.5 + torch.rand((b, g, 2), generator=gen) * 10
    cxy = (xy + 54) / step
    r = gaussian.gaussian_radius((size[..., 1] / step, size[..., 0] / step),
                                 0.1)
    r = torch.floor(r).clamp_min(2.0)
    labels = torch.randint(0, nc, (b, g), generator=gen)
    valid = (torch.rand((b, g), generator=gen) > 0.1) & \
        (cxy >= 0).all(-1) & (cxy[..., 0] < hw[1]) & (cxy[..., 1] < hw[0])
    return cxy, r, valid, labels


@pytest.mark.parametrize("b,g,hw,nc", [(4, 64, (180, 180), 10),
                                       (2, 500, (180, 180), 10),
                                       (1, 3, (24, 20), 4)])
def test_gaussian_heatmap_kernel_matches_plain_version(card, b, g, hw, nc):
    cxy, r, valid, labels = (t.to(card) for t in _gaussian_inputs(
        torch.Generator().manual_seed(g), b, g, nc, hw, 0.6))
    before = cuda_build.LAUNCHES["gaussian_heatmap"]
    got = gaussian.draw_heatmap_gaussian_batch(hw, cxy, r, valid, labels, nc)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["gaussian_heatmap"] == before + 1
    want = gaussian.draw_heatmap_gaussian_batch_ref(hw, cxy, r, valid,
                                                    labels, nc)
    assert got.shape == (b,) + hw + (nc,)
    assert torch.equal(got, want)
    assert int((got == 1.0).sum()) == int((want == 1.0).sum()) > 0


def test_centerpoint_tiny_on_card_matches_cpu(card):
    from isfusion_tpu_torch.flagship import build_centerpoint
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer
    from isfusion_tpu_torch.testing import cp_kept_boxes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs, losses = [], []
    for dev in ("cpu", "cuda"):
        model, batch_fn = build_centerpoint(tiny=True, device=dev, seed=2)
        batch = batch_fn(2, seed=5)
        before = dict(cuda_build.LAUNCHES)
        outs.append(cp_kept_boxes(model, batch, dev))
        model.train()
        step = make_train_step(model, build_optimizer(
            model, dict(type="AdamW", lr=1e-4)))
        m = step(batch, torch.Generator(dev).manual_seed(0))
        losses.append({k: float(v) for k, v in m.items()})
        launched = {k: cuda_build.LAUNCHES[k] - before[k]
                    for k in ("nms_circle", "gaussian_heatmap")}
        assert launched == ({"nms_circle": 1, "gaussian_heatmap": 1}
                            if dev == "cuda" else
                            {"nms_circle": 0, "gaussian_heatmap": 0})
    (cb, cs, ck), (gb, gs, gk) = outs
    assert torch.equal(ck, gk) and len(ck) > 10
    for got, want in ((gb, cb), (gs, cs)):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    for k, want in losses[0].items():
        assert abs(losses[1][k] - want) <= 1e-4 * max(abs(want), 1e-6), k


MVX_PCR = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
MVX_VS = (0.05, 0.05, 0.1)


def _voxel_sets():
    from isfusion_tpu_torch.flagship import synthetic_points_batch
    from isfusion_tpu_torch.testing import voxel_adversarial_sets
    sets = voxel_adversarial_sets(np.random.default_rng(3), MVX_PCR, MVX_VS,
                                  p=20000)
    cloud = synthetic_points_batch(2, num_points=50000, seed=4)
    sets.append(("flagship_cloud", cloud["points"], cloud["points_mask"]))
    rng = np.random.default_rng(6)
    low, size = np.asarray(MVX_PCR[:3]), np.asarray(MVX_VS)
    # all 20,000 points in one voxel: one long slice (a block sorts it)
    one = np.zeros((1, 20000, 4), np.float32)
    one[0, :, :3] = low + (np.array([700, 400, 20]) +
                           rng.uniform(0.1, 0.9, (20000, 3))) * size
    sets.append(("one_voxel", one, np.ones((1, 20000), bool)))
    # slices across the thread, warp and block sorts, in shuffled order
    lens = [1, 2, 5, 16, 17, 31, 32, 33, 64, 100, 255, 256, 257, 300, 600,
            1500] * 6
    cells = rng.choice(1000 * 1000, len(lens), replace=False)
    xyz = np.concatenate([
        low + (np.array([cell % 1000, cell // 1000, 7]) +
               rng.uniform(0.1, 0.9, (n, 3))) * size
        for cell, n in zip(cells, lens)])
    sl = np.zeros((1, len(xyz), 4), np.float32)
    sl[0, :, :3] = xyz[rng.permutation(len(xyz))]
    sets.append(("slices", sl, np.ones((1, len(xyz)), bool)))
    return sets


@pytest.mark.parametrize("case", range(9))
def test_dynamic_voxelize_kernel_matches_plain_version(card, case):
    name, pts, mask = _voxel_sets()[case]
    pcr, vs = (MVX_PCR, MVX_VS) if name != "flagship_cloud" else \
        ((-54.0, -54.0, -5.0, 54.0, 54.0, 3.0), (0.075, 0.075, 0.2))
    pts, mask = torch.from_numpy(pts).to(card), torch.from_numpy(mask).to(card)
    before = cuda_build.LAUNCHES["dynamic_voxelize"]
    got = voxel.voxelize_dynamic(pts, mask, pcr, vs)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["dynamic_voxelize"] == before + 1
    want = voxel.voxelize_dynamic_ref(pts, mask, pcr, vs)
    assert torch.equal(got.point_voxel_index, want.point_voxel_index), name
    assert torch.equal(got.voxel_coors, want.voxel_coors), name
    assert torch.equal(got.voxel_ptr, want.voxel_ptr), name
    assert torch.equal(got.point_order, want.point_order), name
    if name == "one_voxel":
        assert got.voxel_ptr.tolist() == [0, 20000]
    again = voxel.voxelize_dynamic(pts, mask, pcr, vs)   # the workspace
    assert torch.equal(again.point_order, want.point_order), name


def test_segment_layout_kernel_matches_plain_version(card):
    gen = torch.Generator().manual_seed(9)
    ids = torch.randint(0, 3000, (40000,), generator=gen)
    ids[ids == 1] = 2                           # an empty segment
    ids[:5000] = 7                              # a long one
    ids[5000:5100] = 8                          # a medium one
    ids = ids.to(card)
    before = cuda_build.LAUNCHES["segment_layout"]
    ptr, order = voxel.segment_layout(ids, 3000)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["segment_layout"] == before + 1
    want_ptr, want_order = voxel.segment_layout_ref(ids, 3000)
    assert torch.equal(ptr, want_ptr) and torch.equal(order, want_order)


def _segments(gen, p, c, s):
    data = torch.randint(-3, 4, (p, c), generator=gen).float()
    data[: p // 2] = torch.randn((p // 2, c), generator=gen)
    ids = torch.randint(0, s, (p,), generator=gen)
    ids[ids == 1] = 2                          # segment 1 stays empty
    data[ids == 3] = data[ids == 3].clamp_max(0)   # max 0, tied
    return data, ids


@pytest.mark.parametrize("c", [3, 64, 128])
def test_dynamic_scatter_max_kernel_matches_plain_version(card, c):
    gen = torch.Generator().manual_seed(c)
    data, ids = _segments(gen, 20000, c, 3000)
    data, ids = data.to(card), ids.to(card)
    g = torch.randn((3000, c), generator=gen).to(card)
    outs = []
    for fn in (scatter.segment_max, scatter.segment_max_ref):
        x = data.clone().requires_grad_(True)
        before = cuda_build.LAUNCHES["dynamic_scatter"]
        out = fn(x, ids, 3000)
        (out * g).sum().backward()
        torch.cuda.synchronize()
        launched = cuda_build.LAUNCHES["dynamic_scatter"] - before
        outs.append((out.detach(), x.grad, launched))
    (ko, kg, kl), (po, pg, pl) = outs
    assert (kl, pl) == (2, 0)                  # forward and backward
    assert torch.equal(ko, po) and torch.equal(kg, pg)
    assert (ko[1] == 0).all()


@pytest.mark.parametrize("c,aligned", [(3, True), (64, True), (64, False),
                                       (128, True)])
def test_dynamic_scatter_max_with_layout_matches_plain_version(card, c,
                                                               aligned):
    """The max, forward and backward, through a list built once: no list
    is built again; bit-equal to the plain version with the empty segment
    and the zero ties; rows 16-byte aligned (16-byte loads) or not."""
    gen = torch.Generator().manual_seed(c + 1)
    data, ids = _segments(gen, 20000, c, 3000)
    data, ids = data.to(card), ids.to(card)
    if not aligned:                            # one float past an alignment
        data = torch.empty(data.numel() + 1, device=card)[1:].view_as(
            data).copy_(data)
        assert data.data_ptr() % 16 != 0
    g = torch.randn((3000, c), generator=gen).to(card)
    layout = voxel.segment_layout(ids, 3000)
    before = dict(cuda_build.LAUNCHES)
    outs = []
    for fn, kw in ((scatter.segment_max, dict(layout=layout)),
                   (scatter.segment_max_ref, {})):
        x = data.detach().clone().requires_grad_(True)
        out = fn(x, ids, 3000, **kw)
        (out * g).sum().backward()
        outs.append((out.detach(), x.grad))
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["segment_layout"] == before["segment_layout"]
    assert cuda_build.LAUNCHES["dynamic_scatter"] == \
        before["dynamic_scatter"] + 2
    (ko, kg), (po, pg) = outs
    assert torch.equal(ko, po) and torch.equal(kg, pg)
    assert (ko[1] == 0).all()


def test_dynamic_scatter_mean_kernel_order_is_fixed(card):
    gen = torch.Generator().manual_seed(7)
    data = torch.randn((30000, 3), generator=gen) * 40
    ids = torch.randint(0, 4000, (30000,), generator=gen)
    ids[:500] = 5                              # one crowded segment
    want_cpu = scatter.segment_mean_ref(data, ids, 4000)
    data, ids = data.to(card), ids.to(card)
    got = scatter.segment_mean(data, ids, 4000)
    again = scatter.segment_mean(data, ids, 4000)
    plain = scatter.segment_mean_ref(data, ids, 4000)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want_cpu)
    assert float((got - plain).abs().max() / plain.abs().max()) <= 1e-6
    x = data.clone().requires_grad_(True)
    w = torch.randn((4000, 3), generator=gen).to(card)
    (scatter.segment_mean(x, ids, 4000) * w).sum().backward()
    xr = data.clone().requires_grad_(True)
    (scatter.segment_mean_ref(xr, ids, 4000) * w).sum().backward()
    assert torch.equal(x.grad, xr.grad)


def test_dynamic_scatter_mean_with_layout_repeats(card):
    gen = torch.Generator().manual_seed(8)
    data = torch.randn((30000, 3), generator=gen) * 40
    ids = torch.randint(0, 4000, (30000,), generator=gen)
    ids[:500] = 5                              # one crowded segment
    ids[ids == 6] = 7                          # an empty one
    want_cpu = scatter.segment_mean_ref(data, ids, 4000)
    data, ids = data.to(card), ids.to(card)
    layout = voxel.segment_layout(ids, 4000)
    before = cuda_build.LAUNCHES["segment_layout"]
    got = scatter.segment_mean(data, ids, 4000, layout)
    again = scatter.segment_mean(data, ids, 4000, layout)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["segment_layout"] == before
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want_cpu)
    assert (got[6] == 0).all()


def test_mvxnet_tiny_on_card_matches_cpu(card):
    from isfusion_tpu_torch.flagship import build_mvxnet
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer
    from isfusion_tpu_torch.testing import (even_class_prior, pp_kept_boxes,
                                            tame_box_deltas)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs, losses = [], []
    for dev in ("cpu", "cuda"):
        model, batch_fn = build_mvxnet(tiny=True, device=dev, seed=2)
        even_class_prior(tame_box_deltas(model))
        batch = batch_fn(2, seed=5)
        before = dict(cuda_build.LAUNCHES)
        outs.append(pp_kept_boxes(model, batch, dev))
        model.train()
        step = make_train_step(model, build_optimizer(
            model, dict(type="AdamW", lr=1e-4)))
        m = step(batch, torch.Generator(dev).manual_seed(0))
        losses.append({k: float(v) for k, v in m.items()})
        launched = {k: cuda_build.LAUNCHES[k] - before[k]
                    for k in ("dynamic_voxelize", "dynamic_scatter",
                              "nms_bev", "segment_layout")}
        if dev == "cuda":
            # a voxelization a predict and a step, whose lists every K2
            # call takes
            assert launched.pop("segment_layout") == 0, launched
            assert launched["dynamic_voxelize"] == 2, launched
            assert min(launched.values()) >= 1, launched
    (cb, cs, ck), (gb, gs, gk) = outs
    assert torch.equal(ck, gk) and len(ck) > 10
    for got, want in ((gb, cb), (gs, cs)):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    for k, want in losses[0].items():
        assert abs(losses[1][k] - want) <= 1e-4 * max(abs(want), 1e-6), k


# ------------------------------------------------ FCOS3D, LiDAR variants
def test_tiny_fcos3d_on_card_matches_cpu(card):
    """The tiny FCOS3D (no hand-written kernel on its path) in float32:
    head outputs 1e-3 of their max, decoded scores and boxes 1e-4 with
    equal labels, loss terms 1e-4 relative, gradients 1e-3 of each
    top-level module's max."""
    from isfusion_tpu_torch.flagship import build_fcos3d

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = []
    for dev in ("cpu", "cuda"):
        model, batch_fn = build_fcos3d(tiny=True, device=dev, seed=2)
        batch = batch_fn(2, seed=5)
        feats = model(batch, mode="feats", device=dev)
        out = {k: v.cpu() for k, v in model(batch, device=dev).items()}
        model.train()
        losses = model(batch, mode="loss", device=dev)
        sum(losses.values()).backward()
        grads = {top: torch.cat([p.grad.cpu().flatten() for p in getattr(
            model, top).parameters()]) for top in ("backbone", "neck",
                                                   "bbox_head")}
        runs.append(([{k: v.cpu() for k, v in f.items()} for f in feats],
                     out, {k: float(v.detach()) for k, v in losses.items()},
                     grads))
    (fc, oc, lc, gc), (fg, og, lg, gg) = runs

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for a, b in zip(fg, fc):
        for k in b:
            assert rel(a[k], b[k]) <= 1e-3, k
    assert torch.equal(og["labels"], oc["labels"])
    for k in ("bboxes", "scores"):
        assert rel(og[k], oc[k]) <= 1e-4, k
    for k, want in lc.items():
        assert abs(lg[k] - want) <= 1e-4 * max(abs(want), 1e-6), k
    for top, want in gc.items():
        assert rel(gg[top], want) <= 1e-3, top


@pytest.mark.parametrize("name", ["dynamic_simple", "dynamic_pillar",
                                  "dynamic_centerpoint", "voxelnet",
                                  "dynamic_voxelnet", "transfusion_l"])
def test_lidar_variant_launches_its_kernels(card, name):
    """A tiny LiDAR variant's predict launches every kernel of its predict
    path and its train forward + backward every kernel of its train path
    (``flagship.LIDAR_VARIANT_KERNELS``); no K2 call builds a point list
    of its own."""
    from isfusion_tpu_torch.flagship import (LIDAR_VARIANT_KERNELS,
                                             build_lidar_variant)

    model, batch_fn = build_lidar_variant(name, device=card, seed=1)
    batch = batch_fn(2, seed=3)
    kernels = LIDAR_VARIANT_KERNELS[name]
    before = dict(cuda_build.LAUNCHES)
    out = model(batch, device=card)
    torch.cuda.synchronize()
    predict = {k: cuda_build.LAUNCHES[k] - before[k] for k in
               kernels["predict"] + ("segment_layout",)}
    assert torch.isfinite(out["bboxes"][out["mask"]]).all()
    model.train()
    before = dict(cuda_build.LAUNCHES)
    losses = model(batch, mode="loss", device=card,
                   generator=torch.Generator(card).manual_seed(0))
    sum(v for k, v in losses.items() if "loss" in k).backward()
    torch.cuda.synchronize()
    train = {k: cuda_build.LAUNCHES[k] - before[k] for k in
             kernels["train"] + ("segment_layout",)}
    assert predict.pop("segment_layout") == 0 and \
        train.pop("segment_layout") == 0
    assert min(predict.values()) >= 1, predict
    assert not train or min(train.values()) >= 1, train


@contextlib.contextmanager
def one_nccl_rank(path):
    """A process group of one rank under NCCL (the configs' backend);
    yields the sizes of the all-reduce calls made while it is up."""
    import torch.distributed as dist
    calls = []
    real = dist.all_reduce

    def counted(*args, **kw):
        calls.append(args[0].numel())
        return real(*args, **kw)

    dist.init_process_group("nccl", init_method=f"file://{path}/group",
                            rank=0, world_size=1)
    dist.all_reduce = counted
    try:
        yield calls
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()


@pytest.fixture
def nccl_rank(card, tmp_path):
    with one_nccl_rank(tmp_path) as calls:
        yield calls


@pytest.mark.parametrize("masked", [False, True])
def test_sync_bn_at_one_nccl_rank_is_the_plain_norm(nccl_rank, masked):
    """A sync norm in a group of one launches no collective and gives the
    plain norm's output, gradients and running statistics bit for
    bit."""
    from isfusion_tpu_torch.models.layers import BatchNorm, MaskedBatchNorm

    gen = torch.Generator().manual_seed(3)
    x = (torch.randn((6, 40, 16), generator=gen) * 3 + 1).cuda()
    mask = (torch.rand((6, 40), generator=gen) < 0.6).cuda()
    ct = torch.randn((6, 40, 16), generator=gen).cuda()
    out = []
    for sync in (True, False):
        kind = MaskedBatchNorm if masked else BatchNorm
        bn = kind(16, eps=1e-3, momentum=0.01, sync=sync).cuda().train()
        xs = x.clone().requires_grad_(True)
        y = bn(xs, mask) if masked else bn(xs)
        (y * ct).sum().backward()
        out.append([t.detach().cpu() for t in (
            y, xs.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var)])
    assert nccl_rank == []
    for got, want in zip(*out):
        assert torch.equal(got, want)


def test_dp_step_at_one_nccl_rank_is_the_plain_step(card, tmp_path):
    """The tiny PointPillars (every norm synced) on the card, float32,
    TF32 off: the step in a group of one NCCL rank (the DP step) against
    the step without a group from the same weights: losses 1e-4
    relative, each top-level module's updated parameters 1e-3 of their
    max; one all-reduce (the gradients', the losses with them) and no
    sync-norm collective."""
    import copy

    from isfusion_tpu_torch.flagship import (build_pointpillars_flagship,
                                             pointpillars_optim_cfg)
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model, batch_fn = build_pointpillars_flagship(tiny=True,
                                                      device="cuda")
        batch = batch_fn(4, seed=2)
        cfg = pointpillars_optim_cfg()
        runs = []
        for grouped in (False, True):
            m = copy.deepcopy(model).train()
            opt = build_optimizer(m, cfg["optimizer"])
            step = make_train_step(m, opt, build_schedule(
                opt, cfg["lr_config"], cfg["momentum_config"]),
                grad_clip_norm(cfg["optimizer_config"]))
            with one_nccl_rank(tmp_path) if grouped else \
                    contextlib.nullcontext([]) as calls:
                metrics = step(batch, torch.Generator("cuda"))
                torch.cuda.synchronize()
                runs.append(({k: float(v) for k, v in metrics.items()},
                             dict(m.named_parameters()), len(calls)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    (plain, p_plain, n_plain), (dp, p_dp, n_dp) = runs
    assert (n_plain, n_dp) == (0, 1)
    assert set(dp) == set(plain)
    for k, v in plain.items():
        assert abs(dp[k] - v) <= 1e-4 * max(abs(v), 1e-12), k
    for top in {n.split(".")[0] for n in p_plain}:
        names = [n for n in p_plain if n.split(".")[0] == top]
        want = torch.cat([p_plain[n].detach().ravel() for n in names])
        got = torch.cat([p_dp[n].detach().ravel() for n in names])
        assert float((got - want).abs().max() /
                     want.abs().max().clamp_min(1e-30)) <= 1e-3, top


# ------------------------------------------------------ K16 RoI-aware pooling
def _roiaware_check(rois, centers, feats, mask, g, card):
    """K16 against its plain version on the card: the forward's list of
    inside (voxel, cell) pairs in voxel order and its cell counts equal,
    pooled features and dfeats within 1e-6 of their max, two calls
    bit-equal, two launches forward and one backward."""
    from isfusion_tpu_torch.ops.roiaware_pool import (
        roiaware_pool, roiaware_pool_ref, roiaware_pool_state)
    rois, centers, feats, mask = (torch.from_numpy(a) for a in (
        rois, centers, feats, mask))
    _, counts, entries = roiaware_pool_state(rois, centers, feats, mask, g)
    rois, centers, feats, mask = (t.to(card) for t in (
        rois, centers, feats, mask))
    r = rois.shape[1]
    pooled_k, counts_k, entries_k = roiaware_pool_state(rois, centers,
                                                        feats, mask, g)
    assert torch.equal(counts_k.cpu(), counts)
    assert torch.equal(entries_k.cpu(), entries)
    dy = torch.randn(pooled_k.shape, generator=torch.Generator().manual_seed(
        r), dtype=torch.float32).to(card)
    runs = []
    for _ in range(2):
        f = feats.clone().requires_grad_()
        before = cuda_build.LAUNCHES["roiaware_pool"]
        out = roiaware_pool(rois, centers, f, mask, g)
        out.backward(dy)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["roiaware_pool"] - before == \
            (3 if r * centers.shape[1] else 0)
        runs.append((out.detach(), f.grad))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0], pooled_k)
    fp = feats.clone().requires_grad_()
    plain = roiaware_pool_ref(rois, centers, fp, mask, g)
    plain.backward(dy)
    for got, want in ((runs[0][0], plain.detach()), (runs[0][1], fp.grad)):
        if want.numel():
            assert float((got - want).abs().max()) <= \
                1e-6 * float(want.abs().max())


@pytest.mark.parametrize("g", [4, 6])
@pytest.mark.parametrize("c", [3, 20])
@pytest.mark.parametrize("r", [0, 1, 100])
@pytest.mark.parametrize("v", [1, 1000, 40000])
def test_roiaware_pool_kernel_matches_plain_version(card, g, c, r, v):
    from isfusion_tpu_torch.testing import roiaware_case
    case = roiaware_case(np.random.default_rng(g + c + r + v), 2, r, v, c)
    _roiaware_check(*case, g, card)


@pytest.mark.parametrize("g", [4, 6])
def test_roiaware_pool_kernel_on_adversarial_sets(card, g):
    """An empty RoI, stacked RoIs, centres exactly on faces and at u = 1 -
    2^-24, masked voxels, V not a multiple of 256, one RoI holding 40,000
    voxels (``testing.roiaware_adversarial_sets``)."""
    from isfusion_tpu_torch.testing import roiaware_adversarial_sets
    for _, *case in roiaware_adversarial_sets(np.random.default_rng(g)):
        _roiaware_check(*case, g, card)


@pytest.mark.parametrize("v", [1, 1037, 40000])
def test_roiaware_pool_saves_membership_without_host_sync(card, v):
    """K16's forward and backward under ``set_sync_debug_mode("error")``
    (no ``.item()``, no ``nonzero``, no size read back), two launches
    forward and one backward; the bitmap the forward saves for the
    backward has its bits set exactly where the plain membership is
    inside (``roiaware_bitmap_ref`` of ``roiaware_cells_ref``), the saved
    cells there equal the plain cells, and every inside pair passes the
    plain mirror of the kernel's cut."""
    from isfusion_tpu_torch.ops import roiaware_pool as rp
    from isfusion_tpu_torch.testing import roiaware_case
    rois, centers, feats, mask = (torch.from_numpy(a).to(card) for a in
                                  roiaware_case(np.random.default_rng(v), 2,
                                                100, v, 20))
    f = feats.clone().requires_grad_()
    dy = torch.randn((2, 100, 6, 6, 6, 20), device=card)
    torch.cuda.synchronize()
    before = cuda_build.LAUNCHES["roiaware_pool"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rp.roiaware_pool(rois, centers, f, mask, 6)
        mid = cuda_build.LAUNCHES["roiaware_pool"]
        _, bits, saved_cells = out.grad_fn.saved_tensors
        out.backward(dy)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (mid - before, cuda_build.LAUNCHES["roiaware_pool"] - mid) == \
        (2, 1)
    cells = rp.roiaware_cells_ref(rois, centers, mask, 6)
    assert bits.dtype == torch.int32
    assert torch.equal(bits, rp.roiaware_bitmap_ref(cells))
    inside = cells >= 0
    assert torch.equal(saved_cells.long()[inside], cells[inside])
    assert not (inside & ~rp.roiaware_cut_ref(rois, centers, mask)).any()


def test_inverse_conv_on_card_matches_cpu(card):
    """A sparse inverse conv (SparseUNet's upsampling) through K12 on the
    card against the plain version on the CPU: output, dX and dW within
    1e-5 of their max; K12 launched forward and backward."""
    gen = np.random.default_rng(3)
    grid, b = (9, 30, 28), 2
    coords = []
    for i in range(b):
        ids = np.sort(gen.choice(np.prod(grid), 1500, replace=False))
        coords.append(np.stack([np.full_like(ids, i), ids // (grid[1] *
                                grid[2]), ids // grid[2] % grid[1],
                                ids % grid[2]], -1))
    coords = torch.from_numpy(np.concatenate(coords)).int()

    def run(dev):
        target = sparse_conv.build_sparse(torch.zeros(len(coords), 1),
                                          coords, grid, b)
        low, _, _ = sparse_conv.strided_rulebook(target, 3, 2, 1)
        wgen = torch.Generator().manual_seed(0)
        x = torch.randn((low.coords.shape[0], 16), generator=wgen)
        w = torch.randn((16, 3, 3, 3, 16), generator=wgen) * 0.1
        dy = torch.randn((len(coords), 16), generator=wgen)
        low = sparse_conv.SparseTensor(x.to(dev), low.coords.to(dev),
                                       low.keys.to(dev), low.shape, b)
        target = sparse_conv.SparseTensor(target.feats.to(dev),
                                          target.coords.to(dev),
                                          target.keys.to(dev), target.shape,
                                          b)
        rows, found = sparse_conv.inverse_rulebook(low, target, 3, 2, 1)
        assert sparse_conv.rulebook_is_injective(rows, found)
        xg, wg = low.feats.requires_grad_(), w.to(dev).requires_grad_()
        out = sparse_conv.sparse_conv(xg, rows, found, wg)
        out.backward(dy.to(dev))
        return [t.detach().cpu() for t in (out, xg.grad, wg.grad)]

    before = cuda_build.LAUNCHES["masked_gather"]
    got = run(card)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["masked_gather"] - before >= 3
    for g_, w_ in zip(got, run("cpu")):
        assert float((g_ - w_).abs().max()) <= 1e-5 * float(w_.abs().max())


# ------------------------------------------------- K10-BEV, K10-normal
def _check_iou_bev(a, b):
    """K10-BEV against its plain version: one counted call, within 1e-5 (of 1,
    or of the plain value where a degenerate pair's IoU exceeds 1), and
    exactly 0 wherever the plain version is."""
    before = cuda_build.LAUNCHES["boxes_iou_bev"]
    got = box_ops.boxes_iou_bev(a, b)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["boxes_iou_bev"] == before + 1
    want = box_ops.boxes_iou_bev_ref(a[..., :5], b[..., :5])
    err = (got - want).abs() / want.abs().clamp_min(1.0)
    assert float(err.max()) <= 1e-5
    assert int((got[want == 0] != 0).sum()) == 0
    return got, want


def test_boxes_iou_bev_kernel_matches_plain_version(card):
    gen = torch.Generator().manual_seed(21)
    a = torch.stack([_boxes(gen, 150) for _ in range(3)])
    b = a[:, torch.randperm(150, generator=gen)[:70]] + \
        torch.randn((3, 70, 7), generator=gen) * 0.3
    b[..., 3:6] = b[..., 3:6].abs() + 0.1
    cols = [0, 1, 3, 4, 6]
    got, want = _check_iou_bev(a[..., cols].to(card), b[..., cols].to(card))
    assert (want > 0.1).sum() >= 3 * 40
    # 9-wide rows read through their strides, no copy: the list count's
    # memset, the tile kernel and the drain
    rows = torch.cat([a[..., cols], torch.randn(3, 150, 4, generator=gen)],
                     -1).to(card)
    assert torch.equal(box_ops.boxes_iou_bev(rows, rows), box_ops.boxes_iou_bev(
        rows[..., :5].contiguous(), rows[..., :5].contiguous()))
    _one_operation(lambda: box_ops.boxes_iou_bev(rows, rows),
                   "boxes_iou_bev", ("Memset", "boxes_iou_bev_kernel",
                                     "boxes_iou_bev_drain"))


@pytest.mark.parametrize("name", [
    "touching_edges", "touching_corners", "nested", "identical", "rotated_45",
    "far_apart", "zero_size", "zero_size_pairs", "yaw_1e4", "yaw_1e4_both"])
def test_boxes_iou_bev_kernel_on_edge_sets(card, name):
    from isfusion_tpu_torch.testing import iou_bev_edge_sets

    _, a, b = next(s for s in iou_bev_edge_sets() if s[0] == name)
    got, _ = _check_iou_bev(a.to(card), b.to(card))
    if name == "far_apart":
        assert not bool(got.any())


def _check_normal(boxes, scores, valid, thr=0.3):
    before = cuda_build.LAUNCHES["nms_normal_bev"]
    got = box_ops.nms_normal_bev_mask(boxes, scores, thr, valid)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["nms_normal_bev"] == before + 1
    want = box_ops.nms_normal_bev_mask_ref(boxes.cpu(), scores.cpu(), thr,
                                           valid.cpu())
    assert torch.equal(got.cpu(), want)
    return got


@pytest.mark.parametrize("b,c,k", [(2, 10, 1000), (1, 3, 63), (2, 2, 64),
                                   (1, 4, 65), (3, 1, 1), (1, 32, 300),
                                   (1, 10, 2000), (1, 2, 2100), (1, 33, 300),
                                   (1, 64, 300), (1, 2, 3000),
                                   (1, 2, 4097), (1, 1, 6000)])
def test_nms_normal_bev_kernel_matches_plain_version(card, b, c, k):
    gen = torch.Generator().manual_seed(k)
    centre = (torch.rand((b, k, 2), generator=gen) * 2 - 1) * 20
    size = 0.3 + torch.rand((b, k, 2), generator=gen) * 4
    boxes = torch.cat([centre - size / 2, centre + size / 2], -1)
    scores = torch.rand((b, c, k), generator=gen)
    keep = _check_normal(boxes.to(card), scores.to(card),
                         (scores > 0.1).to(card))
    if k >= 64:
        assert 0 < int(keep.sum()) < int((scores > 0.1).sum())


def test_nms_normal_bev_kernel_on_edge_sets(card):
    from isfusion_tpu_torch.testing import nms_normal_edge_sets

    gen = torch.Generator().manual_seed(5)
    for _, boxes, scores, valid in nms_normal_edge_sets(gen):
        _check_normal(boxes.to(card), scores.to(card), valid.to(card))


def test_boxes_iou_bev_kernel_on_a_sorted_merge_set(card):
    """K10-BEV on the set a weighted merge hands it: four views' boxes of
    one scene by descending score, the same object up to four times:
    within 1e-5, exactly 0 where
    the plain version is, and bit-equal over repeated calls with another
    shape between them."""
    from isfusion_tpu_torch.core.post_processing import BEV_COLS, undo_view

    views, metas = _merge_views(torch.Generator().manual_seed(7))
    boxes = torch.cat([undo_view(v["bboxes"], m)
                       for v, m in zip(views, metas)])
    scores = torch.cat([v["scores"] for v in views])
    bev = boxes[torch.sort(scores, descending=True, stable=True).indices][
        :, BEV_COLS].contiguous().to(card)
    got, want = _check_iou_bev(bev, bev)
    assert int((want == 0).sum()) > 0 and int((want > 0.5).sum()) > 0
    small = bev[:37, None].expand(37, 3, 5).transpose(0, 1)
    _check_iou_bev(small, small.flip(1))
    assert torch.equal(box_ops.boxes_iou_bev(bev, bev), got)


def test_boxes_iou_bev_kernel_under_repeats_and_streams(card):
    """K10-BEV on 60 random and score-sorted four-view sets (1-3 samples,
    up to 800 boxes) with the output's memory filled with NaN just before
    each call, so a pair that neither kernel writes shows; 300 repeated
    calls with another shape between them, bit-equal; and 8 sets on two
    streams at once beside matrix products on a third, bit-equal to their
    calls alone."""
    gen = torch.Generator().manual_seed(41)
    cols = [0, 1, 3, 4, 6]

    def four_views(n):
        base = _boxes(gen, n, r=30.0)[:, cols]
        views = torch.cat([base + torch.randn(base.shape, generator=gen) *
                           0.05 for _ in range(4)])
        score = torch.rand(views.shape[0], generator=gen)
        return views[torch.sort(score, descending=True).indices][None]

    for i in range(60):
        if i % 2:
            a = b = four_views(int(torch.randint(20, 200, (1,),
                                                 generator=gen)))
        else:
            s = int(torch.randint(1, 4, (1,), generator=gen))
            n, m = (int(x) for x in torch.randint(1, 300, (2,),
                                                  generator=gen))
            a = torch.stack([_boxes(gen, n, r=20.0)[:, cols]
                             for _ in range(s)])
            b = torch.stack([_boxes(gen, m, r=20.0)[:, cols]
                             for _ in range(s)])
        a, b = a.to(card), b.to(card)
        torch.full((a.shape[0] * a.shape[1] * b.shape[1],), float("nan"),
                   device=card)  # freed at once: the output's block
        _check_iou_bev(a, b)
    x = four_views(202).to(card)
    first = box_ops.boxes_iou_bev(x, x).clone()
    for i in range(300):
        torch.full(first.shape, float("nan"), device=card)
        if i % 7 == 0:
            box_ops.boxes_iou_bev(x[:, :37], x[:, 5:90])
        assert torch.equal(box_ops.boxes_iou_bev(x, x), first)
    sets = [four_views(150).to(card) for _ in range(8)]
    want = [box_ops.boxes_iou_bev(y, y).clone() for y in sets]
    big = torch.randn(2048, 2048, device=card)
    streams = [torch.cuda.Stream() for _ in range(3)]
    torch.cuda.synchronize()
    for _ in range(10):
        with torch.cuda.stream(streams[2]):
            y = big
            for _ in range(4):
                y = y @ big
        outs = []
        for k, y in enumerate(sets):
            with torch.cuda.stream(streams[k % 2]):
                outs.append(box_ops.boxes_iou_bev(y, y))
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))


def _merge_views(gen, n_views=4, per_view=500, num_classes=10):
    """Four views' detections of one scene (``max_num`` 500 each): 150
    objects, each view holding every object jittered plus its own false
    positives, in the view's own frame (flipped as its meta says)."""
    from isfusion_tpu_torch.core.post_processing import undo_view

    metas = [dict(), dict(pcd_horizontal_flip=True),
             dict(pcd_vertical_flip=True),
             dict(pcd_horizontal_flip=True, pcd_vertical_flip=True)]
    objs = torch.cat([(torch.rand((150, 2), generator=gen) * 2 - 1) * 50,
                      torch.rand((150, 1), generator=gen) * -2,
                      0.5 + torch.rand((150, 3), generator=gen) * 4,
                      (torch.rand((150, 1), generator=gen) * 2 - 1) * np.pi,
                      torch.randn((150, 2), generator=gen)], 1)
    obj_labels = torch.randint(0, num_classes, (150,), generator=gen)
    views = []
    for meta in metas[:n_views]:
        extra = per_view - 150
        b = torch.cat([objs + torch.randn((150, 9), generator=gen) * 0.05,
                       objs[torch.randint(0, 150, (extra,), generator=gen)] +
                       torch.randn((extra, 9), generator=gen) * 1.5])
        b[:, 3:6] = b[:, 3:6].abs() + 0.1
        labels = torch.cat([obj_labels, torch.randint(
            0, num_classes, (extra,), generator=gen)])
        scores = torch.rand((per_view,), generator=gen)
        views.append(dict(bboxes=undo_view(b, meta), scores=scores,
                          labels=labels, mask=scores > 0.05))
    return views, metas


def test_merge_of_four_views_of_500_boxes_on_card_matches_cpu(card):
    """The test-time merge at the configs' size: four views of ``max_num``
    500 boxes, 2,000 in one class-agnostic K10-NMS (past the greedy pass's
    shared memory) and ``box3d_multiclass_nms`` over 2,000 x 10 scores, on
    the card and on the CPU: labels and masks equal, boxes and scores
    within 1e-6 of their max; the weighted merge too."""
    from isfusion_tpu_torch.core.post_processing import (
        box3d_multiclass_nms, merge_aug_bboxes_3d)

    views, metas = _merge_views(torch.Generator().manual_seed(12))
    assert box_ops.greedy_smem_bytes(2000) <= box_ops.NMS_SMEM_BYTES
    kw = dict(score_thr=0.05, nms_thr=0.25, max_num=500, merge_thr=0.5)
    boxes = torch.cat([v["bboxes"] for v in views])
    # no pair within float32 rounding of a threshold (0.2, 0.25, 0.5),
    # where the kernel's IoU and the plain one may fall either side
    bev = boxes[None, :, [0, 1, 3, 4, 6]]
    iou = box_ops.boxes_iou_bev_ref(bev, bev)
    assert not any(bool(((iou - t).abs() < 1e-5).any())
                   for t in (0.2, 0.25, 0.5))
    per_class = torch.zeros((len(boxes), 10))
    per_class[torch.arange(len(boxes)), torch.cat(
        [v["labels"] for v in views])] = torch.cat([v["scores"]
                                                    for v in views])
    valid = torch.cat([v["mask"] for v in views])
    out = {}
    for dev in ("cpu", card):
        vs = [{k: t.to(dev) for k, t in v.items()} for v in views]
        before = cuda_build.LAUNCHES["nms_bev"]
        out[str(dev)] = dict(
            plain=merge_aug_bboxes_3d(vs, metas, **kw),
            weighted=merge_aug_bboxes_3d(vs, metas, use_weighted_nms=True,
                                         **kw),
            multiclass=box3d_multiclass_nms(boxes.to(dev),
                                            per_class.to(dev), 0.05, 0.2,
                                            500, valid.to(dev)))
        if dev != "cpu":
            assert cuda_build.LAUNCHES["nms_bev"] == before + 2
    for mode, want in out["cpu"].items():
        got = out["cuda"][mode]
        assert got["bboxes"].is_cuda, mode
        for k in ("labels", "mask"):
            assert torch.equal(got[k].cpu(), want[k]), (mode, k)
        for k in ("bboxes", "scores"):
            scale = want[k].abs().max().clamp_min(1e-30)
            assert float((got[k].cpu() - want[k]).abs().max() / scale) \
                <= 1e-6, (mode, k)
    kept = {k: int(r["mask"].sum()) for k, r in out["cpu"].items()}
    assert all(0 < n <= 500 for n in kept.values()), kept


def test_card_tensors_never_reach_the_plain_versions(card, monkeypatch):
    """K10-BEV and K10-normal on CUDA tensors launch their kernels: their
    plain versions raise if called."""
    def refuse(*_, **__):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(box_ops, "boxes_iou_bev_ref", refuse)
    monkeypatch.setattr(box_ops, "nms_normal_bev_mask_ref", refuse)
    monkeypatch.setattr(box_ops, "greedy_suppress_ref", refuse)
    gen = torch.Generator().manual_seed(3)
    a = _boxes(gen, 40)[:, [0, 1, 3, 4, 6]].to(card)
    assert box_ops.boxes_iou_bev(a, a).is_cuda
    boxes = torch.cat([a[:, :2] - 1, a[:, :2] + 1], -1)[None]
    scores = torch.rand((1, 2, 40), generator=gen).to(card)
    assert box_ops.nms_normal_bev_mask(boxes, scores, 0.3).is_cuda


# --------------------------------------------- KITTI evaluator, ImVoxelNet
def _kitti_eval_case(tmp_path, seed: int = 0):
    """A synthetic KITTI val split (``tools/make_synthetic_kitti.py``) and
    detections around its GT: each GT box jittered by 0.3 m and 10% of
    its size, one far copy and one near duplicate a sample, random
    scores."""
    from isfusion_tpu_torch.datasets import KittiDataset
    from isfusion_tpu_torch.tools.make_synthetic_kitti import make_dataset

    make_dataset(str(tmp_path), train=1, val=6, points=2000, objects=10,
                 seed=seed)
    ds = KittiDataset(ann_file=str(tmp_path / "kitti_infos_val.pkl"),
                      classes=("pedestrian", "cyclist", "car"),
                      test_mode=True)
    rng = np.random.default_rng(seed)
    dets = []
    for i in range(len(ds)):
        ann = ds.get_ann_info(i)
        g, n = ann["gt_bboxes_3d"].numpy(), len(ann["gt_labels_3d"])
        b = np.concatenate([g, g[:1], g[:1]]).astype(np.float32)
        b[:n, :3] += rng.normal(0, 0.3, (n, 3))
        b[:n, 3:6] *= rng.uniform(0.9, 1.1, (n, 3))
        b[n, :2] += 20.0
        b[n + 1, :2] += 0.05
        dets.append(dict(bboxes=b, scores=rng.uniform(0.1, 1, n + 2),
                         labels=np.concatenate([ann["gt_labels_3d"]] +
                                               [ann["gt_labels_3d"][:1]] * 2),
                         mask=np.ones(n + 2, bool)))
    return ds, dets


def test_kitti_eval_iou_calls_on_card_match_plain_versions(card, tmp_path):
    """The KITTI evaluator on the card: each of its K10-BEV and K10 calls
    (one a sample, class and mode; one launch each) within 1e-5 of its
    plain version and exactly 0 where it is; the metrics equal to the
    CPU's (the plain IoU) to 1e-12 unless a pair lies within 1e-5 of a
    threshold."""
    from isfusion_tpu_torch.testing import recording_eval_ious

    ds, dets = _kitti_eval_case(tmp_path)
    before = {k: cuda_build.LAUNCHES[k] for k in ("boxes_iou_bev",
                                                   "boxes_iou_3d")}
    with recording_eval_ious() as seen:
        got = ds.evaluate(dets, device="cuda")
    want = ds.evaluate(dets, device="cpu")
    kinds = [k for k, _, _ in seen]
    assert kinds.count("bev") == kinds.count("3d") >= 6
    assert cuda_build.LAUNCHES["boxes_iou_bev"] - before["boxes_iou_bev"] \
        == kinds.count("bev")
    assert cuda_build.LAUNCHES["boxes_iou_3d"] - before["boxes_iou_3d"] \
        == kinds.count("3d")
    nearest = 1.0
    for kind, a, b in seen:
        assert a.is_cuda and b.is_cuda
        if kind == "bev":
            g, w = _check_iou_bev(a, b)
        else:
            g = box_ops.boxes_iou_3d(a, b)
            w = box_ops.boxes_iou_3d_ref(a.cpu(), b.cpu()).to(card)
            assert float((g - w).abs().max()) <= 1e-5
            assert int((g[w == 0] != 0).sum()) == 0
        for th in (0.7, 0.5):
            if w.numel():
                nearest = min(nearest, float((w - th).abs().min()))
    assert set(got) == set(want) and "car_3d_moderate" in got
    if nearest > 1e-5:
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12, k


def test_tiny_imvoxelnet_predict_on_card_matches_cpu(card):
    """The tiny ImVoxelNet in float32 (TF32 off): head outputs 1e-3 of
    their max; every kept box (K10-NMS on the card, one launch a request)
    with the same labels, boxes and scores 1e-3 of their max."""
    from isfusion_tpu_torch.flagship import build_imvoxelnet
    from isfusion_tpu_torch.testing import pp_kept_boxes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = []
    for dev in ("cpu", "cuda"):
        model, batch_fn = build_imvoxelnet(tiny=True, device=dev, seed=4)
        batch = batch_fn(2, seed=6)
        feats = [x.cpu() for x in model(batch, mode="feats", device=dev)[0]]
        before = cuda_build.LAUNCHES["nms_bev"]
        kept = pp_kept_boxes(model, batch, dev)
        if dev == "cuda":
            assert cuda_build.LAUNCHES["nms_bev"] == before + 1
        runs.append((feats, kept))
    (fc, kc), (fg, kg) = runs

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    for a, b in zip(fg, fc):
        assert rel(a, b) <= 1e-3
    assert len(kc[0]) >= 8 and torch.equal(kg[2], kc[2])
    for a, b in zip(kg[:2], kc[:2]):
        assert rel(a, b) <= 1e-3


# ------------------------------------------------ K14 (the PointNet++ ops)
POINT_SETS = [s[0] for s in point_op_sets(np.random.default_rng(14))]
# the gathers' sets: every set, the ball grid's among them; the NaN sets
# (NaN interpolation weights) are held by their own test
GATHER_SETS = [n for n in POINT_SETS if n not in NAN_SETS]


def _same_or_both_nan(a, b) -> bool:
    """Bit-equal, NaN where the other is NaN."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


def _point_set(name, card):
    for s in point_op_sets(np.random.default_rng(14)):
        if s[0] == name:
            xyz, mask, q = (torch.from_numpy(a).to(card) for a in s[1:4])
            return xyz, mask, q, s[4], s[5], s[6]
    raise KeyError(name)


def _launched(name, fn):
    before = cuda_build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("name", POINT_SETS)
def test_k14_index_kernels_match_plain_versions(card, name):
    """K14-FPS, K14-ball and K14-NN (k = 1, 3, 8, 16) bit-equal to their
    plain versions on the adversarial sets: indices, valid flags, squared
    distances (NaN where the plain version's are)."""
    xyz, mask, q, radius, k, s = _point_set(name, card)
    got = _launched("furthest_point_sample",
                    lambda: pn.furthest_point_sample(xyz, s, mask))
    assert torch.equal(got, pn.furthest_point_sample_ref(xyz, s, mask))
    got = _launched("ball_query", lambda: pn.ball_query(radius, k, xyz, q,
                                                        mask))
    want = pn.ball_query_ref(radius, k, xyz, q, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for kk in (1, 3, 8, 16):
        if kk <= xyz.shape[1]:
            got = _launched("three_nn", lambda: pn.knn(kk, xyz, q, mask))
            want = pn.knn_ref(kk, xyz, q, mask)
            assert torch.equal(got[0], want[0]), kk
            assert _same_or_both_nan(got[1], want[1]), kk


@pytest.mark.parametrize("name", GATHER_SETS)
def test_k14_gathers_match_plain_versions(card, name):
    """K14-gather's three forms bit-equal forward to the plain versions on
    every set, the ball grid's crowded balls among them (the rows' width
    and storage offset from ``POINT_SET_ROWS``), the no-grad call equal to
    the grad call; the features' gradient within 1e-6 of the max of the
    float32 sums in slot order (``testing.slot_order_grad``; plain float32
    autograd sums a row's slots by atomics, in no fixed order, and a
    float64 sum parts from a long row's float32 sum by more than that),
    the weights' gradient within 1e-6 of the max of the plain version's
    float64 one, and two kernel backwards bit-equal; one forward launch a call, and a backward's
    launches (one per gradient) beside one list of K1's list stage, none
    counted as K2's."""
    xyz, mask, q, radius, k, s = _point_set(name, card)
    c, offset = POINT_SET_ROWS.get(name, (7, 0))
    gen = torch.Generator(card).manual_seed(5)
    feats = torch.randn(xyz.shape[:2] + (c,), generator=gen, device=card)
    fps = pn.furthest_point_sample_ref(xyz, s, mask)
    gi, _ = pn.ball_query_ref(radius, k, xyz, q, mask)
    ni, d2 = pn.knn_ref(3, xyz, q, mask)
    w = pn.interpolation_weights(torch.sqrt(d2.clamp_min(1e-10)))
    for op, idx, weight in (("gather_points", fps, None),
                            ("group_points", gi, None),
                            ("three_interpolate", ni, w)):
        extra = () if weight is None else (weight,)
        _, view = offset_rows(feats, offset, card)
        with torch.no_grad():
            lean = _launched("point_gather",
                             lambda: getattr(pn, op)(view, idx, *extra))
        grads = []
        for _ in range(2):
            base, f = offset_rows(feats, offset, card, requires_grad=True)
            wt = tuple(e.clone().requires_grad_(True) for e in extra)
            out = getattr(pn, op)(f, idx, *wt)
            g = torch.randn(out.shape, generator=torch.Generator(
                card).manual_seed(9), device=card)
            before = dict(cuda_build.LAUNCHES)
            out.backward(g)
            torch.cuda.synchronize()
            launched = {key: cuda_build.LAUNCHES[key] - before[key]
                        for key in ("point_gather", "point_gather_layout",
                                    "segment_layout")}
            assert launched == dict(point_gather=1 + len(wt),
                                    point_gather_layout=1,
                                    segment_layout=0), (op, launched)
            grads.append((out.detach(), base.grad[offset:].view(
                feats.shape)) + tuple(e.grad for e in wt))
        with torch.no_grad():
            plain = getattr(pn, op + "_ref")(feats, idx, *extra)
        f64 = feats.double().requires_grad_(True)
        w64 = tuple(e.double().requires_grad_(True) for e in extra)
        getattr(pn, op + "_ref")(f64, idx, *w64).backward(g.double())
        b = idx.shape[0]
        want = [slot_order_grad(idx.reshape(b, -1), feats.shape[1], g,
                                *extra).to(card)] + [e.grad.float()
                                                    for e in w64]
        (o1, *g1), (o2, *g2) = grads
        assert torch.equal(o1, plain), op
        assert torch.equal(o2, plain), op
        assert torch.equal(lean, o1), op
        for a, b_, c_ in zip(g1, g2, want):
            assert torch.equal(a, b_), op
            assert float((a - c_).abs().max()) <= 1e-6 * max(
                float(c_.abs().max()), 1e-30), op


@pytest.mark.parametrize("name", GATHER_SETS + ["one_row", "long_rows"])
def test_k14_slot_lists_match_plain_version(card, name):
    """K14-gather's list (the CSR of the slots that read each source row,
    each row's in increasing order), held through the backward that builds
    it: the features' gradient bit-equal to the sums in slot order, for
    group_points on the balls of each set and three_interpolate on its
    neighbours (rows of 5 floats); on 3,000 slots of one row, and on SA2's
    32 x 1,024 slots with most of them on a few rows (rows of 8 floats;
    rows past a warp's 256 slots take a block's bitmap order). One list
    counted a backward, none as K2's."""
    gen = torch.Generator(card).manual_seed(3)
    if name == "one_row":
        n = 5
        cases = [("group_points", torch.full((2, 1500, 1), 3,
                                             dtype=torch.int32,
                                             device=card), None)]
    elif name == "long_rows":
        n = 2048
        idx = torch.randint(0, n, (1, 1024, 32), generator=gen,
                            device=card, dtype=torch.int32)
        few = torch.tensor([0, 7, 100, n - 1], dtype=torch.int32,
                           device=card)
        pick = torch.rand(idx.shape, generator=gen, device=card) < 0.8
        idx = torch.where(pick, few[idx % 4], idx)
        cases = [("group_points", idx, None)]
    else:
        xyz, mask, q, radius, k, _ = _point_set(name, card)
        n = xyz.shape[1]
        gi, _ = pn.ball_query_ref(radius, k, xyz, q, mask)
        ni, d2 = pn.knn_ref(3, xyz, q, mask)
        w = pn.interpolation_weights(torch.sqrt(d2.clamp_min(1e-10)))
        cases = [("group_points", gi, None), ("three_interpolate", ni, w)]
    for op, idx, weight in cases:
        b = idx.shape[0]
        # rows of 5 floats a lane each, of 8 as float4 (aligned)
        c = 5 if name in POINT_SETS else 8
        feats = torch.randn((b, n, c), generator=gen, device=card
                            ).requires_grad_(True)
        extra = () if weight is None else (weight,)
        out = getattr(pn, op)(feats, idx, *extra)
        g = torch.randn(out.shape, generator=gen, device=card)
        before = dict(cuda_build.LAUNCHES)
        out.backward(g)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["point_gather_layout"] == \
            before["point_gather_layout"] + 1
        assert cuda_build.LAUNCHES["segment_layout"] == \
            before["segment_layout"]
        want = slot_order_grad(idx.reshape(b, -1), n, g, weight)
        assert torch.equal(feats.grad.cpu(), want), (name, op)


# (set, cluster) for each K14-FPS route and the sets it takes (one block:
# N <= 4,096; a cluster of C: N <= 8,192 x C)
FPS_ROUTES = [(name, cluster) for name, xyz, *_ in point_op_sets(
    np.random.default_rng(14)) for cluster in (1, 8, 16)
              if xyz.shape[1] <= (4096 if cluster == 1 else 8192 * cluster)]


@pytest.mark.parametrize("name,route", FPS_ROUTES)
def test_k14_fps_routes_match_plain_version(card, name, route):
    """Every route of K14-FPS (one block a sample, a cluster of 8 or 16
    blocks) bit-equal to the plain version on the sets that route
    takes."""
    xyz, mask, _, _, _, s = _point_set(name, card)
    got = _launched("furthest_point_sample", lambda: pn.fps_launch(
        xyz, s, mask, route))
    assert torch.equal(got, pn.furthest_point_sample_ref(xyz, s, mask))


# (set, route) for each K14-ball route on the sets whose radius the grid
# takes: the scan, the grid with its default table, the grid with 4
# buckets (every cell collides)
BALL_ROUTES = [(name, route) for name, *_, radius, _, _ in point_op_sets(
    np.random.default_rng(14)) if pn.ball_grid_params(radius) is not None
               for route in ("scan", "grid", "grid_4_buckets")]


@pytest.mark.parametrize("name,route", BALL_ROUTES)
def test_k14_ball_routes_match_plain_version(card, name, route):
    """Every route of K14-ball bit-equal to the plain version: indices and
    valid flags, one launch a call."""
    xyz, mask, q, radius, k, _ = _point_set(name, card)
    got = _launched("ball_query", lambda: pn.ball_query_launch(
        radius, k, xyz, q, mask, grid=route != "scan",
        table_bits=2 if route == "grid_4_buckets" else None))
    want = pn.ball_query_ref(radius, k, xyz, q, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("route", ["scan", "grid"])
def test_k14_ball_on_nan_coordinates_matches_plain_version(card, route):
    """NaN queries and NaN points: K14-ball's indices and valid flags by
    either route equal the plain version's, every index inside [0, N) (a
    ball with no point takes the nearest, and a NaN distance ranks first
    as in torch's argmin: a NaN query takes its sample's first valid
    point, an empty ball of a sample with an unmasked NaN point takes
    that point), and K14-gather groups by them as its plain version."""
    rng = np.random.default_rng(21)
    n = 5000
    xyz = rng.uniform(0, 4, (2, n, 3)).astype(np.float32)
    mask = np.ones((2, n), bool)
    xyz[0, 10, 2] = np.nan
    xyz[1, 0] = np.nan
    mask[1, :2] = False
    xyz[1, 7, 0] = np.nan
    q = xyz[:, 100:164].copy()
    q[0, :4] = np.nan
    q[1, 5, 1] = np.nan
    q[:, 6] = 100.0
    xyz, mask, q = (torch.from_numpy(a).to(card) for a in (xyz, mask, q))
    got = _launched("ball_query", lambda: pn.ball_query_launch(
        0.2, 16, xyz, q, mask, grid=route == "grid"))
    want = pn.ball_query_ref(0.2, 16, xyz, q, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0].min()) >= 0 and int(got[0].max()) < n
    assert (got[0][0, :4] == 0).all() and (got[0][1, 5] == 2).all()
    assert (got[0][1, 6] == 7).all()
    feats = torch.randn((2, n, 8), device=card)
    grouped = _launched("point_gather", lambda: pn.group_points(feats,
                                                                got[0]))
    assert torch.equal(grouped, pn.group_points_ref(feats, got[0]))


@pytest.mark.parametrize("name", POINT_SETS)
def test_k14_knn_past_16_matches_plain_version(card, name):
    """K14-NN at k = 16, 17, 32, 64 and k = N (up to 6,000 points) equal
    to the plain version bit for bit: ties, duplicates, masked sources."""
    xyz, mask, q, _, _, _ = _point_set(name, card)
    n = xyz.shape[1]
    for kk in sorted({16, 17, 32, 64} | ({n} if n <= 6000 else set())):
        if kk <= n:
            got = _launched("three_nn", lambda: pn.knn(kk, xyz, q, mask))
            want = pn.knn_ref(kk, xyz, q, mask)
            assert torch.equal(got[0], want[0]), kk
            assert _same_or_both_nan(got[1], want[1]), kk


@pytest.mark.parametrize("route", ["block", "cluster8", "cluster16", "tail",
                                   "knn"])
def test_k14_fps_and_knn_on_nan_coordinates(card, route):
    """``NAN_SETS`` by every route: K14-FPS's picks (one block, clusters of
    8 and 16, and the tail route on a 70,000-point cloud whose samples hold
    NaN points in registers and in the tail, one sample all NaN, NaN next
    to masked rows) and K14-NN's indices (k = 1, 3, 4, 5, 16, 17 and 40:
    both instances and the rounds past 16) bit-equal to the plain
    versions', distances NaN where theirs are, every index inside [0,
    N)."""
    for name in NAN_SETS:
        xyz, mask, q, _, _, s = _point_set(name, card)
        n = xyz.shape[1]
        if route == "knn":
            for kk in (1, 3, 4, 5, 16, 17, 40):
                got = _launched("three_nn", lambda: pn.knn(kk, xyz, q, mask))
                want = pn.knn_ref(kk, xyz, q, mask)
                assert torch.equal(got[0], want[0]), kk
                assert _same_or_both_nan(got[1], want[1]), kk
                assert int(got[0].min()) >= 0 and int(got[0].max()) < n
            continue
        if route == "tail":
            n = 70_000
            xyz, mask, _ = fps_large_cloud(n, card)
            gen = torch.Generator(card).manual_seed(3)
            rows = torch.randint(1, n - 1, (40,), generator=gen,
                                 device=card)
            xyz[0, rows[:20], 0] = float("nan")          # registers, tail
            xyz[0, n - 100:n - 90, 2] = float("nan")     # the last share
            mask[0, rows[:5] + 1] = False
            xyz[1] = float("nan")
            s = 300
        cluster = dict(block=1, cluster8=8, cluster16=16, tail=8)[route]
        got = _launched("furthest_point_sample", lambda: pn.fps_launch(
            xyz, s, mask, cluster))
        assert torch.equal(got, pn.furthest_point_sample_ref(xyz, s, mask))
        assert int(got.min()) >= 0 and int(got.max()) < n


def test_k14_at_votenets_first_level(card):
    """The first SA level's shapes: FPS 40,000 -> 2,048 and the ball query
    (K 64, r 0.2) on a synthetic room, K14-NN at the FP shape (1,024 over
    512), each equal to its plain version."""
    from isfusion_tpu_torch.flagship import synthetic_indoor_batch

    pts = torch.from_numpy(synthetic_indoor_batch(1, seed=2)["points"]).to(
        card)
    xyz = pts[..., :3].contiguous()
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=card)
    fps = pn.furthest_point_sample(xyz, 2048, mask)
    assert torch.equal(fps, pn.furthest_point_sample_ref(xyz, 2048, mask))
    q = pn.gather_points(xyz, fps)
    got = pn.ball_query(0.2, 64, xyz, q, mask)
    want = pn.ball_query_ref(0.2, 64, xyz, q, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = pn.knn(3, q[:, :512], q[:, :1024])
    want = pn.knn_ref(3, q[:, :512], q[:, :1024])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# K14-FPS past a cluster's registers: at and past 50,000 points, around
# 65,536 (8 blocks' 8,192 points in registers) and twice and three times
# that (the tail route streams the rest)
FPS_LARGE_N = (50_000, 50_001, 65_536, 65_537, 100_000, 200_000)


@pytest.mark.parametrize("n", FPS_LARGE_N)
def test_k14_fps_past_shared_memory_and_knn_past_its_k(card, n):
    """K14-FPS takes any N: on ``testing.fps_large_cloud``'s batch of 2
    clouds of N points, the second with its first 3 points and its last
    quarter masked, the picks are bit-equal to the plain version's (the
    first valid point first; the lowest index among ties, which decide
    the first picks: a block's register point against its thread's tail
    copy and another block's, and within a tail against the thread's next
    tail point and the next lane's), by the route the wrapper takes and by
    clusters of 8 and 16 (the tail route wherever N passes 8,192 x C), one
    launch a call. K14-NN answers k > 16 (its rounds of 16) as the plain
    version does."""
    xyz, mask, ties = fps_large_cloud(n, card)
    want = pn.furthest_point_sample_ref(xyz, 512, mask)
    assert int(want[1, 0]) == 3
    assert torch.equal(want[:, 1:1 + ties.shape[1]], ties)
    got = _launched("furthest_point_sample",
                    lambda: pn.furthest_point_sample(xyz, 512, mask))
    assert torch.equal(got, want)
    for cluster in (8, 16):
        got = _launched("furthest_point_sample", lambda: pn.fps_launch(
            xyz, 512, mask, cluster))
        assert torch.equal(got, want), cluster
    src, q = xyz[:, :100].contiguous(), xyz[:, :8].contiguous()
    got = _launched("three_nn", lambda: pn.knn(17, src, q))
    want = pn.knn_ref(17, src, q)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


_BAD_INDEX = """
import sys
import torch
from isfusion_tpu_torch.ops import pointnet_ops as pn
form, bad, dev = sys.argv[1], int(sys.argv[2]), sys.argv[3]
feats = torch.randn(2, 10, 3, device=dev)
shape = {"gather_points": (2, 4), "group_points": (2, 4, 2),
         "three_interpolate": (2, 4, 3)}[form]
idx = torch.zeros(shape, dtype=torch.int32, device=dev)
idx.view(-1)[-2] = bad
extra = (torch.full(shape, 1 / 3, device=dev),) \
    if form == "three_interpolate" else ()
getattr(pn, form)(feats, idx, *extra)
torch.cuda.synchronize()
print("no error")
"""


@pytest.mark.parametrize("form,bad", [("gather_points", 10),
                                      ("group_points", -1),
                                      ("three_interpolate", 10)])
def test_k14_gather_fails_on_an_index_out_of_range(card, form, bad):
    """An index outside the source rows stops K14-gather with a CUDA error,
    where the plain version on the CPU raises: the kernel reads no other
    row in its place. The error loses the card's context, so the card's
    case runs in a process of its own."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    runs = {dev: subprocess.run(
        [sys.executable, "-c", _BAD_INDEX, form, str(bad), dev], cwd=root,
        capture_output=True, text=True, timeout=300) for dev in ("cpu",
                                                                 "cuda")}
    for dev, res in runs.items():
        assert res.returncode != 0 and "no error" not in res.stdout, dev
    assert "index" in runs["cpu"].stderr.lower(), runs["cpu"].stderr
    assert "CUDA error" in runs["cuda"].stderr, runs["cuda"].stderr[-2000:]


@pytest.mark.parametrize("name", ["votenet", "h3d"])
def test_tiny_votenet_on_card_matches_cpu(card, name):
    """The tiny VoteNet / H3DNet in float32 (TF32 off), its GT boxes on
    the CPU model's proposals: head outputs 1e-3 of their max (indices and
    masks equal), predict (mask and labels equal, boxes 1e-3), losses 1e-4
    relative, gradients 1e-3 of their max; every K14 kernel launched in
    the card's predict and loss."""
    from isfusion_tpu_torch.flagship import build_h3dnet, build_votenet
    from isfusion_tpu_torch.testing import indoor_positives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = build_votenet if name == "votenet" else build_h3dnet
    cpu_model, batch_fn = build(tiny=True, device="cpu", seed=1)
    batch = indoor_positives(cpu_model, batch_fn(2, seed=3), "cpu")
    runs = []
    for dev in ("cpu", "cuda"):
        model, _ = build(tiny=True, device=dev, seed=1)
        cuda_build.reset_launches()
        feats = {k: v.cpu() for k, v in model(batch, mode="feats",
                                              device=dev).items()}
        pred = {k: v.cpu() for k, v in model(batch, device=dev).items()}
        model.train()
        losses = model(batch, mode="loss", device=dev)
        sum(losses.values()).backward()
        if dev == "cuda":
            assert all(cuda_build.LAUNCHES[k] > 0 for k in (
                "furthest_point_sample", "ball_query", "three_nn",
                "point_gather"))
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        runs.append((feats, pred, {k: float(v) for k, v in
                                   losses.items()}, grads))
    (fc, pc, lc, gc), (fg, pg, lg, gg) = runs

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() /
                     b.float().abs().max().clamp_min(1e-30))

    for k, v in fc.items():
        if v.is_floating_point():
            assert rel(fg[k], v) <= 1e-3, k
        else:
            assert torch.equal(fg[k], v), k
    assert torch.equal(pg["mask"], pc["mask"])
    assert torch.equal(pg["labels"], pc["labels"])
    assert rel(pg["bboxes"], pc["bboxes"]) <= 1e-3
    for k, v in lc.items():
        assert v > 0 and abs(lg[k] - v) <= 1e-4 * abs(v), k
    for top in sorted({n.split(".")[0] for n in gc}):
        names = [n for n in gc if n.split(".")[0] == top]
        assert rel(torch.cat([gg[n].flatten() for n in names]),
                   torch.cat([gc[n].flatten() for n in names])) <= 1e-3, top


# ------------------------------------------------ K15 (PAConv, paconv.cu)
def _rel(a, b) -> float:
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a.double() - b).abs().max()) / max(scale, 1e-30) \
        if a.numel() else 0.0


# (R, C, M, O, case): paconvseg's SA1 layer 1 at batch 2, a masked ball's
# zero rows ("zero"), M = 1, O off the 32 / 64 tiles, odd C, 1 row; SA4's
# layer 3 at serve (512 rows: the depth split over blocks), one row past
# 32,768 tiles of 128 rows (the old grid's 65,535 tiles of 64), rows of x
# scaled by 2^20, 1 or 2^-20 ("wide": the TF32 split at large and tiny
# exponents)
BANK_SETS = dict(sa1=(65536, 18, 16, 32, None),
                 sa4=(1024, 518, 16, 256, None),
                 rows_zero=(2048, 18, 16, 32, "zero"),
                 m1=(3000, 64, 1, 64, None),
                 o37=(1000, 130, 16, 37, None), o70=(777, 64, 4, 70, None),
                 c7=(2500, 7, 8, 33, None), r1=(1, 18, 16, 32, None),
                 sa4_serve=(512, 512, 16, 512, None),
                 rows_past_grid=(4194305, 8, 1, 8, None),
                 wide_range=(4096, 64, 16, 64, "wide"))


@pytest.mark.parametrize("name", sorted(BANK_SETS))
def test_k15_bank_matches_plain_version(card, name):
    """K15-bank forward and backward (dX, dS, dW) within 1e-5 of the max
    of the plain version's float64 values on the same inputs, the
    gradients bit-equal over two calls; one launch a forward, two a
    backward (dX with dS, then dW)."""
    from isfusion_tpu_torch.ops import paconv
    r, c, m, o, case = BANK_SETS[name]
    gen = torch.Generator(card).manual_seed(r + c)
    x = torch.randn((r, c), generator=gen, device=card)
    if case == "zero":
        x.zero_()
    elif case == "wide":
        e = torch.randint(-1, 2, (r, 1), generator=gen, device=card)
        x = x * torch.exp2(20.0 * e)
    s = torch.softmax(torch.randn((r, m), generator=gen, device=card), -1)
    w = torch.randn((c, m * o), generator=gen, device=card) / c ** 0.5
    g = torch.randn((r, o), generator=gen, device=card)
    runs = []
    for _ in range(2):
        ins = [a.clone().requires_grad_(True) for a in (x, s, w)]
        out = _launched("paconv_bank", lambda: paconv.paconv_bank(*ins))
        before = cuda_build.LAUNCHES["paconv_bank"]
        out.backward(g)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["paconv_bank"] == before + 2
        runs.append([out.detach()] + [a.grad for a in ins])
    ins = [a.double().requires_grad_(True) for a in (x, s, w)]
    want = paconv.paconv_bank_ref(*ins)
    want.backward(g.double())
    for got, ref in zip(runs[0], [want.detach()] + [a.grad for a in ins]):
        assert _rel(got, ref) <= 1e-5, name
    for a, b in zip(runs[0][1:], runs[1][1:]):
        assert torch.equal(a, b), name
    with torch.no_grad():
        assert torch.equal(paconv.paconv_bank(x, s, w), runs[0][0])


# (B, N, S, K, M, O, aggregate, case): paconvseg's SA1 train shape, one
# row named by every slot of a sample, M = 1 with O = 37 (avg), K = 1
SCORE_SETS = dict(sa1_train=((8, 4096, 1024, 32, 16, 32), "sum", None),
                  one_row=((2, 300, 64, 16, 4, 37), "sum", "one_row"),
                  m1_o37=((2, 500, 64, 8, 1, 37), "avg", None),
                  k1=((1, 200, 100, 1, 16, 32), "sum", None))


@pytest.mark.parametrize("name", sorted(SCORE_SETS))
def test_k15_score_matches_plain_version(card, name):
    """K15-score forward and the gradients of the scores and both
    features within 1e-5 of the max of the plain version's float64
    values, knn with repeated indices and rows named by no slot (the last
    10% of N), the gradients bit-equal over two calls; one launch a
    forward, three a backward."""
    from isfusion_tpu_torch.ops import paconv
    (b, n, s, k, m, o), agg, case = SCORE_SETS[name]
    gen = torch.Generator(card).manual_seed(n + s)
    sc = torch.softmax(torch.randn((b, s, k, m), generator=gen,
                                   device=card), -1)
    pf = torch.randn((b, n, m, o), generator=gen, device=card)
    cf = torch.randn((b, n, m, o), generator=gen, device=card)
    knn = torch.randint(0, int(n * 0.9), (b, s, k), generator=gen,
                        device=card, dtype=torch.int32)
    rep = torch.rand((b, s, k), generator=gen, device=card) < 0.3
    knn = torch.where(rep, knn[..., :1], knn)
    if case == "one_row":
        knn[0] = 3
    g = torch.randn((b, s, k, o), generator=gen, device=card)
    runs = []
    for _ in range(2):
        ins = [a.clone().requires_grad_(True) for a in (sc, pf, cf)]
        out = _launched("paconv_score", lambda: paconv.assign_score_withk(
            *ins, knn, agg))
        before = cuda_build.LAUNCHES["paconv_score"]
        out.backward(g)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["paconv_score"] == before + 3
        runs.append([out.detach()] + [a.grad for a in ins])
    ins = [a.double().requires_grad_(True) for a in (sc, pf, cf)]
    want = paconv.assign_score_withk_ref(*ins, knn, agg)
    want.backward(g.double())
    for got, ref in zip(runs[0], [want.detach()] + [a.grad for a in ins]):
        assert _rel(got, ref) <= 1e-5, name
    for a, c in zip(runs[0][1:], runs[1][1:]):
        assert torch.equal(a, c), name
    assert not runs[0][2][:, int(n * 0.9):].any()


def test_k15_tiny_segmentors_on_card_match_cpu(card):
    """The tiny PointNet++ and PAConv segmentors in float32 (TF32 off) on
    the card against the CPU, dropout off: logits 1e-3 of their max, the
    loss 1e-4 relative, the gradients 1e-3 of their max; K15-bank in the
    PAConv forward and backward."""
    from isfusion_tpu_torch import flagship
    torch.backends.cuda.matmul.allow_tf32 = False
    for build in (flagship.build_pointnet2seg, flagship.build_paconvseg):
        res = []
        for d in ("cuda", "cpu"):
            model, batch_fn = build(tiny=True, device=d, seed=1)
            model.decode_head.dropout_ratio = 0.0
            batch = batch_fn(2, seed=3)
            before = cuda_build.LAUNCHES["paconv_bank"]
            logits = model(batch, mode="feats", device=d).cpu()
            model.train()
            loss = model(batch, mode="loss", device=d)["loss_sem_seg"]
            loss.backward()
            if d == "cuda" and build is flagship.build_paconvseg:
                assert cuda_build.LAUNCHES["paconv_bank"] > before
            res.append((logits, float(loss), torch.cat([
                p.grad.cpu().flatten() for p in model.parameters()])))
        (lg, sg, gg), (lc, sc, gc) = res
        assert float((lg - lc).abs().max()) <= 1e-3 * float(lc.abs().max())
        assert abs(sg - sc) <= 1e-4 * abs(sc)
        assert float((gg - gc).abs().max()) <= 1e-3 * float(gc.abs().max())


# ------------------------------------------------------------------ K17
SST_SETS = ("random", "clustered", "masked", "multi_sample", "cap_binding",
            "three_d", "window_2d", "one_voxel")


def _sst_set(name):
    from isfusion_tpu_torch.testing import sst_partition_sets
    coords, valid, cfg = sst_partition_sets()[name]
    return torch.from_numpy(coords), torch.from_numpy(valid), cfg


def _sst_part(coords, valid, cfg, shift, ref=False):
    from isfusion_tpu_torch.ops import sst_window as sw
    args = (coords, valid, cfg["sparse_shape"], cfg["window_shape"],
            cfg["drop_info"])
    if ref:
        caps = sw.level_caps(cfg["drop_info"], cfg["win_caps"],
                             coords.shape[1], sw.num_windows(
                                 cfg["sparse_shape"], cfg["window_shape"]))
        return sw.sst_partition_ref(*args, caps, shift)
    return sw.sst_partition(*args, cfg["win_caps"], shift)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("name", SST_SETS)
def test_k17_partition_matches_plain_version(card, name, shift):
    """K17-part: every output bit-equal to the plain version's on the
    CPU (one launch-call)."""
    coords, valid, cfg = _sst_set(name)
    got = _launched("sst_partition", lambda: _sst_part(
        coords.to(card), valid.to(card), cfg, shift))
    want = _sst_part(coords, valid, cfg, shift, ref=True)
    assert got.levels == want.levels and got.canvas == want.canvas
    for f in got._fields:
        a = getattr(got, f)
        if torch.is_tensor(a):
            assert torch.equal(a.cpu(), getattr(want, f)), (name, f)


@pytest.mark.parametrize("dtype,c", [("float32", 128), ("float32", 5),
                                     ("bfloat16", 128), ("bfloat16", 3)])
@pytest.mark.parametrize("name", ["clustered", "multi_sample",
                                  "cap_binding", "three_d"])
def test_k17_moves_match_plain_autograd(card, name, dtype, c):
    """K17-move ops 0-2 (rows of 16-, 10- and 6-byte widths): forward and
    every input's gradient equal to the plain versions under autograd on
    the card, one launch a forward and a backward."""
    from isfusion_tpu_torch.ops import sst_window as sw
    coords, valid, cfg = _sst_set(name)
    part = _sst_part(coords.to(card), valid.to(card), cfg, True)
    gen = torch.Generator(card).manual_seed(3)
    b, v = valid.shape

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=card).to(
            getattr(torch, dtype))

    feats = rand(b, v, c)
    toks = [rand(b, cap, t, c) for t, cap in part.levels]
    cases = (("flat_to_window", lambda f, ts: sw.flat_to_window(f, part),
              lambda f, ts: sw.flat_to_window_ref(f, part)),
             ("window_to_flat",
              lambda f, ts: [sw.window_to_flat(ts, part, f)],
              lambda f, ts: [sw.window_to_flat_ref(ts, part, f)]),
             ("flat_to_canvas", lambda f, ts: [sw.flat_to_canvas(f, part)],
              lambda f, ts: [sw.flat_to_canvas_ref(f, part)]))
    for op, fn, ref in cases:
        res = []
        for f_ in (fn, ref):
            f = feats.clone().requires_grad_(True)
            ts = [t.clone().requires_grad_(True) for t in toks]
            before = cuda_build.LAUNCHES["sst_move"]
            y = f_(f, ts)
            gs = [rand(*t.shape) for t in y] if not res else res[0][2]
            torch.autograd.backward(y, gs)
            torch.cuda.synchronize()
            res.append((y, [f.grad] + [t.grad for t in ts], gs,
                        cuda_build.LAUNCHES["sst_move"] - before))
        (y, g, _, n), (yr, gr, _, nr) = res
        assert nr == 0 and n == (3 if op == "window_to_flat" else 2), op
        for a, b_ in zip(y, yr):
            assert torch.equal(a, b_), op
        for a, b_ in zip(g, gr):
            assert (a is None) == (b_ is None) or not b_.any(), op
            if a is not None:
                assert torch.equal(a, b_), op
        with torch.no_grad():
            half = fn(feats, toks)
        for a, b_ in zip(half, y):
            assert torch.equal(a, b_), op


def test_k17_sst_on_card_matches_cpu(card):
    """The tiny SSTv2Sparse (two drop levels) on the card against the CPU
    from the same weights and inputs, float32 with TF32 off: canvas and
    every gradient within 1e-3 of the max; K17 in forward and backward."""
    from isfusion_tpu_torch import flagship
    torch.backends.cuda.matmul.allow_tf32 = False
    res = []
    for d in ("cuda", "cpu"):
        model, batch_fn = flagship.build_sst_sparse("tiny", device=d, seed=1)
        inputs = flagship.sst_sparse_inputs(batch_fn(2, seed=2), "tiny", 16,
                                            "cpu", seed=3)
        before = dict(cuda_build.LAUNCHES)
        out = model(*(t.to(d) for t in inputs))
        (out ** 2).sum().backward()
        if d == "cuda":
            torch.cuda.synchronize()
            assert cuda_build.LAUNCHES["sst_partition"] == \
                before["sst_partition"] + 4
            assert cuda_build.LAUNCHES["sst_move"] > before["sst_move"] + 4
        res.append((out.detach().cpu(), torch.cat([
            p.grad.cpu().flatten() for p in model.parameters()])))
    (oc, gc), (o, g) = res
    assert float((oc - o).abs().max()) <= 1e-3 * float(o.abs().max())
    assert float((gc - g).abs().max()) <= 1e-3 * float(g.abs().max())


@pytest.mark.parametrize("nms_type", ["circle", "rotate"])
def test_transfusion_nms_on_card_matches_cpu(card, nms_type):
    """TransFusionHeadV2.get_bboxes with per-task NMS on the card against
    the CPU: masks and labels equal, scores within 1e-6; one K10-circle
    or K10-NMS launch a task with a radius."""
    from isfusion_tpu_torch.models.dense_heads.transfusion_head import \
        TransFusionHeadV2
    gen = np.random.default_rng(5)
    b, p, nc = 2, 200, 10
    preds = dict(heatmap=gen.normal(size=(b, p, nc)),
                 center=gen.uniform(60, 120, (b, p, 2)),
                 height=gen.normal(size=(b, p, 1)),
                 dim=np.log(gen.uniform(0.5, 2.5, (b, p, 3))),
                 rot=gen.normal(size=(b, p, 2)),
                 vel=gen.normal(size=(b, p, 2)),
                 query_heatmap_score=gen.uniform(0.1, 1.0, (b, p, nc)))
    preds = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in preds.items()}
    preds["query_labels"] = torch.from_numpy(gen.choice(
        [0, 1, 8, 9], (b, p))).long()
    common = dict(pc_range=[-54.0, -54.0], voxel_size=[0.075, 0.075],
                  out_size_factor=8)
    coder = dict(type="TransFusionBBoxCoder", **common,
                 post_center_range=[-61.2, -61.2, -10, 61.2, 61.2, 10],
                 score_threshold=0.0, code_size=10)
    tasks = [dict(indices=[0, 1], radius=0.7), dict(indices=[8], radius=0.175),
             dict(indices=[9], radius=0.175)]
    head = TransFusionHeadV2(num_proposals=p, num_classes=nc, in_channels=8,
                             hidden_channel=8, num_decoder_layers=1,
                             num_heads=2, ffn_channel=8, bbox_coder=coder,
                             test_cfg=dict(nms_type=nms_type, tasks=tasks,
                                           **common))
    kernel = "nms_circle" if nms_type == "circle" else "nms_bev"
    before = cuda_build.LAUNCHES[kernel]
    got = head.get_bboxes({k: v.to(card) for k, v in preds.items()})
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[kernel] == before + 3
    want = head.get_bboxes(preds)
    for key in ("mask", "labels"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert float((got["scores"].cpu() - want["scores"]).abs().max()) <= 1e-6
    head.test_cfg = dict(common)
    free = head.get_bboxes(preds)
    assert (free["mask"] & ~want["mask"]).any()      # NMS suppressed boxes
