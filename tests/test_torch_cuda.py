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
the IoU one device operation a call, the IoU exactly 0 wherever its
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
parameters 1e-3 of each module's max) with one all-reduce.
"""
import contextlib

import pytest
import torch

import numpy as np

from isfusion_tpu_torch.ops import (box_ops, cuda_build, gaussian, scatter,
                                    sparse_conv, voxel)
from isfusion_tpu_torch.ops.gather import masked_gather, masked_gather_ref

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
    # each unordered pair is computed once and mirrored
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
    """K = 1,344 at 32 classes fills the greedy pass's shared memory
    ((32 + 1344) * 21 words); K = 1,345 is refused at any class count."""
    assert box_ops.nms_smem_bytes(32, 1344) <= box_ops.NMS_SMEM_BYTES
    assert box_ops.nms_smem_bytes(1, 1345) > box_ops.NMS_SMEM_BYTES
    gen = torch.Generator().manual_seed(0)
    boxes, scores, valid = (t.to(card) for t in _nms_inputs(gen, 1, 32,
                                                            1344))
    before = cuda_build.LAUNCHES["nms_bev"]
    got = box_ops.nms_bev_mask(boxes, scores, 0.2, valid)
    assert cuda_build.LAUNCHES["nms_bev"] == before + 1
    bits = box_ops.nms_bev_suppression_bits(boxes, 0.2)
    assert torch.equal(got, box_ops.greedy_suppress_ref(bits, scores, valid))
    boxes, scores, valid = (t.to(card) for t in _nms_inputs(gen, 1, 1, 1345))
    with pytest.raises(ValueError):
        box_ops.nms_bev_mask(boxes, scores, 0.2, valid)
    assert cuda_build.LAUNCHES["nms_bev"] == before + 2


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
    before = cuda_build.LAUNCHES["nms_circle"]
    got = box_ops.circle_nms_mask(centers, scores, thr, valid)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["nms_circle"] == before + 1
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
    device operation (no copy, no sort). ``fn`` runs once and the card
    drains before the profile starts, so the profile sees neither the
    library's first load nor an earlier test's work still running."""
    fn()
    torch.cuda.synchronize()
    before = cuda_build.LAUNCHES[name]
    ops, taken = _device_ops(fn, calls)
    assert cuda_build.LAUNCHES[name] - before == 2 * calls * taken
    assert len(ops) == 1 and kernel in next(iter(ops)), ops
    assert 0 < next(iter(ops.values())) <= calls, ops


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
    """K = 1,792 fills the block's shared memory; 1,793 is refused."""
    from isfusion_tpu_torch.testing import circle_nms_sets

    k = box_ops.CIRCLE_MAX_BOXES
    centers, scores, valid, thr = (t.to(card) for t in circle_nms_sets(
        torch.Generator().manual_seed(k), 2, k))
    _check_circle(centers, scores, valid, thr)
    before = cuda_build.LAUNCHES["nms_circle"]
    centers, scores, valid, thr = (t.to(card) for t in circle_nms_sets(
        torch.Generator().manual_seed(0), 1, k + 1))
    with pytest.raises(ValueError):
        box_ops.circle_nms_mask(centers, scores, thr, valid)
    assert cuda_build.LAUNCHES["nms_circle"] == before


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
