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
plain versions (the positives, cells at 1.0, included); 1e-5 of
the max for the sparse conv's
K12 backward against plain autograd on the CPU, 1e-3 of the max for the
tiny flagship on the card against the CPU, 1e-4 of the max for the tiny
PointPillars' and CenterPoint's kept boxes (the same entries and
labels), and 1e-4 relative for the tiny train steps' losses (float32, TF32
off: sums run in another order).
"""
import pytest
import torch

import numpy as np

from isfusion_tpu_torch.ops import box_ops, cuda_build, gaussian, sparse_conv
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
    before = cuda_build.LAUNCHES["masked_gather"]
    pg, _ = gpu(batch, mode="feats", device="cuda")
    assert cuda_build.LAUNCHES["masked_gather"] > before
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
