#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``isfusion_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one line (every failure raises, exit code != 0):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles every hand-written kernel from ``isfusion_tpu_torch/
   csrc`` (one ``nvcc`` per source, all started together) and prints each
   kernel's registers, stack and spills (``ptxas -v``);
3. main path: the full-width IS-Fusion flagship (seeded random weights,
   ``configs/isfusion/isfusion_0075voxel.py``) serves one warm-up and five
   timed batch-1 requests at bench shape (200,000 points, 6 x 384 x 1056
   images), each with the points jittered as ``bench.py`` does. Launch
   counts are zeroed just before the five requests and read just after;
   the phase fails unless every kernel of the predict path (K12) launched;
4. kernel check: each kernel against its plain PyTorch version on the
   inputs the main path gave it (stage-0 and stage-1 im2col gathers) and
   on the TPU microbenchmark's shape, bit for bit, with timings.
   The K12 backward (the transposed-rulebook gather of a sparse conv's dX)
   at the stage-0 shapes, bit for bit, and one conv's dX and dW against
   plain autograd; K10 (rotated 3D IoU) on 4 x 200 x 64 box pairs with
   identical, disjoint, rotated and nested boxes against its plain
   version (all four samples in one launch, as a train step calls it);
5. breakdown: one request with CUDA events around each top-level module,
   one under torch.profiler (device busy share, top kernels);
6. precision gap: the same request with every compute dtype float32 (TF32
   off) against the bfloat16 run (reported, not asserted);
7. reference check: the tiny flagship on the card against the same model
   on the CPU (the kernels' plain versions), float32;
8. train: the full-width flagship in train mode with the config's AdamW,
   cyclic schedules and grad clip takes 1 warm-up and 5 timed steps at
   batch 4 (``samples_per_gpu``; one sample with two camera views
   dropped), bf16. Launch counts are zeroed before the timed steps and
   read after, split into each step's forward and backward. Prints each
   step's losses, grad norm and ms, peak memory, the host Hungarian's ms
   and the launches per step; fails on a non-finite loss or grad norm, a
   zero grad norm, a kernel not launched in every step, or an unchanged
   weight of the sparse encoder, the fusion encoder or the head;
9. train reference: one float32 step of the tiny flagship (dropout off) on
   the card and on the CPU from the same weights and batch: loss terms
   within 1e-4 relative, each top-level module's gradient within 1e-3 of
   its max (the K12 route against plain autograd on the card is
   reported beside it); then 30 steps on that batch on the card (lr
   1e-3, no clip) must lower the loss;
10. PointPillars main path: the full-width PointPillars of
    ``configs/pointpillars/hv_pointpillars_secfpn_sbn-all_4x8_2x_nus-3d.py``
    (seeded random weights, the box-regression weights scaled by 0.01 so
    that boxes are scene-sized, bf16 convs, float32 decode and NMS) serves
    one warm-up and five batch-1 requests of 120,000 points; launch counts are
    zeroed just before the five and read after each: the phase fails
    unless K10-NMS (``nms_bev``) launched in every request. Prints the
    median and max ms, peak memory, pillars against the cap and the kept
    boxes;
11. PointPillars kernel check: K10-NMS against its plain version on the
    request's own top-1,000 boxes and 10 classes, on the same request
    before the scaling, on a scene-like set of 1,000 boxes and 10 classes
    with no pair near the threshold, on 1,000 boxes within 3 m (every
    bounding circle meets) and 1,000 on a 10 m grid (none meets), and on
    adversarial sets (identical, nested, 45-degree, chained, all-invalid,
    single box): keep masks equal to the plain greedy walk over the
    kernel's own suppression bits, those bits symmetric and equal
    wherever the plain IoU is more than 1e-5 from the threshold, keep
    masks equal to the plain version's whenever no pair is that close;
    prints each set's box sizes, the shares of pairs whose circles meet
    and whose boxes intersect, three operation bounds (the least that
    settles every pair, the kernel's circle cut, every pair) and each
    pass's device time;
12. PointPillars train: batch 4, the ``schedule_2x`` recipe (AdamW, step
    lr with linear warmup, clip 35), 1 warm-up and 5 timed steps; fails on
    a non-finite or zero grad norm or an unchanged weight of the VFE, the
    backbone or the head;
13. PointPillars reference: the tiny PointPillars in float32 on the card
    against the CPU, predict (same kept entries and labels, boxes within
    1e-4 of their max) and one train step (losses 1e-4 relative,
    gradients per top-level module 1e-3 of their max).

The card's ``nvidia-smi`` line, then the kernels' JSON record, then
``{"ok": true, "device": {...}}`` end the output.

``python3 chip_smoke.py --pp-serve [TREE]`` runs only pp-serve (more
requests, then the K10-NMS wrapper's device and host time), with the port
imported from the checkout TREE: two checkouts compared in one call
(``pp_serve_timing``).
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_REQUESTS = 5
N_TRAIN_STEPS = 5
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
F32_OPS_PER_S = 67e12               # H100 SXM float32 rate, no tensor cores
MICRO_SHAPE = (145_000, 1536, 145_408)  # (V, F, N) of micro_dma_gather.py


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


def sync(dev: str) -> None:
    import torch
    if dev == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, dev: str = "cuda", iters: int = 20) -> float:
    """Mean device ms of ``fn()`` over ``iters`` launches after a warm-up
    (CUDA events; the host clock on the CPU, for rehearsals only)."""
    import torch
    fn()
    sync(dev)
    if dev != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, iters: int = 50) -> dict:
    """{device operation: (launches per call, mean device ms per launch)}
    over ``iters`` calls of ``fn()`` under torch.profiler after a
    warm-up: the card's own clock, without the host's launch overhead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / iters, e.self_device_time_total / 1e3 / e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


def kernel_ms(ops: dict, kernel: str):
    """Mean device ms per launch of the operations of ``device_kernels``
    whose name holds ``kernel``."""
    hits = [v for name, v in ops.items() if kernel in name]
    if not hits:
        return "not measured"
    return sum(n * ms for n, ms in hits) / sum(n for n, _ in hits)


def kernel_device_ms(fn, kernel: str, iters: int = 50):
    """Mean device ms per launch of the kernels whose name holds
    ``kernel``, over ``iters`` calls of ``fn()`` (``device_kernels``)."""
    return kernel_ms(device_kernels(fn, iters), kernel)


def gather_bytes(src, idx, fmask) -> int:
    """Least bytes a masked gather must move: each distinct kept source
    row read once, every output row written once, idx and fmask read."""
    import torch
    row = src.shape[1] * src.element_size()
    distinct = int(torch.unique(idx[fmask]).numel())
    return distinct * row + idx.numel() * (row + 4 + 1)


def phase_device() -> str:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))
    return smi


def phase_build():
    """Build every kernel, then report each source's registers, stack and
    spills (``ptxas -v``, all sources at once)."""
    from concurrent.futures import ThreadPoolExecutor
    from isfusion_tpu_torch.ops import cuda_build
    secs = cuda_build.build_all()
    names = sorted(cuda_build.SIGNATURES)
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        usage = list(ex.map(lambda n: cuda_build.ptxas_usage(
            cuda_build.CSRC_DIR / f"{n}.cu"), names))
    log("build", kernels=names, seconds=secs, ptxas=dict(zip(names, usage)))


def jittered(batch: dict, i: int) -> dict:
    """Request ``i``: the points shifted by 1e-3 * (i + 1) (bench.py)."""
    return dict(batch, points=batch["points"] + 1e-3 * (i + 1))


def phase_main_path(model, batch: dict, dev: str = "cuda"):
    """Serve 1 warm-up + N_REQUESTS requests. Returns (launch counts of
    the timed requests, the stage-0/1 subm gather inputs of the warm-up,
    request stats)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build, sparse_conv

    # keep the first gather input of each (rows, width) seen in the
    # warm-up: the main path's own stage-0/1 im2col inputs (the kernel's
    # route on the card, the plain one in a CPU rehearsal)
    real_gather = sparse_conv.masked_gather
    real_ref = sparse_conv.masked_gather_ref
    seen = {}

    def recording(fn):
        def gather(src, idx, fmask):
            key = tuple(src.shape)
            if key not in seen:
                seen[key] = (src.clone(), idx.clone(), fmask.clone())
            return fn(src, idx, fmask)
        return gather

    sparse_conv.masked_gather = recording(real_gather)
    sparse_conv.masked_gather_ref = recording(real_ref)
    try:
        stats = {}
        model(jittered(batch, 0), device=dev, stats=stats)
        sync(dev)
    finally:
        sparse_conv.masked_gather = real_gather
        sparse_conv.masked_gather_ref = real_ref
    layers = model.pts_middle_encoder.encoder_layers
    stage = {}
    for name, n, blk in (("stage0", stats["active_sites"][0],
                          layers.encoder_layer1[0]),
                         ("stage1", stats["active_sites"][1],
                          layers.encoder_layer2[0])):
        key = (n, blk.conv1.weight.shape[-1])
        if key not in seen:
            raise RuntimeError(f"main path showed no {name} subm gather")
        stage[name] = seen.pop(key)
    seen.clear()

    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times = []
    for i in range(N_REQUESTS):
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(cuda_build.LAUNCHES)
    p = model.pts_bbox_head.num_proposals
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != dict(bboxes=(1, p, 9), scores=(1, p), labels=(1, p),
                      mask=(1, p)):
        raise RuntimeError(f"unexpected output shapes {shapes}")
    if not (torch.isfinite(out["bboxes"]).all()
            and torch.isfinite(out["scores"]).all()):
        raise RuntimeError("non-finite outputs")
    req = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, voxels=stats["voxels"],
               pillars=stats["pillars"], active_sites=stats["active_sites"],
               launches=launches)
    if dev == "cuda":
        req["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("main_path", **req)
    return launches, stage, req


def _near_monotone(v: int, n: int, masked: float, gen):
    import torch
    idx = (torch.arange(n, dtype=torch.int64) * v // n)
    idx = (idx + torch.randint(-2, 3, (n,), generator=gen)).clamp(0, v - 1)
    fmask = torch.rand(n, generator=gen) >= masked
    return idx.to(torch.int32), fmask


def phase_kernel_check(stage: dict, dev: str = "cuda"):
    """Kernel vs plain version, bit for bit; returns the stage-0 bf16
    record for the JSON line."""
    import torch
    from isfusion_tpu_torch.ops.gather import masked_gather, masked_gather_ref

    gen = torch.Generator().manual_seed(0)
    cases = []
    for name, (src, idx, fmask) in stage.items():
        cases.append((f"{name}_rulebook", src, idx, fmask))
        perm = torch.randperm(idx.numel(), generator=gen) % src.shape[0]
        cases.append((f"{name}_permutation", src,
                      perm.to(torch.int32).to(dev), torch.ones_like(fmask)))
    v, f, n = MICRO_SHAPE
    msrc = torch.randn((v, f), generator=gen).to(torch.bfloat16).to(dev)
    midx, mmask = _near_monotone(v, n, 0.08, gen)
    cases.append(("micro_near_monotone", msrc, midx.to(dev), mmask.to(dev)))
    cases.append(("micro_permutation", msrc,
                  (torch.randperm(n, generator=gen) % v).to(
                      torch.int32).to(dev),
                  torch.ones(n, dtype=torch.bool).to(dev)))
    record = None
    for name, src, idx, fmask in cases:
        for dt in (torch.bfloat16, torch.float32):
            s = src.to(dt).contiguous()
            got = masked_gather(s, idx, fmask)
            ref = masked_gather_ref(s, idx, fmask)
            sync(dev)
            if not torch.equal(got, ref):
                raise RuntimeError(f"masked_gather differs from its plain "
                                   f"version on {name} {dt}")
            err = float((got.float() - ref.float()).abs().max())
            nbytes = gather_bytes(s, idx, fmask)
            row = dict(case=name, dtype=str(dt).split(".")[-1],
                       V=s.shape[0], F=s.shape[1], N=idx.numel(),
                       kept=float(fmask.float().mean()), bytes=nbytes,
                       max_abs_err=err,
                       ms=cuda_ms(lambda: masked_gather(s, idx, fmask), dev),
                       plain_ms=cuda_ms(
                           lambda: masked_gather_ref(s, idx, fmask), dev),
                       library_ms=cuda_ms(
                           lambda: torch.index_select(s, 0, idx), dev),
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            log("kernel_check", **row)
            if name == "stage0_rulebook" and dt == torch.bfloat16:
                record = row
            del got, ref
    return record


def phase_backward_check(src, idx, fmask, dev: str = "cuda") -> dict:
    """K12 in a sparse conv's backward at the stage-0 shapes: the
    transposed-rulebook gather of dY (bf16) bit for bit against its plain
    version, timed beside its byte bound and the library route
    (``index_add_`` of the im2col gradient into dX); then one conv's dX and
    dW (float32) through ``SparseConvFunction`` against plain autograd
    within 1e-5 of their max. Returns the record for the JSON line."""
    import torch
    from isfusion_tpu_torch.ops import sparse_conv
    from isfusion_tpu_torch.ops.gather import masked_gather, masked_gather_ref

    n, cin = src.shape
    rows, found = idx.view(n, -1), fmask.view(n, -1)
    k, cout = rows.shape[1], cin          # stage-0 subm conv: 32 -> 32
    gen = torch.Generator().manual_seed(1)
    dy = torch.randn((n, cout), generator=gen).to(torch.bfloat16).to(dev)
    rows_t, found_t = sparse_conv.transpose_rulebook(rows, found, n)
    ti, tf = rows_t.reshape(-1), found_t.reshape(-1)
    got, ref = masked_gather(dy, ti, tf), masked_gather_ref(dy, ti, tf)
    sync(dev)
    if not torch.equal(got, ref):
        raise RuntimeError("K12 backward gather differs from its plain "
                           "version")
    if int(found_t.sum()) != int(found.sum()):
        raise RuntimeError("transposed rulebook lost or doubled pairs")
    nbytes = gather_bytes(dy, ti, tf)
    dcols = torch.randn((int(found.sum()), cin), generator=gen).to(
        torch.bfloat16).to(dev)
    dst = idx.long()[fmask]
    rec = dict(N=n, K=k, C=cout, kept=float(found.float().mean()),
               bytes=nbytes, max_abs_err=float((got.float() -
                                                ref.float()).abs().max()),
               ms=cuda_ms(lambda: masked_gather(dy, ti, tf), dev),
               plain_ms=cuda_ms(lambda: masked_gather_ref(dy, ti, tf), dev),
               library_ms=cuda_ms(lambda: torch.zeros(
                   (n, cin), dtype=dy.dtype, device=dev).index_add_(
                       0, dst, dcols), dev),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    del got, ref, dcols

    torch.backends.cuda.matmul.allow_tf32 = False
    x0 = src.float()
    w0 = (torch.randn((cout, 3, 3, 3, cin), generator=gen) /
          (27 * cin) ** 0.5).to(dev)
    dy32 = dy.float()

    def fwd_bwd(fn):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        fn(x, rows, found, w).backward(dy32)
        return x.grad, w.grad

    kern, plain = fwd_bwd(sparse_conv.SparseConvFunction.apply), \
        fwd_bwd(sparse_conv.sparse_conv_plain)
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(kern, plain)]
    rec.update(dx_rel_err=errs[0], dw_rel_err=errs[1],
               conv_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(
                   sparse_conv.SparseConvFunction.apply), dev, iters=5),
               conv_fwd_bwd_plain_ms=cuda_ms(lambda: fwd_bwd(
                   sparse_conv.sparse_conv_plain), dev, iters=5))
    log("backward_check", **rec)
    if max(errs) > 1e-5:
        raise RuntimeError(f"sparse conv backward differs from plain "
                           f"autograd by {max(errs):.3g} of the max")
    return rec


def iou_test_boxes(gen, n: int = 200, m: int = 64):
    """(a (n, 7), b (m, 7), rows of a copied into b[:8]) at flagship
    range: b holds 8 copies of boxes of a (identical), 8 rotated copies,
    8 nested (shrunk) copies, 8 disjoint boxes and 32 jittered copies."""
    import torch
    a = torch.empty((n, 7))
    a[:, :2] = (torch.rand((n, 2), generator=gen) * 2 - 1) * 48
    a[:, 2] = -1 - torch.rand(n, generator=gen)
    a[:, 3:6] = 0.5 + torch.rand((n, 3), generator=gen) * 4.5
    a[:, 6] = (torch.rand(n, generator=gen) * 2 - 1) * 3.14159
    src = torch.randperm(n, generator=gen)[:m]
    pick = a[src].clone()
    pick[8:16, 6] += 0.7                       # rotated
    pick[16:24, 3:6] *= 0.5                    # nested
    pick[16:24, 2] += 0.1
    pick[24:32, :2] += 500.0                   # disjoint
    pick[32:] += torch.randn((m - 32, 7), generator=gen) * 0.3
    pick[32:, 3:6] = pick[32:, 3:6].abs() + 0.1
    return a, pick, src[:8]


def phase_iou_check(dev: str = "cuda") -> dict:
    """K10 against its plain version on 4 x 200 x 64 pairs (the
    assigner's shape at batch 4, all samples in one launch, as a train
    step calls it), within 1e-5; the batched launch timed beside its
    operation bound and beside one launch per sample (the earlier
    design), by CUDA events around the wrapper (``ms``, ``one_sample_ms``,
    ``per_sample_launches_ms`` for all four) and by the profiler's device
    time of the kernel alone (``device_ms``, ``one_sample_device_ms``)."""
    import torch
    from isfusion_tpu_torch.ops import box_ops

    gen = torch.Generator().manual_seed(2)
    sets = [iou_test_boxes(gen) for _ in range(4)]
    a = torch.stack([s[0] for s in sets]).to(dev)
    b = torch.stack([s[1] for s in sets]).to(dev)
    got = box_ops.boxes_iou_3d(a, b)
    ref = box_ops.boxes_iou_3d_ref(a, b)
    sync(dev)
    err = float((got - ref).abs().max())
    for i, (_, _, same) in enumerate(sets):
        err = max(err, float((got[i, same, range(8)] - 1).abs().max()))
    ops = box_ops.iou3d_ops(a, b)
    nbytes = (a.numel() + b.numel() + got.numel()) * 4
    rec = dict(B=a.shape[0], N=a.shape[1], M=b.shape[1], max_abs_err=err,
               ops=ops,
               ms=cuda_ms(lambda: box_ops.boxes_iou_3d(a, b), dev, iters=50),
               one_sample_ms=cuda_ms(lambda: box_ops.boxes_iou_3d(a[0], b[0]),
                                     dev, iters=50),
               per_sample_launches_ms=cuda_ms(
                   lambda: [box_ops.boxes_iou_3d(a[i], b[i])
                            for i in range(a.shape[0])], dev, iters=50),
               plain_ms=cuda_ms(lambda: box_ops.boxes_iou_3d_ref(a, b), dev),
               bound_ms=max(ops / F32_OPS_PER_S,
                            nbytes / HBM_BYTES_PER_S) * 1e3,
               library_ms=None)
    if dev == "cuda":
        rec["device_ms"] = kernel_device_ms(
            lambda: box_ops.boxes_iou_3d(a, b), "boxes_iou_3d_kernel")
        rec["one_sample_device_ms"] = kernel_device_ms(
            lambda: box_ops.boxes_iou_3d(a[0], b[0]), "boxes_iou_3d_kernel")
    log("iou_check", **rec)
    if err > 1e-5:
        raise RuntimeError(f"boxes_iou_3d differs from its plain version by "
                           f"{err:.3g}")
    return rec


BREAKDOWN_MODULES = ("img_backbone", "img_neck", "pts_voxel_encoder",
                     "pts_middle_encoder", "fusion_encoder", "pts_backbone",
                     "pts_neck", "pts_bbox_head")


def phase_breakdown(model, batch: dict, modules=BREAKDOWN_MODULES,
                    nested=("pts_backbone",), prefix: str = ""):
    """Where one request's time goes: CUDA events around each top-level
    module of ``modules`` (forward hooks; stream time, so launch gaps
    count), then one request under torch.profiler for the device's busy
    share and the top device operations (kernels and copies). The
    ``nested`` modules run inside another one (the flagship's
    ``fusion_encoder`` calls the ``pts_backbone`` stages) and are left
    out of the sum; the rest of the request is upload, voxelization,
    pillarization, decode, NMS and host gaps. Logs ``{prefix}breakdown``
    and ``{prefix}profile``."""
    import torch

    spans = {n: [] for n in modules}

    def stamp(name, start):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if start:
                spans[name].append([ev, None])
            else:
                spans[name][-1][1] = ev
        return hook

    handles = []
    for n in modules:
        mod = getattr(model, n)
        handles += [mod.register_forward_pre_hook(stamp(n, True)),
                    mod.register_forward_hook(stamp(n, False))]
    try:
        t0 = time.perf_counter()
        model(jittered(batch, 0), device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for h in handles:
            h.remove()
    module_ms = {n: sum(a.elapsed_time(b) for a, b in s)
                 for n, s in spans.items()}
    top = sum(v for k, v in module_ms.items() if k not in nested)
    log(f"{prefix}breakdown", request_ms=wall, module_ms=module_ms,
        rest_ms=wall - top)

    device_profile(f"{prefix}profile",
                   lambda: model(jittered(batch, 0), device="cuda"))


def phase_precision_gap(model_bf16, batch: dict):
    """f32 (TF32 off) vs the bf16 request: dense heatmap gap and top-200
    index agreement (reported only)."""
    import torch
    from isfusion_tpu_torch.flagship import build_isfusion_flagship
    from isfusion_tpu_torch.models.middle_encoders.isfusion_encoder import \
        maxpool_nms, topk_stable

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model32, _ = build_isfusion_flagship(compute_dtype="float32",
                                         device="cuda", seed=0)
    req = jittered(batch, 0)
    p16, _ = model_bf16(req, mode="feats", device="cuda")
    p32, _ = model32(req, mode="feats", device="cuda")
    head = model32.pts_bbox_head

    def top(p):
        heat = maxpool_nms(torch.sigmoid(p["dense_heatmap"]),
                           head.nms_kernel_size, head._flat_nms_classes())
        b = heat.shape[0]
        return topk_stable(heat.permute(0, 3, 1, 2).reshape(b, -1),
                           head.num_proposals)

    h16, h32 = p16["dense_heatmap"].float(), p32["dense_heatmap"].float()
    if not (torch.isfinite(h16).all() and torch.isfinite(h32).all()):
        raise RuntimeError("non-finite dense heatmap")
    t16, t32 = top(p16)[0].tolist(), top(p32)[0].tolist()
    log("precision_gap", heatmap_max_abs_gap=float((h16 - h32).abs().max()),
        heatmap_max_abs=float(h32.abs().max()),
        top200_index_share=len(set(t16) & set(t32)) / len(t32))
    del model32


def phase_reference_check():
    """Tiny flagship, float32: card (kernels) vs CPU (plain versions)."""
    import torch
    from isfusion_tpu_torch.flagship import build_isfusion_flagship

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu, batch_fn = build_isfusion_flagship(tiny=True, device="cuda", seed=1)
    cpu, _ = build_isfusion_flagship(tiny=True, device="cpu", seed=1)
    batch = batch_fn(1, seed=3)
    pg, ig = gpu(batch, mode="feats", device="cuda")
    pc, ic = cpu(batch, mode="feats", device="cpu")
    worst = 0.0
    for name, a, b in (("dense_heatmap", pg["dense_heatmap"],
                        pc["dense_heatmap"]), ("ins_heatmap", ig, ic)):
        rel = float((a.cpu() - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
    same = float((pg["query_labels"].cpu() == pc["query_labels"]).float()
                 .mean())
    log("reference_check", heatmap_rel_err=worst, query_label_share=same)
    if worst > 1e-3:
        raise RuntimeError(f"tiny flagship on the card differs from the "
                           f"CPU by {worst:.3g} of the heatmap's max")


PREDICT_KERNELS = ("masked_gather",)
TRAIN_WATCH = ("pts_middle_encoder", "fusion_encoder", "pts_bbox_head")


def train_batch(batch_fn, size: int) -> dict:
    """``size`` synthetic samples with views 1 and 4 of sample 0 dropped
    (ModalMask3D), exercising the severed backward of masked views."""
    import numpy as np
    batch = batch_fn(size)
    mask = np.ones(batch["img"].shape[:2], bool)
    mask[0, [1, 4][:mask.shape[1] - 1]] = False
    batch["img_view_mask"] = mask
    return batch


def device_profile(phase: str, fn, top: int = 10) -> None:
    """``fn()`` once under torch.profiler: its host-clock ms (ending in a
    synchronize), the device's busy ms and idle share, and the top device
    operations (kernels and copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    log(phase, wall_ms=wall, device_busy_ms=busy,
        device_idle_share=1 - busy / wall if busy > 0 else "not measured",
        device_ops=sum(e.count for e in ops),
        top_device_ops=[dict(name=e.key[:70], count=e.count,
                             ms=e.self_device_time_total / 1e3)
                        for e in ops[:top]])


def _unchanged(model, watch: dict) -> list:
    """Names of the watched modules' parameters still bit-equal to their
    copies in ``watch``."""
    import torch
    return [f"{n}[{j}]" for n, ps in watch.items()
            for j, (p, q) in enumerate(zip(getattr(model, n).parameters(),
                                           ps))
            if torch.equal(p.detach(), q)]


def phase_train(model, batch: dict, dev: str = "cuda",
                steps: int = N_TRAIN_STEPS) -> dict:
    """1 warm-up + ``steps`` train steps with the config's optimizer,
    schedules and clip; launches per step split at the end of each
    step's forward (a forward hook on the detector)."""
    import torch
    from isfusion_tpu_torch.flagship import flagship_optim_cfg
    from isfusion_tpu_torch.models.dense_heads import transfusion_head
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = flagship_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(
        model, opt, build_schedule(opt, cfg["lr_config"],
                                   cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    hungarian_ms, fwd_marks = [], []
    real_assign = transfusion_head.assign_batch

    def timed_assign(costs):
        sync(dev)               # the copy waits for the costs anyway
        t0 = time.perf_counter()
        out = real_assign(costs)
        hungarian_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def event():
        if dev != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def at_forward_end(*_):
        fwd_marks.append((dict(cuda_build.LAUNCHES), event()))

    transfusion_head.assign_batch = timed_assign
    hook = model.register_forward_hook(at_forward_end)
    try:
        step(jittered(batch, 0), gen)
        sync(dev)
        watch = {n: [p.detach().clone() for p in getattr(model,
                                                         n).parameters()]
                 for n in TRAIN_WATCH}
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        hungarian_ms.clear()
        times, per_step = [], []
        for i in range(steps):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            ev0 = event()
            m = step(jittered(batch, i + 1), gen)
            ev1 = event()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            after, (mid, ev_fwd) = dict(cuda_build.LAUNCHES), fwd_marks[-1]
            split = {} if ev0 is None else dict(
                forward_stream_ms=ev0.elapsed_time(ev_fwd),
                backward_update_stream_ms=ev_fwd.elapsed_time(ev1))
            launches = dict(
                masked_gather_forward=mid["masked_gather"] -
                before["masked_gather"],
                masked_gather_backward=after["masked_gather"] -
                mid["masked_gather"],
                boxes_iou_3d=after["boxes_iou_3d"] - before["boxes_iou_3d"])
            vals = {k: float(v) for k, v in m.items()}
            log("train_step", step=i, ms=times[-1], **split,
                launches=launches, hungarian_ms=hungarian_ms[-1], **vals)
            per_step.append(launches)
            bad = [k for k, v in vals.items() if v != v or abs(v) == float(
                "inf")]
            if bad or vals["grad_norm"] == 0:
                raise RuntimeError(f"train step {i}: non-finite {bad} or "
                                   f"zero grad norm {vals['grad_norm']}")
            if dev == "cuda" and min(launches.values()) == 0:
                raise RuntimeError(f"train step {i}: a kernel did not "
                                   f"launch: {launches}")
        total = dict(cuda_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if dev == "cuda" else None
        if dev == "cuda":
            device_profile("train_profile",
                           lambda: step(jittered(batch, 0), gen), top=12)
    finally:
        transfusion_head.assign_batch = real_assign
        hook.remove()
    unchanged = _unchanged(model, watch)
    rec = dict(batch=batch["points"].shape[0], median_ms=statistics.median(
        times), max_ms=max(times), all_ms=times,
        hungarian_ms_median=statistics.median(hungarian_ms),
        launches_per_step=per_step[-1],
        launches=total, unchanged_weights=unchanged)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} train steps: "
                           f"{unchanged[:10]}")
    return rec


def off_sampling_kinks(model, seed: int = 9):
    """Seeded N(0, 0.01^2) sampling-offset weights in every deformable
    attention. At init they are zero and every sampling location sits on
    a pixel centre, where the bilinear sampler has no derivative: the
    card and the CPU, rounding the locations differently, would take
    different one-sided derivatives there."""
    import torch
    from isfusion_tpu_torch.models.middle_encoders.isfusion_encoder import \
        MSDeformAttn
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, MSDeformAttn):
                w = mod.sampling_offsets.weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
    return model


def _module_grad_errs(ga: dict, gb: dict) -> dict:
    """Max |a - b| / max |b| of each top-level module's gradients (None
    where the loss reaches no parameter, on both sides alike)."""
    import torch
    errs = {}
    for top in BREAKDOWN_MODULES:
        pairs = [(a, b) for a, b in zip(ga[top], gb[top]) if b is not None]
        if sum(a is not None for a in ga[top]) != len(pairs):
            raise RuntimeError(f"{top}: the runs reach other parameters")
        if not pairs:       # the detached image backbone
            continue
        got = torch.cat([a.flatten() for a, _ in pairs])
        want = torch.cat([b.flatten() for _, b in pairs])
        errs[top] = float((got - want).abs().max() /
                          want.abs().max().clamp_min(1e-30))
    return errs


def phase_train_reference(dev: str = "cuda"):
    """Tiny flagship, float32, dropout off: one train step on the card
    against the CPU (and, on the card, the K12 route against plain
    autograd through ``sparse_conv_plain``), then 30 steps on one batch
    that must lower the loss."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the tiny model's proposal and instance top-k turn rounding into
    # discrete choices: with the atomics of index_add_ (VFE cluster
    # centres) a card run can land on either side of a near-tie, so the
    # card runs with PyTorch's deterministic kernels here
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _train_reference(dev)
    finally:
        torch.use_deterministic_algorithms(False)


def _train_reference(dev: str):
    import torch
    from isfusion_tpu_torch.flagship import build_isfusion_flagship
    from isfusion_tpu_torch.models.middle_encoders import sparse_encoder
    from isfusion_tpu_torch.ops import sparse_conv
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer

    def one_step(d):
        model, batch_fn = build_isfusion_flagship(tiny=True, device=d,
                                                  seed=1, dropout=False)
        off_sampling_kinks(model).train()
        batch = train_batch(batch_fn, 2)
        opt = build_optimizer(model, dict(type="AdamW", lr=1e-4))
        m = make_train_step(model, opt)(batch,
                                        torch.Generator(d).manual_seed(0))
        grads = {top: [None if p.grad is None else p.grad.detach().cpu()
                       for p in getattr(model, top).parameters()]
                 for top in BREAKDOWN_MODULES}
        return {k: float(v) for k, v in m.items()}, grads, model, batch

    mg, gg, model, batch = one_step(dev)
    mc, gc, _, _ = one_step("cpu")
    real = sparse_encoder.sparse_conv
    sparse_encoder.sparse_conv = sparse_conv.sparse_conv_plain
    try:
        mp, gp, _, _ = one_step(dev)
    finally:
        sparse_encoder.sparse_conv = real
    loss_err = max(abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mc.items())
    grad_err = _module_grad_errs(gg, gc)
    opt = build_optimizer(model, dict(type="AdamW", lr=1e-3))
    step = make_train_step(model, opt)
    gen = torch.Generator(dev).manual_seed(1)
    curve = [float(step(batch, gen)["loss"]) for _ in range(30)]
    log("train_reference", loss_rel_err=loss_err, grad_rel_err=grad_err,
        kernel_vs_plain_on_card_loss_rel_err=max(
            abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mp.items()),
        kernel_vs_plain_on_card_grad_rel_err=_module_grad_errs(gg, gp),
        plain_on_card_vs_cpu_grad_rel_err=_module_grad_errs(gp, gc),
        losses=mc, loss_first=curve[0], loss_last=curve[-1],
        loss_curve=curve)
    if loss_err > 1e-4 or max(grad_err.values()) > 1e-3:
        raise RuntimeError(f"tiny train step on the card differs from the "
                           f"CPU: losses {loss_err:.3g}, grads {grad_err}")
    if not curve[-1] < curve[0]:
        raise RuntimeError(f"30 steps did not lower the loss: {curve}")

# ------------------------------------------------------------ PointPillars
PP_PREDICT_KERNELS = ("nms_bev",)
PP_MODULES = ("pts_voxel_encoder", "pts_backbone", "pts_neck",
              "pts_bbox_head")
PP_TRAIN_WATCH = ("pts_voxel_encoder", "pts_backbone", "pts_bbox_head")
NMS_NEAR = 1e-5         # a pair this close to the threshold may round apart


def record_nms_inputs(model, batch: dict, dev: str, stats=None):
    """One PointPillars request; returns the NMS inputs it made (its
    top-``nms_pre`` BEV boxes, every class's scores, their validity)."""
    from isfusion_tpu_torch.models.dense_heads import anchor3d_head

    real, seen = anchor3d_head.nms_bev_mask, []

    def recording(boxes, scores, thresh, valid):
        seen.append((boxes.clone(), scores.clone(), valid.clone()))
        return real(boxes, scores, thresh, valid)

    anchor3d_head.nms_bev_mask = recording
    try:
        model(batch, device=dev, stats=stats)
        sync(dev)
    finally:
        anchor3d_head.nms_bev_mask = real
    return seen[0]


def phase_pp_main_path(model, batch: dict, dev: str = "cuda"):
    """PointPillars serving: 1 warm-up + N_REQUESTS batch-1 requests
    (bf16 convs, float32 decode and NMS). Records the warm-up's NMS inputs
    (its top-``nms_pre`` boxes and every class's scores). Launch counts are
    zeroed just before the timed requests and read after each; fails
    unless ``nms_bev`` launched in every request. Returns (launch counts,
    NMS inputs, record)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build

    stats = {}
    nms_in = record_nms_inputs(model, jittered(batch, 0), dev, stats)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    for i in range(N_REQUESTS):
        before = cuda_build.LAUNCHES["nms_bev"]
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append(cuda_build.LAUNCHES["nms_bev"] - before)
    launches = dict(cuda_build.LAUNCHES)
    if dev == "cuda":
        phase_breakdown(model, batch, PP_MODULES, (), "pp_")
    n = int(model.pts_bbox_head.test_cfg.get("max_num", 500))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != dict(bboxes=(1, n, 9), scores=(1, n), labels=(1, n),
                      mask=(1, n)):
        raise RuntimeError(f"unexpected PointPillars output shapes {shapes}")
    m = out["mask"]
    if not (torch.isfinite(out["bboxes"][m]).all()
            and torch.isfinite(out["scores"][m]).all()):
        raise RuntimeError("non-finite PointPillars boxes")
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, pillars=stats["voxels"], cap=stats["cap"],
               kept_boxes=int(m.sum()), nms_launches=per_request,
               launches=launches)
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("pp_main_path", **rec)
    if dev == "cuda" and min(per_request) == 0:
        raise RuntimeError(f"nms_bev did not launch in every request: "
                           f"{per_request}")
    return launches, nms_in, rec


def nms_test_sets(gen):
    """Adversarial (name, boxes (1, K, 5), scores (1, C, K), valid) sets:
    identical boxes, nested boxes, 45-degree rotations, suppression
    chains (A suppresses B, B would suppress C, A misses C), all-invalid
    and a single box."""
    import torch

    def scored(name, boxes, valid=None, scores=None):
        if scores is None:
            scores = torch.rand((1, 3, boxes.shape[0]), generator=gen)
        v = torch.ones_like(scores, dtype=torch.bool) if valid is None \
            else valid
        return name, boxes[None], scores, v

    k = torch.arange(64, dtype=torch.float32)
    base = torch.tensor([3.0, -2.0, 4.0, 2.0, 0.3])
    nested = base.repeat(64, 1)
    nested[:, 2:4] *= (0.97 ** k)[:, None]
    rot = base.repeat(64, 1)
    rot[:, 4] += k * math.pi / 4
    chain = torch.tensor([[0.0, 0, 4, 2, 0], [1.2, 0, 4, 2, 0],
                          [3.4, 0, 4, 2, 0]])
    chains = torch.cat([chain + torch.tensor([12.0 * i, 0, 0, 0, 0])
                        for i in range(20)])
    chain_scores = torch.tensor([0.9, 0.8, 0.7]).repeat(20).expand(1, 3, 60)
    return [scored("identical", base.repeat(64, 1)),
            scored("nested", nested), scored("rotated_45", rot),
            scored("chains", chains, scores=chain_scores.clone()),
            scored("all_invalid", nested, valid=torch.zeros(
                (1, 3, 64), dtype=torch.bool)),
            scored("single_box", base[None])]


def box_sizes(boxes) -> dict:
    """Quantiles (0, 0.5, 0.9, 1) of (B, K, 5) BEV boxes' dx and dy and
    their largest |x|, |y|, in metres."""
    import torch
    b = boxes.reshape(-1, 5).float().cpu()
    q = torch.tensor([0.0, 0.5, 0.9, 1.0])
    return dict(dx_q=torch.quantile(b[:, 2], q).tolist(),
                dy_q=torch.quantile(b[:, 3], q).tolist(),
                max_abs_xy=float(b[:, :2].abs().max()))


def _nms_compare(boxes, scores, valid, thr, dev) -> dict:
    """K10-NMS on one set against two yardsticks: its keep masks must
    equal the plain greedy walk over the kernel's own suppression bits
    (which holds the greedy pass exactly, rounding aside), and its bits
    must be symmetric and equal the plain IoU's wherever that lies more
    than NMS_NEAR from the threshold; the plain version's keep masks
    (``keep_equal``) must be equal whenever no pair is that close. Also
    the shares of unordered pairs whose bounding circles meet (the pairs
    the pairwise pass computes) and whose boxes intersect, and three
    operation counts with their bounds: what settles every pair at least
    (``nms_bev_needed_ops``, the bound), what the kernel's circle cut
    computes, and one IoU for every pair."""
    import torch
    from isfusion_tpu_torch.ops import box_ops

    got = box_ops.nms_bev_mask(boxes, scores, thr, valid)
    ref = box_ops.nms_bev_mask_ref(boxes, scores, thr, valid)
    iou = box_ops.boxes_iou_bev_ref(boxes, boxes)
    near = (iou - thr).abs() < NMS_NEAR
    # on the CPU (rehearsal) the plain bits stand in for the kernel's
    bits = box_ops.nms_bev_suppression_bits(boxes, thr) if dev == "cuda" \
        else iou > thr
    on_bits = box_ops.greedy_suppress_ref(bits.cpu(), scores.cpu(),
                                          valid.cpu())
    k = boxes.shape[1]
    pairs = max(boxes.shape[0] * k * (k - 1) // 2, 1)
    meet = torch.triu(box_ops.bev_circles_meet(boxes), diagonal=1)
    ops = box_ops.nms_bev_needed_ops(boxes, thr)
    ops_cut, ops_all = box_ops.nms_bev_cut_ops(boxes), box_ops.nms_bev_ops(
        boxes)
    sync(dev)
    return dict(K=k, C=scores.shape[1], kept=int(ref.sum()),
                greedy_equal=torch.equal(got.cpu(), on_bits),
                keep_equal=torch.equal(got, ref),
                bad_bits=int(((bits != (iou > thr)) & ~near).sum()),
                symmetric=torch.equal(bits, bits.transpose(1, 2)),
                pairs_near_threshold=int(near.sum()),
                keep_flags_differ=int((got != ref).sum()),
                circles_meet_share=int(meet.sum()) / pairs,
                intersect_share=int(torch.triu(iou > 0, 1).sum()) / pairs,
                ops=ops, ops_circle_cut=ops_cut, ops_all_pairs=ops_all,
                bound_ms=ops / F32_OPS_PER_S * 1e3,
                circle_cut_bound_ms=ops_cut / F32_OPS_PER_S * 1e3,
                all_pairs_bound_ms=ops_all / F32_OPS_PER_S * 1e3)


def phase_pp_kernel_check(nms_in, dev: str = "cuda", untamed=None) -> dict:
    """K10-NMS against its plain version (``_nms_compare``) on the
    request's own top boxes and classes, on the same request before the
    box deltas were tamed (``untamed``, boxes far wider than the scene),
    on a scene-like set of 1,000 boxes and 10 classes with no pair near
    the threshold, on 1,000 boxes within 3 m (every circle meets) and
    1,000 on a 10 m grid (none meets), and on the adversarial sets; on the
    card each set's pairwise and greedy passes' device times. The
    request's NMS timed beside its three operation bounds (``bound_ms``,
    the least that settles this request's pairs; the kernel's circle cut;
    every pair), with the device operations of one wrapper call. Returns
    the record for the JSON line."""
    import torch
    from isfusion_tpu_torch.ops import box_ops
    from isfusion_tpu_torch.testing import (nms_cluster_set, nms_scene_set,
                                            nms_sparse_set)

    thr = 0.2
    boxes, scores, valid = nms_in
    gen = torch.Generator().manual_seed(11)
    cases = [("request", boxes, scores, valid)]
    if untamed is not None:
        cases.append(("request_untamed",) + tuple(untamed))
    cases += [(n, b.to(dev), s.to(dev), v.to(dev)) for n, b, s, v in
              [("scene",) + nms_scene_set(torch.Generator().manual_seed(3)),
               ("cluster",) + nms_cluster_set(
                   torch.Generator().manual_seed(4)),
               ("sparse",) + nms_sparse_set(torch.Generator().manual_seed(5))]
              + nms_test_sets(gen)]
    worst, request = 0, None
    for name, b, s, v in cases:
        r = _nms_compare(b, s, v, thr, dev)
        if dev == "cuda":
            ops = device_kernels(
                lambda: box_ops.nms_bev_mask(b, s, thr, v), iters=20)
            r.update(pairwise_device_ms=kernel_ms(ops, "nms_mask_kernel"),
                     greedy_device_ms=kernel_ms(ops, "nms_greedy_kernel"),
                     device_ops_per_call={k[:60]: n for k, (n, _) in
                                          ops.items()})
        worst = max(worst, r["keep_flags_differ"])
        log("pp_nms_case", case=name, box_m=box_sizes(b), **r)
        if name == "request":
            request = r
        if name == "scene" and r["pairs_near_threshold"]:
            raise RuntimeError("the scene set has pairs near the threshold")
        if r["bad_bits"] or not r["greedy_equal"] or not r["symmetric"] or \
                (r["pairs_near_threshold"] == 0 and not r["keep_equal"]):
            raise RuntimeError(f"nms_bev differs from its plain version on "
                               f"{name}: {r}")
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + 2 * valid.numel()
    rec = dict(B=boxes.shape[0], K=boxes.shape[1], C=scores.shape[1],
               max_abs_err=float(worst), ops=request["ops"],
               ops_circle_cut=request["ops_circle_cut"],
               ops_all_pairs=request["ops_all_pairs"],
               circles_meet_share=request["circles_meet_share"],
               intersect_share=request["intersect_share"],
               ms=cuda_ms(lambda: box_ops.nms_bev_mask(boxes, scores, thr,
                                                       valid), dev, iters=50),
               plain_ms=cuda_ms(lambda: box_ops.nms_bev_mask_ref(
                   boxes, scores, thr, valid), dev, iters=2),
               sort_ms=cuda_ms(lambda: torch.sort(
                   scores, dim=-1, descending=True, stable=True), dev,
                   iters=50),
               bound_ms=max(request["bound_ms"],
                            nbytes / HBM_BYTES_PER_S * 1e3),
               circle_cut_bound_ms=max(request["circle_cut_bound_ms"],
                                       nbytes / HBM_BYTES_PER_S * 1e3),
               all_pairs_bound_ms=max(request["all_pairs_bound_ms"],
                                      nbytes / HBM_BYTES_PER_S * 1e3),
               greedy_chunks_per_class=-(-boxes.shape[1] // 64),
               library_ms=None)
    if dev == "cuda":
        # the pairwise pass alone (the greedy pass is the rest)
        rec["pairwise_ms"] = cuda_ms(lambda: box_ops._launch_nms(
            boxes, None, None, None, 1, thr, False), dev, iters=50)
        for key in ("pairwise_device_ms", "greedy_device_ms",
                    "device_ops_per_call"):
            rec[key] = request[key]
    log("pp_kernel_check", **rec)
    return rec


def phase_pp_train(model, batch: dict, dev: str = "cuda",
                   steps: int = N_TRAIN_STEPS) -> dict:
    """1 warm-up + ``steps`` PointPillars train steps with the config's
    ``schedule_2x`` recipe (AdamW, step lr with linear warmup, clip 35);
    fails on a non-finite or zero grad norm or an unchanged weight of the
    VFE, the backbone or the head."""
    import torch
    from isfusion_tpu_torch.flagship import pointpillars_optim_cfg
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = pointpillars_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(
        model, opt, build_schedule(opt, cfg["lr_config"],
                                   cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    step(jittered(batch, 0), gen)
    sync(dev)
    watch = {n: [p.detach().clone() for p in getattr(model, n).parameters()]
             for n in PP_TRAIN_WATCH}
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, marks = [], []

    def event():
        if dev != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    hook = model.register_forward_hook(lambda *_: marks.append(event()))
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            ev0 = event()
            m = step(jittered(batch, i + 1), gen)
            ev1 = event()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            split = {} if ev0 is None else dict(
                forward_stream_ms=ev0.elapsed_time(marks[-1]),
                backward_update_stream_ms=marks[-1].elapsed_time(ev1))
            vals = {k: float(v) for k, v in m.items()}
            log("pp_train_step", step=i, ms=times[-1], **split, **vals)
            if any(not math.isfinite(v) for v in vals.values()) or \
                    vals["grad_norm"] == 0:
                raise RuntimeError(f"PointPillars train step {i}: {vals}")
    finally:
        hook.remove()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    if dev == "cuda":
        device_profile("pp_train_profile",
                       lambda: step(jittered(batch, 0), gen), top=12)
    unchanged = _unchanged(model, watch)
    rec = dict(batch=batch["points"].shape[0],
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, unchanged_weights=unchanged)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("pp_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} PointPillars "
                           f"train steps: {unchanged[:10]}")
    return rec


def phase_pp_reference(dev: str = "cuda"):
    """Tiny PointPillars, float32 (TF32 off), box deltas tamed
    (``tame_box_deltas``): predict and one train step on the card against
    the CPU from the same weights and batch. The same
    boxes kept with the same labels, boxes and scores within 1e-4 of their
    max;
    losses within 1e-4 relative, each top-level module's gradient within
    1e-3 of its max."""
    import torch
    from isfusion_tpu_torch.flagship import build_pointpillars_flagship
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer
    from isfusion_tpu_torch.testing import pp_kept_boxes, tame_box_deltas

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(d):
        model, batch_fn = build_pointpillars_flagship(tiny=True, device=d,
                                                      seed=1)
        batch = batch_fn(2, seed=3)
        out = pp_kept_boxes(tame_box_deltas(model), batch, d)
        model.train()
        opt = build_optimizer(model, dict(type="AdamW", lr=1e-4))
        m = make_train_step(model, opt)(batch,
                                        torch.Generator(d).manual_seed(0))
        grads = {top: [p.grad.detach().cpu().flatten()
                       for p in getattr(model, top).parameters()]
                 for top in PP_MODULES}
        return out, {k: float(v) for k, v in m.items()}, grads

    (og, mg, gg), (oc, mc, gc) = run(dev), run("cpu")
    if not torch.equal(og[2], oc[2]):
        raise RuntimeError("tiny PointPillars on the card kept other boxes "
                           "than on the CPU")

    def rel_to_max(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    box_err = max(rel_to_max(og[i], oc[i]) for i in (0, 1))
    loss_err = max(abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mc.items())
    grad_err = {top: rel_to_max(torch.cat(gg[top]), torch.cat(gc[top]))
                for top in PP_MODULES}
    log("pp_reference", kept=len(oc[2]), box_rel_err=box_err,
        loss_rel_err=loss_err, grad_rel_err=grad_err, losses=mc)
    if box_err > 1e-4 or loss_err > 1e-4 or max(grad_err.values()) > 1e-3:
        raise RuntimeError(f"tiny PointPillars on the card differs from the "
                           f"CPU: boxes {box_err:.3g}, losses "
                           f"{loss_err:.3g}, grads {grad_err}")


def main() -> int:
    import torch
    if not os.path.isdir(os.path.join(REPO, "isfusion_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(isfusion_tpu_torch/ not found)")
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    from isfusion_tpu_torch.flagship import (build_isfusion_flagship,
                                             flagship_optim_cfg)
    model, batch_fn = build_isfusion_flagship(device="cuda", seed=0)
    batch = batch_fn(1)
    launches, stage, _ = phase_main_path(model, batch)
    # K10 serves the assigner: it is on the train path, not this one
    missing = [k for k in PREDICT_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: "
                           f"{missing}")
    rec = phase_kernel_check(stage)
    bwd = phase_backward_check(*stage["stage0"])
    iou = phase_iou_check()
    del stage
    torch.cuda.empty_cache()
    phase_breakdown(model, batch)
    phase_precision_gap(model, batch)
    phase_reference_check()
    train = phase_train(model, train_batch(
        batch_fn, flagship_optim_cfg()["samples_per_gpu"]))
    del model
    torch.cuda.empty_cache()
    phase_train_reference()
    torch.cuda.empty_cache()

    from isfusion_tpu_torch.flagship import (build_pointpillars_flagship,
                                             pointpillars_optim_cfg)
    from isfusion_tpu_torch.testing import tame_box_deltas
    pp, pp_batch_fn = build_pointpillars_flagship(device="cuda", seed=0)
    pp_batch = pp_batch_fn(1)
    # random weights decode boxes far wider than the scene: the request's
    # NMS inputs as they are go to the kernel check, and the model serves
    # (and trains) with scene-sized boxes
    untamed = record_nms_inputs(pp, jittered(pp_batch, 0), "cuda")
    tame_box_deltas(pp)
    pp_launches, nms_in, _ = phase_pp_main_path(pp, pp_batch)
    missing = [k for k in PP_PREDICT_KERNELS if pp_launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the PointPillars "
                           f"path: {missing}")
    nms = phase_pp_kernel_check(nms_in, untamed=untamed)
    del nms_in, untamed
    phase_pp_train(pp, pp_batch_fn(pointpillars_optim_cfg()[
        "samples_per_gpu"]))
    del pp
    torch.cuda.empty_cache()
    phase_pp_reference()

    per_step = train["launches_per_step"]
    kernels = [dict(
        name="masked_gather", route="cuda",
        source="isfusion_tpu_torch/csrc/masked_gather.cu",
        replaces="tools/analysis_tools/micro_dma_gather.py:25",
        launches=launches["masked_gather"],
        max_abs_err=max(rec["max_abs_err"], bwd["max_abs_err"]),
        ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by="bytes", library_ms=rec["library_ms"],
        launches_per_request=launches["masked_gather"] // N_REQUESTS,
        train_launches_per_step=dict(
            forward=per_step["masked_gather_forward"],
            backward=per_step["masked_gather_backward"]),
        backward=dict(ms=bwd["ms"], plain_ms=bwd["plain_ms"],
                      bound_ms=bwd["bound_ms"],
                      library_ms=bwd["library_ms"])),
        dict(name="boxes_iou_3d", route="cuda",
             source="isfusion_tpu_torch/csrc/boxes_iou_3d.cu",
             replaces="isfusion_tpu/ops/box_ops.py:180",
             launches=train["launches"]["boxes_iou_3d"],
             max_abs_err=iou["max_abs_err"], ms=iou["ms"],
             plain_ms=iou["plain_ms"], bound_ms=iou["bound_ms"],
             bound_by="operations", library_ms=None,
             train_launches_per_step=per_step["boxes_iou_3d"],
             device_ms=iou["device_ms"],
             one_sample_device_ms=iou["one_sample_device_ms"],
             per_sample_launches_ms=iou["per_sample_launches_ms"]),
        dict(name="nms_bev", route="cuda",
             source="isfusion_tpu_torch/csrc/nms_bev.cu",
             replaces="isfusion_tpu/ops/box_ops.py:216",
             launches=pp_launches["nms_bev"],
             max_abs_err=nms["max_abs_err"], ms=nms["ms"],
             plain_ms=nms["plain_ms"], bound_ms=nms["bound_ms"],
             bound_by="operations", library_ms=None,
             launches_per_request=pp_launches["nms_bev"] // N_REQUESTS,
             circle_cut_bound_ms=nms["circle_cut_bound_ms"],
             all_pairs_bound_ms=nms["all_pairs_bound_ms"],
             pairwise_device_ms=nms["pairwise_device_ms"],
             greedy_device_ms=nms["greedy_device_ms"])]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def pp_serve_timing(tree: str, requests: int = 50) -> int:
    """``python3 chip_smoke.py --pp-serve [TREE]``: pp-serve alone, with
    the port imported from the checkout TREE (default: this one), to
    compare two checkouts on one card in one call (run them in the order
    A, B, B, A). The main path's model, tamed, serves one warm-up and
    ``requests`` timed batch-1 requests; then the warm-up's K10-NMS call
    is timed alone: CUDA-event ms, and the host's ms to make one call
    (from an idle card, no sync inside). Prints one JSON record."""
    import torch
    smi = phase_device()
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import isfusion_tpu_torch
    from isfusion_tpu_torch.flagship import build_pointpillars_flagship
    from isfusion_tpu_torch.ops import box_ops, cuda_build
    from isfusion_tpu_torch.testing import tame_box_deltas
    if not isfusion_tpu_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"isfusion_tpu_torch imported from "
                           f"{isfusion_tpu_torch.__file__}, not {tree}")
    pp, batch_fn = build_pointpillars_flagship(device="cuda", seed=0)
    batch = batch_fn(1)
    tame_box_deltas(pp)
    boxes, scores, valid = record_nms_inputs(pp, jittered(batch, 0), "cuda")
    times = []
    for i in range(requests):
        t0 = time.perf_counter()
        pp(jittered(batch, i + 1), device="cuda")
        sync("cuda")
        times.append((time.perf_counter() - t0) * 1e3)

    def nms():
        return box_ops.nms_bev_mask(boxes, scores, 0.2, valid)

    event_ms = cuda_ms(nms, iters=200)
    host = []
    for _ in range(100):
        sync("cuda")
        t0 = time.perf_counter()
        nms()
        host.append((time.perf_counter() - t0) * 1e3)
    sync("cuda")
    log("pp_serve", nvidia_smi=smi, tree=tree,
        nms_library=cuda_build._lib_path("nms_bev").name, requests=requests,
        median_ms=statistics.median(times), min_ms=min(times),
        max_ms=max(times), all_ms=times, nms_event_ms=event_ms,
        nms_host_ms=statistics.median(host), nms_host_max_ms=max(host))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pp-serve"]:
        sys.exit(pp_serve_timing(sys.argv[2] if len(sys.argv) > 2 else REPO))
    sys.exit(main())
