#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``isfusion_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one line (every failure raises, exit code != 0):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles every hand-written kernel from ``isfusion_tpu_torch/
   csrc`` (one ``nvcc`` per source, all started together);
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
   version;
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
   1e-3, no clip) must lower the loss.

The card's ``nvidia-smi`` line, then the kernels' JSON record, then
``{"ok": true, "device": {...}}`` end the output.
"""
from __future__ import annotations

import json
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
    from isfusion_tpu_torch.ops import cuda_build
    secs = cuda_build.build_all()
    log("build", kernels=sorted(cuda_build.SIGNATURES), seconds=secs)


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
    assigner's per-sample shape at batch 4), within 1e-5; one launch
    timed beside its operation bound."""
    import torch
    from isfusion_tpu_torch.ops import box_ops

    gen = torch.Generator().manual_seed(2)
    pairs = [tuple(t.to(dev) for t in iou_test_boxes(gen)) for _ in range(4)]
    err, ops = 0.0, 0
    for a, b, same in pairs:
        got = box_ops.boxes_iou_3d(a, b)
        ref = box_ops.boxes_iou_3d_ref(a, b)
        sync(dev)
        err = max(err, float((got - ref).abs().max()),
                  float((got[same, range(8)] - 1).abs().max()))
        ops += box_ops.iou3d_ops(a, b)
    a, b, _ = pairs[0]
    nbytes = (a.numel() + b.numel() + a.shape[0] * b.shape[0]) * 4
    ops_per_launch = ops / len(pairs)
    rec = dict(N=a.shape[0], M=b.shape[0], launches_checked=len(pairs),
               max_abs_err=err, ops_per_launch=ops_per_launch,
               ms=cuda_ms(lambda: box_ops.boxes_iou_3d(a, b), dev, iters=50),
               plain_ms=cuda_ms(lambda: box_ops.boxes_iou_3d_ref(a, b), dev),
               bound_ms=max(ops_per_launch / F32_OPS_PER_S,
                            nbytes / HBM_BYTES_PER_S) * 1e3,
               library_ms=None)
    log("iou_check", **rec)
    if err > 1e-5:
        raise RuntimeError(f"boxes_iou_3d differs from its plain version by "
                           f"{err:.3g}")
    return rec


BREAKDOWN_MODULES = ("img_backbone", "img_neck", "pts_voxel_encoder",
                     "pts_middle_encoder", "fusion_encoder", "pts_backbone",
                     "pts_neck", "pts_bbox_head")


def phase_breakdown(model, batch: dict):
    """Where one request's time goes: CUDA events around each top-level
    module (forward hooks; stream time, so launch gaps count), then one
    request under torch.profiler for the device's busy share and the top
    device operations (kernels and copies). ``fusion_encoder`` includes the ``pts_backbone`` stages it
    calls; the rest of the request is upload, voxelization,
    pillarization, decode and host gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spans = {n: [] for n in BREAKDOWN_MODULES}

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
    for n in BREAKDOWN_MODULES:
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
    top = sum(v for k, v in module_ms.items() if k != "pts_backbone")
    log("breakdown", request_ms=wall, module_ms=module_ms,
        rest_ms=wall - top)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(jittered(batch, 0), device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log("profile", request_ms=wall, device_busy_ms=busy,
        device_idle_share=1 - busy / wall if busy > 0 else "not measured",
        device_ops=sum(e.count for e in kernels),
        top_device_ops=[dict(name=e.key[:70], count=e.count,
                          ms=e.self_device_time_total / 1e3)
                     for e in kernels[:10]])


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


def train_profile(step, batch: dict, gen):
    """One train step under torch.profiler: the device's busy and idle
    share and the top device operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    log("train_profile", step_ms=wall, device_busy_ms=busy,
        device_idle_share=1 - busy / wall if busy > 0 else "not measured",
        device_ops=sum(e.count for e in ops),
        top_device_ops=[dict(name=e.key[:70], count=e.count,
                             ms=e.self_device_time_total / 1e3)
                        for e in ops[:12]])


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
            train_profile(step, jittered(batch, 0), gen)
    finally:
        transfusion_head.assign_batch = real_assign
        hook.remove()
    unchanged = [f"{n}[{j}]" for n, ps in watch.items()
                 for j, (p, q) in enumerate(zip(getattr(model,
                                                        n).parameters(), ps))
                 if torch.equal(p.detach(), q)]
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
             train_launches_per_step=per_step["boxes_iou_3d"])]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
