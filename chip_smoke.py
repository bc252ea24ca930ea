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
   counts are zeroed just before the five requests and read after each;
   the phase fails unless every kernel of the predict path (K12, K1
   dynamic voxelization, K2 dynamic scatter) launched in every request.
   ``forward_repeat`` says whether two eval-mode head outputs of one
   request are equal, and gives the total loss of two forwards with the
   default and with the deterministic kernels;
4. kernel check: each kernel against its plain PyTorch version on the
   inputs the main path gave it (stage-0 and stage-1 im2col gathers) and
   on the TPU microbenchmark's shape, bit for bit, with timings; K1 and
   K2 (``[dynamic_check]``) on the request's own voxelization and
   DynamicVFE inputs, and after phase 8 on the first train batch's (batch
   4): K1's rows, table and point lists and K2's max (forward and
   backward, through the lists the path's K1 built) equal to their plain
   versions, K2's mean equal to the plain version on the CPU and within
   1e-6 of the max of the plain version on the card, with ms, device ms,
   plain ms, library ms and the byte bound. No K2 call of the flagship or
   MVX-Net paths builds a list of its own (``check_no_layout_builds``).
   The K12 backward (the transposed-rulebook gather of a sparse conv's dX)
   at the stage-0 shapes, bit for bit, and one conv's dX and dW against
   plain autograd;
5. breakdown: one request with CUDA events around each top-level module,
   one under torch.profiler (device busy share, top kernels);
6. precision gap: the same request with every compute dtype float32 (TF32
   off) against the bfloat16 run (reported, not asserted);
7. reference check: the tiny flagship on the card against the same model
   on the CPU (the kernels' plain versions), float32;
8. train: the full-width flagship in train mode with the config's AdamW,
   cyclic schedules and grad clip takes 1 warm-up and 3 timed steps at
   batch 4 (``samples_per_gpu``; one sample with two camera views
   dropped), bf16; the warm-up step records K10's inputs. Launch counts
   are zeroed before the timed steps and
   read after, split into each step's forward and backward. Prints each
   step's losses, grad norm and ms, peak memory, the host Hungarian's ms
   and the launches per step (K12 forward and backward, K10, K11 for the
   dense heatmap target, K1, K2 forward and backward); fails on a
   non-finite loss or grad norm, a
   zero grad norm, a kernel not launched in every step, or an unchanged
   weight of the sparse encoder, the fusion encoder or the head. Then K10
   (rotated 3D IoU) against its plain version on that step's own
   assigner inputs (4 x 200 x 64 pairs, every sample in one launch,
   read in the assigner's 9-wide rows), on 4 x 200 x 64 pairs with
   identical, disjoint, rotated and nested boxes, and on edge sets
   (touching, nested, identical, 45 degrees, stacked in z, far apart):
   within 1e-5 and exactly 0 wherever the plain version is, with the
   shares of pairs each exact cut settles, ms, whole-call device ms and
   operations, the data-dependent and all-pairs bounds
   (``[iou_case]``, ``[iou_check]``) and the floor of an empty launch;
9. train reference: one float32 step of the tiny flagship (dropout off) on
   the card and on the CPU from the same weights and batch: loss terms
   within 1e-4 relative, each top-level module's gradient within 1e-3 of
   its max (the K12 route against plain autograd on the card is
   reported beside it); then 10 steps on that batch on the card (lr
   1e-3, no clip) must lower the loss;
10. isfusion_learn: the flagship's train -> eval loop
    from ``configs/isfusion/isfusion_0075voxel.py`` as written (CBGS,
    10-sweep LiDAR, six 900 x 1600 PNG views, GT-paste with image
    patches, ModalMask3D, ImageAug3D, global rot / scale / flip; batch 4,
    6 loader workers) on a 4 / 2-sample fixture with its GT database
    under ``build/``: the first 2 of the 10 epochs at full width by
    ``train_model``, a fresh model resumed from ``epoch_1.pth`` (step
    count, weights, optimizer and generator state and the epoch's
    batches equal; losses reported beside the first run's, and whether
    one batch's forward repeats), then
    ``single_device_test`` + ``evaluate`` of the val split through
    ``MultiScaleFlipAug3D``. Launch counts zeroed just before the loop and
    read after; K12 forward and backward and K10 must launch in every
    loop step. Prints CBGS's length, steps per epoch, points per sample,
    step ms inside an epoch and at its start, the data-time share, the
    launches per step, peak memory, eval samples/s, the metrics and the
    resume check;
11. PointPillars main path: the full-width PointPillars of
    ``configs/pointpillars/hv_pointpillars_secfpn_sbn-all_4x8_2x_nus-3d.py``
    (seeded random weights, the box-regression weights scaled by 0.01 so
    that boxes are scene-sized, bf16 convs, float32 decode and NMS) serves
    one warm-up and five batch-1 requests of 120,000 points; launch counts are
    zeroed just before the five and read after each: the phase fails
    unless K10-NMS (``nms_bev``) launched in every request. Prints the
    median and max ms, peak memory, pillars against the cap and the kept
    boxes;
12. learn: the train -> eval loop of ``isfusion_tpu_torch/apis`` on a
    fixture of 8 train / 4 val samples (the port's generator, 120,000
    points, car and pedestrian) under ``build/``: the first 2 of the 100
    epochs of ``configs/pointpillars/hv_pointpillars_learnability_syn.py``
    at batch 4 from seeded weights, box regression scaled by 0.01
    (checkpoint every epoch, evaluation after epoch 2), launch counts
    zeroed just before and read just after; a second model resumed from
    the epoch-1 checkpoint must log the same losses and metrics; then
    ``single_device_test`` + ``evaluate`` on the val split, ``nms_bev``
    once per predict batch. Prints step ms, the data wait's share, the
    first and last loss, the metrics, eval samples/s and peak memory;
13. PointPillars kernel check: K10-NMS against its plain version on the
    request's own top-1,000 boxes and 10 classes, on the same request
    before the scaling, on a scene-like set of 1,000 boxes and 10 classes
    with no pair near the threshold, on 1,000 boxes within 3 m (every
    bounding circle meets) and 1,000 on a 10 m grid (none meets), and on
    adversarial sets (identical, nested, 45-degree, chained, all-invalid,
    single box) and on the learn phase's eval batch (B 4 x C 2 x K 256,
    trained and random weights): keep masks equal to the plain greedy
    walk over the kernel's own suppression bits, those bits symmetric
    and equal wherever the plain IoU is more than 1e-5 from the
    threshold, keep masks equal to the plain version's whenever no pair
    is that close;
    prints each set's box sizes, the shares of pairs whose circles meet
    and whose boxes intersect, three operation bounds (the least that
    settles every pair, the kernel's circle cut, every pair) and each
    pass's device time;
14. PointPillars train: batch 4, the ``schedule_2x`` recipe (AdamW, step
    lr with linear warmup, clip 35), 1 warm-up and 3 timed steps; fails on
    a non-finite or zero grad norm or an unchanged weight of the VFE, the
    backbone or the head;
15. PointPillars reference: the tiny PointPillars in float32 on the card
    against the CPU, predict (same kept entries and labels, boxes within
    1e-4 of their max) and one train step (losses 1e-4 relative,
    gradients per top-level module 1e-3 of their max);
16. CenterPoint main path: the full-width CenterPoint of
    ``configs/centerpoint/centerpoint_0075voxel_second_secfpn_circlenms_
    4x8_cyclic_20e_nus.py`` (seeded random weights, hard 0.075 m voxels,
    bf16 sparse encoder, SECOND, SECONDFPN and CenterHead convs; float32
    decode and circle NMS) serves one warm-up and five batch-1 requests
    of the flagship's 200,000-point cloud, the points jittered; launch
    counts zeroed just before the five and read after each: the phase
    fails unless K12 (``masked_gather``) and K10-circle (``nms_circle``)
    launched in every request. Prints the median and max ms, peak
    memory, voxels against the 120,000 test cap, active sites per sparse
    stage and the boxes kept per task; then ``cp_breakdown`` /
    ``cp_profile``;
17. CenterPoint train: batch 4, 64 padded GT rows, the config's AdamW,
    cyclic lr and momentum and clip 35, 1 warm-up and 3 timed steps;
    fails on a non-finite loss or grad norm, a zero grad norm, an
    unchanged weight of the SparseEncoder, SECOND or CenterHead, or a step
    without K12 forward, K12 backward or K11 (``gaussian_heatmap``)
    launches. Prints the median and max ms, peak memory and the launches
    per step;
18. CenterPoint kernel check: K10-circle against its plain version on
    the request's own decoded sets (6 tasks x 500), an eval batch's (B 4
    x 6 x 500) and adversarial sets (identical centres, all within the
    radius, none within, pairs exactly on the threshold, equal scores,
    all invalid, a single box): keep masks equal. K11 against its plain
    version on the CenterPoint step's inputs (B 4 x G 64, 180 x 180, 10
    classes) and the flagship step's: heatmaps equal, cells at 1.0 equal.
    Each kernel's ms (CUDA events), device ms (profiler; K10-circle's
    whole call and its device operations, also on the request's sets
    shuffled), plain ms and bound, and the floor of an empty launch;
19. CenterPoint reference: the tiny CenterPoint in float32 on the card
    against the CPU, predict (same kept entries and labels, boxes within
    1e-4 of their max) and one train step (losses 1e-4 relative,
    gradients per top-level module 1e-3 of their max);
20. MVX-Net main path (``[mvx_main_path]``): the full-width MVX-Net of
    ``configs/mvxnet/dv_mvx-fpn_second_secfpn_adamw_2x8_80e_kitti-3d-
    3class.py`` (seeded random weights, the head's class bias zeroed and
    its box regression scaled by 0.01 so that NMS sees full sets of
    scene-sized boxes; ResNet-50, FPN, PointFusion's
    lateral convs, the SparseEncoder, SECOND, SECONDFPN and the head in
    bf16; dynamic voxels, the VFE, PointFusion's transforms, decode and
    NMS float32) serves one warm-up and five batch-1 requests of a
    KITTI-like 120,000-point 360-degree cloud (about half in the front
    range) and one 384 x 1280 view; launch counts zeroed just before the
    five and read after each: fails unless K1, K2, K12 and K10-NMS
    launched in every request. Prints the median and max ms, the voxels
    against the JAX package's (80000, 90000) cap (not applied), active
    sites per sparse stage, boxes kept, peak memory; then
    ``mvx_breakdown`` / ``mvx_profile`` (the device idle share);
21. MVX-Net train (``[mvx_train]``): batch 2, 16 padded 3-class GT rows,
    the config's AdamW, CosineAnnealing with linear warmup and clip 35, 1
    warm-up and 3 timed steps; prints the losses, grad norm, ms, peak
    memory and the launches per step (K1, K2 forward and backward, K12
    forward and backward); fails on a non-finite loss, a step without one
    of them, an unchanged weight of the VFE, PointFusion, the sparse
    encoder, FPN, ResNet's layer4 or the head, or a changed frozen ResNet
    tensor (the stem, layer1, every BatchNorm);
22. MVX-Net kernel check (``[mvx_kernel_check]``): K1 and K2 against
    their plain versions on the MVX request's own inputs and K1 on the
    adversarial sets of ``testing.voxel_adversarial_sets`` (points on
    voxel faces, duplicates, out-of-range and masked points, empty
    samples) at MVX-Net's grid;
23. MVX-Net reference (``[mvx_reference]``): the tiny MVX-Net in float32
    (TF32 off) on the card against the CPU, predict (the same kept boxes
    and labels, boxes within 1e-4 of their max) and one train step
    (losses 1e-4 relative, gradients per top-level module 1e-3 of their
    max);
24. FCOS3D main path (``[fcos_main_path]``): the full-width FCOS3D of
    ``configs/fcos3d/fcos3d_r101_caffe_fpn_gn-head_2x8_1x_nus-mono3d.py``
    (seeded random weights; ResNet-101, FPN and the GN head's convs in
    bf16, GN statistics and decode float32; no hand-written kernel on its
    path) serves one warm-up and five batch-1 requests of one 928 x 1600
    view; prints the median and max ms, peak memory, the stream ms of the
    backbone, neck, head and decode, the device idle share
    (``[fcos_profile]``) and the precision gap against a float32 run;
25. FCOS3D train (``[fcos_train]``): batch 2, 24 GT rows a view, the
    config's SGD, warmup and clip 35, 1 warm-up and 3 timed steps; fails
    on a non-finite loss term, a frozen ResNet tensor that moved or any
    other parameter that did not;
26. FCOS3D reference (``[fcos_reference]``): the tiny FCOS3D in float32
    on the card against the CPU: head outputs, decode, losses, gradients
    and one SGD step;
27. LiDAR variants (``[lidar_variants]``): the six tiny detectors of
    ``flagship.LIDAR_VARIANTS`` (DynamicVoxelNet on DynamicSimpleVFE, on
    dynamic pillars and on DynamicVFE, DynamicCenterPoint, VoxelNet,
    TransFusion-L) on nuScenes' raw intensities, on the card against the
    CPU with the card taking the CPU's discrete choices (each one it
    would have made otherwise must be a tie within rounding): head
    outputs, kept boxes, train-mode losses and gradients; each kernel's
    launches on the predict and loss paths (every kernel of a path must
    launch) and each kernel against its plain version on that path's own
    inputs.

28. data-parallel train (``[dp_train]``): the flagship's one-card step
    at batch 4 (the config's recipe, seed 0) three times (how far it
    repeats: P2G's ``index_add_`` and ``grid_sampler_2d_backward`` sum by
    atomics) and once with the sync norms' pooled sums
    (``testing.pooled_sync_norms``), then the same step as a
    data-parallel step in a process group of one rank under NCCL (the
    config's backend) against the first: losses 1e-4 relative, updated
    parameters 1e-3 of each top-level module's max, each module's
    gradients within 1e-3 of its max where the one-card step repeats
    that closely, else within ``DP_GRAD_CEILING``, which no module's
    repeat gap may pass; one all-reduce and the one-card step's
    launches. Then ``DP_WORLD`` (2) ranks spawned under gloo, both on
    ``cuda:0`` (NCCL refuses two ranks on one device), each running
    ``dp_rank`` (spawned before phase 27, where they start, build the
    flagship and warm it up with a batch-1 DP step while the variants
    run, then wait for the references): (a) a flagship step at batch 4 a rank on identical halves, held as
    above against the one-card step with the pooled sums (the ranks'
    sums double exactly); (b) 2 steps on the distinct halves of a global
    batch of 8 (each rank its own generator): the first step's averaged
    gradients against the mean of the ranks' own (gathered on the host,
    1e-6 of the max), the synced VFE's running statistics after it
    against one train-mode pass of the VFE over all 8 samples (1e-4 of
    their max); PointPillars with every norm synced: the feature path
    up to the neck (float32, TF32 off, train mode) on each rank's 4
    samples against its rows of one forward over the 8, every running
    statistic too (1e-4 of the max), then 2 DP train steps at its
    precision. Prints per rank the step ms (two ranks share one card:
    not a scaling figure), the gradient all-reduce's ms and bytes, the
    sync-BN collectives per step, the peak GiB, each step's launches
    (equal to the one-card step's) and the host seconds of each part;
29. gathered eval (``[dp_eval]``): the learnability PointPillars (seeded,
    box deltas tamed, float32, TF32 off) on a 5-sample val split, 2
    samples a rank, the last global batch padded: every rank's gathered
    results against ``single_device_test`` in one process (the same
    kept entries and labels, boxes and scores 1e-4 of their max), the
    metrics within 1e-4.

The card's ``nvidia-smi`` line, then the kernels' JSON record (each
kernel with its launches on the LiDAR variants' paths and, for K12, K1,
K2, K11 and K10, on each rank's DP steps), then
``{"ok": true, "device": {...}}`` end the output.

``python3 chip_smoke.py --dp`` runs the device and build phases, then
phases 28-29 alone.

``python3 chip_smoke.py --fcos`` runs the device and build phases, then
phases 24-26 alone.

``python3 chip_smoke.py --pp-serve [TREE]`` runs only pp-serve (more
requests, then the K10-NMS wrapper's device and host time), with the port
imported from the checkout TREE: two checkouts compared in one call
(``pp_serve_timing``).

``python3 chip_smoke.py --dynamic TREE`` runs only the four cells of K1
and K2 (serve, train, mvx-serve, mvx-train; more requests and steps) and
times K1 and K2 on each cell's own inputs, with the port imported from
the checkout TREE: two checkouts compared in one call
(``dynamic_compare``).

``python3 chip_smoke.py --boxes TREE`` runs only cp-serve and the
flagship's train step (more requests and steps) and times K10-circle and
K10 on their own inputs (CUDA-event ms, whole-call device ms and
operations), with the port imported from the checkout TREE, beside the
floor of an empty launch: two checkouts compared in one call
(``boxes_compare``).

``python3 chip_smoke.py --learn WORK_DIR`` runs the learnability recipe in
full (48 train / 16 val samples, 100 epochs, ``learn_run``) and leaves
``WORK_DIR/train_log.jsonl``.

``python3 chip_smoke.py --isfusion-learn`` runs phase 10 alone (after the
device and build phases).
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
N_REQUESTS = 5
N_TRAIN_STEPS = 3
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
F32_OPS_PER_S = 67e12               # H100 SXM float32 rate, no tensor cores
MICRO_SHAPE = (145_000, 1536, 145_408)  # (V, F, N) of micro_dma_gather.py


def log(phase: str, **kw) -> None:
    """One line of ``phase``'s results; ``t_s`` is the host seconds since
    the script started."""
    kw["t_s"] = round(time.perf_counter() - T0, 1)
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
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # a warm-up step under the profiler first: the trace misses the first
    # launches of a profile (up to a fifth of 50 short calls), which
    # undercounted the operations of a call
    done = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: done.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    # the profiler's own device-side events (the step's annotation spans
    # the step; buffer requests; the synchronisations the profile waits
    # on) are no operations of fn
    return {e.key: (e.count / iters, e.self_device_time_total / 1e3 / e.count)
            for e in done[0] if e.device_type == DeviceType.CUDA and e.count
            and not (e.key.startswith(("ProfilerStep",
                                       "Activity Buffer Request"))
                     or "Sync" in e.key)}


def kernel_breakdown(fn, iters: int = 20) -> dict:
    """{kernel's short name: device ms per ``fn()`` call}
    (``device_kernels``), largest first."""
    import re
    per = collections.Counter()
    for name, (n, ms) in device_kernels(fn, iters).items():
        m = re.search(r"(\w+)(?:<[^>]*>)?\(", name)
        per[m.group(1) if m else name] += n * ms
    return dict(per.most_common())


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


def recording_heatmap(real, seen: list):
    """``real`` (a head's ``draw_heatmap_gaussian_batch``) that also
    appends each call's inputs to ``seen``; the kernel still runs."""
    def draw(shape_hw, centers, radii, valid, labels, num_classes):
        seen.append((tuple(shape_hw), centers.clone(), radii.clone(),
                     valid.clone(), labels.clone(), num_classes))
        return real(shape_hw, centers, radii, valid, labels, num_classes)
    return draw


@contextlib.contextmanager
def recording_gathers():
    """Inside the block, the first K12 call of each (rows, width) keeps its
    inputs in the yielded dict; the kernel (or its plain version) still
    runs."""
    from isfusion_tpu_torch.ops import sparse_conv

    real, real_ref, seen = sparse_conv.masked_gather, \
        sparse_conv.masked_gather_ref, {}

    def recording(fn):
        def gather(src, idx, fmask):
            seen.setdefault(tuple(src.shape), (src.clone(), idx.clone(),
                                               fmask.clone()))
            return fn(src, idx, fmask)
        return gather

    sparse_conv.masked_gather = recording(real)
    sparse_conv.masked_gather_ref = recording(real_ref)
    try:
        yield seen
    finally:
        sparse_conv.masked_gather, sparse_conv.masked_gather_ref = \
            real, real_ref


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
    from isfusion_tpu_torch.ops import cuda_build

    # the first gather input of each (rows, width) seen in the warm-up:
    # the main path's own stage-0/1 im2col inputs (the kernel's route on
    # the card, the plain one in a CPU rehearsal)
    stats = {}
    with recording_gathers() as seen, recording_dynamic() as dynamic_in:
        model(jittered(batch, 0), device=dev, stats=stats)
        sync(dev)
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
    times, per_request = [], []
    for i in range(N_REQUESTS):
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: cuda_build.LAUNCHES[k] - before[k]
                            for k in PREDICT_KERNELS})
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
               launches_per_request=per_request, launches=launches)
    if dev == "cuda":
        req["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # does a serve forward repeat? two eval-mode head outputs of one
    # request, and the total loss of two forwards with the default and
    # the deterministic kernels (PERF.md question 10)
    one = jittered(batch, 0)
    req["forward_repeat"] = dict(
        feats_equal=_same_tree(model(one, mode="feats", device=dev),
                               model(one, mode="feats", device=dev)),
        loss=_forward_repeat(model, one, dev))
    log("main_path", **req)
    if dev == "cuda" and any(min(r.values()) == 0 for r in per_request):
        raise RuntimeError(f"a request launched no {PREDICT_KERNELS}: "
                           f"{per_request}")
    req["dynamic_inputs"] = dynamic_in
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


def same_layout(t):
    """A copy of ``t`` with its strides (a slice of wider rows stays one)."""
    import torch
    out = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                              device=t.device)
    return out.copy_(t)


@contextlib.contextmanager
def recording_iou():
    """Inside the block, every K10 call of the assigner appends its
    inputs (the proposals' and the GTs' rows, in their own layout) to the
    yielded list; the kernel still runs."""
    from isfusion_tpu_torch.core.bbox import assigners

    real, seen = assigners.boxes_iou_3d, []

    def recording(a, b):
        seen.append((same_layout(a), same_layout(b)))
        return real(a, b)

    assigners.boxes_iou_3d = recording
    try:
        yield seen
    finally:
        assigners.boxes_iou_3d = real


def launch_floor(dev: str = "cuda") -> dict:
    """The floor of one launch on this card: an empty kernel
    (``csrc/empty_launch.cu``) through ctypes, as the wrappers launch
    theirs: CUDA-event ms a launch (launches queued back to back), device
    ms (profiler)."""
    if dev != "cuda":
        return dict(ms="not measured", device_ms="not measured")
    import torch
    from isfusion_tpu_torch.ops import cuda_build
    lib = cuda_build.load("empty_launch")

    def launch():
        err = lib.empty_launch(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty_launch failed with CUDA error {err}")

    return dict(ms=cuda_ms(launch, iters=200),
                device_ms=device_ms_per_call(launch, iters=50))


def iou_case(a, b, dev: str = "cuda", timed: bool = True) -> dict:
    """K10 on (a, b) against its plain version: max error, the pairs the
    plain version makes exactly 0 that the kernel does not (must be 0),
    the shares of pairs settled by each cut, and, ``timed``: CUDA-event
    ms, whole-call device ms and device operations (profiler, every
    operation the wrapper issues), plain ms, the data-dependent bound
    (``iou3d_needed_ops``: each pair's cheapest certificate, or the bytes)
    and the all-pairs one."""
    import torch
    from isfusion_tpu_torch.ops import box_ops

    got = box_ops.boxes_iou_3d(a, b)
    ref = box_ops.boxes_iou_3d_ref(a, b)
    sync(dev)
    by_z, by_circle = box_ops.iou3d_early_outs(a, b)
    r = dict(shape=[list(a.shape), list(b.shape)],
             row_strides=[a.stride(-2), b.stride(-2)],
             max_abs_err=float((got - ref).abs().max()),
             zeros=int((ref == 0).sum()),
             nonzero_where_plain_zero=int((got[ref == 0] != 0).sum()),
             cut_by_z=float(by_z.float().mean()),
             cut_by_circle=float((by_circle & ~by_z).float().mean()))
    if not timed:
        return r
    n, m = a.shape[-2], b.shape[-2]
    nbytes = (a[..., 0].numel() + b[..., 0].numel()) * 7 * 4 + \
        got.numel() * 4
    needed, every = box_ops.iou3d_needed_ops(a, b), box_ops.iou3d_ops(a, b)
    t_ops, t_bytes = needed / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    r.update(pairs=got.numel(), needed_ops=needed, all_pairs_ops=every,
             ms=cuda_ms(lambda: box_ops.boxes_iou_3d(a, b), dev, iters=50),
             plain_ms=cuda_ms(lambda: box_ops.boxes_iou_3d_ref(a, b), dev),
             bound_ms=max(t_ops, t_bytes) * 1e3,
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             all_pairs_bound_ms=max(every / F32_OPS_PER_S, t_bytes) * 1e3)
    if dev == "cuda":
        ops = device_kernels(lambda: box_ops.boxes_iou_3d(a, b), iters=50)
        r.update(device_ms=sum(k * ms for k, ms in ops.values()),
                 kernel_device_ms=kernel_ms(ops, "boxes_iou_3d_kernel"),
                 device_ops_per_call={k[:60]: v for k, (v, _) in
                                      ops.items()})
    return r


def phase_iou_check(train_in=None, dev: str = "cuda") -> dict:
    """K10 against its plain version: on the train step's own assigner
    inputs (``train_in``, recorded by ``phase_train``: every sample and
    decoder layer, in the assigner's strided rows; the main path's shape),
    on 4 x 200 x 64 pairs with identical, disjoint, rotated and nested
    boxes (``testing.iou_test_boxes``, all samples in one launch) and on
    the edge sets of ``testing.iou_edge_sets`` (touching, nested,
    identical, 45 degrees, stacked in z, far apart): within 1e-5, and
    exactly 0 wherever the plain version is. The first two timed
    (``iou_case``), the batched test boxes also launched once per sample
    (``per_sample_launches_ms``: the design before batching)."""
    import torch
    from isfusion_tpu_torch.ops import box_ops
    from isfusion_tpu_torch.testing import iou_edge_sets, iou_test_boxes

    gen = torch.Generator().manual_seed(2)
    sets = [iou_test_boxes(gen) for _ in range(4)]
    a = torch.stack([s[0] for s in sets]).to(dev)
    b = torch.stack([s[1] for s in sets]).to(dev)
    recs = {}
    if train_in is not None:
        recs["train"] = iou_case(*train_in, dev=dev)
    recs["test_boxes"] = iou_case(a, b, dev=dev)
    got = box_ops.boxes_iou_3d(a, b)
    for i, (_, _, same) in enumerate(sets):
        recs["test_boxes"]["max_abs_err"] = max(
            recs["test_boxes"]["max_abs_err"],
            float((got[i, same, range(8)] - 1).abs().max()))
    recs["test_boxes"]["per_sample_launches_ms"] = cuda_ms(
        lambda: [box_ops.boxes_iou_3d(a[i], b[i]) for i in range(4)], dev,
        iters=50)
    for name, ea, eb in iou_edge_sets():
        recs[name] = iou_case(ea.to(dev), eb.to(dev), dev, timed=False)
    for name, r in recs.items():
        log("iou_case", case=name, **r)
        if r["max_abs_err"] > 1e-5 or r["nonzero_where_plain_zero"]:
            raise RuntimeError(f"boxes_iou_3d differs from its plain version "
                               f"on {name}: {r}")
    main = recs["train" if train_in is not None else "test_boxes"]
    rec = dict(main, max_abs_err=max(r["max_abs_err"] for r in
                                     recs.values()),
               test_boxes=recs["test_boxes"],
               launch_floor=launch_floor(dev))
    log("iou_check", **{k: v for k, v in rec.items()
                        if k != "device_ops_per_call"})
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

    return device_profile(f"{prefix}profile",
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


PREDICT_KERNELS = ("masked_gather", "dynamic_voxelize", "dynamic_scatter")
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
    rec = dict(wall_ms=wall, device_busy_ms=busy,
               device_idle_share=1 - busy / wall if busy > 0
               else "not measured", device_ops=sum(e.count for e in ops))
    log(phase, **rec, top_device_ops=[dict(name=e.key[:70], count=e.count,
                                           ms=e.self_device_time_total / 1e3)
                                      for e in ops[:top]])
    return rec


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
    hungarian_ms, fwd_marks, heat_in = [], [], []
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
    real_heat = transfusion_head.draw_heatmap_gaussian_batch
    transfusion_head.draw_heatmap_gaussian_batch = recording_heatmap(
        real_heat, heat_in)
    hook = model.register_forward_hook(at_forward_end)
    try:
        with recording_dynamic() as dynamic_in, recording_iou() as iou_in:
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
                boxes_iou_3d=after["boxes_iou_3d"] - before["boxes_iou_3d"],
                gaussian_heatmap=after["gaussian_heatmap"] -
                before["gaussian_heatmap"],
                dynamic_voxelize=mid["dynamic_voxelize"] -
                before["dynamic_voxelize"],
                dynamic_scatter_forward=mid["dynamic_scatter"] -
                before["dynamic_scatter"],
                dynamic_scatter_backward=after["dynamic_scatter"] -
                mid["dynamic_scatter"])
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
        transfusion_head.draw_heatmap_gaussian_batch = real_heat
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
    rec["heatmap_inputs"] = heat_in[0]
    rec["dynamic_inputs"] = dynamic_in
    rec["iou_inputs"] = iou_in[0]
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
    autograd through ``sparse_conv_plain``), then 10 steps on one batch
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
    curve = [float(step(batch, gen)["loss"]) for _ in range(10)]
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
        raise RuntimeError(f"10 steps did not lower the loss: {curve}")

# ------------------------------------------------------------ PointPillars
PP_PREDICT_KERNELS = ("nms_bev",)
PP_MODULES = ("pts_voxel_encoder", "pts_backbone", "pts_neck",
              "pts_bbox_head")
PP_TRAIN_WATCH = ("pts_voxel_encoder", "pts_backbone", "pts_bbox_head")
NMS_NEAR = 1e-5         # a pair this close to the threshold may round apart


@contextlib.contextmanager
def recording_nms():
    """Inside the block, every K10-NMS call of the anchor head appends its
    inputs (its top-``nms_pre`` BEV boxes, every class's scores, their
    validity) to the yielded list; the kernel still runs."""
    from isfusion_tpu_torch.models.dense_heads import anchor3d_head

    real, seen = anchor3d_head.nms_bev_mask, []

    def recording(boxes, scores, thresh, valid):
        seen.append((boxes.clone(), scores.clone(), valid.clone()))
        return real(boxes, scores, thresh, valid)

    anchor3d_head.nms_bev_mask = recording
    try:
        yield seen
    finally:
        anchor3d_head.nms_bev_mask = real


def record_nms_inputs(model, batch: dict, dev: str, stats=None):
    """One PointPillars request; returns the NMS inputs it made."""
    with recording_nms() as seen:
        model(batch, device=dev, stats=stats)
        sync(dev)
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


def phase_pp_kernel_check(nms_in, dev: str = "cuda", untamed=None,
                          eval_sets=()) -> dict:
    """K10-NMS against its plain version (``_nms_compare``) on the
    request's own top boxes and classes, on the same request before the
    box deltas were tamed (``untamed``, boxes far wider than the scene),
    on a scene-like set of 1,000 boxes and 10 classes with no pair near
    the threshold, on 1,000 boxes within 3 m (every circle meets) and
    1,000 on a 10 m grid (none meets), on the adversarial sets and on
    ``eval_sets`` ((name, boxes, scores, valid): the learn phase's eval
    batch, B 4 x C 2 x K 256, trained and with random weights); on the
    card each set's pairwise and greedy passes' device times. The
    request's NMS (and the set named "eval", as ``eval_shape``) timed
    beside its three operation bounds (``bound_ms``, the least that
    settles its pairs; the kernel's circle cut; every pair), with the
    device operations of one wrapper call. Returns the record for the
    JSON line."""
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
    cases += list(eval_sets)
    worst, kept = 0, {}
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
        if name in ("request", "eval"):
            kept[name] = (b, s, v, r)
        if name == "scene" and r["pairs_near_threshold"]:
            raise RuntimeError("the scene set has pairs near the threshold")
        if r["bad_bits"] or not r["greedy_equal"] or not r["symmetric"] or \
                (r["pairs_near_threshold"] == 0 and not r["keep_equal"]):
            raise RuntimeError(f"nms_bev differs from its plain version on "
                               f"{name}: {r}")
    rec = dict(_nms_timing(*kept["request"], thr, dev),
               max_abs_err=float(worst),
               greedy_chunks_per_class=-(-boxes.shape[1] // 64),
               library_ms=None)
    if "eval" in kept:
        rec["eval_shape"] = _nms_timing(*kept["eval"], thr, dev)
    if dev == "cuda":
        # the pairwise pass alone (the greedy pass is the rest)
        rec["pairwise_ms"] = cuda_ms(lambda: box_ops._launch_nms(
            boxes, None, None, None, 1, thr, False), dev, iters=50)
    log("pp_kernel_check", **rec)
    return rec


def _nms_timing(boxes, scores, valid, r: dict, thr: float, dev: str) -> dict:
    """One set's shape, pair shares and operation counts (``r``, from
    ``_nms_compare``), the wrapper's, the plain version's and the sort's
    ms, and its three bounds: each the larger of the operations' time and
    the inputs' bytes over the memory rate."""
    import torch
    from isfusion_tpu_torch.ops import box_ops

    floor = (boxes.numel() * 4 + scores.numel() * 4 + 2 * valid.numel()) \
        / HBM_BYTES_PER_S * 1e3
    rec = dict(B=boxes.shape[0], K=boxes.shape[1], C=scores.shape[1],
               ops=r["ops"], ops_circle_cut=r["ops_circle_cut"],
               ops_all_pairs=r["ops_all_pairs"],
               circles_meet_share=r["circles_meet_share"],
               intersect_share=r["intersect_share"],
               ms=cuda_ms(lambda: box_ops.nms_bev_mask(boxes, scores, thr,
                                                       valid), dev, iters=50),
               plain_ms=cuda_ms(lambda: box_ops.nms_bev_mask_ref(
                   boxes, scores, thr, valid), dev, iters=2),
               sort_ms=cuda_ms(lambda: torch.sort(
                   scores, dim=-1, descending=True, stable=True), dev,
                   iters=50),
               bound_ms=max(r["bound_ms"], floor),
               circle_cut_bound_ms=max(r["circle_cut_bound_ms"], floor),
               all_pairs_bound_ms=max(r["all_pairs_bound_ms"], floor))
    for key in ("pairwise_device_ms", "greedy_device_ms",
                "device_ops_per_call"):
        if key in r:
            rec[key] = r[key]
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


LEARN_CFG = os.path.join(REPO, "configs", "pointpillars",
                         "hv_pointpillars_learnability_syn.py")
LEARN_CLASSES = ["car", "pedestrian"]


def learn_cfg(data_root: str, epochs: int, eval_interval: int,
              ckpt_interval: int, log_interval: int):
    """The learnability config on the fixture at ``data_root``, run for
    ``epochs`` epochs with the given intervals, seed 0."""
    from isfusion_tpu_torch.config import Config
    cfg = Config.fromfile(LEARN_CFG)
    for split in ("train", "val", "test"):
        ann = "train" if split == "train" else "val"
        cfg.data[split].update(data_root=data_root, ann_file=os.path.join(
            data_root, f"nuscenes_infos_{ann}.pkl"))
    cfg.total_epochs = epochs
    cfg.runner.max_epochs = epochs
    cfg.evaluation = dict(interval=eval_interval)
    cfg.checkpoint_config = dict(interval=ckpt_interval)
    cfg.log_config = dict(interval=log_interval)
    cfg.seed = 0
    return cfg


def _steps_summary(records: list) -> dict:
    """Step ms (each logged step's ``time`` less its ``data_time``: the
    upload, step and sync), the data wait's share of the logged time, and
    the first and last logged loss."""
    steps = [r for r in records if "mode" not in r]
    ms = [(r["time"] - r["data_time"]) * 1e3 for r in steps]
    return dict(logged_steps=len(steps), step_ms_median=statistics.median(ms),
                step_ms_max=max(ms),
                data_time_share=sum(r["data_time"] for r in steps)
                / sum(r["time"] for r in steps),
                first_loss=steps[0]["loss"], last_loss=steps[-1]["loss"])


def _timed_eval(model, cfg, dev: str):
    """The val split through ``single_device_test`` (its NMS inputs
    recorded, launch counts zeroed just before and read just after) and
    ``evaluate``: (results, metrics, NMS inputs, record)."""
    import numpy as np
    from isfusion_tpu_torch.apis import single_device_test
    from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
    from isfusion_tpu_torch.ops import cuda_build

    data = dict(cfg.data)
    dataset = build_dataset(data["val"])
    loader = build_dataloader(
        dataset, samples_per_gpu=int(data["samples_per_gpu"]),
        workers_per_gpu=int(data["workers_per_gpu"]), shuffle=False)
    cuda_build.reset_launches()
    with recording_nms() as seen:
        t0 = time.perf_counter()
        results = single_device_test(model, loader, dev)
        predict_s = time.perf_counter() - t0
    launches = cuda_build.LAUNCHES["nms_bev"]
    t0 = time.perf_counter()
    metrics = dataset.evaluate(results)
    n = int(model.pts_bbox_head.test_cfg.get("max_num", 500))
    bad = [i for i, r in enumerate(results)
           if r["bboxes"].shape != (n, 9) or
           not np.isfinite(r["bboxes"][r["mask"]]).all()]
    bad += [k for k, v in metrics.items()
            if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"learn eval: bad results or metrics {bad}")
    rec = dict(samples=len(results), batches=len(loader),
               eval_samples_per_s=len(results) / predict_s,
               evaluate_s=time.perf_counter() - t0, nms_launches=launches,
               kept_boxes=int(sum(r["mask"].sum() for r in results)))
    if dev == "cuda" and launches != len(loader):
        raise RuntimeError(f"nms_bev launched {launches} times in "
                           f"{len(loader)} predict batches")
    return results, metrics, seen[0], rec


def phase_learn(dev: str = "cuda", train: int = 8, val: int = 4,
                points: int = 120_000):
    """The train -> eval loop of ``apis/``: a fixture of ``train`` /
    ``val`` samples (the port's generator, no images) under ``build/``;
    the first 2 of the learnability recipe's 100 epochs at batch 4 by
    ``train_model`` (checkpoint every epoch, evaluation after epoch 2),
    from seeded weights with the box regression scaled by 0.01
    (``tame_box_deltas``: untrained weights decode boxes far wider than
    the scene, and the eval's NMS should see scene-sized ones), launch
    counts zeroed just before and read just after; a second model
    resumed from the epoch-1 checkpoint trains epoch 2 again and must log
    the same losses, grad norms and metrics; then ``single_device_test``
    + ``evaluate`` on the val split (``nms_bev`` once per predict batch).
    PyTorch's deterministic kernels throughout, so that the resumed run
    can match bit for bit. Returns (the eval batch's NMS inputs, those of
    the same batch with the random initial weights, record)."""
    import shutil
    import tempfile

    import torch
    from isfusion_tpu_torch.apis import init_model, train_model
    from isfusion_tpu_torch.datasets import build_dataset
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import tame_box_deltas
    from isfusion_tpu_torch.tools.make_synthetic_nuscenes import make_dataset

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="learn_", dir=os.path.join(REPO, "build"))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        make_dataset(data, train=train, val=val, points=points, seed=0,
                     classes=LEARN_CLASSES)
        fixture_s = time.perf_counter() - t0
        cfg = learn_cfg(data, epochs=100, eval_interval=2, ckpt_interval=1,
                        log_interval=1)
        model = tame_box_deltas(init_model(cfg, device=dev))
        *_, random_in, _ = _timed_eval(model, cfg, dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        records = train_model(model, build_dataset(cfg.data.train), cfg,
                              os.path.join(root, "work"), device=dev,
                              until_epoch=2)
        train_s = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if dev == "cuda" else None
        resumed = train_model(init_model(cfg, device=dev, seed=5),
                              build_dataset(cfg.data.train), cfg,
                              os.path.join(root, "resumed"), device=dev,
                              resume_from=os.path.join(root, "work",
                                                       "epoch_1.pth"),
                              until_epoch=2)
        _, metrics, eval_in, ev = _timed_eval(model, cfg, dev)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root)

    def untimed(recs):
        return [{k: v for k, v in r.items() if k not in ("data_time", "time")}
                for r in recs]

    resume_equal = resumed[0].get("epoch") == 1 and \
        untimed(resumed) == untimed(records[-len(resumed):])
    val_rec = [r for r in records if "mode" in r]
    rec = dict(fixture=dict(train=train, val=val, points=points,
                            seconds=fixture_s),
               train_s=train_s, **_steps_summary(records),
               train_launches=launches, peak_mem_gib=peak,
               resume_equal=resume_equal,
               resumed_losses=[r["loss"] for r in resumed if "mode" not in r],
               val_in_loop=val_rec[-1] if val_rec else None,
               val={k: v for k, v in metrics.items()
                    if k in ("mAP", "NDS", "car_AP", "pedestrian_AP")},
               **ev)
    log("learn", **rec)
    steps = [r for r in records if "mode" not in r]
    if any(not math.isfinite(r[k]) for r in steps for k in r
           if k.startswith("loss") or k == "grad_norm"):
        raise RuntimeError(f"non-finite loss in the learn phase: {steps}")
    if not resume_equal:
        raise RuntimeError(f"the resumed run logged other values: "
                           f"{resumed} against {records}")
    if dev == "cuda" and launches["nms_bev"] != ev["batches"]:
        raise RuntimeError(f"nms_bev launched {launches['nms_bev']} times in "
                           f"the loop's {ev['batches']} eval batches")
    return eval_in, random_in, rec


ISFUSION_CFG = os.path.join(REPO, "configs", "isfusion",
                            "isfusion_0075voxel.py")


def isfusion_learn_cfg(data_root: str):
    """The flagship config as written, its data paths (``data_root``,
    every ``ann_file``, the GT sampler's ``data_root`` and ``info_path``)
    at ``data_root``, a record every step, seed 0."""
    from isfusion_tpu_torch.config import Config
    cfg = Config.fromfile(ISFUSION_CFG)
    for d, ann in ((cfg.data.train.dataset, "train"), (cfg.data.val, "val"),
                   (cfg.data.test, "val")):
        d.update(data_root=data_root, ann_file=os.path.join(
            data_root, f"nuscenes_infos_{ann}.pkl"))
        for t in d.pipeline:
            if t["type"] == "ObjectSampleV2":
                t["db_sampler"].update(
                    data_root=data_root, info_path=os.path.join(
                        data_root, "nuscenes_dbinfos_train.pkl"))
    cfg.log_config = dict(interval=1)
    cfg.seed = 0
    return cfg


class LoopProbe:
    """Forward hooks on a detector in a train loop: at each forward's
    start the launch counts and the batch's fingerprint (points and GT
    rows per sample, the LiDAR augmentation's first entry), at its end
    the launch counts again; ``steps()`` gives each step's K12 forward /
    backward and K10 launches (a step's backward ends where the next
    forward starts, the last one at ``close()``)."""

    def __init__(self, model):
        from isfusion_tpu_torch.ops import cuda_build
        self.launches = cuda_build.LAUNCHES
        self.marks, self.prints = [], []
        self.hooks = [model.register_forward_pre_hook(self.start),
                      model.register_forward_hook(self.end)]

    def start(self, _, args):
        batch = self.last = args[0]
        self.marks.append(dict(self.launches))
        self.prints.append(dict(
            points=batch["points_mask"].sum(1).tolist(),
            gt=batch["gt_mask"].sum(1).tolist(),
            lidar_aug=batch["lidar_aug_matrix"][:, 0, 0].tolist()))

    def end(self, *_):
        self.marks.append(dict(self.launches))

    def close(self) -> list:
        for h in self.hooks:
            h.remove()
        marks = self.marks + [dict(self.launches)]
        return [dict(masked_gather_forward=mid["masked_gather"] -
                     pre["masked_gather"],
                     masked_gather_backward=post["masked_gather"] -
                     mid["masked_gather"],
                     boxes_iou_3d=post["boxes_iou_3d"] - pre["boxes_iou_3d"])
                for pre, mid, post in zip(marks[0::2], marks[1::2],
                                          marks[2::2])]


def phase_isfusion_learn(dev: str = "cuda", train: int = 4, val: int = 2,
                         points: int = 128_000, img_hw=(900, 1600),
                         nvidia_smi: str = None):
    """The flagship's train -> eval loop from its own config's data: a
    fixture of ``train`` / ``val`` samples under ``build/`` (the port's
    generator, seed 0, all 10 classes, ``points`` key-frame points and
    three sweeps of a quarter as many, six ``img_hw`` PNG views, the GT
    database); the config as written (CBGS, multi-sweep LiDAR, GT-paste
    with image patches, ModalMask3D, ImageAug3D, global rot / scale /
    flip, batch 4, 6 loader workers) for the first 2 of its 10 epochs by
    ``train_model`` at full width, checkpoint every epoch, launch counts
    zeroed just before and read just after; a fresh model resumed from
    ``epoch_1.pth`` trains epoch 2 again: its step count, the restored
    weights, optimizer and generator state and the epoch's batches (each
    step's fingerprint) must equal the first run's; its losses are
    reported beside the first run's, and two forwards of one batch from
    one generator state show whether the forward itself repeats, with
    default and with deterministic kernels (on the card it repeats only
    with the latter, and the losses drift apart); then the val split
    through the test pipeline (``MultiScaleFlipAug3D``) by
    ``single_device_test`` + ``evaluate``. Fails on a non-finite loss,
    grad norm or box, or a kernel not launched in every loop step."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from isfusion_tpu_torch.apis import init_model, single_device_test, \
        train_model
    from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.runner.checkpoint import load_checkpoint
    from isfusion_tpu_torch.runner.optim import build_optimizer
    from isfusion_tpu_torch.tools.make_synthetic_nuscenes import make_dataset

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="isfusion_learn_",
                            dir=os.path.join(REPO, "build"))
    try:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        make_dataset(data, train=train, val=val, points=points,
                     img_hw=img_hw, seed=0, images=True, gt_database=True)
        fixture_s = time.perf_counter() - t0
        cfg = isfusion_learn_cfg(data)
        work = os.path.join(root, "work")
        model = init_model(cfg, device=dev)
        dataset = build_dataset(cfg.data.train)
        host_ms = _pipeline_ms(dataset, samples=2)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        probe = LoopProbe(model)
        t0 = time.perf_counter()
        records = train_model(model, dataset, cfg, work, device=dev,
                              until_epoch=2)
        train_s = time.perf_counter() - t0
        per_step = probe.close()
        launches = dict(cuda_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if dev == "cuda" else None

        # resume: what epoch_1.pth restores, then epoch 2 again
        ckpt = torch.load(os.path.join(work, "epoch_1.pth"),
                          map_location=dev, weights_only=True)
        fresh = init_model(cfg, device=dev, seed=5).train()
        opt = build_optimizer(fresh, dict(cfg.optimizer))
        gen = torch.Generator(dev)
        meta = load_checkpoint(os.path.join(work, "epoch_1.pth"), fresh,
                               opt, gen)
        restored = dict(
            weights=all(torch.equal(v, ckpt["state_dict"][k])
                        for k, v in fresh.state_dict().items()),
            optimizer=_same_tree(opt.state_dict(), ckpt["optimizer"]),
            generator=torch.equal(gen.get_state(),
                                  ckpt["generator_states"][0].cpu()))
        del opt, ckpt
        # the same fresh model trains epoch 2 from the checkpoint
        model2 = fresh
        del fresh
        probe2 = LoopProbe(model2)
        resumed = train_model(model2, build_dataset(cfg.data.train), cfg,
                              os.path.join(root, "resumed"), device=dev,
                              resume_from=os.path.join(work, "epoch_1.pth"),
                              until_epoch=2)
        probe2.close()
        repeat = _forward_repeat(model2, probe2.last, dev)
        del model2
        if dev == "cuda":
            torch.cuda.empty_cache()

        val_set = build_dataset(cfg.data.val)
        loader = build_dataloader(
            val_set, samples_per_gpu=int(cfg.data.samples_per_gpu),
            workers_per_gpu=int(cfg.data.workers_per_gpu), shuffle=False)
        t0 = time.perf_counter()
        results = single_device_test(model, loader, dev)
        eval_s = time.perf_counter() - t0
        metrics = val_set.evaluate(results)
    finally:
        shutil.rmtree(root)

    steps = [r for r in records if "mode" not in r]
    again = [r for r in resumed if "mode" not in r]
    n_epoch = len(steps) // 2
    first = [s for s, r in zip(probe.prints, steps) if r["epoch"] == 1]
    losses = [(a["loss"], b["loss"]) for a, b in zip(steps[n_epoch:], again)]
    resume = dict(
        meta=meta, step_count=[r["step"] for r in again] ==
        [r["step"] for r in steps[n_epoch:]], **restored,
        batches=probe2.prints == first,
        losses=[[a, b] for a, b in losses],
        max_loss_rel_diff=max(abs(a - b) / max(abs(a), 1e-12)
                              for a, b in losses),
        forward_repeat_losses=repeat)
    step_ms = [(r["time"] - r["data_time"]) * 1e3 for r in steps]
    inside = [m for m, r in zip(step_ms, steps) if r["iter"] > 0]
    starts = [m for m, r in zip(step_ms, steps) if r["iter"] == 0]
    pts = [p for s in probe.prints for p in s["points"]]
    rec = dict(
        nvidia_smi=nvidia_smi,
        fixture=dict(train=train, val=val, key_points=points,
                     img_hw=list(img_hw), seconds=fixture_s),
        cbgs_len=len(dataset), steps_per_epoch=n_epoch,
        points_per_sample=dict(min=min(pts), median=statistics.median(pts),
                               max=max(pts)),
        gt_per_sample_max=max(g for s in probe.prints for g in s["gt"]),
        train_s=train_s, step_ms_inside_epoch=dict(
            median=statistics.median(inside), max=max(inside)),
        step_ms_epoch_start=starts,
        data_time_share=sum(r["data_time"] for r in steps) /
        sum(r["time"] for r in steps),
        epoch_start_data_s=[r["data_time"] for r in steps
                            if r["iter"] == 0],
        host_ms_per_sample=host_ms,
        launches_per_step=per_step[-1],
        launches_per_step_range={k: [min(s[k] for s in per_step),
                                     max(s[k] for s in per_step)]
                                 for k in per_step[0]},
        launches=launches,
        peak_mem_gib=peak, first_loss=steps[0]["loss"],
        last_loss=steps[-1]["loss"], resume=resume,
        eval=dict(samples=len(results), seconds=eval_s,
                  samples_per_s=len(results) / eval_s),
        metrics={k: v for k, v in metrics.items()
                 if k in ("mAP", "NDS", "car_AP", "pedestrian_AP")})
    log("isfusion_learn", **rec)
    bad = [(r["step"], k) for r in steps + again for k in r
           if (k.startswith("loss") or k == "grad_norm") and
           not math.isfinite(r[k])]
    bad += [i for i, r in enumerate(results)
            if not np.isfinite(r["bboxes"]).all()]
    bad += [k for k, v in metrics.items()
            if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"isfusion_learn: non-finite values {bad}")
    if not (resume["step_count"] and resume["weights"] and
            resume["optimizer"] and resume["generator"] and
            resume["batches"] and meta["epoch"] == 1):
        raise RuntimeError(f"isfusion_learn: the resume check failed: "
                           f"{resume}")
    if dev == "cuda" and min(min(s.values()) for s in per_step) == 0:
        raise RuntimeError(f"isfusion_learn: a kernel did not launch in "
                           f"every loop step: {per_step}")
    return rec


def _pipeline_ms(dataset, samples: int) -> dict:
    """Host ms of each train transform for the first ``samples`` samples
    of a ``CBGSDataset``, in this process (one core), summed per
    transform name, divided by ``samples``; 'total' is the whole
    sample."""
    inner = dataset.dataset
    spent = {}

    def timed(t):
        def run(data):
            t0 = time.perf_counter()
            out = t(data)
            name = type(t).__name__
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    real = inner.pipeline.transforms
    inner.pipeline.transforms = [timed(t) for t in real]
    try:
        t0 = time.perf_counter()
        for i in range(samples):
            dataset[i]
        total = time.perf_counter() - t0
    finally:
        inner.pipeline.transforms = real
    out = {k: v * 1e3 / samples for k, v in spent.items()}
    out["total"] = total * 1e3 / samples
    return out


def _forward_repeat(model, batch: dict, dev: str) -> dict:
    """The total loss of two train-mode forwards of one batch from one
    generator state, with PyTorch's default kernels and then with its
    deterministic ones (warn-only): is the forward itself reproducible
    on this device?"""
    import torch
    from isfusion_tpu_torch.parallel.train_step import total_loss
    out = {}
    try:
        for mode in ("default", "deterministic"):
            torch.use_deterministic_algorithms(mode == "deterministic",
                                               warn_only=True)
            out[mode] = []
            for _ in range(2):
                with torch.no_grad():
                    losses = model(batch, mode="loss",
                                   device=torch.device(dev),
                                   generator=torch.Generator(
                                       dev).manual_seed(0))
                out[mode].append(float(total_loss(losses)))
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def _same_tree(a, b) -> bool:
    """Nested dicts / lists of tensors and numbers, equal bit for bit."""
    import torch
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same_tree(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b.to(a.device))
    return a == b


# ------------------------------------------------------------- CenterPoint
CP_PREDICT_KERNELS = ("masked_gather", "nms_circle")
CP_MODULES = ("pts_voxel_encoder", "pts_middle_encoder", "pts_backbone",
              "pts_neck", "pts_bbox_head")
CP_TRAIN_WATCH = ("pts_middle_encoder", "pts_backbone", "pts_bbox_head")
# float32 operations per cell of a K11 window: 2 differences, 2 products,
# a sum, a negation, a division, the exponential (~4) and the max
GAUSSIAN_OPS_PER_CELL = 12


@contextlib.contextmanager
def recording_circle_nms():
    """Inside the block, every K10-circle call of CenterHead appends its
    inputs (centres (R, K, 2), scores, valid, thresholds (R,)) to the
    yielded list; the kernel still runs."""
    from isfusion_tpu_torch.models.dense_heads import centerpoint_head

    real, seen = centerpoint_head.circle_nms_mask, []

    def recording(centers, scores, thresh, valid):
        seen.append((centers.clone(), scores.clone(), valid.clone(),
                     thresh.clone()))
        return real(centers, scores, thresh, valid)

    centerpoint_head.circle_nms_mask = recording
    try:
        yield seen
    finally:
        centerpoint_head.circle_nms_mask = real


def phase_cp_main_path(model, batch: dict, dev: str = "cuda"):
    """CenterPoint serving: 1 warm-up + N_REQUESTS batch-1 requests (bf16
    convs; voxelization, VFE, decode and NMS float32), the points jittered
    per request. Launch counts are zeroed just before the timed requests
    and read after each; fails unless K12 (``masked_gather``) and
    K10-circle (``nms_circle``) launched in every request. Returns (launch
    counts, the warm-up's circle-NMS inputs, record)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build

    stats = {}
    with recording_circle_nms() as seen:
        model(jittered(batch, 0), device=dev, stats=stats)
        sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    for i in range(N_REQUESTS):
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: cuda_build.LAUNCHES[k] - before[k]
                            for k in CP_PREDICT_KERNELS})
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    if dev == "cuda":
        phase_breakdown(model, batch, CP_MODULES, (), "cp_")
    head = model.pts_bbox_head
    nt, post = len(head.task_heads), int(head.test_cfg["post_max_size"])
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != dict(bboxes=(1, nt * post, 9), scores=(1, nt * post),
                      labels=(1, nt * post), mask=(1, nt * post)):
        raise RuntimeError(f"unexpected CenterPoint output shapes {shapes}")
    m = out["mask"]
    if not (torch.isfinite(out["bboxes"][m]).all()
            and torch.isfinite(out["scores"][m]).all()):
        raise RuntimeError("non-finite CenterPoint boxes")
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, voxels=stats["voxels"], cap=stats["cap"],
               active_sites=stats["active_sites"],
               kept_per_task=m.reshape(nt, post).sum(-1).tolist(),
               launches_per_request=per_request, launches=launches)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("cp_main_path", **rec)
    if dev == "cuda" and any(min(r.values()) == 0 for r in per_request):
        raise RuntimeError(f"a CenterPoint request launched no "
                           f"{CP_PREDICT_KERNELS}: {per_request}")
    return launches, seen[0], rec


def record_cp_eval_sets(model, batch: dict, dev: str):
    """The circle-NMS inputs of one eval batch (B 4 x 6 tasks x 500)."""
    with recording_circle_nms() as seen:
        model(batch, device=dev)
        sync(dev)
    return seen[0]


def phase_cp_train(model, batch: dict, dev: str = "cuda",
                   steps: int = N_TRAIN_STEPS) -> dict:
    """1 warm-up + ``steps`` CenterPoint train steps at batch 4 with the
    config's AdamW, cyclic lr and momentum and clip 35, launches per step
    split at the end of each step's forward; fails on a non-finite or
    zero grad norm or loss, an unchanged weight of the SparseEncoder,
    SECOND or CenterHead, or a step that launched no K12 forward, K12
    backward or K11. Returns the record (with the warm-up's K11 inputs)."""
    import torch
    from isfusion_tpu_torch.flagship import centerpoint_optim_cfg
    from isfusion_tpu_torch.models.dense_heads import centerpoint_head
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = centerpoint_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(
        model, opt, build_schedule(opt, cfg["lr_config"],
                                   cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    heat_in, marks = [], []
    real_heat = centerpoint_head.draw_heatmap_gaussian_batch
    centerpoint_head.draw_heatmap_gaussian_batch = recording_heatmap(
        real_heat, heat_in)
    try:
        step(jittered(batch, 0), gen)
        sync(dev)
    finally:
        centerpoint_head.draw_heatmap_gaussian_batch = real_heat
    watch = {n: [p.detach().clone() for p in getattr(model, n).parameters()]
             for n in CP_TRAIN_WATCH}
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()

    def event():
        if dev != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    hook = model.register_forward_hook(
        lambda *_: marks.append((dict(cuda_build.LAUNCHES), event())))
    times, per_step = [], []
    try:
        for i in range(steps):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            ev0 = event()
            m = step(jittered(batch, i + 1), gen)
            ev1 = event()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            after, (mid, ev_fwd) = dict(cuda_build.LAUNCHES), marks[-1]
            split = {} if ev0 is None else dict(
                forward_stream_ms=ev0.elapsed_time(ev_fwd),
                backward_update_stream_ms=ev_fwd.elapsed_time(ev1))
            launches = dict(
                masked_gather_forward=mid["masked_gather"] -
                before["masked_gather"],
                masked_gather_backward=after["masked_gather"] -
                mid["masked_gather"],
                gaussian_heatmap=after["gaussian_heatmap"] -
                before["gaussian_heatmap"])
            vals = {k: float(v) for k, v in m.items()}
            log("cp_train_step", step=i, ms=times[-1], **split,
                launches=launches, loss=vals["loss"],
                grad_norm=vals["grad_norm"])
            per_step.append(launches)
            if any(not math.isfinite(v) for v in vals.values()) or \
                    vals["grad_norm"] == 0:
                raise RuntimeError(f"CenterPoint train step {i}: {vals}")
            if dev == "cuda" and min(launches.values()) == 0:
                raise RuntimeError(f"CenterPoint train step {i}: a kernel "
                                   f"did not launch: {launches}")
    finally:
        hook.remove()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    if dev == "cuda":
        device_profile("cp_train_profile",
                       lambda: step(jittered(batch, 0), gen), top=12)
    unchanged = _unchanged(model, watch)
    rec = dict(batch=batch["points"].shape[0],
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, launches_per_step=per_step,
               losses={k: float(v) for k, v in m.items()},
               unchanged_weights=unchanged)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("cp_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} CenterPoint train "
                           f"steps: {unchanged[:10]}")
    rec["heatmap_inputs"] = heat_in[0]
    return rec


def circle_bound_ms(centers) -> tuple:
    """K10-circle's least time on these (R, K, 2) centres and what bounds
    it: the larger of its operations (one squared distance a pair, K
    log2 K comparisons a set for the score order) over the float32 rate
    and its bytes (centres, scores, valid, keep, thresholds) over the
    memory rate."""
    from isfusion_tpu_torch.ops import box_ops
    r, k = centers.shape[:2]
    t_ops = (box_ops.circle_nms_ops(r, k) + box_ops.circle_order_ops(r, k)
             ) / F32_OPS_PER_S
    t_bytes = (r * k * (8 + 4 + 1 + 1) + 4 * r) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def circle_walk_rounds(centers, scores, valid, thresh) -> list:
    """Per set, the rounds K10-circle's walk takes to resolve its chunks
    (``csrc/nms_circle.cu`` step (c): each chunk of 64 score positions
    iterated from "all alive kept" to its fixed point, two ballots a
    round), from the plain suppression bits in ``torch.sort``'s order:
    the walk's serial length, which the slowest set sets for the
    launch."""
    import numpy as np
    import torch
    out = []
    for c, s, v, t in zip(centers.float().cpu(), scores.float().cpu(),
                          valid.cpu(), thresh.float().cpu()):
        order = torch.sort(s, descending=True, stable=True).indices
        c, removed = c[order], ~v[order].numpy()
        d = c[None, :, :] - c[:, None, :]
        near = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] <= t).numpy()
        k, rounds = len(removed), 0
        for base in range(0, k, 64):
            end = min(base + 64, k)
            alive = ~removed[base:end]
            if not alive.any():
                continue
            # sub[p, q]: p suppresses q, p before q in the chunk
            sub = np.triu(near[base:end, base:end], 1)
            kept = alive
            while True:
                rounds += 1
                nxt = alive & ~(sub & kept[:, None]).any(0)
                if (nxt == kept).all():
                    break
                kept = nxt
            removed[end:] |= near[base:end, end:][kept].any(0)
        out.append(rounds)
    return out


def gaussian_bound_ms(shape_hw, radii, valid, num_classes: int) -> tuple:
    """K11's least time on these inputs and what bounds it: the larger of
    its bytes (the heatmap written once, the objects read once) over the
    memory rate and its operations (each valid object's window cells
    inside the grid, ``GAUSSIAN_OPS_PER_CELL`` each) over the float32
    rate."""
    from isfusion_tpu_torch.ops import gaussian
    h, w = shape_hw
    lead = tuple(radii.shape[:-1])
    side = 2 * radii.floor() + 1
    cells = int((side.clamp_max(w) * side.clamp_max(h))[valid].sum())
    t_bytes = gaussian.gaussian_heatmap_bytes(lead + (h, w, num_classes),
                                              radii.numel()) / HBM_BYTES_PER_S
    t_ops = cells * GAUSSIAN_OPS_PER_CELL / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_cp_kernel_check(nms_in, eval_in, heat_sets, dev: str = "cuda",
                          launches=None):
    """K10-circle against its plain version on the request's own (6 x 500)
    sets, an eval batch's (B 4 x 6 x 500) and the adversarial sets
    (``testing.circle_nms_adversarial_sets``): keep masks equal. K11
    against its plain version on ``heat_sets`` ((name, inputs): a
    CenterPoint train step's, B 4 x G 64, 180 x 180, 10 classes, and the
    flagship's): heatmaps equal, cells at 1.0 equal. For each kernel at
    the main path's shape: ms (CUDA events), device ms (profiler), the
    plain version's ms, the bound and what bounds it, beside ``launches``
    (the main paths' counts). Returns the records for the JSON line."""
    import torch
    from isfusion_tpu_torch.ops import box_ops, gaussian
    from isfusion_tpu_torch.testing import circle_nms_adversarial_sets

    def circle(c, s, v, t):
        return box_ops.circle_nms_mask(c, s, t, v)

    def circle_ref(c, s, v, t):
        return box_ops.circle_nms_mask_ref(c, s, t, v)

    # the request's sets with each set's boxes shuffled: the score order by
    # counting, where the decode's top-k order takes the index order
    gen = torch.Generator().manual_seed(13)
    perm = torch.stack([torch.randperm(nms_in[0].shape[1], generator=gen)
                        for _ in range(nms_in[0].shape[0])]).to(dev)
    shuffled = (torch.gather(nms_in[0], 1, perm[..., None].expand(
        -1, -1, 2)), torch.gather(nms_in[1], 1, perm),
        torch.gather(nms_in[2], 1, perm), nms_in[3])
    cases = [("request",) + tuple(nms_in), ("eval",) + tuple(eval_in),
             ("request_shuffled",) + shuffled]
    cases += [(n,) + tuple(a.to(dev) for a in args) for n, *args in
              circle_nms_adversarial_sets(torch.Generator().manual_seed(12))]
    recs = {}
    for name, *args in cases:
        got, ref = circle(*args), circle_ref(*args)
        sync(dev)
        r = dict(R=args[0].shape[0], K=args[0].shape[1],
                 kept=int(ref.sum()), keep_equal=torch.equal(got, ref),
                 keep_flags_differ=int((got != ref).sum()))
        if name in ("request", "eval", "request_shuffled"):
            bound, by = circle_bound_ms(args[0])
            r.update(ms=cuda_ms(lambda: circle(*args), dev, iters=50),
                     plain_ms=cuda_ms(lambda: circle_ref(*args), dev,
                                      iters=2),
                     bound_ms=bound, bound_by=by,
                     thresholds=args[3].tolist()[:6],
                     walk_rounds=circle_walk_rounds(*args)[:6])
            if dev == "cuda":
                # the whole call: every device operation the wrapper issues
                ops = device_kernels(lambda: circle(*args), iters=50)
                r.update(device_ms=sum(n * ms for n, ms in ops.values()),
                         kernel_device_ms=kernel_ms(ops,
                                                    "nms_circle_kernel"),
                         device_ops_per_call={k[:60]: n for k, (n, _) in
                                              ops.items()})
            recs[name] = r
        log("cp_nms_case", case=name, **r)
        if not r["keep_equal"]:
            raise RuntimeError(f"nms_circle differs from its plain version "
                               f"on {name}: {r}")
    for name, (hw, *args, nc) in heat_sets:
        got = gaussian.draw_heatmap_gaussian_batch(hw, *args, nc)
        ref = gaussian.draw_heatmap_gaussian_batch_ref(hw, *args, nc)
        sync(dev)
        bound, by = gaussian_bound_ms(hw, args[1], args[2], nc)
        r = dict(shape=list(got.shape), objects=int(args[2].sum()),
                 equal=torch.equal(got, ref),
                 max_abs_err=float((got - ref).abs().max()),
                 positives=int((got == 1.0).sum()),
                 plain_positives=int((ref == 1.0).sum()),
                 ms=cuda_ms(lambda: gaussian.draw_heatmap_gaussian_batch(
                     hw, *args, nc), dev, iters=50),
                 plain_ms=cuda_ms(
                     lambda: gaussian.draw_heatmap_gaussian_batch_ref(
                         hw, *args, nc), dev, iters=5),
                 bound_ms=bound, bound_by=by)
        if dev == "cuda":
            r["device_ms"] = kernel_device_ms(
                lambda: gaussian.draw_heatmap_gaussian_batch(hw, *args, nc),
                "gaussian_heatmap_kernel", iters=20)
        recs[name] = r
        log("cp_heatmap_case", case=name, **r)
        if not r["equal"] or r["positives"] != r["plain_positives"]:
            raise RuntimeError(f"gaussian_heatmap differs from its plain "
                               f"version on {name}: {r}")
    recs["launch_floor"] = launch_floor(dev)
    log("cp_kernel_check", launches=launches, nms_circle=recs["request"],
        nms_circle_eval=recs["eval"],
        nms_circle_shuffled=recs["request_shuffled"],
        launch_floor=recs["launch_floor"],
        gaussian_heatmap={k: v for k, v in recs.items()
                          if k not in ("request", "eval", "request_shuffled",
                                       "launch_floor")})
    return recs


def phase_cp_reference(dev: str = "cuda"):
    """Tiny CenterPoint, float32 (TF32 off): predict and one train step on
    the card (its kernels) against the CPU (the plain versions) from the
    same weights and batch. The same boxes kept with the same labels
    (``testing.cp_kept_boxes``), boxes and scores within 1e-4 of their
    max; losses within 1e-4 relative, each top-level module's gradient
    within 1e-3 of its max."""
    import torch
    from isfusion_tpu_torch.flagship import build_centerpoint
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer
    from isfusion_tpu_torch.testing import cp_kept_boxes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modules = CP_MODULES[1:]          # HardSimpleVFE has no parameters

    def run(d):
        model, batch_fn = build_centerpoint(tiny=True, device=d, seed=1)
        batch = batch_fn(2, seed=3)
        before = dict(cuda_build.LAUNCHES)
        out = cp_kept_boxes(model, batch, d)
        model.train()
        opt = build_optimizer(model, dict(type="AdamW", lr=1e-4))
        m = make_train_step(model, opt)(batch,
                                        torch.Generator(d).manual_seed(0))
        grads = {top: [p.grad.detach().cpu().flatten()
                       for p in getattr(model, top).parameters()]
                 for top in modules}
        launched = {k: cuda_build.LAUNCHES[k] - before[k]
                    for k in ("masked_gather", "nms_circle",
                              "gaussian_heatmap")}
        return out, {k: float(v) for k, v in m.items()}, grads, launched

    (og, mg, gg, lg), (oc, mc, gc, _) = run(dev), run("cpu")
    if not torch.equal(og[2], oc[2]):
        raise RuntimeError("tiny CenterPoint on the card kept other boxes "
                           "than on the CPU")

    def rel_to_max(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    box_err = max(rel_to_max(og[i], oc[i]) for i in (0, 1))
    loss_err = max(abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mc.items())
    grad_err = {top: rel_to_max(torch.cat(gg[top]), torch.cat(gc[top]))
                for top in modules}
    log("cp_reference", kept=len(oc[2]), box_rel_err=box_err,
        loss_rel_err=loss_err, grad_rel_err=grad_err, card_launches=lg,
        losses=mc)
    if box_err > 1e-4 or loss_err > 1e-4 or max(grad_err.values()) > 1e-3:
        raise RuntimeError(f"tiny CenterPoint on the card differs from the "
                           f"CPU: boxes {box_err:.3g}, losses "
                           f"{loss_err:.3g}, grads {grad_err}")
    if dev == "cuda" and min(lg.values()) == 0:
        raise RuntimeError(f"tiny CenterPoint on the card launched no "
                           f"kernel of {lg}")


# ------------------------------------------------ K1 / K2 (both detectors)
@contextlib.contextmanager
def recording_dynamic():
    """Inside the block, the first call of ``voxelize_dynamic`` (as the
    IS-Fusion and MVX detectors call it), of ``segment_mean`` and of
    ``segment_max`` at each width (as DynamicVFE calls them, with the
    point lists the path's own K1 built, or None) keep their inputs in the
    yielded dict ("voxelize", "mean", "max64", ...), and "calls" counts
    each key's calls; the kernels still run."""
    from isfusion_tpu_torch.models import voxel_encoders
    from isfusion_tpu_torch.models.detectors import isfusion, mvx_two_stage

    seen, calls = {}, collections.Counter()
    real_vox = isfusion.voxelize_dynamic
    real_max = voxel_encoders.segment_max
    real_mean = voxel_encoders.segment_mean

    def vox(points, mask, pcr, vs):
        calls["voxelize"] += 1
        seen.setdefault("voxelize", (points.detach().clone(), mask.clone(),
                                     tuple(pcr), tuple(vs)))
        return real_vox(points, mask, pcr, vs)

    def record(key, data, ids, n, args):
        layout = args[0] if args else None
        calls[key] += 1
        seen.setdefault(key, (data.detach().clone(), ids.clone(), int(n),
                              None if layout is None else
                              tuple(t.clone() for t in layout)))

    def smax(data, ids, n, *args):
        record(f"max{data.shape[1]}", data, ids, n, args)
        return real_max(data, ids, n, *args)

    def smean(data, ids, n, *args):
        record("mean", data, ids, n, args)
        return real_mean(data, ids, n, *args)

    isfusion.voxelize_dynamic = mvx_two_stage.voxelize_dynamic = vox
    voxel_encoders.segment_max, voxel_encoders.segment_mean = smax, smean
    try:
        yield seen
    finally:
        seen["calls"] = dict(calls)
        isfusion.voxelize_dynamic = mvx_two_stage.voxelize_dynamic = real_vox
        voxel_encoders.segment_max = real_max
        voxel_encoders.segment_mean = real_mean


def check_no_layout_builds(label: str, launches: dict):
    """On the DynamicVFE paths every K2 call takes the point lists of the
    path's own K1: none is built inside ``segment_max`` /
    ``segment_mean``."""
    if launches.get("segment_layout", 0):
        raise RuntimeError(f"{label}: K2 built {launches['segment_layout']} "
                           f"point lists itself (DynamicVFE passed none)")


def device_ms_per_call(fn, iters: int = 20):
    """Device ms of every device operation of one ``fn()`` call (the
    profiler's), or "not measured" off the card."""
    import torch
    if not torch.cuda.is_available():
        return "not measured"
    ops = device_kernels(fn, iters)
    return sum(n * ms for n, ms in ops.values())


def voxelize_bytes(points, n_valid: int, nv: int) -> int:
    """Least bytes of K1: xyz (12) and the mask (1) read once per point,
    the point's row (8) written once, each voxel's (b, z, y, x) (16) and
    offset (4) and each valid point's list entry (4) written once."""
    p = points.shape[0] * points.shape[1]
    return p * (12 + 1 + 8) + n_valid * 4 + (nv + 1) * 20


def voxelize_design_bytes(points, n_valid: int, nv: int, grid) -> int:
    """Bytes the K1 design moves beyond that, estimated: the L1 words
    (one bit an L0 word) scanned, their prefixes written and read (12 a
    word), each occupied L0 word's slot (<= a voxel; 16), each point's key
    read again (8), each valid point's compacted index, list entry, count
    and cursor as 4-byte words written and read (24)."""
    b, p = points.shape[:2]
    l0_words = -(-(b * grid[0] * grid[1] * grid[2]) // 32)
    l1_words = -(-l0_words // 32)
    return voxelize_bytes(points, n_valid, nv) + l1_words * 12 + nv * 16 + \
        b * p * 8 + n_valid * 24


def scatter_bytes(p: int, c: int, s: int) -> int:
    """Least bytes of a K2 forward: the (P, C) rows (4 each) and the ids
    (8) read once, the (S, C) segments written once."""
    return p * c * 4 + p * 8 + s * c * 4


def dynamic_check(label: str, seen: dict, dev: str = "cuda",
                  sets=()) -> dict:
    """K1 and K2 against their plain versions on ``seen``
    (``recording_dynamic``: the main path's own inputs, K2's with the
    point lists the path's K1 built) and on ``sets`` ((name, points,
    mask, pcr, voxel size) for K1 alone). K1: rows, table, ``voxel_ptr``
    and ``point_order`` equal. K2 max: forward and backward (a seeded
    gradient) equal; K2 mean: equal to the plain version on the CPU (the
    same sum order), within 1e-6 of the output's max of the plain version
    on the card, equal to itself on a second call. Each case logs a
    ``[dynamic_check]`` line with the kernel's ms (CUDA events), device ms
    (profiler, every device operation of one call), the plain version's
    ms, the library call's ms (``torch.unique(sorted, return_inverse,
    return_counts)`` of the linear ids for K1, with ``sort_ms`` of
    ``torch.sort(stable)`` of the voxel ids beside it; ``scatter_reduce_``
    for K2) and the byte bound; K1 the list's largest and mean points a
    voxel, the max its backward's device ms (``bwd_device_ms``) and
    bound. Returns the records by case."""
    import torch
    from isfusion_tpu_torch.ops import scatter, voxel

    recs = {}
    cases = []
    if "voxelize" in seen:
        cases.append(("voxelize",) + tuple(seen["voxelize"]))
    cases += [(n,) + tuple(args) for n, *args in sets]
    for name, pts, mask, pcr, vs in cases:
        pts, mask = pts.to(dev), mask.to(dev)
        got = voxel.voxelize_dynamic(pts, mask, pcr, vs)
        ref = voxel.voxelize_dynamic_ref(pts, mask, pcr, vs)
        sync(dev)
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        nv = int(ref.voxel_coors.shape[0])
        n_valid = int(ref.point_order.shape[0])
        per_voxel = (ref.voxel_ptr[1:] - ref.voxel_ptr[:-1]).float()
        coors, in_range, grid = voxel.compute_voxel_coords(pts, pcr, vs)
        keys = voxel._keys(coors, grid).reshape(-1)[
            (mask.bool() & in_range).reshape(-1)]
        vid = ref.point_voxel_index[ref.point_voxel_index >= 0]
        nbytes = voxelize_bytes(pts, n_valid, nv)
        r = dict(kernel="dynamic_voxelize", points=int(pts.shape[0] *
                                                       pts.shape[1]),
                 voxels=nv, valid_points=n_valid, equal=equal,
                 layout_equal=torch.equal(got.voxel_ptr, ref.voxel_ptr) and
                 torch.equal(got.point_order, ref.point_order),
                 max_points_per_voxel=int(per_voxel.max()) if nv else 0,
                 mean_points_per_voxel=float(per_voxel.mean()) if nv else 0,
                 bytes=nbytes, design_bytes=voxelize_design_bytes(
                     pts, n_valid, nv, (grid[2], grid[1], grid[0])),
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 max_abs_err=0.0 if equal else float("inf"))
        if name == "voxelize":
            parts = kernel_breakdown(lambda: voxel.voxelize_dynamic(
                pts, mask, pcr, vs)) if dev == "cuda" else {}
            r.update(ms=cuda_ms(lambda: voxel.voxelize_dynamic(
                         pts, mask, pcr, vs), dev),
                     device_ms=sum(parts.values()) if parts else
                     "not measured", device_kernels=parts,
                     plain_ms=cuda_ms(lambda: voxel.voxelize_dynamic_ref(
                         pts, mask, pcr, vs), dev, iters=5),
                     library_ms=cuda_ms(lambda: torch.unique(
                         keys, sorted=True, return_inverse=True,
                         return_counts=True), dev, iters=5),
                     sort_ms=cuda_ms(lambda: torch.sort(vid, stable=True),
                                     dev, iters=5))
        recs[name] = r
        log("dynamic_check", on=label, case=name, **r)
        if not equal:
            raise RuntimeError(f"dynamic_voxelize differs from its plain "
                               f"version on {label} {name}")
    gen = torch.Generator().manual_seed(21)
    for name in sorted(k for k in seen if k.startswith("max")):
        data, ids, n, layout = seen[name]
        p, c = data.shape
        g = torch.randn((n, c), generator=gen).to(dev)
        res = []
        for fn, args in ((scatter.segment_max, (layout,)),
                         (scatter.segment_max_ref, ())):
            x = data.clone().requires_grad_(True)
            out = fn(x, ids, n, *args)
            out.backward(g)
            res.append((out.detach(), x.grad))
        sync(dev)
        (ko, kg), (po, pg) = res
        equal = torch.equal(ko, po) and torch.equal(kg, pg)
        idx = ids.view(-1, 1).expand(p, c)

        def bwd():
            x = data.clone().requires_grad_(True)
            scatter.segment_max(x, ids, n, layout).backward(g)

        nbytes = scatter_bytes(p, c, n)
        bwd_bytes = p * c * 4 * 2 + p * 8 + n * c * 4 * 2
        r = dict(kernel="dynamic_scatter", op="max", P=p, C=c, S=n,
                 equal=equal, max_abs_err=max(float((ko - po).abs().max()),
                                              float((kg - pg).abs().max())),
                 bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                 bound_by="bytes",
                 ms=cuda_ms(lambda: scatter.segment_max(data, ids, n, layout),
                            dev),
                 device_ms=device_ms_per_call(
                     lambda: scatter.segment_max(data, ids, n, layout)),
                 plain_ms=cuda_ms(lambda: scatter.segment_max_ref(
                     data, ids, n), dev),
                 library_ms=cuda_ms(lambda: torch.zeros(
                     (n, c), device=dev).scatter_reduce_(
                         0, idx, data, "amax", include_self=False), dev),
                 fwd_bwd_ms=cuda_ms(bwd, dev, iters=10),
                 bwd_device_ms=kernel_device_ms(bwd, "max_grad_kernel", 20)
                 if dev == "cuda" else "not measured",
                 backward_bound_ms=bwd_bytes / HBM_BYTES_PER_S * 1e3)
        recs[name] = r
        log("dynamic_check", on=label, case=name, **r)
        if not equal:
            raise RuntimeError(f"segment_max differs from its plain version "
                               f"on {label} {name}")
    if "mean" in seen:
        data, ids, n, layout = seen["mean"]
        p, c = data.shape
        got = scatter.segment_mean(data, ids, n, layout)
        again = scatter.segment_mean(data, ids, n, layout)
        plain = scatter.segment_mean_ref(data, ids, n)
        cpu = scatter.segment_mean_ref(data.cpu(), ids.cpu(), n)
        sync(dev)
        scale = float(plain.abs().max().clamp_min(1e-30))
        err = float((got - plain).abs().max())
        nbytes = scatter_bytes(p, c, n)
        r = dict(kernel="dynamic_scatter", op="mean", P=p, C=c, S=n,
                 equal_to_cpu=torch.equal(got.cpu(), cpu),
                 repeats=torch.equal(got, again),
                 plain_on_card_repeats=torch.equal(
                     plain, scatter.segment_mean_ref(data, ids, n)),
                 max_abs_err=err, err_of_max=err / scale, bytes=nbytes,
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 ms=cuda_ms(lambda: scatter.segment_mean(data, ids, n,
                                                         layout), dev),
                 device_ms=device_ms_per_call(
                     lambda: scatter.segment_mean(data, ids, n, layout)),
                 plain_ms=cuda_ms(lambda: scatter.segment_mean_ref(
                     data, ids, n), dev),
                 library_ms=cuda_ms(lambda: torch.zeros(
                     (n, c), device=dev).scatter_reduce_(
                         0, ids.view(-1, 1).expand(p, c), data, "mean",
                         include_self=False), dev))
        recs["mean"] = r
        log("dynamic_check", on=label, case="mean", **r)
        if not (r["equal_to_cpu"] and r["repeats"]) or r["err_of_max"] > 1e-6:
            raise RuntimeError(f"segment_mean off its plain versions on "
                               f"{label}: {r}")
    return recs


# ------------------------------------------------------------------ MVX-Net
MVX_PREDICT_KERNELS = ("dynamic_voxelize", "dynamic_scatter", "masked_gather",
                       "nms_bev")
MVX_MODULES = ("img_backbone", "img_neck", "pts_voxel_encoder",
               "pts_middle_encoder", "pts_backbone", "pts_neck",
               "pts_bbox_head")
# parameters a train step must move: the VFE's layers, PointFusion, the
# sparse encoder, FPN, ResNet's last stage, the head
MVX_TRAIN_WATCH = ("pts_voxel_encoder.vfe_layers.",
                   "pts_voxel_encoder.fusion_layer.", "pts_middle_encoder.",
                   "img_neck.", "img_backbone.layer4.", "pts_bbox_head.")


def phase_mvx_main_path(model, batch: dict, dev: str = "cuda"):
    """MVX-Net serving: 1 warm-up + N_REQUESTS batch-1 requests (bf16
    convs; voxelization, the VFE, PointFusion's sampling and transforms,
    decode and NMS float32), the points jittered per request. Launch
    counts are zeroed just before the timed requests and read after each;
    fails unless K1, K2, K12 and K10-NMS launched in every request.
    Returns (launch counts, the warm-up's K1 / K2 inputs, record)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build

    stats = {}
    with recording_dynamic() as seen:
        model(jittered(batch, 0), device=dev, stats=stats)
        sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    for i in range(N_REQUESTS):
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: cuda_build.LAUNCHES[k] - before[k]
                            for k in MVX_PREDICT_KERNELS})
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    idle = phase_breakdown(model, batch, MVX_MODULES, (), "mvx_")[
        "device_idle_share"] if dev == "cuda" else "not measured"
    n = int(model.pts_bbox_head.test_cfg.get("max_num", 500))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != dict(bboxes=(1, n, 7), scores=(1, n), labels=(1, n),
                      mask=(1, n)):
        raise RuntimeError(f"unexpected MVX-Net output shapes {shapes}")
    m = out["mask"]
    if not (torch.isfinite(out["bboxes"][m]).all()
            and torch.isfinite(out["scores"][m]).all()):
        raise RuntimeError("non-finite MVX-Net boxes")
    cap_train, cap_test = model.pts_voxel_layer["max_voxels"]
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, points=int(batch["points"].shape[1]),
               voxels=stats["voxels"], jax_cap=[cap_train, cap_test],
               over_jax_cap=max(stats["voxels"]) > cap_test,
               active_sites=stats["active_sites"], kept_boxes=int(m.sum()),
               kept_per_class=torch.bincount(
                   out["labels"][m], minlength=3).tolist(),
               device_idle_share=idle,
               launches_per_request=per_request, launches=launches)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("mvx_main_path", **rec)
    if dev == "cuda" and any(min(r.values()) == 0 for r in per_request):
        raise RuntimeError(f"an MVX-Net request launched no "
                           f"{MVX_PREDICT_KERNELS}: {per_request}")
    return launches, seen, rec


def _watched(model, prefixes) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith(prefixes) and p.requires_grad}


def phase_mvx_train(model, batch: dict, dev: str = "cuda",
                    steps: int = N_TRAIN_STEPS) -> dict:
    """1 warm-up + ``steps`` MVX-Net train steps at batch 2 with the
    config's AdamW, CosineAnnealing with linear warmup and clip 35;
    launches per step split at the end of each step's forward. Fails on a
    non-finite loss or a zero grad norm, a step without K1, K2 forward, K2
    backward, K12 forward or K12 backward, an unchanged weight of the
    VFE, PointFusion, the sparse encoder, FPN, ResNet's layer4 or the
    head, or a changed frozen ResNet parameter or BN statistic (the stem,
    layer1, every BatchNorm). Returns the record (with the warm-up's K1 /
    K2 inputs)."""
    import torch
    from isfusion_tpu_torch.flagship import mvxnet_optim_cfg
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = mvxnet_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(
        model, opt, build_schedule(opt, cfg["lr_config"], None),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    frozen = {n: t.detach().clone() for n, t in
              model.img_backbone.state_dict().items()
              if n.split(".")[0] in ("conv1", "bn1", "layer1") or
              ".bn" in n or ".downsample.1." in n}
    with recording_dynamic() as seen:
        step(jittered(batch, 0), gen)
        sync(dev)
    watch = _watched(model, MVX_TRAIN_WATCH)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()

    def event():
        if dev != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    marks = []
    hook = model.register_forward_hook(
        lambda *_: marks.append((dict(cuda_build.LAUNCHES), event())))
    times, per_step = [], []
    try:
        for i in range(steps):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            ev0 = event()
            m = step(jittered(batch, i + 1), gen)
            ev1 = event()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            after, (mid, ev_fwd) = dict(cuda_build.LAUNCHES), marks[-1]
            split = {} if ev0 is None else dict(
                forward_stream_ms=ev0.elapsed_time(ev_fwd),
                backward_update_stream_ms=ev_fwd.elapsed_time(ev1))
            launches = dict(
                dynamic_voxelize=mid["dynamic_voxelize"] -
                before["dynamic_voxelize"],
                dynamic_scatter_forward=mid["dynamic_scatter"] -
                before["dynamic_scatter"],
                dynamic_scatter_backward=after["dynamic_scatter"] -
                mid["dynamic_scatter"],
                masked_gather_forward=mid["masked_gather"] -
                before["masked_gather"],
                masked_gather_backward=after["masked_gather"] -
                mid["masked_gather"])
            vals = {k: float(v) for k, v in m.items()}
            log("mvx_train_step", step=i, ms=times[-1], **split,
                launches=launches, **vals)
            per_step.append(launches)
            if any(not math.isfinite(v) for v in vals.values()) or \
                    vals["grad_norm"] == 0:
                raise RuntimeError(f"MVX-Net train step {i}: {vals}")
            if dev == "cuda" and min(launches.values()) == 0:
                raise RuntimeError(f"MVX-Net train step {i}: a kernel did "
                                   f"not launch: {launches}")
    finally:
        hook.remove()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    if dev == "cuda":
        device_profile("mvx_train_profile",
                       lambda: step(jittered(batch, 0), gen), top=12)
    params = dict(model.named_parameters())
    unchanged = [n for n, t in watch.items() if torch.equal(params[n], t)]
    now = model.img_backbone.state_dict()
    moved = [n for n, t in frozen.items() if not torch.equal(now[n], t)]
    rec = dict(batch=batch["points"].shape[0],
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, launches_per_step=per_step,
               losses={k: float(v) for k, v in m.items()},
               watched=len(watch), unchanged_weights=unchanged,
               frozen_checked=len(frozen), frozen_moved=moved)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("mvx_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} MVX-Net train "
                           f"steps: {unchanged[:10]}")
    if moved:
        raise RuntimeError(f"frozen ResNet tensors changed: {moved[:10]}")
    rec["dynamic_inputs"] = seen
    return rec


def phase_mvx_kernel_check(seen: dict, dev: str = "cuda") -> dict:
    """K1 and K2 against their plain versions on the MVX request's own
    inputs (``phase_mvx_main_path``) and K1 on ``testing.
    voxel_adversarial_sets`` at MVX-Net's grid (points on voxel faces,
    duplicates, out-of-range and masked points, empty samples)."""
    import numpy as np
    import torch
    from isfusion_tpu_torch.flagship import mvxnet_model_cfg
    from isfusion_tpu_torch.testing import voxel_adversarial_sets

    vl = mvxnet_model_cfg()["pts_voxel_layer"]
    pcr, vs = tuple(vl["point_cloud_range"]), tuple(vl["voxel_size"])
    sets = [(name, torch.from_numpy(p), torch.from_numpy(m), pcr, vs)
            for name, p, m in voxel_adversarial_sets(
                np.random.default_rng(5), pcr, vs, p=60000)]
    recs = dynamic_check("mvx_request", seen, dev, sets)
    log("mvx_kernel_check", **{k: {f: v[f] for f in (
        "ms", "device_ms", "bound_ms", "plain_ms", "library_ms") if f in v}
        for k, v in recs.items()})
    return recs


def phase_mvx_reference(dev: str = "cuda"):
    """Tiny MVX-Net, float32 (TF32 off): predict and one train step on
    the card (its kernels) against the CPU (the plain versions) from the
    same weights and batch, the box deltas tamed and the class prior
    evened (``testing``) so that NMS sees full sets. The same boxes kept
    with the same labels (``testing.pp_kept_boxes``), boxes and scores
    within 1e-4 of their max; losses within 1e-4 relative, each top-level
    module's gradient within 1e-3 of its max."""
    import torch
    from isfusion_tpu_torch.flagship import build_mvxnet
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer
    from isfusion_tpu_torch.testing import (even_class_prior, pp_kept_boxes,
                                            tame_box_deltas)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(d):
        model, batch_fn = build_mvxnet(tiny=True, device=d, seed=1)
        even_class_prior(tame_box_deltas(model))
        batch = batch_fn(2, seed=3)
        before = dict(cuda_build.LAUNCHES)
        out = pp_kept_boxes(model, batch, d)
        model.train()
        opt = build_optimizer(model, dict(type="AdamW", lr=1e-4))
        m = make_train_step(model, opt)(batch,
                                        torch.Generator(d).manual_seed(0))
        grads = {top: [p.grad.detach().cpu().flatten()
                       for p in getattr(model, top).parameters()
                       if p.grad is not None]
                 for top in MVX_MODULES}
        launched = {k: cuda_build.LAUNCHES[k] - before[k]
                    for k in MVX_PREDICT_KERNELS}
        return out, {k: float(v) for k, v in m.items()}, grads, launched

    (og, mg, gg, lg), (oc, mc, gc, _) = run(dev), run("cpu")
    if not torch.equal(og[2], oc[2]):
        raise RuntimeError("tiny MVX-Net on the card kept other boxes than "
                           "on the CPU")

    def rel_to_max(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    box_err = max(rel_to_max(og[i], oc[i]) for i in (0, 1))
    loss_err = max(abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mc.items())
    grad_err = {top: rel_to_max(torch.cat(gg[top]), torch.cat(gc[top]))
                for top in MVX_MODULES}
    log("mvx_reference", kept=len(oc[2]), box_rel_err=box_err,
        loss_rel_err=loss_err, grad_rel_err=grad_err, card_launches=lg,
        losses=mc)
    if len(oc[2]) == 0 or box_err > 1e-4 or loss_err > 1e-4 or \
            max(grad_err.values()) > 1e-3:
        raise RuntimeError(f"tiny MVX-Net on the card differs from the CPU: "
                           f"boxes {box_err:.3g}, losses {loss_err:.3g}, "
                           f"grads {grad_err}")
    if dev == "cuda" and min(lg.values()) == 0:
        raise RuntimeError(f"tiny MVX-Net on the card launched no kernel of "
                           f"{lg}")


# ------------------------------------------------------------------ FCOS3D
FCOS_MODULES = ("backbone", "neck", "bbox_head")
FCOS_LOSSES = ("loss_cls", "loss_bbox", "loss_centerness", "loss_dir",
               "loss_attr")


def _rel_to_max(a, b) -> float:
    return float((a.float() - b.float()).abs().max() /
                 b.float().abs().max().clamp_min(1e-30))


def fcos_stream_ms(model, batch: dict) -> dict:
    """One FCOS3D request with CUDA events around the backbone, the neck,
    the head's forward and its decode (stream ms; the rest is the upload
    and host gaps)."""
    import torch

    spans = {}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def pre(name):
        return lambda *_: spans.__setitem__(name, [event(), None])

    def post(name):
        return lambda *_: spans[name].__setitem__(1, event())

    handles = []
    for n in FCOS_MODULES:
        mod = getattr(model, n)
        handles += [mod.register_forward_pre_hook(pre(n)),
                    mod.register_forward_hook(post(n))]
    head = model.bbox_head
    real = head.get_bboxes

    def decode(*args, **kw):
        spans["decode"] = [event(), None]
        out = real(*args, **kw)
        spans["decode"][1] = event()
        return out

    head.get_bboxes = decode
    try:
        t0 = time.perf_counter()
        model(batch, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        del head.get_bboxes
        for h in handles:
            h.remove()
    ms = {n: a.elapsed_time(b) for n, (a, b) in spans.items()}
    return dict(request_ms=wall, stream_ms=ms,
                rest_ms=wall - sum(ms.values()))


def phase_fcos_main_path(model, batch: dict, dev: str = "cuda") -> dict:
    """fcos-serve: the full-width FCOS3D (bf16 convs; GN statistics,
    decode float32) serves 1 warm-up + N_REQUESTS batch-1 requests of one
    928 x 1600 view. Median and max ms, peak memory, the stream ms of the
    backbone, neck, head and decode, the device idle share (profiler), and
    the precision gap against the same request with every module in
    float32 (TF32 off): the class and centerness logits' largest gap, the
    share of the top-200 points both keep. Fails on a wrong output shape
    or a non-finite kept box."""
    import torch
    from isfusion_tpu_torch.flagship import build_fcos3d
    from isfusion_tpu_torch.models.dense_heads.fcos_mono3d_head import \
        flatten_levels

    model(batch, device=dev)
    sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        out = model(batch, device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    k = int(model.test_cfg.get("max_per_img", 200))
    shapes = {key: tuple(v.shape) for key, v in out.items()}
    if shapes != dict(bboxes=(1, k, 9), scores=(1, k), labels=(1, k),
                      mask=(1, k), attrs=(1, k)):
        raise RuntimeError(f"unexpected FCOS3D output shapes {shapes}")
    m = out["mask"]
    if not torch.isfinite(out["bboxes"][m]).all():
        raise RuntimeError("non-finite FCOS3D boxes")
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, img=list(batch["img"].shape[1:3]),
               kept_boxes=int(m.sum()))
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec.update(fcos_stream_ms(model, batch))
        rec["device_idle_share"] = device_profile(
            "fcos_profile", lambda: model(batch, device=dev))[
                "device_idle_share"]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model32, _ = build_fcos3d(device=dev, seed=0)
        for mod in model32.modules():         # every module in float32
            if hasattr(mod, "cdtype"):
                mod.cdtype = None
        f16 = model(batch, mode="feats", device=dev)
        f32 = model32(batch, mode="feats", device=dev)
        gap = {key: max(float((a[key].float() - b[key]).abs().max())
                        for a, b in zip(f16, f32))
               for key in ("cls_score", "centerness", "bbox_pred")}
        def top_points(feats):
            cls = flatten_levels([f["cls_score"].float() for f in feats])
            ctr = flatten_levels([f["centerness"].float() for f in feats])
            score = (cls.sigmoid() * ctr.sigmoid()).amax(-1)[0]
            return set(torch.topk(score, k).indices.tolist())

        rec["precision_gap"] = dict(
            logit_max_abs_gap=gap,
            cls_logit_max_abs=max(float(b["cls_score"].abs().max())
                                  for b in f32),
            top200_point_share=len(top_points(f16) & top_points(f32)) / k)
        del model32, f16, f32
        torch.cuda.empty_cache()
    log("fcos_main_path", **rec)
    return rec


def phase_fcos_train(model, batch: dict, dev: str = "cuda",
                     steps: int = N_TRAIN_STEPS) -> dict:
    """fcos-train: batch 2 (the config's ``2x8``), 24 GT rows a view, the
    config's SGD (momentum, weight decay, biases at 2x the lr and no
    decay), step lr with linear warmup and clip 35; 1 warm-up + ``steps``
    timed steps. Fails on a non-finite loss term (all five), a zero grad
    norm, a frozen tensor that changed (the stem, ``layer1``, every
    BatchNorm's parameters and statistics) or a trainable parameter that
    did not move."""
    import torch
    from isfusion_tpu_torch.flagship import fcos3d_optim_cfg
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = fcos3d_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, cfg["lr_config"], None), grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    frozen = {n: t.detach().clone() for n, t in
              model.backbone.state_dict().items()
              if n.split(".")[0] in ("conv1", "bn1", "layer1") or
              ".bn" in n or ".downsample.1." in n}
    step(batch, gen)
    sync(dev)
    watch = {n: p.detach().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        m = step(batch, gen)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        log("fcos_train_step", step=i, ms=times[-1], **vals)
        if set(FCOS_LOSSES) - set(vals) or any(
                not math.isfinite(v) for v in vals.values()) or \
                vals["grad_norm"] == 0:
            raise RuntimeError(f"FCOS3D train step {i}: {vals}")
    params = dict(model.named_parameters())
    unchanged = [n for n, t in watch.items() if torch.equal(params[n], t)]
    now = model.backbone.state_dict()
    moved = [n for n, t in frozen.items() if not torch.equal(now[n], t)]
    rec = dict(batch=int(batch["img"].shape[0]),
               gt_rows=int(batch["gt_mask"].shape[1]),
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, losses=vals, trainable=len(watch),
               unchanged_weights=unchanged, frozen_checked=len(frozen),
               frozen_moved=moved,
               lr=[g["lr"] for g in opt.param_groups])
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        device_profile("fcos_train_profile", lambda: step(batch, gen))
    log("fcos_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} FCOS3D steps: "
                           f"{unchanged[:10]}")
    if moved or not frozen:
        raise RuntimeError(f"frozen ResNet tensors changed: {moved[:10]}")
    model.eval()
    return rec


def phase_fcos_reference(dev: str = "cuda") -> dict:
    """The tiny FCOS3D in float32 (TF32 off) on the card against the CPU
    from the same weights and batch: head outputs within 1e-3 of their
    max, the decode's scores and boxes within 1e-4 of their max with
    equal labels, loss terms within 1e-4 relative, each top-level
    module's gradient within 1e-3 of its max, one step of the config's
    SGD (the parameters' updates) within 1e-3 of their max."""
    import torch
    from isfusion_tpu_torch.flagship import build_fcos3d, fcos3d_optim_cfg
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(d):
        model, batch_fn = build_fcos3d(tiny=True, device=d, seed=1)
        batch = batch_fn(2, seed=3)
        feats = model(batch, mode="feats", device=d)
        out = model(batch, device=d)
        model.train()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = build_optimizer(model, fcos3d_optim_cfg()["optimizer"])
        m = make_train_step(model, opt)(batch, torch.Generator(
            d).manual_seed(0))
        grads = {top: torch.cat([p.grad.detach().cpu().flatten() for p in
                                 getattr(model, top).parameters()
                                 if p.grad is not None])
                 for top in FCOS_MODULES}
        delta = torch.cat([(p.detach() - before[n]).cpu().flatten()
                           for n, p in model.named_parameters()])
        return ([{k: v.cpu() for k, v in f.items()} for f in feats],
                {k: v.cpu() for k, v in out.items()},
                {k: float(v) for k, v in m.items()}, grads, delta)

    (fg, og, mg, gg, dg), (fc, oc, mc, gc, dc) = run(dev), run("cpu")
    feat_err = max(_rel_to_max(a[k], b[k]) for a, b in zip(fg, fc)
                   for k in b if b[k] is not None)
    box_err = max(_rel_to_max(og[k], oc[k]) for k in ("bboxes", "scores"))
    labels_equal = torch.equal(og["labels"], oc["labels"])
    loss_err = max(abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mc.items()
                   if k != "grad_norm")
    grad_err = {top: _rel_to_max(gg[top], gc[top]) for top in FCOS_MODULES}
    step_err = _rel_to_max(dg, dc)
    rec = dict(feat_rel_err=feat_err, box_rel_err=box_err,
               labels_equal=labels_equal, loss_rel_err=loss_err,
               grad_rel_err=grad_err, sgd_step_rel_err=step_err, losses=mc)
    log("fcos_reference", **rec)
    if feat_err > 1e-3 or box_err > 1e-4 or not labels_equal or \
            loss_err > 1e-4 or max(grad_err.values()) > 1e-3 or \
            step_err > 1e-3:
        raise RuntimeError(f"tiny FCOS3D on the card differs from the CPU: "
                           f"{rec}")
    return rec


def fcos_run() -> int:
    """``python3 chip_smoke.py --fcos``: the device and build phases, then
    the FCOS3D phases alone."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    run_fcos_phases()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_fcos_phases(dev: str = "cuda") -> dict:
    import torch
    from isfusion_tpu_torch.flagship import build_fcos3d, fcos3d_optim_cfg

    model, batch_fn = build_fcos3d(device=dev, seed=0)
    serve = phase_fcos_main_path(model, batch_fn(1), dev)
    train = phase_fcos_train(model, batch_fn(
        fcos3d_optim_cfg()["samples_per_gpu"], seed=1), dev)
    del model
    if dev == "cuda":
        torch.cuda.empty_cache()
    return dict(serve=serve, train=train, reference=phase_fcos_reference(dev))


# ------------------------------------------------ LiDAR detectors on parts
@contextlib.contextmanager
def recording_heatmaps():
    """Inside the block, every K11 call of CenterHead and TransFusionHeadV2
    appends its inputs to the yielded list; the kernel still runs."""
    from isfusion_tpu_torch.models.dense_heads import (centerpoint_head,
                                                       transfusion_head)

    seen, mods = [], (centerpoint_head, transfusion_head)
    real = [m.draw_heatmap_gaussian_batch for m in mods]
    for m, r in zip(mods, real):
        m.draw_heatmap_gaussian_batch = recording_heatmap(r, seen)
    try:
        yield seen
    finally:
        for m, r in zip(mods, real):
            m.draw_heatmap_gaussian_batch = r


def variant_kernel_check(name: str, rec: dict, dev: str) -> dict:
    """Every kernel a LiDAR variant's path launched, against its plain
    version on the inputs that path gave it (``phase_lidar_variants``):
    K12 and K11 bit for bit, K10-circle's keep masks equal, K10-NMS as
    ``_nms_compare``, K10 within 1e-5 and 0 wherever the plain version
    is, K1 and K2 as ``dynamic_check``. Returns {kernel: record}."""
    import torch
    from isfusion_tpu_torch.ops import box_ops, gaussian
    from isfusion_tpu_torch.ops.gather import masked_gather, masked_gather_ref

    out = {}
    for key, (src, idx, fmask) in rec["gathers"].items():
        if src.shape[1] * src.element_size() % 16:
            continue        # a CPU rehearsal's plain route: unpadded rows
        got, ref = masked_gather(src, idx, fmask), masked_gather_ref(
            src, idx, fmask)
        out.setdefault("masked_gather", []).append(dict(
            shape=list(key), equal=torch.equal(got, ref),
            max_abs_err=float((got.float() - ref.float()).abs().max())))
    for c, s, v, t in rec["circles"]:
        got = box_ops.circle_nms_mask(c, s, t, v)
        ref = box_ops.circle_nms_mask_ref(c, s, t, v)
        out.setdefault("nms_circle", []).append(dict(
            R=c.shape[0], K=c.shape[1], equal=torch.equal(got, ref),
            max_abs_err=float((got != ref).sum())))
    for boxes, scores, valid in rec["nms"]:
        r = _nms_compare(boxes, scores, valid, rec["nms_thr"], dev)
        ok = r["greedy_equal"] and r["symmetric"] and not r["bad_bits"] and \
            (r["keep_equal"] or r["pairs_near_threshold"] > 0)
        out.setdefault("nms_bev", []).append(dict(
            K=r["K"], C=r["C"], kept=r["kept"], equal=ok,
            keep_equal=r["keep_equal"],
            max_abs_err=float(r["keep_flags_differ"])))
    for shape_hw, c, r, v, lab, nc in rec["heatmaps"]:
        got = gaussian.draw_heatmap_gaussian_batch(shape_hw, c, r, v, lab, nc)
        ref = gaussian.draw_heatmap_gaussian_batch_ref(shape_hw, c, r, v,
                                                       lab, nc)
        out.setdefault("gaussian_heatmap", []).append(dict(
            shape=list(got.shape), equal=torch.equal(got, ref),
            max_abs_err=float((got - ref).abs().max())))
    for a, b in rec["ious"]:
        r = iou_case(a, b, dev, timed=False)
        out.setdefault("boxes_iou_3d", []).append(dict(
            shape=r["shape"], equal=r["max_abs_err"] <= 1e-5 and
            not r["nonzero_where_plain_zero"], max_abs_err=r["max_abs_err"]))
    if rec["dynamic"]:
        for case, r in dynamic_check(f"variant_{name}", rec["dynamic"],
                                     dev).items():
            out.setdefault(r["kernel"], []).append(dict(
                case=case, equal=True, max_abs_err=r["max_abs_err"]))
    bad = {k: [c for c in v if not c["equal"]] for k, v in out.items()}
    bad = {k: v for k, v in bad.items() if v}
    if bad:
        raise RuntimeError(f"{name}: kernels differ from their plain "
                           f"versions on the path's inputs: {bad}")
    return {k: dict(calls=len(v), max_abs_err=max(c["max_abs_err"]
                                                  for c in v))
            for k, v in out.items()}


def _variant_run(name: str, dev: str, record: bool = False,
                 pins=None) -> dict:
    """One LiDAR variant on ``dev`` from seed 1, on nuScenes' raw 0-255
    intensities: its head outputs, the kept boxes (all of them, canonical
    order), the loss terms and each top-level module's gradient of one
    train-mode loss forward, all under ``testing.pinned_choices(pins)``
    (``choices``: recorded, or taken from ``pins`` with this run's own
    differing choices reported); with ``record``, the launches of the
    predict and loss paths (counts zeroed just before each) and every
    kernel's inputs on them."""
    import torch
    from isfusion_tpu_torch.flagship import (LIDAR_VARIANT_KERNELS,
                                             build_lidar_variant)
    from isfusion_tpu_torch.models.dense_heads.anchor3d_head import \
        Anchor3DHead
    from isfusion_tpu_torch.models.dense_heads.centerpoint_head import \
        CenterHead
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import (bbox_head, cp_kept_boxes,
                                            even_class_prior, pinned_choices,
                                            pp_kept_boxes, tame_box_deltas)

    model, batch_fn = build_lidar_variant(name, device=dev, seed=1)
    head = bbox_head(model)
    if isinstance(head, Anchor3DHead):
        even_class_prior(tame_box_deltas(model))
    batch = batch_fn(2, seed=3)
    with contextlib.ExitStack() as stack:
        choices = stack.enter_context(pinned_choices(pins))
        rec = dict(feats=[t.detach().cpu() for t in _leaves(
            model(batch, mode="feats", device=dev))], choices=choices)
        if record:
            rec.update(dynamic=stack.enter_context(recording_dynamic()),
                       gathers=stack.enter_context(recording_gathers()),
                       nms=stack.enter_context(recording_nms()),
                       circles=stack.enter_context(recording_circle_nms()),
                       heatmaps=stack.enter_context(recording_heatmaps()),
                       ious=stack.enter_context(recording_iou()))
        cuda_build.reset_launches()
        if isinstance(head, Anchor3DHead):
            kept = pp_kept_boxes(model, batch, dev)
        elif isinstance(head, CenterHead):
            kept = cp_kept_boxes(model, batch, dev)
        else:
            out = {k: v.cpu() for k, v in model(batch, device=dev).items()}
            kept = (out["bboxes"], out["scores"], out["labels"])
        sync(dev)
        predict = dict(cuda_build.LAUNCHES)
        model.train()
        cuda_build.reset_launches()
        losses = model(batch, mode="loss", device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
        sum(v for k, v in losses.items() if "loss" in k).backward()
        sync(dev)
        train = dict(cuda_build.LAUNCHES)
    tops = sorted({n.split(".")[0] for n, _ in model.named_parameters()})
    grads = {top: torch.cat([p.grad.detach().cpu().flatten() for p in
                             getattr(model, top).parameters()
                             if p.grad is not None]) for top in tops}
    kernels = LIDAR_VARIANT_KERNELS[name]
    rec.update(kept=kept, grads=grads,
               losses={k: float(v.detach()) for k, v in losses.items()},
               launches=dict(
                   predict={k: predict[k] for k in kernels["predict"]},
                   train={k: train[k] for k in set(kernels["predict"]) |
                          set(kernels["train"])}),
               nms_thr=float(head.test_cfg.get("nms_thr", 0.0)))
    if record and rec["dynamic"]:
        # K2's point lists come from the path's own K1
        check_no_layout_builds(name, {"segment_layout":
                                      predict["segment_layout"] +
                                      train["segment_layout"]})
    return rec


def kept_match_errs(got, want):
    """Kept boxes (boxes, scores, keys in canonical order, ``testing.
    pp_kept_boxes``) of two devices: each box of ``want`` matched to the
    nearest box of ``got`` with its key (boxes at one anchor position tie
    in the canonical order). Returns each box's error, the larger of its
    box's and its score's relative to their max, or None when the counts
    per key differ."""
    import torch

    (bg, sg, kg), (bw, sw, kw) = got, want
    if not len(bw):
        return None
    bscale = bw.abs().max().clamp_min(1e-30)
    sscale = sw.abs().max().clamp_min(1e-30)
    errs = []
    for key in torch.unique(kw):
        g, w = kg == key, kw == key
        if int(g.sum()) != int(w.sum()):
            return None
        dist = torch.maximum(
            (bw[w][:, None] - bg[g][None]).abs().amax(-1) / bscale,
            (sw[w][:, None] - sg[g][None]).abs() / sscale)
        errs.append(dist.amin(1))
    return torch.cat(errs)


def _leaves(tree):
    """The tensors of nested dicts / lists, in key order."""
    import torch
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def phase_lidar_variants(dev: str = "cuda") -> dict:
    """The tiny LiDAR detectors on ported parts (``flagship.
    LIDAR_VARIANTS``), float32 (TF32 off), on nuScenes' raw 0-255
    intensities, each on the card against the CPU from the same weights
    and batch. The card run takes the CPU run's discrete choices (every
    ReLU's signs, the heads' top-k picks, TransFusion's Hungarian
    matches, the NMS keep masks: ``testing.pinned_choices``), and each
    choice the card would have made otherwise must be a tie within
    rounding: a ReLU input within 1e-4 of its tensor's max of 0, top-k
    picks within 1e-4 of the scores' max, a match within 1e-4 of the
    optimal cost, NMS suppression bits that differ only at pairs within
    1e-4 of the threshold and score orders only among scores within 1e-4
    of their max. Given those choices: head outputs within 1e-4 of their
    max; the same kept boxes of each sample and class, every one within
    1e-4 of the boxes' and scores' max; loss terms (train mode) within
    1e-4 relative; each top-level module's gradient within 1e-3 of its
    max. On the card each kernel of the path (``flagship.
    LIDAR_VARIANT_KERNELS``) must launch in the predict or the train
    forward (counts zeroed just before each), and each is held against its
    plain version on the inputs the path gave it
    (``variant_kernel_check``). Returns {variant: record}."""
    import torch
    from isfusion_tpu_torch.flagship import (LIDAR_VARIANT_KERNELS,
                                             LIDAR_VARIANTS)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in LIDAR_VARIANTS:
        cpu = _variant_run(name, "cpu")
        card = _variant_run(name, dev, record=True, pins=cpu["choices"])
        (bg, sg, kg), (bc, sc, kc) = card["kept"], cpu["kept"]
        same = bg.shape == bc.shape and torch.equal(kg.cpu(), kc.cpu())
        errs = kept_match_errs((bg.cpu(), sg.cpu(), kg.cpu()),
                               (bc, sc, kc)) if same else None
        kept_err = float(errs.max()) if errs is not None and len(errs) \
            else (0.0 if errs is not None or not len(kc) else None)
        feat_err = max(_rel_to_max(a.cpu(), b) for a, b in zip(
            card["feats"], cpu["feats"]))
        loss_err = max(abs(card["losses"][k] - v) / max(abs(v), 1e-12)
                       for k, v in cpu["losses"].items() if "loss" in k)
        grad_err = {top: _rel_to_max(card["grads"][top], g)
                    for top, g in cpu["grads"].items()}
        choices = card["choices"]
        checks = variant_kernel_check(name, card, dev)
        rec = dict(kept=int(kc.numel()), same_kept_per_class=same,
                   kept_max_rel_err=kept_err, head_rel_err=feat_err,
                   loss_rel_err=loss_err, grad_rel_err=grad_err,
                   choices_pinned={k: len(choices[k]) for k in (
                       "relu", "topk", "assign", "nms_bev", "nms_circle")},
                   card_own_choices_differ=choices["flips"],
                   unexplained_choices=choices["unexplained"],
                   launches=card["launches"], kernel_checks=checks)
        log("lidar_variants", variant=name, **rec)
        if not same or kept_err is None or kept_err > 1e-4 or \
                feat_err > 1e-4 or loss_err > 1e-4 or \
                max(grad_err.values()) > 1e-3 or choices["unexplained"]:
            raise RuntimeError(f"tiny {name} on the card differs from the "
                               f"CPU: {rec}")
        kernels = LIDAR_VARIANT_KERNELS[name]
        missing = [k for k in kernels["predict"]
                   if card["launches"]["predict"][k] == 0] + \
            [k for k in kernels["train"] if card["launches"]["train"][k] == 0]
        if dev == "cuda" and missing:
            raise RuntimeError(f"{name}: kernels not launched on the path: "
                               f"{missing} ({card['launches']})")
        out[name] = rec
    return out


def learn_run(work_dir: str) -> int:
    """``python3 chip_smoke.py --learn WORK_DIR``: the learnability recipe
    in full on the card. A fixture of 48 train / 16 val samples (seed 0,
    120,000 points, car and pedestrian) under WORK_DIR/data; the config's
    100 epochs at batch 4 (evaluation and checkpoint every 20 epochs, a
    record every 50 steps) by ``train_model`` into WORK_DIR
    (``train_log.jsonl``); then the timed eval of the val split. Prints
    one ``[learn_run]`` record and the ``nvidia-smi`` line; exits 1 unless
    the last logged loss is <= 1.0 and the final mAP >= 0.50 and NDS >=
    0.55."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    from isfusion_tpu_torch.apis import init_model, train_model
    from isfusion_tpu_torch.datasets import build_dataset
    from isfusion_tpu_torch.tools.make_synthetic_nuscenes import make_dataset

    work_dir = os.path.abspath(work_dir)
    data = os.path.join(work_dir, "data")
    t0 = time.perf_counter()
    make_dataset(data, train=48, val=16, points=120_000, seed=0,
                 classes=LEARN_CLASSES)
    fixture_s = time.perf_counter() - t0
    cfg = learn_cfg(data, epochs=100, eval_interval=20, ckpt_interval=20,
                    log_interval=50)
    model = init_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records = train_model(model, build_dataset(cfg.data.train), cfg,
                          work_dir, device="cuda")
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _, metrics, _, ev = _timed_eval(model, cfg, "cuda")
    final = [r for r in records if "mode" in r][-1]
    summary = _steps_summary(records)
    ok = summary["last_loss"] <= 1.0 and final["mAP"] >= 0.50 and \
        final["NDS"] >= 0.55
    log("learn_run", nvidia_smi=smi, fixture_s=fixture_s, train_s=train_s,
        steps=max(r["step"] for r in records if "step" in r),
        peak_mem_gib=peak, **summary, **ev,
        val=[{k: r[k] for k in ("epoch", "mAP", "NDS")}
             for r in records if "mode" in r],
        final_eval={k: metrics[k] for k in ("mAP", "NDS")},
        meets_acceptance=ok)
    print(smi)
    return 0 if ok else 1


# the K2 fields of the kernels line at the train and MVX-Net shapes
DP_WORLD = 2                # ranks of [dp_train] / [dp_eval] on one card
DP_STEPS = 2
# a module's gradients in a DP step against the one-card step: within
# 1e-3 of its max where the one-card step repeats that closely, else
# within DP_GRAD_CEILING, and no module's one-card repeat gap above it:
# about twice the largest gap read on an H100 80GB HBM3 (2.26e-2, the
# VFE's; the sparse encoder's 1.53e-2), where P2G's index_add_ and
# grid_sampler_2d_backward sum by atomics
DP_GRAD_CEILING = 5e-2
DP_KERNELS = ("masked_gather_forward", "masked_gather_backward",
              "dynamic_voxelize", "dynamic_scatter_forward",
              "dynamic_scatter_backward", "gaussian_heatmap", "boxes_iou_3d")


def _module_errs(got: dict, want: dict) -> dict:
    """Per top-level module: max |got - want| over the module's tensors
    relative to its max |want|."""
    import torch
    errs = {}
    for top in sorted({n.split(".")[0] for n in want}):
        names = [n for n in want if n.split(".")[0] == top]
        w = torch.cat([want[n].float().ravel() for n in names])
        g = torch.cat([got[n].float().ravel().to(w.device) for n in names])
        errs[top] = float((g - w).abs().max() /
                          w.abs().max().clamp_min(1e-30))
    return errs


class StepProbe:
    """Launch counts of each step of ``model`` (forward and backward split
    at the end of the detector's forward) and the all-reduce calls (a
    sync BatchNorm's and the gradients') made during it."""

    def __init__(self, model):
        import torch.distributed as dist
        from isfusion_tpu_torch.ops import cuda_build
        self.launches = cuda_build.LAUNCHES
        self.mid = None
        self.calls = 0
        self.hook = model.register_forward_hook(self._forward_end)
        self.real = dist.all_reduce
        probe = self

        def counted(*args, **kw):
            probe.calls += 1
            return probe.real(*args, **kw)

        dist.all_reduce = counted

    def _forward_end(self, *_):
        self.mid = dict(self.launches)

    def close(self):
        import torch.distributed as dist
        dist.all_reduce = self.real
        self.hook.remove()

    def run(self, step, batch, gen, dev: str):
        """One ``step``: (metrics as floats, host ms ending in a sync,
        launches, all-reduce calls)."""
        before, self.calls = dict(self.launches), 0
        t0 = time.perf_counter()
        m = step(batch, gen)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        after, mid = dict(self.launches), self.mid
        launches = dict(
            masked_gather_forward=mid["masked_gather"] -
            before["masked_gather"],
            masked_gather_backward=after["masked_gather"] -
            mid["masked_gather"],
            dynamic_voxelize=mid["dynamic_voxelize"] -
            before["dynamic_voxelize"],
            dynamic_scatter_forward=mid["dynamic_scatter"] -
            before["dynamic_scatter"],
            dynamic_scatter_backward=after["dynamic_scatter"] -
            mid["dynamic_scatter"],
            gaussian_heatmap=after["gaussian_heatmap"] -
            before["gaussian_heatmap"],
            boxes_iou_3d=after["boxes_iou_3d"] - before["boxes_iou_3d"])
        return {k: float(v) for k, v in m.items()}, ms, launches, self.calls


def _dp_models(tiny: bool, dev: str):
    """(flagship, its batch_fn, the flagship recipe's step factory)."""
    from isfusion_tpu_torch.flagship import (build_isfusion_flagship,
                                             flagship_optim_cfg)
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)
    model, batch_fn = build_isfusion_flagship(tiny=tiny, device=dev, seed=0)
    cfg = flagship_optim_cfg()

    def make_step():
        opt = build_optimizer(model, cfg["optimizer"])
        return make_train_step(
            model, opt, build_schedule(opt, cfg["lr_config"],
                                       cfg["momentum_config"]),
            grad_clip_norm(cfg["optimizer_config"]))

    return model.train(), batch_fn, make_step


def _grads(model) -> dict:
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def _params(model) -> dict:
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def _grad_limits(spread: dict) -> dict:
    """Each module's gradient limit from its one-card repeat gap
    (``spread``: the largest gap of two more one-card steps from the
    first): 1e-3 of its max below 1e-3, else DP_GRAD_CEILING."""
    return {k: 1e-3 if v < 1e-3 else DP_GRAD_CEILING
            for k, v in spread.items()}


def _step_check(got: dict, want: dict, spread: dict) -> dict:
    """A DP step against the one-card step: losses within 1e-4 relative,
    updated parameters within 1e-3 of each top-level module's max, each
    module's gradients within its ``_grad_limits``, and no one-card
    repeat gap above DP_GRAD_CEILING."""
    loss_err = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
                   for k, v in want["metrics"].items()
                   if "loss" in k)
    grad_err = _module_errs(got["grads"], want["grads"])
    param_err = _module_errs(got["params"], want["params"])
    limits = _grad_limits(spread)
    grad_ok = all(e <= limits[k] for k, e in grad_err.items()) and \
        max(spread.values()) <= DP_GRAD_CEILING
    return dict(loss_rel_err=loss_err, grad_err_of_max=max(
        grad_err.values()), param_err_of_max=max(param_err.values()),
        ok=loss_err <= 1e-4 and grad_ok and max(param_err.values()) <= 1e-3,
        grad_err_per_module=grad_err)


def _vfe_stats(model) -> dict:
    return {n: b.detach().cpu().clone() for n, b in
            model.pts_voxel_encoder.named_buffers() if "running" in n}


def _vfe_reference(model, batch: dict, dev: str) -> dict:
    """The flagship VFE's running statistics after one train-mode pass
    of the VFE alone over every point of ``batch``, voxelized as the
    detector's forward voxelizes them (nothing else reaches those
    statistics)."""
    import torch
    from isfusion_tpu_torch import upload
    from isfusion_tpu_torch.ops.voxel import voxelize_dynamic
    t = upload(model, {k: batch[k] for k in ("points", "points_mask")}, dev)
    points, mask = t["points"].float(), t["points_mask"].bool()
    vl = model.pts_voxel_layer
    with torch.no_grad():
        dv = voxelize_dynamic(points, mask, vl["point_cloud_range"],
                              vl["voxel_size"])
        model.pts_voxel_encoder(points.reshape(-1, points.shape[-1]),
                                dv.point_voxel_index, dv.voxel_coors,
                                layout=(dv.voxel_ptr, dv.point_order))
    return _vfe_stats(model)


def _pp_model(dev: str, tiny: bool, float32: bool):
    """The PointPillars of the nuScenes config (every norm synced), seed
    0; ``float32`` computes the backbone and neck in float32."""
    import copy
    from isfusion_tpu_torch.flagship import pointpillars_model_cfg
    from isfusion_tpu_torch.models.builder import build_detector
    from isfusion_tpu_torch.models.layers import init_weights
    cfg = copy.deepcopy(pointpillars_model_cfg(tiny))
    if float32:
        for key in ("pts_backbone", "pts_neck", "pts_bbox_head"):
            cfg[key] = dict(cfg[key], compute_dtype=None)
    return init_weights(build_detector(cfg), 0).to(dev).train()


def _pp_feats(model, batch: dict, dev: str):
    """Train-mode (batch statistics) feature path of PointPillars up to
    the neck, no gradient."""
    import torch
    from isfusion_tpu_torch import upload
    from isfusion_tpu_torch.models.detectors.mvx_two_stage import \
        lidar_features
    with torch.no_grad():
        return lidar_features(
            upload(model, batch, dev), model.pts_voxel_layer, True,
            model.pts_voxel_encoder, model.pts_middle_encoder,
            model.pts_backbone, model.pts_neck)


def _set_tf32(matmul: bool, cudnn: bool):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _dp_eval_cfg(data: str):
    cfg = learn_cfg(data, epochs=1, eval_interval=1, ckpt_interval=1,
                    log_interval=1)
    cfg.data.samples_per_gpu = 2
    cfg.data.workers_per_gpu = 0
    return cfg


def _dp_eval_model(cfg, dev: str):
    from isfusion_tpu_torch.apis import init_model
    from isfusion_tpu_torch.testing import tame_box_deltas
    return tame_box_deltas(init_model(cfg, device=dev, seed=0))


def dp_rank(rank: int, size: int, work: str, dev: str, tiny: bool,
            refs) -> None:
    """One rank of [dp_train] / [dp_eval] (spawned; gloo, every rank on
    ``cuda:0`` on the card). Builds the flagship and warms it up with one
    DP step at batch 1 (the first step of a fresh process loads its
    kernels and its collectives' buffers), then takes the one-process
    references from the queue ``refs`` (CPU tensors in shared memory,
    and the parent's TF32 flags), compares against them and writes
    ``work/rank{rank}.json``, with the wall-clock time each part ended
    at (``ended_at``)."""
    ended = dict(entered=time.time())
    sys.path.insert(0, REPO)
    import copy
    import torch
    import torch.distributed as dist
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        work, "group"), rank=rank, world_size=size)
    ended["group"] = time.time()
    try:
        model, batch_fn, make_step = _dp_models(tiny, dev)
        init = copy.deepcopy(model.state_dict())
        ended["build"] = time.time()
        make_step()(train_batch(batch_fn, 1), torch.Generator(
            dev).manual_seed(0))
        model.load_state_dict(init)
        if dev == "cuda":
            torch.cuda.empty_cache()
        ended["warm_up"] = time.time()
        ref = refs.get()
        ended["references"] = time.time()
        if dev == "cuda":
            _set_tf32(*ref["tf32"])
        out = dict(flagship=_dp_rank_flagship(rank, size, dev, model,
                                              make_step, init,
                                              ref["flagship"]))
        del model, init
        if dev == "cuda":
            torch.cuda.empty_cache()
        ended["flagship"] = time.time()
        out["pointpillars"] = _dp_rank_pp(rank, size, dev, tiny,
                                          ref["tf32"], ref["pp"])
        ended["pointpillars"] = time.time()
        out["eval"] = _dp_rank_eval(rank, size, dev, ref["eval"])
        del ref
        ended["eval"] = time.time()
        out["ended_at"] = ended
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f, default=float)
    finally:
        dist.destroy_process_group()


def start_dp_ranks(dev: str = "cuda", tiny: bool = False) -> dict:
    """Spawn the ``DP_WORLD`` ranks of [dp_train] / [dp_eval] (``dp_rank``)
    early: they start, build and warm up while earlier phases run, then
    wait for ``phase_dp``'s references. ``stop_dp_ranks`` ends them."""
    import tempfile
    import torch.multiprocessing as mp
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="dp_", dir=os.path.join(REPO, "build"))
    refs = mp.get_context("spawn").SimpleQueue()
    started = time.time()
    ctx = mp.spawn(dp_rank, args=(DP_WORLD, work, dev, tiny, refs),
                   nprocs=DP_WORLD, join=False)
    return dict(work=work, refs=refs, ctx=ctx, started=started, dev=dev,
                tiny=tiny)


def stop_dp_ranks(ranks: dict) -> None:
    """End the ranks that are still running (after a failure they wait
    for references that never come) and remove their directory."""
    import shutil
    for p in ranks["ctx"].processes:
        if p.is_alive():
            p.terminate()
        p.join()
    shutil.rmtree(ranks["work"], ignore_errors=True)


def _dp_run(model, step, batch, gen, dev, steps=DP_STEPS,
            keep_first=False):
    """``steps`` steps; per step metrics, ms, launches, all-reduce calls;
    with ``keep_first``, the first step's gradients and updated
    parameters."""
    probe = StepProbe(model)
    try:
        recs, first = [], None
        for i in range(steps):
            m, ms, launches, calls = probe.run(step, batch, gen, dev)
            recs.append(dict(metrics=m, ms=ms, launches=launches,
                             allreduce_calls=calls))
            if i == 0 and keep_first:
                first = dict(metrics=m, grads=_grads(model),
                             params=_params(model))
    finally:
        probe.close()
    return recs, first


@contextlib.contextmanager
def _recorded_pmean():
    """Within the block the train step's gradient all-reduce also keeps
    host copies of its flat input (this rank's gradients, has-gradient
    flags and loss terms) and of its output (their mean) in the yielded
    dict."""
    import torch
    from isfusion_tpu_torch.parallel import train_step
    real, seen = train_step.all_reduce_mean_, {}

    def recorded(tensors):
        seen["local"] = torch.cat([t.reshape(-1) for t in tensors]).cpu()
        n = real(tensors)
        seen["mean"] = torch.cat([t.reshape(-1) for t in tensors]).cpu()
        return n

    train_step.all_reduce_mean_ = recorded
    try:
        yield seen
    finally:
        train_step.all_reduce_mean_ = real


def _pmean_err(seen: dict, size: int) -> float:
    """The step's averaged buffer against the mean of every rank's own
    buffer, gathered on the host (``all_gather``: another collective than
    the step's), relative to the mean's max."""
    import torch
    import torch.distributed as dist
    every = [torch.empty_like(seen["local"]) for _ in range(size)]
    dist.all_gather(every, seen["local"])
    want = torch.stack(every).sum(0) / size
    return float((seen["mean"] - want).abs().max() /
                 want.abs().max().clamp_min(1e-30))


def _packed(tensors: dict) -> tuple:
    """(names, shapes, one flat float32 tensor) of a name -> tensor dict:
    one storage to share with the ranks (a shared storage holds a file
    descriptor)."""
    import torch
    names = list(tensors)
    return names, [tuple(tensors[n].shape) for n in names], torch.cat(
        [tensors[n].float().reshape(-1) for n in names])


def _as_tensors(batch: dict) -> dict:
    """A numpy batch as CPU tensors (shared with the ranks, not
    pickled)."""
    import numpy as np
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _unpacked(packed: tuple) -> dict:
    names, shapes, flat = packed
    parts = flat.split([math.prod(s) for s in shapes])
    return {n: t.view(s) for n, t, s in zip(names, parts, shapes)}


def _dp_rank_flagship(rank, size, dev, model, make_step, init,
                      ref) -> dict:
    """[dp_train]'s flagship on rank ``rank``: ``model`` (in its initial
    state ``init``), the recipe's step factory ``make_step`` and the
    parent's references ``ref``."""
    import torch
    from isfusion_tpu_torch.apis.train import rank_seed
    from isfusion_tpu_torch.parallel.mesh import all_reduce_mean_, \
        shard_batch
    marks = [("start", time.perf_counter())]
    pooled = dict(ref["pooled_step"], grads=_unpacked(ref["pooled_step"][
        "grads"]), params=_unpacked(ref["pooled_step"]["params"]))
    out = {}
    # (a) identical halves: every rank the one-card step's batch (the
    # first half of the global batch) and draws, against the one-card
    # step with the pooled statistics
    step = make_step()
    marks.append(("load", time.perf_counter()))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    recs, first = _dp_run(model, step, shard_batch(ref["global_batch"], 0,
                                                   size),
                          torch.Generator(dev).manual_seed(0), dev, steps=1,
                          keep_first=True)
    out["same"] = dict(steps=recs, check=_step_check(
        first, pooled, ref["spread"]),
        allreduce_bytes=step.state["allreduce_bytes"])
    grads = [p.grad.detach().clone() for p in model.parameters()
             if p.grad is not None]
    times = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        all_reduce_mean_(grads)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = statistics.median(times)
    del step, grads, first
    marks.append(("identical_halves", time.perf_counter()))
    # (b) distinct halves of the global batch, each rank its own draws;
    # the first step's gradient pmean against the ranks' own gradients
    model.load_state_dict(init)
    step = make_step()
    own = shard_batch(ref["global_batch"], rank, size)
    gen = torch.Generator(dev).manual_seed(rank_seed(0, rank))
    with _recorded_pmean() as seen:
        recs, _ = _dp_run(model, step, own, gen, dev, steps=1)
    vfe = _vfe_stats(model)     # after one forward over both halves
    pmean_err = _pmean_err(seen, size)
    del seen
    recs += _dp_run(model, step, own, gen, dev, steps=DP_STEPS - 1)[0]
    errs = {n: float((vfe[n] - w).abs().max() / w.abs().max().clamp_min(
        1e-30)) for n, w in ref["vfe_stats"].items()}
    out["distinct"] = dict(steps=recs, vfe_stats_err=max(errs.values()),
                           vfe_stats_err_per_buffer=errs,
                           pmean_err_of_max=pmean_err)
    if dev == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del step
    marks.append(("distinct_halves", time.perf_counter()))
    out["seconds"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    return out


def _dp_rank_pp(rank, size, dev, tiny, tf32, ref) -> dict:
    import torch
    from isfusion_tpu_torch.flagship import pointpillars_optim_cfg
    from isfusion_tpu_torch.parallel.mesh import shard_batch
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)
    own = shard_batch(ref["batch"], rank, size)
    # the feature path up to the neck, float32 (TF32 off), train mode
    if dev == "cuda":
        _set_tf32(False, False)
    model = _pp_model(dev, tiny, float32=True)
    feats = _pp_feats(model, own, dev).float().cpu()
    want = ref["feats"][rank]
    stats = {n: b.cpu() for n, b in model.named_buffers() if "running" in n}
    out = dict(feats_err_of_max=float((feats - want).abs().max() /
                                      want.abs().max()),
               running_err_of_max=max(_module_errs(
                   stats, ref["running"]).values()),
               running_buffers=len(stats))
    del model
    # the train steps at the config's precision (bf16 convs)
    if dev == "cuda":
        _set_tf32(*tf32)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = _pp_model(dev, tiny, float32=False)
    cfg = pointpillars_optim_cfg()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, cfg["lr_config"], cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    recs, _ = _dp_run(model, step, own, torch.Generator(dev).manual_seed(0),
                      dev)
    out.update(steps=recs, allreduce_bytes=step.state["allreduce_bytes"])
    if dev == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, step, opt
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _dp_rank_eval(rank, size, dev, ref) -> dict:
    import torch
    from isfusion_tpu_torch.apis import single_device_test
    from isfusion_tpu_torch.apis.train import evaluate_split
    from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
    if dev == "cuda":
        _set_tf32(False, False)
    cfg = _dp_eval_cfg(ref["data"])
    model = _dp_eval_model(cfg, dev)
    dataset = build_dataset(cfg.data.val)
    loader = build_dataloader(dataset, samples_per_gpu=2 * size,
                              shuffle=False)
    t0 = time.perf_counter()
    got = single_device_test(model, loader, dev)
    eval_s = time.perf_counter() - t0
    metrics = evaluate_split(model, cfg, "val", dev)
    same = len(got) == len(ref["results"]) and all(
        all((g[k] == w[k]).all() for k in w)
        for g, w in zip(got, ref["results"]))
    errs = []
    for g, w in zip(got, ref["results"]):
        m_g, m_w = g["mask"], w["mask"]
        if not (m_g == m_w).all() or not (g["labels"][m_w] ==
                                          w["labels"][m_w]).all():
            errs.append(float("inf"))
            continue
        for k in ("bboxes", "scores"):
            scale = max(abs(w[k][m_w]).max(), 1e-30) if m_w.any() else 1
            errs.append(float(abs(g[k][m_w] - w[k][m_w]).max() / scale)
                        if m_w.any() else 0.0)
    metrics_err = None if metrics is None else max(
        abs(float(metrics[k]) - float(v)) for k, v in ref["metrics"].items()
        if isinstance(v, (int, float)))
    return dict(samples=len(got), bit_equal=bool(same),
                max_err_of_max=max(errs) if errs else 0.0, eval_s=eval_s,
                metrics_max_abs_err=metrics_err)


def phase_dp(ranks: dict) -> dict:
    """[dp_train] and [dp_eval]: the one-process references and the
    one-rank NCCL step, then the ranks of ``start_dp_ranks`` run on
    those references."""
    import copy
    import torch
    import torch.distributed as dist
    from isfusion_tpu_torch.apis import single_device_test
    from isfusion_tpu_torch.apis.train import evaluate_split
    from isfusion_tpu_torch.flagship import build_pointpillars_flagship
    from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
    from isfusion_tpu_torch.parallel.mesh import shard_batch
    from isfusion_tpu_torch.testing import pooled_sync_norms
    from isfusion_tpu_torch.tools.make_synthetic_nuscenes import make_dataset

    dev, tiny, work = ranks["dev"], ranks["tiny"], ranks["work"]
    # the ranks take this process's TF32 flags (earlier phases turn TF32
    # off), so that their steps compute what the references here compute
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    marks = [("start", time.time())]
    try:
        # the flagship's one-card step (the identical-halves reference)
        model, batch_fn, make_step = _dp_models(tiny, dev)
        init = copy.deepcopy(model.state_dict())
        spg = 2 if tiny else 4
        global_batch = train_batch(batch_fn, spg * DP_WORLD)
        batch = shard_batch(global_batch, 0, DP_WORLD)
        runs = []
        # the step three times (how far it repeats), then with the sync
        # norms' pooled sums, which identical halves double exactly
        for pooled in (False, False, False, True):
            model.load_state_dict(init)
            probe = StepProbe(model)
            try:
                with pooled_sync_norms() if pooled else \
                        contextlib.nullcontext():
                    m, ms, one_launches, _ = probe.run(
                        make_step(), batch,
                        torch.Generator(dev).manual_seed(0), dev)
            finally:
                probe.close()
            runs.append(dict(metrics=m, grads=_grads(model),
                             params=_params(model)))
        ref_step, pooled_step = runs[0], runs[3]
        gaps = [_module_errs(r["grads"], ref_step["grads"])
                for r in runs[1:3]]
        spread = {k: max(g[k] for g in gaps) for k in gaps[0]}
        del runs, gaps
        marks.append(("one_card_steps", time.time()))
        # one rank under the config's backend: the DP step is the one-card
        # step (its only all-reduce the gradients')
        model.load_state_dict(init)
        backend = "nccl" if dev == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="file://" +
                                os.path.join(work, "one"), rank=0,
                                world_size=1)
        try:
            recs, first = _dp_run(model, make_step(), batch,
                                  torch.Generator(dev).manual_seed(0), dev,
                                  steps=1, keep_first=True)
        finally:
            dist.destroy_process_group()
        one_rank = dict(backend=backend,
                        **_step_check(first, ref_step, spread),
                        allreduce_calls=recs[0]["allreduce_calls"],
                        launches_equal=recs[0]["launches"] == one_launches,
                        one_card_repeat_grad_err=spread,
                        grad_limits=_grad_limits(spread))
        marks.append(("one_nccl_rank", time.time()))
        # the synced VFE statistics of one pass over both halves
        model.load_state_dict(init)
        ref = dict(tf32=tf32, flagship=dict(
            global_batch=_as_tensors(global_batch), spread=spread,
            vfe_stats=_vfe_reference(model, global_batch, dev),
            pooled_step=dict(metrics=pooled_step["metrics"],
                             grads=_packed(pooled_step["grads"]),
                             params=_packed(pooled_step["params"]))))
        del model, first, init, ref_step, pooled_step
        if dev == "cuda":
            torch.cuda.empty_cache()
        marks.append(("vfe_reference", time.time()))
        # PointPillars: the feature path over the concatenated batch
        if dev == "cuda":
            _set_tf32(False, False)
        _, pp_batch_fn = build_pointpillars_flagship(tiny=tiny, device=dev)
        pp_batch = pp_batch_fn(spg * DP_WORLD, seed=2)
        pp = _pp_model(dev, tiny, float32=True)
        feats = _pp_feats(pp, pp_batch, dev).float().cpu()
        ref["pp"] = dict(batch=_as_tensors(pp_batch),
                         feats=list(feats.split(spg)),
                         running={n: b.cpu() for n, b in pp.named_buffers()
                                  if "running" in n})
        del pp, feats
        marks.append(("pp_reference", time.time()))
        # the eval reference: a ragged val split, one process
        data = os.path.join(work, "data")
        make_dataset(data, train=1, val=5, points=20000 if tiny else 120000,
                     img_hw=(16, 32), seed=0, classes=LEARN_CLASSES)
        cfg = _dp_eval_cfg(data)
        ev_model = _dp_eval_model(cfg, dev)
        loader = build_dataloader(build_dataset(cfg.data.val),
                                  samples_per_gpu=2, shuffle=False)
        ref["eval"] = dict(data=data, results=single_device_test(
            ev_model, loader, dev), metrics=evaluate_split(
                ev_model, cfg, "val", dev))
        del ev_model
        if dev == "cuda":
            _set_tf32(*tf32)
            torch.cuda.empty_cache()

        marks.append(("eval_reference", time.time()))
        for _ in range(DP_WORLD):
            ranks["refs"].put(ref)
        while not ranks["ctx"].join():
            pass
        del ref
        marks.append(("ranks", time.time()))
        results = []
        for r in range(DP_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                results.append(json.load(f))
    finally:
        stop_dp_ranks(ranks)
    seconds = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    return _dp_report(results, one_rank, one_launches, ms, seconds,
                      ranks["started"], dev)


def _dp_report(ranks, one_rank, one_launches, one_ms, seconds, spawned_at,
               dev) -> dict:
    """Log [dp_train] / [dp_eval] and fail on a check not met.
    ``seconds``: the host seconds of each part of ``phase_dp``; each
    rank's parts are timed from ``spawned_at``."""
    bad = []
    if not one_rank["ok"] or one_rank["allreduce_calls"] != 1 or \
            not one_rank["launches_equal"]:
        bad.append(f"one rank: {one_rank}")
    per_rank = []
    for r, rec in enumerate(ranks):
        f, pp = rec["flagship"], rec["pointpillars"]
        steps = f["same"]["steps"] + f["distinct"]["steps"]
        if not f["same"]["check"]["ok"]:
            bad.append(f"rank {r} identical halves: {f['same']['check']}")
        if f["distinct"]["pmean_err_of_max"] > 1e-6:
            bad.append(f"rank {r} gradient pmean "
                       f"{f['distinct']['pmean_err_of_max']}")
        if f["distinct"]["vfe_stats_err"] > 1e-4:
            bad.append(f"rank {r} VFE statistics "
                       f"{f['distinct']['vfe_stats_err']}")
        if pp["feats_err_of_max"] > 1e-4 or pp["running_err_of_max"] > 1e-4:
            bad.append(f"rank {r} PointPillars feature path {pp}")
        if dev == "cuda" and any(s["launches"] != one_launches
                                 for s in steps):
            bad.append(f"rank {r} launches {[s['launches'] for s in steps]}"
                       f" against one card's {one_launches}")
        finite = [math.isfinite(v) for s in steps + pp["steps"]
                  for v in s["metrics"].values()]
        if not all(finite):
            bad.append(f"rank {r}: a non-finite loss")
        ev = rec["eval"]
        if ev["samples"] != 5 or ev["max_err_of_max"] > 1e-4 or (
                ev["metrics_max_abs_err"] or 0) > 1e-4:
            bad.append(f"rank {r} eval {ev}")
        per_rank.append(dict(
            rank=r,
            step_ms=[s["ms"] for s in f["distinct"]["steps"]],
            identical_halves_step_ms=[s["ms"] for s in f["same"][
                "steps"]],
            identical_halves=f["same"]["check"],
            distinct_halves=[dict(s["metrics"]) for s in f["distinct"][
                "steps"]],
            vfe_running_stats_err_of_max=f["distinct"]["vfe_stats_err"],
            pmean_err_of_max=f["distinct"]["pmean_err_of_max"],
            seconds=dict(f["seconds"], **{
                f"{k}_ended_at": v - spawned_at
                for k, v in rec["ended_at"].items()}),
            allreduce_ms=f["allreduce_ms"],
            allreduce_bytes=f["same"]["allreduce_bytes"],
            sync_bn_collectives_per_step=[s["allreduce_calls"] - 1
                                          for s in steps],
            peak_gib=f.get("peak_gib"),
            launches_per_step=[s["launches"] for s in steps],
            pp=dict(feats_err_of_max=pp["feats_err_of_max"],
                    running_err_of_max=pp["running_err_of_max"],
                    running_buffers=pp["running_buffers"],
                    step_ms=[s["ms"] for s in pp["steps"]],
                    losses=[s["metrics"]["loss"] for s in pp["steps"]],
                    grad_norm=[s["metrics"]["grad_norm"]
                               for s in pp["steps"]],
                    sync_bn_collectives_per_step=[s["allreduce_calls"] - 1
                                                  for s in pp["steps"]],
                    allreduce_bytes=pp["allreduce_bytes"],
                    peak_gib=pp.get("peak_gib"))))
    log("dp_train", ranks=DP_WORLD, backend="gloo, every rank on cuda:0"
        if dev == "cuda" else "gloo on the CPU",
        note="two ranks share one card: step ms is not a scaling figure",
        one_card_step_ms=one_ms,
        one_card_launches=one_launches,
        one_rank=one_rank, seconds=seconds, per_rank=per_rank)
    log("dp_eval", **{f"rank{r}": rec["eval"] for r, rec in
                      enumerate(ranks)})
    if bad:
        raise RuntimeError("dp: " + "; ".join(bad))
    return dict(per_rank=per_rank, one_rank=one_rank)


SCATTER_FIELDS = ("P", "C", "S", "ms", "device_ms", "fwd_bwd_ms",
                  "bwd_device_ms", "plain_ms", "library_ms", "bound_ms",
                  "backward_bound_ms")


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
    launches, stage, serve_req = phase_main_path(model, batch)
    # K10 serves the assigner: it is on the train path, not this one
    missing = [k for k in PREDICT_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: "
                           f"{missing}")
    check_no_layout_builds("serve", launches)
    rec = phase_kernel_check(stage)
    dyn_serve = dynamic_check("serve", serve_req.pop("dynamic_inputs"))
    bwd = phase_backward_check(*stage["stage0"])
    del stage
    torch.cuda.empty_cache()
    phase_breakdown(model, batch)
    phase_precision_gap(model, batch)
    phase_reference_check()
    train = phase_train(model, train_batch(
        batch_fn, flagship_optim_cfg()["samples_per_gpu"]))
    check_no_layout_builds("train", train["launches"])
    del model
    torch.cuda.empty_cache()
    iou = phase_iou_check(train.pop("iou_inputs"))
    dyn_train = dynamic_check("train", train.pop("dynamic_inputs"))
    torch.cuda.empty_cache()
    phase_train_reference()
    torch.cuda.empty_cache()
    isfusion_learn = phase_isfusion_learn(nvidia_smi=smi)
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
    eval_in, random_in, learn = phase_learn()
    nms = phase_pp_kernel_check(nms_in, untamed=untamed, eval_sets=[
        ("eval",) + tuple(eval_in), ("eval_random",) + tuple(random_in)])
    del nms_in, untamed, eval_in, random_in
    phase_pp_train(pp, pp_batch_fn(pointpillars_optim_cfg()[
        "samples_per_gpu"]))
    del pp
    torch.cuda.empty_cache()
    phase_pp_reference()

    per_step = train["launches_per_step"]
    from isfusion_tpu_torch.flagship import (build_centerpoint,
                                             centerpoint_optim_cfg)
    cp, cp_batch_fn = build_centerpoint(device="cuda", seed=0)
    cp_launches, circle_in, cp_req = phase_cp_main_path(cp, cp_batch_fn(1))
    circle_eval_in = record_cp_eval_sets(cp, cp_batch_fn(4, seed=1), "cuda")
    cp_train = phase_cp_train(cp, cp_batch_fn(centerpoint_optim_cfg()[
        "samples_per_gpu"]))
    del cp
    torch.cuda.empty_cache()
    cp_rec = phase_cp_kernel_check(circle_in, circle_eval_in, [
        ("cp_train", cp_train["heatmap_inputs"]),
        ("flagship_train", train["heatmap_inputs"])], launches=dict(
            nms_circle_per_request=[r["nms_circle"] for r in cp_req[
                "launches_per_request"]],
            gaussian_heatmap_per_cp_step=[s["gaussian_heatmap"] for s in
                                          cp_train["launches_per_step"]],
            gaussian_heatmap_per_flagship_step=per_step[
                "gaussian_heatmap"]))
    del circle_in, circle_eval_in
    phase_cp_reference()
    torch.cuda.empty_cache()

    from isfusion_tpu_torch.flagship import build_mvxnet, mvxnet_optim_cfg
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import even_class_prior
    mvx, mvx_batch_fn = build_mvxnet(device="cuda", seed=0)
    # random weights score every anchor near the focal prior's 0.01, under
    # the 0.1 threshold, and regress boxes wider than the scene: serve
    # (and train) with an even class prior and scene-sized boxes, so that
    # NMS sees full candidate sets
    even_class_prior(tame_box_deltas(mvx))
    mvx_launches, mvx_seen, mvx_req = phase_mvx_main_path(mvx,
                                                          mvx_batch_fn(1))
    mvx.pts_bbox_head.reset_special_parameters()   # the focal prior back
    check_no_layout_builds("mvx-serve", mvx_launches)
    mvx_train = phase_mvx_train(mvx, mvx_batch_fn(mvxnet_optim_cfg()[
        "samples_per_gpu"]))
    check_no_layout_builds("mvx-train", cuda_build.LAUNCHES)
    mvx_train.pop("dynamic_inputs")
    del mvx
    torch.cuda.empty_cache()
    mvx_dyn = phase_mvx_kernel_check(mvx_seen)
    del mvx_seen
    phase_mvx_reference()
    torch.cuda.empty_cache()

    run_fcos_phases()
    torch.cuda.empty_cache()
    # the DP ranks start, build and warm up during the variants, which
    # time nothing
    dp_ranks = start_dp_ranks()
    try:
        variants = phase_lidar_variants()
        torch.cuda.empty_cache()
        dp = phase_dp(dp_ranks)
    finally:
        stop_dp_ranks(dp_ranks)

    def on_variants(kernel):
        """Each LiDAR variant's launches of ``kernel`` (predict, train)."""
        return {v: dict(predict=r["launches"]["predict"].get(kernel),
                        train=r["launches"]["train"].get(kernel),
                        max_abs_err=r["kernel_checks"].get(
                            kernel, {}).get("max_abs_err"))
                for v, r in variants.items()
                if kernel in r["launches"]["train"]}

    kernels = [dict(
        name="masked_gather", route="cuda",
        source="isfusion_tpu_torch/csrc/masked_gather.cu",
        replaces="tools/analysis_tools/micro_dma_gather.py:25",
        launches=launches["masked_gather"],
        cp_launches_per_request=[r["masked_gather"] for r in cp_req[
            "launches_per_request"]],
        cp_train_launches_per_step=[dict(
            forward=s["masked_gather_forward"],
            backward=s["masked_gather_backward"])
            for s in cp_train["launches_per_step"]],
        max_abs_err=max(rec["max_abs_err"], bwd["max_abs_err"]),
        ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by="bytes", library_ms=rec["library_ms"],
        launches_per_request=launches["masked_gather"] // N_REQUESTS,
        train_launches_per_step=dict(
            forward=per_step["masked_gather_forward"],
            backward=per_step["masked_gather_backward"]),
        isfusion_learn_launches_per_step=dict(
            forward=isfusion_learn["launches_per_step"][
                "masked_gather_forward"],
            backward=isfusion_learn["launches_per_step"][
                "masked_gather_backward"]),
        backward=dict(ms=bwd["ms"], plain_ms=bwd["plain_ms"],
                      bound_ms=bwd["bound_ms"],
                      library_ms=bwd["library_ms"])),
        dict(name="boxes_iou_3d", route="cuda",
             source="isfusion_tpu_torch/csrc/boxes_iou_3d.cu",
             replaces="isfusion_tpu/ops/box_ops.py:180",
             launches=train["launches"]["boxes_iou_3d"],
             max_abs_err=iou["max_abs_err"], ms=iou["ms"],
             plain_ms=iou["plain_ms"], bound_ms=iou["bound_ms"],
             bound_by=iou["bound_by"], library_ms=None,
             train_launches_per_step=per_step["boxes_iou_3d"],
             isfusion_learn_launches_per_step=isfusion_learn[
                 "launches_per_step"]["boxes_iou_3d"],
             **{k: iou[k] for k in (
                 "shape", "row_strides", "device_ms", "kernel_device_ms",
                 "all_pairs_bound_ms", "cut_by_z", "cut_by_circle",
                 "nonzero_where_plain_zero", "launch_floor")},
             device_ops_per_call=sum(iou["device_ops_per_call"].values()),
             test_boxes={k: iou["test_boxes"][k] for k in (
                 "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                 "all_pairs_bound_ms", "per_sample_launches_ms")}),
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
             greedy_device_ms=nms["greedy_device_ms"],
             learn_train_launches=learn["train_launches"]["nms_bev"],
             learn_eval_launches=learn["nms_launches"],
             learn_eval_batches=learn["batches"],
             eval_shape={k: v for k, v in nms["eval_shape"].items()
                         if k != "device_ops_per_call"}),
        dict(name="nms_circle", route="cuda",
             source="isfusion_tpu_torch/csrc/nms_circle.cu",
             replaces="isfusion_tpu/ops/box_ops.py:243",
             launches=cp_launches["nms_circle"],
             max_abs_err=float(cp_rec["request"]["keep_flags_differ"]),
             ms=cp_rec["request"]["ms"], plain_ms=cp_rec["request"][
                 "plain_ms"], bound_ms=cp_rec["request"]["bound_ms"],
             bound_by=cp_rec["request"]["bound_by"], library_ms=None,
             launches_per_request=[r["nms_circle"] for r in cp_req[
                 "launches_per_request"]],
             device_ms=cp_rec["request"]["device_ms"],
             kernel_device_ms=cp_rec["request"]["kernel_device_ms"],
             device_ops_per_call=sum(cp_rec["request"][
                 "device_ops_per_call"].values()),
             launch_floor=cp_rec["launch_floor"],
             eval_shape={k: v for k, v in cp_rec["eval"].items()
                         if k != "device_ops_per_call"},
             shuffled_request={k: cp_rec["request_shuffled"][k] for k in (
                 "ms", "device_ms", "bound_ms")}),
        dict(name="gaussian_heatmap", route="cuda",
             source="isfusion_tpu_torch/csrc/gaussian_heatmap.cu",
             replaces="isfusion_tpu/ops/gaussian.py:65",
             launches=sum(s["gaussian_heatmap"] for s in cp_train[
                 "launches_per_step"]),
             max_abs_err=max(cp_rec[k]["max_abs_err"]
                             for k in ("cp_train", "flagship_train")),
             ms=cp_rec["cp_train"]["ms"],
             plain_ms=cp_rec["cp_train"]["plain_ms"],
             bound_ms=cp_rec["cp_train"]["bound_ms"],
             bound_by=cp_rec["cp_train"]["bound_by"], library_ms=None,
             device_ms=cp_rec["cp_train"]["device_ms"],
             cp_train_launches_per_step=[s["gaussian_heatmap"] for s in
                                         cp_train["launches_per_step"]],
             train_launches_per_step=per_step["gaussian_heatmap"],
             flagship_train_shape=cp_rec["flagship_train"]),
        dict(name="dynamic_voxelize", route="cuda",
             source="isfusion_tpu_torch/csrc/dynamic_voxelize.cu",
             replaces="isfusion_tpu/ops/voxel.py:125",
             launches=launches["dynamic_voxelize"],
             max_abs_err=max(r["voxelize"]["max_abs_err"] for r in (
                 dyn_serve, dyn_train, mvx_dyn)),
             **{k: dyn_serve["voxelize"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "device_ms", "sort_ms", "points", "voxels", "design_bytes",
                 "max_points_per_voxel", "mean_points_per_voxel")},
             launches_per_request=[r["dynamic_voxelize"] for r in serve_req[
                 "launches_per_request"]],
             train_launches_per_step=per_step["dynamic_voxelize"],
             train_shape={k: dyn_train["voxelize"][k] for k in (
                 "points", "voxels", "ms", "device_ms", "plain_ms",
                 "library_ms", "sort_ms", "bound_ms",
                 "max_points_per_voxel")},
             mvx_launches_per_request=[r["dynamic_voxelize"] for r in
                                       mvx_req["launches_per_request"]],
             mvx_train_launches_per_step=[s["dynamic_voxelize"] for s in
                                          mvx_train["launches_per_step"]],
             mvx_shape={k: mvx_dyn["voxelize"][k] for k in (
                 "points", "voxels", "ms", "device_ms", "plain_ms",
                 "library_ms", "sort_ms", "bound_ms",
                 "max_points_per_voxel")}),
        dict(name="dynamic_scatter", route="cuda",
             source="isfusion_tpu_torch/csrc/dynamic_scatter.cu",
             replaces="isfusion_tpu/ops/voxel.py:169",
             launches=launches["dynamic_scatter"],
             max_abs_err=max(r[k]["max_abs_err"] for r in (
                 dyn_serve, dyn_train, mvx_dyn) for k in r
                 if r[k]["kernel"] == "dynamic_scatter"),
             **{k: dyn_serve["max64"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "device_ms", "P", "C", "S", "fwd_bwd_ms", "bwd_device_ms",
                 "backward_bound_ms")},
             layout_builds_on_path=launches["segment_layout"],
             mean=dict({k: dyn_serve["mean"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
                 "err_of_max", "equal_to_cpu", "repeats",
                 "plain_on_card_repeats")}),
             launches_per_request=[r["dynamic_scatter"] for r in serve_req[
                 "launches_per_request"]],
             train_launches_per_step=dict(
                 forward=per_step["dynamic_scatter_forward"],
                 backward=per_step["dynamic_scatter_backward"]),
             mvx_launches_per_request=[r["dynamic_scatter"] for r in
                                       mvx_req["launches_per_request"]],
             mvx_train_launches_per_step=[dict(
                 forward=s["dynamic_scatter_forward"],
                 backward=s["dynamic_scatter_backward"])
                 for s in mvx_train["launches_per_step"]],
             train_shape={k: {f: v[f] for f in SCATTER_FIELDS if f in v}
                          for k, v in dyn_train.items()
                          if v["kernel"] == "dynamic_scatter"},
             mvx_shape={k: {f: v[f] for f in SCATTER_FIELDS if f in v}
                        for k, v in mvx_dyn.items()
                        if v["kernel"] == "dynamic_scatter"})]
    dp_keys = dict(masked_gather=("masked_gather_forward",
                                  "masked_gather_backward"),
                   dynamic_voxelize=("dynamic_voxelize",),
                   dynamic_scatter=("dynamic_scatter_forward",
                                    "dynamic_scatter_backward"),
                   gaussian_heatmap=("gaussian_heatmap",),
                   boxes_iou_3d=("boxes_iou_3d",))
    for k in kernels:
        if k["name"] in dp_keys:
            # per rank, per DP step: [dp_train]'s flagship steps
            k["dp_launches_per_step"] = [
                [{n: s[n] for n in dp_keys[k["name"]]}
                 for s in r["launches_per_step"]] for r in dp["per_rank"]]
        k["lidar_variants"] = on_variants(k["name"])
        errs = [r["max_abs_err"] for r in k["lidar_variants"].values()
                if r["max_abs_err"] is not None]
        k["max_abs_err"] = max([k["max_abs_err"]] + errs)
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


def dynamic_times(seen: dict) -> dict:
    """K1 and K2 on one forward's recorded inputs (``recording_dynamic``,
    with the lists that forward passed, if any): CUDA-event and device ms
    (profiler, every device operation of one call) of the voxelization,
    the mean and each max, the device ms of each max's backward kernels,
    and the device ms of all K1 and K2 calls of one forward (``fwd``) and
    of one train step (``fwd_bwd``: the maxima's backwards too)."""
    import torch
    from isfusion_tpu_torch.ops import scatter, voxel

    pts, mask, pcr, vs = seen["voxelize"]
    r = dict(k1_ms=cuda_ms(lambda: voxel.voxelize_dynamic(pts, mask, pcr,
                                                          vs)),
             k1_device_ms=device_ms_per_call(
                 lambda: voxel.voxelize_dynamic(pts, mask, pcr, vs)))
    fwd = r["k1_device_ms"] * seen["calls"]["voxelize"]
    bwd = 0.0
    gen = torch.Generator().manual_seed(21)
    for key in sorted(k for k in seen if k == "mean" or k.startswith("max")):
        data, ids, n, layout = seen[key]
        args = () if layout is None else (layout,)
        fn = getattr(scatter, "segment_mean" if key == "mean" else
                     "segment_max")
        r[f"{key}_ms"] = cuda_ms(lambda: fn(data, ids, n, *args))
        r[f"{key}_device_ms"] = device_ms_per_call(
            lambda: fn(data, ids, n, *args))
        fwd += r[f"{key}_device_ms"] * seen["calls"][key]
        if key == "mean":
            continue
        g = torch.randn((n, data.shape[1]), generator=gen).to(data.device)

        def backward():
            x = data.clone().requires_grad_(True)
            fn(x, ids, n, *args).backward(g)

        ops = device_kernels(backward, 20)
        r[f"{key}_bwd_device_ms"] = sum(
            k * ms for name, (k, ms) in ops.items()
            if "ties_kernel" in name or "max_grad_kernel" in name)
        bwd += r[f"{key}_bwd_device_ms"] * seen["calls"][key]
    r.update(calls=seen["calls"], fwd_device_ms=fwd,
             fwd_bwd_device_ms=fwd + bwd)
    return r


def dynamic_compare(tree: str, requests: int = 20, steps: int = 10) -> int:
    """``python3 chip_smoke.py --dynamic TREE``: the four cells that run
    K1 and K2 — the flagship's serve (batch 1) and train (batch 4) and
    MVX-Net's (batch 1, batch 2) — with the port imported from the
    checkout TREE, to compare two checkouts on one card in one call (run
    them in the order A, B, B, A). Each cell: one warm-up under
    ``recording_dynamic``, then ``requests`` requests or ``steps`` steps
    (host-clock median, min, max), then ``dynamic_times`` on the
    warm-up's K1 and K2 inputs. Prints one JSON record."""
    import torch
    smi = phase_device()
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import isfusion_tpu_torch
    from isfusion_tpu_torch.flagship import (build_isfusion_flagship,
                                             build_mvxnet,
                                             flagship_optim_cfg,
                                             mvxnet_optim_cfg)
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)
    from isfusion_tpu_torch.testing import even_class_prior, tame_box_deltas
    if not isfusion_tpu_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"isfusion_tpu_torch imported from "
                           f"{isfusion_tpu_torch.__file__}, not {tree}")
    rec = dict(tree=tree, nvidia_smi=smi, build_s=cuda_build.build_all(),
               libraries=[cuda_build._lib_path(n).name for n in (
                   "dynamic_voxelize", "dynamic_scatter")])

    def timed(label, run, n):
        with recording_dynamic() as seen:
            run(0)
            sync("cuda")
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            run(i + 1)
            sync("cuda")
            times.append((time.perf_counter() - t0) * 1e3)
        rec[label] = dict(median_ms=statistics.median(times),
                          min_ms=min(times), max_ms=max(times),
                          **dynamic_times(seen))

    def stepper(model, cfg, momentum):
        model.train()
        opt = build_optimizer(model, cfg["optimizer"])
        step = make_train_step(
            model, opt, build_schedule(opt, cfg["lr_config"], momentum),
            grad_clip_norm(cfg["optimizer_config"]))
        return step, torch.Generator("cuda").manual_seed(0)

    model, batch_fn = build_isfusion_flagship(device="cuda", seed=0)
    batch = batch_fn(1)
    timed("serve", lambda i: model(jittered(batch, i), device="cuda"),
          requests)
    cfg = flagship_optim_cfg()
    tb = train_batch(batch_fn, cfg["samples_per_gpu"])
    step, gen = stepper(model, cfg, cfg["momentum_config"])
    timed("train", lambda i: step(jittered(tb, i), gen), steps)
    del model, step
    torch.cuda.empty_cache()
    mvx, mvx_batch_fn = build_mvxnet(device="cuda", seed=0)
    even_class_prior(tame_box_deltas(mvx))
    mb = mvx_batch_fn(1)
    timed("mvx_serve", lambda i: mvx(jittered(mb, i), device="cuda"),
          requests)
    mvx.pts_bbox_head.reset_special_parameters()
    cfg = mvxnet_optim_cfg()
    mtb = mvx_batch_fn(cfg["samples_per_gpu"])
    step, gen = stepper(mvx, cfg, None)
    timed("mvx_train", lambda i: step(jittered(mtb, i), gen), steps)
    log("dynamic_compare", **rec)
    return 0


def boxes_compare(tree: str, requests: int = 20, steps: int = 10) -> int:
    """``python3 chip_smoke.py --boxes TREE``: the cells of K10-circle and
    K10 with the port imported from the checkout TREE, to compare two
    checkouts on one card in one call (run them in the order A, B, B, A):
    cp-serve (one warm-up recording K10-circle's inputs, ``requests``
    timed requests) and the flagship's train step at batch 4 (one warm-up
    recording K10's inputs, ``steps`` timed steps), host-clock median, min
    and max; then each kernel on the warm-up's inputs (K10-circle also on
    an eval batch's 24 sets, K10 also on ``testing.iou_test_boxes``):
    CUDA-event ms and whole-call device ms and operations (profiler);
    K10-NMS's two passes on ``testing.nms_scene_set`` (unchanged code:
    their spread); the tree's ``ptxas -v`` registers, stack and spills of
    both sources; the floor of an empty launch where the tree has one.
    Prints one JSON record."""
    import torch
    smi = phase_device()
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import isfusion_tpu_torch
    from isfusion_tpu_torch.flagship import (build_centerpoint,
                                             build_isfusion_flagship,
                                             flagship_optim_cfg)
    from isfusion_tpu_torch.ops import box_ops, cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)
    if not isfusion_tpu_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"isfusion_tpu_torch imported from "
                           f"{isfusion_tpu_torch.__file__}, not {tree}")
    names = ("boxes_iou_3d", "nms_circle", "nms_bev")
    rec = dict(tree=tree, nvidia_smi=smi, build_s=cuda_build.build_all(),
               libraries=[cuda_build._lib_path(n).name for n in names],
               ptxas={n: cuda_build.ptxas_usage(cuda_build.CSRC_DIR /
                                                f"{n}.cu")
                      for n in names[:2]})
    if "empty_launch" in cuda_build.SIGNATURES:
        rec["launch_floor"] = launch_floor()

    def timed(run, n):
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            run(i + 1)
            sync("cuda")
            times.append((time.perf_counter() - t0) * 1e3)
        return dict(median_ms=statistics.median(times), min_ms=min(times),
                    max_ms=max(times))

    def kernel_times(fn):
        ops = device_kernels(fn, iters=50)
        return dict(ms=cuda_ms(fn, iters=200),
                    device_ms=sum(n * ms for n, ms in ops.values()),
                    device_ops_per_call=sum(n for n, _ in ops.values()))

    cp, cp_batch_fn = build_centerpoint(device="cuda", seed=0)
    batch = cp_batch_fn(1)
    with recording_circle_nms() as seen:
        cp(jittered(batch, 0), device="cuda")
        sync("cuda")
    rec["cp_serve"] = timed(lambda i: cp(jittered(batch, i), device="cuda"),
                            requests)
    eval_in = record_cp_eval_sets(cp, cp_batch_fn(4, seed=1), "cuda")
    del cp
    torch.cuda.empty_cache()
    for label, (c, sc, v, t) in (("circle_request", seen[0]),
                                 ("circle_eval", eval_in)):
        rec[label] = dict(R=c.shape[0], K=c.shape[1], **kernel_times(
            lambda: box_ops.circle_nms_mask(c, sc, t, v)))

    model, batch_fn = build_isfusion_flagship(device="cuda", seed=0)
    cfg = flagship_optim_cfg()
    tb = train_batch(batch_fn, cfg["samples_per_gpu"])
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(
        model, opt, build_schedule(opt, cfg["lr_config"],
                                   cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator("cuda").manual_seed(0)
    with recording_iou() as iou_in:
        step(jittered(tb, 0), gen)
        sync("cuda")
    rec["train"] = timed(lambda i: step(jittered(tb, i), gen), steps)
    del model, step, opt
    torch.cuda.empty_cache()
    a, b = iou_in[0]
    rec["iou_train"] = dict(shape=[list(a.shape), list(b.shape)],
                            **kernel_times(lambda: box_ops.boxes_iou_3d(a,
                                                                        b)))
    # the box sets of this checkout's testing module, whatever TREE holds
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_testing", os.path.join(REPO, "isfusion_tpu_torch",
                                           "testing.py"))
    testing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(testing)
    g = torch.Generator().manual_seed(2)
    sets = [testing.iou_test_boxes(g) for _ in range(4)]
    ta = torch.stack([x[0] for x in sets]).cuda()
    tb7 = torch.stack([x[1] for x in sets]).cuda()
    rec["iou_test_boxes"] = kernel_times(lambda: box_ops.boxes_iou_3d(ta,
                                                                      tb7))
    boxes, scores, valid = (x.cuda() for x in testing.nms_scene_set(
        torch.Generator().manual_seed(3)))
    ops = device_kernels(lambda: box_ops.nms_bev_mask(boxes, scores, 0.2,
                                                      valid), iters=50)
    rec["nms_bev_scene"] = dict(
        pairwise_device_ms=kernel_ms(ops, "nms_mask_kernel"),
        greedy_device_ms=kernel_ms(ops, "nms_greedy_kernel"))
    log("boxes_compare", **rec)
    return 0


def dp_run() -> int:
    """``python3 chip_smoke.py --dp``: the device and build phases, then
    ``phase_dp`` alone."""
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    dp_ranks = start_dp_ranks()
    try:
        phase_dp(dp_ranks)
    finally:
        stop_dp_ranks(dp_ranks)
    print(smi)
    return 0


def isfusion_learn_run() -> int:
    """``python3 chip_smoke.py --isfusion-learn``: the device and build
    phases, then ``phase_isfusion_learn`` alone."""
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    phase_isfusion_learn(nvidia_smi=smi)
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--fcos"]:
        sys.exit(fcos_run())
    if sys.argv[1:] == ["--isfusion-learn"]:
        sys.exit(isfusion_learn_run())
    if sys.argv[1:] == ["--dp"]:
        sys.exit(dp_run())
    if sys.argv[1:2] == ["--learn"] and len(sys.argv) == 3:
        sys.exit(learn_run(sys.argv[2]))
    if sys.argv[1:2] == ["--dynamic"] and len(sys.argv) == 3:
        sys.exit(dynamic_compare(sys.argv[2]))
    if sys.argv[1:2] == ["--boxes"] and len(sys.argv) == 3:
        sys.exit(boxes_compare(sys.argv[2]))
    if sys.argv[1:2] == ["--pp-serve"]:
        sys.exit(pp_serve_timing(sys.argv[2] if len(sys.argv) > 2 else REPO))
    sys.exit(main())
