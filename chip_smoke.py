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
   the phase fails unless every kernel launched;
4. kernel check: each kernel against its plain PyTorch version on the
   inputs the main path gave it (stage-0 and stage-1 im2col gathers) and
   on the TPU microbenchmark's shape, bit for bit, with timings;
5. breakdown: one request with CUDA events around each top-level module,
   one under torch.profiler (device busy share, top kernels);
6. precision gap: the same request with every compute dtype float32 (TF32
   off) against the bfloat16 run (reported, not asserted);
7. reference check: the tiny flagship on the card against the same model
   on the CPU (the kernels' plain versions), float32.

The line before the last is the kernels' JSON record, the last line is
``{"ok": true, "device": {...}}``.
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
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
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
    # warm-up: the main path's own stage-0/1 im2col inputs
    real_gather = sparse_conv.masked_gather
    seen = {}

    def recording_gather(src, idx, fmask):
        key = tuple(src.shape)
        if key not in seen:
            seen[key] = (src.clone(), idx.clone(), fmask.clone())
        return real_gather(src, idx, fmask)

    sparse_conv.masked_gather = recording_gather
    try:
        stats = {}
        model(jittered(batch, 0), device=dev, stats=stats)
        sync(dev)
    finally:
        sparse_conv.masked_gather = real_gather
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


def main() -> int:
    import torch
    if not os.path.isdir(os.path.join(REPO, "isfusion_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(isfusion_tpu_torch/ not found)")
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    from isfusion_tpu_torch.flagship import build_isfusion_flagship
    model, batch_fn = build_isfusion_flagship(device="cuda", seed=0)
    batch = batch_fn(1)
    launches, stage, _ = phase_main_path(model, batch)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: "
                           f"{missing}")
    rec = phase_kernel_check(stage)
    del stage
    torch.cuda.empty_cache()
    phase_breakdown(model, batch)
    phase_precision_gap(model, batch)
    phase_reference_check()
    kernels = [dict(
        name="masked_gather", route="cuda",
        source="isfusion_tpu_torch/csrc/masked_gather.cu",
        replaces="tools/analysis_tools/micro_dma_gather.py:25",
        launches=launches["masked_gather"],
        max_abs_err=rec["max_abs_err"], ms=rec["ms"],
        plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by="bytes", library_ms=rec["library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
