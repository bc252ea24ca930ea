"""The rank side of ``tests/test_torch_parallel.py``: every case of the
port's data-parallel slice, run by two processes spawned on the CPU under
gloo. The module imports neither JAX nor the JAX package, so a spawned
rank never loads them; the test process draws the shared inputs from the
same functions, runs the JAX package and the one-process references, and
compares.

``run_ranks(cases, world_size, work)`` starts the ranks (``work``: a
directory for the group's init file and each rank's ``rank{r}.pt``) and
returns the process context; ``rank_results(work, world_size)`` loads
what each rank saved. Each case is a function ``(rank, size, arg) ->
dict`` of ``CASES``.
"""
import copy
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from isfusion_tpu_torch import flagship
from isfusion_tpu_torch.apis import single_device_test, train_model
from isfusion_tpu_torch.config import Config
from isfusion_tpu_torch.datasets import build_dataset
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.layers import BatchNorm, MaskedBatchNorm
from isfusion_tpu_torch.parallel.mesh import gather_objects, shard_batch
from isfusion_tpu_torch.parallel.train_step import make_train_step
from isfusion_tpu_torch.runner import optim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARN_CFG = os.path.join(REPO, "configs", "pointpillars",
                         "hv_pointpillars_learnability_syn.py")
BN_EPS, BN_MOMENTUM = 1e-3, 0.01


def tiny_learn_cfg(data_root: str) -> Config:
    """The learnability config at tiny width: 6.4 m pillars over +-51.2 m
    (16 x 16 after the first SECOND stride), SECOND 16/32/64, 4,096
    points, its nms_pre 256 and max_num 100; 2 epochs of batch 4, eval and
    checkpoint every epoch, every step logged."""
    cfg = Config.fromfile(LEARN_CFG)
    vs = [3.2, 3.2, 8]
    m = cfg.model
    m.pts_voxel_layer.update(voxel_size=vs, max_num_points=8,
                             max_voxels=(1024, 1024))
    m.pts_voxel_encoder.update(feat_channels=[16], voxel_size=vs)
    m.pts_middle_encoder.update(in_channels=16, output_shape=[32, 32])
    m.pts_backbone.update(in_channels=16, out_channels=[16, 32, 64],
                          layer_nums=[1, 1, 1])
    m.pts_neck.update(in_channels=[16, 32, 64], out_channels=[16, 16, 16])
    m.pts_bbox_head.update(in_channels=48, feat_channels=48)
    for split in ("train", "val", "test"):
        ann = "train" if split == "train" else "val"
        d = cfg.data[split]
        d.update(data_root=data_root, ann_file=os.path.join(
            data_root, f"nuscenes_infos_{ann}.pkl"))
        for t in d.pipeline:
            if t["type"] == "DefaultFormatBundle3D":
                t["max_points"] = 4096
    cfg.data.workers_per_gpu = 0
    cfg.total_epochs = 2
    cfg.runner.max_epochs = 2
    cfg.evaluation = dict(interval=1)
    cfg.checkpoint_config = dict(interval=1)
    cfg.log_config = dict(interval=1)
    cfg.seed = 0
    return cfg


def plain_norms(cfg):
    """A model config with every synced norm type made plain BN."""
    if isinstance(cfg, dict):
        out = {k: plain_norms(v) for k, v in cfg.items()}
        if "sync" in str(out.get("type", "")).lower():
            out["type"] = "BN1d"
        return out
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(plain_norms(v) for v in cfg)
    return cfg


# ------------------------------------------------------------- inputs
def bn_inputs(seed: int = 0) -> dict:
    """Global inputs of the sync-BN cases (2 ranks): an NHWC map (4, 3,
    5, 8); a padded (4, 16, 8) buffer whose two halves keep 80% and 25%
    of their rows; active-site rows of 37 and 11 sites; an output
    cotangent for each; the norms' parameters and running statistics."""
    rng = np.random.default_rng(seed)
    f = np.float32
    nhwc = (rng.normal(size=(4, 3, 5, 8)) * 2 + 0.5).astype(f)
    padded = (rng.normal(size=(4, 16, 8)) * 3 + 1).astype(f)
    keep = rng.uniform(size=(4, 16))
    mask = np.concatenate([keep[:2] < 0.8, keep[2:] < 0.25])
    sites = [(rng.normal(size=(n, 8)) * 1.5 - 0.3).astype(f)
             for n in (37, 11)]
    return dict(
        nhwc=nhwc, nhwc_ct=rng.normal(size=nhwc.shape).astype(f),
        padded=padded, mask=mask,
        padded_ct=rng.normal(size=padded.shape).astype(f),
        sites=sites, sites_ct=[rng.normal(size=s.shape).astype(f)
                               for s in sites],
        weight=rng.uniform(0.5, 1.5, 8).astype(f),
        bias=rng.normal(0, 0.1, 8).astype(f),
        running_mean=rng.normal(0, 0.5, 8).astype(f),
        running_var=rng.uniform(0.5, 2.0, 8).astype(f))


def make_bn(kind, inp: dict, sync: bool) -> BatchNorm:
    bn = kind(8, eps=BN_EPS, momentum=BN_MOMENTUM, sync=sync)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(inp[k]))
    return bn.train()


def run_bn(bn: BatchNorm, x: np.ndarray, ct: np.ndarray, mask=None) -> dict:
    """Output, input / weight / bias gradients of sum(out * ct) and the
    running statistics after one train-mode forward."""
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt) if mask is None else bn(xt, torch.from_numpy(mask))
    (y * torch.from_numpy(ct)).sum().backward()
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(),
                dw=bn.weight.grad.numpy().copy(),
                db=bn.bias.grad.numpy().copy(),
                running_mean=bn.running_mean.numpy().copy(),
                running_var=bn.running_var.numpy().copy())


def bn_case(rank: int, size: int, _arg) -> dict:
    inp = bn_inputs()
    lo, hi = 2 * rank, 2 * rank + 2
    out = dict(
        nhwc=run_bn(make_bn(BatchNorm, inp, True), inp["nhwc"][lo:hi],
                    inp["nhwc_ct"][lo:hi]),
        masked=run_bn(make_bn(MaskedBatchNorm, inp, True),
                      inp["padded"][lo:hi], inp["padded_ct"][lo:hi],
                      inp["mask"][lo:hi]),
        sites=run_bn(make_bn(BatchNorm, inp, True), inp["sites"][rank],
                     inp["sites_ct"][rank]))
    # identical halves of the masked norm: the one-rank arithmetic, bit
    # for bit (the halves' sums double exactly)
    out["masked_same"] = run_bn(make_bn(MaskedBatchNorm, inp, True),
                                inp["padded"][:2], inp["padded_ct"][:2],
                                inp["mask"][:2])
    return out


# ------------------------------------------------------- the train steps
def tiny_flagship(sync: bool):
    """The tiny flagship (dropout off) with the config's norms, or with
    every norm plain BN; its global batch of 4 samples."""
    from isfusion_tpu_torch.models.layers import init_weights
    cfg = flagship.flagship_model_cfg(tiny=True, dropout=False)
    if not sync:
        cfg = plain_norms(cfg)
    model = init_weights(build_detector(cfg), 0).train()
    _, batch_fn = flagship.build_isfusion_flagship(tiny=True, device="cpu",
                                                   dropout=False)
    return model, batch_fn(4, seed=3)


def flagship_step(model):
    """A flagship recipe step (AdamW, cyclic lr and momentum, clip) on
    ``model``: data-parallel in a rank, one card in the test process."""
    cfg = flagship.flagship_optim_cfg()
    opt = optim.build_optimizer(model, cfg["optimizer"])
    sched = optim.build_schedule(opt, cfg["lr_config"],
                                 cfg["momentum_config"], total_steps=100)
    return opt, sched, make_train_step(
        model, opt, sched, optim.grad_clip_norm(cfg["optimizer_config"]))


def _numpy(batch: dict) -> dict:
    return {k: np.asarray(v) for k, v in batch.items()}


def step_result(model, metrics: dict) -> dict:
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                params={n: p.detach().clone() for n, p in
                        model.named_parameters()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                buffers={n: b.clone() for n, b in model.named_buffers()})


def take_step(model, batch) -> dict:
    _, _, step = flagship_step(model)
    metrics = step(_numpy(batch), torch.Generator().manual_seed(0))
    return step_result(model, metrics)


def flagship_case(rank: int, size: int, _arg) -> dict:
    out = {}
    # identical halves, every norm plain and the config's synced VFE norm
    # (the one-card steps run in the test process)
    plain, batch = tiny_flagship(sync=False)
    half = shard_batch(_numpy(batch), 0, size)
    out["same_plain"] = take_step(copy.deepcopy(plain), half)
    synced, _ = tiny_flagship(sync=True)
    out["same_synced"] = take_step(synced, half)
    # distinct halves, every norm plain: the mean of the ranks' one-card
    # gradients and losses, then clip + AdamW
    own = shard_batch(_numpy(batch), rank, size)
    one = copy.deepcopy(plain)
    losses = one(own, mode="loss", device="cpu",
                 generator=torch.Generator().manual_seed(0))
    sum(v.sum() for k, v in losses.items() if "loss" in k).backward()
    mine = dict(losses={k: float(v.detach()) for k, v in losses.items()},
                grads={n: p.grad.clone() for n, p in one.named_parameters()
                       if p.grad is not None})
    every = gather_objects(mine)
    oracle = copy.deepcopy(plain)
    opt, sched, _ = flagship_step(oracle)
    sched.apply(0)
    opt.zero_grad(set_to_none=True)
    grads = []
    for n, p in oracle.named_parameters():
        got = [r["grads"][n] for r in every if n in r["grads"]]
        if got:
            p.grad = sum(got + [torch.zeros_like(p)] * (size - len(got))) \
                / size
            grads.append(p.grad)
    cfg = flagship.flagship_optim_cfg()
    norm = optim.clip_by_global_norm(grads, optim.grad_clip_norm(
        cfg["optimizer_config"]))
    opt.step()
    out["distinct_oracle"] = dict(
        losses={k: float(np.mean([r["losses"][k] for r in every]))
                for k in every[0]["losses"]},
        grad_norm=float(norm),
        params={n: p.detach().clone() for n, p in oracle.named_parameters()},
        grads={n: p.grad.clone() for n, p in oracle.named_parameters()
               if p.grad is not None})
    out["distinct_dp"] = take_step(copy.deepcopy(plain), own)
    return out


def lidar_case(rank: int, size: int, arg) -> dict:
    """The tiny PointPillars (plain norms) from the carried weights
    ``arg['state_dict']``, one DP step on rank ``rank``'s rows of
    ``arg['batch']`` with SGD(lr 1) and the recipe's clip."""
    cfg = plain_norms(flagship.pointpillars_model_cfg(tiny=True))
    model = build_detector(cfg)
    model.load_state_dict(arg["state_dict"])
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    clip = optim.grad_clip_norm(flagship.pointpillars_optim_cfg()[
        "optimizer_config"])
    step = make_train_step(model, opt, None, clip)
    metrics = step(shard_batch(arg["batch"], rank, size),
                   torch.Generator().manual_seed(0))
    return step_result(model, metrics)


def eval_case(rank: int, size: int, arg) -> dict:
    """The gathered eval of the tiny PointPillars over ``arg['batches']``
    (global batches, the last one ragged)."""
    model, _ = flagship.build_pointpillars_flagship(tiny=True, device="cpu",
                                                    seed=arg["seed"])
    from isfusion_tpu_torch.testing import tame_box_deltas
    tame_box_deltas(model)
    return dict(results=single_device_test(model, arg["batches"], "cpu"))


def train_model_case(rank: int, size: int, arg) -> dict:
    """Two epochs of ``train_model`` at world ``size`` (batch 2 a rank),
    then epoch 2 again by a fresh model resumed from ``epoch_1.pth``."""
    from isfusion_tpu_torch.apis import init_model
    cfg = tiny_learn_cfg(arg["data"])
    cfg.data.samples_per_gpu = 2
    work, resumed_dir = arg["work"], arg["resumed"]
    model = init_model(cfg, device="cpu")
    records = train_model(model, build_dataset(cfg.data.train), cfg,
                          work_dir=work, device="cpu")
    model2 = init_model(cfg, device="cpu", seed=5)
    resumed = train_model(model2, build_dataset(cfg.data.train), cfg,
                          work_dir=resumed_dir, device="cpu",
                          resume_from=os.path.join(work, "epoch_1.pth"))
    return dict(records=records, resumed=resumed,
                state=model.state_dict(), state2=model2.state_dict())


CASES = dict(bn=bn_case, flagship=flagship_case, lidar=lidar_case,
             eval=eval_case, train_model=train_model_case)


# -------------------------------------------------------------- ranks
# the ranks' CPU state, which a bit-for-bit reference takes as well
THREADS = 2


def _rank_main(rank: int, size: int, work: str, cases: dict) -> None:
    torch.set_num_threads(THREADS)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        work, "group"), rank=rank, world_size=size)
    try:
        out = {name: CASES[name](rank, size, arg)
               for name, arg in cases.items()}
        out["jax_loaded"] = sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "flax",
                                                          "isfusion_tpu"))
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(cases: dict, world_size: int, work: str):
    """Start ``world_size`` spawned ranks running ``cases`` ({name: arg});
    returns the ``torch.multiprocessing`` context (``join()`` it)."""
    return torch.multiprocessing.spawn(_rank_main, args=(
        world_size, work, cases), nprocs=world_size, join=False)


def rank_results(work: str, world_size: int) -> list:
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world_size)]
