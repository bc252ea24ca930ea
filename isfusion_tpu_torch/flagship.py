"""The IS-Fusion flagship, the PointPillars baseline and their synthetic
inputs (counterpart of ``isfusion_tpu/flagship.py``).

The input generators are copies of the JAX package's and return numpy
arrays, so one batch can be handed to both packages bit for bit.
``build_isfusion_flagship`` builds the detector from
``configs/isfusion/isfusion_0075voxel.py`` with seeded random weights on
the CUDA card (``device="cpu"`` to run on the CPU), in eval mode;
``flagship_optim_cfg`` gives the config's training recipe. A train step::

    model, batch_fn = build_isfusion_flagship(seed=0)
    model.train()
    cfg = flagship_optim_cfg()
    opt = build_optimizer(model, cfg["optimizer"])    # runner/optim.py
    sched = build_schedule(opt, cfg["lr_config"], cfg["momentum_config"])
    step = make_train_step(model, opt, sched,         # parallel/train_step.py
                           grad_clip_norm(cfg["optimizer_config"]))
    metrics = step(batch_fn(4), torch.Generator("cuda").manual_seed(0))

``build_pointpillars_flagship`` builds the LiDAR-only PointPillars
detector of ``configs/pointpillars/hv_pointpillars_secfpn_sbn-all_4x8_2x_
nus-3d.py`` the same way, and ``pointpillars_optim_cfg`` gives its
``schedule_2x`` recipe (step lr with warmup, clip 35).
``build_centerpoint`` builds the CenterPoint detector of
``configs/centerpoint/centerpoint_0075voxel_second_secfpn_circlenms_4x8_
cyclic_20e_nus.py`` (hard 0.075 m voxels, circle NMS), and
``centerpoint_optim_cfg`` gives its recipe (AdamW, cyclic lr and
momentum, clip 35).
"""
from __future__ import annotations

import copy
import os
from typing import Callable, Optional, Tuple

import numpy as np
from torch import nn

from . import resolve_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ISFUSION_CFG = os.path.join(
    REPO_ROOT, "configs", "isfusion", "isfusion_0075voxel.py")
POINTPILLARS_CFG = os.path.join(
    REPO_ROOT, "configs", "pointpillars",
    "hv_pointpillars_secfpn_sbn-all_4x8_2x_nus-3d.py")
CENTERPOINT_CFG = os.path.join(
    REPO_ROOT, "configs", "centerpoint",
    "centerpoint_0075voxel_second_secfpn_circlenms_4x8_cyclic_20e_nus.py")

# config keys of the modules that carry a compute_dtype
_DTYPE_MODULES = ("img_backbone", "img_neck", "pts_middle_encoder",
                  "fusion_encoder", "pts_backbone", "pts_neck",
                  "pts_bbox_head")


def synthetic_multimodal_batch(batch_size: int, num_points: int = 200000,
                               num_views: int = 6, img_hw=(384, 1056),
                               num_gt: int = 64, seed: int = 0,
                               pcr=(-54, -54, -5, 54, 54, 3)) -> dict:
    """nuScenes-scale synthetic LiDAR + 6-camera batch with plausible
    pinhole projection matrices (cameras on a 360-degree ring)."""
    base = synthetic_points_batch(batch_size, num_points, num_gt, seed, pcr)
    rng = np.random.default_rng(seed + 1)
    h, w = img_hw
    img = rng.uniform(size=(batch_size, num_views, h, w, 3)).astype(
        np.float32)
    f = 0.6 * w
    K = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    l2i = np.zeros((num_views, 4, 4), np.float32)
    for v in range(num_views):
        th = 2 * np.pi * v / num_views
        fwd = np.array([np.cos(th), np.sin(th), 0.0])
        left = np.array([-np.sin(th), np.cos(th), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        R = np.eye(4, dtype=np.float32)
        R[0, :3] = -left   # cam x = right
        R[1, :3] = -up     # cam y = down
        R[2, :3] = fwd     # cam z = forward
        l2i[v] = K @ R
    base["img"] = img
    base["lidar2img"] = np.broadcast_to(
        l2i, (batch_size, num_views, 4, 4)).copy()
    return base


def _lidar_cloud(rng: np.random.Generator, num_points: int,
                 pcr, sweeps: int = 10) -> np.ndarray:
    """Ray-cast a nuScenes-like multi-sweep cloud: 32-beam spinning LiDAR
    over a ground plane with random walls plus dense object clusters.
    Returns (num_points, 3) xyz inside ``pcr``."""
    beams = 32
    elev = np.deg2rad(np.linspace(-30.0, 10.0, beams))
    clouds = []
    for s in range(sweeps):
        n_az = 1084
        az = np.linspace(-np.pi, np.pi, n_az, endpoint=False) + \
            rng.uniform(0, 0.01)
        A, E = np.meshgrid(az, elev)
        with np.errstate(divide="ignore"):
            r_ground = np.where(E < -0.005, 1.84 / np.tan(-E), 1e9)
        wall_d = rng.uniform(4.0, 60.0, n_az)
        has_wall = rng.uniform(size=n_az) < 0.55
        r_wall = np.where(has_wall[None, :], wall_d[None, :], 1e9)
        r = np.minimum(r_ground, r_wall)
        keep = r < 80.0
        r = r[keep] * rng.normal(1.0, 0.003, keep.sum())
        a, e = A[keep], E[keep]
        ego = np.array([0.9 * s, 0.05 * s, 0.0])
        clouds.append(np.stack([
            r * np.cos(e) * np.cos(a) + ego[0],
            r * np.cos(e) * np.sin(a) + ego[1],
            r * np.sin(e)], -1))
    for _ in range(40):
        c = rng.uniform(-50, 50, 2)
        n = int(rng.integers(50, 1500))
        xy = c + rng.normal(0, [1.6, 0.7], (n, 2))
        z = rng.uniform(-1.8, 0.4, n)
        clouds.append(np.stack([xy[:, 0], xy[:, 1], z], -1))
    pts = np.concatenate(clouds)
    m = ((pts[:, 0] > pcr[0]) & (pts[:, 0] < pcr[3]) &
         (pts[:, 1] > pcr[1]) & (pts[:, 1] < pcr[4]) &
         (pts[:, 2] > pcr[2]) & (pts[:, 2] < pcr[5]))
    pts = pts[m]
    idx = rng.permutation(len(pts))
    if len(pts) >= num_points:
        return pts[idx[:num_points]]
    extra = rng.integers(0, len(pts), num_points - len(pts))
    return np.concatenate([pts, pts[extra] + rng.normal(
        0, 0.02, (len(extra), 3))])


def synthetic_points_batch(batch_size: int, num_points: int = 120000,
                           num_gt: int = 64, seed: int = 0,
                           pcr=(-50, -50, -5, 50, 50, 3)) -> dict:
    """Fixed-shape synthetic nuScenes-like LiDAR batch (5-dim points,
    padded GT boxes with mask); points follow ``_lidar_cloud``."""
    rng = np.random.default_rng(seed)
    pts = np.empty((batch_size, num_points, 5), np.float32)
    for b in range(batch_size):
        pts[b, :, :3] = _lidar_cloud(np.random.default_rng(seed + b),
                                     num_points, pcr)
    pts[..., 3] = rng.uniform(0, 255, (batch_size, num_points))
    pts[..., 4] = rng.integers(0, 10, (batch_size, num_points)) * 0.05
    mask = rng.uniform(size=(batch_size, num_points)) > 0.05
    boxes = np.zeros((batch_size, num_gt, 9), np.float32)
    boxes[..., :2] = rng.uniform(0.9 * pcr[0], 0.9 * pcr[3],
                                 (batch_size, num_gt, 2))
    boxes[..., 2] = -1.0
    boxes[..., 3:6] = rng.uniform(0.5, 5.0, (batch_size, num_gt, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (batch_size, num_gt))
    labels = rng.integers(0, 7, (batch_size, num_gt))
    gt_mask = np.arange(num_gt)[None, :] < rng.integers(
        max(num_gt // 2, 1), num_gt + 1, (batch_size, 1))
    return dict(points=pts, points_mask=mask, gt_bboxes_3d=boxes,
                gt_labels_3d=labels, gt_mask=gt_mask)


def flagship_model_cfg(tiny: bool = False,
                       compute_dtype: Optional[str] = None,
                       dropout: bool = True) -> dict:
    """The flagship's model config dict. ``tiny`` shrinks geometry and
    widths as the JAX package's tiny variant does (and runs float32);
    ``compute_dtype`` overrides every module's compute dtype;
    ``dropout=False`` sets every dropout and drop-path rate to 0 and turns
    the P2G pixel jitter off (a train step that draws nothing)."""
    from .config import Config

    model_cfg = copy.deepcopy(dict(Config.fromfile(ISFUSION_CFG).model))
    if tiny:
        pcr = [-28.8, -28.8, -5.0, 28.8, 28.8, 3.0]
        vs = [0.3, 0.3, 8.0 / 24.0]
        vshape = 192            # (28.8*2)/0.3
        bev = vshape // 8       # 24
        nzc = 24                # z cells; sparse_shape z = nzc + 1
        model_cfg["pc_range"] = pcr
        model_cfg["voxel_size"] = vs
        model_cfg["pts_voxel_layer"] = dict(
            point_cloud_range=pcr, max_num_points=-1, voxel_size=vs,
            max_voxels=(1536, 1536))
        model_cfg["pillar_max_voxels"] = (512, 512)
        model_cfg["img_backbone"] = dict(
            model_cfg["img_backbone"], embed_dims=24,
            num_heads=[1, 2, 4, 8], depths=[1, 1, 1, 1],
            with_cp=False, compute_dtype=None)
        model_cfg["img_neck"] = dict(
            model_cfg["img_neck"], in_channels=[48, 96, 192],
            out_channels=32, compute_dtype=None)
        model_cfg["pts_voxel_encoder"] = dict(
            model_cfg["pts_voxel_encoder"], feat_channels=[16, 16],
            voxel_size=vs, point_cloud_range=pcr)
        model_cfg["pts_middle_encoder"] = dict(
            model_cfg["pts_middle_encoder"], in_channels=16,
            sparse_shape=[nzc + 1, vshape, vshape],
            base_channels=8, output_channels=32,
            encoder_channels=((8, 8, 16), (16, 16, 16), (16, 16, 32),
                              (32, 32)),
            compute_dtype="float32", z_windows=None,
            subm_dilation_ratios=None)
        model_cfg["fusion_encoder"] = dict(
            model_cfg["fusion_encoder"], embed_dims=32, bev_size=bev,
            grid_size=[[bev, bev, 1], [bev // 2, bev // 2, 1]],
            instance_num=16, compute_dtype=None)
        model_cfg["pts_backbone"] = dict(
            model_cfg["pts_backbone"], in_channels=16,
            out_channels=[16, 32], layer_nums=[1, 1], compute_dtype=None)
        model_cfg["pts_neck"] = dict(
            model_cfg["pts_neck"], in_channels=[16, 32],
            out_channels=[16, 16], compute_dtype=None)
        head = dict(model_cfg["pts_bbox_head"], num_proposals=16,
                    in_channels=32, hidden_channel=16, num_heads=2,
                    ffn_channel=32, compute_dtype=None)
        head["bbox_coder"] = dict(
            head["bbox_coder"], pc_range=pcr[:2], voxel_size=vs[:2],
            post_center_range=[-32.0, -32.0, -10.0, 32.0, 32.0, 10.0])
        model_cfg["pts_bbox_head"] = head
        for key in ("train_cfg", "test_cfg"):
            sub = dict(dict(model_cfg[key])["pts"])
            sub.update(grid_size=[vshape, vshape, nzc], out_size_factor=8,
                       voxel_size=vs[:2] if key == "test_cfg" else vs)
            if "point_cloud_range" in sub:
                sub["point_cloud_range"] = pcr
            if "pc_range" in sub:
                sub["pc_range"] = pcr[:2]
            model_cfg[key] = dict(model_cfg[key], pts=sub)
    if not dropout:
        model_cfg["img_backbone"] = dict(model_cfg["img_backbone"],
                                         drop_rate=0.0, attn_drop_rate=0.0,
                                         drop_path_rate=0.0)
        model_cfg["fusion_encoder"] = dict(model_cfg["fusion_encoder"],
                                           dropout=0.0, random_noise=None)
        model_cfg["pts_bbox_head"] = dict(model_cfg["pts_bbox_head"],
                                          dropout=0.0)
    if compute_dtype is not None:
        for key in _DTYPE_MODULES:
            model_cfg[key] = dict(model_cfg[key], compute_dtype=compute_dtype)
    return model_cfg


def flagship_optim_cfg() -> dict:
    """The flagship config's training recipe: ``optimizer``,
    ``optimizer_config`` (grad clip), ``lr_config``, ``momentum_config``
    and ``samples_per_gpu``."""
    from .config import Config

    cfg = Config.fromfile(ISFUSION_CFG)
    out = {k: copy.deepcopy(dict(cfg[k])) for k in (
        "optimizer", "optimizer_config", "lr_config", "momentum_config")}
    out["samples_per_gpu"] = int(cfg.data["samples_per_gpu"])
    return out


def build_isfusion_flagship(tiny: bool = False,
                            compute_dtype: Optional[str] = None,
                            device=None, seed: int = 0, dropout: bool = True
                            ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): the flagship IS-Fusion detector with weights
    drawn from ``seed``, in eval mode on ``device`` (default: the CUDA
    card; raises if it is missing), and ``batch_fn(batch_size, seed=0)``
    giving a numpy batch at the model's shapes (bench shape: 200,000
    points, 6 x 384 x 1056 images; tiny: 3,072 points, 1 x 64 x 224)."""
    from .models.builder import build_detector
    from .models.layers import init_weights

    dev = resolve_device(device)
    model_cfg = flagship_model_cfg(tiny, compute_dtype, dropout)
    model = init_weights(build_detector(model_cfg), seed).to(dev).eval()
    if tiny:
        pcr = tuple(model_cfg["pc_range"])

        def batch_fn(b, seed=0):
            return synthetic_multimodal_batch(
                b, num_points=3072, num_views=1, img_hw=(64, 224), num_gt=8,
                seed=seed, pcr=pcr)
    else:
        def batch_fn(b, seed=0):
            return synthetic_multimodal_batch(b, seed=seed)
    return model, batch_fn


def pointpillars_model_cfg(tiny: bool = False) -> dict:
    """The PointPillars model config dict. ``tiny`` shrinks geometry and
    widths as the JAX package's tiny variant does (16 m x 16 m at 0.5 m,
    <= 8 points in <= 256 pillars, SECOND 16/32/64) and runs float32;
    at full width the SECOND backbone, the neck and the head compute in
    bf16 (the port's serving and training precision; the voxel encoder
    stays float32, as in the JAX package)."""
    compute_dtype = "bfloat16"
    from .config import Config

    model_cfg = copy.deepcopy(dict(Config.fromfile(POINTPILLARS_CFG).model))
    if tiny:
        pcr = [-8, -8, -5, 8, 8, 3]
        vs = [0.5, 0.5, 8]
        model_cfg["pts_voxel_layer"] = dict(
            max_num_points=8, point_cloud_range=pcr, voxel_size=vs,
            max_voxels=(256, 256))
        model_cfg["pts_voxel_encoder"] = dict(
            model_cfg["pts_voxel_encoder"], feat_channels=[16, 16],
            voxel_size=vs, point_cloud_range=pcr)
        model_cfg["pts_middle_encoder"] = dict(
            model_cfg["pts_middle_encoder"], in_channels=16,
            output_shape=[32, 32])
        model_cfg["pts_backbone"] = dict(
            model_cfg["pts_backbone"], in_channels=16,
            out_channels=[16, 32, 64], layer_nums=[1, 1, 1])
        model_cfg["pts_neck"] = dict(
            model_cfg["pts_neck"], in_channels=[16, 32, 64],
            out_channels=[16, 16, 16])
        head = dict(model_cfg["pts_bbox_head"], in_channels=48,
                    feat_channels=48)
        head["anchor_generator"] = dict(
            head["anchor_generator"],
            ranges=[[-8, -8, r[2], 8, 8, r[5]]
                    for r in head["anchor_generator"]["ranges"]])
        model_cfg["pts_bbox_head"] = head
        compute_dtype = None
    for key in ("pts_backbone", "pts_neck", "pts_bbox_head"):
        model_cfg[key] = dict(model_cfg[key], compute_dtype=compute_dtype)
    return model_cfg


def pointpillars_optim_cfg() -> dict:
    """The PointPillars config's training recipe (``schedule_2x``):
    ``optimizer``, ``optimizer_config`` (grad clip), ``lr_config``,
    ``momentum_config`` (None) and ``samples_per_gpu``."""
    from .config import Config

    cfg = Config.fromfile(POINTPILLARS_CFG)
    out = {k: copy.deepcopy(dict(cfg[k])) if cfg[k] is not None else None
           for k in ("optimizer", "optimizer_config", "lr_config",
                     "momentum_config")}
    out["samples_per_gpu"] = int(cfg.data["samples_per_gpu"])
    return out


def build_pointpillars_flagship(tiny: bool = False, device=None,
                                seed: int = 0
                                ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): the PointPillars nuScenes detector
    (``MVXFasterRCNN``) with weights drawn from ``seed``, in eval mode on
    ``device`` (default: the CUDA card; raises if it is missing), and
    ``batch_fn(batch_size, seed=0)`` giving a numpy batch (bench shape:
    120,000 points, 64 padded GT boxes; tiny: 2,048 points, 8 boxes, as the
    JAX package's tiny variant)."""
    from .models.builder import build_detector
    from .models.layers import init_weights

    dev = resolve_device(device)
    model_cfg = pointpillars_model_cfg(tiny)
    model = init_weights(build_detector(model_cfg), seed).to(dev).eval()
    if tiny:
        pcr = tuple(model_cfg["pts_voxel_layer"]["point_cloud_range"])

        def batch_fn(b, seed=0):
            return synthetic_points_batch(b, num_points=2048, num_gt=8,
                                          seed=seed, pcr=pcr)
    else:
        def batch_fn(b, seed=0):
            return synthetic_points_batch(b, seed=seed)
    return model, batch_fn


# the (x, y) range the CenterPoint serve cloud spans: the flagship's
CENTERPOINT_CLOUD_RANGE = (-54, -54, -5, 54, 54, 3)


def centerpoint_model_cfg(tiny: bool = False) -> dict:
    """The CenterPoint model config dict as written; at full width the
    SparseEncoder, SECOND, SECONDFPN and CenterHead convs compute in bf16
    (hard voxelization, the VFE, targets, losses, decode and NMS stay
    float32). ``tiny``: a 16 m scene at 0.125 x 0.125 x 0.2 m voxels (a
    128 x 128 x 41 grid, a 16 x 16 BEV), narrow widths, float32, voxel
    caps that hold every point and the JAX package's column caps lifted
    to the whole grid (``stage_cap_ratios``, read by the JAX SparseEncoder
    only); the coder's ``max_num`` 128 (a 16 x 16 map holds 256 cells a
    class)."""
    from .config import Config

    model_cfg = copy.deepcopy(dict(Config.fromfile(CENTERPOINT_CFG).model))
    compute_dtype = "bfloat16"
    if tiny:
        pcr = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
        vs = [0.125, 0.125, 0.2]
        n, cap = 128, 2048
        model_cfg["pts_voxel_layer"] = dict(
            model_cfg["pts_voxel_layer"], point_cloud_range=pcr,
            voxel_size=vs, max_voxels=(cap, cap))
        model_cfg["pts_middle_encoder"] = dict(
            model_cfg["pts_middle_encoder"], sparse_shape=[41, n, n],
            base_channels=8, output_channels=16,
            encoder_channels=((8, 8, 16), (16, 16, 16), (16, 16, 32),
                              (32, 32)),
            stage_cap_ratios=tuple((n >> i) ** 2 / cap for i in range(4)),
            dilation_ratio=1.0)
        model_cfg["pts_backbone"] = dict(
            model_cfg["pts_backbone"], in_channels=32, out_channels=[16, 32],
            layer_nums=[1, 1])
        model_cfg["pts_neck"] = dict(
            model_cfg["pts_neck"], in_channels=[16, 32],
            out_channels=[16, 16])
        head = dict(model_cfg["pts_bbox_head"], in_channels=32,
                    share_conv_channel=16,
                    separate_head=dict(model_cfg["pts_bbox_head"][
                        "separate_head"], head_conv=16))
        head["bbox_coder"] = dict(head["bbox_coder"], pc_range=pcr,
                                  voxel_size=vs[:2], max_num=128,
                                  post_center_range=[-10.0, -10.0, -10.0,
                                                     10.0, 10.0, 10.0])
        model_cfg["pts_bbox_head"] = head
        model_cfg["train_cfg"] = dict(pts=dict(
            model_cfg["train_cfg"]["pts"], point_cloud_range=pcr,
            grid_size=[n, n, 40], voxel_size=vs))
        model_cfg["test_cfg"] = dict(pts=dict(
            model_cfg["test_cfg"]["pts"], voxel_size=vs[:2],
            post_center_limit_range=[-10.0, -10.0, -10.0, 10.0, 10.0, 10.0],
            max_per_img=128))
        compute_dtype = None
    model_cfg["pts_middle_encoder"] = dict(
        model_cfg["pts_middle_encoder"],
        compute_dtype=compute_dtype or "float32")
    for key in ("pts_backbone", "pts_neck", "pts_bbox_head"):
        model_cfg[key] = dict(model_cfg[key], compute_dtype=compute_dtype)
    return model_cfg


def centerpoint_optim_cfg() -> dict:
    """The CenterPoint config's training recipe: ``optimizer`` (AdamW, lr
    1e-4, weight decay 0.01), ``optimizer_config`` (clip 35),
    ``lr_config`` and ``momentum_config`` (cyclic) and
    ``samples_per_gpu`` 4. The config file has no ``data`` section: the
    4 is the per-card batch of its name (``4x8``: 4 samples a card on 8
    cards)."""
    from .config import Config

    cfg = Config.fromfile(CENTERPOINT_CFG)
    out = {k: copy.deepcopy(dict(cfg[k])) for k in (
        "optimizer", "optimizer_config", "lr_config", "momentum_config")}
    out["samples_per_gpu"] = 4
    return out


def build_centerpoint(tiny: bool = False, device=None, seed: int = 0
                      ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): the CenterPoint nuScenes detector with weights
    drawn from ``seed``, in eval mode on ``device`` (default: the CUDA
    card; raises if it is missing), and ``batch_fn(batch_size, seed=0)``
    giving a numpy batch (bench shape: the flagship's serve cloud of
    200,000 points over +-54 m and 64 padded GT boxes; tiny: 2,048 points
    over +-8 m and 8 boxes; labels over the 10 classes)."""
    from .models.builder import build_detector
    from .models.layers import init_weights

    dev = resolve_device(device)
    model_cfg = centerpoint_model_cfg(tiny)
    model = init_weights(build_detector(model_cfg), seed).to(dev).eval()
    if tiny:
        pcr = tuple(model_cfg["pts_voxel_layer"]["point_cloud_range"])

        def batch_fn(b, seed=0):
            return synthetic_points_batch(b, num_points=2048, num_gt=8,
                                          seed=seed, pcr=pcr)
    else:
        def batch_fn(b, seed=0):
            return synthetic_points_batch(b, num_points=200000, seed=seed,
                                          pcr=CENTERPOINT_CLOUD_RANGE)

    def all_classes(b, seed=0):
        # the synthetic batch labels 7 classes; CenterPoint's six tasks
        # cover all 10, so every task head gets GT rows
        batch = batch_fn(b, seed)
        batch["gt_labels_3d"] = np.random.default_rng(seed + 1).integers(
            0, 10, batch["gt_labels_3d"].shape)
        return batch
    return model, all_classes
