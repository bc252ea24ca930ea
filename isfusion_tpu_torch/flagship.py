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
momentum, clip 35). ``build_mvxnet`` builds MVX-Net of
``configs/mvxnet/dv_mvx-fpn_second_secfpn_adamw_2x8_80e_kitti-3d-3class.py``
(``DynamicMVXFasterRCNN``: ResNet-50 + FPN, dynamic voxels, PointFusion,
the conv_module SparseEncoder, the 3-class KITTI Anchor3DHead) with a
KITTI-like synthetic batch of one camera, and ``mvxnet_optim_cfg`` its
recipe (AdamW, CosineAnnealing with linear warmup, clip 35).
``build_parta2`` builds the two-stage PartA2 (SparseUNet, the RPN
Anchor3DHead, the RoI head with K16's pooling) at MVX-Net's KITTI
settings on its batch, and ``parta2_optim_cfg`` its recipe (AdamW, cyclic
lr and momentum, clip 10). ``build_fcos3d`` builds the monocular FCOS3D
of ``configs/fcos3d/fcos3d_
r101_caffe_fpn_gn-head_2x8_1x_nus-mono3d.py`` (ResNet-101 caffe, FPN with
two extra levels, the GN FCOSMono3DHead) with a nuScenes-like synthetic
camera batch (``synthetic_mono_batch``), and ``fcos3d_optim_cfg`` its
recipe (SGD with momentum, weight decay and the bias multipliers, step lr
with linear warmup, clip 35). ``build_ssn`` and ``build_free_anchor`` build
SSN (ShapeAwareHead) and FreeAnchor on RegNetX-400MF + FPN on the
PointPillars config's voxels and recipe (``ssn_optim_cfg``,
``free_anchor_optim_cfg``: batch 2 and 4).
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
MVXNET_CFG = os.path.join(
    REPO_ROOT, "configs", "mvxnet",
    "dv_mvx-fpn_second_secfpn_adamw_2x8_80e_kitti-3d-3class.py")
FCOS3D_CFG = os.path.join(
    REPO_ROOT, "configs", "fcos3d",
    "fcos3d_r101_caffe_fpn_gn-head_2x8_1x_nus-mono3d.py")

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
                 pcr, sweeps: int = 10,
                 sensor_height: float = 1.84) -> np.ndarray:
    """Ray-cast a nuScenes-like multi-sweep cloud: 32-beam spinning LiDAR
    ``sensor_height`` m over a ground plane with random walls plus dense
    object clusters. Returns (num_points, 3) xyz inside ``pcr``."""
    beams = 32
    elev = np.deg2rad(np.linspace(-30.0, 10.0, beams))
    clouds = []
    for s in range(sweeps):
        n_az = 1084
        az = np.linspace(-np.pi, np.pi, n_az, endpoint=False) + \
            rng.uniform(0, 0.01)
        A, E = np.meshgrid(az, elev)
        with np.errstate(divide="ignore"):
            r_ground = np.where(E < -0.005, sensor_height / np.tan(-E),
                                1e9)
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


# MVX-Net: the KITTI LiDAR's mount height and the span of the serve cloud
# (360 degrees; the config's range is the front half)
KITTI_SENSOR_HEIGHT = 1.73
MVXNET_CLOUD_RANGE = (-70.4, -40.0, -3.0, 70.4, 40.0, 1.0)
MVXNET_IMG_HW = (384, 1280)
# the anchor sizes of the three classes (Pedestrian, Cyclist, Car)
KITTI_CLASS_SIZES = ((0.6, 0.8, 1.73), (0.6, 1.76, 1.73), (1.6, 3.9, 1.56))
KITTI_CLASS_Z = (-0.6, -0.6, -1.78)


def synthetic_kitti_batch(batch_size: int, num_points: int = 120000,
                          img_hw=MVXNET_IMG_HW, num_gt: int = 16,
                          seed: int = 0, pcr=MVXNET_CLOUD_RANGE,
                          gt_range=(0.0, -40.0, 70.4, 40.0)) -> dict:
    """KITTI-like synthetic batch: 4-dim points (x, y, z, reflectance) of
    a 360-degree ray-cast cloud from a LiDAR 1.73 m above the ground
    (``_lidar_cloud``, 4 sweeps) inside ``pcr``, one camera view (B, 1, H,
    W, 3) with the KITTI-like ``lidar2img`` (``testing.kitti_lidar2img``),
    and 3-class 7-dim GT boxes (pedestrian, cyclist, car: the anchors'
    sizes and centres' heights, scaled by U(0.8, 1.2)) inside
    ``gt_range`` (x0, y0, x1, y1), padded with a mask."""
    from .testing import kitti_lidar2img

    rng = np.random.default_rng(seed)
    pts = np.empty((batch_size, num_points, 4), np.float32)
    for b in range(batch_size):
        pts[b, :, :3] = _lidar_cloud(np.random.default_rng(seed + b),
                                     num_points, pcr, sweeps=4,
                                     sensor_height=KITTI_SENSOR_HEIGHT)
    pts[..., 3] = rng.uniform(0, 1, (batch_size, num_points))
    h, w = img_hw
    img = rng.uniform(size=(batch_size, 1, h, w, 3)).astype(np.float32)
    l2i = np.broadcast_to(kitti_lidar2img(img_hw),
                          (batch_size, 1, 4, 4)).copy()
    labels = rng.integers(0, 3, (batch_size, num_gt))
    size = np.asarray(KITTI_CLASS_SIZES, np.float32)[labels] * \
        rng.uniform(0.8, 1.2, (batch_size, num_gt, 1))
    boxes = np.zeros((batch_size, num_gt, 7), np.float32)
    x0, y0, x1, y1 = gt_range
    boxes[..., 0] = rng.uniform(x0 + 0.05 * (x1 - x0), x1 - 0.05 * (x1 - x0),
                                (batch_size, num_gt))
    boxes[..., 1] = rng.uniform(y0 + 0.05 * (y1 - y0), y1 - 0.05 * (y1 - y0),
                                (batch_size, num_gt))
    boxes[..., 2] = np.asarray(KITTI_CLASS_Z, np.float32)[labels]
    boxes[..., 3:6] = size
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (batch_size, num_gt))
    gt_mask = np.arange(num_gt)[None, :] < rng.integers(
        max(num_gt // 2, 1), num_gt + 1, (batch_size, 1))
    return dict(points=pts, points_mask=np.ones((batch_size, num_points),
                                                bool),
                img=img, lidar2img=l2i, gt_bboxes_3d=boxes,
                gt_labels_3d=labels, gt_mask=gt_mask)


# config keys of MVX-Net's modules that compute in bf16 at full width
_MVX_BF16 = ("img_backbone", "img_neck", "pts_middle_encoder",
             "pts_backbone", "pts_neck", "pts_bbox_head")
# the tiny MVX-Net's scene: 12.8 m x 16 m in front of the car
MVXNET_TINY_RANGE = [0.0, -8.0, -3.0, 12.8, 8.0, 1.0]


def mvxnet_model_cfg(tiny: bool = False) -> dict:
    """MVX-Net's model config dict. Full width: the config as written, the
    convs (ResNet, FPN, PointFusion's lateral convs, the SparseEncoder,
    SECOND, SECONDFPN, the head) in bf16; dynamic voxelization, the VFE,
    PointFusion's sampling and transforms, targets, losses, decode and NMS
    in float32. ``tiny``: a 12.8 x 16 m front scene at 0.2 x 0.2 x 0.4 m
    voxels (a 64 x 80 x 10 grid), a 2-stage ResNet-50 of base width 4
    (caffe, stage 1 frozen), a 2-level FPN with 3 outputs, a 2-stage
    conv_module SparseEncoder, narrow SECOND / SECONDFPN / head, float32,
    the JAX SparseEncoder's column caps lifted to the whole grid and its
    voxel cap above the points (``stage_cap_ratios``, ``max_voxels``: read
    by the JAX package only)."""
    from .config import Config

    model_cfg = copy.deepcopy(dict(Config.fromfile(MVXNET_CFG).model))
    if not tiny:
        for key in _MVX_BF16:
            model_cfg[key] = dict(model_cfg[key], compute_dtype="bfloat16")
        vfe = dict(model_cfg["pts_voxel_encoder"])
        vfe["fusion_layer"] = dict(vfe["fusion_layer"],
                                   compute_dtype="bfloat16")
        model_cfg["pts_voxel_encoder"] = vfe
        return model_cfg
    pcr = MVXNET_TINY_RANGE
    vs = [0.2, 0.2, 0.4]
    ny, nx, cap = 80, 64, 4096
    model_cfg["img_backbone"] = dict(
        model_cfg["img_backbone"], base_channels=4, num_stages=2,
        strides=(1, 2), out_indices=(0, 1))
    model_cfg["img_neck"] = dict(model_cfg["img_neck"], in_channels=[16, 32],
                                 out_channels=16, num_outs=3)
    model_cfg["pts_voxel_layer"] = dict(
        model_cfg["pts_voxel_layer"], point_cloud_range=pcr, voxel_size=vs,
        max_voxels=(cap, cap))
    model_cfg["pts_voxel_encoder"] = dict(
        model_cfg["pts_voxel_encoder"], feat_channels=[16, 16],
        voxel_size=vs, point_cloud_range=pcr,
        fusion_layer=dict(model_cfg["pts_voxel_encoder"]["fusion_layer"],
                          img_channels=16, pts_channels=16, mid_channels=16,
                          out_channels=16, img_levels=[0, 1, 2]))
    model_cfg["pts_middle_encoder"] = dict(
        model_cfg["pts_middle_encoder"], in_channels=16,
        sparse_shape=[11, ny, nx], base_channels=8, output_channels=16,
        encoder_channels=((8,), (16, 16)), encoder_paddings=((1,), (1, 1)),
        stage_cap_ratios=tuple((ny >> i) * (nx >> i) / cap + 1e-9
                               for i in range(2)), dilation_ratio=1.0)
    model_cfg["pts_backbone"] = dict(
        model_cfg["pts_backbone"], in_channels=32, out_channels=[16, 32],
        layer_nums=[1, 1])
    model_cfg["pts_neck"] = dict(model_cfg["pts_neck"], in_channels=[16, 32],
                                 out_channels=[16, 16])
    head = dict(model_cfg["pts_bbox_head"], in_channels=32, feat_channels=32)
    head["anchor_generator"] = dict(
        head["anchor_generator"],
        ranges=[[pcr[0], pcr[1], r[2], pcr[3], pcr[4], r[5]]
                for r in head["anchor_generator"]["ranges"]])
    model_cfg["pts_bbox_head"] = head
    return model_cfg


def mvxnet_optim_cfg() -> dict:
    """MVX-Net's training recipe: ``optimizer`` (AdamW, lr 0.003, weight
    decay 0.01), ``optimizer_config`` (clip 35), ``lr_config``
    (CosineAnnealing, linear warmup over 1,000 steps from 0.1 of the lr,
    ``min_lr_ratio`` 1e-5), ``momentum_config`` (None) and
    ``samples_per_gpu`` 2. The config has no ``data`` section: the 2 is
    the per-card batch of its name (``2x8``)."""
    from .config import Config

    cfg = Config.fromfile(MVXNET_CFG)
    out = {k: copy.deepcopy(dict(cfg[k])) for k in (
        "optimizer", "optimizer_config", "lr_config")}
    out["momentum_config"] = None
    out["samples_per_gpu"] = 2
    return out


def build_mvxnet(tiny: bool = False, device=None, seed: int = 0
                 ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): MVX-Net (``DynamicMVXFasterRCNN``) with weights
    drawn from ``seed``, in eval mode on ``device`` (default: the CUDA
    card; raises if it is missing), and ``batch_fn(batch_size, seed=0)``
    giving a KITTI-like numpy batch (``synthetic_kitti_batch``; full
    width: 120,000 points of a 360-degree cloud, about half in the
    config's front range, one 384 x 1280 view, 16 padded GT rows; tiny:
    2,048 points over the tiny scene, one 64 x 192 view, 8 GT rows)."""
    from .models.builder import build_detector
    from .models.layers import init_weights

    dev = resolve_device(device)
    model_cfg = mvxnet_model_cfg(tiny)
    model = init_weights(build_detector(model_cfg), seed).to(dev).eval()
    if tiny:
        pcr = MVXNET_TINY_RANGE

        def batch_fn(b, seed=0):
            return synthetic_kitti_batch(
                b, num_points=2048, img_hw=(64, 192), num_gt=8, seed=seed,
                pcr=pcr, gt_range=(pcr[0], pcr[1], pcr[3], pcr[4]))
    else:
        def batch_fn(b, seed=0):
            return synthetic_kitti_batch(b, seed=seed)
    return model, batch_fn


# PartA2: the KITTI 3-class settings of MVX-Net's config (range, voxel
# size, sparse shape, SECOND, SECONDFPN, the anchors), the JAX SparseUNet's
# and PartAggregationROIHead's defaults (the reference's widths), and the
# reference PartA2's RPN test config, which the JAX module uses in
# training too (one proposal config, ROADMAP queue 3)
PARTA2_RPN_TEST_CFG = dict(use_rotate_nms=True, nms_across_levels=False,
                           nms_pre=1024, nms_thr=0.7, score_thr=0.0,
                           min_bbox_size=0, max_num=100)
# the tiny PartA2's scene (the JAX package's PartA2 test): 16 x 16 x 8 m,
# at 0.25 x 0.25 x 0.2 m voxels (an 8 x 8 BEV after the three stride-2
# stages)
PARTA2_TINY_RANGE = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]


def parta2_model_cfg(tiny: bool = False) -> dict:
    """PartA2's model config dict. Full width: hard voxels (5 points, the
    caps (16000, 40000)), HardSimpleVFE(4), the SparseUNet of sparse shape
    [41, 1600, 1408] (base 16, output 128, the default encoder and decoder
    widths), MVX-Net's SECOND (256 -> [128, 256]), SECONDFPN (-> [256,
    256]) and 3-class Anchor3DHead (512 wide, the three KITTI anchors, 2
    rotations, assigned per class), the RoI head's defaults (grid 6,
    shared (128, 128), 20 input channels) and 100 proposals; the
    SparseUNet, SECOND, SECONDFPN and the RPN's convs in bf16, the pooling,
    the RoI MLP, the part heads, targets and losses in float32. ``tiny``:
    the JAX package's PartA2 test model (a 16 m scene, a 4-stage SparseUNet
    of widths 8-16, SECOND / SECONDFPN 16-32 wide, grid 4, shared (32, 32))
    with the three KITTI anchors, 0.25 m voxels (an 8 x 8 BEV: 384
    anchors), the full width's RPN test config over all of them with 64
    proposals, the sparse shape's depth 41 as the reference's (so conv_out
    gives SECOND its 32 channels) and
    the JAX SparseUNet's table caps lifted above what a stride-2 conv can
    make (``stage_cap_ratios``, read by the JAX package only); float32."""
    from .config import Config

    cfg = Config.fromfile(MVXNET_CFG)
    mvx = copy.deepcopy(dict(cfg.model))
    rpn = dict(mvx["pts_bbox_head"])
    roi = dict(type="PartAggregationROIHead", num_classes=3)
    train_cfg = dict(rpn=dict(mvx["train_cfg"]["pts"]))
    if not tiny:
        bf16 = dict(compute_dtype="bfloat16")
        return dict(
            type="PartA2",
            voxel_layer=dict(max_num_points=5,
                             point_cloud_range=list(cfg["point_cloud_range"]),
                             voxel_size=list(cfg["voxel_size"]),
                             max_voxels=(16000, 40000)),
            voxel_encoder=dict(type="HardSimpleVFE", num_features=4),
            middle_encoder=dict(
                type="SparseUNet", in_channels=4,
                sparse_shape=list(mvx["pts_middle_encoder"]["sparse_shape"]),
                order=("conv", "norm", "act"), **bf16),
            backbone=dict(mvx["pts_backbone"], **bf16),
            neck=dict(mvx["pts_neck"], **bf16), rpn_head=dict(rpn, **bf16),
            roi_head=roi, num_proposals=100, train_cfg=train_cfg,
            test_cfg=dict(rpn=dict(PARTA2_RPN_TEST_CFG)))
    pcr = PARTA2_TINY_RANGE
    rpn.update(in_channels=32, feat_channels=32, anchor_generator=dict(
        rpn["anchor_generator"],
        ranges=[[pcr[0], pcr[1], z, pcr[3], pcr[4], z] for z in
                KITTI_CLASS_Z]))
    return dict(
        type="PartA2",
        voxel_layer=dict(max_num_points=5, point_cloud_range=pcr,
                         voxel_size=[0.25, 0.25, 0.2],
                         max_voxels=(1024, 1024)),
        voxel_encoder=dict(type="HardSimpleVFE", num_features=4),
        middle_encoder=dict(
            type="SparseUNet", in_channels=4, sparse_shape=[41, 64, 64],
            base_channels=8, output_channels=16,
            encoder_channels=((8,), (16, 16), (16, 16), (16, 16)),
            encoder_paddings=((1,), (1, 1), (1, 1), ((0, 1, 1), 1)),
            decoder_channels=((16, 16, 16), (16, 16, 16), (16, 16, 8),
                              (8, 8, 8)),
            decoder_paddings=((1, 0), (1, 0), (0, 0), (0, 1)),
            stage_cap_ratios=(8.0, 8.0, 8.0, 8.0)),
        backbone=dict(type="SECOND", in_channels=32, out_channels=[16, 32],
                      layer_nums=[1, 1], layer_strides=[1, 2]),
        neck=dict(type="SECONDFPN", in_channels=[16, 32],
                  out_channels=[16, 16], upsample_strides=[1, 2]),
        rpn_head=rpn,
        roi_head=dict(roi, grid_size=4, shared_channels=(32, 32)),
        num_proposals=64,
        train_cfg=dict(rpn=dict(
            assigner=dict(pos_iou_thr=0.6, neg_iou_thr=0.3, min_pos_iou=0.3),
            code_weight=[1.0] * 7)),
        test_cfg=dict(rpn=dict(PARTA2_RPN_TEST_CFG, nms_pre=512,
                               max_num=64)))


def parta2_optim_cfg() -> dict:
    """PartA2's training recipe, the reference's cyclic schedule as PartA2
    sets it: ``optimizer`` (AdamW, lr 0.001, betas (0.95, 0.99), weight
    decay 0.01), ``optimizer_config`` (clip 10), ``lr_config`` (cyclic, to
    10x over 40% of the steps, then to 1e-4x) and ``momentum_config``
    (cyclic, beta1 0.95 -> 0.85 -> 0.95), ``samples_per_gpu`` 2 (its
    ``2x8``)."""
    return dict(
        optimizer=dict(type="AdamW", lr=0.001, betas=(0.95, 0.99),
                       weight_decay=0.01),
        optimizer_config=dict(grad_clip=dict(max_norm=10, norm_type=2)),
        lr_config=dict(policy="cyclic", target_ratio=(10, 1e-4),
                       cyclic_times=1, step_ratio_up=0.4),
        momentum_config=dict(policy="cyclic",
                             target_ratio=(0.85 / 0.95, 1), cyclic_times=1,
                             step_ratio_up=0.4),
        samples_per_gpu=2)


def build_parta2(tiny: bool = False, device=None, seed: int = 0
                 ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): PartA2 with weights drawn from ``seed``, in eval
    mode on ``device`` (default: the CUDA card; raises if it is missing),
    and ``batch_fn(batch_size, seed=0)`` giving a KITTI-like numpy batch
    (``synthetic_kitti_batch``: full width, MVX-Net's 120,000-point cloud
    and 16 padded 3-class GT rows; tiny, 1,024 points over the tiny scene
    and 8 GT rows)."""
    from .models.builder import build_detector
    from .models.layers import init_weights

    dev = resolve_device(device)
    model_cfg = parta2_model_cfg(tiny)
    model = init_weights(build_detector(model_cfg), seed).to(dev).eval()
    if tiny:
        pcr = PARTA2_TINY_RANGE

        def batch_fn(b, seed=0):
            return synthetic_kitti_batch(
                b, num_points=1024, img_hw=(8, 8), num_gt=8, seed=seed,
                pcr=pcr, gt_range=(pcr[0], pcr[1], pcr[3], pcr[4]))
    else:
        def batch_fn(b, seed=0):
            return synthetic_kitti_batch(b, seed=seed)
    return model, batch_fn


# FCOS3D: nuScenes' 1600 x 900 camera padded to a multiple of 32 (the
# reference mono pipeline's Pad(size_divisor=32)) and a CAM_FRONT-like
# intrinsic
FCOS3D_IMG_HW = (928, 1600)
FCOS3D_VALID_HW = (900, 1600)
NUSCENES_CAM_INTRINSIC = ((1266.417, 0.0, 816.267), (0.0, 1266.417, 491.507),
                          (0.0, 0.0, 1.0))
# the tiny FCOS3D of the JAX package's test (tests/test_models/
# test_fcos3d.py): a 64 x 96 image, 3 classes, 4 attributes
FCOS3D_TINY_HW = (64, 96)


def synthetic_mono_batch(batch_size: int, seed: int = 0,
                         img_hw=FCOS3D_IMG_HW, valid_hw=FCOS3D_VALID_HW,
                         intrinsic=NUSCENES_CAM_INTRINSIC, num_gt: int = 24,
                         num_classes: int = 10, num_attrs: int = 9,
                         depth_range=(5.0, 60.0)) -> dict:
    """A camera batch of the FCOS3D head's contract
    (``models/dense_heads/fcos_mono3d_head.py``): one view a sample, (B,
    H, W, 3) in [0, 1) over ``valid_hw`` and zero padding below and right
    of it, a 4x4 ``cam2img`` from ``intrinsic``, and ``num_gt`` padded GT
    rows (between half and all valid) whose projected centres lie inside
    the valid image at ``depth_range`` metres: camera-frame 9-dim boxes
    (x, y, z, sizes U(0.5, 4), yaw U(-pi, pi), vx, vz U(-1, 1)) whose
    centre projects to ``centers2d``, ``depths`` = z, and the 2D box
    around the centre of half-size ``f * size / (2 z)`` clipped to the
    image; labels and attributes uniform."""
    rng = np.random.default_rng(seed)
    h, w = img_hw
    vh, vw = valid_hw
    img = np.zeros((batch_size, h, w, 3), np.float32)
    img[:, :vh, :vw] = rng.uniform(size=(batch_size, vh, vw, 3))
    k = np.asarray(intrinsic, np.float32)
    cam2img = np.broadcast_to(np.eye(4, dtype=np.float32),
                              (batch_size, 4, 4)).copy()
    cam2img[:, :3, :3] = k
    shape = (batch_size, num_gt)
    u = rng.uniform(0.02 * vw, 0.98 * vw, shape).astype(np.float32)
    v = rng.uniform(0.02 * vh, 0.98 * vh, shape).astype(np.float32)
    z = rng.uniform(*depth_range, shape).astype(np.float32)
    boxes = np.zeros(shape + (9,), np.float32)
    boxes[..., 0] = (u - k[0, 2]) * z / k[0, 0]
    boxes[..., 1] = (v - k[1, 2]) * z / k[1, 1]
    boxes[..., 2] = z
    boxes[..., 3:6] = rng.uniform(0.5, 4.0, shape + (3,))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, shape)
    boxes[..., 7:9] = rng.uniform(-1.0, 1.0, shape + (2,))
    half_w = k[0, 0] * np.maximum(boxes[..., 3], boxes[..., 5]) / (2 * z)
    half_h = k[1, 1] * boxes[..., 4] / (2 * z)
    gt2d = np.stack([np.clip(u - half_w, 0, vw), np.clip(v - half_h, 0, vh),
                     np.clip(u + half_w, 0, vw), np.clip(v + half_h, 0, vh)],
                    -1).astype(np.float32)
    gt_mask = np.arange(num_gt)[None, :] < rng.integers(
        max(num_gt // 2, 1), num_gt + 1, (batch_size, 1))
    return dict(img=img, cam2img=cam2img, gt_bboxes=gt2d,
                centers2d=np.stack([u, v], -1), depths=z, gt_bboxes_3d=boxes,
                gt_labels_3d=rng.integers(0, num_classes, shape),
                attr_labels=rng.integers(0, num_attrs, shape),
                gt_mask=gt_mask)


def fcos3d_model_cfg(tiny: bool = False) -> dict:
    """FCOS3D's model config dict. Full width: the config as written
    (ResNet-101 caffe, ``frozen_stages=1``, ``norm_eval``; FPN from C3 with
    two extra convs on P5's output; the GN head with 10 classes and 9
    attributes; ``max_per_img`` 200), the backbone, neck and head convs in
    bf16 (GN statistics, decode and losses float32). ``tiny``: the JAX
    package's test model (``tests/test_models/test_fcos3d.py``): a
    ResNet-18 of base width 8 (stages 2-4), a 3-level FPN of 16 channels,
    a one-conv head of 16 channels over strides 8-32, 3 classes, 4
    attributes, GN of 4 groups, the top 16; float32."""
    from .config import Config

    if not tiny:
        model_cfg = copy.deepcopy(dict(Config.fromfile(FCOS3D_CFG).model))
        for key in ("backbone", "neck", "bbox_head"):
            model_cfg[key] = dict(model_cfg[key], compute_dtype="bfloat16")
        return model_cfg
    return dict(
        type="FCOSMono3D",
        backbone=dict(type="ResNet", depth=18, base_channels=8,
                      out_indices=(1, 2, 3)),
        neck=dict(type="FPN", in_channels=[16, 32, 64], out_channels=16,
                  start_level=0, num_outs=3),
        bbox_head=dict(
            type="FCOSMono3DHead", num_classes=3, in_channels=16,
            feat_channels=16, stacked_convs=1, strides=(8, 16, 32),
            regress_ranges=((-1, 48), (48, 96), (96, 1e8)),
            cls_branch=(16,), reg_branch=((16,), (16,), (16,), (16,), ()),
            dir_branch=(16,), attr_branch=(16,), centerness_branch=(16,),
            num_attrs=4, norm_cfg=dict(type="GN", num_groups=4)),
        test_cfg=dict(max_per_img=16))


def fcos3d_optim_cfg() -> dict:
    """FCOS3D's training recipe: ``optimizer`` (SGD, lr 0.002, momentum
    0.9, weight decay 1e-4, biases at 2x the lr and no decay),
    ``optimizer_config`` (clip 35), ``lr_config`` (step at epochs 8 and
    11, linear warmup over 500 steps from a third of the lr),
    ``momentum_config`` (None), ``samples_per_gpu`` 2 (the ``2x8`` of the
    config's name) and ``max_epochs`` 12."""
    from .config import Config

    cfg = Config.fromfile(FCOS3D_CFG)
    out = {k: copy.deepcopy(dict(cfg[k])) for k in (
        "optimizer", "optimizer_config", "lr_config")}
    out["momentum_config"] = None
    out["samples_per_gpu"] = 2
    out["max_epochs"] = int(cfg["runner"]["max_epochs"])
    return out


def build_fcos3d(tiny: bool = False, device=None, seed: int = 0
                 ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): FCOS3D (``FCOSMono3D``) with weights drawn from
    ``seed``, in eval mode on ``device`` (default: the CUDA card; raises
    if it is missing), and ``batch_fn(batch_size, seed=0)`` giving a
    numpy camera batch (``synthetic_mono_batch``; full width: one 928 x
    1600 view, 24 padded GT rows over 10 classes and 9 attributes; tiny:
    the JAX test's 64 x 96 view, focal 50, 4 GT rows over 3 classes and 4
    attributes at 5-40 m)."""
    from .models.builder import build_detector
    from .models.layers import init_weights

    dev = resolve_device(device)
    model = init_weights(build_detector(fcos3d_model_cfg(tiny)), seed).to(
        dev).eval()
    if tiny:
        h, w = FCOS3D_TINY_HW

        def batch_fn(b, seed=0):
            return synthetic_mono_batch(
                b, seed, img_hw=(h, w), valid_hw=(h, w),
                intrinsic=((50.0, 0.0, w / 2), (0.0, 50.0, h / 2),
                           (0.0, 0.0, 1.0)), num_gt=4, num_classes=3,
                num_attrs=4, depth_range=(5.0, 40.0))
    else:
        def batch_fn(b, seed=0):
            return synthetic_mono_batch(b, seed)
    return model, batch_fn


# The LiDAR detectors built from ported parts, tiny (no config in
# configs/): DynamicVoxelNet on DynamicSimpleVFE, on dynamic pillars
# (DynamicPillarFeatureNet) and on DynamicVFE, DynamicCenterPoint on
# DynamicVFE, VoxelNet on hard voxels and TransFusion-L, over a 12.8 m
# scene at 0.2 x 0.2 x 0.4 m voxels (a 64 x 64 x 10 grid, a 32 x 32 BEV)
# or 0.4 m pillars (a 32 x 32 BEV)
LIDAR_VARIANTS = ("dynamic_simple", "dynamic_pillar", "dynamic_centerpoint",
                  "voxelnet", "dynamic_voxelnet", "transfusion_l")
LIDAR_TINY_RANGE = [-6.4, -6.4, -3.0, 6.4, 6.4, 1.0]
# the kernels each variant's predict (and train) path launches
LIDAR_VARIANT_KERNELS = {
    "dynamic_simple": dict(predict=("dynamic_voxelize", "dynamic_scatter",
                                    "masked_gather", "nms_circle"),
                           train=("gaussian_heatmap",)),
    "dynamic_pillar": dict(predict=("dynamic_voxelize", "dynamic_scatter",
                                    "nms_bev"), train=()),
    "dynamic_centerpoint": dict(predict=("dynamic_voxelize",
                                         "dynamic_scatter", "masked_gather",
                                         "nms_circle"),
                                train=("gaussian_heatmap",)),
    "voxelnet": dict(predict=("masked_gather", "nms_bev"), train=()),
    "dynamic_voxelnet": dict(predict=("dynamic_voxelize", "dynamic_scatter",
                                      "masked_gather", "nms_bev"), train=()),
    "transfusion_l": dict(predict=("masked_gather",),
                          train=("boxes_iou_3d", "gaussian_heatmap")),
}


def lidar_variant_model_cfg(name: str) -> dict:
    """The tiny model config of a ``LIDAR_VARIANTS`` entry, float32, the
    JAX package's voxel and column caps above what the scene holds. A
    2-stage SparseEncoder (MVX-Net's tiny one) -> SECOND (16, 32) ->
    SECONDFPN (16, 16) gives a 32-channel 32 x 32 BEV map to one of three
    heads: CenterPoint's six-task CenterHead (narrow), the 10-class
    nuScenes Anchor3DHead of PointPillars, or the tiny flagship's
    TransFusionHeadV2 (16 proposals, dropout off):

    - ``dynamic_simple``: DynamicVoxelNet, DynamicSimpleVFE (the 5 point
      features' mean a voxel), CenterHead (a VoxelNet: the JAX package's
      DynamicCenterPoint hands its voxel encoder image arguments that
      DynamicSimpleVFE does not take);
    - ``dynamic_centerpoint``: DynamicCenterPoint, DynamicVFE (16, 16),
      CenterHead;
    - ``dynamic_pillar``: DynamicVoxelNet, DynamicPillarFeatureNet (16) on
      0.4 m pillars -> PointPillarsScatter -> the tiny PointPillars'
      SECOND and SECONDFPN -> Anchor3DHead;
    - ``voxelnet``: VoxelNet, hard voxels -> HardSimpleVFE ->
      Anchor3DHead;
    - ``dynamic_voxelnet``: DynamicVoxelNet, DynamicVFE -> Anchor3DHead;
    - ``transfusion_l``: TransFusionDetector, hard voxels ->
      HardSimpleVFE -> TransFusionHeadV2."""
    if name not in LIDAR_VARIANTS:
        raise KeyError(f"unknown LiDAR variant {name!r}: {LIDAR_VARIANTS}")
    cp = centerpoint_model_cfg(tiny=True)
    pp = pointpillars_model_cfg(tiny=True)
    pcr = list(LIDAR_TINY_RANGE)
    vs = [0.2, 0.2, 0.4]
    n, nz, cap, osf = 64, 10, 2048, 2
    hard_layer = dict(max_num_points=10, point_cloud_range=pcr,
                      voxel_size=vs, max_voxels=(cap, cap))
    dyn_layer = dict(hard_layer, max_num_points=-1)
    dvfe = dict(type="DynamicVFE", in_channels=5, feat_channels=[16, 16],
                with_cluster_center=True, with_voxel_center=True,
                voxel_size=vs, point_cloud_range=pcr,
                norm_cfg=dict(type="BN1d", eps=1e-3, momentum=0.01))
    simple = dict(type="HardSimpleVFE", num_features=5)

    def sparse(cin):
        return dict(type="SparseEncoder", in_channels=cin,
                    sparse_shape=[nz + 1, n, n], order=("conv", "norm", "act"),
                    base_channels=8, output_channels=16,
                    encoder_channels=((8,), (16, 16)),
                    encoder_paddings=((1,), (1, 1)),
                    stage_cap_ratios=tuple((n >> i) ** 2 / cap + 1e-9
                                           for i in range(2)),
                    dilation_ratio=1.0)

    bev = dict(backbone=dict(cp["pts_backbone"], in_channels=32),
               neck=cp["pts_neck"])
    anchor = dict(pp["pts_bbox_head"], in_channels=32, feat_channels=32)
    anchor["anchor_generator"] = dict(
        anchor["anchor_generator"],
        ranges=[[pcr[0], pcr[1], r[2], pcr[3], pcr[4], r[5]]
                for r in anchor["anchor_generator"]["ranges"]])
    lidar_cfgs = dict(train_cfg=pp["train_cfg"], test_cfg=pp["test_cfg"])

    def voxelnet(kind, layer, vfe, middle, backbone=bev["backbone"],
                 neck=bev["neck"], head=anchor):
        return dict(type=kind, voxel_layer=layer, voxel_encoder=vfe,
                    middle_encoder=middle, backbone=backbone, neck=neck,
                    bbox_head=head, **lidar_cfgs)

    if name == "voxelnet":
        return voxelnet("VoxelNet", hard_layer, simple, sparse(5))
    if name == "dynamic_voxelnet":
        return voxelnet("DynamicVoxelNet", dyn_layer, dvfe, sparse(16))
    if name == "dynamic_pillar":
        pvs = [0.4, 0.4, pcr[5] - pcr[2]]
        return voxelnet(
            "DynamicVoxelNet", dict(dyn_layer, voxel_size=pvs),
            dict(dvfe, type="DynamicPillarFeatureNet", feat_channels=[16],
                 voxel_size=pvs),
            dict(pp["pts_middle_encoder"], output_shape=[32, 32]),
            pp["pts_backbone"], pp["pts_neck"],
            dict(anchor, in_channels=48, feat_channels=48))
    grid = dict(point_cloud_range=pcr, grid_size=[n, n, nz],
                voxel_size=vs, out_size_factor=osf)
    if name == "transfusion_l":
        fl = flagship_model_cfg(tiny=True, dropout=False)
        head = dict(fl["pts_bbox_head"], in_channels=32)
        head["bbox_coder"] = dict(head["bbox_coder"], pc_range=pcr[:2],
                                  voxel_size=vs[:2], out_size_factor=osf,
                                  post_center_range=[-8.0, -8.0, -10.0,
                                                     8.0, 8.0, 10.0])
        train = dict(dict(fl["train_cfg"])["pts"], **grid)
        test = dict(dict(fl["test_cfg"])["pts"], grid_size=[n, n, nz],
                    out_size_factor=osf, pc_range=pcr[:2],
                    voxel_size=vs[:2])
        return dict(type="TransFusionDetector", pts_voxel_layer=hard_layer,
                    pts_voxel_encoder=simple, pts_middle_encoder=sparse(5),
                    pts_backbone=bev["backbone"], pts_neck=bev["neck"],
                    pts_bbox_head=head, train_cfg=dict(pts=train),
                    test_cfg=dict(pts=test))
    head = dict(cp["pts_bbox_head"])
    head["bbox_coder"] = dict(head["bbox_coder"], pc_range=pcr[:2],
                              voxel_size=vs[:2], out_size_factor=osf,
                              post_center_range=[-8.0, -8.0, -10.0, 8.0,
                                                 8.0, 10.0])
    center_cfgs = dict(
        train_cfg=dict(pts=dict(cp["train_cfg"]["pts"], **grid)),
        test_cfg=dict(pts=dict(cp["test_cfg"]["pts"], voxel_size=vs[:2],
                               out_size_factor=osf, pc_range=pcr[:2],
                               post_center_limit_range=[-8.0, -8.0, -10.0,
                                                        8.0, 8.0, 10.0])))
    if name == "dynamic_simple":
        return dict(voxelnet("DynamicVoxelNet", dyn_layer,
                             dict(simple, type="DynamicSimpleVFE"),
                             sparse(5), head=head), **center_cfgs)
    return dict(type="DynamicCenterPoint", pts_voxel_layer=dyn_layer,
                pts_voxel_encoder=dvfe, pts_middle_encoder=sparse(16),
                pts_backbone=bev["backbone"], pts_neck=bev["neck"],
                pts_bbox_head=head, **center_cfgs)


def build_lidar_variant(name: str, device=None, seed: int = 0
                        ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn) of a ``LIDAR_VARIANTS`` entry with weights drawn
    from ``seed``, in eval mode on ``device`` (default: the CUDA card;
    raises if it is missing); ``batch_fn(batch_size, seed=0,
    reflectance=False)``: 2,048 points over the 12.8 m scene
    (``synthetic_points_batch``: nuScenes' raw 0-255 intensity, or with
    ``reflectance`` that intensity scaled into [0, 1) as KITTI's) and 8
    padded GT boxes over the 10 classes."""
    from .models.builder import build_detector
    from .models.layers import init_weights

    dev = resolve_device(device)
    model_cfg = lidar_variant_model_cfg(name)
    model = init_weights(build_detector(model_cfg), seed).to(dev).eval()
    layer = model_cfg.get("pts_voxel_layer", model_cfg.get("voxel_layer"))
    pcr = tuple(layer["point_cloud_range"])

    def batch_fn(b, seed=0, reflectance=False):
        batch = synthetic_points_batch(b, num_points=2048, num_gt=8,
                                       seed=seed, pcr=pcr)
        if reflectance:
            batch["points"][..., 3] /= 255.0
        batch["gt_labels_3d"] = np.random.default_rng(seed + 1).integers(
            0, 10, batch["gt_labels_3d"].shape)
        return batch
    return model, batch_fn


# SSN (mmdet3d configs/ssn/hv_ssn_secfpn_sbn-all_2x16_2x_nus-3d.py) on
# the PointPillars config's voxels, HardVFE, scatter, SECOND, SECONDFPN
# and schedule_2x: the classes in the reference's task order, their
# anchor sizes and z (motorcycle, bus and construction_vehicle from the
# reference SSN config, the rest equal to the PointPillars config's)
SSN_CLASSES = ("bicycle", "motorcycle", "pedestrian", "traffic_cone",
               "barrier", "car", "truck", "trailer", "bus",
               "construction_vehicle")
SSN_SIZES = ((0.60058911, 1.68452161, 1.27192197),
             (0.76279481, 2.09973778, 1.44403034),
             (0.66344886, 0.7256437, 1.75748069),
             (0.39694519, 0.40359262, 1.06232151),
             (2.49008838, 0.48578221, 0.98297065),
             (1.95017717, 4.60718145, 1.72270761),
             (2.4560939, 6.73778078, 2.73004906),
             (2.87427237, 12.01320693, 3.81509561),
             (2.94046906, 11.1885991, 3.47030982),
             (2.73050468, 6.38352896, 3.13312415))
SSN_Z = (-1.67339111, -1.71396371, -1.61785072, -1.80984986, -1.763965,
         -1.80032795, -1.74440365, -1.68526504, -1.80673031, -1.64824291)
SSN_TASKS = (dict(num_class=2, shared_conv_channels=(64, 64),
                  shared_conv_strides=(1, 1)),
             dict(num_class=1, shared_conv_channels=(64, 64),
                  shared_conv_strides=(1, 1)),
             dict(num_class=2, shared_conv_channels=(64, 64),
                  shared_conv_strides=(1, 1)),
             dict(num_class=1, shared_conv_channels=(64, 64, 64),
                  shared_conv_strides=(2, 1, 1)),
             dict(num_class=4, shared_conv_channels=(64, 64, 64),
                  shared_conv_strides=(2, 1, 1)))
# the tiny SSN head: the two tasks of the JAX package's ShapeAwareHead
# test over three sizes
SSN_TINY_TASKS = (dict(num_class=1, shared_conv_channels=(16, 16),
                       shared_conv_strides=(1, 1)),
                  dict(num_class=2, shared_conv_channels=(16, 16, 16),
                       shared_conv_strides=(2, 1, 1)))
SSN_TINY_SIZES = ((0.6, 0.6, 1.7), (1.9, 4.6, 1.7), (2.9, 10.5, 3.2))

# regnetx_400mf (mmdet's arch table) written out, as the JAX package
# takes it; the tiny arch is the JAX package's RegNet test's at depth 8
# (stages 24, 64, 152)
REGNETX_400MF = dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22,
                     bot_mul=1.0)
REGNET_TINY = dict(w0=24, wa=24.48, wm=2.54, group_w=8, depth=8,
                   bot_mul=1.0)
# FreeAnchor on RegNetX-400MF + FPN (mmdet3d configs/free_anchor/
# hv_pointpillars_regnet-400mf_fpn_sbn-all_free-anchor_4x8_2x_nus-3d.py):
# the reference base config's FPN-level anchors, one scale a level
FREE_ANCHOR_SIZES = ((0.8660, 2.5981, 1.0), (0.5774, 1.7321, 1.0),
                     (1.0, 1.0, 1.0), (0.4, 0.4, 1.0))

def ssn_model_cfg(tiny: bool = False) -> dict:
    """The SSN model config: the PointPillars config's voxels, HardVFE,
    scatter, SECOND and SECONDFPN (``pointpillars_model_cfg``) with the
    ShapeAwareHead of the reference SSN config (384 channels in, five
    tasks over the ten classes, their sizes and z over +-50 m,
    ``assign_per_class``), the PointPillars config's assigner (the JAX
    head reads one), code weights and test config. ``tiny``: the tiny
    PointPillars with the two tasks of the JAX package's ShapeAwareHead
    test over three classes, float32."""
    cfg = pointpillars_model_cfg(tiny)
    head = dict(cfg["pts_bbox_head"], type="ShapeAwareHead",
                assign_per_class=True)
    gen = dict(head["anchor_generator"], type="AlignedAnchor3DRangeGenerator",
               custom_values=[0, 0], rotations=[0, 1.57], reshape_out=False)
    if tiny:
        gen.update(ranges=[[-8, -8, -1.8, 8, 8, -1.8]],
                   sizes=[list(s) for s in SSN_TINY_SIZES])
        head.update(num_classes=3, tasks=[dict(t) for t in SSN_TINY_TASKS])
    else:
        gen.update(ranges=[[-50, -50, z, 50, 50, z] for z in SSN_Z],
                   sizes=[list(s) for s in SSN_SIZES])
        head.update(num_classes=10, tasks=[dict(t) for t in SSN_TASKS])
    head["anchor_generator"] = gen
    cfg["pts_bbox_head"] = head
    return cfg


def ssn_optim_cfg() -> dict:
    """SSN's recipe: the PointPillars config's ``schedule_2x`` at
    ``samples_per_gpu`` 2 (the reference config's ``2x16``)."""
    return dict(pointpillars_optim_cfg(), samples_per_gpu=2)


def free_anchor_model_cfg(tiny: bool = False) -> dict:
    """The FreeAnchor model config: the PointPillars config's voxels,
    HardVFE and scatter, NoStemRegNet regnetx_400mf (``base_channels``
    64, strides (1, 2, 2, 2), stages 1-3 out) -> FPN (64, 160, 384) -> 256
    with BN and ReLU, three levels -> FreeAnchor3DHead (10 classes, 256
    channels, ``pre_anchor_topk`` 25, ``bbox_thr`` 0.5, ``gamma`` 2,
    ``alpha`` 0.5) with the reference base config's FPN-level anchors
    (AlignedAnchor3DRangeGenerator over +-50 m, scales 1, 2, 4: 420,000
    anchors at full width). ``tiny``: the tiny PointPillars' voxels and
    scatter (16 channels, 32 x 32), the tiny RegNet (stages 24, 64, 152,
    strides (1, 2, 2)) -> FPN 16 -> the head over three sizes at
    ``pre_anchor_topk`` 8, float32."""
    cfg = pointpillars_model_cfg(tiny)
    dt = cfg["pts_backbone"]["compute_dtype"]
    # the tiny model's norms are the JAX RegNet's default (BN2d, eps
    # 1e-5): with the reference's eps 1e-3 the tiny RegNet's seeded train
    # gradients in float32 lie 8e-4 of their max from the same model's in
    # float64 (1.4e-5 with BN2d), too close to the 1e-3 that holds the
    # card against the CPU in float32; the CPU tests hold both settings
    # against the JAX package in float64
    bn = dict(type="BN2d") if tiny else dict(type="naiveSyncBN2d", eps=1e-3,
                                             momentum=0.01)
    pp_head = cfg["pts_bbox_head"]
    if tiny:
        arch, base, strides, outs = REGNET_TINY, 16, (1, 2, 2), (0, 1, 2)
        widths, ch, topk = [24, 64, 152], 16, 8
        sizes = [[1.95, 4.6, 1.72], [0.6, 1.68, 1.27], [0.66, 0.72, 1.75]]
        rng, nc = [[-8, -8, -1.8, 8, 8, -1.8]], 3
    else:
        arch, base, strides, outs = REGNETX_400MF, 64, (1, 2, 2, 2), \
            (1, 2, 3)
        widths, ch, topk = [64, 160, 384], 256, 25
        sizes = [list(s) for s in FREE_ANCHOR_SIZES]
        rng, nc = [[-50, -50, -1.8, 50, 50, -1.8]], 10
    cfg["pts_backbone"] = dict(
        type="NoStemRegNet", arch=dict(arch), base_channels=base,
        strides=strides, out_indices=outs, norm_cfg=dict(bn),
        compute_dtype=dt)
    cfg["pts_neck"] = dict(type="FPN", in_channels=widths, out_channels=ch,
                           start_level=0, num_outs=3, norm_cfg=dict(bn),
                           act_cfg=dict(type="ReLU"), compute_dtype=dt)
    cfg["pts_bbox_head"] = dict(
        type="FreeAnchor3DHead", num_classes=nc, in_channels=ch,
        feat_channels=ch, use_direction_classifier=True,
        pre_anchor_topk=topk, bbox_thr=0.5, gamma=2.0, alpha=0.5,
        anchor_generator=dict(
            type="AlignedAnchor3DRangeGenerator", ranges=rng,
            scales=[1, 2, 4], sizes=sizes, custom_values=[0, 0],
            rotations=[0, 1.57], reshape_out=True),
        assigner_per_size=False, diff_rad_by_sin=True, dir_offset=0.7854,
        dir_limit_offset=0, bbox_coder=pp_head["bbox_coder"],
        loss_cls=pp_head["loss_cls"],
        loss_bbox=dict(type="SmoothL1Loss", beta=1.0 / 9.0,
                       loss_weight=0.8),
        loss_dir=pp_head["loss_dir"], compute_dtype=dt)
    cfg["train_cfg"] = copy.deepcopy(cfg["train_cfg"])
    cfg["train_cfg"]["pts"]["code_weight"] = [1.0] * 7 + [0.25, 0.25]
    return cfg


def free_anchor_optim_cfg() -> dict:
    """FreeAnchor's recipe: the PointPillars config's ``schedule_2x`` at
    ``samples_per_gpu`` 4 (the reference config's ``4x8``)."""
    return pointpillars_optim_cfg()


def _build_pointpillars_family(model_cfg: dict, tiny: bool, device,
                               seed: int):
    from .models.builder import build_detector
    from .models.layers import init_weights

    dev = resolve_device(device)
    model = init_weights(build_detector(model_cfg), seed).to(dev).eval()
    classes = int(model_cfg["pts_bbox_head"]["num_classes"])
    pcr = tuple(model_cfg["pts_voxel_layer"]["point_cloud_range"])
    points, gts = (2048, 8) if tiny else (120000, 64)

    def batch_fn(b, seed=0):
        batch = synthetic_points_batch(b, num_points=points, num_gt=gts,
                                       seed=seed, pcr=pcr)
        batch["gt_labels_3d"] = np.random.default_rng(seed + 1).integers(
            0, classes, batch["gt_labels_3d"].shape)
        return batch
    return model, batch_fn


def build_ssn(tiny: bool = False, device=None, seed: int = 0
              ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): SSN (``ssn_model_cfg``, ``MVXFasterRCNN``) with
    weights drawn from ``seed``, in eval mode on ``device`` (default: the
    CUDA card; raises if it is missing); ``batch_fn(batch_size, seed=0)``:
    the PointPillars cloud (120,000 points, 64 padded GT rows; tiny: 2,048
    and 8) with GT labels over the model's classes."""
    return _build_pointpillars_family(ssn_model_cfg(tiny), tiny, device,
                                      seed)


def build_free_anchor(tiny: bool = False, device=None, seed: int = 0
                      ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): FreeAnchor on RegNetX-400MF + FPN
    (``free_anchor_model_cfg``, ``MVXFasterRCNN``), as ``build_ssn``."""
    return _build_pointpillars_family(free_anchor_model_cfg(tiny), tiny,
                                      device, seed)


# ImVoxelNet: mmdet3d's configs/imvoxelnet/imvoxelnet_kitti-3d-car.py (one
# class, Car; the images at the KITTI test scale 384 x 1280)
IMVOXELNET_RANGE = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
IMVOXELNET_IMG_HW = (384, 1280)
# the JAX package's tiny ImVoxelNet (tests/test_models/test_imvoxelnet.py);
# its batch here is 48 x 160 (the KITTI camera's aspect) with the KITTI
# lidar2img scaled to it
IMVOXELNET_TINY_RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 1.0)
IMVOXELNET_TINY_HW = (48, 160)


def imvoxelnet_model_cfg(tiny: bool = False) -> dict:
    """ImVoxelNet's model config dict. Full width: mmdet3d's
    ``imvoxelnet_kitti-3d-car.py``: ResNet-50 (``frozen_stages=1``, BN
    without gradients, ``norm_eval``), FPN [256, 512, 1024, 2048] -> 64
    with four outputs, a (216, 248, 12) volume of 0.32 x 0.32 x 0.33 m
    voxels over [0, -39.68, -3, 69.12, 39.68, 1], OutdoorImVoxelNeck 64
    -> 256, a one-class Anchor3DHead (256 wide; the Car anchor at z -1.78,
    rotations 0 and 1.57; focal loss, smooth-L1 with beta 1/9 and weight
    2, direction loss 0.2; assigner IoU 0.6 / 0.45 / 0.45; test top 100,
    rotated NMS at 0.01, scores above 0.1, 50 kept). The backbone, the
    FPN, the 3D neck and the head compute in bf16; the lift, targets,
    losses, decode and NMS in float32. ``tiny``: the JAX package's test
    model (ResNet-18 of base width 8 to its third stage, a one-level FPN
    16 wide, a 16 x 16 x 4 volume of 1 m voxels, a 16-wide neck and
    head), float32. The JAX ResNet reads ``frozen_stages`` and freezes
    nothing; the port freezes as the reference (ROADMAP queue 3)."""
    head = dict(
        type="Anchor3DHead", num_classes=1, in_channels=256,
        feat_channels=256,
        anchor_generator=dict(
            type="AlignedAnchor3DRangeGenerator",
            ranges=[[-0.16, -39.68, -1.78, 68.96, 39.68, -1.78]],
            sizes=[[1.6, 3.9, 1.56]], rotations=[0, 1.57],
            reshape_out=True),
        bbox_coder=dict(type="DeltaXYZWLHRBBoxCoder", code_size=7),
        loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                      alpha=0.25, loss_weight=1.0),
        loss_bbox=dict(type="SmoothL1Loss", beta=1.0 / 9.0, loss_weight=2.0),
        loss_dir=dict(type="CrossEntropyLoss", loss_weight=0.2))
    cfg = dict(
        type="ImVoxelNet",
        backbone=dict(type="ResNet", depth=50, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      norm_cfg=dict(type="BN", requires_grad=False),
                      norm_eval=True, style="pytorch"),
        neck=dict(type="FPN", in_channels=[256, 512, 1024, 2048],
                  out_channels=64, num_outs=4),
        neck_3d=dict(type="OutdoorImVoxelNeck", in_channels=64,
                     out_channels=256),
        n_voxels=(216, 248, 12), voxel_size=(0.32, 0.32, 0.33),
        point_cloud_range=list(IMVOXELNET_RANGE), bbox_head=head,
        train_cfg=dict(assigner=dict(pos_iou_thr=0.6, neg_iou_thr=0.45,
                                     min_pos_iou=0.45),
                       code_weight=[1.0] * 7),
        test_cfg=dict(use_rotate_nms=True, nms_pre=100, nms_thr=0.01,
                      score_thr=0.1, max_num=50))
    if not tiny:
        for key in ("backbone", "neck", "neck_3d", "bbox_head"):
            cfg[key] = dict(cfg[key], compute_dtype="bfloat16")
        return cfg
    pcr = list(IMVOXELNET_TINY_RANGE)
    cfg.update(
        backbone=dict(type="ResNet", depth=18, base_channels=8,
                      out_indices=(2,)),
        neck=dict(type="FPN", in_channels=[32], out_channels=16,
                  num_outs=1),
        neck_3d=dict(type="OutdoorImVoxelNeck", in_channels=16,
                     out_channels=16),
        n_voxels=(16, 16, 4), voxel_size=(1.0, 1.0, 1.0),
        point_cloud_range=pcr,
        bbox_head=dict(head, in_channels=16, feat_channels=16,
                       anchor_generator=dict(
                           head["anchor_generator"],
                           ranges=[[-8, -8, -1.8, 8, 8, -1.8]],
                           sizes=[[1.9, 4.5, 1.7]]),
                       loss_bbox=dict(type="SmoothL1Loss", beta=1.0 / 9.0,
                                      loss_weight=1.0)),
        train_cfg=dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.3,
                                     min_pos_iou=0.3),
                       code_weight=[1.0] * 7),
        test_cfg=dict(nms_pre=32, nms_thr=0.3, score_thr=0.0, max_num=8))
    return cfg


def imvoxelnet_optim_cfg() -> dict:
    """ImVoxelNet's training recipe (mmdet3d's config): ``optimizer``
    (AdamW, lr 1e-4, weight decay 1e-4, the backbone at ``lr_mult`` 0.1),
    ``optimizer_config`` (clip 35), ``lr_config`` (step at epochs 8 and
    11), ``momentum_config`` (None), ``samples_per_gpu`` 4 and
    ``max_epochs`` 12."""
    return dict(
        optimizer=dict(type="AdamW", lr=1e-4, weight_decay=1e-4,
                       paramwise_cfg=dict(custom_keys={
                           "backbone": dict(lr_mult=0.1, decay_mult=1.0)})),
        optimizer_config=dict(grad_clip=dict(max_norm=35.0, norm_type=2)),
        lr_config=dict(policy="step", step=[8, 11]),
        momentum_config=None, samples_per_gpu=4, max_epochs=12)


def synthetic_imvoxelnet_batch(batch_size: int,
                               img_hw=IMVOXELNET_IMG_HW, num_gt: int = 8,
                               seed: int = 0,
                               gt_range=(3.0, -25.0, 60.0, 25.0)) -> dict:
    """One-view camera batch: img (B, H, W, 3) uniform in [0, 1), the
    KITTI-like lidar2img (B, 4, 4) (``testing.kitti_lidar2img`` at this
    size), and Car GT boxes (B, G, 7) of the KITTI car anchor's size
    scaled by U(0.8, 1.2) and its bottom height, inside ``gt_range`` (x0,
    y0, x1, y1), padded with a mask (labels 0)."""
    from .testing import kitti_lidar2img

    rng = np.random.default_rng(seed)
    h, w = img_hw
    img = rng.uniform(size=(batch_size, h, w, 3)).astype(np.float32)
    l2i = np.broadcast_to(kitti_lidar2img(img_hw),
                          (batch_size, 4, 4)).copy()
    boxes = np.zeros((batch_size, num_gt, 7), np.float32)
    x0, y0, x1, y1 = gt_range
    boxes[..., 0] = rng.uniform(x0, x1, (batch_size, num_gt))
    boxes[..., 1] = rng.uniform(y0, y1, (batch_size, num_gt))
    boxes[..., 2] = KITTI_CLASS_Z[2]
    boxes[..., 3:6] = np.asarray(KITTI_CLASS_SIZES[2], np.float32) * \
        rng.uniform(0.8, 1.2, (batch_size, num_gt, 1))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (batch_size, num_gt))
    gt_mask = np.arange(num_gt)[None, :] < rng.integers(
        max(num_gt // 2, 1), num_gt + 1, (batch_size, 1))
    return dict(img=img, lidar2img=l2i, gt_bboxes_3d=boxes,
                gt_labels_3d=np.zeros((batch_size, num_gt), np.int64),
                gt_mask=gt_mask)


def build_imvoxelnet(tiny: bool = False, device=None, seed: int = 0
                     ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): ImVoxelNet with weights drawn from ``seed``, in
    eval mode on ``device`` (default: the CUDA card; raises if it is
    missing), and ``batch_fn(batch_size, seed=0)`` giving a one-view numpy
    batch (``synthetic_imvoxelnet_batch``; full width: 384 x 1280, 8
    padded Car rows at 3-60 m; tiny: 48 x 160, 4 rows at 1-7 m)."""
    from .models.builder import build_detector
    from .models.layers import init_weights

    dev = resolve_device(device)
    model = init_weights(build_detector(imvoxelnet_model_cfg(tiny)),
                         seed).to(dev).eval()
    if tiny:
        def batch_fn(b, seed=0):
            return synthetic_imvoxelnet_batch(
                b, img_hw=IMVOXELNET_TINY_HW, num_gt=4, seed=seed,
                gt_range=(1.0, -6.0, 7.0, 6.0))
    else:
        def batch_fn(b, seed=0):
            return synthetic_imvoxelnet_batch(b, seed=seed)
    return model, batch_fn


# PartA2's KITTI loop: the three classes in the anchors' order, as the
# KITTI evaluator names them
PARTA2_KITTI_CLASSES = ("pedestrian", "cyclist", "car")


def parta2_kitti_cfg(data_root: str, tiny: bool = False, epochs: int = 2,
                     max_points: int = 20000):
    """The PartA2 train -> eval loop on a KITTI layout (``tools/
    make_synthetic_kitti.py``, ``tools/kitti_converter.py``): the model of
    ``parta2_model_cfg(tiny)``, ``KittiDataset`` splits from
    ``kitti_infos_{train,val}.pkl``, the reference PartA2's KITTI train
    pipeline without its GT-database sampler (LoadPointsFromFile with 4
    dims, LoadAnnotations3D, ObjectNoise, RandomFlip3D,
    GlobalRotScaleTrans, PointsRangeFilter, ObjectRangeFilter,
    PointShuffle, DefaultFormatBundle3D padded to ``max_points``,
    Collect3D), the test pipeline (LoadPointsFromFile,
    PointsRangeFilter, the bundle, Collect3D), ``parta2_optim_cfg``'s
    recipe over ``epochs``, eval and checkpoint every epoch, every step
    logged. A ``Config``."""
    import os

    from .config import Config

    model = parta2_model_cfg(tiny)
    pcr = list(model["voxel_layer"]["point_cloud_range"])
    classes = list(PARTA2_KITTI_CLASSES)
    load = dict(type="LoadPointsFromFile", coord_type="LIDAR", load_dim=4,
                use_dim=4)
    bundle = dict(type="DefaultFormatBundle3D", class_names=classes,
                  max_points=max_points, max_gt=32)
    train_pipeline = [
        load,
        dict(type="LoadAnnotations3D", with_bbox_3d=True,
             with_label_3d=True),
        dict(type="ObjectNoise", num_try=100,
             translation_std=[1.0, 1.0, 0.5], global_rot_range=[0.0, 0.0],
             rot_range=[-0.78539816, 0.78539816]),
        dict(type="RandomFlip3D", flip_ratio_bev_horizontal=0.5),
        dict(type="GlobalRotScaleTrans", rot_range=[-0.78539816, 0.78539816],
             scale_ratio_range=[0.95, 1.05]),
        dict(type="PointsRangeFilter", point_cloud_range=pcr),
        dict(type="ObjectRangeFilter", point_cloud_range=pcr),
        dict(type="PointShuffle"),
        bundle,
        dict(type="Collect3D", keys=["points", "gt_bboxes_3d",
                                     "gt_labels_3d"])]
    test_pipeline = [
        load, dict(type="PointsRangeFilter", point_cloud_range=pcr),
        dict(bundle, with_label=False), dict(type="Collect3D",
                                             keys=["points"])]

    def split(name, pipeline, test_mode):
        return dict(type="KittiDataset", data_root=data_root,
                    ann_file=os.path.join(data_root,
                                          f"kitti_infos_{name}.pkl"),
                    pipeline=pipeline, classes=classes, test_mode=test_mode)

    optim = parta2_optim_cfg()
    return Config(dict(
        model=model,
        data=dict(samples_per_gpu=optim["samples_per_gpu"],
                  workers_per_gpu=0,
                  train=split("train", train_pipeline, False),
                  val=split("val", test_pipeline, True),
                  test=split("val", test_pipeline, True)),
        optimizer=optim["optimizer"],
        optimizer_config=optim["optimizer_config"],
        lr_config=optim["lr_config"],
        momentum_config=optim["momentum_config"],
        total_epochs=epochs, runner=dict(max_epochs=epochs),
        evaluation=dict(interval=1), checkpoint_config=dict(interval=1),
        log_config=dict(interval=1), seed=0))
