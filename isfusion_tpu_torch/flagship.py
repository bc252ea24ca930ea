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
``free_anchor_optim_cfg``: batch 2 and 4). ``build_votenet`` and
``build_h3dnet`` build the indoor VoteNet of mmdet3d's
``votenet_8x8_scannet-3d-18class.py`` and the JAX package's H3DNet on it
with a synthetic room of 40,000 points (``synthetic_indoor_batch``), and
``votenet_optim_cfg`` gives their ``schedule_3x`` recipe (AdamW, clip 10,
step lr, batch 8).
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


# ----------------------------------------------------------- indoor (VoteNet)
# ScanNet's 18 classes' mean sizes are not in this repository: 18 seeded
# sizes in 0.2-2.0 m take their place (they change no shape and no cost)
SCANNET_MEAN_SIZES = tuple(tuple(round(float(v), 4) for v in row) for row in
                           np.random.default_rng(18).uniform(0.2, 2.0,
                                                             (18, 3)))
# the JAX package's tiny VoteNet (tests/test_models/test_votenet.py)
VOTENET_TINY_SIZES = ((0.6, 0.6, 0.5), (1.0, 1.0, 1.0), (2.0, 1.0, 1.0),
                      (0.5, 0.5, 1.8))


def votenet_model_cfg(tiny: bool = False) -> dict:
    """VoteNet's model config dict. Full width: mmdet3d's
    ``votenet_8x8_scannet-3d-18class.py`` (``_base_/models/votenet.py``):
    PointNet2SASSG over xyz + height (4 channels; SA 2,048 / 1,024 / 512 /
    256 points, radii 0.2 / 0.4 / 0.8 / 1.2, 64 / 32 / 16 / 16 samples,
    widths (64, 64, 128), (128, 128, 256) x 3; FP (256, 256) x 2; max
    pool, ``use_xyz``, ``normalize_xyz``); VoteHead, 18 classes,
    PartialBinBasedBBoxCoder (1 direction bin, 18 sizes, no rotation), the
    vote module (256, 256) with ``norm_feats``, the vote aggregation (256
    points, radius 0.3, 16 samples, ``mlp_channels`` [256, 128, 128,
    128]), shared convs (128, 128). Float32 throughout, as the reference
    trains it. ``tiny``: the JAX package's test model (4 classes, 6
    direction bins with rotation, 128 / 64 / 32 / 16 points, widths 8-32)
    with ``in_channels`` 4, its points' width (the JAX package ignores
    the key; its test sets 1)."""
    head = dict(
        type="VoteHead", num_classes=18,
        bbox_coder=dict(type="PartialBinBasedBBoxCoder", num_sizes=18,
                        num_dir_bins=1, with_rot=False,
                        mean_sizes=[list(s) for s in SCANNET_MEAN_SIZES]),
        vote_module_cfg=dict(in_channels=256, vote_per_seed=1,
                             gt_per_seed=3, conv_channels=(256, 256),
                             conv_cfg=dict(type="Conv1d"),
                             norm_cfg=dict(type="BN1d"), norm_feats=True,
                             vote_loss=dict(type="ChamferDistance",
                                            mode="l1", reduction="none",
                                            loss_dst_weight=10.0)),
        vote_aggregation_cfg=dict(type="PointSAModule", num_point=256,
                                  radius=0.3, num_sample=16,
                                  mlp_channels=[256, 128, 128, 128],
                                  use_xyz=True, normalize_xyz=True),
        pred_layer_cfg=dict(in_channels=128, shared_conv_channels=(128, 128),
                            bias=True),
        feat_channels=(128, 128),
        objectness_loss=dict(type="CrossEntropyLoss",
                             class_weight=[0.2, 0.8], reduction="sum",
                             loss_weight=5.0),
        center_loss=dict(type="ChamferDistance", mode="l2",
                         reduction="sum", loss_src_weight=10.0,
                         loss_dst_weight=10.0),
        dir_class_loss=dict(type="CrossEntropyLoss", reduction="sum",
                            loss_weight=1.0),
        dir_res_loss=dict(type="SmoothL1Loss", reduction="sum",
                          loss_weight=10.0),
        size_class_loss=dict(type="CrossEntropyLoss", reduction="sum",
                             loss_weight=1.0),
        size_res_loss=dict(type="SmoothL1Loss", reduction="sum",
                           loss_weight=10.0 / 3.0),
        semantic_loss=dict(type="CrossEntropyLoss", reduction="sum",
                           loss_weight=1.0))
    cfg = dict(
        type="VoteNet",
        backbone=dict(type="PointNet2SASSG", in_channels=4,
                      num_points=(2048, 1024, 512, 256),
                      radius=(0.2, 0.4, 0.8, 1.2),
                      num_samples=(64, 32, 16, 16),
                      sa_channels=((64, 64, 128), (128, 128, 256),
                                   (128, 128, 256), (128, 128, 256)),
                      fp_channels=((256, 256), (256, 256)),
                      norm_cfg=dict(type="BN2d"),
                      sa_cfg=dict(type="PointSAModule", pool_mod="max",
                                  use_xyz=True, normalize_xyz=True)),
        bbox_head=head,
        train_cfg=dict(pos_distance_thr=0.3, neg_distance_thr=0.6,
                       sample_mod="vote"),
        test_cfg=dict(sample_mod="seed", nms_thr=0.25, score_thr=0.05,
                      per_class_proposal=True))
    if not tiny:
        return cfg
    return dict(
        type="VoteNet",
        backbone=dict(type="PointNet2SASSG", in_channels=4,
                      num_points=(128, 64, 32, 16),
                      radius=(0.4, 0.8, 1.2, 2.4), num_samples=(8, 8, 8, 8),
                      sa_channels=((8, 8, 16), (16, 16, 32), (16, 16, 32),
                                   (16, 16, 32)),
                      fp_channels=((32, 32), (32, 32))),
        bbox_head=dict(
            type="VoteHead", num_classes=4,
            bbox_coder=dict(type="PartialBinBasedBBoxCoder", num_dir_bins=6,
                            num_sizes=4, with_rot=True,
                            mean_sizes=[list(s) for s in
                                        VOTENET_TINY_SIZES]),
            vote_module_cfg=dict(in_channels=32, vote_per_seed=1,
                                 conv_channels=(32, 32)),
            vote_aggregation_cfg=dict(num_point=32, radius=0.9,
                                      num_sample=8,
                                      mlp_channels=[32, 32, 32, 32]),
            feat_channels=(32, 32)),
        test_cfg=dict(max_output_num=16))


def votenet_optim_cfg() -> dict:
    """VoteNet's training recipe (``schedule_3x``): AdamW (lr 0.008, weight
    decay 0.01), clip 10, step lr at epochs 24 and 32 with no warmup,
    ``samples_per_gpu`` 8 (``8x8``), 36 epochs."""
    return dict(optimizer=dict(type="AdamW", lr=0.008, weight_decay=0.01),
                optimizer_config=dict(grad_clip=dict(max_norm=10.0,
                                                     norm_type=2)),
                lr_config=dict(policy="step", step=[24, 32]),
                momentum_config=None, samples_per_gpu=8, max_epochs=36)


def h3dnet_model_cfg(tiny: bool = False) -> dict:
    """H3DNet, the JAX package's compact version: VoteNet's backbone and
    head (``votenet_model_cfg(tiny)``) plus the face and edge primitive
    vote branches, ``primitive_channels`` 64 (the JAX default; tiny 16)."""
    return dict(votenet_model_cfg(tiny), type="H3DNet",
                primitive_channels=16 if tiny else 64)


def synthetic_indoor_batch(batch_size: int, num_points: int = 40000,
                           num_classes: int = 18, max_gt: int = 64,
                           seed: int = 0, room=(8.0, 8.0, 3.0),
                           scan_share: float = 0.75) -> dict:
    """An indoor batch in the JAX package's contract: a room of ``room``
    metres (x, y centred on 0, floor at z 0) with its floor and four walls
    and 8-16 axis-aligned boxes standing on the floor (sizes 0.3-2.0 m,
    labels over ``num_classes``), scanned as ``scan_share * num_points``
    points spread over the floor, the walls and the boxes' tops and sides
    by area (1 cm noise), then exactly ``num_points`` drawn from them with
    replacement (exact duplicates exist, as ``IndoorPointSample`` makes
    them from a short scan). Points (B, N, 4): xyz and the height above the
    floor, ``z - percentile(z, 0.99)`` (``shift_height``); points_mask all
    True; gt_bboxes_3d (B, ``max_gt``, 7) bottom-centred, yaw 0,
    gt_labels_3d (B, ``max_gt``) int64, gt_mask (B, ``max_gt``). numpy,
    from ``seed``."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((batch_size, num_points, 4), np.float32)
    boxes = np.zeros((batch_size, max_gt, 7), np.float32)
    labels = np.zeros((batch_size, max_gt), np.int64)
    gt_mask = np.zeros((batch_size, max_gt), bool)
    for b in range(batch_size):
        r = indoor_room(rng, num_points, num_classes, room, scan_share)
        g = len(r["labels"])
        pts[b, :, :3] = r["xyz"]
        pts[b, :, 3] = r["xyz"][:, 2] - np.percentile(r["xyz"][:, 2], 0.99)
        boxes[b, :g] = r["boxes"]
        labels[b, :g] = r["labels"]
        gt_mask[b, :g] = True
    return dict(points=pts, points_mask=np.ones((batch_size, num_points),
                                                bool),
                gt_bboxes_3d=boxes, gt_labels_3d=labels, gt_mask=gt_mask)


def indoor_room(rng: np.random.Generator, num_points: int, num_classes: int,
                room=(8.0, 8.0, 3.0), scan_share: float = 0.75,
                resample: bool = True) -> dict:
    """One room of ``synthetic_indoor_batch``, drawn from ``rng``: ``xyz``
    (num_points, 3) float32, ``boxes`` (G, 7) bottom-centred (yaw 0),
    ``labels`` (G,), and each point's surface ``part``: 0 the floor, 1-4
    the walls, 5 + g the box g's top and sides. ``resample`` False: the
    scan itself (``scan_share * num_points`` distinct points), not drawn
    again with replacement."""
    lx, ly, lz = room
    g = int(rng.integers(8, 17))
    size = rng.uniform(0.3, 2.0, (g, 3))
    size[:, 2] = np.minimum(size[:, 2], lz - 0.2)
    ctr = np.stack([rng.uniform(-lx / 2 + size[:, 0] / 2,
                                lx / 2 - size[:, 0] / 2),
                    rng.uniform(-ly / 2 + size[:, 1] / 2,
                                ly / 2 - size[:, 1] / 2)], -1)
    # (origin, edge u, edge v) of every scanned rectangle
    rects = [((-lx / 2, -ly / 2, 0), (lx, 0, 0), (0, ly, 0)),
             ((-lx / 2, -ly / 2, 0), (lx, 0, 0), (0, 0, lz)),
             ((-lx / 2, ly / 2, 0), (lx, 0, 0), (0, 0, lz)),
             ((-lx / 2, -ly / 2, 0), (0, ly, 0), (0, 0, lz)),
             ((lx / 2, -ly / 2, 0), (0, ly, 0), (0, 0, lz))]
    for (cx, cy), (dx, dy, dz) in zip(ctr, size):
        x0, y0 = cx - dx / 2, cy - dy / 2
        rects += [((x0, y0, dz), (dx, 0, 0), (0, dy, 0)),
                  ((x0, y0, 0), (dx, 0, 0), (0, 0, dz)),
                  ((x0, y0 + dy, 0), (dx, 0, 0), (0, 0, dz)),
                  ((x0, y0, 0), (0, dy, 0), (0, 0, dz)),
                  ((x0 + dx, y0, 0), (0, dy, 0), (0, 0, dz))]
    o, u, v = (np.asarray(t, np.float64) for t in zip(*rects))
    area = np.linalg.norm(np.cross(u, v), axis=-1)
    scan = int(num_points * scan_share)
    which = rng.choice(len(rects), scan, p=area / area.sum())
    st = rng.uniform(size=(scan, 2))
    xyz = o[which] + st[:, :1] * u[which] + st[:, 1:] * v[which] + \
        rng.normal(0, 0.01, (scan, 3))
    pick = rng.integers(0, scan, num_points) if resample else \
        np.arange(scan)
    part = np.where(which < 5, which, 5 + (which - 5) // 5)[pick]
    boxes = np.zeros((g, 7), np.float32)
    boxes[:, :2] = ctr
    boxes[:, 3:6] = size
    return dict(xyz=xyz[pick].astype(np.float32), boxes=boxes,
                labels=rng.integers(0, num_classes, g), part=part)


def _build_indoor(cfg: dict, device, seed: int, batch_fn):
    from .models.builder import build_detector
    from .models.layers import init_weights

    dev = resolve_device(device)
    return init_weights(build_detector(cfg), seed).to(dev).eval(), batch_fn


def _votenet_batch(tiny: bool):
    """VoteNet's and H3DNet's ``batch_fn``."""
    if tiny:
        def batch_fn(b, seed=0):
            return synthetic_indoor_batch(b, num_points=256, num_classes=4,
                                          max_gt=16, seed=seed,
                                          room=(4.0, 4.0, 2.5))
    else:
        def batch_fn(b, seed=0):
            return synthetic_indoor_batch(b, seed=seed)
    return batch_fn


def build_votenet(tiny: bool = False, device=None, seed: int = 0
                  ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): VoteNet (``votenet_model_cfg(tiny)``) with weights
    drawn from ``seed``, in eval mode on ``device`` (default: the CUDA
    card; raises if it is missing), and ``batch_fn(batch_size, seed=0)``
    giving ``synthetic_indoor_batch`` (full width: 40,000 points, 18
    classes, 64 GT rows; tiny: 256 points in a 4 x 4 x 2.5 m room, 4
    classes, 16 rows)."""
    return _build_indoor(votenet_model_cfg(tiny), device, seed,
                         _votenet_batch(tiny))


def build_h3dnet(tiny: bool = False, device=None, seed: int = 0
                 ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): H3DNet (``h3dnet_model_cfg(tiny)``) as
    ``build_votenet`` builds VoteNet."""
    return _build_indoor(h3dnet_model_cfg(tiny), device, seed,
                         _votenet_batch(tiny))


# ------------------------------------------- the VoteNet family's variants
# 3DSSD's KITTI scene: the config's point cloud range (front half)
SSD3D_CLOUD_RANGE = (0.0, -40.0, -5.0, 70.0, 40.0, 3.0)
# the JAX package's tiny indoor variants (tests/test_models/
# test_indoor_variants.py): 3 classes, unit mean sizes
INDOOR_VARIANT_TINY_CLASSES = 3


def _tiny_variant_backbone() -> dict:
    """The JAX test's backbone, ``in_channels`` 4 (its points' width)."""
    return dict(type="PointNet2SASSG", in_channels=4,
                num_points=(128, 64), radius=(0.5, 1.0), num_samples=(8, 8),
                sa_channels=((8, 8, 16), (16, 16, 32)),
                fp_channels=((32, 32),))


def ssd3dnet_model_cfg(tiny: bool = False) -> dict:
    """3DSSD's model config dict. Full width: mmdet3d's
    ``configs/3dssd/3dssd_4x4_kitti-3d-car.py`` (``_base_/models/
    3dssd.py``) over KITTI Car's 16,384 points of (x, y, z, reflectance),
    float32. Where the JAX modules cannot take the reference's shape:

    - the backbone ``PointNet2SAMSG`` (three scales a level, D-FPS / F-FPS
      sampling, aggregation convs) becomes a ``PointNet2SASSG`` that keeps
      each level's point count and its widest scale: 4,096 / 512 / 256
      points, radii 0.8 / 1.6 / 4.8, 64 / 64 / 32 samples, widths (32, 32,
      64), (64, 96, 128), (128, 256, 256), no FP levels, plain FPS (the
      reference's F-FPS and D-FPS mix, and its MSG aggregation, are
      reductions);
    - the head's vote module (128 wide, with the vote range clip) is the
      JAX candidate shift (128,); its aggregation takes the first scale
      (256 points, radius 4.8, 16 samples, [256, 256, 256, 512]) and
      normalises the grouped xyz; ``pred_layer_cfg``'s shared convs (512,
      128) are ``feat_channels``, one prediction conv after them;
    - BN eps 1e-5 (the reference 1e-3); the JAX losses (L1 and cross
      entropy, no corner loss), ``AnchorFreeBBoxCoder`` with 12 direction
      bins and rotation, 1 class; predict keeps the top
      ``max_output_num`` 100 with no NMS.

    ``tiny``: the JAX test's model (3 classes, ``PartialBinBasedBBoxCoder``
    with 6 bins, the two-level backbone with one FP level), ``in_channels``
    4."""
    if tiny:
        nc = INDOOR_VARIANT_TINY_CLASSES
        return dict(
            type="SSD3DNet", backbone=_tiny_variant_backbone(),
            bbox_head=dict(
                type="SSD3DHead", num_classes=nc,
                bbox_coder=dict(type="PartialBinBasedBBoxCoder",
                                num_dir_bins=6, num_sizes=nc, with_rot=True,
                                mean_sizes=[[1, 1, 1]] * nc),
                candidate_shift_channels=(16,), feat_channels=(32,),
                vote_aggregation_cfg=dict(num_point=16, radius=2.0,
                                          num_sample=8,
                                          mlp_channels=[16, 16, 32])),
            test_cfg=dict(max_output_num=8))
    return dict(
        type="SSD3DNet",
        backbone=dict(type="PointNet2SASSG", in_channels=4,
                      num_points=(4096, 512, 256), radius=(0.8, 1.6, 4.8),
                      num_samples=(64, 64, 32),
                      sa_channels=((32, 32, 64), (64, 96, 128),
                                   (128, 256, 256)),
                      fp_channels=(),
                      sa_cfg=dict(type="PointSAModule", pool_mod="max",
                                  use_xyz=True, normalize_xyz=False)),
        bbox_head=dict(
            type="SSD3DHead", num_classes=1,
            bbox_coder=dict(type="AnchorFreeBBoxCoder", num_dir_bins=12,
                            with_rot=True),
            candidate_shift_channels=(128,), feat_channels=(512, 128),
            vote_aggregation_cfg=dict(num_point=256, radius=4.8,
                                      num_sample=16,
                                      mlp_channels=[256, 256, 256, 512])),
        train_cfg=dict(sample_mod="spec", pos_distance_thr=10.0,
                       expand_dims_length=0.05),
        test_cfg=dict(sample_mod="spec", score_thr=0.0,
                      per_class_proposal=True, max_output_num=100))


def ssd3dnet_optim_cfg() -> dict:
    """3DSSD's KITTI recipe: AdamW (lr 0.002, no weight decay), clip 35,
    step lr at epochs 45 and 60, ``samples_per_gpu`` 4 (``4x4``), 80
    epochs."""
    return dict(optimizer=dict(type="AdamW", lr=0.002, weight_decay=0.0),
                optimizer_config=dict(grad_clip=dict(max_norm=35.0,
                                                     norm_type=2)),
                lr_config=dict(policy="step", step=[45, 60]),
                momentum_config=None, samples_per_gpu=4, max_epochs=80)


def synthetic_kitti_car_batch(batch_size: int, num_points: int = 16384,
                              seed: int = 0, max_gt: int = 16) -> dict:
    """3DSSD's KITTI Car batch: ``synthetic_kitti_batch``'s LiDAR cloud
    inside ``SSD3D_CLOUD_RANGE`` (``num_points`` of x, y, z, reflectance)
    and only its car rows of the GT (label 0, first in the padded rows);
    no image."""
    b = synthetic_kitti_batch(batch_size, num_points, img_hw=(8, 8),
                              num_gt=max_gt, seed=seed,
                              pcr=SSD3D_CLOUD_RANGE,
                              gt_range=(0.0, -40.0, 70.0, 40.0))
    car = (b["gt_labels_3d"] == 2) & b["gt_mask"]
    boxes = np.zeros_like(b["gt_bboxes_3d"])
    mask = np.zeros_like(b["gt_mask"])
    for s in range(batch_size):
        g = int(car[s].sum())
        boxes[s, :g] = b["gt_bboxes_3d"][s][car[s]]
        mask[s, :g] = True
    return dict(points=b["points"], points_mask=b["points_mask"],
                gt_bboxes_3d=boxes,
                gt_labels_3d=np.zeros_like(b["gt_labels_3d"]),
                gt_mask=mask)


def _tiny_variant_batch(b: int, seed: int = 0) -> dict:
    """The tiny variants' batch: a 4 x 4 x 2.5 m room of 256 points, the
    JAX test's 3 classes, 16 GT rows."""
    return synthetic_indoor_batch(b, num_points=256,
                                  num_classes=INDOOR_VARIANT_TINY_CLASSES,
                                  max_gt=16, seed=seed, room=(4.0, 4.0, 2.5))


def build_ssd3dnet(tiny: bool = False, device=None, seed: int = 0
                   ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): 3DSSD (``ssd3dnet_model_cfg(tiny)``) with weights
    drawn from ``seed``, in eval mode on ``device`` (default: the CUDA
    card; raises if it is missing), and ``batch_fn(batch_size, seed=0)``:
    ``synthetic_kitti_car_batch`` (tiny: ``_tiny_variant_batch``)."""
    return _build_indoor(ssd3dnet_model_cfg(tiny), device, seed,
                         _tiny_variant_batch if tiny
                         else synthetic_kitti_car_batch)


def groupfree3d_model_cfg(tiny: bool = False) -> dict:
    """Group-Free 3D's model config dict. Full width: mmdet3d's
    ``configs/groupfree3d/groupfree3d_8x4_scannet-3d-18class-L6-O256.py``
    over 50,000 points of xyz (``in_channels`` 3), float32: VoteNet's SA
    widths with FP widths (256, 256), (256, 288); the head's 6 decoder
    layers, 256 proposals (KPS), embedding 288, 8 heads, FFN 2,048, dropout
    0.1, 18 classes, sizes by class (``size_cls_agnostic`` False, 18 seeded
    mean sizes, ``SCANNET_MEAN_SIZES``), 1 direction bin without rotation,
    shared convs (288, 288), the reference's loss weights. Where the JAX
    modules cannot take the reference's shape: mmcv's
    ``BaseTransformerLayer`` (``GroupFree3DMHA``) is the JAX post-norm
    ``TransformerDecoderLayer`` (the same operation order); every smooth
    L1 term uses beta 1 (the reference's size residual 1/9); the points'
    owners are geometric (the JAX package has no instance masks);
    predict keeps the top ``max_output_num`` 64 with no NMS.

    ``tiny``: the JAX test's model (3 classes, 2 decoder layers, 16
    proposals, width 32, 4 heads, size-agnostic sizes), ``in_channels``
    4; ``size_cls_agnostic`` and ``prediction_stages`` as given."""
    if tiny:
        nc = INDOOR_VARIANT_TINY_CLASSES
        return dict(
            type="GroupFree3DNet", backbone=_tiny_variant_backbone(),
            bbox_head=dict(
                type="GroupFree3DHead", num_classes=nc, in_channels=32,
                num_decoder_layers=2, num_proposal=16, embed_dims=32,
                num_heads=4, ffn_channels=64,
                pred_layer_cfg=dict(in_channels=32,
                                    shared_conv_channels=(32, 32)),
                bbox_coder=dict(type="GroupFree3DBBoxCoder", num_dir_bins=6,
                                num_sizes=nc, with_rot=True,
                                size_cls_agnostic=True,
                                mean_sizes=[[1, 1, 1]] * nc),
                sampling_objectness_loss=dict(type="FocalLoss",
                                              loss_weight=8.0),
                center_loss=dict(type="SmoothL1Loss", loss_weight=10.0),
                dir_res_loss=dict(type="SmoothL1Loss", loss_weight=10.0),
                size_reg_loss=dict(type="SmoothL1Loss", loss_weight=10.0),
                size_res_loss=dict(type="SmoothL1Loss", loss_weight=10.0)),
            test_cfg=dict(max_output_num=8, prediction_stages="last"))
    return dict(
        type="GroupFree3DNet",
        backbone=dict(type="PointNet2SASSG", in_channels=3,
                      num_points=(2048, 1024, 512, 256),
                      radius=(0.2, 0.4, 0.8, 1.2),
                      num_samples=(64, 32, 16, 16),
                      sa_channels=((64, 64, 128), (128, 128, 256),
                                   (128, 128, 256), (128, 128, 256)),
                      fp_channels=((256, 256), (256, 288)),
                      norm_cfg=dict(type="BN2d"),
                      sa_cfg=dict(type="PointSAModule", pool_mod="max",
                                  use_xyz=True, normalize_xyz=True)),
        bbox_head=dict(
            type="GroupFree3DHead", num_classes=18, in_channels=288,
            num_decoder_layers=6, num_proposal=256, embed_dims=288,
            num_heads=8, ffn_channels=2048, dropout=0.1,
            pred_layer_cfg=dict(in_channels=288,
                                shared_conv_channels=(288, 288), bias=True),
            bbox_coder=dict(type="GroupFree3DBBoxCoder", num_sizes=18,
                            num_dir_bins=1, with_rot=False,
                            size_cls_agnostic=False,
                            mean_sizes=[list(s) for s in
                                        SCANNET_MEAN_SIZES]),
            # the weights alone: the head computes the reference's focal
            # loss and cross entropies, and smooth L1 with beta 1 where the
            # reference's size residual takes 1/9 (as the JAX head)
            sampling_objectness_loss=dict(type="FocalLoss", loss_weight=8.0),
            objectness_loss=dict(type="FocalLoss", loss_weight=1.0),
            center_loss=dict(type="SmoothL1Loss", loss_weight=10.0),
            dir_class_loss=dict(type="CrossEntropyLoss", loss_weight=1.0),
            dir_res_loss=dict(type="SmoothL1Loss", loss_weight=10.0),
            size_class_loss=dict(type="CrossEntropyLoss", loss_weight=1.0),
            size_res_loss=dict(type="SmoothL1Loss", loss_weight=10.0 / 9.0),
            semantic_loss=dict(type="CrossEntropyLoss", loss_weight=1.0)),
        train_cfg=dict(sample_mod="kps"),
        test_cfg=dict(sample_mod="kps", nms_thr=0.25, score_thr=0.0,
                      per_class_proposal=True, prediction_stages="last"))


# the decoder's modules train at a tenth of the lr (the reference config's
# paramwise_cfg)
GROUPFREE3D_DECODER_KEYS = ("bbox_head.decoder_layers",
                            "bbox_head.decoder_self_posembeds",
                            "bbox_head.decoder_cross_posembeds",
                            "bbox_head.decoder_query_proj",
                            "bbox_head.decoder_key_proj")


def groupfree3d_optim_cfg() -> dict:
    """Group-Free 3D's ScanNet recipe: AdamW (lr 0.006, weight decay
    0.0005; the decoder's modules at ``lr_mult`` 0.1), clip 0.1, step lr
    at epochs 280 and 340, ``samples_per_gpu`` 8 (``8x4``), 400 epochs."""
    return dict(optimizer=dict(
        type="AdamW", lr=0.006, weight_decay=0.0005,
        paramwise_cfg=dict(custom_keys={
            k: dict(lr_mult=0.1, decay_mult=1.0)
            for k in GROUPFREE3D_DECODER_KEYS})),
        optimizer_config=dict(grad_clip=dict(max_norm=0.1, norm_type=2)),
        lr_config=dict(policy="step", step=[280, 340]),
        momentum_config=None, samples_per_gpu=8, max_epochs=400)


def synthetic_scannet_batch(batch_size: int, num_points: int = 50000,
                            seed: int = 0) -> dict:
    """Group-Free 3D's ScanNet batch: ``synthetic_indoor_batch``'s room of
    ``num_points`` points, xyz only, 18 classes, 64 GT rows."""
    b = synthetic_indoor_batch(batch_size, num_points=num_points,
                               seed=seed)
    return dict(b, points=np.ascontiguousarray(b["points"][..., :3]))


def build_groupfree3d(tiny: bool = False, device=None, seed: int = 0
                      ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): Group-Free 3D (``groupfree3d_model_cfg(tiny)``)
    as ``build_ssd3dnet`` builds 3DSSD; ``synthetic_scannet_batch`` (tiny:
    ``_tiny_variant_batch``)."""
    return _build_indoor(groupfree3d_model_cfg(tiny), device, seed,
                         _tiny_variant_batch if tiny
                         else synthetic_scannet_batch)


# SUN RGB-D: 10 classes; their mean sizes are not in this repository: 10
# seeded sizes in 0.2-2.0 m take their place (no shape or cost changes)
SUNRGBD_MEAN_SIZES = tuple(tuple(round(float(v), 4) for v in row) for row in
                           np.random.default_rng(10).uniform(0.2, 2.0,
                                                             (10, 3)))
SUNRGBD_IMG_HW = (530, 730)
# the JAX test's image and camera
IMVOTENET_TINY_HW = (32, 48)


def sunrgbd_cam2img(img_hw=SUNRGBD_IMG_HW, center=(0.0, -4.5, 1.5),
                    focal: float = 529.5) -> np.ndarray:
    """(4, 4) float32: the depth frame's points (x right, y forward, z up)
    to pixels of a level camera at ``center`` looking along +y, pinhole
    ``focal`` pixels, principal point at the image's centre. At the
    default an 8 x 8 m room centred on 0 lies in front of it."""
    h, w = img_hw
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    r = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])
    out = np.eye(4)
    out[:3, :3] = k @ r
    out[:3, 3] = k @ (-r @ np.asarray(center, np.float64))
    return out.astype(np.float32)


def imvotenet_model_cfg(tiny: bool = False) -> dict:
    """ImVoteNet's model config dict. Full width: mmdet3d's
    ``configs/imvotenet/imvotenet_stage2_16x8_sunrgbd-3d-10class.py`` over
    20,000 SUN RGB-D points of xyz + height and one 530 x 730 image,
    float32: VoteNet's backbone; the VoteHead with 10 classes (10 seeded
    mean sizes, ``SUNRGBD_MEAN_SIZES``), 12 direction bins with rotation,
    the vote module's input 256 + ``img_feat_dim`` 16 (the JAX default);
    the image branch a ResNet-50 whose last map is sampled. Where the JAX
    modules cannot take the reference's shape: the reference's three
    cues from a 2D detector (Faster R-CNN on the ResNet + FPN: geometric,
    semantic, texture) and its three vote heads become the texture cue
    alone (the image features at the seeds' projections, ``img_fuse`` to
    16 channels) into one VoteHead; the image branch is trained (the
    reference freezes it); predict keeps the top ``max_output_num`` 128
    with no NMS. The ResNet's BatchNorms normalise by the batch in train
    mode (``norm_eval`` False; the reference keeps a pretrained branch's
    statistics): with random weights no running statistics describe the
    images, and under ``norm_eval`` the branch trained at the recipe's lr
    grew its last map from 3.3 to 3.8e20 in two AdamW steps on an H100
    and turned the votes to NaN.

    ``tiny``: the JAX test's model (a ResNet-18 of base width 8, its
    second stage sampled, ``img_feat_dim`` 8, the tiny VoteHead of 3
    classes and 6 bins), ``in_channels`` 4."""
    if tiny:
        nc = INDOOR_VARIANT_TINY_CLASSES
        return dict(
            type="ImVoteNet", backbone=_tiny_variant_backbone(),
            img_backbone=dict(type="ResNet", depth=18, base_channels=8,
                              out_indices=(1,)),
            img_feat_dim=8,
            bbox_head=dict(
                type="VoteHead", num_classes=nc,
                bbox_coder=dict(type="PartialBinBasedBBoxCoder",
                                num_dir_bins=6, num_sizes=nc, with_rot=True,
                                mean_sizes=[[1, 1, 1]] * nc),
                vote_module_cfg=dict(in_channels=40, conv_channels=(32,)),
                vote_aggregation_cfg=dict(num_point=16, radius=1.0,
                                          num_sample=8,
                                          mlp_channels=[32, 32, 32]),
                feat_channels=(32,)),
            test_cfg=dict(max_output_num=8))
    cfg = votenet_model_cfg()
    head = cfg["bbox_head"]
    head.update(
        num_classes=10,
        bbox_coder=dict(type="PartialBinBasedBBoxCoder", num_sizes=10,
                        num_dir_bins=12, with_rot=True,
                        mean_sizes=[list(s) for s in SUNRGBD_MEAN_SIZES]),
        vote_module_cfg=dict(head["vote_module_cfg"], in_channels=256 + 16))
    return dict(cfg, type="ImVoteNet",
                img_backbone=dict(type="ResNet", depth=50, num_stages=4,
                                  out_indices=(0, 1, 2, 3), norm_eval=False,
                                  style="pytorch"),
                img_feat_dim=16,
                test_cfg=dict(sample_mod="seed", nms_thr=0.25,
                              score_thr=0.05, per_class_proposal=True))


def imvotenet_optim_cfg() -> dict:
    """ImVoteNet's stage-2 recipe (``schedule_3x``: AdamW lr 0.008, clip
    10, step lr at 24 and 32) at ``samples_per_gpu`` 16 (``16x8``)."""
    return dict(votenet_optim_cfg(), samples_per_gpu=16)


def synthetic_sunrgbd_batch(batch_size: int, num_points: int = 20000,
                            seed: int = 0, img_hw=SUNRGBD_IMG_HW,
                            num_classes: int = 10, max_gt: int = 64,
                            room=(8.0, 8.0, 3.0), cam2img=None) -> dict:
    """ImVoteNet's batch: ``synthetic_indoor_batch``'s room (xyz + height,
    ``num_classes``), one (B, H, W, 3) float32 image in [0, 1) and its
    ``cam2img`` (default ``sunrgbd_cam2img(img_hw)``)."""
    b = synthetic_indoor_batch(batch_size, num_points=num_points,
                               num_classes=num_classes, max_gt=max_gt,
                               seed=seed, room=room)
    rng = np.random.default_rng(seed + 1)
    h, w = img_hw
    c2i = sunrgbd_cam2img(img_hw) if cam2img is None else cam2img
    return dict(b, img=rng.uniform(size=(batch_size, h, w, 3)).astype(
        np.float32), cam2img=np.broadcast_to(
            np.asarray(c2i, np.float32), (batch_size, 4, 4)).copy())


# the JAX test's tiny camera: depth along z, principal point at the
# image's centre
IMVOTENET_TINY_CAM2IMG = ((30, 0, 24, 0), (0, 30, 16, 0), (0, 0, 1, 0),
                          (0, 0, 0, 1))


def build_imvotenet(tiny: bool = False, device=None, seed: int = 0
                    ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): ImVoteNet (``imvotenet_model_cfg(tiny)``) as
    ``build_ssd3dnet`` builds 3DSSD; ``synthetic_sunrgbd_batch`` (tiny: 256
    points in a 4 x 4 x 2.5 m room, 3 classes, 16 GT rows, a 32 x 48
    image under the JAX test's camera)."""
    if tiny:
        def batch_fn(b, seed=0):
            return synthetic_sunrgbd_batch(
                b, num_points=256, seed=seed, img_hw=IMVOTENET_TINY_HW,
                num_classes=INDOOR_VARIANT_TINY_CLASSES, max_gt=16,
                room=(4.0, 4.0, 2.5), cam2img=IMVOTENET_TINY_CAM2IMG)
    else:
        batch_fn = synthetic_sunrgbd_batch
    return _build_indoor(imvotenet_model_cfg(tiny), device, seed, batch_fn)


# ------------------------------------------------ semantic segmentation
# the segmentors' classes: ScanNet's 20 (wall 0, floor 1) and S3DIS's 13
# (floor 1, wall 2); a synthetic point's label is its surface's
SCANNET_SEG_CLASSES = ("wall", "floor", "cabinet", "bed", "chair", "sofa",
                       "table", "door", "window", "bookshelf", "picture",
                       "counter", "desk", "curtain", "refrigerator",
                       "showercurtrain", "toilet", "sink", "bathtub",
                       "otherfurniture")
S3DIS_SEG_CLASSES = ("ceiling", "floor", "wall", "beam", "column", "window",
                     "door", "table", "chair", "sofa", "bookcase", "board",
                     "clutter")
_SEG_SA = dict(num_points=(1024, 256, 64, 16), radius=(0.1, 0.2, 0.4, 0.8),
               num_samples=(32, 32, 32, 32),
               sa_channels=((32, 32, 64), (64, 64, 128), (128, 128, 256),
                            (256, 256, 512)), fp_channels=())
_SEG_TINY_SA = dict(num_points=(128, 64), radius=(0.4, 0.8),
                    num_samples=(8, 8), sa_channels=((8, 8, 16), (16, 16, 32)),
                    fp_channels=())


def pointnet2seg_model_cfg(tiny: bool = False) -> dict:
    """PointNet++ (SSG) semantic segmentation: mmdet3d's
    ``pointnet2_ssg_16x2_cosine_200e_scannet_seg-3d-20class.py`` on
    ``_base_/models/pointnet2_ssg.py``: PointNet2SASSG over 9 channels
    (xyz, rgb, normalised xyz; SA 1,024 / 256 / 64 / 16 points, radii 0.1
    / 0.2 / 0.4 / 0.8, 32 samples, widths (32, 32, 64) ... (256, 256,
    512), no FP), PointNet2Head (FP (768, 256, 256), (384, 256, 256), (320,
    256, 128), (128, 128, 128, 128), 128 channels, dropout 0.5, 20
    classes, ignore_index 20). The config's class weights of the loss are
    ScanNet's label statistics, which the synthetic rooms do not have: the
    loss is unweighted, as the JAX package's default. Float32. ``tiny``:
    the JAX package's test model (``tests/test_models/test_segmentor.py``:
    SA 128 / 64 points, 5 classes) over the same 9 channels."""
    sa = _SEG_TINY_SA if tiny else _SEG_SA
    head = dict(type="PointNet2Head", num_classes=5, ignore_index=5,
                channels=16, fp_channels=((48, 16, 16), (19, 16, 16)),
                dropout_ratio=0.5) if tiny else dict(
        type="PointNet2Head", num_classes=20, ignore_index=20, channels=128,
        fp_channels=((768, 256, 256), (384, 256, 256), (320, 256, 128),
                     (128, 128, 128, 128)), dropout_ratio=0.5)
    return dict(type="EncoderDecoder3D", backbone=dict(
        type="PointNet2SASSG", in_channels=9, norm_cfg=dict(type="BN2d"),
        sa_cfg=dict(type="PointSAModule", pool_mod="max", use_xyz=True,
                    normalize_xyz=False), **sa), decode_head=head)


def paconvseg_model_cfg(tiny: bool = False) -> dict:
    """PAConv (SSG) semantic segmentation: mmdet3d's
    ``paconv_ssg_8x8_cosine_150e_s3dis_seg-3d-13class.py`` on
    ``_base_/models/paconv_ssg.py``: PAConvSASSG over 9 channels at
    PointNet++'s SA widths, 16 kernels (``sa_cfg['num_kernels']``),
    ScoreNet (16, 16, 16) with softmax; PAConvHead (the JAX package's
    ``fp_channels``, 128 channels, dropout 0.5, 13 classes, ignore_index
    13). The JAX package groups by the ball query at the PointNet++ radii
    where the config groups by k nearest neighbours (ROADMAP). Float32.
    ``tiny``: SA 128 / 64 points, 4 kernels, 4 classes."""
    sa = _SEG_TINY_SA if tiny else _SEG_SA
    head = dict(type="PAConvHead", num_classes=4, ignore_index=4,
                channels=16, fp_channels=((48, 16, 16), (19, 16, 16)),
                dropout_ratio=0.5) if tiny else dict(
        type="PAConvHead", num_classes=13, ignore_index=13, channels=128,
        dropout_ratio=0.5)
    return dict(type="EncoderDecoder3D", backbone=dict(
        type="PAConvSASSG", in_channels=9, norm_cfg=dict(type="BN2d"),
        sa_cfg=dict(type="PAConvSAModule", pool_mod="max", use_xyz=True,
                    normalize_xyz=False, num_kernels=4 if tiny else 16),
        **sa), decode_head=head)


def pointnet2seg_optim_cfg() -> dict:
    """The PointNet++ ScanNet recipe (``seg_cosine_200e.py``): Adam (lr
    0.001, weight decay 0.01), no clip, CosineAnnealing to 1e-5
    (``min_lr_ratio`` 0.01), ``samples_per_gpu`` 16 (``16x2``), 200
    epochs."""
    return dict(optimizer=dict(type="Adam", lr=0.001, weight_decay=0.01),
                optimizer_config=dict(grad_clip=None),
                lr_config=dict(policy="CosineAnnealing", warmup=None,
                               min_lr_ratio=0.01),
                momentum_config=None, samples_per_gpu=16, max_epochs=200)


def paconvseg_optim_cfg() -> dict:
    """The PAConv S3DIS recipe (``seg_cosine_150e.py``): SGD (lr 0.2,
    momentum 0.9, weight decay 1e-4), no clip, CosineAnnealing to 0.002
    (``min_lr_ratio`` 0.01), ``samples_per_gpu`` 8 (``8x8``), 150
    epochs."""
    return dict(optimizer=dict(type="SGD", lr=0.2, momentum=0.9,
                               weight_decay=0.0001),
                optimizer_config=dict(grad_clip=None),
                lr_config=dict(policy="CosineAnnealing", warmup=None,
                               min_lr_ratio=0.01),
                momentum_config=None, samples_per_gpu=8, max_epochs=150)


SEG_ROOM_POINTS = 300000
SCANNET_SEG_PATCH = dict(block_size=1.5, use_normalized_coord=True,
                         enlarge_size=0.2, min_unique_num=None)
S3DIS_SEG_PATCH = dict(block_size=1.0, use_normalized_coord=True,
                       num_try=10000, enlarge_size=None, eps=0.0)


def synthetic_seg_batch(batch_size: int, num_points: int = 8192,
                        classes=SCANNET_SEG_CLASSES, seed: int = 0,
                        room=(8.0, 8.0, 3.0), patch=None) -> dict:
    """A segmentation batch in the JAX package's contract, from
    ``indoor_room``'s rooms: points (B, N, 9) float32 (xyz; rgb in [0, 1],
    one colour a surface plus noise; xyz over the room's max, the
    ``use_normalized_coord`` columns), points_mask all True,
    pts_semantic_mask (B, N) int64: the floor 'floor', the walls 'wall', a
    box's points its class (the classes after those two, by the box's
    label), and 10% of the points the ignored label (the number of
    classes, the configs' ``ignore_index``). ``patch`` None: the room drawn
    to ``num_points`` points (the tiny models'); else the keyword arguments
    of ``IndoorPatchPointSample`` (``SCANNET_SEG_PATCH``,
    ``S3DIS_SEG_PATCH``; ``ignore_index`` and ``min_unique_num``, where
    absent, the configs': the ignored label and ``num_points // 4``): each
    sample a block of ``num_points`` points cut by that transform from a
    scan of ``SEG_ROOM_POINTS`` distinct points, re-centred on the block in
    x and y, as the configs' train pipelines cut it. numpy, from
    ``seed``."""
    from .core.points import DepthPoints
    from .datasets.pipelines.transforms_3d import IndoorPatchPointSample

    rng = np.random.default_rng(seed)
    k = len(classes)
    floor, wall = classes.index("floor"), classes.index("wall")
    objects = [i for i in range(k) if i not in (floor, wall)]
    cut = None if patch is None else IndoorPatchPointSample(num_points, **{
        "ignore_index": k, "min_unique_num": num_points // 4, **patch})
    pts = np.zeros((batch_size, num_points, 9), np.float32)
    sem = np.zeros((batch_size, num_points), np.int64)
    for b in range(batch_size):
        if cut is None:
            r = indoor_room(rng, num_points, len(objects), room)
        else:
            r = indoor_room(rng, SEG_ROOM_POINTS, len(objects), room, 1.0,
                            resample=False)
        part = r["part"]
        xyz = r["xyz"]
        n = len(xyz)
        colour = rng.uniform(0, 1, (5 + len(r["labels"]), 3))
        rgb = np.clip(colour[part] + rng.normal(0, 0.05, (n, 3)), 0, 1)
        obj = np.asarray(objects)[r["labels"]]
        lab = np.where(part == 0, floor, np.where(
            part < 5, wall, obj[np.maximum(part - 5, 0)]))
        lab[rng.uniform(size=n) < 0.1] = k
        if cut is None:
            pts[b, :, :3] = xyz
            pts[b, :, 3:6] = rgb
            pts[b, :, 6:] = xyz / np.maximum(xyz.max(0), 1e-6)
            sem[b] = lab
            continue
        data = cut(dict(points=DepthPoints(
            np.concatenate([xyz, rgb], 1).astype(np.float32), 6,
            attribute_dims=dict(color=[3, 4, 5])), pts_semantic_mask=lab,
            rng=np.random.RandomState(int(rng.integers(2 ** 31)))))
        pts[b] = data["points"].numpy()
        sem[b] = data["pts_semantic_mask"]
    return dict(points=pts, points_mask=np.ones((batch_size, num_points),
                                                bool),
                pts_semantic_mask=sem)


def _build_segmentor(cfg: dict, device, seed: int, batch_fn):
    from .models.builder import build_segmentor
    from .models.layers import init_weights

    dev = resolve_device(device)
    return init_weights(build_segmentor(cfg), seed).to(dev).eval(), batch_fn


def build_pointnet2seg(tiny: bool = False, device=None, seed: int = 0
                       ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): PointNet++ segmentation
    (``pointnet2seg_model_cfg(tiny)``) with weights drawn from ``seed``,
    in eval mode on ``device`` (default: the CUDA card), and
    ``batch_fn(batch_size, seed=0)`` giving ``synthetic_seg_batch`` at
    ScanNet's 20 classes, 8,192 points a 1.5 m patch (tiny: 5 classes, a
    4 x 4 x 2.5 m room of 256 points)."""
    classes = SCANNET_SEG_CLASSES[:5] if tiny else SCANNET_SEG_CLASSES

    def batch_fn(b, seed=0):
        if tiny:
            return synthetic_seg_batch(b, 256, classes, seed=seed,
                                       room=(4.0, 4.0, 2.5))
        return synthetic_seg_batch(b, 8192, classes, seed=seed,
                                   patch=SCANNET_SEG_PATCH)
    return _build_segmentor(pointnet2seg_model_cfg(tiny), device, seed,
                            batch_fn)


def build_paconvseg(tiny: bool = False, device=None, seed: int = 0
                    ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): PAConv segmentation (``paconvseg_model_cfg
    (tiny)``) as ``build_pointnet2seg``, its batch at S3DIS's 13 classes,
    4,096 points a 1.0 m patch (tiny: 4 classes, 256 points)."""
    classes = S3DIS_SEG_CLASSES[:4] if tiny else S3DIS_SEG_CLASSES

    def batch_fn(b, seed=0):
        if tiny:
            return synthetic_seg_batch(b, 256, classes, seed=seed,
                                       room=(4.0, 4.0, 2.5))
        return synthetic_seg_batch(b, 4096, classes, seed=seed,
                                   patch=S3DIS_SEG_PATCH)
    return _build_segmentor(paconvseg_model_cfg(tiny), device, seed,
                            batch_fn)


# ------------------------------------------------------- the ScanNet loop
def votenet_scannet_cfg(data_root: str, tiny: bool = False, epochs: int = 2,
                        num_points: int = 40000):
    """VoteNet's train -> eval loop on a ScanNet layout (``tools/
    make_synthetic_scannet.py``): the model of ``votenet_model_cfg(tiny)``,
    ``ScanNetDataset`` splits from ``scannet_infos_{train,val}.pkl``, and
    ``votenet_8x8_scannet-3d-18class.py``'s train pipeline as far as the
    JAX package has it: LoadPointsFromFile (DEPTH, ``shift_height``,
    ``load_dim`` 6, ``use_dim`` [0, 1, 2]), LoadAnnotations3D,
    GlobalAlignment (z), PointSample (``num_points``), RandomFlip3D (0.5 /
    0.5), GlobalRotScaleTrans (+-5 degrees, no scale, ``shift_height``),
    the format bundle and Collect3D. Left out, as the JAX package has
    them not: the instance and semantic mask loading and
    ``PointSegClassMapping``. The test pipeline loads, aligns and samples
    (the config's MultiScaleFlipAug3D runs no flip and no rotation).
    ``tiny``: the tiny VoteNet's 4 classes, the others' boxes filtered out.
    ``votenet_optim_cfg``'s recipe over ``epochs``, eval and checkpoint
    every epoch, every step logged. A ``Config``."""
    import os

    from .config import Config

    classes = ["cabinet", "bed", "chair", "sofa", "table", "door", "window",
               "bookshelf", "picture", "counter", "desk", "curtain",
               "refrigerator", "showercurtrain", "toilet", "sink", "bathtub",
               "garbagebin"][:4 if tiny else 18]
    load = dict(type="LoadPointsFromFile", coord_type="DEPTH",
                shift_height=True, load_dim=6, use_dim=[0, 1, 2])
    bundle = dict(type="DefaultFormatBundle3D", class_names=classes,
                  max_points=num_points, max_gt=64)
    train_pipeline = [
        load,
        dict(type="LoadAnnotations3D", with_bbox_3d=True,
             with_label_3d=True)] + ([
            dict(type="ObjectNameFilter", classes=classes)] if tiny else []) + [
        dict(type="GlobalAlignment", rotation_axis=2),
        dict(type="PointSample", num_points=num_points),
        dict(type="RandomFlip3D", flip_ratio_bev_horizontal=0.5,
             flip_ratio_bev_vertical=0.5),
        dict(type="GlobalRotScaleTrans", rot_range=[-0.087266, 0.087266],
             scale_ratio_range=[1.0, 1.0], shift_height=True),
        bundle,
        dict(type="Collect3D", keys=["points", "gt_bboxes_3d",
                                     "gt_labels_3d"])]
    test_pipeline = [
        load, dict(type="GlobalAlignment", rotation_axis=2),
        dict(type="PointSample", num_points=num_points),
        dict(bundle, with_label=False), dict(type="Collect3D",
                                             keys=["points"])]

    def split(name, pipeline, test_mode):
        return dict(type="ScanNetDataset", data_root=data_root,
                    ann_file=os.path.join(data_root,
                                          f"scannet_infos_{name}.pkl"),
                    pipeline=pipeline, classes=classes, test_mode=test_mode)

    optim = votenet_optim_cfg()
    return Config(dict(
        model=votenet_model_cfg(tiny),
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


# ------------------------------------------------------------- SST sparse
# SST (Fan et al., CVPR 2022) as a standalone sparse backbone over pillars:
# "flagship": the flagship's grid2region_0 widths on its 180 x 180 BEV
# (0.6 m cells: 0.075 m voxels x out_size_factor 8; one 36-token level,
# configs/isfusion/isfusion_0075voxel.py:20-23); "waymo": SST's Waymo
# settings (the Waymo configs of tusen-ai/SST: 0.32 m pillars over
# +-74.88 m, 12 x 12 windows, 6 blocks, three drop levels in training,
# four at test); "tiny": the CPU tests' widths
SST_RANGES = dict(flagship=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
                  waymo=(-74.88, -74.88, -2.0, 74.88, 74.88, 4.0),
                  tiny=(-7.2, -5.4, -2.0, 7.2, 5.4, 4.0))
SST_PILLARS = dict(flagship=(0.6, 0.6, 8.0), waymo=(0.32, 0.32, 6.0),
                   tiny=(0.6, 0.6, 6.0))
SST_WAYMO_TRAIN_DROP = (
    {"max_tokens": 30, "drop_range": (0, 30)},
    {"max_tokens": 60, "drop_range": (30, 60)},
    {"max_tokens": 100, "drop_range": (60, 100000)})
SST_WAYMO_TEST_DROP = (
    {"max_tokens": 30, "drop_range": (0, 30)},
    {"max_tokens": 60, "drop_range": (30, 60)},
    {"max_tokens": 100, "drop_range": (60, 100)},
    {"max_tokens": 144, "drop_range": (100, 100000)})


def sst_sparse_model_cfg(name: str, train: bool = False) -> dict:
    """The ``SSTv2Sparse`` config of ``name`` ("flagship", "waymo",
    "tiny"); ``train`` takes Waymo's training drop levels."""
    if name == "flagship":
        return dict(type="SSTv2Sparse", d_model=128, nhead=8, num_blocks=1,
                    dim_feedforward=128, window_shape=(6, 6, 1),
                    sparse_shape=(180, 180, 1), drop_info=(
                        {"max_tokens": 36, "drop_range": (0, 100000)},))
    if name == "waymo":
        return dict(type="SSTv2Sparse", d_model=128, nhead=8, num_blocks=6,
                    dim_feedforward=256, window_shape=(12, 12, 1),
                    sparse_shape=(468, 468, 1), drop_info=(
                        SST_WAYMO_TRAIN_DROP if train
                        else SST_WAYMO_TEST_DROP))
    if name == "tiny":
        return dict(type="SSTv2Sparse", d_model=16, nhead=2, num_blocks=1,
                    dim_feedforward=32, window_shape=(6, 6, 1),
                    sparse_shape=(24, 18, 1), drop_info=(
                        {"max_tokens": 4, "drop_range": (0, 5)},
                        {"max_tokens": 16, "drop_range": (5, 100000)}))
    raise KeyError(f"no SST configuration {name!r}")


def synthetic_sst_points(name: str, batch_size: int, seed: int = 0) -> dict:
    """``points`` (B, N, 3) float32 and ``points_mask`` of ``name``'s
    cloud: the flagship request's 200,000 points; for Waymo 200,000 of a
    ray-cast scan plus 40 dense clusters (so that every drop level holds
    windows and training windows drop tokens); a small cloud (tiny)."""
    if name == "flagship":
        b = synthetic_points_batch(batch_size, 200000, seed=seed,
                                   pcr=SST_RANGES[name])
        return dict(points=b["points"][..., :3].copy(),
                    points_mask=b["points_mask"])
    pcr, pts = SST_RANGES[name], []
    for s in range(batch_size):
        rng = np.random.default_rng(seed + s)
        if name == "waymo":
            parts = [_lidar_cloud(rng, 120000, pcr, sensor_height=2.2)]
            n_clusters, spread, n_pts = 40, (1.5, 4.0), (500, 4000)
            total = 200000
        else:
            parts = [rng.uniform(pcr[:3], pcr[3:], (150, 3))]
            n_clusters, spread, n_pts = 3, (0.5, 1.0), (60, 120)
            total = 300
        for _ in range(n_clusters):
            c = rng.uniform(0.8 * np.asarray(pcr[:2]),
                            0.8 * np.asarray(pcr[3:5]))
            n = int(rng.integers(*n_pts))
            xy = c + rng.normal(0, rng.uniform(*spread), (n, 2))
            parts.append(np.stack([xy[:, 0], xy[:, 1],
                                   rng.uniform(-1.5, 2.0, n)], -1))
        p = np.concatenate(parts)
        pts.append(p[rng.permutation(len(p))][:total])
    n = max(len(p) for p in pts)
    points = np.zeros((batch_size, n, 3), np.float32)
    mask = np.zeros((batch_size, n), bool)
    for s, p in enumerate(pts):
        points[s, :len(p)], mask[s, :len(p)] = p, True
    return dict(points=points, points_mask=mask)


def sst_sparse_inputs(batch: dict, name: str, channels: int, device,
                      seed: int = 0):
    """(feats (B, V, C) float32, coords (B, V, 3) int32 zyx, valid (B, V)):
    the pillars that ``batch``'s points occupy (K1's voxelization on the
    card), in each sample's grid order, V the most a sample has; the
    features N(0, 1) from ``seed`` (zeros on invalid rows)."""
    import torch

    from .ops.voxel import voxelize_dynamic

    dev = resolve_device(device)
    pts = torch.from_numpy(batch["points"]).to(dev)
    mask = torch.from_numpy(batch["points_mask"]).to(dev)
    vc = voxelize_dynamic(pts, mask, SST_RANGES[name],
                          SST_PILLARS[name]).voxel_coors.long()
    b = pts.shape[0]
    counts = torch.bincount(vc[:, 0], minlength=b)
    v = int(counts.max())
    first = torch.cumsum(counts, 0) - counts
    row = torch.arange(vc.shape[0], device=dev) - first[vc[:, 0]]
    coords = torch.zeros((b, v, 3), dtype=torch.int32, device=dev)
    coords[vc[:, 0], row] = vc[:, 1:].to(torch.int32)
    valid = torch.zeros((b, v), dtype=torch.bool, device=dev)
    valid[vc[:, 0], row] = True
    feats = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(b, v, channels)).astype(np.float32)).to(dev)
    return feats * valid[..., None], coords, valid


def build_sst_sparse(name: str = "flagship", train: bool = False,
                     device=None, seed: int = 0
                     ) -> Tuple[nn.Module, Callable[..., dict]]:
    """(model, batch_fn): ``SSTv2Sparse`` of ``sst_sparse_model_cfg(name,
    train)`` with weights drawn from ``seed``, in eval mode on ``device``,
    and ``batch_fn(batch_size, seed=0)`` giving ``synthetic_sst_points``
    (``sst_sparse_inputs`` makes the model's inputs). The layer norms'
    scales are drawn from U(0.5, 1.5) and their biases from N(0, 0.1), as
    the CPU tests' JAX variables: with unit scales and zero biases the
    canvas's sum of squares is a constant of each token's last norm, and
    every gradient before it is rounding noise."""
    import torch

    from .models.builder import build_backbone
    from .models.layers import init_weights

    dev = resolve_device(device)
    model = init_weights(build_backbone(sst_sparse_model_cfg(name, train)),
                         seed)
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for n, p in model.named_parameters():
            if ".norm" in n:
                p.copy_(torch.rand(p.shape, generator=g) + 0.5
                        if n.endswith("weight") else
                        0.1 * torch.randn(p.shape, generator=g))
    model = model.to(dev).eval()

    def batch_fn(b, seed=0):
        return synthetic_sst_points(name, b, seed)
    return model, batch_fn
