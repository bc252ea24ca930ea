"""Augmentation and filtering transforms of the nuScenes paths
(counterpart of ``isfusion_tpu/datasets/pipelines/transforms_3d.py``):
the LiDAR ones (``GlobalRotScaleTrans``, ``RandomFlip3D``,
``PointsRangeFilter``, ``ObjectRangeFilter``, ``ObjectNameFilter``,
``PointShuffle``, ``PointSample``) and the IS-Fusion flagship's
(``ImageNormalize``, ``ImageAug3D``, ``GlobalRotScaleTransV2``,
``RandomFlip3DV2``, ``ModalMask3D``, ``ObjectSampleV2``) and the outdoor
KITTI ones (``ObjectNoise``, ``RandomJitterPoints``,
``BackgroundPointsFilter``, ``VoxelBasedPointSampler``), and the indoor
ones (``GlobalAlignment``, ``RandomDropPointsColor``,
``IndoorPatchPointSample``).

Every random draw comes from ``results['rng']``, a
``numpy.random.RandomState`` that the dataset seeds from (seed, epoch,
sample index); a transform that draws raises without it. The JAX package
draws the same numbers from the global ``np.random`` stream (a
RandomState too), in the same order (for ``GlobalRotScaleTrans``: theta,
scale, translation; then the horizontal flip, then the vertical). So one
sample seeded alike on both sides gets bit-equal outputs. Two draws
differ by design: ``ModalMask3D`` picks its dropped views with
``rng.choice(n, k, replace=False)`` where the JAX package calls Python's
``random.sample``, and the GT-paste sampler's picks come from the sample's
rng (``dbsampler.py``).

Camera views are (H, W, 3) uint8 arrays until ``ImageNormalize``; the
image operations are PIL's, bit for bit (``image_io``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ...core.bbox.box_np_ops import points_in_rbbox
from ...registry import OBJECT_SAMPLERS, PIPELINES, build_from_cfg
from . import image_io


def sample_rng(results: dict) -> np.random.RandomState:
    rng = results.get("rng")
    if rng is None:
        raise RuntimeError("a random transform draws from results['rng'] (a "
                           "numpy RandomState the dataset seeds); none given")
    return rng


@PIPELINES.register_module()
class GlobalRotScaleTrans:
    """Global rotation, scaling and translation of points and GT boxes."""

    def __init__(self, rot_range=(-0.78539816, 0.78539816),
                 scale_ratio_range=(0.95, 1.05),
                 translation_std=(0, 0, 0), shift_height: bool = False):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = np.asarray(translation_std, np.float32)

    def __call__(self, data: dict) -> dict:
        rng = sample_rng(data)
        theta = rng.uniform(*self.rot_range)
        scale = rng.uniform(*self.scale_ratio_range)
        trans = rng.normal(scale=self.translation_std, size=3).astype(
            np.float32)
        has_boxes = "gt_bboxes_3d" in data and len(data["gt_bboxes_3d"])
        if "points" in data:
            if has_boxes:
                # the box class turns the points with its own sign
                data["gt_bboxes_3d"].rotate(theta, data["points"])
            else:
                data["points"].rotate(theta)
            data["points"].translate(trans)
            data["points"].scale(scale)
        elif has_boxes:
            data["gt_bboxes_3d"].rotate(theta)
        if has_boxes:
            data["gt_bboxes_3d"].translate(trans)
            data["gt_bboxes_3d"].scale(scale)
        data["pcd_scale_factor"] = scale
        data["pcd_rotation"] = theta
        return data


@PIPELINES.register_module()
class RandomFlip3D:
    """BEV flips: horizontal (y) with ``flip_ratio_bev_horizontal``, then
    vertical (x) with ``flip_ratio_bev_vertical``; both draws are always
    taken."""

    def __init__(self, flip_ratio_bev_horizontal: float = 0.5,
                 flip_ratio_bev_vertical: float = 0.0, **kwargs):
        self.ratio_h = flip_ratio_bev_horizontal
        self.ratio_v = flip_ratio_bev_vertical

    def __call__(self, data: dict) -> dict:
        rng = sample_rng(data)
        for ratio, direction, key in (
                (self.ratio_h, "horizontal", "pcd_horizontal_flip"),
                (self.ratio_v, "vertical", "pcd_vertical_flip")):
            if rng.rand() < ratio:
                data["points"].flip(direction)
                if "gt_bboxes_3d" in data:
                    data["gt_bboxes_3d"].flip(direction)
                data[key] = True
        return data


@PIPELINES.register_module()
class PointsRangeFilter:
    """Keep the points inside point_cloud_range (open bounds)."""

    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, data: dict) -> dict:
        data["points"] = data["points"][data["points"].in_range_3d(self.pcr)]
        return data


@PIPELINES.register_module()
class ObjectRangeFilter:
    """Keep the GT boxes whose BEV centre is inside the range; yaw then
    limited to [-pi, pi)."""

    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, data: dict) -> dict:
        boxes = data["gt_bboxes_3d"]
        mask = boxes.in_range_bev(self.pcr[[0, 1, 3, 4]])
        data["gt_bboxes_3d"] = boxes[mask]
        data["gt_labels_3d"] = data["gt_labels_3d"][mask]
        data["gt_bboxes_3d"].limit_yaw(offset=0.5, period=2 * np.pi)
        return data


@PIPELINES.register_module()
class ObjectNameFilter:
    """Keep the GT boxes whose label is one of ``classes``."""

    def __init__(self, classes):
        self.labels = list(range(len(classes)))

    def __call__(self, data: dict) -> dict:
        mask = np.isin(data["gt_labels_3d"], self.labels)
        data["gt_bboxes_3d"] = data["gt_bboxes_3d"][mask]
        data["gt_labels_3d"] = data["gt_labels_3d"][mask]
        return data


@PIPELINES.register_module()
class PointShuffle:
    def __call__(self, data: dict) -> dict:
        data["points"].shuffle(sample_rng(data))
        return data


@PIPELINES.register_module(name=["PointSample", "IndoorPointSample"])
class PointSample:
    """``num_points`` points drawn at random (with replacement when the
    cloud is smaller); an empty cloud becomes zeros."""

    def __init__(self, num_points: int):
        self.num_points = int(num_points)

    def __call__(self, data: dict) -> dict:
        pts = data["points"]
        n = len(pts)
        if n == 0:
            data["points"] = pts.new_point(
                np.zeros((self.num_points, pts.tensor.shape[1]), np.float32))
            return data
        idx = sample_rng(data).choice(n, self.num_points,
                                      replace=n < self.num_points)
        data["points"] = pts[idx]
        return data


@PIPELINES.register_module()
class ImageNormalize:
    """uint8 views -> float32 ``(img / 255 - mean) / std`` per channel."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, results: dict) -> dict:
        results["img"] = [
            (np.asarray(img, np.float32) / 255.0 - self.mean) / self.std
            for img in results["img"]]
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std)
        return results


@PIPELINES.register_module()
class ImageAug3D:
    """Per view: resize, crop to ``final_dim`` (H, W), left-right flip and
    rotate (degrees), as PIL does them; ``img_aug_matrix`` (Nv, 4, 4) maps
    original pixels to the augmented ones. Train: per view a resize, a
    bottom share, a crop x and a rotation drawn uniformly and a flip
    chosen, in that order; test: the ranges' means, centred crop."""

    def __init__(self, final_dim, resize_lim, bot_pct_lim, rot_lim,
                 rand_flip: bool, is_train: bool):
        self.final_dim = final_dim
        self.resize_lim = resize_lim
        self.bot_pct_lim = bot_pct_lim
        self.rot_lim = rot_lim
        self.rand_flip = rand_flip
        self.is_train = is_train

    def sample_augmentation(self, results):
        w, h = results["ori_shape"]
        fh, fw = self.final_dim
        if self.is_train:
            rng = sample_rng(results)
            resize = rng.uniform(*self.resize_lim)
            new_w, new_h = int(w * resize), int(h * resize)
            crop_h = int((1 - rng.uniform(*self.bot_pct_lim))
                         * new_h) - fh
            crop_w = int(rng.uniform(0, max(0, new_w - fw)))
            crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
            flip = bool(self.rand_flip and rng.choice([0, 1]))
            rotate = rng.uniform(*self.rot_lim)
        else:
            resize = float(np.mean(self.resize_lim))
            new_w, new_h = int(w * resize), int(h * resize)
            crop_h = int((1 - np.mean(self.bot_pct_lim)) * new_h) - fh
            crop_w = int(max(0, new_w - fw) / 2)
            crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
            flip, rotate = False, 0.0
        return resize, (new_w, new_h), crop, flip, rotate

    @staticmethod
    def img_transform(img, resize, resize_dims, crop, flip, rotate):
        """The augmented view and its 2 x 2 rotation and translation (the
        JAX package's float32 operations, in its order)."""
        rotation = np.eye(2, dtype=np.float32)
        translation = np.zeros(2, np.float32)
        img = image_io.resize(img, resize_dims)
        img = image_io.crop(img, crop)
        if flip:
            img = image_io.flip_lr(img)
        img = image_io.rotate(img, rotate)

        rotation = rotation * resize
        translation = translation - np.asarray(crop[:2], np.float32)
        if flip:
            a = np.array([[-1, 0], [0, 1]], np.float32)
            b = np.array([crop[2] - crop[0], 0], np.float32)
            rotation = a @ rotation
            translation = a @ translation + b
        theta = rotate / 180 * np.pi
        a = np.array([[np.cos(theta), np.sin(theta)],
                      [-np.sin(theta), np.cos(theta)]], np.float32)
        b = np.array([crop[2] - crop[0], crop[3] - crop[1]],
                     np.float32) / 2
        b = a @ (-b) + b
        rotation = a @ rotation
        translation = a @ translation + b
        return img, rotation, translation

    def __call__(self, data: dict) -> dict:
        if "img" not in data:
            return data
        new_imgs, transforms = [], []
        for img in data["img"]:
            resize, dims, crop, flip, rotate = self.sample_augmentation(data)
            new_img, rotation, translation = self.img_transform(
                img, resize, dims, crop, flip, rotate)
            t = np.eye(4, dtype=np.float32)
            t[:2, :2] = rotation
            t[:2, 3] = translation
            new_imgs.append(new_img)
            transforms.append(t)
        data["img"] = new_imgs
        data["img_aug_matrix"] = np.stack(transforms)
        return data


@PIPELINES.register_module()
class GlobalRotScaleTransV2:
    """Global rotation, scaling and translation of points and GT boxes
    (train: scale, theta, then three normal translations drawn), recorded
    as the 4 x 4 ``lidar_aug_matrix`` (identity in test)."""

    def __init__(self, resize_lim, rot_lim, trans_lim, is_train: bool):
        self.resize_lim = resize_lim
        self.rot_lim = rot_lim
        self.trans_lim = trans_lim
        self.is_train = is_train

    def __call__(self, data: dict) -> dict:
        transform = np.eye(4, dtype=np.float32)
        if self.is_train:
            rng = sample_rng(data)
            scale = rng.uniform(*self.resize_lim)
            theta = rng.uniform(*self.rot_lim)
            translation = np.array(
                [rng.normal(0, self.trans_lim) for _ in range(3)],
                np.float32)
            gt_boxes = data["gt_bboxes_3d"]
            # the box class turns the points with its own sign
            if "points" in data:
                _, rotation = gt_boxes.rotate(theta, data["points"])
                data["points"].translate(translation)
                data["points"].scale(scale)
            else:
                rotation = gt_boxes.rotate(theta)
            gt_boxes.translate(translation)
            gt_boxes.scale(scale)
            transform[:3, :3] = rotation.T * scale
            transform[:3, 3] = translation * scale
        data["lidar_aug_matrix"] = transform
        return data


@PIPELINES.register_module()
class RandomFlip3DV2:
    """BEV flips of points and boxes, each with probability 1/2 (two
    choices drawn, also in test), composed into ``lidar_aug_matrix``."""

    def __call__(self, data: dict) -> dict:
        rng = sample_rng(data)
        rotation = np.eye(3, dtype=np.float32)
        for direction, mirror in (("horizontal", [1, -1, 1]),
                                  ("vertical", [-1, 1, 1])):
            if rng.choice([0, 1]):
                rotation = np.diag(np.asarray(mirror, np.float32)) @ rotation
                if "points" in data:
                    data["points"].flip(direction)
                if "gt_bboxes_3d" in data:
                    data["gt_bboxes_3d"].flip(direction)
        if "lidar_aug_matrix" not in data:
            data["lidar_aug_matrix"] = np.eye(4, dtype=np.float32)
        data["lidar_aug_matrix"][:3, :] = \
            rotation @ data["lidar_aug_matrix"][:3, :]
        return data


@PIPELINES.register_module()
class ModalMask3D:
    """Camera-view dropping as a boolean ``img_view_mask`` (Nv,): in
    train, before ``stop_epoch``, with probability 1/2 three views (two
    outside nuScenes) drawn without replacement are dropped; in test view
    0 is."""

    def __init__(self, mode: str = "train",
                 dataset_type: str = "NuScenesDataset", stop_epoch=None,
                 **kwargs):
        self.mode = mode
        self.dataset_type = dataset_type
        self.stop_epoch = stop_epoch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __call__(self, data: dict) -> dict:
        n = len(data["img"]) if isinstance(data.get("img"), (list, tuple)) \
            else int(data.get("num_views", 6))
        mask = np.ones((n,), bool)
        if self.mode == "test":
            mask[0] = False
        elif self.stop_epoch is None or self.epoch < self.stop_epoch:
            rng = sample_rng(data)
            if rng.rand() > 0.5:
                k = 3 if self.dataset_type == "NuScenesDataset" else 2
                mask[rng.choice(n, k, replace=False)] = False
        data["img_view_mask"] = mask
        return data


@PIPELINES.register_module()
class ObjectSampleV2:
    """GT-paste (``MMDataBaseSamplerV2``) until ``stop_epoch``: the
    sampled boxes and labels are appended, the real points inside them
    removed, their object points put first, and, with ``sample_2d``, the
    views replaced by the pasted ones."""

    def __init__(self, db_sampler: dict, sample_2d: bool = True,
                 stop_epoch: Optional[int] = None):
        cfg = dict(db_sampler)
        cfg.setdefault("type", "MMDataBaseSamplerV2")
        self.db_sampler = build_from_cfg(cfg, OBJECT_SAMPLERS)
        self.sample_2d = sample_2d
        self.stop_epoch = stop_epoch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __call__(self, data: dict) -> dict:
        if self.stop_epoch is not None and self.epoch >= self.stop_epoch:
            return data
        sampled = self.db_sampler.sample_all(
            data["gt_bboxes_3d"].numpy(), data["gt_labels_3d"],
            sample_rng(data), imgs=data.get("img"),
            gt_bboxes_2d=data.get("gt_bboxes"))
        if sampled is None:
            return data
        data["gt_bboxes_3d"] = data["gt_bboxes_3d"].new_box(
            np.concatenate([data["gt_bboxes_3d"].numpy(),
                            sampled["gt_bboxes_3d"]], 0))
        data["gt_labels_3d"] = np.concatenate(
            [data["gt_labels_3d"], sampled["gt_labels_3d"]], 0)
        points = data["points"]
        masks = points_in_rbbox(points.numpy(), sampled["gt_bboxes_3d"])
        points = points[~masks.any(-1)]
        data["points"] = points.new_point(
            np.concatenate([sampled["points"], points.numpy()], 0))
        if self.sample_2d and sampled.get("imgs") is not None:
            data["img"] = sampled["imgs"]
        return data


# --------------------------------------------- the outdoor LiDAR transforms
@PIPELINES.register_module()
class ObjectNoise:
    """Per-object jitter (SECOND's ``noise_per_object_v3_``): each GT box,
    in order, draws a translation N(0, ``translation_std``) and a yaw
    U(``rot_range``) until the moved box overlaps no other current box in
    BEV (at most ``num_try`` draws; else it stays), then moves with its
    points (those inside it before any move)."""

    def __init__(self, translation_std=(0.25, 0.25, 0.25),
                 rot_range=(-0.15707963267, 0.15707963267),
                 num_try: int = 100, global_rot_range=(0.0, 0.0)):
        self.translation_std = np.asarray(translation_std, np.float32)
        self.rot_range = rot_range
        self.num_try = int(num_try)

    def __call__(self, data: dict) -> dict:
        from ...core.bbox.box_np_ops import box_collision_test
        boxes, pts = data["gt_bboxes_3d"], data["points"]
        arr = boxes.numpy()
        if len(arr) == 0:
            return data
        rng = sample_rng(data)
        inside = points_in_rbbox(pts.numpy(), arr)
        tensor = pts.numpy()
        for i in range(len(arr)):
            t, r = np.zeros(3, np.float32), 0.0
            others = np.delete(arr, i, axis=0)
            for _ in range(max(1, self.num_try)):
                t_c = rng.normal(scale=self.translation_std, size=3)
                r_c = rng.uniform(*self.rot_range)
                cand = arr[i:i + 1].copy()
                cand[0, :3] += t_c
                cand[0, 6] += r_c
                if len(others) == 0 or not box_collision_test(
                        cand[:, [0, 1, 3, 4, 6]],
                        others[:, [0, 1, 3, 4, 6]]).any():
                    t, r = t_c, r_c
                    break
            if r == 0.0 and not np.any(t):
                continue
            sel = inside[:, i]
            c = arr[i, :3].copy()
            cs, sn = np.cos(r), np.sin(r)
            rot = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]],
                           np.float32)
            # the points turn with the box's shape (yaw += r)
            tensor[sel, :3] = (tensor[sel, :3] - c) @ rot + c + t
            arr[i, :3] += t
            arr[i, 6] += r
        data["points"] = pts.new_point(tensor)
        data["gt_bboxes_3d"] = boxes.new_box(arr)
        return data


@PIPELINES.register_module()
class RandomJitterPoints:
    """Per-point N(0, ``jitter_std``) noise on xyz, clipped to
    ``clip_range`` (boxes untouched)."""

    def __init__(self, jitter_std=(0.01, 0.01, 0.01),
                 clip_range=(-0.05, 0.05)):
        if isinstance(jitter_std, (int, float)):
            jitter_std = [jitter_std] * 3
        self.jitter_std = np.asarray(jitter_std, np.float32)
        if clip_range is not None and isinstance(clip_range, (int, float)):
            clip_range = [-clip_range, clip_range]
        self.clip_range = clip_range

    def __call__(self, data: dict) -> dict:
        pts = data["points"]
        noise = sample_rng(data).randn(len(pts), 3).astype(np.float32) * \
            self.jitter_std[None, :]
        if self.clip_range is not None:
            noise = np.clip(noise, self.clip_range[0], self.clip_range[1])
        pts.translate(noise)
        return data


@PIPELINES.register_module()
class BackgroundPointsFilter:
    """Drops the points inside a GT box enlarged by
    ``bbox_enlarge_range`` but outside the box itself (a clean margin
    around each object)."""

    def __init__(self, bbox_enlarge_range):
        if isinstance(bbox_enlarge_range, (int, float)):
            bbox_enlarge_range = [float(bbox_enlarge_range)] * 3
        self.bbox_enlarge_range = np.asarray(bbox_enlarge_range,
                                             np.float32)[None, :]

    def __call__(self, data: dict) -> dict:
        boxes = data["gt_bboxes_3d"]
        arr = boxes.numpy().copy()
        arr[:, :3] = boxes.gravity_center
        enlarged = arr.copy()
        enlarged[:, 3:6] += self.bbox_enlarge_range
        pts = data["points"].numpy()
        if len(arr):
            fg = points_in_rbbox(pts, arr, origin=(0.5, 0.5, 0.5)).max(1)
            fg_en = points_in_rbbox(pts, enlarged,
                                    origin=(0.5, 0.5, 0.5)).max(1)
        else:
            fg = fg_en = np.zeros(len(pts), bool)
        valid = ~(~fg & fg_en)
        data["points"] = data["points"][valid]
        for key in ("pts_instance_mask", "pts_semantic_mask"):
            if data.get(key) is not None:
                data[key] = np.asarray(data[key])[valid]
        return data


@PIPELINES.register_module()
class VoxelBasedPointSampler:
    """Samples points by voxel budget: the current sweep's points (time
    channel ``time_dim`` 0) and the earlier sweeps' are each shuffled
    (current first), voxelized (``core/voxel_generator.py``) and padded
    to their ``max_voxels`` with copies of the first voxel; the per-point
    mask and segmentation fields ride along as extra channels."""

    def __init__(self, cur_sweep_cfg: dict, prev_sweep_cfg=None,
                 time_dim: int = 3):
        from ...core.voxel_generator import VoxelGenerator
        self.cur_voxel_generator = VoxelGenerator(**cur_sweep_cfg)
        self.cur_voxel_num = self.cur_voxel_generator._max_voxels
        self.time_dim = int(time_dim)
        if prev_sweep_cfg is not None:
            assert prev_sweep_cfg["max_num_points"] == \
                cur_sweep_cfg["max_num_points"]
            self.prev_voxel_generator = VoxelGenerator(**prev_sweep_cfg)
            self.prev_voxel_num = self.prev_voxel_generator._max_voxels
        else:
            self.prev_voxel_generator = None
            self.prev_voxel_num = 0

    @staticmethod
    def _sample(points: np.ndarray, sampler) -> np.ndarray:
        voxels, _, _ = sampler.generate(points)
        cap, per = sampler._max_voxels, sampler._max_num_points
        if voxels.shape[0] == 0:
            return np.zeros((cap, per, points.shape[-1]), points.dtype)
        if voxels.shape[0] < cap:
            pad = np.broadcast_to(voxels[:1], (cap - voxels.shape[0],) +
                                  voxels.shape[1:])
            voxels = np.concatenate([voxels, pad], 0)
        return voxels

    def __call__(self, data: dict) -> dict:
        pts = data["points"]
        arr = pts.numpy()
        original_dim = arr.shape[1]
        extra, fields2dim = [arr], []
        for key in list(data.get("pts_mask_fields", [])) + \
                list(data.get("pts_seg_fields", [])):
            fields2dim.append((key, original_dim + len(fields2dim)))
            extra.append(np.asarray(data[key])[..., None])
        arr = np.concatenate(extra, -1)
        cur_flag = arr[:, self.time_dim] == 0
        cur, prev = arr[cur_flag], arr[~cur_flag]
        if prev.shape[0] == 0:
            prev = cur
        rng = sample_rng(data)
        rng.shuffle(cur)
        rng.shuffle(prev)
        cur = self._sample(cur, self.cur_voxel_generator)
        if self.prev_voxel_generator is not None:
            arr = np.concatenate(
                [cur, self._sample(prev, self.prev_voxel_generator)], 0)
        else:
            arr = cur
        if self.cur_voxel_generator._max_num_points == 1:
            arr = arr.squeeze(1)
        data["points"] = pts.new_point(
            arr[..., :original_dim].astype(np.float32))
        for key, dim in fields2dim:
            data[key] = arr[..., dim]
        return data


@PIPELINES.register_module()
class GlobalAlignment:
    """The scene axis-aligned by ``ann_info['axis_align_matrix']`` (a 4x4
    with a rotation about ``rotation_axis`` and a translation): points
    ``xyz @ R^T + t``. ScanNet's boxes are stored aligned; the transform
    is not reversed."""

    def __init__(self, rotation_axis: int):
        self.rotation_axis = int(rotation_axis)

    def _check_rot_mat(self, rot: np.ndarray) -> None:
        valid = np.allclose(np.linalg.det(rot), 1.0, atol=1e-5)
        unit = np.zeros(3, rot.dtype)
        unit[self.rotation_axis] = 1.0
        valid &= np.allclose(rot[self.rotation_axis, :], unit)
        valid &= np.allclose(rot[:, self.rotation_axis], unit)
        if not valid:
            raise ValueError(f"invalid rotation matrix {rot}")

    def __call__(self, data: dict) -> dict:
        ann = data.get("ann_info", {})
        if "axis_align_matrix" not in ann:
            raise KeyError("GlobalAlignment needs ann_info's "
                           "axis_align_matrix")
        mat = np.asarray(ann["axis_align_matrix"], np.float32)
        if mat.shape != (4, 4):
            raise ValueError(f"invalid axis_align_matrix {mat.shape}")
        rot, trans = mat[:3, :3], mat[:3, 3]
        self._check_rot_mat(rot)
        data["points"].rotate(rot.T)
        data["points"].translate(trans)
        return data


@PIPELINES.register_module()
class RandomDropPointsColor:
    """Every point's colour set to 0 with probability ``drop_ratio`` (one
    draw a sample; kept as the reference's ``rand() > 1 - ratio``)."""

    def __init__(self, drop_ratio: float = 0.2):
        if not 0 <= drop_ratio <= 1:
            raise ValueError(f"invalid drop_ratio {drop_ratio}")
        self.drop_ratio = float(drop_ratio)

    def __call__(self, data: dict) -> dict:
        pts = data["points"]
        if not (pts.attribute_dims and "color" in pts.attribute_dims):
            raise KeyError("RandomDropPointsColor expects points with a "
                           "color attribute")
        if sample_rng(data).rand() > 1.0 - self.drop_ratio:
            pts.tensor[:, pts.attribute_dims["color"]] = 0.0
        return data


@PIPELINES.register_module()
class IndoorPatchPointSample:
    """A column patch of the scene, then ``num_points`` of its points
    (PointNet++'s ScanNet recipe): up to ``num_try`` random centres, the
    points within ``block_size`` / 2 (+ ``enlarge_size``) in x and y kept
    when the patch covers enough of a 31 x 31 x 62 grid (or has
    ``min_unique_num`` points) and 70% of its labels are not
    ``ignore_index``; sampled without replacement, or all of them and
    the rest drawn again; x and y re-centred on the patch's centre;
    ``use_normalized_coord`` appends xyz / the scene's max as attribute
    ``normalized_coord``. The draws, in the JAX package's order: each
    try's centre, then the choice."""

    def __init__(self, num_points: int, block_size: float = 1.5,
                 sample_rate=None, ignore_index=None,
                 use_normalized_coord: bool = False, num_try: int = 10,
                 enlarge_size: float = 0.2, min_unique_num=None,
                 eps: float = 1e-2):
        self.num_points = int(num_points)
        self.block_size = float(block_size)
        self.ignore_index = ignore_index
        self.use_normalized_coord = bool(use_normalized_coord)
        self.num_try = int(num_try)
        self.enlarge_size = float(enlarge_size) if enlarge_size else 0.0
        self.min_unique_num = min_unique_num
        self.eps = float(eps)

    def _patch(self, rng, coords: np.ndarray, sem: np.ndarray) -> tuple:
        coord_max = coords.max(0)
        coord_min = coords.min(0)
        point_idxs = np.arange(len(coords))
        cur_center = coords[0]
        for _ in range(self.num_try):
            cur_center = coords[rng.choice(len(coords))]
            half = np.array([self.block_size / 2, self.block_size / 2, 0.0])
            cur_max = cur_center + half
            cur_min = cur_center - half
            cur_max[2], cur_min[2] = coord_max[2], coord_min[2]
            choice = np.all((coords >= cur_min - self.enlarge_size)
                            & (coords <= cur_max + self.enlarge_size), 1)
            if not choice.any():
                continue
            cur_coords = coords[choice]
            point_idxs = np.where(choice)[0]
            mask = np.all((cur_coords >= cur_min - self.eps)
                          & (cur_coords <= cur_max + self.eps), 1)
            if self.min_unique_num is None:
                vidx = np.ceil((cur_coords[mask] - cur_min)
                               / np.maximum(cur_max - cur_min, 1e-6)
                               * np.array([31.0, 31.0, 62.0]))
                vidx = np.unique(vidx[:, 0] * 31 * 62 + vidx[:, 1] * 62
                                 + vidx[:, 2])
                flag1 = len(vidx) / (31.0 * 31.0 * 62.0) >= 0.02
            else:
                flag1 = mask.sum() >= self.min_unique_num
            flag2 = True if self.ignore_index is None else \
                np.sum(sem[choice] != self.ignore_index) / max(
                    len(sem[choice]), 1) >= 0.7
            if flag1 and flag2:
                break
        if len(point_idxs) >= self.num_points:
            choices = rng.choice(point_idxs, self.num_points, replace=False)
        else:
            dup = rng.choice(len(point_idxs),
                             self.num_points - len(point_idxs))
            choices = point_idxs[np.concatenate(
                [np.arange(len(point_idxs)), dup], 0)]
        return choices, cur_center, coord_max

    def __call__(self, data: dict) -> dict:
        pts = data["points"]
        if "pts_semantic_mask" not in data:
            raise KeyError("IndoorPatchPointSample needs pts_semantic_mask")
        sem = np.asarray(data["pts_semantic_mask"])
        coords = pts.numpy()[:, :3]
        attrs = pts.numpy()[:, 3:]
        choices, center, coord_max = self._patch(sample_rng(data), coords,
                                                 sem)
        sel_coords = coords[choices].copy()
        sel_coords[:, 0] -= center[0]
        sel_coords[:, 1] -= center[1]
        sel_attrs = attrs[choices]
        attribute_dims = dict(pts.attribute_dims or {})
        if self.use_normalized_coord:
            norm = coords[choices] / np.maximum(coord_max, 1e-6)
            start = 3 + sel_attrs.shape[1]
            sel_attrs = np.concatenate([sel_attrs, norm], 1)
            attribute_dims["normalized_coord"] = [start, start + 1,
                                                  start + 2]
        new = np.concatenate([sel_coords, sel_attrs], 1).astype(np.float32)
        out = pts.new_point(new)
        out.attribute_dims = attribute_dims or None
        data["points"] = out
        data["pts_semantic_mask"] = sem[choices]
        if data.get("pts_instance_mask") is not None:
            data["pts_instance_mask"] = \
                np.asarray(data["pts_instance_mask"])[choices]
        return data
