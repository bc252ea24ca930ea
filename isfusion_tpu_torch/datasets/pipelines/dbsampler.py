"""GT-database copy-paste sampler of the multimodal pipeline (counterpart
of ``isfusion_tpu/datasets/pipelines/dbsampler.py``): per class, GT
objects from an offline database (``tools/create_gt_database.py``) are
drawn, kept unless they collide in BEV (rotated boxes, with the existing
and the already kept ones) or, with ``check_2D_collision``, in the image
(their 2D boxes), and their image patches are pasted far to near with a
mixup blend.

The picks are a function of the sample's rng alone: each class draws
``min(num, len)`` distinct entries with ``rng.choice(len, k,
replace=False)``. The JAX package's ``BatchSampler`` shuffles each class
list once and walks it round-robin across samples; that state would
depend on which samples a loader worker saw before, so a resumed run
would draw other objects and the worker count would change the data.
Every draw comes from the sample's rng, in the JAX order: the 2D
collision threshold, then each class's picks.

Images are (H, W, 3) uint8 arrays; patches are PNG files read by
``image_io.read_png`` and resized, where the paste region is larger, by
``image_io.resize`` (PIL's, bit for bit).
"""
from __future__ import annotations

import copy
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ...core.bbox.box_np_ops import box_collision_test
from ...registry import OBJECT_SAMPLERS
from . import image_io


class BatchSampler:
    """One class's database entries."""

    def __init__(self, sampled_list: List[dict], name: str):
        self._sampled_list = sampled_list
        self._name = name

    def sample(self, num: int, rng: np.random.RandomState) -> List[dict]:
        """``min(num, len)`` distinct entries drawn from ``rng``."""
        n = len(self._sampled_list)
        if num == 0 or n == 0:
            return []
        return [self._sampled_list[i]
                for i in rng.choice(n, min(num, n), replace=False)]


@OBJECT_SAMPLERS.register_module()
class MMDataBaseSamplerV2:
    def __init__(self, info_path: str, data_root: str = "",
                 rate: float = 1.0, prepare: Optional[dict] = None,
                 sample_groups: Optional[dict] = None,
                 classes: Optional[list] = None, img_num: int = 6,
                 blending_type=None, depth_consistent: bool = True,
                 check_2D_collision: bool = True, collision_thr=0.0,
                 mixup: float = 1.0, points_loader: Optional[dict] = None):
        self.data_root = data_root
        self.rate = rate
        self.classes = list(classes or [])
        self.cat2label = {c: i for i, c in enumerate(self.classes)}
        self.img_num = img_num
        self.blending_type = blending_type
        self.depth_consistent = depth_consistent
        self.check_2D_collision = check_2D_collision
        self.collision_thr = collision_thr
        self.mixup = mixup

        with open(info_path, "rb") as f:
            db_infos: Dict[str, List[dict]] = pickle.load(f)
        prepare = dict(prepare or {})
        if "filter_by_difficulty" in prepare:
            removed = set(prepare["filter_by_difficulty"])
            db_infos = {
                k: [i for i in v if i.get("difficulty", 0) not in removed]
                for k, v in db_infos.items()}
        if "filter_by_min_points" in prepare:
            for name, min_num in prepare["filter_by_min_points"].items():
                if name in db_infos:
                    db_infos[name] = [
                        i for i in db_infos[name]
                        if i.get("num_points_in_gt", 1e9) >= int(min_num)]
        self.db_infos = db_infos
        self.sample_groups = {k: int(v)
                              for k, v in (sample_groups or {}).items()}
        self.samplers = {k: BatchSampler(db_infos.get(k, []), k)
                         for k in self.sample_groups}

    def _load_points(self, info: dict) -> np.ndarray:
        """An object's points, stored relative to its box, moved back."""
        path = os.path.join(self.data_root, info["path"])
        if path.endswith(".npy"):
            pts = np.load(path)
        else:
            pts = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
        pts = pts.copy()
        pts[:, :3] += np.asarray(info["box3d_lidar"][:3], np.float32)
        return pts

    def _pick_collision_thr(self, rng: np.random.RandomState) -> float:
        """``collision_thr`` as a float, a list (a uniform choice) or a
        dict (mode 'value' or 'range')."""
        thr = self.collision_thr
        if isinstance(thr, (int, float)):
            return float(thr)
        if isinstance(thr, (list, tuple)):
            return float(rng.choice(list(thr)))
        if isinstance(thr, dict):
            if thr.get("mode", "value") == "range":
                lo, hi = thr["thr_range"]
                return float(rng.uniform(lo, hi))
            return float(rng.choice(list(thr["thr_range"])))
        return 0.0

    @staticmethod
    def _coll_2d(total_2d: np.ndarray, thr: float) -> np.ndarray:
        """Image-space collisions of (x1, y1, x2, y2) boxes: any overlap at
        ``thr`` 0, else intersection over the query box > ``thr``."""
        n = len(total_2d)
        if n == 0:
            return np.zeros((0, 0), bool)
        iw = (np.minimum(total_2d[:, None, 2], total_2d[None, :, 2]) -
              np.maximum(total_2d[:, None, 0], total_2d[None, :, 0]))
        ih = (np.minimum(total_2d[:, None, 3], total_2d[None, :, 3]) -
              np.maximum(total_2d[:, None, 1], total_2d[None, :, 1]))
        inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
        if thr == 0:
            return inter > 0
        area = ((total_2d[:, 2] - total_2d[:, 0]) *
                (total_2d[:, 3] - total_2d[:, 1]))
        return inter / np.maximum(area[None, :], 1e-6) > thr

    def sample_all(self, gt_bboxes: np.ndarray, gt_labels: np.ndarray,
                   rng: np.random.RandomState, imgs=None,
                   gt_bboxes_2d: Optional[np.ndarray] = None
                   ) -> Optional[dict]:
        """gt_bboxes (G, >= 7), gt_labels (G,) -> dict of the kept
        objects' boxes, labels and points (and the pasted views when
        ``imgs`` are given), or None when none was kept."""
        sampled_infos: List[dict] = []
        avoid = gt_bboxes.copy() if len(gt_bboxes) else \
            np.zeros((0, 9), np.float32)
        avoid_2d = np.asarray(gt_bboxes_2d, np.float32).reshape(-1, 4) \
            if gt_bboxes_2d is not None else np.zeros((0, 4), np.float32)
        # the row of `avoid` each 2D box belongs to
        avoid_2d_rows = np.arange(len(avoid_2d))
        thr_2d = self._pick_collision_thr(rng) if self.check_2D_collision \
            else None
        for name, max_num in self.sample_groups.items():
            label = self.cat2label.get(name)
            if label is None:
                continue
            existing = int((gt_labels == label).sum())
            num = int(self.rate * max(0, max_num - existing))
            if num <= 0:
                continue
            cands = self.samplers[name].sample(num, rng)
            if not cands:
                continue
            new_boxes = np.stack(
                [np.asarray(c["box3d_lidar"], np.float32) for c in cands])
            all_boxes = np.concatenate(
                [avoid[:, :7], new_boxes[:, :7]], axis=0)
            bev = all_boxes[:, [0, 1, 3, 4, 6]]
            coll = box_collision_test(bev, bev)
            # candidates without a 2D box never collide in the image
            if thr_2d is not None:
                new_2d = np.stack(
                    [np.asarray(c.get("bbox", [0, 0, 0, 0]), np.float32)
                     for c in cands])
                has_2d = np.asarray(
                    [c.get("bbox") is not None for c in cands])
                total_2d = np.concatenate([avoid_2d, new_2d], axis=0)
                c2d = self._coll_2d(total_2d, thr_2d)
                if len(total_2d) != len(all_boxes) or \
                        not np.array_equal(avoid_2d_rows,
                                           np.arange(len(avoid))):
                    full = np.zeros((len(all_boxes),) * 2, bool)
                    idx = np.r_[avoid_2d_rows,
                                len(avoid) + np.arange(len(new_2d))]
                    full[np.ix_(idx, idx)] = c2d
                    c2d = full
                n_av = len(avoid)
                c2d[n_av:][~has_2d] = False
                c2d[:, n_av:][:, ~has_2d] = False
                coll = coll | c2d
            np.fill_diagonal(coll, False)
            n_avoid = avoid.shape[0]
            keep = []
            for i in range(new_boxes.shape[0]):
                gi = n_avoid + i
                if not coll[gi, :gi].any():
                    keep.append(i)
                else:
                    coll[gi, :] = False
                    coll[:, gi] = False
            if not keep:
                continue
            kept_boxes = new_boxes[keep]
            pad = np.zeros((kept_boxes.shape[0],
                            max(0, avoid.shape[1] - kept_boxes.shape[1])),
                           np.float32)
            avoid = np.concatenate(
                [avoid, np.concatenate([kept_boxes, pad], 1)
                 [:, :avoid.shape[1]]], axis=0)
            if thr_2d is not None:
                kept_2d, kept_rows = [], []
                for rank, i in enumerate(keep):
                    if cands[i].get("bbox") is not None:
                        kept_2d.append(
                            np.asarray(cands[i]["bbox"], np.float32))
                        kept_rows.append(n_avoid + rank)
                if kept_2d:
                    avoid_2d = np.concatenate(
                        [avoid_2d, np.stack(kept_2d)], axis=0)
                    avoid_2d_rows = np.concatenate(
                        [avoid_2d_rows, np.asarray(kept_rows)])
            for i in keep:
                info = copy.deepcopy(cands[i])
                info["label"] = label
                sampled_infos.append(info)

        if not sampled_infos:
            return None
        boxes = np.stack([np.asarray(i["box3d_lidar"], np.float32)
                          for i in sampled_infos])
        labels = np.asarray([i["label"] for i in sampled_infos], np.int64)
        points = np.concatenate(
            [self._load_points(i) for i in sampled_infos], axis=0)
        out = dict(gt_bboxes_3d=boxes, gt_labels_3d=labels, points=points,
                   imgs=None)
        if imgs is not None:
            out["imgs"] = self._paste_images(imgs, sampled_infos)
        return out

    def _paste_images(self, imgs, sampled_infos: List[dict]):
        """Far-to-near patch pasting with a mixup blend inside a 5% margin
        (or a feathered mask with ``blending_type='gaussian'``); objects
        without a patch keep their LiDAR paste only."""
        with_patch = [i for i in sampled_infos
                      if i.get("image_path") and i.get("bbox") is not None
                      and i.get("cam_idx") is not None]
        if not with_patch:
            return imgs
        # far objects first, so that near ones overdraw them
        if self.depth_consistent:
            with_patch.sort(
                key=lambda i: -float(np.linalg.norm(i["box3d_lidar"][:2])))
        imgs = [np.array(img) for img in imgs]
        for info in with_patch:
            cam = int(info["cam_idx"])
            if cam >= len(imgs):
                continue
            patch_path = os.path.join(self.data_root, info["image_path"])
            if not os.path.exists(patch_path):
                continue
            patch = image_io.read_png(patch_path)
            x1, y1, x2, y2 = [int(v) for v in info["bbox"]]
            tarr = imgs[cam]
            img_h, img_w = tarr.shape[:2]
            x1 = max(x1, 0)
            y1 = max(y1, 0)
            w = max(min(x2, img_w - 1) - x1 + 1, 1)
            h = max(min(y2, img_h - 1) - y1 + 1, 1)
            if patch.shape[0] < h or patch.shape[1] < w:
                patch = image_io.resize(patch, (w, h))
            parr = patch.astype(np.float32)[:h, :w, :tarr.shape[-1]]
            mask = np.zeros((h, w), np.float32)
            mh, mw = int(0.05 * h), int(0.05 * w)
            mask[mh:h - mh, mw:w - mw] = 1.0
            if self.blending_type == "gaussian" and h > 4 and w > 4:
                yy = np.linspace(-1, 1, h)[:, None]
                xx = np.linspace(-1, 1, w)[None]
                mask = np.exp(-((yy ** 4 + xx ** 4) * 3.0)).astype(
                    np.float32)
            region = tarr[y1:y1 + h, x1:x1 + w].astype(np.float32)
            blended = region * (1 - mask[..., None] * self.mixup) + \
                parr * mask[..., None] * self.mixup
            tarr[y1:y1 + h, x1:x1 + w] = blended.astype(tarr.dtype)
        return imgs
