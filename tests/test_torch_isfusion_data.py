"""The IS-Fusion flagship's data path in the port against the JAX package:
``image_io`` against PIL, each new transform against its JAX class, both
pipelines of ``configs/isfusion/isfusion_0075voxel.py`` sample by sample
through the dataset, ``CBGSDataset``, the test loader's batches, a predict
on one loader batch against the JAX detector on carried weights, and two
epochs of ``train_model`` on the tiny flagship with an exact resume,
``single_device_test`` and ``evaluate``.

The fixture is the port's generator (4 train / 2 val samples, 3,000
key-frame points, 90 x 160 PNG views, all 10 classes) with its GT
database. Random transforms: JAX draws from the global ``np.random``
after ``np.random.set_state``, the port from a ``RandomState`` in the
same state. Three draws differ by design and are pinned: ``ModalMask3D``'s
view choice (JAX: Python's ``random.sample``, patched here to draw
``np.random.choice(n, k, replace=False)`` as the port does), the GT
sampler's picks (patched on both sides to each class list's first
entries) and ``PointShuffle``'s permutation (JAX: an unseeded generator,
patched here to permute from the global ``np.random`` as the port does
from its rng). Tolerances: points, masks, boxes, labels, matrices, the
view mask and the images bit for bit (the resize is PIL's exactly);
predict within 1e-3 of the max (float32, CPU).
"""
import ast
import copy
import json
import os
import pickle
import random
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from isfusion_tpu.datasets import CBGSDataset as JaxCBGS
from isfusion_tpu.datasets import DataLoader as JaxLoader
from isfusion_tpu.datasets import NuScenesDataset as JaxNuScenes
from isfusion_tpu.datasets.pipelines import dbsampler as jdb
from isfusion_tpu.datasets.pipelines import loading as jload
from isfusion_tpu.datasets.pipelines import test_time_aug as jtta
from isfusion_tpu.datasets.pipelines import transforms_3d as jtrans
from isfusion_tpu.core.bbox import box_np_ops as jbox
from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu_torch.apis import (init_model, single_device_test,
                                     train_model)
from isfusion_tpu_torch.config import Config
from isfusion_tpu_torch.core.bbox import box_np_ops as tbox
from isfusion_tpu_torch.datasets import (CBGSDataset, NuScenesDataset,
                                         build_dataloader, build_dataset,
                                         collate_batch)
from isfusion_tpu_torch.datasets.pipelines import dbsampler as tdb
from isfusion_tpu_torch.datasets.pipelines import formating as tformat
from isfusion_tpu_torch.datasets.pipelines import image_io
from isfusion_tpu_torch.datasets.pipelines import loading as tload
from isfusion_tpu_torch.datasets.pipelines import test_time_aug as ttta
from isfusion_tpu_torch.datasets.pipelines import transforms_3d as ttrans
from isfusion_tpu_torch.flagship import flagship_model_cfg
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from isfusion_tpu_torch.tools import make_synthetic_nuscenes as tgen
from isfusion_tpu_torch.tools import test as ttest_cli
from isfusion_tpu_torch.tools import train as ttrain_cli
from isfusion_tpu_torch.tools.create_gt_database import \
    create_groundtruth_database
from test_torch_isfusion import _uncapped_cfg
from tools.data_converter import create_gt_database as jgt
from torch_parity import assert_close_to_max, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CFG = os.path.join(REPO, "configs", "isfusion",
                            "isfusion_0075voxel.py")
IMG_HW = (90, 160)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("syn_img"))
    tgen.make_dataset(out, train=4, val=2, points=3000, img_hw=IMG_HW,
                      seed=0, images=True, gt_database=True)
    return out


def flagship_cfg(root: str, final_dim=None, pcr=None, max_points=None):
    """The flagship config with its data paths at ``root``; optionally
    its image size, point range and point budget cut for a tiny model."""
    cfg = Config.fromfile(FLAGSHIP_CFG)
    splits = [cfg.data.train.dataset, cfg.data.val, cfg.data.test]
    for d, ann in zip(splits, ("train", "val", "val")):
        d.update(data_root=root, ann_file=os.path.join(
            root, f"nuscenes_infos_{ann}.pkl"))
        pipe = list(d.pipeline)
        for t in d.pipeline:
            pipe += t.get("transforms", [])
        for t in pipe:
            if t["type"] == "ObjectSampleV2":
                t["db_sampler"].update(data_root=root, info_path=os.path.join(
                    root, "nuscenes_dbinfos_train.pkl"))
            if t["type"] == "ImageAug3D" and final_dim:
                t["final_dim"] = final_dim
            if "point_cloud_range" in t and pcr:
                t["point_cloud_range"] = pcr
            if t["type"] == "DefaultFormatBundle3D" and max_points:
                t["max_points"] = max_points
    return cfg


def _kw(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "type"}


# --------------------------------------------------------------- image_io
def _fixture_img(h=40, w=48, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 60, (h, w, 3)) +
            np.linspace(0, 195, h)[:, None, None]).astype(np.uint8)


def _png_with_filters(img: np.ndarray, kinds) -> bytes:
    """A PNG of ``img`` whose rows use the row filters ``kinds`` in turn
    (a plain encoder of the five filters of the PNG specification)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        prior = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("writer", ["port", "pil", "every_filter"])
def test_png_decode_matches_pil(tmp_path, writer):
    img = _fixture_img()
    img[5:9, 10:30] = np.random.default_rng(1).integers(0, 256, (4, 20, 3))
    path = str(tmp_path / "a.png")
    if writer == "port":
        image_io.write_png(path, img)
    elif writer == "pil":
        Image.fromarray(img).save(path)
    else:
        with open(path, "wb") as f:
            f.write(_png_with_filters(img, [0, 1, 2, 3, 4]))
    got = image_io.read_png(path)
    want = np.asarray(Image.open(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("box", [(0, 13, 48, 37), (-10, -5, 20, 30),
                                 (30, 20, 60, 50)])
def test_crop_and_flip_match_pil(box):
    img = _fixture_img()
    np.testing.assert_array_equal(image_io.crop(img, box),
                                  np.asarray(Image.fromarray(img).crop(box)))
    np.testing.assert_array_equal(
        image_io.flip_lr(img), np.asarray(Image.fromarray(img).transpose(
            Image.FLIP_LEFT_RIGHT)))


@pytest.mark.parametrize("angle", [-5.4, -2.37, 0.0, 0.001, 3.3, 5.4, 90.0])
def test_rotate_matches_pil(angle):
    img = _fixture_img(37, 52)
    np.testing.assert_array_equal(image_io.rotate(img, angle), np.asarray(
        Image.fromarray(img).rotate(angle)))


@pytest.mark.parametrize("size", [(91, 51), (115, 64), (132, 74), (161, 91),
                                  (7, 3)])
def test_resize_matches_pil(size):
    """PIL's bicubic resample (default for RGB): here bit for bit, which
    is inside the 1-LSB-on-1%-of-pixels tolerance the port allows."""
    img = _fixture_img(*IMG_HW, seed=2)
    got = image_io.resize(img, size)
    want = np.asarray(Image.fromarray(img).resize(size))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ GT database
def test_gt_database_matches_jax(fixture_dir, tmp_path):
    """The JAX tool on the same fixture (PIL reading the PNG views and
    writing the patches, JAX projecting): the same objects, points,
    cameras and patches; the 2D boxes within 1e-4 px."""
    kw = dict(ann_file=os.path.join(fixture_dir, "nuscenes_infos_train.pkl"),
              data_root=fixture_dir, classes=tgen.CLASSES, test_mode=False,
              modality=dict(use_camera=True, use_lidar=True))
    jpath = jgt.create_groundtruth_database(JaxNuScenes(**kw),
                                            out_dir=str(tmp_path))
    tpath = create_groundtruth_database(NuScenesDataset(**kw),
                                        out_dir=str(tmp_path / "port"))
    want, got = (pickle.load(open(p, "rb")) for p in (jpath, tpath))
    assert list(got) == list(want)
    patches = 0
    for name in want:
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            assert set(g) == set(w)
            for k in ("name", "path", "gt_idx", "num_points_in_gt",
                      "difficulty", "cam_idx", "image_path"):
                assert g.get(k) == w.get(k), k
            np.testing.assert_array_equal(g["box3d_lidar"], w["box3d_lidar"])
            np.testing.assert_array_equal(
                np.load(tmp_path / "port" / g["path"]),
                np.load(tmp_path / w["path"]))
            if "bbox" in w:
                np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-4)
            if "image_path" in w:
                np.testing.assert_array_equal(
                    image_io.read_png(str(tmp_path / "port" /
                                          g["image_path"])),
                    np.asarray(Image.open(tmp_path / w["image_path"])))
                patches += 1
    assert patches >= 20


# ------------------------------------------------------------- transforms
def _loaded(root, index=0, split="train", images=True, sweeps=False):
    """One sample loaded by both packages (JAX: PIL images)."""
    load = [dict(type="LoadPointsFromFile", coord_type="LIDAR", load_dim=5,
                 use_dim=5)]
    if sweeps:
        load.append(dict(type="LoadPointsFromMultiSweeps", sweeps_num=10,
                         use_dim=[0, 1, 2, 3, 4]))
    load.append(dict(type="LoadAnnotations3D", with_bbox_3d=True,
                     with_label_3d=True))
    if images:
        load.append(dict(type="LoadMultiViewImageFromFilesV2",
                         to_float32=True))
    kw = dict(ann_file=os.path.join(root, f"nuscenes_infos_{split}.pkl"),
              data_root=root, classes=tgen.CLASSES, pipeline=load,
              modality=dict(use_camera=True, use_lidar=True))
    res = []
    for ds in (JaxNuScenes(**kw), NuScenesDataset(**kw)):
        r = ds.get_data_info(index)
        ds.pre_pipeline(r)
        res.append(ds.pipeline(r))
    return res


def _views(imgs):
    return np.stack([np.asarray(i) for i in imgs])


def test_loading_matches_jax(fixture_dir):
    jres, tres = _loaded(fixture_dir, index=1, sweeps=True)
    np.testing.assert_array_equal(tres["points"].tensor,
                                  jres["points"].tensor)
    assert len(tres["points"]) > 4000          # key frame + 3 sweeps
    np.testing.assert_array_equal(_views(tres["img"]), _views(jres["img"]))
    assert tres["ori_shape"] == jres["ori_shape"] == (IMG_HW[1], IMG_HW[0])
    for k in ("lidar2img", "camera_intrinsics", "camera2lidar"):
        assert tres[k].dtype == jres[k].dtype == np.float32
        np.testing.assert_array_equal(tres[k], jres[k])
    assert tres["img_filename"] == jres["img_filename"]


def test_multisweep_draw_matches_jax(fixture_dir):
    """Fewer sweeps kept than there are: the choice is drawn."""
    jres, tres = _loaded(fixture_dir, index=2, images=False)
    np.random.seed(4)
    want = jload.LoadPointsFromMultiSweeps(sweeps_num=2, use_dim=[0, 1, 2,
                                                                  3, 4])(jres)
    tres["rng"] = np.random.RandomState(4)
    got = tload.LoadPointsFromMultiSweeps(sweeps_num=2, use_dim=[0, 1, 2, 3,
                                                                 4])(tres)
    np.testing.assert_array_equal(got["points"].tensor,
                                  want["points"].tensor)


IMAGE_AUGS = {
    "train": dict(final_dim=(48, 96), resize_lim=[0.57, 0.825],
                  bot_pct_lim=[0.0, 0.0], rot_lim=[-5.4, 5.4],
                  rand_flip=True, is_train=True),
    "test": dict(final_dim=(48, 96), resize_lim=[0.72, 0.72],
                 bot_pct_lim=[0.0, 0.0], rot_lim=[0.0, 0.0],
                 rand_flip=False, is_train=False),
}


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("mode", sorted(IMAGE_AUGS))
def test_image_aug_and_normalize_match_jax(fixture_dir, mode, seed):
    jres, tres = _loaded(fixture_dir, index=seed % 4)
    np.random.seed(seed)
    want = jtrans.ImageAug3D(**IMAGE_AUGS[mode])(jres)
    tres["rng"] = np.random.RandomState(seed)
    got = ttrans.ImageAug3D(**IMAGE_AUGS[mode])(tres)
    assert got["img_aug_matrix"].dtype == want["img_aug_matrix"].dtype
    np.testing.assert_array_equal(got["img_aug_matrix"],
                                  want["img_aug_matrix"])
    np.testing.assert_array_equal(_views(got["img"]), _views(want["img"]))
    norm = dict(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
    want = jtrans.ImageNormalize(**norm)(want)
    got = ttrans.ImageNormalize(**norm)(got)
    assert _views(got["img"]).dtype == np.float32
    np.testing.assert_array_equal(_views(got["img"]), _views(want["img"]))


GLOBAL_AUGS = {
    "rot_scale_train": lambda m: m.GlobalRotScaleTransV2(
        resize_lim=[0.9, 1.1], rot_lim=[-0.78539816, 0.78539816],
        trans_lim=0.5, is_train=True),
    "rot_scale_test": lambda m: m.GlobalRotScaleTransV2(
        resize_lim=[1.0, 1.0], rot_lim=[0.0, 0.0], trans_lim=0.0,
        is_train=False),
}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(GLOBAL_AUGS))
def test_global_aug_and_flip_match_jax(fixture_dir, name, seed):
    jres, tres = _loaded(fixture_dir, index=seed, images=False)
    np.random.seed(seed)
    want = jtrans.RandomFlip3DV2()(GLOBAL_AUGS[name](jtrans)(jres))
    tres["rng"] = np.random.RandomState(seed)
    got = ttrans.RandomFlip3DV2()(GLOBAL_AUGS[name](ttrans)(tres))
    np.testing.assert_array_equal(got["points"].tensor,
                                  want["points"].tensor)
    np.testing.assert_array_equal(got["gt_bboxes_3d"].tensor,
                                  want["gt_bboxes_3d"].tensor)
    assert got["lidar_aug_matrix"].dtype == np.float32
    np.testing.assert_array_equal(got["lidar_aug_matrix"],
                                  want["lidar_aug_matrix"])


def _choice_sample(population, k):
    """``random.sample`` drawn as the port draws: from numpy's state."""
    return np.random.choice(len(population), k, replace=False).tolist()


@pytest.mark.parametrize("mode,epoch", [("train", 0), ("train", 8),
                                        ("test", 0)])
def test_modal_mask_matches_jax(fixture_dir, monkeypatch, mode, epoch):
    monkeypatch.setattr(random, "sample", _choice_sample)
    jres, tres = _loaded(fixture_dir, images=False)
    dropped = set()
    for seed in range(6):
        j = jtrans.ModalMask3D(mode=mode, stop_epoch=8)
        t = ttrans.ModalMask3D(mode=mode, stop_epoch=8)
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        np.random.seed(seed)
        want = j(dict(jres))["img_view_mask"]
        tres["rng"] = np.random.RandomState(seed)
        got = t(dict(tres))["img_view_mask"]
        np.testing.assert_array_equal(got, want)
        dropped.add(int((~got).sum()))
    assert dropped == {"train": {0, 3} if epoch < 8 else {0},
                       "test": {1}}[mode]


def test_box_np_ops_match_jax():
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(-5, 5, (20, 3)),
                            rng.uniform(0.5, 3, (20, 3)),
                            rng.uniform(-np.pi, np.pi, (20, 1))],
                           1).astype(np.float32)
    pts = rng.uniform(-6, 6, (500, 5)).astype(np.float32)
    inside = tbox.points_in_rbbox(pts, boxes)
    np.testing.assert_array_equal(inside, jbox.points_in_rbbox(pts, boxes))
    assert 0 < inside.sum() < inside.size
    bev = boxes[:, [0, 1, 3, 4, 6]]
    coll = tbox.box_collision_test(bev, bev[:7])
    np.testing.assert_array_equal(coll, jbox.box_collision_test(bev, bev[:7]))
    assert 0 < coll.sum() < coll.size


def _pinned(self, num, *rng):
    """A class's first ``num`` entries, drawing nothing."""
    return self._sampled_list[:num]


def _global_shuffle(self, data):
    data["points"].shuffle(np.random.mtrand._rand)
    return data


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_object_sample_matches_jax(fixture_dir, monkeypatch, seed):
    """GT-paste with the picks pinned on both sides: the 2D threshold
    draw, the collisions, the removal of points, the mixup paste and the
    labels bit for bit."""
    cfg = flagship_cfg(fixture_dir)
    sample = [t for t in cfg.data.train.dataset.pipeline
              if t["type"] == "ObjectSampleV2"][0]
    monkeypatch.setattr(jdb.BatchSampler, "sample", _pinned)
    monkeypatch.setattr(tdb.BatchSampler, "sample", _pinned)
    jres, tres = _loaded(fixture_dir, index=seed)
    j, t = jtrans.ObjectSampleV2(**_kw(sample)), \
        ttrans.ObjectSampleV2(**_kw(sample))
    n_gt = len(tres["gt_labels_3d"])
    np.random.seed(seed)
    want = j(jres)
    tres["rng"] = np.random.RandomState(seed)
    got = t(tres)
    np.testing.assert_array_equal(got["points"].tensor,
                                  want["points"].tensor)
    np.testing.assert_array_equal(got["gt_bboxes_3d"].tensor,
                                  want["gt_bboxes_3d"].tensor)
    np.testing.assert_array_equal(got["gt_labels_3d"], want["gt_labels_3d"])
    np.testing.assert_array_equal(_views(got["img"]), _views(want["img"]))
    assert len(got["gt_labels_3d"]) > n_gt          # objects were pasted
    assert not np.array_equal(_views(got["img"]),
                              _views(_loaded(fixture_dir, seed)[1]["img"]))


def test_gt_picks_come_from_the_sample_rng(fixture_dir):
    with open(os.path.join(fixture_dir, "nuscenes_dbinfos_train.pkl"),
              "rb") as f:
        cars = pickle.load(f)["car"]
    sampler = tdb.BatchSampler(cars, "car")
    a = sampler.sample(3, np.random.RandomState(7))
    b = sampler.sample(3, np.random.RandomState(7))
    assert [i["path"] for i in a] == [i["path"] for i in b]
    assert len({i["path"] for i in a}) == 3
    assert len(sampler.sample(len(cars) + 5, np.random.RandomState(1))) == \
        len(cars)
    assert sampler.sample(0, np.random.RandomState(1)) == []


def test_collect3dv2_keeps_the_camera_matrices():
    res = dict(points=np.zeros((4, 5), np.float32), img=np.zeros((6, 2, 2, 3)),
               points_mask=np.ones(4, bool), lidar2img=np.eye(4)[None],
               img_aug_matrix=np.eye(4)[None], lidar_aug_matrix=np.eye(4),
               img_view_mask=np.ones(6, bool), token="t")
    for cls in (tformat.Collect3DV2, tformat.Collect3D):
        out = cls(keys=["points", "img"])(res)
        assert set(out) == {"points", "img", "points_mask", "lidar2img",
                            "img_aug_matrix", "lidar_aug_matrix",
                            "img_view_mask", "img_metas"}


def test_tta_variants_match_jax(fixture_dir):
    """Four flip variants at two point scales, in the JAX order."""
    cfg = dict(
        transforms=[dict(type="PointsRangeFilter",
                         point_cloud_range=[-54, -54, -5, 54, 54, 3]),
                    dict(type="DefaultFormatBundle3D", max_points=8192,
                         with_label=False),
                    dict(type="Collect3DV2", keys=["points"],
                         meta_keys=["token"])],
        pts_scale_ratio=[0.95, 1.0], flip=True, pcd_horizontal_flip=True,
        pcd_vertical_flip=True)
    jres, tres = _loaded(fixture_dir, images=False)
    want = jtta.MultiScaleFlipAug3D(**cfg)(jres)
    got = ttta.MultiScaleFlipAug3D(**cfg)(tres)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g["img_metas"] == w["img_metas"]
        np.testing.assert_array_equal(g["points"], w["points"])
        np.testing.assert_array_equal(g["points_mask"], w["points_mask"])


def test_multi_variant_tta_batch_raises():
    a = dict(points=np.zeros(3))
    assert collate_batch([[a], [a]])["points"].shape == (2, 3)
    with pytest.raises(NotImplementedError, match="multi-variant"):
        collate_batch([[a, a], [a, a]])


# ------------------------------------------------ pipelines, CBGS, loader
@pytest.mark.parametrize("split,index", [("train", 0), ("train", 3),
                                         ("val", 1)])
def test_flagship_pipeline_matches_jax(fixture_dir, monkeypatch, split,
                                       index):
    """The config's pipelines as written, sample by sample through each
    package's dataset."""
    monkeypatch.setattr(random, "sample", _choice_sample)
    monkeypatch.setattr(jdb.BatchSampler, "sample", _pinned)
    monkeypatch.setattr(tdb.BatchSampler, "sample", _pinned)
    monkeypatch.setattr(jtrans.PointShuffle, "__call__", _global_shuffle)
    cfg = flagship_cfg(fixture_dir)
    d = cfg.data.train.dataset if split == "train" else cfg.data.val
    jds, tds = JaxNuScenes(**_kw(d)), NuScenesDataset(**_kw(d))
    tds.seed, tds.epoch = 3, 1
    rng = tds.sample_rng(index)
    np.random.set_state(rng.get_state())
    if split == "train":
        want = jds.prepare_train_data(index)
        got = tds.prepare_train_data(index, rng)
    else:
        (want,), (got,) = jds.prepare_test_data(index), tds[index]
    assert set(got) == set(want)
    keys = {"points", "points_mask", "img", "lidar2img", "img_aug_matrix",
            "lidar_aug_matrix"}
    keys |= {"gt_bboxes_3d", "gt_labels_3d", "gt_mask", "img_view_mask"} \
        if split == "train" else set()
    assert set(got) - {"img_metas"} == keys
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["img"].shape == (6, 384, 1056, 3)
    assert got["points_mask"].sum() > 4000


def test_cbgs_indices_match_jax_and_copies_draw_apart(fixture_dir):
    cfg = flagship_cfg(fixture_dir, final_dim=(48, 96), max_points=30000)
    inner = cfg.data.train.dataset
    jinner = JaxNuScenes(**_kw(inner))
    np.random.seed(11)
    want = JaxCBGS(jinner).sample_indices
    ds = CBGSDataset(dict(inner), seed=11)
    assert ds.sample_indices == want
    assert len(ds) > 4 * len(ds.dataset) // 2
    # two copies of one sample get different augmentations
    first = {}
    for i, j in enumerate(ds.sample_indices):
        if j in first:
            a, b = ds[first[j]], ds[i]
            assert not np.array_equal(a["lidar_aug_matrix"],
                                      b["lidar_aug_matrix"])
            break
        first[j] = i
    else:
        raise AssertionError("no duplicate in the CBGS index list")
    ds.seed = 12
    np.random.seed(12)
    assert ds.sample_indices == JaxCBGS(jinner).sample_indices


def test_test_loader_batches_match_jax(fixture_dir):
    """The val split through both loaders (batch 2, the test pipeline);
    the JAX dataset seeded per sample as the port's."""
    cfg = flagship_cfg(fixture_dir, final_dim=(48, 96), max_points=30000)
    jds, tds = JaxNuScenes(**_kw(cfg.data.val)), build_dataset(cfg.data.val)
    prepare = jds.prepare_test_data

    def seeded(index):
        np.random.set_state(tds.sample_rng(index).get_state())
        return prepare(index)

    jds.prepare_test_data = seeded
    jl = JaxLoader(jds, batch_size=2, shuffle=False, num_workers=1,
                   drop_last=False)
    tl = build_dataloader(tds, samples_per_gpu=2, workers_per_gpu=1,
                          shuffle=False)
    (got,), (want,) = list(tl), list(jl)
    assert set(got) == set(want)
    assert got["img"].shape == (2, 6, 48, 96, 3)
    for k, v in want.items():
        if k != "img_metas":
            np.testing.assert_array_equal(got[k].numpy(), v)


# ----------------------------------------------------- predict and loop
TINY_PCR = [-8, -8, -5, 8, 8, 3]


def test_predict_on_a_loader_batch_matches_jax(fixture_dir):
    """The JAX package's tiny detector (six views) on one batch of the
    port's test loader, and the port's on carried weights."""
    model_cfg = _uncapped_cfg()
    model_cfg["fusion_encoder"]["num_views"] = 6
    model_cfg["pts_voxel_layer"]["max_voxels"] = 4096
    cfg = flagship_cfg(fixture_dir, final_dim=(32, 48), pcr=TINY_PCR,
                       max_points=4096)
    ds = build_dataset(cfg.data.val)
    batch = next(iter(build_dataloader(ds, samples_per_gpu=2,
                                       shuffle=False)))
    nb = {k: v.numpy() for k, v in batch.items() if k != "img_metas"}
    assert nb["img"].shape == (2, 6, 32, 48, 3)
    assert 200 < nb["points_mask"].sum(1).min() <= \
        nb["points_mask"].sum(1).max() <= 4096
    model = jbuild_detector(model_cfg)
    variables = random_variables(model, nb, train=False, mode="feats")
    want = jax.jit(lambda v, b: model.apply(v, b, train=False,
                                            mode="predict"))(variables, nb)
    port = build_detector(copy.deepcopy(model_cfg))
    port.load_state_dict(state_dict_from_jax(variables))
    port.eval()
    got = port(nb, mode="predict", device="cpu")
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    for k in ("bboxes", "scores"):
        assert_close_to_max(got[k].numpy(), np.asarray(want[k]), 1e-3)


def tiny_flagship_cfg(root: str) -> Config:
    """The flagship config at tiny width (``flagship_model_cfg(tiny=
    True)``: +-28.8 m, Swin 24 wide, 64 proposals for 64 GT rows) on the
    fixture: views 64 x 224, 8,192 points, batch 4; 2 epochs, eval and
    checkpoint every epoch, every step logged; dropout off."""
    cfg = flagship_cfg(root, final_dim=(64, 224), pcr=[-28.8, -28.8, -5.0,
                                                      28.8, 28.8, 3.0],
                       max_points=8192)
    cfg.model = flagship_model_cfg(tiny=True, dropout=False)
    # the assignment needs a proposal per (padded) GT row
    cfg.model["pts_bbox_head"]["num_proposals"] = 64
    for t in cfg.data.train.dataset.pipeline:
        if t["type"] == "DefaultFormatBundle3D":
            t["max_gt"] = 64
    cfg.data.workers_per_gpu = 0
    cfg.total_epochs = 2
    cfg.runner.max_epochs = 2
    cfg.evaluation = dict(interval=1)
    cfg.checkpoint_config = dict(interval=1)
    cfg.log_config = dict(interval=1)
    cfg.seed = 0
    return cfg


def test_flagship_loop_trains_resumes_and_evaluates(fixture_dir,
                                                    tmp_path):
    """Two epochs, epoch 2 again from the epoch-1 checkpoint (equal logs
    and weights), then the val split's predict and metrics. PyTorch's
    deterministic kernels: with its default ones the loop does not
    repeat on several CPU threads."""
    cfg = tiny_flagship_cfg(fixture_dir)
    # the 2-sample split trains: CBGS makes about 10 of it (2 steps)
    cfg.data.train.dataset.ann_file = cfg.data.val.ann_file
    work = str(tmp_path / "work")
    torch.use_deterministic_algorithms(True)
    try:
        model = init_model(cfg, device="cpu")
        records = train_model(model, build_dataset(cfg.data.train), cfg,
                              work_dir=work, device="cpu")
        model2 = init_model(cfg, device="cpu", seed=5)
        resumed = train_model(model2, build_dataset(cfg.data.train), cfg,
                              work_dir=str(tmp_path / "resumed"),
                              device="cpu", resume_from=os.path.join(
                                  work, "epoch_1.pth"))
    finally:
        torch.use_deterministic_algorithms(False)
    steps = [r for r in records if "mode" not in r]
    n = len(steps) // 2
    assert n >= 2 and [r["epoch"] for r in steps] == [0] * n + [1] * n
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps)

    def untimed(recs):
        return [{k: v for k, v in r.items() if k not in ("data_time", "time")}
                for r in recs]

    assert untimed(resumed) == untimed(records[-len(resumed):])
    assert len(resumed) == n + 1
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k
    ds = build_dataset(cfg.data.val)
    results = single_device_test(model, build_dataloader(
        ds, samples_per_gpu=2, shuffle=False), device="cpu")
    metrics = ds.evaluate(results)
    assert len(results) == 2 and results[0]["bboxes"].shape == (64, 9)
    assert {"mAP", "NDS", "car_AP"} <= set(metrics)
    last_val = [r for r in records if "mode" in r][-1]
    assert last_val["epoch"] == 2
    assert last_val["NDS"] == round(metrics["NDS"], 5)


def test_cli_trains_and_tests_the_flagship_config(fixture_dir, tmp_path,
                                                  capsys):
    """The CLIs on the tiny flagship config, its data paths given by
    ``--cfg-options`` (list items by index, as the GT sampler's are)."""
    cfg = tiny_flagship_cfg("unset")
    cfg_path = str(tmp_path / "tiny_flagship.py")
    with open(cfg_path, "w") as f:
        f.write("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    sample = [i for i, t in enumerate(cfg.data.train.dataset.pipeline)
              if t["type"] == "ObjectSampleV2"][0]
    ann = os.path.join(fixture_dir, "nuscenes_infos_val.pkl")
    paths = [f"data.{split}.{k}={v}" for split in (
        "train.dataset", "val", "test") for k, v in (
        ("data_root", fixture_dir), ("ann_file", ann))]
    db = f"data.train.dataset.pipeline.{sample}.db_sampler"
    paths += [f"{db}.data_root={fixture_dir}", f"{db}.info_path=" +
              os.path.join(fixture_dir, "nuscenes_dbinfos_train.pkl")]
    work = str(tmp_path / "work")
    ttrain_cli.main([cfg_path, "--work-dir", work, "--device", "cpu",
                     "--cfg-options", "total_epochs=1",
                     "evaluation.interval=0", *paths])
    assert os.path.isfile(os.path.join(work, "epoch_1.pth"))
    capsys.readouterr()
    metrics = ttest_cli.main([cfg_path, work, "--eval", "bbox", "--device",
                              "cpu", "--cfg-options", *paths])
    assert json.loads(capsys.readouterr().out) == metrics
    assert {"mAP", "NDS", "car_AP"} <= set(metrics)


# ----------------------------------------------------------------- imports
NEW_MODULES = [
    "core/bbox/box_np_ops.py", "datasets/dataset_wrappers.py",
    "datasets/pipelines/image_io.py", "datasets/pipelines/dbsampler.py",
    "datasets/pipelines/test_time_aug.py", "tools/create_gt_database.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_new_module_imports_no_jax(rel):
    path = os.path.join(REPO, "isfusion_tpu_torch", rel)
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "isfusion_tpu",
              "tools")
    for node in ast.walk(ast.parse(open(path).read(), path)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        assert not [n for n in names if n.split(".")[0] in banned], rel


def test_port_imports_no_imaging_library():
    """The card's machine has no PIL; OpenCV and torchvision are not
    relied on either."""
    paths = [os.path.join(r, f) for r, _, fs in os.walk(
        os.path.join(REPO, "isfusion_tpu_torch")) for f in fs
        if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    for path in paths:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad = [n for n in names
                   if n.split(".")[0] in ("PIL", "cv2", "torchvision")]
            assert not bad, (path, bad)
