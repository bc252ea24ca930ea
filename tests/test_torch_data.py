"""The port's data side against the JAX package: the synthetic fixture
generator, the LiDAR nuScenes pipeline transforms, ``pad_to``, the
loader's per-epoch order and collate, and the nuScenes evaluator.

Inputs are made from a seed and handed to both packages. Random
transforms: the JAX one draws from the global ``np.random`` after
``np.random.seed(s)``, the port's from ``results['rng'] =
np.random.RandomState(s)``; the outputs must be equal bit for bit
(``np.array_equal``), as must the generator's ``.bin`` bytes and infos,
the loader's batches and the metrics (within 1e-12).
"""
import copy
import os
import pickle

import numpy as np
import pytest
import torch

from isfusion_tpu.core.evaluation import nuscenes_eval as jeval
from isfusion_tpu.datasets import DataLoader as JaxLoader
from isfusion_tpu.datasets import NuScenesDataset as JaxNuScenes
from isfusion_tpu.datasets.pipelines import formating as jformat
from isfusion_tpu.datasets.pipelines import transforms_3d as jtrans
from isfusion_tpu_torch.core.evaluation import nuscenes_eval as teval
from isfusion_tpu_torch.datasets import NuScenesDataset, build_dataloader
from isfusion_tpu_torch.datasets.builder import EpochBatchSampler
from isfusion_tpu_torch.datasets.pipelines import formating
from isfusion_tpu_torch.datasets.pipelines import transforms_3d as ttrans
from isfusion_tpu_torch.tools import make_synthetic_nuscenes as tgen
from tools.misc import make_synthetic_nuscenes as jgen

CLASSES = ("car", "pedestrian")
PCR = [-51.2, -51.2, -5, 51.2, 51.2, 3]
FIXTURE = dict(train=4, val=2, points=2048, img_hw=(16, 32), seed=0,
               classes=["car", "pedestrian"])


def _same(a, b, path="") -> None:
    """Recursive equality of info trees (arrays: values and dtype)."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """The port's fixture (4 train / 2 val, 2,048 points, 16 x 32 images),
    and the JAX tool's samples drawn from the same seed into the same
    directory just before: (dir, JAX infos, JAX .bin bytes)."""
    out = str(tmp_path_factory.mktemp("syn"))
    rng = np.random.default_rng(FIXTURE["seed"])
    want_infos, want_bins = {}, {}
    for split in ("train", "val"):
        want_infos[split] = [jgen.make_sample(
            rng, out, split, i, FIXTURE["points"], FIXTURE["img_hw"],
            classes=FIXTURE["classes"]) for i in range(FIXTURE[split])]
    for infos in want_infos.values():
        for info in infos:
            for path in [info["lidar_path"]] + [s["data_path"]
                                                for s in info["sweeps"]]:
                with open(path, "rb") as f:
                    want_bins[path] = f.read()
    tgen.make_dataset(out, FIXTURE["train"], FIXTURE["val"],
                      FIXTURE["points"], FIXTURE["img_hw"], FIXTURE["seed"],
                      FIXTURE["classes"])
    return out, want_infos, want_bins


def _ann(out, split):
    return os.path.join(out, f"nuscenes_infos_{split}.pkl")


def test_generator_matches_jax(fixture_dir):
    """The same infos as the JAX tool's, but for the views' files: PNG
    where the JAX tool writes JPEG."""
    out, want_infos, want_bins = fixture_dir
    want_infos = copy.deepcopy(want_infos)
    for infos in want_infos.values():
        for info in infos:
            for cam in info["cams"].values():
                assert cam["data_path"].endswith(".jpg")
                cam["data_path"] = cam["data_path"][:-4] + ".png"
    for split, want in want_infos.items():
        with open(_ann(out, split), "rb") as f:
            got = pickle.load(f)
        assert got["metadata"] == dict(version="v1.0-synthetic")
        _same(got["infos"], want)
    for path, data in want_bins.items():
        with open(path, "rb") as f:
            assert f.read() == data, path


def test_generator_cli_writes_images_only_when_asked(tmp_path):
    """``--images`` writes each sample's six views as PNG: the picture
    the JAX tool draws (and writes as JPEG), pixel for pixel."""
    from PIL import Image
    tgen.main(["--out", str(tmp_path / "a"), "--train", "1", "--val", "0",
               "--points", "512", "--img-hw", "8", "16"])
    assert not os.path.isdir(tmp_path / "a" / "samples" / "CAM_FRONT")
    tgen.main(["--out", str(tmp_path / "b"), "--train", "1", "--val", "0",
               "--points", "512", "--img-hw", "8", "16", "--images"])
    assert os.listdir(tmp_path / "b" / "samples" / "CAM_FRONT") == \
        ["syntrain0000.png"]
    name = "samples/LIDAR_TOP/syntrain0000.bin"
    with open(tmp_path / "a" / name, "rb") as fa, \
            open(tmp_path / "b" / name, "rb") as fb:
        assert fa.read() == fb.read()
    # the JAX tool's draws up to the picture, then the picture itself
    rng = np.random.default_rng(0)
    jgen._lidar_cloud(rng, 512, (-54, -54, -5, 54, 54, 3), sweeps=1)
    rng.uniform(0, 255, (512, 1))
    for _ in range(3):
        jgen._lidar_cloud(rng, 128, (-54, -54, -5, 54, 54, 3), sweeps=1)
        rng.uniform(0, 255, (128, 1))
    want = (rng.uniform(0, 60, (8, 16, 3)) +
            np.linspace(0, 195, 8)[:, None, None]).astype(np.uint8)
    for cam in tgen.CAM_NAMES:
        path = tmp_path / "b" / "samples" / cam / "syntrain0000.png"
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)


# ---------------------------------------------------------- transforms
def _loaded(out, index=0, split="train"):
    """The same sample loaded by both packages: (JAX results, port
    results) after LoadPointsFromFile + LoadAnnotations3D."""
    load = [dict(type="LoadPointsFromFile", coord_type="LIDAR", load_dim=5,
                 use_dim=5),
            dict(type="LoadAnnotations3D", with_bbox_3d=True,
                 with_label_3d=True)]
    kw = dict(ann_file=_ann(out, split), data_root=out, classes=CLASSES,
              pipeline=load)
    jds, tds = JaxNuScenes(**kw), NuScenesDataset(**kw)
    res = []
    for ds in (jds, tds):
        r = ds.get_data_info(index)
        ds.pre_pipeline(r)
        res.append(ds.pipeline(r))
    return res


def _assert_results_equal(want, got):
    np.testing.assert_array_equal(got["points"].tensor, want["points"].tensor)
    if "gt_bboxes_3d" in want:
        np.testing.assert_array_equal(got["gt_bboxes_3d"].tensor,
                                      want["gt_bboxes_3d"].tensor)
        np.testing.assert_array_equal(got["gt_labels_3d"],
                                      want["gt_labels_3d"])
    for k in ("pcd_scale_factor", "pcd_rotation", "pcd_horizontal_flip",
              "pcd_vertical_flip"):
        assert got.get(k) == want.get(k), k


TRANSFORMS = {
    "rot_scale_trans": lambda m: m.GlobalRotScaleTrans(
        rot_range=[-0.3925, 0.3925], scale_ratio_range=[0.95, 1.05],
        translation_std=[0.2, 0.2, 0.1]),
    "rot_scale_learn": lambda m: m.GlobalRotScaleTrans(
        rot_range=[-0.3925, 0.3925], scale_ratio_range=[0.95, 1.05],
        translation_std=[0, 0, 0]),
    "flip": lambda m: m.RandomFlip3D(flip_ratio_bev_horizontal=0.5,
                                     flip_ratio_bev_vertical=0.5),
    "points_range": lambda m: m.PointsRangeFilter(
        point_cloud_range=[-20, -30, -2, 30, 20, 1]),
    "object_range": lambda m: m.ObjectRangeFilter(
        point_cloud_range=[-20, -30, -2, 30, 20, 1]),
    "object_name": lambda m: m.ObjectNameFilter(classes=["car"]),
    "point_sample_down": lambda m: m.PointSample(num_points=1000),
    "point_sample_up": lambda m: m.PointSample(num_points=9000),
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(fixture_dir, name, seed):
    jres, tres = _loaded(fixture_dir[0], index=seed % 4)
    np.random.seed(seed)
    want = TRANSFORMS[name](jtrans)(jres)
    tres["rng"] = np.random.RandomState(seed)
    got = TRANSFORMS[name](ttrans)(tres)
    _assert_results_equal(want, got)
    if name == "object_name":
        assert (got["gt_labels_3d"] == 0).all()
    if name == "points_range":
        assert 0 < len(got["points"]) < len(jres["points"].tensor) + 1


def test_flips_cover_both_directions(fixture_dir):
    """Over seeds 0-7 the horizontal and the vertical flip each happen
    and each is skipped (so the flip test above sees both branches)."""
    seen = set()
    for s in range(8):
        _, tres = _loaded(fixture_dir[0])
        tres["rng"] = np.random.RandomState(s)
        out = ttrans.RandomFlip3D(0.5, 0.5)(tres)
        seen.add((bool(out.get("pcd_horizontal_flip")),
                  bool(out.get("pcd_vertical_flip"))))
    assert len(seen) == 4


def test_point_shuffle_matches_jax_points_shuffle(fixture_dir):
    """The JAX transform draws from an unseeded generator; its points'
    ``shuffle(rng)`` with the same RandomState is the reference."""
    jres, tres = _loaded(fixture_dir[0])
    jres["points"].shuffle(np.random.RandomState(5))
    tres["rng"] = np.random.RandomState(5)
    got = ttrans.PointShuffle()(tres)
    np.testing.assert_array_equal(got["points"].tensor,
                                  jres["points"].tensor)


def test_random_transform_needs_a_generator(fixture_dir):
    _, tres = _loaded(fixture_dir[0])
    with pytest.raises(RuntimeError, match="rng"):
        ttrans.RandomFlip3D()(tres)


def _learn_pipeline(test_mode, shuffle=False):
    pipe = [dict(type="LoadPointsFromFile", coord_type="LIDAR", load_dim=5,
                 use_dim=5)]
    if not test_mode:
        pipe += [dict(type="LoadAnnotations3D", with_bbox_3d=True,
                      with_label_3d=True),
                 dict(type="GlobalRotScaleTrans",
                      rot_range=[-0.3925, 0.3925],
                      scale_ratio_range=[0.95, 1.05],
                      translation_std=[0, 0, 0]),
                 dict(type="RandomFlip3D", flip_ratio_bev_horizontal=0.5),
                 dict(type="PointsRangeFilter", point_cloud_range=PCR),
                 dict(type="ObjectRangeFilter", point_cloud_range=PCR),
                 dict(type="ObjectNameFilter", classes=list(CLASSES))]
        pipe += [dict(type="PointShuffle")] if shuffle else []
        pipe += [dict(type="DefaultFormatBundle3D", class_names=CLASSES,
                      max_points=4096, max_gt=32),
                 dict(type="Collect3D",
                      keys=["points", "gt_bboxes_3d", "gt_labels_3d"])]
    else:
        pipe += [dict(type="PointsRangeFilter", point_cloud_range=PCR),
                 dict(type="DefaultFormatBundle3D", class_names=CLASSES,
                      max_points=4096, max_gt=32, with_label=False),
                 dict(type="Collect3D", keys=["points"])]
    return pipe


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "img_metas":
            assert got[k]["token"] == want[k]["token"]
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("index", [0, 2])
def test_learn_pipeline_matches_jax(fixture_dir, test_mode, index):
    """The learnability config's pipelines (PointShuffle aside) through
    each package's dataset, the JAX one seeded globally."""
    out = fixture_dir[0]
    kw = dict(ann_file=_ann(out, "train"), data_root=out, classes=CLASSES,
              pipeline=_learn_pipeline(test_mode), test_mode=test_mode)
    jds, tds = JaxNuScenes(**kw), NuScenesDataset(**kw)
    tds.seed, tds.epoch = 7, 2
    rng = tds.sample_rng(index)
    np.random.set_state(rng.get_state())
    want = jds.prepare_test_data(index) if test_mode else \
        jds.prepare_train_data(index)
    got = tds[index]
    _assert_samples_equal(got, want)
    assert got["points_mask"].sum() > 1000


def test_sample_draws_depend_on_seed_epoch_and_index(fixture_dir):
    out = fixture_dir[0]
    ds = NuScenesDataset(ann_file=_ann(out, "train"), data_root=out,
                         classes=CLASSES,
                         pipeline=_learn_pipeline(False, shuffle=True))
    ds.seed = 1
    a, b = ds[1], ds[1]
    np.testing.assert_array_equal(a["points"], b["points"])
    ds.set_epoch(1)
    c = ds[1]
    assert not np.array_equal(a["points"], c["points"])


# --------------------------------------------------------------- pad_to
@pytest.mark.parametrize("m", [0, 10, 64, 65, 1000])
def test_pad_to_matches_jax(m):
    rng = np.random.default_rng(m)
    arr = rng.normal(size=(m, 5)).astype(np.float32)
    got, gmask = formating.pad_to(arr, 64)
    want, wmask = jformat.pad_to(arr, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gmask, wmask)
    if m > 64:
        # a uniform stride subsample: first and near-last rows, no prefix
        assert np.array_equal(got[0], arr[0]) and gmask.all()
        assert np.array_equal(got[-1], arr[(63 * m) // 64])


# --------------------------------------------------------------- loader
@pytest.mark.parametrize("n,batch,drop_last", [(10, 3, True), (10, 3, False),
                                               (48, 4, True)])
def test_loader_order_matches_jax(n, batch, drop_last):
    jl = JaxLoader(list(range(n)), batch_size=batch, shuffle=True, seed=5,
                   drop_last=drop_last, num_workers=1)
    sampler = EpochBatchSampler(n, batch, True, 5, drop_last)
    for epoch in range(3):
        jl.epoch = sampler.epoch = epoch
        want = jl._indices()
        np.testing.assert_array_equal(sampler.indices(), want)
        got = list(sampler)
        assert len(got) == len(sampler) == len(jl)
        assert [i for b in got for i in b] == want.tolist()


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_jax(fixture_dir, workers):
    """Two epochs of shuffled batches (augmentation off) through both
    loaders: the same samples in the same order, collated alike; the
    port's in ``workers`` worker processes."""
    out = fixture_dir[0]
    pipe = [t for t in _learn_pipeline(False)
            if t["type"] not in ("GlobalRotScaleTrans", "RandomFlip3D")]
    kw = dict(ann_file=_ann(out, "train"), data_root=out, classes=CLASSES,
              pipeline=pipe)
    jl = JaxLoader(JaxNuScenes(**kw), batch_size=2, shuffle=True, seed=3,
                   num_workers=1)
    tl = build_dataloader(NuScenesDataset(**kw), samples_per_gpu=2,
                          workers_per_gpu=workers, shuffle=True, seed=3)
    assert len(tl) == len(jl) == 2
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        for got, want in zip(tl, jl):
            assert all(torch.is_tensor(v) for k, v in got.items()
                       if k != "img_metas")
            assert [m["token"] for m in got["img_metas"]] == \
                [m["token"] for m in want["img_metas"]]
            _assert_samples_equal(
                {k: v.numpy() for k, v in got.items() if k != "img_metas"},
                {k: v for k, v in want.items() if k != "img_metas"})


# ----------------------------------------------------------- evaluation
def _random_case(seed, n_samples=5):
    rng = np.random.default_rng(seed)
    names = ["car", "pedestrian", "barrier", "traffic_cone"]
    dets, gts, egos = [], [], []
    for _ in range(n_samples):
        ng = int(rng.integers(3, 12))
        g = np.zeros((ng, 9), np.float32)
        g[:, :2] = rng.uniform(-55, 55, (ng, 2))
        g[:, 3:6] = rng.uniform(0.4, 5, (ng, 3))
        g[:, 6] = rng.uniform(-np.pi, np.pi, ng)
        g[:, 7:9] = rng.normal(0, 1, (ng, 2))
        glab = rng.integers(0, 4, ng)
        nd = int(rng.integers(0, 20))
        src = rng.integers(0, ng, nd)
        d = g[src] + rng.normal(0, 0.8, (nd, 9)).astype(np.float32)
        d[:, 3:6] = np.abs(d[:, 3:6]) + 0.1
        dlab = np.where(rng.uniform(size=nd) < 0.8, glab[src],
                        rng.integers(0, 4, nd))
        attrs = ["vehicle.moving", "vehicle.parked", "pedestrian.standing",
                 ""]
        dets.append(dict(boxes=d, labels=dlab,
                         scores=rng.uniform(size=nd).astype(np.float32),
                         mask=rng.uniform(size=nd) < 0.9,
                         attrs=np.asarray([attrs[int(i)] for i in dlab])))
        gts.append(dict(boxes=g, labels=glab,
                        num_pts=rng.integers(0, 4, ng),
                        attrs=np.asarray([attrs[int(i)] for i in glab])))
        egos.append(rng.normal(0, 2, 2))
    return dets, gts, names, egos


def _assert_metrics_equal(got, want, tol=1e-12):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= tol, k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nuscenes_eval_matches_jax(seed):
    dets, gts, names, egos = _random_case(seed)
    want = jeval.nuscenes_style_eval(copy.deepcopy(dets), copy.deepcopy(gts),
                                     names, ego_translations=egos)
    got = teval.nuscenes_style_eval(dets, gts, names, ego_translations=egos)
    assert 0 < want["mAP"] < 1
    _assert_metrics_equal(got, want)


def _fake_results(infos, seed):
    rng = np.random.default_rng(seed)
    out = []
    for info in infos:
        g = np.concatenate([info["gt_boxes"], info["gt_velocity"]], -1)
        b = np.zeros((100, 9), np.float32)
        n = min(len(g), 100)
        b[:n] = g[:n] + rng.normal(0, 0.3, (n, 9)).astype(np.float32)
        b[n:] = rng.normal(0, 20, (100 - n, 9))
        b[:, 3:6] = np.abs(b[:, 3:6]) + 0.1
        b[:, 2] -= b[:, 5] / 2        # bottom-centre rows, as predicted
        labels = rng.integers(0, 2, 100)
        labels[:n] = [CLASSES.index(c) for c in info["gt_names"][:n]]
        scores = rng.uniform(size=100).astype(np.float32) * 0.5
        scores[:n] += 0.5             # the near-GT boxes score higher
        out.append(dict(bboxes=b, scores=scores, labels=labels,
                        mask=rng.uniform(size=100) < 0.7))
    return out


def test_dataset_evaluate_and_format_match_jax(fixture_dir, tmp_path):
    out = fixture_dir[0]
    kw = dict(ann_file=_ann(out, "train"), data_root=out, classes=CLASSES,
              test_mode=True, pipeline=_learn_pipeline(True))
    jds, tds = JaxNuScenes(**kw), NuScenesDataset(**kw)
    results = _fake_results(tds.data_infos, 0)
    want = jds.evaluate(copy.deepcopy(results))
    got = tds.evaluate(results)
    assert want["mAP"] > 0.1
    _assert_metrics_equal(got, want)
    jpath = jds._format_bbox(results, str(tmp_path / "jax"))
    tpath = tds._format_bbox(results, str(tmp_path / "port"))
    with open(jpath) as fj, open(tpath) as ft:
        assert fj.read() == ft.read()


# The cases of tests/test_metrics/test_nuscenes_eval.py, against both
# evaluators
EVAL_CLASSES = ["car", "pedestrian", "barrier", "traffic_cone"]


def _box(x, y, yaw=0.0, dims=(4.0, 2.0, 1.5), vel=(0.0, 0.0)):
    return np.array([x, y, 0.0, *dims, yaw, *vel], np.float32)


def _det(boxes, labels, scores, attrs=None):
    d = dict(boxes=np.stack(boxes) if boxes else np.zeros((0, 9)),
             labels=np.asarray(labels), scores=np.asarray(scores))
    if attrs is not None:
        d["attrs"] = np.asarray(attrs)
    return d


def _gt(boxes, labels, attrs=None, num_pts=None):
    g = dict(boxes=np.stack(boxes) if boxes else np.zeros((0, 9)),
             labels=np.asarray(labels))
    if attrs is not None:
        g["attrs"] = np.asarray(attrs)
    if num_pts is not None:
        g["num_pts"] = np.asarray(num_pts)
    return g


def _perfect(ne):
    boxes = [_box(0, 0, 0.3, vel=(1.0, 0.0)), _box(5, 5, -1.0)]
    attrs = ["vehicle.moving", "pedestrian.standing"]
    m = ne.nuscenes_style_eval([_det(boxes, [0, 1], [0.9, 0.8], attrs)],
                               [_gt(boxes, [0, 1], attrs, [10, 10])],
                               EVAL_CLASSES)
    assert m["mAP"] == pytest.approx(1.0)
    assert m["NDS"] == pytest.approx(1.0)
    assert m["mATE"] == pytest.approx(0.0)
    assert m["mAAE"] == pytest.approx(0.0)
    assert m["attr_err_available"] is True


def _class_range(ne):
    m = ne.nuscenes_style_eval(
        [_det([_box(45, 0), _box(45.0, 0.1)], [0, 1], [0.9, 0.9])],
        [_gt([_box(45, 0), _box(45, 0)], [0, 1], num_pts=[5, 5])],
        EVAL_CLASSES)
    assert m["car_AP"] == pytest.approx(1.0)
    assert "pedestrian_AP" not in m


def _zero_point(ne):
    m = ne.nuscenes_style_eval(
        [_det([_box(0, 0)], [0], [0.9])],
        [_gt([_box(0, 0), _box(10, 0)], [0, 0], num_pts=[5, 0])],
        EVAL_CLASSES)
    assert m["car_AP"] == pytest.approx(1.0)


def _barrier_period(ne):
    m = ne.nuscenes_style_eval(
        [_det([_box(0, 0, 0.4 + np.pi)], [2], [0.9])],
        [_gt([_box(0, 0, 0.4)], [2], num_pts=[5])], EVAL_CLASSES)
    assert m["barrier_orient_err"] == pytest.approx(0.0, abs=1e-6)
    assert "barrier_vel_err" not in m and "barrier_attr_err" not in m


def _cone_orientation(ne):
    m = ne.nuscenes_style_eval(
        [_det([_box(0, 0, 1.0)], [3], [0.9])],
        [_gt([_box(0, 0, 2.2)], [3], num_pts=[5])], EVAL_CLASSES)
    assert "traffic_cone_orient_err" not in m and "traffic_cone_AP" in m


def _wrong_attribute(ne):
    b = _box(0, 0, vel=(1.0, 0.0))
    m = ne.nuscenes_style_eval(
        [_det([b], [0], [0.9], attrs=["vehicle.parked"])],
        [_gt([b], [0], attrs=["vehicle.moving"], num_pts=[5])],
        EVAL_CLASSES)
    assert m["car_attr_err"] == pytest.approx(1.0)
    assert m["mAAE"] == pytest.approx(1.0)


def _hand_ap(ne):
    md = ne._accumulate(
        [dict(boxes=np.stack([_box(0.5, 0), _box(20, 0)]),
              labels=np.asarray([0, 0]), scores=np.asarray([0.9, 0.8]))],
        [dict(boxes=np.stack([_box(0, 0), _box(10, 0)]),
              labels=np.asarray([0, 0]))], "car", 0, 1.0)
    assert ne._calc_ap(md) == pytest.approx((39 * 0.9 + 0.4) / (90 * 0.9),
                                            abs=1e-9)


def _nds_formula(ne):
    m = ne.nuscenes_style_eval([_det([_box(0.5, 0)], [0], [0.9])],
                               [_gt([_box(0, 0)], [0], num_pts=[5])],
                               EVAL_CLASSES)
    assert m["attr_err_available"] is False
    tp_sum = sum(1.0 - min(1.0, m[k])
                 for k in ("mATE", "mASE", "mAOE", "mAVE", "mAAE"))
    assert m["NDS"] == pytest.approx((5 * m["mAP"] + tp_sum) / 10.0)


def _range_table(ne):
    assert ne.CLASS_RANGE["car"] == 50 and ne.CLASS_RANGE["barrier"] == 30
    assert ne.CLASS_RANGE["pedestrian"] == 40


@pytest.mark.parametrize("impl", ["jax", "port"])
@pytest.mark.parametrize("case", [_perfect, _class_range, _zero_point,
                                  _barrier_period, _cone_orientation,
                                  _wrong_attribute, _hand_ap, _nds_formula,
                                  _range_table], ids=lambda f: f.__name__)
def test_nuscenes_eval_golden_cases(impl, case):
    case(jeval if impl == "jax" else teval)
