"""The port's indoor data path against the JAX package: depth boxes and
points (``core/bbox/structures.py``, ``core/points.py``),
``LoadPointsFromFile`` with ``shift_height``, the indoor transforms
(``GlobalAlignment``, ``RandomDropPointsColor``,
``IndoorPatchPointSample``), ``ScanNetDataset`` / ``SUNRGBDDataset`` /
``S3DISDataset`` on a layout written by
``tools/make_synthetic_scannet.py``, the ScanNet train pipeline sample by
sample, ``indoor_eval`` and the datasets' ``evaluate``; then VoteNet's
ScanNet loop at tiny size (3 + 2 scenes, one epoch).

Every comparison is exact (bit for bit), except the indoor AP, equal to
1e-12: on the CPU its IoU is K10's plain version (``ops/box_ops.py``),
the JAX package's its XLA geometry, both float32. The transforms draw
from ``results['rng']`` (a ``RandomState`` seeded as JAX's global
``np.random``), in JAX's order. The port joins a relative ``pts_path`` to
``data_root``, as the reference does; the JAX package reads it as given
(its side runs from inside the layout).
"""
import os

import numpy as np
import pytest

from isfusion_tpu.core import points as jpoints
from isfusion_tpu.core.bbox import structures as jstructures
from isfusion_tpu.core.evaluation.indoor_eval import indoor_eval as jeval
from isfusion_tpu.datasets import indoor_datasets as jdatasets
from isfusion_tpu.datasets.pipelines import loading as jloading
from isfusion_tpu.datasets.pipelines import transforms_3d as jtransforms
from isfusion_tpu_torch import flagship
from isfusion_tpu_torch.core import points as tpoints
from isfusion_tpu_torch.core.bbox import structures as tstructures
from isfusion_tpu_torch.core.evaluation.indoor_eval import indoor_eval
from isfusion_tpu_torch.datasets import build_dataset
from isfusion_tpu_torch.datasets import indoor_datasets as tdatasets
from isfusion_tpu_torch.datasets.pipelines import loading as tloading
from isfusion_tpu_torch.datasets.pipelines import transforms_3d as ttransforms
from isfusion_tpu_torch.tools.make_synthetic_scannet import make_dataset


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scannet"))
    make_dataset(d, train=3, val=2, points=3000, seed=0)
    return d


def _boxes(seed=0, n=6):
    rng = np.random.default_rng(seed)
    t = np.concatenate([rng.uniform(-3, 3, (n, 3)), rng.uniform(0.2, 2, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    return t.astype(np.float32)


def _equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif hasattr(want, "tensor"):
        assert type(got).__name__ == type(want).__name__, path
        _equal(got.tensor, want.tensor, path)
    else:
        w, g = np.asarray(want), np.asarray(got)
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("op", ["flip_h", "flip_v", "rotate", "rotate_mat",
                                "views"])
def test_depth_boxes_and_points_match_jax(op):
    """DepthInstance3DBoxes (from gravity-centre rows) and DepthPoints:
    flips both ways with points, rotation by an angle and by a matrix
    with points, and the views (bev, nearest_bev, corners)."""
    t = _boxes()
    pts = np.random.default_rng(1).normal(size=(50, 4)).astype(np.float32)
    jb = jstructures.DepthInstance3DBoxes(t.copy(), origin=(0.5, 0.5, 0.5))
    tb = tstructures.DepthInstance3DBoxes(t.copy(), origin=(0.5, 0.5, 0.5))
    jp = jpoints.DepthPoints(pts.copy(), points_dim=4)
    tp = tpoints.DepthPoints(pts.copy(), points_dim=4)
    if op.startswith("flip"):
        d = "horizontal" if op == "flip_h" else "vertical"
        jb.flip(d, jp)
        tb.flip(d, tp)
    elif op == "rotate":
        _, jm = jb.rotate(0.37, jp)
        _, tm = tb.rotate(0.37, tp)
        _equal(tm, jm)
    elif op == "rotate_mat":
        c, s = np.cos(0.7), np.sin(0.7)
        mat = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        _equal(tb.rotate(mat), jb.rotate(mat))
        _equal(tp.rotate(mat), jp.rotate(mat))
    else:
        for view in ("bev", "nearest_bev", "corners"):
            _equal(getattr(tb, view), getattr(jb, view), view)
        assert tstructures.get_box_type("Depth")[0] is \
            tstructures.DepthInstance3DBoxes
        assert tpoints.get_points_type("DEPTH") is tpoints.DepthPoints
    _equal(tb.tensor, jb.tensor)
    _equal(tp.tensor, jp.tensor)


def test_load_points_with_shift_height_matches_jax(layout):
    """DEPTH points of xyz and the height above the 0.99th percentile of
    z, the ``height`` attribute."""
    path = os.path.join(layout, "points", "scene0000_00.bin")
    kw = dict(coord_type="DEPTH", shift_height=True, load_dim=6,
              use_dim=[0, 1, 2])
    want = jloading.LoadPointsFromFile(**kw)(dict(pts_filename=path))
    got = tloading.LoadPointsFromFile(**kw)(dict(pts_filename=path))
    assert type(got["points"]).__name__ == "DepthPoints"
    _equal(got["points"].tensor, want["points"].tensor)
    assert got["points"].attribute_dims == want["points"].attribute_dims \
        == dict(height=3)


def _points_with_color(seed=0, n=4000):
    """(results for JAX, for the port): DEPTH points of xyz, rgb in
    [0, 1], labels over 5 classes and 6 (ignored)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(0, 4, (n, 3)), rng.uniform(0, 1, (n, 3))],
                         1).astype(np.float32)
    sem = rng.integers(0, 7, n)
    out = []
    for mod in (jpoints, tpoints):
        r = dict(points=mod.DepthPoints(pts.copy(), points_dim=6,
                                        attribute_dims=dict(color=[3, 4, 5])),
                 pts_semantic_mask=sem.copy(),
                 ann_info=dict(axis_align_matrix=_align()))
        out.append(r)
    return out


def _align():
    c, s = np.cos(1.1), np.sin(1.1)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    m[:3, 3] = [1.5, -0.5, 0.2]
    return m


TRANSFORMS = dict(
    align=(jtransforms.GlobalAlignment, ttransforms.GlobalAlignment,
           dict(rotation_axis=2)),
    drop_color=(jtransforms.RandomDropPointsColor,
                ttransforms.RandomDropPointsColor, dict(drop_ratio=0.5)),
    patch=(jtransforms.IndoorPatchPointSample,
           ttransforms.IndoorPatchPointSample,
           dict(num_points=2048, block_size=1.5, ignore_index=6,
                use_normalized_coord=True)),
    patch_short=(jtransforms.IndoorPatchPointSample,
                 ttransforms.IndoorPatchPointSample,
                 dict(num_points=6000, block_size=1.0, enlarge_size=0.1,
                      use_normalized_coord=False)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_indoor_transforms_match_jax(name, seed):
    """Each transform on the same points and seed (JAX: np.random.seed;
    the port: results['rng']): points, attributes and labels bit for
    bit. ``patch_short`` draws duplicates (a patch of fewer points than
    asked)."""
    jcls, tcls, kw = TRANSFORMS[name]
    jr, tr = _points_with_color(seed)
    np.random.seed(seed)
    want = jcls(**kw)(jr)
    tr["rng"] = np.random.RandomState(seed)
    got = tcls(**kw)(tr)
    _equal(got["points"].tensor, want["points"].tensor)
    assert got["points"].attribute_dims == want["points"].attribute_dims
    _equal(got["pts_semantic_mask"], want["pts_semantic_mask"])


DATASETS = ("ScanNetDataset", "SUNRGBDDataset", "S3DISDataset")


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("name", DATASETS)
def test_dataset_infos_match_jax(layout, name, test_mode):
    """``get_data_info`` (the port's path joined to data_root) and
    ``get_ann_info`` on every scene; S3DIS also with ``load_interval`` 2
    (every other scene of JAX's)."""
    ann = os.path.join(layout, "scannet_infos_train.pkl")
    kw = dict(ann_file=ann, data_root=layout, pipeline=None,
              test_mode=test_mode)
    jds = getattr(jdatasets, name)(**kw)
    tds = getattr(tdatasets, name)(**kw)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        want = jds.get_data_info(i)
        want["pts_filename"] = os.path.join(layout, want["pts_filename"])
        _equal(tds.get_data_info(i), want)
        _equal(tds.get_ann_info(i), jds.get_ann_info(i))
    if name == "S3DISDataset":
        thin = tdatasets.S3DISDataset(load_interval=2, **kw)
        assert len(thin) == 2
        _equal(thin.get_ann_info(1), jds.get_ann_info(2))
    if name == "ScanNetDataset":
        m = tds.get_ann_info(0)["axis_align_matrix"]
        assert not np.allclose(m, np.eye(4))


@pytest.mark.parametrize("index,seed", [(0, 0), (2, 7)])
def test_scannet_pipeline_sample_matches_jax(layout, index, seed,
                                             monkeypatch):
    """``votenet_scannet_cfg``'s train pipeline (load with
    ``shift_height``, annotations, alignment, 40,000 -> 2,000 points,
    flips, rotation, the format bundle) through both datasets: the
    formatted arrays bit for bit."""
    cfg = flagship.votenet_scannet_cfg(layout, num_points=2000)
    split = dict(cfg.data.train)
    split.pop("type")
    pipeline = split.pop("pipeline")
    monkeypatch.chdir(layout)
    jds = jdatasets.ScanNetDataset(pipeline=pipeline, **split)
    tds = tdatasets.ScanNetDataset(pipeline=pipeline, **split)
    np.random.seed(seed)
    want = jds.prepare_train_data(index)
    got = tds.prepare_train_data(index, np.random.RandomState(seed))
    keys = ("points", "points_mask", "gt_bboxes_3d", "gt_labels_3d",
            "gt_mask")
    _equal({k: got[k] for k in keys}, {k: want[k] for k in keys})
    assert got["gt_mask"].sum() >= 8


def _detections(gts, seed):
    """Three detections of each of two classes a sample's GT holds and of
    one it lacks: one around a GT box of the class, one around a box of
    any class, one off every box (each (class, sample) IoU call 3 x G:
    few eager JAX calls)."""
    rng = np.random.default_rng(seed)
    dets = []
    for g in gts:
        boxes, labels = np.asarray(g["boxes"]), np.asarray(g["labels"])
        classes = list(np.unique(labels))[:2] + [int(np.setdiff1d(
            np.arange(18), labels)[0])]
        rows, lab = [], []
        for c in classes:
            own = np.nonzero(labels == c)[0]
            rows += [boxes[rng.choice(own)] if len(own) else boxes[0],
                     boxes[rng.integers(len(boxes))],
                     boxes[0] + np.array([9, 9, 0, 0, 0, 0, 0], np.float32)]
            lab += [c] * 3
        d = np.asarray(rows) + np.concatenate([
            rng.normal(0, 0.1, (len(rows), 3)),
            rng.normal(0, 0.05, (len(rows), 3)),
            np.zeros((len(rows), 1))], 1)
        dets.append(dict(boxes=d.astype(np.float32),
                         labels=np.asarray(lab, np.int64),
                         scores=rng.uniform(size=len(rows)).astype(
                             np.float32)))
    return dets


def test_indoor_eval_and_evaluate_match_jax(layout, seed=0):
    """``indoor_eval`` on detections around the GT (some misplaced or
    mislabelled) and the datasets' ``evaluate`` of ``single_device_test``
    style results (a ``mask`` of kept rows): the metrics to 1e-12."""
    ann = os.path.join(layout, "scannet_infos_val.pkl")
    kw = dict(ann_file=ann, data_root=layout, pipeline=None)
    jds, tds = jdatasets.ScanNetDataset(**kw), tdatasets.ScanNetDataset(**kw)
    gts = [dict(boxes=tds.get_ann_info(i)["gt_bboxes_3d"].numpy(),
                labels=tds.get_ann_info(i)["gt_labels_3d"])
           for i in range(len(tds))]
    dets = _detections(gts, seed)
    want = jeval(dets, gts, list(tds.CLASSES))
    got = indoor_eval(dets, gts, list(tds.CLASSES), device="cpu")
    assert set(got) == set(want) and want["mAP_0.25"] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    results = [dict(bboxes=np.concatenate([d["boxes"], d["boxes"][:2]]),
                    scores=np.concatenate([d["scores"], [0.9, 0.8]]),
                    labels=np.concatenate([d["labels"], [0, 1]]),
                    mask=np.arange(len(d["boxes"]) + 2) < len(d["boxes"]))
               for d in dets]
    want = jds.evaluate(results)
    got = tds.evaluate(results, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


def test_votenet_scannet_loop_runs_through_evaluate(layout, tmp_path):
    """The tiny VoteNet through ``votenet_scannet_cfg``'s loop: three train
    scenes, one epoch, the eval of the val split by ``indoor_eval``."""
    from isfusion_tpu_torch.apis.train import train_model
    cfg = flagship.votenet_scannet_cfg(layout, tiny=True, epochs=1,
                                       num_points=1024)
    cfg.data.samples_per_gpu = 2
    model, _ = flagship.build_votenet(tiny=True, device="cpu")
    train = build_dataset(cfg.data.train)
    assert len(train) == 3 and len(build_dataset(cfg.data.val)) == 2
    recs = train_model(model, train, cfg, work_dir=str(tmp_path),
                       device="cpu")
    steps = [r for r in recs if "loss" in r]
    val = [r for r in recs if r.get("mode") == "val"]
    assert steps and all(np.isfinite(r["loss"]) for r in steps)
    assert len(val) == 1 and "mAP_0.25" in val[0]
    assert (tmp_path / "epoch_1.pth").exists()
