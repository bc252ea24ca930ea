"""The port's KITTI data path against the JAX package: ``KittiDataset``'s
``get_data_info`` / ``get_ann_info`` on the JAX test's fixture
(``tests/test_data/test_kitti_dataset.py:make_kitti_fixture``), the KITTI
evaluator (``kitti_eval``, to 1e-12: the perfect and the missed cases of
the JAX tests, random detections around the GT, the difficulty masks),
the info converter (``create_kitti_info_file``) on a synthetic layout
written by ``tools/make_synthetic_kitti.py``, and PartA2's train -> eval
loop on that layout at tiny size (2 + 1 samples, one epoch).

On the CPU the evaluator's IoU runs through the plain versions of K10-BEV
and K10 (``ops/box_ops.py``); the JAX package's through its XLA
geometry, both in float32.
"""
import pickle

import numpy as np
import pytest

from isfusion_tpu.core.evaluation import kitti_eval as jeval
from isfusion_tpu.datasets import KittiDataset as JaxKitti
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.core.evaluation import kitti_eval as teval
from isfusion_tpu_torch.datasets import KittiDataset, build_dataset
from isfusion_tpu_torch.tools import kitti_converter as tconv
from isfusion_tpu_torch.tools.make_synthetic_kitti import make_dataset
from test_data.test_kitti_dataset import make_kitti_fixture
from tools.data_converter import kitti_converter as jconv


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti")
    ann = make_kitti_fixture(str(d), num_samples=4)
    kw = dict(ann_file=ann, data_root=str(d), pipeline=None)
    return (JaxKitti(test_mode=True, **kw), KittiDataset(test_mode=True,
                                                         **kw),
            JaxKitti(test_mode=False, **kw), KittiDataset(test_mode=False,
                                                          **kw))


def _equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif hasattr(want, "tensor"):
        _equal(got.tensor, want.tensor, path)
        assert type(got).__name__ == type(want).__name__, path
    else:
        w, g = np.asarray(want), np.asarray(got)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("index", [0, 3])
def test_data_and_ann_info_match_jax(fixture, index):
    jtest, ttest, jtrain, ttrain = fixture
    _equal(ttest.get_data_info(index), jtest.get_data_info(index))
    _equal(ttrain.get_data_info(index), jtrain.get_data_info(index))
    ann = ttrain.get_ann_info(index)
    assert len(ann["gt_bboxes_3d"]) == 2            # DontCare dropped
    assert ttest.get_data_info(index)["lidar2img"].shape == (1, 4, 4)


def _gts(ds):
    out = []
    for i in range(len(ds)):
        ann = ds.get_ann_info(i)
        b2d = ann["bboxes"]
        out.append(dict(boxes=ann["gt_bboxes_3d"].numpy(),
                        labels=ann["gt_labels_3d"],
                        occluded=np.asarray(ann["occluded"], np.float32),
                        truncated=np.asarray(ann["truncated"], np.float32),
                        bbox2d_height=b2d[:, 3] - b2d[:, 1]))
    return out


def _random_case(gts, seed):
    """Per sample: each GT detected with a jittered box (some far off,
    some with another label) plus two false positives; random scores;
    a mask that hides one row; the GT's difficulty fields varied."""
    rng = np.random.default_rng(seed)
    dets, out = [], []
    for g in gts:
        n = len(g["boxes"])
        b = np.concatenate([g["boxes"], g["boxes"][:1]]).copy()
        b[:n, :3] += rng.normal(0, 0.3, (n, 3))
        b[:n, 3:6] *= rng.uniform(0.9, 1.1, (n, 3))
        b[n:, :2] += 15.0
        b = np.concatenate([b, b[:1] + [0.05, 0, 0, 0, 0, 0, 0.1]])
        labels = np.concatenate([g["labels"], g["labels"][:1],
                                 g["labels"][:1]])
        labels[rng.uniform(size=len(labels)) < 0.15] = 2
        mask = np.ones(len(b), bool)
        mask[int(rng.integers(0, len(b)))] = False
        dets.append(dict(bboxes=b.astype(np.float32),
                         scores=rng.uniform(0.1, 1.0, len(b)),
                         labels=labels, mask=mask))
        out.append(dict(g, occluded=rng.integers(0, 3, n).astype(
            np.float32), truncated=rng.uniform(0, 0.6, n).astype(
                np.float32), bbox2d_height=rng.uniform(20, 60, n)))
    return dets, out


def _check(dets, gts, classes, want_keys=None):
    want = jeval.kitti_eval(dets, gts, classes)
    got = teval.kitti_eval(dets, gts, classes, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    if want_keys:
        assert want_keys <= set(want)
    return got


def test_eval_perfect_and_missed_match_jax(fixture):
    _, ttest, _, _ = fixture
    gts = _gts(ttest)
    perfect = [dict(boxes=g["boxes"], scores=np.full(2, 0.9),
                    labels=g["labels"]) for g in gts]
    got = _check(perfect, gts, list(ttest.CLASSES))
    assert got["mAP_3d_moderate"] > 0.9
    missed = [dict(d, boxes=d["boxes"] + np.float32([10, 10, 0, 0, 0, 0, 0]))
              for d in perfect]
    assert _check(missed, gts, list(ttest.CLASSES))["mAP_3d_moderate"] < 0.1
    # the dataset's own evaluate, as the JAX test calls it
    assert ttest.evaluate(perfect, device="cpu") == got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_random_detections_match_jax(fixture, seed):
    _, ttest, _, _ = fixture
    dets, gts = _random_case(_gts(ttest), seed)
    got = _check(dets, gts, list(ttest.CLASSES),
                 {"car_bev_hard", "car_3d_hard"})
    assert any(0.0 < v < 1.0 for v in got.values())


@pytest.mark.parametrize("level", [0, 1, 2])
def test_difficulty_masks_match_jax(fixture, level):
    _, ttest, _, _ = fixture
    _, gts = _random_case(_gts(ttest), 7)
    for g in gts:
        np.testing.assert_array_equal(teval._gt_difficulty_mask(g, level),
                                      jeval._gt_difficulty_mask(g, level))


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_syn"))
    make_dataset(root, train=2, val=1, points=3000, objects=4, seed=0,
                 x_range=(1.0, 7.0))
    return root


def test_info_converter_matches_jax(layout, tmp_path):
    import shutil
    for split in ("train", "val"):
        shutil.copy(f"{layout}/kitti_infos_{split}.pkl",
                    tmp_path / f"port_{split}.pkl")
    jconv.create_kitti_info_file(layout, "jax")
    for split in ("train", "val"):
        with open(f"{layout}/jax_infos_{split}.pkl", "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / f"port_{split}.pkl", "rb") as f:
            got = pickle.load(f)
        assert len(got) == len(want) == (2 if split == "train" else 1)
        for g, w in zip(got, want):
            _equal(g, w)
            assert list(w["annos"]["name"])[-1] == "DontCare"
    assert tconv._read_calib(f"{layout}/training/calib/000000.txt").keys() \
        == jconv._read_calib(f"{layout}/training/calib/000000.txt").keys()


def test_parta2_kitti_loop_runs_through_evaluate(layout, tmp_path):
    from isfusion_tpu_torch.apis.train import train_model
    cfg = tflagship.parta2_kitti_cfg(layout, tiny=True, epochs=1,
                                     max_points=3000)
    model, _ = tflagship.build_parta2(tiny=True, device="cpu")
    train = build_dataset(cfg.data.train)
    assert len(train) == 2 and len(build_dataset(cfg.data.val)) == 1
    recs = train_model(model, train, cfg, work_dir=str(tmp_path),
                       device="cpu")
    steps = [r for r in recs if "loss" in r]
    val = [r for r in recs if r.get("mode") == "val"]
    assert len(steps) == 1 and np.isfinite(steps[0]["loss"])
    assert len(val) == 1 and "mAP_3d_moderate" in val[0]
    assert (tmp_path / "epoch_1.pth").exists()
