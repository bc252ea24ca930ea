"""The port's train -> eval loop on the CPU: the whole eval path of a tiny
PointPillars (the learnability config, cut to 16 x 16 BEV cells of 6.4 m)
against the JAX package on carried weights; a two-epoch ``train_model``
run with checkpoints, resume and the JAX log's keys; the CLIs; the
norm types the builders take; the import rule for the new modules; the
entry points' default device.

The eval path runs the fixture's train split (4 samples: one predict
batch of B 4 x C 2 x K 256 for K10-NMS, the learnability config's eval
shape) through the dataset, the test pipeline, the loader,
``single_device_test`` and ``evaluate`` of each package. Tolerances
(float32, CPU): kept masks and labels equal; boxes and scores within 1e-4
of their max (as ``tests/test_torch_pointpillars.py``); metrics within
1e-4. The box-regression weights are scaled by 0.01 on both sides so that
random weights decode scene-sized boxes.
"""
import ast
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from isfusion_tpu.apis.test import single_device_test as jsingle_test
from isfusion_tpu.datasets import NuScenesDataset as JaxNuScenes
from isfusion_tpu.datasets import build_dataloader as jbuild_loader
from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.parallel.train_step import TrainState
from isfusion_tpu_torch.apis import (inference_detector, init_model,
                                     single_device_test, train_model)
from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
from isfusion_tpu_torch.models import layers
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.ops import cuda_build
from isfusion_tpu_torch.runner.checkpoint import checkpoint_path, load_params
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from isfusion_tpu_torch.tools import make_synthetic_nuscenes as tgen
from isfusion_tpu_torch.tools import test as ttest_cli
from isfusion_tpu_torch.tools import train as ttrain_cli
from torch_dp_workers import tiny_learn_cfg
from torch_parity import assert_close_to_max, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_LOG = os.path.join(REPO, "evidence", "learnability_tpu_train_log.jsonl")


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("syn"))
    tgen.make_dataset(out, train=4, val=2, points=2048, img_hw=(16, 32),
                      seed=0, classes=["car", "pedestrian"])
    return out


# ------------------------------------------------------ the eval path
@pytest.fixture(scope="module")
def eval_path(fixture_dir):
    cfg = tiny_learn_cfg(fixture_dir)
    test = dict(cfg.data.test, ann_file=cfg.data.train.ann_file)
    jmodel = jbuild_detector(dict(cfg.model))
    jds = JaxNuScenes(**{k: v for k, v in test.items() if k != "type"})
    jloader = jbuild_loader(jds, samples_per_gpu=4, shuffle=False,
                            workers_per_gpu=1)
    batch0 = next(iter(jloader))
    variables = random_variables(
        jmodel, {k: v for k, v in batch0.items() if k != "img_metas"},
        train=False, mode="feats", seed=3)
    variables["params"]["pts_bbox_head_m"]["conv_reg"]["kernel"] *= 0.01
    state = TrainState.create(jax.tree_util.tree_map(np.asarray, variables),
                              optax.identity())
    want = jsingle_test(jmodel, state, jloader)
    want_metrics = jds.evaluate(want)

    port = build_detector(dict(cfg.model))
    port.load_state_dict(state_dict_from_jax(variables))
    port.eval()
    ds = build_dataset(test)
    loader = build_dataloader(ds, samples_per_gpu=4, shuffle=False)
    got = single_device_test(port, loader, device="cpu")
    return want, want_metrics, got, ds.evaluate(got), port, cfg


def test_eval_path_kept_boxes_match_jax(eval_path):
    want, _, got, _, _, _ = eval_path
    assert len(got) == len(want) == 4
    kept = 0
    for g, w in zip(got, want):
        m = np.asarray(w["mask"])
        np.testing.assert_array_equal(g["mask"], m)
        np.testing.assert_array_equal(g["labels"][m],
                                      np.asarray(w["labels"])[m])
        assert_close_to_max(g["scores"][m], np.asarray(w["scores"])[m], 1e-4)
        assert_close_to_max(g["bboxes"][m], np.asarray(w["bboxes"])[m], 1e-4)
        assert g["bboxes"].shape == (100, 9)
        kept += int(m.sum())
    assert kept >= 40


def test_eval_path_metrics_match_jax(eval_path):
    # random weights find almost nothing (mAP 0); the metrics of planted
    # detections are held in tests/test_torch_data.py
    _, want, _, got, _, _ = eval_path
    assert list(got) == list(want)
    assert {"car_AP", "pedestrian_AP", "mAP", "NDS"} <= set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-4, k
        else:
            assert got[k] == v, k


def test_inference_detector_matches_single_device_test(eval_path,
                                                       fixture_dir):
    _, _, got, _, port, cfg = eval_path
    ds = build_dataset(dict(cfg.data.test, ann_file=cfg.data.train.ann_file))
    batch = next(iter(build_dataloader(ds, samples_per_gpu=4,
                                       shuffle=False)))
    before = cuda_build.LAUNCHES["nms_bev"]
    out = inference_detector(port, batch, device="cpu")
    assert cuda_build.LAUNCHES["nms_bev"] == before     # plain on the CPU
    for i in range(4):
        for k in ("bboxes", "scores", "labels", "mask"):
            np.testing.assert_array_equal(out[k][i], got[i][k])


# ------------------------------------------------------- the train loop
def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(fixture_dir, tmp_path_factory):
    """Two epochs, then epoch 2 again from the epoch-1 checkpoint."""
    cfg = tiny_learn_cfg(fixture_dir)
    work = str(tmp_path_factory.mktemp("work"))
    model = init_model(cfg, device="cpu")
    records = train_model(model, build_dataset(cfg.data.train), cfg,
                          work_dir=work, device="cpu")
    resumed_dir = str(tmp_path_factory.mktemp("resumed"))
    model2 = init_model(cfg, device="cpu", seed=5)
    resumed = train_model(model2, build_dataset(cfg.data.train), cfg,
                          work_dir=resumed_dir, device="cpu",
                          resume_from=os.path.join(work, "epoch_1.pth"))
    return cfg, work, records, resumed, model, model2


def test_train_log_has_the_jax_log_keys(trained):
    _, work, records, _, _, _ = trained
    assert _log(os.path.join(work, "train_log.jsonl")) == records
    want = _log(TPU_LOG)
    train_keys = {frozenset(r) for r in want if "mode" not in r}
    val_keys = {frozenset(r) for r in want if "mode" in r}
    assert len(train_keys) == len(val_keys) == 1
    steps = [r for r in records if "mode" not in r]
    vals = [r for r in records if "mode" in r]
    assert {frozenset(r) for r in steps} == train_keys
    assert {frozenset(r) for r in vals} == val_keys
    # one record a step (interval 1), one val record an epoch
    assert [r["step"] for r in steps] == [1, 2]
    assert [(r["epoch"], r["iter"]) for r in steps] == [(0, 0), (1, 0)]
    assert [r["epoch"] for r in vals] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps)


def test_resume_reproduces_epoch_two(trained):
    _, work, records, resumed, model, model2 = trained
    assert sorted(f for f in os.listdir(work) if f.endswith(".pth")) == \
        ["epoch_1.pth", "epoch_2.pth"]
    assert checkpoint_path(work).endswith("epoch_2.pth")

    def untimed(recs):
        return [{k: v for k, v in r.items() if k not in ("data_time", "time")}
                for r in recs]

    # records: step (epoch 0), val 1, step (epoch 1), val 2; the resumed
    # run logs the last two with the same losses, grad norm and metrics
    assert [("mode" in r, r["epoch"]) for r in resumed] == [(False, 1),
                                                            (True, 2)]
    assert untimed(resumed) == untimed(records[2:])
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k
    sd, meta = load_params(work)
    assert meta == dict(epoch=2, step=2)
    assert set(sd) == set(model.state_dict())


def test_cli_train_then_test(fixture_dir, tmp_path, capsys):
    cfg = tiny_learn_cfg(fixture_dir)
    cfg_path = str(tmp_path / "tiny_learn.py")
    with open(cfg_path, "w") as f:
        f.write("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    work = str(tmp_path / "work")
    ttrain_cli.main([cfg_path, "--work-dir", work, "--device", "cpu",
                     "--cfg-options", "total_epochs=1",
                     "evaluation.interval=0", "--seed", "2"])
    assert os.path.isfile(os.path.join(work, "epoch_1.pth"))
    capsys.readouterr()
    metrics = ttest_cli.main([cfg_path, work, "--eval", "bbox", "--device",
                              "cpu", "--out", str(tmp_path / "m.json")])
    printed = json.loads(capsys.readouterr().out)
    assert printed == metrics == json.load(open(tmp_path / "m.json"))
    assert {"mAP", "NDS", "car_AP", "pedestrian_AP"} <= set(metrics)


# --------------------------------------------------------------- misc
@pytest.mark.parametrize("kind", ["BN", "BN1d", "BN2d", "SyncBN",
                                  "naiveSyncBN1d", "naiveSyncBN2d"])
def test_norm_builders_take_batch_norm_types(kind):
    cfg = tiny_learn_cfg("unused").model
    for key in ("pts_voxel_encoder", "pts_backbone", "pts_neck"):
        cfg[key]["norm_cfg"] = dict(type=kind, eps=2e-3, momentum=0.02)
    model = build_detector(dict(cfg))
    bns = [m for m in model.modules() if isinstance(m, layers.BatchNorm)]
    assert len(bns) == 1 + 6 + 3
    assert all(m.eps == 2e-3 and m.momentum == 0.02 for m in bns)
    assert all(m.sync == ("sync" in kind.lower()) for m in bns)


def test_norm_builders_refuse_other_norms():
    cfg = tiny_learn_cfg("unused").model
    cfg["pts_backbone"]["norm_cfg"] = dict(type="GN", num_groups=8)
    with pytest.raises(NotImplementedError, match="GN"):
        build_detector(dict(cfg))


NEW_MODULES = [
    "registry.py", "core/points.py", "core/bbox/structures.py",
    "core/evaluation/nuscenes_eval.py", "datasets/__init__.py",
    "datasets/builder.py", "datasets/custom_3d.py",
    "datasets/nuscenes_dataset.py", "datasets/pipelines/compose.py",
    "datasets/pipelines/loading.py", "datasets/pipelines/transforms_3d.py",
    "datasets/pipelines/formating.py", "runner/checkpoint.py",
    "apis/train.py", "apis/test.py", "apis/inference.py", "tools/train.py",
    "tools/test.py", "tools/make_synthetic_nuscenes.py",
    "datasets/nuscenes_mono_dataset.py",
    "models/dense_heads/fcos_mono3d_head.py",
    "models/detectors/single_stage_mono3d.py",
    "models/detectors/voxelnet.py", "models/detectors/transfusion.py",
    "models/detectors/centerpoint.py", "models/voxel_encoders.py",
    "models/layers.py", "runner/optim.py", "runner/convert.py",
    "models/backbones/regnet.py", "models/dense_heads/shape_aware_head.py",
    "models/dense_heads/free_anchor3d_head.py", "core/post_processing.py",
    "models/detectors/imvoxelnet.py", "models/necks/yolox_pafpn.py",
    "core/voxel_generator.py", "datasets/kitti_dataset.py",
    "core/evaluation/kitti_eval.py", "tools/kitti_converter.py",
    "tools/make_synthetic_kitti.py", "ops/pointnet_ops.py",
    "models/backbones/pointnet2.py", "models/backbones/multi_backbone.py",
    "models/dense_heads/vote_head.py", "models/detectors/votenet.py",
    "models/detectors/h3dnet.py",
    "core/bbox/coders.py", "models/builder.py", "flagship.py",
    "testing.py"]


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


@pytest.mark.parametrize("call", ["init_model", "train_model",
                                  "single_device_test"])
def test_entry_points_default_to_the_card(call, fixture_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = tiny_learn_cfg(fixture_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if call == "init_model":
            init_model(cfg)
        elif call == "train_model":
            train_model(init_model(cfg, device="cpu"),
                        build_dataset(cfg.data.train), cfg, work_dir="unused")
        else:
            single_device_test(init_model(cfg, device="cpu"), [])
