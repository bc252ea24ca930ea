"""The whole detector: the tiny IS-Fusion detector (config of
tests/test_models/test_isfusion.py) in the JAX package and in the port,
on the same variables (drawn for the JAX tree, carried across with
state_dict_from_jax) and the same numpy batch (two samples, one camera
view dropped).

Tolerances (float32, CPU): heatmaps and boxes/scores 1e-3 of their max;
the top-k proposal indices of the head and of the instance-guided fusion
exact. The JAX capacity caps are lifted to the full grid of every table,
so the JAX reference drops nothing. On this seed no two heatmap scores
sit within rounding of each other at the top-k boundary.
"""
import ast
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models import build_detector
from isfusion_tpu.models.dense_heads.transfusion_head import _maxpool_nms
from isfusion_tpu_torch.models.builder import build_detector as port_build
from isfusion_tpu_torch.models.middle_encoders.isfusion_encoder import \
    maxpool_nms, topk_stable
from test_models.test_isfusion import tiny_batch, tiny_isfusion_cfg
from torch_parity import assert_close_to_max, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-3


def _uncapped_cfg():
    cfg = copy.deepcopy(tiny_isfusion_cfg())
    enc = cfg["pts_middle_encoder"]
    nz, ny, nx = enc["sparse_shape"]
    v_cap = cfg["pts_voxel_layer"]["max_voxels"]
    cells = [(ny >> i) * (nx >> i) for i in range(4)]
    enc.update(stage_cap_ratios=tuple(c / v_cap + 1e-9 for c in cells),
               dilation_ratio=1.0)
    return cfg


@pytest.fixture(scope="module")
def both():
    cfg = _uncapped_cfg()
    batch = tiny_batch()
    # the caps hold every point, pillar and column of this batch
    assert cfg["pts_voxel_layer"]["max_voxels"] >= batch["points"].shape[1]
    bev = cfg["fusion_encoder"]["bev_size"]
    assert cfg["pillar_max_voxels"][1] >= bev * bev
    model = build_detector(cfg)
    variables = random_variables(model, batch, train=False, mode="feats")
    preds, ins = jax.jit(lambda v, b: model.apply(
        v, b, train=False, mode="feats"))(variables, batch)
    boxes = model.apply(variables, preds,
                        method=lambda m, p: m.pts_bbox_head_m.get_bboxes(p))

    from isfusion_tpu_torch.runner.convert import state_dict_from_jax
    port = port_build(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    port.eval()
    nb = {k: np.asarray(v) for k, v in batch.items()}
    tpreds, tins = port(nb, mode="feats", device="cpu")
    tboxes = port(nb, mode="predict", device="cpu")
    return cfg, (preds, ins, boxes), (tpreds, tins, tboxes)


@pytest.mark.parametrize("key", ["dense_heatmap", "ins_heatmap", "heatmap",
                                 "center", "height", "dim", "rot", "vel",
                                 "query_heatmap_score"])
def test_feats_match(both, key):
    _, (preds, ins, _), (tpreds, tins, _) = both
    want = ins if key == "ins_heatmap" else preds[key]
    got = tins if key == "ins_heatmap" else tpreds[key]
    assert_close_to_max(got.numpy(), np.asarray(want), TOL)


@pytest.mark.parametrize("which", ["head", "igf"])
def test_topk_indices_identical(both, which):
    cfg, (preds, ins, _), (tpreds, tins, _) = both
    if which == "head":
        k = cfg["pts_bbox_head"]["num_proposals"]
        jh, th = preds["dense_heatmap"], tpreds["dense_heatmap"]
        np.testing.assert_array_equal(tpreds["query_labels"].numpy(),
                                      np.asarray(preds["query_labels"]))
    else:
        k = cfg["fusion_encoder"]["instance_num"]
        jh, th = ins, tins
    b, h, w, nc = jh.shape
    jheat = _maxpool_nms(jax.nn.sigmoid(jh), 3, ())
    _, jtop = jax.lax.top_k(jheat.transpose(0, 3, 1, 2).reshape(b, -1), k)
    theat = maxpool_nms(torch.sigmoid(th), 3, ())
    ttop = topk_stable(theat.permute(0, 3, 1, 2).reshape(b, -1), k)
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))


@pytest.mark.parametrize("key", ["bboxes", "scores", "labels"])
def test_predict_matches(both, key):
    _, (_, _, boxes), (_, _, tboxes) = both
    got, want = tboxes[key].numpy(), np.asarray(boxes[key])
    assert got.shape == want.shape
    if key == "labels":
        np.testing.assert_array_equal(got, want)
    else:
        assert_close_to_max(got, want, TOL)


def _port_sources():
    for root, _, files in os.walk(os.path.join(REPO, "isfusion_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    banned = ("jax", "jaxlib", "flax", "optax", "isfusion_tpu")
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in banned:
                    bad.append(f"{os.path.relpath(path, REPO)}: {n}")
    assert bad == []
