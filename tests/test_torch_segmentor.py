"""The port's segmentors (``models/segmentors/encoder_decoder.py``,
``models/decode_heads/pointnet2_head.py``) against the JAX package's
``EncoderDecoder3D`` on carried weights: the tiny PointNet++ segmentor
(``flagship.pointnet2seg_model_cfg(tiny=True)``, the JAX test's model of
``tests/test_models/test_segmentor.py`` over 9 channels) and the tiny
PAConv one (``PAConvSASSG`` + ``PAConvHead``), on ``synthetic_seg_batch``
rooms of 256 points with ignored labels, dropout off. Also ``seg_eval``
against JAX's, and the converter on both full-width JAX trees (traced by
``jax.eval_shape``, no init compile).

Tolerances: logits within 1e-4 of their max and the predictions equal
where the two largest logits are 1e-4 of the max apart or more; the loss
within 1e-4 relative (train mode, batch statistics); every parameter's
gradient within 1e-3 of the max of its top module's (backbone, decode
head) gradient in JAX's float64 run (``jax.enable_x64``, the JAX layers'
float32 casts widened, the points float32 so that sampling and grouping
choose alike); one SGD step (lr 0.1) moves every parameter by lr times
that gradient, 1e-3 of the max; ``seg_eval``'s metrics equal (NaN where
JAX's are) on labels with and without ``ignore_index`` and with a class
absent.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isfusion_tpu.models  # noqa: F401  (registration)
from isfusion_tpu.core.evaluation.seg_eval import seg_eval as jseg_eval
from isfusion_tpu.models import layers as jlayers
from isfusion_tpu.registry import SEGMENTORS as JSEGMENTORS
from isfusion_tpu.registry import build_from_cfg as jbuild
from isfusion_tpu_torch import flagship
from isfusion_tpu_torch.core.evaluation.seg_eval import seg_eval
from isfusion_tpu_torch.models.builder import build_segmentor
from isfusion_tpu_torch.parallel.train_step import make_train_step
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from isfusion_tpu_torch.runner.optim import build_optimizer
from torch_parity import (OPTIMIZED_XLA, assert_close_to_max, float64_jax,
                          jax_cfg, random_variables)

KINDS = dict(
    pointnet2=(flagship.pointnet2seg_model_cfg,
               flagship.SCANNET_SEG_CLASSES[:5]),
    paconv=(flagship.paconvseg_model_cfg, flagship.S3DIS_SEG_CLASSES[:4]))


def _case(kind):
    make, classes = KINDS[kind]
    cfg = make(tiny=True)
    cfg["decode_head"]["dropout_ratio"] = 0.0
    batch = flagship.synthetic_seg_batch(2, 256, classes, seed=3,
                                         room=(4.0, 4.0, 2.5))
    jmodel = jbuild(jax_cfg(cfg), JSEGMENTORS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(jmodel, jb, train=False, mode="feats")
    port = build_segmentor(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    return jmodel, variables, port.eval(), batch, jb


@pytest.fixture(scope="module", params=sorted(KINDS))
def case(request):
    return _case(request.param)


def test_logits_and_predict_match_jax(case):
    jmodel, variables, port, batch, jb = case

    def run(v, b):
        return (jmodel.apply(v, b, train=False, mode="feats"),
                jmodel.apply(v, b, train=False, mode="predict"))

    logits, pred = jax.device_get(jax.jit(run).lower(variables, jb).compile(
        OPTIMIZED_XLA)(variables, jb))
    got = port(batch, device="cpu")
    assert_close_to_max(got["logits"].numpy(), logits, 1e-4)
    top2 = np.sort(logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) >= 1e-4 * np.abs(logits).max()
    np.testing.assert_array_equal(got["semantic_pred"].numpy()[clear],
                                  np.asarray(pred["semantic_pred"])[clear])
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got["mask"].numpy(), batch["points_mask"])


def test_loss_gradients_and_step_match_jax(case):
    """The loss with ``ignore_index`` in train mode, every parameter's
    gradient against JAX's float64 one, one SGD step."""
    jmodel, variables, port, batch, jb = case
    ignore = port.decode_head.ignore_index
    assert (batch["pts_semantic_mask"] == ignore).any()

    def loss_fn(params, bs, b):
        losses, _ = jmodel.apply({"params": params, "batch_stats": bs}, b,
                                 train=True, mode="loss",
                                 mutable=["batch_stats"])
        return losses["loss_sem_seg"]

    jl = float(jax.jit(loss_fn)(variables["params"],
                                variables["batch_stats"], jb))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64)), variables)
        b64 = dict(jb)
        with float64_jax(jlayers):
            lowered = jax.jit(jax.grad(loss_fn)).lower(
                v64["params"], v64["batch_stats"], b64)
        jg = jax.device_get(lowered.compile(OPTIMIZED_XLA)(
            v64["params"], v64["batch_stats"], b64))
    want = state_dict_from_jax({"params": jg})
    trained = copy.deepcopy(port).train()
    tl = trained(batch, mode="loss", device="cpu",
                 generator=torch.Generator().manual_seed(0))
    assert abs(float(tl["loss_sem_seg"]) - jl) <= 1e-4 * abs(jl)
    tl["loss_sem_seg"].backward()
    params = dict(trained.named_parameters())
    for top in ("backbone", "decode_head"):
        names = [n for n in params if n.startswith(top + ".")]
        w = np.concatenate([want[n].numpy().ravel() for n in names])
        g = np.concatenate([params[n].grad.numpy().ravel() for n in names])
        assert np.abs(w).max() > 0, top
        assert_close_to_max(g, w, 1e-3)
    stepped = copy.deepcopy(port).train()
    before = {n: p.detach().clone() for n, p in stepped.named_parameters()}
    opt = build_optimizer(stepped, dict(type="SGD", lr=0.1))
    m = make_train_step(stepped, opt)(batch,
                                      torch.Generator().manual_seed(0))
    assert abs(float(m["loss"]) - jl) <= 1e-4 * abs(jl)
    moved = np.concatenate([(before[n] - p.detach()).numpy().ravel() / 0.1
                            for n, p in stepped.named_parameters()])
    grads = np.concatenate([want[n].numpy().ravel()
                            for n, _ in stepped.named_parameters()])
    assert_close_to_max(moved, grads, 1e-3)


def test_seg_eval_matches_jax():
    """With and without ``ignore_index``, a class absent from labels and
    predictions (IoU NaN, skipped by the means), and one absent from the
    labels only (IoU 0)."""
    rng = np.random.default_rng(5)
    label2cat = {i: f"c{i}" for i in range(6)}
    gts = [rng.integers(0, 5, 300) for _ in range(3)]
    preds = [np.where(rng.uniform(size=300) < 0.7, g, rng.integers(0, 4, 300))
             for g in gts]
    gts[1][:40] = 6                     # the ignore index
    gts = [np.where(g == 3, 2, g) for g in gts]        # class 3: predicted
    for ignore in (None, 6):
        want = jseg_eval(gts, preds, label2cat, ignore)
        got = seg_eval(gts, preds, label2cat, ignore)
        assert set(got) == set(want)
        for k, w in want.items():
            assert (np.isnan(w) and np.isnan(got[k])) or got[k] == w, k
        assert np.isnan(got["c5_iou"]) and got["c3_iou"] == 0.0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_converter_carries_full_width_jax_trees(kind):
    """The full-width JAX segmentor's variables (traced by
    ``jax.eval_shape``) become exactly the port's state_dict: the same
    keys and shapes."""
    make, classes = KINDS[kind]
    cfg = make()
    n = 8192 if kind == "pointnet2" else 4096
    jb = dict(points=jnp.zeros((1, n, 9), jnp.float32),
              points_mask=jnp.ones((1, n), bool))
    variables = random_variables(jbuild(jax_cfg(cfg), JSEGMENTORS), jb,
                                 train=False, mode="feats")
    sd = state_dict_from_jax(variables)
    want = {k: tuple(v.shape) for k, v in build_segmentor(cfg)
            .state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_seg_configs_build_their_optimizers():
    """The PointNet++ config's Adam (mmcv's: the decay added to the
    gradient) through two steps of fixed gradients against a numpy
    oracle, the PAConv config's SGD with momentum, and both cosine
    schedules from the base lr to 1% of it."""
    from isfusion_tpu_torch.runner.optim import build_schedule
    model = build_segmentor(flagship.pointnet2seg_model_cfg(tiny=True))
    cfg = flagship.pointnet2seg_optim_cfg()
    opt = build_optimizer(model, cfg["optimizer"])
    assert type(opt) is torch.optim.Adam
    rng = np.random.default_rng(4)
    lr, wd, (b1, b2), eps = 1e-3, 1e-2, (0.9, 0.999), 1e-8
    state = {n: [p.detach().numpy().astype(np.float64).copy(), 0.0, 0.0]
             for n, p in model.named_parameters()}
    for t in (1, 2):
        for n, p in model.named_parameters():
            g = rng.normal(size=tuple(p.shape)).astype(np.float32)
            p.grad = torch.from_numpy(g)
            w, m, v = state[n]
            d = g + wd * w
            m = b1 * m + (1 - b1) * d
            v = b2 * v + (1 - b2) * d * d
            w = w - lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t))
                                                + eps)
            state[n] = [w, m, v]
        opt.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), state[n][0],
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    sched = build_schedule(opt, cfg["lr_config"], None, total_steps=100)
    for count, want in ((0, 1e-3), (100, 1e-5)):
        sched.apply(count)
        assert abs(opt.param_groups[0]["lr"] - want) <= 1e-12
    pcfg = flagship.paconvseg_optim_cfg()
    sgd = build_optimizer(build_segmentor(flagship.paconvseg_model_cfg(
        tiny=True)), pcfg["optimizer"])
    assert type(sgd) is torch.optim.SGD
    assert sgd.param_groups[0]["momentum"] == 0.9
    sched = build_schedule(sgd, pcfg["lr_config"], None, total_steps=10)
    sched.apply(10)
    assert abs(sgd.param_groups[0]["lr"] - 0.002) <= 1e-12
    assert pcfg["samples_per_gpu"] == 8 and cfg["samples_per_gpu"] == 16


@pytest.mark.parametrize("patch, points, classes, block", [
    (flagship.SCANNET_SEG_PATCH, 8192, flagship.SCANNET_SEG_CLASSES, 1.5),
    (flagship.S3DIS_SEG_PATCH, 4096, flagship.S3DIS_SEG_CLASSES, 1.0)])
def test_full_width_seg_batch_is_a_config_block(patch, points, classes,
                                                block):
    """The full-width batches cut each sample as the configs' pipelines
    do: ``num_points`` points of one block (x and y re-centred, within
    half the block plus ``enlarge_size``; over half of them distinct, a
    block of fewer points drawn again to ``num_points`` as the transform
    does), rgb in [0, 1], labels
    in [0, ignore_index], and SA1's 0.1 m balls (the plain ball query at
    1,024 FPS centres, 32 slots) mostly filled: over half the slots."""
    from isfusion_tpu_torch.ops import pointnet_ops

    batch = flagship.synthetic_seg_batch(1, points, classes, seed=2,
                                         patch=patch)
    pts, sem = batch["points"][0], batch["pts_semantic_mask"][0]
    assert pts.shape == (points, 9) and pts.dtype == np.float32
    assert len(np.unique(pts[:, :3], axis=0)) > points // 2
    reach = block / 2 + (patch.get("enlarge_size") or 0.0) + 1e-5
    assert np.abs(pts[:, :2]).max() <= reach
    assert pts[:, 3:6].min() >= 0 and pts[:, 3:6].max() <= 1
    assert sem.min() >= 0 and sem.max() <= len(classes)
    xyz = torch.from_numpy(np.ascontiguousarray(pts[None, :, :3]))
    centres = xyz[:, pointnet_ops.furthest_point_sample_ref(xyz, 1024)[0]
                  .long()]
    _, valid = pointnet_ops.ball_query_ref(0.1, 32, xyz, centres)
    assert float(valid.float().mean()) > 0.5
