"""The port's training slice against the JAX package: losses, rotated 3D
IoU, gaussian targets, Hungarian matching and the assigner, the sparse
conv's K12-built backward, the train-mode SparseEncoder, the whole tiny
detector's losses and gradients, the optimizer and schedules, and one
full train step.

Randomness cannot match across the packages, so every dropout and drop
path is off and the P2G pixel jitter is disabled in both (the JAX fusion
encoder fixes its deformable-layer dropout at 0.1: a module-scoped patch
makes flax's ``Dropout`` and attention dropout the identity while the JAX
functions are traced). The JAX detector is compiled three times: loss and
gradients, ``detach=True``, and one ``make_train_step``.

BatchNorm: the port (like torch and the reference) feeds the unbiased
batch variance into ``running_var``; flax feeds the biased one, so running
variances are compared after scaling the JAX batch term by n / (n - 1).

Tolerances (float32, CPU): losses 1e-6 relative; IoU 1e-5; gaussians
1e-6; sparse conv gradients 1e-6 relative; encoder outputs and gradients
1e-4 of the max; detector loss terms 1e-4 relative and gradients 1e-3 of
each top-level module's max with cosine >= 0.9999 (summation order
differs); schedules 1e-7; optimizer parameters 1e-6 relative; one train
step's parameter deltas 1e-2 of lr x lr_mult (plus the parameter's float32
spacing) wherever the JAX gradient exceeds 1e-4 of its tensor's max and,
clipped, 100 x Adam's eps.
"""
import copy

import flax.linen as fnn
import flax.linen.attention as fattn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isfusion_tpu import flagship as jflagship
from isfusion_tpu.core.bbox.assigners import \
    HungarianAssigner3D as JaxAssigner
from isfusion_tpu.models import build_detector
from isfusion_tpu.models import losses as jlosses
from isfusion_tpu.models.middle_encoders.sparse_encoder import \
    SparseEncoder as JaxSparseEncoder
from isfusion_tpu.ops import box_ops as jbox
from isfusion_tpu.ops import gaussian as jgauss
from isfusion_tpu.ops.hungarian import assign_proposals as jassign
from isfusion_tpu.parallel.train_step import TrainState, total_loss
from isfusion_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from isfusion_tpu.runner import optim as joptim
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.core.bbox.assigners import HungarianAssigner3D
from isfusion_tpu_torch.models import losses as tlosses
from isfusion_tpu_torch.models.builder import build_detector as port_build
from isfusion_tpu_torch.models.layers import BatchNorm
from isfusion_tpu_torch.models.middle_encoders.sparse_encoder import \
    SparseEncoder
from isfusion_tpu_torch.ops import box_ops, gaussian, sparse_conv
from isfusion_tpu_torch.ops.hungarian import assign_proposals
from isfusion_tpu_torch.parallel.train_step import make_train_step
from isfusion_tpu_torch.runner import optim as toptim
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from isfusion_tpu_torch.testing import pinned_choices
from test_models.test_isfusion import tiny_batch
from test_torch_isfusion import _uncapped_cfg
from torch_parity import (assert_close_to_max, float64_choices, load_from_jax,
                          random_variables)

MODULES = ("img_backbone", "img_neck", "pts_voxel_encoder",
           "pts_middle_encoder", "fusion_encoder", "pts_backbone",
           "pts_neck", "pts_bbox_head")


@pytest.fixture(scope="module")
def no_jax_dropout():
    """flax Dropout and attention-weight dropout off while JAX traces."""
    orig = fattn.dot_product_attention_weights

    def no_attn_dropout(*args, **kw):
        args = list(args)
        args[6] = 0.0                     # dropout_rate
        return orig(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fattn, "dot_product_attention_weights", no_attn_dropout)
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        yield


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("name", ["focal", "gaussian_focal", "l1"])
def test_losses_match(name):
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(40, 10)).astype(np.float32)
    weight = rng.uniform(0, 1, (40, 10)).astype(np.float32)
    avg = 7.5
    if name == "focal":
        target = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 40)]
        fns = (jlosses.sigmoid_focal_loss, tlosses.sigmoid_focal_loss)
    elif name == "gaussian_focal":
        pred = 1 / (1 + np.exp(-pred))
        target = rng.uniform(0, 1, (40, 10)).astype(np.float32)
        target[rng.uniform(size=(40, 10)) < 0.1] = 1.0
        fns = (jlosses.gaussian_focal_loss, tlosses.gaussian_focal_loss)
    else:
        target = rng.normal(size=(40, 10)).astype(np.float32)
        fns = (jlosses.l1_loss, tlosses.l1_loss)
    for kw in (dict(weight=weight, avg_factor=avg), dict(weight=weight),
               dict()):
        want = fns[0](jnp.asarray(pred), jnp.asarray(target),
                      **{k: (jnp.asarray(v) if k == "weight" else v)
                         for k, v in kw.items()})
        got = fns[1](torch.from_numpy(pred), torch.from_numpy(target),
                     **{k: (torch.from_numpy(v) if k == "weight" else v)
                        for k, v in kw.items()})
        assert _rel(got, want) <= 1e-6


# ---------------------------------------------------- rotated 3D IoU (K10)
def _boxes(rng, n, r=6.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-r, r, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


EDGE_BOXES = np.array([
    [0, 0, -1, 2, 1, 1.5, 0.3],               # identical pair
    [0, 0, -1, 2, 1, 1.5, 0.3],
    [10, 10, 0, 1, 1, 1, 0],                  # disjoint
    [0, 0, -1, 1, 0.5, 1, 0.3],               # nested
    [0, 0, -1, 2, 1, 1.5, 0.3 + np.pi / 2],   # rotated by 90 degrees
    [0, 0, -1, 2, 2, 1, 0.0],
    [0.5, 0, 2, 2, 1, 1.5, 0.3],              # BEV overlap, none in z
], np.float32)


def test_boxes_iou_3d_plain_matches_jax():
    # batched: (2, N, 7) x (2, M, 7), each sample against the JAX function
    rng = np.random.default_rng(0)
    a = np.stack([np.concatenate([_boxes(rng, 60), EDGE_BOXES])
                  for _ in range(2)])
    b = np.stack([np.concatenate([_boxes(rng, 45), EDGE_BOXES])
                  for _ in range(2)])
    want = np.stack([np.asarray(jbox.boxes_iou_3d(jnp.asarray(x),
                                                  jnp.asarray(y)))
                     for x, y in zip(a, b)])
    got = box_ops.boxes_iou_3d(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2, 67, 52)
    assert (want > 0).mean() > 0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    e = got.numpy()[0, -7:, -7:]
    assert abs(e[0, 1] - 1) < 1e-6 and e[2, 3] == 0 and e[6, 0] == 0
    assert abs(e[3, 0] - (1 * 0.5 * 1) / (2 * 1 * 1.5)) < 1e-6


# ------------------------------------------------------ gaussian targets
def test_gaussian_radius_and_heatmap_match():
    rng = np.random.default_rng(1)
    hgt = rng.uniform(0.2, 12, 50).astype(np.float32)
    wid = rng.uniform(0.2, 12, 50).astype(np.float32)
    want = np.asarray(jgauss.gaussian_radius((jnp.asarray(hgt),
                                              jnp.asarray(wid)), 0.1))
    got = gaussian.gaussian_radius((torch.from_numpy(hgt),
                                    torch.from_numpy(wid)), 0.1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)

    h, w, nc, n = 24, 20, 4, 12
    cxy = rng.uniform(-2, 22, (n, 2)).astype(np.float32)
    rad = np.floor(rng.uniform(2, 5, n)).astype(np.float32)
    labels = rng.integers(0, nc, n)
    valid = rng.uniform(size=n) > 0.2
    want = np.stack([np.asarray(jgauss.draw_heatmap_gaussian_batch(
        (h, w), jnp.asarray(cxy), jnp.asarray(rad),
        jnp.asarray(valid & (labels == c)))) for c in range(nc)], -1)
    got = gaussian.draw_heatmap_gaussian_batch(
        (h, w), torch.from_numpy(cxy), torch.from_numpy(rad),
        torch.from_numpy(valid), torch.from_numpy(labels), nc)
    assert (want == 1).sum() >= 3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ------------------------------------------------- Hungarian and assigner
def test_hungarian_matches_jax():
    rng = np.random.default_rng(2)
    for q, g in ((30, 7), (16, 16), (50, 1), (12, 0)):
        cost = rng.uniform(0, 1, (q, g)).astype(np.float32)
        want = np.asarray(jassign(jnp.asarray(cost)))
        np.testing.assert_array_equal(assign_proposals(cost), want)


def test_hungarian_assigner_matches_jax():
    rng = np.random.default_rng(3)
    q, g, nc = 40, 9, 5
    pcr = [-8, -8, -5, 8, 8, 3]
    boxes = np.concatenate([_boxes(rng, q, 7), rng.normal(size=(q, 2))],
                           1).astype(np.float32)
    gts = np.concatenate([_boxes(rng, g, 7), rng.normal(size=(g, 2))],
                         1).astype(np.float32)
    boxes[:g, :7] = gts[:, :7] + rng.normal(0, 0.3, (g, 7)).astype(
        np.float32)                          # some overlapping pairs
    labels = rng.integers(0, nc, g)
    mask = np.ones(g, bool)
    mask[-2:] = False
    logits = rng.normal(size=(q, nc)).astype(np.float32)
    kw = dict(cls_cost=dict(gamma=2.0, alpha=0.25, weight=0.15),
              reg_cost=dict(weight=0.25), iou_cost=dict(weight=0.25))
    tc = dict(point_cloud_range=pcr)
    want = JaxAssigner(**kw).assign(
        jnp.asarray(boxes), jnp.asarray(gts), jnp.asarray(labels),
        jnp.asarray(mask), jnp.asarray(logits), tc)
    got = HungarianAssigner3D(**kw).assign(
        torch.from_numpy(boxes), torch.from_numpy(gts),
        torch.from_numpy(labels), torch.from_numpy(mask),
        torch.from_numpy(logits), tc)
    np.testing.assert_array_equal(got.gt_inds.numpy(),
                                  np.asarray(want.gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (np.asarray(want.max_overlaps) > 0).sum() >= 3
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(want.max_overlaps), atol=1e-5)
    # the head's batched cost (all samples in one K10 call) == per sample
    args = [torch.from_numpy(x) for x in (boxes, gts, labels, mask, logits)]
    one = HungarianAssigner3D(**kw).cost(*args, tc)
    two = HungarianAssigner3D(**kw).cost(*[torch.stack([x, x.flip(0)])
                                           for x in args], tc)
    flip = HungarianAssigner3D(**kw).cost(*[x.flip(0) for x in args], tc)
    for got, w0, w1 in zip(two, one, flip):
        torch.testing.assert_close(got, torch.stack([w0, w1]), rtol=0,
                                   atol=1e-6)


# ------------------------------------------ sparse conv backward (K12)
def _site_table(n=200, grid=(9, 14, 12), cin=8, seed=0):
    rng = np.random.default_rng(seed)
    cells = rng.choice(np.prod(grid), n, replace=False)
    coords = np.stack(np.unravel_index(cells, grid), -1)
    coords = np.concatenate([np.zeros((n, 1), np.int64), coords], 1)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32))
    return sparse_conv.build_sparse(feats, torch.from_numpy(coords), grid, 1)


@pytest.mark.parametrize("kind", ["subm", "strided", "strided_z"])
def test_sparse_conv_function_gradients_match_plain(kind):
    sp = _site_table(seed=4)
    if kind == "subm":
        rows, found, ks = *sparse_conv.subm_rulebook(sp), (3, 3, 3)
    else:
        ks, st, pad = ((3, 3, 3), 2, 1) if kind == "strided" else \
            ((3, 1, 1), (2, 1, 1), 0)
        _, rows, found = sparse_conv.strided_rulebook(sp, ks, st, pad)
    rng = np.random.default_rng(5)
    w0 = torch.from_numpy(rng.normal(size=(12,) + ks + (8,)).astype(
        np.float32))
    dy = torch.from_numpy(rng.normal(size=(rows.shape[0], 12)).astype(
        np.float32))

    # the transposed rulebook is exact: every found pair, once
    rows_t, found_t = sparse_conv.transpose_rulebook(rows, found,
                                                     sp.feats.shape[0])
    o, k = torch.nonzero(found, as_tuple=True)
    assert int(found_t.sum()) == len(o)
    assert torch.equal(rows_t[rows[o, k].long(), k], o.int())

    grads = []
    for fn in (sparse_conv.SparseConvFunction.apply,
               sparse_conv.sparse_conv_plain):
        x = sp.feats.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        out = fn(x, rows, found, w)
        (out * dy).sum().backward()
        grads.append((out.detach(), x.grad, w.grad))
    for got, want in zip(*grads):
        assert_close_to_max(got.numpy(), want.numpy(), 1e-6)


# ---------------------------------------------- train-mode SparseEncoder
def _bn_rows(module):
    """Hooks recording the rows each port BatchNorm normalises."""
    rows = {}

    def hook(name):
        def fn(mod, inp, out):
            rows[name] = inp[0].numel() // inp[0].shape[-1]
        return fn

    handles = [m.register_forward_hook(hook(n))
               for n, m in module.named_modules() if isinstance(m, BatchNorm)]
    return rows, handles


def _check_running_stats(port, before, after_jax, rows, prefix=""):
    """Port running stats after a train step against the JAX ones (the
    JAX batch variance scaled by n / (n - 1))."""
    checked = 0
    for name, mod in port.named_modules():
        if not isinstance(mod, BatchNorm) or name not in rows:
            continue
        key = prefix + name
        m, n = mod.momentum, rows[name]
        rm0 = before[f"{key}.running_mean"].numpy()
        rv0 = before[f"{key}.running_var"].numpy()
        jm = after_jax[f"{key}.running_mean"].numpy()
        jv = after_jax[f"{key}.running_var"].numpy()
        assert_close_to_max(mod.running_mean.numpy(), jm, 1e-4)
        want_var = (1 - m) * rv0 + (jv - (1 - m) * rv0) * n / (n - 1)
        assert_close_to_max(mod.running_var.numpy(), want_var, 1e-4)
        assert not np.allclose(rm0, jm)
        checked += 1
    return checked


def test_sparse_encoder_train_mode_matches_jax():
    """The tiny detector's encoder on the voxels of its first sample."""
    cfg = _uncapped_cfg()
    enc = dict(cfg["pts_middle_encoder"])
    vl = cfg["pts_voxel_layer"]
    pts = np.asarray(tiny_batch()["points"][0])
    from isfusion_tpu_torch.ops.voxel import voxelize_dynamic
    dv = voxelize_dynamic(torch.from_numpy(pts)[None],
                          torch.ones((1, len(pts)), dtype=torch.bool),
                          vl["point_cloud_range"], vl["voxel_size"])
    coors = dv.voxel_coors[:, 1:].numpy()
    v = len(coors)
    feats = np.random.default_rng(5).normal(
        size=(v, enc["in_channels"])).astype(np.float32)
    # JAX column caps lifted to the full BEV grid of every stage table
    nz, ny, nx = enc["sparse_shape"]
    enc.update(stage_cap_ratios=tuple((ny >> i) * (nx >> i) / v + 1e-9
                                      for i in range(4)))
    kw = {k: w for k, w in enc.items() if k != "type"}
    jenc = JaxSparseEncoder(**kw)
    args = (jnp.asarray(feats)[None], jnp.asarray(coors)[None],
            jnp.ones((1, v), bool))
    variables = random_variables(jenc, *args, seed=6)
    out_shape = jax.eval_shape(lambda: jenc.apply(variables, *args)).shape
    probe = np.random.default_rng(7).normal(size=out_shape).astype(
        np.float32)

    def fn(params, x):
        out, mut = jenc.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              x, *args[1:], train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out * probe), (out, mut["batch_stats"])

    (_, (want, jbs)), (gp, gx) = jax.jit(jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True))(variables["params"], args[0])

    tenc = load_from_jax(SparseEncoder(**kw), variables,
                         "pts_middle_encoder_m", "pts_middle_encoder").train()
    tc = torch.from_numpy(np.concatenate([np.zeros((v, 1), np.int64),
                                          coors], 1))
    # the ReLU signs of the exact function: two of this encoder's ReLU
    # inputs lie within float32 rounding of 0, and the port's float32 sums
    # put them on the JAX side on one kind of host and not on another
    choices = float64_choices(tenc, lambda m, f: m(f, tc, 1),
                              torch.from_numpy(feats))
    before = {f"pts_middle_encoder.{k}": t.clone()
              for k, t in tenc.state_dict().items()}
    rows, handles = _bn_rows(tenc)
    x = torch.from_numpy(feats).requires_grad_(True)
    with pinned_choices(choices) as pins:
        got = tenc(x, tc, 1)
    (got * torch.from_numpy(probe)).sum().backward()
    for h in handles:
        h.remove()
    assert set(pins["flips"]) <= {"relu"} and not pins["unexplained"]
    assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-4)
    assert_close_to_max(x.grad.numpy(), np.asarray(gx)[0], 1e-4)
    jg = state_dict_from_jax({"params": {
        "pts_middle_encoder_m": jax.device_get(gp)}})
    for name, p in tenc.named_parameters():
        assert_close_to_max(p.grad.numpy(),
                            jg[f"pts_middle_encoder.{name}"].numpy(), 1e-4)
    after = state_dict_from_jax({"batch_stats": {
        "pts_middle_encoder_m": jax.device_get(jbs)}})
    assert _check_running_stats(tenc, before, after, rows,
                                "pts_middle_encoder.") >= 10


# ----------------------------------------------------- the whole detector
def _detector_cfgs(detach=False):
    cfg = _uncapped_cfg()
    cfg["detach"] = detach
    cfg["pts_bbox_head"]["dropout"] = 0.0
    cfg["fusion_encoder"]["random_noise"] = None
    pcfg = copy.deepcopy(cfg)
    pcfg["fusion_encoder"]["dropout"] = 0.0
    return cfg, pcfg


def _jax_loss_and_grads(cfg, batch, variables):
    model = build_detector(cfg)

    def loss_fn(params, bs, b):
        losses, mut = model.apply(
            {"params": params, "batch_stats": bs}, b, train=True,
            mode="loss", mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return total_loss(losses), (losses, mut["batch_stats"])

    (_, (losses, bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"], batch)
    return ({k: float(v) for k, v in losses.items()},
            state_dict_from_jax({"params": jax.device_get(grads)}),
            state_dict_from_jax({"batch_stats": jax.device_get(bs)}))


def _port_loss_and_grads(pcfg, batch, variables):
    port = port_build(pcfg)
    port.load_state_dict(state_dict_from_jax(variables))
    port.train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    rows, handles = _bn_rows(port)
    losses = port({k: np.asarray(v) for k, v in batch.items()}, mode="loss",
                  device="cpu")
    sum(v for k, v in losses.items() if "loss" in k).backward()
    for h in handles:
        h.remove()
    return port, {k: float(v) for k, v in losses.items()}, before, rows


@pytest.fixture(scope="module")
def detector(no_jax_dropout):
    cfg, pcfg = _detector_cfgs()
    batch = tiny_batch()
    variables = random_variables(build_detector(cfg), batch, train=False,
                                 mode="feats")
    jl, jg, jbs = _jax_loss_and_grads(cfg, batch, variables)
    port, tl, before, rows = _port_loss_and_grads(pcfg, batch, variables)
    return dict(cfg=cfg, pcfg=pcfg, batch=batch, variables=variables,
                jax=(jl, jg, jbs), port=(port, tl, before, rows))


def _module_grads(port, jgrads, top):
    """The port's gradients of one top-level module (None where autograd
    reached no parameter) and the JAX ones, flattened."""
    got, want = [], []
    for name, p in port.named_parameters():
        if name.split(".")[0] == top:
            want.append(jgrads[name].numpy().ravel())
            got.append(None if p.grad is None else p.grad.numpy().ravel())
    return got, want


def _assert_grads_close(got, want):
    """A parameter the loss does not reach (the image FPN's level 0 and the
    backbone stage feeding it) has no port gradient and a zero JAX one."""
    for g, w in zip(got, want):
        assert g is not None or not np.abs(w).any()
    got = np.concatenate([np.zeros_like(w) if g is None else g
                          for g, w in zip(got, want)])
    want = np.concatenate(want)
    assert np.abs(want).max() > 0
    assert_close_to_max(got, want, 1e-3)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos >= 0.9999


def test_detector_loss_terms_match(detector):
    jl, _, _ = detector["jax"]
    _, tl, _, _ = detector["port"]
    assert set(tl) == set(jl) == {"loss_heatmap", "loss_heatmap_ins",
                                  "layer_-1_loss_cls", "layer_-1_loss_bbox",
                                  "matched_ious"}
    for k in jl:
        assert _rel(tl[k], jl[k]) <= 1e-4, k


@pytest.mark.parametrize("top", MODULES)
def test_detector_gradients_match(detector, top):
    _, jg, _ = detector["jax"]
    port = detector["port"][0]
    _assert_grads_close(*_module_grads(port, jg, top))


def test_detector_batch_statistics_match(detector):
    _, _, jbs = detector["jax"]
    port, _, before, rows = detector["port"]
    assert _check_running_stats(port, before, jbs, rows) >= 40


def test_detached_image_backbone(detector):
    cfg, pcfg = _detector_cfgs(detach=True)
    batch, variables = detector["batch"], detector["variables"]
    jl, jg, _ = _jax_loss_and_grads(cfg, batch, variables)
    port, tl, _, _ = _port_loss_and_grads(pcfg, batch, variables)
    for k in jl:
        assert _rel(tl[k], jl[k]) <= 1e-4, k
    for top in MODULES:
        got, want = _module_grads(port, jg, top)
        if top == "img_backbone":
            assert all(g is None for g in got)
            assert not any(np.abs(w).any() for w in want)
        else:
            _assert_grads_close(got, want)


# ------------------------------------------------ optimizer and schedule
def _optim_cfgs():
    cfg = tflagship.flagship_optim_cfg()
    return cfg["optimizer"], cfg["optimizer_config"], cfg["lr_config"], \
        cfg["momentum_config"]


def test_schedules_match():
    opt_cfg, _, lr_cfg, mom_cfg = _optim_cfgs()
    total = 20
    jlr = joptim.build_lr_schedule(lr_cfg, opt_cfg["lr"], total)
    jb1 = joptim.build_momentum_schedule(mom_cfg, 0.9, total)
    toy = torch.nn.Linear(2, 2)
    sched = toptim.build_schedule(toptim.build_optimizer(toy, opt_cfg),
                                  lr_cfg, mom_cfg, total)
    for c in range(total):
        assert abs(sched.lr(c) - float(jlr(c))) <= 1e-7
        assert abs(sched.beta1(c) - float(jb1(c))) <= 1e-7


class _Toy(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for top, leaves in arrays.items():
            mod = torch.nn.Module()
            for n, a in leaves.items():
                mod.register_parameter(n, torch.nn.Parameter(
                    torch.from_numpy(a.copy())))
            self.add_module(top, mod)


def test_optimizer_steps_match():
    opt_cfg, opt_conf, lr_cfg, mom_cfg = _optim_cfgs()
    rng = np.random.default_rng(8)
    arrays = {"img_backbone": {"w": rng.normal(size=(6, 5)),
                               "b": rng.normal(size=(5,))},
              "pts_bbox_head": {"w": rng.normal(size=(4, 3)),
                                "b": rng.normal(size=(3,))}}
    arrays = {t: {n: a.astype(np.float32) for n, a in d.items()}
              for t, d in arrays.items()}
    grads = [{t: {n: (rng.normal(size=a.shape) *
                      rng.choice([1e-4, 10.0])).astype(np.float32)
                  for n, a in d.items()} for t, d in arrays.items()}
             for _ in range(10)]
    total = 30

    params = jax.tree_util.tree_map(jnp.asarray, arrays)
    tx = joptim.build_optimizer(params, opt_cfg, opt_conf, lr_cfg, mom_cfg,
                                total_steps=total)
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, params)
        params = optax.apply_updates(params, upd)

    toy = _Toy(arrays)
    opt = toptim.build_optimizer(toy, opt_cfg)
    sched = toptim.build_schedule(opt, lr_cfg, mom_cfg, total)
    clip = toptim.grad_clip_norm(opt_conf)
    for c, g in enumerate(grads):
        sched.apply(c)
        for t, d in g.items():
            for n, a in d.items():
                getattr(getattr(toy, t), n).grad = torch.from_numpy(a)
        toptim.clip_by_global_norm([p.grad for p in toy.parameters()], clip)
        opt.step()
    for t, d in params.items():
        for n, want in d.items():
            got = getattr(getattr(toy, t), n).detach().numpy()
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       atol=1e-7)


def test_train_step_matches_jax(detector):
    cfg, pcfg = detector["cfg"], detector["pcfg"]
    batch, variables = detector["batch"], detector["variables"]
    _, jgrads, _ = detector["jax"]
    opt_cfg, opt_conf, lr_cfg, mom_cfg = _optim_cfgs()
    model = build_detector(cfg)
    tx = joptim.build_optimizer(variables["params"], opt_cfg, opt_conf,
                                lr_cfg, mom_cfg, total_steps=100)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              tx)
    jstep = jmake_train_step(model, tx, mesh=None, donate=False)
    new_state, jm = jstep(state, batch, jax.random.PRNGKey(0))
    jafter = state_dict_from_jax({"params": jax.device_get(new_state.params),
                                  "batch_stats": jax.device_get(
                                      new_state.batch_stats)})

    port = port_build(pcfg)
    port.load_state_dict(state_dict_from_jax(variables))
    port.train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    opt = toptim.build_optimizer(port, opt_cfg)
    step = make_train_step(port, opt, toptim.build_schedule(
        opt, lr_cfg, mom_cfg, 100), toptim.grad_clip_norm(opt_conf))
    rows, handles = _bn_rows(port)
    tm = step({k: np.asarray(v) for k, v in batch.items()},
              torch.Generator().manual_seed(0))
    for h in handles:
        h.remove()
    assert _rel(tm["loss"], jm["loss"]) <= 1e-4
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-4
    lr = opt_cfg["lr"]
    clip = min(1.0, opt_conf["grad_clip"]["max_norm"] / float(
        jm["grad_norm"]))
    checked = 0
    for name, p in port.named_parameters():
        mult = 0.1 if name.startswith("img_backbone") else 1.0
        g = jgrads[name].numpy()
        # Adam's first update is ~sign(g) only where the clipped gradient
        # is far above its eps (1e-8): below, it tracks g's relative error
        sel = (np.abs(g) > 1e-4 * np.abs(g).max()) & \
            (np.abs(g) * clip > 100 * 1e-8)
        d_port = (p.detach() - before[name]).numpy()[sel]
        d_jax = (jafter[name] - before[name]).numpy()[sel]
        # + the float32 spacing of the parameter, which quantises a delta
        # of lr * lr_mult = 1e-5 (img_backbone) near |p| = 1 to 6e-8 steps
        tol = 1e-2 * lr * mult + 2 * np.spacing(np.abs(
            before[name].numpy()[sel]))
        assert (np.abs(d_port - d_jax) <= tol).all(), name
        checked += int(sel.sum())
    assert checked > 10000
    assert _check_running_stats(port, before, jafter, rows) >= 40


def test_tiny_train_cfg_matches_jax():
    jmodel, _ = jflagship.build_isfusion_flagship(tiny=True)
    want = dict(dict(jmodel.train_cfg)["pts"])
    got = tflagship.flagship_model_cfg(tiny=True)["train_cfg"]["pts"]
    assert got == want
