"""Helpers shared by the port's parity tests (tests/test_torch_*.py):
random JAX variables drawn with numpy, carrying a JAX module's variables
into the matching port module, the tiny LiDAR detectors of
``flagship.LIDAR_VARIANTS`` and the tiny PointPillars-family detectors
(SSN, FreeAnchor) run on both sides."""
import contextlib
import math

import jax
import numpy as np
import torch

from isfusion_tpu_torch.runner.convert import state_dict_from_jax


def random_variables(module, *args, seed=0, **kwargs):
    """Variables of a flax ``module`` with the shapes ``module.init`` gives,
    drawn with numpy: kernels N(0, 1/fan_in), norm scales U(0.5, 1.5),
    biases N(0, 0.1), BN means N(0, 0.5), BN variances U(0.5, 2) -- so no
    norm is the identity. Only traces the module (no init compile)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name == "scale":
            x = rng.uniform(0.5, 1.5, s.shape)
        elif name == "var":
            x = rng.uniform(0.5, 2.0, s.shape)
        elif name == "mean":
            x = rng.normal(0, 0.5, s.shape)
        elif name == "kernel":
            fan_in = max(int(np.prod(s.shape[:-1])), 1)
            x = rng.normal(0, 1.0 / np.sqrt(fan_in), s.shape)
        else:
            x = rng.normal(0, 0.1, s.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def load_from_jax(port_module: torch.nn.Module, variables, jax_path: str,
                  ref_prefix: str) -> torch.nn.Module:
    """Carry a JAX module's ``variables`` (at ``jax_path``, e.g.
    'fusion_encoder_m/instance_att', inside the JAX detector) into
    ``port_module`` (named ``ref_prefix`` in the reference state_dict);
    eval mode."""
    def nest(tree):
        for name in reversed(jax_path.split("/")):
            tree = {name: tree}
        return tree

    sd = state_dict_from_jax({c: nest(variables[c]) for c in variables})
    n = len(ref_prefix) + 1
    port_module.load_state_dict({k[n:]: v for k, v in sd.items()
                                 if k.startswith(ref_prefix + ".")})
    return port_module.eval()


def assert_close_to_max(got, want, tol):
    """|got - want| <= tol * max|want| elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"max error {err:.3g} of the max exceeds {tol}"


# XLA:CPU's backend optimisation level 1 for one compile: under the
# suite's level 0 (tests/conftest.py) a jitted JAX train step of a sparse
# detector computes gradients 1e-3 to 4e-3 of their max away from the
# same step at levels 1 and 2, whose gradients the port matches to 1e-5
OPTIMIZED_XLA = {"xla_backend_optimization_level": 1,
                 "xla_llvm_disable_expensive_passes": True}


def jax_cfg(v):
    """A port config for the JAX builder (no compute_dtype keys)."""
    if isinstance(v, dict):
        return {k: jax_cfg(x) for k, x in v.items() if k != "compute_dtype"}
    return v


def tree_leaves(tree):
    """(path, leaf) of nested dicts / lists, sorted by key; None skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from ((f"{k}/{p}", v) for p, v in tree_leaves(tree[k]))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from ((f"{i}/{p}", v) for p, v in tree_leaves(t))
    elif tree is not None:
        yield "", tree


@contextlib.contextmanager
def float64_port():
    """Inside the block the port computes in float64: its float32 casts
    (``torch.float32`` and its alias ``torch.float``, ``Tensor.float``) and
    new tensors widen. Undone on exit. Dtypes a module fixed when it was
    built (``cdtype``) stay: ``widen`` them."""
    saved = torch.float32, torch.float, torch.Tensor.float, \
        torch.get_default_dtype()
    torch.float32 = torch.float = torch.float64
    torch.Tensor.float = torch.Tensor.double
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.float32, torch.float, torch.Tensor.float = saved[:3]
        torch.set_default_dtype(saved[3])


_FLOAT32, _TENSOR_FLOAT = torch.float32, torch.Tensor.float


def widen(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` in float64: its tensors (``.double()``) and every float32
    compute dtype its submodules fixed when they were built (``cdtype``:
    the BatchNorms of the sparse encoders, their convs), so that under
    ``float64_port`` no float32 island is left."""
    module = module.double()
    for m in module.modules():
        for name, v in list(vars(m).items()):
            if v is _FLOAT32:
                setattr(m, name, torch.float64)
    return module


@contextlib.contextmanager
def float64_jax(*modules):
    """While the JAX package traces inside the block (under
    ``jax.enable_x64``), the float32 that each of its ``modules`` names
    (``jnp.float32``: casts, ``preferred_element_type``) is float64, as the
    port's is under ``float64_port``. Default: ``models/layers.py``, whose
    ``MaskedBatchNorm`` (the VFEs' BatchNorm) takes its statistics
    ``E[x^2] - E[x]^2`` in float32 for bf16 safety. Left in float32, such
    a module's rounding follows XLA:CPU's fusion of its sums (compiled or
    eager, the host's vector width) and can flip a ReLU downstream."""
    import jax.numpy as jnp

    from isfusion_tpu.models import layers

    class _Wide:
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    saved = [(m, m.jnp) for m in (modules or (layers,))]
    for m, _ in saved:
        m.jnp = _Wide()
    try:
        yield
    finally:
        for m, jnp_ in saved:
            m.jnp = jnp_


def float64_choices(port: torch.nn.Module, run, *args):
    """The discrete choices (``testing.pinned_choices``: ReLU signs, top-k,
    NMS) of ``run(module, *args)`` on a float64 copy of ``port`` (``widen``,
    ``float64_port``; float numpy arrays and tensors among ``args``, or
    inside a dict of them, widened; voxel coordinates computed in float32
    from the same points). A float32 run given them takes the
    exact function's choices: where a ReLU input lies within float32
    rounding of 0, the side it falls on depends on the order of the host's
    sums (its vector width, its threads), so an unpinned float32 run
    matches the JAX package on one kind of machine and not on another."""
    import copy

    from isfusion_tpu_torch.testing import pinned_choices

    def wide(v):
        if isinstance(v, dict):
            return {k: wide(x) for k, x in v.items()}
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            return v.astype(np.float64)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.detach().double()
        return v

    from isfusion_tpu_torch.ops import voxel

    real_coords = voxel.compute_voxel_coords

    def coords(points, *rest):
        # voxel coordinates are the float32 data's own (the JAX package's
        # arithmetic): the float64 run voxelizes the same points alike
        inside = torch.float32, torch.float, torch.Tensor.float
        torch.float32 = torch.float = _FLOAT32
        torch.Tensor.float = _TENSOR_FLOAT
        try:
            return real_coords(points.to(_FLOAT32), *rest)
        finally:
            torch.float32, torch.float, torch.Tensor.float = inside

    model = widen(copy.deepcopy(port))
    voxel.compute_voxel_coords = coords
    try:
        with float64_port(), pinned_choices() as rec:
            run(model, *[wide(a) for a in args])
    finally:
        voxel.compute_voxel_coords = real_coords
    return rec


def lidar_variant_case(name: str, reflectance: bool = True,
                       pin_float64: bool = False) -> dict:
    """A tiny ``flagship.LIDAR_VARIANTS`` detector on both sides from one
    batch (2 samples; ``reflectance``: intensity in [0, 1), else the raw
    0-255): JAX variables drawn with numpy and carried (strict); the JAX
    head outputs and decode (eval) and the losses and gradients (train,
    batch statistics) in one jitted call; the port's head outputs and
    predict in eval mode, its losses and gradients in train mode. With
    ``pin_float64`` the port's train forward takes the discrete choices
    (ReLU signs) of a float64 run of itself (``testing.pinned_choices``;
    their report under ``pins``)."""
    import copy

    from isfusion_tpu_torch.testing import pinned_choices

    import jax.numpy as jnp

    from isfusion_tpu.models import build_detector as jbuild_detector
    from isfusion_tpu.parallel.train_step import total_loss
    from isfusion_tpu_torch import flagship
    from isfusion_tpu_torch.models.builder import build_detector

    cfg = flagship.lidar_variant_model_cfg(name)
    _, batch_fn = flagship.build_lidar_variant(name, device="cpu")
    batch = batch_fn(2, seed=1, reflectance=reflectance)
    jcfg = jax_cfg(cfg)
    jmodel = jbuild_detector(jcfg)
    head = "bbox_head_m" if "bbox_head" in jcfg else "pts_bbox_head_m"
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(jmodel, jbatch, train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))

    def loss_fn(params, bs):
        losses, _ = jmodel.apply({"params": params, "batch_stats": bs},
                                 jbatch, train=True, mode="loss",
                                 mutable=["batch_stats"])
        return total_loss(losses), losses

    def run(v):
        feats = jmodel.apply(v, jbatch, train=False, mode="feats")
        decoded = jmodel.apply(v, feats, method=lambda m, p: getattr(
            m, head).get_bboxes(p))
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"], v.get("batch_stats", {}))
        return feats, decoded, losses, grads

    compiled = jax.jit(run).lower(variables).compile(OPTIMIZED_XLA)
    feats, decoded, jl, jg = compiled(variables)
    port.eval()
    got_feats = port(batch, mode="feats", device="cpu")
    got_pred = port(batch, device="cpu")
    pins = None
    if pin_float64:
        wide = copy.deepcopy(port).double().train()
        wide_batch = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
                      for k, v in batch.items()}
        with float64_port(), pinned_choices() as pins:
            wide(wide_batch, mode="loss", device="cpu",
                 generator=torch.Generator().manual_seed(0))
    trained = copy.deepcopy(port).train()
    with pinned_choices(pins) if pins else contextlib.nullcontext() as pin:
        tl = trained(batch, mode="loss", device="cpu",
                     generator=torch.Generator().manual_seed(0))
        sum(v for k, v in tl.items() if "loss" in k).backward()
    return dict(feats=feats, decoded=decoded, got_feats=got_feats,
                got_pred=got_pred, jl={k: float(v) for k, v in jl.items()},
                jg=state_dict_from_jax({"params": jax.device_get(jg)}),
                trained=trained, pins=pin,
                tl={k: float(v.detach()) for k, v in tl.items()})


def assert_same_kept_boxes(got: dict, want: dict, tol: float = 1e-4,
                           tie: float = 1e-5):
    """Decoded boxes (``bboxes``, ``scores``, ``labels``, ``mask``; (B, K,
    ...) numpy) equal: the same mask; each kept box matched to its
    nearest kept box of the other side with the same label (one to one,
    boxes and scores within ``tol`` of their max); a box may sit at
    another position only among scores within ``tie`` of their max (two
    nearly equal scores in either order)."""
    mask = np.asarray(want["mask"])
    np.testing.assert_array_equal(np.asarray(got["mask"]), mask)
    for b in range(mask.shape[0]):
        m = mask[b]
        wb, gb = [np.concatenate([np.asarray(d["bboxes"])[b][m],
                                  np.asarray(d["scores"])[b][m][:, None]],
                                 -1).astype(np.float64)
                  for d in (want, got)]
        wl, gl = np.asarray(want["labels"])[b][m], \
            np.asarray(got["labels"])[b][m]
        if not len(wb):
            continue
        scale = np.array([max(np.abs(wb[:, :-1]).max(), 1e-12),
                          max(np.abs(wb[:, -1]).max(), 1e-12)])
        diff = np.abs(wb[:, None] - gb[None])
        dist = np.maximum(diff[..., :-1].max(-1) / scale[0],
                          diff[..., -1] / scale[1])
        dist[wl[:, None] != gl[None]] = np.inf
        match = dist.argmin(1)
        assert len(set(match.tolist())) == len(match), "not one to one"
        assert dist[np.arange(len(match)), match].max() <= tol
        moved = match != np.arange(len(match))
        s = wb[:, -1]
        assert (np.abs(s[moved] - s[match[moved]]) <= tie * scale[1]).all()


def check_variant_outputs(case):
    """A ``lidar_variant_case``: head outputs 1e-3 of their max, the kept
    boxes as ``assert_same_kept_boxes``."""
    got = dict(tree_leaves(case["got_feats"]))
    want = {k: np.asarray(v) for k, v in tree_leaves(case["feats"])}
    assert set(got) == set(want) and got
    for k, w in want.items():
        assert_close_to_max(got[k].numpy(), w, 1e-3)
    assert np.asarray(case["decoded"]["mask"]).sum() >= 8
    assert_same_kept_boxes({k: v.numpy() for k, v in case[
        "got_pred"].items()}, case["decoded"])


def check_variant_gradients(case):
    """A ``lidar_variant_case``: loss terms 1e-4 relative, each top-level
    module's gradient 1e-3 of its max."""
    jl, tl = case["jl"], case["tl"]
    assert set(tl) == set(jl) and len(jl) >= 3
    for k in jl:
        assert abs(tl[k] - jl[k]) <= 1e-4 * max(abs(jl[k]), 1e-12), k
    jg, port = case["jg"], case["trained"]
    tops = sorted({n.split(".")[0] for n, p in port.named_parameters()})
    for top in tops:
        got, want = [], []
        for name, p in port.named_parameters():
            if name.split(".")[0] == top:
                want.append(jg[name].numpy().ravel())
                got.append(p.grad.numpy().ravel())
        want = np.concatenate(want)
        assert np.abs(want).max() > 0, top
        assert_close_to_max(np.concatenate(got), want, 1e-3)


def anchor_family_case(cfg: dict, batch: dict, optim: dict,
                       variables=None) -> dict:
    """A tiny PointPillars-family detector (SSN, FreeAnchor: an
    ``MVXFasterRCNN`` config of the port) on both sides from one numpy
    batch: JAX variables drawn with numpy (or ``variables``) and carried
    (strict). The JAX side in one call compiled at XLA:CPU level 1 (as
    ``lidar_variant_case``; these detectors' gradients there equal their
    eager trace's within 2e-5 of their max): head outputs and predict
    (eval), loss terms and gradients (train, batch statistics), and one
    step of ``optim``'s optimizer (``runner/optim.py:build_optimizer``:
    clip, then AdamW). The port: the same in eval mode, loss terms and
    gradients in train mode, and one ``make_train_step`` from the carried
    weights."""
    import copy

    import jax.numpy as jnp
    import optax

    from isfusion_tpu.models import build_detector as jbuild_detector
    from isfusion_tpu.parallel.train_step import total_loss
    from isfusion_tpu.runner import optim as joptim
    from isfusion_tpu_torch.models.builder import build_detector
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner import optim as toptim

    jmodel = jbuild_detector(jax_cfg(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if variables is None:
        variables = random_variables(jmodel, jbatch, train=False,
                                     mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    port.eval()
    opt_cfg, opt_conf, lr_cfg = (optim["optimizer"],
                                 optim["optimizer_config"],
                                 optim["lr_config"])
    tx = joptim.build_optimizer(variables["params"], opt_cfg, opt_conf,
                                lr_cfg, None, total_steps=100)

    def loss_fn(params, bs):
        losses, _ = jmodel.apply({"params": params, "batch_stats": bs},
                                 jbatch, train=True, mode="loss",
                                 mutable=["batch_stats"])
        return total_loss(losses), losses

    def run(v):
        feats = jmodel.apply(v, jbatch, train=False, mode="feats")
        decoded = jmodel.apply(v, jbatch, train=False, mode="predict")
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"], v["batch_stats"])
        updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
        return feats, decoded, losses, grads, optax.apply_updates(
            v["params"], updates)

    feats, decoded, jl, jg, after = jax.jit(run).lower(variables).compile(
        OPTIMIZED_XLA)(variables)
    got_feats = port(batch, mode="feats", device="cpu")
    got_pred = port(batch, device="cpu")
    trained = copy.deepcopy(port).train()
    tl = trained(batch, mode="loss", device="cpu")
    sum(v for k, v in tl.items() if "loss" in k).backward()
    stepped = copy.deepcopy(port).train()
    opt = toptim.build_optimizer(stepped, opt_cfg)
    tm = make_train_step(stepped, opt, toptim.build_schedule(
        opt, lr_cfg, None, 100), toptim.grad_clip_norm(opt_conf))(
            batch, torch.Generator().manual_seed(0))
    return dict(feats=feats, decoded=decoded, got_feats=got_feats,
                got_pred=got_pred, jl={k: float(v) for k, v in jl.items()},
                jg=state_dict_from_jax({"params": jax.device_get(jg)}),
                trained=trained, tl={k: float(v.detach())
                                     for k, v in tl.items()},
                before=port.state_dict(), stepped=stepped,
                tm={k: float(v) for k, v in tm.items()},
                jafter=state_dict_from_jax({"params": jax.device_get(
                    after)}))


def check_step(case, lr: float, grad_clip: float):
    """An ``anchor_family_case``'s optimizer step: the clipped gradient's
    norm 1e-4 relative; each parameter's update within 1e-2 of the lr
    (Adam's first update is ~lr * sign(g)) where its gradient is above
    1e-4 of its tensor's max and its clipped value far above Adam's eps;
    a parameter whose gradient is exactly 0 everywhere moves by weight
    decay alone on both sides."""
    jg, before, jafter = case["jg"], case["before"], case["jafter"]
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in jg.values()))
    assert abs(case["tm"]["grad_norm"] - norm) <= 1e-4 * norm
    clip = min(1.0, grad_clip / norm)
    checked = 0
    for name, p in case["stepped"].named_parameters():
        g = jg[name].numpy()
        b = before[name].numpy()
        d_port = p.detach().numpy() - b
        d_jax = jafter[name].numpy() - b
        sel = (np.abs(g) > 1e-4 * np.abs(g).max()) & \
            (np.abs(g) * clip > 100 * 1e-8)
        if not g.any():
            sel = np.ones_like(g, bool)
        tol = 1e-2 * lr + 2 * np.spacing(np.abs(b[sel]))
        assert (np.abs(d_port[sel] - d_jax[sel]) <= tol).all(), name
        checked += int(sel.sum())
    return checked


def indoor_variant_case(cfg: dict, batch: dict, optim: dict, widen=(),
                        positives: bool = False) -> dict:
    """A tiny indoor point detector (SSD3DNet, GroupFree3DNet, ImVoteNet:
    a port config whose JAX twin is ``jax_cfg(cfg)``) on both sides from
    one numpy batch, JAX variables drawn with numpy and carried (strict).
    ``positives``: the GT boxes first moved onto the port's train-mode
    proposals (``testing.indoor_positives``: a VoteHead's box terms need
    them). The JAX side compiled at XLA:CPU level 1: head outputs, predict
    and loss terms in float32 (one call), then the gradients and one step
    of ``optim``'s optimizer (clip, then AdamW) in float64 (a second call:
    ``jax.enable_x64`` with the JAX modules ``widen`` computing their
    float32 casts in float64, ``float64_jax``; the points stay float32),
    so that a ReLU input within float32 rounding of 0 cannot move the
    reference by the host's sum order. The port: the same outputs in eval
    mode, the loss terms and gradients in train mode, one
    ``make_train_step`` from the carried weights. A JAX VoteHead's joint
    prediction layer is split as the port's ``ConvPred`` splits it."""
    import copy

    import jax.numpy as jnp
    import optax

    from isfusion_tpu.models import build_detector as jbuild_detector
    from isfusion_tpu.parallel.train_step import total_loss
    from isfusion_tpu.runner import optim as joptim
    from isfusion_tpu_torch.models.builder import build_detector
    from isfusion_tpu_torch.models.dense_heads.vote_head import (
        ConvPred, split_joint_pred)
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner import optim as toptim
    from isfusion_tpu_torch.testing import indoor_positives

    jmodel = jbuild_detector(jax_cfg(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(jmodel, jbatch, train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    port.eval()
    if positives:
        batch = indoor_positives(port, batch, "cpu")
    opt_cfg, opt_conf, lr_cfg = (optim["optimizer"],
                                 optim["optimizer_config"],
                                 optim["lr_config"])

    def loss_fn(params, bs, jb):
        losses, _ = jmodel.apply({"params": params, "batch_stats": bs}, jb,
                                 train=True, mode="loss",
                                 mutable=["batch_stats"])
        return total_loss(losses), losses

    def run(v, jb):
        return (jmodel.apply(v, jb, train=False, mode="feats"),
                jmodel.apply(v, jb, train=False, mode="predict"),
                loss_fn(v["params"], v["batch_stats"], jb)[1])

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    feats, decoded, jl = jax.device_get(jax.jit(run).lower(
        variables, jbatch).compile(OPTIMIZED_XLA)(variables, jbatch))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64))
            if np.asarray(x).dtype.kind == "f" else jnp.asarray(x),
            jax.device_get(variables))
        b64 = {k: jnp.asarray(v.astype(np.float64) if v.dtype.kind == "f"
                              and k != "points" else v)
               for k, v in batch.items()}
        tx = joptim.build_optimizer(v64["params"], opt_cfg, opt_conf,
                                    lr_cfg, None, total_steps=100)

        def step(v, jb):
            grads = jax.grad(lambda p: loss_fn(p, v["batch_stats"], jb)[0])(
                v["params"])
            updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
            return grads, optax.apply_updates(v["params"], updates)

        with float64_jax(*widen):
            lowered = jax.jit(step).lower(v64, b64)
        jg, after = jax.device_get(lowered.compile(OPTIMIZED_XLA)(v64, b64))
    jg, jafter = (state_dict_from_jax({"params": t}) for t in (jg, after))
    for name, mod in port.named_modules():
        if isinstance(mod, ConvPred):
            for sd in (jg, jafter):
                split_joint_pred(sd, f"{name}.", mod.num_reg)
    got_feats = port(batch, mode="feats", device="cpu")
    got_pred = port(batch, device="cpu")
    trained = copy.deepcopy(port).train()
    tl = trained(batch, mode="loss", device="cpu")
    sum(tl.values()).backward()
    stepped = copy.deepcopy(port).train()
    opt = toptim.build_optimizer(stepped, opt_cfg)
    tm = make_train_step(stepped, opt, toptim.build_schedule(
        opt, lr_cfg, None, 100), toptim.grad_clip_norm(opt_conf))(
            batch, torch.Generator().manual_seed(0))
    return dict(feats=feats, decoded=decoded, got_feats=got_feats,
                got_pred=got_pred, jl={k: float(v) for k, v in jl.items()},
                jg=jg, jafter=jafter, trained=trained,
                tl={k: float(v.detach()) for k, v in tl.items()},
                before=port.state_dict(), stepped=stepped,
                tm={k: float(v) for k, v in tm.items()}, batch=batch)


def check_indoor_outputs(case, index_keys=()) -> None:
    """An ``indoor_variant_case``'s head outputs in float32: masks and
    ``index_keys`` equal, the rest within 1e-4 of their max."""
    got, want = case["got_feats"], case["feats"]
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if not torch.is_tensor(g):
            assert g == w, key
        elif g.dtype == torch.bool or key in index_keys:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), key)
        else:
            assert_close_to_max(g.numpy(), np.asarray(w), 1e-4)


def check_indoor_predict(case) -> None:
    """Predict: mask and labels equal, boxes and scores within 1e-4 of
    their max."""
    gp, wp = case["got_pred"], case["decoded"]
    for key in ("mask", "labels"):
        np.testing.assert_array_equal(gp[key].numpy(), np.asarray(wp[key]))
    for key in ("bboxes", "scores"):
        assert_close_to_max(gp[key].numpy(), np.asarray(wp[key]), 1e-4)


def check_indoor_losses(case, names) -> None:
    """The loss terms are ``names``, each within 1e-4 relative or 1e-7
    absolute (a term near 0, such as a direction residual of few
    positives, keeps float32's absolute error), at least one above 0."""
    jl, tl = case["jl"], case["tl"]
    assert set(tl) == set(jl) == set(names)
    for k in jl:
        assert abs(tl[k] - jl[k]) <= max(1e-4 * abs(jl[k]), 1e-7), \
            (k, tl[k], jl[k])
    assert max(jl.values()) > 0


def check_indoor_gradients(case, tops) -> None:
    """Each module under ``tops`` (prefixes of the parameter names): its
    gradient within 1e-3 of the max of JAX's float64 gradient, which is
    not 0. A parameter the loss does not reach (a ResNet stage after the
    sampled one) has no port gradient and a JAX gradient of 0."""
    params = dict(case["trained"].named_parameters())
    assert {n.split(".")[0] for n in params} == {t.split(".")[0]
                                                for t in tops}
    for top in tops:
        names = [n for n in params if n.startswith(top)]
        assert names, top
        want = np.concatenate([case["jg"][n].numpy().ravel() for n in names])
        got = np.concatenate([np.zeros(params[n].numel(), np.float32)
                              if params[n].grad is None else
                              params[n].grad.numpy().ravel()
                              for n in names])
        assert np.abs(want).max() > 0, top
        assert_close_to_max(got, want, 1e-3)


def check_indoor_step(case, lr: float, grad_clip: float) -> None:
    """The step as ``check_step`` over the parameters with a gradient; the
    others stay as they were in the port, whose AdamW skips them, where
    optax decays them (ROADMAP queue 3, settled)."""
    params = dict(case["trained"].named_parameters())
    dead = {n for n, p in params.items() if p.grad is None}
    stepped = dict(case["stepped"].named_parameters())
    for n in dead:
        assert not case["jg"][n].numpy().any(), n
        assert torch.equal(stepped[n], case["before"][n]), n

    class _Live:
        @staticmethod
        def named_parameters():
            return [(n, p) for n, p in stepped.items() if n not in dead]

    assert check_step(dict(case, stepped=_Live), lr, grad_clip) > 1000
