"""The port's data-parallel slice on the CPU: two ranks spawned under gloo
(``tests/torch_dp_workers.py``, which imports no JAX) run every case once,
while this process runs the JAX package and the one-process references.

- the loader's rank slices against the JAX ``DataLoader._indices``;
- the sync norms (NHWC ``BatchNorm``, ``MaskedBatchNorm`` with unequal
  valid counts, the sparse encoder's active-site ``BatchNorm``) against
  the JAX ``nn.BatchNorm`` / ``MaskedBatchNorm(axis_name='data')`` under
  ``shard_map`` on 2 of the 8 virtual devices, and against the port's
  one-process norm over the concatenated rows;
- the tiny flagship's DP step: identical halves with every norm plain
  equal bit for bit to the one-card step; identical halves with the
  config's synced VFE norm equal bit for bit to the one-card step whose
  sync norm takes the pooled sums (``testing.pooled_sync_norms``; one
  card's ``F.batch_norm`` statistics differ from those sums in float32
  rounding, which the module tests above bound at 1e-5); distinct halves
  (plain norms) against the mean of the ranks' one-card losses and
  gradients, then clip + AdamW;
- the tiny PointPillars' DP step (plain norms: the JAX detectors do not
  bind their sync norms to the mesh) against the JAX mesh step on the
  same weights and global batch, compiled at XLA:CPU backend level 1
  (``torch_parity.OPTIMIZED_XLA``), with SGD(lr 1) after the recipe's
  clip so that the update is the averaged gradient;
- the gathered eval of a ragged batch against ``single_device_test``;
- ``train_model`` at world 2, resumed after epoch 1, against the
  uninterrupted run, and the checkpoint's rank count.

Tolerances (float32): loader order exact; sync norms 1e-5 of the max;
the flagship's identical halves and the masked norm's identical halves
bit for bit; the per-rank oracle and the JAX mesh step: losses 1e-4
relative, gradients and updated parameters 1e-3 of the max; the
gathered eval and the resumed run equal.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from jax import shard_map
from jax.sharding import PartitionSpec as P

from isfusion_tpu.datasets.builder import DataLoader as JaxDataLoader
from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.models.layers import MaskedBatchNorm as JaxMaskedBN
from isfusion_tpu.parallel import TrainState, create_mesh
from isfusion_tpu.parallel import shard_batch as jshard_batch
from isfusion_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.apis import single_device_test
from isfusion_tpu_torch.datasets.builder import EpochBatchSampler
from isfusion_tpu_torch.models.layers import BatchNorm, MaskedBatchNorm
from isfusion_tpu_torch.runner import optim
from isfusion_tpu_torch.runner.checkpoint import load_checkpoint
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from isfusion_tpu_torch.testing import pooled_sync_norms, tame_box_deltas
from isfusion_tpu_torch.tools import make_synthetic_nuscenes as tgen
import torch_dp_workers as workers
from torch_parity import (OPTIMIZED_XLA, assert_close_to_max, jax_cfg,
                          random_variables)

WORLD = 2


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


# ------------------------------------------------------------ the loader
class _Samples:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass


@pytest.mark.parametrize("ranks", [2, 3])
def test_rank_slices_are_the_jax_global_batches(ranks):
    n, spg = 23, 3
    jax_loader = JaxDataLoader(_Samples(n), batch_size=spg * ranks,
                               shuffle=True, seed=7)
    samplers = [EpochBatchSampler(n, spg, True, 7, True, r, ranks)
                for r in range(ranks)]
    for epoch in range(2):
        jax_loader.set_epoch(epoch)
        idx = jax_loader._indices()
        want = [idx[i:i + spg * ranks].tolist()
                for i in range(0, len(idx), spg * ranks)]
        for s in samplers:
            s.epoch = epoch
        got = [sum(rows, []) for rows in zip(*samplers)]
        assert got == want and len(want) >= 1
        assert all(len(s) == len(jax_loader) == len(want)
                   for s in samplers)


def test_init_distributed_raises_instead_of_running_alone(monkeypatch):
    from isfusion_tpu_torch.parallel.mesh import TORCHRUN_ENV, \
        init_distributed, world
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_distributed("gloo", "cpu")
    for k, v in zip(TORCHRUN_ENV, ("0", "1", "0", "localhost", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="nccl"):
        init_distributed("nccl", "cpu")
    assert world() == (0, 1)


def test_shard_batch_takes_each_ranks_rows():
    from isfusion_tpu_torch.parallel.mesh import shard_batch
    batch = dict(points=np.arange(12).reshape(6, 2),
                 gt=torch.arange(6), img_metas=list("abcdef"))
    got = [shard_batch(batch, r, 3) for r in range(3)]
    assert [g["img_metas"] for g in got] == [["a", "b"], ["c", "d"],
                                              ["e", "f"]]
    assert torch.equal(got[2]["gt"], torch.tensor([4, 5]))
    np.testing.assert_array_equal(got[1]["points"], [[4, 5], [6, 7]])
    with pytest.raises(ValueError, match="split"):
        shard_batch(batch, 0, 4)


# ------------------------------------------------- the ranks, spawned once
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the ranks with every case, then (while they run) the JAX
    side and the one-process references; returns both."""
    work = str(tmp_path_factory.mktemp("dp"))
    data = os.path.join(work, "data")
    tgen.make_dataset(data, train=4, val=2, points=2048, img_hw=(16, 32),
                      seed=0, classes=["car", "pedestrian"])
    # the LiDAR detector: JAX variables drawn with numpy, carried across
    cfg = workers.plain_norms(tflagship.pointpillars_model_cfg(tiny=True))
    _, pp_batch_fn = tflagship.build_pointpillars_flagship(tiny=True,
                                                           device="cpu")
    pp_batch = pp_batch_fn(4, seed=4)
    jmodel = jbuild_detector(jax_cfg(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in pp_batch.items()}
    variables = random_variables(jmodel, jbatch, train=False, mode="feats")
    variables["params"]["pts_bbox_head_m"]["conv_reg"]["kernel"] *= 0.01
    eval_batches = [pp_batch_fn(4, seed=1), pp_batch_fn(3, seed=2)]
    ctx = workers.run_ranks(dict(
        bn=None, flagship=None,
        lidar=dict(state_dict=state_dict_from_jax(variables),
                   batch=pp_batch),
        eval=dict(seed=0, batches=eval_batches),
        train_model=dict(data=data, work=os.path.join(work, "a"),
                         resumed=os.path.join(work, "b"))), WORLD, work)
    try:
        ref = dict(bn=_jax_bn(), lidar=_jax_mesh_step(jmodel, variables,
                                                      pp_batch),
                   one_card=_one_card_steps(),
                   eval=_one_process_eval(eval_batches))
    finally:
        while not ctx.join():
            pass
    return workers.rank_results(work, WORLD), ref, work, data


def test_ranks_import_no_jax(run):
    ranks, _, _, _ = run
    assert [r["jax_loaded"] for r in ranks] == [[]] * WORLD


# -------------------------------------------------------------- sync BN
def _jax_bn():
    """Each sync norm under shard_map on 2 devices: outputs, gradients of
    sum(out * ct) (input rows, scale, bias) and the batch statistics."""
    inp = workers.bn_inputs()
    mesh = create_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    c = 8
    variables = {"params": {"scale": inp["weight"], "bias": inp["bias"]},
                 "batch_stats": {"mean": inp["running_mean"],
                                 "var": inp["running_var"]}}

    def run(module, x, ct, *mask):
        def local(params, xs, *ms):
            out, mut = module.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                xs, *ms, train=True, mutable=["batch_stats"]) \
                if isinstance(module, JaxMaskedBN) else module.apply(
                    {"params": params,
                     "batch_stats": variables["batch_stats"]},
                    xs, mutable=["batch_stats"])
            return out, mut["batch_stats"]

        f = shard_map(local, mesh=mesh,
                      in_specs=(P(),) + (P("data"),) * (1 + len(mask)),
                      out_specs=(P("data"), P()), check_vma=False)

        def loss(params, xs):
            out, stats = f(params, xs, *mask)
            return jnp.sum(out * ct), (out, stats)

        (_, (out, stats)), (dp, dx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(variables["params"], x)
        return dict(y=np.asarray(out), dx=np.asarray(dx),
                    dw=np.asarray(dp["scale"]), db=np.asarray(dp["bias"]),
                    running_mean=np.asarray(stats["mean"]),
                    running_var=np.asarray(stats["var"]))

    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                            epsilon=workers.BN_EPS, axis_name="data")
    masked = JaxMaskedBN(momentum=workers.BN_MOMENTUM,
                         epsilon=workers.BN_EPS, axis_name="data")
    n = max(len(s) for s in inp["sites"])
    sites = np.zeros((WORLD, n, c), np.float32)
    sites_ct = np.zeros_like(sites)
    site_mask = np.zeros((WORLD, n), bool)
    for r, (s, ct) in enumerate(zip(inp["sites"], inp["sites_ct"])):
        sites[r, :len(s)], sites_ct[r, :len(s)] = s, ct
        site_mask[r, :len(s)] = True
    # flax BatchNorm names its variables scale / bias / mean / var as well
    return dict(
        nhwc=run(flax_bn, inp["nhwc"], inp["nhwc_ct"]),
        masked=run(masked, inp["padded"], inp["padded_ct"], inp["mask"]),
        sites=run(masked, sites, sites_ct, site_mask), site_mask=site_mask)


def _one_process(kind, inp, x, ct, mask=None):
    return workers.run_bn(workers.make_bn(kind, inp, sync=False), x, ct,
                          mask)


def _unbiased(inp, jax_var, count):
    """The port's running variance from flax's (biased) one: the batch
    term scaled by count / (count - 1)."""
    keep = (1 - workers.BN_MOMENTUM) * inp["running_var"]
    return keep + (jax_var - keep) * count / (count - 1)


def _gathered(ranks, case, key):
    got = [r["bn"][case][key] for r in ranks]
    if key in ("dw", "db"):
        return np.sum(got, 0)        # the global loss's gradient
    if key in ("y", "dx"):
        return np.concatenate(got)
    return got[0]


@pytest.mark.parametrize("case", ["nhwc", "masked", "sites"])
@pytest.mark.parametrize("key", ["y", "dx", "dw", "db", "running_mean",
                                 "running_var"])
def test_sync_bn_matches_jax_shard_map(run, case, key):
    ranks, ref, _, _ = run
    inp = workers.bn_inputs()
    want = ref["bn"][case][key]
    got = _gathered(ranks, case, key)
    if case == "sites" and key in ("y", "dx"):
        m = ref["bn"]["site_mask"]
        want = np.concatenate([want[r][m[r]] for r in range(WORLD)])
    if key == "running_var" and case != "masked":
        count = 4 * 3 * 5 if case == "nhwc" else sum(
            len(s) for s in inp["sites"])
        want = _unbiased(inp, want, count)
    for r in ranks:         # every rank holds the pooled statistics
        if key.startswith("running"):
            np.testing.assert_array_equal(r["bn"][case][key], got)
    assert_close_to_max(got, want, 1e-5)


@pytest.mark.parametrize("case", ["nhwc", "masked", "sites"])
@pytest.mark.parametrize("key", ["y", "dx", "dw", "db", "running_mean",
                                 "running_var"])
def test_sync_bn_matches_one_process_norm(run, case, key):
    ranks, _, _, _ = run
    inp = workers.bn_inputs()
    if case == "nhwc":
        want = _one_process(BatchNorm, inp, inp["nhwc"], inp["nhwc_ct"])
    elif case == "masked":
        want = _one_process(MaskedBatchNorm, inp, inp["padded"],
                            inp["padded_ct"], inp["mask"])
    else:
        want = _one_process(BatchNorm, inp, np.concatenate(inp["sites"]),
                            np.concatenate(inp["sites_ct"]))
    got = _gathered(ranks, case, key)
    assert_close_to_max(got, want[key], 1e-5)


def test_masked_sync_bn_identical_halves_bit_equal(run):
    ranks, _, _, _ = run
    inp = workers.bn_inputs()
    want = _one_process(MaskedBatchNorm, inp, inp["padded"][:2],
                        inp["padded_ct"][:2], inp["mask"][:2])
    for r in ranks:
        for k, w in want.items():
            np.testing.assert_array_equal(r["bn"]["masked_same"][k], w, k)


# ------------------------------------------------- the tiny flagship step
def _one_card_steps():
    """The one-card step of the tiny flagship, every norm plain and with
    the config's norms (taking the pooled sums), on the first half of the
    global batch, in the ranks' CPU state (threads, deterministic
    kernels)."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    threads = torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(workers.THREADS)
    try:
        out = {}
        for name, sync in (("plain", False), ("synced", True)):
            model, batch = workers.tiny_flagship(sync=sync)
            rows = {}

            def count(mod, args, rows=rows):
                name = names[mod]
                rows.setdefault(name, args[0].shape[0])

            names = {m: n for n, m in model.pts_voxel_encoder.named_modules()
                     if isinstance(m, BatchNorm)}
            for m in names:
                m.register_forward_pre_hook(count)
            half = workers.shard_batch(workers._numpy(batch), 0, WORLD)
            with pooled_sync_norms():
                out[name] = dict(workers.take_step(model, half),
                                 vfe_rows=rows)
        return out
    finally:
        torch.use_deterministic_algorithms(deterministic)
        torch.set_num_threads(threads)


def _assert_steps_close(got, want, loss_keys):
    for k in loss_keys:
        assert _rel(got["metrics"][k], want[k]) <= 1e-4, k
    assert set(got["grads"]) == set(want["grads"]) and want["grads"]
    for key in ("grads", "params"):
        for name, w in want[key].items():
            assert_close_to_max(got[key][name].numpy(), w.numpy(), 1e-3)


@pytest.mark.parametrize("norms", ["plain", "synced"])
def test_identical_halves_bit_equal_one_card(run, norms):
    ranks, ref, _, _ = run
    one = ref["one_card"][norms]
    for r in ranks:
        dp = r["flagship"][f"same_{norms}"]
        assert dp["metrics"] == one["metrics"]
        for key in ("params", "grads", "buffers"):
            assert set(dp[key]) == set(one[key]) and one[key]
            for name, t in one[key].items():
                if key == "buffers" and "pts_voxel_encoder" in name and \
                        "running_var" in name and norms == "synced":
                    continue    # unbiased by the global count: below
                assert torch.equal(dp[key][name], t), (key, name)


def test_identical_halves_synced_running_var_counts_both_ranks(run):
    """The synced VFE norms' running variance takes the batch variance
    unbiased by the global count: 2c rows where one card has c."""
    ranks, ref, _, _ = run
    one = ref["one_card"]["synced"]
    mom = workers.BN_MOMENTUM
    assert len(one["vfe_rows"]) == 2
    for mod_name, c in one["vfe_rows"].items():
        key = f"pts_voxel_encoder.{mod_name}.running_var"
        biased = (one["buffers"][key].double() - (1 - mom)) / mom * \
            (c - 1) / c
        want = (1 - mom) + mom * biased * 2 * c / (2 * c - 1)
        for r in ranks:
            got = r["flagship"]["same_synced"]["buffers"][key].double()
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-6)


def test_distinct_halves_equal_mean_of_ranks_then_clip_adamw(run):
    ranks, _, _, _ = run
    oracle = ranks[0]["flagship"]["distinct_oracle"]
    want = dict(oracle["losses"], grads=oracle["grads"],
                params=oracle["params"])
    for r in ranks:
        got = r["flagship"]["distinct_dp"]
        _assert_steps_close(got, want, list(oracle["losses"]))
        assert _rel(got["metrics"]["grad_norm"], oracle["grad_norm"]) <= 1e-4
    for name, t in ranks[0]["flagship"]["distinct_dp"]["params"].items():
        assert torch.equal(ranks[1]["flagship"]["distinct_dp"]["params"][
            name], t), name


# ------------------------------------- the LiDAR detector's JAX mesh step
def _jax_mesh_step(jmodel, variables, batch):
    clip = optim.grad_clip_norm(tflagship.pointpillars_optim_cfg()[
        "optimizer_config"])
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.sgd(1.0))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              tx)
    mesh = create_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    step = jmake_train_step(jmodel, tx, mesh=mesh, donate=False)
    sbatch = jshard_batch({k: np.asarray(v) for k, v in batch.items()},
                          mesh)
    rng = jax.random.PRNGKey(0)
    compiled = step.lower(state, sbatch, rng).compile(OPTIMIZED_XLA)
    new_state, metrics = compiled(state, sbatch, rng)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                before=state_dict_from_jax({"params": jax.device_get(
                    state.params)}),
                after=state_dict_from_jax({"params": jax.device_get(
                    new_state.params)}))


def test_lidar_dp_step_matches_jax_mesh_step(run):
    ranks, ref, _, _ = run
    want = ref["lidar"]
    for r in ranks:
        got = r["lidar"]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            assert _rel(got["metrics"][k], v) <= 1e-4, k
        tops = sorted({n.split(".")[0] for n in got["params"]})
        for top in tops:
            # SGD(lr 1): the update is the clipped, averaged gradient
            d_got = np.concatenate([(want["before"][n] - p).numpy().ravel()
                                    for n, p in got["params"].items()
                                    if n.split(".")[0] == top])
            d_want = np.concatenate([
                (want["before"][n] - want["after"][n]).numpy().ravel()
                for n in got["params"] if n.split(".")[0] == top])
            assert np.abs(d_want).max() > 0, top
            assert_close_to_max(d_got, d_want, 1e-3)
            g = np.concatenate([got["grads"].get(
                n, torch.zeros_like(p)).numpy().ravel()
                for n, p in got["params"].items() if n.split(".")[0] == top])
            assert_close_to_max(g, d_want, 1e-3)


# ------------------------------------------------------- the gathered eval
def _one_process_eval(batches):
    model, _ = tflagship.build_pointpillars_flagship(tiny=True, device="cpu",
                                                     seed=0)
    tame_box_deltas(model)
    return single_device_test(model, batches, device="cpu")


def test_gathered_eval_of_a_ragged_batch_equals_single_device_test(run):
    ranks, ref, _, _ = run
    want = ref["eval"]
    assert len(want) == 7 and sum(int(w["mask"].sum()) for w in want) > 0
    for r in ranks:
        got = r["eval"]["results"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], k)


# --------------------------------------------------- train_model at world 2
def test_train_model_world_two_resumes_exactly(run):
    ranks, _, work, _ = run

    def untimed(recs):
        return [{k: v for k, v in rec.items() if k not in ("data_time",
                                                             "time")}
                for rec in recs]

    r0 = ranks[0]["train_model"]
    assert [("mode" in x, x["epoch"]) for x in r0["records"]] == [
        (False, 0), (True, 1), (False, 1), (True, 2)]
    assert untimed(r0["resumed"]) == untimed(r0["records"][2:])
    # rank 1 logs the same (averaged) steps and writes nothing
    assert untimed(ranks[1]["train_model"]["records"]) == untimed(
        [x for x in r0["records"] if "mode" not in x])
    for r in ranks:
        for k, v in r0["state"].items():
            assert torch.equal(r["train_model"]["state"][k], v), k
            assert torch.equal(r["train_model"]["state2"][k], v), k
    import json
    with open(os.path.join(work, "a", "train_log.jsonl")) as f:
        assert [json.loads(line) for line in f] == r0["records"]


def test_checkpoint_restores_each_rank_and_refuses_another_world(run):
    ranks, _, work, data = run
    from isfusion_tpu_torch.apis import init_model
    cfg = workers.tiny_learn_cfg(data)
    model = init_model(cfg, device="cpu")
    path = os.path.join(work, "a", "epoch_1.pth")
    states = torch.load(path, weights_only=True)["generator_states"]
    assert len(states) == WORLD and not torch.equal(states[0], states[1])
    gen = torch.Generator()
    load_checkpoint(path, model, None, gen, rank=1, world_size=WORLD)
    assert torch.equal(gen.get_state(), states[1])
    with pytest.raises(ValueError, match="2 ranks"):
        load_checkpoint(path, copy.deepcopy(model), None, gen)
