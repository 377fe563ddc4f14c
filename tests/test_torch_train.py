"""The port's residual regression (``train/training.py``) and ResNet1D's
train mode against the JAX package's Flax/optax loop, on the CPU, from the
same initial weights (Flax's init carried across with the port's loaders)
and the same minibatches.

* ``prepare_residual_dataset`` against JAX (rtol 1e-6);
* ``FlaxBatchNorm1d`` in train mode against Flax ``nn.BatchNorm`` (outputs
  and running statistics, rtol 1e-5, atol 1e-6), where a stock
  ``BatchNorm1d`` (momentum 0.01, the unbiased running variance) is off;
* ``make_train_step`` on an MLP 5→32→32→32→3 for 10 steps against JAX's
  step with ``optax.adam`` and ``optax.adamw``, with and without the zero
  head: per-step MSE/MAE and the parameters after (tolerances below);
* ``make_train_step`` on ResNet-18 in train mode for 3 SGD steps:
  parameters and the BatchNorm running statistics against Flax's
  ``batch_stats``;
* ``train_residual_model`` whole, fed JAX's split permutation and epoch
  orders through the port's own loop (``training._run``): the history and
  the final parameters;
* data-parallel: a world-1 gloo group equals the run without one bit for
  bit (MLP and ResNet-18); two gloo ranks equal one process on the whole
  minibatch (rtol 1e-5, atol 1e-6), the MLP through Adam and ResNet-18's
  BatchNorm statistics summed over the ranks; a minibatch that does not
  split over the ranks raises;
* ``residual_from_train_state`` on the port's ``TrainState`` equals
  ``make_residual_fn`` on the same module, bit for bit, and raises on
  params of another kind.

Every comparison prints its largest error.
"""

from __future__ import annotations

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from flax import linen as fnn

from dnn_mppi_mpc_tpu.models import learned as jl
from dnn_mppi_mpc_tpu.train import training as jtr
from dnn_mppi_mpc_tpu_torch.models import learned as tl
from dnn_mppi_mpc_tpu_torch.train import training as ttr

JOIN_SECONDS = 120
DIMS = dict(out_dim=3, hidden=32, depth=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread spares each op the pool's wake-up."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(name, got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    print(f"{name}: max abs err {float(np.abs(got - want).max()):.3e} (rtol {rtol}, atol {atol})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _data(n=200, seed=0):
    """A smooth residual of (state, control) rows, float32 numpy."""
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(n, 3)).astype(np.float32)
    controls = rng.normal(size=(n, 2)).astype(np.float32)
    errors = np.stack([0.3 * np.tanh(controls[:, 0]) * np.cos(states[:, 2]),
                       0.2 * controls[:, 1] * np.sin(states[:, 2]),
                       0.1 * controls[:, 0] - 0.05 * states[:, 0]], -1).astype(np.float32)
    return states, controls, errors


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _flax_mlp(zero_head: bool, seed: int = 0):
    jm = jl.MLP(**DIMS, zero_init_head=zero_head)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 5), jnp.float32))
    tm = tl.MLP(**DIMS, zero_init_head=zero_head, device="cpu")
    tl.load_flax_mlp(tm, _np(variables))
    return jm, variables, tm


def _mlp_params(tm):
    """The port's MLP as Flax's ``Dense_i`` {kernel, bias} numpy tree."""
    return {f"Dense_{i}": {"kernel": l.weight.detach().numpy().T, "bias": l.bias.detach().numpy()}
            for i, l in enumerate(tm.layers)}


def test_prepare_residual_dataset_matches_jax():
    s, c, e = _data()
    jx, jy, jin, jout = jtr.prepare_residual_dataset(*map(jnp.asarray, (s, c, e)))
    tx, ty, tin, tout = ttr.prepare_residual_dataset(*_t(s, c, e))
    for name, got, want in (("features", tx, jx), ("targets", ty, jy), ("in mean", tin.mean, jin.mean),
                            ("in std", tin.std, jin.std), ("out mean", tout.mean, jout.mean),
                            ("out std", tout.std, jout.std)):
        _close(name, got.numpy(), np.asarray(want), 1e-6, 1e-7)


def test_flax_batchnorm_train_mode_matches_flax():
    """One train-mode call on (B, L, C) = (32, 1, 16): the output and the
    updated running statistics equal Flax's; a stock BatchNorm1d with the
    matching momentum (0.01) leaves Flax's running variance by the
    unbiased estimator's n/(n − 1)."""
    rng = np.random.default_rng(4)
    x = (2.0 * rng.normal(size=(32, 1, 16)) + 0.5).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(16, np.float32), "var": np.ones(16, np.float32)}}
    y, upd = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = tl.FlaxBatchNorm1d(16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    got = bn(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    _close("BatchNorm train output", got.detach().numpy(), np.asarray(y), 1e-5, 1e-6)
    _close("running mean", bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), 1e-5, 1e-6)
    _close("running var", bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), 1e-5, 1e-6)
    stock = torch.nn.BatchNorm1d(16, eps=tl.BN_EPS, momentum=0.01)
    stock(torch.from_numpy(x).transpose(1, 2))
    gap = np.abs(stock.running_var.numpy() - np.asarray(upd["batch_stats"]["var"]))
    print(f"stock BatchNorm1d running var: max abs err {gap.max():.3e}")
    assert gap.max() > 1e-4


# Ten Adam steps agree to float32 rounding, with the zero head and without it:
# the largest gap over the parameters is 3.6e-7 in both cases (measured), so
# rtol 1e-5, atol 1e-6 holds for both. With the zero head the hidden layers'
# first gradients are exactly 0 in both frameworks (0 times the head's
# error), so Adam's first step leaves them at 0 rather than turning rounding
# noise into ±lr; from step 2 their gradients are products of a head of
# ~1e-3 and none lands at rounding level. Where one does — a ResNet's convs,
# below — Adam's first step is lr·g/(|g| + 1e-8), ±lr for either sign of a
# 1e-8 gradient, and the frameworks part by up to 2·lr in that element.
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("zero_head", [False, True])
@pytest.mark.parametrize("decay", [0.0, 1e-2])
def test_mlp_train_step_matches_optax(zero_head, decay):
    jm, variables, tm = _flax_mlp(zero_head)
    tx = optax.adamw(1e-3, weight_decay=decay) if decay else optax.adam(1e-3)
    jstep = jtr.make_train_step(jm, tx)
    params, opt_state = variables, tx.init(variables)
    step = ttr.make_train_step(tm, ttr.make_optimizer(
        tm, ttr.TrainConfig(learning_rate=1e-3, weight_decay=decay)))
    rng = np.random.default_rng(1)
    rtol, atol = STEP_RTOL, STEP_ATOL
    for k in range(10):
        x = rng.normal(size=(32, 5)).astype(np.float32)
        y = (0.3 * np.tanh(x[:, :3]) + 0.1 * rng.normal(size=(32, 3))).astype(np.float32)
        params, opt_state, jm_ = jstep(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        m = step(*_t(x, y))
        _close(f"step {k} mse", float(m["mse"]), float(jm_["mse"]), 1e-5, 1e-7)
        _close(f"step {k} mae", float(m["mae"]), float(jm_["mae"]), 1e-5, 1e-7)
    got = _mlp_params(tm)
    for name, want in _np(params["params"]).items():
        for leaf in ("kernel", "bias"):
            _close(f"{name}/{leaf} (zero head {zero_head}, decay {decay})", got[name][leaf],
                   want[leaf], rtol, atol)


def _flax_resnet():
    jm = jl.ResNet1D(out_dim=3, variant="18")
    variables = jm.init(jax.random.PRNGKey(0), jnp.ones((2, 1, 5), jnp.float32))
    tm = tl.ResNet1D(out_dim=3, variant="18", device="cpu")
    tl.load_flax_resnet(tm, _np(variables))
    return jm, variables, tm


def _resnet_tree(tm):
    """The port's ResNet1D as a Flax ``params`` / ``batch_stats`` numpy tree."""
    def conv_bn(conv, bn, p, s, i):
        p[f"Conv_{i}"] = {"kernel": conv.weight.detach().numpy().transpose(2, 1, 0)}
        p[f"BatchNorm_{i}"] = {"scale": bn.weight.detach().numpy(),
                               "bias": bn.bias.detach().numpy()}
        s[f"BatchNorm_{i}"] = {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}

    p, s = {}, {}
    conv_bn(tm.stem, tm.stem_bn, p, s, 0)
    for j, block in enumerate(tm.blocks):
        bp, bs = p.setdefault(f"BasicBlock1D_{j}", {}), s.setdefault(f"BasicBlock1D_{j}", {})
        for i, (conv, bn) in enumerate(zip(block.convs, block.bns)):
            conv_bn(conv, bn, bp, bs, i)
    p["Dense_0"] = {"kernel": tm.head.weight.detach().numpy().T,
                    "bias": tm.head.bias.detach().numpy()}
    return {"params": p, "batch_stats": s}


def test_resnet18_train_step_matches_flax_batch_stats():
    """Three train-mode steps (batch 32, L = 1): the parameters and the
    BatchNorm running mean and variance equal Flax's ``params`` and
    ``batch_stats`` (rtol 1e-4, atol 1e-6; measured 1.2e-7 and 3.6e-7; a
    stock BatchNorm1d's running variance is already 3e-4 off after one step,
    see the test above). Both sides step with plain SGD (``make_train_step``
    takes any optimizer), so an element's update is lr times its gradient:
    Adam's first step, lr·g/(|g| + 1e-8), is ±lr for a gradient at rounding
    level (one conv gradient here is 1.1e-8 in JAX and −3.5e-8 in the port,
    against a largest of 6.5e-2) and would part the two by 2·lr there. The
    step-0 gradients agree to 1.7e-5 of each tensor's largest. lr is 0.002:
    at 0.05 and 0.01 the third step jumps to 4.6e-4 and 8.4e-5 in single
    elements (batch_stats still 1.2e-6) — a discrete flip at one step, as a
    ReLU input at rounding level gives, not a drift."""
    jm, variables, tm = _flax_resnet()
    tx = optax.sgd(0.002)
    jstep = jtr.make_train_step(jm, tx, has_batch_stats=True)
    params, opt_state = variables, tx.init(variables["params"])
    step = ttr.make_train_step(tm, torch.optim.SGD(tm.parameters(), lr=0.002))
    rng = np.random.default_rng(2)
    for k in range(3):
        x = rng.normal(size=(32, 1, 5)).astype(np.float32)
        y = (0.5 * np.tanh(x[:, 0, :3])).astype(np.float32)
        params, opt_state, jm_ = jstep(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        m = step(*_t(x, y))
        _close(f"resnet step {k} mse", float(m["mse"]), float(jm_["mse"]), 1e-5, 1e-7)
    assert not tm.training  # the step restores eval mode
    got, want = _resnet_tree(tm), _np(params)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    worst = {"params": 0.0, "batch_stats": 0.0}
    for path, leaf in flat_got:
        ref = flat_want[path]
        np.testing.assert_allclose(leaf, ref, rtol=1e-4, atol=1e-6, err_msg=str(path))
        worst[path[0].key] = max(worst[path[0].key], float(np.abs(leaf - ref).max()))
    print(f"ResNet-18 after 3 steps, max abs err: {worst} (rtol 1e-4, atol 1e-6)")


def _jax_orders(n, cfg, val_fraction=0.3):
    """The split permutation and epoch orders of JAX's train_residual_model
    (training.py:141-142, 187-190)."""
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(cfg.seed), n))
    n_train = n - int(n * val_fraction)
    key, orders = jax.random.PRNGKey(cfg.seed + 2), []
    for _ in range(cfg.num_epochs):
        key, sub = jax.random.split(key)
        orders.append(torch.from_numpy(np.array(jax.random.permutation(sub, n_train))))
    return torch.from_numpy(perm.copy()), orders


def test_train_residual_model_matches_jax_on_its_orders():
    """The whole run (MLP 5→32→32→32→3, zero head, 6 epochs of batch 32 over
    140 train rows, the remainder dropped: 24 Adam steps at lr 2e-3) on
    JAX's split and epoch orders: the history curves (rtol 1e-5, atol 1e-7)
    and the final parameters (rtol 1e-5, atol 5e-6: the largest gap is
    2.0e-6, in one hidden kernel, above the 10-step test's 3.6e-7 — over 24
    steps some gradient element passes through rounding level, where Adam's
    g/(√v + ε) amplifies it)."""
    s, c, e = _data()
    cfg = jtr.TrainConfig(num_epochs=6, batch_size=32, learning_rate=2e-3)
    jm = jl.MLP(**DIMS)
    jstate, jhist = jtr.train_residual_model(jm, *map(jnp.asarray, (s, c, e)), cfg)
    tm = tl.MLP(**DIMS, device="cpu")  # Flax's init: model.init(PRNGKey(seed + 1))
    tl.load_flax_mlp(tm, _np(jm.init(jax.random.PRNGKey(cfg.seed + 1), jnp.zeros((2, 5), jnp.float32))))
    tcfg = ttr.TrainConfig(**vars(cfg))
    perm, orders = _jax_orders(len(s), cfg)
    state, hist = ttr._run(tm, ttr.make_optimizer(tm, tcfg), *_t(s, c, e), tcfg, perm, orders)
    for key in ("train_mse", "train_mae", "val_mse", "val_mae"):
        _close(key, hist[key], jhist[key], 1e-5, 1e-7)
    got = _mlp_params(tm)
    for name, want in _np(jstate.params["params"]).items():
        for leaf in ("kernel", "bias"):
            _close(f"{name}/{leaf}", got[name][leaf], want[leaf], 1e-5, 5e-6)
    _close("in scaler", state.in_scaler.std.numpy(), np.asarray(jstate.in_scaler.std), 1e-6, 0)


def test_train_residual_model_has_jax_s_parameters():
    """The public entry point takes JAX's parameters, in JAX's order, with
    the process group in place of the mesh, and nothing more: the loop's
    own hooks (given orders, a context around each epoch) stay on ``_run``."""
    import inspect

    want = [("group" if p == "mesh" else p)
            for p in inspect.signature(jtr.train_residual_model).parameters]
    assert list(inspect.signature(ttr.train_residual_model).parameters) == want


def _world1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


@pytest.mark.parametrize("variant", ["mlp", "resnet18"])
def test_world_one_group_is_bit_equal(variant):
    s, c, e = _data(n=100)
    cfg = ttr.TrainConfig(num_epochs=2, batch_size=32)

    def make():
        g = torch.Generator().manual_seed(5)
        if variant == "mlp":
            return tl.MLP(**DIMS, zero_init_head=False, device="cpu", generator=g)
        return tl.ResNet1D(3, "18", device="cpu", generator=g)

    alone, with_group = make(), make()
    st_a, h_a = ttr.train_residual_model(alone, *_t(s, c, e), cfg)
    _world1()
    try:
        st_g, h_g = ttr.train_residual_model(with_group, *_t(s, c, e), cfg, group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert h_a == h_g
    assert st_a.params.keys() == st_g.params.keys()
    assert all(torch.equal(st_a.params[k], st_g.params[k]) for k in st_a.params)


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank, world_size=2)
    try:
        for kind in ("mlp", "resnet18"):
            state, hist = _two_rank_run(kind, dist.group.WORLD)
            torch.save({"params": state.params, "hist": hist}, f"{out_dir}/{kind}{rank}.pt")
    finally:
        dist.destroy_process_group()


def _net(kind):
    g = torch.Generator().manual_seed(5)
    if kind == "mlp":
        return tl.MLP(**DIMS, zero_init_head=False, device="cpu", generator=g)
    return tl.ResNet1D(3, "18", device="cpu", generator=g)


def _two_rank_run(kind, group=None):
    """Epochs of batch 32 over 70 train rows (no padding; each rank takes 16
    + 16 rows of a minibatch): the MLP through ``train_residual_model``
    (Adam, 3 epochs), ResNet-18 through its loop with SGD at lr 0.002 for
    one epoch (2 steps). Adam's first step makes ±lr of a gradient at
    rounding level (the ResNet step test above); from the third step on a
    discrete flip — a ReLU input at rounding level, the kink of that test —
    parts single stem weights by 1e-5 and the third epoch's MSE by 8.5e-4,
    while the first two epochs' MSEs agree to 1e-7. What this holds is the
    BatchNorm statistics summed over the ranks."""
    s, c, e = _t(*_data(n=100))
    cfg = ttr.TrainConfig(num_epochs=3 if kind == "mlp" else 1, batch_size=32)
    net = _net(kind)
    if kind == "mlp":
        return ttr.train_residual_model(net, s, c, e, cfg, group=group)
    return ttr._run(net, torch.optim.SGD(net.parameters(), lr=0.002), s, c, e, cfg,
                    ttr._split_permutation(100, cfg.seed, "cpu"),
                    ttr._epoch_orders(70, cfg.seed, cfg.num_epochs, "cpu"), group=group)


# the mean of two half-batch means against one mean, and BatchNorm's sums of
# two halves against one sum: float32 rounding (measured 1.2e-7 and 2.4e-7)
TWO_RANK_TOL = {"mlp": (1e-5, 1e-6), "resnet18": (1e-5, 1e-6)}


@pytest.mark.parametrize("kind", ["mlp", "resnet18"])
def test_two_gloo_ranks_match_one_process(two_ranks, kind):
    """Two ranks, each on half of every minibatch, gradients all-reduced
    (and for ResNet-18 the BatchNorm batch statistics summed over the
    ranks): the parameters and the history of one process on the whole
    minibatch (``TWO_RANK_TOL``)."""
    state, hist = _two_rank_run(kind)
    rtol, atol = TWO_RANK_TOL[kind]
    for r in range(2):
        out = torch.load(two_ranks / f"{kind}{r}.pt")
        for key in hist:
            _close(f"{kind} rank {r} {key}", out["hist"][key], hist[key], rtol, atol)
        for k, v in state.params.items():
            _close(f"{kind} rank {r} {k}", out["params"][k].float().numpy(), v.float().numpy(),
                   rtol, atol)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Spawn the two gloo ranks once for the module; their saved outputs."""
    tmp_path = tmp_path_factory.mktemp("two_ranks")
    ctx = tmp.start_processes(_rank_main, args=(str(tmp_path / "store"), str(tmp_path)),
                              nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"the two ranks did not finish in {JOIN_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return tmp_path


def test_minibatch_must_split_over_the_group(monkeypatch):
    """The train rows pad to a multiple of the world size; a minibatch that
    does not split evenly over the ranks raises before any step."""
    assert ttr._train_rows(100, 0.3, 3) == 72 and ttr._train_rows(100, 0.3, 2) == 70
    s, c, e = _data(n=100)
    net = tl.MLP(**DIMS, device="cpu")
    before = [p.clone() for p in net.parameters()]
    monkeypatch.setattr(ttr, "_world", lambda group: 3)
    cfg = ttr.TrainConfig(batch_size=32)
    with pytest.raises(ValueError, match="does not split evenly over 3 ranks"):
        ttr._run(net, ttr.make_optimizer(net, cfg), *_t(s, c, e), cfg, torch.arange(100),
                 [torch.arange(72)])
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))


@pytest.mark.parametrize("variant", ["mlp", "resnet18"])
def test_residual_from_port_train_state(variant):
    s, c, e = _data(n=80)
    g = torch.Generator().manual_seed(2)
    net = (tl.MLP(**DIMS, device="cpu", generator=g) if variant == "mlp"
           else tl.ResNet1D(3, "18", device="cpu", generator=g))
    state, _ = ttr.train_residual_model(net, *_t(s, c, e), ttr.TrainConfig(num_epochs=2, batch_size=16))
    fresh = (tl.MLP(**DIMS, device="cpu") if variant == "mlp" else tl.ResNet1D(3, "18", device="cpu"))
    fn = tl.residual_from_train_state(fresh, state)
    want = tl.make_residual_fn(net, state.in_scaler, state.out_scaler,
                               needs_length_axis=variant == "resnet18")
    feats = torch.cat(_t(s, c), -1)
    assert torch.equal(fn(feats), want(feats))
    with pytest.raises(TypeError, match="state_dict"):
        tl.residual_from_train_state(fresh, types.SimpleNamespace(
            params=[1.0], in_scaler=None, out_scaler=None))
