"""The port's learned models (``models/learned.py``) against the JAX package's
Flax ones, on the CPU, with the same weights (the Flax tree as numpy leaves,
loaded through the port's loaders).

* ``MLP`` forward against Flax ``apply`` (rtol 1e-5, atol 1e-6); the loader
  raises on a missing, extra or misshapen ``Dense_*``;
* ``Standardizer.fit`` (population std) against JAX (rtol 1e-6);
* ``make_residual_fn`` with scalers over a leading batch (rtol 1e-5, atol
  1e-6); ``residual_dynamics`` and its ``jacrev`` against JAX's ``jacfwd``
  (rtol 1e-5, atol 1e-6);
* ResNet-18 and ResNet-50 conv forward against Flax at L = 1 with perturbed
  BatchNorm statistics (the recipe of tests/test_resnet_dynamics.py:184-206;
  atol 2e-5, that test's gate), the port's fold against its own conv path
  (atol 2e-5), ``residual_from_train_state`` for both families, and the
  ResNet loader's guards.

Every comparison prints its largest error.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.models import dynamics as jdyn
from dnn_mppi_mpc_tpu.models import learned as jl
from dnn_mppi_mpc_tpu_torch.models import dynamics as tdyn
from dnn_mppi_mpc_tpu_torch.models import learned as tl


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread spares every op the
    thread pool's wake-up cost, which would dominate its time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(name, got, want, rtol, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    print(f"{name}: max abs err {float(np.abs(got - want).max()):.3e} (rtol {rtol}, atol {atol})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _numpy_tree(variables):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables)


def flax_mlp(hidden, depth, seed=0, zero_init_head=False):
    """(JAX MLP, its variables as numpy, the port's MLP with them loaded)."""
    jm = jl.MLP(out_dim=3, hidden=hidden, depth=depth, zero_init_head=zero_init_head)
    variables = _numpy_tree(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 5), jnp.float32)))
    tm = tl.MLP(out_dim=3, hidden=hidden, depth=depth, device="cpu")
    tl.load_flax_mlp(tm, variables)
    return jm, variables, tm


def flax_resnet(variant, seed=0, perturb=True):
    """(JAX ResNet1D, its variables — with ``perturb`` every leaf perturbed
    and the variances kept positive — the port's ResNet1D with them loaded)."""
    jm = jl.ResNet1D(out_dim=3, variant=variant)
    variables = _numpy_tree(jm.init(jax.random.PRNGKey(seed), jnp.ones((2, 1, 5), jnp.float32)))
    if not perturb:
        tm = tl.ResNet1D(out_dim=3, variant=variant, device="cpu")
        return jm, variables, tl.load_flax_resnet(tm, variables)
    rng = np.random.default_rng(seed + 1)
    variables = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), variables)

    def fix_var(d):
        for k, v in d.items():
            if isinstance(v, dict):
                fix_var(v)
            elif k == "var":
                d[k] = np.abs(v) + 0.5

    fix_var(variables["batch_stats"])
    tm = tl.ResNet1D(out_dim=3, variant=variant, device="cpu")
    tl.load_flax_resnet(tm, variables)
    return jm, variables, tm


def scalers(seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=5), rng.uniform(0.5, 2.0, 5), rng.normal(size=3),
              rng.uniform(0.5, 2.0, 3)]
    arrays = [a.astype(np.float32) for a in arrays]
    js = (jl.Standardizer(jnp.asarray(arrays[0]), jnp.asarray(arrays[1])),
          jl.Standardizer(jnp.asarray(arrays[2]), jnp.asarray(arrays[3])))
    ts = (tl.Standardizer.from_numpy(arrays[0], arrays[1], device="cpu"),
          tl.Standardizer.from_numpy(arrays[2], arrays[3], device="cpu"))
    return js, ts


@pytest.mark.parametrize("hidden,depth", [(16, 2), (128, 1), (64, 3)])
def test_mlp_forward_matches_flax(hidden, depth):
    jm, variables, tm = flax_mlp(hidden, depth)
    x = np.random.default_rng(1).normal(size=(33, 5)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(f"MLP {hidden}x{depth}", got.numpy(), np.asarray(want), 1e-5, 1e-6)


def test_mlp_zero_head_and_seeded_init():
    """Flax's default zero head; a seeded init is reproducible and its head
    is not zero with zero_init_head=False."""
    zero = tl.MLP(hidden=8, depth=1, device="cpu")
    assert not zero.layers[-1].weight.any() and not zero.layers[-1].bias.any()
    nets = [tl.MLP(hidden=8, depth=1, zero_init_head=False, device="cpu",
                   generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(nets[0].layers[-1].weight, nets[1].layers[-1].weight)
    assert nets[0].layers[-1].weight.abs().min() > 0


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_mlp_loader_raises(fault):
    _, variables, tm = flax_mlp(16, 2)
    p = dict(variables["params"])
    if fault == "missing":
        del p["Dense_2"]
    elif fault == "extra":
        p["Dense_9"] = p["Dense_0"]
    else:
        p["Dense_1"] = {"kernel": np.zeros((16, 15), np.float32),
                        "bias": np.zeros(15, np.float32)}
    with pytest.raises(ValueError, match="missing|unexpected|shape"):
        tl.load_flax_mlp(tm, {"params": p})


def test_standardizer_fit_matches_jax():
    data = np.random.default_rng(2).normal(3.0, 2.0, size=(257, 5)).astype(np.float32)
    want = jl.Standardizer.fit(jnp.asarray(data))
    got = tl.Standardizer.fit(torch.from_numpy(data))
    _close("Standardizer mean", got.mean.numpy(), np.asarray(want.mean), 1e-6, 0.0)
    _close("Standardizer std (population)", got.std.numpy(), np.asarray(want.std), 1e-6, 0.0)
    z = np.random.default_rng(3).normal(size=(4, 5)).astype(np.float32)
    _close("Standardizer transform", got.transform(torch.from_numpy(z)).numpy(),
           np.asarray(want.transform(jnp.asarray(z))), 1e-5, 1e-6)
    _close("Standardizer inverse", got.inverse(torch.from_numpy(z)).numpy(),
           np.asarray(want.inverse(jnp.asarray(z))), 1e-5, 1e-6)


def test_make_residual_fn_with_scalers_matches_jax():
    jm, variables, tm = flax_mlp(32, 2, seed=4)
    (jin, jout), (tin, tout) = scalers(4)
    feats = np.random.default_rng(5).normal(size=(3, 7, 5)).astype(np.float32)
    want = jl.make_residual_fn(jm, variables, jin, jout)(jnp.asarray(feats))
    got = tl.make_residual_fn(tm, tin, tout)(torch.from_numpy(feats))
    assert got.shape == (3, 7, 3) and not got.requires_grad
    _close("make_residual_fn", got.numpy(), np.asarray(want), 1e-5, 1e-6)


def test_residual_dynamics_and_jacobian_match_jax():
    """f = unicycle + NN and its Jacobian in (x, u): the port's jacrev (the
    NMPC linearization's transform) against JAX's jacfwd."""
    jm, variables, tm = flax_mlp(32, 2, seed=6)
    jf = jdyn.residual_dynamics(jdyn.unicycle, jl.make_residual_fn(jm, variables))
    tf = tdyn.residual_dynamics(tdyn.unicycle, tl.make_residual_fn(tm))
    rng = np.random.default_rng(6)
    x, u = rng.normal(size=3).astype(np.float32), rng.normal(size=2).astype(np.float32)
    _close("residual_dynamics", tf(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
           np.asarray(jf(jnp.asarray(x), jnp.asarray(u))), 1e-5, 1e-6)
    jx, ju = jax.jacfwd(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(u))
    tx, tu = torch.func.jacrev(tf, argnums=(0, 1))(torch.from_numpy(x), torch.from_numpy(u))
    _close("d f / d x", tx.numpy(), np.asarray(jx), 1e-5, 1e-6)
    _close("d f / d u", tu.numpy(), np.asarray(ju), 1e-5, 1e-6)


@pytest.mark.parametrize("variant", ["18", "50"])
def test_resnet_forward_matches_flax(variant):
    jm, variables, tm = flax_resnet(variant)
    x = np.random.default_rng(7).normal(size=(16, 1, 5)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(f"ResNet-{variant} conv forward", got.numpy(), np.asarray(want), 0.0, 2e-5)


@pytest.mark.parametrize("variant", ["18", "50"])
def test_resnet_fold_matches_conv_path(variant):
    tm = tl.ResNet1D(out_dim=3, variant=variant, device="cpu",
                     generator=torch.Generator().manual_seed(8))
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.normal_(1.0, 0.1, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    x = torch.randn(16, 5, generator=g)
    with torch.no_grad():
        want = tm(x[:, None, :])
    got = tl.fold_resnet1d_l1(tm)(x)
    _close(f"ResNet-{variant} fold vs conv", got.numpy(), want.numpy(), 0.0, 2e-5)
    bf = tl.fold_resnet1d_l1(tm, compute_dtype=torch.bfloat16)(x)
    assert bf.dtype == torch.float32
    _close(f"ResNet-{variant} bf16 fold vs conv", bf.numpy(), want.numpy(), 0.0, 5e-2)


@pytest.mark.parametrize("family", ["mlp", "resnet18"])
def test_residual_from_train_state_matches_jax(family):
    """A train state (params as a Flax tree, scalers) bound by both
    packages; the ResNet gets the L = 1 fold on both sides."""
    if family == "mlp":
        jm, variables, _ = flax_mlp(16, 2, seed=10)
        tm = tl.MLP(out_dim=3, hidden=16, depth=2, device="cpu")
    else:
        jm, variables, _ = flax_resnet("18", seed=10)
        tm = tl.ResNet1D(out_dim=3, variant="18", device="cpu")
    (jin, jout), _ = scalers(10)
    jstate = types.SimpleNamespace(params=jax.tree_util.tree_map(jnp.asarray, variables),
                                   in_scaler=jin, out_scaler=jout)
    tstate = types.SimpleNamespace(params=variables, in_scaler=jin, out_scaler=jout)
    feats = np.random.default_rng(11).normal(size=(9, 5)).astype(np.float32)
    want = jl.residual_from_train_state(jm, jstate)(jnp.asarray(feats))
    got = tl.residual_from_train_state(tm, tstate)(torch.from_numpy(feats))
    _close(f"residual_from_train_state {family}", got.numpy(), np.asarray(want), 1e-5, 2e-5)


@pytest.mark.parametrize("fault", ["no batch_stats", "extra block", "shape"])
def test_resnet_loader_raises(fault):
    _, variables, tm = flax_resnet("18")
    variables = {"params": dict(variables["params"]),
                 "batch_stats": dict(variables["batch_stats"])}
    if fault == "no batch_stats":
        del variables["batch_stats"]
    elif fault == "extra block":
        variables["params"]["BasicBlock1D_8"] = variables["params"]["BasicBlock1D_7"]
    else:
        variables["params"]["Dense_0"] = {"kernel": np.zeros((511, 3), np.float32),
                                          "bias": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="batch_stats|unexpected|shape"):
        tl.load_flax_resnet(tm, variables)
