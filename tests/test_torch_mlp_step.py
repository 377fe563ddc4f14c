"""The port's fused residual-MLP step (``ops/cuda/mlp_step.py``) against the
JAX package's (``ops/pallas/mlp_step.py``, Pallas in interpret mode), on the
CPU: the cases of tests/test_mlp_step.py with its tolerances (rtol 3e-5, atol
3e-6; rtol 1e-4, atol 1e-5 for the MPPI tick).

* ``fold_residual_mlp`` from the port's MLP and from the Flax tree against
  the JAX fold;
* the plain ``fused_mlp_apply`` against the JAX interpret kernel on the same
  folded weights (16-wide depth 2 at K = 100, 128-wide at K = 256, 64-wide
  depth 1 without scalers, and the bfloat16 option: products of bfloat16
  operands, for which an activation one float32 ulp apart on the two sides
  can round to bfloat16 values one bfloat16 ulp apart, so rtol 1e-2 and atol
  1e-3 there);
* ``make_fused_residual_step`` against JAX's Euler residual dynamics over a
  (2, 24, ·) leading batch and with ``residual_scale=1``; the shape and
  grad checks;
* the kernel's launch plan (rows a block, the weight stage, shared memory)
  and its raises on widths it does not take;
* one MPPI tick with injected ε, the fused step against JAX ``mppi_step``;
  ``presets.dnn_mppi`` at both residual levels, one tick against the JAX
  preset with the same ε (JAX in float32 here: rtol 1e-3, atol 1e-4, the
  exploration temperature 1/1e-4 amplifying rounding in the costs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import presets as jpresets
from dnn_mppi_mpc_tpu.config import MPPIConfig as JConfig
from dnn_mppi_mpc_tpu.config import MPPIParams as JParams
from dnn_mppi_mpc_tpu.models import euler_step as j_euler
from dnn_mppi_mpc_tpu.models import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.dynamics import residual_dynamics as j_residual_dynamics
from dnn_mppi_mpc_tpu.models.learned import make_residual_fn as j_make_residual_fn
from dnn_mppi_mpc_tpu.ops.pallas import mlp_step as jmlp
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch import presets
from dnn_mppi_mpc_tpu_torch.models import unicycle
from dnn_mppi_mpc_tpu_torch.models.learned import make_residual_fn
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

from test_torch_learned import _close, flax_mlp, scalers

DT = 0.05


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread spares every op the
    thread pool's wake-up cost, which would dominate its time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(hidden, depth, seed=0, with_scalers=True):
    jm, variables, tm = flax_mlp(hidden, depth, seed=seed)
    if with_scalers:
        (jin, jout), (tin, tout) = scalers(seed)
    else:
        jin = jout = tin = tout = None
    return (jm, variables, jin, jout), (tm, tin, tout)


def _jax_oracle_step(jm, variables, jin, jout):
    f = j_residual_dynamics(j_unicycle, j_make_residual_fn(jm, variables, jin, jout))
    return lambda x, u: j_euler(f, x, u, DT)


def _xu(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape + (3,)).astype(np.float32),
            rng.normal(size=shape + (2,)).astype(np.float32))


def test_fold_residual_mlp_matches_jax():
    (jm, variables, jin, jout), (tm, tin, tout) = _setup(32, 2, seed=3)
    jws, jbs = jmlp.fold_residual_mlp(variables, jin, jout, DT)
    for source, (tws, tbs) in (("module", kern.fold_residual_mlp(tm, tin, tout, DT)),
                               ("tree", kern.fold_residual_mlp(variables, tin, tout, DT))):
        assert len(tws) == len(jws) and not any(w.requires_grad for w in tws)
        for i, (tw, tb, jw, jb) in enumerate(zip(tws, tbs, jws, jbs)):
            _close(f"fold {source} W{i}", tw.numpy(), np.asarray(jw), 3e-5, 3e-6)
            _close(f"fold {source} b{i}", tb.numpy(), np.asarray(jb), 3e-5, 3e-6)


@pytest.mark.parametrize("hidden,depth,K,with_scalers,dtype", [
    (16, 2, 100, True, "float32"),  # sub-lane widths + odd K: the JAX padding paths
    (128, 2, 256, True, "float32"),  # the dnn_mppi example's deployment size
    (64, 1, 8, False, "float32"),  # no scalers, a single tanh layer
    (128, 1, 200, True, "bfloat16"),  # the suite net, bfloat16 operands
])
def test_plain_fused_mlp_apply_matches_jax_kernel(hidden, depth, K, with_scalers, dtype):
    (jm, variables, jin, jout), (tm, tin, tout) = _setup(hidden, depth, with_scalers=with_scalers)
    jws, jbs = jmlp.fold_residual_mlp(variables, jin, jout, DT)
    feats = np.random.default_rng(1).normal(size=(K, 5)).astype(np.float32)
    want = jmlp.fused_mlp_apply(jnp.asarray(feats), jws, jbs, block_rows=64,
                                compute_dtype=getattr(jnp, dtype), interpret=True)
    kern.reset_counts()
    got = kern.fused_mlp_apply(torch.from_numpy(feats),
                               [torch.from_numpy(np.asarray(w)) for w in jws],
                               [torch.from_numpy(np.asarray(b)) for b in jbs],
                               compute_dtype=getattr(torch, dtype))
    assert kern.fused_mlp_apply_plain.calls == 1 and kern.fused_mlp_apply.launches == 0
    tol = (3e-5, 3e-6) if dtype == "float32" else (1e-2, 1e-3)
    _close(f"fused_mlp_apply {hidden}x{depth} K={K} {dtype}", got.numpy(), np.asarray(want), *tol)


def test_fused_step_broadcasts_leading_batch_dims():
    """num_rollout_repeats > 1 hands the step (M, K, nx) batches."""
    jside, (tm, tin, tout) = _setup(16, 2)
    x, u = _xu((2, 24), 2)
    want = _jax_oracle_step(*jside)(jnp.asarray(x), jnp.asarray(u))
    step = kern.make_fused_residual_step(unicycle, tm, DT, tin, tout, device="cpu")
    got = step(torch.from_numpy(x), torch.from_numpy(u))
    assert got.shape == (2, 24, 3)
    _close("fused step (2, 24)", got.numpy(), np.asarray(want), 3e-5, 3e-6)


def test_fused_step_discrete_residual_scale():
    """residual_scale=1: the one-step-error convention of the data pipeline."""
    (jm, variables, jin, jout), (tm, tin, tout) = _setup(32, 2, seed=5)
    net = j_make_residual_fn(jm, variables, jin, jout)
    x, u = _xu((40,), 5)
    want = j_euler(j_unicycle, jnp.asarray(x), jnp.asarray(u), DT) + net(
        jnp.concatenate([jnp.asarray(x), jnp.asarray(u)], -1))
    step = kern.make_fused_residual_step(unicycle, tm, DT, tin, tout, residual_scale=1.0,
                                         device="cpu")
    _close("fused step, residual_scale=1", step(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
           np.asarray(want), 3e-5, 3e-6)


def test_fused_mlp_apply_checks():
    ws, bs = [torch.zeros(5, 8), torch.zeros(8, 3)], [torch.zeros(8), torch.zeros(3)]
    with pytest.raises(ValueError, match="features"):
        kern.fused_mlp_apply(torch.zeros(4, 6), ws, bs)
    with pytest.raises(ValueError, match="width mismatch"):
        kern.fused_mlp_apply(torch.zeros(4, 5), [ws[0], torch.zeros(7, 3)], bs)
    with pytest.raises(ValueError, match="bias"):
        kern.fused_mlp_apply(torch.zeros(4, 5), ws, [torch.zeros(8), torch.zeros(4)])
    with pytest.raises(ValueError, match="compute_dtype"):
        kern.fused_mlp_apply(torch.zeros(4, 5), ws, bs, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="backward"):
        kern.fused_mlp_apply(torch.zeros(4, 5, requires_grad=True), ws, bs)


@pytest.mark.parametrize("dims,stage,smem", [
    ((5, 128, 128, 3), 16384, 2 * 4 * 8 * 128 + 8 * 16384),  # the suite net
    ((5, 512, 512, 512, 3), 16384, 2 * 4 * 8 * 512 + 8 * 16384),  # the reference net
    ((5, 96, 200, 3), 16384, 2 * 4 * 8 * 200 + 8 * 16384),  # ragged widths
    ((5, 2048, 3), 12672, 2 * 4 * 8 * 2048 + 8 * 12672),  # the widest layer it takes
])
def test_mlp_launch_plan(dims, stage, smem):
    got = kern.mlp_step.mlp_launch_plan(dims)
    assert got == (stage, smem)
    assert smem <= kern.common.MAX_SMEM_OPT_IN and stage % 4 == 0 and stage >= max(dims[1:])


def test_mlp_launch_plan_raises():
    with pytest.raises(ValueError, match="2048 wide"):
        kern.mlp_step.mlp_launch_plan((5, 2049, 3))
    with pytest.raises(ValueError, match="no room"):  # a 4 000-wide input fills the memory
        kern.mlp_step.mlp_launch_plan((4000, 512, 3))
    assert [kern.mlp_step._layer_rn(w) for w in (1, 256, 257, 512, 513, 1024, 2048)] == [
        1, 1, 2, 2, 4, 4, 8]


def _tick_problem(K=32, T=6):
    cfg = dict(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT, lam=1.0, exploration=0.0,
               filter_window=3, waypoint_search_len=5)
    n = 30
    path = np.stack([np.linspace(0.0, 3.0, n), np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    p = dict(sigma=[[0.1, 0.0], [0.0, 0.05]], stage_weight=[1.0, 1.0, 0.1],
             terminal_weight=[1.0, 1.0, 0.1], u_min=[-2.0, -2.0], u_max=[2.0, 2.0], ref_path=path)
    jp = JParams(**{k: jnp.asarray(np.asarray(v, np.float32)) for k, v in p.items()})
    return JConfig(**cfg), jp, tcfg.MPPIConfig(**cfg), tcfg.params_from_numpy(**p, device="cpu")


def test_mppi_tick_with_fused_step_matches_jax():
    """One full MPPI tick (injected ε): the port's scan path over the fused
    step against the JAX scan path over the plain residual dynamics."""
    jside, (tm, tin, tout) = _setup(16, 2, seed=4)
    jc, jp, tc, tp = _tick_problem()
    eps = (np.random.default_rng(5).normal(size=(32, 6, 2)) * 0.1).astype(np.float32)
    ju, _, _ = jmppi.mppi_step(jc, _jax_oracle_step(*jside), *jmppi.make_tracking_costs(jc), jp,
                               jmppi.MPPIState.init(jc), jnp.zeros(3, jnp.float32),
                               noise=jnp.asarray(eps))
    step = kern.make_fused_residual_step(unicycle, tm, DT, tin, tout, device="cpu")
    tu, _, _ = tmppi.mppi_step(tc, step, *tmppi.make_tracking_costs(tc), tp,
                               tmppi.MPPIState.init(tc, device="cpu"), torch.zeros(3),
                               noise=torch.from_numpy(eps))
    _close("MPPI tick u0, fused step", tu.numpy(), np.asarray(ju), 1e-4, 1e-5)


@pytest.mark.parametrize("level", ["step", "rate"])
def test_dnn_mppi_preset_tick_matches_jax(level, f32_mode):
    """``presets.dnn_mppi`` (K = 256, T = 10, the suite's 5→128→128→3 net
    with a non-zero head) against the JAX preset: one tick with the same ε
    from a state off the path."""
    (jm, variables, _, _), (tm, _, _) = _setup(128, 1, seed=7, with_scalers=False)
    ref = np.stack([np.linspace(0.0, 4.0, 100), np.linspace(0.0, 4.0, 100),
                    np.full(100, np.pi / 4)], 1).astype(np.float32)
    js, jp = jpresets.dnn_mppi(jnp.asarray(ref), j_make_residual_fn(jm, variables),
                               num_samples=256, horizon=10, residual_level=level)
    ts, tp = presets.dnn_mppi(ref, make_residual_fn(tm), num_samples=256, horizon=10,
                              residual_level=level, device="cpu")
    eps = np.random.default_rng(8).multivariate_normal(
        np.zeros(2), [[0.2, 0.0], [0.0, 0.1]], (256, 10)).astype(np.float32)
    x0 = np.array([0.3, -0.2, 0.5], np.float32)
    ju, jst, jaux = js.step(jp, js.init(), jnp.asarray(x0), jnp.asarray(eps))
    tu, tst, taux = ts.step(tp, ts.init(), torch.from_numpy(x0), torch.from_numpy(eps))
    _close(f"dnn_mppi {level} S", taux.costs.numpy(), np.asarray(jaux.costs), 1e-5, 1e-5)
    _close(f"dnn_mppi {level} u0", tu.numpy(), np.asarray(ju), 1e-3, 1e-4)
    _close(f"dnn_mppi {level} u_prev", tst.u_prev.numpy(), np.asarray(jst.u_prev), 1e-3, 1e-4)
    assert int(tst.waypoint_idx) == int(jst.waypoint_idx)


def test_dnn_mppi_preset_guards():
    with pytest.raises(ValueError, match="residual_level"):
        presets.dnn_mppi(np.zeros((4, 3)), lambda f: f[..., :3], residual_level="delta",
                         device="cpu")
    solver, params = presets.dnn_mppi(np.zeros((4, 3)), lambda f: f[..., :3].double(),
                                      num_samples=16, horizon=4, device="cpu")
    assert solver.dynamics_step(torch.zeros(3), torch.zeros(2)).dtype == torch.float32


@pytest.mark.cuda
def test_fused_mlp_kernel_on_card():
    """The kernel against its plain version (one call; chip_smoke.py covers
    the main-path shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(5, 64, generator=g), torch.randn(64, 64, generator=g) / 8,
          torch.randn(64, 3, generator=g) / 8]
    bs = [torch.randn(64, generator=g), torch.randn(64, generator=g), torch.randn(3, generator=g)]
    x = torch.randn(100, 5, generator=g)
    dev = torch.device("cuda")
    got = kern.fused_mlp_apply(x.to(dev), [w.to(dev) for w in ws], [b.to(dev) for b in bs])
    want = kern.fused_mlp_apply_plain(x.to(dev), [w.to(dev) for w in ws], [b.to(dev) for b in bs])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,K", [((5, 96, 200, 3), 777), ((5, 512, 512, 512, 3), 300)])
def test_fused_mlp_kernel_on_card_ragged_and_wide(dims, K):
    """Widths that are no multiple of the register tile or the 16-byte copy,
    an odd K, and the 512-wide net's two columns a thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    ws = [(torch.randn(a, b, generator=g) / a ** 0.5).to(dev) for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * torch.randn(b, generator=g)).to(dev) for b in dims[1:]]
    x = torch.randn(K, dims[0], generator=g).to(dev)
    torch.testing.assert_close(kern.fused_mlp_apply(x, ws, bs),
                               kern.fused_mlp_apply_plain(x, ws, bs), rtol=1e-5, atol=1e-6)
