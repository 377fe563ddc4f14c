"""The port's tile steps, models and nu-wide hash noise against the JAX package.

* the four tile steps of ``models/tile.py`` against the JAX tile steps
  (``sincos="native"`` on the JAX side) on seeded numpy tiles, and each
  against ``euler_step`` of its model in the port;
* ``atan_tile`` against JAX (1e-7) and ``np.arctan`` (3e-7);
* ``four_wheel_torque`` and ``dynamic_bicycle`` against JAX (rtol 1e-6), and
  their params' defaults equal to the JAX defaults;
* ``lift_dynamics`` / ``lift_dynamics_time_varying`` equal to the tile
  through the whole generic tick (the JAX
  ``test_lift_dynamics_adapter_matches_tile`` tolerances);
* ``hash_noise`` at nu = 2 bit-equal to the one-pair stream, and at nu = 3
  and 4 its mean and covariance against Σ within 4 standard errors.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.models import dynamics as jdyn
from dnn_mppi_mpc_tpu.models import tile as jtile
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch import models as tmodels
from dnn_mppi_mpc_tpu_torch.models import tile as ttile
from dnn_mppi_mpc_tpu_torch.ops.cuda import mathx as tmathx
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

DT = 0.05
N = 4096


def _tiles(n, seed, scales):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, s, n).astype(np.float32) for s in scales]


# name -> (port factory, JAX factory, state scales, control scales, port model, nx)
TILES = {
    "unicycle": (lambda: ttile.unicycle_tile(DT), lambda: jtile.unicycle_tile(DT, sincos="native"),
                 (2.0, 2.0, 3.0), (1.5, 2.0), tmodels.unicycle),
    "kinematic_bicycle": (
        lambda: ttile.kinematic_bicycle_tile(DT, 2.5),
        lambda: jtile.kinematic_bicycle_tile(DT, 2.5, sincos="native"),
        (2.0, 2.0, 3.0, 3.0), (0.5, 2.0),
        lambda x, u: tmodels.kinematic_bicycle(x, u, tmodels.BicycleParams(2.5))),
    "four_wheel_torque": (
        lambda: ttile.four_wheel_torque_tile(DT),
        lambda: jtile.four_wheel_torque_tile(DT, sincos="native"),
        (2.0, 2.0, 3.0, 1.0, 1.0), (2.0, 2.0, 2.0, 2.0), tmodels.four_wheel_torque),
    "dynamic_bicycle": (
        lambda: ttile.dynamic_bicycle_tile(DT), lambda: jtile.dynamic_bicycle_tile(DT),
        (2.0, 2.0, 0.5, 2.0), (2.0, 0.4), tmodels.dynamic_bicycle),
}


@pytest.mark.parametrize("name", list(TILES))
def test_tile_step_matches_jax(name):
    make_t, make_j, xs_scale, vs_scale, _ = TILES[name]
    xs = _tiles(N, 1, xs_scale)
    vs = _tiles(N, 2, vs_scale)
    step = make_t()
    assert step.family == name and (step.nx, step.nu) == (len(xs), len(vs))
    got = step(tuple(torch.as_tensor(x) for x in xs), tuple(torch.as_tensor(v) for v in vs))
    want = make_j()(tuple(jnp.asarray(x) for x in xs), tuple(jnp.asarray(v) for v in vs))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(TILES))
def test_tile_step_is_the_euler_step(name):
    make_t, _, xs_scale, vs_scale, model = TILES[name]
    x = torch.as_tensor(np.stack(_tiles(N, 3, xs_scale), -1))
    u = torch.as_tensor(np.stack(_tiles(N, 4, vs_scale), -1))
    got = make_t()(tuple(x.unbind(-1)), tuple(u.unbind(-1)))
    want = tmodels.euler_step(model, x, u, DT)
    # the dynamic bicycle's tile uses the atan polynomial (|err| <= ~2e-8)
    torch.testing.assert_close(torch.stack(got, -1), want, rtol=1e-6, atol=2e-6)


def test_atan_tile_matches_jax_and_numpy():
    x = np.concatenate([np.random.default_rng(5).normal(0.0, 3.0, 20000),
                        [0.0, 1.0, -1.0, 1e-8, 1e6, -1e6]]).astype(np.float32)
    got = ttile.atan_tile(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtile.atan_tile(jnp.asarray(x))), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got, np.arctan(x.astype(np.float64)), rtol=0, atol=3e-7)


@pytest.mark.parametrize("model", ["four_wheel_torque", "dynamic_bicycle"])
def test_models_match_jax(model):
    nx, nu = (5, 4) if model == "four_wheel_torque" else (4, 2)
    rng = np.random.default_rng(6)
    x = rng.normal(0.0, 1.0, (N, nx)).astype(np.float32)
    u = rng.normal(0.0, 1.0, (N, nu)).astype(np.float32)
    x[:, 3] = np.abs(x[:, 3]) + 0.1  # speed away from the vx guard
    got = getattr(tmodels, model)(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    want = np.asarray(getattr(jdyn, model)(jnp.asarray(x), jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_dynamic_bicycle_guards_vx_zero():
    x = torch.zeros((3, 4))
    u = torch.tensor([[1.0, 0.0], [0.5, 0.2], [0.0, -0.3]])
    assert bool(torch.isfinite(tmodels.dynamic_bicycle(x, u)).all())
    step = ttile.dynamic_bicycle_tile(DT)
    assert all(bool(torch.isfinite(t).all()) for t in step(tuple(x.unbind(-1)), tuple(u.unbind(-1))))


@pytest.mark.parametrize("cls", ["FourWheelParams", "DynamicBicycleParams"])
def test_params_defaults_equal_jax(cls):
    got = getattr(tmodels, cls).default()
    want = getattr(jdyn, cls).default()
    for name in got.__dataclass_fields__:
        assert float(getattr(got, name)) == float(getattr(want, name)), name


def test_tile_factories_bake_float32_constants_in_jax_order():
    p = tmodels.FourWheelParams.default()
    step = ttile.four_wheel_torque_tile(DT)
    assert step.constants == (float(np.float32(DT)),
                              float(np.float32(p.wheel_radius / (4.0 * p.mass))),
                              float(np.float32(p.wheel_radius / (p.wheel_sep * p.inertia) * 0.5)))
    with pytest.raises(ValueError, match="sincos"):
        ttile.unicycle_tile(DT, sincos="poly")


def _own_step(xs, vs):
    return xs


@pytest.mark.parametrize("forged", ["constructor", "replace_fn", "replace_constants"])
def test_only_the_factories_make_a_step_of_a_family(forged):
    """The kernel runs a family's built-in step from its family and
    constants and never calls fn: a step that paired a family with another
    function or other constants raises instead of running one model on the
    card and another on the CPU."""
    made = ttile.four_wheel_torque_tile(DT)
    forge = {
        "constructor": lambda: ttile.TileStep("unicycle", 3, 2, (float(np.float32(DT)),), False,
                                              _own_step),
        "replace_fn": lambda: dataclasses.replace(made, fn=_own_step),
        "replace_constants": lambda: dataclasses.replace(made, constants=(0.1, 0.2, 0.3)),
    }[forged]
    with pytest.raises(ValueError, match="lift_dynamics"):
        forge()
    assert dataclasses.replace(made).family == "four_wheel_torque"
    assert ttile.TileStep(None, None, None, (), False, _own_step).family is None


# --- lift_dynamics through the whole tick ------------------------------------------


def _lift_problem(time_varying=False):
    cfg = tcfg.MPPIConfig(num_samples=256, horizon=10, dim_x=3, dim_u=2, dt=DT, lam=0.8,
                          alpha=0.3, exploration=0.25, filter_window=5, waypoint_search_len=8,
                          time_varying_dynamics=time_varying)
    n = 40
    path = np.stack([np.linspace(0.0, 4.0, n), np.sin(np.linspace(0.0, 2.0, n)),
                     np.random.default_rng(7).normal(0.0, 0.4, n).cumsum() * 0.1], 1)
    params = tcfg.params_from_numpy(
        sigma=[[0.2, 0.05], [0.05, 0.1]], stage_weight=[4.0, 4.0, 0.5],
        terminal_weight=[9.0, 9.0, 2.0], u_min=[-1.5, -2.0], u_max=[1.5, 2.0], ref_path=path,
        device="cpu")
    rng = np.random.default_rng(3)
    eps = torch.as_tensor(rng.multivariate_normal(np.zeros(2), params.sigma.numpy(), (256, 10)),
                          dtype=torch.float32)
    u_prev = rng.normal(0.0, 0.3, (10, 2))
    return cfg, params, eps, tmppi.state_from_numpy(u_prev, 0, [0, 0], device="cpu")


@pytest.mark.parametrize("time_varying", [False, True], ids=["lift", "lift_time_varying"])
def test_lift_dynamics_matches_tile(time_varying):
    cfg, params, eps, state = _lift_problem(time_varying)
    step_fn = lambda x, u: tmodels.euler_step(tmodels.unicycle, x, u, DT)  # noqa: E731
    lifted = (ttile.lift_dynamics_time_varying(lambda x, u, t: step_fn(x, u)) if time_varying
              else ttile.lift_dynamics(step_fn))
    assert lifted.family is None and lifted.takes_t == time_varying
    stage, terminal = tmppi.make_tracking_costs(cfg)
    x0 = torch.tensor([0.1, -0.05, 0.2])
    outs = []
    for tile in (ttile.unicycle_tile(DT), lifted):
        c = cfg if tile is lifted else dataclasses.replace(cfg, time_varying_dynamics=False)
        dyn = (lambda x, u, t: step_fn(x, u)) if c.time_varying_dynamics else step_fn
        solver = tmppi.MPPISolver(c, dyn, stage, terminal, fused_tick=True, tile_dynamics=tile,
                                  device="cpu")
        u0, _, aux = solver.step(params, state, x0, eps)
        outs.append((u0.numpy(), aux.costs.numpy()))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5, atol=1e-5)


# --- the nu-wide hash noise --------------------------------------------------------


def test_hash_noise_nu2_is_the_one_pair_stream():
    """nu = 2 draws pair 0 only: the stream of the diff-drive ticks, bit for bit."""
    K, T, k_blk, seed = 1024, 6, 256, 0xABCDEF
    chol = torch.tensor([[0.3, 0.0], [0.05, 0.2]])
    got = tmathx.hash_noise(seed, chol, K, T, k_blk, 3)
    blocks = torch.arange(K // k_blk, dtype=torch.int64) + 3
    z0, z1 = tmathx.hash_normal_pair(torch.tensor(seed), blocks, (T, k_blk // 128, 128))
    z0 = z0.reshape(-1, T, k_blk).transpose(-1, -2).reshape(K, T)
    z1 = z1.reshape(-1, T, k_blk).transpose(-1, -2).reshape(K, T)
    want = torch.stack([chol[0, 0] * z0, chol[1, 0] * z0 + chol[1, 1] * z1], -1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nu", [3, 4])
def test_hash_noise_moments(nu):
    """Pair p of step t at counter (p·T + t)·k_blk + local; the colored ε has
    mean 0 and covariance Σ within 4 standard errors."""
    K, T = 2048, 40
    rng = np.random.default_rng(nu)
    A = rng.normal(0.0, 0.4, (nu, nu))
    sigma = torch.tensor(A @ A.T + 0.1 * np.eye(nu), dtype=torch.float32)
    eps = tmathx.hash_noise(77, torch.linalg.cholesky(sigma.double()).float(), K, T, 1024)
    assert eps.shape == (K, T, nu)
    e = eps.reshape(-1, nu).double()
    n = e.shape[0]
    s = sigma.double()
    d = torch.diagonal(s)
    z_mean = (e.mean(0).abs() / torch.sqrt(d / n)).max()
    z_cov = ((torch.cov(e.T) - s).abs() / torch.sqrt((d[:, None] * d[None, :] + s**2) / n)).max()
    assert float(z_mean) < 4.0 and float(z_cov) < 4.0, (float(z_mean), float(z_cov))
    # ε of component 2 at step 5: pair 0 (stream row 5) and pair 1 (row T + 5)
    L = torch.linalg.cholesky(sigma.double()).float()
    z0, z1 = tmathx.hash_normal_pair(torch.tensor(77), torch.tensor([0]), (2 * T, 8, 128))

    def row(z, r):  # block 0, stream row r: samples 0..1023
        return z[0, r].reshape(-1)

    want = L[2, 0] * row(z0, 5) + L[2, 1] * row(z1, 5) + L[2, 2] * row(z0, T + 5)
    assert torch.equal(eps[:1024, 5, 2], want)
