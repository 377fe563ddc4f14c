"""Parity of the PyTorch port's plain modules with the JAX package.

Config, unicycle/integrators, sampling, waypoints, costs, filters, paths and
the numpy→port converters: the same numpy inputs go through the JAX function
and its port counterpart. Each test states its tolerance.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler, rk4_step as j_rk4
from dnn_mppi_mpc_tpu.ops import costs as jcosts
from dnn_mppi_mpc_tpu.ops import filters as jfilters
from dnn_mppi_mpc_tpu.ops import sampling as jsampling
from dnn_mppi_mpc_tpu.ops.waypoints import nearest_waypoint as j_nearest
from dnn_mppi_mpc_tpu.paths.generators import line as j_line
from dnn_mppi_mpc_tpu.solvers.mppi import MPPIState as JState
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch.models import euler_step, rk4_step, unicycle
from dnn_mppi_mpc_tpu_torch.ops import costs as tcosts
from dnn_mppi_mpc_tpu_torch.ops import filters as tfilters
from dnn_mppi_mpc_tpu_torch.ops import sampling as tsampling
from dnn_mppi_mpc_tpu_torch.ops.cuda.common import check
from dnn_mppi_mpc_tpu_torch.ops.waypoints import nearest_waypoint
from dnn_mppi_mpc_tpu_torch.paths import line
from dnn_mppi_mpc_tpu_torch.solvers.mppi import state_from_numpy
from dnn_mppi_mpc_tpu_torch.utils.benchtime import slope_timing

CFG_KW = dict(num_samples=256, horizon=12, dim_x=3, dim_u=2, dt=0.05, lam=0.8, alpha=0.3)


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("temperature", ["lambda", "exploration"])
def test_config_properties_match(temperature):
    jc = jcfg.MPPIConfig(**CFG_KW, temperature=jcfg.Temperature(temperature))
    tc = tcfg.MPPIConfig(**CFG_KW, temperature=tcfg.Temperature(temperature))
    assert tc.gamma == jc.gamma
    assert tc.inv_temperature == jc.inv_temperature
    assert [e.value for e in tcfg.SmoothingFilter] == [e.value for e in jcfg.SmoothingFilter]
    assert [e.value for e in tcfg.CostAccumulation] == [e.value for e in jcfg.CostAccumulation]


def test_params_and_state_from_numpy():
    jp = jcfg.MPPIParams(
        sigma=jnp.array([[0.2, 0.05], [0.05, 0.1]], jnp.float32),
        stage_weight=jnp.array([4.0, 4.0, 0.5], jnp.float32),
        terminal_weight=jnp.array([9.0, 9.0, 2.0], jnp.float32),
        u_min=jnp.array([-1.5, -2.0], jnp.float32),
        u_max=jnp.array([1.5, 2.0], jnp.float32),
        ref_path=jnp.zeros((7, 3), jnp.float32),
        obstacles=jnp.array([[1.0, 0.4, 0.3]], jnp.float32),
    )
    leaves = [None if v is None else np.asarray(v) for v in jp.tree_flatten()[0]]
    tp = tcfg.params_from_numpy(*leaves)
    for name in ("sigma", "stage_weight", "terminal_weight", "u_min", "u_max", "ref_path",
                 "obstacles"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
        assert getattr(tp, name).dtype == torch.float32
    assert tp.obstacle_velocities is None and tp.control_weight is None
    assert tp.to("cpu").sigma.device.type == "cpu"

    js = JState(
        u_prev=jnp.ones((5, 2), jnp.float32),
        waypoint_idx=jnp.asarray(3, jnp.int32),
        key=jnp.asarray([0xFFFFFFFF, 7], jnp.uint32),
    )
    ts = state_from_numpy(*(np.asarray(v) for v in js.tree_flatten()[0]))
    assert ts.key.tolist() == [0xFFFFFFFF, 7] and ts.key.dtype == torch.int64
    assert int(ts.waypoint_idx) == 3
    np.testing.assert_array_equal(ts.u_prev.numpy(), np.ones((5, 2), np.float32))


@pytest.mark.parametrize("which", ["unicycle", "euler", "rk4"])
def test_dynamics_and_integrators_match(which):
    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 1.0, (64, 3)).astype(np.float32)
    u = rng.normal(0.0, 1.0, (64, 2)).astype(np.float32)
    if which == "unicycle":
        want, got = j_unicycle(jnp.asarray(x), jnp.asarray(u)), unicycle(t32(x), t32(u))
    elif which == "euler":
        want = j_euler(j_unicycle, jnp.asarray(x), jnp.asarray(u), 0.05)
        got = euler_step(unicycle, t32(x), t32(u), 0.05)
    else:
        want = j_rk4(j_unicycle, jnp.asarray(x), jnp.asarray(u), 0.05)
        got = rk4_step(unicycle, t32(x), t32(u), 0.05)
    # float32 transcendentals of two libraries: a few ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "sigma",
    [[[0.1, 0.0], [0.0, 0.01]], [[0.2, 0.05], [0.05, 0.1]], [[1.0, 1.0], [1.0, 1.0]]],
    ids=["diag", "full", "singular_floor"],
)
def test_cholesky_and_inverse_match(sigma):
    s = np.asarray(sigma, np.float32)
    got = tsampling.small_cholesky(t32(s)).numpy()
    want = np.asarray(jsampling.small_cholesky(jnp.asarray(s)))
    # float32 on both sides; the singular case exercises the pivot floor
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(np.isfinite(got))
    if sigma[0][1] != 1.0:
        np.testing.assert_allclose(
            tsampling.sigma_inverse(t32(s)).numpy(),
            np.asarray(jsampling.sigma_inverse(jnp.asarray(s))),
            rtol=1e-6,
        )


def test_sample_noise_moments():
    """The scan path's own generator: distribution, not bits (torch and jax
    generators differ). 4σ bounds on mean and covariance at n = 409 600."""
    sigma = torch.tensor([[0.2, 0.05], [0.05, 0.1]])
    g = torch.Generator().manual_seed(0)
    eps = tsampling.sample_noise(g, sigma, 4096, 100)
    assert eps.shape == (4096, 100, 2) and eps.dtype == torch.float32
    e = eps.reshape(-1, 2).double()
    n = e.shape[0]
    d = torch.diagonal(sigma).double()
    assert torch.all(e.mean(0).abs() <= 4 * torch.sqrt(d / n))
    se = torch.sqrt((d[:, None] * d[None, :] + sigma.double() ** 2) / n)
    assert torch.all((torch.cov(e.T) - sigma.double()).abs() <= 4 * se)


@pytest.mark.parametrize("start", [0, 17, 39], ids=["head", "mid", "clipped_end"])
def test_nearest_waypoint_matches(start):
    rng = np.random.default_rng(start)
    path = np.stack([np.linspace(0, 4, 40), np.sin(np.linspace(0, 2, 40)), np.zeros(40)], 1)
    path[5] = path[4]  # an exact tie: first index wins
    path = path.astype(np.float32)
    xy = np.concatenate([rng.normal(1.5, 1.5, (200, 2)), path[4:5, :2]]).astype(np.float32)
    j_idx, j_ref = j_nearest(jnp.asarray(path), jnp.asarray(xy), jnp.asarray(start), 8)
    t_idx, t_ref = nearest_waypoint(t32(path), t32(xy), torch.tensor(start), 8)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_ref.numpy(), np.asarray(j_ref))


@pytest.mark.parametrize("mode", ["circle", "soft"])
def test_obstacle_costs_match(mode):
    rng = np.random.default_rng(3)
    xy = rng.uniform(-1, 3, (500, 2)).astype(np.float32)
    obs = np.array([[1.0, 0.4, 0.3], [2.5, 0.8, 0.4]], np.float32)
    if mode == "circle":
        want = jcosts.circle_robot_collision(jnp.asarray(xy), jnp.asarray(obs), 0.75)
        got = tcosts.circle_robot_collision(t32(xy), t32(obs), 0.75)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        want = jcosts.soft_obstacle_cost(jnp.asarray(xy), jnp.asarray(obs), 2.0, 100.0)
        got = tcosts.soft_obstacle_cost(t32(xy), t32(obs), 2.0, 100.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tcosts.COLLISION_PENALTY == jcosts.COLLISION_PENALTY


@pytest.mark.parametrize("kind", ["ma_edge", "ma_padded", "savgol"])
@pytest.mark.parametrize("window", [5, 10])
def test_filter_matrix_matches(kind, window):
    # both are float64 numpy built the same way: equal to rounding
    np.testing.assert_allclose(
        tfilters.filter_matrix(kind, 20, window, 3),
        jfilters.filter_matrix(kind, 20, window, 3),
        rtol=0, atol=1e-12,
    )


@pytest.mark.parametrize("kind", ["ma_edge", "ma_padded", "savgol", "none"])
def test_apply_filter_matches(kind):
    x = np.random.default_rng(4).normal(0, 1, (20, 2)).astype(np.float32)
    want = jfilters.apply_filter(jnp.asarray(x), kind, 7, 3)
    got = tfilters.apply_filter(t32(x), kind, 7, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_line_matches():
    want = np.asarray(j_line(jnp.array([0.0, 0.5]), jnp.array([6.0, -3.0]), num_points=120))
    got = line((0.0, 0.5), (6.0, -3.0), num_points=120).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "bad, match",
    [
        (torch.zeros(3, dtype=torch.float64), "float32"),
        (torch.zeros(4), "shape"),
        (torch.zeros(3, 2).T[0], "contiguous"),
    ],
    ids=["dtype", "shape", "contiguity"],
)
def test_kernel_argument_checks_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        check("x", bad, (3,), torch.device("cpu"))


def test_slope_timing_arithmetic():
    """The slope protocol with a fake clock: per-tick 2 ms, fixed 5 ms."""
    def make_runner(n):
        return lambda: n

    def wall(run):
        return 0.005 + 0.002 * run()

    t = slope_timing(make_runner, 10, 50, reps=4, wall=wall)
    assert t.tau == pytest.approx(0.002)
    assert t.p50 == pytest.approx(0.002)
    assert t.ticks_per_s == pytest.approx(500.0)
