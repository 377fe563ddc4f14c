"""The vendored scalar oracles (``testing/oracle.py``) against the JAX
package's, and the port's ticks against them, on the CPU.

* ``OracleMPPI`` (faithful and pure, the tick anchor and the rollout carry
  with and without the persisted maximum) and ``OracleRacecarMPPI`` step by
  step beside the JAX package's copies on the same ε: u0, the sequence, the
  costs and the carried state bit-equal;
* the port's scan path and the fused ticks' plain versions (rows 2 and 7 as
  a ``MPPISolver`` on CPU tensors runs them) against the pure-mode oracle
  on injected ε, as tests/test_mppi_parity.py and tests/test_mppi_racecar.py
  hold the JAX engine: one tick (costs rtol 2e-4 atol 1e-4 and rtol 3e-4
  atol 1e-3; u0 and the next sequence rtol 1e-4 atol 1e-5 and rtol 1e-3
  atol 1e-4), then closed loops of 15 and 10 ticks (u0 rtol 5e-3, atol
  5e-4 and 2e-3; the plants' states rtol 1e-3, atol 1e-3 and 2e-3).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.testing import oracle as joracle
from dnn_mppi_mpc_tpu_torch import presets
from dnn_mppi_mpc_tpu_torch.config import (
    MPPIConfig,
    SmoothingFilter,
    Temperature,
    params_from_numpy,
)
from dnn_mppi_mpc_tpu_torch.models import euler_step, unicycle
from dnn_mppi_mpc_tpu_torch.paths import lemniscate_with_speed
from dnn_mppi_mpc_tpu_torch.solvers.mppi import MPPISolver, make_tracking_costs
from dnn_mppi_mpc_tpu_torch.testing import oracle as toracle

K, T, DT = 128, 10, 0.1
SIGMA = np.array([[0.1, 0.0], [0.0, 0.01]])
RACE_SIGMA = np.array([[0.5, 0.0], [0.0, 0.1]])
OBSTACLES = np.array([[5.0, 5.0, 1.0], [7.0, 7.0, 1.0]])


def _line_path(n=100):
    return np.stack([np.linspace(0.0, 10.0, n), np.linspace(0.0, -5.0, n),
                     np.full(n, np.arctan2(-5.0, 10.0))], axis=1)


def _race_path():
    return lemniscate_with_speed(10.0, 100, device="cpu").double().numpy()


ORACLES = {
    "faithful": lambda m: m.OracleMPPI(ref_path=_line_path(), dt=DT, K=K, T=T, faithful=True),
    "pure": lambda m: m.OracleMPPI(ref_path=_line_path(), dt=DT, K=K, T=T, faithful=False),
    "pure rollout carry": lambda m: m.OracleMPPI(ref_path=_line_path(), dt=DT, K=K, T=T,
                                                 faithful=False, waypoint_carry="rollout"),
    "pure carry persisted": lambda m: m.OracleMPPI(
        ref_path=_line_path(), dt=DT, K=K, T=T, faithful=False, waypoint_carry="rollout",
        waypoint_persist="max", filter_window=5),
    "racecar": lambda m: m.OracleRacecarMPPI(ref_path=_race_path(), K=K, T=T,
                                             obstacles=OBSTACLES),
}


@pytest.mark.parametrize("name", list(ORACLES))
def test_vendored_oracles_bit_equal_to_jax(name):
    ours, theirs = ORACLES[name](toracle), ORACLES[name](joracle)
    race = name == "racecar"
    rng = np.random.default_rng(3)
    x = np.array([10.0, 0.0, np.pi / 2, 3.0]) if race else np.array([0.0, 0.1, 0.0])
    for _ in range(4):
        eps = rng.multivariate_normal(np.zeros(2), RACE_SIGMA if race else SIGMA, size=(K, T))
        a, b = ours.step(x.copy(), eps), theirs.step(x.copy(), eps)
        for got, want in zip(a, b):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ours.u_prev, theirs.u_prev)
        assert ours.prev_idx == theirs.prev_idx
        x = ours._transition(x, a[0])


def _diff_drive(route):
    cfg = MPPIConfig(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT, lam=1.0, alpha=0.2,
                     exploration=0.0001, temperature=Temperature.EXPLORATION,
                     filter=SmoothingFilter.MOVING_AVERAGE_EDGE, filter_window=10,
                     waypoint_search_len=20)
    params = params_from_numpy(SIGMA, [5.0, 5.0, 10.0], [5.0, 5.0, 10.0], [-5.0, -3.14],
                               [5.0, 3.14], _line_path(), device="cpu")

    def step(x, u):
        return euler_step(unicycle, x, u, DT)

    solver = MPPISolver(cfg, step, *make_tracking_costs(cfg), fused_tick=route == "fused",
                        device="cpu")
    oracle = toracle.OracleMPPI(ref_path=_line_path(), dt=DT, K=K, T=T, faithful=False)
    return solver, params, oracle, step, SIGMA, np.array([0.0, 0.0, 0.0]), np.zeros(3)


def _racecar(route):
    solver, params = presets.racecar_mppi(_race_path(), num_samples=K, horizon=T,
                                          obstacles=OBSTACLES, fused_tick=route == "fused",
                                          device="cpu")
    oracle = toracle.OracleRacecarMPPI(ref_path=_race_path(), K=K, T=T, obstacles=OBSTACLES)
    return (solver, params, oracle, solver.dynamics_step, RACE_SIGMA,
            np.array([10.0, 0.0, np.pi / 2, 3.0]), np.array([10.0, 0.0, np.pi / 2, 2.0]))


# (single tick: S, u0/u_prev; loop: u0, x) as (rtol, atol), from the JAX tests
LIMITS = {"diff_drive": ((2e-4, 1e-4), (1e-4, 1e-5), (5e-3, 5e-4), (1e-3, 1e-3), 42, 7, 15),
          "racecar": ((3e-4, 1e-3), (1e-3, 1e-4), (5e-3, 2e-3), (1e-3, 2e-3), 11, 13, 10)}


@pytest.mark.parametrize("route", ["scan", "fused"])
@pytest.mark.parametrize("problem", ["diff_drive", "racecar"])
def test_port_ticks_match_the_pure_oracle(problem, route):
    make = _diff_drive if problem == "diff_drive" else _racecar
    lim_S, lim_u, lim_loop, lim_x, seed_tick, seed_loop, ticks = LIMITS[problem]
    solver, params, oracle, step, sigma, x_tick, x_loop = make(route)
    assert (solver.tick_fn is None) == (route == "scan")
    eps = np.random.default_rng(seed_tick).multivariate_normal(np.zeros(2), sigma, size=(K, T))
    u0_o, _, S_o = oracle.step(x_tick, eps)
    u0, st, aux = solver.step(params, solver.init(), torch.tensor(x_tick, dtype=torch.float32),
                              noise=torch.tensor(eps, dtype=torch.float32))
    np.testing.assert_allclose(aux.costs.numpy(), S_o, rtol=lim_S[0], atol=lim_S[1])
    np.testing.assert_allclose(u0.numpy(), u0_o, rtol=lim_u[0], atol=lim_u[1])
    np.testing.assert_allclose(st.u_prev.numpy(), oracle.u_prev, rtol=lim_u[0], atol=lim_u[1])

    oracle = make(route)[2]
    rng = np.random.default_rng(seed_loop)
    x_o, x, st = x_loop.copy(), torch.tensor(x_loop, dtype=torch.float32), solver.init()
    for _ in range(ticks):
        eps = rng.multivariate_normal(np.zeros(2), sigma, size=(K, T))
        u0_o, _, _ = oracle.step(x_o, eps)
        u0, st, _ = solver.step(params, st, x, noise=torch.tensor(eps, dtype=torch.float32))
        np.testing.assert_allclose(u0.numpy(), u0_o, rtol=lim_loop[0], atol=lim_loop[1])
        x_o = oracle._transition(x_o, u0_o)
        x = step(x, u0)
    np.testing.assert_allclose(x.numpy(), x_o, rtol=lim_x[0], atol=lim_x[1])
