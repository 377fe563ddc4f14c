"""The port's CEM solver (``solvers/cem.py``) against the JAX package's, on
the CPU.

* ``cem_step`` against JAX's ``cem_step`` on tests/test_cem.py's problem,
  fed the ε JAX draws itself (``jax.random.split(state.key, num_iters + 1)``,
  then ``jax.random.normal(iter_key, (K, T, nu))`` an iteration,
  solvers/cem.py:121,133): u0, the shifted mean and std and the elite and
  best costs within rtol 1e-5, atol 1e-6, the waypoint index exact, over
  three chained ticks, at 4 iterations and at 1; each iteration's elite cut
  has a cost gap (in a float64 rerun of the same iteration) wider than the
  costs' agreement (``S_ATOL``), so both packages keep the same elite;
* ``cem_state_from_numpy``: a JAX state carried across gives JAX's next
  tick;
* JAX's three behaviour tests (tests/test_cem.py) and
  ``test_cem_time_varying`` (tests/test_time_varying.py:185) on the port,
  ε from the solver's own generator;
* the guards (ε shape, no ε and no generator).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.config import MPPIConfig as JMPPIConfig
from dnn_mppi_mpc_tpu.config import MPPIParams as JMPPIParams
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.paths.generators import line as j_line
from dnn_mppi_mpc_tpu.solvers import cem as jcem
from dnn_mppi_mpc_tpu.solvers.mppi import make_tracking_costs as j_costs
from dnn_mppi_mpc_tpu_torch.config import MPPIConfig, params_from_numpy
from dnn_mppi_mpc_tpu_torch.models import euler_step, unicycle
from dnn_mppi_mpc_tpu_torch.solvers import cem as tcem
from dnn_mppi_mpc_tpu_torch.solvers.mppi import MPPISolver, make_tracking_costs

DT, K, T = 0.1, 256, 15
# the port's and JAX's per-sample costs agree well within this (float32
# rollouts of ~10-100 summed over 15 steps, sin/cos one ulp apart)
S_ATOL = 1e-4
SIGMA = [[0.1, 0.0], [0.0, 0.05]]
W_STAGE = [5.0, 5.0, 2.0]
U_MIN, U_MAX = [-2.0, -2.0], [2.0, 2.0]


def _path():
    return np.asarray(j_line(jnp.zeros(2), jnp.array([6.0, 0.0]), 80), np.float32)


def _jax_problem(num_iters):
    mcfg = JMPPIConfig(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT)
    params = JMPPIParams(sigma=jnp.array(SIGMA), stage_weight=jnp.array(W_STAGE),
                         terminal_weight=jnp.array(W_STAGE), u_min=jnp.array(U_MIN),
                         u_max=jnp.array(U_MAX), ref_path=jnp.asarray(_path()))
    ccfg = jcem.CEMConfig(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT, num_iters=num_iters)
    step = lambda x, u: j_euler(j_unicycle, x, u, DT)
    return ccfg, params, step, *j_costs(mcfg)


def _port_problem(num_iters, **cfg_kw):
    mcfg = MPPIConfig(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT)
    params = params_from_numpy(SIGMA, W_STAGE, W_STAGE, U_MIN, U_MAX, _path(), device="cpu")
    ccfg = tcem.CEMConfig(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT,
                          num_iters=num_iters, **cfg_kw)
    step = lambda x, u: euler_step(unicycle, x, u, DT)
    return ccfg, params, step, *make_tracking_costs(mcfg)


def _jax_noise(key, num_iters):
    """The ε JAX's cem_step draws from ``key`` (solvers/cem.py:121,133)."""
    _, *iter_keys = jax.random.split(key, num_iters + 1)
    return np.stack([np.asarray(jax.random.normal(k, (K, T, 2), jnp.float32))
                     for k in iter_keys])


def _elite_gaps(ccfg, mean, std, wp_start, x0, noise):
    """Each iteration's cost gap at the elite cut, the iterations rerun in
    float64 numpy (tracking costs of the tick's window, Euler unicycle)."""
    path = _path().astype(np.float64)
    W = min(ccfg.waypoint_search_len, len(path))
    start = min(max(wp_start, 0), len(path) - W)
    window = path[start:start + W]
    w = np.asarray(W_STAGE)
    n_elite = max(1, int(K * ccfg.elite_fraction))

    def track(x):
        d = ((x[:, None, :2] - window[None, :, :2]) ** 2).sum(-1)
        ref = window[d.argmin(1)]
        return ((x - ref) ** 2 * w).sum(-1)

    gaps = []
    mean, std = mean.astype(np.float64), std.astype(np.float64)
    for eps in noise.astype(np.float64):
        v = np.clip(mean[None] + std[None] * eps, U_MIN, U_MAX)
        x, S = np.broadcast_to(x0, (K, 3)).astype(np.float64), np.zeros(K)
        for t in range(T):
            x = x + DT * np.stack([v[:, t, 0] * np.cos(x[:, 2]), v[:, t, 0] * np.sin(x[:, 2]),
                                   v[:, t, 1]], -1)
            S = S + track(x)
        S = S + track(x)
        order = np.argsort(S, kind="stable")
        gaps.append(S[order[n_elite]] - S[order[n_elite - 1]])
        elite = v[order[:n_elite]]
        m = ccfg.momentum
        mean = m * mean + (1 - m) * elite.mean(0)
        std = m * std + (1 - m) * np.maximum(elite.std(0), ccfg.min_std)
    return gaps


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("num_iters", [4, 1])
def test_cem_step_matches_jax(num_iters):
    jp = _jax_problem(num_iters)
    tcfg, tparams, tstep, tstage, tterm = _port_problem(num_iters)
    jstate = jcem.CEMState.init(jp[0], jax.random.PRNGKey(5))
    tstate = tcem.CEMState.init(tcfg, device="cpu")
    x = np.array([0.1, -0.2, 0.05], np.float32)
    jstep = jax.jit(lambda s, xx: jcem.cem_step(*jp[:1], jp[2], jp[3], jp[4], jp[1], s, xx))
    for _ in range(3):
        noise = _jax_noise(jstate.key, num_iters)
        gaps = _elite_gaps(tcfg, tstate.mean.numpy(), tstate.std.numpy(),
                           int(tstate.waypoint_idx), x, noise)
        assert min(gaps) > S_ATOL, gaps
        ju0, jstate_next, jaux = jstep(jstate, jnp.asarray(x))
        tu0, tstate, taux = tcem.cem_step(tcfg, tstep, tstage, tterm, tparams, tstate,
                                          torch.as_tensor(x), torch.as_tensor(noise))
        _close(tu0, ju0)
        _close(tstate.mean, jstate_next.mean)
        _close(tstate.std, jstate_next.std)
        assert int(tstate.waypoint_idx) == int(jstate_next.waypoint_idx)
        _close(taux.elite_cost, jaux.elite_cost)
        _close(taux.best_cost, jaux.best_cost)
        jstate = jstate_next
        x = np.array(j_euler(j_unicycle, jnp.asarray(x), ju0, DT), np.float32)


def test_cem_state_from_numpy_carries_a_jax_state():
    jp = _jax_problem(3)
    tcfg, tparams, tstep, tstage, tterm = _port_problem(3)
    jstate = jcem.CEMState.init(jp[0], jax.random.PRNGKey(2))
    x = jnp.array([0.3, 0.1, 0.0])
    for _ in range(2):
        u0, jstate, _ = jcem.cem_step(jp[0], jp[2], jp[3], jp[4], jp[1], jstate, x)
        x = j_euler(j_unicycle, x, u0, DT)
    tstate = tcem.cem_state_from_numpy(np.asarray(jstate.mean), np.asarray(jstate.std),
                                       np.asarray(jstate.waypoint_idx), device="cpu")
    noise = _jax_noise(jstate.key, 3)
    ju0, jnext, _ = jcem.cem_step(jp[0], jp[2], jp[3], jp[4], jp[1], jstate, x)
    tu0, tnext, _ = tcem.cem_step(tcfg, tstep, tstage, tterm, tparams, tstate,
                                  torch.as_tensor(np.asarray(x)), torch.as_tensor(noise))
    _close(tu0, ju0)
    _close(tnext.mean, jnext.mean)
    assert tstate.mean.dtype == torch.float32 and tstate.waypoint_idx.dtype == torch.int64


# --- JAX's behaviour tests on the port ----------------------------------------------------


def _solver(num_iters, seed, **cfg_kw):
    ccfg, params, step, stage, terminal = _port_problem(num_iters, **cfg_kw)
    return tcem.CEMSolver(ccfg, step, stage, terminal, device="cpu", seed=seed), params, step


def test_cem_iterations_reduce_cost():
    solver, params, _ = _solver(6, 0)
    _, _, aux = solver.step(params, solver.init(), torch.zeros(3))
    assert np.isfinite(float(aux.best_cost))
    one, _, _ = _solver(1, 0)
    _, _, aux1 = one.step(params, one.init(), torch.zeros(3))
    assert float(aux.best_cost) < float(aux1.best_cost)


def test_cem_closed_loop_tracks_line():
    solver, params, step = _solver(4, 1)
    x, st = torch.zeros(3), solver.init()
    for _ in range(80):
        u0, st, _ = solver.step(params, st, x)
        x = step(x, u0)
    assert float(x[0]) > 0.5, f"no progress: {x}"
    assert abs(float(x[1])) < 0.5, f"off path: {x}"
    assert bool(torch.isfinite(x).all())


def test_cem_comparable_to_mppi():
    """Same problem, same budget: CEM's progress in MPPI's league (sanity,
    not superiority), as tests/test_cem.py."""
    ccfg, params, step, stage, terminal = _port_problem(3)
    mcfg = MPPIConfig(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT)
    mppi = MPPISolver(mcfg, step, stage, terminal, device="cpu", seed=2)
    cem = tcem.CEMSolver(ccfg, step, stage, terminal, device="cpu", seed=2)

    def run(solver):
        x, st = torch.zeros(3), solver.init()
        for _ in range(60):
            u0, st, _ = solver.step(params, st, x)
            x = step(x, u0)
        return float(x[0])

    prog_mppi, prog_cem = run(mppi), run(cem)
    assert prog_cem > 0.3 * max(prog_mppi, 0.3), (prog_cem, prog_mppi)


def test_cem_time_varying():
    """F(x, u, t) with time-decaying actuation (tests/test_time_varying.py)."""
    def dyn_tv(x, u, t):
        decay = 1.0 / (1.0 + 0.1 * t * 0.05)
        v, w, yaw = u[..., 0] * decay, u[..., 1] * decay, x[..., 2]
        return torch.stack([x[..., 0] + v * torch.cos(yaw) * 0.05,
                            x[..., 1] + v * torch.sin(yaw) * 0.05, yaw + w * 0.05], -1)

    mcfg = MPPIConfig(num_samples=128, horizon=8, dim_x=3, dim_u=2, dt=0.05)
    ccfg = tcem.CEMConfig(num_samples=128, horizon=8, dim_x=3, dim_u=2, dt=0.05, num_iters=3,
                          time_varying_dynamics=True)
    params = params_from_numpy(SIGMA, W_STAGE, W_STAGE, U_MIN, U_MAX, _path(), device="cpu")
    solver = tcem.CEMSolver(ccfg, dyn_tv, *make_tracking_costs(mcfg), device="cpu")
    u0, _, aux = solver.step(params, solver.init(), torch.zeros(3))
    assert bool(torch.isfinite(u0).all()) and np.isfinite(float(aux.best_cost))


def test_cem_guards():
    ccfg, params, step, stage, terminal = _port_problem(2)
    state = tcem.CEMState.init(ccfg, device="cpu")
    with pytest.raises(ValueError, match="noise has shape"):
        tcem.cem_step(ccfg, step, stage, terminal, params, state, torch.zeros(3),
                      torch.zeros(1, K, T, 2))
    with pytest.raises(ValueError, match="torch.Generator"):
        tcem.cem_step(ccfg, step, stage, terminal, params, state, torch.zeros(3))
