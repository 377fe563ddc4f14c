"""The JAX package's CPU run of ``chip_smoke.py`` phase 12's pipeline: the
figures the phase prints beside the card's, and the gates it holds the card
to (JAX meets every one but the tracking ratio, see below).

The pipeline is the card's: the CLI's collect protocol (cli.py:322-400: 8
series × 200 ticks, K = 512, T = 20, the wheel-efficiency plant) on JAX's
PRNG; the reference's deployment MLP (5→512×3→3, zero head, 50 epochs of
batch 256 at lr 1e-3) through JAX's ``train_residual_model``; then

* the residual fit, rms(errors − net(features)) / rms(errors) over every
  row (gate 0.35, tests/test_mppi_learned.py:124);
* ``presets.dnn_nmpc`` over the net as a rate residual (the out-scaler over
  dt) to (2.0, 1.5) on the plant in continuous time (ERK, 3 steps a tick),
  60 ticks: the goal error (gate 0.15, tests/test_e2e_dnn_pipeline.py:145);
* PPO with ``ActorCritic`` (hidden 128, depth 2) on the point-goal task, 32
  environments × 64 steps, 80 iterations from PRNGKey(0): the mean reward
  of the first and the last five iterations (gate: late above early);
* (slow: minutes on a CPU) ``presets.dnn_mppi`` (K = 1 024, T = 25) on the line
  (0, 0) → (4, 2) from (0, 0.6, 0), 200 ticks on the plant: the nominal
  step (a zero residual) and the net, each over keys 0 to
  ``chip_smoke.DEPLOY_EPISODES`` − 1, the mean of each episode's
  steady-state RMS distance to the path (gates: corrected < 1.15 · nominal
  and < 0.5, tests/test_mppi_learned.py:132-133).

JAX runs with x64 off, as the package runs outside this suite. Figures to
1e-2 (the tracking means to 2e-2: each episode is chaotic at nearly
one-hot weights, and how XLA fuses one loop moves single episodes).
Run pytest from the repository root (it imports ``chip_smoke``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnn_mppi_mpc_tpu import presets as jpresets
from dnn_mppi_mpc_tpu.config import MPPIConfig, MPPIParams
from dnn_mppi_mpc_tpu.envs.closed_loop import (
    collect_residual_dataset,
    mppi_controller,
    run_closed_loop,
)
from dnn_mppi_mpc_tpu.models import euler_step, unicycle
from dnn_mppi_mpc_tpu.models.integrators import erk_step
from dnn_mppi_mpc_tpu.models.learned import (
    MLP,
    Standardizer,
    make_residual_fn,
    residual_from_train_state,
)
from dnn_mppi_mpc_tpu.paths.generators import line
from dnn_mppi_mpc_tpu.solvers.mppi import MPPISolver, MPPIState, make_tracking_costs
from dnn_mppi_mpc_tpu.train.rl import ActorCritic, PPOConfig, make_ppo_trainer
from dnn_mppi_mpc_tpu.train.training import TrainConfig, train_residual_model


def u_eff(u):
    return jnp.stack([0.85 * u[..., 0], 0.9 * u[..., 1] + 0.05 * u[..., 0]], -1)


def plant(x, u):
    return euler_step(unicycle, x, u_eff(u), 0.05)


def plant_rates(x, u):
    ue = u_eff(u)
    return jnp.stack([ue[..., 0] * jnp.cos(x[..., 2]), ue[..., 0] * jnp.sin(x[..., 2]),
                      ue[..., 1]], -1)


def collect(cs):
    """The CLI's collect protocol (cli.py:335-399) on JAX's PRNG."""
    dt = cs.DT_COLLECT
    cfg = MPPIConfig(num_samples=cs.K_COLLECT, horizon=cs.T_COLLECT, dim_x=3, dim_u=2, dt=dt,
                     compute_optimal_traj=False)

    def nominal(x, u):
        return euler_step(unicycle, x, u, dt)

    solver = MPPISolver(cfg, nominal, *make_tracking_costs(cfg))

    def factory(key):
        k1, k2 = jax.random.split(key)
        start = jax.random.uniform(k1, (2,), minval=-3.0, maxval=3.0)
        goal = jax.random.uniform(k2, (2,), minval=-8.0, maxval=8.0)
        params = MPPIParams(sigma=jnp.array([[0.1, 0.0], [0.0, 0.05]]),
                            stage_weight=jnp.array([5.0, 5.0, 2.0]),
                            terminal_weight=jnp.array([5.0, 5.0, 2.0]),
                            u_min=jnp.array([-3.0, -3.14]), u_max=jnp.array([3.0, 3.14]),
                            ref_path=line(start, goal, 100))

        def controller(cs_, x):
            u0, cs_, _ = solver._step(params, cs_, x, None)
            return u0, cs_

        return controller, MPPIState.init(cfg, key)

    def x0_sampler(key):
        return jnp.concatenate([jax.random.uniform(key, (2,), minval=-3.0, maxval=3.0),
                                jnp.zeros(1)])

    return collect_residual_dataset(factory, plant, nominal, x0_sampler,
                                    jax.random.PRNGKey(cs.COLLECT_SEED), cs.COLLECT_SERIES,
                                    cs.COLLECT_TICKS)


def fit_ratio(net, ep) -> float:
    feats = jnp.concatenate([ep.states, ep.controls], -1)
    err = np.asarray(ep.errors, np.float64)
    return float(np.sqrt(np.mean((err - np.asarray(net(feats), np.float64)) ** 2))
                 / np.sqrt(np.mean(err ** 2)))


def tracking_rmse(cs, fn, ticks: int, keys) -> float:
    """``presets.dnn_mppi`` over ``fn`` on the deploy line, one episode a key:
    the mean of the episodes' steady-state RMS distance to the path."""
    ref = line(jnp.zeros(2), jnp.asarray(cs.DEPLOY_END, jnp.float32), num_points=cs.DEPLOY_POINTS)
    solver, params = jpresets.dnn_mppi(ref, fn, num_samples=cs.DEPLOY_K)
    path = np.asarray(ref[:, :2], np.float64)

    @jax.jit
    def episode(key):
        ep, _ = run_closed_loop(mppi_controller(solver, params), plant, solver.init(key),
                                jnp.asarray(cs.DEPLOY_X0, jnp.float32), ticks)
        return ep.states

    out = []
    for k in keys:
        xy = np.asarray(episode(jax.random.PRNGKey(k))[:, :2], np.float64)
        d = np.linalg.norm(xy[:, None] - path[None], axis=-1).min(1)
        out.append(float(np.sqrt(np.mean(d[ticks // 2:] ** 2))))
    return float(np.mean(out))


@pytest.fixture(scope="module")
def pipeline():
    import chip_smoke as cs

    with jax.enable_x64(False):
        ep = collect(cs)
        model = MLP(out_dim=3, hidden=cs.TRAIN_HIDDEN, depth=cs.TRAIN_DEPTH)
        tstate, hist = train_residual_model(model, ep.states, ep.controls, ep.errors,
                                            TrainConfig(**cs.TRAIN_CFG))
    return cs, ep, model, tstate, hist


def nmpc_goal_err(cs, model, tstate) -> float:
    dt = cs.DT_COLLECT
    rate = make_residual_fn(model, tstate.params, tstate.in_scaler,
                            Standardizer(tstate.out_scaler.mean / dt, tstate.out_scaler.std / dt))
    goal = jnp.asarray(cs.NMPC_GOAL, jnp.float32)
    solver, params = jpresets.dnn_nmpc(goal, rate, dt=cs.NMPC_DT)
    solve = jax.jit(solver.solve)
    x = jnp.zeros(3, jnp.float32)
    st = solver.init(x)
    for _ in range(cs.NMPC_TICKS):
        u0, st, _ = solve(params, st, x)
        x = erk_step(plant_rates, x, u0, cs.NMPC_DT, num_steps=3)
    return float(jnp.linalg.norm(x[:2] - goal[:2]))


def ppo_rewards(cs) -> tuple:
    dt = cs.PPO_DT

    def env_reset(key):
        return jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0)

    def env_step(state, action, key):
        action = jnp.clip(action, -1.0, 1.0)
        nxt = jnp.clip(state + dt * action, -1.5, 1.5)
        return nxt, -jnp.sum(nxt ** 2) - 0.01 * jnp.sum(action ** 2), jnp.linalg.norm(nxt) < 0.05

    cfg = PPOConfig(**cs.PPO_CFG)
    init_fn, train_iter = make_ppo_trainer(cfg, ActorCritic(act_dim=2), env_step, env_reset)
    key = jax.random.PRNGKey(0)
    params, opt_state = init_fn(key)
    env_states = jax.vmap(env_reset)(jax.random.split(key, cfg.num_envs))
    rewards = []
    for _ in range(cs.PPO_ITERS):
        params, opt_state, env_states, key, m = train_iter(params, opt_state, env_states, key)
        rewards.append(float(m["mean_reward"]))
    return float(np.mean(rewards[:5])), float(np.mean(rewards[-5:]))


def test_chip_smoke_training_jax_references(pipeline):
    cs, ep, model, tstate, hist = pipeline
    with jax.enable_x64(False):
        got = {"mlp_fit_ratio": fit_ratio(residual_from_train_state(model, tstate), ep),
               "nmpc_goal_err_m": nmpc_goal_err(cs, model, tstate)}
        got["ppo_reward_early"], got["ppo_reward_late"] = ppo_rewards(cs)
    print("JAX CPU references:", got, "val_mse", hist["val_mse"][0], hist["val_mse"][-1])
    assert hist["val_mse"][-1] < hist["val_mse"][0]
    assert got["mlp_fit_ratio"] < cs.FIT_RATIO_MLP and got["nmpc_goal_err_m"] < cs.NMPC_ERR_LIMIT
    assert got["ppo_reward_late"] > got["ppo_reward_early"]
    for key, value in got.items():
        np.testing.assert_allclose(value, cs.TRAIN_JAX_REFERENCE[key], rtol=0.0, atol=1e-2,
                                   err_msg=key)


@pytest.mark.slow
def test_chip_smoke_tracking_jax_references(pipeline):
    cs, ep, model, tstate, _ = pipeline
    with jax.enable_x64(False):
        net = residual_from_train_state(model, tstate)
        got = {"rmse_nominal_m": tracking_rmse(cs, lambda f: jnp.zeros(f.shape[:-1] + (3,)),
                                               cs.DEPLOY_TICKS, range(cs.DEPLOY_EPISODES)),
               "rmse_dnn_m": tracking_rmse(cs, net, cs.DEPLOY_TICKS, range(cs.DEPLOY_EPISODES))}
    print("JAX CPU references:", got, "ratio", got["rmse_dnn_m"] / got["rmse_nominal_m"])
    # JAX's own run misses the ratio gate the card is held to (1.36 against
    # 1.15: at this plant's small wheel error its corrected model predicts a
    # step better but does not track better here); it meets the absolute one
    assert got["rmse_dnn_m"] < cs.RMSE_LIMIT and got["rmse_nominal_m"] < cs.RMSE_LIMIT
    for key, value in got.items():
        np.testing.assert_allclose(value, cs.TRAIN_JAX_REFERENCE[key], rtol=0.0, atol=2e-2,
                                   err_msg=key)


def test_reference_pipeline_is_the_card_s():
    """The constants this file reads are the ones chip_smoke.py runs."""
    import chip_smoke as cs

    assert cs.TRAIN_DIMS == (5, cs.TRAIN_HIDDEN, cs.TRAIN_HIDDEN, cs.TRAIN_HIDDEN, 3)
    assert dataclasses.asdict(TrainConfig(**cs.TRAIN_CFG)) == {
        "learning_rate": 1e-3, "batch_size": 256, "num_epochs": 50, "weight_decay": 0.0,
        "seed": 0}
    assert (cs.K_COLLECT, cs.T_COLLECT, cs.COLLECT_SERIES, cs.COLLECT_TICKS) == (512, 20, 8, 200)
