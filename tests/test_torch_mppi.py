"""The port's MPPI slice as a whole against the JAX package.

* a 5-tick closed loop of the port's ``MPPISolver(fused_tick=True)`` against
  the JAX engine with its fused Pallas tick (interpret mode), the same
  injected ε each tick; trajectories to rtol 1e-3 / atol 1e-4 as
  tests/test_mppi_tick.py::test_tick_closed_loop_matches_scan;
* the scan path and the split-rollout path against the JAX ones (S rtol and
  atol 2e-4, w rtol 2e-4 atol 1e-6, controls rtol 1e-4 atol 1e-5);
* routing, the guards on unported options, that importing the port never
  imports JAX, and that the scripts that run only on the card read no name
  they do not bind.
"""

from __future__ import annotations

import ast
import builtins
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch import presets
from dnn_mppi_mpc_tpu_torch.models import euler_step, unicycle, unicycle_tile
from dnn_mppi_mpc_tpu_torch.paths import (
    circle_with_speed,
    lemniscate,
    lemniscate_with_speed,
    line,
)
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi
from dnn_mppi_mpc_tpu_torch.solvers import sqp as tsqp

DT = 0.05
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_ENUMS = {"accumulation": "CostAccumulation", "filter": "SmoothingFilter",
          "temperature": "Temperature"}


def _cfg(module, kw):
    """module.MPPIConfig from keyword arguments, enum fields given by value."""
    return module.MPPIConfig(
        **{k: getattr(module, _ENUMS[k])(v) if k in _ENUMS else v for k, v in kw.items()}
    )


def _problem(K=512, T=12, W=8, collision="none", params_kw=None, **cfg_kw):
    kw = dict(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT, lam=0.8, alpha=0.3,
              exploration=0.2, filter_window=5, waypoint_search_len=W)
    kw.update(cfg_kw)
    n = 40
    p = dict(
        sigma=np.array([[0.2, 0.05], [0.05, 0.1]], np.float32),
        stage_weight=np.array([4.0, 4.0, 0.5], np.float32),
        terminal_weight=np.array([9.0, 9.0, 2.0], np.float32),
        u_min=np.array([-1.5, -2.0], np.float32),
        u_max=np.array([1.5, 2.0], np.float32),
        ref_path=np.stack([np.linspace(0, 4, n), np.sin(np.linspace(0, 2, n)),
                           np.linspace(0.1, 0.5, n)], 1).astype(np.float32),
    )
    p.update({k: np.asarray(v, np.float32) for k, v in (params_kw or {}).items()})
    jc, tc = _cfg(jcfg, kw), _cfg(tcfg, kw)
    jp = jcfg.MPPIParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = tcfg.params_from_numpy(**p, device="cpu")
    jsc, jtc = jmppi.make_tracking_costs(jc, collision=collision)
    tsc, ttc = tmppi.make_tracking_costs(tc, collision=collision)
    return (jc, jp, lambda x, u: j_euler(j_unicycle, x, u, DT), jsc, jtc), (
        tc, tp, lambda x, u: euler_step(unicycle, x, u, DT), tsc, ttc)


def _noise(cfg, sigma, seed):
    rng = np.random.default_rng(seed)
    return rng.multivariate_normal(
        np.zeros(2), np.asarray(sigma), (cfg.num_samples, cfg.horizon)
    ).astype(np.float32)


def _key_words(key):
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key).astype(np.int64).tolist()


@pytest.mark.parametrize("iso_xy", [False, True])
def test_closed_loop_fused_tick_matches_jax(iso_xy):
    jside, tside = _problem(collision="circle",
                            params_kw=dict(obstacles=[[1.0, 0.4, 0.3], [2.5, 0.8, 0.4]]))
    jc, jp, jstep, jsc, jtc = jside
    tc, tp, tstep, tsc, ttc = tside
    jtick = jmppi.make_pallas_diffdrive_tick(jc, robot_radius=0.5, interpret=True,
                                             fuse_epilogue=True, iso_xy=iso_xy)
    jrun = jax.jit(lambda p, s, x, n: jmppi.mppi_step(jc, jstep, jsc, jtc, p, s, x, n,
                                                      tick_fn=jtick))
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, fused_tick=True, iso_xy=iso_xy,
                              device="cpu")
    assert solver.tick_fn.__qualname__.startswith("make_cuda_diffdrive_tick.")
    x_j = jnp.array([0.0, 0.2, 0.0], jnp.float32)
    x_t = torch.tensor([0.0, 0.2, 0.0])
    st_j, st_t = jmppi.MPPIState.init(jc), solver.init()
    for i in range(5):
        eps = _noise(jc, jp.sigma, 100 + i)
        u_j, st_j, aux_j = jrun(jp, st_j, x_j, jnp.asarray(eps))
        u_t, st_t, aux_t = solver.step(tp, st_t, x_t, torch.as_tensor(eps))
        x_j, x_t = jstep(x_j, u_j), tstep(x_t, u_t)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev),
                                   rtol=1e-3, atol=1e-4)
        assert int(st_t.waypoint_idx) == int(st_j.waypoint_idx)
        assert st_t.key.tolist() == _key_words(st_j.key)
        assert int(aux_t.status) == int(aux_j.status) == 0


SCAN_CASES = {
    "sum": dict(),
    "last_circle": dict(collision="circle", accumulation="last",
                        params_kw=dict(obstacles=[[1.0, 0.4, 0.3], [2.5, 0.8, 0.4]])),
    "soft_drift_control_cost": dict(
        collision="soft", filter="savgol",
        params_kw=dict(obstacles=[[1.2, 0.9, 0.3], [2.2, 1.6, 0.4]],
                       obstacle_velocities=[[0.5, 0.3], [-0.4, 0.2]],
                       control_weight=[0.1, 0.1])),
    "repeats_exploration_temp": dict(num_rollout_repeats=2, rollout_var_cost=0.5,
                                     temperature="exploration", exploration=0.5,
                                     filter="ma_padded"),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_path_matches_jax(case):
    jside, tside = _problem(compute_optimal_traj=True, **SCAN_CASES[case])
    jc, jp, jstep, jsc, jtc = jside
    tc, tp, tstep, tsc, ttc = tside
    eps = _noise(jc, jp.sigma, 7)
    u_prev = np.random.default_rng(0).normal(0, 0.3, (jc.horizon, 2)).astype(np.float32)
    x0 = np.array([0.1, -0.05, 0.2], np.float32)
    st_j = jmppi.MPPIState(u_prev=jnp.asarray(u_prev), waypoint_idx=jnp.asarray(2, jnp.int32),
                           key=jax.random.PRNGKey(0))
    u_j, st_j, aux_j = jax.jit(
        lambda p, s, x, n: jmppi.mppi_step(jc, jstep, jsc, jtc, p, s, x, n)
    )(jp, st_j, jnp.asarray(x0), jnp.asarray(eps))
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, device="cpu")
    u_t, st_t, aux_t = solver.step(tp, tmppi.state_from_numpy(u_prev, 2, [0, 0], device="cpu"),
                                   torch.as_tensor(x0), torch.as_tensor(eps))
    np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(aux_t.weights.numpy(), np.asarray(aux_j.weights),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aux_t.optimal_traj.numpy(), np.asarray(aux_j.optimal_traj),
                               rtol=1e-4, atol=1e-5)
    assert int(aux_t.status) == int(aux_j.status)
    assert int(st_t.waypoint_idx) == int(st_j.waypoint_idx)


def test_split_rollout_path_matches_jax():
    jside, tside = _problem(collision="circle", accumulation="last",
                            params_kw=dict(obstacles=[[1.0, 0.4, 0.3], [2.5, 0.8, 0.4]]))
    jc, jp, jstep, jsc, jtc = jside
    tc, tp, tstep, tsc, ttc = tside
    eps = _noise(jc, jp.sigma, 11)
    x0 = np.array([0.1, -0.05, 0.2], np.float32)
    rollout = jmppi.make_pallas_diffdrive_rollout(jc, robot_radius=0.5, interpret=True)
    u_j, st_j, aux_j = jax.jit(
        lambda p, s, x, n: jmppi.mppi_step(jc, jstep, jsc, jtc, p, s, x, n, rollout_fn=rollout)
    )(jp, jmppi.MPPIState.init(jc), jnp.asarray(x0), jnp.asarray(eps))
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, use_kernel=True, device="cpu")
    assert solver.rollout_fn is not None and solver.tick_fn is None
    u_t, st_t, aux_t = solver.step(tp, solver.init(), torch.as_tensor(x0), torch.as_tensor(eps))
    np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "K, T, kw, route",
    [
        (10240, 50, dict(fused_tick=True), "make_cuda_diffdrive_tick"),
        (102400, 50, dict(fused_tick=True), "make_cuda_diffdrive_tick_blocked"),
        (10240, 50, dict(use_kernel=True), "make_cuda_diffdrive_rollout"),
    ],
    ids=["single_block", "k_blocked", "split_rollout"],
)
def test_solver_routes_like_jax(K, T, kw, route):
    cfg, params, step, stage, terminal = presets.flagship(K, T, "cpu")
    solver = tmppi.MPPISolver(cfg, step, stage, terminal, device="cpu", **kw)
    fn = solver.tick_fn or solver.rollout_fn
    assert fn.__qualname__.split(".")[0] == route
    if route.endswith("_blocked"):
        assert tmppi._pick_k_block(K, T) == jmppi._pick_k_block(K, T) == 10240


def test_flagship_preset_matches_jax():
    from __graft_entry__ import _flagship

    jc, jp, *_ = _flagship(1024, 20)
    tc, tp, *_ = presets.flagship(1024, 20, "cpu")
    for f in dataclasses.fields(tc):
        tv = getattr(tc, f.name)
        jv = getattr(jc, "use_pallas" if f.name == "use_kernel" else f.name)
        assert (tv.value if hasattr(tv, "value") else tv) == (jv.value if hasattr(jv, "value") else jv)
    for name in ("sigma", "stage_weight", "terminal_weight", "u_min", "u_max", "ref_path"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))


def _flag(**cfg_kw):
    cfg, params, step, stage, terminal = presets.flagship(1024, 20, "cpu")
    return dataclasses.replace(cfg, **cfg_kw), params, step, stage, terminal


GUARDS = {
    # the K-blocked route has no carry (the single-block tick runs it:
    # tests/test_torch_waypoint_carry.py)
    "waypoint_carry_rollout": (dict(waypoint_carry="rollout", num_samples=102400),
                               dict(fused_tick=True), "waypoint_carry"),
    "lean": ({}, dict(fused_tick=True, lean=True), "lean"),
    "fold_anchor": ({}, dict(fused_tick=True, fold_anchor=True), "fold_anchor"),
    "sincos_poly": ({}, dict(fused_tick=True, sincos="poly"), "sincos"),
    "gaussian_popcount": ({}, dict(fused_tick=True, gaussian="popcount"), "gaussian"),
    "tile_dynamics_without_fused_tick": ({}, dict(tile_dynamics=unicycle_tile(0.02)),
                                         "tile_dynamics"),
    "repeats_fused": (dict(num_rollout_repeats=2), dict(fused_tick=True), "num_rollout_repeats"),
    "repeats_split": (dict(num_rollout_repeats=2), dict(use_kernel=True), "num_rollout_repeats"),
    "time_varying_fused": (dict(time_varying_dynamics=True), dict(fused_tick=True),
                           "time_varying_dynamics"),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_unported_options_raise_at_construction(case):
    cfg_kw, solver_kw, match = GUARDS[case]
    cfg, params, step, stage, terminal = _flag(**cfg_kw)
    with pytest.raises(ValueError, match=match):
        tmppi.MPPISolver(cfg, step, stage, terminal, device="cpu", **solver_kw)


def test_polygon_collision_raises():
    """The vehicle polygon is the race car's cost: the diff-drive ticks, which
    compile in the circle and soft costs, refuse it (the JAX kernel asserts
    the same); an unknown mode is refused by the scan costs too."""
    cfg, params, step, stage, terminal = _flag()
    for K in (1024, 102400):  # the fused tick and the K-blocked tick
        with pytest.raises(ValueError, match="polygon"):
            tmppi.MPPISolver(dataclasses.replace(cfg, num_samples=K), step, stage, terminal,
                             fused_tick=True, collision="polygon", device="cpu")
    with pytest.raises(ValueError, match="collision"):
        tmppi.make_tracking_costs(cfg, collision="ellipse")


def test_runtime_guards_raise():
    cfg, params, step, stage, terminal = _flag()
    x0 = torch.zeros(3)
    split = tmppi.MPPISolver(cfg, step, stage, terminal, use_kernel=True, device="cpu")
    with pytest.raises(ValueError, match="control_weight"):
        split.step(dataclasses.replace(params, control_weight=torch.tensor([0.1, 0.1])),
                   split.init(), x0)
    with pytest.raises(ValueError, match="moving obstacles"):
        split.step(dataclasses.replace(params, obstacles=torch.tensor([[1.0, 0.0, 0.2]]),
                                       obstacle_velocities=torch.tensor([[0.1, 0.0]])),
                   split.init(), x0)


def test_iso_xy_weights_checked_once_per_params(monkeypatch):
    cfg, params, step, stage, terminal = _flag()
    solver = tmppi.MPPISolver(cfg, step, stage, terminal, fused_tick=True, iso_xy=True,
                              device="cpu")
    calls = []
    real = tmppi._check_iso_weights
    monkeypatch.setattr(tmppi, "_check_iso_weights", lambda p: calls.append(1) or real(p))
    st, x0 = solver.init(), torch.zeros(3)
    for _ in range(3):
        _, st, _ = solver.step(params, st, x0)
    assert len(calls) == 1
    bad = dataclasses.replace(params, stage_weight=torch.tensor([5.0, 4.0, 10.0]))
    with pytest.raises(ValueError, match="symmetric"):
        solver.step(bad, st, x0)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default device on a machine without a card")


def _flag_solver(**kw):
    cfg, _, step, stage, terminal = _flag()
    return tmppi.MPPISolver(cfg, step, stage, terminal, fused_tick=True, **kw)


def _nmpc_cfg():
    return tcfg.SQPConfig(N=5, dim_x=3, dim_u=2, dt=0.1)


def _sharded_nmpc(device):
    """make_sharded_nmpc_fleet: resolves its device before it asks the
    process group anything; with a device, on a one-process gloo group."""
    import torch.distributed as dist

    from dnn_mppi_mpc_tpu_torch import parallel

    solver = tsqp.NMPCSolver(_nmpc_cfg(), unicycle, device="cpu")
    if not device:
        return parallel.make_sharded_nmpc_fleet(solver)
    parallel.initialize_distributed(device="cpu")
    try:
        return parallel.make_sharded_nmpc_fleet(solver, **device)
    finally:
        dist.destroy_process_group()


def _cem():
    from dnn_mppi_mpc_tpu_torch.solvers import cem

    return cem


def _cem_cfg():
    return _cem().CEMConfig(num_samples=64, horizon=5, dim_x=3, dim_u=2, dt=0.1)


def _cem_parts():
    _, _, step, stage, terminal = _flag()
    return step, stage, terminal


def _cli():
    from dnn_mppi_mpc_tpu_torch import cli

    return cli


def _profiling():
    from dnn_mppi_mpc_tpu_torch.utils import profiling

    return profiling


def _profiled(**device):
    import tempfile

    with tempfile.TemporaryDirectory() as d, _profiling().trace(d, **device) as prof:
        pass
    return prof


def _batched_step(device):
    """make_batched_mppi_step: resolves its device before it asks the process
    group anything; with a device, on a one-process gloo group."""
    import torch.distributed as dist

    from dnn_mppi_mpc_tpu_torch import parallel

    cfg, _, step, stage, terminal = _flag()
    if not device:
        return parallel.make_batched_mppi_step(cfg, step, stage, terminal)
    parallel.initialize_distributed(device="cpu")
    try:
        return parallel.make_batched_mppi_step(cfg, step, stage, terminal, **device)
    finally:
        dist.destroy_process_group()


DEVICE_DEFAULTS = {
    "MPPISolver": lambda device: _flag_solver(**device),
    "MPPIState.init": lambda device: tmppi.MPPIState.init(_flag()[0], **device),
    "presets.flagship": lambda device: presets.flagship(1024, 20, **device),
    "presets.racecar_mppi": lambda device: presets.racecar_mppi(
        np.zeros((10, 4), np.float32), num_samples=128, horizon=5, fused_tick=True, **device),
    "presets.diff_drive_mppi": lambda device: presets.diff_drive_mppi(
        np.zeros((10, 3), np.float32), fused_tick=True, **device),
    "presets.goal_seeking_mppi": lambda device: presets.goal_seeking_mppi(
        [1.0, 1.0, 0.0], num_samples=128, horizon=5, obstacles=[[0.5, 0.5, 0.2]],
        obstacle_velocities=[[0.1, 0.0]], fused_tick=True, **device),
    "envs.Plant": lambda device: _envs().Plant(unicycle, 0.1, process_noise_std=[0.1] * 3,
                                               **device),
    "envs.WheelPlant": lambda device: _envs().plants.WheelPlant(0.1, **device),
    "paths.lemniscate": lambda device: lemniscate(2.0, 8, **device),
    "envs.collect_residual_dataset": lambda device: _envs().collect_residual_dataset(
        lambda gen: ((lambda cs, x: (torch.zeros(2), cs)), None), lambda x, u: x,
        lambda x, u: x, lambda gen: torch.zeros(3), 0, 1, 2, **device),
    "presets.mppi_fleet": lambda device: presets.mppi_fleet(2, 128, 5, **device),
    "params_from_numpy": lambda device: tcfg.params_from_numpy(
        np.eye(2), np.ones(3), np.ones(3), -np.ones(2), np.ones(2), np.zeros((4, 3)), **device),
    "state_from_numpy": lambda device: tmppi.state_from_numpy(
        np.zeros((5, 2)), 0, [0, 0], **device),
    "paths.line": lambda device: line([0.0, 0.0], [1.0, 1.0], num_points=5, **device),
    "paths.circle_with_speed": lambda device: circle_with_speed(2.0, 8, **device),
    "paths.lemniscate_with_speed": lambda device: lemniscate_with_speed(2.0, 8, **device),
    "NMPCSolver": lambda device: tsqp.NMPCSolver(_nmpc_cfg(), unicycle, **device),
    "NMPCState.init": lambda device: tsqp.NMPCState.init(_nmpc_cfg(), [0.0, 0.0, 0.0], **device),
    "presets.diff_drive_nmpc": lambda device: presets.diff_drive_nmpc(
        [1.0, 0.0, 0.0], N=5, obstacles=[[0.5, 0.5, 0.2]], **device),
    "presets.racecar_nmpc": lambda device: presets.racecar_nmpc([1.0, 0.0, 0.0, 0.0], N=5,
                                                                **device),
    "presets.four_wheel_nmpc": lambda device: presets.four_wheel_nmpc(
        [1.0, 0.5, 0.0, 0.0, 0.0], N=5, **device),
    "presets.nmpc_fleet": lambda device: presets.nmpc_fleet(B=2, N=5, **device),
    "make_sharded_nmpc_fleet": _sharded_nmpc,
    "ocp_params_from_numpy": lambda device: tsqp.ocp_params_from_numpy(
        np.eye(3), np.eye(2), np.eye(3), np.zeros((5, 5)), np.zeros(3), -np.ones(3),
        np.ones(3), -np.ones(2), np.ones(2), **device),
    "nmpc state_from_numpy": lambda device: tsqp.state_from_numpy(np.zeros((6, 3)),
                                                                  np.zeros((5, 2)), **device),
    "models.MLP": lambda device: _learned().MLP(hidden=8, depth=1, **device),
    "models.ResNet1D": lambda device: _learned().ResNet1D(3, "18", **device),
    "Standardizer.from_numpy": lambda device: _learned().Standardizer.from_numpy(
        np.zeros(5), np.ones(5), **device),
    "make_fused_residual_step": lambda device: _kern().make_fused_residual_step(
        unicycle, _learned().MLP(hidden=8, depth=1, device="cpu"), 0.05, **device),
    "make_resnet_chain_fn": lambda device: _kern().make_resnet_chain_fn(
        _learned().ResNet1D(3, "18", device="cpu"), **device),
    "presets.dnn_mppi": lambda device: presets.dnn_mppi(
        np.zeros((10, 3)), lambda f: f[..., :3], num_samples=16, horizon=4, **device),
    "presets.dnn_nmpc": lambda device: presets.dnn_nmpc([1.0, 0.0, 0.0], lambda f: f[..., :3],
                                                        N=5, **device),
    "train.step_sequence": lambda device: _train().step_sequence(8, [1.0, 0.5], 2, **device),
    "train.ramp_sequence": lambda device: _train().ramp_sequence(8, [0.1], [1.0], **device),
    "train.sine_sequence": lambda device: _train().sine_sequence(8, [1.0], [2.0], 0.1, **device),
    "train.random_sequence": lambda device: _train().random_sequence(
        torch.Generator(), 8, [-1.0], [1.0], hold=2, **device),
    "train.multisine_sequence": lambda device: _train().multisine_sequence(
        torch.Generator(), 8, 2, **device),
    "train.latin_hypercube": lambda device: _train().latin_hypercube(
        torch.Generator(), 4, [[0.0, 1.0]], **device),
    "train.ActorCritic": lambda device: _train().ActorCritic(2, 8, 1, obs_dim=2, **device),
    "train.PixelActorCritic": lambda device: _train().PixelActorCritic(2, (4,), 8, size=8,
                                                                       **device),
    "solvers.CEMSolver": lambda device: _cem().CEMSolver(_cem_cfg(), *_cem_parts(), **device),
    "CEMState.init": lambda device: _cem().CEMState.init(_cem_cfg(), **device),
    "cem_state_from_numpy": lambda device: _cem().cem_state_from_numpy(
        np.zeros((5, 2)), np.ones((5, 2)), 0, **device),
    "parallel.make_batched_mppi_step": _batched_step,
    "envs.collect_residual_dataset (fleet route)": lambda device: _envs().collect_residual_dataset(
        *_cli().collect_problem("cpu", 128, 4), 0, 2, 2, **device),
    "utils.profiling.trace": lambda device: _profiled(**device),
    "utils.profiling.time_fn": lambda device: _profiling().time_fn(lambda: None, iters=1,
                                                                   **device),
}


def _envs():
    from dnn_mppi_mpc_tpu_torch import envs

    return envs


def _learned():
    from dnn_mppi_mpc_tpu_torch.models import learned

    return learned


def _train():
    from dnn_mppi_mpc_tpu_torch import train

    return train


def _kern():
    from dnn_mppi_mpc_tpu_torch.ops import cuda

    return cuda



@pytest.mark.parametrize("entry", list(DEVICE_DEFAULTS))
def test_entry_points_default_to_the_card(entry):
    """Without a device the entry points run on the card: with no card they
    raise (no fallback to the CPU); with device="cpu" they work."""
    _no_card()
    make = DEVICE_DEFAULTS[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make({})
    assert make({"device": "cpu"}) is not None


def test_solver_without_device_raises_and_runs_on_cpu():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _flag_solver()
    solver = _flag_solver(device="cpu")
    u0, st, aux = solver.step(_flag()[1], solver.init(), torch.zeros(3))
    assert u0.device.type == "cpu" and int(aux.status) == 0


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import dnn_mppi_mpc_tpu_torch, dnn_mppi_mpc_tpu_torch.presets\n"
        "import dnn_mppi_mpc_tpu_torch.solvers.mppi, dnn_mppi_mpc_tpu_torch.ops.cuda\n"
        "import dnn_mppi_mpc_tpu_torch.utils.benchtime, dnn_mppi_mpc_tpu_torch._build\n"
        "import dnn_mppi_mpc_tpu_torch.parallel, dnn_mppi_mpc_tpu_torch.solvers.sqp\n"
        "import dnn_mppi_mpc_tpu_torch.testing.oracle_nmpc\n"
        "import dnn_mppi_mpc_tpu_torch.envs, dnn_mppi_mpc_tpu_torch.envs.closed_loop\n"
        "import dnn_mppi_mpc_tpu_torch.envs.plants, dnn_mppi_mpc_tpu_torch.envs.sensors\n"
        "import dnn_mppi_mpc_tpu_torch.utils.logging, dnn_mppi_mpc_tpu_torch.train\n"
        "import dnn_mppi_mpc_tpu_torch.train.rl, dnn_mppi_mpc_tpu_torch.envs.render\n"
        "from dnn_mppi_mpc_tpu_torch.presets import diff_drive_mppi, goal_seeking_mppi\n"
        "import dnn_mppi_mpc_tpu_torch.solvers.cem, dnn_mppi_mpc_tpu_torch.envs.bullet_bridge\n"
        "import dnn_mppi_mpc_tpu_torch.testing.oracle, dnn_mppi_mpc_tpu_torch.testing.mock_pybullet\n"
        "import dnn_mppi_mpc_tpu_torch.utils.profiling, dnn_mppi_mpc_tpu_torch.paths.splines\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dnn_mppi_mpc_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(new))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr
    for src in (REPO / "dnn_mppi_mpc_tpu_torch").rglob("*.py"):
        text = src.read_text()
        for name in ("jax", "flax", "optax", "orbax"):
            assert f"import {name}" not in text and f"from {name}" not in text, (src, name)
        assert "dnn_mppi_mpc_tpu." not in text.replace("dnn_mppi_mpc_tpu_torch", ""), src


@pytest.mark.parametrize("script", ["chip_smoke.py"] + sorted(
    str(p.relative_to(REPO)) for p in (REPO / "tools").glob("*.py")))
def test_card_scripts_load_only_names_they_bind(script):
    """These scripts run only on the card: a name read anywhere in one must
    be bound somewhere in it (an import, a definition, an assignment, an
    argument) or be a builtin, so a removed helper fails here and not after
    minutes on the card."""
    tree = ast.parse((REPO / script).read_text())
    bound = set(dir(builtins)) | {"__file__"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and not isinstance(node.ctx, ast.Load):
            bound.add(node.id)
        elif isinstance(node, ast.arg):
            bound.add(node.arg)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            bound.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound.update((a.asname or a.name).split(".")[0] for a in node.names)
    loaded = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    assert not loaded - bound, sorted(loaded - bound)


@pytest.mark.cuda
def test_flagship_closed_loop_on_card(cuda_device):
    from dnn_mppi_mpc_tpu_torch.ops import cuda as kern

    cfg, params, step, stage, terminal = presets.flagship(10240, 50, cuda_device)
    solver = tmppi.MPPISolver(cfg, step, stage, terminal, fused_tick=True, iso_xy=True,
                              device=cuda_device)
    kern.reset_counts()
    st = solver.init()
    x = torch.tensor([0.0, 0.0, float(np.arctan2(-10.0, 20.0))], device=cuda_device)
    statuses = []
    for _ in range(20):
        u0, st, aux = solver.step(params, st, x)
        x = step(x, u0)
        statuses.append(aux.status)
    torch.cuda.synchronize()
    assert kern.diffdrive_mppi_tick.launches == 20
    assert kern.diffdrive_mppi_tick_plain.calls == 0
    assert int(torch.stack(statuses).max()) == 0 and bool(torch.isfinite(x).all())


def test_resolve_device_names_the_current_card(monkeypatch):
    """"cuda" without an index resolves to the card its tensors report
    (cuda:0), so a step built with the default device accepts the tensors
    made on it (torch.device("cuda") != torch.device("cuda:0"))."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tcfg.resolve_device("cuda") == torch.device("cuda", 0)
    assert tcfg.resolve_device(torch.device("cuda", 0)) == torch.device("cuda", 0)
    assert tcfg.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.cuda
def test_fleet_step_runs_on_the_default_device(cuda_device):
    step, params, states, _ = presets.mppi_fleet(2, 128, 5)
    u0s, _, _ = step(params, states, torch.zeros((2, 3), device=cuda_device))
    assert u0s.shape == (2, 2)
