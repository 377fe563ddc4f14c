"""The port's closed-loop layer (``dnn_mppi_mpc_tpu_torch/envs``,
``utils/logging.py``) against the JAX package's ``envs``, on the CPU.

One counterpart of each test in tests/test_envs.py (its NMPC loop is in
tests/test_torch_goal_seeking.py), each feeding the same seeded numpy
inputs to the JAX function and to the port:

* kinematics, obstacles (drift, chase, the per-obstacle sinusoid) and the
  sensors (lidar, with the full circle's unique beams; goal-relative
  features): rtol 1e-6, atol 1e-6 (atol 1e-5 for lidar ranges, a
  square root of float32 differences);
* ``Plant`` with Euler, RK4 and ERK and its delay, and ``WheelPlant``'s lag,
  delay, cap, slip and gains, step by step against the JAX plants: rtol
  1e-6 (1e-5 for the poses), atol 1e-6; the yaw wrap bit for bit on a grid
  of yaws that holds ±π and the float32 values one ulp on either side of
  them, alone and through a plant step; process and
  measurement noise by their moments and by repeating under one seed (the
  port draws from a ``torch.Generator``, not JAX's stream);
* ``run_closed_loop`` with the proportional controller (states against
  JAX, rtol 1e-5, atol 1e-5 over 50 ticks), metrics at ticks 0, 5, …, 35 in
  tick order (their values likewise), the MPPI scan-path loop with injected ε against JAX's,
  ``with_recovery``'s reset ladder, ``collect_residual_dataset`` with a
  factory and sampler fixed by the series index equal to JAX's dataset
  (atol 1e-6), the resumable collection's reuse and invalidation,
  ``MetricsWriter`` as ``metric_cb``, and the episode-CSV round trip.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import envs as jenvs
from dnn_mppi_mpc_tpu.envs import closed_loop as jcl
from dnn_mppi_mpc_tpu.envs import plants as jplants
from dnn_mppi_mpc_tpu.envs import sensors as jsensors
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.utils import logging as jlogging
from dnn_mppi_mpc_tpu_torch import envs
from dnn_mppi_mpc_tpu_torch.envs import closed_loop as cl
from dnn_mppi_mpc_tpu_torch.envs import plants, sensors
from dnn_mppi_mpc_tpu_torch.models import euler_step, unicycle
from dnn_mppi_mpc_tpu_torch.utils import logging as tlogging

DT = 0.1
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread spares every op the thread pool's
    wake-up cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def t_step(x, u):
    return euler_step(unicycle, x, u, DT)


def j_step(x, u):
    return j_euler(j_unicycle, x, u, DT)


# --- kinematics, obstacles, sensors -------------------------------------------------


def test_diff_drive_wheel_ik():
    rng = np.random.default_rng(0)
    v, w = rng.normal(size=(2, 7)).astype(np.float32)
    close(envs.diff_drive_wheel_speeds(t32(v), t32(w)),
          jenvs.diff_drive_wheel_speeds(jnp.asarray(v), jnp.asarray(w)))
    L = 0.5708
    close(envs.diff_drive_wheel_speeds(t32(1.0), t32(0.5)), [1 - 0.5 * L / 2, 1 + 0.5 * L / 2] * 2)


def test_ackermann_wheel_ik_straight_line():
    close(envs.ackermann_wheel_speeds(t32(2.0), t32(0.0), 0.325, 0.2), [2.0] * 4)
    rng = np.random.default_rng(1)
    v, steer = rng.normal(size=7).astype(np.float32), rng.uniform(-0.4, 0.4, 7).astype(np.float32)
    close(envs.ackermann_wheel_speeds(t32(v), t32(steer), 0.325, 0.2),
          jenvs.ackermann_wheel_speeds(jnp.asarray(v), jnp.asarray(steer), 0.325, 0.2))


def test_drift_and_chase_obstacles():
    init = np.array([[5.0, 4.0, 0.5], [3.5, 3.5, 0.4]], np.float32)
    vel = 0.09 * np.array([[0.2, 0.1], [-0.1, 0.1]], np.float32)
    for t in (2.0, 0.35):
        got = envs.drift_obstacles(t32(init), t32(vel), t)
        close(got, jenvs.drift_obstacles(jnp.asarray(init), jnp.asarray(vel), jnp.asarray(t)))
    close(envs.drift_obstacles(t32(init), t32(vel), t32(2.0))[:, 2], init[:, 2], 0, 0)

    target = np.array([0.0, 0.0], np.float32)
    chased = envs.chase_obstacles(t32(init), t32(target), speed=1.0, dt=0.1)
    close(chased, jenvs.chase_obstacles(jnp.asarray(init), jnp.asarray(target), 1.0, 0.1))
    assert np.all(np.linalg.norm(chased[:, :2].numpy(), axis=1)
                  < np.linalg.norm(init[:, :2], axis=1))
    # an obstacle on its target stays put
    still = envs.chase_obstacles(t32(init), t32(init[0, :2]), speed=1.0, dt=0.1)
    close(still[0], init[0], 0, 0)


def test_sinusoid_obstacles_per_obstacle_scalars():
    """A bare (n,) amplitude and ω apply to both axes of their own obstacle,
    never across x and y (n = 2 and 3 would hide the wrong broadcast)."""
    centers = np.array([[0.0, 0.0, 0.5], [5.0, 1.0, 0.4], [2.0, -3.0, 0.3]], np.float32)
    amps = np.array([1.0, 2.0, 0.5], np.float32)
    omegas = np.array([1.0, 0.5, 2.0], np.float32)
    for n in (2, 3):
        got = envs.sinusoid_obstacles(t32(centers[:n]), t32(amps[:n]), t32(omegas[:n]), 0.7)
        want = jenvs.sinusoid_obstacles(jnp.asarray(centers[:n]), jnp.asarray(amps[:n]),
                                        jnp.asarray(omegas[:n]), jnp.asarray(0.7))
        close(got, want)
        off = amps[:n] * np.sin(omegas[:n] * 0.7)
        close(got[:, 0], centers[:n, 0] + off)
        close(got[:, 1], centers[:n, 1] + off)
        close(got[:, 2], centers[:n, 2], 0, 0)
    amps2 = np.stack([amps, np.zeros(3, np.float32)], 1)
    got = envs.sinusoid_obstacles(t32(centers), t32(amps2), t32(np.ones((3, 2))), 0.7)
    close(got, jenvs.sinusoid_obstacles(jnp.asarray(centers), jnp.asarray(amps2),
                                        jnp.ones((3, 2)), jnp.asarray(0.7)))
    close(got[:, 1], centers[:, 1], 0, 0)


@pytest.mark.parametrize("beams, fov", [(1, 0.0), (36, 2 * math.pi), (11, 1.5), (7, 2 * math.pi)])
def test_lidar_scan_matches_jax(beams, fov):
    rng = np.random.default_rng(beams)
    poses = np.concatenate([rng.uniform(-2, 2, (5, 2)), rng.uniform(-3, 3, (5, 1))],
                           1).astype(np.float32)
    obs = np.concatenate([rng.uniform(-5, 5, (4, 2)), rng.uniform(0.3, 1.0, (4, 1))],
                         1).astype(np.float32)
    got = sensors.lidar_scan(t32(poses), t32(obs), num_beams=beams, max_range=8.0, fov=fov)
    want = jsensors.lidar_scan(jnp.asarray(poses), jnp.asarray(obs), num_beams=beams,
                               max_range=8.0, fov=fov)
    assert got.shape == want.shape == (5, beams)
    if beams > 1:  # hits and misses both
        assert 0 < int((got < 8.0).sum()) < got.numel()
    close(got, want, atol=1e-5)


def test_lidar_scan_geometry():
    """A beam straight at a circle returns the distance to its surface; a
    miss returns the maximum range."""
    obstacles = t32([[5.0, 0.0, 1.0]])
    ranges = sensors.lidar_scan(t32([0.0, 0.0, 0.0]), obstacles, num_beams=1, max_range=20.0,
                                fov=0.0)
    close(ranges, [4.0], atol=1e-5)
    ranges = sensors.lidar_scan(t32([0.0, 0.0, np.pi]), obstacles, num_beams=1, max_range=20.0,
                                fov=0.0)
    close(ranges, [20.0], 0, 0)
    obs = sensors.goal_relative_obs(t32([0.0, 0.0, 0.0]), t32([3.0, 4.0, 0.5]))
    close(obs, jsensors.goal_relative_obs(jnp.zeros(3), jnp.array([3.0, 4.0, 0.5])))
    close(obs[:2], [5.0, np.arctan2(4, 3)])
    close(sensors.goal_relative_obs(t32([1.0, 0.0, 3.0]), t32([0.0, 1.0]))[2], 0.0, 0, 0)


def test_lidar_full_circle_has_unique_beams():
    """At fov = 2π the −π direction is one beam, not two: an obstacle
    straight behind is seen at range 2 by exactly one beam."""
    ranges = sensors.lidar_scan(t32([0.0, 0.0, 0.0]), t32([[-3.0, 0.0, 1.0]]), num_beams=36)
    assert ranges.shape == (36,)
    close(ranges.min(), 2.0, atol=1e-5)
    assert int((torch.abs(ranges - 2.0) < 1e-5).sum()) == 1


# --- plants -----------------------------------------------------------------------------


def _yaw_grid() -> np.ndarray:
    """Yaws around every wrap boundary: ±π, ±3π and 0 in float32, with the
    float32 values one ulp on either side, and a spread in between."""
    centers = np.float32([np.pi, -np.pi, 3 * np.pi, -3 * np.pi, 0.0, 2 * np.pi, -2 * np.pi])
    near = [np.nextafter(c, np.float32(d)) for c in centers for d in (np.inf, -np.inf)]
    spread = np.linspace(-10.0, 10.0, 2001, dtype=np.float32)
    return np.concatenate([centers, np.float32(near), spread]).astype(np.float32)


def test_yaw_wrap_is_bit_equal_to_jax():
    """The JAX plant's mod(yaw + π, 2π) − π, rounding for rounding: not the
    algebraic twin π − mod(π − yaw, 2π), which differs by about an ulp."""
    yaws = _yaw_grid()
    want = np.asarray(jnp.mod(jnp.asarray(yaws) + jnp.pi, 2.0 * jnp.pi) - jnp.pi)
    got = plants.wrap_to_pi(torch.from_numpy(yaws)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    twin = np.pi - np.mod(np.pi - yaws, np.float32(2 * np.pi))
    assert np.any(twin.astype(np.float32) != got)  # the twin is another function


def test_wheel_plant_wraps_the_grid_bit_for_bit():
    """A WheelPlant step at rest from each of the grid's yaws: the yaw goes
    through the plant's wrap alone, and the poses equal the JAX plant's bit
    for bit. (Under a turning command XLA may contract yaw + dt·ω into one
    fused multiply-add, so that is held to a tolerance, in
    test_wheel_plant_matches_jax.)"""
    yaws = _yaw_grid()
    x0 = np.stack([np.zeros_like(yaws), np.ones_like(yaws), yaws], 1)
    u = np.zeros((len(yaws), 2), np.float32)
    plant = plants.WheelPlant(DT, **CPU)
    got = plant.step_body(plant.init(x0), t32(u)).x.numpy()
    jp = jplants.WheelPlant(DT)
    want = np.asarray(jp.step_body(jp.init(jnp.asarray(x0)), jnp.asarray(u)).x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.all((got[:, 2] >= -np.float32(np.pi)) & (got[:, 2] < np.float32(np.pi)))


def test_plant_euler_matches_reference_update():
    plant = plants.Plant(unicycle, dt=DT, **CPU)
    st = plant.step(plant.init([0.0, 0.0, 0.5], dim_u=2), t32([2.0, 0.3]))
    close(st.x, [0.2 * np.cos(0.5), 0.2 * np.sin(0.5), 0.5 + 0.03])


@pytest.mark.parametrize("method", ["euler", "rk4", "erk"])
def test_plant_integrators_match_jax(method):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    us = rng.normal(size=(6, 4, 2)).astype(np.float32)
    tp = plants.Plant(unicycle, dt=DT, method=method, num_steps=3, **CPU)
    jp = jplants.Plant(j_unicycle, dt=DT, method=method, num_steps=3)
    ts, js = tp.init(x, dim_u=2), jp.init(jnp.asarray(x), dim_u=2)
    for u in us:
        ts, js = tp.step(ts, t32(u)), jp.step(js, jnp.asarray(u))
        close(ts.x, js.x, rtol=1e-5, atol=1e-6)


def test_plant_input_delay():
    """Inputs act after the buffer's delay, oldest first, as JAX's plant."""
    tp = plants.Plant(unicycle, dt=DT, delay_steps=2, **CPU)
    jp = jplants.Plant(j_unicycle, dt=DT, delay_steps=2)
    ts, js = tp.init([0.0, 0.0, 0.0], dim_u=2), jp.init(jnp.zeros(3), dim_u=2)
    assert tuple(ts.u_buffer.shape) == tuple(js.u_buffer.shape) == (2, 2)
    for i, u in enumerate([[1.0, 0.0], [1.0, 0.5], [0.0, 0.0], [0.3, -0.2], [0.0, 0.0]]):
        ts, js = tp.step(ts, t32(u)), jp.step(js, jnp.asarray(u, jnp.float32))
        close(ts.x, js.x)
        close(ts.u_buffer, js.u_buffer, 0, 0)
        if i < 2:
            close(ts.x, 0.0, 0, 0)  # still at rest
    assert float(ts.x[0]) > 0.05


def test_plant_process_noise_reproducible():
    """Noise repeats under one seed, differs under another, and has the
    stated moments (5 standard errors over 4 000 steps of a resting
    plant)."""
    std = [0.01, 0.02, 0.001]
    plant = plants.Plant(unicycle, dt=DT, process_noise_std=std, measurement_noise_std=std, **CPU)
    a = plant.step(plant.init(np.zeros(3), dim_u=2, seed=7), t32([1.0, 0.0]))
    b = plant.step(plant.init(np.zeros(3), dim_u=2, seed=7), t32([1.0, 0.0]))
    c = plant.step(plant.init(np.zeros(3), dim_u=2, seed=8), t32([1.0, 0.0]))
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)
    assert abs(float(a.x[1])) > 0
    y_a, _ = plant.measure(a)
    y_b, _ = plant.measure(b)
    assert torch.equal(y_a, y_b) and not torch.equal(y_a, a.x)

    n = 4000
    st = plant.init(np.zeros((n, 3)), dim_u=2, seed=3)
    st = plant.step(st, torch.zeros(n, 2))
    for got in (st.x, plant.measure(st)[0] - st.x):
        mean, sd = got.double().mean(0).numpy(), got.double().std(0).numpy()
        assert np.all(np.abs(mean) < 5 * np.array(std) / np.sqrt(n))
        assert np.all(np.abs(sd - std) < 5 * np.array(std) / np.sqrt(2 * n))


def test_wheel_plant_matches_unicycle_for_ideal_wheels():
    plant = plants.WheelPlant(dt=DT, **CPU)
    x0, u = t32([0.3, -0.2, 0.7]), t32([1.2, 0.5])
    close(plant.step_body(plant.init(x0), u).x, t_step(x0, u))


WHEEL_CASES = {
    "lag": dict(tau=0.1),
    "delay": dict(delay_steps=2),
    "cap": dict(wheel_speed_cap=1.0),
    "slip_gains": dict(slip=0.7, common_gain=1.8, diff_gain=0.5),
    "all": dict(tau=0.25, delay_steps=1, wheel_speed_cap=1.5, slip=0.9, common_gain=1.2,
                diff_gain=0.8),
    "no_wrap": dict(wrap_yaw=False),
}


@pytest.mark.parametrize("case", list(WHEEL_CASES))
def test_wheel_plant_matches_jax(case):
    """Ten steps of body commands through the wheel plant, against JAX's."""
    kw = WHEEL_CASES[case]
    rng = np.random.default_rng(3)
    us = rng.normal(0.0, 1.5, (10, 2)).astype(np.float32)
    us[:, 1] += 2.0  # turning: the yaw passes +π
    tp, jp = plants.WheelPlant(DT, **kw, **CPU), jplants.WheelPlant(DT, **kw)
    ts, js = tp.init([0.1, -0.1, 2.5]), jp.init(jnp.array([0.1, -0.1, 2.5]))
    for u in us:
        ts, js = tp.step_body(ts, t32(u)), jp.step_body(js, jnp.asarray(u))
        close(ts.x, js.x, rtol=1e-5, atol=1e-6)
        close(ts.wheel_speeds, js.wheel_speeds, atol=1e-6)
        close(ts.u_buffer, js.u_buffer, atol=1e-6)
    assert (float(ts.x[2]) > np.pi) == (case == "no_wrap")


def test_wheel_plant_lag_delay_cap():
    plant = plants.WheelPlant(dt=DT, delay_steps=1, **CPU)
    ps = plant.step_body(plant.init(np.zeros(3)), t32([2.0, 0.0]))
    assert float(ps.x[0]) == 0.0
    ps = plant.step_body(ps, t32([0.0, 0.0]))
    close(ps.x[0], 0.2)
    plant = plants.WheelPlant(dt=DT, tau=0.1, **CPU)
    close(plant.step_body(plant.init(np.zeros(3)), t32([1.0, 0.0])).x[0],
          0.1 * (1 - math.exp(-1.0)))
    plant = plants.WheelPlant(dt=DT, wheel_speed_cap=1.0, **CPU)
    close(plant.step_body(plant.init(np.zeros(3)), t32([5.0, 0.0])).x[0], 0.1)


def test_wheel_plant_wraps_yaw():
    plant = plants.WheelPlant(dt=DT, **CPU)
    ps = plant.step_body(plant.init([0.0, 0.0, 3.1]), t32([0.0, 1.0]))
    assert float(ps.x[2]) < 0.0


def test_wheel_plant_diff_gain_calibration():
    plant = plants.WheelPlant(dt=DT, common_gain=2.0, diff_gain=0.5, **CPU)
    ps = plant.step_body(plant.init(np.zeros(3)), t32([1.0, 1.0]))
    close(ps.x[0], 0.2, atol=1e-5)
    close(ps.x[2], 0.05, atol=1e-5)


def test_wheel_plant_process_noise_repeats_under_a_seed():
    plant = plants.WheelPlant(dt=DT, process_noise_std=[0.01, 0.01, 0.001], **CPU)
    a = plant.step_body(plant.init(np.zeros(3), seed=4), t32([1.0, 0.0]))
    b = plant.step_body(plant.init(np.zeros(3), seed=4), t32([1.0, 0.0]))
    assert torch.equal(a.x, b.x) and float(a.x[1]) != 0.0


# --- the closed loop ----------------------------------------------------------------------


def _p_controller(goal, stack, norm, atan2, clip):
    def controller(cs, x):
        d = goal - x[:2]
        heading = atan2(d[1], d[0])
        v = clip(norm(d), 0.0, 1.0)
        w = clip(2.0 * (heading - x[2]), -1.5, 1.5)
        return stack([v, w]), cs

    return controller


def _t_p_controller(goal):
    return _p_controller(t32(goal), torch.stack, torch.linalg.vector_norm, torch.atan2,
                         torch.clamp)


def _j_p_controller(goal):
    return _p_controller(jnp.asarray(goal, jnp.float32), jnp.stack, jnp.linalg.norm,
                         jnp.arctan2, jnp.clip)


@pytest.mark.parametrize("errors", ["nominal", "x_ref", "zeros"])
def test_closed_loop_proportional_controller(errors):
    """50 ticks of a P-controller: states, controls and errors against JAX's
    scan; the goal reached; residuals zero when the nominal model is the
    plant."""
    goal = [1.0, 0.0]
    x_ref = [0.5, 0.5, 0.0]
    kw_t = dict(nominal=dict(nominal_step=t_step), x_ref=dict(x_ref=t32(x_ref)),
                zeros={})[errors]
    kw_j = dict(nominal=dict(nominal_step=j_step), x_ref=dict(x_ref=jnp.asarray(x_ref)),
                zeros={})[errors]
    ep, cs = cl.run_closed_loop(_t_p_controller(goal), t_step, "carry", torch.zeros(3), 50,
                                **kw_t)
    jep, _ = jcl.run_closed_loop(_j_p_controller(goal), j_step, None, jnp.zeros(3), 50, **kw_j)
    assert cs == "carry"
    assert ep.states.shape == (51, 3) and ep.controls.shape == (50, 2)
    for got, want in zip(ep, jep):
        close(got, want, rtol=1e-5, atol=1e-5)
    assert float(torch.linalg.vector_norm(ep.states[-1, :2] - t32(goal))) < 0.1
    if errors != "x_ref":
        close(ep.errors, 0.0, 0, 1e-6)


def test_metrics_streaming_every_five_ticks():
    """Ticks 0, 5, …, 35 reach the callback in tick order, with 0-d tensors;
    the values equal JAX's."""
    goal = [1.0, 0.5]
    received = []

    def cb(tick, **metrics):
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in metrics.values())
        received.append((tick, {k: float(v) for k, v in metrics.items()}))

    def metric_fn(x, u):
        return {"dist": torch.linalg.vector_norm(x[:2] - t32(goal)),
                "u_norm": torch.linalg.vector_norm(u)}

    cl.run_closed_loop(_t_p_controller(goal), t_step, None, torch.zeros(3), 40,
                       metric_fn=metric_fn, metric_cb=cb, metric_every=5)
    assert [t for t, _ in received] == [0, 5, 10, 15, 20, 25, 30, 35]
    got = dict(received)
    assert got[35]["dist"] < got[0]["dist"]

    j_received = []
    ep, _ = jax.jit(lambda x0: jcl.run_closed_loop(
        _j_p_controller(goal), j_step, None, x0, 40,
        metric_fn=lambda x, u: {"dist": jnp.linalg.norm(x[:2] - jnp.asarray(goal)),
                                "u_norm": jnp.linalg.norm(u)},
        metric_cb=lambda t, **m: j_received.append((t, {k: float(v) for k, v in m.items()})),
        metric_every=5))(jnp.zeros(3))
    jax.block_until_ready(ep.states)
    jax.effects_barrier()
    want = dict(j_received)
    for t in got:
        close([got[t]["dist"], got[t]["u_norm"]], [want[t]["dist"], want[t]["u_norm"]],
              rtol=1e-5, atol=1e-5)


def test_metrics_writer_as_metric_cb(tmp_path):
    """run_closed_loop(metric_cb=MetricsWriter.write): the 0-d tensors and a
    (2,) tensor serialize as numbers and lists."""
    path = str(tmp_path / "metrics.jsonl")
    w = tlogging.MetricsWriter(path)
    cl.run_closed_loop(lambda cs, x: (t32([0.5, 0.1]), cs), t_step, None, torch.zeros(3), 20,
                       metric_fn=lambda x, u: {"speed": u[0], "pos": x[:2]},
                       metric_cb=w.write, metric_every=10)
    w.close()
    lines = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in lines] == [0, 10]
    assert all(isinstance(r["speed"], float) and len(r["pos"]) == 2 for r in lines)
    assert tlogging.get_logger().name == "dnn_mppi_mpc_tpu_torch"
    assert tlogging.get_logger("envs").name == "dnn_mppi_mpc_tpu_torch.envs"


def test_episode_csv_roundtrip(tmp_path):
    states = np.random.default_rng(0).normal(size=(12, 3))
    controls = np.random.default_rng(1).normal(size=(12, 2))
    path = str(tmp_path / "ep.csv")
    tlogging.save_episode_csv(path, states, controls)
    s2, c2 = tlogging.load_episode_csv(path, nx=3)
    close(s2, states, 0, 1e-12)
    close(c2, controls, 0, 1e-12)
    jpath = str(tmp_path / "jax.csv")
    jlogging.save_episode_csv(jpath, states, controls)
    assert open(path).read() == open(jpath).read()


def test_on_device_mppi_closed_loop_scan():
    """The MPPI controller in run_closed_loop on the scan path, injected ε
    each tick, against JAX's scan loop over the same ε: 30 ticks within
    rtol 1e-3, atol 1e-4 (tests/test_mppi_tick.py's closed-loop limit); the
    robot moves along the line without leaving it."""
    from dnn_mppi_mpc_tpu.config import MPPIConfig as JConfig
    from dnn_mppi_mpc_tpu.config import MPPIParams as JParams
    from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
    from dnn_mppi_mpc_tpu_torch.config import MPPIConfig, params_from_numpy
    from dnn_mppi_mpc_tpu_torch.paths import line
    from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

    kw = dict(num_samples=128, horizon=10, dim_x=3, dim_u=2, dt=DT)
    p = dict(sigma=np.eye(2) * 0.2, stage_weight=[5.0, 5.0, 1.0], terminal_weight=[5.0, 5.0, 1.0],
             u_min=[-3.0, -3.0], u_max=[3.0, 3.0],
             ref_path=line([0.0, 0.0], [5.0, 0.0], num_points=60, **CPU).numpy())
    jc, tc = JConfig(**kw), MPPIConfig(**kw)
    jp = JParams(**{k: jnp.asarray(v, jnp.float32) for k, v in p.items()})
    tp = params_from_numpy(**p, **CPU)
    jsolver = jmppi.MPPISolver(jc, j_step, *jmppi.make_tracking_costs(jc))
    tsolver = tmppi.MPPISolver(tc, t_step, *tmppi.make_tracking_costs(tc), **CPU)
    ticks = 30
    rng = np.random.default_rng(5)
    noise = rng.multivariate_normal(np.zeros(2), np.eye(2) * 0.2,
                                    (ticks, 128, 10)).astype(np.float32)

    def j_controller(cs, x):
        st, i = cs
        u0, st, _ = jsolver._step(jp, st, x, jnp.asarray(noise)[i])
        return u0, (st, i + 1)

    jep, _ = jax.jit(lambda cs, x0: jcl.run_closed_loop(j_controller, j_step, cs, x0, ticks))(
        (jmppi.MPPIState.init(jc), 0), jnp.zeros(3))
    ticks_eps = iter(torch.from_numpy(noise))

    class Injected:
        """The solver, handed this tick's ε."""

        def step(self, params, st, x):
            return tsolver.step(params, st, x, next(ticks_eps))

    controller = cl.mppi_controller(Injected(), tp)
    ep, st = cl.run_closed_loop(controller, t_step, tsolver.init(), torch.zeros(3), ticks)
    close(ep.states, jep.states, rtol=1e-3, atol=1e-4)
    close(ep.controls, jep.controls, rtol=1e-3, atol=1e-4)
    assert torch.isfinite(ep.states).all()
    assert float(ep.states[-1, 0]) > 0.1 and float(ep.states[:, 1].abs().max()) < 1.0


def test_with_recovery_resets_wedged_controller():
    """A NaN in the nominal sequence's last row wedges the solver in
    hold-previous (the shift replicates it); the wrapper emits the safe
    control on failed ticks, resets the sequence after three, and the loop
    solves again. The ladder (bad-tick and reset counts, controls) equals
    JAX's on the same injected ε."""
    from dnn_mppi_mpc_tpu.config import MPPIConfig as JConfig
    from dnn_mppi_mpc_tpu.config import MPPIParams as JParams
    from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
    from dnn_mppi_mpc_tpu_torch.config import MPPIConfig, params_from_numpy
    from dnn_mppi_mpc_tpu_torch.paths import line
    from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

    kw = dict(num_samples=64, horizon=8, dim_x=3, dim_u=2, dt=DT, waypoint_search_len=10)
    p = dict(sigma=[[0.2, 0.0], [0.0, 0.1]], stage_weight=[5.0, 5.0, 1.0],
             terminal_weight=[5.0, 5.0, 1.0], u_min=[-2.0, -2.0], u_max=[2.0, 2.0],
             ref_path=line([0.0, 0.0], [3.0, 1.0], num_points=60, **CPU).numpy())
    jc, tc = JConfig(**kw), MPPIConfig(**kw)
    jp = JParams(**{k: jnp.asarray(v, jnp.float32) for k, v in p.items()})
    tp = params_from_numpy(**p, **CPU)
    noise = np.random.default_rng(6).multivariate_normal(
        np.zeros(2), np.asarray(p["sigma"]), (10, 64, 8)).astype(np.float32)
    jcore = jax.jit(lambda s, x, n: jmppi.mppi_step(jc, j_step, *jmppi.make_tracking_costs(jc),
                                                    jp, s, x, n))
    stage, terminal = tmppi.make_tracking_costs(tc)
    ticks = iter(range(10))

    def t_aux(cs, x):
        return tmppi.mppi_step(tc, t_step, stage, terminal, tp, cs, x,
                               torch.from_numpy(noise[next(ticks)]))

    j_ticks = iter(range(10))

    def j_aux(cs, x):
        return jcore(cs, x, jnp.asarray(noise[next(j_ticks)]))

    def t_reset(cs):
        return tmppi.MPPIState(u_prev=torch.zeros_like(cs.u_prev),
                               waypoint_idx=cs.waypoint_idx, key=cs.key)

    def j_reset(cs):
        return jmppi.MPPIState(u_prev=jnp.zeros_like(cs.u_prev), waypoint_idx=cs.waypoint_idx,
                               key=cs.key)

    bad_t = tmppi.MPPIState.init(tc, **CPU)
    bad_t.u_prev[-1, 0] = float("nan")
    bad_j = jmppi.MPPIState.init(jc)
    bad_j = jmppi.MPPIState(u_prev=bad_j.u_prev.at[-1, 0].set(jnp.nan),
                            waypoint_idx=bad_j.waypoint_idx, key=bad_j.key)
    t_ctrl = cl.with_recovery(t_aux, t_reset, max_bad_ticks=3)
    j_ctrl = jcl.with_recovery(j_aux, j_reset, max_bad_ticks=3)
    rs, jrs = cl.recovery_init(bad_t), jcl.recovery_init(bad_j)
    x, jx = t32([0.0, 0.2, 0.0]), jnp.array([0.0, 0.2, 0.0], jnp.float32)
    us = []
    for _ in range(10):
        u, rs = t_ctrl(rs, x)
        ju, jrs = j_ctrl(jrs, jx)
        assert (int(rs.bad_ticks), int(rs.resets)) == (int(jrs.bad_ticks), int(jrs.resets))
        assert rs.bad_ticks.dtype == rs.resets.dtype == torch.int32
        close(u, ju, rtol=1e-4, atol=1e-5)
        us.append(u)
        x, jx = t_step(x, u), j_step(jx, ju)
    assert int(rs.resets) >= 1
    assert torch.isfinite(torch.stack(us)).all()
    assert float(us[-1].abs().sum()) > 0
    assert torch.isfinite(rs.inner.u_prev).all()


def test_with_recovery_safe_control_and_state_kinds():
    """u_safe replaces a failed tick's control; the reset swaps every tensor
    of a named-tuple state and keeps its other leaves."""
    from typing import NamedTuple

    class Aux(NamedTuple):
        status: torch.Tensor

    class State(NamedTuple):
        seq: torch.Tensor
        tag: str

    statuses = iter([2, 2, 0, 3])

    def aux_ctrl(cs, x):
        return t32([1.0, 1.0]), State(cs.seq + 1.0, cs.tag), Aux(torch.tensor(next(statuses)))

    ctrl = cl.with_recovery(aux_ctrl, lambda cs: State(torch.zeros_like(cs.seq), "fresh"),
                            max_bad_ticks=2, u_safe=t32([-0.5, 0.0]))
    rs = cl.recovery_init(State(torch.zeros(2), "start"))
    outs = []
    for _ in range(4):
        u, rs = ctrl(rs, torch.zeros(3))
        outs.append((u.tolist(), rs.inner.seq.tolist(), int(rs.bad_ticks), int(rs.resets)))
    assert outs == [([-0.5, 0.0], [1.0, 1.0], 1, 0), ([-0.5, 0.0], [0.0, 0.0], 0, 1),
                    ([1.0, 1.0], [1.0, 1.0], 0, 1), ([-0.5, 0.0], [2.0, 2.0], 1, 1)]
    assert rs.inner.tag == "start"
    with pytest.raises(ValueError, match="holds a tensor"):
        cl.recovery_init(("no", "tensor"))


# --- data collection ----------------------------------------------------------------------

DRIFT = np.float32([0.01, -0.02, 0.0])


def _series_draws(key, num_series):
    """JAX's per-series (u, x0) of tests/test_envs.py's factory and sampler."""
    out = []
    for k in jax.random.split(key, num_series):
        k1, k2 = jax.random.split(k)
        out.append((np.asarray(jax.random.uniform(k1, (2,), minval=-1.0, maxval=1.0)),
                    np.asarray(jax.random.uniform(k2, (3,), minval=-1.0, maxval=1.0))))
    return out


def _jax_collection(key, num_series, ticks):
    def controller_factory(key):
        u_rand = jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0)
        return (lambda cs, x: (u_rand, cs)), None

    def x0_sampler(key):
        return jax.random.uniform(key, (3,), minval=-1.0, maxval=1.0)

    return jcl.collect_residual_dataset(controller_factory, lambda x, u: j_step(x, u) + DRIFT,
                                        j_step, x0_sampler, key, num_series, ticks)


def _fixed_by_series(draws):
    """A factory and a sampler that return series i's (u, x0) on their i-th
    call: the series run in order, one after another."""
    factory_calls, sampler_calls = itertools.count(), itertools.count()

    def controller_factory(gen):
        assert isinstance(gen, torch.Generator)
        u = t32(draws[next(factory_calls)][0])
        return (lambda cs, x: (u, cs)), None

    def x0_sampler(gen):
        return t32(draws[next(sampler_calls)][1])

    return controller_factory, x0_sampler


def _t_plant(x, u):
    return t_step(x, u) + torch.from_numpy(DRIFT)


def test_collect_residual_dataset_equals_jax():
    """Eight series of twenty ticks with the plant's drift the nominal model
    lacks: the (160, ·) triplet equals JAX's dataset, and the errors capture
    the drift."""
    key = jax.random.PRNGKey(0)
    jep = _jax_collection(key, 8, 20)
    factory, sampler = _fixed_by_series(_series_draws(key, 8))
    ep = cl.collect_residual_dataset(factory, _t_plant, t_step, sampler, 0, 8, 20, **CPU)
    assert ep.states.shape == (160, 3) and ep.controls.shape == (160, 2)
    for got, want in zip(ep, jep):
        close(got, want, rtol=1e-6, atol=1e-6)
    close(ep.errors.mean(0), DRIFT, 0, 1e-6)


def _random_factory(gen):
    u = torch.rand(2, generator=gen) * 2.0 - 1.0
    return (lambda cs, x: (u, cs)), None


def _random_sampler(gen):
    return torch.rand(3, generator=gen) * 2.0 - 1.0


def test_collect_seeds_each_series_from_seed_and_index():
    """Series i's generators come from (seed, i): a run of 3 series is the
    first 3 of a run of 5, another seed gives other series, and the
    generators are on the device asked for."""
    args = (_random_factory, _t_plant, t_step, _random_sampler)
    five = cl.collect_residual_dataset(*args, 11, 5, 4, **CPU)
    three = cl.collect_residual_dataset(*args, 11, 3, 4, **CPU)
    other = cl.collect_residual_dataset(*args, 12, 3, 4, **CPU)
    assert torch.equal(three.states, five.states[:12])
    assert not torch.equal(other.states, three.states)
    g_ctrl, g_x0 = cl.series_generators(11, 2, torch.device("cpu"))
    assert g_ctrl.device.type == "cpu" and g_ctrl.initial_seed() != g_x0.initial_seed()


def test_collect_resumable_checkpoints_and_matches(tmp_path):
    """Chunk-level resume: a run that lost its last chunk recomputes only
    that one (the others' files untouched), and the result equals the
    uninterrupted run and the one-call collection bit for bit."""
    args = (_random_factory, _t_plant, t_step, _random_sampler, 3, 10, 12)
    d1 = str(tmp_path / "run1")
    full = cl.collect_residual_dataset_resumable(*args, out_dir=d1, series_per_chunk=4, **CPU)
    assert full.states.shape == (120, 3)
    chunks = sorted(os.listdir(d1))
    assert chunks == ["chunk_00000.npz", "chunk_00001.npz", "chunk_00002.npz"]
    d2 = str(tmp_path / "run2")
    os.makedirs(d2)
    for c in chunks[:2]:
        shutil.copy(os.path.join(d1, c), os.path.join(d2, c))
    t0 = os.path.getmtime(os.path.join(d2, chunks[0]))
    resumed = cl.collect_residual_dataset_resumable(*args, out_dir=d2, series_per_chunk=4, **CPU)
    assert os.path.getmtime(os.path.join(d2, chunks[0])) == t0
    assert sorted(os.listdir(d2)) == chunks
    one_call = cl.collect_residual_dataset(*args, **CPU)
    for got, want, again in zip(resumed, full, one_call):
        assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("change", ["seed", "config_tag", "series_per_chunk", "ticks"])
def test_collect_resumable_invalidates_stale_cache(tmp_path, change):
    """A cached chunk from another seed, tag, chunk size or tick count is
    collected again (its file rewritten), never returned."""
    base = dict(seed=0, num_series=4, ticks_per_series=6, series_per_chunk=4, config_tag="")
    fns = (_random_factory, _t_plant, t_step, _random_sampler)
    d = str(tmp_path / "run")
    first = cl.collect_residual_dataset_resumable(*fns, out_dir=d, **base, **CPU)
    path = os.path.join(d, "chunk_00000.npz")
    t0 = os.stat(path).st_mtime_ns
    kw = dict(base, **{"seed": dict(seed=1), "config_tag": dict(config_tag="other"),
                       "series_per_chunk": dict(series_per_chunk=2),
                       "ticks": dict(ticks_per_series=5)}[change])
    again = cl.collect_residual_dataset_resumable(*fns, out_dir=d, **kw, **CPU)
    assert os.stat(path).st_mtime_ns != t0
    fresh = cl.collect_residual_dataset(*fns, kw["seed"], kw["num_series"],
                                        kw["ticks_per_series"], **CPU)
    assert torch.equal(again.states, fresh.states)
    if change == "seed":
        assert not torch.equal(again.states, first.states)
