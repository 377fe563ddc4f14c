"""The port's PyBullet bridge (``envs/bullet_bridge.py``) end to end on its
vendored mock engine (``testing/mock_pybullet.py``), beside the JAX
package's bridge on its own mock, on the CPU — tests/test_bullet_bridge.py's
seven tests:

* the bridge sees an engine injected as ``sys.modules["pybullet"]``;
* the diff-drive and Ackermann wheel commands: the port's command logs
  equal the JAX bridge's bit for bit (the kinematics in float64), and the
  IK's closed forms;
* the diff-drive closed loop under scripted commands at 240 and 10 Hz: the
  states equal the JAX bridge's bit for bit and the JAX ``WheelPlant``
  (tau = 0) at the physics dt within 1e-9;
* the racecar URDF's joint discovery; the Ackermann pose against the scalar
  kinematic bicycle within 1e-9;
* the port's fused goal-seeking tick (its plain version here) in the loop:
  the final distance under 0.55 of the first, the controller's tensor read
  to the host by the bridge.
"""

from __future__ import annotations

import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dnn_mppi_mpc_tpu.testing.mock_pybullet as j_mock
from dnn_mppi_mpc_tpu.envs import bullet_bridge as j_bridge
from dnn_mppi_mpc_tpu.envs.plants import WheelPlant as JWheelPlant
from dnn_mppi_mpc_tpu_torch import presets
from dnn_mppi_mpc_tpu_torch.envs import bullet_bridge as t_bridge
from dnn_mppi_mpc_tpu_torch.envs.kinematics import HUSKY_WHEEL_SEP
from dnn_mppi_mpc_tpu_torch.testing import mock_pybullet as t_mock


def _inject(monkeypatch, mock):
    mock._reset()
    monkeypatch.setitem(sys.modules, "pybullet", mock)
    monkeypatch.setitem(sys.modules, "pybullet_data", mock)


def _both(monkeypatch, run):
    """``run(bridge module, mock)`` on the JAX bridge over its mock, then on
    the port's over its own."""
    out = []
    for bridge, mock in ((j_bridge, j_mock), (t_bridge, t_mock)):
        _inject(monkeypatch, mock)
        out.append(run(bridge, mock))
    return out


def test_has_pybullet_sees_injection(monkeypatch):
    _inject(monkeypatch, t_mock)
    assert t_bridge.has_pybullet()
    assert t_bridge.HAS_PYBULLET  # read when asked, not at import


def test_diffdrive_commands_match_ik(monkeypatch):
    def run(bridge, mock):
        env = bridge.BulletDiffDriveEnv(physics_hz=240.0, max_wheel_force=17.5)
        env.apply_control(0.8, -0.4)
        log = list(mock._body(env.robot).command_log)
        env.close()
        return log

    j_log, t_log = _both(monkeypatch, run)
    assert t_log == j_log
    assert [c[0] for c in t_log] == [2, 3, 4, 5]
    assert all(c[1] == t_mock.VELOCITY_CONTROL and c[3] == 17.5 for c in t_log)
    np.testing.assert_allclose([c[2] for c in t_log],
                               [0.8 + 0.4 * HUSKY_WHEEL_SEP / 2, 0.8 - 0.4 * HUSKY_WHEEL_SEP / 2] * 2,
                               rtol=1e-12)


def _scripted(num_ticks):
    ts = np.arange(num_ticks)
    return np.stack([0.6 + 0.3 * np.sin(0.11 * ts), 0.5 * np.cos(0.07 * ts)], axis=-1)


@pytest.mark.parametrize("control_hz", [240.0, 10.0])
def test_diffdrive_closed_loop_matches_wheelplant(monkeypatch, control_hz):
    physics_hz, num_ticks = 240.0, 40
    cmds = _scripted(num_ticks)

    def run(bridge, mock):
        ticks = iter(range(num_ticks))
        env = bridge.BulletDiffDriveEnv(physics_hz=physics_hz)
        states = env.run(lambda x: cmds[next(ticks)], num_ticks=num_ticks, control_hz=control_hz)
        final = env.get_state()
        env.close()
        return states, final

    (j_states, j_final), (t_states, t_final) = _both(monkeypatch, run)
    np.testing.assert_array_equal(t_states, j_states)
    np.testing.assert_array_equal(t_final, j_final)
    substeps = max(1, int(physics_hz / control_hz))
    plant = JWheelPlant(dt=1.0 / physics_hz, wheel_sep=HUSKY_WHEEL_SEP)
    st = plant.init(jnp.zeros(3, dtype=jnp.float64))
    ref = []
    for i in range(num_ticks):
        ref.append(np.asarray(st.x))
        for _ in range(substeps):
            st = plant.step_body(st, jnp.asarray(cmds[i], dtype=jnp.float64))
    np.testing.assert_allclose(t_states, np.asarray(ref), atol=1e-9)
    np.testing.assert_allclose(t_final, np.asarray(st.x), atol=1e-9)
    assert np.hypot(t_final[0], t_final[1]) > 0.05


def test_diffdrive_mppi_in_the_loop(monkeypatch):
    """The deployment shape: the goal-seeking fused tick (K = 256, T = 20,
    dt = 0.1) driving the bridge for 25 ticks at 10 Hz; the bridge reads the
    returned tensor to the host."""
    _inject(monkeypatch, t_mock)
    goal = [1.0, 0.6, 0.0]
    solver, params = presets.goal_seeking_mppi(goal, num_samples=256, horizon=20, dt=0.1,
                                               fused_tick=True, device="cpu")
    state = {"st": solver.init()}

    def controller(x):
        u0, state["st"], _ = solver.step(params, state["st"], torch.as_tensor(x, dtype=torch.float32))
        return u0

    env = t_bridge.BulletDiffDriveEnv()
    env.run(controller, num_ticks=25, control_hz=10.0)
    final = env.get_state()
    env.close()
    d0 = float(np.hypot(goal[0], goal[1]))
    d1 = float(np.hypot(final[0] - goal[0], final[1] - goal[1]))
    assert d1 < 0.55 * d0, (final, d1, d0)


def test_ackermann_joint_discovery(monkeypatch):
    _inject(monkeypatch, t_mock)
    env = t_bridge.BulletAckermannEnv()
    assert env.steer_joints == [3, 5]
    assert env.drive_joints == [1, 2, 4, 6]  # lr, rr, lf, rf
    env.close()


def test_ackermann_commands_match_ik(monkeypatch):
    def run(bridge, mock):
        env = bridge.BulletAckermannEnv(wheel_base=0.325, track_width=0.2)
        env.apply_control(0.3, 1.5)
        log = list(mock._body(env.robot).command_log)
        env.close()
        return log

    j_log, t_log = _both(monkeypatch, run)
    assert t_log == j_log
    pos = [c for c in t_log if c[1] == t_mock.POSITION_CONTROL]
    vel = [c for c in t_log if c[1] == t_mock.VELOCITY_CONTROL]
    assert [c[0] for c in pos] == [3, 5] and all(c[2] == pytest.approx(0.3) for c in pos)
    assert [c[0] for c in vel] == [1, 2, 4, 6]
    t = math.tan(0.3)
    np.testing.assert_allclose(vel[0][2], 1.5 * (1.0 - 0.2 * t / (2 * 0.325)), rtol=1e-12)


def test_ackermann_closed_loop_matches_bicycle(monkeypatch):
    physics_hz, control_hz, num_ticks, wheel_base = 240.0, 20.0, 30, 0.325
    cmds = np.stack([0.25 * np.sin(0.2 * np.arange(num_ticks)), np.full(num_ticks, 1.2)], -1)

    def run(bridge, mock):
        ticks = iter(range(num_ticks))
        env = bridge.BulletAckermannEnv(physics_hz=physics_hz, wheel_base=wheel_base)
        states = env.run(lambda x: torch.as_tensor(cmds[next(ticks)]), num_ticks=num_ticks,
                         control_hz=control_hz)
        env.close()
        return states

    j_states, t_states = _both(monkeypatch, run)
    np.testing.assert_array_equal(t_states, j_states)
    substeps, dt = int(physics_hz / control_hz), 1.0 / physics_hz
    x = y = yaw = speed = 0.0
    ref = []
    for i in range(num_ticks):
        ref.append([x, y, yaw, speed])
        steer, v = cmds[i]
        for _ in range(substeps):
            x += dt * v * math.cos(yaw)
            y += dt * v * math.sin(yaw)
            yaw += dt * v * math.tan(steer) / wheel_base
        speed = v
    np.testing.assert_allclose(t_states, np.asarray(ref), atol=1e-9)
    assert abs(t_states[-1][2]) > 0.02
