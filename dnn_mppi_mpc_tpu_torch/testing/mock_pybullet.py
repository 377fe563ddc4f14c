"""In-process kinematic mock of the pybullet API subset the bridge uses.

A copy of ``dnn_mppi_mpc_tpu/testing/mock_pybullet.py``, kept here so that
the port's ``envs/bullet_bridge.py`` runs end to end on a machine without
JAX or pybullet; ``tests/test_torch_bullet_bridge.py`` holds the two
bridges equal on it.

``envs/bullet_bridge.py`` mirrors the reference's PyBullet deployment loops
(simulation/bullet_differential_drive_dnn.py:419-467 — Husky wheel-velocity
motors; controllers/bullet_mpc_race_car_obstacle.py:396-528 — racecar joint
discovery + Ackermann IK), but pybullet is not installable in the TPU image,
so that code would otherwise run dark. This module is a drop-in
``sys.modules["pybullet"]`` stand-in that executes the SAME call sequence the
real engine would see: connect → loadURDF → getNumJoints/getJointInfo →
setJointMotorControl2 → stepSimulation → getBasePositionAndOrientation.

It is NOT a physics engine. Velocity-controlled wheel joints track their
targets through an optional first-order lag and the base pose integrates
ideal differential-drive / kinematic-bicycle kinematics at the physics
timestep — the same actuation model as :class:`..envs.plants.WheelPlant`,
implemented independently in scalar numpy so tests can crosscheck the
bridge's IK + command plumbing against the JAX plant (not against itself).

Every motor command is recorded in ``body.command_log`` so tests can assert
the exact wheel-speed targets the bridge sent (the
``envs.kinematics.diff_drive_wheel_speeds`` /
``ackermann_wheel_speeds`` outputs).

Usage (see tests/test_bullet_bridge.py)::

    import dnn_mppi_mpc_tpu_torch.testing.mock_pybullet as mock
    sys.modules["pybullet"] = mock
    sys.modules["pybullet_data"] = mock   # provides getDataPath()
    env = BulletDiffDriveEnv()            # runs against the mock
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# --- constants (values mirror the real pybullet module) ---------------------
DIRECT = 2
GUI = 1
VELOCITY_CONTROL = 0
TORQUE_CONTROL = 1
POSITION_CONTROL = 2

HUSKY_WHEEL_SEP = 0.5708  # envs.kinematics.HUSKY_WHEEL_SEP (husky URDF track)
RACECAR_WHEEL_BASE = 0.325  # pybullet_data racecar (mpc_racecar.py:31)


@dataclass
class _Joint:
    name: str
    velocity_target: float = 0.0
    position_target: float = 0.0
    velocity: float = 0.0
    position: float = 0.0
    force: float = 0.0


@dataclass
class _Body:
    """One loaded URDF. ``kind`` selects the integration model."""

    kind: str  # "static" | "husky" | "racecar"
    joints: List[_Joint]
    pos: np.ndarray
    yaw: float = 0.0
    lin_vel: np.ndarray = field(default_factory=lambda: np.zeros(3))
    ang_vel: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # (joint_index, control_mode, target, force) per setJointMotorControl2
    command_log: List[Tuple[int, int, float, float]] = field(default_factory=list)


class _Sim:
    def __init__(self) -> None:
        self.dt = 1.0 / 240.0
        self.gravity = (0.0, 0.0, 0.0)
        self.bodies: Dict[int, _Body] = {}
        self.wheel_tau = 0.0  # optional first-order joint-velocity lag
        self.steps = 0

    # -- body construction ---------------------------------------------------
    def load(self, fileName: str, basePosition) -> int:
        name = fileName.lower()
        pos = np.asarray(basePosition, dtype=float)
        if "husky" in name:
            joints = [
                _Joint("chassis_joint"),
                _Joint("imu_joint"),
                # indices 2-5: the bridge's default wheel_joint_indices,
                # matching the real husky.urdf wheel joint layout
                _Joint("front_left_wheel"),
                _Joint("front_right_wheel"),
                _Joint("rear_left_wheel"),
                _Joint("rear_right_wheel"),
            ]
            body = _Body("husky", joints, pos)
        elif "racecar" in name:
            joints = [
                _Joint("chassis_inertia_joint"),
                # discovery order must give drive joints (lr, rr, lf, rf) —
                # the order ackermann_wheel_speeds emits and the reference's
                # bullet_mpc_race_car_obstacle.py:409-419 name-split produces
                _Joint("left_rear_wheel_joint"),
                _Joint("right_rear_wheel_joint"),
                _Joint("left_steering_hinge_joint"),
                _Joint("left_front_wheel_joint"),
                _Joint("right_steering_hinge_joint"),
                _Joint("right_front_wheel_joint"),
            ]
            body = _Body("racecar", joints, pos)
        else:  # plane.urdf and friends
            body = _Body("static", [], pos)
        bid = len(self.bodies)
        self.bodies[bid] = body
        return bid

    # -- integration ---------------------------------------------------------
    def step(self) -> None:
        for body in self.bodies.values():
            if body.kind == "husky":
                self._step_husky(body)
            elif body.kind == "racecar":
                self._step_racecar(body)
        self.steps += 1

    def _track(self, j: _Joint) -> float:
        if self.wheel_tau > 0.0:
            alpha = 1.0 - math.exp(-self.dt / self.wheel_tau)
            j.velocity += alpha * (j.velocity_target - j.velocity)
        else:
            j.velocity = j.velocity_target
        return j.velocity

    def _step_husky(self, body: _Body) -> None:
        w = [self._track(body.joints[i]) for i in (2, 3, 4, 5)]
        # FK twin of WheelPlant (wheel order fl, fr, rl, rr)
        left = 0.5 * (w[0] + w[2])
        right = 0.5 * (w[1] + w[3])
        v = 0.5 * (left + right)
        omega = (right - left) / HUSKY_WHEEL_SEP
        c, s = math.cos(body.yaw), math.sin(body.yaw)
        body.pos[0] += self.dt * v * c
        body.pos[1] += self.dt * v * s
        body.yaw += self.dt * omega
        body.lin_vel = np.array([v * c, v * s, 0.0])
        body.ang_vel = np.array([0.0, 0.0, omega])

    def _step_racecar(self, body: _Body) -> None:
        steer_targets = [
            j.position_target for j in body.joints if "steering" in j.name
        ]
        steer = float(np.mean(steer_targets)) if steer_targets else 0.0
        for j in body.joints:
            if "steering" in j.name:
                j.position = j.position_target  # ideal position servo
        rear = [
            self._track(j)
            for j in body.joints
            if "wheel" in j.name and "rear" in j.name
        ]
        # also advance the front wheels' lag state
        for j in body.joints:
            if "wheel" in j.name and "front" in j.name:
                self._track(j)
        v = float(np.mean(rear)) if rear else 0.0  # (lr + rr)/2 == body v
        c, s = math.cos(body.yaw), math.sin(body.yaw)
        body.pos[0] += self.dt * v * c
        body.pos[1] += self.dt * v * s
        body.yaw += self.dt * v * math.tan(steer) / RACECAR_WHEEL_BASE
        body.lin_vel = np.array([v * c, v * s, 0.0])
        body.ang_vel = np.array([0.0, 0.0, v * math.tan(steer) / RACECAR_WHEEL_BASE])


_clients: Dict[int, _Sim] = {}
_next_client = [0]


def _sim(client: Optional[int] = None) -> _Sim:
    if not _clients:
        raise RuntimeError("mock pybullet: not connected")
    if client is None:
        client = max(_clients)
    return _clients[client]


# --- module-level API (the subset envs/bullet_bridge.py calls) --------------


def connect(mode: int = DIRECT) -> int:
    cid = _next_client[0]
    _next_client[0] += 1
    _clients[cid] = _Sim()
    return cid


def disconnect(client: Optional[int] = None) -> None:
    if client is None and _clients:
        client = max(_clients)
    _clients.pop(client, None)


def isConnected() -> bool:
    return bool(_clients)


def setAdditionalSearchPath(path: str) -> None:
    pass


def getDataPath() -> str:  # doubles as the pybullet_data module surface
    return ""


def setGravity(gx: float, gy: float, gz: float) -> None:
    _sim().gravity = (gx, gy, gz)


def setTimeStep(dt: float) -> None:
    _sim().dt = float(dt)


def setRealTimeSimulation(flag: int) -> None:
    pass


def loadURDF(fileName: str, basePosition=(0.0, 0.0, 0.0), *args, **kwargs) -> int:
    return _sim().load(fileName, basePosition)


def getNumJoints(bodyUniqueId: int) -> int:
    return len(_sim().bodies[bodyUniqueId].joints)


def getJointInfo(bodyUniqueId: int, jointIndex: int) -> tuple:
    j = _sim().bodies[bodyUniqueId].joints[jointIndex]
    # real pybullet returns a 17-tuple; the bridge reads [1] (name bytes)
    return (jointIndex, j.name.encode()) + (None,) * 15


def getJointState(bodyUniqueId: int, jointIndex: int) -> tuple:
    j = _sim().bodies[bodyUniqueId].joints[jointIndex]
    return (j.position, j.velocity, (0.0,) * 6, 0.0)


def setJointMotorControl2(
    bodyUniqueId: int,
    jointIndex: int,
    controlMode: int,
    targetVelocity: float = 0.0,
    targetPosition: float = 0.0,
    force: float = 0.0,
    **kwargs,
) -> None:
    body = _sim().bodies[bodyUniqueId]
    j = body.joints[jointIndex]
    if controlMode == VELOCITY_CONTROL:
        j.velocity_target = float(targetVelocity)
        body.command_log.append((jointIndex, controlMode, float(targetVelocity), float(force)))
    elif controlMode == POSITION_CONTROL:
        j.position_target = float(targetPosition)
        body.command_log.append((jointIndex, controlMode, float(targetPosition), float(force)))
    else:
        raise NotImplementedError(f"mock pybullet: control mode {controlMode}")
    j.force = float(force)


def stepSimulation() -> None:
    _sim().step()


def getBasePositionAndOrientation(bodyUniqueId: int) -> tuple:
    body = _sim().bodies[bodyUniqueId]
    half = 0.5 * body.yaw
    quat = (0.0, 0.0, math.sin(half), math.cos(half))  # (x, y, z, w)
    return (tuple(body.pos), quat)


def resetBasePositionAndOrientation(bodyUniqueId: int, pos, quat) -> None:
    body = _sim().bodies[bodyUniqueId]
    body.pos = np.asarray(pos, dtype=float)
    body.yaw = getEulerFromQuaternion(quat)[2]


def getBaseVelocity(bodyUniqueId: int) -> tuple:
    body = _sim().bodies[bodyUniqueId]
    return (tuple(body.lin_vel), tuple(body.ang_vel))


def getEulerFromQuaternion(quat) -> tuple:
    x, y, z, w = quat
    # ZYX convention, matching pybullet
    roll = math.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = math.asin(max(-1.0, min(1.0, 2.0 * (w * y - z * x))))
    yaw = math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return (roll, pitch, yaw)


def getQuaternionFromEuler(euler) -> tuple:
    roll, pitch, yaw = euler
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    return (
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    )


def _reset() -> None:
    """Test hook: drop all clients (fresh module state between tests)."""
    _clients.clear()
    _next_client[0] = 0


def _body(bodyUniqueId: int) -> _Body:
    """Test hook: direct access to a body's state + command log."""
    return _sim().bodies[bodyUniqueId]
