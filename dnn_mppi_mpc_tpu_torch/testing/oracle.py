"""Scalar numpy MPPI oracle for golden-trace / parity testing.

A copy of ``dnn_mppi_mpc_tpu/testing/oracle.py``, kept here so that the
port can hold its ticks against it on a machine without JAX
(``chip_smoke.py``); ``tests/test_torch_oracle.py`` holds the two copies
equal.

An independent, loop-level re-implementation of the reference MPPI semantics
(controllers/mppi_differential_drive.py:87-165) used ONLY by tests and the
verification harness: the TPU engine is checked against this oracle with
identical injected noise (SURVEY §7 "Noise/RNG parity"). Two modes:

* ``faithful=True`` replicates the reference quirks exactly:
  - the stateful nearest-waypoint search whose window start mutates across
    every (k, t) cost call (mppi_differential_drive.py:201-220, :228)
  - the ``S[k] =`` stage-cost overwrite (:124)
* ``faithful=False`` ("pure" mode) uses the cleaned-up semantics the TPU engine
  implements: window start fixed per control tick, ``+=`` accumulation —
  this mode must match the JAX engine to float tolerance.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class OracleMPPI:
    """Scalar-loop MPPI over unicycle dynamics (the reference's config 1)."""

    ref_path: np.ndarray
    dt: float = 0.1
    K: int = 100
    T: int = 10
    lam: float = 1.0
    alpha: float = 0.2
    exploration: float = 0.0001
    sigma: np.ndarray = None
    stage_weight: np.ndarray = None
    terminal_weight: np.ndarray = None
    max_speed: float = 5.0
    max_omega: float = 3.14
    search_len: int = 20
    faithful: bool = True
    temperature: str = "exploration"  # diff-drive uses 1/exploration (:175)
    filter_window: int = 10
    waypoint_carry: str = "tick"  # pure-mode lookup anchoring: "tick" mirrors
    # the engine default; "rollout" carries a per-sample monotone window start
    # through the rollout (MPPIConfig.waypoint_carry) — only used with
    # faithful=False (faithful mode replicates the reference's full
    # cross-sample mutation instead)
    waypoint_persist: str = "none"  # "max" persists the furthest carried index

    def __post_init__(self):
        if self.sigma is None:
            self.sigma = np.array([[0.1, 0.0], [0.0, 0.01]])
        if self.stage_weight is None:
            self.stage_weight = np.array([5.0, 5.0, 10.0])
        if self.terminal_weight is None:
            self.terminal_weight = np.array([5.0, 5.0, 10.0])
        self.u_prev = np.zeros((self.T, 2))
        self.prev_idx = 0
        self.gamma = self.lam * (1.0 - self.alpha)
        self.sigma_inv = np.linalg.inv(self.sigma)

    # -- pieces -----------------------------------------------------------
    def _transition(self, x, v):
        return np.array(
            [
                x[0] + v[0] * np.cos(x[2]) * self.dt,
                x[1] + v[0] * np.sin(x[2]) * self.dt,
                x[2] + v[1] * self.dt,
            ]
        )

    def _clamp(self, v):
        return np.array(
            [
                np.clip(v[0], -self.max_speed, self.max_speed),
                np.clip(v[1], -self.max_omega, self.max_omega),
            ]
        )

    def _nearest(self, x, y, update):
        start = self.prev_idx
        window = self.ref_path[start : start + self.search_len]
        d = (x - window[:, 0]) ** 2 + (y - window[:, 1]) ** 2
        local = int(np.argmin(d))
        idx = local + start
        if update:
            self.prev_idx = idx
        return self.ref_path[idx]

    def _nearest_pure(self, x, y, start):
        P = self.ref_path.shape[0]
        start = min(max(start, 0), max(P - self.search_len, 0))
        window = self.ref_path[start : start + self.search_len]
        d = (x - window[:, 0]) ** 2 + (y - window[:, 1]) ** 2
        return self.ref_path[int(np.argmin(d)) + start]

    def _nearest_carried(self, x, y, start):
        """Pure forward-only lookup returning (idx, ref) — the numpy twin of
        ops/waypoints.nearest_waypoint_carried. Truncates at the path end
        like the reference's [prev : prev+W] slice (never regresses)."""
        P = self.ref_path.shape[0]
        start = min(max(start, 0), P - 1)
        window = self.ref_path[start : start + self.search_len]
        d = (x - window[:, 0]) ** 2 + (y - window[:, 1]) ** 2
        idx = int(np.argmin(d)) + start
        return idx, self.ref_path[idx]

    def _track_cost(self, x, weight, tick_start):
        if self.faithful:
            ref = self._nearest(x[0], x[1], update=True)
        else:
            ref = self._nearest_pure(x[0], x[1], tick_start)
        e = x - ref[:3]
        return float(np.sum(weight * e * e))

    def _moving_average(self, xx):
        # clamp like the engine (ops/filters.py moving_average_edge) so
        # short-horizon parity configs (T < filter_window) are testable —
        # reference configs always satisfy w ≤ T so semantics are unchanged
        w = min(self.filter_window, xx.shape[0])
        b = np.ones(w) / w
        out = np.zeros_like(xx)
        n_conv = math.ceil(w / 2)
        for d in range(xx.shape[1]):
            out[:, d] = np.convolve(xx[:, d], b, mode="same")
            out[0, d] *= w / n_conv
            for i in range(1, n_conv):
                out[i, d] *= w / (i + n_conv)
                out[-1, d] *= w / (i + n_conv - (w % 2))
        return out

    # -- one control tick -------------------------------------------------
    def step(self, x0: np.ndarray, epsilon: np.ndarray):
        """One tick with injected noise ε of shape (K, T, 2).

        Returns (u0, u_sequence, costs S).
        """
        u = self.u_prev.copy()
        # tick-level waypoint advance (update_prev_idx=True at :96)
        if self.faithful:
            self._nearest(x0[0], x0[1], update=True)
        else:
            # mirror the engine: clipped window, argmin, window start becomes idx
            P = self.ref_path.shape[0]
            start = min(max(self.prev_idx, 0), max(P - self.search_len, 0))
            window = self.ref_path[start : start + self.search_len, :2]
            d = np.sum((window - x0[:2]) ** 2, axis=1)
            self.prev_idx = int(np.argmin(d)) + start
        tick_start = self.prev_idx

        S = np.zeros(self.K)
        v = np.zeros((self.K, self.T, 2))
        n_exploit = (1.0 - self.exploration) * self.K
        rollout_carry = (not self.faithful) and self.waypoint_carry == "rollout"
        final_wpi = np.full(self.K, tick_start, dtype=int)
        for k in range(self.K):
            x = x0.copy()
            wpi = tick_start
            for t in range(1, self.T + 1):
                if k < n_exploit:
                    v[k, t - 1] = u[t - 1] + epsilon[k, t - 1]
                else:
                    v[k, t - 1] = epsilon[k, t - 1]
                v[k, t - 1] = self._clamp(v[k, t - 1])
                x = self._transition(x, v[k, t - 1])
                if rollout_carry:
                    # cost anchored at the pre-update carry; argmin becomes
                    # the next carry (engine: waypoint_carry="rollout")
                    idx, ref = self._nearest_carried(x[0], x[1], wpi)
                    e = x - ref[:3]
                    c = float(np.sum(self.stage_weight * e * e))
                    wpi = idx
                else:
                    c = self._track_cost(x, self.stage_weight, tick_start)
                c += self.gamma * float(u[t - 1] @ self.sigma_inv @ v[k, t - 1])
                if self.faithful:
                    S[k] = c  # reference overwrite quirk (:124)
                else:
                    S[k] += c
            if rollout_carry:
                _, ref = self._nearest_carried(x[0], x[1], wpi)
                e = x - ref[:3]
                S[k] += float(np.sum(self.terminal_weight * e * e))
                final_wpi[k] = wpi
            else:
                S[k] += self._track_cost(x, self.terminal_weight, tick_start)
        if rollout_carry and self.waypoint_persist == "max":
            self.prev_idx = int(final_wpi.max())

        rho = S.min()
        inv_temp = (
            1.0 / self.exploration if self.temperature == "exploration" else 1.0 / self.lam
        )
        eta = np.sum(np.exp(-inv_temp * (S - rho)))
        w = np.exp(-inv_temp * (S - rho)) / eta

        w_eps = np.einsum("k,ktu->tu", w, epsilon)
        w_eps = self._moving_average(w_eps)
        u = u + w_eps

        self.u_prev[:-1] = u[1:]
        self.u_prev[-1] = u[-1]
        return u[0], u, S


@dataclasses.dataclass
class OracleRacecarMPPI:
    """Scalar-loop race-car MPPI (kinematic bicycle + polygon collision).

    Independent re-implementation of controllers/mppi_race_car_obstacle.py:65-131:
    λ-convention softmax (:222-224), ``+=`` accumulation (:94), yaw wrapped to
    [0, 2π) in the cost (:151), padded moving-average filter (:228-239),
    9-point vehicle outline vs circles with 1.5× margin (:255-274). The cost-side
    waypoint lookup here is already pure (window start fixed per tick, :153), so
    the TPU engine matches this oracle exactly under injected noise.
    """

    ref_path: np.ndarray
    dt: float = 0.05
    wheel_base: float = 2.5
    K: int = 100
    T: int = 10
    lam: float = 50.0
    alpha: float = 1.0
    exploration: float = 0.01
    sigma: np.ndarray = None
    stage_weight: np.ndarray = None
    terminal_weight: np.ndarray = None
    max_steer: float = 0.523
    max_accel: float = 2.0
    obstacles: np.ndarray = None  # (n, 3) x, y, r
    vehicle_w: float = 3.0
    vehicle_l: float = 4.0
    margin_rate: float = 1.5
    collision_penalty: float = 1.0e7
    search_len: int = 200
    filter_window: int = 10

    def __post_init__(self):
        if self.sigma is None:
            self.sigma = np.array([[0.5, 0.0], [0.0, 0.1]])
        if self.stage_weight is None:
            self.stage_weight = np.array([50.0, 50.0, 1.0, 20.0])
        if self.terminal_weight is None:
            self.terminal_weight = np.array([50.0, 50.0, 1.0, 20.0])
        if self.obstacles is None:
            self.obstacles = np.zeros((0, 3))
        self.u_prev = np.zeros((self.T, 2))
        self.prev_idx = 0
        self.gamma = self.lam * (1.0 - self.alpha)
        self.sigma_inv = np.linalg.inv(self.sigma)

    def _transition(self, x, v):
        steer, accel = v
        return np.array(
            [
                x[0] + x[3] * np.cos(x[2]) * self.dt,
                x[1] + x[3] * np.sin(x[2]) * self.dt,
                x[2] + x[3] / self.wheel_base * np.tan(steer) * self.dt,
                x[3] + accel * self.dt,
            ]
        )

    def _clamp(self, v):
        return np.array(
            [
                np.clip(v[0], -self.max_steer, self.max_steer),
                np.clip(v[1], -self.max_accel, self.max_accel),
            ]
        )

    def _nearest(self, x, y, start):
        P = self.ref_path.shape[0]
        w = min(self.search_len, P)
        start = min(max(start, 0), max(P - w, 0))
        window = self.ref_path[start : start + w]
        d = (x - window[:, 0]) ** 2 + (y - window[:, 1]) ** 2
        return int(np.argmin(d)) + start

    def _collided(self, x_t):
        x, y, yaw = x_t[0], x_t[1], x_t[2]
        hl = 0.5 * self.vehicle_l * self.margin_rate
        hw = 0.5 * self.vehicle_w * self.margin_rate
        bx = np.array([-1.0, -1.0, 0.0, 1.0, 1.0, 1.0, 0.0, -1.0, -1.0]) * hl
        by = np.array([0.0, 1.0, 1.0, 1.0, 0.0, -1.0, -1.0, -1.0, 0.0]) * hw
        px = bx * np.cos(yaw) - by * np.sin(yaw) + x
        py = bx * np.sin(yaw) + by * np.cos(yaw) + y
        for ox, oy, r in self.obstacles:
            if np.any((px - ox) ** 2 + (py - oy) ** 2 < r**2):
                return 1.0
        return 0.0

    def _cost(self, x_t, weight, tick_start):
        idx = self._nearest(x_t[0], x_t[1], tick_start)
        ref = self.ref_path[idx]
        yaw = np.mod(x_t[2] + 2.0 * np.pi, 2.0 * np.pi)
        e = np.array([x_t[0] - ref[0], x_t[1] - ref[1], yaw - ref[2], x_t[3] - ref[3]])
        c = float(np.sum(weight * e * e))
        return c + self._collided(x_t) * self.collision_penalty

    def _moving_average_padded(self, xx):
        k = self.filter_window
        kernel = np.ones(k) / k
        out = np.zeros_like(xx)
        for d in range(xx.shape[1]):
            padded = np.concatenate([xx[: k // 2, d], xx[:, d], xx[-(k // 2):, d]])
            out[:, d] = np.convolve(padded, kernel, mode="same")[k // 2 : -(k // 2)]
        return out

    def step(self, x0: np.ndarray, epsilon: np.ndarray):
        u = self.u_prev.copy()
        self.prev_idx = self._nearest(x0[0], x0[1], self.prev_idx)
        tick_start = self.prev_idx

        S = np.zeros(self.K)
        n_exploit = (1.0 - self.exploration) * self.K
        for k in range(self.K):
            x = x0.copy()
            for t in range(1, self.T + 1):
                if k < n_exploit:
                    v = u[t - 1] + epsilon[k, t - 1]
                else:
                    v = epsilon[k, t - 1].copy()
                v = self._clamp(v)
                x = self._transition(x, v)
                S[k] += self._cost(x, self.stage_weight, tick_start)
                S[k] += self.gamma * float(u[t - 1] @ self.sigma_inv @ v)
            S[k] += self._cost(x, self.terminal_weight, tick_start)

        rho = S.min()
        w = np.exp(-(1.0 / self.lam) * (S - rho))
        w /= w.sum()

        w_eps = np.einsum("k,ktu->tu", w, epsilon)
        w_eps = self._moving_average_padded(w_eps)
        u = u + w_eps
        self.u_prev[:-1] = u[1:]
        self.u_prev[-1] = u[-1]
        return u[0], u, S


__all__ = ["OracleMPPI", "OracleRacecarMPPI"]
