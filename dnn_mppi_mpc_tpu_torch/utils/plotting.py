"""Headless trajectory / control plots (Agg backend, PNG artifacts).

Covers the visualization surface of the reference without its blocking
FuncAnimation windows: trajectory overview with sampled-rollout fans
(controllers/mppi_differential_drive.py:291-372), control-signal panels
(controllers/mppi_race_car_obstacle.py:301-321), state/error panels
(controllers/mpc_differential_dynamics.py:317-391), and training curves
(train/train_diff_mlp.py:139-159).

A copy of ``dnn_mppi_mpc_tpu/utils/plotting.py`` (numpy and matplotlib
only; the port imports nothing of the JAX package);
``tests/test_torch_plotting.py`` holds the two copies equal (their code,
and their plots byte for byte). It imports matplotlib when it is
imported, as the original does: a host without matplotlib cannot load it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def plot_trajectory(
    path: str,
    states: np.ndarray,
    ref_path: Optional[np.ndarray] = None,
    sampled_trajs: Optional[np.ndarray] = None,
    optimal_traj: Optional[np.ndarray] = None,
    obstacles: Optional[np.ndarray] = None,
    title: str = "trajectory",
) -> None:
    """Top-down view: driven path, reference, sampled fan, obstacles."""
    fig, ax = plt.subplots(figsize=(7, 7))
    if sampled_trajs is not None:
        for i, tr in enumerate(np.asarray(sampled_trajs)):
            alpha = max(0.05, 0.35 * (1.0 - i / max(1, len(sampled_trajs))))
            ax.plot(tr[:, 0], tr[:, 1], color="gray", lw=0.3, alpha=alpha, zorder=2)
    if ref_path is not None:
        ref_path = np.asarray(ref_path)
        ax.plot(ref_path[:, 0], ref_path[:, 1], "b--", lw=1.0, label="reference", zorder=3)
    if optimal_traj is not None:
        optimal_traj = np.asarray(optimal_traj)
        ax.plot(optimal_traj[:, 0], optimal_traj[:, 1], color="#990099", lw=1.5, label="planned", zorder=4)
    states = np.asarray(states)
    ax.plot(states[:, 0], states[:, 1], "g-", lw=1.5, label="driven", zorder=5)
    if states.shape[1] >= 3:
        draw_robot(ax, states[-1, 0], states[-1, 1], states[-1, 2])
    if obstacles is not None:
        for ox, oy, r in np.asarray(obstacles):
            ax.add_patch(plt.Circle((ox, oy), r, color="red", alpha=0.4, zorder=1))
    ax.set_xlabel("x [m]"), ax.set_ylabel("y [m]")
    ax.set_title(title), ax.axis("equal"), ax.grid(True), ax.legend()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def draw_robot(ax, x: float, y: float, yaw: float, body_l: float = 0.6, body_w: float = 0.4) -> None:
    """Body + four wheels footprint at a pose — the headless equivalent of the
    DifferentialSimulation renderer (models/differentialSim.py:5-75)."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s], [s, c]])

    def poly(cx, cy, L, W):
        pts = np.array(
            [[-L / 2, -W / 2], [L / 2, -W / 2], [L / 2, W / 2], [-L / 2, W / 2]]
        )
        pts = pts @ R.T + np.array([cx, cy])
        return plt.Polygon(pts, closed=True, fill=False, ec="k", lw=1.0, zorder=6)

    ax.add_patch(poly(x, y, body_l, body_w))
    wl, ww = body_l * 0.35, body_w * 0.18
    for dx, dy in [
        (body_l * 0.3, body_w * 0.55),
        (body_l * 0.3, -body_w * 0.55),
        (-body_l * 0.3, body_w * 0.55),
        (-body_l * 0.3, -body_w * 0.55),
    ]:
        wx, wy = np.array([dx, dy]) @ R.T + np.array([x, y])
        ax.add_patch(poly(wx, wy, wl, ww))
    ax.plot(
        [x, x + 0.5 * body_l * c], [y, y + 0.5 * body_l * s], "k-", lw=1.2, zorder=6
    )


def plot_controls(
    path: str, controls: np.ndarray, dt: float, labels: Optional[Sequence[str]] = None
) -> None:
    """Per-channel control signals over time (mppi_race_car_obstacle.py:301-321)."""
    controls = np.asarray(controls)
    nu = controls.shape[1]
    t = np.arange(controls.shape[0]) * dt
    fig, axes = plt.subplots(1, nu, figsize=(5 * nu, 4))
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes):
        ax.plot(t, controls[:, i], lw=2)
        ax.set_xlabel("time [s]")
        ax.set_ylabel(labels[i] if labels else f"u{i}")
        ax.grid(True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_training_curves(path: str, history: dict) -> None:
    """Loss/MAE curves (train/train_diff_mlp.py:139-159)."""
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for key in ("train_mse", "val_mse"):
        if key in history:
            axes[0].plot(history[key], label=key)
    for key in ("train_mae", "val_mae"):
        if key in history:
            axes[1].plot(history[key], label=key)
    for ax, t in zip(axes, ("MSE", "MAE")):
        ax.set_xlabel("epoch"), ax.set_ylabel(t), ax.grid(True), ax.legend()
        ax.set_yscale("log")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_animation(
    path: str,
    states: np.ndarray,
    ref_path: Optional[np.ndarray] = None,
    planned_trajs: Optional[np.ndarray] = None,
    obstacles: Optional[np.ndarray] = None,
    obstacle_trajs: Optional[np.ndarray] = None,
    fps: int = 10,
    stride: int = 1,
    title: str = "closed loop",
) -> None:
    """Animated closed-loop artifact — the reference's primary verification
    output (FuncAnimation loops at controllers/mppi_differential_drive.py:
    291-372 and the 4-pane models/vehicle.py:45-83,247+), re-done headless.

    Per frame: driven path so far, robot footprint at the current pose, the
    tick's planned trajectory (``planned_trajs`` (n_ticks, T, ≥2)), and
    obstacles — static ``obstacles`` (n, 3) or per-tick ``obstacle_trajs``
    (n_ticks, n, 3) for moving-obstacle runs. Writes .gif via Pillow (this
    image has no ffmpeg; pass an .mp4 path on machines that do).
    """
    from matplotlib.animation import FuncAnimation, PillowWriter, FFMpegWriter

    states = np.asarray(states)
    frames = range(1, states.shape[0] + 1, stride)
    fig, ax = plt.subplots(figsize=(7, 7))

    pts = [states[:, :2]]
    if ref_path is not None:
        pts.append(np.asarray(ref_path)[:, :2])
    allp = np.concatenate(pts, axis=0)
    pad = 1.0
    xlim = (allp[:, 0].min() - pad, allp[:, 0].max() + pad)
    ylim = (allp[:, 1].min() - pad, allp[:, 1].max() + pad)

    def draw(i):
        ax.clear()
        ax.set_xlim(*xlim), ax.set_ylim(*ylim)
        ax.set_aspect("equal"), ax.grid(True, alpha=0.3)
        ax.set_title(f"{title} — tick {i}")
        if ref_path is not None:
            rp = np.asarray(ref_path)
            ax.plot(rp[:, 0], rp[:, 1], "b--", lw=1.0, zorder=3)
        obs_now = None
        if obstacle_trajs is not None:
            obs_now = np.asarray(obstacle_trajs)[min(i - 1, len(obstacle_trajs) - 1)]
        elif obstacles is not None:
            obs_now = np.asarray(obstacles)
        if obs_now is not None:
            for ox, oy, r in obs_now:
                ax.add_patch(plt.Circle((ox, oy), r, color="red", alpha=0.4, zorder=1))
        if planned_trajs is not None and i - 1 < len(planned_trajs):
            tr = np.asarray(planned_trajs)[i - 1]
            ax.plot(tr[:, 0], tr[:, 1], color="#990099", lw=1.5, zorder=4)
        ax.plot(states[:i, 0], states[:i, 1], "g-", lw=1.5, zorder=5)
        if states.shape[1] >= 3:
            draw_robot(ax, states[i - 1, 0], states[i - 1, 1], states[i - 1, 2])

    anim = FuncAnimation(fig, draw, frames=frames)
    writer = (
        FFMpegWriter(fps=fps) if path.endswith(".mp4") else PillowWriter(fps=fps)
    )
    anim.save(path, writer=writer)
    plt.close(fig)


def draw_vehicle(
    ax,
    x: float,
    y: float,
    yaw: float,
    steer: float = 0.0,
    length: float = 4.0,
    width: float = 2.0,
    wheel_base: float = 2.5,
) -> None:
    """Race-car outline: chassis + four wheels, fronts rotated by ``steer`` —
    the vehicle artist of models/vehicle.py:120-180 (chassis rectangle and
    steerable front wheels), headless."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s], [s, c]])

    def poly(cx, cy, L, W, extra_rot=0.0):
        ce, se = np.cos(extra_rot), np.sin(extra_rot)
        Re = np.array([[ce, -se], [se, ce]])
        pts = np.array(
            [[-L / 2, -W / 2], [L / 2, -W / 2], [L / 2, W / 2], [-L / 2, W / 2]]
        )
        pts = pts @ Re.T @ R.T + np.array([cx, cy])
        return plt.Polygon(pts, closed=True, fill=False, ec="k", lw=1.2, zorder=6)

    ax.add_patch(poly(x + 0.25 * length * c, y + 0.25 * length * s, length, width))
    wl, ww = length * 0.22, width * 0.14
    half = wheel_base / 2.0
    rear = np.array([x, y])
    front = rear + np.array([wheel_base * c, wheel_base * s])
    for base, extra in ((rear, 0.0), (front, steer)):
        for side in (1.0, -1.0):
            off = np.array([0.0, side * width * 0.5]) @ R.T
            wx, wy = base + off
            ax.add_patch(poly(wx, wy, wl, ww, extra_rot=extra))
    ax.plot(
        [x, x + 0.8 * length * c], [y, y + 0.8 * length * s],
        "k-", lw=0.8, alpha=0.5, zorder=6,
    )


def save_racecar_animation(
    path: str,
    states: np.ndarray,
    controls: np.ndarray,
    ref_path: Optional[np.ndarray] = None,
    fps: int = 10,
    stride: int = 1,
    steer_limits=(-0.6, 0.6),
    accel_limits=(-3.0, 3.0),
    wheel_base: float = 2.5,
    view_span: float = 15.0,
    title: str = "race car",
) -> None:
    """Four-pane race-car animation — the rich layout of models/vehicle.py
    :45-83 (main chase view, full-course minimap, steering gauge, accel
    gauge), re-done headless to a .gif (Pillow; .mp4 where ffmpeg exists).

    ``states`` is (n, ≥3) (x, y, yaw[, v]); ``controls`` (n, 2) =
    (steer, accel) per tick (mppi_race_car_obstacle.py's control order).
    """
    from matplotlib.animation import FuncAnimation, PillowWriter, FFMpegWriter
    from matplotlib.gridspec import GridSpec

    states = np.asarray(states)
    controls = np.asarray(controls)
    fig = plt.figure(figsize=(10, 7))
    gs = GridSpec(3, 3, figure=fig)
    ax_main = fig.add_subplot(gs[:, :2])
    ax_map = fig.add_subplot(gs[0, 2])
    ax_steer = fig.add_subplot(gs[1, 2])
    ax_acc = fig.add_subplot(gs[2, 2])

    def gauge(ax, value, limits, label):
        ax.clear()
        ax.barh([0], [value], color="#2c7fb8")
        ax.set_xlim(*limits)
        ax.set_yticks([])
        ax.axvline(0.0, color="k", lw=0.8)
        ax.set_title(f"{label}: {value:+.2f}", fontsize=9)
        ax.grid(True, axis="x", alpha=0.3)

    frames = range(1, states.shape[0] + 1, stride)

    def draw(i):
        k = i - 1
        x, y, yaw = states[k, 0], states[k, 1], states[k, 2]
        steer = float(controls[min(k, len(controls) - 1), 0])
        acc = float(controls[min(k, len(controls) - 1), 1])
        # main chase view centered on the vehicle
        ax_main.clear()
        ax_main.set_xlim(x - view_span, x + view_span)
        ax_main.set_ylim(y - view_span, y + view_span)
        ax_main.set_aspect("equal")
        ax_main.grid(True, alpha=0.3)
        ax_main.set_title(f"{title} — tick {i}")
        if ref_path is not None:
            rp = np.asarray(ref_path)
            ax_main.plot(rp[:, 0], rp[:, 1], "b--", lw=1.0, zorder=3)
        ax_main.plot(states[:i, 0], states[:i, 1], "g-", lw=1.5, zorder=5)
        draw_vehicle(ax_main, x, y, yaw, steer, wheel_base=wheel_base)
        # minimap: whole course + current position
        ax_map.clear()
        if ref_path is not None:
            rp = np.asarray(ref_path)
            ax_map.plot(rp[:, 0], rp[:, 1], "b--", lw=0.8)
        ax_map.plot(states[:i, 0], states[:i, 1], "g-", lw=1.0)
        ax_map.plot([x], [y], "ro", ms=4)
        ax_map.set_aspect("equal")
        ax_map.set_xticks([]), ax_map.set_yticks([])
        ax_map.set_title("course", fontsize=9)
        gauge(ax_steer, steer, steer_limits, "steer [rad]")
        gauge(ax_acc, acc, accel_limits, "accel [m/s²]")

    anim = FuncAnimation(fig, draw, frames=frames)
    writer = (
        FFMpegWriter(fps=fps) if path.endswith(".mp4") else PillowWriter(fps=fps)
    )
    anim.save(path, writer=writer)
    plt.close(fig)


__all__ = [
    "plot_trajectory",
    "draw_robot",
    "draw_vehicle",
    "plot_controls",
    "plot_training_curves",
    "save_animation",
    "save_racecar_animation",
]
