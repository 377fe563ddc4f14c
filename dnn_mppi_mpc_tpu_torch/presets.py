"""Ready-made problem configurations.

:func:`flagship` is the counterpart of ``__graft_entry__.py:25 _flagship``:
diff-drive MPPI, unicycle with Euler steps at dt 0.02, exploration
temperature (1/1e-4), SUM cost, moving-average-edge filter of window 10, a
W = 20 waypoint window over a 200-point line from (0, 0) to (20, −10).

:func:`diff_drive_mppi` and :func:`goal_seeking_mppi` are the JAX package's
diff-drive presets: waypoint tracking with the reference controller's
defaults (circle collision when obstacles are given), and goal-point MPPI
with soft, drifting obstacles (the suite's ``goal_seeking`` row).

:func:`racecar_mppi` is the counterpart of the JAX package's
``presets.racecar_mppi``: the race car (kinematic bicycle, polygon
collision) as one :class:`MPPISolver` and its params.

:func:`mppi_fleet` is the problem of the JAX suite's ``mppi_fleet`` row
(``utils/benchsuite.py:223-258``): B diff-drive controllers, each tracking
its own line, through the fleet tick.

:func:`dnn_mppi` and :func:`dnn_nmpc` are the JAX package's learned-residual
presets: MPPI and SQP-RTI NMPC over the unicycle plus a learned residual
(``models/learned.py``), with the residual function the caller binds.

:func:`diff_drive_nmpc`, :func:`racecar_nmpc` and :func:`four_wheel_nmpc`
are the JAX package's NMPC presets (SQP-RTI on the unicycle with obstacle
h-rows, the kinematic or dynamic bicycle, the four-wheel torque model with
IRK). :func:`nmpc_fleet` is the problem of the JAX suite's ``nmpc_fleet``
row (``utils/benchsuite.py:310-346``): 128 diff-drive NMPC problems, each
with its own goal and obstacle, solved as one fleet.

Each runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .config import (
    CostAccumulation,
    MPPIConfig,
    MPPIParams,
    SmoothingFilter,
    SQPConfig,
    Temperature,
    params_from_numpy,
)
from .models.dynamics import (
    BicycleParams,
    DynamicBicycleParams,
    dynamic_bicycle,
    four_wheel_torque,
    kinematic_bicycle,
    residual_dynamics,
    unicycle,
)
from .models.integrators import euler_step
from .paths.generators import line
from .solvers.mppi import (
    MPPISolver,
    MPPIState,
    make_cuda_bicycle_rollout,
    make_cuda_bicycle_tick,
    make_fleet_fused_mppi_step,
    _reject_unported,
    make_cuda_diffdrive_tick,
    make_tracking_costs,
    resolve_device,
)
from .solvers.sqp import NMPCSolver, NMPCState, OCPParams, circle_obstacle_h, ocp_params_from_numpy


def flagship(num_samples: int = 10240, horizon: int = 50, device="cuda"):
    """(cfg, params, step_fn, stage_cost, terminal_cost) of the flagship
    diff-drive tracking problem, with params on ``device``."""
    device = resolve_device(device)
    dt = 0.02  # 50 Hz control budget
    cfg = MPPIConfig(
        num_samples=num_samples,
        horizon=horizon,
        dim_x=3,
        dim_u=2,
        dt=dt,
        lam=1.0,
        alpha=0.2,
        exploration=0.0001,
        temperature=Temperature.EXPLORATION,
        accumulation=CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE,
        filter_window=10,
        waypoint_search_len=20,
    )

    n_pts = 200
    # built in float64 numpy and rounded once, like the JAX preset
    path = np.stack(
        [
            np.linspace(0.0, 20.0, n_pts),
            np.linspace(0.0, -10.0, n_pts),
            np.full(n_pts, np.arctan2(-10.0, 20.0)),
        ],
        axis=1,
    )
    params = params_from_numpy(
        sigma=[[0.1, 0.0], [0.0, 0.01]],
        stage_weight=[5.0, 5.0, 10.0],
        terminal_weight=[5.0, 5.0, 10.0],
        u_min=[-5.0, -3.14],
        u_max=[5.0, 3.14],
        ref_path=path,
        device=device,
    )

    def step_fn(x, u):
        return euler_step(unicycle, x, u, dt)

    stage, terminal = make_tracking_costs(cfg)
    return cfg, params, step_fn, stage, terminal


def _lane_rounded_samples(num_samples: int) -> int:
    """K rounded up to a multiple of 128: the hash noise stream lays the
    samples out as (K/128, 128) rows, as the JAX kernels' lanes do."""
    return -(-num_samples // 128) * 128


def _f32(a, device) -> Optional[torch.Tensor]:
    """``a`` (a tensor, array or list; or None) as float32 on ``device``."""
    if a is None or isinstance(a, torch.Tensor):
        return None if a is None else a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


def diff_drive_mppi(
    ref_path,
    num_samples: int = 100,
    horizon: int = 10,
    dt: float = 0.1,
    obstacles=None,
    use_kernel: bool = False,
    fused_tick: bool = False,
    iso_xy: Optional[bool] = None,
    device="cuda",
    **overrides,
) -> tuple[MPPISolver, MPPIParams]:
    """Diff-drive waypoint-tracking MPPI, the JAX preset.

    The reference controller's defaults (controllers/mppi_differential_drive.py:399-410):
    dt = 0.1, K = 100, T = 10, exploration 1e-4, λ = 1, α = 0.2,
    Σ = diag(0.1, 0.01), weights (5, 5, 10), v ∈ ±5, ω ∈ ±3.14, the
    moving-average-edge filter of window min(10, T), W = 20; with
    ``obstacles`` (n, 3) the circle-collision variant (its own main runs
    K = 500, T = 20). ``fused_tick`` binds the fused tick, ``use_kernel``
    (JAX's ``use_pallas``) the split rollout; either rounds K up to a
    multiple of 128 (``solver.cfg.num_samples`` is the K in use).
    ``iso_xy`` None enables the symmetric-weight specialization exactly
    when the x and y weights are equal, which the defaults are.
    ``overrides`` replace any :class:`MPPIConfig` field. Params live on
    ``device``."""
    device = resolve_device(device)
    if use_kernel or fused_tick:
        num_samples = _lane_rounded_samples(num_samples)
    kw = dict(
        num_samples=num_samples,
        horizon=horizon,
        dim_x=3,
        dim_u=2,
        dt=dt,
        lam=1.0,
        alpha=0.2,
        exploration=0.0001,
        temperature=Temperature.EXPLORATION,
        accumulation=CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE,
        filter_window=min(10, horizon),
        waypoint_search_len=20,
        use_kernel=use_kernel,
    )
    kw.update(overrides)
    cfg = MPPIConfig(**kw)
    weights = [5.0, 5.0, 10.0]
    params = MPPIParams(
        sigma=_f32([[0.1, 0.0], [0.0, 0.01]], device),
        stage_weight=_f32(weights, device),
        terminal_weight=_f32(weights, device),
        u_min=_f32([-5.0, -3.14], device),
        u_max=_f32([5.0, 3.14], device),
        ref_path=_f32(ref_path, device),
        obstacles=_f32(obstacles, device),
    )

    def step(x, u):
        return euler_step(unicycle, x, u, dt)

    stage, terminal = make_tracking_costs(
        cfg, collision="none" if obstacles is None else "circle"
    )
    if iso_xy is None:
        iso_xy = weights[0] == weights[1]
    # the kernels' collision stays "circle": params.obstacles None is no obstacle
    solver = MPPISolver(cfg, step, stage, terminal, use_kernel=use_kernel,
                        fused_tick=fused_tick, iso_xy=iso_xy, device=device)
    return solver, params


def goal_seeking_mppi(
    goal,
    num_samples: int = 1500,
    horizon: int = 50,
    dt: float = 0.05,
    obstacles=None,
    obstacle_velocities=None,
    fused_tick: bool = False,
    gaussian: str = "hash",
    device="cuda",
    **overrides,
) -> tuple[MPPISolver, MPPIParams]:
    """Goal-point MPPI with soft obstacle costs, the JAX preset.

    The configuration of the reference's test/test_mppi_diff_obs.py:631-667:
    K = 1 500, T = 50, dt = 0.05, λ temperature (λ = 1), α = 1, Q = diag(30,
    5, 9), the action cost diag(0.1, 0.1) on the clamped action
    (``control_weight``), u ∈ ±2, Σ = diag(0.5, 0.3), the exponential soft
    obstacle cost (safety distance 2.0, weight 100) with
    ``obstacle_velocities`` drifting the obstacles during the rollout, the
    Savitzky-Golay filter (window min(51, T), order 3). The path is the one
    goal pose (W = 1), so every tick reports status 1, end of path.
    ``fused_tick`` binds the fused tick (soft collision, the filter in its
    epilogue) and rounds K up to a multiple of 128 (1 500 → 1 536).

    ``gaussian``: the JAX default ``"popcount"`` is a TPU hardware
    generator; the port draws from the hash stream, so its default is
    ``"hash"`` and any other value raises ``ValueError``. ``overrides``
    replace any :class:`MPPIConfig` field. Params live on ``device``."""
    _reject_unported(gaussian=gaussian)
    device = resolve_device(device)
    if fused_tick:
        num_samples = _lane_rounded_samples(num_samples)
    kw = dict(
        num_samples=num_samples,
        horizon=horizon,
        dim_x=3,
        dim_u=2,
        dt=dt,
        lam=1.0,
        alpha=1.0,
        exploration=0.0,
        temperature=Temperature.LAMBDA,
        filter=SmoothingFilter.SAVGOL,
        filter_window=min(51, horizon),
        savgol_polyorder=3,
        waypoint_search_len=1,
    )
    kw.update(overrides)
    cfg = MPPIConfig(**kw)
    weights = [30.0, 5.0, 9.0]
    params = MPPIParams(
        sigma=_f32([[0.5, 0.0], [0.0, 0.3]], device),
        stage_weight=_f32(weights, device),
        terminal_weight=_f32(weights, device),
        control_weight=_f32([0.1, 0.1], device),
        u_min=_f32([-2.0, -2.0], device),
        u_max=_f32([2.0, 2.0], device),
        ref_path=_f32(goal, device)[None, :],
        obstacles=_f32(obstacles, device),
        obstacle_velocities=_f32(obstacle_velocities, device),
    )

    def step(x, u):
        return euler_step(unicycle, x, u, dt)

    soft = dict(soft_safety_distance=2.0, soft_weight=100.0)
    stage, terminal = make_tracking_costs(
        cfg, collision="none" if obstacles is None else "soft", **soft
    )
    # collision="soft" is no obstacle when params.obstacles is None
    tick_fn = (make_cuda_diffdrive_tick(cfg, gaussian=gaussian, collision="soft",
                                        fuse_epilogue=True, **soft)
               if fused_tick else None)
    solver = MPPISolver(cfg, step, stage, terminal, tick_fn=tick_fn, gaussian=gaussian,
                        device=device)
    return solver, params


def racecar_mppi(
    ref_path,
    num_samples: int = 100,
    horizon: int = 10,
    dt: float = 0.05,
    wheel_base: float = 2.5,
    obstacles=None,
    use_kernel: bool = False,
    fused_tick: bool = False,
    gaussian: str = "hash",
    iso_xy: Optional[bool] = None,
    sincos: str = "native",
    device="cuda",
    **overrides,
) -> tuple[MPPISolver, MPPIParams]:
    """Race-car MPPI (kinematic bicycle) with polygon collision when
    ``obstacles`` (n, 3) are given.

    The JAX preset's defaults: dt = 0.05, L = 2.5, λ = 50, α = 1,
    exploration 0.01, Σ = diag(0.5, 0.1), 4-term weights (50, 50, 1, 20),
    steer ±0.523, accel ±2.0, a 4 × 3 m vehicle with a 1.5 safety margin,
    SUM cost, the padded moving-average filter, W = 200. ``fused_tick``
    binds the fused bicycle tick, ``use_kernel`` the split bicycle rollout;
    either rounds K up to a multiple of 128. ``iso_xy`` None enables the
    symmetric-weight specialization exactly when the weights are symmetric.
    The TPU-only ``gaussian`` and ``sincos`` modes raise ``ValueError``, as
    in :class:`MPPISolver`.
    ``solver.dynamics_step`` is the Euler bicycle step, the plant of a
    closed loop. ``ref_path`` and ``obstacles`` may be tensors or arrays;
    the params live on ``device``."""
    device = resolve_device(device)
    if fused_tick or use_kernel:
        num_samples = _lane_rounded_samples(num_samples)
    kw = dict(
        num_samples=num_samples,
        horizon=horizon,
        dim_x=4,
        dim_u=2,
        dt=dt,
        lam=50.0,
        alpha=1.0,
        exploration=0.01,
        temperature=Temperature.LAMBDA,
        accumulation=CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_PADDED,
        filter_window=min(10, horizon),
        waypoint_search_len=200,
    )
    kw.update(overrides)
    cfg = MPPIConfig(**kw)
    weights = [50.0, 50.0, 1.0, 20.0]
    params = MPPIParams(
        sigma=_f32([[0.5, 0.0], [0.0, 0.1]], device),
        stage_weight=_f32(weights, device),
        terminal_weight=_f32(weights, device),
        u_min=_f32([-0.523, -2.0], device),
        u_max=_f32([0.523, 2.0], device),
        ref_path=_f32(ref_path, device),
        obstacles=_f32(obstacles, device),
    )
    if iso_xy is None:
        iso_xy = weights[0] == weights[1]
    bp = BicycleParams(wheel_base=wheel_base)

    def step(x, u):
        return euler_step(lambda s, a: kinematic_bicycle(s, a, bp), x, u, dt)

    stage, terminal = make_tracking_costs(
        cfg,
        wrap_yaw=True,
        collision="none" if obstacles is None else "polygon",
        vehicle_length=4.0,
        vehicle_width=3.0,
        safety_margin_rate=1.5,
    )
    rollout_fn = tick_fn = None
    if fused_tick:
        tick_fn = make_cuda_bicycle_tick(
            cfg, wheel_base=wheel_base, gaussian=gaussian, iso_xy=iso_xy, sincos=sincos
        )
    elif use_kernel:
        rollout_fn = make_cuda_bicycle_rollout(cfg, wheel_base=wheel_base)
    solver = MPPISolver(cfg, step, stage, terminal, rollout_fn=rollout_fn, tick_fn=tick_fn,
                        gaussian=gaussian, sincos=sincos, device=device)
    return solver, params


def mppi_fleet(B: int = 16, num_samples: int = 1024, horizon: int = 50, device="cuda"):
    """(fleet step, params, initial states, plant) of the JAX suite's
    ``mppi_fleet`` row: B unicycles at dt 0.05 with W = 20, Σ = diag(0.2,
    0.1), weights (8, 8, 2), u ∈ [(−3, −3.14), (3, 3.14)], the other
    :class:`MPPIConfig` fields at their defaults; member b tracks an
    80-point line from the origin to goal b of
    ``np.random.default_rng(0).uniform(-4, 4, (B, 2))`` and starts from the
    key ``PRNGKey(b)`` (raw words [0, b]). The step is
    :func:`make_fleet_fused_mppi_step`; ``step.cfg`` is its config. The plant
    is the Euler unicycle step, which takes (B, 3) states and (B, 2)
    controls."""
    device = resolve_device(device)
    dt = 0.05
    cfg = MPPIConfig(num_samples=num_samples, horizon=horizon, dim_x=3, dim_u=2, dt=dt,
                     waypoint_search_len=20)
    goals = np.random.default_rng(0).uniform(-4, 4, (B, 2)).astype(np.float32)
    paths = torch.stack([line([0.0, 0.0], g, num_points=80, device="cpu") for g in goals])
    params = params_from_numpy(
        sigma=[[0.2, 0.0], [0.0, 0.1]],
        stage_weight=[8.0, 8.0, 2.0],
        terminal_weight=[8.0, 8.0, 2.0],
        u_min=[-3.0, -3.14],
        u_max=[3.0, 3.14],
        ref_path=paths,
        device=device,
    )

    def plant(x, u):
        return euler_step(unicycle, x, u, dt)

    step = make_fleet_fused_mppi_step(cfg, plant, device=device)
    states = MPPIState.fleet(cfg, [[0, b] for b in range(B)], device=device)
    return step, params, states, plant


def _ls_params(Q, R, Qe, goal, N, lbx, ubx, lbu, ubu, p=None, device="cuda") -> OCPParams:
    """LINEAR_LS params: yref = (goal, 0) at every stage, yref_e = goal."""
    goal = np.asarray(goal, np.float32)
    nu = np.asarray(R).shape[0]
    yref = np.concatenate([goal, np.zeros(nu, np.float32)])[None, :].repeat(N, axis=0)
    return ocp_params_from_numpy(Q=Q, R=R, Qe=Qe, yref=yref, yref_e=goal, lbx=lbx, ubx=ubx,
                                 lbu=lbu, ubu=ubu, p=p, device=device)


def diff_drive_nmpc(goal, N: int = 30, dt: float = 0.1, obstacles=None, sqp_iters: int = 2,
                    device="cuda", **overrides) -> tuple[NMPCSolver, OCPParams]:
    """Diff-drive NMPC with circular obstacle h-constraints: LINEAR_LS with
    Q = Qe = diag(10, 10, 0.1), R = diag(0.5, 0.05), ERK(4, 3), x ∈ ±10,
    u ∈ ±1, and one (x−ox)² + (y−oy)² ≥ r² row per row (ox, oy,
    radius + safe distance) of ``obstacles``. ``overrides`` are
    :class:`SQPConfig` fields (``qp_backend="kernel"`` for the fused QP
    kernel)."""
    device = resolve_device(device)
    n_obs = 0 if obstacles is None else np.asarray(obstacles).shape[0]
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=sqp_iters,
                    qp_iters=overrides.pop("qp_iters", 12), n_h_constraints=n_obs, **overrides)
    solver = NMPCSolver(cfg, unicycle, h_fn=None if obstacles is None else circle_obstacle_h,
                        device=device)
    params = _ls_params(Q=np.diag([10.0, 10.0, 0.1]), R=np.diag([0.5, 0.05]),
                        Qe=np.diag([10.0, 10.0, 0.1]), goal=goal, N=N, lbx=np.full(3, -10.0),
                        ubx=np.full(3, 10.0), lbu=[-1.0, -1.0], ubu=[1.0, 1.0], p=obstacles,
                        device=device)
    return solver, params


def racecar_nmpc(goal, N: int = 50, dt: float = 0.05, wheel_base: float = 0.325,
                 dynamic_model: bool = False, sqp_iters: int = 2, device="cuda",
                 **overrides) -> tuple[NMPCSolver, OCPParams]:
    """Race-car NMPC: the kinematic bicycle (L = 0.325, N = 50, controls
    (δ, a) in ±(0.4, 2)) or the dynamic single-track model with tire slip
    (controls (a, δ) in ±(2, 0.4), accel first)."""
    device = resolve_device(device)
    cfg = SQPConfig(N=N, dim_x=4, dim_u=2, dt=dt, sqp_iters=sqp_iters,
                    qp_iters=overrides.pop("qp_iters", 12), **overrides)
    if dynamic_model:
        dbp = DynamicBicycleParams.default()

        def dyn(x, u):
            return dynamic_bicycle(x, u, dbp)

        lbu, ubu = [-2.0, -0.4], [2.0, 0.4]
    else:
        bp = BicycleParams(wheel_base=wheel_base)

        def dyn(x, u):
            return kinematic_bicycle(x, u, bp)

        lbu, ubu = [-0.4, -2.0], [0.4, 2.0]
    solver = NMPCSolver(cfg, dyn, device=device)
    params = _ls_params(Q=np.diag([20.0, 20.0, 0.5, 1.0]), R=np.diag([0.5, 0.5]),
                        Qe=np.diag([20.0, 20.0, 0.5, 1.0]), goal=goal, N=N,
                        lbx=[-10.0, -10.0, -10.0, -3.0], ubx=[10.0, 10.0, 10.0, 3.0],
                        lbu=lbu, ubu=ubu, device=device)
    return solver, params


def four_wheel_nmpc(goal, N: int = 20, dt: float = 0.1, sqp_iters: int = 2, device="cuda",
                    **overrides) -> tuple[NMPCSolver, OCPParams]:
    """Four-wheel torque-input NMPC, with the implicit Gauss-Legendre
    integrator by default (``integrator="erk"`` for the explicit one):
    Q = Qe = diag(20, 20, 1, 1, 1), R = 0.1·I, x ∈ ±20, torques ∈ ±5."""
    device = resolve_device(device)
    cfg = SQPConfig(N=N, dim_x=5, dim_u=4, dt=dt, sqp_iters=sqp_iters,
                    integrator=overrides.pop("integrator", "irk"),
                    qp_iters=overrides.pop("qp_iters", 12), **overrides)
    solver = NMPCSolver(cfg, four_wheel_torque, device=device)
    params = _ls_params(Q=np.diag([20.0, 20.0, 1.0, 1.0, 1.0]), R=np.eye(4) * 0.1,
                        Qe=np.diag([20.0, 20.0, 1.0, 1.0, 1.0]), goal=goal, N=N,
                        lbx=np.full(5, -20.0), ubx=np.full(5, 20.0), lbu=np.full(4, -5.0),
                        ubu=np.full(4, 5.0), device=device)
    return solver, params


def nmpc_fleet(B: int = 128, N: int = 30, qp_backend: str = "kernel", device="cuda",
               **overrides):
    """(solver, params, states, x0s) of the JAX suite's ``nmpc_fleet`` row:
    :func:`diff_drive_nmpc` with its defaults (``sqp_iters=2``) at horizon N,
    other :class:`SQPConfig` fields from ``overrides``;
    member b drives to goal b = (3 cos θ_b, 3 sin θ_b, θ_b) and avoids one
    obstacle of radius 0.25 at 0.55 of the way, with θ, then x0s ∈ ±0.3,
    drawn from ``np.random.default_rng(0)``. Every params leaf carries the
    leading member axis, as the suite's ``vmap`` gives them; step the fleet
    with ``solver.batched_solve()``."""
    device = resolve_device(device)
    solver, base = diff_drive_nmpc(np.zeros(3), N=N, obstacles=[[1.0, 0.0, 0.3]],
                                   qp_backend=qp_backend, device=device, **overrides)
    rng = np.random.default_rng(0)
    ang = rng.uniform(0, 2 * np.pi, B)
    goals = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang), ang], axis=1)
    x0s = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    # in float64 and rounded once, as the suite builds them
    obs = np.concatenate([0.55 * goals[:, :2], np.full((B, 1), 0.25)],
                         axis=1)[:, None, :].astype(np.float32)
    goals = goals.astype(np.float32)
    yref = np.concatenate([goals, np.zeros((B, 2), np.float32)], axis=1)[:, None, :]

    def member_axis(t):
        return t.expand(B, *t.shape).contiguous()

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    params = OCPParams(Q=member_axis(base.Q), R=member_axis(base.R), Qe=member_axis(base.Qe),
                       yref=on_device(yref.repeat(N, axis=1)), yref_e=on_device(goals),
                       lbx=member_axis(base.lbx), ubx=member_axis(base.ubx),
                       lbu=member_axis(base.lbu), ubu=member_axis(base.ubu), p=on_device(obs))
    x0s = torch.from_numpy(x0s).to(device)
    return solver, params, NMPCState.init(solver.cfg, x0s, device=device), x0s


def dnn_mppi(ref_path, learned_fn: Callable[[torch.Tensor], torch.Tensor],
             num_samples: int = 1024, horizon: int = 25, dt: float = 0.05,
             residual_level: str = "step", device="cuda", **overrides
             ) -> tuple[MPPISolver, MPPIParams]:
    """DNN-MPPI: sampling MPPI over the unicycle plus a learned residual.
    ``learned_fn`` maps concat(x, u) features to a residual
    (``models.learned.make_residual_fn`` or ``residual_from_train_state``
    bind an MLP or a conv ResNet-18/50; ``ops.cuda.make_resnet_chain_fn``
    gives the chain kernel). ``residual_level``: ``'step'`` corrects the
    discrete transition, x⁺ = euler(x, u) + NN(x, u) (what the data
    pipeline regresses); ``'rate'`` corrects ẋ, then Euler. The residual is
    cast to the features' dtype. λ = 1, α = 0.2, exploration temperature
    1/1e-4, the moving-average-edge filter of window min(10, T), W = 20,
    Σ = diag(0.2, 0.1), weights (8, 8, 2), u ∈ [(−3, −3.14), (3, 3.14)];
    the scan path (each rollout step calls ``learned_fn`` on (K, 5)). For
    the fused MLP kernel, bind ``ops.cuda.make_fused_residual_step`` as the
    dynamics step of an :class:`MPPISolver` on this config."""
    device = resolve_device(device)

    def learned(feats):
        return learned_fn(feats).to(feats.dtype)

    if residual_level == "rate":
        dyn = residual_dynamics(unicycle, learned)

        def step(x, u):
            return euler_step(dyn, x, u, dt)
    elif residual_level == "step":
        def step(x, u):
            return euler_step(unicycle, x, u, dt) + learned(torch.cat([x, u], dim=-1))
    else:
        raise ValueError(f"residual_level must be 'step' or 'rate': {residual_level!r}")

    kw = dict(num_samples=num_samples, horizon=horizon, dim_x=3, dim_u=2, dt=dt, lam=1.0,
              alpha=0.2, exploration=0.0001, temperature=Temperature.EXPLORATION,
              filter=SmoothingFilter.MOVING_AVERAGE_EDGE, filter_window=min(10, horizon),
              waypoint_search_len=20)
    kw.update(overrides)
    cfg = MPPIConfig(**kw)

    weights = [8.0, 8.0, 2.0]
    params = MPPIParams(sigma=_f32([[0.2, 0.0], [0.0, 0.1]], device),
                        stage_weight=_f32(weights, device), terminal_weight=_f32(weights, device),
                        u_min=_f32([-3.0, -3.14], device), u_max=_f32([3.0, 3.14], device),
                        ref_path=_f32(ref_path, device))
    stage, terminal = make_tracking_costs(cfg)
    return MPPISolver(cfg, step, stage, terminal, device=device), params


def dnn_nmpc(goal, learned_fn: Callable[[torch.Tensor], torch.Tensor], N: int = 10,
             dt: float = 0.1, obstacles=None, sqp_iters: int = 2, device="cuda",
             **overrides) -> tuple[NMPCSolver, OCPParams]:
    """DNN-NMPC: the unicycle plus a learned rate residual through the SQP
    engine (f = unicycle + NN(x, u), ERK(4, 3)); the linearization
    differentiates through ``learned_fn`` with ``vmap(jacrev)``, so bind the
    plain net (``models.learned.make_residual_fn``), not a kernel.
    LINEAR_LS with Q = Qe = diag(10, 10, 0.5), R = diag(0.2, 0.05), x ∈ ±20,
    u ∈ ±2, one circle h-row per row of ``obstacles``. ``overrides`` are
    :class:`SQPConfig` fields (``qp_backend="kernel"`` for the QP kernel)."""
    device = resolve_device(device)
    n_obs = 0 if obstacles is None else np.asarray(obstacles).shape[0]
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=sqp_iters,
                    qp_iters=overrides.pop("qp_iters", 12), n_h_constraints=n_obs, **overrides)
    solver = NMPCSolver(cfg, residual_dynamics(unicycle, learned_fn),
                        h_fn=None if obstacles is None else circle_obstacle_h, device=device)
    params = _ls_params(Q=np.diag([10.0, 10.0, 0.5]), R=np.diag([0.2, 0.05]),
                        Qe=np.diag([10.0, 10.0, 0.5]), goal=goal, N=N, lbx=np.full(3, -20.0),
                        ubx=np.full(3, 20.0), lbu=[-2.0, -2.0], ubu=[2.0, 2.0], p=obstacles,
                        device=device)
    return solver, params


__all__ = ["diff_drive_mppi", "diff_drive_nmpc", "dnn_mppi", "dnn_nmpc", "flagship",
           "four_wheel_nmpc", "goal_seeking_mppi", "mppi_fleet", "nmpc_fleet", "racecar_mppi",
           "racecar_nmpc"]
