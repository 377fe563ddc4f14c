"""Typed configuration for the PyTorch/CUDA MPPI and NMPC engines.

Counterpart of ``dnn_mppi_mpc_tpu/config.py``. The split is the same:

* **static config** — frozen, hashable dataclasses that fix shapes and code
  paths (sample count K, horizon T, temperature convention, filter kind);
* **runtime params** — :class:`MPPIParams`, a dataclass of tensors that can
  change between ticks without rebuilding anything.

The enums and :class:`MPPIConfig` carry the JAX package's fields, with
``use_pallas`` renamed ``use_kernel``; the fields of the per-rollout
waypoint carry (``waypoint_persist``, ``carry_window_len``) come with that
mode. :class:`SQPConfig` is the NMPC engine's static configuration.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch


class Temperature(enum.Enum):
    """Softmax inverse-temperature convention (weight ∝ exp(-(S-ρ)/λ) for
    ``LAMBDA``, exp(-(S-ρ)/exploration) for ``EXPLORATION``)."""

    LAMBDA = "lambda"
    EXPLORATION = "exploration"


class CostAccumulation(enum.Enum):
    """``SUM`` accumulates every stage cost; ``LAST`` keeps only the last
    stage cost (plus terminal), the reference's ``S[k] =`` overwrite quirk."""

    SUM = "sum"
    LAST = "last"


class SmoothingFilter(enum.Enum):
    """Smoothing filter applied to the weighted-noise update."""

    MOVING_AVERAGE_EDGE = "ma_edge"
    MOVING_AVERAGE_PADDED = "ma_padded"
    SAVGOL = "savgol"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Static MPPI solver configuration (fields as in the JAX package).

    ``waypoint_carry`` and ``waypoint_persist`` are checked where a step or a
    binder uses them (``solvers/mppi.py``), as in JAX: an unknown mode, or
    the per-rollout carry on a path without it, raises ``ValueError``.
    """

    num_samples: int  # K
    horizon: int  # T
    dim_x: int
    dim_u: int
    dt: float
    lam: float = 1.0  # λ, information-theoretic temperature
    alpha: float = 0.2  # γ = λ(1-α)
    exploration: float = 0.0001  # pure-noise sample fraction AND alt temperature
    temperature: Temperature = Temperature.LAMBDA
    accumulation: CostAccumulation = CostAccumulation.SUM
    filter: SmoothingFilter = SmoothingFilter.MOVING_AVERAGE_EDGE
    filter_window: int = 10
    savgol_polyorder: int = 3
    waypoint_search_len: int = 20  # W
    num_rollout_repeats: int = 1  # M (scan path only)
    rollout_var_cost: float = 0.0
    rollout_var_discount: float = 0.95
    use_kernel: bool = False  # split CUDA rollout kernel on the scan path
    waypoint_carry: str = "tick"  # nearest-waypoint window anchoring:
    # * "tick"    — one window per control tick: every rollout state queries
    #   the same [start, start + W) window
    # * "rollout" — each rollout carries its own monotone window start
    #   through the rollout (idx_{t+1} = argmin over [idx_t, idx_t + W)), the
    #   pure form of the reference's stateful in-cost lookup: the window
    #   creeps ahead of the robot during the solve, which is what produces
    #   the reference demo's forward progress (the tracking cost has no
    #   progress term). The scan path, the diff-drive fused tick and the
    #   generic tick implement it; the other kernels raise.
    waypoint_persist: str = "none"  # cross-tick carry in "rollout" mode:
    # "none" keeps the tick-level window advance; "max" carries the furthest
    # rollout-carried index into the next tick's window start (the
    # reference's prev_way_point_idx keeping the last sample's final index).
    # The end-of-path status still judges the tick-level index.
    carry_window_len: Optional[int] = None  # "rollout" mode on the fused
    # kernels: the rows gathered from the tick anchor, which must cover the
    # furthest index a rollout can reach (the per-step search span stays
    # waypoint_search_len). None → waypoint_search_len + horizon (at most
    # about one waypoint a step); too few rows cut the lookahead short.
    time_varying_dynamics: bool = False  # dynamics_step(x, u, t) (scan path)
    compute_optimal_traj: bool = False  # (T, nx) diagnostic rollout of u_new

    @property
    def gamma(self) -> float:
        return self.lam * (1.0 - self.alpha)

    @property
    def inv_temperature(self) -> float:
        if self.temperature == Temperature.LAMBDA:
            return 1.0 / self.lam
        return 1.0 / self.exploration


@dataclasses.dataclass
class MPPIParams:
    """Runtime MPPI parameters: a dataclass of float32 tensors.

    ``sigma`` is Σ (dim_u × dim_u); ``u_min``/``u_max`` clamp the controls
    inside the rollout; ``stage_weight``/``terminal_weight`` are diagonal
    tracking weights; ``ref_path`` is the (P, d) waypoint table;
    ``obstacles`` (n, 3) are circles (x, y, r) and ``obstacle_velocities``
    (n, 2) make them drift during the rollout; ``model_params`` is an opaque
    object for a user's dynamics (the solvers carry it and never read it);
    ``control_weight`` (dim_u,) adds Σⱼ rⱼ·vⱼ² of the clamped action to each
    stage cost.
    """

    sigma: torch.Tensor
    stage_weight: torch.Tensor
    terminal_weight: torch.Tensor
    u_min: torch.Tensor
    u_max: torch.Tensor
    ref_path: torch.Tensor
    obstacles: Optional[torch.Tensor] = None
    obstacle_velocities: Optional[torch.Tensor] = None
    model_params: Optional[object] = None
    control_weight: Optional[torch.Tensor] = None

    def to(self, device) -> "MPPIParams":
        """A copy with every tensor moved to ``device`` (``model_params``'
        tensor leaves too; its other leaves as they are)."""
        return MPPIParams(**{
            f.name: _map_leaves(getattr(self, f.name),
                                lambda a: a.to(device) if isinstance(a, torch.Tensor) else a)
            for f in dataclasses.fields(self)
        })


def _map_leaves(tree, fn):
    """``fn`` over the leaves of nested dicts, lists and tuples (named tuples
    keep their type); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _map_leaves(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        leaves = [_map_leaves(v, fn) for v in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else type(tree)(leaves)
    return fn(tree)


QP_BACKENDS = ("torch", "kernel")


@dataclasses.dataclass(frozen=True)
class SQPConfig:
    """Static configuration of the SQP-RTI NMPC engine (fields and defaults
    as in the JAX package).

    ``qp_backend`` is ``"torch"`` (``solvers/qp.barrier_qp_solve``, the
    counterpart of the JAX ``"xla"``) or ``"kernel"`` (the fused
    barrier-Riccati CUDA kernel, the counterpart of ``"pallas"``; on CPU
    tensors its plain version). The JAX names raise ``ValueError``.
    ``parallel_riccati`` (default True, as in JAX) has the ``"torch"``
    backend solve each Newton step's LQR by the associative-scan Riccati
    (``solvers/qp.riccati_solve_parallel``) instead of the serial sweep; the
    ``"kernel"`` backend does not read it.
    """

    N: int  # shooting intervals
    dim_x: int
    dim_u: int
    dt: float
    num_rk4_steps: int = 3  # ERK substeps per interval
    integrator: str = "erk"  # 'erk' (RK4 substeps) or 'irk' (Gauss-Legendre + Newton)
    irk_newton_iters: int = 3  # Newton steps on the IRK stage equations
    sqp_iters: int = 1  # 1 == SQP-RTI; >1 == converged SQP
    qp_iters: int = 12  # interior-point iterations per QP solve
    n_h_constraints: int = 0  # nonlinear inequality constraints (obstacles)
    soft_h: bool = False  # soften h-constraints with slack penalties
    slack_weight_l2: float = 1.0e4  # L2 slack penalty (the barrier's h stiffness)
    slack_weight_l1: float = 1.0e3  # L1 slack penalty (the barrier's h slope)
    ip_mu0: float = 1.0e-1  # initial interior-point barrier weight
    ip_kappa: float = 0.25  # barrier decrease factor per iteration
    ip_delta: float = 1.0e-3  # relaxed-barrier threshold δ (the QP's accuracy floor)
    line_search: str = "merit"  # 'merit' (ℓ1 merit over six step sizes) or 'full'
    h_terminal: bool = True  # h-constraints at the terminal node too
    parallel_riccati: bool = True  # the torch backend's LQR by associative scans
    qp_backend: str = "torch"  # 'torch' or 'kernel'

    def __post_init__(self):
        if self.qp_backend in ("xla", "pallas"):
            port = "torch" if self.qp_backend == "xla" else "kernel"
            raise ValueError(
                f"qp_backend={self.qp_backend!r} is the JAX package's name: this port's "
                f"backends are 'torch' and 'kernel' (use {port!r})"
            )
        if self.qp_backend not in QP_BACKENDS:
            raise ValueError(f"qp_backend must be one of {QP_BACKENDS}, got {self.qp_backend!r}")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine without
    one raises here, with the way out, instead of deep in a kernel call.
    ``"cuda"`` without an index becomes the current card (``cuda:0``), the
    device its tensors report, so a step's device checks accept them."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"this runs on the card by default (device={str(device)!r}) and no CUDA "
            "device is available: pass device='cpu' to run the plain versions on the CPU"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def params_from_numpy(
    sigma,
    stage_weight,
    terminal_weight,
    u_min,
    u_max,
    ref_path,
    obstacles=None,
    obstacle_velocities=None,
    model_params=None,
    control_weight=None,
    *,
    device="cuda",
) -> MPPIParams:
    """Build :class:`MPPIParams` on ``device`` from the JAX package's
    ``MPPIParams`` leaves given as numpy arrays (in their field order). A
    fleet's per-member leaves keep their leading member axis: ``ref_path``
    (B, P, d), ``obstacles`` (B, n, 3), ``obstacle_velocities`` (B, n, 2).

    ``model_params`` is carried through as JAX's ``unify_float_dtype`` does:
    its numpy leaves (through dicts, lists and tuples) go to ``device``,
    floating ones as float32, and its other leaves (Python scalars, any
    object) pass as they are."""
    device = resolve_device(device)

    def f32(a):
        if a is None:
            return None
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def leaf(a):
        if not isinstance(a, np.ndarray):
            return a
        return f32(a) if np.issubdtype(a.dtype, np.floating) else torch.as_tensor(a).to(device)

    return MPPIParams(
        sigma=f32(sigma),
        stage_weight=f32(stage_weight),
        terminal_weight=f32(terminal_weight),
        u_min=f32(u_min),
        u_max=f32(u_max),
        ref_path=f32(ref_path),
        obstacles=f32(obstacles),
        obstacle_velocities=f32(obstacle_velocities),
        model_params=_map_leaves(model_params, leaf),
        control_weight=f32(control_weight),
    )


__all__ = [
    "Temperature",
    "CostAccumulation",
    "SmoothingFilter",
    "MPPIConfig",
    "MPPIParams",
    "QP_BACKENDS",
    "SQPConfig",
    "params_from_numpy",
    "resolve_device",
]
