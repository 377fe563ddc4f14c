"""Cross-entropy method (CEM) trajectory optimizer — counterpart of
``dnn_mppi_mpc_tpu/solvers/cem.py``.

The reference declares this solver but never implements it
(controllers/mppi_differential_drive.py:251-252, ``_cross_entropy: pass``).
A tick samples K control sequences from a per-step Gaussian, rolls them out
and scores them with the MPPI engine's stage and terminal costs, keeps the
elite fraction, refits the mean and (diagonal) spread with momentum and a
floor, and iterates; then the distribution shifts one step, its last std
refilled with ``init_std``.

The JAX package runs CEM on its scan path with no Pallas kernel, and so does
the port: plain PyTorch on (K, ...) tensors, on the card by default. The
iterations' ε (num_iters, K, T, dim_u) is injected or drawn from the
solver's ``torch.Generator`` on the device (other numbers than JAX's
``jax.random`` stream). The elite count is static and the sort and gather
stay on the device, so nothing in a tick waits for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import MPPIParams, resolve_device
from ..ops.waypoints import nearest_waypoint
from .mppi import CostContext, StageCost, TerminalCost, _time_indexed


@dataclasses.dataclass(frozen=True)
class CEMConfig:
    """Static CEM configuration (shares the problem dims with MPPIConfig)."""

    num_samples: int  # K
    horizon: int  # T
    dim_x: int
    dim_u: int
    dt: float
    num_iters: int = 5  # CEM refinement iterations per control tick
    elite_fraction: float = 0.1
    init_std: float = 0.5
    min_std: float = 0.05  # floor keeps exploration alive (prevents collapse)
    momentum: float = 0.25  # smoothing of mean/std across iterations
    # dynamics_step is F(x, u, t), t the rollout step index
    time_varying_dynamics: bool = False
    waypoint_search_len: int = 20


@dataclasses.dataclass
class CEMState:
    """The carried distribution over control sequences and the waypoint
    window start (the generator that draws ε is the solver's)."""

    mean: torch.Tensor  # (T, dim_u)
    std: torch.Tensor  # (T, dim_u)
    waypoint_idx: torch.Tensor  # () int64

    @classmethod
    def init(cls, cfg: CEMConfig, device="cuda") -> "CEMState":
        device = resolve_device(device)
        shape = (cfg.horizon, cfg.dim_u)
        return cls(
            mean=torch.zeros(shape, dtype=torch.float32, device=device),
            std=torch.full(shape, cfg.init_std, dtype=torch.float32, device=device),
            waypoint_idx=torch.zeros((), dtype=torch.int64, device=device),
        )


def cem_state_from_numpy(mean, std, waypoint_idx, *, device="cuda") -> CEMState:
    """:class:`CEMState` on ``device`` from a JAX ``CEMState``'s mean, std
    and waypoint index as numpy arrays (its key has no counterpart)."""
    device = resolve_device(device)
    return CEMState(
        mean=torch.tensor(np.asarray(mean, np.float32), device=device),
        std=torch.tensor(np.asarray(std, np.float32), device=device),
        waypoint_idx=torch.as_tensor(np.asarray(waypoint_idx, np.int64), device=device),
    )


class CEMAux(NamedTuple):
    elite_cost: torch.Tensor  # mean cost of the elite set at the last iteration
    best_cost: torch.Tensor


def cem_step(
    cfg: CEMConfig,
    dynamics_step: Callable,
    stage_cost: StageCost,
    terminal_cost: TerminalCost,
    params: MPPIParams,
    state: CEMState,
    x0: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, CEMState, CEMAux]:
    """One CEM control tick: ``num_iters`` rounds of sample → rollout →
    elite refit, then the receding shift. Returns (u0, next state, aux).

    ``noise`` (num_iters, K, T, dim_u) injects each iteration's standard
    normal ε; without it ε is drawn from ``generator`` (on the state's
    device). The elite set is the ``max(1, ⌊K · elite_fraction⌋)`` samples
    of least cost, ties in sample order (a stable sort, as JAX's
    ``argsort``); its spread is the population std."""
    K, T, nu = cfg.num_samples, cfg.horizon, cfg.dim_u
    n_elite = max(1, int(K * cfg.elite_fraction))
    mean, std = state.mean, state.std
    x0 = x0.to(mean.dtype)
    if noise is None:
        if generator is None:
            raise ValueError("cem_step needs injected noise or a torch.Generator")
        noise = torch.randn((cfg.num_iters, K, T, nu), generator=generator, dtype=mean.dtype,
                            device=mean.device)
    elif noise.shape != (cfg.num_iters, K, T, nu):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"{(cfg.num_iters, K, T, nu)}")
    noise = noise.to(mean.dtype)

    wp_idx, _ = nearest_waypoint(params.ref_path, x0[:2], state.waypoint_idx,
                                 cfg.waypoint_search_len)
    ctx = CostContext(params=params, waypoint_start=wp_idx)
    dyn_t = _time_indexed(cfg, dynamics_step)

    def rollout_costs(v):
        """(K, T, nu) clamped sequences → (K,) summed costs."""
        x = x0.expand((K,) + x0.shape)
        s = torch.zeros(K, dtype=x0.dtype, device=x0.device)
        for t in range(T):
            x = dyn_t(x, v[:, t], t)
            s = s + stage_cost(x, t, ctx)
        return s + terminal_cost(x, ctx)

    for i in range(cfg.num_iters):
        v = torch.clamp(mean[None] + std[None] * noise[i], params.u_min, params.u_max)
        S = rollout_costs(v)
        top = torch.argsort(S, stable=True)[:n_elite]
        elite = v.index_select(0, top)  # (n_elite, T, nu)
        new_mean = elite.mean(0)
        new_std = torch.clamp(elite.std(0, correction=0), min=cfg.min_std)
        mean = cfg.momentum * mean + (1.0 - cfg.momentum) * new_mean
        std = cfg.momentum * std + (1.0 - cfg.momentum) * new_std
        elite_S = S.index_select(0, top)
        elite_cost, best_cost = elite_S.mean(), elite_S[0]

    u0 = mean[0]
    mean_shift = torch.cat([mean[1:], mean[-1:]], dim=0)
    std_shift = torch.cat([std[1:], torch.full_like(std[-1:], cfg.init_std)], dim=0)
    return u0, CEMState(mean=mean_shift, std=std_shift, waypoint_idx=wp_idx), CEMAux(
        elite_cost=elite_cost, best_cost=best_cost)


class CEMSolver:
    """Binds config, dynamics and costs (the counterpart of JAX's
    ``CEMSolver``), on ``device`` (the card by default), with its own
    ``torch.Generator`` seeded from ``seed``."""

    def __init__(
        self,
        cfg: CEMConfig,
        dynamics_step: Callable,
        stage_cost: StageCost,
        terminal_cost: TerminalCost,
        device="cuda",
        seed: int = 0,
    ) -> None:
        self.cfg = cfg
        self.dynamics_step = dynamics_step
        self.stage_cost = stage_cost
        self.terminal_cost = terminal_cost
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def init(self) -> CEMState:
        return CEMState.init(self.cfg, device=self.device)

    def step(self, params: MPPIParams, state: CEMState, x0: torch.Tensor,
             noise: Optional[torch.Tensor] = None):
        return cem_step(self.cfg, self.dynamics_step, self.stage_cost, self.terminal_cost,
                        params, state, x0, noise, generator=self.generator)


__all__ = ["CEMAux", "CEMConfig", "CEMSolver", "CEMState", "cem_state_from_numpy", "cem_step"]
