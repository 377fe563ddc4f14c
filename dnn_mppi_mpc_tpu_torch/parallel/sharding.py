"""Sample-sharded MPPI and the sharded fleet over the ranks of a process
group — counterpart of ``dnn_mppi_mpc_tpu/parallel/sharding.py``.

* :func:`make_sharded_mppi_step` is the scan-path step with K split over n
  ranks: each rank runs :func:`~..solvers.mppi.mppi_step` on its K/n
  samples (the scan loop, or a ``rollout_fn`` such as the generic rollout
  kernel with the shard's ``k_offset``), and ρ, η and Σw·ε are all-reduced.
* :func:`make_sharded_fused_mppi_step` splits one controller's K samples
  over n ranks. Phase 1 is the K-blocked tick in ``s_only`` mode with ε
  drawn from (seed, global block); between the phases the only traffic is
  three all-reduces (ρ = min, η = Σ m, and the (T, 2) Σ w·ε partials);
  phase 2 is ``weighted_noise_reduce``, which draws the same ε again on
  the K-blocked tick's grid of chunks × steps, from the weights m/η, and
  sums the chunks in chunk order. The (K, T, 2) noise tensor never exists.
* :func:`make_batched_mppi_step` is the scan-path step over a batch of
  scenarios, each with its own params, state and x0: rank i of n runs its
  B/n scenarios as one ``torch.func.vmap`` of ``mppi_step``, with no
  collectives.
* :func:`make_sharded_mppi_fleet` gives each rank B/n members of a fleet,
  with no collectives (the fused fleet tick, or with ``fused=False`` the
  batched scan-path step over the fleet's shared params).
* :func:`make_sharded_nmpc_fleet` does the same for a fleet of NMPC
  problems: each rank solves its members with ``NMPCSolver.batched_solve``
  (with the kernel QP backend, one launch of the batched QP kernel per SQP
  iteration for the rank's members).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..config import MPPIConfig, MPPIParams
from ..ops.cuda.common import f32
from ..ops.sampling import small_cholesky
from ..ops.waypoints import nearest_waypoint, waypoint_window
from ..solvers.sqp import PARAM_NDIM, NMPCSolver, NMPCState, OCPParams
from ..solvers.mppi import (
    MPPIAux,
    MPPIState,
    StageCost,
    TerminalCost,
    _check_kernel_collision,
    _check_tick_carry,
    _energy_rows,
    _IsoCheck,
    _mppi_tail,
    _on_device,
    _pick_k_block,
    _reject_last,
    _reject_repeats,
    _warm_filter,
    advance_key,
    make_fleet_fused_mppi_step,
    mppi_step,
    resolve_device,
    tick_seed,
)


def make_sharded_mppi_step(
    cfg: MPPIConfig,
    dynamics_step: Callable,
    stage_cost: StageCost,
    terminal_cost: TerminalCost,
    group: Optional[dist.ProcessGroup] = None,
    rollout_fn: Optional[Callable] = None,
    device="cuda",
) -> Callable:
    """The scan-path MPPI step with K sharded over the ranks of ``group``
    (the default group when None; the JAX mesh axis).

    ``step(params, state, x0, noise=None) -> (u0, state, aux)`` on one
    controller's replicated params, state and x0, which lie on ``device``
    (default the card, with an NCCL group; gloo on the CPU). Injected
    ``noise`` is the global (K, T, dim_u) tensor, replicated: rank i takes
    its rows [i·K/n, (i+1)·K/n), as JAX's ``P(axis)`` in-spec gives shard i.
    Without noise rank i draws its slice from its own generator
    (``step.generator``, seeded i; set its state to reseed), not from JAX's
    stream. Every rank returns the same u0 and state; ``aux.costs`` /
    ``aux.weights`` are this rank's samples. ``rollout_fn`` (e.g. ``make_cuda_generic_rollout``) replaces the scan
    loop. ``num_samples % world_size`` raises."""
    group = dist.group.WORLD if group is None else group
    n, i = dist.get_world_size(group), dist.get_rank(group)
    K = cfg.num_samples
    if K % n != 0:
        raise ValueError(f"num_samples={K} must be divisible by the group size {n}")
    local = slice(i * (K // n), (i + 1) * (K // n))
    device = resolve_device(device)
    _warm_filter(cfg, device)
    generator = torch.Generator(device=device).manual_seed(i)

    def step(params: MPPIParams, state: MPPIState, x0: torch.Tensor,
             noise: Optional[torch.Tensor] = None):
        _on_device(device, u_prev=state.u_prev, x0=x0, ref_path=params.ref_path)
        if noise is not None:
            if noise.shape[0] != K:
                raise ValueError(f"noise has {noise.shape[0]} samples, expected K={K}")
            noise = noise[local]
        return mppi_step(cfg, dynamics_step, stage_cost, terminal_cost, params, state, x0,
                         noise, rollout_fn=rollout_fn, generator=generator, group=group)

    step.samples = local
    step.generator = generator
    return step


def make_sharded_fused_mppi_step(
    cfg: MPPIConfig,
    dynamics_step: Callable,
    group: Optional[dist.ProcessGroup] = None,
    robot_radius: float = 0.5,
    safety_margin_rate: float = 1.5,
    collision: str = "circle",
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    iso_xy: bool = False,
    k_blk: Optional[int] = None,
    device="cuda",
) -> Callable:
    """Sample-sharded two-phase MPPI tick over the ranks of ``group`` (the
    default group when None; the JAX mesh axis).

    Rank i of n rolls out samples [i·K/n, (i+1)·K/n): its first noise block
    is ``i·(K/n)/k_blk``, so the ε of every sample depends only on (seed,
    global block) and the result does not depend on n once ``k_blk`` is
    fixed (default: the JAX package's pick for K/n samples). Every rank
    shares the seed of the replicated carried key and returns the same u0
    and state; ``aux.costs`` / ``aux.weights`` are this rank's samples.

    ``step(params, state, x0) -> (u0, state, aux)`` on one controller's
    replicated params, state and x0, which lie on ``device`` (default the
    card, with an NCCL group; gloo on the CPU). ``params.control_weight``,
    ``num_rollout_repeats > 1`` and LAST accumulation raise (the JAX step
    runs its kernels with SUM whatever the config says)."""
    from ..ops.cuda.mppi_tick_blocked import diffdrive_mppi_tick_blocked, weighted_noise_reduce

    _check_tick_carry(cfg, "sharded two-phase tick")
    _reject_repeats(cfg, "sharded two-phase tick")
    _reject_last(cfg, "sharded two-phase tick")
    _check_kernel_collision(collision)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    K, T = cfg.num_samples, cfg.horizon
    if K % n != 0:
        raise ValueError(f"num_samples={K} must be divisible by the group size {n}")
    local_K = K // n
    kb = k_blk if k_blk is not None else _pick_k_block(local_K, T)
    if local_K % kb != 0:
        raise ValueError(f"k_blk={kb} must divide the per-shard sample count {local_K}")
    block_offset = i * (local_K // kb)
    k_offset = float(i * local_K)
    device = resolve_device(device)
    _warm_filter(cfg, device)
    inv_t = f32(cfg.inv_temperature)
    iso_check = _IsoCheck()

    def step(params: MPPIParams, state: MPPIState, x0: torch.Tensor):
        if params.control_weight is not None:
            raise ValueError(
                "params.control_weight (the pytorch_mppi action cost) is not "
                "implemented in the sharded two-phase tick"
            )
        u = state.u_prev
        _on_device(device, u_prev=u, x0=x0, ref_path=params.ref_path)
        if iso_xy:
            iso_check(params)
        x0 = x0.to(u.dtype)
        wp_idx, _ = nearest_waypoint(params.ref_path, x0[:2], state.waypoint_idx,
                                     cfg.waypoint_search_len)
        _, window = waypoint_window(params.ref_path, wp_idx, cfg.waypoint_search_len)
        seed = tick_seed(state.key)
        chol = small_cholesky(params.sigma)
        S_local = diffdrive_mppi_tick_blocked(
            seed, u, _energy_rows(cfg, params, u), chol, x0, window[:, :3].contiguous(),
            params.stage_weight, params.terminal_weight, params.u_min, params.u_max,
            cfg.dt, (1.0 - cfg.exploration) * K, cfg.inv_temperature,
            obstacles=params.obstacles, robot_radius=robot_radius,
            safety_margin_rate=safety_margin_rate,
            obstacle_velocities=params.obstacle_velocities,
            soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
            k_offset=k_offset, block_offset=block_offset,
            K=local_K, T=T, W=window.shape[0], K_BLK=kb, s_only=True,
            collision=collision, iso_xy=iso_xy,
        )
        rho = S_local.min().reshape(1)
        dist.all_reduce(rho, op=dist.ReduceOp.MIN, group=group)
        m = torch.exp(-inv_t * (S_local - rho))
        eta = m.sum().reshape(1)
        dist.all_reduce(eta, op=dist.ReduceOp.SUM, group=group)
        w_local = m / eta
        w_eps = weighted_noise_reduce(seed, w_local, chol, block_offset, K=local_K, T=T,
                                      K_BLK=kb)
        dist.all_reduce(w_eps, op=dist.ReduceOp.SUM, group=group)
        return _mppi_tail(cfg, dynamics_step, params, x0, u, advance_key(state.key), wp_idx,
                          S_local, w_local, w_eps)

    step.k_blk = kb
    return step


_MEMBER_LEAVES = ("ref_path", "obstacles", "obstacle_velocities")
# MPPIParams' tensor fields (model_params is an opaque object)
_PARAM_TENSORS = ("sigma", "stage_weight", "terminal_weight", "u_min", "u_max", "ref_path",
                  "obstacles", "obstacle_velocities", "control_weight")


def _batched_scan_step(cfg: MPPIConfig, dynamics_step: Callable, stage_cost: StageCost,
                       terminal_cost: TerminalCost, device: torch.device,
                       generator: torch.Generator) -> Callable:
    """``run(params, states, x0s, eps=None)``: one ``torch.func.vmap`` of
    ``mppi_step`` over all the scenarios it is given (the leading axis of
    every tensor leaf); without ``eps`` each scenario's ε is drawn outside
    the vmap from ``generator``, coloured by its own Σ."""
    K, T, nu = cfg.num_samples, cfg.horizon, cfg.dim_u

    def one(leaves, model_params, u_prev, waypoint_idx, key, x0, eps):
        params = MPPIParams(**leaves, model_params=model_params)
        u0, state, aux = mppi_step(cfg, dynamics_step, stage_cost, terminal_cost, params,
                                   MPPIState(u_prev, waypoint_idx, key), x0, eps)
        return u0, (state.u_prev, state.waypoint_idx, state.key), tuple(aux)

    batched = torch.func.vmap(one, in_dims=(0, None, 0, 0, 0, 0, 0))

    def run(params: MPPIParams, states: MPPIState, x0s: torch.Tensor,
            eps: Optional[torch.Tensor] = None):
        _on_device(device, u_prev=states.u_prev, x0s=x0s, ref_path=params.ref_path)
        leaves = {name: getattr(params, name) for name in _PARAM_TENSORS
                  if getattr(params, name) is not None}
        if eps is None:
            chol = torch.func.vmap(small_cholesky)(params.sigma.to(torch.float64))
            z = torch.randn((x0s.shape[0], K, T, nu), generator=generator, dtype=torch.float64,
                            device=device)
            # z @ cholᵀ a scenario, written out elementwise (no TF32 path)
            eps = (z.unsqueeze(-2) * chol[:, None, None]).sum(-1)
        u0s, (u_prev, waypoint_idx, key), aux = batched(
            leaves, params.model_params, states.u_prev, states.waypoint_idx, states.key, x0s,
            eps.to(states.u_prev.dtype))
        return u0s, MPPIState(u_prev, waypoint_idx, key), MPPIAux(*aux)

    return run


def _rank_generator(group, device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed + dist.get_rank(group))


def make_batched_mppi_step(
    cfg: MPPIConfig,
    dynamics_step: Callable,
    stage_cost: StageCost,
    terminal_cost: TerminalCost,
    group: Optional[dist.ProcessGroup] = None,
    device="cuda",
    seed: int = 0,
) -> Callable:
    """The scan-path MPPI step over a batch of B scenarios, split over the
    ranks of ``group`` (the default group when None; the JAX mesh axis):
    rank i runs scenarios [i·B/n, (i+1)·B/n), with no collectives.

    ``step(params, states, x0s, noise=None) -> (u0s, states, auxs)``: every
    tensor leaf of ``params`` carries the leading batch axis (JAX's
    ``in_axes=0``; ``model_params`` goes to every scenario as it is),
    ``states`` is a fleet :class:`MPPIState` and ``x0s`` is (B, dim_x), all
    on ``device`` (default the card). A tick is one batched computation,
    ``torch.func.vmap`` of ``mppi_step`` over the rank's scenarios, not a
    loop over them. Injected ``noise`` is (B, K, T, dim_u) (the rank takes
    its rows); without it each scenario's ε is drawn outside the vmap from
    ``step.generator`` (seeded ``seed`` + rank), coloured by its own Σ —
    not JAX's per-key stream. Returns this rank's scenarios;
    ``step.members(B)`` is their slice. B % n raises."""
    device = resolve_device(device)
    members = _fleet_members(group)
    _warm_filter(cfg, device)
    generator = _rank_generator(group, device, seed)
    run = _batched_scan_step(cfg, dynamics_step, stage_cost, terminal_cost, device, generator)
    shape = (cfg.num_samples, cfg.horizon, cfg.dim_u)

    def step(params: MPPIParams, states: MPPIState, x0s: torch.Tensor,
             noise: Optional[torch.Tensor] = None):
        B = x0s.shape[0]
        mine = members(B)
        if noise is not None and tuple(noise.shape) != (B,) + shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {(B,) + shape}")
        local = dataclasses.replace(params, **{
            name: getattr(params, name)[mine] for name in _PARAM_TENSORS
            if getattr(params, name) is not None})
        local_states = MPPIState(u_prev=states.u_prev[mine],
                                 waypoint_idx=states.waypoint_idx[mine], key=states.key[mine])
        return run(local, local_states, x0s[mine], None if noise is None else noise[mine])

    step.members = members
    step.generator = generator
    return step


def make_sharded_mppi_fleet(
    cfg: MPPIConfig,
    dynamics_step: Callable,
    group: Optional[dist.ProcessGroup] = None,
    fused: bool = True,
    stage_cost: Optional[StageCost] = None,
    terminal_cost: Optional[TerminalCost] = None,
    **fleet_kwargs,
) -> Callable:
    """A fleet of independent MPPI controllers split over the ranks of
    ``group``: rank i runs members [i·B/n, (i+1)·B/n) with no collectives,
    through :func:`make_fleet_fused_mppi_step` (``fused=True``) or the
    batched scan-path step (``fused=False``).

    ``step(params, states, x0s)`` takes the whole fleet (B members, as the
    JAX step takes its global arrays): per-member leaves of ``params``
    (``ref_path`` (B, P, d), ``obstacles`` (B, n, 3), ``obstacle_velocities``
    (B, n, 2)) are sliced with the fleet, shared ones are kept whole. It
    returns this rank's members' ``(u0s, states, auxs)``; ``step.members(B)``
    is their slice. B % n raises. ``fleet_kwargs`` go to the fleet step
    (``device`` among them, default the card).

    ``fused=False`` is JAX's vmapped scan-path fleet: each rank runs
    :func:`make_batched_mppi_step`'s computation on its members, the shared
    leaves broadcast to them (``fleet_kwargs``: ``device`` and ``seed``);
    it needs ``stage_cost`` and ``terminal_cost``, as in JAX."""
    members = _fleet_members(group)
    if fused:
        inner = make_fleet_fused_mppi_step(cfg, dynamics_step, **fleet_kwargs)
    else:
        if stage_cost is None or terminal_cost is None:
            raise ValueError("the scan-path fleet (fused=False) needs stage_cost/terminal_cost")
        device = resolve_device(fleet_kwargs.pop("device", "cuda"))
        _warm_filter(cfg, device)
        generator = _rank_generator(group, device, fleet_kwargs.pop("seed", 0))
        if fleet_kwargs:
            raise TypeError(f"the scan-path fleet takes device and seed, not {sorted(fleet_kwargs)}")
        batched = _batched_scan_step(cfg, dynamics_step, stage_cost, terminal_cost, device,
                                     generator)

        def inner(params, states, x0s):
            b = x0s.shape[0]
            member = {name for name in _MEMBER_LEAVES
                      if getattr(params, name) is not None and getattr(params, name).dim() == 3}
            return batched(dataclasses.replace(params, **{
                name: getattr(params, name) if name in member
                else getattr(params, name).expand((b,) + getattr(params, name).shape)
                for name in _PARAM_TENSORS if getattr(params, name) is not None}), states, x0s)

    def step(params: MPPIParams, states: MPPIState, x0s: torch.Tensor):
        mine = members(x0s.shape[0])
        local = dataclasses.replace(params, **{
            name: getattr(params, name)[mine]
            for name in _MEMBER_LEAVES
            if getattr(params, name) is not None and getattr(params, name).dim() == 3
        })
        local_states = MPPIState(u_prev=states.u_prev[mine],
                                 waypoint_idx=states.waypoint_idx[mine], key=states.key[mine])
        return inner(local, local_states, x0s[mine])

    step.members = members
    return step


def _fleet_members(group: Optional[dist.ProcessGroup]) -> Callable[[int], slice]:
    """``members(B)``: rank i's slice [i·B/n, (i+1)·B/n) of a B-member fleet
    (B % n raises)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)

    def members(B: int) -> slice:
        if B % n != 0:
            raise ValueError(f"fleet size {B} must be divisible by the group size {n}")
        return slice(i * (B // n), (i + 1) * (B // n))

    return members


def make_sharded_nmpc_fleet(solver: NMPCSolver, group: Optional[dist.ProcessGroup] = None,
                            device="cuda") -> Callable:
    """A fleet of independent NMPC problems split over the ranks of
    ``group`` (the default group when None): rank i solves members
    [i·B/n, (i+1)·B/n) with ``solver.batched_solve()``, with no collectives.

    ``step(params, states, x0s)`` takes the whole fleet, on ``device``
    (default the card): the params' leaves with a leading member axis are
    sliced with the fleet, shared ones are kept whole. It returns this
    rank's members' ``(u0s, states, auxs)``; ``step.members(B)`` is their
    slice. B % n raises."""
    device = resolve_device(device)
    members = _fleet_members(group)
    fleet = solver.batched_solve()

    def step(params: OCPParams, states: NMPCState, x0s: torch.Tensor):
        _on_device(device, X=states.X, x0s=x0s, yref=params.yref)
        mine = members(x0s.shape[0])
        local = OCPParams(**{
            f.name: (None if getattr(params, f.name) is None
                     else getattr(params, f.name)[mine]
                     if getattr(params, f.name).dim() == PARAM_NDIM[f.name] + 1
                     else getattr(params, f.name))
            for f in dataclasses.fields(params)
        })
        return fleet(local, NMPCState(X=states.X[mine], U=states.U[mine]), x0s[mine])

    step.members = members
    return step


__all__ = ["make_batched_mppi_step", "make_sharded_fused_mppi_step", "make_sharded_mppi_fleet",
           "make_sharded_mppi_step", "make_sharded_nmpc_fleet"]
