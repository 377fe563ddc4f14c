"""Closed-loop simulation and residual-dynamics data collection
(counterpart of ``dnn_mppi_mpc_tpu/envs/closed_loop.py``).

The reference closes its control loops in Python, one controller call a
frame (controllers/mppi_differential_drive.py:305-369,
simulation/bullet_differential_drive_dnn.py:419-467). The JAX package runs
the whole loop as one ``lax.scan``; here it is a Python loop over device
tensors: controller tick → plant step → log, with nothing in it that waits
for the card, so the host enqueues tick after tick while the card works.
States, controls and errors are stacked on the device at the end.

The JAX ``vmap`` over data-collection series has its counterpart in the
fleet tick: where every series' controller is an :class:`MPPIController`
over one solver with a fleet step (``MPPISolver.fleet_step``), the
series of a collection run as the members of one fleet step, one
``fleet_mppi_tick`` launch a tick for all of them (see
:func:`collect_residual_dataset` for the rule). Any other controller runs
its series one after another.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device

# controller: (ctrl_state, x) -> (u, new_ctrl_state)
Controller = Callable[[object, torch.Tensor], Tuple[torch.Tensor, object]]
# plant transition: (x, u) -> x_next
PlantStep = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class Episode(NamedTuple):
    states: torch.Tensor  # (T+1, nx) visited plant states
    controls: torch.Tensor  # (T, nu) applied controls
    errors: torch.Tensor  # (T, nx) residual or tracking errors


def run_closed_loop(
    controller: Controller,
    plant_step: PlantStep,
    ctrl_state0,
    x0: torch.Tensor,
    num_ticks: int,
    nominal_step: Optional[PlantStep] = None,
    x_ref: Optional[torch.Tensor] = None,
    metric_fn: Optional[Callable[[torch.Tensor, torch.Tensor], dict]] = None,
    metric_cb: Optional[Callable[..., None]] = None,
    metric_every: int = 1,
) -> Tuple[Episode, object]:
    """Run ``num_ticks`` ticks of controller and plant; returns the episode
    and the final controller state.

    errors column:

    * with ``nominal_step``: the residual x_next − F_nominal(x, u), the
      model-error target of the DNN training pipeline;
    * with ``x_ref``: the tracking error x − x_ref;
    * else zeros.

    Metrics: with both ``metric_fn`` (``(x_next, u) → dict`` of 0-d
    tensors) and ``metric_cb`` (``(tick, **metrics)``, e.g.
    ``utils.logging.MetricsWriter.write``), ticks 0, ``metric_every``,
    2·``metric_every``, … call ``metric_cb`` in tick order with the 0-d
    device tensors ``metric_fn`` returned. The loop converts nothing: a
    callback that reads a value on the host (``float(v)``) waits for the
    card there, and that wait is the callback's own."""
    cs, x = ctrl_state0, x0
    xs, us, errs = [x0], [], []
    for t in range(num_ticks):
        u, cs = controller(cs, x)
        x_next = plant_step(x, u)
        if nominal_step is not None:
            err = x_next - nominal_step(x, u)
        elif x_ref is not None:
            err = x - x_ref
        else:
            err = torch.zeros_like(x)
        if metric_fn is not None and metric_cb is not None and t % metric_every == 0:
            metric_cb(t, **metric_fn(x_next, u))
        xs.append(x_next)
        us.append(u)
        errs.append(err)
        x = x_next
    episode = Episode(states=torch.stack(xs), controls=torch.stack(us), errors=torch.stack(errs))
    return episode, cs


def series_generators(seed: int, series: int, device) -> Tuple[torch.Generator, torch.Generator]:
    """The two generators of data-collection series ``series`` under
    ``seed`` (the controller factory's and the x0 sampler's, the JAX split
    of a series key into two), on ``device``, seeded from
    ``np.random.SeedSequence([seed, series])``."""
    words = np.random.SeedSequence([seed, series]).generate_state(2, np.uint32)
    return tuple(torch.Generator(device=device).manual_seed(int(w)) for w in words)


_SHARED_LEAVES = ("sigma", "stage_weight", "terminal_weight", "u_min", "u_max")
_MEMBER_LEAVES = ("ref_path", "obstacles", "obstacle_velocities")


def _same(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> bool:
    """``a`` and ``b`` are one tensor, or equal (a read that waits for the
    card, made once before the first tick), or both None."""
    if a is None or b is None:
        return a is b
    return a is b or (a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b)))


def _fleet_plan(controllers: list, states: list):
    """The fleet step and its stacked (params, states) when the series can
    run as fleet members (:func:`collect_residual_dataset`'s rule), else
    None."""
    from ..solvers.mppi import MPPISolver, MPPIState

    first = controllers[0]
    if not all(type(c) is MPPIController and c.solver is first.solver for c in controllers):
        return None
    if not (isinstance(first.solver, MPPISolver)
            and all(isinstance(st, MPPIState) for st in states)):
        return None
    step = first.solver.fleet_step()
    if step is None:
        return None
    params = [c.params for c in controllers]
    p0 = params[0]
    if any(p.control_weight is not None for p in params):
        return None
    if not all(_same(getattr(p, name), getattr(p0, name))
               for p in params for name in _SHARED_LEAVES):
        return None
    for name in _MEMBER_LEAVES:
        leaves = [getattr(p, name) for p in params]
        if any(a is None for a in leaves) and not all(a is None for a in leaves):
            return None
        if leaves[0] is not None and any(a.shape != leaves[0].shape for a in leaves):
            return None
    fleet_params = dataclasses.replace(p0, **{
        name: None if getattr(p0, name) is None
        else torch.stack([getattr(p, name) for p in params])
        for name in _MEMBER_LEAVES})
    fleet_state = MPPIState(*(torch.stack([getattr(st, f) for st in states])
                              for f in ("u_prev", "waypoint_idx", "key")))
    return step, fleet_params, fleet_state


def _run_fleet(step, params, states, x0s, plant_step, nominal_step, ticks: int) -> Episode:
    """``ticks`` fleet ticks of the B series (leading axis of ``x0s``),
    the plant and the nominal step one ``vmap`` over the (B, nx) states; the
    episode is series-major, (B·ticks, ·)."""
    transition = torch.func.vmap(lambda x, u: (plant_step(x, u), nominal_step(x, u)))
    x, xs, us, errs = x0s, [], [], []
    for _ in range(ticks):
        u, states, _ = step(params, states, x)
        x_next, x_nominal = transition(x, u)
        xs.append(x)
        us.append(u)
        errs.append(x_next - x_nominal)
        x = x_next
    return Episode(*(torch.stack(seq, dim=1).flatten(0, 1) for seq in (xs, us, errs)))


def _collect(controller_factory, plant_step, nominal_step, x0_sampler, seed, series,
             ticks_per_series, device) -> Episode:
    """The series ``series`` (a range), flattened series-major: as the
    members of one fleet step where the rule allows it, else one after
    another."""
    controllers, states, x0s = [], [], []
    for i in series:
        g_ctrl, g_x0 = series_generators(seed, i, device)
        controller, cs0 = controller_factory(g_ctrl)
        controllers.append(controller)
        states.append(cs0)
        x0s.append(x0_sampler(g_x0))
    plan = _fleet_plan(controllers, states)
    if plan is not None:
        step, params, fleet_state = plan
        return _run_fleet(step, params, fleet_state, torch.stack(x0s), plant_step, nominal_step,
                          ticks_per_series)
    parts = [run_closed_loop(c, plant_step, cs0, x0, ticks_per_series,
                             nominal_step=nominal_step)[0]
             for c, cs0, x0 in zip(controllers, states, x0s)]
    # (B, T, ·) flattened to (B·T, ·); states drop each series' last row
    return Episode(
        states=torch.cat([p.states[:-1] for p in parts]),
        controls=torch.cat([p.controls for p in parts]),
        errors=torch.cat([p.errors for p in parts]),
    )


def collect_residual_dataset(
    controller_factory: Callable[[torch.Generator], Tuple[Controller, object]],
    plant_step: PlantStep,
    nominal_step: PlantStep,
    x0_sampler: Callable[[torch.Generator], torch.Tensor],
    seed: int,
    num_series: int,
    ticks_per_series: int,
    device="cuda",
) -> Episode:
    """Randomized-scenario data collection: ``num_series`` closed loops of
    ``ticks_per_series`` ticks, flattened to the reference's (states,
    controls, errors) triplet layout, (B·T, ·) on ``device``
    (train/bullet_mpc_differential_drive.py:334-336).

    The JAX signature, with a seed in place of the key:
    ``controller_factory(generator) → (controller, ctrl_state0)`` and
    ``x0_sampler(generator) → x0`` each take a ``torch.Generator`` on
    ``device`` seeded from ``(seed, series)`` (:func:`series_generators`);
    every series' controller and x0 are made before the first tick.

    The batched route, the counterpart of JAX's ``vmap`` over series: the
    series run as the B members of one ``make_fleet_fused_mppi_step`` (one
    ``fleet_mppi_tick`` launch a tick for all of them; the plant and the
    nominal step through ``torch.func.vmap`` over the (B, nx) states) when

    * every controller is an :class:`MPPIController` (what
      :func:`mppi_controller` returns) over one ``MPPISolver`` and its
      initial state an ``MPPIState``,
    * that solver has a fleet step (:meth:`MPPISolver.fleet_step`: its tick
      is the single-block diff-drive tick with ``waypoint_carry="tick"``),
      and
    * the series' params share ``sigma``, the weights, ``u_min`` and
      ``u_max`` (one tensor, or equal), have no ``control_weight``, and
      their ``ref_path`` (and ``obstacles``, ``obstacle_velocities`` where
      present) stack on a member axis.

    The fleet step is built once a call. Member b draws the hash stream of
    its own carried key, which is the single-block tick's stream: S of a
    tick is the sequential route's bit for bit given equal inputs; its tail
    (filter, update, shift) runs in PyTorch, not in the kernel's epilogue,
    so u0 may differ by rounding. Any other controller (a plain function,
    another route, shared leaves that differ) runs its series one after
    another.
    Nothing catches a failure of the fleet route to fall back."""
    device = resolve_device(device)
    return _collect(controller_factory, plant_step, nominal_step, x0_sampler, seed,
                    range(num_series), ticks_per_series, device)


def collect_residual_dataset_resumable(
    controller_factory: Callable[[torch.Generator], Tuple[Controller, object]],
    plant_step: PlantStep,
    nominal_step: PlantStep,
    x0_sampler: Callable[[torch.Generator], torch.Tensor],
    seed: int,
    num_series: int,
    ticks_per_series: int,
    out_dir: str,
    series_per_chunk: int = 8,
    config_tag: str = "",
    device="cuda",
) -> Episode:
    """Checkpointed :func:`collect_residual_dataset`: resume at the chunk.

    The series are collected in chunks of ``series_per_chunk``; each
    finished chunk goes to ``out_dir/chunk_<i>.npz`` (written to a temporary
    file, then ``os.replace``d, so a crash never leaves half a chunk), and a
    re-run skips the chunks it finds. Chunk i holds series
    [i·series_per_chunk, …) of ``seed``, so the result equals the
    uninterrupted run's and :func:`collect_residual_dataset`'s. A cached
    chunk is used only when its seed, chunk index, chunk size, tick count and
    ``config_tag`` (pass a fingerprint of the controller and sampler set-up
    when ``out_dir`` is reused across configurations) are this run's;
    otherwise it is collected again."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    n_chunks = -(-num_series // series_per_chunk)
    parts = []
    for i in range(n_chunks):
        path = os.path.join(out_dir, f"chunk_{i:05d}.npz")
        first = i * series_per_chunk
        n_i = min(series_per_chunk, num_series - first)
        stamp = dict(seed=seed, chunk=i, series_per_chunk=series_per_chunk, num_series=n_i,
                     ticks=ticks_per_series, config_tag=config_tag)
        if os.path.exists(path):
            with np.load(path) as z:
                if all(k in z and z[k].item() == v for k, v in stamp.items()):
                    parts.append(Episode(*(torch.from_numpy(z[k]).to(device)
                                           for k in Episode._fields)))
                    continue
        ep = _collect(controller_factory, plant_step, nominal_step, x0_sampler, seed,
                      range(first, first + n_i), ticks_per_series, device)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **{k: getattr(ep, k).cpu().numpy() for k in Episode._fields},
                 **{k: np.asarray(v) for k, v in stamp.items()})
        os.replace(tmp, path)
        parts.append(ep)
    return Episode(*(torch.cat([getattr(p, k) for p in parts]) for k in Episode._fields))


class MPPIController:
    """An ``MPPISolver`` (or anything with its ``step``) and its params as
    the ``(ctrl_state, x) → (u, ctrl_state)`` controller
    :func:`run_closed_loop` takes; it keeps ``solver`` and ``params``, which
    :func:`collect_residual_dataset` reads to run series as a fleet."""

    def __init__(self, solver, params) -> None:
        self.solver, self.params = solver, params

    def __call__(self, cs, x):
        u0, cs, _ = self.solver.step(self.params, cs, x)
        return u0, cs


def mppi_controller(solver, params) -> MPPIController:
    """An ``MPPISolver`` as a controller (``solver.step``; the state is the
    ``MPPIState``)."""
    return MPPIController(solver, params)


def nmpc_controller(solver, params) -> Controller:
    """An ``NMPCSolver`` likewise (``solver.solve``; the state is the
    ``NMPCState`` warm start)."""

    def controller(cs, x):
        u0, cs, _ = solver.solve(params, cs, x)
        return u0, cs

    return controller


class RecoveryState(NamedTuple):
    """The carry of :func:`with_recovery`: the inner controller's state and
    its failure counts (int32 0-d tensors on the state's device)."""

    inner: object
    bad_ticks: torch.Tensor  # consecutive failed ticks
    resets: torch.Tensor  # recoveries so far (telemetry)


def _tree_map(fn: Callable, cur, *others):
    """``fn(leaf, *other_leaves)`` over the tensors of ``cur`` and of the
    trees ``others`` that share its structure, through dataclasses, tuples
    and named tuples (other leaves: ``cur``'s)."""
    if isinstance(cur, torch.Tensor):
        return fn(cur, *others)
    if dataclasses.is_dataclass(cur):
        return dataclasses.replace(cur, **{
            f.name: _tree_map(fn, getattr(cur, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(cur) if f.init})
    if isinstance(cur, tuple):
        leaves = [_tree_map(fn, *branches) for branches in zip(cur, *others)]
        return type(cur)(*leaves) if hasattr(cur, "_fields") else tuple(leaves)
    return cur


def with_recovery(
    controller_aux: Callable,
    reset_fn: Callable,
    max_bad_ticks: int = 5,
    u_safe: Optional[torch.Tensor] = None,
) -> Controller:
    """Elastic recovery: reset a wedged controller inside the loop.

    ``controller_aux(inner_state, x) → (u, inner_state, aux)``, where bit 2
    of ``aux.status`` marks a failed tick (both solvers hold the previous
    sequence on a non-finite update and set it). A tick that failed emits
    ``u_safe`` (zero control by default; a tensor on the controls' device)
    instead of the controller's output, and after ``max_bad_ticks``
    consecutive failed ticks the inner state is swapped for
    ``reset_fn(inner_state)`` (e.g. a zeroed nominal sequence, the key
    kept). The choice is ``torch.where`` over the state's tensors, never a
    Python branch on a device value, so the ladder does not wait for the
    card. Start it from :func:`recovery_init`."""

    def controller(rs: RecoveryState, x):
        u, inner, aux = controller_aux(rs.inner, x)
        failed = (aux.status & 2) > 0
        bad = torch.where(failed, rs.bad_ticks + 1, 0).to(torch.int32)
        do_reset = bad >= max_bad_ticks
        inner = _tree_map(lambda cur, fresh: torch.where(do_reset, fresh, cur), inner,
                          reset_fn(inner))
        safe = torch.zeros_like(u) if u_safe is None else torch.broadcast_to(u_safe, u.shape)
        u = torch.where(failed, safe, u)
        return u, RecoveryState(
            inner=inner,
            bad_ticks=torch.where(do_reset, 0, bad).to(torch.int32),
            resets=rs.resets + do_reset.to(torch.int32),
        )

    return controller


def recovery_init(inner_state) -> RecoveryState:
    """The recovery carry around ``inner_state``, counts zero on its device."""
    devices = []
    _tree_map(lambda leaf: devices.append(leaf.device) or leaf, inner_state)
    if not devices:
        raise ValueError("recovery_init needs a controller state that holds a tensor")
    zero = torch.zeros((), dtype=torch.int32, device=devices[0])
    return RecoveryState(inner=inner_state, bad_ticks=zero, resets=zero.clone())


__all__ = [
    "Episode",
    "MPPIController",
    "RecoveryState",
    "collect_residual_dataset",
    "collect_residual_dataset_resumable",
    "mppi_controller",
    "nmpc_controller",
    "recovery_init",
    "run_closed_loop",
    "series_generators",
    "with_recovery",
]
