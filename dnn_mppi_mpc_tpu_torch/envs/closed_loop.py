"""Closed-loop simulation and residual-dynamics data collection
(counterpart of ``dnn_mppi_mpc_tpu/envs/closed_loop.py``).

The reference closes its control loops in Python, one controller call a
frame (controllers/mppi_differential_drive.py:305-369,
simulation/bullet_differential_drive_dnn.py:419-467). The JAX package runs
the whole loop as one ``lax.scan``; here it is a Python loop over device
tensors: controller tick → plant step → log, with nothing in it that waits
for the card, so the host enqueues tick after tick while the card works.
States, controls and errors are stacked on the device at the end.

The JAX ``vmap`` over data-collection series has no counterpart yet: the
series run one after another (batching them as fleet members is ROADMAP
A7).
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


def _collect(controller_factory, plant_step, nominal_step, x0_sampler, seed, series,
             ticks_per_series, device) -> Episode:
    """The series ``series`` (a range) one after another, flattened."""
    parts = []
    for i in series:
        g_ctrl, g_x0 = series_generators(seed, i, device)
        controller, cs0 = controller_factory(g_ctrl)
        x0 = x0_sampler(g_x0)
        ep, _ = run_closed_loop(controller, plant_step, cs0, x0, ticks_per_series,
                                nominal_step=nominal_step)
        parts.append(ep)
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
    ``device`` seeded from ``(seed, series)`` (:func:`series_generators`).
    The series run one after another on the card."""
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


def mppi_controller(solver, params) -> Controller:
    """An ``MPPISolver`` as the ``(ctrl_state, x) → (u, ctrl_state)``
    controller :func:`run_closed_loop` takes (``solver.step``; the state is
    the ``MPPIState``)."""

    def controller(cs, x):
        u0, cs, _ = solver.step(params, cs, x)
        return u0, cs

    return controller


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
