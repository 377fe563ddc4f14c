"""The benchmark suite: ten headline workloads, each timed as a chain of
control ticks on the card.

Counterpart of ``dnn_mppi_mpc_tpu/utils/benchsuite.py``: the same rows, in
the same order, each built from the port's presets and solvers and timed
by the two-length slope (:mod:`.benchtime`) over n ticks of solver step +
plant step. Where JAX chains the ticks on the device as one jitted
``lax.scan``, the card replays one tick captured as a CUDA graph
(:func:`.benchtime.scan_chain_runner`), so a row measures the tick and not
the host's enqueue of its ops. Each row prints one JSON line with JAX's
keys and ``"chain"``: ``"cuda_graph"`` on the card, ``"eager"`` on the CPU.

On the CPU (``device="cpu"``) the rows shrink to JAX's CPU smoke shapes and
are labelled ``cpu_smoke``: the same builders and routes, with the kernels'
plain versions in place of the kernels (JAX's CPU rows take its XLA scan
path instead); the numbers are not measurements. The artifact is written
only by a run of every row on the card.

===================== ======================================================
``flagship``          diff-drive MPPI K=10 240 T=50, fused tick (row 2)
``pod_k``             K=102 400, the K-blocked tick (row 3)
``racecar``           bicycle MPPI K=10 240 T=20 W=200, polygon collision (7)
``goal_seeking``      soft costs, drifting obstacles, SavGol, K=1 536 (2)
``mppi_fleet``        B=16 fleet tick, K=1 024 T=50 each (5)
``dnn_mppi``          5→128→128→3 MLP residual on the scan path, K=1 024 T=25
``nmpc_rti``          diff-drive SQP-RTI N=30, two obstacle rows, QP kernel (10)
``nmpc_fleet``        B=128 N=30 fleet on the batched QP kernel (11)
``sharded_tick``      the two-phase sample-sharded tick, one rank a card (3, 4)
``sharded_mppi_fleet`` the fleet split over the ranks, fleet tick a rank (5)
===================== ======================================================

``python -m dnn_mppi_mpc_tpu_torch.utils.benchsuite [--rows a,b] [--reps n]``
runs the suite (the counterpart of ``bench.py --suite``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from .benchtime import cuda_event_wall, host_wall, scan_chain_runner, slope_timing

ROWS = (
    "flagship",
    "pod_k",
    "racecar",
    "goal_seeking",
    "mppi_fleet",
    "dnn_mppi",
    "nmpc_rti",
    "nmpc_fleet",
    "sharded_tick",
    "sharded_mppi_fleet",
)

# where a full run on the card writes its rows
ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "assets", "cuda_bench_suite.json")


@dataclasses.dataclass
class Workload:
    """One row: ``body(params, state, x) -> ((state, x), y)`` is a control
    tick (solver step + plant step) from ``st0`` and ``x0``; ``cfg`` is the
    solver's config, ``generators`` the ``torch.Generator``s the tick draws
    from (the scan path's), ``n1`` < ``n2`` the chain lengths, and
    ``solves_per_tick`` the controllers a tick solves (B for a fleet)."""

    name: str
    body: Callable
    params: object
    st0: object
    x0: torch.Tensor
    cfg: object
    n1: int
    n2: int
    solves_per_tick: int
    meta: Dict
    generators: Tuple[torch.Generator, ...] = ()

    def make_runner(self, n: int) -> Callable:
        """n ticks chained: replays of one captured tick on the card, eager
        ticks on the CPU (:func:`.benchtime.scan_chain_runner`)."""
        return scan_chain_runner(self.body, self.params, self.st0, self.x0, n,
                                 generators=self.generators)


def _mppi_workload(name, solver, params, x0, n1, n2, meta) -> Workload:
    """A single-controller MPPI chain: solver step + plant step a tick."""
    def body(params, state, x):
        u0, state, aux = solver.step(params, state, x)
        return (state, solver.dynamics_step(x, u0)), aux.costs[0]

    gens = () if solver.tick_fn is not None or solver.rollout_fn is not None else (
        solver.generator,)
    return Workload(name, body, params, solver.init(), x0, solver.cfg, n1, n2, 1, meta, gens)


def _flagship_workload(name, device, K, T, n1, n2, kernel) -> Workload:
    from .. import presets
    from ..solvers.mppi import MPPISolver

    cfg, params, step_fn, stage, terminal = presets.flagship(K, T, device)
    solver = MPPISolver(cfg, step_fn, stage, terminal, fused_tick=True, iso_xy=True,
                        device=device)
    return _mppi_workload(name, solver, params, torch.zeros(3, device=device), n1, n2,
                          {"K": K, "T": T, "kernel": kernel})


def _build_flagship(device) -> Workload:
    on_card = device.type == "cuda"
    K, T = (10_240, 50) if on_card else (512, 25)
    return _flagship_workload("flagship", device, K, T, *((200, 1000) if on_card else (4, 12)),
                              "diffdrive_mppi_tick")


def _build_pod_k(device) -> Workload:
    from ..solvers.mppi import _EPS_BYTES_PER_SAMPLE_STEP, _SINGLE_BLOCK_VMEM_BUDGET

    on_card = device.type == "cuda"
    K, T = (102_400, 50) if on_card else (1024, 25)
    blocked = _EPS_BYTES_PER_SAMPLE_STEP * T * K > _SINGLE_BLOCK_VMEM_BUDGET
    return _flagship_workload(
        "pod_k", device, K, T, *((25, 125) if on_card else (4, 12)),
        "diffdrive_mppi_tick_blocked" if blocked else "diffdrive_mppi_tick")


def _build_racecar(device) -> Workload:
    from .. import presets
    from ..paths import lemniscate_with_speed

    on_card = device.type == "cuda"
    K = 10_240 if on_card else 256
    ref = lemniscate_with_speed(10.0, 200, speed=5.0, device=device)
    solver, params = presets.racecar_mppi(
        ref, num_samples=K, horizon=20, obstacles=[[5.0, 5.0, 1.0], [7.0, 7.0, 1.0]],
        fused_tick=True, device=device)
    return _mppi_workload(
        "racecar", solver, params, ref[0].clone(), *((50, 250) if on_card else (2, 6)),
        {"K": K, "T": 20, "W": 200, "n_obs": 2, "kernel": "bicycle_mppi_tick"})


def _build_goal_seeking(device) -> Workload:
    from .. import presets

    on_card = device.type == "cuda"
    K = 1536 if on_card else 256
    solver, params = presets.goal_seeking_mppi(
        [6.0, 6.0, 1.57], num_samples=K,
        obstacles=[[5.0, 4.0, 0.5], [3.5, 3.5, 0.5], [2.0, 5.0, 0.5]],
        obstacle_velocities=0.09 * np.array([[0.2, 0.1], [-0.1, 0.1], [0.1, -0.2]]),
        fused_tick=True, device=device)
    return _mppi_workload(
        "goal_seeking", solver, params, torch.zeros(3, device=device),
        *((200, 1000) if on_card else (2, 6)),
        {"K": K, "T": solver.cfg.horizon, "n_obs": 3, "collision": "soft",
         "kernel": "diffdrive_mppi_tick"})


def _build_dnn_mppi(device) -> Workload:
    """The 5→128→128→3 residual MLP of JAX's row on the scan path. JAX's
    row initialises the net with Flax at ``PRNGKey(0)``, whose zero head
    makes the residual exactly 0; the card's host has no Flax, so the
    weights here come from ``np.random.default_rng(0)``
    (``models.learned.seeded_mlp_tree``, a small non-zero head) at the same
    widths."""
    from .. import presets
    from ..models.learned import MLP, load_flax_mlp, make_residual_fn, seeded_mlp_tree
    from ..paths import line

    on_card = device.type == "cuda"
    K = 1024 if on_card else 256
    net = load_flax_mlp(MLP(out_dim=3, hidden=128, depth=1, in_dim=5, device=device),
                        seeded_mlp_tree((5, 128, 128, 3), seed=0))
    ref = line([0.0, 0.0], [4.0, 4.0], num_points=100, device=device)
    solver, params = presets.dnn_mppi(ref, make_residual_fn(net), num_samples=K, horizon=25,
                                      device=device)
    return _mppi_workload(
        "dnn_mppi", solver, params, torch.zeros(3, device=device),
        *((50, 250) if on_card else (2, 6)),
        {"K": K, "T": 25, "net": "mlp_5_128_128_3", "kernel": "scan"})


def _fleet_workload(name, step, cfg, params, states, plant, B, n1, n2, meta, members=None
                    ) -> Workload:
    """A fleet chain; ``members`` (a slice) is the rank's part of a fleet
    split over ranks, whose other members the rank leaves as they are."""
    def body(params, st, x):
        u0s, new, auxs = step(params, st, x)
        if members is None:
            return (new, plant(x, u0s)), auxs.costs[:, 0]
        leaves = {}
        for f in dataclasses.fields(st):
            t = getattr(st, f.name).clone()
            t[members] = getattr(new, f.name)
            leaves[f.name] = t
        x_next = x.clone()
        x_next[members] = plant(x[members], u0s)
        return (dataclasses.replace(st, **leaves), x_next), auxs.costs[:, 0]

    x0 = torch.zeros((B, 3), device=params.ref_path.device)
    return Workload(name, body, params, states, x0, cfg, n1, n2, B, meta)


def _build_mppi_fleet(device) -> Workload:
    """``presets.mppi_fleet``: B unicycles, member b tracking its own line
    to a goal of ``default_rng(0)`` from key [0, b]."""
    from .. import presets

    on_card = device.type == "cuda"
    B, K, T = (16, 1024, 50) if on_card else (4, 128, 10)
    step, params, states, plant = presets.mppi_fleet(B, K, T, device=device)
    return _fleet_workload("mppi_fleet", step, step.cfg, params, states, plant, B,
                           *((50, 250) if on_card else (2, 6)),
                           {"B": B, "K": K, "T": T, "kernel": "fleet_mppi_tick"})


def _nmpc_workload(name, solve, plant, params, st0, x0, n1, n2, solves_per_tick, cfg, meta
                   ) -> Workload:
    def body(params, st, x):
        u0, st, _ = solve(params, st, x)
        return (st, plant(x, u0)), u0.reshape(-1)[0]  # u0[0] or a fleet's u0[0, 0]

    return Workload(name, body, params, st0, x0, cfg, n1, n2, solves_per_tick, meta)


def _build_nmpc_rti(device) -> Workload:
    from .. import presets

    on_card = device.type == "cuda"
    solver, params = presets.diff_drive_nmpc(
        [3.0, 2.0, 0.0], N=30, obstacles=[[1.5, 1.0, 0.3], [2.5, 1.8, 0.3]], sqp_iters=1,
        qp_backend="kernel", device=device)
    x0 = torch.zeros(3, device=device)
    return _nmpc_workload(
        "nmpc_rti", solver.solve, solver.dyn_step, params, solver.init(x0), x0,
        *((30, 150) if on_card else (2, 6)), 1, solver.cfg,
        {"N": 30, "n_obs": 2, "sqp_iters": 1, "qp_backend": "kernel",
         "kernel": "fused_barrier_qp_solve"})


def _build_nmpc_fleet(device) -> Workload:
    """JAX's row: ``presets.nmpc_fleet`` at its preset defaults
    (``sqp_iters=2``), one batched QP launch an SQP iteration."""
    from .. import presets

    on_card = device.type == "cuda"
    B, N = (128, 30) if on_card else (8, 10)
    solver, params, states, x0s = presets.nmpc_fleet(B, N, qp_backend="kernel", device=device)
    return _nmpc_workload(
        "nmpc_fleet", solver.batched_solve(), solver.dyn_step, params, states, x0s,
        *((10, 50) if on_card else (2, 6)), B, solver.cfg,
        {"B": B, "N": N, "qp_backend": "kernel", "kernel": "batched_fused_barrier_qp_solve"})


def _world(device) -> int:
    """The default process group's size, joining a one-process group
    (NCCL on the card, gloo on the CPU) when there is none."""
    from ..parallel import initialize_distributed

    return initialize_distributed(device)[1]


def _build_sharded_tick(device) -> Workload:
    """The flagship's K split over the ranks of the default group
    (``parallel.make_sharded_fused_mppi_step``: the K-blocked tick's
    ``s_only`` rollout, three all-reduces, ``weighted_noise_reduce``). At
    one rank a card this is JAX's one-shard A/B: the sharded wrapper and
    its collectives at group size 1. As in JAX's row, x[0] moves by
    1e-6·u0[0] a tick, so a tick depends on the one before."""
    from .. import presets
    from ..parallel import make_sharded_fused_mppi_step
    from ..solvers.mppi import MPPIState

    on_card = device.type == "cuda"
    n = _world(device)
    K, T = (10_240 * n, 50) if on_card else (1024 * n, 25)
    cfg, params, step_fn, _, _ = presets.flagship(K, T, device)
    step = make_sharded_fused_mppi_step(cfg, step_fn, iso_xy=True, device=device)

    def body(params, state, x):
        u0, state, aux = step(params, state, x)
        x_next = x.clone()
        x_next[:1] += u0[:1] * 1e-6
        return (state, x_next), aux.costs.min()

    return Workload(
        "sharded_tick", body, params, MPPIState.init(cfg, device=device),
        torch.zeros(3, device=device), cfg, *((200, 1000) if on_card else (2, 6)), 1,
        {"K": K, "T": T, "devices": n,
         "kernel": "diffdrive_mppi_tick_blocked s_only + weighted_noise_reduce"})


def _build_sharded_mppi_fleet(device) -> Workload:
    """The fleet split over the ranks of the default group
    (``parallel.make_sharded_mppi_fleet``, the fleet tick on each rank's
    members, no collectives). Each rank advances its own members."""
    from .. import presets
    from ..parallel import make_sharded_mppi_fleet

    on_card = device.type == "cuda"
    n = _world(device)
    B, K, T = (16 * n, 1024, 50) if on_card else (n, 128, 10)
    fleet_step, params, states, plant = presets.mppi_fleet(B, K, T, device=device)
    step = make_sharded_mppi_fleet(fleet_step.cfg, plant, fused=True, device=device)
    return _fleet_workload("sharded_mppi_fleet", step, fleet_step.cfg, params, states, plant, B,
                           *((50, 250) if on_card else (2, 6)),
                           {"B": B, "K": K, "T": T, "devices": n, "kernel": "fleet_mppi_tick"},
                           members=step.members(B))


_BUILDERS = {
    "flagship": _build_flagship,
    "pod_k": _build_pod_k,
    "racecar": _build_racecar,
    "goal_seeking": _build_goal_seeking,
    "mppi_fleet": _build_mppi_fleet,
    "dnn_mppi": _build_dnn_mppi,
    "nmpc_rti": _build_nmpc_rti,
    "nmpc_fleet": _build_nmpc_fleet,
    "sharded_tick": _build_sharded_tick,
    "sharded_mppi_fleet": _build_sharded_mppi_fleet,
}


def build(name: str, device="cuda") -> Workload:
    """Row ``name``'s workload on ``device`` (the card unless the caller
    passes ``device="cpu"``)."""
    if name not in _BUILDERS:
        raise ValueError(f"unknown suite rows {[name]}; available: {list(ROWS)}")
    return _BUILDERS[name](resolve_device(device))


def run_suite(rows: Optional[Sequence[str]] = None, reps: Optional[int] = None,
              artifact: Optional[str] = None, device="cuda") -> list:
    """Time the selected rows (all by default); print one JSON line each and
    return the rows. ``reps`` timed chains a length (default 10 on the card,
    3 on the CPU), after one warm-up each. A run of every row on the card
    also writes ``artifact`` (default ``docs/assets/cuda_bench_suite.json``):
    the rows, the card's name and power limit and the chaining. A run on
    the CPU or of some rows writes nothing. A one-process group made for
    the sharded rows is destroyed at the end."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if reps is None:
        reps = 10 if on_card else 3
    names = ROWS if rows is None else tuple(rows)
    unknown = [n for n in names if n not in _BUILDERS]
    if unknown:
        raise ValueError(f"unknown suite rows {unknown}; available: {list(ROWS)}")

    had_group = dist.is_available() and dist.is_initialized()
    results = []
    try:
        for name in names:
            w = _BUILDERS[name](device)
            t = slope_timing(w.make_runner, w.n1, w.n2, reps,
                             wall=cuda_event_wall if on_card else host_wall)
            # a jitter-inverted slope is floored at 1e-9 s; a floored tau
            # would read as billions of solves a second: take p50, say so
            floored = t.tau <= 2e-9
            per_tick = t.p50 if floored else t.tau
            row = {
                "workload": name,
                "per_tick_ms_best": round(t.tau * 1e3, 4),
                "per_tick_ms_p50": round(t.p50 * 1e3, 4),
                "per_tick_ms_p99": round(t.p99 * 1e3, 4),
                "solves_per_s": round(w.solves_per_tick / max(per_tick, 1e-9), 1),
                "chain_lengths": [w.n1, w.n2],
                **w.meta,
                "chain": "cuda_graph" if on_card else "eager",
            }
            if floored:
                row["slope_floored"] = True
            if not on_card:
                row["cpu_smoke"] = True  # smoke shapes: not a measurement
            results.append(row)
            print(json.dumps(row), flush=True)
            del w, t  # the graphs and their pools go with the row
            if on_card:
                torch.cuda.empty_cache()
    finally:
        if not had_group and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()

    if on_card and rows is None:
        from ..runtime.realtime_bench import card_name

        artifact = ARTIFACT if artifact is None else artifact
        out = {"device": card_name(), "rows": results,
               "chain": "one tick captured as a CUDA graph, replayed n times; slope of "
                        "CUDA-event walls over two chain lengths (utils/benchtime.py)"}
        with open(artifact, "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"# wrote {artifact}", flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=None, help="comma-separated rows (default: all)")
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--artifact", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run_suite(rows=None if args.rows is None else tuple(args.rows.split(",")),
                     reps=args.reps, artifact=args.artifact, device=args.device)


__all__ = ["ARTIFACT", "ROWS", "Workload", "build", "run_suite"]


if __name__ == "__main__":
    main()
