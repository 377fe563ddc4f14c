"""Command-line interface: ``python -m dnn_mppi_mpc_tpu_torch <command>``
(counterpart of ``dnn_mppi_mpc_tpu/cli.py``).

One typed entry point over the preset layer, in place of the reference's
``if __name__ == "__main__"`` scripts with hard-coded constants:

    python -m dnn_mppi_mpc_tpu_torch info
    python -m dnn_mppi_mpc_tpu_torch demo diff-drive-mppi --ticks 300 --lookahead --fused
    python -m dnn_mppi_mpc_tpu_torch demo racecar-nmpc --ticks 100
    python -m dnn_mppi_mpc_tpu_torch bench --k 10240 --t 50
    python -m dnn_mppi_mpc_tpu_torch collect --series 8 --ticks 200 --out data.npz
    python -m dnn_mppi_mpc_tpu_torch train --data data.npz --model mlp --ckpt state.pt
    python -m dnn_mppi_mpc_tpu_torch realtime --ticks 1000

Every command prints one machine-readable JSON line as its last stdout line
(progress goes to stderr). Each runs on the card (``--device cuda``, the
default) and raises without one unless given ``--device cpu``, where the
kernels' plain versions run. ``--fused`` binds the hand-written CUDA ticks
(the diff-drive or race-car fused tick; for the NMPC demos the fused QP
kernel) and needs the card. ``demo --out DIR`` writes the trajectory and
control plots as PNGs (``utils/plotting.py``, matplotlib's Agg backend); on
a host without matplotlib it raises ``ImportError`` before the demo runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import __version__


def _emit(payload: dict) -> None:
    print(json.dumps(payload), flush=True)


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device(args: argparse.Namespace) -> torch.device:
    """The command's device; a card that is not there raises, naming
    ``--device cpu``."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device is available — pass --device cpu to run "
            "the kernels' plain versions on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if getattr(args, "fused", False) and dev.type != "cuda":
        raise RuntimeError("--fused binds the hand-written CUDA kernels and needs the card: "
                           "drop --fused for --device cpu")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# info


def cmd_info(args: argparse.Namespace) -> None:
    dev = _device(args)
    on_card = dev.type == "cuda"
    names = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
             if on_card else ["cpu"])
    _emit({
        "version": __version__,
        "backend": "cuda" if on_card else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": names,
        "device_count": len(names),
        "demos": sorted(_DEMOS),
        "commands": ["info", "demo", "bench", "collect", "train", "realtime"],
    })


# ---------------------------------------------------------------------------
# demo


def _line_path(dev, n: int = 200) -> torch.Tensor:
    from .paths.generators import line

    return line([0.0, 0.0], [8.0, -4.0], n, device=dev)


def _demo_diff_drive_mppi(args, dev):
    from . import presets

    obstacles = [[3.0, -1.0, 0.8], [5.5, -3.0, 0.8]] if args.obstacles else None
    lookahead = dict(waypoint_carry="rollout", waypoint_persist="max") if args.lookahead else {}
    solver, params = presets.diff_drive_mppi(
        _line_path(dev), num_samples=args.samples, horizon=args.horizon, obstacles=obstacles,
        fused_tick=args.fused, compute_optimal_traj=False, device=dev, **lookahead)
    return solver, params, "mppi", torch.zeros(3, device=dev), obstacles


def _demo_racecar_mppi(args, dev):
    from . import presets
    from .paths.generators import circle_with_speed

    ref = circle_with_speed(radius=20.0, speed=5.0, num_points=400, device=dev)
    solver, params = presets.racecar_mppi(
        ref, num_samples=args.samples, horizon=max(args.horizon, 20), fused_tick=args.fused,
        compute_optimal_traj=False, device=dev)
    x0 = torch.tensor([20.0, 0.0, float(np.float32(np.pi / 2)), 2.0], device=dev)
    return solver, params, "mppi", x0, None


def _demo_goal_seeking_mppi(args, dev):
    from . import presets

    solver, params = presets.goal_seeking_mppi(
        [6.0, 6.0, 0.0], num_samples=args.samples, horizon=max(args.horizon, 25),
        fused_tick=args.fused, device=dev)
    return solver, params, "mppi", torch.zeros(3, device=dev), params.obstacles


def _nmpc_backend(args) -> dict:
    """``--fused`` on an NMPC demo: the fused barrier-Riccati QP kernel."""
    return dict(qp_backend="kernel") if args.fused else {}


def _demo_diff_drive_nmpc(args, dev):
    from . import presets

    obstacles = [[2.0, 1.2, 0.7]] if args.obstacles else None
    solver, params = presets.diff_drive_nmpc([4.0, 2.5, 0.0], obstacles=obstacles, device=dev,
                                             **_nmpc_backend(args))
    return solver, params, "nmpc", torch.zeros(3, device=dev), obstacles


def _demo_racecar_nmpc(args, dev):
    from . import presets

    solver, params = presets.racecar_nmpc([5.0, 3.0, 0.0, 0.0], device=dev,
                                          **_nmpc_backend(args))
    return solver, params, "nmpc", torch.zeros(4, device=dev), None


def _demo_four_wheel_nmpc(args, dev):
    from . import presets

    solver, params = presets.four_wheel_nmpc([2.0, 1.0, 0.0, 0.0, 0.0], device=dev,
                                             **_nmpc_backend(args))
    return solver, params, "nmpc", torch.zeros(5, device=dev), None


_DEMOS = {
    "diff-drive-mppi": _demo_diff_drive_mppi,
    "racecar-mppi": _demo_racecar_mppi,
    "goal-seeking-mppi": _demo_goal_seeking_mppi,
    "diff-drive-nmpc": _demo_diff_drive_nmpc,
    "racecar-nmpc": _demo_racecar_nmpc,
    "four-wheel-nmpc": _demo_four_wheel_nmpc,
}


def cmd_demo(args: argparse.Namespace) -> None:
    """A closed-loop demo through ``run_closed_loop``: the controller's
    first tick runs once before the timed episode (the kernels' build and
    first launches), then ``--ticks`` ticks of controller and plant; with
    ``--out`` the trajectory and control plots of the episode as PNGs."""
    from .envs.closed_loop import mppi_controller, nmpc_controller, run_closed_loop

    if args.out:
        # needs matplotlib: without it this raises, before the demo runs
        from .utils.plotting import plot_controls, plot_trajectory
    if args.lookahead and args.name != "diff-drive-mppi":
        raise RuntimeError("--lookahead is the diff-drive-mppi demo's option")
    dev = _device(args)
    solver, params, kind, x0, obstacles = _DEMOS[args.name](args, dev)
    dt = float(solver.cfg.dt)
    if kind == "mppi":
        controller = mppi_controller(solver, params)
        cs0 = solver.init([0, args.seed])
        plant = solver.dynamics_step
        ref_path = params.ref_path.cpu().numpy()
        # goal distance fits an open course or a goal pose (one row); a
        # circle's end is its start: cross-track error is its measure
        target = None
        if len(ref_path) == 1 or np.linalg.norm(ref_path[0, :2] - ref_path[-1, :2]) > 1e-3:
            target = ref_path[-1, :2]
    else:
        controller = nmpc_controller(solver, params)
        cs0 = solver.init(x0)
        plant = solver.dyn_step
        ref_path = None
        target = params.yref_e[:2].cpu().numpy()

    controller(cs0, x0)  # build, first launches
    _sync(dev)
    t0 = time.perf_counter()
    episode, _ = run_closed_loop(controller, plant, cs0, x0, args.ticks)
    _sync(dev)
    wall = time.perf_counter() - t0

    states = episode.states.cpu().numpy()
    controls = episode.controls.cpu().numpy()
    start_err = final_err = None
    if target is not None:
        start_err = float(np.linalg.norm(states[0, :2] - target))
        final_err = float(np.linalg.norm(states[-1, :2] - target))
    cross_track = None
    if ref_path is not None:
        d = np.linalg.norm(ref_path[None, :, :2] - states[:, None, :2], axis=-1)
        cross_track = float(d.min(axis=1).max())  # the worst nearest-path distance
    artifacts = []
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        traj_png = os.path.join(args.out, f"{args.name}_trajectory.png")
        ctrl_png = os.path.join(args.out, f"{args.name}_controls.png")
        if isinstance(obstacles, torch.Tensor):
            obstacles = obstacles.cpu().numpy()
        plot_trajectory(traj_png, states, ref_path=ref_path, obstacles=obstacles,
                        title=args.name)
        plot_controls(ctrl_png, controls, dt)
        artifacts = [traj_png, ctrl_png]
        _say(f"wrote {traj_png}, {ctrl_png}")
    _emit({
        "demo": args.name,
        "kind": kind,
        "ticks": args.ticks,
        "dt": dt,
        "device": str(dev),
        "fused": bool(args.fused),
        "lookahead": bool(args.lookahead),
        "goal_distance_start_m": start_err,
        "goal_distance_final_m": final_err,
        "cross_track_error_max_m": cross_track,
        "mean_speed": float(np.abs(controls[:, 0]).mean()),
        "wall_s": wall,
        "ticks_per_s": args.ticks / wall,
        "realtime_factor": args.ticks * dt / wall,
        "finite": bool(np.isfinite(states).all()),
        "artifacts": artifacts,
    })


# ---------------------------------------------------------------------------
# bench


def _host_wall(run) -> float:
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def cmd_bench(args: argparse.Namespace) -> None:
    """Ticks a second by the two-chain slope (``utils/benchtime.py``) over
    eager ticks + plant steps of ``presets.diff_drive_mppi`` at (K, T): the
    fused tick on the card (CUDA-event walls), the scan path on the CPU (K
    at most 1 024, host walls)."""
    from . import presets
    from .utils.benchtime import cuda_event_wall, slope_timing

    dev = _device(args)
    on_card = dev.type == "cuda"
    K = args.k if on_card else min(args.k, 1024)
    solver, params = presets.diff_drive_mppi(
        _line_path(dev), num_samples=K, horizon=args.t, dt=0.02, fused_tick=on_card,
        iso_xy=on_card, compute_optimal_traj=False, device=dev)
    step_fn = solver.dynamics_step

    def make_runner(n):
        def run():
            state, x = solver.init(), torch.zeros(3, device=dev)
            for _ in range(n):
                u0, state, _ = solver.step(params, state, x)
                x = step_fn(x, u0)
        return run

    n1, n2 = (20, 100) if on_card else (2, 6)
    timing = slope_timing(make_runner, n1, n2, reps=5 if on_card else 2,
                          wall=cuda_event_wall if on_card else _host_wall)
    _emit({
        "metric": f"mppi_solves_per_s_K{solver.cfg.num_samples}_T{args.t}",
        "value": timing.ticks_per_s,
        "unit": "solves/s",
        "per_solve_ms_best": timing.tau * 1e3,
        "p50_ms": timing.p50 * 1e3,
        "p99_ms": timing.p99 * 1e3,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "cuda_fused_tick": on_card,
        "chain": "eager ticks",
    })


# ---------------------------------------------------------------------------
# collect


def collect_problem(device, samples: int = 512, horizon: int = 20, dt: float = 0.05):
    """The collect command's protocol (the reference's collect_data_series,
    train/bullet_mpc_differential_drive.py:119-157): (controller factory,
    plant, nominal step, x0 sampler) for ``collect_residual_dataset``. The
    controller is the fused tick (K ``samples``, rounded up to a multiple
    of 128; T, dt; the default config) tracking a 100-point line from a
    random start in [−3, 3]² to a random goal in [−8, 8]²; the plant, which
    the nominal model gets wrong, executes 0.85·v and 0.9·ω + 0.05·v. A
    series draws everything on ``device`` from its generators."""
    from .config import MPPIConfig, params_from_numpy
    from .envs.closed_loop import mppi_controller
    from .models import euler_step, unicycle
    from .presets import _lane_rounded_samples
    from .solvers.mppi import MPPISolver, make_tracking_costs

    cfg = MPPIConfig(num_samples=_lane_rounded_samples(samples), horizon=horizon, dim_x=3,
                     dim_u=2, dt=dt, compute_optimal_traj=False)

    def nominal(x, u):
        return euler_step(unicycle, x, u, dt)

    def plant(x, u):
        u_eff = torch.stack([0.85 * u[..., 0], 0.9 * u[..., 1] + 0.05 * u[..., 0]], -1)
        return euler_step(unicycle, x, u_eff, dt)

    solver = MPPISolver(cfg, nominal, *make_tracking_costs(cfg), fused_tick=True, device=device)
    base = params_from_numpy(sigma=[[0.1, 0.0], [0.0, 0.05]], stage_weight=[5.0, 5.0, 2.0],
                             terminal_weight=[5.0, 5.0, 2.0], u_min=[-3.0, -3.14],
                             u_max=[3.0, 3.14], ref_path=np.zeros((100, 3)), device=device)
    s = torch.linspace(0.0, 1.0, 100, device=solver.device)[:, None]

    def controller_factory(gen):
        dev = solver.device
        start = torch.rand(2, generator=gen, device=dev) * 6.0 - 3.0
        goal = torch.rand(2, generator=gen, device=dev) * 16.0 - 8.0
        d = goal - start
        yaw = torch.atan2(d[1], d[0]).expand(100, 1)
        params = dataclasses.replace(base, ref_path=torch.cat([start + s * d, yaw], dim=1))
        key = torch.randint(0, 2**32, (2,), generator=gen, device=dev)
        return mppi_controller(solver, params), solver.init(key)

    def x0_sampler(gen):
        xy = torch.rand(2, generator=gen, device=solver.device) * 6.0 - 3.0
        return torch.cat([xy, torch.zeros(1, device=solver.device)])

    return controller_factory, plant, nominal, x0_sampler


def cmd_collect(args: argparse.Namespace) -> None:
    """Randomized-series residual-dataset collection → .npz (states,
    controls, errors: the layout of the reference's saved_data/*_diff.npy)."""
    from .envs.closed_loop import collect_residual_dataset

    dev = _device(args)
    factory, plant, nominal, sampler = collect_problem(dev, args.samples)
    t0 = time.perf_counter()
    ep = collect_residual_dataset(factory, plant, nominal, sampler, args.seed, args.series,
                                  args.ticks, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    states, controls, errors = (t.cpu().numpy() for t in ep)
    np.savez(args.out, states=states, controls=controls, errors=errors)
    _emit({
        "out": args.out,
        "series": args.series,
        "ticks_per_series": args.ticks,
        "rows": int(states.shape[0]),
        "mean_abs_residual": float(np.abs(errors).mean()),
        "device": str(dev),
        "wall_s": wall,
    })


# ---------------------------------------------------------------------------
# train


def cmd_train(args: argparse.Namespace) -> None:
    """``train_residual_model`` on a collected .npz; ``--ckpt`` saves the
    full train state (params, optimizer, scalers) with ``save_checkpoint``."""
    from .models.learned import MLP, ResNet1D
    from .train.checkpoint import save_checkpoint, train_state_tree
    from .train.training import TrainConfig, train_residual_model

    dev = _device(args)
    data = np.load(args.data)
    states, controls, errors = (torch.tensor(data[k], dtype=torch.float32, device=dev)
                                for k in ("states", "controls", "errors"))
    out_dim = errors.shape[-1]
    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "mlp":
        model = MLP(out_dim=out_dim, hidden=args.hidden, depth=args.depth, device=dev,
                    generator=gen)
    else:
        model = ResNet1D(out_dim=out_dim, variant=args.model[len("resnet"):], device=dev,
                         generator=gen)
    t0 = time.perf_counter()
    state, hist = train_residual_model(
        model, states, controls, errors,
        TrainConfig(num_epochs=args.epochs, batch_size=args.batch, seed=args.seed))
    _sync(dev)
    wall = time.perf_counter() - t0
    if args.ckpt:
        save_checkpoint(args.ckpt, train_state_tree(state))
    _emit({
        "model": args.model,
        "rows": int(states.shape[0]),
        "epochs": args.epochs,
        "final_train_mse": float(hist["train_mse"][-1]),
        "final_val_mse": float(hist["val_mse"][-1]),
        "final_val_mae": float(hist["val_mae"][-1]),
        "checkpoint": args.ckpt,
        "device": str(dev),
        "wall_s": wall,
    })


# ---------------------------------------------------------------------------
# realtime


def cmd_realtime(args: argparse.Namespace) -> None:
    """The real-time loop's measurement (``runtime/realtime_bench.py``)."""
    from .runtime.realtime_bench import main as realtime_main

    _device(args)
    argv = ["--hz", str(args.hz), "--ticks", str(args.ticks), "--k", str(args.k),
            "--t", str(args.t), "--device", args.device]
    if args.no_fused_plant:
        argv.append("--no-fused-plant")
    if args.json_out:
        argv += ["--json-out", args.json_out]
    realtime_main(argv)


# ---------------------------------------------------------------------------
# parser


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dnn_mppi_mpc_tpu_torch",
                                 description="MPPI / NMPC on the card: the CLI")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    sub = ap.add_subparsers(dest="command", required=True)

    sub.add_parser("info", parents=[common], help="version, backend, card, demos"
                   ).set_defaults(fn=cmd_info)

    d = sub.add_parser("demo", parents=[common], help="run a closed-loop controller demo")
    d.add_argument("name", choices=sorted(_DEMOS))
    d.add_argument("--ticks", type=int, default=200)
    d.add_argument("--samples", type=int, default=1024, help="MPPI rollouts K")
    d.add_argument("--horizon", type=int, default=10)
    d.add_argument("--obstacles", action="store_true")
    d.add_argument("--fused", action="store_true",
                   help="the CUDA fused tick (MPPI) or the fused QP kernel (NMPC); needs the card")
    d.add_argument("--lookahead", action="store_true",
                   help="diff-drive-mppi only: waypoint_carry='rollout' + persist='max', the "
                   "pure form of the reference's stateful waypoint lookup (scan path, or the "
                   "fused tick with --fused)")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--out", default=None,
                   help="directory for the trajectory and control plots (PNG; needs "
                        "matplotlib)")
    d.set_defaults(fn=cmd_demo)

    b = sub.add_parser("bench", parents=[common], help="slope-estimated MPPI solves/s")
    b.add_argument("--k", type=int, default=10240)
    b.add_argument("--t", type=int, default=50)
    b.set_defaults(fn=cmd_bench)

    c = sub.add_parser("collect", parents=[common],
                       help="randomized-series residual dataset → .npz")
    c.add_argument("--series", type=int, default=8)
    c.add_argument("--ticks", type=int, default=200)
    c.add_argument("--samples", type=int, default=512, help="MPPI rollouts K")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--out", default="residual_dataset.npz")
    c.set_defaults(fn=cmd_collect)

    r = sub.add_parser("realtime", parents=[common],
                       help="paced pacer → tick → plant loop (runtime/realtime_bench.py)")
    r.add_argument("--hz", type=float, default=50.0)
    r.add_argument("--ticks", type=int, default=10_000)
    r.add_argument("--k", type=int, default=10_240)
    r.add_argument("--t", type=int, default=50)
    r.add_argument("--no-fused-plant", action="store_true",
                   help="an eager tick and a separate plant step instead of one CUDA graph")
    r.add_argument("--json-out", type=str, default=None)
    r.set_defaults(fn=cmd_realtime)

    t = sub.add_parser("train", parents=[common],
                       help="train a residual model from a collected .npz")
    t.add_argument("--data", required=True)
    t.add_argument("--model", default="mlp", choices=["mlp", "resnet18", "resnet50"])
    t.add_argument("--hidden", type=int, default=512)
    t.add_argument("--depth", type=int, default=2)
    t.add_argument("--epochs", type=int, default=50)
    t.add_argument("--batch", type=int, default=256)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--ckpt", default=None, help="file for the full train state (torch.save)")
    t.set_defaults(fn=cmd_train)
    return ap


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()


__all__ = ["build_parser", "collect_problem", "main"]
