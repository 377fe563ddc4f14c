#!/usr/bin/env python3
"""Time the fused QP kernel on the NMPC main paths' own QPs, on the card.

A measuring script, not part of the package. It imports the
``dnn_mppi_mpc_tpu_torch`` of the tree it lies in, so two versions of the
kernel are compared by running each tree's copy in one call, in turns
(a, b, b, a). The QPs are caught at the SQP engine's call:

* nmpc_rti's first tick from x0 = 0 (a cold start: many right-hand sides
  of the back substitution are exact zeros) and its tenth tick;
* the four-wheel IRK NMPC's first QP ((5, 4), N = 20, 10 iterations);
* nmpc_fleet's first QP (B = 128);
* the three main-path loops as ``chip_smoke.py`` drives them: nmpc_rti
  (100 ticks from x0 = 0, 100 QPs), the four-wheel IRK (80 ticks, 160 QPs)
  and nmpc_fleet (60 ticks, 120 QPs); each loop's QPs are replayed back to
  back, so that the profile holds only QP kernels, and the device time a
  QP averaged over the loop is what the loop pays.

Each single QP is held against the plain version (``_qp_plain``) and must
agree within 1e-5 (``chip_smoke.py``'s ``TOL["dX"]``); the variants of one
run must agree with each other exactly. Run from anywhere:

    python tools/qp_time.py [--calls 30] [--variants JSON]

``--variants`` is a JSON list of keyword-argument sets for
``ops/cuda/riccati_qp._launch``, each timed in turns (default ``[{}]``,
the launch as the wrappers make it); a set may only name arguments that
the tree's ``_launch`` takes. Device time comes from the profiler. Prints
the card's name and power limit, then one JSON line a QP and variant;
exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dnn_mppi_mpc_tpu_torch import presets  # noqa: E402
from dnn_mppi_mpc_tpu_torch.ops.cuda import riccati_qp as rq  # noqa: E402
from dnn_mppi_mpc_tpu_torch.solvers import sqp  # noqa: E402

KERNEL = "barrier_qp_kernel"
DEFAULTS = dict(num_iters=12, mu0=1e-1, kappa=0.35, delta=1e-3, stiffness=None,
                h_stiffness=None, h_slope=0.0)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def caught(name: str, run) -> list:
    """[(qp, dx0, kw)] of every call of ``sqp.<name>`` while ``run()`` runs."""
    real, seen = getattr(sqp, name), []

    def spy(qp, dx0, **kw):
        seen.append((qp, dx0, kw))
        return real(qp, dx0, **kw)

    setattr(sqp, name, spy)
    try:
        run()
    finally:
        setattr(sqp, name, real)
    return seen


def closed_loop(solve, params, state, x, plant, ticks: int) -> None:
    for _ in range(ticks):
        u0, state, _ = solve(params, state, x)
        x = plant(x, u0)


def main_path_qps(dev) -> dict:
    rti, rti_params = presets.diff_drive_nmpc([3.0, 2.0, 0.0], N=30,
                                              obstacles=[[1.5, 1.0, 0.3], [2.5, 1.8, 0.3]],
                                              sqp_iters=1, qp_backend="kernel", device=dev)
    x = torch.zeros(3, device=dev)
    rti_loop = caught("fused_barrier_qp_solve", lambda: closed_loop(
        rti.solve, rti_params, rti.init(x), x, rti.dyn_step, 100))
    wheel, wheel_params = presets.four_wheel_nmpc([1.0, 0.5, 0.0, 0.0, 0.0], N=20, sqp_iters=2,
                                                  qp_iters=10, qp_backend="kernel", device=dev)
    x = torch.zeros(5, device=dev)
    wheel_loop = caught("fused_barrier_qp_solve", lambda: closed_loop(
        wheel.solve, wheel_params, wheel.init(x), x, wheel.dyn_step, 80))
    fleet, fleet_params, states, x0s = presets.nmpc_fleet(device=dev)
    fleet_loop = caught("batched_fused_barrier_qp_solve", lambda: closed_loop(
        fleet.batched_solve(), fleet_params, states, x0s, fleet.dyn_step, 60))
    return {"nmpc_rti tick 1 QP": rti_loop[:1], "nmpc_rti tick 10 QP": rti_loop[9:10],
            "four_wheel irk tick 1 QP": wheel_loop[:1], "nmpc_fleet tick 1 QP": fleet_loop[:1],
            "nmpc_rti loop, 100 ticks": rti_loop, "four_wheel irk loop, 80 ticks": wheel_loop,
            "nmpc_fleet loop, 60 ticks": fleet_loop}


def prepared(qp, dx0, kw):
    leaves, x0, B, _ = rq.batch_leaves(qp, dx0, torch.float32)
    return leaves, x0, B, dict(DEFAULTS, **kw)


def device_us(fn, calls: int, per_call: int) -> float:
    """Device µs a QP kernel of ``fn`` (which launches ``per_call``), from the
    profiler; the profile opens with sleep kernels, as CUPTI can miss its
    first records, and is taken again with more if it holds too few."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8 * 4 ** attempt):
                torch.cuda._sleep(200_000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and KERNEL in e.name]
        if len(times) == calls * per_call:
            return sum(times) / len(times)
    raise RuntimeError(f"the profiler kept {len(times)} of {calls * per_call} QP kernels")


def measure(label: str, qps: list, variants: list, calls: int, card: str) -> None:
    runs = [prepared(*q) for q in qps]

    def launch_all(variant):
        return [rq._launch(leaves, x0, B, **kw, **variant) for leaves, x0, B, kw in runs]

    times = {i: [] for i in range(len(variants))}
    order = list(range(len(variants)))
    for i in order + order[::-1]:
        times[i].append(device_us(lambda: launch_all(variants[i]), max(1, calls // len(runs)),
                                  len(runs)))
    first = None
    leaves, x0, B, kw = runs[0]
    for i, variant in enumerate(variants):
        outs = launch_all(variant)
        first = first or outs
        diff = max(float((o - f).abs().max()) for out, fo in zip(outs, first)
                   for o, f in zip(out, fo))
        finite = all(bool(torch.isfinite(o).all()) for out in outs for o in out)
        err = None
        if len(runs) == 1:
            mus, misc = rq.qp_schedule(kw["num_iters"], kw["mu0"], kw["kappa"], kw["delta"],
                                       kw["stiffness"], kw["h_stiffness"], kw["h_slope"],
                                       x0.device)
            plain = rq._qp_plain(leaves, x0, mus, misc, kw["num_iters"])
            err = max(float((o - p).abs().max()) for o, p in zip(outs[0], plain))
        emit({"qp": label, "variant": variant, "qps": len(runs), "B": B,
              "N": leaves["A"].shape[1], "nx": leaves["A"].shape[2], "nu": leaves["B"].shape[3],
              "n_h": 0 if leaves["Jh"] is None else leaves["Jh"].shape[2],
              "S": leaves["S"] is not None, "iters": kw["num_iters"],
              "device_us_runs": times[i], "device_us": min(times[i]),
              "max_abs_err_vs_plain": err, "max_abs_diff_vs_first_variant": diff,
              "card": card})
        if diff != 0.0 or not finite or not (err is None or err <= 1e-5):
            raise AssertionError(f"{label} {variant}: {diff} from the first variant, "
                                 f"{err} from the plain version, finite {finite}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--variants", default="[{}]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qp_time: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    variants = json.loads(args.variants)
    for label, qps in main_path_qps(torch.device("cuda", 0)).items():
        measure(label, qps, variants, args.calls if len(qps) == 1 else len(qps) * 3, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
