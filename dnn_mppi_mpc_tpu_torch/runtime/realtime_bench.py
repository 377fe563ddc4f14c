"""One-process end-to-end real-time pipeline measurement (counterpart of
``dnn_mppi_mpc_tpu/runtime/realtime_bench.py``).

A single process drives

    native RatePacer (absolute deadlines, runtime/src/dmmrt.cpp)
      → flagship MPPI tick (the fused CUDA tick on the card, the scan path
        on the CPU)
      → plant step (the unicycle's Euler step, the simulator's role)

for N ticks at a fixed rate, recording per-tick host cost and per-deadline
lateness — not chain slopes (a slope averages the per-tick tails away; this
module does the opposite). It replaces the reference's deployment loop
simulation/bullet_differential_drive_dnn.py:419-467 (read state → solve →
actuate → sleep).

``fused_plant=True`` (the counterpart of JAX's one donated dispatch a tick)
captures tick + plant once as one CUDA graph (:class:`GraphedTick`) and
replays it each tick: the carried state — the nominal controls, the key the
tick seed is drawn from, the waypoint index — and the plant's x live in
static buffers that each replay advances in place. A capture that fails
raises; nothing falls back to eager ticks. ``fused_plant=False`` runs the
eager tick and a separate plant step. On the CPU (the tests) CUDA graphs do
not exist: the fused form runs the same tick + plant body eagerly.

What the output measures:

* ``ack_p*``, ``late_*``, ``misses_per_10k``: the host loop — the pacer's
  wake-up discipline and each tick's cost from the call to the CUDA event
  recorded after it (the controller waits on that event);
* ``device_pace``: a ``torch.profiler`` (CUPTI) trace of a short paced
  segment: the ticks that ran on the device (one rollout kernel each), their
  spacing, and each tick's device busy time (``device_tick_us``) and share
  of the period.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from ..solvers.mppi import MPPISolver, MPPIState
from ..utils.benchtime import ChainGraph

# the kernel every fused tick launches once: its launches count the ticks
TICK_KERNEL = "rollout_kernel"
# paced ticks in the profiled segment (fewer when the run has fewer)
PACE_TICKS = 200


class GraphedTick(ChainGraph):
    """One MPPI tick and one plant step, captured once as a CUDA graph: a
    :class:`..utils.benchtime.ChainGraph` whose tick is ``solver.step`` and
    then ``step_fn``. The real-time loop holds a solver and a plant step,
    not a ``body``; this class makes its tick from them in one place. Every
    :meth:`replay` advances ``self.state`` (u_prev, waypoint_idx, key) and
    ``self.x`` in place and returns u0 (``self.y``); on the CPU it runs the
    same body eagerly."""

    def __init__(self, solver: MPPISolver, params, step_fn, state: MPPIState, x: torch.Tensor):
        def body(params, st, x):
            u0, nxt, _ = solver.step(params, st, x)
            return (nxt, step_fn(x, u0)), u0

        super().__init__(body, params, state, x)


def card_name() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def _kernel_events(trace_path: str) -> list:
    """(start µs, duration µs, name) of every kernel in a Chrome trace."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    return sorted((float(e["ts"]), float(e.get("dur", 0.0)), e.get("name", ""))
                  for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")


def traced_pace_check(loop, n: int, hz: float) -> dict:
    """Run ``n`` paced ticks of ``loop`` under ``torch.profiler`` (CUPTI)
    and read the device timeline: the ticks that ran on the device (one
    ``TICK_KERNEL`` launch each; ``loop.run`` also runs one warm-up call
    before pacing, counted in ``expected_ticks``), the p50 spacing of their
    starts, and each tick's device busy time — the kernels from its rollout
    to the next tick's — as its median in µs and its share of the period.
    The profile opens with spin kernels, since CUPTI can miss a profile's
    first kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(200_000)
        torch.cuda.synchronize()
        loop.run(n)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        kernels = [k for k in _kernel_events(path) if "spin_kernel" not in k[2]]
    starts = [ts for ts, _, name in kernels if TICK_KERNEL in name]
    busy = []
    for i, s in enumerate(starts):
        end = starts[i + 1] if i + 1 < len(starts) else float("inf")
        busy.append(sum(d for ts, d, _ in kernels if s <= ts < end))
    period_ms = 1e3 / hz
    gaps = np.diff(starts) / 1e3 if len(starts) > 1 else np.asarray([])
    tick_us = float(np.median(busy)) if busy else None
    return {
        "expected_ticks": int(n) + 1,
        "device_ticks": len(starts),
        "kernels_per_tick": len(kernels) / len(starts) if starts else None,
        "device_period_p50_ms": float(np.percentile(gaps, 50)) if gaps.size else None,
        "device_tick_us": tick_us,
        "device_tick_p99_us": float(np.percentile(busy, 99)) if busy else None,
        "busy_share": tick_us / (period_ms * 1e3) if tick_us is not None else None,
        "idle_share": 1.0 - tick_us / (period_ms * 1e3) if tick_us is not None else None,
    }


def _p99_excluding_stalls(ack_ms: np.ndarray, thresh_ms: float = 5.0):
    """p99 of the per-tick ack with ±2-tick neighbourhoods of stalls (acks
    over ``thresh_ms``) removed: the loop's own tail beside the host's."""
    stall = np.convolve((ack_ms > thresh_ms).astype(float), np.ones(5), "same") > 0
    keep = ack_ms[~stall]
    return float(np.percentile(keep, 99)) if keep.size else None


def run_realtime_e2e(
    hz: float = 50.0,
    ticks: int = 10_000,
    K: int = 10_240,
    T: int = 50,
    seed: int = 0,
    fused_plant: bool = True,
    device="cuda",
) -> dict:
    """Drive pacer + controller + plant in this process; return miss stats.

    ``presets.flagship(K, T)`` on ``device``: on the card the fused tick
    (row 2, ``iso_xy``), on the CPU the scan path. A deadline miss is a tick
    whose pacer wake-up was late by more than 10 % of the period (the pacer
    sleeps on absolute deadlines, so lateness means the previous tick's work
    overran its slot); ``misses_per_10k`` is that count per 10 000 ticks. On
    the card a profiled segment of ``min(PACE_TICKS, ticks)`` paced ticks
    gives ``device_pace``."""
    from .. import presets
    from .loop import RealtimeLoop

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg, params, step_fn, stage, terminal = presets.flagship(K, T, dev)
    solver = MPPISolver(cfg, step_fn, stage, terminal, fused_tick=on_card, iso_xy=True,
                        device=dev, seed=seed)
    state = solver.init([0, seed])
    x0 = torch.zeros(3, dtype=torch.float32, device=dev)
    done = torch.cuda.Event() if on_card else None

    def wait(u0):
        if done is not None:  # the counterpart of block_until_ready
            done.record()
            done.synchronize()
        return u0

    if fused_plant:
        fused = GraphedTick(solver, params, step_fn, state, x0)

        def read_state():
            return fused.x

        def controller(x):
            return wait(fused.replay())

        def apply_control(u):
            pass  # the plant advanced inside the tick's graph
    else:
        holder = {"state": state, "x": x0}

        def read_state():
            return holder["x"]

        def controller(x):
            u0, holder["state"], _ = solver.step(params, holder["state"], x)
            return wait(u0)

        def apply_control(u):
            holder["x"] = step_fn(holder["x"], u)

    cap = 1 << max(14, int(np.ceil(np.log2(max(ticks, 2)))))
    loop = RealtimeLoop(controller, read_state, apply_control, hz=hz, telemetry_capacity=cap,
                        convert_arrays=False, warmup_apply=True)
    try:
        pacer_stats = loop.run(ticks)
        rec = loop.drain_telemetry()
        pace = traced_pace_check(loop, min(PACE_TICKS, ticks), hz) if on_card else None
    finally:
        loop.close()

    period_ns = 1e9 / hz
    ack_ms = rec["solve_ns"] / 1e6
    late_ns = rec["late_ns"]
    misses = int(np.sum(late_ns > 0.1 * period_ns))
    all_executed = pace is None or pace["device_ticks"] >= 0.98 * pace["expected_ticks"]
    device_fits = pace is None or (pace["device_tick_us"] is not None
                                   and pace["device_tick_us"] * 1e3 < 0.1 * period_ns)
    return {
        "metric": "realtime_e2e",
        "hz": hz,
        "ticks": int(rec.shape[0]),
        "K": K,
        "T": T,
        "device": card_name() if on_card else "cpu",
        "solver_path": ("cuda_fused_tick" if on_card else "scan")
        + (" + plant, one CUDA graph" if fused_plant and on_card else ""),
        "fused_plant": fused_plant,
        "graph": bool(fused_plant and on_card),
        "ack_p50_ms": float(np.percentile(ack_ms, 50)),
        "ack_p99_ms": float(np.percentile(ack_ms, 99)),
        "ack_max_ms": float(ack_ms.max()),
        "ack_p99_ex_stall_ms": _p99_excluding_stalls(ack_ms),
        "late_p50_ms": float(np.percentile(late_ns, 50)) / 1e6,
        "late_p99_ms": float(np.percentile(late_ns, 99)) / 1e6,
        "late_max_ms": float(late_ns.max()) / 1e6,
        "misses_per_10k": misses * 10_000 / max(rec.shape[0], 1),
        "pacer_overruns": int(pacer_stats["overruns"]),
        "rt_scheduling": bool(pacer_stats.get("rt_scheduling", False)),
        "device_pace": pace,
        "all_ticks_executed": bool(all_executed),
        "device_fits_budget": bool(device_fits),
        "spike_ticks": [int(t) for t in rec["tick"][ack_ms > 5.0][:20]],
        "meets_budget_p99": bool(np.percentile(ack_ms, 99) < 1e3 / hz
                                 and np.percentile(late_ns, 99) < 0.1 * period_ns
                                 and all_executed and device_fits),
    }


def main(argv: Optional[list] = None) -> dict:
    """``python -m dnn_mppi_mpc_tpu_torch realtime``: prints one JSON line."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hz", type=float, default=50.0)
    ap.add_argument("--ticks", type=int, default=10_000)
    ap.add_argument("--k", type=int, default=10_240)
    ap.add_argument("--t", type=int, default=50)
    ap.add_argument("--no-fused-plant", action="store_true",
                    help="an eager tick and a separate plant step instead of one CUDA graph")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", type=str, default=None)
    args = ap.parse_args(argv)
    out = run_realtime_e2e(hz=args.hz, ticks=args.ticks, K=args.k, T=args.t,
                           fused_plant=not args.no_fused_plant, device=args.device)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()


__all__ = ["GraphedTick", "PACE_TICKS", "TICK_KERNEL", "card_name", "main",
           "run_realtime_e2e", "traced_pace_check"]
