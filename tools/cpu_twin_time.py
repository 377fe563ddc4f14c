#!/usr/bin/env python3
"""Time the generic tick's plain twin on the CPU for a lifted MLP residual.

A measuring script, not part of the package. On CPU tensors the fused
generic tick runs its plain twin, which sums the matrix products of a
lifted step in the generated functor's order (``user_tile.functor_order``,
one broadcast multiply-add per input of a product) up to the weights a
functor holds, and as ``torch.mm`` past them. This script times that route:
``MPPISolver(fused_tick=True, tile_dynamics=lift_dynamics(F))`` at the
flagship's costs (K samples, horizon T, device "cpu"), F the Euler unicycle
plus a seeded tanh MLP residual of the given widths written with
``torch.nn.functional.linear``, one tick after another from the path's
start. It prints one JSON line a width: the seconds a tick (median, least
and largest over the timed ticks, after one tick of warm-up), the step's
weight count and the torch threads. Run from anywhere:

    python tools/cpu_twin_time.py                       # this tree's package
    python tools/cpu_twin_time.py --root OTHER_CHECKOUT # another tree's

``--root`` imports ``dnn_mppi_mpc_tpu_torch`` from another checkout of the
repo (an older commit), so the two routes are timed by one script on one
machine, in turns.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--widths", nargs="+", default=["5,512,512,3", "5,32,32,3"])
    ap.add_argument("-K", type=int, default=1024)
    ap.add_argument("-T", type=int, default=50)
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args()
    sys.path.insert(0, a.root)
    import torch

    from dnn_mppi_mpc_tpu_torch import presets
    from dnn_mppi_mpc_tpu_torch.models import dynamics, lift_dynamics
    from dnn_mppi_mpc_tpu_torch.models.integrators import euler_step
    from dnn_mppi_mpc_tpu_torch.solvers.mppi import MPPISolver

    torch.set_num_threads(a.threads)
    for spec in a.widths:
        widths = [int(w) for w in spec.split(",")]
        rng = np.random.default_rng(19)
        layers = [(torch.tensor(rng.normal(0.0, 1.0 / np.sqrt(i), (o, i)), dtype=torch.float32),
                   torch.tensor(0.05 * rng.normal(size=o), dtype=torch.float32))
                  for i, o in zip(widths[:-1], widths[1:])]
        cfg, params, _, stage, terminal = presets.flagship(a.K, a.T, "cpu")

        def plant(x, u, layers=layers, dt=cfg.dt):
            h = torch.cat([x, u], -1)
            for n, (W, b) in enumerate(layers):
                h = torch.nn.functional.linear(h, W, b)
                h = torch.tanh(h) if n + 1 < len(layers) else h * 1e-3
            return euler_step(dynamics.unicycle, x, u, dt) + h

        solver = MPPISolver(cfg, plant, stage, terminal, fused_tick=True,
                            tile_dynamics=lift_dynamics(plant), device="cpu")
        st = solver.init()
        x = torch.tensor([0.0, 0.0, float(np.arctan2(-10.0, 20.0))])
        secs = []
        for tick in range(a.ticks + 1):
            t0 = time.perf_counter()
            u, st, _ = solver.step(params, st, x)
            if tick:
                secs.append(time.perf_counter() - t0)
            x = plant(x[None], u[None])[0]
        print(json.dumps({
            "cpu_plain_tick_s": statistics.median(secs), "min_s": min(secs), "max_s": max(secs),
            "ticks": a.ticks, "widths": widths, "K": a.K, "T": a.T, "threads": a.threads,
            "weights": sum(W.numel() + b.numel() for W, b in layers),
            "root": Path(a.root).name, "finite": bool(torch.isfinite(x).all())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
