#!/usr/bin/env python3
"""Time the diff-drive kernels at their main paths' shapes, on the card.

A measuring script, not part of the package. It imports the
``dnn_mppi_mpc_tpu_torch`` and ``chip_smoke`` of the tree it lies in, so two
versions of the kernels are compared by running each tree's copy in one
call, in turns (a, b, b, a). For each wrapper at its main path's shape:

* ``diffdrive_rollout_costs``: the split rollout, K = 10 240, T = 50,
  W = 20, ε injected;
* ``diffdrive_mppi_tick``: the flagship's fused tick, K = 10 240, hash ε
  without ``emit_eps`` (the solver's call), ISO, the epilogue;
* ``diffdrive_mppi_tick_blocked``: the pod-K tick, K = 102 400,
  ``K_BLK`` = 10 240, ISO;
* ``diffdrive_mppi_tick_blocked[s_only]``: its rollout alone at K = 10 240,
  the sharded tick's phase 1;
* ``fleet_mppi_tick``: B = 16 members of K = 1 024, T = 50, W = 20;
* ``weighted_noise_reduce``: the sharded tick's phase 2 at K = 10 240 (its
  main path, world size 1) and K = 102 400, ``K_BLK`` = 10 240, T = 50;

it prints the time a call (CUDA events over 100 back-to-back calls, taken
in ROUNDS rounds: their median, least and largest; the wrapper's host work
sets it where that is longer than the device's), the device time a call and
its three largest kernels (profiler), and then the time a tick (CUDA
events over 50 ticks, ROUNDS rounds) and the device busy time a tick (20
ticks profiled) of the flagship, fleet and sharded (world size 1, NCCL on a
one-process group) closed loops. Run from anywhere:

    python tools/diffdrive_time.py

Prints the card's name and power limit, then one JSON line a row; exits
non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from dnn_mppi_mpc_tpu_torch import _build, parallel, presets  # noqa: E402
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern  # noqa: E402
from dnn_mppi_mpc_tpu_torch.solvers.mppi import MPPISolver, MPPIState  # noqa: E402

ROUNDS = 7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rows(dev) -> dict:
    """name -> the call at its main path's shape."""
    rng = np.random.default_rng(2)
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    cfg, _, _, _, _ = presets.flagship(cs.K_FLAG, cs.T_FLAG, dev)
    flag = cs.problem(cs.K_FLAG, cfg.inv_temperature, rng, dev)
    pod = cs.problem(cs.K_POD, cfg.inv_temperature, rng, dev)
    eps = torch.randn((cs.K_FLAG, cs.T_FLAG, 2), generator=torch.Generator(dev).manual_seed(1),
                      device=dev) * 0.1
    roll = {k: flag[k] for k in ("u", "a", "x0", "window", "stage_w", "term_w", "u_min",
                                 "u_max", "dt", "n_exploit")}
    ft = cs.filter_t(cs.T_FLAG, dev)
    base = cs.fleet_inputs(dev, rng)
    fleet = dict(base["args"], iso_xy=True)

    def reduce(K):
        w = torch.rand(K, generator=torch.Generator(dev).manual_seed(K), device=dev)
        args = dict(seed=seed, w=w / w.sum(), chol_sigma=flag["chol_sigma"], block_offset=0,
                    K=K, T=cs.T_FLAG, K_BLK=cs.K_BLK)
        return lambda: kern.weighted_noise_reduce(**args)

    return {
        "diffdrive_rollout_costs": lambda: kern.diffdrive_rollout_costs(
            **roll, eps=eps, T=cs.T_FLAG, W=cs.W_FLAG),
        "diffdrive_mppi_tick": lambda: kern.diffdrive_mppi_tick(
            **flag, seed=seed, filter_t=ft, K=cs.K_FLAG, T=cs.T_FLAG, W=cs.W_FLAG,
            fuse_epilogue=True, iso_xy=True),
        "diffdrive_mppi_tick_blocked": lambda: kern.diffdrive_mppi_tick_blocked(
            **pod, seed=seed, K=cs.K_POD, T=cs.T_FLAG, W=cs.W_FLAG, K_BLK=cs.K_BLK, iso_xy=True),
        "diffdrive_mppi_tick_blocked[s_only]": lambda: kern.diffdrive_mppi_tick_blocked(
            **flag, seed=seed, K=cs.K_FLAG, T=cs.T_FLAG, W=cs.W_FLAG, K_BLK=cs.K_BLK,
            iso_xy=True, s_only=True),
        "fleet_mppi_tick": lambda: kern.fleet_mppi_tick(**fleet),
        f"weighted_noise_reduce K={cs.K_FLAG}": reduce(cs.K_FLAG),
        f"weighted_noise_reduce K={cs.K_POD}": reduce(cs.K_POD),
    }


def loops(dev) -> dict:
    """name -> one closed-loop tick (step and plant) of the flagship, the
    fleet and the sharded flagship at world size 1 (the default process
    group, which the caller opens)."""
    cfg, params, step_fn, stage, terminal = presets.flagship(cs.K_FLAG, cs.T_FLAG, dev)
    flag = MPPISolver(cfg, step_fn, stage, terminal, fused_tick=True, iso_xy=True, device=dev)
    step, fparams, states, fplant = presets.mppi_fleet(cs.B_FLEET, cs.K_FLEET, cs.T_FLAG,
                                                       device=dev)
    sharded = parallel.make_sharded_fused_mppi_step(cfg, step_fn, iso_xy=True, device=dev)
    carry = {"flag": (flag.init(), cs.path_start(dev)),
             "fleet": (states, torch.zeros((cs.B_FLEET, 3), device=dev)),
             "sharded": (MPPIState.init(cfg, device=dev), cs.path_start(dev))}

    def flag_tick():
        st, x = carry["flag"]
        u0, st, _ = flag.step(params, st, x)
        carry["flag"] = (st, step_fn(x, u0))

    def fleet_tick():
        st, x = carry["fleet"]
        u0, st, _ = step(fparams, st, x)
        carry["fleet"] = (st, fplant(x, u0))

    def sharded_tick():
        st, x = carry["sharded"]
        u0, st, _ = sharded(params, st, x)
        carry["sharded"] = (st, step_fn(x, u0))

    return {"flagship closed loop": flag_tick, "fleet closed loop": fleet_tick,
            "sharded closed loop world 1": sharded_tick}


def main() -> int:
    if not torch.cuda.is_available():
        print("diffdrive_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    _build.load_kernels()
    parallel.initialize_distributed(device=dev)
    try:
        measure(dev, card)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def measure(dev, card: str) -> None:
    tree = str(ROOT)
    for name, fn in rows(dev).items():
        dev_us, n, by_name, _ = cs.device_time(fn, 100)
        ms = sorted(cs.time_call(fn, 100) for _ in range(ROUNDS))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        emit({"kernel": name, "tree": tree, "card": card, "ms": ms[ROUNDS // 2],
              "ms_min": ms[0], "ms_max": ms[-1], "device_ms": dev_us / 1e3, "device_kernels": n,
              "top_kernels_us": [[k[:48], v] for k, v in top]})
    for name, fn in loops(dev).items():
        for _ in range(3):
            fn()
        dev_us, n, by_name, host_ops = cs.device_time(fn, 20)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        ms = sorted(cs.time_call(fn, 50) for _ in range(ROUNDS))
        emit({"loop": name, "tree": tree, "card": card, "tick_ms": ms[ROUNDS // 2],
              "tick_ms_min": ms[0], "tick_ms_max": ms[-1], "device_busy_us_per_tick": dev_us,
              "device_kernels_per_tick": n, "host_aten_ops_per_tick": host_ops,
              "top_kernels_us_per_tick": [[k[:60], v] for k, v in top]})


if __name__ == "__main__":
    sys.exit(main())
