#!/usr/bin/env python3
"""Time the generic kernels at their main paths' shapes, on the card.

A measuring script, not part of the package. It imports the
``dnn_mppi_mpc_tpu_torch`` and ``chip_smoke`` of the tree it lies in, so two
versions of the kernels are compared by running each tree's copy in one
call, in turns (a, b, b, a). For each wrapper at its main path's shape:

* ``generic_mppi_tick``: the four-wheel example's fused tick (K = 2 048,
  T = 25, W = 20, nu = 4, two obstacles, hash ε without ``emit_eps``: the
  solver's call, the epilogue), the same at K = 10 240, T = 50, and the
  flagship's tick through the unicycle tile (K = 10 240, T = 50, nu = 2);
* ``generic_rollout_costs``: the four-wheel split rollout, ε injected, at
  K = 2 048, T = 25 and K = 10 240, T = 50;

it prints the time a call (CUDA events over 100 back-to-back calls, taken
in ROUNDS rounds: their median, least and largest; the wrapper's host work
sets it where that is longer than the device's), the device time a call and
its three largest kernels (profiler), and then the time a tick (CUDA events
over 50 ticks, ROUNDS rounds), the device busy time a tick (20 ticks
profiled) and the host's top-level ATen ops a tick of the four-wheel
example's closed loop and the flagship's through the unicycle tile. Run
from anywhere:

    python tools/generic_time.py            # the rows and loops
    python tools/generic_time.py --groups   # G = 1, 2, 4, 8 of every family

``--groups`` builds csrc/generic_kernels.cu four more times with
``-DDMM_GENERIC_GROUP`` (chip_smoke.VARIANT_BUILDS) and times each family's
fused tick and split rollout at both shapes at every G beside the shipped
rule (``chip_smoke.generic_variants``, two rounds in turns), one JSON line a
call and one for the rule. Prints the card's name and power limit, then one
JSON line a row; exits non-zero without a card.
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
from dnn_mppi_mpc_tpu_torch import _build, presets  # noqa: E402
from dnn_mppi_mpc_tpu_torch.models import four_wheel_torque_tile, unicycle_tile  # noqa: E402
from dnn_mppi_mpc_tpu_torch.models.tile import FAMILIES  # noqa: E402
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern  # noqa: E402
from dnn_mppi_mpc_tpu_torch.solvers.mppi import MPPISolver  # noqa: E402

ROUNDS = 7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rows(dev) -> dict:
    """name -> the call at its main path's shape."""
    rng = np.random.default_rng(2)
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    calls = {}
    for K, T in ((cs.K_EX, cs.T_EX), (cs.K_FLAG, cs.T_FLAG)):
        p, static = cs.four_wheel_inputs(dev, rng, K, T, sigma=0.6 * np.eye(4))
        ft = cs.filter_t(T, dev)
        calls[f"generic_mppi_tick four_wheel K={K}"] = (
            lambda p=p, st=static, ft=ft: kern.generic_mppi_tick(
                **p, **st, seed=seed, filter_t=ft, fuse_epilogue=True))
        split = {k: v for k, v in static.items() if k != "K"}
        eps = torch.randn((K, T, 4), generator=torch.Generator(dev).manual_seed(K),
                          device=dev) * 0.77
        roll = {k: p[k] for k in ("u", "a", "x0", "window", "stage_w", "term_w", "u_min",
                                  "u_max", "dt", "n_exploit", "obstacles", "robot_radius")}
        calls[f"generic_rollout_costs four_wheel K={K}"] = (
            lambda r=roll, st=split, e=eps: kern.generic_rollout_costs(**r, **st, eps=e))
    cfg, _, _, _, _ = presets.flagship(cs.K_FLAG, cs.T_FLAG, dev)
    flag = cs.problem(cs.K_FLAG, cfg.inv_temperature, rng, dev)
    ft = cs.filter_t(cs.T_FLAG, dev)
    calls[f"generic_mppi_tick unicycle K={cs.K_FLAG}"] = lambda: kern.generic_mppi_tick(
        **flag, seed=seed, filter_t=ft, K=cs.K_FLAG, T=cs.T_FLAG, W=cs.W_FLAG,
        fuse_epilogue=True, step_tile=unicycle_tile(cfg.dt), nx=3, nu=2, n_track=3)
    return calls


def loops(dev) -> dict:
    """name -> one closed-loop tick (step and plant) of the four-wheel
    example and of the flagship through the unicycle tile."""
    cfg, params, plant, stage, terminal = cs.four_wheel_example(dev)
    ex = MPPISolver(cfg, plant, stage, terminal, fused_tick=True,
                    tile_dynamics=four_wheel_torque_tile(cs.DT_EX), robot_radius=cs.EX_RADIUS,
                    device=dev)
    fcfg, fparams, step_fn, fstage, fterminal = presets.flagship(cs.K_FLAG, cs.T_FLAG, dev)
    uni = MPPISolver(fcfg, step_fn, fstage, fterminal, fused_tick=True,
                     tile_dynamics=unicycle_tile(fcfg.dt), device=dev)
    carry = {"ex": (ex.init(), torch.zeros(5, device=dev)),
             "uni": (uni.init(), cs.path_start(dev))}

    def ex_tick():
        st, x = carry["ex"]
        u0, st, _ = ex.step(params, st, x)
        carry["ex"] = (st, plant(x, u0))

    def uni_tick():
        st, x = carry["uni"]
        u0, st, _ = uni.step(fparams, st, x)
        carry["uni"] = (st, step_fn(x, u0))

    return {"four-wheel closed loop": ex_tick, "unicycle tile generic tick": uni_tick}


def groups(dev, card: str) -> None:
    """G = 1, 2, 4 and 8 of every family beside the shipped rule."""
    cs.finish_variant_builds(cs.start_variant_builds(
        [name for name in cs.VARIANT_BUILDS if name.startswith("generic_g")]))
    rows_, rule = cs.generic_variants(dev, FAMILIES)
    for name, row in rows_.items():
        emit({"variant": name, "card": card, **row})
    emit({"generic_rule": rule, "card": card})


def main() -> int:
    if not torch.cuda.is_available():
        print("generic_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    _build.load_kernels()
    if "--groups" in sys.argv[1:]:
        groups(dev, card)
        return 0
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
              "device_idle_share": 1.0 - dev_us / (ms[ROUNDS // 2] * 1e3),
              "device_kernels_per_tick": n, "host_aten_ops_per_tick": host_ops,
              "top_kernels_us_per_tick": [[k[:60], v] for k, v in top]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
