#!/usr/bin/env python3
"""Weigh the IRK's Newton solve by what it costs the four-wheel IRK NMPC tick
at N = 300 on the card.

A measuring script, not part of the package. ``irk_step``
(``models/integrators.py``) solves 9 Newton systems of 20 × 20 a step
(3 substeps × 3 Newton steps, s·nx = 4·5), and the SQP tick runs it under
``vmap(jacrev(...))`` for every linearization and again in the merit search
and the plant. Each candidate below never waits for the card and keeps
partial pivoting:

* ``pivoted_solve`` (the package's): Gauss-Jordan elimination a column at a
  time, a dozen whole-matrix ops a column;
* ``column_lu``: the partial-pivot LU a column at a time (the pivot row
  swapped in with masks), then the back substitution a column at a time;
* ``small_lu_solve`` (``ops/sampling.py``): the partial-pivot LU unrolled
  element by element, O(n²) small ops;

and, eager only, ``solve_ex`` (``torch.linalg.solve_ex``, the solve before
``pivoted_solve``), which waits for the card inside the library, so its
tick cannot be captured.

For each, the candidate is put in the place of
``integrators.pivoted_solve`` and ``chip_smoke.py``'s N = 300 tick + plant
(``long_solver``, ``nmpc_tick_body``) is measured: the host's top-level ATen
ops of an eager tick (a CPU profile), the eager tick (the CUDA-event wall of
3 ticks over 3, after one), the tick captured as one CUDA graph
(``ChainGraph``) and its replays' slope over (3, 12)-replay chains, two runs
of the three in turns (a, b, c, c, b, a), the busy µs and kernels of one
replay (CUPTI), the capture's wall time, and the largest difference of the
state after 12 replays from the package's solve. Run from anywhere:

    python tools/irk_solve_choice.py

Prints the card's name and power limit, then one JSON line a candidate;
exits non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dnn_mppi_mpc_tpu_torch import _build  # noqa: E402
from dnn_mppi_mpc_tpu_torch.models import integrators  # noqa: E402
from dnn_mppi_mpc_tpu_torch.ops.sampling import small_lu_solve  # noqa: E402
from dnn_mppi_mpc_tpu_torch.utils.benchtime import ChainGraph, slope_timing  # noqa: E402

CHAIN = (3, 12)


def column_lu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·x = b by the partial-pivot LU a column at a time: the first row at
    or below k with the largest |a[i, k]| is swapped into row k with masks
    and eliminated from the rows below; then the back substitution a column
    at a time."""
    n = a.shape[-1]
    idx = torch.arange(n, device=a.device)
    ge = (idx[:, None] >= idx[None, :]).unbind(1)
    gt = (idx[:, None] > idx[None, :]).unbind(1)
    at = (idx[:, None] == idx[None, :])[:, None, :].unbind(2)
    ab = torch.cat([a, b[:, None]], dim=1)
    for k in range(n):
        p = torch.argmax(torch.where(ge[k], ab[:, k].abs(), -1.0))
        row_p = torch.gather(ab, 0, p.expand(1, n + 1))
        ab = torch.where(at[k], row_p, torch.where((idx == p)[:, None], ab[k], ab))
        ab = ab - torch.where(gt[k], ab[:, k] / row_p[0, k], 0.0)[:, None] * row_p
    y = ab[:, n]
    xs = [None] * n
    for k in reversed(range(n)):
        xs[k] = y[k] / ab[k, k]
        y = y - ab[:, k] * xs[k]
    return torch.stack(xs)


def solve_ex(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The library's batched LU solve without its error check."""
    return torch.linalg.solve_ex(a, b, check_errors=False)[0]


CANDIDATES = {"pivoted_solve": integrators.pivoted_solve, "column_lu": column_lu,
              "small_lu_solve": small_lu_solve}
EAGER_ONLY = {"solve_ex": solve_ex}
EAGER_TICKS = 3


def eager_ms(body, params, st0, x0) -> float:
    """ms an eager tick: CUDA events around EAGER_TICKS ticks, after one."""
    carry = {"st": st0, "x": x0}

    def ticks(n):
        for _ in range(n):
            (carry["st"], carry["x"]), _ = body(params, carry["st"], carry["x"])

    ticks(1)
    return cs.cuda_event_wall(lambda: ticks(EAGER_TICKS)) * 1e3 / EAGER_TICKS


def main() -> int:
    if not torch.cuda.is_available():
        print("irk_solve_choice: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_kernels()
    dev = torch.device("cuda", 0)
    shipped = integrators.pivoted_solve
    runs = {}
    try:
        for name, solve in {**CANDIDATES, **EAGER_ONLY}.items():
            integrators.pivoted_solve = solve
            solver, params = cs.long_solver(dev)
            x0 = torch.zeros(5, device=dev)
            st0 = solver.init(x0)
            body = cs.nmpc_tick_body(solver.solve, solver.dyn_step)
            tick_ms = eager_ms(body, params, st0, x0)
            ops = cs.host_ops(lambda: body(params, st0, x0))
            if name in EAGER_ONLY:
                print(json.dumps({"irk_solve": name, "card": card, "N": cs.N_LONG_NMPC,
                                  "eager_ms": tick_ms, "eager_ticks": EAGER_TICKS,
                                  "host_aten_ops_per_tick": ops, "graph": "not capturable"}),
                      flush=True)
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tick = ChainGraph(body, params, st0, x0)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            busy_us, kernels, _, _ = cs.device_time(tick.replay, 1)
            runs[name] = {"tick": tick, "st0": st0, "x0": x0, "host_aten_ops_per_tick": ops,
                          "eager_ms": tick_ms,
                          "capture_s": capture_s, "busy_us_per_replay": busy_us,
                          "kernels_per_replay": kernels, "graph_ms_runs": []}
    finally:
        integrators.pivoted_solve = shipped

    def runner(r):
        def make(n):
            def run():
                r["tick"].load(r["st0"], r["x0"])
                for _ in range(n):
                    r["tick"].replay()
            return run
        return make

    order = list(CANDIDATES)
    for name in order + order[::-1]:
        runs[name]["graph_ms_runs"].append(
            slope_timing(runner(runs[name]), *CHAIN, 2).tau * 1e3)
    finals = {}
    for name, r in runs.items():
        runner(r)(12)()
        finals[name] = r["tick"].x.clone()
    for name, r in runs.items():
        print(json.dumps({
            "irk_solve": name, "card": card, "N": cs.N_LONG_NMPC, "dt": cs.DT_LONG,
            "graph_ms": min(r["graph_ms_runs"]), "graph_ms_runs": r["graph_ms_runs"],
            "graph_chain": list(CHAIN),
            "eager_ticks": EAGER_TICKS,
            **{k: r[k] for k in ("eager_ms", "host_aten_ops_per_tick", "busy_us_per_replay",
                                 "kernels_per_replay", "capture_s")},
            "x_after_12_max_abs_diff_vs_pivoted_solve":
                float((finals[name] - finals["pivoted_solve"]).abs().max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
