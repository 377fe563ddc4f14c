#!/usr/bin/env python3
"""Measure ``chip_smoke.py`` phase 12's one-step compare of ResNet-18 (the
card's training step against the CPU's) over several trained states and
minibatches, on the card.

A measuring script, not part of the package. It runs what phase 12 runs
before that compare: the collection (the CLI's protocol, 8 × 200 fused
ticks), then ResNet-18 trained on it in train-mode BatchNorm (30 epochs of
batch 128 at lr 2e-3) from each of ``--seeds`` (a seed may repeat: cuDNN's
backward is not bit-reproducible, so each run ends in its own state). From
each state, ``chip_smoke.step_line`` on each minibatch: the first 128 rows
of every series (series 0's is phase 12's), and the first minibatches of
the run's first epoch. One ``{"step_spread": ...}`` line a compare, then a
``{"step_spread_summary": ...}`` line: the largest error on the card's
branches, on the CPU's own, and the least with TF32 on, and how many of
each pass the limit. Each compare's line names the gradient tensor with the
largest relative error (``grad_worst_tensor``, its error, its absolute error
and the reference's largest magnitude and norm); every tensor's figures go
to ``--out``, one line a compare; a last ``{"step_spread_tensor_summary":
...}`` line counts which tensor set each compare's error and gives each
tensor's largest and median error over the compares. Each compare also
holds the card's and the CPU's float32 steps against the CPU's float64 step
(``f64``), and two ``{"step_spread_f64": ...}`` lines sum that up for the
series batches and the epoch minibatches. With ``--draws N``, each
compare also takes N + 1 more float32 steps on the card and N + 1 on the
CPU, in the minibatch's order and N seeded permutations of its rows
(``chip_smoke.step_orders``), each against the float64 step, and a
``{"step_spread_orders": ...}`` line counts how many of the card's steps
``chip_smoke.step_ok``'s rule would fail with the CPU's farthest over its
first n + 1 orders as the referee, for each n of ``--judge``. Run from
anywhere:

    python tools/step_compare_spread.py [--seeds 0 0 0 1 2] [--minibatches 4] [--out PATH]
                                        [--draws 16] [--judge 0 4 8 16]

Prints the card's name and power limit first; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 0, 0, 1, 2])
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--out", default="step_spread_tensors.jsonl",
                    help="where each compare's per-tensor gradient errors go, one line a compare")
    ap.add_argument("--draws", type=int, default=0,
                    help="permuted row orders for the card's and the CPU's float32 draws")
    ap.add_argument("--judge", type=int, nargs="+", default=[0, 4, 8, 16],
                    help="row orders of the CPU's referee whose failures to count")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_compare_spread: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cs._build.load_kernels()
    dev = torch.device("cuda", 0)
    ep, _, _ = cs.phase_collection(dev, {}, card)
    cfg = cs.TrainConfig(**cs.RESNET_TRAIN_CFG)
    n = ep.states.shape[0]
    n_train = cs.training._train_rows(n, 0.3, 1)
    split = cs.training._split_permutation(n, cfg.seed, dev)
    orders = cs.training._epoch_orders(n_train, cfg.seed, cfg.num_epochs, dev)
    feats = torch.cat([ep.states, ep.controls], -1)
    rtol = cs.STEP_RTOL["resnet18"]
    lines, tensors = [], []
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    tensor_log = open(args.out, "w")
    for run, seed in enumerate(args.seeds):
        net = cs.new_resnet(dev, seed)
        state, _ = cs.training._run(net, cs.make_optimizer(net, cfg), ep.states, ep.controls,
                                    ep.errors, cfg, split, orders)
        batches = {f"series {s} first 128 rows": torch.arange(s * cs.COLLECT_TICKS,
                                                              s * cs.COLLECT_TICKS + 128, device=dev)
                   for s in range(cs.COLLECT_SERIES)}
        for b in range(args.minibatches):
            batches[f"epoch 0 minibatch {b}"] = split[:n_train][orders[0][b * 128:(b + 1) * 128]]
        for label, rows in batches.items():
            x = state.in_scaler.transform(feats[rows])[:, None, :]
            y = state.out_scaler.transform(ep.errors[rows])
            line = cs.step_line("resnet18", net, state.opt_state, cfg, x, y, per_tensor=True)
            by_tensor = line.pop("grad_by_tensor")
            worst_k = max(by_tensor, key=lambda k: by_tensor[k]["rel_err"])
            line = {"step_spread": label, "run": run, "seed": seed, **line,
                    "grad_worst_tensor": worst_k, **{f"grad_worst_{k}": v
                                                     for k, v in by_tensor[worst_k].items()}}
            if args.draws:
                line["draws"] = order_draws(net, state.opt_state, cfg, x, y, args.draws)
            cs.emit(line)
            tensor_log.write(json.dumps({"step_spread_tensors": label, "run": run,
                                         "grad_by_tensor": by_tensor}) + "\n")
            lines.append(line)
            tensors.append(by_tensor)

    def worst(get):
        return max(get(ln) for ln in lines)

    own = [max(v for k, v in ln["cpu_own_branches"].items()) for ln in lines]
    matched = [max(ln["mse_rel_err"], ln["grad_rel_err"], ln["param_rel_err"]) for ln in lines]
    tf32 = [max(v for k, v in ln["tf32"].items() if k.endswith("rel_err")) for ln in lines]
    cs.emit({"step_spread_summary": "resnet18", "card": card, "compares": len(lines),
             "rtol": rtol, "step_ok": sum(ln["ok"] for ln in lines),
             "card_branches_max_err": max(matched),
             "card_branches_over_rtol": sum(e > rtol for e in matched),
             "branch_margin_max": worst(lambda ln: ln["branch_margin"]),
             "branches_differ_max": worst(lambda ln: ln["branches_differ"]),
             "compares_with_branches_differing": sum(ln["branches_differ"] > 0 for ln in lines),
             "cpu_own_branches_max_err": max(own),
             "cpu_own_branches_over_rtol": sum(e > rtol for e in own),
             "tf32_min_err": min(tf32), "tf32_under_rtol": sum(e <= rtol for e in tf32),
             "smoke_batch_errors": [m for m, ln in zip(matched, lines)
                                    if ln["step_spread"].startswith("series 0 ")],
             "smoke_batch_own_errors": [o for o, ln in zip(own, lines)
                                        if ln["step_spread"].startswith("series 0 ")]})
    names = list(tensors[0])
    per = {k: [t[k]["rel_err"] for t in tensors] for k in names}
    kinds = {"series first 128 rows": [ln for ln in lines if ln["step_spread"].startswith("series")],
             "epoch minibatches": [ln for ln in lines if ln["step_spread"].startswith("epoch")]}
    for kind, group in kinds.items():
        cs.emit({"step_spread_f64": kind, "card": card, "compares": len(group),
                 "card_vs_cpu_max": max(ln["grad_rel_err"] for ln in group),
                 "card_vs_cpu_over_rtol": sum(ln["grad_rel_err"] > rtol for ln in group),
                 "card_vs_f64_max": max(ln["f64"]["card"]["grad_rel_err"] for ln in group),
                 "cpu_vs_f64_max": max(ln["f64"]["cpu"]["grad_rel_err"] for ln in group),
                 "cpu_vs_f64_over_rtol": sum(ln["f64"]["cpu"]["grad_rel_err"] > rtol
                                             for ln in group),
                 "card_closer_to_f64_than_cpu": sum(
                     ln["f64"]["card"]["grad_rel_err"] <= ln["f64"]["cpu"]["grad_rel_err"]
                     for ln in group)})
    cs.emit({"step_spread_tensor_summary": "resnet18", "card": card, "compares": len(lines),
             "worst_tensor_counts": {k: sum(ln["grad_worst_tensor"] == k for ln in lines)
                                     for k in names if any(ln["grad_worst_tensor"] == k
                                                           for ln in lines)},
             "tensors_over_rtol": {k: sum(e > rtol for e in v) for k, v in per.items()
                                   if any(e > rtol for e in v)},
             "max_rel_err_by_tensor": {k: max(v) for k, v in per.items()},
             "median_rel_err_by_tensor": {k: sorted(v)[len(v) // 2] for k, v in per.items()},
             "min_ref_max_by_tensor": {k: min(t[k]["ref_max"] for t in tensors) for k in names}})
    tensor_log.close()
    drawn = [ln["draws"] for ln in lines if "draws" in ln]
    if drawn:
        judged = {}
        for n in args.judge:
            fails = [sum(not all(e[k] <= max(rtol, max(c[k] for c in d["cpu"][:n + 1]))
                                 for k in cs.STEP_ERRORS) for e in d["card"]) for d in drawn]
            judged[str(n)] = {"card_steps_failed": sum(fails),
                              "compares_with_a_failure": sum(f > 0 for f in fails)}
        grad = {side: [e["grad_rel_err"] for d in drawn for e in d[side]]
                for side in ("card", "cpu")}
        cs.emit({"step_spread_orders": "resnet18", "card": card, "compares": len(drawn),
                 "card_steps": len(grad["card"]), "rtol": rtol, "failed_by_referee_orders": judged,
                 "card_grad_vs_f64_max": max(grad["card"]),
                 "cpu_grad_vs_f64_max": max(grad["cpu"]),
                 "card_grad_vs_f64_median": sorted(grad["card"])[len(grad["card"]) // 2],
                 "cpu_grad_vs_f64_median": sorted(grad["cpu"])[len(grad["cpu"]) // 2],
                 "card64_vs_cpu64_max": max(max(ln["f64"]["card64"].values()) for ln in lines),
                 "cpu_orders_over_cpu": sum(ln["f64"]["cpu_orders"]["grad_rel_err"]
                                            > ln["f64"]["cpu"]["grad_rel_err"] for ln in lines)})
    return 0


def order_draws(net, opt_state, cfg, x, y, n: int) -> dict:
    """The card's and the CPU's float32 steps on the card's branches, in the
    minibatch's order and ``n`` permutations of its rows, each against the
    CPU's float64 step (``chip_smoke.step_errs``)."""
    card = cs.step_run(net, opt_state, cfg, x, y, "card")
    f64 = cs.step_run(net, opt_state, cfg, x, y, "cpu64", given=card[3])
    exact = (f64[0], {k: g.float() for k, g in f64[1].items()},
             {k: q.float() for k, q in f64[2].items()})
    orders = [None] + cs.step_orders(int(x.shape[0]), n)
    return {side: [cs.step_errs(cs.step_run(net, opt_state, cfg, x, y, side, given=card[3],
                                            order=o), exact) for o in orders]
            for side in ("card", "cpu")}


if __name__ == "__main__":
    sys.exit(main())
