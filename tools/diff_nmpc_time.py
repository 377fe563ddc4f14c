#!/usr/bin/env python3
"""Measure what ``chip_smoke.py`` phase 13 leaves out for time: the device
time of the QP's recompute backward, and the torch twin's gradient from the
cold start.

A measuring script, not part of the package. From the converged windows
phase 13 gates on, it runs phase 13's QP part with the device profiles of
both backward rules (the recompute rule's ~8·10⁴ kernels a call take the
profiler minutes on the card) and its tick part with the cold start's
3-tick gradient by the torch twin beside the kernel's IFT (~2 s a twin
tick). Run from anywhere:

    python tools/diff_nmpc_time.py

Prints the card's name and power limit, then phase 13's lines for those
parts; exits non-zero without a card, or where a gate fails.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("diff_nmpc_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cs._build.load_kernels()
    dev = torch.device("cuda", 0)
    rep = {}
    rti_warm, fleet_warm = cs.diff_windows(dev)
    cs.run_phase(cs.phase_diff_qp, dev, card, rep, rti_warm[:4], fleet_warm, True)
    cs.run_phase(cs.phase_diff_tick, dev, card, rep, rti_warm, True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
