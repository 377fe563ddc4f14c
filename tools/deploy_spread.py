#!/usr/bin/env python3
"""Measure the episode-to-episode spread of ``chip_smoke.py`` phase 12's
DNN-MPPI deployment on the card, at a chosen number of episodes.

A measuring script, not part of the package. It runs what phase 12 runs
before its row-12 deployment, the same way: the collection (the CLI's
protocol, 8 × 200 fused ticks), then the 5→512×3→3 MLP trained on it with
the CLI's defaults; then ``phase_deploy_mlp`` with ``DEPLOY_EPISODES`` set
to ``--episodes``: both arms on the scan path of ``presets.dnn_mppi``'s
config, episode i of each from noise seed i. Its ``training_deploy`` line
carries each episode's RMSE, each mean's standard error, the ratio's, and
each arm's wall time. Episode i is the same episode at any count, so the
means over the first n episodes can be read off one run. Run from
anywhere:

    python tools/deploy_spread.py [--episodes 32]

Prints the card's name and power limit, then the lines phase 12 prints up
to its deployment; exits non-zero without a card, or where a gate fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("deploy_spread: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cs._build.load_kernels()
    dev = torch.device("cuda", 0)
    data, _ = cs.phase_collection(dev)
    net = cs.new_mlp(dev)
    state, _ = cs.train_on_card(net, data, cs.TrainConfig(**cs.TRAIN_CFG), "mlp 5-512x3-3", card)
    cs.DEPLOY_EPISODES = args.episodes
    cs.phase_deploy_mlp(dev, net, state, {})
    return 0


if __name__ == "__main__":
    sys.exit(main())
