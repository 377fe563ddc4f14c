"""Structured metrics logging (vendored from ``dnn_mppi_mpc_tpu/utils/logging.py``):
JSONL metric streams and CSV episode dumps, numpy and the standard library
only."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np

_LOG = logging.getLogger("dnn_mppi_mpc_tpu_torch")
if not _LOG.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    _LOG.addHandler(_h)
    _LOG.setLevel(logging.INFO)


def get_logger(name: Optional[str] = None) -> logging.Logger:
    return _LOG if name is None else _LOG.getChild(name)


class MetricsWriter:
    """Append-only JSONL metric stream: one {'step', 'ts', **metrics} per line."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "ts": time.time()}
        for k, v in metrics.items():
            if isinstance(v, (bool, int, float, str)) or v is None:
                rec[k] = v
            elif hasattr(v, "tolist"):
                # numpy arrays and scalars, and tensors: run_closed_loop hands
                # metric_cb 0-d device tensors (reading one waits for the card)
                rec[k] = v.tolist()
            else:
                rec[k] = np.asarray(v).tolist()
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


def save_episode_csv(path: str, states: np.ndarray, controls: np.ndarray) -> None:
    """Dump a closed-loop episode as CSV (the reference's npy/csv artifact
    convention, train/bullet_mpc_differential_drive.py:334-336)."""
    states, controls = np.asarray(states), np.asarray(controls)
    n = min(len(states), len(controls))
    cols = np.concatenate([states[:n], controls[:n]], axis=1)
    header = ",".join([f"x{i}" for i in range(states.shape[1])]
                      + [f"u{i}" for i in range(controls.shape[1])])
    np.savetxt(path, cols, delimiter=",", header=header, comments="")


def load_episode_csv(path: str, nx: int) -> tuple[np.ndarray, np.ndarray]:
    """Load a (states, controls) episode CSV (the reference's RobotDataset
    CSV convention, train/train_mlp.py)."""
    data = np.loadtxt(path, delimiter=",", skiprows=1)
    return data[:, :nx], data[:, nx:]


__all__ = ["get_logger", "MetricsWriter", "save_episode_csv", "load_episode_csv"]
