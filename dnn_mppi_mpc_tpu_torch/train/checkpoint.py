"""Checkpoints with ``torch.save`` / ``torch.load(weights_only=True)`` —
counterpart of ``dnn_mppi_mpc_tpu/train/checkpoint.py`` (orbax there).

A checkpoint is one file holding a tree of dicts, lists, tuples, tensors
and plain numbers: the full-resume tree of a training run is ``{"params":
state.params, "opt_state": state.opt_state, "in_scaler": {"mean", "std"},
"out_scaler": {"mean", "std"}}`` (:func:`train_state_tree`, the shape the
JAX CLI's ``train --ckpt`` writes). It is written to a temporary file in the
same directory and then ``os.replace``d over ``path``, so a crash leaves
the previous checkpoint whole.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
from typing import Any, Optional

import torch


def train_state_tree(state) -> dict:
    """A ``training.TrainState`` as the full-resume tree, its scalers as
    ``{"mean", "std"}`` dicts."""
    return {"params": state.params, "opt_state": state.opt_state,
            "in_scaler": dataclasses.asdict(state.in_scaler),
            "out_scaler": dataclasses.asdict(state.out_scaler)}


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` through a temporary file and
    ``os.replace``; on any failure the temporary file is removed and
    ``path`` keeps what it held."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(tree, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _restore(loaded: Any, target: Any, where: str) -> Any:
    """``loaded`` with each tensor leaf cast to the dtype and moved to the
    device of ``target``'s leaf at the same place; the structure and the
    tensors' shapes must agree."""
    if torch.is_tensor(target):
        if not torch.is_tensor(loaded) or loaded.shape != target.shape:
            raise ValueError(f"{where}: {getattr(loaded, 'shape', type(loaded).__name__)} does "
                             f"not fit the target's {tuple(target.shape)}")
        return loaded.to(device=target.device, dtype=target.dtype)
    if isinstance(target, Mapping):
        if not isinstance(loaded, Mapping) or set(loaded) != set(target):
            raise ValueError(f"{where}: keys {sorted(map(str, getattr(loaded, 'keys', list)()))}"
                             f" do not match the target's {sorted(map(str, target))}")
        out = {k: _restore(loaded[k], target[k], f"{where}/{k}") for k in target}
        return type(loaded)(out) if type(loaded) is not dict else out
    if isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(target):
            raise ValueError(f"{where}: a sequence of {len(target)} expected")
        return type(loaded)(_restore(a, b, f"{where}/{i}")
                            for i, (a, b) in enumerate(zip(loaded, target)))
    return loaded


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Read the tree at ``path`` (``weights_only``: tensors and plain
    containers, no pickled code). Without ``target`` its tensors load on
    the CPU; with ``target`` (a tree of the same structure) each tensor
    takes the dtype and device of the target's leaf, the counterpart of
    orbax's ``to_shape_dtype_struct`` restore. A structure or shape that
    does not match raises ``ValueError``."""
    loaded = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return loaded if target is None else _restore(loaded, target, "checkpoint")


__all__ = ["load_checkpoint", "save_checkpoint", "train_state_tree"]
