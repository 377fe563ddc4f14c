"""The port's checkpoints (``train/checkpoint.py``: ``torch.save`` /
``torch.load(weights_only=True)`` where the JAX package uses orbax), on the
CPU:

* the full-resume tree of a training run (params with the BatchNorm
  buffers, optimizer state, both scalers) round-trips bit for bit; without
  ``target`` every tensor loads on the CPU, with ``target`` each takes its
  target leaf's dtype and device (a float64 leaf, a ``meta`` leaf);
* a target of another structure or shape raises ``ValueError``;
* a crash between the write and the replace leaves the old checkpoint
  whole and no temporary file;
* k steps, a checkpoint, a fresh module and optimizer loaded from it and k
  more steps equal 2k uninterrupted steps bit for bit; the same for epochs
  of ``train_residual_model`` resumed on the first run's permutations.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu_torch.models import learned as tl
from dnn_mppi_mpc_tpu_torch.train import checkpoint as ck
from dnn_mppi_mpc_tpu_torch.train import training as ttr


def _data(n=96, seed=0):
    rng = np.random.default_rng(seed)
    s, c = rng.normal(size=(n, 3)), rng.normal(size=(n, 2))
    e = np.stack([0.3 * np.tanh(c[:, 0]), 0.2 * c[:, 1] * np.sin(s[:, 2]), 0.1 * s[:, 0]], -1)
    return [torch.tensor(a, dtype=torch.float32) for a in (s, c, e)]


def _net(kind="mlp", seed=3):
    g = torch.Generator().manual_seed(seed)
    if kind == "mlp":
        return tl.MLP(hidden=16, depth=1, zero_init_head=False, device="cpu", generator=g)
    return tl.ResNet1D(3, "18", device="cpu", generator=g)


def _equal(a, b) -> bool:
    if torch.is_tensor(b):
        return torch.is_tensor(a) and a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    if isinstance(b, dict):
        return isinstance(a, dict) and set(a) == set(b) and all(_equal(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("kind", ["mlp", "resnet18"])
def test_full_train_state_round_trips(tmp_path, kind):
    state, _ = ttr.train_residual_model(_net(kind), *_data(),
                                        ttr.TrainConfig(num_epochs=2, batch_size=32))
    tree = ck.train_state_tree(state)
    assert set(tree) == {"params", "opt_state", "in_scaler", "out_scaler"}
    assert set(tree["in_scaler"]) == {"mean", "std"}
    path = str(tmp_path / "state.pt")
    ck.save_checkpoint(path, tree)
    assert _equal(ck.load_checkpoint(path), tree)
    assert _equal(ck.load_checkpoint(path, target=tree), tree)


def test_target_sets_dtype_and_device(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": [torch.ones(2), 7],
            "step": torch.tensor(3.0)}
    path = str(tmp_path / "t.pt")
    ck.save_checkpoint(path, tree)
    target = {"w": torch.empty(2, 3, dtype=torch.float64), "n": [torch.empty(2, device="meta"), 0],
              "step": torch.tensor(0.0)}
    out = ck.load_checkpoint(path, target=target)
    assert out["w"].dtype == torch.float64 and torch.equal(out["w"], tree["w"].double())
    assert out["n"][0].device.type == "meta" and out["n"][1] == 7
    assert ck.load_checkpoint(path)["w"].device.type == "cpu"
    for bad in ({"w": torch.empty(3, 2), "n": target["n"], "step": target["step"]},
                {"w": target["w"], "step": target["step"]},
                {"w": target["w"], "n": [torch.empty(2)], "step": target["step"]}):
        with pytest.raises(ValueError):
            ck.load_checkpoint(path, target=bad)


def test_crash_before_replace_keeps_the_old_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "ckpt.pt")
    ck.save_checkpoint(path, {"v": torch.zeros(3)})

    def crash(src, dst):
        raise OSError("crash between write and replace")

    monkeypatch.setattr(os, "replace", crash)
    with pytest.raises(OSError, match="crash"):
        ck.save_checkpoint(path, {"v": torch.ones(3)})
    monkeypatch.undo()
    assert torch.equal(ck.load_checkpoint(path)["v"], torch.zeros(3))
    assert os.listdir(tmp_path) == ["ckpt.pt"]


def test_resumed_steps_equal_uninterrupted_steps(tmp_path):
    s, c, e = _data()
    x, y = torch.cat([s, c], -1), e
    cfg = ttr.TrainConfig(learning_rate=3e-3)

    def steps(net, opt, ks):
        step = ttr.make_train_step(net, opt)
        for k in ks:
            step(x[16 * k:16 * k + 16], y[16 * k:16 * k + 16])

    whole = _net()
    steps(whole, ttr.make_optimizer(whole, cfg), range(6))
    first = _net()
    opt = ttr.make_optimizer(first, cfg)
    steps(first, opt, range(3))
    path = str(tmp_path / "k.pt")
    ck.save_checkpoint(path, {"params": first.state_dict(), "opt_state": opt.state_dict()})
    loaded = ck.load_checkpoint(path)
    resumed = _net(seed=9)  # another init: the checkpoint overwrites it
    resumed.load_state_dict(loaded["params"])
    opt = ttr.make_optimizer(resumed, cfg)
    opt.load_state_dict(loaded["opt_state"])
    steps(resumed, opt, range(3, 6))
    assert _equal(resumed.state_dict(), whole.state_dict())


def test_resumed_epochs_equal_uninterrupted_epochs(tmp_path):
    s, c, e = _data()
    cfg = ttr.TrainConfig(num_epochs=3, batch_size=16, learning_rate=3e-3)
    whole_state, whole_hist = ttr.train_residual_model(_net(), s, c, e,
                                                       ttr.TrainConfig(**{**vars(cfg), "num_epochs": 5}))
    state, _ = ttr.train_residual_model(_net(), s, c, e, cfg)
    path = str(tmp_path / "e.pt")
    ck.save_checkpoint(path, ck.train_state_tree(state))
    loaded = ck.load_checkpoint(path)
    net = _net(seed=9)
    net.load_state_dict(loaded["params"])
    opt = ttr.make_optimizer(net, cfg)
    opt.load_state_dict(loaded["opt_state"])
    n_train = ttr._train_rows(len(s), 0.3, 1)
    orders = ttr._epoch_orders(n_train, cfg.seed, 5, s.device)[3:]
    resumed, hist = ttr._run(net, opt, s, c, e, cfg, ttr._split_permutation(len(s), cfg.seed, s.device),
                             orders)
    assert _equal(resumed.params, whole_state.params)
    assert _equal(resumed.opt_state, whole_state.opt_state)
    assert hist["val_mse"] == whole_hist["val_mse"][3:]
