"""Residual-dynamics regression training on ``torch.optim`` — counterpart of
``dnn_mppi_mpc_tpu/train/training.py``.

The JAX package's loop, point by point: split first with a permutation from
``seed``; fit the scalers on the train rows only (population std + 1e-8);
``bs = min(batch_size, n_train)`` and ``n_train // bs`` steps an epoch, the
remainder dropped; a fresh permutation every epoch; the epoch's train
MSE/MAE the mean of its steps' means, val MSE/MAE in eval mode over the
whole val split; Adam, or AdamW with ``weight_decay`` (optax's decoupled
decay is torch's AdamW). Conv models get the (B, 1, C) length axis.

Two differences are PyTorch's. The module arrives initialized (JAX calls
``model.init(PRNGKey(seed + 1))`` inside), and the run trains it in place.
``TrainState.params`` is the module's ``state_dict``, which carries the
BatchNorm buffers as the JAX ``params`` carries ``batch_stats``, and
``opt_state`` the optimizer's ``state_dict``.

Each step runs its forward and its backward in full float32
(``ops/filters.full_f32``: cuDNN would take TF32 for the convolutions by
default). Within an epoch nothing waits for the card: the steps' metrics
stay on the device and are read once, at the epoch's end, for the history.

``group`` (a ``torch.distributed`` process group) is the counterpart of
``mesh=``: the train rows are padded by repetition to a multiple of the
group's size, each rank steps on its share of every minibatch, and the
gradients (and the step's metrics) are all-reduced and averaged; BatchNorm
takes its batch statistics over the whole minibatch. At world size 1 the
run equals the run without a group bit for bit.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, ContextManager, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..models.learned import FlaxBatchNorm1d, ResNet1D, Standardizer
from ..ops.filters import full_f32


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters of the regression loop (the reference's defaults:
    Adam, lr 1e-3, MSE loss, minibatches over the residual-error dataset)."""

    learning_rate: float = 1.0e-3
    batch_size: int = 256
    num_epochs: int = 100
    weight_decay: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    """``params``: the module's ``state_dict`` (BatchNorm buffers included);
    ``opt_state``: the optimizer's ``state_dict``; the two scalers."""

    params: dict
    opt_state: dict
    in_scaler: Standardizer
    out_scaler: Standardizer


def prepare_residual_dataset(states: torch.Tensor, controls: torch.Tensor,
                             errors: torch.Tensor):
    """Standardized (state, control) features and residual-error targets,
    with the two scalers fitted on ALL rows (deployment preprocessing;
    :func:`train_residual_model` fits on the train split only). Returns
    (features, targets, in_scaler, out_scaler)."""
    feats = torch.cat([states, controls], dim=-1)
    in_scaler, out_scaler = Standardizer.fit(feats), Standardizer.fit(errors)
    return in_scaler.transform(feats), out_scaler.transform(errors), in_scaler, out_scaler


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> torch.optim.Optimizer:
    """Adam at ``cfg.learning_rate``, or AdamW with ``cfg.weight_decay``
    (optax's ``adamw``: the decay decoupled from the moments)."""
    if cfg.weight_decay:
        return torch.optim.AdamW(model.parameters(), lr=cfg.learning_rate,
                                 weight_decay=cfg.weight_decay)
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> Callable[[torch.Tensor, torch.Tensor], dict]:
    """One SGD step on (x, y): the module in train mode (BatchNorm on the
    batch's statistics, its running ones updated as Flax's are), MSE loss,
    its gradients, the optimizer's update, all in full float32; the module's
    mode is restored after. Returns ``{"mse", "mae"}`` as 0-d device
    tensors. The gradients stay in ``.grad`` until the next step. With
    ``group``, x and y are this rank's share of the minibatch: the gradients
    and metrics are averaged over the group, and the BatchNorm layers sum
    their batch statistics over it."""
    world = _world(group)
    for m in model.modules():
        if isinstance(m, FlaxBatchNorm1d):
            m.group = group
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x: torch.Tensor, y: torch.Tensor) -> dict:
        was_training = model.training
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with full_f32():
            diff = model(x) - y
            mse = torch.mean(diff * diff)
            mae = torch.mean(torch.abs(diff))
            mse.backward()
            metrics = torch.stack([mse.detach(), mae.detach()])
            if group is not None:
                grads = [p.grad for p in params]
                flat = torch.cat([g.reshape(-1) for g in grads] + [metrics])
                dist.all_reduce(flat, group=group)
                flat = flat / world
                for g, part in zip(grads, flat[:-2].split([g.numel() for g in grads])):
                    g.copy_(part.view_as(g))
                metrics = flat[-2:]
            optimizer.step()
        model.train(was_training)
        return {"mse": metrics[0], "mae": metrics[1]}

    return step


def _eval_metrics(model: nn.Module, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[MSE, MAE] of the module in eval mode (running statistics)."""
    was_training = model.training
    model.eval()
    with torch.no_grad(), full_f32():
        diff = model(x) - y
        out = torch.stack([torch.mean(diff * diff), torch.mean(torch.abs(diff))])
    model.train(was_training)
    return out


def _split_permutation(n: int, seed: int, device) -> torch.Tensor:
    return torch.randperm(n, generator=torch.Generator(device).manual_seed(seed), device=device)


def _epoch_orders(n_train: int, seed: int, num_epochs: int, device) -> list:
    """The per-epoch permutations of the train rows: ``num_epochs``
    successive draws from one generator seeded with ``seed + 2``."""
    gen = torch.Generator(device).manual_seed(seed + 2)
    return [torch.randperm(n_train, generator=gen, device=device) for _ in range(num_epochs)]


def _train_rows(n: int, val_fraction: float, world: int) -> int:
    """The train split's rows after the padding to a multiple of ``world``."""
    n_train = n - int(n * val_fraction)
    return n_train + (-n_train) % world


def _run(model: nn.Module, optimizer: torch.optim.Optimizer, states: torch.Tensor,
         controls: torch.Tensor, errors: torch.Tensor, cfg: TrainConfig, perm: torch.Tensor,
         orders: Sequence[torch.Tensor], group=None, val_fraction: float = 0.3,
         epoch_context: Optional[Callable[[], ContextManager]] = None):
    """The run of :func:`train_residual_model` on a given split permutation
    ``perm`` and per-epoch ``orders`` (one epoch each), from the module's and
    the optimizer's present state. ``epoch_context``, when given, is
    entered around each epoch's steps (a check such as
    ``torch.cuda.set_sync_debug_mode``; the epoch's metrics are read after
    it exits). Returns (TrainState, history)."""
    feats = torch.cat([states, controls], dim=-1)
    n_val = int(feats.shape[0] * val_fraction)
    feats, errs = feats[perm], errors[perm]
    f_train, e_train, f_val, e_val = feats[n_val:], errs[n_val:], feats[:n_val], errs[:n_val]
    in_scaler, out_scaler = Standardizer.fit(f_train), Standardizer.fit(e_train)
    x_train, y_train = in_scaler.transform(f_train), out_scaler.transform(e_train)
    x_val, y_val = in_scaler.transform(f_val), out_scaler.transform(e_val)

    world = _world(group)
    rank = 0 if group is None else dist.get_rank(group)
    pad = (-x_train.shape[0]) % world
    if pad:
        x_train = torch.cat([x_train, x_train[:pad]])
        y_train = torch.cat([y_train, y_train[:pad]])
    if isinstance(model, ResNet1D):  # conv models take a length axis: (B, L = 1, C)
        x_train, x_val = x_train[:, None, :], x_val[:, None, :]

    n_train = x_train.shape[0]
    bs = min(cfg.batch_size, n_train)
    if bs % world:
        raise ValueError(f"the minibatch of {bs} rows does not split evenly over {world} ranks")
    share = bs // world
    steps_per_epoch = max(1, n_train // bs)
    step = make_train_step(model, optimizer, group)
    context = epoch_context or contextlib.nullcontext
    history = {"train_mse": [], "train_mae": [], "val_mse": [], "val_mae": []}
    for order in orders:
        with context():
            ms = []
            for i in range(steps_per_epoch):
                idx = order[i * bs + rank * share: i * bs + (rank + 1) * share]
                ms.append(step(x_train.index_select(0, idx), y_train.index_select(0, idx)))
            epoch = torch.stack([torch.stack([m["mse"] for m in ms]).mean(),
                                 torch.stack([m["mae"] for m in ms]).mean()])
            values = torch.cat([epoch, _eval_metrics(model, x_val, y_val)])
        # the epoch's one read from the card
        for key, v in zip(history, values.tolist()):
            history[key].append(v)

    state = TrainState(params={k: v.detach().clone() for k, v in model.state_dict().items()},
                       opt_state=copy.deepcopy(optimizer.state_dict()),
                       in_scaler=in_scaler, out_scaler=out_scaler)
    return state, history


def train_residual_model(model: nn.Module, states: torch.Tensor, controls: torch.Tensor,
                         errors: torch.Tensor, cfg: TrainConfig = TrainConfig(),
                         group: Optional[dist.ProcessGroup] = None, val_fraction: float = 0.3):
    """Train ``model`` in place on the residual errors: split, standardize,
    minibatch Adam, per-epoch MSE/MAE curves. The data's device is the
    run's: the module must live there. The split permutation is drawn from
    a generator seeded with ``cfg.seed``, the epochs' from one seeded with
    ``cfg.seed + 2``. ``group``: data-parallel over a process group (module
    docstring). Returns (TrainState, history) with history's ``train_mse``,
    ``train_mae``, ``val_mse`` and ``val_mae`` lists of floats."""
    device = states.device
    perm = _split_permutation(states.shape[0], cfg.seed, device)
    n_train = _train_rows(states.shape[0], val_fraction, _world(group))
    orders = _epoch_orders(n_train, cfg.seed, cfg.num_epochs, device)
    return _run(model, make_optimizer(model, cfg), states, controls, errors, cfg, perm, orders,
                group, val_fraction)


__all__ = [
    "TrainConfig",
    "TrainState",
    "make_optimizer",
    "make_train_step",
    "prepare_residual_dataset",
    "train_residual_model",
]
