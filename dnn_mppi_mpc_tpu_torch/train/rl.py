"""PPO actor-critic RL on batched tensor environments — counterpart of
``dnn_mppi_mpc_tpu/train/rl.py``.

* :class:`ActorCritic` — a Gaussian policy and a value over separate tanh
  MLP trunks; :class:`PixelActorCritic` — the same heads over separate
  strided-conv trunks on channels-last frames (``envs.render.raster_scene``);
* :class:`PPOConfig`, :class:`Transition`, :func:`gaussian_log_prob`,
  :func:`compute_gae` (the reverse recurrence);
* :func:`make_ppo_trainer` — ``(init_fn, train_iteration)``: a rollout of
  ``rollout_length`` steps over every environment at once, GAE, then
  ``num_epochs`` × ``num_minibatches`` clipped-surrogate Adam steps after
  optax's global-norm clip;
* :func:`load_flax_actor_critic` — a Flax variable tree (numpy leaves) into
  either module.

The environment contract is batched, as ``envs.collect_residual_dataset``'s
is: ``env_step(states, actions, generator) -> (next_states, reward, done)``
acts on all N environments' (N, …) states and (N, act_dim) actions and
returns (N,) rewards and (N,) bool ``done``; ``env_reset(n, generator)``
returns n fresh states. Where JAX splits keys, these draw from the
``torch.Generator`` they are handed. The whole iteration is a Python loop
over device tensors with nothing in it that waits for the card; its
metrics come back as 0-d device tensors.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device
from ..models.learned import _check_names, _copy, _lecun_normal_, _linear, _load_dense, _np_leaf
from ..ops.filters import full_f32

LOG_STD_INIT = -0.5
STD_FLOOR = 1e-3


def _mean_head(hidden: int, act_dim: int, generator) -> nn.Linear:
    """Flax's ``orthogonal(0.01)`` kernel and zero bias."""
    layer = _linear(hidden, act_dim, generator, zero=True)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=0.01, generator=generator)
    return layer


def _std(log_std: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.exp(log_std), STD_FLOOR)


class ActorCritic(nn.Module):
    """Gaussian policy and value over separate tanh MLP trunks (the actor's
    and the critic's each ``depth`` × tanh(Linear(·, hidden))): the mean
    head (orthogonal init, gain 0.01), a state-independent ``log_std``
    (−0.5 at init; std floored at 1e-3) and the value head. ``obs_dim`` is
    the observation's width (Flax infers it). ``forward(obs)`` returns
    (mean (…, act_dim), std (act_dim,), value (…))."""

    def __init__(self, act_dim: int, hidden: int = 128, depth: int = 2, *, obs_dim: int,
                 device="cuda", generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        dims = [obs_dim] + [hidden] * depth
        self.actor = nn.ModuleList(_linear(a, b, generator) for a, b in zip(dims, dims[1:]))
        self.mean_head = _mean_head(hidden, act_dim, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), LOG_STD_INIT))
        self.critic = nn.ModuleList(_linear(a, b, generator) for a, b in zip(dims, dims[1:]))
        self.value_head = _linear(hidden, 1, generator)
        self.to(device)

    def forward(self, obs: torch.Tensor):
        with full_f32():
            a, v = obs, obs
            for layer in self.actor:
                a = torch.tanh(layer(a))
            for layer in self.critic:
                v = torch.tanh(layer(v))
            return self.mean_head(a), _std(self.log_std), self.value_head(v)[..., 0]


def _same_pad(n: int, k: int = 3, s: int = 2) -> tuple:
    """Flax's 'SAME' padding of one axis of n: (low, high), the odd pixel
    on the high side — (0, 1) for a 3-wide stride-2 conv on an even n,
    which ``nn.Conv2d``'s symmetric ``padding`` cannot express."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _ConvTrunk(nn.Module):
    """3 × 3 stride-2 'SAME' convs with tanh, flattened in Flax's (H, W, C)
    order, then tanh(Linear(·, hidden))."""

    def __init__(self, in_channels: int, size: int, features: Sequence[int], hidden: int,
                 generator) -> None:
        super().__init__()
        convs, c = [], in_channels
        for f in features:
            conv = nn.utils.skip_init(nn.Conv2d, c, f, 3, stride=2, device="cpu")
            with torch.no_grad():
                _lecun_normal_(conv.weight, generator)
                conv.bias.zero_()
            convs.append(conv)
            size, c = -(-size // 2), f
        self.convs = nn.ModuleList(convs)
        self.dense = _linear(size * size * c, hidden, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            (top, bottom), (left, right) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = torch.tanh(conv(F.pad(x, (left, right, top, bottom))))
        # flatten in (H, W, C) order, as Flax's reshape of a channels-last map
        return torch.tanh(self.dense(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))


class PixelActorCritic(nn.Module):
    """Gaussian policy and value over separate strided-conv trunks on
    channels-last (…, size, size, in_channels) frames: each trunk runs
    ``features`` 3 × 3 stride-2 'SAME' tanh convs and tanh(Linear(·,
    hidden)); the heads are :class:`ActorCritic`'s. ``forward(obs)``
    returns (mean, std, value)."""

    def __init__(self, act_dim: int, features: Sequence[int] = (16, 32, 32), hidden: int = 128,
                 *, size: int = 48, in_channels: int = 3, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.actor = _ConvTrunk(in_channels, size, features, hidden, generator)
        self.mean_head = _mean_head(hidden, act_dim, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), LOG_STD_INIT))
        self.critic = _ConvTrunk(in_channels, size, features, hidden, generator)
        self.value_head = _linear(hidden, 1, generator)
        self.to(device)

    def forward(self, obs: torch.Tensor):
        batch = obs.shape[:-3]
        x = obs.reshape((-1,) + obs.shape[-3:])
        with full_f32():
            mean = self.mean_head(self.actor(x))
            value = self.value_head(self.critic(x))[..., 0]
        return mean.reshape(batch + mean.shape[-1:]), _std(self.log_std), value.reshape(batch)


def _load_conv(conv: nn.Conv2d, tree: Mapping, where: str) -> None:
    _check_names(tree, ["kernel", "bias"], where)
    # Flax kernels are (kh, kw, c_in, c_out); Conv2d weights (c_out, c_in, kh, kw)
    _copy(conv.weight, _np_leaf(tree, "kernel", where).transpose(3, 2, 0, 1), f"{where}/kernel")
    _copy(conv.bias, _np_leaf(tree, "bias", where), f"{where}/bias")


def load_flax_actor_critic(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a Flax ``train.rl.ActorCritic`` or ``PixelActorCritic`` tree
    (``{"params": …}`` or the inner dict, numpy leaves) into ``model``, in
    the order Flax names the layers. ActorCritic: ``Dense_i`` are the
    actor's trunk, the mean head, the critic's trunk, the value head.
    PixelActorCritic: ``Conv_i`` the actor's convs, then the critic's;
    ``Dense_0`` the actor's trunk, ``Dense_1`` the mean head, ``Dense_2`` the
    value head (Flax builds ``nn.Dense(1)`` before it runs the critic's
    trunk for its argument), ``Dense_3`` the critic's trunk. ``log_std``
    beside them. A missing, extra or misshapen entry raises ``ValueError``."""
    p = variables.get("params", variables)
    if isinstance(model, PixelActorCritic):
        convs = list(model.actor.convs) + list(model.critic.convs)
        denses = [model.actor.dense, model.mean_head, model.value_head, model.critic.dense]
    else:
        convs = []
        denses = [*model.actor, model.mean_head, *model.critic, model.value_head]
    names = ([f"Conv_{i}" for i in range(len(convs))] + [f"Dense_{i}" for i in range(len(denses))]
             + ["log_std"])
    _check_names(p, names, f"{type(model).__name__} params")
    for i, conv in enumerate(convs):
        _load_conv(conv, p[f"Conv_{i}"], f"Conv_{i}")
    for i, layer in enumerate(denses):
        _load_dense(layer, p[f"Dense_{i}"], f"Dense_{i}")
    _copy(model.log_std, np.asarray(p["log_std"], np.float32), "log_std")
    return model


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    clip_eps: float = 0.2
    gamma: float = 0.99
    gae_lambda: float = 0.95
    learning_rate: float = 3.0e-4
    rollout_length: int = 128
    num_envs: int = 32
    num_epochs: int = 4
    num_minibatches: int = 4
    value_coef: float = 0.5
    entropy_coef: float = 1.0e-3
    max_grad_norm: float = 0.5


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    value: torch.Tensor


def gaussian_log_prob(mean: torch.Tensor, std: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """log N(action; mean, diag(std²)), summed over the last axis."""
    z = (action - mean) / std
    return torch.sum(-0.5 * z ** 2 - torch.log(std) - 0.5 * math.log(2.0 * math.pi), dim=-1)


def compute_gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
                last_value: torch.Tensor, gamma: float, lam: float):
    """Generalized advantage estimates over (T, N) rewards, values and dones
    by the reverse recurrence δ_t = r_t + γ·V_{t+1}·(1 − d_t) − V_t,
    A_t = δ_t + γλ·(1 − d_t)·A_{t+1}; returns (advantages, advantages +
    values)."""
    gae, next_value = torch.zeros_like(last_value), last_value
    out = [None] * rewards.shape[0]
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        out[t], next_value = gae, values[t]
    advantages = torch.stack(out)
    return advantages, advantages + values


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the parameters' ``.grad``: the
    gradients are left alone while their global norm g is below
    ``max_norm`` and become g_i / g · max_norm once it is not.
    ``torch.nn.utils.clip_grad_norm_`` would differ: it always scales, by
    max_norm / (g + 1e-6) clamped at 1. Runs on the device (a ``where``, no
    host read); returns g."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))
    return g_norm


def make_ppo_trainer(cfg: PPOConfig, model: nn.Module,
                     env_step: Callable, env_reset: Callable,
                     obs_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """``(init_fn, train_iteration)`` for batched environments (module
    docstring). ``init_fn()`` returns the optimizer (Adam at
    ``cfg.learning_rate`` over ``model``'s parameters; the module is
    already initialized). ``train_iteration(optimizer, env_states,
    generator)`` rolls every environment ``cfg.rollout_length`` steps
    (finished ones reset at once), computes GAE and runs the update on
    ``model`` in place; it returns (env_states, metrics) with metrics
    ``loss``, ``mean_reward`` and ``mean_value`` as 0-d device tensors.
    ``obs_fn`` maps the (N, …) states to policy observations (identity by
    default)."""
    if obs_fn is None:
        def obs_fn(s):
            return s
    params = [p for p in model.parameters()]

    def init_fn() -> torch.optim.Optimizer:
        return torch.optim.Adam(params, lr=cfg.learning_rate)

    def rollout(env_states, gen):
        steps = []
        with torch.no_grad():
            for _ in range(cfg.rollout_length):
                obs = obs_fn(env_states)
                mean, std, value = model(obs)
                action = mean + std * torch.randn(mean.shape, generator=gen, device=mean.device)
                logp = gaussian_log_prob(mean, std, action)
                nxt, reward, done = env_step(env_states, action, gen)
                fresh = env_reset(env_states.shape[0], gen)
                nxt = torch.where(done.reshape(done.shape + (1,) * (nxt.dim() - 1)), fresh, nxt)
                steps.append(Transition(obs, action, logp, reward, done.to(reward.dtype), value))
                env_states = nxt
            last_value = model(obs_fn(env_states))[2]
        return env_states, Transition(*(torch.stack(f) for f in zip(*steps))), last_value

    def update(optimizer, traj: Transition, last_value, gen):
        adv, returns = compute_gae(traj.reward, traj.value, traj.done, last_value, cfg.gamma,
                                   cfg.gae_lambda)
        # the population std, as jnp.std: torch.std defaults to the unbiased one
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        batch = Transition(*(f.reshape((-1,) + f.shape[2:]) for f in traj))
        adv_f, ret_f = adv.reshape(-1), returns.reshape(-1)
        n = adv_f.shape[0]
        mb = n // cfg.num_minibatches
        losses = []
        for _ in range(cfg.num_epochs):
            perm = torch.randperm(n, generator=gen, device=adv_f.device)
            for i in range(cfg.num_minibatches):
                idx = perm[i * mb:(i + 1) * mb]

                def take(t):
                    return t.index_select(0, idx)

                optimizer.zero_grad(set_to_none=True)
                with full_f32():
                    mean, std, value = model(take(batch.obs))
                    ratio = torch.exp(gaussian_log_prob(mean, std, take(batch.action))
                                      - take(batch.log_prob))
                    a = take(adv_f)
                    # the clipped surrogate
                    surr = torch.minimum(ratio * a, torch.clamp(ratio, 1.0 - cfg.clip_eps,
                                                                1.0 + cfg.clip_eps) * a)
                    policy_loss = -torch.mean(surr)
                    value_loss = torch.mean((value - take(ret_f)) ** 2)
                    entropy = torch.mean(torch.sum(
                        torch.log(std) + 0.5 * (1 + math.log(2 * math.pi)), dim=-1))
                    total = (policy_loss + cfg.value_coef * value_loss
                             - cfg.entropy_coef * entropy)
                    total.backward()
                    clip_by_global_norm_(params, cfg.max_grad_norm)
                    optimizer.step()
                losses.append(total.detach())
        return torch.stack(losses).reshape(cfg.num_epochs, cfg.num_minibatches).mean(1).mean()

    def train_iteration(optimizer, env_states, generator):
        env_states, traj, last_value = rollout(env_states, generator)
        loss = update(optimizer, traj, last_value, generator)
        return env_states, {"loss": loss, "mean_reward": traj.reward.mean(),
                            "mean_value": traj.value.mean()}

    return init_fn, train_iteration


__all__ = [
    "ActorCritic",
    "PPOConfig",
    "PixelActorCritic",
    "Transition",
    "clip_by_global_norm_",
    "compute_gae",
    "gaussian_log_prob",
    "load_flax_actor_critic",
    "make_ppo_trainer",
]
