"""The port's PPO (``train/rl.py``) against the JAX package's, on the CPU.

* ``gaussian_log_prob`` (rtol 1e-6, atol 1e-7) and ``compute_gae`` (rtol
  1e-6, atol 1e-6: XLA contracts the recurrence's multiply-adds into fused
  ones, one rounding fewer a step, so over 12 steps of returns up to ~5 an
  advantage near 0 is off by float32 rounding of the large terms) against
  JAX, and GAE at λ = 1 against plain discounted returns;
* ``ActorCritic`` and ``PixelActorCritic`` forward against Flax ``apply``
  with Flax's parameters carried across by ``load_flax_actor_critic``
  (rtol 1e-5, atol 1e-6); the pixel case at 48 × 48 (Flax's 'SAME' pads
  (0, 1) at stride 2) and at 15 × 15 (it pads (1, 1)), which also holds the
  (H, W, C) flatten order; the loader's guards; the initialization (an
  orthogonal mean head of gain 0.01, log_std −0.5);
* ``clip_by_global_norm_`` against ``optax.clip_by_global_norm`` below and
  above the norm (rtol 1e-6, atol 1e-8);
* ``PPOConfig`` and ``Transition`` against JAX's fields;
* a short PPO run on tests/test_train_extras.py:74-84's point-goal task
  (16 environments, rollout 64, 20 iterations) whose late mean reward beats
  its early one.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_mppi_mpc_tpu.train import rl as jrl
from dnn_mppi_mpc_tpu_torch.train import rl as trl


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(name, got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    print(f"{name}: max abs err {float(np.abs(got - want).max()):.3e} (rtol {rtol}, atol {atol})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def test_log_prob_and_gae_match_jax():
    rng = np.random.default_rng(0)
    mean, action = (rng.normal(size=(7, 2)).astype(np.float32) for _ in range(2))
    std = rng.uniform(0.2, 1.0, 2).astype(np.float32)
    _close("log prob", trl.gaussian_log_prob(*map(torch.from_numpy, (mean, std, action))),
           jrl.gaussian_log_prob(*map(jnp.asarray, (mean, std, action))), 1e-6, 1e-7)
    T, N = 12, 5
    rewards, values = (rng.normal(size=(T, N)).astype(np.float32) for _ in range(2))
    dones = (rng.uniform(size=(T, N)) < 0.2).astype(np.float32)
    last = rng.normal(size=N).astype(np.float32)
    got = trl.compute_gae(*map(torch.from_numpy, (rewards, values, dones, last)), 0.99, 0.95)
    want = jrl.compute_gae(*map(jnp.asarray, (rewards, values, dones, last)), 0.99, 0.95)
    _close("advantages", got[0], want[0], 1e-6, 1e-6)
    _close("returns", got[1], want[1], 1e-6, 1e-6)
    adv, ret = trl.compute_gae(torch.ones(5, 1), torch.zeros(5, 1), torch.zeros(5, 1),
                               torch.zeros(1), gamma=0.9, lam=1.0)
    _close("λ = 1 returns", ret[:, 0], [sum(0.9 ** k for k in range(5 - t)) for t in range(5)],
           1e-6, 0.0)


@pytest.mark.parametrize("depth", [1, 2])
def test_actor_critic_matches_flax(depth):
    jm = jrl.ActorCritic(act_dim=2, hidden=32, depth=depth)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3), jnp.float32))
    variables = jax.tree_util.tree_map(lambda a: a + 0.01, variables)  # a non-zero mean head
    tm = trl.load_flax_actor_critic(trl.ActorCritic(2, 32, depth, obs_dim=3, device="cpu"),
                                    _np(variables))
    obs = np.random.default_rng(1).normal(size=(4, 6, 3)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(obs))
    with torch.no_grad():
        got = tm(torch.from_numpy(obs))
    for name, g, w in zip(("mean", "std", "value"), got, want):
        assert g.shape == w.shape, name
        _close(f"ActorCritic depth {depth} {name}", g, w, 1e-5, 1e-6)


@pytest.mark.parametrize("size,features", [(48, (16, 32, 32)), (15, (4, 8))])
def test_pixel_actor_critic_matches_flax(size, features):
    jm = jrl.PixelActorCritic(act_dim=2, features=features, hidden=32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32))
    variables = jax.tree_util.tree_map(lambda a: a + 0.01, variables)
    tm = trl.load_flax_actor_critic(
        trl.PixelActorCritic(2, features, 32, size=size, device="cpu"), _np(variables))
    obs = np.random.default_rng(2).uniform(size=(2, 3, size, size, 3)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(obs))
    with torch.no_grad():
        got = tm(torch.from_numpy(obs))
    for name, g, w in zip(("mean", "std", "value"), got, want):
        assert g.shape == w.shape, name
        _close(f"PixelActorCritic {size}x{size} {name}", g, w, 1e-5, 1e-6)
    assert trl._same_pad(48) == (0, 1) and trl._same_pad(15) == (1, 1)


def test_loader_guards_and_init():
    jm = jrl.ActorCritic(act_dim=2, hidden=8, depth=2)
    tree = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3), jnp.float32)))["params"]
    tm = trl.ActorCritic(2, 8, 2, obs_dim=3, device="cpu", generator=torch.Generator().manual_seed(0))
    for bad in ({k: v for k, v in tree.items() if k != "Dense_3"}, {**tree, "Dense_9": tree["Dense_0"]},
                {**tree, "Dense_5": {"kernel": np.zeros((8, 2), np.float32),
                                     "bias": np.zeros(2, np.float32)}}):
        with pytest.raises(ValueError):
            trl.load_flax_actor_critic(tm, bad)
    w = tm.mean_head.weight.detach()
    _close("orthogonal(0.01) head", w @ w.T, 1e-4 * torch.eye(2), 0.0, 1e-9)
    assert torch.equal(tm.log_std.detach(), torch.full((2,), -0.5))
    assert not tm.mean_head.bias.any()


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((4, 3), (3,), (2, 2))]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = trl.clip_by_global_norm_(params, 0.5)
    want, _ = optax.clip_by_global_norm(0.5).update([jnp.asarray(g) for g in grads], None)
    assert (float(norm) < 0.5) == (scale == 0.01)
    for i, (p, w) in enumerate(zip(params, want)):
        _close(f"clipped grad {i} (scale {scale})", p.grad, w, 1e-6, 1e-8)


def test_config_and_transition_match_jax():
    assert dataclasses.asdict(trl.PPOConfig()) == dataclasses.asdict(jrl.PPOConfig())
    assert trl.Transition._fields == jrl.Transition._fields


def test_ppo_learns_point_goal():
    """The point-goal task on all environments at once; 20 iterations of 16
    environments × 64 steps: the mean reward of the last five beats the
    first five's."""
    dt = 0.1

    def env_reset(n, gen):
        return torch.rand((n, 2), generator=gen) * 2.0 - 1.0

    def env_step(states, actions, gen):
        a = actions.clamp(-1.0, 1.0)
        nxt = (states + dt * a).clamp(-1.5, 1.5)
        return nxt, -(nxt ** 2).sum(-1) - 0.01 * (a ** 2).sum(-1), nxt.norm(dim=-1) < 0.05

    cfg = trl.PPOConfig(num_envs=16, rollout_length=64, learning_rate=1e-3)
    model = trl.ActorCritic(act_dim=2, hidden=32, depth=2, obs_dim=2, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    init_fn, train_iteration = trl.make_ppo_trainer(cfg, model, env_step, env_reset)
    opt, gen = init_fn(), torch.Generator().manual_seed(0)
    states = env_reset(cfg.num_envs, gen)
    rewards = []
    for _ in range(20):
        states, m = train_iteration(opt, states, gen)
        assert set(m) == {"loss", "mean_reward", "mean_value"} and m["loss"].dim() == 0
        rewards.append(float(m["mean_reward"]))
    early, late = np.mean(rewards[:5]), np.mean(rewards[-5:])
    print(f"PPO point goal: early {early:.4f}, late {late:.4f}")
    assert late > early, (early, late)
