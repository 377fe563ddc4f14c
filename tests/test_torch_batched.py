"""The port's sampled trajectories, batched scan-path step, scan-path fleet
and ``MPPIParams.model_params`` against the JAX package, on the CPU.

* ``sampled_trajectories`` (and ``MPPISolver.sampled_trajectories``) against
  JAX's on the same injected ε and costs: the same samples in the same
  order (a stable sort, ties in sample order), the states within 1e-6;
  ``test_sampled_trajectories_thread_t``'s case (time-varying dynamics, top
  10 %, costs all zero: sample 0 first, re-rolled by hand);
* ``make_batched_mppi_step`` at world size 1 (gloo) against ``jax.vmap`` of
  JAX's ``mppi_step`` on four scenarios with their own Σ, paths, starts and
  keys, ε injected: u0 and the next states within rtol 1e-5, atol 1e-6
  (tests/test_sharding.py's limits), costs within 1e-4; its own draws are
  ε = z·Lᵀ a scenario from ``step.generator``;
* ``make_sharded_mppi_fleet(fused=False)`` at world size 1 equal to the
  batched step on the broadcast params, bit for bit, shared and per-member
  paths; without the costs it raises, as JAX's;
* ``model_params``: a Python float rides through the tick
  (tests/test_mppi_features.py:234), numpy leaves go to the device as
  float32 (integers keep their dtype), other leaves pass as they are, and
  ``MPPIParams.to`` moves its tensors.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch import parallel
from dnn_mppi_mpc_tpu_torch.models import euler_step, unicycle
from dnn_mppi_mpc_tpu_torch.ops.sampling import small_cholesky
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

K, T, DT, B = 64, 8, 0.05, 4
CFG = dict(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT, lam=0.8, alpha=0.3,
           exploration=0.25, filter_window=5, waypoint_search_len=8)


def _path(n=40, phase=0.0):
    s = np.linspace(0, 2, n)
    return np.stack([np.linspace(0, 4, n), np.sin(s + phase), 0.1 * s], 1).astype(np.float32)


def _leaves(sigma_scale=1.0, phase=0.0):
    return dict(sigma=np.array([[0.1, 0.0], [0.0, 0.05]], np.float32) * sigma_scale,
                stage_weight=np.array([5.0, 5.0, 1.0], np.float32),
                terminal_weight=np.array([6.0, 6.0, 2.0], np.float32),
                u_min=np.array([-2.0, -1.5], np.float32),
                u_max=np.array([2.0, 1.5], np.float32), ref_path=_path(phase=phase))


def _j_dyn(x, u):
    return j_euler(j_unicycle, x, u, DT)


def _t_dyn(x, u):
    return euler_step(unicycle, x, u, DT)


# --- sampled trajectories ------------------------------------------------------------------


@pytest.mark.parametrize("top_fraction", [1.0, 0.1, 0.001])
def test_sampled_trajectories_match_jax(top_fraction):
    rng = np.random.default_rng(1)
    p = _leaves()
    noise = (rng.normal(size=(K, T, 2)) * 0.4).astype(np.float32)
    costs = np.round(rng.random(K) * 8).astype(np.float32)  # ties: the stable order
    u_prev = (rng.normal(size=(T, 2)) * 0.3).astype(np.float32)
    x0 = np.array([0.1, 0.2, 0.3], np.float32)
    jc = jcfg.MPPIConfig(**CFG)
    jst = jmppi.MPPIState(u_prev=jnp.asarray(u_prev), waypoint_idx=jnp.asarray(0, jnp.int32),
                          key=jax.random.PRNGKey(0))
    want = jmppi.sampled_trajectories(jc, _j_dyn, jcfg.MPPIParams(**{
        k: jnp.asarray(v) for k, v in p.items()}), jst, jnp.asarray(x0), jnp.asarray(noise),
        jnp.asarray(costs), top_fraction=top_fraction)
    cfg = tcfg.MPPIConfig(**CFG)
    solver = tmppi.MPPISolver(cfg, _t_dyn, *tmppi.make_tracking_costs(cfg), device="cpu")
    got = solver.sampled_trajectories(tcfg.params_from_numpy(**p, device="cpu"),
                                      tmppi.state_from_numpy(u_prev, 0, [0, 0], device="cpu"),
                                      torch.as_tensor(x0), torch.as_tensor(noise),
                                      torch.as_tensor(costs), top_fraction=top_fraction)
    assert got.shape == want.shape == (max(1, int(K * top_fraction)), T, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_sampled_trajectories_thread_t():
    """Time-varying dynamics F(x, u, t): t reaches every step (JAX's
    test_sampled_trajectories_thread_t, K = 256, T = 10, top 10 %)."""
    def dyn_tv(x, u, t):
        decay = 1.0 / (1.0 + 0.1 * t * DT)
        v, w, yaw = u[..., 0] * decay, u[..., 1] * decay, x[..., 2]
        return torch.stack([x[..., 0] + v * torch.cos(yaw) * DT,
                            x[..., 1] + v * torch.sin(yaw) * DT, yaw + w * DT], -1)

    Kt, Tt = 256, 10
    cfg = tcfg.MPPIConfig(**dict(CFG, num_samples=Kt, horizon=Tt, time_varying_dynamics=True))
    p = tcfg.params_from_numpy(**_leaves(), device="cpu")
    noise = torch.as_tensor(np.random.default_rng(5).normal(size=(Kt, Tt, 2)) * 0.5,
                            dtype=torch.float32)
    x0 = torch.tensor([0.0, 0.2, 0.1])
    trajs = tmppi.sampled_trajectories(cfg, dyn_tv, p, tmppi.MPPIState.init(cfg, device="cpu"),
                                       x0, noise, torch.zeros(Kt), top_fraction=0.1)
    assert trajs.shape == (Kt // 10, Tt, 3)
    x = x0
    for t in range(Tt):
        x = dyn_tv(x, torch.clamp(noise[0, t], p.u_min, p.u_max), t)
        torch.testing.assert_close(trajs[0, t], x, rtol=0, atol=1e-6)


# --- the batched step ---------------------------------------------------------------------


@pytest.fixture
def gloo_world1():
    assert not dist.is_initialized()
    assert parallel.initialize_distributed(device="cpu") == (0, 1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _scenarios():
    """B scenarios: their own Σ and paths (every leaf batched), starts,
    nominal sequences, window starts and keys, and injected ε."""
    rng = np.random.default_rng(2)
    per = [_leaves(sigma_scale=1.0 + 0.3 * b, phase=0.2 * b) for b in range(B)]
    leaves = {k: np.stack([q[k] for q in per]) for k in per[0]}
    u_prev = (rng.normal(size=(B, T, 2)) * 0.3).astype(np.float32)
    wp = np.array([0, 2, 1, 3])
    keys = np.stack([np.arange(B), np.full(B, 9)], 1).astype(np.uint32)
    x0s = (rng.normal(size=(B, 3)) * 0.2).astype(np.float32)
    eps = (rng.normal(size=(B, K, T, 2)) * 0.3).astype(np.float32)
    return leaves, u_prev, wp, keys, x0s, eps


def _port_batch(leaves, u_prev, wp, keys):
    return (tcfg.params_from_numpy(**leaves, device="cpu"),
            tmppi.state_from_numpy(u_prev, wp, keys, device="cpu"))


def test_batched_step_matches_jax_vmap(gloo_world1):
    leaves, u_prev, wp, keys, x0s, eps = _scenarios()
    jc = jcfg.MPPIConfig(**CFG)
    stage, terminal = jmppi.make_tracking_costs(jc)
    jparams = jcfg.MPPIParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jst = jmppi.MPPIState(u_prev=jnp.asarray(u_prev), waypoint_idx=jnp.asarray(wp, jnp.int32),
                          key=jnp.asarray(keys))
    ju0, jnext, jaux = jax.vmap(lambda p, s, x, n: jmppi.mppi_step(
        jc, _j_dyn, stage, terminal, p, s, x, n))(jparams, jst, jnp.asarray(x0s),
                                                  jnp.asarray(eps))
    cfg = tcfg.MPPIConfig(**CFG)
    step = parallel.make_batched_mppi_step(cfg, _t_dyn, *tmppi.make_tracking_costs(cfg),
                                           device="cpu")
    assert step.members(B) == slice(0, B)
    params, states = _port_batch(leaves, u_prev, wp, keys)
    u0, nxt, aux = step(params, states, torch.as_tensor(x0s), torch.as_tensor(eps))
    np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nxt.u_prev.numpy(), np.asarray(jnext.u_prev), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(nxt.waypoint_idx.numpy(), np.asarray(jnext.waypoint_idx))
    # the carried key advances by the port's Weyl step (the scan path's ε is
    # injected here; JAX splits its key instead)
    assert torch.equal(nxt.key, tmppi.advance_key(states.key))
    np.testing.assert_allclose(aux.costs.numpy(), np.asarray(jaux.costs), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(aux.status.numpy(), np.asarray(jaux.status))
    with pytest.raises(ValueError, match="noise has shape"):
        step(params, states, torch.as_tensor(x0s), torch.as_tensor(eps[:, :8]))


def test_batched_step_draws_each_scenario_from_its_sigma(gloo_world1):
    leaves, u_prev, wp, keys, x0s, _ = _scenarios()
    cfg = tcfg.MPPIConfig(**CFG)
    step = parallel.make_batched_mppi_step(cfg, _t_dyn, *tmppi.make_tracking_costs(cfg),
                                           device="cpu", seed=4)
    params, states = _port_batch(leaves, u_prev, wp, keys)
    drawn = step(params, states, torch.as_tensor(x0s))
    gen = torch.Generator().manual_seed(4)  # rank 0: the seed itself
    z = torch.randn((B, K, T, 2), generator=gen, dtype=torch.float64)
    chol = torch.stack([small_cholesky(s) for s in params.sigma.double()])
    eps = (z.unsqueeze(-2) * chol[:, None, None]).sum(-1).float()
    again = parallel.make_batched_mppi_step(cfg, _t_dyn, *tmppi.make_tracking_costs(cfg),
                                            device="cpu")(params, states, torch.as_tensor(x0s),
                                                          eps)
    for a, b in zip((drawn[0], drawn[1].u_prev, drawn[2].costs),
                    (again[0], again[1].u_prev, again[2].costs)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("per_member_path", [False, True])
def test_sharded_scan_fleet_world1_equals_the_batched_step(gloo_world1, per_member_path):
    leaves, u_prev, wp, keys, x0s, _ = _scenarios()
    cfg = tcfg.MPPIConfig(**CFG)
    stage, terminal = tmppi.make_tracking_costs(cfg)
    shared = {k: v[0] for k, v in leaves.items()}
    if per_member_path:
        shared["ref_path"] = leaves["ref_path"]
    fleet = parallel.make_sharded_mppi_fleet(cfg, _t_dyn, fused=False, stage_cost=stage,
                                             terminal_cost=terminal, device="cpu", seed=3)
    params, states = _port_batch(shared, u_prev, wp, keys)
    got = fleet(params, states, torch.as_tensor(x0s))
    batched = parallel.make_batched_mppi_step(cfg, _t_dyn, stage, terminal, device="cpu", seed=3)
    full = {k: np.broadcast_to(v, (B,) + v.shape) if v.ndim == leaves[k].ndim - 1 else v
            for k, v in shared.items()}
    want = batched(*_port_batch(full, u_prev, wp, keys), torch.as_tensor(x0s))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].u_prev, want[1].u_prev)
    with pytest.raises(ValueError, match="stage_cost"):
        parallel.make_sharded_mppi_fleet(cfg, _t_dyn, fused=False, device="cpu")


# --- model_params ---------------------------------------------------------------------------


def test_mppi_step_accepts_non_array_model_params():
    """A Python float in ``model_params`` rides through the tick
    (tests/test_mppi_features.py:234)."""
    cfg = tcfg.MPPIConfig(num_samples=64, horizon=6, dim_x=3, dim_u=2, dt=0.05,
                          waypoint_search_len=4)
    gain = 0.9

    def step_fn(x, u, g=gain):
        return euler_step(unicycle, x, u * g, cfg.dt)

    params = tcfg.params_from_numpy(np.eye(2) * 0.1, [5.0, 5.0, 1.0], [5.0, 5.0, 1.0],
                                    [-2.0, -2.0], [2.0, 2.0], np.zeros((10, 3)),
                                    model_params=0.5, device="cpu")
    assert params.model_params == 0.5
    solver = tmppi.MPPISolver(cfg, step_fn, *tmppi.make_tracking_costs(cfg), device="cpu")
    u0, _, _ = solver.step(params, solver.init(), torch.zeros(3))
    assert bool(torch.isfinite(u0).all())


def test_params_from_numpy_carries_model_params():
    tree = {"w": np.ones((2, 3)), "n": np.arange(3, dtype=np.int32), "gain": 0.5,
            "layers": [np.zeros(2), "tanh"], "tag": ("a", np.float64(2.0))}
    p = tcfg.params_from_numpy(np.eye(2), np.ones(3), np.ones(3), -np.ones(2), np.ones(2),
                               np.zeros((4, 3)), model_params=tree, device="cpu")
    mp = p.model_params
    assert mp["w"].dtype == torch.float32 and mp["w"].shape == (2, 3)
    assert mp["n"].dtype == torch.int32 and mp["n"].tolist() == [0, 1, 2]
    assert mp["gain"] == 0.5 and mp["layers"][1] == "tanh" and mp["tag"][0] == "a"
    assert isinstance(mp["layers"][0], torch.Tensor) and isinstance(mp["tag"], tuple)
    moved = p.to("cpu")
    assert moved.model_params["gain"] == 0.5 and torch.equal(moved.model_params["w"], mp["w"])
    # the JAX package carries the same leaves (unify_float_dtype)
    unified = jmppi.unify_float_dtype(jcfg.MPPIParams(
        sigma=jnp.eye(2), stage_weight=jnp.ones(3), terminal_weight=jnp.ones(3),
        u_min=-jnp.ones(2), u_max=jnp.ones(2), ref_path=jnp.zeros((4, 3)),
        model_params={"w": jnp.ones((2, 3)), "gain": 0.5}), jnp.float32)
    assert unified.model_params["gain"] == 0.5
    np.testing.assert_array_equal(np.asarray(unified.model_params["w"]), mp["w"].numpy())
