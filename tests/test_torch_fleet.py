"""The port's fleet tick against the JAX package.

* ``fleet_mppi_tick`` (on the CPU: ``fleet_mppi_tick_plain``) against the
  JAX ``fleet_mppi_tick(gaussian="hash", interpret=True, sincos="native")``
  at B = 3, K = 256, T = 8, W = 8: the same hash stream bit for bit, so S
  agrees to float32 rounding (rtol 2e-5, atol 2e-4, as
  tests/test_torch_mppi_tick.py holds the blocked tick), w to the softmax's
  (rtol 2e-4, atol 1e-6) and Σw·ε to the reductions' order (rtol 1e-4,
  atol 1e-5);
* ``weighted_noise_reduce`` and the ``s_only`` blocked tick with a non-zero
  block offset against their JAX kernels (ε atol 1e-6: the Box-Muller
  transcendentals; S and Σw·ε as above);
* the port's fleet step against the JAX scan-path ``mppi_step`` of each
  member fed that member's hash ε (JAX ``weighted_noise_reduce(emit_eps=
  True)`` at the member's seed, one block of K) — the pattern of
  tests/test_fleet_tick.py:88-120 with the hash stream in place of the TPU's
  generator; S rtol/atol 2e-4, w rtol 2e-4 atol 1e-6, controls rtol 1e-4
  atol 1e-5 (tests/test_mppi_tick.py:121-130);
* the guards, the carry of a JAX fleet's params and states, and the
  ``mppi_fleet`` preset against the JAX suite's row.

The JAX side runs with x64 off, as tests/test_fleet_tick.py:38-44 does for
gridded Pallas kernels.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.ops.pallas.mppi_tick_blocked import diffdrive_mppi_tick_blocked as j_blocked
from dnn_mppi_mpc_tpu.ops.pallas.mppi_tick_blocked import fleet_mppi_tick as j_fleet
from dnn_mppi_mpc_tpu.ops.pallas.mppi_tick_blocked import weighted_noise_reduce as j_wnr
from dnn_mppi_mpc_tpu.paths import line as j_line
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch import presets
from dnn_mppi_mpc_tpu_torch.models import euler_step, unicycle
from dnn_mppi_mpc_tpu_torch.ops.cuda import mppi_tick_blocked as tblocked
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

B, K, T, W, DT = 3, 256, 8, 8, 0.05
SIGMA = np.array([[0.09, 0.0], [0.0, 0.04]], np.float32)
CHOL = np.linalg.cholesky(SIGMA.astype(np.float64)).astype(np.float32)
WEYL = np.array([0x9E3779B9, 0x85EBCA6B], np.uint64)


@pytest.fixture(autouse=True)
def _f32_mode():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _path(n=40, shift=0.0):
    return np.stack([np.linspace(0, 4, n), np.sin(np.linspace(0, 2, n)) + shift,
                     np.linspace(0.1, 0.5, n)], 1).astype(np.float32)


# --- the kernel --------------------------------------------------------------

FLEET_CASES = {
    "none": dict(),
    "circle": dict(obstacles=True),
    "soft_drift": dict(obstacles=True, drift=True, collision="soft"),
    "iso_xy": dict(obstacles=True, iso_xy=True),
    "last": dict(last_only=True),
}


def _fleet_inputs(seed=0):
    rng = np.random.default_rng(seed)
    windows = np.stack([_path(shift=0.2 * b)[3 * b:3 * b + W] for b in range(B)])
    return dict(
        seeds=np.array([11, 2**31 - 5, 77777], np.int64),
        u=rng.normal(0, 0.3, (B, T, 2)).astype(np.float32),
        a=rng.normal(0, 0.3, (B, T, 2)).astype(np.float32),
        chol=CHOL,
        x0=rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32),
        windows=windows,
        sw=np.array([3.0, 3.0, 1.0], np.float32),
        tw=np.array([5.0, 5.0, 2.0], np.float32),
        u_min=np.array([-2.0, -1.5], np.float32),
        u_max=np.array([2.0, 1.5], np.float32),
        obstacles=rng.uniform(0.0, 1.2, (B, 2, 3)).astype(np.float32) * [1, 1, 0.4],
        velocities=rng.normal(0, 0.5, (B, 2, 2)).astype(np.float32),
    )


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_fleet_tick_plain_matches_jax(case):
    spec = FLEET_CASES[case]
    x = _fleet_inputs()
    order = ["u", "a", "chol", "x0", "windows", "sw", "tw", "u_min", "u_max"]
    obs = x["obstacles"] if spec.get("obstacles") else None
    vel = x["velocities"] if spec.get("drift") else None
    common = dict(B=B, K=K, T=T, W=W, last_only=spec.get("last_only", False),
                  collision=spec.get("collision", "circle"), iso_xy=spec.get("iso_xy", False))
    n_exploit, inv_t = 0.8 * K, 1.25
    j = j_fleet(
        jnp.asarray(x["seeds"].astype(np.int32)), *(jnp.asarray(x[k]) for k in order), DT,
        n_exploit, inv_t, obstacles=None if obs is None else jnp.asarray(obs),
        obstacle_velocities=None if vel is None else jnp.asarray(vel),
        interpret=True, gaussian="hash", sincos="native", **common,
    )
    tblocked.fleet_mppi_tick_plain.calls = 0
    t = tblocked.fleet_mppi_tick(
        torch.as_tensor(x["seeds"]), *(torch.as_tensor(x[k]) for k in order), DT, n_exploit,
        inv_t, obstacles=None if obs is None else torch.as_tensor(obs),
        obstacle_velocities=None if vel is None else torch.as_tensor(vel), **common,
    )
    assert tblocked.fleet_mppi_tick_plain.calls == 1  # CPU tensors: the plain version
    (jS, jw, jweps), (tS, tw, tweps) = [np.asarray(v) for v in j], [v.numpy() for v in t]
    assert tS.shape == (B, K) and tweps.shape == (B, T, 2)
    np.testing.assert_allclose(tS, jS, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(tw, jw, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(tweps, jweps, rtol=1e-4, atol=1e-5)
    if obs is not None and not spec.get("drift"):
        assert (tS > 1e6).any()  # some rollouts reach an obstacle


def test_fleet_member_is_the_single_block_stream():
    """Member b of the fleet is the blocked tick with seed b and K_BLK = K
    (the JAX fleet's per-member parity oracle)."""
    x = _fleet_inputs(1)
    order = ["u", "a", "chol", "x0", "windows", "sw", "tw", "u_min", "u_max"]
    S, _, w_eps = tblocked.fleet_mppi_tick(
        torch.as_tensor(x["seeds"]), *(torch.as_tensor(x[k]) for k in order), DT, 0.8 * K,
        1.25, B=B, K=K, T=T, W=W,
    )
    for b in range(B):
        one = [torch.as_tensor(x[k][b] if x[k].ndim > 2 or k in ("x0", "windows") else x[k])
               for k in order]
        Sb, _, _, wb = tblocked.diffdrive_mppi_tick_blocked(
            torch.as_tensor(x["seeds"][b:b + 1]), *one, DT, 0.8 * K, 1.25, K=K, T=T, W=W,
            K_BLK=K,
        )
        torch.testing.assert_close(S[b], Sb, rtol=0, atol=0)
        torch.testing.assert_close(w_eps[b], wb, rtol=1e-6, atol=1e-7)


def test_weighted_noise_reduce_plain_matches_jax():
    Kw, KB, offset = 512, 128, 3
    rng = np.random.default_rng(4)
    w = rng.random(Kw).astype(np.float32)
    w /= w.sum()
    jweps, jeps = j_wnr(jnp.asarray(424242, jnp.int32), jnp.asarray(w), jnp.asarray(CHOL), offset,
                        K=Kw, T=T, K_BLK=KB, interpret=True, gaussian="hash", emit_eps=True)
    tweps, teps = tblocked.weighted_noise_reduce_plain(
        torch.tensor([424242]), torch.as_tensor(w), torch.as_tensor(CHOL), offset, K=Kw, T=T,
        K_BLK=KB, emit_eps=True)
    np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tweps.numpy(), np.asarray(jweps), rtol=1e-4, atol=1e-5)
    # the wrapper on CPU tensors is the plain version
    got = tblocked.weighted_noise_reduce(torch.tensor([424242]), torch.as_tensor(w),
                                         torch.as_tensor(CHOL), offset, K=Kw, T=T, K_BLK=KB)
    torch.testing.assert_close(got, tweps, rtol=0, atol=0)


def test_s_only_blocked_plain_matches_jax():
    """Phase 1 of the sharded tick: shard 1 of 2 (k_offset = 512, block
    offset 4 of 128-sample blocks) with the exploration split inside it."""
    Ks, KB, k_offset, block_offset = 512, 128, 512.0, 4
    x = _fleet_inputs(2)
    order = ["u", "a", "chol", "x0", "windows", "sw", "tw", "u_min", "u_max"]
    one = {k: (x[k][0] if k in ("u", "a", "x0", "windows") else x[k]) for k in order}
    obs = x["obstacles"][0]
    n_exploit = 0.8 * 2 * Ks  # the global split falls inside this shard
    common = dict(K=Ks, T=T, W=W, K_BLK=KB, s_only=True)
    jS = j_blocked(jnp.asarray(99, jnp.int32), *(jnp.asarray(one[k]) for k in order), DT,
                   n_exploit, 1.25, jnp.asarray(obs), 0.5, 1.5, None, 2.0, 100.0, k_offset,
                   block_offset, gaussian="hash", interpret=True, **common)
    tS = tblocked.diffdrive_mppi_tick_blocked(
        torch.tensor([99]), *(torch.as_tensor(one[k]) for k in order), DT, n_exploit, 1.25,
        torch.as_tensor(obs), 0.5, 1.5, None, 2.0, 100.0, k_offset, block_offset, **common)
    assert tS.shape == (Ks,)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), rtol=2e-5, atol=2e-4)


# --- the fleet step ------------------------------------------------------------


def _fleet_problem(per_member: bool):
    kw = dict(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT, lam=0.8, alpha=0.3,
              exploration=0.2, filter_window=5, waypoint_search_len=W)
    jc, tc = jcfg.MPPIConfig(**kw), tcfg.MPPIConfig(**kw)
    p = dict(
        sigma=SIGMA,
        stage_weight=np.array([3.0, 3.0, 1.0], np.float32),
        terminal_weight=np.array([5.0, 5.0, 2.0], np.float32),
        u_min=np.array([-2.0, -1.5], np.float32),
        u_max=np.array([2.0, 1.5], np.float32),
    )
    if per_member:
        p.update(ref_path=np.stack([_path(shift=0.3 * b) for b in range(B)]),
                 obstacles=np.array([[[1.0 + 0.2 * b, 0.6, 0.3], [2.2, 1.2 - 0.1 * b, 0.4]]
                                     for b in range(B)], np.float32),
                 obstacle_velocities=np.array([[[0.5, 0.3], [-0.4, 0.2 * b]] for b in range(B)],
                                              np.float32))
    else:
        p.update(ref_path=_path(), obstacles=np.array([[1.5, 0.5, 0.3]], np.float32))
    return jc, tc, p


@pytest.mark.parametrize("per_member", [False, True], ids=["shared_circle", "per_member_soft"])
def test_fleet_step_matches_per_member_jax_step(per_member):
    jc, tc, p = _fleet_problem(per_member)
    collision = "soft" if per_member else "circle"
    rng = np.random.default_rng(5)
    x0s = rng.uniform(-0.4, 0.4, (B, 3)).astype(np.float32)
    u_prev = rng.normal(0, 0.3, (B, T, 2)).astype(np.float32)
    keys = np.array([[0, b] for b in range(B)], np.uint32)
    keys[1] = [0xDEADBEEF, 0x12345678]
    wp = np.array([0, 3, 1], np.int64)

    fleet = tmppi.make_fleet_fused_mppi_step(tc, lambda x, u: euler_step(unicycle, x, u, DT),
                                             collision=collision, device="cpu")
    u0s, st, aux = fleet(tcfg.params_from_numpy(**p, device="cpu"),
                         tmppi.state_from_numpy(u_prev, wp, keys, device="cpu"),
                         torch.as_tensor(x0s))

    jstep = lambda x, u: j_euler(j_unicycle, x, u, DT)  # noqa: E731
    js, jt = jmppi.make_tracking_costs(jc, collision=collision)
    run = jax.jit(lambda pm, s, x, n: jmppi.mppi_step(jc, jstep, js, jt, pm, s, x, n))
    for b in range(B):
        pb = {k: (v[b] if per_member and k in ("ref_path", "obstacles", "obstacle_velocities")
                  else v) for k, v in p.items()}
        seed = np.int32(np.uint32(keys[b, 0] ^ keys[b, 1]).view(np.int32))
        _, eps = j_wnr(jnp.asarray(seed), jnp.zeros((K,), jnp.float32), jnp.asarray(CHOL), 0,
                       K=K, T=T, K_BLK=K, interpret=True, gaussian="hash", emit_eps=True)
        st_b = jmppi.MPPIState(u_prev=jnp.asarray(u_prev[b]), waypoint_idx=jnp.asarray(wp[b]),
                               key=jnp.asarray(keys[b]))
        u0_r, st_r, aux_r = run(jcfg.MPPIParams(**{k: jnp.asarray(v) for k, v in pb.items()}),
                                st_b, jnp.asarray(x0s[b]), eps)
        np.testing.assert_allclose(aux.costs[b].numpy(), np.asarray(aux_r.costs),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(aux.weights[b].numpy(), np.asarray(aux_r.weights),
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(u0s[b].numpy(), np.asarray(u0_r), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(st.u_prev[b].numpy(), np.asarray(st_r.u_prev),
                                   rtol=1e-4, atol=1e-5)
        assert int(st.waypoint_idx[b]) == int(st_r.waypoint_idx)
        assert int(aux.status[b]) == int(aux_r.status)
        # the fused ticks' Weyl advance of the raw key words (solvers/mppi.py:1589)
        want = ((keys[b].astype(np.uint64) + WEYL) % 2**32).astype(np.int64)
        assert st.key[b].tolist() == want.tolist()


def test_fleet_step_holds_each_member_on_its_own_nonfinite_update():
    _, tc, p = _fleet_problem(False)
    fleet = tmppi.make_fleet_fused_mppi_step(tc, lambda x, u: euler_step(unicycle, x, u, DT),
                                             device="cpu")
    u_prev = np.random.default_rng(6).normal(0, 0.3, (B, T, 2)).astype(np.float32)
    u_prev[1, 2, 0] = np.nan  # member 1's update is non-finite
    _, st, aux = fleet(tcfg.params_from_numpy(**p, device="cpu"),
                       tmppi.state_from_numpy(u_prev, np.zeros(B), [[0, b] for b in range(B)],
                                              device="cpu"),
                       torch.zeros(B, 3))
    assert aux.status.tolist()[1] & 2 and not aux.status.tolist()[0] & 2
    want = np.concatenate([u_prev[1, 1:], u_prev[1, -1:]])
    np.testing.assert_array_equal(st.u_prev[1].numpy(), want)
    assert bool(torch.isfinite(st.u_prev[0]).all()) and bool(torch.isfinite(st.u_prev[2]).all())


FLEET_GUARDS = {
    "repeats": (dict(num_rollout_repeats=2), {}, "num_rollout_repeats"),
    "sincos_poly": ({}, dict(sincos="poly"), "sincos"),
    "polygon": ({}, dict(collision="polygon"), "polygon"),
    "waypoint_carry": (dict(waypoint_carry="rollout"), {}, "waypoint_carry"),
}


@pytest.mark.parametrize("case", list(FLEET_GUARDS))
def test_fleet_guards_raise_at_construction(case):
    cfg_kw, kw, match = FLEET_GUARDS[case]
    _, tc, _ = _fleet_problem(False)
    with pytest.raises(ValueError, match=match):
        tmppi.make_fleet_fused_mppi_step(dataclasses.replace(tc, **cfg_kw),
                                         lambda x, u: x, device="cpu", **kw)


def test_fleet_runtime_guards_raise():
    _, tc, p = _fleet_problem(False)
    fleet = tmppi.make_fleet_fused_mppi_step(tc, lambda x, u: euler_step(unicycle, x, u, DT),
                                             device="cpu")
    states = tmppi.MPPIState.fleet(tc, [[0, b] for b in range(B)], device="cpu")
    params = tcfg.params_from_numpy(**p, device="cpu")
    with pytest.raises(ValueError, match="control_weight"):
        fleet(dataclasses.replace(params, control_weight=torch.tensor([0.1, 0.1])), states,
              torch.zeros(B, 3))
    iso = tmppi.make_fleet_fused_mppi_step(tc, lambda x, u: euler_step(unicycle, x, u, DT),
                                           iso_xy=True, device="cpu")
    asym = dataclasses.replace(params, stage_weight=torch.tensor([3.0, 2.0, 1.0]))
    with pytest.raises(ValueError, match="symmetric"):
        iso(asym, states, torch.zeros(B, 3))


def test_params_and_states_carry_a_jax_fleet():
    _, _, p = _fleet_problem(True)
    jp = jcfg.MPPIParams(**{k: jnp.asarray(v) for k, v in p.items()})
    jc = jcfg.MPPIConfig(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT)
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32))
    jst = jax.vmap(lambda k: jmppi.MPPIState.init(jc, k))(jkeys)
    jst = dataclasses.replace(jst, u_prev=jst.u_prev + jnp.arange(B, dtype=jnp.float32)[:, None, None])
    leaves = [np.asarray(getattr(jp, f.name)) if getattr(jp, f.name) is not None else None
              for f in dataclasses.fields(jp)]
    tp = tcfg.params_from_numpy(*leaves, device="cpu")
    assert tp.ref_path.shape == (B, 40, 3) and tp.obstacles.shape == (B, 2, 3)
    assert tp.obstacle_velocities.shape == (B, 2, 2)
    for name in ("ref_path", "obstacles", "obstacle_velocities", "sigma"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    kd = jax.random.key_data(jst.key) if jnp.issubdtype(jst.key.dtype, jax.dtypes.prng_key) \
        else jst.key
    ts = tmppi.state_from_numpy(np.asarray(jst.u_prev), np.asarray(jst.waypoint_idx),
                                np.asarray(kd), device="cpu")
    assert ts.u_prev.shape == (B, T, 2) and ts.waypoint_idx.shape == (B,)
    np.testing.assert_array_equal(ts.u_prev.numpy(), np.asarray(jst.u_prev))
    assert ts.key.tolist() == np.asarray(kd).astype(np.int64).tolist()
    # and MPPIState.fleet builds the same initial state from the raw keys
    fresh = tmppi.MPPIState.fleet(tcfg.MPPIConfig(num_samples=K, horizon=T, dim_x=3, dim_u=2,
                                                  dt=DT), np.asarray(kd), device="cpu")
    assert fresh.key.tolist() == ts.key.tolist() and fresh.u_prev.shape == (B, T, 2)


# --- the preset ---------------------------------------------------------------


def test_mppi_fleet_preset_matches_the_jax_suite_row():
    Bp, Kp, Tp = 4, 128, 10
    step, params, states, plant = presets.mppi_fleet(Bp, Kp, Tp, device="cpu")
    # the JAX suite's row (utils/benchsuite.py:223-258)
    jc = jcfg.MPPIConfig(num_samples=Kp, horizon=Tp, dim_x=3, dim_u=2, dt=0.05,
                         waypoint_search_len=20)
    for f in dataclasses.fields(step.cfg):
        tv = getattr(step.cfg, f.name)
        jv = getattr(jc, "use_pallas" if f.name == "use_kernel" else f.name)
        assert (tv.value if hasattr(tv, "value") else tv) == (
            jv.value if hasattr(jv, "value") else jv), f.name
    goals = np.random.default_rng(0).uniform(-4, 4, (Bp, 2)).astype(np.float32)
    paths = jnp.stack([j_line(jnp.zeros(2), jnp.asarray(g), num_points=80) for g in goals])
    np.testing.assert_allclose(params.ref_path.numpy(), np.asarray(paths), rtol=1e-6, atol=1e-6)
    for name, want in (("sigma", [[0.2, 0.0], [0.0, 0.1]]), ("stage_weight", [8.0, 8.0, 2.0]),
                       ("terminal_weight", [8.0, 8.0, 2.0]), ("u_min", [-3.0, -3.14]),
                       ("u_max", [3.0, 3.14])):
        np.testing.assert_array_equal(getattr(params, name).numpy(), np.float32(want))
    assert params.obstacles is None
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.arange(Bp, dtype=jnp.uint32))
    jkd = jax.random.key_data(jkeys) if jnp.issubdtype(jkeys.dtype, jax.dtypes.prng_key) \
        else jkeys
    assert states.key.tolist() == np.asarray(jkd).astype(np.int64).tolist()
    x = torch.zeros(Bp, 3)
    for _ in range(3):
        u0s, states, aux = step(params, states, x)
        x = plant(x, u0s)
    assert u0s.shape == (Bp, 2) and aux.costs.shape == (Bp, Kp)
    assert aux.status.tolist() == [0] * Bp and bool(torch.isfinite(x).all())
