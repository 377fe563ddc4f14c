"""The port's generic MPPI tick and rollout against the JAX package.

* the plain versions ``generic_mppi_tick_plain`` / ``generic_rollout_costs_plain``
  against the JAX ``generic_mppi_tick`` / ``generic_rollout_costs``
  (Pallas in interpret mode, injected ε) at the JAX tests' size (K = 256,
  T = 10, tests/test_generic_tick.py:46), over the four tile-step families,
  no obstacles / circle / soft with drift, SUM / LAST, W = 8 and 40 (the
  JAX kernel's hoisted and loop window paths), wrap-yaw, the fused epilogue,
  and k_offset 0 and 128; tolerances of tests/test_generic_tick.py:114-123
  (S rtol/atol 3e-4; w rtol 3e-4 atol 1e-6; controls rtol 1e-4 atol 1e-5);
* ``MPPISolver(fused_tick=True, tile_dynamics=four_wheel_torque_tile(DT),
  device="cpu")`` against the JAX ``mppi_step`` with
  ``make_generic_fused_tick(interpret=True)`` on the same injected ε, one
  tick and a 5-tick closed loop; the split route
  (``make_cuda_generic_rollout``) against the JAX split route;
* ``params_from_numpy`` / ``state_from_numpy`` on the example's (4, 4) Σ and
  4-column path; the guards.

On the CPU the wrappers run the plain versions; the kernels are held against
them on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models import dynamics as jdyn
from dnn_mppi_mpc_tpu.models import tile as jtile
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.ops.pallas import generic_tick as jgen
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch import models as tmodels
from dnn_mppi_mpc_tpu_torch.models import tile as ttile
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern
from dnn_mppi_mpc_tpu_torch.ops.filters import filter_matrix
from dnn_mppi_mpc_tpu_torch.ops.sampling import sigma_inverse, small_cholesky
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

K, T, DT = 256, 10, 0.05

# family -> (nx, nu, port tile, JAX tile, control bounds)
FAMILIES = {
    "unicycle": (3, 2, ttile.unicycle_tile(DT), jtile.unicycle_tile(DT, sincos="native"), 2.0),
    "kinematic_bicycle": (4, 2, ttile.kinematic_bicycle_tile(DT, 2.5),
                          jtile.kinematic_bicycle_tile(DT, 2.5, sincos="native"), 0.5),
    "four_wheel_torque": (5, 4, ttile.four_wheel_torque_tile(DT),
                          jtile.four_wheel_torque_tile(DT, sincos="native"), 2.0),
    "dynamic_bicycle": (4, 2, ttile.dynamic_bicycle_tile(DT), jtile.dynamic_bicycle_tile(DT), 0.4),
}
OBSTACLES = np.array([[0.525, 0.163, 0.05], [0.3, -0.35, 0.1]], np.float32)
VELOCITIES = np.array([[0.4, -0.2], [-0.3, 0.3]], np.float32)


def _path(ncols, n=80, seed=7):
    rng = np.random.default_rng(seed)
    cols = [np.linspace(0.0, 4.0, n), np.sin(np.linspace(0.0, 2.0, n))]
    for _ in range(ncols - 2):
        cols.append(rng.normal(0.0, 0.4, n).cumsum() * 0.1)
    return np.stack(cols, 1).astype(np.float32)


def _inputs(family, W, n_track, obstacles, drift, seed=11):
    """One tick's inputs as numpy, made from ``seed``."""
    nx, nu, _, _, bound = FAMILIES[family]
    rng = np.random.default_rng(seed)
    A = rng.normal(0.0, 0.2, (nu, nu))
    sigma = A @ A.T + 0.05 * np.eye(nu)
    u = rng.normal(0.0, 0.3, (T, nu))
    x0 = rng.uniform(-0.1, 0.1, nx)
    x0[2] = 0.3  # a yaw in [0, 2π): the wrapped yaw stays near the path's
    if nx >= 4:
        x0[3] = 0.8  # a speed: the bicycles move
    lo = -np.full(nu, 2.0)
    hi = np.full(nu, 2.0)
    if family == "kinematic_bicycle":
        lo[0], hi[0] = -bound, bound
    if family == "dynamic_bicycle":
        lo[1], hi[1] = -bound, bound
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        u=f(u), a=f(0.56 * u @ np.linalg.inv(sigma)), chol=f(np.linalg.cholesky(sigma)),
        x0=f(x0), window=_path(max(n_track, 2))[3:3 + W], stage_w=f(rng.uniform(1.0, 6.0, n_track)),
        term_w=f(rng.uniform(2.0, 9.0, n_track)), u_min=f(lo), u_max=f(hi),
        eps=f(rng.multivariate_normal(np.zeros(nu), sigma, (K, T))),
        obstacles=OBSTACLES if obstacles else None, velocities=VELOCITIES if drift else None,
    )


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _run_tick(family, W, n_track, *, obstacles=False, drift=False, collision="circle",
              last=False, wrap=False, fuse=False):
    nx, nu, ttl, jtl, _ = FAMILIES[family]
    p = _inputs(family, W, n_track, obstacles, drift)
    ft = np.ascontiguousarray(filter_matrix("ma_edge", T, 5).T, np.float32)
    common = dict(dt=DT, n_exploit=0.75 * K, robot_radius=0.1, soft_safety_distance=1.2,
                  soft_weight=4.0)
    static = dict(nx=nx, nu=nu, n_track=n_track, K=K, T=T, W=W, wrap_yaw=wrap, last_only=last,
                  collision=collision, fuse_epilogue=fuse)
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        jout = jgen.generic_mppi_tick(
            jnp.zeros((), jnp.int32), _j(p["u"]), _j(p["a"]), _j(p["chol"]), _j(p["x0"]),
            _j(p["window"]), _j(p["stage_w"]), _j(p["term_w"]), _j(p["u_min"]), _j(p["u_max"]),
            inv_temperature=jnp.float32(1.0 / 0.8), obstacles=_j(p["obstacles"]),
            eps=_j(p["eps"]), obstacle_velocities=_j(p["velocities"]),
            filter_t=_j(ft) if fuse else None, step_tile=jtl, interpret=True, **common, **static)
    finally:
        jax.config.update("jax_enable_x64", old)
    tout = kern.generic_mppi_tick(
        None, _t(p["u"]), _t(p["a"]), _t(p["chol"]), _t(p["x0"]), _t(p["window"]),
        _t(p["stage_w"]), _t(p["term_w"]), _t(p["u_min"]), _t(p["u_max"]),
        inv_temperature=1.0 / 0.8, obstacles=_t(p["obstacles"]), eps=_t(p["eps"]),
        obstacle_velocities=_t(p["velocities"]), filter_t=_t(ft) if fuse else None,
        step_tile=ttl, **common, **static)
    return jout, tout


TICK_CASES = {
    "unicycle none W8": ("unicycle", 8, 3, {}),
    "unicycle circle LAST W40": ("unicycle", 40, 3, dict(obstacles=True, last=True)),
    "kinematic_bicycle wrap circle W8": ("kinematic_bicycle", 8, 4,
                                         dict(obstacles=True, wrap=True, hits=True)),
    "kinematic_bicycle wrap soft_drift W40 epilogue": (
        "kinematic_bicycle", 40, 4,
        dict(obstacles=True, drift=True, collision="soft", wrap=True, fuse=True)),
    "four_wheel_torque none W8 epilogue": ("four_wheel_torque", 8, 3, dict(fuse=True)),
    "four_wheel_torque circle_drift LAST W40": (
        "four_wheel_torque", 40, 3, dict(obstacles=True, drift=True, last=True, hits=True)),
    "dynamic_bicycle soft_drift W8": ("dynamic_bicycle", 8, 2,
                                      dict(obstacles=True, drift=True, collision="soft")),
    "dynamic_bicycle wrap circle LAST W40 epilogue": (
        "dynamic_bicycle", 40, 3, dict(obstacles=True, wrap=True, last=True, fuse=True)),
}


@pytest.mark.parametrize("case", list(TICK_CASES))
def test_generic_tick_plain_matches_jax(case):
    family, W, n_track, kw = TICK_CASES[case]
    kw = dict(kw)
    hits = kw.pop("hits", False)
    calls = kern.generic_mppi_tick_plain.calls
    jout, tout = _run_tick(family, W, n_track, **kw)
    assert kern.generic_mppi_tick_plain.calls == calls + 1
    (jS, jw, jweps), (tS, tw, tweps) = jout[:3], tout[:3]
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(tweps.numpy(), np.asarray(jweps), rtol=1e-4, atol=1e-5)
    if hits:  # some rollouts, not all, reach an obstacle
        assert 0.0 < float((np.asarray(jS) > 1e6).mean()) < 1.0
    if kw.get("fuse"):
        for got, want in zip(tout[3], jout[3]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


ROLLOUT_CASES = {
    f"{family} k_offset={k_off}": (family, k_off) for family in FAMILIES for k_off in (0, 128)
}


@pytest.mark.parametrize("case", list(ROLLOUT_CASES))
def test_generic_rollout_plain_matches_jax(case):
    family, k_off = ROLLOUT_CASES[case]
    nx, nu, ttl, jtl, _ = FAMILIES[family]
    n_track = 3 if nx > 3 else 2
    W = 40 if k_off else 8
    p = _inputs(family, W, n_track, obstacles=True, drift=bool(k_off), seed=12)
    kw = dict(dt=DT, n_exploit=0.5 * 2 * K, robot_radius=0.1, safety_margin_rate=1.0,
              soft_safety_distance=1.2, soft_weight=4.0, k_offset=float(k_off), nx=nx, nu=nu,
              n_track=n_track, T=T, W=W, wrap_yaw=n_track >= 3, collision="circle")
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        jS = jgen.generic_rollout_costs(
            _j(p["eps"]), _j(p["u"]), _j(p["a"]), _j(p["x0"]), _j(p["window"]),
            _j(p["stage_w"]), _j(p["term_w"]), _j(p["u_min"]), _j(p["u_max"]),
            obstacles=_j(p["obstacles"]), obstacle_velocities=_j(p["velocities"]),
            step_tile=jtl, interpret=True, **kw)
    finally:
        jax.config.update("jax_enable_x64", old)
    tS = kern.generic_rollout_costs(
        _t(p["eps"]), _t(p["u"]), _t(p["a"]), _t(p["x0"]), _t(p["window"]), _t(p["stage_w"]),
        _t(p["term_w"]), _t(p["u_min"]), _t(p["u_max"]), obstacles=_t(p["obstacles"]),
        obstacle_velocities=_t(p["velocities"]), step_tile=ttl, **kw)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), rtol=3e-4, atol=3e-4)


# --- the solver, one tick and a closed loop ------------------------------------------


def _cfg_kw(nx, nu, **kw):
    base = dict(num_samples=K, horizon=T, dim_x=nx, dim_u=nu, dt=DT, lam=0.8, alpha=0.3,
                exploration=0.25, filter_window=5, waypoint_search_len=8)
    base.update(kw)
    return base


def _four_wheel(obstacles=None, **cfg_kw):
    """(JAX side, port side) of the four-wheel problem of
    tests/test_generic_tick.py: cfg, params, plant, stage, terminal."""
    kw = _cfg_kw(5, 4, **cfg_kw)
    rng = np.random.default_rng(5)
    A = rng.normal(0, 0.2, (4, 4))
    p = dict(sigma=np.asarray(A @ A.T + 0.05 * np.eye(4), np.float32),
             stage_weight=np.array([4.0, 4.0, 0.5], np.float32),
             terminal_weight=np.array([9.0, 9.0, 2.0], np.float32),
             u_min=np.full(4, -2.0, np.float32), u_max=np.full(4, 2.0, np.float32),
             ref_path=_path(3, n=40), obstacles=obstacles)
    jc, tc = jcfg.MPPIConfig(**kw), tcfg.MPPIConfig(**kw)
    jp = jcfg.MPPIParams(**{k: _j(v) for k, v in p.items()})
    tp = tcfg.params_from_numpy(**p, device="cpu")
    collision = "none" if obstacles is None else "circle"
    jside = (jc, jp, lambda x, u: j_euler(jdyn.four_wheel_torque, x, u, DT),
             *jmppi.make_tracking_costs(jc, collision=collision, robot_radius=0.4))
    tside = (tc, tp, lambda x, u: tmodels.euler_step(tmodels.four_wheel_torque, x, u, DT),
             *tmppi.make_tracking_costs(tc, collision=collision, robot_radius=0.4))
    return jside, tside


def _noise(sigma, seed):
    rng = np.random.default_rng(seed)
    return rng.multivariate_normal(np.zeros(sigma.shape[0]), np.asarray(sigma, np.float64),
                                   (K, T)).astype(np.float32)


def _key_words(key):
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key).astype(np.int64).tolist()


@pytest.mark.parametrize("fuse", [True, False], ids=["epilogue", "xla_tail"])
def test_solver_generic_tick_closed_loop_matches_jax(fuse):
    jside, tside = _four_wheel(obstacles=np.array([[1.2, 0.3, 0.3]], np.float32))
    jc, jp, jstep, jsc, jtc = jside
    tc, tp, tstep, tsc, ttc = tside
    jtick = jmppi.make_generic_fused_tick(jc, jtile.four_wheel_torque_tile(DT, sincos="native"),
                                          robot_radius=0.4, interpret=True, fuse_epilogue=fuse)
    jrun = jax.jit(lambda p, s, x, n: jmppi.mppi_step(jc, jstep, jsc, jtc, p, s, x, n,
                                                      tick_fn=jtick))
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, fused_tick=True, robot_radius=0.4,
                              tile_dynamics=ttile.four_wheel_torque_tile(DT),
                              fuse_epilogue=fuse, device="cpu")
    assert solver.tick_fn.__qualname__.startswith("make_cuda_generic_tick.")
    x_j = jnp.array([0.1, -0.05, 0.2, 0.3, 0.05], jnp.float32)
    x_t = torch.tensor([0.1, -0.05, 0.2, 0.3, 0.05])
    st_j = jmppi.MPPIState(u_prev=jnp.zeros((T, 4), jnp.float32),
                           waypoint_idx=jnp.zeros((), jnp.int32), key=jnp.asarray([3, 4], jnp.uint32))
    st_t = tmppi.state_from_numpy(np.zeros((T, 4)), 0, [3, 4], device="cpu")
    for i in range(5):
        eps = _noise(tp.sigma.numpy(), 40 + i)
        u_j, st_j, aux_j = jrun(jp, st_j, x_j, jnp.asarray(eps))
        u_t, st_t, aux_t = solver.step(tp, st_t, x_t, torch.as_tensor(eps))
        if i == 0:  # one tick: the JAX test's tolerances
            np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs),
                                       rtol=3e-4, atol=3e-4)
            np.testing.assert_allclose(aux_t.weights.numpy(), np.asarray(aux_j.weights),
                                       rtol=3e-4, atol=1e-6)
            np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-4, atol=1e-5)
        x_j, x_t = jstep(x_j, u_j), tstep(x_t, u_t)
        # the closed loop: trajectories as tests/test_torch_mppi.py holds them
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev),
                                   rtol=1e-3, atol=1e-4)
        assert int(st_t.waypoint_idx) == int(st_j.waypoint_idx)
        assert st_t.key.tolist() == _key_words(st_j.key)
        assert int(aux_t.status) == int(aux_j.status)


def test_split_generic_rollout_matches_jax():
    jside, tside = _four_wheel(obstacles=np.array([[1.0, 0.4, 0.3]], np.float32))
    jc, jp, jstep, jsc, jtc = jside
    tc, tp, tstep, tsc, ttc = tside
    jroll = jmppi.make_generic_pallas_rollout(
        jc, jtile.four_wheel_torque_tile(DT, sincos="native"), collision="circle",
        robot_radius=0.4, interpret=True)
    troll = tmppi.make_cuda_generic_rollout(tc, ttile.four_wheel_torque_tile(DT),
                                            collision="circle", robot_radius=0.4)
    eps = _noise(tp.sigma.numpy(), 9)
    u_prev = np.random.default_rng(0).normal(0, 0.3, (T, 4)).astype(np.float32)
    x0 = np.array([0.1, -0.05, 0.2, 0.3, 0.05], np.float32)
    st_j = jmppi.MPPIState(u_prev=jnp.asarray(u_prev), waypoint_idx=jnp.asarray(2, jnp.int32),
                           key=jax.random.PRNGKey(0))
    u_j, st_j, aux_j = jax.jit(
        lambda p, s, x, n: jmppi.mppi_step(jc, jstep, jsc, jtc, p, s, x, n, rollout_fn=jroll)
    )(jp, st_j, jnp.asarray(x0), jnp.asarray(eps))
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, rollout_fn=troll, device="cpu")
    calls = kern.generic_rollout_costs_plain.calls
    u_t, st_t, aux_t = solver.step(tp, tmppi.state_from_numpy(u_prev, 2, [0, 0], device="cpu"),
                                   torch.as_tensor(x0), torch.as_tensor(eps))
    assert kern.generic_rollout_costs_plain.calls == calls + 1
    np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev), rtol=1e-4, atol=1e-5)


def test_example_params_and_state_carry_over():
    """The example's (4, 4) Σ, 4-column path and obstacles go through
    params_from_numpy unchanged; the nu = 4 state through state_from_numpy."""
    path = np.concatenate([np.stack([np.linspace(0, 8, 200), np.linspace(0, -4, 200),
                                     np.full(200, np.arctan2(-4.0, 8.0))], 1),
                           np.full((200, 1), 1.5)], 1).astype(np.float32)
    p = dict(sigma=0.6 * np.eye(4), stage_weight=[8.0, 8.0, 1.0, 3.0],
             terminal_weight=[12.0, 12.0, 2.0, 3.0], u_min=np.full(4, -2.5),
             u_max=np.full(4, 2.5), ref_path=path, obstacles=[[3.0, -1.2, 0.5], [5.5, -3.0, 0.5]])
    tp = tcfg.params_from_numpy(**p, device="cpu")
    jp = jcfg.MPPIParams(**{k: jnp.asarray(np.asarray(v, np.float32)) for k, v in p.items()})
    for f in dataclasses.fields(tp):
        got, want = getattr(tp, f.name), getattr(jp, f.name)
        if want is None:
            assert got is None
        else:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u_prev = np.random.default_rng(1).normal(0, 0.5, (25, 4)).astype(np.float32)
    st = tmppi.state_from_numpy(u_prev, 7, [1, 2], device="cpu")
    assert st.u_prev.shape == (25, 4) and torch.equal(st.u_prev, torch.as_tensor(u_prev))
    assert int(st.waypoint_idx) == 7 and st.key.tolist() == [1, 2]


# --- guards ---------------------------------------------------------------------------


def _guard_setup(**cfg_kw):
    _, (tc, tp, tstep, tsc, ttc) = _four_wheel(**cfg_kw)
    return tc, tp, tstep, tsc, ttc


GUARDS = {
    "repeats": (dict(num_rollout_repeats=2), dict(), "num_rollout_repeats"),
    "waypoint_carry_rollout": (dict(waypoint_carry="rollout"), dict(), "waypoint_carry"),
    "polygon": ({}, dict(collision="polygon"), "polygon"),
    "gaussian_popcount": ({}, dict(gaussian="popcount"), "gaussian"),
    "time_varying_without_takes_t": (dict(time_varying_dynamics=True), dict(),
                                     "time_varying_dynamics"),
    "tile_nx_not_dim_x": (dict(dim_x=4), dict(), "nx=5"),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_generic_tick_guards_raise_at_construction(case):
    cfg_kw, solver_kw, match = GUARDS[case]
    tc, tp, tstep, tsc, ttc = _guard_setup(**cfg_kw)
    with pytest.raises(ValueError, match=match):
        tmppi.MPPISolver(tc, tstep, tsc, ttc, fused_tick=True,
                         tile_dynamics=ttile.four_wheel_torque_tile(DT), device="cpu", **solver_kw)


def test_generic_guards_weight_mismatch_and_split_repeats():
    tc, tp, tstep, tsc, ttc = _guard_setup()
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, fused_tick=True,
                              tile_dynamics=ttile.four_wheel_torque_tile(DT), device="cpu")
    bad = dataclasses.replace(tp, terminal_weight=torch.tensor([9.0, 9.0]))
    with pytest.raises(ValueError, match="n_track"):
        solver.step(bad, solver.init(), torch.zeros(5))
    with pytest.raises(ValueError, match="num_rollout_repeats"):
        tmppi.make_cuda_generic_rollout(dataclasses.replace(tc, num_rollout_repeats=3),
                                        ttile.four_wheel_torque_tile(DT))


def test_sigma_factors_are_computed_once_per_params_object():
    """The generic binders reuse Σ's factor and inverse while the params
    object stays the same, and compute them again for a new one."""
    _, (tc, tp, *_) = _four_wheel()
    factors = tmppi._SigmaFactors()
    chol, inverse = factors(tp)
    assert factors(tp)[0] is chol and factors(tp)[1] is inverse
    tp2 = dataclasses.replace(tp, sigma=2.0 * tp.sigma)
    chol2, inverse2 = factors(tp2)
    assert torch.equal(chol2, small_cholesky(tp2.sigma))
    assert torch.equal(inverse2, sigma_inverse(tp2.sigma))
    assert not torch.equal(chol2, chol)


def test_kernel_refuses_what_it_cannot_run():
    """A lifted step, a time-varying step and the per-rollout carry have no
    kernel: the check that guards the CUDA launch raises, naming the
    built-in families; on CPU tensors a lifted step runs."""
    lifted = ttile.lift_dynamics(lambda x, u: x)
    with pytest.raises(ValueError, match="four_wheel_torque"):
        kern.generic_tick.kernel_model(lifted, False)
    with pytest.raises(ValueError, match="step_takes_t"):
        kern.generic_tick.kernel_model(ttile.unicycle_tile(DT), True)
    with pytest.raises(ValueError, match="rollout_carry"):
        kern.generic_tick.kernel_model(ttile.unicycle_tile(DT), False, True)
    assert kern.generic_tick.kernel_model(ttile.dynamic_bicycle_tile(DT), False) == 3
    with pytest.raises(ValueError, match="shared memory"):
        kern.generic_tick.check_staging(50, 3000, 4, 4, 2)
    kern.generic_tick.check_staging(20, 200, 4, 2, 2)  # the race car's shape fits


def test_tile_dynamics_on_the_card_refuses_a_lifted_step(monkeypatch):
    tc, tp, tstep, tsc, ttc = _guard_setup()
    # the check comes before anything touches the card, so it runs here
    monkeypatch.setattr(tmppi, "resolve_device", lambda d: torch.device("cuda"))
    with pytest.raises(ValueError, match="lift_dynamics"):
        tmppi.MPPISolver(tc, tstep, tsc, ttc, fused_tick=True,
                         tile_dynamics=ttile.lift_dynamics(tstep), device="cuda")
