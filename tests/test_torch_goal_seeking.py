"""The port's diff-drive presets in closed loop against the JAX package, on
the CPU.

* ``presets.diff_drive_mppi`` and ``presets.goal_seeking_mppi``: configs
  and params equal to JAX's (with and without obstacles and kernels); K
  rounded 1 500 → 1 536 with ``fused_tick``; ``gaussian="popcount"`` (the
  JAX default, a TPU generator) raises; the Savitzky-Golay filter matrix at
  the preset's T = 50 equal to JAX's (max |Δ| 0.0);
* the goal-seeking loop (K = 256, T = 25, three soft drifting obstacles,
  ``control_weight``, SavGol, W = 1) for 20 ticks with injected ε: the
  port's fused tick (its plain version on the CPU) against
  ``make_pallas_diffdrive_tick(interpret=True, collision="soft")``, and the
  two scan paths; ``diff_drive_mppi`` on ``lemniscate(5.0, 200)`` through
  ``WheelPlant`` likewise (scan, fused, split). The port runs through
  ``run_closed_loop(mppi_controller(...))``. Free running, the states stay
  within rtol 1e-3, atol 1e-4 of JAX's (tests/test_torch_mppi.py's limit)
  and every status equals JAX's. The controls are held tick by tick from
  JAX's warm start, to the same limit: at λ = 1 over costs of ~10⁴ (and at
  the exploration temperature 1/1e-4) the weights are nearly one-hot, so a
  float32 rounding of S moves a weight by ~1e-3, and over a free run the
  controls drift apart further than the states do;
* ``nmpc_controller`` in ``run_closed_loop`` on the torch and kernel QP
  backends against JAX's ``test_on_device_nmpc_closed_loop_scan`` (N = 10,
  80 ticks): states within rtol 1e-3, atol 1e-3 (the NMPC tests' 1e-3);
* the JAX CPU figures ``chip_smoke.py`` prints beside the card's, computed
  again (each to 1e-2 m).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu import presets as jpresets
from dnn_mppi_mpc_tpu.envs import closed_loop as jcl
from dnn_mppi_mpc_tpu.envs import plants as jplants
from dnn_mppi_mpc_tpu.envs.obstacles import drift_obstacles
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.integrators import erk_step as j_erk
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.ops import filters as jfilters
from dnn_mppi_mpc_tpu.paths import generators as jpaths
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu.solvers import sqp as jsqp
from dnn_mppi_mpc_tpu_torch import presets
from dnn_mppi_mpc_tpu_torch.config import SQPConfig
from dnn_mppi_mpc_tpu_torch.envs import closed_loop as cl
from dnn_mppi_mpc_tpu_torch.envs import plants
from dnn_mppi_mpc_tpu_torch.models import erk_step, euler_step, unicycle
from dnn_mppi_mpc_tpu_torch.ops import filters
from dnn_mppi_mpc_tpu_torch.paths import lemniscate
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi
from dnn_mppi_mpc_tpu_torch.solvers import sqp as tsqp

RTOL, ATOL = 1e-3, 1e-4
GOAL = (6.0, 6.0, 1.57)
# the suite's goal_seeking row (utils/benchsuite.py:168-187)
OBSTACLES = [[5.0, 4.0, 0.5], [3.5, 3.5, 0.5], [2.0, 5.0, 0.5]]
VELOCITIES = (0.09 * np.array([[0.2, 0.1], [-0.1, 0.1], [0.1, -0.2]])).tolist()
SOFT = dict(soft_safety_distance=2.0, soft_weight=100.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _goal_seeking(module, **kw):
    """The goal-seeking preset of ``module`` (JAX or the port) with the
    suite's obstacles."""
    if module is jpresets:
        return jpresets.goal_seeking_mppi(jnp.asarray(GOAL), obstacles=jnp.asarray(OBSTACLES),
                                          obstacle_velocities=jnp.asarray(VELOCITIES), **kw)
    return presets.goal_seeking_mppi(GOAL, obstacles=OBSTACLES, obstacle_velocities=VELOCITIES,
                                     device="cpu", **kw)


def _diff_drive(module, ref, **kw):
    if module is jpresets:
        kw["use_pallas"] = kw.pop("use_kernel", False)
        if kw.get("obstacles") is not None:
            kw["obstacles"] = jnp.asarray(kw["obstacles"])
        return jpresets.diff_drive_mppi(jnp.asarray(ref), **kw)
    return presets.diff_drive_mppi(ref, device="cpu", **kw)


def _config_fields(cfg) -> dict:
    """The port config's fields by the JAX names, enums by value."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out["use_pallas" if f.name == "use_kernel" else f.name] = getattr(v, "value", v)
    return out


def _assert_same_problem(jside, tside):
    (js, jp), (ts, tp) = jside, tside
    want = {k: getattr(getattr(js.cfg, k), "value", getattr(js.cfg, k))
            for k in _config_fields(ts.cfg)}
    assert _config_fields(ts.cfg) == want
    for f in dataclasses.fields(tp):
        got, ref = getattr(tp, f.name), getattr(jp, f.name)
        assert (got is None) == (ref is None), f.name
        if got is not None:
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.float32), err_msg=f.name)


PRESET_CASES = {
    "goal_seeking": dict(),
    "goal_seeking_fused": dict(fused_tick=True),
    "goal_seeking_T25_K256": dict(num_samples=256, horizon=25, fused_tick=True),
    "diff_drive": dict(),
    "diff_drive_obstacles_fused": dict(num_samples=500, horizon=20,
                                       obstacles=[[3.0, -1.0, 0.8], [5.5, -3.0, 0.8]],
                                       fused_tick=True),
    "diff_drive_split_overrides": dict(use_kernel=True, filter_window=4, lam=0.5),
}


@pytest.mark.parametrize("case", list(PRESET_CASES))
def test_preset_config_and_params_match_jax(case):
    kw = dict(PRESET_CASES[case])
    if case.startswith("goal"):
        jside, tside = _goal_seeking(jpresets, **kw), _goal_seeking(presets, **kw)
    else:
        ref = np.asarray(jpaths.line(jnp.zeros(2), jnp.array([8.0, -4.0]), 200))
        jside, tside = _diff_drive(jpresets, ref, **kw), _diff_drive(presets, ref, **kw)
    _assert_same_problem(jside, tside)
    solver = tside[0]
    if kw.get("fused_tick"):
        assert solver.tick_fn.__qualname__.startswith("make_cuda_diffdrive_tick.")
        assert solver.tick_fn.fused_epilogue
        assert solver.tick_fn.iso_xy == case.startswith("diff_drive")
    elif kw.get("use_kernel"):
        assert solver.rollout_fn is not None and solver.tick_fn is None
    else:
        assert solver.rollout_fn is None and solver.tick_fn is None


def test_goal_seeking_rounds_K_and_rejects_tpu_generators():
    assert _goal_seeking(presets)[0].cfg.num_samples == 1500
    assert _goal_seeking(presets, fused_tick=True)[0].cfg.num_samples == 1536
    assert _goal_seeking(jpresets, fused_tick=True)[0].cfg.num_samples == 1536
    for gaussian in ("popcount", "box_muller"):
        with pytest.raises(ValueError, match="TPU hardware generator"):
            _goal_seeking(presets, fused_tick=True, gaussian=gaussian)
    solver, params = presets.goal_seeking_mppi(GOAL, device="cpu")  # no obstacles
    assert params.obstacles is None and params.ref_path.shape == (1, 3)
    assert _diff_drive(presets, np.zeros((5, 3)), num_samples=100, fused_tick=True)[0] \
        .cfg.num_samples == 128


def test_savgol_filter_matrix_at_the_preset_horizon():
    """The preset's filter (window min(51, 50) = 50 → 49, order 3) as the
    fused tick's epilogue matrix: equal to JAX's, max |Δ| 0.0."""
    cfg = _goal_seeking(presets)[0].cfg
    args = (cfg.filter.value, cfg.horizon, cfg.filter_window, cfg.savgol_polyorder)
    assert args == ("savgol", 50, 50, 3)
    got, want = filters.filter_matrix(*args), jfilters.filter_matrix(*args)
    assert float(np.abs(got - want).max()) == 0.0


def _viol(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max())


def _injected(solver, eps):
    """``solver`` as ``mppi_controller`` calls it, handed tick i's ε on
    call i."""
    ticks = iter(eps)

    class Injected:
        def step(self, params, st, x):
            return solver.step(params, st, x, torch.from_numpy(next(ticks)))

    return Injected()


def _closed_loop_against_jax(jside, tside, jfn, jdyn, plant, jplant_step, x0, ticks, seed):
    """Free running: the port through run_closed_loop(mppi_controller), JAX
    tick by tick with ``jfn`` (one jitted mppi_step), each on its own state,
    the same ε; then the port's tick from each of JAX's warm starts."""
    (js, jp), (ts, tp) = jside, tside
    K, T = js.cfg.num_samples, js.cfg.horizon
    rng = np.random.default_rng(seed)
    eps = rng.multivariate_normal(np.zeros(2), np.asarray(jp.sigma), (ticks, K, T)).astype(
        np.float32)
    st, x = jmppi.MPPIState.init(js.cfg), jnp.asarray(x0)
    j_states, j_starts, j_u0, j_uprev, j_status = [np.asarray(x)], [], [], [], []
    for i in range(ticks):
        j_starts.append((st, x))
        u0, st, aux = jfn(jp, st, x, jnp.asarray(eps[i]))
        x = jplant_step(x, u0)
        j_states.append(np.asarray(x))
        j_u0.append(np.asarray(u0))
        j_uprev.append(np.asarray(st.u_prev))
        j_status.append(int(aux.status))

    statuses = []
    inner = _injected(ts, eps)

    class Recording:
        def step(self, params, st, x):
            u0, st, aux = inner.step(params, st, x)
            statuses.append(int(aux.status))
            return u0, st, aux

    ep, _ = cl.run_closed_loop(cl.mppi_controller(Recording(), tp), plant, ts.init(),
                               torch.tensor(np.asarray(x0, np.float32)), ticks)
    assert torch.isfinite(ep.states).all()
    assert statuses == j_status
    assert _viol(ep.states, np.stack(j_states)) <= 1.0, "free-running states"

    locked = _injected(ts, eps)
    for i, (st_j, x_j) in enumerate(j_starts):
        st_t = tmppi.state_from_numpy(np.asarray(st_j.u_prev), np.asarray(st_j.waypoint_idx),
                                      [0, 0], device="cpu")
        u0, st_t, _ = locked.step(tp, st_t, torch.tensor(np.asarray(x_j)))
        assert _viol(u0, j_u0[i]) <= 1.0, f"u0 at tick {i}"
        assert _viol(st_t.u_prev, j_uprev[i]) <= 1.0, f"u_prev at tick {i}"
    return ep


@pytest.mark.parametrize("route", ["scan", "fused"])
def test_goal_seeking_closed_loop_matches_jax(route):
    kw = dict(num_samples=256, horizon=25, fused_tick=route == "fused")
    jside, tside = _goal_seeking(jpresets, **kw), _goal_seeking(presets, **kw)
    jc = jside[0].cfg
    stage, terminal = jmppi.make_tracking_costs(jc, collision="soft", **SOFT)

    def jdyn(x, u):
        return j_euler(j_unicycle, x, u, jc.dt)

    tick = (jmppi.make_pallas_diffdrive_tick(jc, interpret=True, collision="soft", **SOFT)
            if route == "fused" else None)
    jfn = jax.jit(lambda p, s, x, n: jmppi.mppi_step(jc, jdyn, stage, terminal, p, s, x, n,
                                                     tick_fn=tick))
    ep = _closed_loop_against_jax(jside, tside, jfn, jdyn, tside[0].dynamics_step, jdyn,
                                  np.zeros(3, np.float32), 20, seed=0)
    assert float(torch.linalg.vector_norm(ep.states[-1, :2] - ep.states[0, :2])) > 1.0


@pytest.mark.parametrize("route", ["scan", "fused", "split"])
def test_diff_drive_mppi_on_lemniscate_matches_jax(route):
    """The reference's defaults (K = 100 → 128 on the kernel routes, T = 10,
    dt = 0.1) on the lemniscate of half-width 5, the body command through
    the wheel plant (IK → wheels → FK)."""
    ref = np.asarray(jpaths.lemniscate(5.0, 200))
    np.testing.assert_allclose(lemniscate(5.0, 200, device="cpu").numpy(), ref, rtol=2e-6,
                               atol=2e-6)
    kw = dict(fused_tick=route == "fused", use_kernel=route == "split")
    jside, tside = _diff_drive(jpresets, ref, **kw), _diff_drive(presets, ref, **kw)
    jc = jside[0].cfg
    stage, terminal = jmppi.make_tracking_costs(jc)

    def jdyn(x, u):
        return j_euler(j_unicycle, x, u, jc.dt)

    if route == "fused":
        f = dict(tick_fn=jmppi.make_pallas_diffdrive_tick(jc, interpret=True,
                                                          fuse_epilogue=True, iso_xy=True))
    elif route == "split":
        f = dict(rollout_fn=jmppi.make_pallas_diffdrive_rollout(jc, interpret=True))
    else:
        f = {}
    jfn = jax.jit(lambda p, s, x, n: jmppi.mppi_step(jc, jdyn, stage, terminal, p, s, x, n, **f))
    jwheels, wheels = jplants.WheelPlant(jc.dt), plants.WheelPlant(jc.dt, device="cpu")

    def jplant_step(x, u):
        return jwheels.step_body(jwheels.init(x), u).x

    def plant(x, u):
        return wheels.step_body(wheels.init(x), u).x

    _closed_loop_against_jax(jside, tside, jfn, jdyn, plant, jplant_step, ref[0], 20, seed=1)


def test_nmpc_controller_loop_matches_jax():
    """tests/test_envs.py::test_on_device_nmpc_closed_loop_scan on the port:
    N = 10, one SQP iteration, 8 QP iterations, ERK(4, 3) plant, 80 ticks to
    the goal (1.5, 1, 0), on both QP backends (the kernel's plain version
    here)."""
    N = 10
    goal = np.array([1.5, 1.0, 0.0], np.float32)
    p = dict(Q=np.diag([10.0, 10.0, 0.1]), R=np.diag([0.2, 0.05]), Qe=np.diag([10.0, 10.0, 0.1]),
             yref=np.concatenate([goal, np.zeros(2)])[None, :].repeat(N, axis=0), yref_e=goal,
             lbx=np.full(3, -10.0), ubx=np.full(3, 10.0), lbu=np.full(2, -1.5),
             ubu=np.full(2, 1.5))
    jc = jcfg.SQPConfig(N=N, dim_x=3, dim_u=2, dt=0.1, sqp_iters=1, qp_iters=8)
    jsolver = jsqp.NMPCSolver(jc, j_unicycle)
    jparams = jsqp.OCPParams(**{k: jnp.asarray(v, jnp.float32) for k, v in p.items()})

    def jplant(x, u):
        return j_erk(j_unicycle, x, u, 0.1, num_steps=3)

    jep, _ = jax.jit(lambda cs, x0: jcl.run_closed_loop(
        jcl.nmpc_controller(jsolver, jparams), jplant, cs, x0, 80))(
        jsolver.init(jnp.zeros(3)), jnp.zeros(3))
    for backend in ("torch", "kernel"):
        cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=0.1, sqp_iters=1, qp_iters=8,
                        qp_backend=backend)
        solver = tsqp.NMPCSolver(cfg, unicycle, device="cpu")
        params = tsqp.ocp_params_from_numpy(**p, device="cpu")

        def plant(x, u):
            return erk_step(unicycle, x, u, 0.1, num_steps=3)

        ep, cs = cl.run_closed_loop(cl.nmpc_controller(solver, params), plant,
                                    solver.init(torch.zeros(3)), torch.zeros(3), 80)
        assert isinstance(cs, tsqp.NMPCState)
        np.testing.assert_allclose(ep.states.numpy(), np.asarray(jep.states), rtol=1e-3,
                                   atol=1e-3, err_msg=backend)
        assert float(np.linalg.norm(ep.states[-1, :2].numpy() - goal[:2])) < 0.1


def _jax_reference_runs(cs) -> dict:
    """chip_smoke.py's goal-seeking and diff-drive loops on the JAX package
    (scan path, JAX's PRNG, on the CPU), measured as chip_smoke measures
    the card's."""
    goal = np.asarray(cs.GOAL[:2], np.float32)
    obs0, vel = (np.asarray(a, np.float32) for a in (cs.GOAL_OBSTACLES, cs.GOAL_VELOCITIES))
    solver, params = jpresets.goal_seeking_mppi(
        jnp.asarray(cs.GOAL), num_samples=cs.K_GOAL, horizon=cs.T_GOAL,
        obstacles=jnp.asarray(obs0), obstacle_velocities=jnp.asarray(vel))
    dt = solver.cfg.dt

    def euler(x, u):
        return j_euler(j_unicycle, x, u, dt)

    step = jax.jit(lambda p, s, x: solver._step(p, s, x, None))
    out = {}
    for name in ("goal_seeking", "goal_seeking_moving"):
        st, x = solver.init(), jnp.zeros(3, jnp.float32)
        xs = [np.asarray(x)]
        for i in range(cs.GOAL_TICKS):
            p = params
            if name == "goal_seeking_moving":  # the world's obstacles at t = i·dt
                p = dataclasses.replace(params, obstacles=drift_obstacles(
                    params.obstacles, params.obstacle_velocities, jnp.float32(i * dt)))
            u, st, _ = step(p, st, x)
            x = euler(x, u)
            xs.append(np.asarray(x))
        xs = np.stack(xs)
        t = np.arange(len(xs), dtype=np.float32)[:, None, None] * np.float32(dt)
        obs = obs0[None, :, :2] + (vel[None] * t if name == "goal_seeking_moving" else 0.0)
        clear = np.linalg.norm(xs[:, None, :2] - obs, axis=-1) - obs0[None, :, 2]
        out[name] = {"goal_dist_end_m": float(np.linalg.norm(xs[-1, :2] - goal)),
                     "clearance_min_m": float(clear.min())}

    ref = jpaths.line(jnp.zeros(2), jnp.asarray(cs.DD_END), cs.DD_PATH_POINTS)
    obstacles = np.asarray(cs.DD_OBSTACLES, np.float32)
    # the K the card runs: the kernel routes round K_DD up to a multiple of 128
    dd, dp = jpresets.diff_drive_mppi(ref, num_samples=cs.K_DD_KERNEL, horizon=cs.T_DD,
                                      obstacles=jnp.asarray(obstacles))
    wheels = jplants.WheelPlant(dd.cfg.dt)

    def wheel_step(x, u):  # no lag or delay: the pose is the plant's whole state
        return wheels.step_body(wheels.init(x), u).x

    def episode(key):
        ep, _ = jcl.run_closed_loop(jcl.mppi_controller(dd, dp), wheel_step, dd.init(key),
                                    jnp.zeros(3, jnp.float32), cs.DD_TICKS)
        return ep.states

    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(cs.DD_JAX_KEYS))
    xs = np.asarray(jax.jit(jax.vmap(episode))(keys))  # (keys, ticks + 1, 3)
    track = np.linalg.norm(xs[:, :, None, :2] - np.asarray(ref)[:, :2], axis=-1).min(-1)
    clear = np.linalg.norm(xs[:, :, None, :2] - obstacles[:, :2], axis=-1) - obstacles[:, 2]
    out["diff_drive_mppi"] = {"cross_track_max_m": float(track.max()),
                              "clearance_min_m": float(clear.min())}
    return out


def test_chip_smoke_jax_references():
    """The JAX CPU figures chip_smoke.py prints beside the card's: the
    goal-seeking suite row (K = 1 536, T = 50, the scan path, JAX's PRNG)
    for 300 ticks from x0 = 0, the same with the world's obstacles drifting,
    and ``diff_drive_mppi`` on the CLI demo's course (K = 512, T = 20)
    through the wheel plant for 200 ticks from eight PRNG keys (the largest
    cross-track distance and the least clearance over them). Each figure to
    a centimetre: these loops are chaotic (nearly one-hot weights), and how
    XLA fuses one and the same loop moves them by millimetres."""
    import chip_smoke as cs

    got = _jax_reference_runs(cs)
    print("JAX CPU references:", got)
    for name, want in (("goal_seeking", cs.GOAL_JAX_REFERENCE),
                       ("goal_seeking_moving", cs.GOAL_MOVING_JAX_REFERENCE),
                       ("diff_drive_mppi", cs.DIFF_DRIVE_JAX_REFERENCE)):
        assert set(got[name]) == set(want), name
        for key, value in want.items():
            np.testing.assert_allclose(got[name][key], value, rtol=0.0, atol=1e-2,
                                       err_msg=f"{name} {key}")
