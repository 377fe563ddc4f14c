"""The port's race-car MPPI path as a whole against the JAX package.

* the scan path, ``make_tracking_costs(wrap_yaw=True, collision="polygon")``,
  against the JAX scan ``mppi_step`` on the same ε: S rtol/atol 3e-4, w rtol
  3e-4 atol 1e-6, u0 and ``u_prev`` rtol 1e-4 atol 1e-5 (the tolerances of
  tests/test_bicycle_tick.py:113-120). This also covers ``wrap_yaw``;
* a 20-tick closed loop through the port's fused bicycle tick (its plain
  version on the CPU) against the JAX engine with the Pallas tick in
  interpret mode, the same injected ε every tick: states to rtol 1e-3 /
  atol 1e-4 as tests/test_bicycle_tick.py:144;
* one tick of the split bicycle rollout route against the JAX one;
* ``presets.racecar_mppi``: its configuration and params against the JAX
  preset's, the K rounding, the ``iso_xy`` detection and every guard.
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
from dnn_mppi_mpc_tpu.models.dynamics import BicycleParams as JBicycleParams
from dnn_mppi_mpc_tpu.models.dynamics import kinematic_bicycle as j_bicycle
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.paths.generators import lemniscate_with_speed as j_lemniscate
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch import presets
from dnn_mppi_mpc_tpu_torch.models import BicycleParams, euler_step, kinematic_bicycle
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

K, T, DT = 512, 8, 0.05
OBSTACLES = [[10.4, 4.9, 0.5], [7.9, 2.0, 0.3]]
X0 = np.array([10.0, 0.5, np.pi / 2, 3.0], np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ref():
    return np.asarray(j_lemniscate(10.0, 100), np.float32)


def _problem(obstacles=False, alpha=0.8, **cfg_kw):
    """(jax side, port side): cfg, params, plant step, stage, terminal of
    the race car at K = 512, T = 8 over a 100-point lemniscate."""
    kw = dict(num_samples=K, horizon=T, dim_x=4, dim_u=2, dt=DT, lam=50.0, alpha=alpha,
              exploration=0.01, filter_window=5, waypoint_search_len=200)
    kw.update(cfg_kw)
    p = dict(
        sigma=np.array([[0.5, 0.0], [0.0, 0.1]], np.float32),
        stage_weight=np.array([50.0, 50.0, 1.0, 20.0], np.float32),
        terminal_weight=np.array([50.0, 50.0, 1.0, 20.0], np.float32),
        u_min=np.array([-0.523, -2.0], np.float32),
        u_max=np.array([0.523, 2.0], np.float32),
        ref_path=_ref(),
        obstacles=np.asarray(OBSTACLES, np.float32) if obstacles else None,
    )
    enums = dict(temperature="lambda", accumulation="sum", filter="ma_padded")
    jc = jcfg.MPPIConfig(**kw, **{k: getattr(jcfg, n)(enums[k]) for k, n in (
        ("temperature", "Temperature"), ("accumulation", "CostAccumulation"),
        ("filter", "SmoothingFilter"))})
    tc = tcfg.MPPIConfig(**kw, **{k: getattr(tcfg, n)(enums[k]) for k, n in (
        ("temperature", "Temperature"), ("accumulation", "CostAccumulation"),
        ("filter", "SmoothingFilter"))})
    jp = jcfg.MPPIParams(**{k: None if v is None else jnp.asarray(v) for k, v in p.items()})
    tp = tcfg.params_from_numpy(**p, device="cpu")
    collision = "polygon" if obstacles else "none"
    jbp = JBicycleParams(wheel_base=jnp.asarray(2.5, jnp.float32))
    jstep = lambda x, u: j_euler(lambda s, a: j_bicycle(s, a, jbp), x, u, DT)  # noqa: E731
    tstep = lambda x, u: euler_step(  # noqa: E731
        lambda s, a: kinematic_bicycle(s, a, BicycleParams(2.5)), x, u, DT)
    jside = (jc, jp, jstep, *jmppi.make_tracking_costs(jc, wrap_yaw=True, collision=collision))
    tside = (tc, tp, tstep, *tmppi.make_tracking_costs(tc, wrap_yaw=True, collision=collision))
    return jside, tside


def _noise(seed):
    rng = np.random.default_rng(seed)
    return rng.multivariate_normal(np.zeros(2), [[0.5, 0.0], [0.0, 0.1]], (K, T)).astype(
        np.float32)


def _assert_tick_close(jout, tout):
    (ju0, jst, jaux), (tu0, tst, taux) = jout, tout
    np.testing.assert_allclose(taux.costs.numpy(), np.asarray(jaux.costs), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(taux.weights.numpy(), np.asarray(jaux.weights), rtol=3e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tu0.numpy(), np.asarray(ju0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tst.u_prev.numpy(), np.asarray(jst.u_prev), rtol=1e-4, atol=1e-5)
    assert int(tst.waypoint_idx) == int(jst.waypoint_idx)
    assert int(taux.status) == int(jaux.status)


def _one_tick(jside, tside, eps, *, jkw=None, tkw=None, start=0):
    jc, jp, jstep, js, jt = jside
    tc, tp, tstep, ts, tt = tside
    u_prev = np.random.default_rng(0).normal(0, 0.1, (T, 2)).astype(np.float32)
    jstate = jmppi.MPPIState(u_prev=jnp.asarray(u_prev), waypoint_idx=jnp.asarray(start, jnp.int32),
                             key=jax.random.PRNGKey(0))
    jout = jax.jit(lambda p, s, x, n: jmppi.mppi_step(jc, jstep, js, jt, p, s, x, n,
                                                      **(jkw or {})))(
        jp, jstate, jnp.asarray(X0), jnp.asarray(eps))
    tstate = tmppi.state_from_numpy(u_prev, start, [0, 0], device="cpu")
    tout = tmppi.mppi_step(tc, tstep, ts, tt, tp, tstate,
                           torch.as_tensor(X0), torch.as_tensor(eps), **(tkw or {}))
    return jout, tout


@pytest.mark.parametrize("obstacles", [False, True], ids=["free", "polygon"])
@pytest.mark.parametrize("alpha", [1.0, 0.8])
def test_scan_path_matches_jax(obstacles, alpha):
    jside, tside = _problem(obstacles=obstacles, alpha=alpha)
    jout, tout = _one_tick(jside, tside, _noise(3))
    if obstacles:
        assert (tout[2].costs > 1e6).any() and (tout[2].costs < 1e6).any()
    _assert_tick_close(jout, tout)


def test_scan_path_wrap_yaw_matches_jax():
    """Headings far outside [0, 2π): the wrapped yaw term decides the cost."""
    jside, tside = _problem()
    jc, jp, jstep, js, jt = jside
    tc, tp, tstep, ts, tt = tside
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(5, 12, (256, 2)), rng.uniform(-20, 20, (256, 1)),
                        rng.uniform(0, 6, (256, 1))], 1).astype(np.float32)
    jctx = jmppi.CostContext(params=jp, waypoint_start=jnp.asarray(0, jnp.int32))
    tctx = tmppi.CostContext(params=tp, waypoint_start=torch.tensor(0))
    want = np.asarray(js(jnp.asarray(x), jnp.asarray(0), jctx))
    got = ts(torch.as_tensor(x), 0, tctx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_split_rollout_route_matches_jax(f32_mode):
    jside, tside = _problem(obstacles=True)
    jroll = jmppi.make_pallas_bicycle_rollout(jside[0], interpret=True)
    troll = tmppi.make_cuda_bicycle_rollout(tside[0])
    jout, tout = _one_tick(jside, tside, _noise(5), jkw=dict(rollout_fn=jroll),
                           tkw=dict(rollout_fn=troll), start=7)
    _assert_tick_close(jout, tout)


def test_closed_loop_fused_tick_matches_jax(f32_mode):
    jside, tside = _problem(obstacles=True)
    jc, jp, jstep, js, jt = jside
    tc, tp, tstep, ts, tt = tside
    jtick = jmppi.make_pallas_bicycle_tick(jc, interpret=True, iso_xy=True)
    jrun = jax.jit(lambda p, s, x, n: jmppi.mppi_step(jc, jstep, js, jt, p, s, x, n,
                                                      tick_fn=jtick))
    solver = tmppi.MPPISolver(tc, tstep, ts, tt, tick_fn=tmppi.make_cuda_bicycle_tick(
        tc, iso_xy=True), device="cpu")
    x_j, x_t = jnp.asarray(X0), torch.as_tensor(X0)
    st_j, st_t = jmppi.MPPIState.init(jc), solver.init()
    for i in range(20):
        eps = _noise(100 + i)
        u_j, st_j, aux_j = jrun(jp, st_j, x_j, jnp.asarray(eps))
        u_t, st_t, aux_t = solver.step(tp, st_t, x_t, torch.as_tensor(eps))
        x_j, x_t = jstep(x_j, u_j), tstep(x_t, u_t)
        assert int(aux_t.status) == int(aux_j.status) == 0
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev), rtol=1e-3,
                               atol=1e-4)
    assert int(st_t.waypoint_idx) == int(st_j.waypoint_idx)


# --- the preset ----------------------------------------------------------------


def test_racecar_preset_matches_jax():
    ref = _ref()
    jsol, jp = jpresets.racecar_mppi(jnp.asarray(ref), num_samples=200, horizon=T,
                                     obstacles=jnp.asarray(OBSTACLES))
    tsol, tp = presets.racecar_mppi(ref, num_samples=200, horizon=T, obstacles=OBSTACLES,
                                    device="cpu")
    for f in dataclasses.fields(tsol.cfg):
        tv = getattr(tsol.cfg, f.name)
        jv = getattr(jsol.cfg, "use_pallas" if f.name == "use_kernel" else f.name)
        assert (tv.value if hasattr(tv, "value") else tv) == (
            jv.value if hasattr(jv, "value") else jv), f.name
    for name in ("sigma", "stage_weight", "terminal_weight", "u_min", "u_max", "ref_path",
                 "obstacles"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name), np.float32))
    x = np.array([[1.0, 2.0, 0.3, 4.0]], np.float32)
    u = np.array([[0.2, -1.0]], np.float32)
    np.testing.assert_allclose(
        tsol.dynamics_step(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
        np.asarray(jsol.dynamics_step(jnp.asarray(x), jnp.asarray(u))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "kw, route",
    [(dict(fused_tick=True), "make_cuda_bicycle_tick"),
     (dict(use_kernel=True), "make_cuda_bicycle_rollout"),
     (dict(), None)],
    ids=["fused_tick", "split_rollout", "scan"],
)
def test_racecar_preset_routes_and_rounds_k(kw, route):
    solver, _ = presets.racecar_mppi(_ref(), num_samples=200, horizon=T, device="cpu", **kw)
    fn = solver.tick_fn or solver.rollout_fn
    assert (fn.__qualname__.split(".")[0] if fn else None) == route
    assert solver.cfg.num_samples == (200 if route is None else 256)
    if route == "make_cuda_bicycle_tick":
        assert solver.tick_fn.iso_xy  # the (50, 50, 1, 20) weights are symmetric


def test_racecar_preset_fused_tick_runs_on_cpu():
    solver, params = presets.racecar_mppi(_ref(), num_samples=256, horizon=T,
                                          obstacles=OBSTACLES, fused_tick=True, device="cpu")
    st, x = solver.init(), torch.as_tensor(X0)
    for _ in range(3):
        u0, st, aux = solver.step(params, st, x)
        x = solver.dynamics_step(x, u0)
    assert aux.costs.shape == (256,) and bool(torch.isfinite(x).all())
    assert int(aux.status) == 0


PRESET_GUARDS = {
    "gaussian_popcount": (dict(fused_tick=True, gaussian="popcount"), "gaussian"),
    "sincos_poly": (dict(fused_tick=True, sincos="poly"), "sincos"),
    "last_fused": (dict(fused_tick=True, accumulation=tcfg.CostAccumulation.LAST), "SUM"),
    "last_split": (dict(use_kernel=True, accumulation=tcfg.CostAccumulation.LAST), "SUM"),
    "repeats_fused": (dict(fused_tick=True, num_rollout_repeats=2), "num_rollout_repeats"),
    "repeats_split": (dict(use_kernel=True, num_rollout_repeats=2), "num_rollout_repeats"),
}


@pytest.mark.parametrize("case", list(PRESET_GUARDS))
def test_racecar_preset_guards_raise(case):
    kw, match = PRESET_GUARDS[case]
    with pytest.raises(ValueError, match=match):
        presets.racecar_mppi(_ref(), num_samples=256, horizon=T, device="cpu", **kw)


@pytest.mark.parametrize("route", ["fused_tick", "use_kernel"])
def test_racecar_runtime_guards_raise(route):
    solver, params = presets.racecar_mppi(_ref(), num_samples=256, horizon=T,
                                          obstacles=OBSTACLES, device="cpu", **{route: True})
    x0 = torch.as_tensor(X0)
    moving = dataclasses.replace(params, obstacle_velocities=torch.tensor([[0.1, 0.0]] * 2))
    with pytest.raises(ValueError, match="obstacle_velocities"):
        solver.step(moving, solver.init(), x0)
    if route == "fused_tick":
        asym = dataclasses.replace(params, stage_weight=torch.tensor([50.0, 40.0, 1.0, 20.0]))
        with pytest.raises(ValueError, match="symmetric"):
            solver.step(asym, solver.init(), x0)


# --- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_racecar_closed_loop_on_card(cuda_device):
    from dnn_mppi_mpc_tpu_torch.ops import cuda as kern
    from dnn_mppi_mpc_tpu_torch.paths import lemniscate_with_speed

    ref = lemniscate_with_speed(10.0, 200, speed=5.0, device=cuda_device)
    solver, params = presets.racecar_mppi(ref, num_samples=10240, horizon=20,
                                          obstacles=[[5.0, 5.0, 1.0], [7.0, 7.0, 1.0]],
                                          fused_tick=True, device=cuda_device)
    kern.reset_counts()
    st, x = solver.init(), ref[0].clone()
    statuses = []
    for _ in range(20):
        u0, st, aux = solver.step(params, st, x)
        x = solver.dynamics_step(x, u0)
        statuses.append(aux.status)
    torch.cuda.synchronize()
    assert kern.bicycle_mppi_tick.launches == 20 and kern.bicycle_mppi_tick_plain.calls == 0
    assert int(torch.stack(statuses).max()) & 2 == 0 and bool(torch.isfinite(x).all())
