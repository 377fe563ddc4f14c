"""``waypoint_carry="rollout"`` in the port against the JAX package, on the
same numpy inputs (mirrors tests/test_waypoint_carry.py):

* ``nearest_waypoint_carried`` against JAX's, path end included: indices
  exact, rows to 1e-6;
* the scan path with the carry against JAX's scan path on injected ε,
  persist "none" and "max": costs rtol 5e-3 / atol 5e-3, u0 rtol 5e-3 /
  atol 5e-4, the window index equal, tick for tick from the same start;
* row 2's plain version (``MPPISolver(fused_tick=True)`` on the CPU)
  against JAX's ``diffdrive_mppi_tick`` in interpret mode with the carry,
  over ``iso_xy``, ``fuse_epilogue`` and ``persist``: costs rtol 2e-4 /
  atol 2e-3, u0 rtol 1e-4 / atol 2e-4, index and status equal (JAX's own
  scan-against-kernel tolerances);
* row 8's plain version against JAX's generic tick with the carry, at
  ``carry_window_len`` 30 and 48;
* the carry progresses more than twice as far as the tick anchor;
* the guards (the K-blocked route, the sharded rollout, a tick function
  without the carry, the routes that have none) and the config's checks.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models import euler_step as j_euler
from dnn_mppi_mpc_tpu.models import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models import unicycle_tile as j_unicycle_tile
from dnn_mppi_mpc_tpu.ops import waypoints as jwp
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch.models import euler_step, tile as ttile, unicycle
from dnn_mppi_mpc_tpu_torch.ops import waypoints as twp
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

K, T, DT = 64, 10, 0.1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path() -> np.ndarray:
    """JAX's ``line(0, (10, -5), 100)`` as the reference test builds it."""
    from dnn_mppi_mpc_tpu.paths.generators import line as j_line

    return np.asarray(j_line(jnp.zeros(2), jnp.array([10.0, -5.0]), 100), np.float32)


def _make(carry="rollout", persist="max", **kw):
    """The reference test's problem in both packages: (cfg, params, step)
    for JAX, then for the port."""
    cfg_kw = {**dict(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT, lam=1.0, alpha=0.2,
                     exploration=0.0001, filter_window=10, waypoint_search_len=20,
                     waypoint_carry=carry, waypoint_persist=persist), **kw}
    jc = jcfg.MPPIConfig(temperature=jcfg.Temperature.EXPLORATION,
                         accumulation=jcfg.CostAccumulation.SUM,
                         filter=jcfg.SmoothingFilter.MOVING_AVERAGE_EDGE, **cfg_kw)
    tc = tcfg.MPPIConfig(temperature=tcfg.Temperature.EXPLORATION,
                         accumulation=tcfg.CostAccumulation.SUM,
                         filter=tcfg.SmoothingFilter.MOVING_AVERAGE_EDGE, **cfg_kw)
    p = dict(sigma=np.array([[0.1, 0.0], [0.0, 0.01]], np.float32),
             stage_weight=np.array([5.0, 5.0, 10.0], np.float32),
             terminal_weight=np.array([5.0, 5.0, 10.0], np.float32),
             u_min=np.array([-5.0, -3.14], np.float32),
             u_max=np.array([5.0, 3.14], np.float32), ref_path=_path())
    jp = jcfg.MPPIParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = tcfg.MPPIParams(**{k: torch.as_tensor(v) for k, v in p.items()})
    return ((jc, jp, lambda x, u: j_euler(j_unicycle, x, u, DT)),
            (tc, tp, lambda x, u: euler_step(unicycle, x, u, DT)))


def _noise(rng, params, k):
    return rng.multivariate_normal(np.zeros(2), np.asarray(params.sigma, np.float64),
                                   size=(k, T)).astype(np.float32)


# --- nearest_waypoint_carried ------------------------------------------------------


@pytest.mark.parametrize("search_len", [5, 20, 150])
def test_nearest_waypoint_carried_matches_jax(search_len):
    """Random queries and starts, many at and past the path end (the
    clipped start, the clamped gather, the duplicate end rows)."""
    path = _path()
    P = path.shape[0]
    rng = np.random.default_rng(search_len)
    xy = np.concatenate([rng.uniform([-1, -6], [11, 1], (200, 2)),
                         path[-1, :2] + rng.normal(0, 0.3, (56, 2))]).astype(np.float32)
    start = np.concatenate([rng.integers(0, P, 200), rng.integers(P - 25, P + 10, 56)])
    start = start.reshape(16, 16).astype(np.int32)
    xy = xy.reshape(16, 16, 2)
    j_idx, j_ref = jwp.nearest_waypoint_carried(jnp.asarray(path), jnp.asarray(xy),
                                                jnp.asarray(start), search_len)
    t_idx, t_ref = twp.nearest_waypoint_carried(torch.as_tensor(path), torch.as_tensor(xy),
                                                torch.as_tensor(start), search_len)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_ref.numpy(), np.asarray(j_ref), rtol=1e-6, atol=1e-6)
    assert (t_idx.numpy() >= np.clip(start, 0, P - 1)).all()  # never regresses
    assert t_idx.max() <= P - 1


# --- the scan path -------------------------------------------------------------------


@pytest.mark.parametrize("persist", ["none", "max"])
def test_scan_path_carry_matches_jax(persist):
    (jc, jp, jstep), (tc, tp, tstep) = _make(persist=persist)
    jst = jmppi.MPPIState.init(jc)
    jsc, jtc = jmppi.make_tracking_costs(jc)
    tsc, ttc = tmppi.make_tracking_costs(tc)
    rng = np.random.default_rng(11)
    x = np.zeros(3, np.float32)
    for tick in range(12):
        eps = _noise(rng, jp, K)
        # each tick from JAX's state before it: a tick-by-tick compare
        tst = tmppi.state_from_numpy(np.asarray(jst.u_prev), int(jst.waypoint_idx), [0, 0],
                                     device="cpu")
        ju0, jst, jaux = jmppi.mppi_step(jc, jstep, jsc, jtc, jp, jst, jnp.asarray(x),
                                         noise=jnp.asarray(eps))
        tu0, tst, taux = tmppi.mppi_step(tc, tstep, tsc, ttc, tp, tst, torch.as_tensor(x),
                                         noise=torch.as_tensor(eps))
        np.testing.assert_allclose(taux.costs.numpy(), np.asarray(jaux.costs), rtol=5e-3,
                                   atol=5e-3)
        np.testing.assert_allclose(tu0.numpy(), np.asarray(ju0), rtol=5e-3, atol=5e-4)
        assert int(tst.waypoint_idx) == int(jst.waypoint_idx), tick
        assert int(taux.status) == int(jaux.status)
        x = np.asarray(jstep(jnp.asarray(x), ju0), np.float32)
    if persist == "max":
        assert int(jst.waypoint_idx) > 5  # the persisted lookahead advanced


# --- row 2 and row 8 against JAX's kernels with the carry -------------------------


def _closed_loop_compare(jc, jp, jstep, tc, tp, tstep, j_tick, t_solver, ticks, seed, k):
    """JAX's scan-free kernel tick against the port's plain tick: each tick
    from the same state and x on the same ε."""
    jsc, jtc = jmppi.make_tracking_costs(jc)
    jst = jmppi.MPPIState.init(jc)
    rng = np.random.default_rng(seed)
    x = np.zeros(3, np.float32)
    for tick in range(ticks):
        eps = _noise(rng, jp, k)
        tst = tmppi.state_from_numpy(np.asarray(jst.u_prev), int(jst.waypoint_idx), [0, 0],
                                     device="cpu")
        ju0, jst, jaux = jmppi.mppi_step(jc, jstep, jsc, jtc, jp, jst, jnp.asarray(x),
                                         noise=jnp.asarray(eps), tick_fn=j_tick)
        tu0, tst, taux = t_solver.step(tp, tst, torch.as_tensor(x), noise=torch.as_tensor(eps))
        np.testing.assert_allclose(taux.costs.numpy(), np.asarray(jaux.costs), rtol=2e-4,
                                   atol=2e-3)
        np.testing.assert_allclose(tu0.numpy(), np.asarray(ju0), rtol=1e-4, atol=2e-4)
        assert int(tst.waypoint_idx) == int(jst.waypoint_idx), tick
        assert int(taux.status) == int(jaux.status), tick
        x = np.asarray(jstep(jnp.asarray(x), ju0), np.float32)
    return int(jst.waypoint_idx)


@pytest.mark.parametrize("persist", ["none", "max"])
@pytest.mark.parametrize("fuse_epilogue", [False, True])
@pytest.mark.parametrize("iso_xy", [False, True])
def test_diffdrive_tick_carry_matches_jax_kernel(persist, fuse_epilogue, iso_xy):
    (jc, jp, jstep), (tc, tp, tstep) = _make(persist=persist, num_samples=128)
    j_tick = jmppi.make_pallas_diffdrive_tick(jc, interpret=True, fuse_epilogue=fuse_epilogue,
                                              iso_xy=iso_xy)
    tsc, ttc = tmppi.make_tracking_costs(tc)
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, fused_tick=True,
                              fuse_epilogue=fuse_epilogue, iso_xy=iso_xy, device="cpu")
    assert solver.tick_fn.supports_rollout_carry
    wp = _closed_loop_compare(jc, jp, jstep, tc, tp, tstep, j_tick, solver, 12, 0, 128)
    if persist == "max":
        assert wp > 5


@pytest.mark.parametrize("carry_window_len", [30, 48])
def test_generic_tick_carry_matches_jax_kernel(carry_window_len):
    (jc, jp, jstep), (tc, tp, tstep) = _make(persist="max", num_samples=128,
                                              carry_window_len=carry_window_len)
    j_tick = jmppi.make_generic_fused_tick(jc, j_unicycle_tile(DT), interpret=True)
    tsc, ttc = tmppi.make_tracking_costs(tc)
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, fused_tick=True,
                              tile_dynamics=ttile.unicycle_tile(DT), fuse_epilogue=False,
                              device="cpu")
    assert solver.tick_fn.supports_rollout_carry
    _closed_loop_compare(jc, jp, jstep, tc, tp, tstep, j_tick, solver, 8, 4, 128)


def test_fused_tick_carry_equals_the_scan_path_at_the_path_end():
    """Near the path end the carry window repeats the last row: the plain
    tick's carried index equals the scan path's and never passes P − 1."""
    (_, _, _), (tc, tp, tstep) = _make(persist="max", num_samples=128)
    tsc, ttc = tmppi.make_tracking_costs(tc)
    fused = tmppi.MPPISolver(tc, tstep, tsc, ttc, fused_tick=True, device="cpu")
    P = tp.ref_path.shape[0]
    rng = np.random.default_rng(3)
    for start in (P - 25, P - 8, P - 1):
        st = tmppi.state_from_numpy(np.zeros((T, 2), np.float32), start, [0, 0], device="cpu")
        x = torch.as_tensor(np.r_[_path()[start, :2] + 0.2, -0.46].astype(np.float32))
        eps = torch.as_tensor(_noise(rng, tp, 128))
        su0, sst, saux = tmppi.mppi_step(tc, tstep, tsc, ttc, tp, st, x, noise=eps)
        fu0, fst, faux = fused.step(tp, st, x, noise=eps)
        assert int(fst.waypoint_idx) == int(sst.waypoint_idx) <= P - 1
        assert int(faux.status) == int(saux.status)
        np.testing.assert_allclose(faux.costs.numpy(), saux.costs.numpy(), rtol=2e-4, atol=2e-3)


# --- behaviour ------------------------------------------------------------------------


def test_rollout_carry_progresses_faster_than_tick_anchor():
    """The lookahead is the point: over 120 scan-path ticks the carry gets
    more than twice as far toward the goal as the tick anchor, and the
    status keeps judging the robot's own index (never the path end here)."""
    goal = np.array([10.0, -5.0])

    def run(carry, persist):
        _, (tc, tp, tstep) = _make(carry=carry, persist=persist)
        tsc, ttc = tmppi.make_tracking_costs(tc)
        solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, device="cpu", seed=0)
        x, st = torch.zeros(3), solver.init()
        for _ in range(120):
            u0, st, aux = solver.step(tp, st, x)
            x = tstep(x, u0)
            assert int(aux.status) & 1 == 0, (carry, persist)
        return float(np.linalg.norm(x[:2].numpy() - goal))

    d0 = float(np.linalg.norm(goal))
    prog_tick = d0 - run("tick", "none")
    prog_roll = d0 - run("rollout", "max")
    assert prog_roll > 2.0 * max(prog_tick, 1e-6), (prog_tick, prog_roll)


# --- guards -----------------------------------------------------------------------------


def test_blocked_route_refuses_the_carry():
    _, (tc, tp, tstep) = _make()
    tsc, ttc = tmppi.make_tracking_costs(tc)
    big = dataclasses.replace(tc, num_samples=131072, horizon=50)
    with pytest.raises(ValueError, match="single-block"):
        tmppi.MPPISolver(big, tstep, tsc, ttc, fused_tick=True, device="cpu")


def test_sharded_rollout_path_refuses_the_carry():
    _, (tc, tp, tstep) = _make()
    tsc, ttc = tmppi.make_tracking_costs(tc)
    with pytest.raises(ValueError, match="sharded"):
        tmppi.mppi_step(tc, tstep, tsc, ttc, tp, tmppi.MPPIState.init(tc, device="cpu"),
                        torch.zeros(3), noise=torch.zeros(K, T, 2),
                        rollout_fn=lambda *a, **k: None)


def test_tick_anchored_tick_fn_is_refused():
    _, (tc, tp, tstep) = _make()
    tsc, ttc = tmppi.make_tracking_costs(tc)
    anchored = tmppi.make_cuda_diffdrive_tick(dataclasses.replace(tc, waypoint_carry="tick"))
    with pytest.raises(ValueError, match="anchors its waypoint window"):
        tmppi.mppi_step(tc, tstep, tsc, ttc, tp, tmppi.MPPIState.init(tc, device="cpu"),
                        torch.zeros(3), noise=torch.zeros(K, T, 2), tick_fn=anchored)


@pytest.mark.parametrize("route", ["split rollout kernel", "split bicycle rollout",
                                   "fused bicycle tick", "fleet fused tick",
                                   "generic split rollout"])
def test_routes_without_the_carry_raise(route):
    """The routes JAX gives no carry keep raising: the split rollouts (rows
    1, 6, 9), the bicycle tick (row 7) and the fleet (row 5)."""
    _, (tc, tp, tstep) = _make()
    binders = {
        "split rollout kernel": lambda: tmppi.make_cuda_diffdrive_rollout(tc),
        "split bicycle rollout": lambda: tmppi.make_cuda_bicycle_rollout(tc),
        "fused bicycle tick": lambda: tmppi.make_cuda_bicycle_tick(tc),
        "fleet fused tick": lambda: tmppi.make_fleet_fused_mppi_step(tc, tstep, device="cpu"),
        "generic split rollout": lambda: tmppi.make_cuda_generic_rollout(
            tc, ttile.unicycle_tile(DT)),
    }
    with pytest.raises(ValueError, match="waypoint_carry='rollout' is not implemented"):
        binders[route]()


@pytest.mark.parametrize("field", ["waypoint_carry", "waypoint_persist"])
def test_config_validation(field):
    _, (tc, tp, tstep) = _make()
    tsc, ttc = tmppi.make_tracking_costs(tc)
    bad = dataclasses.replace(tc, **{field: "bogus"})
    with pytest.raises(ValueError, match=field):
        tmppi.mppi_step(bad, tstep, tsc, ttc, tp, tmppi.MPPIState.init(tc, device="cpu"),
                        torch.zeros(3), noise=torch.zeros(K, T, 2))
    with pytest.raises(ValueError, match=field):
        tmppi.MPPISolver(bad, tstep, tsc, ttc, fused_tick=True, device="cpu")


def test_config_fields_match_jax():
    for name in ("waypoint_carry", "waypoint_persist", "carry_window_len"):
        j = next(f for f in dataclasses.fields(jcfg.MPPIConfig) if f.name == name)
        t = next(f for f in dataclasses.fields(tcfg.MPPIConfig) if f.name == name)
        assert t.default == j.default, name
    cfg = tcfg.MPPIConfig(num_samples=8, horizon=50, dim_x=3, dim_u=2, dt=0.02)
    assert tmppi.carry_window_len(cfg, 1000) == 70
    assert tmppi.carry_window_len(cfg, 40) == 40
    assert tmppi.carry_window_len(dataclasses.replace(cfg, carry_window_len=30), 1000) == 30
