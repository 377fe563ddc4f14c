"""The port's MPPI slice as a whole against the JAX package.

* a 5-tick closed loop of the port's ``MPPISolver(fused_tick=True)`` against
  the JAX engine with its fused Pallas tick (interpret mode), the same
  injected ε each tick; trajectories to rtol 1e-3 / atol 1e-4 as
  tests/test_mppi_tick.py::test_tick_closed_loop_matches_scan;
* the scan path and the split-rollout path against the JAX ones (S rtol and
  atol 2e-4, w rtol 2e-4 atol 1e-6, controls rtol 1e-4 atol 1e-5);
* routing, the guards on unported options, and that importing the port
  never imports JAX.
"""

from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch import presets
from dnn_mppi_mpc_tpu_torch.models import euler_step, unicycle
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

DT = 0.05
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_ENUMS = {"accumulation": "CostAccumulation", "filter": "SmoothingFilter",
          "temperature": "Temperature"}


def _cfg(module, kw):
    """module.MPPIConfig from keyword arguments, enum fields given by value."""
    return module.MPPIConfig(
        **{k: getattr(module, _ENUMS[k])(v) if k in _ENUMS else v for k, v in kw.items()}
    )


def _problem(K=512, T=12, W=8, collision="none", params_kw=None, **cfg_kw):
    kw = dict(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT, lam=0.8, alpha=0.3,
              exploration=0.2, filter_window=5, waypoint_search_len=W)
    kw.update(cfg_kw)
    n = 40
    p = dict(
        sigma=np.array([[0.2, 0.05], [0.05, 0.1]], np.float32),
        stage_weight=np.array([4.0, 4.0, 0.5], np.float32),
        terminal_weight=np.array([9.0, 9.0, 2.0], np.float32),
        u_min=np.array([-1.5, -2.0], np.float32),
        u_max=np.array([1.5, 2.0], np.float32),
        ref_path=np.stack([np.linspace(0, 4, n), np.sin(np.linspace(0, 2, n)),
                           np.linspace(0.1, 0.5, n)], 1).astype(np.float32),
    )
    p.update({k: np.asarray(v, np.float32) for k, v in (params_kw or {}).items()})
    jc, tc = _cfg(jcfg, kw), _cfg(tcfg, kw)
    jp = jcfg.MPPIParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = tcfg.params_from_numpy(**p)
    jsc, jtc = jmppi.make_tracking_costs(jc, collision=collision)
    tsc, ttc = tmppi.make_tracking_costs(tc, collision=collision)
    return (jc, jp, lambda x, u: j_euler(j_unicycle, x, u, DT), jsc, jtc), (
        tc, tp, lambda x, u: euler_step(unicycle, x, u, DT), tsc, ttc)


def _noise(cfg, sigma, seed):
    rng = np.random.default_rng(seed)
    return rng.multivariate_normal(
        np.zeros(2), np.asarray(sigma), (cfg.num_samples, cfg.horizon)
    ).astype(np.float32)


def _key_words(key):
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key).astype(np.int64).tolist()


@pytest.mark.parametrize("iso_xy", [False, True])
def test_closed_loop_fused_tick_matches_jax(iso_xy):
    jside, tside = _problem(collision="circle",
                            params_kw=dict(obstacles=[[1.0, 0.4, 0.3], [2.5, 0.8, 0.4]]))
    jc, jp, jstep, jsc, jtc = jside
    tc, tp, tstep, tsc, ttc = tside
    jtick = jmppi.make_pallas_diffdrive_tick(jc, robot_radius=0.5, interpret=True,
                                             fuse_epilogue=True, iso_xy=iso_xy)
    jrun = jax.jit(lambda p, s, x, n: jmppi.mppi_step(jc, jstep, jsc, jtc, p, s, x, n,
                                                      tick_fn=jtick))
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, fused_tick=True, iso_xy=iso_xy)
    assert solver.tick_fn.__qualname__.startswith("make_cuda_diffdrive_tick.")
    x_j = jnp.array([0.0, 0.2, 0.0], jnp.float32)
    x_t = torch.tensor([0.0, 0.2, 0.0])
    st_j, st_t = jmppi.MPPIState.init(jc), solver.init()
    for i in range(5):
        eps = _noise(jc, jp.sigma, 100 + i)
        u_j, st_j, aux_j = jrun(jp, st_j, x_j, jnp.asarray(eps))
        u_t, st_t, aux_t = solver.step(tp, st_t, x_t, torch.as_tensor(eps))
        x_j, x_t = jstep(x_j, u_j), tstep(x_t, u_t)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev),
                                   rtol=1e-3, atol=1e-4)
        assert int(st_t.waypoint_idx) == int(st_j.waypoint_idx)
        assert st_t.key.tolist() == _key_words(st_j.key)
        assert int(aux_t.status) == int(aux_j.status) == 0


SCAN_CASES = {
    "sum": dict(),
    "last_circle": dict(collision="circle", accumulation="last",
                        params_kw=dict(obstacles=[[1.0, 0.4, 0.3], [2.5, 0.8, 0.4]])),
    "soft_drift_control_cost": dict(
        collision="soft", filter="savgol",
        params_kw=dict(obstacles=[[1.2, 0.9, 0.3], [2.2, 1.6, 0.4]],
                       obstacle_velocities=[[0.5, 0.3], [-0.4, 0.2]],
                       control_weight=[0.1, 0.1])),
    "repeats_exploration_temp": dict(num_rollout_repeats=2, rollout_var_cost=0.5,
                                     temperature="exploration", exploration=0.5,
                                     filter="ma_padded"),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_path_matches_jax(case):
    jside, tside = _problem(compute_optimal_traj=True, **SCAN_CASES[case])
    jc, jp, jstep, jsc, jtc = jside
    tc, tp, tstep, tsc, ttc = tside
    eps = _noise(jc, jp.sigma, 7)
    u_prev = np.random.default_rng(0).normal(0, 0.3, (jc.horizon, 2)).astype(np.float32)
    x0 = np.array([0.1, -0.05, 0.2], np.float32)
    st_j = jmppi.MPPIState(u_prev=jnp.asarray(u_prev), waypoint_idx=jnp.asarray(2, jnp.int32),
                           key=jax.random.PRNGKey(0))
    u_j, st_j, aux_j = jax.jit(
        lambda p, s, x, n: jmppi.mppi_step(jc, jstep, jsc, jtc, p, s, x, n)
    )(jp, st_j, jnp.asarray(x0), jnp.asarray(eps))
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc)
    u_t, st_t, aux_t = solver.step(tp, tmppi.state_from_numpy(u_prev, 2, [0, 0]),
                                   torch.as_tensor(x0), torch.as_tensor(eps))
    np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(aux_t.weights.numpy(), np.asarray(aux_j.weights),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aux_t.optimal_traj.numpy(), np.asarray(aux_j.optimal_traj),
                               rtol=1e-4, atol=1e-5)
    assert int(aux_t.status) == int(aux_j.status)
    assert int(st_t.waypoint_idx) == int(st_j.waypoint_idx)


def test_split_rollout_path_matches_jax():
    jside, tside = _problem(collision="circle", accumulation="last",
                            params_kw=dict(obstacles=[[1.0, 0.4, 0.3], [2.5, 0.8, 0.4]]))
    jc, jp, jstep, jsc, jtc = jside
    tc, tp, tstep, tsc, ttc = tside
    eps = _noise(jc, jp.sigma, 11)
    x0 = np.array([0.1, -0.05, 0.2], np.float32)
    rollout = jmppi.make_pallas_diffdrive_rollout(jc, robot_radius=0.5, interpret=True)
    u_j, st_j, aux_j = jax.jit(
        lambda p, s, x, n: jmppi.mppi_step(jc, jstep, jsc, jtc, p, s, x, n, rollout_fn=rollout)
    )(jp, jmppi.MPPIState.init(jc), jnp.asarray(x0), jnp.asarray(eps))
    solver = tmppi.MPPISolver(tc, tstep, tsc, ttc, use_kernel=True)
    assert solver.rollout_fn is not None and solver.tick_fn is None
    u_t, st_t, aux_t = solver.step(tp, solver.init(), torch.as_tensor(x0), torch.as_tensor(eps))
    np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "K, T, kw, route",
    [
        (10240, 50, dict(fused_tick=True), "make_cuda_diffdrive_tick"),
        (102400, 50, dict(fused_tick=True), "make_cuda_diffdrive_tick_blocked"),
        (10240, 50, dict(use_kernel=True), "make_cuda_diffdrive_rollout"),
    ],
    ids=["single_block", "k_blocked", "split_rollout"],
)
def test_solver_routes_like_jax(K, T, kw, route):
    cfg, params, step, stage, terminal = presets.flagship(K, T, "cpu")
    solver = tmppi.MPPISolver(cfg, step, stage, terminal, **kw)
    fn = solver.tick_fn or solver.rollout_fn
    assert fn.__qualname__.split(".")[0] == route
    if route.endswith("_blocked"):
        assert tmppi._pick_k_block(K, T) == jmppi._pick_k_block(K, T) == 10240


def test_flagship_preset_matches_jax():
    from __graft_entry__ import _flagship

    jc, jp, *_ = _flagship(1024, 20)
    tc, tp, *_ = presets.flagship(1024, 20, "cpu")
    for f in dataclasses.fields(tc):
        tv = getattr(tc, f.name)
        jv = getattr(jc, "use_pallas" if f.name == "use_kernel" else f.name)
        assert (tv.value if hasattr(tv, "value") else tv) == (jv.value if hasattr(jv, "value") else jv)
    for name in ("sigma", "stage_weight", "terminal_weight", "u_min", "u_max", "ref_path"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))


def _flag(**cfg_kw):
    cfg, params, step, stage, terminal = presets.flagship(1024, 20, "cpu")
    return dataclasses.replace(cfg, **cfg_kw), params, step, stage, terminal


GUARDS = {
    "waypoint_carry_rollout": (dict(waypoint_carry="rollout"), dict(fused_tick=True), "waypoint_carry"),
    "lean": ({}, dict(fused_tick=True, lean=True), "lean"),
    "fold_anchor": ({}, dict(fused_tick=True, fold_anchor=True), "fold_anchor"),
    "sincos_poly": ({}, dict(fused_tick=True, sincos="poly"), "sincos"),
    "gaussian_popcount": ({}, dict(fused_tick=True, gaussian="popcount"), "gaussian"),
    "tile_dynamics": ({}, dict(fused_tick=True, tile_dynamics=object()), "tile_dynamics"),
    "repeats_fused": (dict(num_rollout_repeats=2), dict(fused_tick=True), "num_rollout_repeats"),
    "repeats_split": (dict(num_rollout_repeats=2), dict(use_kernel=True), "num_rollout_repeats"),
    "time_varying_fused": (dict(time_varying_dynamics=True), dict(fused_tick=True),
                           "time_varying_dynamics"),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_unported_options_raise_at_construction(case):
    cfg_kw, solver_kw, match = GUARDS[case]
    cfg, params, step, stage, terminal = _flag(**cfg_kw)
    with pytest.raises(ValueError, match=match):
        tmppi.MPPISolver(cfg, step, stage, terminal, **solver_kw)


def test_polygon_collision_raises():
    """The vehicle polygon is the race car's cost: the diff-drive ticks, which
    compile in the circle and soft costs, refuse it (the JAX kernel asserts
    the same); an unknown mode is refused by the scan costs too."""
    cfg, params, step, stage, terminal = _flag()
    for K in (1024, 102400):  # the fused tick and the K-blocked tick
        with pytest.raises(ValueError, match="polygon"):
            tmppi.MPPISolver(dataclasses.replace(cfg, num_samples=K), step, stage, terminal,
                             fused_tick=True, collision="polygon")
    with pytest.raises(ValueError, match="collision"):
        tmppi.make_tracking_costs(cfg, collision="ellipse")


def test_runtime_guards_raise():
    cfg, params, step, stage, terminal = _flag()
    x0 = torch.zeros(3)
    split = tmppi.MPPISolver(cfg, step, stage, terminal, use_kernel=True)
    with pytest.raises(ValueError, match="control_weight"):
        split.step(dataclasses.replace(params, control_weight=torch.tensor([0.1, 0.1])),
                   split.init(), x0)
    with pytest.raises(ValueError, match="moving obstacles"):
        split.step(dataclasses.replace(params, obstacles=torch.tensor([[1.0, 0.0, 0.2]]),
                                       obstacle_velocities=torch.tensor([[0.1, 0.0]])),
                   split.init(), x0)


def test_iso_xy_weights_checked_once_per_params(monkeypatch):
    cfg, params, step, stage, terminal = _flag()
    solver = tmppi.MPPISolver(cfg, step, stage, terminal, fused_tick=True, iso_xy=True)
    calls = []
    real = tmppi._check_iso_weights
    monkeypatch.setattr(tmppi, "_check_iso_weights", lambda p: calls.append(1) or real(p))
    st, x0 = solver.init(), torch.zeros(3)
    for _ in range(3):
        _, st, _ = solver.step(params, st, x0)
    assert len(calls) == 1
    bad = dataclasses.replace(params, stage_weight=torch.tensor([5.0, 4.0, 10.0]))
    with pytest.raises(ValueError, match="symmetric"):
        solver.step(bad, st, x0)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import dnn_mppi_mpc_tpu_torch, dnn_mppi_mpc_tpu_torch.presets\n"
        "import dnn_mppi_mpc_tpu_torch.solvers.mppi, dnn_mppi_mpc_tpu_torch.ops.cuda\n"
        "import dnn_mppi_mpc_tpu_torch.utils.benchtime, dnn_mppi_mpc_tpu_torch._build\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'dnn_mppi_mpc_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(new))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr
    for src in (REPO / "dnn_mppi_mpc_tpu_torch").rglob("*.py"):
        text = src.read_text()
        assert "import jax" not in text and "from jax" not in text, src
        assert "dnn_mppi_mpc_tpu." not in text.replace("dnn_mppi_mpc_tpu_torch", ""), src


@pytest.mark.cuda
def test_flagship_closed_loop_on_card(cuda_device):
    from dnn_mppi_mpc_tpu_torch.ops import cuda as kern

    cfg, params, step, stage, terminal = presets.flagship(10240, 50, cuda_device)
    solver = tmppi.MPPISolver(cfg, step, stage, terminal, fused_tick=True, iso_xy=True,
                              device=cuda_device)
    kern.reset_counts()
    st = solver.init()
    x = torch.tensor([0.0, 0.0, float(np.arctan2(-10.0, 20.0))], device=cuda_device)
    statuses = []
    for _ in range(20):
        u0, st, aux = solver.step(params, st, x)
        x = step(x, u0)
        statuses.append(aux.status)
    torch.cuda.synchronize()
    assert kern.diffdrive_mppi_tick.launches == 20
    assert kern.diffdrive_mppi_tick_plain.calls == 0
    assert int(torch.stack(statuses).max()) == 0 and bool(torch.isfinite(x).all())
