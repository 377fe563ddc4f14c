"""Tile steps of the user's on the card: the tracer, its refusals, the build
key, and the rollout step t that F(x, u, t) receives.

* ``t``: JAX's ``dyn_tv`` (tests/test_time_varying.py:44, actuation decaying
  with t) through JAX's ``mppi_step`` scan and through the port's scan step
  on the same numpy noise, costs, u0 and the optimal trajectory within
  1e-6; every path that calls F(x, u, t) — the scan step, the optimal
  trajectory, sampled trajectories, CEM and the generic plain twin — hands
  it a 0-d int32 tensor (JAX's int32 index), from one ``arange`` a call;
* ``ops/cuda/user_tile.py``: the headers it emits (widths, TAKES_T, one
  sincosf for a sin and cos of one argument, hexadecimal float32 literals,
  the int t cast where the step casts it), the same step lowered once, and
  a refusal naming the cause for a matrix product, ``irk_step``'s
  ``linalg_solve``, a reduction, Python branching on a value, a wrong state
  count and an nx/nu mismatch, on the card route (``kernel_model`` and
  ``MPPISolver(device="cuda")``), while the plain version still runs those
  steps on CPU tensors;
* ``_build.build_user``: the library's key changes with a constant of the
  step, the same step reuses the library on disk, and a build without nvcc
  raises.

The generated kernels themselves run on the CPU emulator in
tests/test_torch_user_tile_emu.py, and on the card in ``chip_smoke.py``'s
``user_tile_*`` phases.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import _build
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch.models import dynamics as tdyn
from dnn_mppi_mpc_tpu_torch.models import tile as ttile
from dnn_mppi_mpc_tpu_torch.models.integrators import euler_step, irk_step, rk4_step
from dnn_mppi_mpc_tpu_torch.ops.cuda import generic_tick as gt
from dnn_mppi_mpc_tpu_torch.ops.cuda import user_tile
from dnn_mppi_mpc_tpu_torch.solvers import cem as tcem
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi
from test_time_varying import _cfg as j_cfg
from test_time_varying import _noise as j_noise
from test_time_varying import _params as j_params
from test_time_varying import dyn_tv as j_dyn_tv

DT = 0.05


def t_dyn_tv(x, u, t):
    """JAX's dyn_tv in PyTorch, as its author would write it there."""
    decay = 1.0 / (1.0 + 0.1 * t.to(x.dtype) * DT)
    v, w, yaw = u[..., 0] * decay, u[..., 1] * decay, x[..., 2]
    return torch.stack([x[..., 0] + v * torch.cos(yaw) * DT,
                        x[..., 1] + v * torch.sin(yaw) * DT, yaw + w * DT], -1)


def _port_cfg(jc, **kw):
    fields = ("num_samples", "horizon", "dim_x", "dim_u", "dt", "lam", "alpha", "exploration",
              "filter_window", "waypoint_search_len", "time_varying_dynamics",
              "compute_optimal_traj")
    return tcfg.MPPIConfig(**{**{k: getattr(jc, k) for k in fields}, **kw},
                           temperature=tcfg.Temperature(jc.temperature.value),
                           filter=tcfg.SmoothingFilter(jc.filter.value))


def _port_params(jp):
    return tcfg.params_from_numpy(**{k: np.asarray(getattr(jp, k)) for k in (
        "sigma", "stage_weight", "terminal_weight", "u_min", "u_max", "ref_path")}, device="cpu")


def test_time_varying_scan_matches_jax():
    """dyn_tv through both scan steps on the same noise: S, u0 and the
    optimal trajectory within 1e-6 (ROADMAP §C: 2.4e-7, 9.3e-10 and 2.3e-10
    with t a 0-d int32 tensor; with t a Python int, as before, 2.4e-7,
    4.7e-10 and 5.8e-11 — decay = 1/(1 + 0.1·t·dt) in float64 then was one
    ulp off JAX's float32 chain at t = 6, 8 and 9, under the gate)."""
    jc, jp = j_cfg(compute_optimal_traj=True), j_params()
    stage, terminal = jmppi.make_tracking_costs(jc)
    x0, noise = np.array([0.0, 0.2, 0.1], np.float32), np.asarray(j_noise(3))
    u_j, _, aux_j = jax.jit(lambda p, s, x, n: jmppi.mppi_step(
        jc, j_dyn_tv, stage, terminal, p, s, x, n))(jp, jmppi.MPPIState.init(jc),
                                                    jnp.asarray(x0), jnp.asarray(noise))
    tc = _port_cfg(jc)
    solver = tmppi.MPPISolver(tc, t_dyn_tv, *tmppi.make_tracking_costs(tc), device="cpu")
    u_t, _, aux_t = solver.step(_port_params(jp), solver.init(), torch.as_tensor(x0),
                                torch.tensor(noise))
    np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux_t.optimal_traj.numpy(), np.asarray(aux_j.optimal_traj),
                               rtol=1e-6, atol=1e-6)


class _Recorder:
    """F(x, u, t) that records what it was handed as t."""

    def __init__(self):
        self.seen = []

    def __call__(self, x, u, t):
        self.seen.append(t)
        return t_dyn_tv(x, u, t)


def _check_seen(seen, T):
    assert len(seen) >= T
    for i, t in enumerate(seen[:T]):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32 and t.dim() == 0
        assert int(t) == i


@pytest.mark.parametrize("path", ["scan", "optimal_traj", "sampled_trajectories", "cem",
                                  "generic_plain"])
def test_f_receives_t_as_an_int32_tensor(path):
    jc = j_cfg(compute_optimal_traj=path == "optimal_traj", num_samples=128, horizon=6)
    tc, tp = _port_cfg(jc), _port_params(j_params())
    rec = _Recorder()
    x0 = torch.tensor([0.0, 0.2, 0.1])
    noise = torch.as_tensor(np.random.default_rng(1).normal(0, 0.1, (128, 6, 2)),
                            dtype=torch.float32)
    stage, terminal = tmppi.make_tracking_costs(tc)
    if path in ("scan", "optimal_traj"):
        solver = tmppi.MPPISolver(tc, t_dyn_tv, stage, terminal, device="cpu")
        solver.dynamics_step = rec
        solver.step(tp, solver.init(), x0, noise)
        if path == "optimal_traj":  # the scan's T calls, then the re-rollout's
            _check_seen(rec.seen[6:], 6)
    elif path == "sampled_trajectories":
        tmppi.sampled_trajectories(tc, rec, tp, tmppi.MPPIState.init(tc, device="cpu"), x0,
                                   noise, torch.zeros(128))
    elif path == "cem":
        ccfg = tcem.CEMConfig(num_samples=128, horizon=6, dim_x=3, dim_u=2, dt=DT, num_iters=2,
                              time_varying_dynamics=True)
        solver = tcem.CEMSolver(ccfg, rec, stage, terminal, device="cpu")
        solver.step(tp, solver.init(), x0)
    else:
        tc = dataclasses.replace(tc, time_varying_dynamics=True)
        tick = tmppi.make_cuda_generic_tick(tc, ttile.lift_dynamics_time_varying(rec))
        solver = tmppi.MPPISolver(tc, t_dyn_tv, stage, terminal, tick_fn=tick, device="cpu")
        solver.step(tp, solver.init(), x0, noise)
    _check_seen(rec.seen, 6)


# --- the tracer ---------------------------------------------------------------------


def _unicycle(dt):
    return ttile.lift_dynamics(lambda x, u: euler_step(tdyn.unicycle, x, u, dt))


def test_lowered_unicycle_header():
    """The lifted Euler unicycle: the widths, no t, one sincosf for cos(yaw)
    and sin(yaw), dt as a hexadecimal float32 literal, the state written
    back last."""
    low = user_tile.lower(_unicycle(0.02), 3, 2, False)
    h = low.header
    assert f"struct {low.name} {{" in h and f"using DmmUserTile = {low.name};" in h
    assert "static constexpr int NX = 3, NU = 2;" in h
    assert "static constexpr bool TAKES_T = false;" in h
    assert "void step(float* x, const float* v) const" in h
    assert h.count("sincosf(") == 1
    assert f"{float(np.float32(0.02)).hex()}f" in h
    assert h.index("sincosf(") < h.index("x[0] = ") < h.index("x[2] = ") < h.index("using")
    assert "aten.stack.default" in low.ops and "aten.cos.default" in low.ops


def test_lowered_time_varying_header():
    """dyn_tv: the step takes the int t, cast to float32 where the step
    casts it; 0.1 and dt as float32 literals."""
    low = user_tile.lower(ttile.lift_dynamics_time_varying(t_dyn_tv), 3, 2, True)
    assert "static constexpr bool TAKES_T = true;" in low.header
    assert "void step(float* x, const float* v, int t) const" in low.header
    assert "static_cast<float>(t)" in low.header
    assert f"{float(np.float32(0.1)).hex()}f" in low.header


def test_lowered_dynamic_bicycle_uses_atanf_and_its_guard():
    """torch.atan becomes dmm_user_atan (atanf on the card), never the
    atan_tile polynomial; the vx guard's 1e-6 is a float32 literal."""
    low = user_tile.lower(ttile.lift_dynamics(
        lambda x, u: euler_step(tdyn.dynamic_bicycle, x, u, DT)), 4, 2, False)
    assert low.header.count("dmm_user_atan(") == 3
    assert "dmm_atan_poly" not in low.header
    assert f"{float(np.float32(1e-6)).hex()}f" in low.header


def test_the_same_step_lowers_once():
    step = ttile.lift_dynamics(lambda x, u: rk4_step(tdyn.four_wheel_torque, x, u, DT))
    assert user_tile.lower(step, 5, 4, False) is user_tile.lower(step, 5, 4, False)


_W = torch.eye(3)


def _branching(x, u):
    if bool((x[..., 0] > 0).any()):
        return x
    return x + 1.0


def _three_of_two(xs, vs):
    return xs[0], xs[1]


# name -> (step, nx, nu, what the message names)
REFUSED = {
    "matrix product": (ttile.lift_dynamics(lambda x, u: x + x @ _W), 3, 2, "aten.mm"),
    "irk_step": (ttile.lift_dynamics(lambda x, u: irk_step(tdyn.unicycle, x, u, DT)), 3, 2,
                 "linalg_solve"),
    "reduction": (ttile.lift_dynamics(lambda x, u: x + u.sum(-1, keepdim=True)), 3, 2,
                  "aten.sum"),
    "python branching": (ttile.lift_dynamics(_branching), 3, 2, "data-dependent"),
    "wrong state count": (ttile.TileStep(None, None, None, (), False, _three_of_two), 3, 2,
                          "returned 2 state dims, expected nx=3"),
    "nx mismatch": (_unicycle(DT), 2, 2, "out of bounds"),
    "nu mismatch": (_unicycle(DT), 3, 1, "out of bounds"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_card_route_refuses_what_it_cannot_lower(case):
    step, nx, nu, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        gt.kernel_model(step, False, nx, nu)


@pytest.mark.parametrize("case", ["matrix product", "reduction", "python branching"])
def test_the_solver_on_the_card_refuses_at_construction(case, monkeypatch):
    """MPPISolver(device="cuda") traces the step before it touches the card."""
    step, nx, nu, match = REFUSED[case]
    monkeypatch.setattr(tmppi, "resolve_device", lambda d: torch.device("cuda"))
    cfg = tcfg.MPPIConfig(num_samples=128, horizon=6, dim_x=3, dim_u=2, dt=DT)
    with pytest.raises(ValueError, match=match):
        tmppi.MPPISolver(cfg, lambda x, u: x, *tmppi.make_tracking_costs(cfg), fused_tick=True,
                         tile_dynamics=step, device="cuda")


@pytest.mark.parametrize("case", ["matrix product", "irk_step", "reduction"])
def test_cpu_tensors_still_run_what_the_card_refuses(case):
    """The plain version runs a step the tracer refuses, on CPU tensors, as
    it did before the tracer existed — after the card route refused it too
    (a trace leaves no fake tensor in the IRK tableau's cache)."""
    step, nx, nu, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        gt.kernel_model(step, False, nx, nu)
    K, T = 128, 4
    rng = np.random.default_rng(0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    S, w, w_eps = gt.generic_mppi_tick(
        None, f(rng.normal(0, 0.3, (T, 2))), f(np.zeros((T, 2))), f(0.3 * np.eye(2)),
        f([0.1, 0.0, 0.2]), f(np.stack([np.linspace(0, 2, 8), np.zeros(8), np.zeros(8)], 1)),
        f([1.0, 1.0, 0.1]), f([2.0, 2.0, 0.2]), f([-2.0, -2.0]), f([2.0, 2.0]), DT, 0.9 * K,
        1.0, eps=f(rng.normal(0, 0.3, (K, T, 2))), step_tile=step, nx=nx, nu=nu, n_track=3,
        K=K, T=T, W=8)
    assert bool(torch.isfinite(S).all()) and abs(float(w.sum()) - 1.0) < 1e-5


# --- the build key --------------------------------------------------------------


def test_library_key_follows_the_generated_source(tmp_path, monkeypatch):
    """A constant of the step changes the key; the same step keeps it, and
    its library on disk is reused without nvcc; with no library and no nvcc
    the build raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    a = user_tile.lower(_unicycle(0.02), 3, 2, False).header
    b = user_tile.lower(_unicycle(0.021), 3, 2, False).header
    assert a != b and _build.user_library_path(a) != _build.user_library_path(b)
    assert _build.user_library_path(a) == _build.user_library_path(
        user_tile.lower(_unicycle(0.02), 3, 2, False).header)

    def no_nvcc():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    built = _build.user_library_path(a)
    built.write_bytes(b"")  # a library already built for this step
    assert _build.build_user(a) == built
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_user(b)


@pytest.mark.cuda
def test_lifted_unicycle_on_the_card_equals_its_plain_twin():
    """On the card: the lifted unicycle's generated kernel against the plain
    twin on the same injected ε (chip_smoke.py's user_tile_compare holds
    every case; this is the quick one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    K, T = 1024, 10
    rng = np.random.default_rng(0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    args = (None, f(rng.normal(0, 0.3, (T, 2))), f(np.zeros((T, 2))), f(0.3 * np.eye(2)),
            f([0.1, 0.0, 0.2]), f(np.stack([np.linspace(0, 2, 8), np.zeros(8), np.zeros(8)], 1)),
            f([1.0, 1.0, 0.1]), f([2.0, 2.0, 0.2]), f([-2.0, -2.0]), f([2.0, 2.0]), DT, 0.9 * K,
            1.0)
    kw = dict(eps=f(rng.normal(0, 0.3, (K, T, 2))), step_tile=_unicycle(DT), nx=3, nu=2,
              n_track=3, K=K, T=T, W=8)
    got = gt.generic_mppi_tick(*args, **kw)
    want = gt.generic_mppi_tick_plain(*args, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
