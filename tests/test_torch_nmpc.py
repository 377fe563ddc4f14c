"""The port's SQP-RTI NMPC engine against the JAX package, on the CPU.

* the integrators: ``erk_step`` on the unicycle (rtol 1e-6), the
  Gauss-Legendre tableau (1e-12), ``irk_step`` on the four-wheel torque
  model (rtol 1e-5); its Newton solve (``pivoted_solve``) against
  ``jnp.linalg.solve`` on seeded IRK Newton systems and an ill-conditioned
  one that needs row swaps, and its Jacobians under ``vmap(jacrev)``
  against JAX's ``vmap(jacfwd)``; ``_linearize``'s A, B and c through ERK
  and IRK (rtol/atol 1e-5);
* one tick of ``presets.diff_drive_nmpc(N=30, two obstacles, sqp_iters=1,
  device="cpu")`` from the same warm start as the JAX solver: the torch QP
  backend's serial sweep against JAX ``qp_backend="xla",
  parallel_riccati=False`` (every test against JAX's serial route sets
  ``parallel_riccati=False`` on both sides) and its associative scan
  against JAX's default route (both ``parallel_riccati=True``), the
  kernel backend (its plain version on the CPU) against JAX
  ``qp_backend="pallas"`` (interpret mode); u0, X and U within rtol/atol
  1e-3 (the JAX tests allow 2e-3 between their own two backends);
* a 20-tick closed loop on the torch backend (N = 20, one obstacle) beside
  the JAX loop: each tick locked to JAX's warm start within 1e-3, the
  free-running final position within rtol/atol 0.05 as
  tests/test_riccati_qp.py:133; a 10-tick loop on the kernel backend at
  N = 10 against the port's torch backend (0.05);
* one tick each of ``racecar_nmpc`` (kinematic and dynamic),
  ``four_wheel_nmpc`` (IRK, N = 10), a general NONLINEAR_LS ``y_fn`` (the
  cross term S reaches the QP), a separable ``y_x_fn`` and ``soft_h=True``
  against JAX on the same inputs (1e-3);
* ``batched_solve`` on both backends against per-member ``solve`` (rtol
  1e-4, atol 1e-5 as tests/test_nmpc.py:239), and against the JAX
  ``batched_solve`` at B = 4, N = 12 (1e-3);
* JAX's default route (``parallel_riccati=True``, the associative scan) on
  both sides: nmpc_rti for 10 ticks locked to JAX's warm start (1e-3) and
  free running (0.05), and a B = 4 fleet for 3 ticks through ``solve``,
  ``batched_solve`` and the sharded fleet at world size 1 (1e-3 against
  JAX; members 1e-4/1e-5; the sharded fleet bit-equal);
* the vendored oracle (``testing/oracle_nmpc.py``) equal to the JAX
  package's copy on config 9 for 10 ticks; ``ocp_params_from_numpy`` and
  ``state_from_numpy`` round-trip the JAX leaves; the device guards.

Every comparison prints its largest error.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dnn_mppi_mpc_tpu import presets as jpresets
from dnn_mppi_mpc_tpu.config import SQPConfig as JSQPConfig
from dnn_mppi_mpc_tpu.models import dynamics as jdyn
from dnn_mppi_mpc_tpu.models import integrators as jint
from dnn_mppi_mpc_tpu.solvers import sqp as jsqp
from dnn_mppi_mpc_tpu.testing import oracle_nmpc as j_oracle
from dnn_mppi_mpc_tpu_torch import parallel, presets
from dnn_mppi_mpc_tpu_torch.config import SQPConfig
from dnn_mppi_mpc_tpu_torch.models import dynamics as tdyn
from dnn_mppi_mpc_tpu_torch.models import integrators as tint
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern
from dnn_mppi_mpc_tpu_torch.solvers import sqp as tsqp
from dnn_mppi_mpc_tpu_torch.testing import oracle_nmpc as t_oracle

GOAL = [3.0, 2.0, 0.0]
OBSTACLES = [[1.5, 1.0, 0.3], [2.5, 1.8, 0.3]]  # the JAX suite's nmpc_rti row


@pytest.fixture
def one_torch_thread():
    """Small tensors: one intra-op thread spares every op the thread pool's
    wake-up cost, which would dominate its time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(name, got, want, rtol, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    print(f"{name}: max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _jax_cfg(backend: str) -> dict:
    return dict(qp_backend=backend, parallel_riccati=False)


# the port's side of a comparison with JAX's serial route
SERIAL = dict(parallel_riccati=False)


def _port_params(jparams) -> tsqp.OCPParams:
    return tsqp.ocp_params_from_numpy(
        **{f.name: None if getattr(jparams, f.name) is None else np.asarray(getattr(jparams, f.name))
           for f in dataclasses.fields(jparams)}, device="cpu")


def _warm_start(N, nx, nu, x0, seed=0):
    """A smooth, feasible warm start both solvers get: X drifting from x0,
    U small."""
    rng = np.random.default_rng(seed)
    drift = np.linspace(0.0, 1.0, N + 1)[:, None] * (0.1 + 0.2 * rng.random(nx))[None, :]
    X = (np.asarray(x0, np.float32)[None, :] + drift).astype(np.float32)
    U = (0.1 + 0.05 * rng.normal(size=(N, nu))).astype(np.float32)
    return X, U


def _one_tick(jsolver, jparams, tsolver, tparams, x0, name, tol=1e-3, seed=0):
    cfg = tsolver.cfg
    X, U = _warm_start(cfg.N, cfg.dim_x, cfg.dim_u, x0, seed)
    x0 = np.asarray(x0, np.float32)
    ju0, jst, jaux = jsolver.solve(jparams, jsqp.NMPCState(X=jnp.asarray(X), U=jnp.asarray(U)),
                                   jnp.asarray(x0))
    tu0, tst, taux = tsolver.solve(tparams, tsqp.state_from_numpy(X, U, device="cpu"),
                                   torch.tensor(x0))
    _close(f"{name} u0", tu0.numpy(), np.asarray(ju0), tol, tol)
    _close(f"{name} X", tst.X.numpy(), np.asarray(jst.X), tol, tol)
    _close(f"{name} U", tst.U.numpy(), np.asarray(jst.U), tol, tol)
    assert int(taux.status) == int(jaux.status) == 0
    return taux, jaux


# --- integrators ------------------------------------------------------------------


def test_erk_step_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    u = rng.normal(size=(6, 2)).astype(np.float32)
    got = tint.erk_step(tdyn.unicycle, torch.tensor(x), torch.tensor(u), 0.1)
    want = jint.erk_step(jdyn.unicycle, jnp.asarray(x), jnp.asarray(u), 0.1)
    _close("erk_step", got.numpy(), np.asarray(want), 1e-6, 1e-7)


def test_gauss_legendre_tableau_matches_jax():
    for s in (1, 2, 4):
        for name, a, b in zip("cAb", tint._gauss_legendre_tableau(s),
                              jint._gauss_legendre_tableau(s)):
            _close(f"tableau {name} s={s}", a, b, 1e-12, 1e-12)


def test_irk_step_matches_jax():
    rng = np.random.default_rng(1)
    x = (0.3 * rng.normal(size=(4, 5))).astype(np.float32)
    u = rng.normal(size=(4, 4)).astype(np.float32)
    got = tint.irk_step(tdyn.four_wheel_torque, torch.tensor(x), torch.tensor(u), 0.1)
    want = jint.irk_step(jdyn.four_wheel_torque, jnp.asarray(x), jnp.asarray(u), 0.1)
    _close("irk_step", got.numpy(), np.asarray(want), 1e-5, 1e-6)
    one = tint.irk_step(tdyn.four_wheel_torque, torch.tensor(x[0]), torch.tensor(u[0]), 0.1)
    _close("irk_step unbatched", one.numpy(), np.asarray(want[0]), 1e-5, 1e-6)


def _irk_newton_systems(seed: int, count: int, dt: float = 0.1, s: int = 4):
    """The IRK Newton systems M·dK = −r (M = I − h·(A⊗J), 20 × 20) that
    ``irk_step`` solves first at ``count`` seeded four-wheel states and
    torques: the explicit-Euler stage init, J at each stage state."""
    A = torch.tensor(tint._gauss_legendre_tableau(s)[1], dtype=torch.float32)
    h, nx = dt / 3, 5
    rng = np.random.default_rng(seed)
    Ms, rs = [], []
    for _ in range(count):
        x = torch.tensor((0.5 * rng.normal(size=nx)).astype(np.float32))
        u = torch.tensor((2.0 * rng.normal(size=4)).astype(np.float32))

        def f(q, u=u):
            return tdyn.four_wheel_torque(q, u)

        K = f(x).expand(s, nx)
        X_st = x[None] + h * (A @ K)
        J = torch.func.vmap(torch.func.jacrev(f))(X_st)
        M = torch.eye(s * nx) - h * (A[:, :, None, None] * J[:, None]).permute(
            0, 2, 1, 3).reshape(s * nx, s * nx)
        Ms.append(M)
        rs.append((K - torch.func.vmap(f)(X_st)).reshape(-1))
    return torch.stack(Ms), torch.stack(rs)


def test_pivoted_solve_matches_jax_on_irk_newton_systems():
    """``pivoted_solve``, the IRK's Newton solve, against ``jnp.linalg.solve``
    (LAPACK's partial-pivot LU) on six seeded four-wheel Newton systems
    (vmapped, as the tick batches them) within rtol/atol 1e-6; and on an
    ill-conditioned one (cond ~4e4) whose rows are rolled so that column
    0's largest entry lies below row 0 (no elimination step without a row
    swap), within 1e-6 of the solution's largest entry."""
    M, r = _irk_newton_systems(0, 6)
    got = torch.func.vmap(tint.pivoted_solve)(M, -r)
    want = jax.vmap(jnp.linalg.solve)(jnp.asarray(M.numpy()), jnp.asarray(-r.numpy()))
    _close("pivoted_solve, Newton systems", got.numpy(), np.asarray(want), 1e-6, 1e-6)

    rng = np.random.default_rng(3)
    Mi = M[0].numpy().astype(np.float64)[np.roll(np.arange(20), 7)]
    Mi[19] += Mi[:19].T @ rng.normal(size=19) * 0.05 + 1e-4 * rng.normal(size=20) - Mi[19]
    Mi = Mi.astype(np.float32)
    assert np.linalg.cond(Mi.astype(np.float64)) > 1e4
    assert abs(Mi[0, 0]) < np.abs(Mi[:, 0]).max()  # the first pivot is a swapped row
    b = rng.normal(size=20).astype(np.float32)
    got = tint.pivoted_solve(torch.tensor(Mi), torch.tensor(b)).numpy()
    want = np.asarray(jnp.linalg.solve(jnp.asarray(Mi), jnp.asarray(b)))
    _close("pivoted_solve, ill-conditioned", got, want, 0.0, 1e-6 * np.abs(want).max())


def test_pivoted_solve_differentiates_under_vmap():
    """``vmap(jacrev(...))`` through the solve, as the SQP engine linearizes
    through ``irk_step`` (``solvers/sqp.py _linearize``): the Jacobians in M
    and in the right-hand side against JAX's ``vmap(jacfwd)`` of
    ``jnp.linalg.solve`` (1e-5)."""
    M, r = _irk_newton_systems(4, 3)
    dM, db = torch.func.vmap(torch.func.jacrev(tint.pivoted_solve, argnums=(0, 1)))(M, r)
    jM, jb = jax.vmap(jax.jacfwd(jnp.linalg.solve, argnums=(0, 1)))(
        jnp.asarray(M.numpy()), jnp.asarray(r.numpy()))
    _close("d solve / d M", dM.numpy(), np.asarray(jM), 1e-5, 1e-5)
    _close("d solve / d b", db.numpy(), np.asarray(jb), 1e-5, 1e-5)


@pytest.mark.parametrize("integrator", ["erk", "irk"])
def test_linearize_matches_jax(integrator):
    """A, B and c of the shooting intervals through ERK (unicycle) and IRK
    (four-wheel), one vmap(jacrev) pass each (JAX: vmap(jacfwd))."""
    rng = np.random.default_rng(2)
    if integrator == "erk":
        nx, nu, tf, jf = 3, 2, tdyn.unicycle, jdyn.unicycle

        def tstep(x, u):
            return tint.erk_step(tf, x, u, 0.1)

        def jstep(x, u):
            return jint.erk_step(jf, x, u, 0.1)
    else:
        nx, nu, tf, jf = 5, 4, tdyn.four_wheel_torque, jdyn.four_wheel_torque

        def tstep(x, u):
            return tint.irk_step(tf, x, u, 0.1)

        def jstep(x, u):
            return jint.irk_step(jf, x, u, 0.1)
    X = (0.3 * rng.normal(size=(7, nx))).astype(np.float32)
    U = (0.5 * rng.normal(size=(6, nu))).astype(np.float32)
    got = tsqp._linearize(tstep, torch.tensor(X), torch.tensor(U))
    want = jsqp._linearize(jstep, jnp.asarray(X), jnp.asarray(U))
    for name, g, w in zip("ABc", got, want):
        _close(f"linearize {integrator} {name}", g.numpy(), np.asarray(w), 1e-5, 1e-5)


# --- the nmpc_rti tick ---------------------------------------------------------------


def _rti(jax_backend: str, port_backend: str, N: int = 30, parallel: bool = False):
    js, jp = jpresets.diff_drive_nmpc(jnp.asarray(GOAL), N=N, obstacles=jnp.asarray(OBSTACLES),
                                      sqp_iters=1, qp_backend=jax_backend,
                                      parallel_riccati=parallel)
    ts, tp = presets.diff_drive_nmpc(GOAL, N=N, obstacles=OBSTACLES, sqp_iters=1,
                                     qp_backend=port_backend, parallel_riccati=parallel,
                                     device="cpu")
    return js, jp, ts, tp


@pytest.mark.parametrize("jax_backend,port_backend", [("xla", "torch"), ("pallas", "kernel")])
def test_rti_tick_matches_jax(jax_backend, port_backend):
    js, jp, ts, tp = _rti(jax_backend, port_backend)
    kern.reset_counts()
    taux, jaux = _one_tick(js, jp, ts, tp, [0.2, 0.1, 0.3], f"rti {port_backend}")
    _close("rti h_margin", float(taux.h_margin), float(jaux.h_margin), 1e-3, 1e-3)
    _close("rti defect", float(taux.defect), float(jaux.defect), 1e-3, 1e-4)
    _close("rti kkt", float(taux.kkt_residual), float(jaux.kkt_residual), 5e-2, 1e-4)
    want_plain = 1 if port_backend == "kernel" else 0
    assert kern.fused_barrier_qp_solve_plain.calls == want_plain
    assert kern.fused_barrier_qp_solve.launches == 0


def test_closed_loop_torch_backend_matches_jax():
    """20 ticks of the torch backend (N = 20, one obstacle, two SQP
    iterations) beside the JAX XLA backend, as tests/test_riccati_qp.py:
    102-133 drives it. Locked step (each tick from JAX's warm start and
    state): u0 and U within 1e-3. Free running: the final position within
    0.05; the yaw is left out there, because both loops chatter by about
    ±0.05 rad while they skirt the obstacle, and a 1e-6 difference puts
    the two out of phase."""
    obs = [[2.0, 0.6, 0.5]]
    goal = [4.0, 0.0, 0.0]
    js, jp = jpresets.diff_drive_nmpc(jnp.asarray(goal), N=20, obstacles=jnp.asarray(obs),
                                      parallel_riccati=False)
    ts, tp = presets.diff_drive_nmpc(goal, N=20, obstacles=obs, device="cpu", **SERIAL)
    x = jnp.zeros(3, jnp.float32)
    st = js.init(x)
    xt = torch.zeros(3)
    stt = ts.init(xt)
    worst = 0.0
    for _ in range(20):
        lock = tsqp.state_from_numpy(np.asarray(st.X), np.asarray(st.U), device="cpu")
        u_lock, _, aux_lock = ts.solve(tp, lock, torch.tensor(np.asarray(x)))
        u0, st, _ = js.solve(jp, st, x)
        worst = max(worst, float(np.abs(u_lock.numpy() - np.asarray(u0)).max()),
                    float(np.abs(aux_lock.U.numpy() - np.asarray(st.U)).max()))
        x = js.dyn_step(x, u0)
        u0t, stt, aux = ts.solve(tp, stt, xt)
        xt = ts.dyn_step(xt, u0t)
        assert int(aux.status) == 0
    print(f"locked-step u0/U max abs err {worst:.3e} (limit 1e-3)")
    assert worst < 1e-3
    _close("closed loop final position", xt[:2].numpy(), np.asarray(x)[:2], 0.05, 0.05)
    assert float(np.asarray(x)[0]) > 1.5 and float(xt[0]) > 1.5  # past the obstacle's front


def test_closed_loop_kernel_backend():
    """10 ticks at N = 10 on the kernel backend (its plain version here)
    against the torch backend: the same trajectory within 0.05."""
    finals = {}
    for backend in ("kernel", "torch"):
        s, p = presets.diff_drive_nmpc(GOAL, N=10, obstacles=OBSTACLES, sqp_iters=1,
                                       qp_backend=backend, device="cpu")
        x = torch.zeros(3)
        st = s.init(x)
        kern.reset_counts()
        for _ in range(10):
            u0, st, aux = s.solve(p, st, x)
            x = s.dyn_step(x, u0)
            assert int(aux.status) == 0
        if backend == "kernel":
            assert kern.fused_barrier_qp_solve_plain.calls == 10
        finals[backend] = x
    _close("kernel vs torch backend loop", finals["kernel"].numpy(), finals["torch"].numpy(),
           0.05, 0.05)
    assert float(torch.linalg.norm(finals["kernel"][:2])) > 0.5  # it moved toward the goal


# --- JAX's default route: the associative-scan Riccati on both sides ------------------


def test_rti_tick_scan_route_matches_jax():
    js, jp, ts, tp = _rti("xla", "torch", parallel=True)
    assert js.cfg.parallel_riccati and ts.cfg.parallel_riccati
    taux, jaux = _one_tick(js, jp, ts, tp, [0.2, 0.1, 0.3], "rti scan route")
    _close("rti scan route h_margin", float(taux.h_margin), float(jaux.h_margin), 1e-3, 1e-3)
    _close("rti scan route defect", float(taux.defect), float(jaux.defect), 1e-3, 1e-4)
    _close("rti scan route kkt", float(taux.kkt_residual), float(jaux.kkt_residual), 5e-2, 1e-4)


def test_rti_closed_loop_scan_route_matches_jax():
    """nmpc_rti (N = 30, two obstacles, one SQP iteration) for 10 ticks from
    x0 = 0 on JAX's default route and the port's: locked to JAX's warm start
    and state, u0 and U within 1e-3 every tick; free running, the final
    state within 0.05 (test_closed_loop_torch_backend_matches_jax's
    limits)."""
    js, jp, ts, tp = _rti("xla", "torch", parallel=True)
    x = jnp.zeros(3, jnp.float32)
    st = js.init(x)
    xt = torch.zeros(3)
    stt = ts.init(xt)
    worst = 0.0
    for _ in range(10):
        lock = tsqp.state_from_numpy(np.asarray(st.X), np.asarray(st.U), device="cpu")
        u_lock, _, aux_lock = ts.solve(tp, lock, torch.tensor(np.asarray(x)))
        u0, st, _ = js.solve(jp, st, x)
        worst = max(worst, float(np.abs(u_lock.numpy() - np.asarray(u0)).max()),
                    float(np.abs(aux_lock.U.numpy() - np.asarray(st.U)).max()))
        x = js.dyn_step(x, u0)
        u0t, stt, aux = ts.solve(tp, stt, xt)
        xt = ts.dyn_step(xt, u0t)
        assert int(aux.status) == 0
    print(f"scan route locked-step u0/U max abs err {worst:.3e} (limit 1e-3)")
    assert worst < 1e-3
    _close("scan route closed loop final state", xt.numpy(), np.asarray(x), 0.05, 0.05)


def test_scan_route_float32_on_a_stiff_qp():
    """The QP the port's nmpc_rti tick builds at JAX's tick-9 state (scan
    route on both sides, as in test_rti_closed_loop_scan_route_matches_jax):
    its h rows' barrier is stiff, and the float32 associative scan of the
    JAX package lands 0.43 from the exact δU there (the port's scan runs in
    float64 for that reason) while the serial sweep is within 1e-5. The
    port's scan route in float32 is held to 1e-4 of a float64 serial solve."""
    from dnn_mppi_mpc_tpu.solvers import qp as jqp
    from dnn_mppi_mpc_tpu_torch.solvers import qp as tqp

    js, jp, ts, tp = _rti("xla", "torch", parallel=True)
    x = jnp.zeros(3, jnp.float32)
    st = js.init(x)
    for _ in range(9):
        u0, st, _ = js.solve(jp, st, x)
        x = js.dyn_step(x, u0)
    seen = []
    real = tsqp.barrier_qp_solve

    def spy(qp, dx0, **kw):
        seen.append((qp, dx0, kw))
        return real(qp, dx0, **kw)

    tsqp.barrier_qp_solve = spy
    try:
        ts.solve(tp, tsqp.state_from_numpy(np.asarray(st.X), np.asarray(st.U), device="cpu"),
                 torch.tensor(np.asarray(x)))
    finally:
        tsqp.barrier_qp_solve = real
    (qp, dx0, kw), = seen
    kw = {k: v for k, v in kw.items() if k not in ("parallel", "return_kkt")}
    one = tqp.BoxedQPData(*(None if t is None else t[0] for t in qp))
    exact = tqp.barrier_qp_solve(tqp.BoxedQPData(*(None if t is None else t.double()
                                                   for t in one)), dx0[0].double(), **kw)[1]
    scan = tqp.barrier_qp_solve(one, dx0[0], parallel=True, **kw)[1]
    serial = tqp.barrier_qp_solve(one, dx0[0], **kw)[1]
    jax_scan = jqp.barrier_qp_solve(
        jqp.BoxedQPData(*(None if t is None else jnp.asarray(t.numpy()) for t in one)),
        jnp.asarray(dx0[0].numpy()), parallel=True, **kw)[1]
    errs = {name: float(np.abs(np.asarray(u, np.float64) - exact.numpy()).max())
            for name, u in (("port scan", scan), ("port serial", serial),
                            ("JAX scan", jax_scan))}
    print("float32 δU against a float64 serial solve:", errs)
    assert errs["port scan"] < 1e-4 and errs["port serial"] < 1e-4


@pytest.fixture
def gloo_world1():
    """A single-process gloo group for the test, torn down after it."""
    assert not dist.is_initialized()
    assert parallel.initialize_distributed(device="cpu") == (0, 1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_fleet_scan_route_matches_jax(gloo_world1):
    """A B = 4 fleet (N = 12, every leaf per member) for 3 ticks on JAX's
    default route and the port's, each tick from JAX's states: the port's
    ``batched_solve`` against JAX's ``batched_solve`` (1e-3), against each
    member's own ``solve`` (rtol 1e-4, atol 1e-5) and against the sharded
    fleet at world size 1 (bit-equal)."""
    B, N = 4, 12
    goals, x0s, obs, yref = _fleet_inputs(B, N)
    js, jbase = jpresets.diff_drive_nmpc(jnp.zeros(3), N=N,
                                         obstacles=jnp.asarray([[1.0, 0.0, 0.3]]))
    assert js.cfg.parallel_riccati and js.cfg.qp_backend == "xla"
    jsolver = jsqp.NMPCSolver(js.cfg, jdyn.unicycle, h_fn=jsqp.circle_obstacle_h)
    jparams = jax.vmap(lambda g, yr, ob: dataclasses.replace(jbase, yref=yr, yref_e=g, p=ob))(
        jnp.asarray(goals), jnp.asarray(yref), jnp.asarray(obs))
    jfleet = jsolver.batched_solve()
    ts, _ = presets.diff_drive_nmpc(np.zeros(3), N=N, obstacles=[[1.0, 0.0, 0.3]], device="cpu")
    assert ts.cfg.parallel_riccati and ts.cfg.qp_backend == "torch"
    tparams = _port_params(jparams)
    tfleet, sharded = ts.batched_solve(), parallel.make_sharded_nmpc_fleet(ts, device="cpu")
    x = jnp.asarray(x0s)
    st = jax.vmap(lambda x0: jsqp.NMPCState.init(js.cfg, x0))(x)
    for tick in range(3):
        tst = tsqp.state_from_numpy(np.asarray(st.X), np.asarray(st.U), device="cpu")
        xt = torch.tensor(np.asarray(x))
        tu0, tst_new, taux = tfleet(tparams, tst, xt)
        su0, sst, _ = sharded(tparams, tst, xt)
        torch.testing.assert_close(su0, tu0, rtol=0, atol=0)
        torch.testing.assert_close(sst.X, tst_new.X, rtol=0, atol=0)
        u0, st, jaux = jfleet(jparams, st, x)
        _close(f"scan-route fleet tick {tick} u0 vs JAX", tu0.numpy(), np.asarray(u0), 1e-3, 1e-3)
        _close(f"scan-route fleet tick {tick} X vs JAX", tst_new.X.numpy(), np.asarray(st.X),
               1e-3, 1e-3)
        assert taux.status.tolist() == np.asarray(jaux.status).tolist() == [0] * B
        for b in range(B):
            pb = tsqp.OCPParams(**{f.name: getattr(tparams, f.name)[b]
                                   for f in dataclasses.fields(tparams)})
            mu0, mst, _ = ts.solve(pb, tsqp.NMPCState(X=tst.X[b], U=tst.U[b]), xt[b])
            _close(f"scan-route tick {tick} member {b} u0", tu0[b].numpy(), mu0.numpy(),
                   1e-4, 1e-5)
            _close(f"scan-route tick {tick} member {b} X", tst_new.X[b].numpy(), mst.X.numpy(),
                   1e-4, 1e-5)
        x = jax.vmap(js.dyn_step)(x, u0)


# --- the other presets and cost forms ------------------------------------------------


@pytest.mark.parametrize("dynamic_model", [False, True], ids=["kinematic", "dynamic"])
def test_racecar_nmpc_tick_matches_jax(dynamic_model):
    goal = [2.0, 1.0, 0.0, 0.0]
    js, jp = jpresets.racecar_nmpc(jnp.asarray(goal), N=10, dynamic_model=dynamic_model,
                                   **_jax_cfg("xla"))
    ts, tp = presets.racecar_nmpc(goal, N=10, dynamic_model=dynamic_model, device="cpu",
                                  **SERIAL)
    x0 = [0.1, -0.1, 0.2, 0.5]
    _one_tick(js, jp, ts, tp, x0, f"racecar dynamic={dynamic_model}")


def test_four_wheel_nmpc_irk_tick_matches_jax():
    goal = [1.0, 0.5, 0.0, 0.0, 0.0]
    js, jp = jpresets.four_wheel_nmpc(jnp.asarray(goal), N=10, **_jax_cfg("xla"))
    ts, tp = presets.four_wheel_nmpc(goal, N=10, device="cpu", **SERIAL)
    assert ts.cfg.integrator == "irk"
    _one_tick(js, jp, ts, tp, [0.05, -0.05, 0.1, 0.2, 0.1], "four-wheel irk")


@pytest.mark.parametrize("jax_backend,port_backend", [("xla", "torch"), ("pallas", "kernel")])
def test_dnn_nmpc_tick_matches_jax(jax_backend, port_backend, one_torch_thread):
    """``presets.dnn_nmpc`` with an MLP rate residual (the suite's 5→128→128→3
    net with a non-zero head, × 0.05) and one obstacle: one tick against the
    JAX preset, the linearization differentiating through the plain net on
    both sides (JAX jacfwd through Flax, the port jacrev)."""
    from dnn_mppi_mpc_tpu.models.learned import make_residual_fn as j_make_residual_fn
    from dnn_mppi_mpc_tpu_torch.models.learned import make_residual_fn
    from test_torch_learned import flax_mlp

    jm, variables, tm = flax_mlp(128, 1, seed=12)
    jnet, tnet = j_make_residual_fn(jm, variables), make_residual_fn(tm)
    goal, obs = [1.5, 0.8, 0.0], [[0.8, 0.3, 0.2]]
    js, jp = jpresets.dnn_nmpc(jnp.asarray(goal), lambda f: 0.05 * jnet(f), N=10,
                               obstacles=jnp.asarray(obs), **_jax_cfg(jax_backend))
    ts, tp = presets.dnn_nmpc(goal, lambda f: 0.05 * tnet(f), N=10, obstacles=obs,
                              qp_backend=port_backend, device="cpu", **SERIAL)
    kern.reset_counts()
    _one_tick(js, jp, ts, tp, [0.1, -0.1, 0.2], f"dnn_nmpc {port_backend}")
    assert kern.fused_barrier_qp_solve_plain.calls == (2 if port_backend == "kernel" else 0)


def test_dnn_nmpc_loop_matches_the_jax_reference(f32_mode, one_torch_thread):
    """chip_smoke.py's dnn_nmpc loop — ``presets.dnn_nmpc`` to its goal from
    x0 = 0 with the seeded suite net (``chip_smoke.mlp_tree``) as the rate
    residual — on the JAX package (XLA backend, float32) and on the port
    (the QP kernel's plain version), free running: the JAX run is
    chip_smoke's ``DNN_NMPC_JAX_REFERENCE`` (to 1e-3), and the port's final
    state is within 1e-3 of JAX's."""
    import chip_smoke as cs
    from dnn_mppi_mpc_tpu.models.learned import MLP as JMLP
    from dnn_mppi_mpc_tpu.models.learned import make_residual_fn as j_make_residual_fn
    from dnn_mppi_mpc_tpu_torch.models.learned import make_residual_fn

    tree = cs.mlp_tree()
    jnet = j_make_residual_fn(JMLP(out_dim=3, hidden=128, depth=1), tree)
    goal = np.asarray(cs.DNN_NMPC_GOAL, np.float32)
    js, jp = jpresets.dnn_nmpc(jnp.asarray(goal), jnet, **_jax_cfg("xla"))
    ts, tp = presets.dnn_nmpc(list(cs.DNN_NMPC_GOAL), make_residual_fn(cs.residual_mlp("cpu")),
                              qp_backend="kernel", device="cpu")
    x, xt = jnp.zeros(3, jnp.float32), torch.zeros(3)
    st, stt = js.init(x), ts.init(xt)
    xs = [np.asarray(x)]
    for _ in range(cs.DNN_NMPC_TICKS):
        u0, st, aux = js.solve(jp, st, x)
        x = js.dyn_step(x, u0)
        xs.append(np.asarray(x))
        assert int(aux.status) == 0
        u0t, stt, auxt = ts.solve(tp, stt, xt)
        xt = ts.dyn_step(xt, u0t)
        assert int(auxt.status) == 0
    d = np.linalg.norm(np.stack(xs)[:, :2] - goal[:2], axis=1)
    ref = {"goal_dist_tick10_m": float(d[10]), "goal_dist_end_m": float(d[-1]),
           "final_x": np.asarray(x).tolist()}
    print("JAX CPU reference:", ref)
    want = cs.DNN_NMPC_JAX_REFERENCE
    _close("JAX loop vs chip_smoke's reference", [ref["goal_dist_tick10_m"], ref["goal_dist_end_m"]]
           + ref["final_x"], [want["goal_dist_tick10_m"], want["goal_dist_end_m"]]
           + want["final_x"], 0.0, 1e-3)
    _close("port loop final state vs JAX", xt.numpy(), np.asarray(x), 0.0, 1e-3)


def _y(lib):
    def y_fn(x, u):
        # a nonlinear output coupling x and u: S = JuᵀWJx is non-zero
        return lib.stack([x[0], x[1], lib.sin(x[2]), u[0] + 0.2 * x[2], u[1]])
    return y_fn


def _cost_params(N, ny):
    """Weights and references over an ny-wide residual (y_fn: ny = 5, with
    an x-u coupling in W; y_x_fn: ny = 3)."""
    W = np.diag([10.0, 10.0, 0.5, 0.5, 0.05])
    W[2, 3] = W[3, 2] = 0.1
    ref = np.array([2.0, 1.0, 0.0, 0.0, 0.0])
    return dict(Q=W[:ny, :ny], R=np.diag([0.5, 0.05]), Qe=W[:ny, :ny],
                yref=np.concatenate([ref[:3], np.zeros(2)])[None, :].repeat(N, axis=0),
                yref_e=ref[:ny], lbx=np.full(3, -10.0), ubx=np.full(3, 10.0),
                lbu=np.array([-1.0, -1.0]), ubu=np.array([1.0, 1.0]))


@pytest.mark.parametrize("form", ["y_fn", "y_x_fn"])
def test_nonlinear_ls_tick_matches_jax(form):
    """The general NONLINEAR_LS residual (cross term S in the QP) and the
    separable state residual."""
    N = 10
    if form == "y_fn":
        p = _cost_params(N, 5)
        kw_j, kw_t = dict(y_fn=_y(jnp)), dict(y_fn=_y(torch))
    else:
        p = _cost_params(N, 3)

        def y_x_t(x):
            return torch.stack([x[0], x[1], torch.sin(x[2])])

        def y_x_j(x):
            return jnp.stack([x[0], x[1], jnp.sin(x[2])])

        kw_j, kw_t = dict(y_x_fn=y_x_j), dict(y_x_fn=y_x_t)
    jcfg = JSQPConfig(N=N, dim_x=3, dim_u=2, dt=0.1, sqp_iters=1, qp_iters=10,
                      parallel_riccati=False)
    tcfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=0.1, sqp_iters=1, qp_iters=10, **SERIAL)
    js = jsqp.NMPCSolver(jcfg, jdyn.unicycle, **kw_j)
    ts = tsqp.NMPCSolver(tcfg, tdyn.unicycle, device="cpu", **kw_t)
    jp = jsqp.OCPParams(**{k: jnp.asarray(v, jnp.float32) for k, v in p.items()})
    tp = tsqp.ocp_params_from_numpy(**p, device="cpu")
    _one_tick(js, jp, ts, tp, [0.1, 0.2, 0.3], f"NONLINEAR_LS {form}")


def test_soft_h_tick_matches_jax():
    """soft_h: the h rows' barrier takes the L2 slack stiffness and the L1
    slope; the warm start crosses an obstacle, so the slope is active."""
    obs = [[0.6, 0.4, 0.3]]
    js, jp = jpresets.diff_drive_nmpc(jnp.asarray(GOAL), N=10, obstacles=jnp.asarray(obs),
                                      sqp_iters=1, soft_h=True, **_jax_cfg("xla"))
    ts, tp = presets.diff_drive_nmpc(GOAL, N=10, obstacles=obs, sqp_iters=1, soft_h=True,
                                     device="cpu", **SERIAL)
    _one_tick(js, jp, ts, tp, [0.3, 0.2, 0.5], "soft_h", seed=3)


# --- fleets --------------------------------------------------------------------------------


def _fleet_inputs(B, N):
    rng = np.random.default_rng(1)
    goals = np.stack([rng.uniform(-2, 2, B), rng.uniform(-2, 2, B), np.zeros(B)],
                     axis=1).astype(np.float32)
    x0s = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    obs = np.concatenate([0.5 * goals[:, :2], np.full((B, 1), 0.2, np.float32)],
                         axis=1)[:, None, :]
    yref = np.concatenate([goals, np.zeros((B, 2), np.float32)], axis=1)[:, None, :].repeat(
        N, axis=1)
    return goals, x0s, obs, yref


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_batched_solve_equals_per_member(backend):
    """Per-member yref, yref_e and obstacle; shared Q, R, bounds."""
    B, N = 3, 8
    goals, x0s, obs, yref = _fleet_inputs(B, N)
    s, base = presets.diff_drive_nmpc(np.zeros(3), N=N, obstacles=[[1.0, 0.0, 0.3]],
                                      sqp_iters=1, qp_iters=8, qp_backend=backend, device="cpu")
    params = dataclasses.replace(base, yref=torch.tensor(yref), yref_e=torch.tensor(goals),
                                 p=torch.tensor(obs))
    states = s.init(torch.tensor(x0s))
    kern.reset_counts()
    u0s, st, aux = s.batched_solve()(params, states, torch.tensor(x0s))
    if backend == "kernel":
        assert kern.batched_fused_barrier_qp_solve_plain.calls == 1
    assert u0s.shape == (B, 2) and aux.status.shape == (B,) and aux.kkt_residual.shape == (B,)
    for b in range(B):
        pb = dataclasses.replace(base, yref=torch.tensor(yref[b]), yref_e=torch.tensor(goals[b]),
                                 p=torch.tensor(obs[b]))
        u0, stb, auxb = s.solve(pb, s.init(torch.tensor(x0s[b])), torch.tensor(x0s[b]))
        _close(f"{backend} member {b} u0", u0s[b].numpy(), u0.numpy(), 1e-4, 1e-5)
        _close(f"{backend} member {b} X", st.X[b].numpy(), stb.X.numpy(), 1e-4, 1e-5)
        _close(f"{backend} member {b} h_margin", float(aux.h_margin[b]), float(auxb.h_margin),
               1e-4, 1e-5)


def test_batched_solve_matches_jax():
    """B = 4, N = 12 against the JAX vmapped fleet (every leaf batched)."""
    B, N = 4, 12
    goals, x0s, obs, yref = _fleet_inputs(B, N)
    js, jbase = jpresets.diff_drive_nmpc(jnp.zeros(3), N=N, obstacles=jnp.asarray([[1.0, 0.0,
                                                                                    0.3]]),
                                         **_jax_cfg("xla"))
    solver = jsqp.NMPCSolver(js.cfg, jdyn.unicycle, h_fn=jsqp.circle_obstacle_h)

    def member(goal, yr, ob):
        return dataclasses.replace(jbase, yref=yr, yref_e=goal, p=ob)

    jparams = jax.vmap(member)(jnp.asarray(goals), jnp.asarray(yref), jnp.asarray(obs))
    jstates = jax.vmap(lambda x: jsqp.NMPCState.init(js.cfg, x))(jnp.asarray(x0s))
    ju0, jst, jaux = solver.batched_solve()(jparams, jstates, jnp.asarray(x0s))

    ts, _ = presets.diff_drive_nmpc(np.zeros(3), N=N, obstacles=[[1.0, 0.0, 0.3]], device="cpu",
                                    **SERIAL)
    tparams = _port_params(jparams)
    assert tparams.Q.shape == (B, 3, 3)
    tu0, tst, taux = ts.batched_solve()(tparams, ts.init(torch.tensor(x0s)), torch.tensor(x0s))
    _close("fleet u0 vs JAX", tu0.numpy(), np.asarray(ju0), 1e-3, 1e-3)
    _close("fleet X vs JAX", tst.X.numpy(), np.asarray(jst.X), 1e-3, 1e-3)
    _close("fleet U vs JAX", tst.U.numpy(), np.asarray(jst.U), 1e-3, 1e-3)
    assert taux.status.tolist() == np.asarray(jaux.status).tolist()


def test_nmpc_fleet_preset_is_the_suite_row():
    """presets.nmpc_fleet builds the suite's fleet (utils/benchsuite.py:
    322-346) from default_rng(0): goals on the 3 m circle, obstacles at 0.55
    of the way, every leaf per member."""
    solver, params, states, x0s = presets.nmpc_fleet(B=6, N=5, device="cpu")
    rng = np.random.default_rng(0)
    ang = rng.uniform(0, 2 * np.pi, 6)
    goals = np.stack([3 * np.cos(ang), 3 * np.sin(ang), ang], axis=1).astype(np.float32)
    np.testing.assert_array_equal(params.yref_e.numpy(), goals)
    np.testing.assert_array_equal(x0s.numpy(), rng.uniform(-0.3, 0.3, (6, 3)).astype(np.float32))
    np.testing.assert_allclose(params.p[:, 0, :2].numpy(), 0.55 * goals[:, :2], rtol=1e-6)
    assert params.Q.shape == (6, 3, 3) and params.yref.shape == (6, 5, 5)
    assert solver.cfg.sqp_iters == 2 and solver.cfg.qp_backend == "kernel"
    assert states.X.shape == (6, 6, 3)


def test_batched_solve_rejects_a_single_state():
    s, p = presets.diff_drive_nmpc(GOAL, N=5, device="cpu")
    with pytest.raises(ValueError, match="batched_solve"):
        s.batched_solve()(p, s.init(torch.zeros(3)), torch.zeros(3))


def test_differentiable_route_takes_gradients():
    """solve_fn(differentiable=True) is the torch-QP twin: autograd goes
    through the whole tick; the kernel backend's ``solve`` differentiates
    too, through the QP kernel's IFT backward (exact for a converged solve,
    which 4 iterations are not; held against the twin and JAX in
    tests/test_torch_diff_nmpc.py)."""
    s, p = presets.diff_drive_nmpc(GOAL, N=6, sqp_iters=1, qp_iters=4, qp_backend="kernel",
                                   device="cpu")
    goal = torch.tensor(GOAL, requires_grad=True)
    pg = dataclasses.replace(p, yref_e=goal)
    x0 = torch.tensor([0.1, 0.0, 0.0])
    u0, _, _ = s.solve_fn(differentiable=True)(pg, s.init(x0), x0)
    (g,) = torch.autograd.grad(u0.sum(), goal)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    kern.reset_counts()
    u0_k, _, _ = s.solve(pg, s.init(x0), x0)
    assert kern.fused_barrier_qp_solve_plain.calls == 1
    (g_k,) = torch.autograd.grad(u0_k.sum(), goal)
    assert g_k.shape == goal.shape and torch.isfinite(g_k).all()


# --- the oracle copy and the carry-across functions ------------------------------------


def _config9(oracle, N=10, dt=0.01):
    Q = np.diag([7.0, 7.0, 9.0])
    R = np.diag([1.0, 0.1])
    goal = np.array([4.0, 4.0, 0.0])
    yref = np.concatenate([goal, [2.0, 0.5]])[None, :].repeat(N, axis=0)
    lbx = np.array([-10.0, -10.0, -3.14])
    lbu = np.array([-30.0, -31.4])
    obs = np.array([[2.0, 1.0, 0.7], [3.0, 2.5, 0.5], [2.0, 3.0, 0.6]])
    return oracle.OracleOCP(N=N, dt=dt, f=oracle.unicycle_np, Q=Q, R=R, Qe=Q, yref=yref,
                            yref_e=goal, lbx=lbx, ubx=-lbx, lbu=lbu, ubu=-lbu,
                            h_fn=oracle.circle_obstacle_h_np, p=obs)


def test_vendored_oracle_equals_the_jax_packages():
    rec_t = t_oracle.closed_loop(_config9(t_oracle), np.zeros(3), ticks=10)
    rec_j = j_oracle.closed_loop(_config9(j_oracle), np.zeros(3), ticks=10)
    for key in ("x", "u0", "warm_X", "warm_U", "X", "U", "qp_viol"):
        np.testing.assert_array_equal(rec_t[key], rec_j[key], err_msg=key)


def test_params_and_state_round_trip_jax_leaves():
    js, jp = jpresets.diff_drive_nmpc(jnp.asarray(GOAL), N=6, obstacles=jnp.asarray(OBSTACLES))
    tp = _port_params(jp)
    for f in dataclasses.fields(jp):
        np.testing.assert_array_equal(getattr(tp, f.name).numpy(),
                                      np.asarray(getattr(jp, f.name), np.float32))
    jst = js.init(jnp.asarray([0.1, 0.2, 0.3], jnp.float32))
    tst = tsqp.state_from_numpy(np.asarray(jst.X), np.asarray(jst.U), device="cpu")
    np.testing.assert_array_equal(tst.X.numpy(), np.asarray(jst.X))
    np.testing.assert_array_equal(tst.U.numpy(), np.asarray(jst.U))
    init = tsqp.NMPCState.init(SQPConfig(N=6, dim_x=3, dim_u=2, dt=0.1), [0.1, 0.2, 0.3],
                               device="cpu")
    np.testing.assert_array_equal(init.X.numpy(), np.asarray(jst.X))
    f64 = tsqp.ocp_params_from_numpy(**{f.name: np.asarray(getattr(jp, f.name))
                                        for f in dataclasses.fields(jp)},
                                     dtype=torch.float64, device="cpu")
    for f in dataclasses.fields(jp):
        np.testing.assert_array_equal(getattr(f64, f.name).numpy(), np.asarray(getattr(jp, f.name)))
