"""f64 acados-semantics SQP-RTI oracle (test-only, pure numpy).

A copy of ``dnn_mppi_mpc_tpu/testing/oracle_nmpc.py``, kept here so that the
port can lockstep its NMPC engine against it on a machine without JAX
(``chip_smoke.py``); ``tests/test_torch_nmpc.py`` holds the two copies equal.

An independent re-derivation of the NMPC tick the reference runs through
acados (controllers/mpc_differential_drive_obstacle_static.py:236-331):

* ERK integration, 4 stages x 3 substeps per shooting interval
  (sim_method_num_stages=4, sim_method_num_steps=3, :241-242), or IRK
  (Gauss-Legendre collocation via complex-safe Picard iteration — the
  integrator of mpc_differential_dynamics.py:198);
* optional acados explicit slack variables on the h-rows (dims.ns/nsh with
  Zl/zl cost, test_diff_mpc_dyna_slack.py:158-182) solved exactly in a
  slack-augmented QP — the ruler for the engine's relaxed-barrier soft_h;
* exact discrete-step sensitivities A = dF/dx, B = dF/du via complex-step
  differentiation (machine-precision, the role of acados' generated ERK
  sensitivity C code);
* LINEAR_LS Gauss-Newton blocks W = blkdiag(Q, R), terminal Qe (:169-183);
* box bounds on x (stages 1..N, stage 0 pinned by lbx_0 = ubx_0 = x0,
  :197-209) and on u (:207-209);
* obstacle h-constraints h(x) >= 0 linearized per stage; acados applies
  con_h_expr at stages 0..N-1 (the reference never sets con_h_expr_e,
  :211-234) — ``h_terminal`` extends them to stage N to mirror the JAX
  engine's safer default;
* the QP solved EXACTLY: full condensing onto the control increments
  (the FULL_CONDENSING_HPIPM shape, :237) followed by a dense
  Mehrotra predictor-corrector interior point to mu < 1e-12;
* SQP_RTI: one linearization + one QP + the FULL Newton step per tick,
  warm-started from the previous trajectory, no shifting (:313-317 warm
  start; the reference reuses simX/simU unshifted) — ``sqp_iters > 1``
  gives converged SQP.

Everything is float64 and scalar-shaped numpy: no JAX, no shared code with
the engine under test. ``chip_smoke.py`` locksteps the port's
:class:`~..solvers.sqp.NMPCSolver` against this oracle per tick (same warm
start, same state) and gates |du0|, |dX|, |dU|.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

Array = np.ndarray


# ---------------------------------------------------------------------------
# Complex-safe dynamics twins (numpy; work elementwise on complex inputs so
# complex-step differentiation is exact to machine precision).
# ---------------------------------------------------------------------------


def unicycle_np(x: Array, u: Array) -> Array:
    """xdot of the diff-drive model (mpc_differential_drive_obstacle_static.py:38-42)."""
    return np.stack([u[0] * np.cos(x[2]), u[0] * np.sin(x[2]), u[1]])


def kinematic_bicycle_np(wheel_base: float) -> Callable[[Array, Array], Array]:
    """xdot of the kinematic bicycle (mpc_racecar.py:15-63; state (x,y,yaw,v),
    control (steer, accel))."""

    def f(x: Array, u: Array) -> Array:
        return np.stack(
            [
                x[3] * np.cos(x[2]),
                x[3] * np.sin(x[2]),
                x[3] * np.tan(u[0]) / wheel_base,
                u[1] + 0.0 * x[0],
            ]
        )

    return f


def rk4_np(f, x: Array, u: Array, h: float) -> Array:
    k1 = f(x, u)
    k2 = f(x + 0.5 * h * k1, u)
    k3 = f(x + 0.5 * h * k2, u)
    k4 = f(x + h * k3, u)
    return x + h / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def erk43_np(f, x: Array, u: Array, dt: float, num_steps: int = 3) -> Array:
    """acados ERK: RK4 x num_steps substeps over one shooting interval."""
    h = dt / num_steps
    for _ in range(num_steps):
        x = rk4_np(f, x, u, h)
    return x


def four_wheel_np(x: Array, u: Array) -> Array:
    """xdot of the four-wheel torque model (mpc_differential_dynamics.py:98-105,
    params :72-77: m=2.0, I=2.0296, r=0.17775, L=0.5708); complex-safe twin of
    models.dynamics.four_wheel_torque."""
    m, inertia, r, L = 2.0, 2.0296, 0.17775, 0.5708
    theta, v, omega = x[2], x[3], x[4]
    dv = (r / (4.0 * m)) * (u[0] + u[1] + u[2] + u[3])
    domega = (r / (L * inertia)) * ((u[0] + u[2]) - (u[1] + u[3])) / 2.0
    return np.stack([v * np.cos(theta), v * np.sin(theta), omega, dv, domega])


def _gl_tableau_np(num_stages: int):
    """Gauss-Legendre collocation tableau via order conditions.

    Independent derivation from models/integrators.py's Lagrange-integration
    route: solve the Vandermonde systems  Σ_j a_ij c_j^{k-1} = c_i^k / k and
    Σ_j b_j c_j^{k-1} = 1/k  (k = 1..s), which uniquely determine the
    collocation weights on the Gauss nodes.
    """
    nodes, _ = np.polynomial.legendre.leggauss(num_stages)
    c = 0.5 * (nodes + 1.0)
    s = num_stages
    V = np.vander(c, s, increasing=True).T  # V[k-1, j] = c_j^(k-1)
    b = np.linalg.solve(V, np.array([1.0 / k for k in range(1, s + 1)]))
    A = np.empty((s, s))
    for i in range(s):
        A[i] = np.linalg.solve(
            V, np.array([c[i] ** k / k for k in range(1, s + 1)])
        )
    return c, A, b


def irk_np(
    f,
    x: Array,
    u: Array,
    dt: float,
    num_stages: int = 4,
    num_steps: int = 3,
    picard_iters: int = 60,
) -> Array:
    """Gauss-Legendre IRK step by Picard (fixed-point) iteration.

    f64 twin of acados' IRK as configured by the four-wheel dynamic NMPC
    (mpc_differential_dynamics.py:198: sim_method_num_stages=4,
    sim_method_num_steps=3). Deliberately NOT Newton (the engine's
    models/integrators.irk_step solves the stage equations with Newton):
    the fixed-point map K_i ← f(x + hΣ_j a_ij K_j, u) is a composition of
    analytic operations, so it is complex-safe — ``step_with_jacobians``'s
    complex-step differentiation goes straight through it, which a Newton
    inner loop (needing its own real Jacobian) would break. Contraction
    factor ≈ h·L·‖A‖; with h = dt/num_steps small and the reference's
    non-stiff-at-h torque model, 60 iterations converge far below f64
    rounding (asserted in tests/test_oracle_nmpc.py).
    """
    _, A, b = _gl_tableau_np(num_stages)
    h = dt / num_steps
    for _ in range(num_steps):
        K = np.broadcast_to(f(x, u), (num_stages, x.shape[0])).copy()
        for _ in range(picard_iters):
            X_st = x[None, :] + h * (A @ K)
            K = np.stack([f(X_st[i], u) for i in range(num_stages)])
        x = x + h * (b @ K)
    return x


def step_with_jacobians(
    f,
    x: Array,
    u: Array,
    dt: float,
    num_steps: int = 3,
    integrator: str = "erk",
    num_stages: int = 4,
) -> Tuple[Array, Array, Array]:
    """(F, A, B) of the discrete step via complex-step differentiation.

    d/dz g(x + ih e_z) / h is exact to f64 rounding for holomorphic g — the
    trig/polynomial dynamics here qualify. This replaces acados' generated
    forward-sensitivity ERK/IRK without sharing any code with jax.jacfwd.
    ``integrator='irk'`` differentiates through the converged Picard fixed
    point of :func:`irk_np` — the exact sensitivity of the implicit step,
    the ruler for the engine's jacfwd-through-Newton (tests/test_oracle_nmpc.py).
    """
    if integrator == "irk":
        stepper = lambda ff, xx, uu: irk_np(ff, xx, uu, dt, num_stages, num_steps)
    else:
        stepper = lambda ff, xx, uu: erk43_np(ff, xx, uu, dt, num_steps)
    nx, nu = x.shape[0], u.shape[0]
    h = 1.0e-100
    F = stepper(f, x.astype(np.float64), u.astype(np.float64))
    A = np.empty((nx, nx))
    B = np.empty((nx, nu))
    for j in range(nx):
        xc = x.astype(np.complex128)
        xc[j] += 1j * h
        A[:, j] = stepper(f, xc, u.astype(np.complex128)).imag / h
    for j in range(nu):
        uc = u.astype(np.complex128)
        uc[j] += 1j * h
        B[:, j] = stepper(f, x.astype(np.complex128), uc).imag / h
    return F, A, B


def h_with_jacobian(h_fn, x: Array, p: Array) -> Tuple[Array, Array]:
    """(h(x), dh/dx) via complex step."""
    nx = x.shape[0]
    hval = np.asarray(h_fn(x.astype(np.float64), p), dtype=np.float64)
    J = np.empty((hval.shape[0], nx))
    step = 1.0e-100
    for j in range(nx):
        xc = x.astype(np.complex128)
        xc[j] += 1j * step
        J[:, j] = np.asarray(h_fn(xc, p)).imag / step
    return hval, J


def circle_obstacle_h_np(x: Array, p: Array) -> Array:
    """Complex-safe twin of solvers.sqp.circle_obstacle_h / the acados rows
    (x-ox)^2 + (y-oy)^2 - (r+safe)^2 >= 0 (…static.py:219-234)."""
    d2 = (x[0] - p[:, 0]) ** 2 + (x[1] - p[:, 1]) ** 2
    return d2 - p[:, 2] ** 2


# ---------------------------------------------------------------------------
# Exact dense QP: Mehrotra predictor-corrector interior point.
# ---------------------------------------------------------------------------


def solve_dense_qp(
    H: Array, g: Array, G: Array, w: Array, tol: float = 1.0e-12, max_iters: int = 60
) -> Tuple[Array, Array]:
    """min 1/2 z'Hz + g'z  s.t.  Gz <= w   (H symmetric PD).

    Standard Mehrotra PD-IP (the HPIPM algorithm family) in f64; returns
    (z*, multipliers). Accuracy ~1e-12 — effectively the exact QP solution,
    the ruler the relaxed-barrier engine is measured against.
    """
    n = H.shape[0]
    m = G.shape[0]
    if m == 0:
        return np.linalg.solve(H, -g), np.zeros(0)
    z = np.zeros(n)
    s = np.maximum(w - G @ z, 1.0)
    lam = np.ones(m)
    e = np.ones(m)
    for _ in range(max_iters):
        rd = H @ z + g + G.T @ lam
        rp = G @ z + s - w
        mu = float(s @ lam) / m
        if max(np.abs(rd).max(), np.abs(rp).max(), mu) < tol:
            break
        if mu < 1e-2 * tol:
            # Degenerate active sets (e.g. the closed loop riding exactly on
            # an obstacle boundary, w-row == 0) stall the dual residual while
            # mu underflows toward 1e-300 and s/lam divisions go non-finite.
            # The primal has converged; stop and let the active-set polish
            # below recover the exact solution.
            break
        sinv_lam = lam / s
        # LU, not Cholesky: near convergence lam/s spans ~1e12 of dynamic
        # range and the normal matrix is only PD up to rounding.
        M = H + G.T @ (sinv_lam[:, None] * G)

        def kkt_solve(r_d, r_p, r_c):
            # eliminate ds = -r_p - G dz ; dlam = (r_c - lam*ds)/s
            rhs = -r_d - G.T @ ((r_c + lam * r_p) / s)
            dz = np.linalg.solve(M, rhs)
            ds = -r_p - G @ dz
            dlam = (r_c - lam * ds) / s
            return dz, ds, dlam

        # predictor (affine)
        r_c_aff = -s * lam
        dz_a, ds_a, dl_a = kkt_solve(rd, rp, r_c_aff)

        def max_step(v, dv):
            neg = dv < 0
            return 1.0 if not neg.any() else min(1.0, float(np.min(-v[neg] / dv[neg])))

        a_p = max_step(s, ds_a)
        a_d = max_step(lam, dl_a)
        mu_aff = float((s + a_p * ds_a) @ (lam + a_d * dl_a)) / m
        sigma = (mu_aff / mu) ** 3

        # corrector + centering
        r_c = -s * lam + sigma * mu * e - ds_a * dl_a
        dz, ds, dlam = kkt_solve(rd, rp, r_c)
        a_p = 0.99995 * max_step(s, ds)
        a_d = 0.99995 * max_step(lam, dlam)
        alpha = min(a_p, a_d)
        if not (np.isfinite(dz).all() and np.isfinite(ds).all() and np.isfinite(dlam).all()):
            break
        z += alpha * dz
        s += alpha * ds
        lam += alpha * dlam

    # Active-set polish: re-solve the equality-constrained QP on the active
    # rows the IP identified (lstsq tolerates degenerate/duplicated rows).
    # This removes the IP's O(mu) complementarity smear and recovers the
    # exact primal even when the active set is degenerate.
    scale = max(1.0, float(np.abs(w).max()))
    act = s < 1.0e-7 * scale
    if act.any():
        Aact = G[act]
        k = Aact.shape[0]
        KKT = np.block([[H, Aact.T], [Aact, np.zeros((k, k))]])
        rhs = np.concatenate([-g, w[act]])
        sol, *_ = np.linalg.lstsq(KKT, rhs, rcond=None)
        z_p, lam_p = sol[:n], sol[n:]
        feas = (G @ z_p <= w + 1.0e-8 * scale).all()
        if feas and (lam_p >= -1.0e-7).all():
            z = z_p
            lam = np.zeros(m)
            lam[act] = np.maximum(lam_p, 0.0)
    return z, lam


# ---------------------------------------------------------------------------
# The OCP spec + one RTI tick.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OracleOCP:
    """f64 twin of (SQPConfig, OCPParams): one LINEAR_LS multiple-shooting OCP."""

    N: int
    dt: float
    f: Callable[[Array, Array], Array]  # continuous dynamics xdot = f(x, u)
    Q: Array
    R: Array
    Qe: Array
    yref: Array  # (N, nx + nu)
    yref_e: Array  # (nx,)
    lbx: Array
    ubx: Array
    lbu: Array
    ubu: Array
    num_rk4_steps: int = 3
    h_fn: Optional[Callable[[Array, Array], Array]] = None
    p: Optional[Array] = None  # h-constraint parameters, e.g. (n_obs, 3)
    h_terminal: bool = False  # acados default: con_h_expr at 0..N-1 only
    integrator: str = "erk"  # 'erk' | 'irk' (mpc_differential_dynamics.py:198)
    num_stages: int = 4  # IRK collocation stages (sim_method_num_stages=4)
    # acados explicit slack variables on the h-rows (dims.ns/nsh with
    # cost.Zl/zl, test_diff_mpc_dyna_slack.py:158-182): each softened row
    # becomes  h + s >= 0, s >= 0  with cost  zl·s + ½·Zl·s²  — solved
    # EXACTLY in the slack-augmented QP, the ruler for the engine's
    # relaxed-barrier soft_h approximation (SQPConfig.slack_weight_l2/_l1).
    soft_h: bool = False
    Zl: float = 1.0e4
    zl: float = 0.0

    @property
    def nx(self) -> int:
        return self.Q.shape[0]

    @property
    def nu(self) -> int:
        return self.R.shape[0]

    def step(self, x: Array, u: Array) -> Array:
        if self.integrator == "irk":
            return irk_np(
                self.f, x, u, self.dt, self.num_stages, self.num_rk4_steps
            )
        return erk43_np(self.f, x, u, self.dt, self.num_rk4_steps)


def rti_tick(
    ocp: OracleOCP, X: Array, U: Array, x0: Array, sqp_iters: int = 1
) -> Tuple[Array, Array, Array, float]:
    """One NMPC tick: sqp_iters x (linearize -> exact condensed QP -> full step).

    Mirrors solve_mpc (…static.py:280-331): pin x0, warm start from (X, U),
    solve, return (u0, X, U, qp_viol) — qp_viol is the max primal
    infeasibility of the tick's QPs (0 when every subproblem was feasible).
    """
    nx, nu, N = ocp.nx, ocp.nu, ocp.N
    X = X.astype(np.float64).copy()
    U = U.astype(np.float64).copy()
    x0 = x0.astype(np.float64)
    qp_viol = 0.0  # max primal infeasibility of the QPs this tick: > 0 means
    # the linearized subproblem had NO feasible point (e.g. a moving obstacle
    # swept over the warm-start trajectory, mpc_…_dynamic.py:467-471) — the
    # exact-QP answer is then meaningless and parity ticks must be skipped
    # (acados returns status != 0 there; the reference ignores it, :322-323).

    for _ in range(sqp_iters):
        A = np.empty((N, nx, nx))
        B = np.empty((N, nx, nu))
        c = np.empty((N, nx))
        for i in range(N):
            F, Ai, Bi = step_with_jacobians(
                ocp.f, X[i], U[i], ocp.dt, ocp.num_rk4_steps,
                integrator=ocp.integrator, num_stages=ocp.num_stages,
            )
            A[i], B[i] = Ai, Bi
            c[i] = F - X[i + 1]

        # Gauss-Newton gradients at the linearization point
        qs = (X[:-1] - ocp.yref[:, :nx]) @ ocp.Q.T  # (N, nx)
        qe = ocp.Qe @ (X[N] - ocp.yref_e)
        rs = (U - ocp.yref[:, nx:]) @ ocp.R.T  # (N, nu)

        # Full condensing: delta_x_i = e_i + Gam_i @ dU  (dU flat (N*nu,))
        dx0 = x0 - X[0]
        ev = np.zeros((N + 1, nx))
        Gam = np.zeros((N + 1, nx, N * nu))
        ev[0] = dx0
        for i in range(N):
            ev[i + 1] = A[i] @ ev[i] + c[i]
            Gam[i + 1] = A[i] @ Gam[i]
            Gam[i + 1][:, i * nu : (i + 1) * nu] += B[i]

        nz = N * nu
        H = np.zeros((nz, nz))
        g = np.zeros(nz)
        for i in range(1, N):  # stage-0 state cost is constant in dU
            H += Gam[i].T @ ocp.Q @ Gam[i]
            g += Gam[i].T @ (ocp.Q @ ev[i] + qs[i])
        H += Gam[N].T @ ocp.Qe @ Gam[N]
        g += Gam[N].T @ (ocp.Qe @ ev[N] + qe)
        for i in range(N):
            sl = slice(i * nu, (i + 1) * nu)
            H[sl, sl] += ocp.R
            g[sl] += rs[i]
        H = 0.5 * (H + H.T)

        # Inequalities G z <= w
        rows_G, rows_w = [], []
        I_nz = np.eye(nz)
        for i in range(N):  # control box
            sl = slice(i * nu, (i + 1) * nu)
            rows_G.append(I_nz[sl])
            rows_w.append(ocp.ubu - U[i])
            rows_G.append(-I_nz[sl])
            rows_w.append(U[i] - ocp.lbu)
        for i in range(1, N + 1):  # state box, stages 1..N
            rows_G.append(Gam[i])
            rows_w.append(ocp.ubx - X[i] - ev[i])
            rows_G.append(-Gam[i])
            rows_w.append(X[i] - ocp.lbx + ev[i])
        n_soft = 0
        if ocp.h_fn is not None and ocp.p is not None:
            last = N if ocp.h_terminal else N - 1
            for i in range(1, last + 1):  # stage 0 is a constant in dU
                h0, Jh = h_with_jacobian(ocp.h_fn, X[i], ocp.p)
                rows_G.append(-Jh @ Gam[i])
                rows_w.append(h0 + Jh @ ev[i])
                if ocp.soft_h:
                    n_soft += h0.shape[0]
        G = np.concatenate(rows_G, axis=0)
        w = np.concatenate([np.atleast_1d(r) for r in rows_w], axis=0)

        if n_soft:
            # Slack-augmented QP over z = [dU; s]: the h-rows (appended
            # last) become  Gh·dU − s ≤ wh  with  s ≥ 0  and slack cost
            # zl·Σs + ½·Zl·‖s‖² — the exact acados ns/nsh semantics.
            m = G.shape[0]
            H = np.block([
                [H, np.zeros((nz, n_soft))],
                [np.zeros((n_soft, nz)), ocp.Zl * np.eye(n_soft)],
            ])
            g = np.concatenate([g, ocp.zl * np.ones(n_soft)])
            G_aug = np.zeros((m + n_soft, nz + n_soft))
            G_aug[:m, :nz] = G
            G_aug[m - n_soft : m, nz:] = -np.eye(n_soft)  # h rows get −s
            G_aug[m:, nz:] = -np.eye(n_soft)  # s ≥ 0
            G = G_aug
            w = np.concatenate([w, np.zeros(n_soft)])

        z_flat, _ = solve_dense_qp(H, g, G, w)
        qp_viol = max(qp_viol, float((G @ z_flat - w).max(initial=0.0)))
        dU_flat = z_flat[:nz]
        dU = dU_flat.reshape(N, nu)
        dX = ev + np.einsum("ixz,z->ix", Gam, dU_flat)

        X = X + dX  # full RTI step
        U = U + dU
    return U[0].copy(), X, U, qp_viol


def closed_loop(
    ocp: OracleOCP,
    x0: Array,
    ticks: int,
    sqp_iters: int = 1,
    plant_step: Optional[Callable[[Array, Array], Array]] = None,
    p_schedule: Optional[Callable[[int], Array]] = None,
):
    """Run the oracle closed loop (plant defaults to the model's ERK step —
    the AcadosSimSolver role, …static.py:259-278).

    Returns a dict of per-tick records incl. the warm starts fed into each
    tick, so a second solver can be locked-step against the SAME inputs.

    ``p_schedule(t)`` updates obstacle parameters per tick — the moving
    obstacles of mpc_differential_drive_obstacle_dynamic.py:467-471.
    """
    plant = plant_step or ocp.step
    x = x0.astype(np.float64).copy()
    X = np.broadcast_to(x, (ocp.N + 1, ocp.nx)).copy()
    U = np.zeros((ocp.N, ocp.nu))
    rec = {
        "x": [], "u0": [], "warm_X": [], "warm_U": [], "X": [], "U": [],
        "p": [], "qp_viol": [],
    }
    for t in range(ticks):
        if p_schedule is not None:
            ocp.p = p_schedule(t)
        rec["x"].append(x.copy())
        rec["warm_X"].append(X.copy())
        rec["warm_U"].append(U.copy())
        rec["p"].append(None if ocp.p is None else np.array(ocp.p, copy=True))
        u0, X, U, viol = rti_tick(ocp, X, U, x, sqp_iters=sqp_iters)
        rec["qp_viol"].append(viol)
        rec["u0"].append(u0.copy())
        rec["X"].append(X.copy())
        rec["U"].append(U.copy())
        x = plant(x, u0)
    return {k: np.asarray(v) if k != "p" else v for k, v in rec.items()}


__all__ = [
    "OracleOCP",
    "rti_tick",
    "closed_loop",
    "solve_dense_qp",
    "unicycle_np",
    "kinematic_bicycle_np",
    "four_wheel_np",
    "circle_obstacle_h_np",
    "erk43_np",
    "irk_np",
    "step_with_jacobians",
]
