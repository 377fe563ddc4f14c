"""The port's differentiable NMPC against the JAX package, on the CPU.

* ``condensed_barrier_objective``, ``barrier_hessian_blocks`` and
  ``ift_qp_vjp`` against JAX's (``solvers/qp.py:472-655``) in float64, with
  and without h rows, S and ``h_slope`` (rtol 1e-6, atol 1e-9: the same
  operations; the IFT's μ_f is the kernel's float32 schedule, 6e-8 off
  JAX's float64 μ₀·κ¹¹); the batched forms against per-member calls, a
  shared leaf's cotangent the members' sum (rtol 1e-10);
* the QP wrappers' gradient (their plain versions on the CPU, the IFT
  backward) against ``jax.grad`` through JAX ``make_vmappable_pallas_qp(
  interpret=True, backward="ift")`` on the active-obstacle case of
  tests/test_diff_nmpc.py:187-234, as that test runs it: float64 leaves, a
  float32 forward, the backward in float64 (rtol 1e-4, atol 1e-6: the two
  float32 forwards differ by ~5e-6, the gradients by 3.5e-6). A float32
  backward is no reference there: with an h margin at δ the barrier's
  stiffness 1e6 enters the adjoint solve, and the float32 IFT of either
  framework is ~1e-3 off the float64 one;
  the port's IFT against its recompute rule, both wrappers, a shared leaf
  in the fleet, and at δ = 1e-2 (rtol 2e-4, atol 1e-5, the JAX test's), on
  converged solves (the IFT is exact for those only);
* the NMPC tick on ``qp_backend="kernel"``: closed-loop gradients against
  central finite differences (rtol 5e-2, atol 5e-3, tests/test_diff_nmpc.py)
  and against JAX's xla-backend ``jax.grad``, one controller and a B = 3
  fleet (rtol 2e-3, atol 1e-4, tests/test_diff_nmpc.py:107-158);
  ``make_sharded_nmpc_fleet`` at world size 1 equal to ``batched_solve``;
* the autotune smoke (``examples/nmpc_autotune.py``'s loop at
  tests/test_diff_nmpc.py:161-184's scale): 12 ``torch.optim.Adam`` steps on
  the kernel backend cut the loss below 0.6 of the first, and the torch
  twin's first five losses follow JAX's optax loop (rtol 1e-4).

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

from dnn_mppi_mpc_tpu.config import SQPConfig as JSQPConfig
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.ops.pallas.riccati_qp import make_vmappable_pallas_qp
from dnn_mppi_mpc_tpu.solvers import qp as jqp
from dnn_mppi_mpc_tpu.solvers import sqp as jsqp
from dnn_mppi_mpc_tpu_torch import parallel
from dnn_mppi_mpc_tpu_torch.config import SQPConfig
from dnn_mppi_mpc_tpu_torch.models.dynamics import unicycle
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern
from dnn_mppi_mpc_tpu_torch.solvers import qp as tqp
from dnn_mppi_mpc_tpu_torch.solvers.sqp import NMPCSolver, NMPCState, OCPParams

FIELDS = tqp.BoxedQPData._fields
GOAL = [1.5, 1.0, 0.5]
THETA = np.log([10.0, 10.0, 0.1, 0.5, 0.05]).astype(np.float32)
X0 = [0.2, -0.1, 0.0]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread spares every op the thread pool's
    wake-up cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(name, got, want, rtol, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    print(f"{name}: max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


# --- the three IFT functions ----------------------------------------------------


def _qp_np(rng, N=8, nx=3, nu=2, n_h=0, with_S=False, tight_h=False):
    """A stage-structured QP (tests/test_riccati_qp.py:22-52's shapes) as
    float64 numpy leaves; ``tight_h`` draws h margins around zero, so both
    barrier branches and the L1 slope are reached."""
    def spd(n):
        M = rng.normal(size=(n, n)) * 0.3
        return M @ M.T + np.eye(n)

    leaves = dict(
        A=np.eye(nx) + 0.05 * rng.normal(size=(N, nx, nx)),
        B=0.2 * rng.normal(size=(N, nx, nu)),
        c=0.05 * rng.normal(size=(N, nx)),
        Q=np.stack([spd(nx) for _ in range(N + 1)]),
        qx_base=0.5 * rng.normal(size=(N + 1, nx)),
        R=np.stack([spd(nu) for _ in range(N)]),
        ru_base=0.5 * rng.normal(size=(N, nu)),
        lbx=1.5 + 0.2 * rng.random((N + 1, nx)),
        ubx=1.5 + 0.2 * rng.random((N + 1, nx)),
        lbu=0.3 + 0.2 * rng.random((N, nu)),
        ubu=0.3 + 0.2 * rng.random((N, nu)),
        Jh=rng.normal(size=(N + 1, n_h, nx)) if n_h else None,
        h0=((0.05 * rng.normal(size=(N + 1, n_h))) if tight_h else
            (1.0 + rng.random((N + 1, n_h)))) if n_h else None,
        S=0.1 * rng.normal(size=(N, nu, nx)) if with_S else None,
    )
    return [leaves[n] for n in FIELDS], 0.2 * rng.normal(size=(nx,))


def _j(leaves):
    return jqp.BoxedQPData(*(None if a is None else jnp.asarray(a) for a in leaves))


def _t(leaves, dtype=torch.float64):
    return tqp.BoxedQPData(*(None if a is None else torch.tensor(a, dtype=dtype)
                             for a in leaves))


# (n_h, S, h_slope, h_stiffness, tight h margins)
IFT_CASES = [(0, False, 0.0, None, False), (2, False, 0.0, None, True),
             (2, True, 0.0, None, False), (2, True, 50.0, 1.0e4, True)]
IFT_IDS = ["plain", "h_rows", "h_rows_S", "soft_h_slope"]


@pytest.mark.parametrize("n_h,with_S,h_slope,h_stiff,tight", IFT_CASES, ids=IFT_IDS)
def test_condensed_objective_and_hessian_blocks_match_jax(n_h, with_S, h_slope, h_stiff,
                                                          tight):
    rng = np.random.default_rng(20 + n_h)
    leaves, dx0 = _qp_np(rng, n_h=n_h, with_S=with_S, tight_h=tight)
    N, nx, nu = 8, 3, 2
    dU = 0.4 * rng.normal(size=(N, nu))  # some u margins past δ: the quadratic branch
    dX = 0.3 * rng.normal(size=(N + 1, nx))
    mu, kw = 3.0e-3, dict(delta=1.0e-3, h_stiffness=h_stiff)
    want = jqp.condensed_barrier_objective(jnp.asarray(dU), _j(leaves), jnp.asarray(dx0), mu,
                                           h_slope=h_slope, **kw)
    got = tqp.condensed_barrier_objective(torch.tensor(dU), _t(leaves), torch.tensor(dx0), mu,
                                          h_slope=h_slope, **kw)
    _close("condensed_barrier_objective", got.numpy(), np.asarray(want), 1e-6, 1e-9)
    jQ, jR = jqp.barrier_hessian_blocks(_j(leaves), jnp.asarray(dX), jnp.asarray(dU), mu, **kw)
    tQ, tR = tqp.barrier_hessian_blocks(_t(leaves), torch.tensor(dX), torch.tensor(dU), mu, **kw)
    _close("barrier_hessian_blocks Q~", tQ.numpy(), np.asarray(jQ), 1e-6, 1e-9)
    _close("barrier_hessian_blocks R~", tR.numpy(), np.asarray(jR), 1e-6, 1e-9)


def _solved(leaves, dx0, kw):
    """(δX, δU) of the port's barrier solve, float64 numpy."""
    dX, dU = tqp.barrier_qp_solve(_t(leaves), torch.tensor(dx0), **kw)
    return dX.numpy(), dU.numpy()


@pytest.mark.parametrize("n_h,with_S,h_slope,h_stiff,tight", IFT_CASES, ids=IFT_IDS)
def test_ift_qp_vjp_matches_jax(n_h, with_S, h_slope, h_stiff, tight):
    rng = np.random.default_rng(30 + n_h)
    leaves, dx0 = _qp_np(rng, n_h=n_h, with_S=with_S, tight_h=tight)
    kw = dict(num_iters=12, mu0=0.1, kappa=0.35, delta=1.0e-3, h_stiffness=h_stiff,
              h_slope=h_slope)
    dX, dU = _solved(leaves, dx0, kw)
    ct_X, ct_U = rng.normal(size=dX.shape), rng.normal(size=dU.shape)
    j_qp, j_x0 = jqp.ift_qp_vjp(_j(leaves), jnp.asarray(dx0), *map(jnp.asarray,
                                (dX, dU, ct_X, ct_U)), **kw)
    t_qp, t_x0 = tqp.ift_qp_vjp(_t(leaves), torch.tensor(dx0), *map(torch.tensor,
                                (dX, dU, ct_X, ct_U)), **kw)
    for name in FIELDS:
        jg, tg = getattr(j_qp, name), getattr(t_qp, name)
        assert (jg is None) == (tg is None), name
        if tg is not None:
            _close(f"ift_qp_vjp {name}", tg.numpy(), np.asarray(jg), 1e-6, 1e-9)
    _close("ift_qp_vjp dx0", t_x0.numpy(), np.asarray(j_x0), 1e-6, 1e-9)


def test_batched_ift_functions_equal_per_member_calls():
    """B = 3 members with Q and h0 shared: J, (Q̃, R̃) and every cotangent
    equal the per-member calls; the shared leaves' cotangents are the sums."""
    rng = np.random.default_rng(40)
    B, kw = 3, dict(num_iters=12, mu0=0.1, kappa=0.35, delta=1.0e-3, h_slope=20.0)
    members = [_qp_np(rng, n_h=2, with_S=True, tight_h=True) for _ in range(B)]
    shared = {"Q", "h0"}
    stacked = [None if members[0][0][k] is None else
               members[0][0][k] if FIELDS[k] in shared else
               np.stack([m[0][k] for m in members]) for k in range(len(FIELDS))]
    for m in members:  # every member sees the shared leaves
        for k, n in enumerate(FIELDS):
            if n in shared:
                m[0][k] = stacked[k]
    dx0 = np.stack([m[1] for m in members])
    sols = [_solved(m[0], m[1], kw) for m in members]
    dX, dU = np.stack([s[0] for s in sols]), np.stack([s[1] for s in sols])
    ct_X, ct_U = rng.normal(size=dX.shape), rng.normal(size=dU.shape)
    mu = 3.0e-3
    J = tqp.condensed_barrier_objective(torch.tensor(dU), _t(stacked), torch.tensor(dx0), mu,
                                        h_slope=20.0)
    Qb, Rb = tqp.barrier_hessian_blocks(_t(stacked), torch.tensor(dX), torch.tensor(dU), mu)
    bar_qp, bar_x0 = tqp.ift_qp_vjp(_t(stacked), torch.tensor(dx0), *map(torch.tensor,
                                    (dX, dU, ct_X, ct_U)), **kw)
    sums = {n: 0.0 for n in shared}
    for b, (leaves, x0) in enumerate(members):
        Jb = tqp.condensed_barrier_objective(torch.tensor(dU[b]), _t(leaves), torch.tensor(x0),
                                             mu, h_slope=20.0)
        _close(f"member {b} J", J[b].numpy(), Jb.numpy(), 1e-10, 1e-12)
        Qm, Rm = tqp.barrier_hessian_blocks(_t(leaves), torch.tensor(dX[b]),
                                            torch.tensor(dU[b]), mu)
        _close(f"member {b} Q~", Qb[b].numpy(), Qm.numpy(), 1e-10, 1e-12)
        _close(f"member {b} R~", Rb[b].numpy(), Rm.numpy(), 1e-10, 1e-12)
        one_qp, one_x0 = tqp.ift_qp_vjp(_t(leaves), torch.tensor(x0), *map(torch.tensor, (
            dX[b], dU[b], ct_X[b], ct_U[b])), **kw)
        _close(f"member {b} dx0 cotangent", bar_x0[b].numpy(), one_x0.numpy(), 1e-10, 1e-12)
        for n in FIELDS:
            g = getattr(one_qp, n)
            if n in shared:
                sums[n] = sums[n] + g.numpy()
            elif g is not None:
                _close(f"member {b} {n} cotangent", getattr(bar_qp, n)[b].numpy(), g.numpy(),
                       1e-10, 1e-12)
    for n in shared:
        assert getattr(bar_qp, n).shape == stacked[FIELDS.index(n)].shape
        _close(f"shared {n} cotangent", getattr(bar_qp, n).numpy(), sums[n], 1e-10, 1e-12)


# --- the QP wrappers' backward ----------------------------------------------------


def _obstacle_qp_np(f=np.float32):
    """tests/test_diff_nmpc.py:187-234's QP, leaves in dtype ``f``: a tight h
    row per stage, so the barrier is active and its Hessian has
    off-diagonal JhᵀhhJh blocks."""
    N, nx, nu = 6, 3, 2
    rng = np.random.default_rng(3)
    leaves = dict(
        A=np.tile(np.eye(nx), (N, 1, 1)) + 0.05 * rng.normal(size=(N, nx, nx)),
        B=0.3 * rng.normal(size=(N, nx, nu)),
        c=0.05 * rng.normal(size=(N, nx)),
        Q=np.tile(np.diag([2.0, 2.0, 0.5]), (N + 1, 1, 1)),
        qx_base=0.3 * rng.normal(size=(N + 1, nx)),
        R=np.tile(np.diag([0.5, 0.3]), (N, 1, 1)),
        ru_base=0.2 * rng.normal(size=(N, nu)),
        lbx=np.full((N + 1, nx), 2.0), ubx=np.full((N + 1, nx), 2.0),
        lbu=np.full((N, nu), 0.6), ubu=np.full((N, nu), 0.6),
        Jh=np.tile(rng.normal(size=(1, 1, nx)), (N + 1, 1, 1)),
        h0=np.full((N + 1, 1), 0.15), S=None,
    )
    return ([None if leaves[n] is None else leaves[n].astype(f) for n in FIELDS],
            np.array([0.1, -0.2, 0.05], f))


def _port_grad(wrapper, leaves, dx0, backward="ift", **kw):
    """d/d(qx_base, dx0) of Σ δX² + Σ sin δU through a port QP wrapper."""
    qp = _t(leaves, torch.tensor(dx0).dtype)
    qxb = qp.qx_base.clone().requires_grad_()
    x0 = torch.tensor(dx0).requires_grad_()
    dX, dU, kkt = getattr(kern, wrapper)(qp._replace(qx_base=qxb), x0, backward=backward, **kw)
    assert not kkt.requires_grad
    return [g.numpy() for g in torch.autograd.grad((dX**2).sum() + dU.sin().sum(), (qxb, x0))]


def test_wrapper_ift_matches_jax_pallas_ift():
    leaves, dx0 = _obstacle_qp_np(np.float64)
    qp = _j(leaves)
    solve = make_vmappable_pallas_qp(12, 1.0e-1, 0.35, None, 0.0, True, "ift")

    def loss(qxb, x0):
        dX, dU, _ = solve(qp._replace(qx_base=qxb), x0)
        return jnp.sum(dX**2) + jnp.sum(jnp.sin(dU))

    want = jax.grad(loss, argnums=(0, 1))(qp.qx_base, jnp.asarray(dx0))
    got = _port_grad("fused_barrier_qp_solve", leaves, dx0, mu0=0.1, kappa=0.35)
    _close("qx_base gradient vs JAX pallas ift", got[0], np.asarray(want[0]), 1e-4, 1e-6)
    _close("dx0 gradient vs JAX pallas ift", got[1], np.asarray(want[1]), 1e-4, 1e-6)


@pytest.mark.parametrize("delta", [1.0e-3, 1.0e-2])
@pytest.mark.parametrize("wrapper", ["fused_barrier_qp_solve", "batched_fused_barrier_qp_solve"])
def test_wrapper_ift_matches_recompute(wrapper, delta):
    """The port's two backward rules agree on the active-obstacle QP, also
    at δ = 1e-2, where the IFT must use the forward's δ and stiffness 1/δ²
    (JAX's ``_bwd`` passes neither and would differentiate δ = 1e-3's
    barrier). Float64 leaves, as tests/test_diff_nmpc.py:187-234 runs its
    QP: both rules then run in float64 about the float32 forward.

    The fleet (B = 3) shares every leaf but qx_base and dx0, and runs 20
    iterations: member 2's h margins at stages 3 and 6 settle on δ, where
    the barrier's ψ'' jumps from μ/δ² to 1/δ², and the IFT is exact only
    for a converged solve. At 12 iterations its gradient is 0.024 off the
    recompute rule's there (the others agree to 1e-8); at 20, 1.2e-9."""
    leaves, dx0 = _obstacle_qp_np(np.float64)
    kw = dict(mu0=0.1, kappa=0.35, delta=delta, num_iters=12)
    if wrapper == "batched_fused_barrier_qp_solve":
        kw["num_iters"] = 20
        rng = np.random.default_rng(5)
        k = FIELDS.index("qx_base")
        leaves[k] = leaves[k] + 0.1 * rng.normal(size=(3,) + leaves[k].shape)
        dx0 = dx0 + 0.05 * rng.normal(size=(3, 3))
    g_ift = _port_grad(wrapper, leaves, dx0, "ift", **kw)
    g_rec = _port_grad(wrapper, leaves, dx0, "recompute", **kw)
    _close(f"{wrapper} δ={delta} qx_base: ift vs recompute", g_ift[0], g_rec[0], 2e-4, 1e-5)
    _close(f"{wrapper} δ={delta} dx0: ift vs recompute", g_ift[1], g_rec[1], 2e-4, 1e-5)


def test_wrapper_shared_leaf_gradient_is_the_members_sum():
    """A leaf shared by the fleet (h0, no leading B) gets the sum of the
    per-member gradients, in its own shape, on both rules."""
    leaves, dx0 = _obstacle_qp_np()
    rng = np.random.default_rng(6)
    x0s = (dx0 + 0.05 * rng.normal(size=(2, 3))).astype(np.float32)
    k = FIELDS.index("h0")
    for rule in ("ift", "recompute"):
        def grad_h0(x0):
            qp = _t(leaves, torch.float32)
            h0 = qp.h0.clone().requires_grad_()
            fn = (kern.fused_barrier_qp_solve if x0.dim() == 1 else
                  kern.batched_fused_barrier_qp_solve)
            dX, dU, _ = fn(qp._replace(h0=h0), x0, mu0=0.1, kappa=0.35, backward=rule)
            (g,) = torch.autograd.grad((dX**2).sum() + dU.sin().sum(), h0)
            return g.numpy()

        fleet = grad_h0(torch.tensor(x0s))
        assert fleet.shape == leaves[k].shape
        _close(f"shared h0 gradient ({rule})", fleet,
               grad_h0(torch.tensor(x0s[0])) + grad_h0(torch.tensor(x0s[1])), 1e-5, 1e-7)


# --- the NMPC tick on the kernel backend ------------------------------------------


def _solver(backend="kernel", N=8, sqp_iters=1):
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=0.1, sqp_iters=sqp_iters, qp_iters=6,
                    qp_backend=backend)
    return NMPCSolver(cfg, unicycle, device="cpu"), cfg


def _params(theta, N):
    q, r = theta[..., :3].exp(), theta[..., 3:].exp()
    goal = torch.tensor(GOAL)
    return OCPParams(Q=torch.diag_embed(q), R=torch.diag_embed(r), Qe=torch.diag_embed(q),
                     yref=torch.cat([goal, torch.zeros(2)])[None].repeat(N, 1), yref_e=goal,
                     lbx=torch.full((3,), -10.0), ubx=torch.full((3,), 10.0),
                     lbu=torch.full((2,), -5.0), ubu=torch.full((2,), 5.0))


def _closed_loop_loss(solver, cfg, theta, x0, ticks=10, effort=0.01, tick=None):
    """tests/test_diff_nmpc.py's ``_closed_loop_loss``: Σ tracking + effort
    over ``ticks`` closed-loop ticks under θ = log diag(Q, R)."""
    tick = tick or solver.solve_fn()
    op = _params(theta, cfg.N)
    goal = torch.tensor(GOAL[:2])
    st, x, loss = NMPCState.init(cfg, x0, device="cpu"), x0, 0.0
    for _ in range(ticks):
        u0, st, _ = tick(op, st, x)
        x = solver.dyn_step(x, u0)
        loss = loss + ((x[:2] - goal) ** 2).sum() + effort * (u0**2).sum()
    return loss


def _central_differences(fn, at, e=1e-2):
    out = []
    with torch.no_grad():
        for i in range(at.shape[0]):
            ei = torch.zeros_like(at)
            ei[i] = e
            out.append(float((fn(at + ei) - fn(at - ei)) / (2 * e)))
    return np.array(out)


def test_x0_gradient_matches_finite_differences():
    solver, cfg = _solver(sqp_iters=2)
    theta = torch.tensor(THETA)

    def loss(x0):
        return _closed_loop_loss(solver, cfg, theta, x0, ticks=6)

    x0 = torch.tensor([0.3, -0.2, 0.1], requires_grad=True)
    kern.reset_counts()
    (g,) = torch.autograd.grad(loss(x0), x0)
    assert kern.fused_barrier_qp_solve_plain.calls == 6 * 2
    assert torch.isfinite(g).all()
    _close("x0 gradient vs central differences", g.numpy(),
           _central_differences(loss, x0.detach()), 5e-2, 5e-3)


def test_weight_gradients_match_finite_differences():
    solver, cfg = _solver()
    x0 = torch.tensor(X0)

    def loss(theta):
        return _closed_loop_loss(solver, cfg, theta, x0)

    theta = torch.tensor(THETA, requires_grad=True)
    (g,) = torch.autograd.grad(loss(theta), theta)
    assert torch.isfinite(g).all()
    _close("weight gradient vs central differences", g.numpy(),
           _central_differences(loss, theta.detach()), 5e-2, 5e-3)


def _jax_params(theta, N):
    goal = jnp.asarray(GOAL, jnp.float32)
    q, r = jnp.exp(theta[..., :3]), jnp.exp(theta[..., 3:])
    return jsqp.OCPParams(
        Q=jnp.diag(q), R=jnp.diag(r), Qe=jnp.diag(q),
        yref=jnp.concatenate([goal, jnp.zeros(2, jnp.float32)])[None, :].repeat(N, axis=0),
        yref_e=goal, lbx=jnp.full(3, -10.0, jnp.float32), ubx=jnp.full(3, 10.0, jnp.float32),
        lbu=jnp.full(2, -5.0, jnp.float32), ubu=jnp.full(2, 5.0, jnp.float32))


def _jax_solver(N, sqp_iters=1):
    cfg = JSQPConfig(N=N, dim_x=3, dim_u=2, dt=0.1, sqp_iters=sqp_iters, qp_iters=6,
                     qp_backend="xla", parallel_riccati=False)
    return jsqp.NMPCSolver(cfg, j_unicycle), cfg


def test_tick_gradients_match_jax_xla(f32_mode):
    """tests/test_diff_nmpc.py:107-158 with the port's kernel backend
    (plain forward, IFT backward) in place of JAX's pallas one: the 6-tick
    tracking loss's θ gradient, and a B = 3 fleet's Σ u0² gradient in x0s
    through ``batched_solve()``, against JAX's all-XLA ``jax.grad`` (each
    member's row from its own tick)."""
    N, ticks = 6, 6
    js, jcfg = _jax_solver(N)
    x0 = np.array(X0, np.float32)
    x0s = np.stack([x0, x0 + 0.1, x0 - 0.2]).astype(np.float32)

    def jax_loss(th):
        op = _jax_params(th, N)

        def body(carry, _):
            st, x = carry
            u0, st, _ = js.solve_fn()(op, st, x)
            x = js.dyn_step(x, u0)
            return (st, x), jnp.sum((x[:2] - op.yref_e[:2]) ** 2)

        x = jnp.asarray(x0)
        _, track = jax.lax.scan(body, (jsqp.NMPCState.init(jcfg, x), x), None, length=ticks)
        return jnp.sum(track)

    def jax_member(x):
        u0, _, _ = js.solve_fn()(_jax_params(jnp.asarray(THETA), N),
                                 jsqp.NMPCState.init(jcfg, x), x)
        return jnp.sum(u0**2)

    j_loss, j_g = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(THETA))
    # the members are independent: row b of the fleet's gradient is member b's
    member_grad = jax.jit(jax.grad(jax_member))
    j_gf = np.stack([np.asarray(member_grad(jnp.asarray(x))) for x in x0s])

    ts, tcfg = _solver(N=N)
    theta = torch.tensor(THETA, requires_grad=True)
    loss = _closed_loop_loss(ts, tcfg, theta, torch.tensor(x0), ticks=ticks, effort=0.0)
    (g,) = torch.autograd.grad(loss, theta)
    _close("6-tick loss vs JAX xla", loss.item(), float(j_loss), 1e-4, 0.0)
    _close("θ gradient vs JAX xla", g.numpy(), np.asarray(j_g), 2e-3, 1e-4)

    xs = torch.tensor(x0s, requires_grad=True)
    kern.reset_counts()
    u0, _, _ = ts.batched_solve()(_params(torch.tensor(THETA), N), ts.init(xs), xs)
    (gf,) = torch.autograd.grad((u0**2).sum(), xs)
    assert kern.batched_fused_barrier_qp_solve_plain.calls == 1
    _close("fleet x0s gradient vs JAX xla", gf.numpy(), np.asarray(j_gf), 2e-3, 1e-4)


@pytest.fixture
def gloo_world1():
    """A single-process gloo group for the test, torn down after it."""
    assert not dist.is_initialized()
    assert parallel.initialize_distributed(device="cpu") == (0, 1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fleet_state_grad(step, solver, params, states, x0s):
    """d/d(x0s, yref_e) of Σ u0² + Σ X² through one fleet step."""
    xs = x0s.clone().requires_grad_()
    goal = params.yref_e.clone().requires_grad_()
    u0, st, _ = step(dataclasses.replace(params, yref_e=goal), states, xs)
    return torch.autograd.grad((u0**2).sum() + (st.X**2).sum(), (xs, goal))


def test_sharded_nmpc_fleet_gradient_equals_batched_solve(gloo_world1):
    from dnn_mppi_mpc_tpu_torch import presets

    solver, params, states, x0s = presets.nmpc_fleet(B=4, N=5, device="cpu")
    sharded = parallel.make_sharded_nmpc_fleet(solver, device="cpu")
    got = _fleet_state_grad(sharded, solver, params, states, x0s)
    want = _fleet_state_grad(solver.batched_solve(), solver, params, states, x0s)
    for name, a, b in zip(("x0s", "yref_e"), got, want):
        assert torch.isfinite(a).all() and float(a.abs().sum()) > 0, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


# --- the autotune loop ----------------------------------------------------------


THETA_POOR = np.log([0.5, 0.5, 5.0, 3.0, 3.0]).astype(np.float32)


def _port_autotune(tick_of, steps, lr=0.2):
    """examples/nmpc_autotune.py's loop at tests/test_diff_nmpc.py:161-184's
    scale with ``torch.optim.Adam`` (optax.adam's betas and eps): the loss
    at each step, before its update."""
    solver, cfg = _solver()
    theta = torch.tensor(THETA_POOR, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = _closed_loop_loss(solver, cfg, theta, torch.tensor(X0), tick=tick_of(solver))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def test_autotune_improves_closed_loop_loss():
    """Twelve Adam steps on the kernel backend (IFT backward) cut the
    closed-loop loss below 0.6 of the first (the JAX test's gate)."""
    losses = _port_autotune(lambda s: s.solve_fn(), 12)
    print("kernel-backend autotune losses", losses)
    assert losses[-1] < 0.6 * losses[0], losses


def test_autotune_torch_twin_follows_jax_optax(f32_mode):
    import optax

    js, jcfg = _jax_solver(8)
    x0 = jnp.asarray(X0, jnp.float32)
    goal = jnp.asarray(GOAL[:2], jnp.float32)

    def jax_loss(th):
        op = _jax_params(th, 8)

        def body(carry, _):
            st, x = carry
            u0, st, _ = js.solve_fn(differentiable=True)(op, st, x)
            x = js.dyn_step(x, u0)
            return (st, x), (jnp.sum((x[:2] - goal) ** 2), jnp.sum(u0**2))

        _, (track, effort) = jax.lax.scan(body, (jsqp.NMPCState.init(jcfg, x0), x0), None,
                                          length=10)
        return jnp.sum(track) + 0.01 * jnp.sum(effort)

    opt = optax.adam(0.2)

    @jax.jit
    def step(th, os_):
        v, g = jax.value_and_grad(jax_loss)(th)
        up, os2 = opt.update(g, os_, th)
        return v, optax.apply_updates(th, up), os2

    th = jnp.asarray(THETA_POOR)
    os_, want = opt.init(th), []
    for _ in range(5):
        v, th, os_ = step(th, os_)
        want.append(float(v))
    got = _port_autotune(lambda s: s.solve_fn(differentiable=True), 5)
    _close("torch twin's first five autotune losses vs JAX optax", got, want, 1e-4, 0.0)
