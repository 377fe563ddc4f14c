"""SQP-RTI NMPC engine: Gauss-Newton SQP over multiple shooting
(counterpart of ``dnn_mppi_mpc_tpu/solvers/sqp.py``).

One tick linearizes the shooting intervals with ``torch.func``
(``vmap(jacrev)`` through the integrator; reverse mode where JAX uses
forward mode, see ``models/integrators.py``), builds the Gauss-Newton QP
(LINEAR_LS, a separable state residual ``y_x_fn``, or a general residual
``y_fn`` with the cross term S), solves it with the relaxed-barrier Riccati
QP and updates the trajectory, ``sqp_iters`` times; then it holds the warm
start if the result is not finite and reports the diagnostics.

Everything is batch-aware: a state with a leading member axis B is a fleet,
solved in one pass of batched tensor ops; the params' leaves may carry the
same leading B or be shared. The QP goes to ``cfg.qp_backend``: ``"torch"``
(:func:`~.qp.barrier_qp_solve`, batched tensor ops that autograd can go
through) or ``"kernel"`` (the fused CUDA kernel: one problem through
``fused_barrier_qp_solve``, a fleet through
``batched_fused_barrier_qp_solve``; their plain versions on CPU tensors).
Both backends differentiate: the kernel's gradient is the
implicit-function-theorem rule at the QP's solution
(:func:`~.qp.ift_qp_vjp`).

The tick never waits for the card: the merit line search picks its step by
``argmin`` and tensor indexing, no Python ``bool`` is taken of a tensor, and
the constants a tick needs on the card (the step candidates, the QP's μ
schedule, the IRK tableau) are copied there once, when the solver is built.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from functools import lru_cache
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jacrev, vmap

from ..config import SQPConfig, resolve_device
from ..models.integrators import _tableau_tensors, erk_step, irk_step
from ..ops.cuda.riccati_qp import (
    batched_fused_barrier_qp_solve,
    fused_barrier_qp_solve,
    qp_schedule,
)
from .qp import BoxedQPData, barrier_qp_solve


@dataclasses.dataclass
class OCPParams:
    """Runtime OCP data: cost matrices, references, bounds, h parameters.

    ``yref`` stacks (x_ref, u_ref) rows like acados' ny = nx + nu reference;
    ``p`` feeds the h-constraint function (obstacle rows (n, 3)). A fleet's
    leaves may carry a leading member axis B; a leaf without it is shared."""

    Q: torch.Tensor  # (nx, nx); the full W (ny, ny) with y_fn
    R: torch.Tensor  # (nu, nu)
    Qe: torch.Tensor  # (nx, nx)
    yref: torch.Tensor  # (N, nx + nu)
    yref_e: torch.Tensor  # (nx,)
    lbx: torch.Tensor  # (nx,)
    ubx: torch.Tensor
    lbu: torch.Tensor  # (nu,)
    ubu: torch.Tensor
    p: Optional[torch.Tensor] = None  # h-constraint parameters

    def to(self, device) -> "OCPParams":
        """A copy with every tensor moved to ``device``."""
        return OCPParams(**{f.name: None if getattr(self, f.name) is None
                            else getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


# each OCPParams leaf's rank without the member axis
PARAM_NDIM = dict(Q=2, R=2, Qe=2, yref=2, yref_e=1, lbx=1, ubx=1, lbu=1, ubu=1, p=2)


def ocp_params_from_numpy(Q, R, Qe, yref, yref_e, lbx, ubx, lbu, ubu, p=None, *,
                          dtype=torch.float32, device="cuda") -> OCPParams:
    """:class:`OCPParams` on ``device`` from the JAX package's ``OCPParams``
    leaves (anything numpy reads), in ``dtype``; a fleet's leaves keep their
    leading member axis."""
    device = resolve_device(device)

    def t(a):
        return None if a is None else torch.tensor(np.asarray(a), dtype=dtype).to(device)

    return OCPParams(Q=t(Q), R=t(R), Qe=t(Qe), yref=t(yref), yref_e=t(yref_e), lbx=t(lbx),
                     ubx=t(ubx), lbu=t(lbu), ubu=t(ubu), p=t(p))


@dataclasses.dataclass
class NMPCState:
    """Warm-start trajectory carried between ticks; a fleet's state has a
    leading member axis B on both leaves."""

    X: torch.Tensor  # (N+1, nx); (B, N+1, nx)
    U: torch.Tensor  # (N, nu); (B, N, nu)

    @classmethod
    def init(cls, cfg: SQPConfig, x0, device="cuda") -> "NMPCState":
        """X = x0 at every node, U = 0, float32 on ``device``; x0 (B, nx)
        gives a fleet's state."""
        device = resolve_device(device)
        x0 = torch.as_tensor(x0, dtype=torch.float32).to(device)
        lead = x0.shape[:-1]
        X = x0.unsqueeze(-2).expand(*lead, cfg.N + 1, x0.shape[-1]).contiguous()
        U = torch.zeros((*lead, cfg.N, cfg.dim_u), dtype=torch.float32, device=device)
        return cls(X=X, U=U)

    def to(self, device) -> "NMPCState":
        return NMPCState(X=self.X.to(device), U=self.U.to(device))


def state_from_numpy(X, U, *, dtype=torch.float32, device="cuda") -> NMPCState:
    """:class:`NMPCState` on ``device`` from the JAX package's ``NMPCState``
    leaves (a fleet's with their leading member axis)."""
    device = resolve_device(device)
    return NMPCState(X=torch.tensor(np.asarray(X), dtype=dtype).to(device),
                     U=torch.tensor(np.asarray(U), dtype=dtype).to(device))


class NMPCAux(NamedTuple):
    X: torch.Tensor  # predicted state trajectory
    U: torch.Tensor  # planned controls
    h_margin: torch.Tensor  # min h-constraint margin over the horizon (inf without h)
    defect: torch.Tensor  # max multiple-shooting defect after the solve
    status: torch.Tensor  # int32: 0 ok, 2 non-finite (solve rejected, warm start held)
    kkt_residual: torch.Tensor  # ∞-norm of the last damped Newton step of the last QP


# h(x, p) -> (n_h,), feasible iff h ≥ 0
HFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def circle_obstacle_h(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """acados-style obstacle rows (x−ox)² + (y−oy)² − (r+safe)² ≥ 0 for
    ``p`` (n_obs, 3) = (ox, oy, r+safe_distance)."""
    d2 = ((x[:2][None, :] - p[:, :2]) ** 2).sum(-1)
    return d2 - p[:, 2] ** 2


def _with_aux(fn):
    def f(*args):
        out = fn(*args)
        return out, out
    return f


def _map_rows(fn, *xs):
    """``fn`` on single rows, vmapped over the flattened leading dims of the
    first argument (the others share them)."""
    lead = xs[0].shape[:-1]
    out = vmap(fn)(*(x.reshape(-1, x.shape[-1]) for x in xs))
    return out.reshape(*lead, *out.shape[1:])


def _linearize(dyn_step, X, U):
    """Stage-wise A, B and defect c of the shooting intervals: one
    ``vmap(jacrev)`` over the concatenated (x, u), with the primal as aux,
    so one pass gives F, A and B. Any leading dims ride along."""
    nx = X.shape[-1]

    def fval(z):
        return dyn_step(z[:nx], z[nx:])

    Z = torch.cat([X[..., :-1, :], U], dim=-1)
    lead = Z.shape[:-1]
    J, F = vmap(jacrev(_with_aux(fval), has_aux=True))(Z.reshape(-1, Z.shape[-1]))
    J = J.reshape(*lead, nx, Z.shape[-1])
    F = F.reshape(*lead, nx)
    return J[..., :nx], J[..., nx:], F - X[..., 1:, :]


def _h_values(h_fn, X, p):
    """h at every node of X (Bt, ..., nx) with member b's parameters p[b]."""
    Bt = X.shape[0]
    rows = X.reshape(Bt, -1, X.shape[-1])
    h = vmap(vmap(h_fn, in_dims=(0, None)))(rows, p)
    return h.reshape(*X.shape[:-1], h.shape[-1])


@lru_cache(maxsize=None)
def _merit_alphas(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The merit line search's step candidates on ``device``, copied once."""
    return torch.tensor([1.0, 0.7, 0.5, 0.35, 0.25, 0.1], dtype=dtype).to(device)


def _member_params(params: OCPParams, Bt: int, dtype) -> dict:
    """Every leaf of ``params`` in ``dtype`` with a leading member axis Bt."""
    out = {}
    for f in dataclasses.fields(params):
        a = getattr(params, f.name)
        if a is None:
            out[f.name] = None
            continue
        a = a.to(dtype)
        nd = PARAM_NDIM[f.name]
        if a.dim() == nd:
            a = a.expand(Bt, *a.shape)
        elif a.dim() != nd + 1 or a.shape[0] != Bt:
            raise ValueError(f"params.{f.name} has shape {tuple(a.shape)}: expected rank {nd}, "
                             f"or rank {nd + 1} with the fleet's {Bt} members first")
        out[f.name] = a
    return out


def _qp_kwargs(cfg: SQPConfig) -> dict:
    # soft h-constraints: the barrier's quadratic extension plays the L2
    # slack role and h_slope the L1 role (acados' Zl/zl)
    return dict(num_iters=cfg.qp_iters, mu0=cfg.ip_mu0, kappa=cfg.ip_kappa, delta=cfg.ip_delta,
                h_stiffness=cfg.slack_weight_l2 if cfg.soft_h else None,
                h_slope=cfg.slack_weight_l1 if cfg.soft_h else 0.0)


def sqp_solve(
    cfg: SQPConfig,
    dyn_step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    h_fn: Optional[HFn],
    params: OCPParams,
    state: NMPCState,
    x0: torch.Tensor,
    y_x_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    y_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    y_e_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, NMPCState, NMPCAux]:
    """One NMPC tick: ``sqp_iters`` × (linearize → barrier-Riccati QP →
    update). Returns (u0, warm-start state, aux).

    Cost forms: LINEAR_LS with y = (x, u) by default; ``y_x_fn(x)`` a
    separable NONLINEAR_LS state residual; ``y_fn(x, u)`` a general
    NONLINEAR_LS residual with the Gauss-Newton blocks Q = JxᵀWJx,
    R = JuᵀWJu and the cross term S = JuᵀWJx, and the terminal residual
    ``y_e_fn(x)`` (default ``y_fn(x, 0)``).

    A state with a leading member axis B (X (B, N+1, nx), x0 (B, nx)) is a
    fleet of independent problems; every output then has the leading B."""
    nx, nu, N = cfg.dim_x, cfg.dim_u, cfg.N
    fleet = state.X.dim() == 3
    X0s, U0s = (state.X, state.U) if fleet else (state.X[None], state.U[None])
    Bt = X0s.shape[0]
    dtype, dev = X0s.dtype, X0s.device
    x0 = x0.to(dtype).reshape(Bt, nx)
    P = _member_params(params, Bt, dtype)
    Q, R, Qe, yref, yref_e = P["Q"], P["R"], P["Qe"], P["yref"], P["yref_e"]
    has_h = h_fn is not None and P["p"] is not None

    if y_fn is not None and y_e_fn is None:
        def y_e_fn(x):
            return y_fn(x, torch.zeros((nu,), dtype=x.dtype, device=x.device))

    def residual_and_jac(fn, *xs):
        """(J, y) of ``fn`` over the flattened leading dims of ``xs``."""
        z = torch.cat(xs, dim=-1)
        sizes = [x.shape[-1] for x in xs]

        def f(zz):
            return fn(*torch.split(zz, sizes))

        lead = z.shape[:-1]
        J, y = vmap(jacrev(_with_aux(f), has_aux=True))(z.reshape(-1, z.shape[-1]))
        return J.reshape(*lead, *J.shape[1:]), y.reshape(*lead, y.shape[-1])

    def qp_of(X, U):
        A, B, c = _linearize(dyn_step, X, U)
        S_cross = None
        if y_fn is not None:
            J, Y = residual_and_jac(y_fn, X[:, :-1], U)  # (Bt, N, ny, nx + nu)
            Jx, Ju = J[..., :nx], J[..., nx:]
            ny = Y.shape[-1]
            r_stage = Y - yref[:, :, :ny]
            Je, Ye = residual_and_jac(y_e_fn, X[:, -1])
            r_term = Ye - yref_e
            Qs = torch.cat([torch.einsum("ziax,zab,ziby->zixy", Jx, Q, Jx),
                            torch.einsum("zax,zab,zby->zxy", Je, Qe, Je)[:, None]], dim=1)
            qx_base = torch.cat([torch.einsum("ziax,zab,zib->zix", Jx, Q, r_stage),
                                 torch.einsum("zax,zab,zb->zx", Je, Qe, r_term)[:, None]], dim=1)
            # here params.Q is the full W (ny × ny) over the residual
            Rs = torch.einsum("ziau,zab,zibv->ziuv", Ju, Q, Ju)
            ru_base = torch.einsum("ziau,zab,zib->ziu", Ju, Q, r_stage)
            S_cross = torch.einsum("ziau,zab,zibx->ziux", Ju, Q, Jx)
        elif y_x_fn is None:
            # LINEAR_LS Gauss-Newton blocks: the Hessian is blkdiag(Q, R) exactly
            Qs = torch.cat([Q[:, None].expand(Bt, N, nx, nx), Qe[:, None]], dim=1)
            qx_base = torch.cat([
                torch.einsum("zxy,ziy->zix", Q, X[:, :-1] - yref[:, :, :nx]),
                torch.einsum("zxy,zy->zx", Qe, X[:, -1] - yref_e)[:, None]], dim=1)
        else:
            Jy, Y = residual_and_jac(y_x_fn, X)  # (Bt, N+1, ny, nx)
            ny = Y.shape[-1]
            r_stage = Y[:, :-1] - yref[:, :, :ny]
            r_term = Y[:, -1] - yref_e
            Qs = torch.cat([
                torch.einsum("ziax,zab,ziby->zixy", Jy[:, :-1], Q, Jy[:, :-1]),
                torch.einsum("zax,zab,zby->zxy", Jy[:, -1], Qe, Jy[:, -1])[:, None]], dim=1)
            qx_base = torch.cat([
                torch.einsum("ziax,zab,zib->zix", Jy[:, :-1], Q, r_stage),
                torch.einsum("zax,zab,zb->zx", Jy[:, -1], Qe, r_term)[:, None]], dim=1)
        if y_fn is None:
            Rs = R[:, None].expand(Bt, N, nu, nu)
            # the control reference: the trailing nu columns of yref
            ru_base = torch.einsum("zuv,ziv->ziu", R, U - yref[:, :, -nu:])

        Jh = h0 = None
        if has_h:
            pp = P["p"]
            Jh, h0 = vmap(vmap(jacrev(_with_aux(h_fn), has_aux=True), in_dims=(0, None)))(X, pp)
            if not cfg.h_terminal:
                # acados convention: h rows at stages 0..N-1 only; a zero
                # terminal Jacobian row removes the stage-N barrier term
                Jh = torch.cat([Jh[:, :-1], torch.zeros_like(Jh[:, -1:])], dim=1)
                h0 = torch.cat([h0[:, :-1], torch.ones_like(h0[:, -1:])], dim=1)
        return BoxedQPData(
            A=A, B=B, c=c, Q=Qs, qx_base=qx_base, R=Rs, ru_base=ru_base,
            lbx=X - P["lbx"][:, None], ubx=P["ubx"][:, None] - X,
            lbu=U - P["lbu"][:, None], ubu=P["ubu"][:, None] - U,
            Jh=Jh, h0=h0, S=S_cross,
        )

    def solve_qp(qp, dx0):
        kw = _qp_kwargs(cfg)
        if cfg.qp_backend == "kernel":
            if fleet:
                dX, dU, kkt = batched_fused_barrier_qp_solve(qp, dx0, **kw)
            else:
                one = BoxedQPData(*(None if t is None else t[0] for t in qp))
                dX, dU, kkt = fused_barrier_qp_solve(one, dx0[0], **kw)
                dX, dU, kkt = dX[None], dU[None], kkt[None]
            return dX.to(dtype), dU.to(dtype), kkt
        return barrier_qp_solve(qp, dx0, return_kkt=True, **kw)

    def merit(Xc, Uc):
        """ℓ1 merit of the candidates (k, Bt, …): LS cost + 1e3·(defects,
        initial-state residual, bound and h violations)."""
        if y_fn is not None:
            ex = _map_rows(y_fn, Xc[..., :-1, :], Uc)
            ex = ex - yref[None, :, :, :ex.shape[-1]]
            eT = _map_rows(y_e_fn, Xc[..., -1, :]) - yref_e[None]
            cost = (0.5 * torch.einsum("kzia,zab,kzib->kz", ex, Q, ex)
                    + 0.5 * torch.einsum("kza,zab,kzb->kz", eT, Qe, eT))
        else:
            if y_x_fn is None:
                ex = Xc[..., :-1, :] - yref[None, :, :, :nx]
                eT = Xc[..., -1, :] - yref_e[None]
            else:
                Yc = _map_rows(y_x_fn, Xc)
                ex = Yc[..., :-1, :] - yref[None, :, :, :Yc.shape[-1]]
                eT = Yc[..., -1, :] - yref_e[None]
            eu = Uc - yref[None, :, :, -nu:]
            cost = (0.5 * torch.einsum("kzix,zxy,kziy->kz", ex, Q, ex)
                    + 0.5 * torch.einsum("kziu,zuv,kziv->kz", eu, R, eu)
                    + 0.5 * torch.einsum("kzx,zxy,kzy->kz", eT, Qe, eT))
        Fc = _map_rows(dyn_step, Xc[..., :-1, :], Uc)
        # the initial-state residual keeps a damped step anchored at x0
        defect = ((Fc - Xc[..., 1:, :]).abs().sum((-2, -1))
                  + (Xc[..., 0, :] - x0[None]).abs().sum(-1))
        viol = (torch.relu(P["lbx"][None, :, None] - Xc).sum((-2, -1))
                + torch.relu(Xc - P["ubx"][None, :, None]).sum((-2, -1))
                + torch.relu(P["lbu"][None, :, None] - Uc).sum((-2, -1))
                + torch.relu(Uc - P["ubu"][None, :, None]).sum((-2, -1)))
        pen = 1.0e3
        m = cost + pen * (defect + viol)
        if has_h:
            # the terminal node is penalised only when its h rows are in the QP
            Xh = Xc if cfg.h_terminal else Xc[..., :-1, :]
            h = _h_values(h_fn, Xh.transpose(0, 1), P["p"]).transpose(0, 1)
            m = m + pen * torch.relu(-h).sum((-2, -1))
        return m

    X, U = X0s, U0s
    kkt = None
    for _ in range(cfg.sqp_iters):
        qp = qp_of(X, U)
        dX, dU, kkt = solve_qp(qp, x0 - X[:, 0])
        if cfg.line_search == "full":
            # acados SQP_RTI: always the full Newton step
            X, U = X + dX, U + dU
            continue
        alphas = _merit_alphas(dtype, dev)
        a = alphas[:, None, None, None]
        merits = merit(X[None] + a * dX[None], U[None] + a * dU[None])  # (6, Bt)
        best = alphas[torch.argmin(merits, dim=0)][:, None, None]
        X, U = X + best * dX, U + best * dU

    # a non-finite solution is rejected and the warm start held (status 2)
    finite = torch.isfinite(X).all(-1).all(-1) & torch.isfinite(U).all(-1).all(-1)
    X = torch.where(finite[:, None, None], X, X0s)
    U = torch.where(finite[:, None, None], U, U0s)
    status = 2 * torch.logical_not(finite).to(torch.int32)

    F = _map_rows(dyn_step, X[:, :-1], U)
    defect = (F - X[:, 1:]).abs().amax(dim=(-2, -1))
    if has_h:
        h_margin = _h_values(h_fn, X, P["p"]).amin(dim=(-2, -1))
    else:
        h_margin = torch.full((Bt,), math.inf, dtype=dtype, device=dev)
    if kkt is None:
        kkt = torch.zeros((Bt,), dtype=dtype, device=dev)

    if not fleet:
        X, U, h_margin, defect, status, kkt = X[0], U[0], h_margin[0], defect[0], status[0], kkt[0]
    aux = NMPCAux(X=X, U=U, h_margin=h_margin, defect=defect, status=status, kkt_residual=kkt)
    return U[..., 0, :], NMPCState(X=X, U=U), aux


class NMPCSolver:
    """Binds config, dynamics and constraints into the per-tick solve.

    ``dynamics`` is continuous (f(x, u) → ẋ, discretized by ERK(4, 3) or
    Gauss-Legendre IRK as ``cfg.integrator`` says) unless ``discrete``.
    ``self.dyn_step`` is the discrete transition, the plant of a closed
    loop. The constants a tick needs are copied to ``device`` (default the
    card) at construction, so no tick waits for the card."""

    def __init__(
        self,
        cfg: SQPConfig,
        dynamics: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        h_fn: Optional[HFn] = None,
        discrete: bool = False,
        y_x_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        y_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
        y_e_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        device="cuda",
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        if discrete:
            step = dynamics
        elif cfg.integrator == "irk":
            def step(x, u):
                return irk_step(dynamics, x, u, cfg.dt, num_steps=cfg.num_rk4_steps,
                                newton_iters=cfg.irk_newton_iters)
            _tableau_tensors(4, torch.float32, self.device)
        else:
            def step(x, u):
                return erk_step(dynamics, x, u, cfg.dt, num_steps=cfg.num_rk4_steps)
        self.dyn_step = step
        self._h_fn = h_fn
        kw = dict(y_x_fn=y_x_fn, y_fn=y_fn, y_e_fn=y_e_fn)
        self._core = functools.partial(sqp_solve, cfg, step, h_fn, **kw)
        # the torch-backend twin, whose gradient is the exact derivative of
        # its own forward (solve_fn / batched_solve with differentiable=True)
        if cfg.qp_backend == "kernel":
            torch_cfg = dataclasses.replace(cfg, qp_backend="torch")
            self._torch_core = functools.partial(sqp_solve, torch_cfg, step, h_fn, **kw)
            kwq = _qp_kwargs(cfg)
            qp_schedule(kwq["num_iters"], kwq["mu0"], kwq["kappa"], kwq["delta"], None,
                        kwq["h_stiffness"], kwq["h_slope"], self.device)
        else:
            self._torch_core = self._core
        _merit_alphas(torch.float32, self.device)

    def init(self, x0) -> NMPCState:
        """The cold start from x0 (nx,) or, for a fleet, x0s (B, nx)."""
        return NMPCState.init(self.cfg, x0, device=self.device)

    def solve(self, params: OCPParams, state: NMPCState, x0: torch.Tensor
              ) -> Tuple[torch.Tensor, NMPCState, NMPCAux]:
        """One tick of one controller: (u0, state, aux)."""
        return self._core(params, state, x0)

    def solve_fn(self, differentiable: bool = False):
        """The tick as a function ``(params, state, x0) → (u0, state, aux)``,
        for closed loops built around it and autograd through the
        controller.

        Both backends differentiate: on ``qp_backend="kernel"`` the QP
        wrapper carries a backward whose rule is the implicit-function
        theorem, one adjoint Riccati solve at the QP's solution
        (``solvers/qp.py ift_qp_vjp``), while the forward stays the kernel.
        It is exact for a converged QP solve. ``differentiable=True`` gives
        the torch-QP twin instead, whose gradient is the exact derivative of
        its own forward: the choice when checking against finite
        differences, at the torch QP's slower forward."""
        return self._torch_core if differentiable else self._core

    def batched_solve(self, differentiable: bool = False):
        """The fleet solve ``(params, states, x0s) → (u0s, states, auxs)`` on
        states with a leading member axis B: one pass of batched ops, and
        with ``qp_backend="kernel"`` one launch of the batched QP kernel per
        SQP iteration for the whole fleet (for fleets split over ranks,
        ``parallel.make_sharded_nmpc_fleet``).

        The kernel backend differentiates through the batched QP's IFT
        backward (see :meth:`solve_fn`); a params leaf shared by the fleet
        gets the sum of the members' gradients. ``differentiable=True``
        builds the fleet on the torch-QP twin, whose gradient is the exact
        derivative of its own forward."""
        core = self._torch_core if differentiable else self._core

        def fleet(params: OCPParams, states: NMPCState, x0s: torch.Tensor):
            if states.X.dim() != 3 or x0s.dim() != 2:
                raise ValueError("batched_solve takes states (B, N+1, nx), (B, N, nu) and "
                                 f"x0s (B, nx); got {tuple(states.X.shape)} and "
                                 f"{tuple(x0s.shape)}")
            return core(params, states, x0s)

        return fleet


__all__ = [
    "HFn",
    "NMPCAux",
    "NMPCSolver",
    "NMPCState",
    "OCPParams",
    "PARAM_NDIM",
    "circle_obstacle_h",
    "ocp_params_from_numpy",
    "sqp_solve",
    "state_from_numpy",
]
