"""Structure-exploiting QP solver: Riccati recursion + relaxed log barrier
(counterpart of ``dnn_mppi_mpc_tpu/solvers/qp.py``).

The stage-structured QP of one NMPC linearization,

    min  Σᵢ ½δxᵢᵀQ̄ᵢδxᵢ + q̄ᵢᵀδxᵢ + ½δuᵢᵀR̄ᵢδuᵢ + r̄ᵢᵀδuᵢ
    s.t. δx_{i+1} = Aᵢδxᵢ + Bᵢδuᵢ + cᵢ,   δx₀ fixed,
         box bounds on x, u and linearized h-constraints,

is solved by damped Newton on a relaxed logarithmic barrier: each Newton
step is an affine LQR solved by a backward/forward Riccati sweep. This is
the ``"torch"`` QP backend of the SQP engine, written in plain PyTorch ops
without in-place updates, so autograd goes through it (the differentiable
route of :class:`~.sqp.NMPCSolver`). The implicit-function-theorem
backward of the fused kernel (:func:`ift_qp_vjp`, with
:func:`condensed_barrier_objective` and :func:`barrier_hessian_blocks`)
lives here too. Every function takes an optional leading batch dimension,
so one call serves a fleet. The JAX package's
associative-scan Riccati (``riccati_solve_parallel``) is not ported; on the
card the fused kernel (``ops/cuda/riccati_qp.py``) takes its role.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.cuda.riccati_qp import batch_leaves, qp_schedule
from ..ops.filters import full_f32
from ..ops.sampling import small_lu_solve


def relaxed_barrier(
    w: torch.Tensor, mu, delta: float, stiffness: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ψ, ψ', ψ'') of the relaxed log barrier at margin w (constraint w ≥ 0).

    ψ(w) = −μ ln w for w > δ; below δ a quadratic extension with a C¹-matched
    gradient and a μ-independent stiffness κ: ψ' = −μ/δ − κ(δ−w), ψ'' = κ.
    ``mu`` is a float or a 0-d tensor."""
    if stiffness is None:
        stiffness = 1.0 / (delta * delta)
    w_safe = torch.clamp_min(w, delta)
    log_val = -mu * torch.log(w_safe)
    log_grad = -mu / w_safe
    log_hess = mu / (w_safe * w_safe)
    dv = delta - w
    quad_val = -mu * math.log(delta) + (mu / delta) * dv + 0.5 * stiffness * dv * dv
    quad_grad = -mu / delta - stiffness * dv
    quad_hess = torch.full_like(w, stiffness)
    use_log = w > delta
    return (
        torch.where(use_log, log_val, quad_val),
        torch.where(use_log, log_grad, quad_grad),
        torch.where(use_log, log_hess, quad_hess),
    )


class LQRData(NamedTuple):
    """Affine time-varying LQR problem, stage-stacked, with an optional
    leading batch dimension on every leaf."""

    A: torch.Tensor  # (N, nx, nx)
    B: torch.Tensor  # (N, nx, nu)
    c: torch.Tensor  # (N, nx) dynamics residual / affine drift
    Qxx: torch.Tensor  # (N+1, nx, nx); stage 0 unused (δx₀ fixed)
    qx: torch.Tensor  # (N+1, nx)
    Ruu: torch.Tensor  # (N, nu, nu)
    ru: torch.Tensor  # (N, nu)
    S: Optional[torch.Tensor] = None  # (N, nu, nx) cross term δuᵀSδx


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def riccati_solve(data: LQRData, dx0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the affine LQR exactly: (δX (..., N+1, nx), δU (..., N, nu)).

    The backward sweep computes the value function (P, p) and the gains
    (K, k), the forward sweep rolls the linear dynamics; both are Python
    loops over the N stages."""
    N = data.A.shape[-3]
    nu = data.B.shape[-1]
    reg = 1e-9
    eye_u = torch.eye(nu, dtype=data.A.dtype, device=data.A.device)
    P, p = data.Qxx[..., N, :, :], data.qx[..., N, :]
    K = [None] * N
    k = [None] * N
    for i in reversed(range(N)):
        A, B, c = data.A[..., i, :, :], data.B[..., i, :, :], data.c[..., i, :]
        Bt = B.transpose(-1, -2)
        PA = P @ A
        PB = P @ B
        Luu = data.Ruu[..., i, :, :] + Bt @ PB
        Luu = 0.5 * (Luu + Luu.transpose(-1, -2)) + reg * eye_u
        Lux = Bt @ PA
        if data.S is not None:
            Lux = data.S[..., i, :, :] + Lux
        p_next = p + _mv(P, c)
        lu = data.ru[..., i, :] + _mv(Bt, p_next)
        # one pivoted LU for both right-hand sides [Lux | lu]
        sol = small_lu_solve(Luu, torch.cat([Lux, lu.unsqueeze(-1)], dim=-1))
        K[i], k[i] = -sol[..., :-1], -sol[..., -1]
        Lt = Lux.transpose(-1, -2)
        P_new = data.Qxx[..., i, :, :] + A.transpose(-1, -2) @ PA + Lt @ K[i]
        P = 0.5 * (P_new + P_new.transpose(-1, -2))
        p = data.qx[..., i, :] + _mv(A.transpose(-1, -2), p_next) + _mv(Lt, k[i])

    dX, dU = [dx0], []
    dx = dx0
    for i in range(N):
        du = _mv(K[i], dx) + k[i]
        dx = _mv(data.A[..., i, :, :], dx) + _mv(data.B[..., i, :, :], du) + data.c[..., i, :]
        dU.append(du)
        dX.append(dx)
    return torch.stack(dX, dim=-2), torch.stack(dU, dim=-2)


class BoxedQPData(NamedTuple):
    """Stage-structured QP with bounds and linearized inequality constraints
    (fields as in the JAX package). Margins use the convention w ≥ 0
    feasible; ``Jh``/``h0`` are n_h linearized rows per stage,
    h0ᵢ + Jhᵢ δxᵢ ≥ 0. A fleet's leaves carry a leading batch dimension."""

    A: torch.Tensor  # (N, nx, nx)
    B: torch.Tensor  # (N, nx, nu)
    c: torch.Tensor  # (N, nx)
    Q: torch.Tensor  # (N+1, nx, nx) LS Hessian blocks
    qx_base: torch.Tensor  # (N+1, nx) LS gradient at δ=0
    R: torch.Tensor  # (N, nu, nu)
    ru_base: torch.Tensor  # (N, nu)
    lbx: torch.Tensor  # (N+1, nx) margin x̄ − lbx at δ=0
    ubx: torch.Tensor  # (N+1, nx) margin ubx − x̄
    lbu: torch.Tensor  # (N, nu)
    ubu: torch.Tensor  # (N, nu)
    Jh: Optional[torch.Tensor]  # (N+1, n_h, nx) or None
    h0: Optional[torch.Tensor]  # (N+1, n_h) margins at δ=0
    S: Optional[torch.Tensor] = None  # (N, nu, nx) LS cross blocks (JuᵀWJx)


def _roll(dU: torch.Tensor, qp: BoxedQPData, dx0: torch.Tensor) -> torch.Tensor:
    """δX (B, N+1, nx) of the exact linear roll δx_{i+1} = Aᵢδxᵢ + Bᵢδuᵢ + cᵢ
    from dx0 (B, nx), on (B, …) leaves."""
    xs = [dx0]
    for i in range(dU.shape[1]):
        xs.append(_mv(qp.A[:, i], xs[-1]) + _mv(qp.B[:, i], dU[:, i]) + qp.c[:, i])
    return torch.stack(xs, dim=1)


def _stiffnesses(delta: float, stiffness: Optional[float], h_stiffness: Optional[float]):
    if stiffness is None:
        stiffness = 1.0 / (delta * delta)
    return stiffness, stiffness if h_stiffness is None else h_stiffness


def _with_batch(qp, dx0: torch.Tensor, *stage_tensors: torch.Tensor):
    """(qp, dx0, stage_tensors, batched) with a leading batch B on every
    leaf, dx0 and each of ``stage_tensors`` ((N[+1], k) per problem): B is
    the size of those that carry one, and a tensor without it is shared."""
    lead = [t.shape[0] for t in stage_tensors if t.dim() == 3]
    if lead and dx0.dim() == 1:
        dx0 = dx0.expand(lead[0], dx0.shape[0])
    leaves, dx0, Bn, batched = batch_leaves(qp, dx0)
    stage = tuple(t if t.dim() == 3 else t.expand(Bn, *t.shape) for t in stage_tensors)
    if any(t.shape[0] != Bn for t in stage):
        raise ValueError(f"the stage tensors' batch sizes {[t.shape[0] for t in stage]} "
                         f"disagree with the QP's {Bn}")
    return BoxedQPData(**leaves), dx0, stage, batched


def barrier_qp_solve(
    qp: BoxedQPData,
    dx0: torch.Tensor,
    num_iters: int = 12,
    mu0: float = 1.0e-1,
    kappa: float = 0.35,
    delta: float = 1.0e-3,
    stiffness: Optional[float] = None,
    h_stiffness: Optional[float] = None,
    h_slope: float = 0.0,
    return_kkt: bool = False,
):
    """Solve the inequality-constrained QP by barrier-Newton/Riccati.

    Each of ``num_iters`` iterations evaluates the relaxed-barrier
    derivatives at the current (δX, δU), folds them into the stage Hessians
    and gradients and takes one exact Riccati Newton step, damped by the
    fraction-to-boundary rule; μ decreases geometrically (μ ← κμ). A final
    condensing roll propagates δx through the linear dynamics with the
    solved δU. ``return_kkt`` also returns the ∞-norm of the last damped
    Newton step, a convergence certificate.

    Unbatched leaves give (δX (N+1, nx), δU (N, nu)[, kkt ()]); with a
    leading batch dimension B on dx0 or on any leaf the results are (B, …)
    and the unbatched leaves are shared."""
    leaves, dx0, _, batched = batch_leaves(qp, dx0)
    qp = BoxedQPData(**leaves)
    Bn, N, nx = qp.A.shape[0], qp.A.shape[1], qp.A.shape[2]
    nu = qp.B.shape[3]
    dtype, dev = qp.A.dtype, qp.A.device
    stiffness, h_stiffness = _stiffnesses(delta, stiffness, h_stiffness)
    eye_x = torch.eye(nx, dtype=dtype, device=dev)

    def member_min(t):
        return torch.amin(t.reshape(Bn, -1), dim=1)

    def ftb(w, dw):
        # max α with w + α·dw ≥ δ/2 for shrinking log-region margins; the
        # double where keeps gradients finite for the margins that do not shrink
        shrink = (dw < 0) & (w > delta)
        denom = torch.where(shrink, torch.clamp_min(-dw, 1e-30), torch.ones_like(dw))
        return member_min(torch.where(shrink, (w - 0.5 * delta) / denom,
                                      torch.full_like(w, math.inf)))

    dX = torch.cat([dx0.unsqueeze(1), torch.zeros((Bn, N, nx), dtype=dtype, device=dev)], dim=1)
    dU = torch.zeros((Bn, N, nu), dtype=dtype, device=dev)
    mus = mu0 * (kappa ** torch.arange(num_iters, dtype=dtype, device=dev))
    step_norm = None
    for it in range(num_iters):
        mu = mus[it]
        wl, wu = qp.lbx + dX, qp.ubx - dX
        _, gl, hl = relaxed_barrier(wl, mu, delta, stiffness)
        _, gu, hu = relaxed_barrier(wu, mu, delta, stiffness)
        wlu, wuu = qp.lbu + dU, qp.ubu - dU
        _, glu, hlu = relaxed_barrier(wlu, mu, delta, stiffness)
        _, guu, huu = relaxed_barrier(wuu, mu, delta, stiffness)

        Qxx = qp.Q + torch.diag_embed(hl + hu)
        qx = qp.qx_base + _mv(qp.Q, dX) + (gl - gu)
        Ruu = qp.R + torch.diag_embed(hlu + huu)
        ru = qp.ru_base + _mv(qp.R, dU) + (glu - guu)
        if qp.S is not None:
            qx = qx + torch.cat([torch.einsum("biuy,biu->biy", qp.S, dU),
                                 torch.zeros((Bn, 1, nx), dtype=dtype, device=dev)], dim=1)
            ru = ru + torch.einsum("biuy,biy->biu", qp.S, dX[:, :-1])
        if qp.Jh is not None:
            wh = qp.h0 + torch.einsum("bihx,bix->bih", qp.Jh, dX)
            _, gh, hh = relaxed_barrier(wh, mu, delta, h_stiffness)
            if h_slope:
                # L1 slack penalty zl·max(0, −h): acados' zl soft-constraint convention
                gh = gh - h_slope * (wh < 0).to(dtype)
            qx = qx + torch.einsum("bihx,bih->bix", qp.Jh, gh)
            Qxx = Qxx + torch.einsum("bihx,bih,bihy->bixy", qp.Jh, hh, qp.Jh)
        # δx₀ is fixed: stage 0 carries no state cost
        Qxx = torch.cat([eye_x.expand(Bn, 1, nx, nx), Qxx[:, 1:]], dim=1)
        qx = torch.cat([torch.zeros((Bn, 1, nx), dtype=dtype, device=dev), qx[:, 1:]], dim=1)

        # Newton step: affine LQR on the residual problem
        c_res = _mv(qp.A, dX[:, :-1]) + _mv(qp.B, dU) + qp.c - dX[:, 1:]
        lqr = LQRData(A=qp.A, B=qp.B, c=c_res, Qxx=Qxx, qx=qx, Ruu=Ruu, ru=ru, S=qp.S)
        ddX, ddU = riccati_solve(lqr, torch.zeros((Bn, nx), dtype=dtype, device=dev))

        # fraction-to-boundary damping (the HPIPM step rule)
        alpha = torch.minimum(torch.minimum(ftb(wl, ddX), ftb(wu, -ddX)),
                              torch.minimum(ftb(wlu, ddU), ftb(wuu, -ddU)))
        if qp.Jh is not None:
            alpha = torch.minimum(alpha, ftb(wh, torch.einsum("bihx,bix->bih", qp.Jh, ddX)))
        alpha = torch.clamp_max(alpha, 1.0).to(dtype)[:, None, None]
        sx, su = alpha * ddX, alpha * ddU
        step_norm = torch.maximum(torch.amax(torch.abs(sx), dim=(1, 2)),
                                  torch.amax(torch.abs(su), dim=(1, 2)))
        dX, dU = dX + sx, dU + su

    # condensing roll: propagate δx exactly through the linear dynamics with
    # the solved δU, removing the residual that damping leaves
    dX = _roll(dU, qp, dx0)
    if step_norm is None:
        step_norm = torch.zeros((Bn,), dtype=dtype, device=dev)
    if not batched:
        dX, dU, step_norm = dX[0], dU[0], step_norm[0]
    if return_kkt:
        return dX, dU, step_norm
    return dX, dU


def condensed_barrier_objective(
    dU: torch.Tensor,
    qp: BoxedQPData,
    dx0: torch.Tensor,
    mu,
    delta: float = 1.0e-3,
    stiffness: Optional[float] = None,
    h_stiffness: Optional[float] = None,
    h_slope: float = 0.0,
) -> torch.Tensor:
    """The condensed (state-eliminated) barrier objective J(δU; qp, δx₀, μ).

    δX is eliminated through the exact linear roll, so ∇_{δU}J = 0 is the
    stationarity condition that :func:`barrier_qp_solve`'s final iterate
    satisfies at its last barrier weight μ: the implicit function that
    :func:`ift_qp_vjp` differentiates. Stage-0 state terms are left out as
    the solver leaves them out (δx₀ is data, not a decision variable); the
    cross term S, the h rows and their L1 slope ``h_slope`` are in.

    ``dU`` (N, nu), dx0 and the leaves may carry a leading batch B (a leaf
    without it is shared); J is then (B,), else a 0-d tensor."""
    stiffness, h_stiffness = _stiffnesses(delta, stiffness, h_stiffness)
    qp, dx0, (dU,), batched = _with_batch(qp, dx0, dU)
    Bn = dU.shape[0]
    dX = _roll(dU, qp, dx0)
    X = dX[:, 1:]

    def bsum(w, stiff):
        return relaxed_barrier(w, mu, delta, stiff)[0].reshape(Bn, -1).sum(1)

    J = (0.5 * torch.einsum("bix,bixy,biy->b", X, qp.Q[:, 1:], X)
         + torch.einsum("bix,bix->b", qp.qx_base[:, 1:], X)
         + 0.5 * torch.einsum("biu,biuv,biv->b", dU, qp.R, dU)
         + torch.einsum("biu,biu->b", qp.ru_base, dU))
    if qp.S is not None:
        J = J + torch.einsum("biu,biuy,biy->b", dU, qp.S, dX[:, :-1])
    J = (J + bsum(qp.lbx[:, 1:] + X, stiffness) + bsum(qp.ubx[:, 1:] - X, stiffness)
         + bsum(qp.lbu + dU, stiffness) + bsum(qp.ubu - dU, stiffness))
    if qp.Jh is not None:
        wh = qp.h0[:, 1:] + torch.einsum("bihx,bix->bih", qp.Jh[:, 1:], X)
        J = J + bsum(wh, h_stiffness)
        if h_slope:
            J = J + h_slope * torch.relu(-wh).reshape(Bn, -1).sum(1)
    return J if batched else J[0]


def barrier_hessian_blocks(
    qp: BoxedQPData,
    dX: torch.Tensor,
    dU: torch.Tensor,
    mu,
    delta: float = 1.0e-3,
    stiffness: Optional[float] = None,
    h_stiffness: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Barrier-augmented stage Hessians (Q̃ (…, N+1, nx, nx), R̃ (…, N, nu,
    nu)) at the iterate (δX, δU).

    The augmentation a Newton step of :func:`barrier_qp_solve` builds (the
    diagonal barrier curvatures of the bounds and JhᵀhhJh of the h rows),
    with stage 0's Q̃ the identity: one Riccati solve against these blocks
    applies (∇²_{δU}J)⁻¹, the one extra solve of :func:`ift_qp_vjp`.
    Batched as :func:`condensed_barrier_objective`."""
    stiffness, h_stiffness = _stiffnesses(delta, stiffness, h_stiffness)
    qp, _, (dX, dU), batched = _with_batch(qp, dX[..., 0, :], dX, dU)
    Bn, nx = dX.shape[0], dX.shape[2]
    _, _, hl = relaxed_barrier(qp.lbx + dX, mu, delta, stiffness)
    _, _, hu = relaxed_barrier(qp.ubx - dX, mu, delta, stiffness)
    Qxx = qp.Q + torch.diag_embed(hl + hu)
    _, _, hlu = relaxed_barrier(qp.lbu + dU, mu, delta, stiffness)
    _, _, huu = relaxed_barrier(qp.ubu - dU, mu, delta, stiffness)
    Ruu = qp.R + torch.diag_embed(hlu + huu)
    if qp.Jh is not None:
        wh = qp.h0 + torch.einsum("bihx,bix->bih", qp.Jh, dX)
        _, _, hh = relaxed_barrier(wh, mu, delta, h_stiffness)
        Qxx = Qxx + torch.einsum("bihx,bih,bihy->bixy", qp.Jh, hh, qp.Jh)
    eye = torch.eye(nx, dtype=Qxx.dtype, device=Qxx.device).expand(Bn, 1, nx, nx)
    Qxx = torch.cat([eye, Qxx[:, 1:]], dim=1)
    return (Qxx, Ruu) if batched else (Qxx[0], Ruu[0])


def ift_qp_vjp(
    qp: BoxedQPData,
    dx0: torch.Tensor,
    dX: torch.Tensor,
    dU: torch.Tensor,
    ct_X: torch.Tensor,
    ct_U: torch.Tensor,
    num_iters: int = 12,
    mu0: float = 1.0e-1,
    kappa: float = 0.35,
    delta: float = 1.0e-3,
    stiffness: Optional[float] = None,
    h_stiffness: Optional[float] = None,
    h_slope: float = 0.0,
) -> Tuple[BoxedQPData, torch.Tensor]:
    """Implicit-function-theorem VJP of the barrier QP at its solution:
    (q̄p, δx̄₀), each leaf's cotangent in that leaf's shape (None for an
    absent leaf; a shared leaf's summed over the batch).

    δU*(θ) solves ∇_{δU}J(δU; θ, μ_f) = 0 at the last barrier weight
    μ_f = μ₀·κ^(iters−1), as the fused kernel's schedule computes it in
    float32 (``qp_schedule``), and δX = roll(δU*, θ). Given the cotangents
    (c̄ₓ, c̄ᵤ) of (δX, δU):

      1. pull c̄ₓ back through the roll: a direct θ̄ term and an extra δU
         cotangent;
      2. one adjoint Riccati solve y = (∇²_{δU}J)⁻¹c̄ᵤᵗᵒᵗ against the
         barrier-augmented Hessians at the solution (c = 0, qx = 0,
         ru = −c̄ᵤᵗᵒᵗ, the same S, δx₀ = 0);
      3. θ̄ −= (∂²J/∂θ∂δU)ᵀy, one VJP of the stationarity residual ∇_{δU}J.

    δ, the stiffness, the h stiffness and ``h_slope`` must be the forward's:
    with other values this is the gradient of another barrier. Exact for a
    converged solve. Every product runs in full float32 on the card, and
    nothing in it waits for the card (the μ schedule is the one the forward
    copied there). The leaves, dx0, δX, δU and the
    cotangents may carry a leading batch B, as in
    :func:`condensed_barrier_objective`."""
    dtype, dev = qp.A.dtype, qp.A.device
    mu_f = qp_schedule(num_iters, mu0, kappa, delta, stiffness, h_stiffness, h_slope,
                       dev)[0][-1].to(dtype)
    kw = dict(delta=delta, stiffness=stiffness, h_stiffness=h_stiffness)
    names = BoxedQPData._fields
    with torch.enable_grad(), full_f32():
        src = BoxedQPData(*(None if t is None else t.detach().requires_grad_() for t in qp))
        x0_src = dx0.detach().requires_grad_()
        stage = (t.detach().to(dtype) for t in (dX, dU, ct_X, ct_U))
        qpb, x0b, (dXb, dUb, cXb, cUb), _ = _with_batch(src, x0_src, *stage)
        Bn, N, nx = qpb.A.shape[0], qpb.A.shape[1], qpb.A.shape[2]

        # 1. the roll's VJP
        dU_roll = dUb.detach().requires_grad_()
        roll_in = (dU_roll, src.A, src.B, src.c, x0_src)
        bar_dU, bar_A, bar_B, bar_c, bar_x0 = torch.autograd.grad(
            _roll(dU_roll, qpb, x0b), roll_in, cXb, retain_graph=True)

        # 2. the adjoint solve on the barrier-augmented blocks
        with torch.no_grad():
            Qxx, Ruu = barrier_hessian_blocks(qpb, dXb, dUb, mu_f, **kw)
            adj = LQRData(A=qpb.A, B=qpb.B, c=torch.zeros_like(qpb.c), Qxx=Qxx,
                          qx=torch.zeros((Bn, N + 1, nx), dtype=dtype, device=dev), Ruu=Ruu,
                          ru=-(cUb + bar_dU), S=qpb.S)
            _, y = riccati_solve(adj, torch.zeros((Bn, nx), dtype=dtype, device=dev))

        # 3. the stationarity residual's VJP at −y, δU held at the solution
        dU_stat = dUb.detach().requires_grad_()
        J = condensed_barrier_objective(dU_stat, qpb, x0b, mu_f, h_slope=h_slope, **kw)
        (resid,) = torch.autograd.grad(J.sum(), dU_stat, create_graph=True)
        present = [n for n in names if getattr(src, n) is not None]
        bars = torch.autograd.grad(resid, [getattr(src, n) for n in present] + [x0_src], -y,
                                   allow_unused=True)
    roll = dict(A=bar_A, B=bar_B, c=bar_c)
    out = {n: None for n in names}
    for n, g in zip(present, bars):
        leaf = getattr(src, n)
        g = torch.zeros_like(leaf) if g is None else g
        out[n] = g + roll[n] if n in roll else g
    g_x0 = bars[-1]
    bar_x0 = bar_x0 if g_x0 is None else bar_x0 + g_x0
    return BoxedQPData(**out), bar_x0


__all__ = [
    "BoxedQPData",
    "LQRData",
    "barrier_hessian_blocks",
    "barrier_qp_solve",
    "condensed_barrier_objective",
    "ift_qp_vjp",
    "relaxed_barrier",
    "riccati_solve",
]
