"""The fused barrier-Riccati QP: the whole relaxed-barrier QP of one NMPC
linearization in one launch.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/riccati_qp.py``. Both TPU
kernels map to one CUDA kernel, ``dmm_barrier_qp`` (csrc/riccati_qp.cu), with
one warp per problem:

* :func:`fused_barrier_qp_solve` (``:493 pallas_barrier_qp_solve``) solves
  one problem, the SQP tick's QP: the kernel at B = 1, one warp;
* :func:`batched_fused_barrier_qp_solve` (``:582
  pallas_batched_barrier_qp_solve`` and ``:706``'s batching rule) solves B
  independent problems of a fleet in one launch, a block (one warp) a
  problem; a leaf given without the leading B is shared by all members.

The warp copies its problem's tables into shared memory once and keeps the
Newton iterate, the step, the gains and the folded stage terms there: the
stage-parallel parts of a Newton iteration (the barrier folds, the dynamics
residual, the step bound and the update) run one stage a lane, the Riccati
recursion's products and back substitution are spread over the lanes with
shuffles, and only the forward sweep and the final roll run on one lane.
The tables are read where they lie, problem-major (:func:`kernel_tables`):
a leaf whose last dimension is contiguous is passed as it is, with its
problem, stage and row strides (0 for a shared leaf or a stage-invariant
one; nx + nu for the linearization's A and B, column blocks of one
Jacobian), and the outputs are written (B, N+1, nx), (B, N, nu) and (B,).

The horizon is bounded by shared memory: a problem takes (N + 1) stage
records of :func:`qp_stage_floats` floats, and one block may hold 227 KB
(232 448 bytes), so N ≤ :func:`qp_max_horizon` (nx, nu, n_h, S): 234 at
(5, 4) with two h rows and S, 637 at (3, 2) with two h rows, 1 416 at
(2, 1) without; every instantiated (nx, nu) takes N = 100 with two h rows
and S. A longer horizon raises ``ValueError`` before the launch, naming the
largest N.

On CUDA tensors each launches the kernel; on CPU tensors each runs its plain
version, the same algorithm in plain PyTorch in the kernel's order of
operations, with the problems on a leading B axis (a member's scalar of the
kernel is one element of a (B, …) tensor op; loops over matrix dimensions
run over the contraction index only, adding terms in the kernel's order).
Nothing falls back: on the card a shape the kernel was not instantiated for
raises ``ValueError``. Everything runs in float32, as in the JAX kernels.

The kernel is invisible to autograd, so an input that requires grad raises
``ValueError``: the implicit-function-theorem backward of the JAX package
(``solvers/qp.py ift_qp_vjp``) comes with a later slice. Until then the
differentiable route is the torch QP backend
(``NMPCSolver.solve_fn(differentiable=True)``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..._build import QP_TABLES, DmmQPArgs, launch
from ..sampling import small_lu_solve
from .common import MAX_SMEM_OPT_IN, on_cuda

# (nx, nu) pairs csrc/riccati_qp.cu instantiates
SUPPORTED_DIMS = tuple((nx, nu) for nx in range(2, 6) for nu in range(1, min(nx, 4) + 1))
_INF = 3.0e38
# the BoxedQPData leaves (solvers/qp.py) and each one's rank without a batch
QP_LEAF_NDIM = dict(A=3, B=3, c=2, Q=3, qx_base=2, R=3, ru_base=2, lbx=2, ubx=2, lbu=2, ubu=2,
                    Jh=3, h0=2, S=3)
# the kernel's stage tables, in the order of DmmQPArgs::tab (csrc/riccati_qp.cu);
# dx0 follows them
TABLES = ("A", "B", "c", "Q", "qx_base", "R", "ru_base", "lbx", "ubx", "lbu", "ubu", "Jh", "h0",
          "S")


@lru_cache(maxsize=None)
def qp_schedule(num_iters: int, mu0: float, kappa: float, delta: float,
                stiffness: Optional[float], h_stiffness: Optional[float], h_slope: float,
                device: torch.device):
    """(mus (num_iters,), misc (5,)) float32 on ``device``: the barrier
    weights μ₀·κⁱ and (δ, bound stiffness, h stiffness, h slope, the Luu
    regularisation 1e-9), with the stiffness 1/δ² unless given and the h
    stiffness the bound stiffness unless given. Made on the host and copied
    to ``device`` once per setting: the copy waits for the card, so a tick
    must not make it."""
    f = np.float32
    mus = f(mu0) * (f(kappa) ** np.arange(num_iters, dtype=f))
    if stiffness is None:
        stiffness = 1.0 / (delta * delta)
    if h_stiffness is None:
        h_stiffness = stiffness
    misc = np.array([delta, stiffness, h_stiffness, h_slope, 1e-9], dtype=f)
    return (torch.from_numpy(np.ascontiguousarray(mus, dtype=f)).to(device),
            torch.from_numpy(misc).to(device))


def _reject_grad(qp, dx0) -> None:
    tensors = [dx0] + [getattr(qp, name) for name in QP_LEAF_NDIM]
    if any(t is not None and t.requires_grad for t in tensors):
        raise ValueError(
            "the fused QP kernel has no backward yet (the implicit-function-theorem "
            "backward comes in a later slice): use the torch QP backend, e.g. "
            "NMPCSolver.solve_fn(differentiable=True), to differentiate the solve"
        )


def batch_leaves(qp, dx0: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """The leaves of ``qp`` (a dict by field name) and dx0, each with a
    leading batch dimension B, in ``dtype`` when given; returns (leaves,
    dx0, B, batched).

    B is the leading size of the leaves that carry one (dx0 (B, nx) among
    them); a leaf without it is broadcast, as the JAX kernel's batching rule
    does. With no batched leaf every leaf gets a batch of one and
    ``batched`` is False."""
    sizes = {getattr(qp, n).shape[0] for n, nd in QP_LEAF_NDIM.items()
             if getattr(qp, n) is not None and getattr(qp, n).dim() == nd + 1}
    if dx0.dim() == 2:
        sizes.add(dx0.shape[0])
    if len(sizes) > 1:
        raise ValueError(f"the batched QP leaves disagree on the batch size: {sorted(sizes)}")
    batched = bool(sizes)
    B = sizes.pop() if batched else 1

    def lead(t, ndim, name):
        if t is None:
            return None
        if dtype is not None:
            t = t.to(dtype)
        if t.dim() == ndim:
            return t.expand(B, *t.shape)
        if t.dim() != ndim + 1:
            raise ValueError(f"{name} has rank {t.dim()}, expected {ndim} or {ndim + 1}")
        return t

    leaves = {n: lead(getattr(qp, n), nd, n) for n, nd in QP_LEAF_NDIM.items()}
    return leaves, lead(dx0, 1, "dx0"), B, batched


def _check_dims(N, nx, nu, n_h, leaves, B, num_iters) -> None:
    if (nx, nu) not in SUPPORTED_DIMS:
        raise ValueError(
            f"the fused QP kernel is instantiated for (nx, nu) in {list(SUPPORTED_DIMS)}; "
            f"got ({nx}, {nu})")
    if num_iters < 1:
        raise ValueError(f"num_iters must be at least 1, got {num_iters}")
    shapes = dict(A=(N, nx, nx), B=(N, nx, nu), c=(N, nx), Q=(N + 1, nx, nx),
                  qx_base=(N + 1, nx), R=(N, nu, nu), ru_base=(N, nu), lbx=(N + 1, nx),
                  ubx=(N + 1, nx), lbu=(N, nu), ubu=(N, nu), Jh=(N + 1, n_h, nx),
                  h0=(N + 1, n_h), S=(N, nu, nx))
    for name, shape in shapes.items():
        t = leaves[name]
        if t is not None and tuple(t.shape) != (B,) + shape:
            raise ValueError(f"{name} must have shape {(B,) + shape}, got {tuple(t.shape)}")
    if (leaves["Jh"] is None) != (leaves["h0"] is None):
        raise ValueError("Jh and h0 must be given together")


# ---------------------------------------------------------------------------
# plain PyTorch version (the kernel body's algorithm, problems on axis 0)
# ---------------------------------------------------------------------------


def _mm(X, Y):
    """Σ_k X[:, r, k]·Y[:, k, c], terms added in k order (the kernel's sums)."""
    s = X[:, :, 0:1] * Y[:, 0:1, :]
    for e in range(1, X.shape[2]):
        s = s + X[:, :, e:e + 1] * Y[:, e:e + 1, :]
    return s


def _mv(X, v):
    """Σ_k X[:, r, k]·v[:, k], terms added in k order."""
    s = X[:, :, 0] * v[:, 0:1]
    for e in range(1, X.shape[2]):
        s = s + X[:, :, e] * v[:, e:e + 1]
    return s


def _qp_plain(L, dx0, mus, misc, num_iters: int):
    """The kernel body on (B, …) float32 leaves ``L``; returns (δX (B, N+1,
    nx), δU (B, N, nu), kkt (B,))."""
    A, Bm_all, c = L["A"], L["B"], L["c"]
    Bn, N, nx = A.shape[0], A.shape[1], A.shape[2]
    nu = Bm_all.shape[3]
    Jh, h0, S = L["Jh"], L["h0"], L["S"]
    n_h = 0 if Jh is None else Jh.shape[2]
    dev = A.device
    delta, stiff, h_stiff, h_slope, reg = misc[0], misc[1], misc[2], misc[3], misc[4]
    neg_mu_delta = None
    eye_u = torch.eye(nu, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    def rb(w, mu, kappa):
        use_log = w > delta
        ws = torch.maximum(w, delta)
        g = torch.where(use_log, -mu / ws, neg_mu_delta - kappa * (delta - w))
        h = torch.where(use_log, mu / (ws * ws), kappa.expand_as(w))
        return g, h

    def fold_x(dX, i, mu):
        dXi = dX[:, i]
        Qxx = L["Q"][:, i]
        q = L["qx_base"][:, i] + _mv(Qxx, dXi)
        gl, hl = rb(L["lbx"][:, i] + dXi, mu, stiff)
        gu, hu = rb(L["ubx"][:, i] - dXi, mu, stiff)
        q = q + gl - gu
        Qxx = Qxx + torch.diag_embed(hl) + torch.diag_embed(hu)
        for r in range(n_h):
            Jr = Jh[:, i, r]
            wh = h0[:, i, r] + _mv(Jr[:, None, :], dXi)[:, 0]
            gh, hh = rb(wh, mu, h_stiff)
            gh = gh - h_slope * torch.where(wh < 0, one, torch.zeros_like(one))
            q = q + Jr * gh[:, None]
            Qxx = Qxx + (Jr[:, :, None] * hh[:, None, None]) * Jr[:, None, :]
        return Qxx, q, dXi

    dX = torch.cat([dx0[:, None], torch.zeros((Bn, N, nx), device=dev)], dim=1)
    dU = torch.zeros((Bn, N, nu), device=dev)
    kkt = None
    for it in range(num_iters):
        mu = mus[it]
        neg_mu_delta = -mu / delta
        P, p, _ = fold_x(dX, N, mu)
        Ks, ks, cres = [None] * N, [None] * N, [None] * N
        for i in reversed(range(N)):
            Qxx, q, dXi = fold_x(dX, i, mu)
            dUi = dU[:, i]
            Ruu = L["R"][:, i]
            r_u = L["ru_base"][:, i] + _mv(Ruu, dUi)
            gl, hl = rb(L["lbu"][:, i] + dUi, mu, stiff)
            gu, hu = rb(L["ubu"][:, i] - dUi, mu, stiff)
            r_u = r_u + gl - gu
            Ruu = Ruu + torch.diag_embed(hl) + torch.diag_embed(hu)
            if S is not None:
                Sm = S[:, i]
                q = q + _mv(Sm.transpose(1, 2), dUi)
                r_u = r_u + _mv(Sm, dXi)
            else:
                Sm = torch.zeros((Bn, nu, nx), device=dev)
            Am, Bm = A[:, i], Bm_all[:, i]
            cr = _mv(Am, dXi) + _mv(Bm, dUi) + c[:, i] - dX[:, i + 1]
            cres[i] = cr
            PA, PB, Pc = _mm(P, Am), _mm(P, Bm), _mv(P, cr)
            Bt = Bm.transpose(1, 2)
            Lraw = Ruu + _mm(Bt, PB)
            Luu = 0.5 * (Lraw + Lraw.transpose(1, 2)) + reg * eye_u
            Lux = Sm + _mm(Bt, PA)
            lu = r_u + _mv(Bt, p + Pc)
            # the kernel's pivoted LU: the same bubbling, 1/pivot and order (columns
            # left of the pivot, which the kernel skips, are never read again)
            sol = small_lu_solve(Luu, torch.cat([Lux, lu[:, :, None]], dim=2))
            Kg, kg = -sol[:, :, :nx], -sol[:, :, nx]
            Ks[i], ks[i] = Kg, kg
            Lt = Lux.transpose(1, 2)
            At = Am.transpose(1, 2)
            Pn = Qxx + _mm(At, PA) + _mm(Lt, Kg)
            p = q + _mv(At, p + Pc) + _mv(Lt, kg)
            P = 0.5 * (Pn + Pn.transpose(1, 2))

        # forward sweep on the residual problem (ddx₀ = 0)
        ddx = torch.zeros((Bn, nx), device=dev)
        ddX, ddU = [ddx], []
        for i in range(N):
            ddu = ks[i] + _mv(Ks[i], ddx)
            ddx = _mv(A[:, i], ddx) + _mv(Bm_all[:, i], ddu) + cres[i]
            ddU.append(ddu)
            ddX.append(ddx)
        ddX, ddU = torch.stack(ddX, dim=1), torch.stack(ddU, dim=1)

        # fraction-to-boundary damping: the smallest bound over every margin
        def ftb(w, dw):
            shrink = (dw < 0) & (w > delta)
            a = (w - 0.5 * delta) / torch.clamp_min(-dw, 1e-30)
            return torch.amin(torch.where(shrink, a, torch.full_like(a, _INF)).reshape(Bn, -1),
                              dim=1)

        cands = [ftb(L["lbx"] + dX, ddX), ftb(L["ubx"] - dX, -ddX),
                 ftb(L["lbu"] + dU, ddU), ftb(L["ubu"] - dU, -ddU)]
        if n_h:
            wh = h0
            dwh = Jh[..., 0] * ddX[:, :, None, 0]
            for d in range(nx):
                wh = wh + Jh[..., d] * dX[:, :, None, d]
                if d:
                    dwh = dwh + Jh[..., d] * ddX[:, :, None, d]
            cands.append(ftb(wh, dwh))
        amin = torch.stack(cands, dim=1).amin(dim=1)
        alpha = torch.minimum(one, amin)[:, None, None]

        sx, su = alpha * ddX, alpha * ddU
        dX, dU = dX + sx, dU + su
        kkt = torch.maximum(torch.abs(sx).reshape(Bn, -1).amax(dim=1),
                            torch.abs(su).reshape(Bn, -1).amax(dim=1))

    # condensing roll
    dx = dx0
    xs = [dx]
    for i in range(N):
        dx = _mv(A[:, i], dx) + _mv(Bm_all[:, i], dU[:, i]) + c[:, i]
        xs.append(dx)
    return torch.stack(xs, dim=1), dU, kkt


def _plain(qp, dx0, num_iters, mu0, kappa, delta, stiffness, h_stiffness, h_slope):
    leaves, dx0, _, _ = batch_leaves(qp, dx0, torch.float32)
    if num_iters < 1:
        raise ValueError(f"num_iters must be at least 1, got {num_iters}")
    mus, misc = qp_schedule(num_iters, mu0, kappa, delta, stiffness, h_stiffness, h_slope,
                            dx0.device)
    return _qp_plain(leaves, dx0, mus, misc, num_iters)


def fused_barrier_qp_solve_plain(qp, dx0, num_iters: int = 12, mu0: float = 1.0e-1,
                                 kappa: float = 0.35, delta: float = 1.0e-3,
                                 stiffness: Optional[float] = None,
                                 h_stiffness: Optional[float] = None, h_slope: float = 0.0):
    """Plain PyTorch version of :func:`fused_barrier_qp_solve`."""
    fused_barrier_qp_solve_plain.calls += 1
    dX, dU, kkt = _plain(qp, dx0, num_iters, mu0, kappa, delta, stiffness, h_stiffness,
                         h_slope)
    return dX[0], dU[0], kkt[0]


fused_barrier_qp_solve_plain.calls = 0


def batched_fused_barrier_qp_solve_plain(qp, dx0, num_iters: int = 12, mu0: float = 1.0e-1,
                                         kappa: float = 0.35, delta: float = 1.0e-3,
                                         stiffness: Optional[float] = None,
                                         h_stiffness: Optional[float] = None,
                                         h_slope: float = 0.0):
    """Plain PyTorch version of :func:`batched_fused_barrier_qp_solve`."""
    batched_fused_barrier_qp_solve_plain.calls += 1
    return _plain(qp, dx0, num_iters, mu0, kappa, delta, stiffness, h_stiffness, h_slope)


batched_fused_barrier_qp_solve_plain.calls = 0


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def qp_stage_floats(nx: int, nu: int, n_h: int, has_S: bool) -> int:
    """Floats of one stage record in the kernel's shared memory (``Rec`` and
    ``stage_floats`` in csrc/riccati_qp.cu): the tables (A, B, c, Q, qx, R,
    ru, the four margins), the iterate, the step, the gains K and k, the
    residual, the folded Qxx, q, Ruu and r_u, then the h rows and S; rounded
    up to an odd count so that 32 lanes on 32 stages hit 32 banks."""
    fixed = 3 * nx * nx + 8 * nx + 2 * nx * nu + 2 * nu * nu + 7 * nu
    return (fixed + n_h * (nx + 1) + (nu * nx if has_S else 0)) | 1


def qp_smem_bytes(N: int, nx: int, nu: int, n_h: int, has_S: bool) -> int:
    """Dynamic shared memory of one block (one problem)."""
    return 4 * (N + 1) * qp_stage_floats(nx, nu, n_h, has_S)


def qp_max_horizon(nx: int, nu: int, n_h: int, has_S: bool) -> int:
    """The largest N whose problem fits in one block's shared memory."""
    return MAX_SMEM_OPT_IN // (4 * qp_stage_floats(nx, nu, n_h, has_S)) - 1


def check_horizon(N: int, nx: int, nu: int, n_h: int, has_S: bool) -> None:
    """Raise ``ValueError`` unless one problem of horizon N fits in a block's
    shared memory (the check before every launch)."""
    need = qp_smem_bytes(N, nx, nu, n_h, has_S)
    if need > MAX_SMEM_OPT_IN:
        raise ValueError(
            f"the fused QP kernel keeps a problem's N + 1 stage records in shared memory: "
            f"N = {N} at (nx, nu) = ({nx}, {nu}) with n_h = {n_h}{' and S' if has_S else ''} "
            f"needs {need} bytes, over the {MAX_SMEM_OPT_IN} a block may have; the largest N "
            f"for this shape is {qp_max_horizon(nx, nu, n_h, has_S)}")


def _table(t: torch.Tensor):
    # the kernel reads a stage as rows of contiguous elements: a leaf whose
    # last dimension is strided (a transposed one) is copied, any other passed
    # as it lies
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        t = t.contiguous()
    return t, t.stride(0), t.stride(1), t.stride(2) if t.dim() == 4 else 0


def kernel_tables(leaves: dict, dx0: torch.Tensor) -> list:
    """The kernel's tables of (B, …) leaves (``batch_leaves``) and dx0 (B,
    nx): for each of ``TABLES`` and then dx0, (tensor, problem stride, stage
    stride, row stride) in floats, or (None, 0, 0, 0) for an absent leaf.
    Element (row, col) of problem b's stage i of a table lies b·(problem
    stride) + i·(stage stride) + row·(row stride) + col floats into the
    tensor: problem-major. A leaf is passed as it lies, a view and no copy,
    wherever its last dimension is contiguous: contiguous leaves, leaves
    shared by all problems (problem stride 0), stage-invariant ones (stage
    stride 0, the fleet's R) and column blocks of a wider matrix (the
    linearization's A and B, row stride nx + nu)."""
    out = [(None, 0, 0, 0) if leaves[n] is None else _table(leaves[n]) for n in TABLES]
    out.append(_table(dx0[:, None]))
    return out


def _launch(leaves, dx0, B, num_iters, mu0, kappa, delta, stiffness, h_stiffness, h_slope):
    """Launch ``dmm_barrier_qp`` on (B, …) leaves, B blocks of one warp;
    returns the (B, N+1, nx), (B, N, nu) and (B,) outputs."""
    A = leaves["A"]
    N, nx, nu = A.shape[1], A.shape[2], leaves["B"].shape[3]
    n_h = 0 if leaves["Jh"] is None else leaves["Jh"].shape[2]
    has_S = leaves["S"] is not None
    _check_dims(N, nx, nu, n_h, leaves, B, num_iters)
    check_horizon(N, nx, nu, n_h, has_S)
    dev = dx0.device
    mus, misc = qp_schedule(num_iters, mu0, kappa, delta, stiffness, h_stiffness, h_slope, dev)
    tabs = kernel_tables(leaves, dx0)
    dX = torch.empty((B, N + 1, nx), dtype=torch.float32, device=dev)
    dU = torch.empty((B, N, nu), dtype=torch.float32, device=dev)
    kkt = torch.empty((B,), dtype=torch.float32, device=dev)
    args = DmmQPArgs(
        mus=mus.data_ptr(), misc=misc.data_ptr(), dX=dX.data_ptr(), dU=dU.data_ptr(),
        kkt=kkt.data_ptr(), Bn=B, N=N, nx=nx, nu=nu, n_h=n_h, num_iters=num_iters,
        has_S=int(has_S), stage_floats=qp_stage_floats(nx, nu, n_h, has_S),
    )
    assert len(tabs) == QP_TABLES
    for j, (t, b_stride, s_stride, r_stride) in enumerate(tabs):
        args.tab[j] = None if t is None else t.data_ptr()
        args.b_stride[j], args.s_stride[j], args.r_stride[j] = b_stride, s_stride, r_stride
    # a table copied above is freed when this returns, to the caching
    # allocator, which hands its memory only to work queued after this launch
    # on its stream
    launch("dmm_barrier_qp", args, dev)
    return dX, dU, kkt


def _on_card(qp, dx0) -> bool:
    return on_cuda(dx0, **{n: getattr(qp, n) for n in QP_LEAF_NDIM})


def fused_barrier_qp_solve(qp, dx0: torch.Tensor, num_iters: int = 12, mu0: float = 1.0e-1,
                           kappa: float = 0.35, delta: float = 1.0e-3,
                           stiffness: Optional[float] = None,
                           h_stiffness: Optional[float] = None, h_slope: float = 0.0):
    """Solve one relaxed-barrier QP (``solvers.qp.BoxedQPData`` leaves
    without a batch dimension, dx0 (nx,)) in one launch: (δX (N+1, nx),
    δU (N, nu), kkt ()), float32. ``stiffness`` defaults to 1/δ² and
    ``h_stiffness`` to ``stiffness``; ``h_slope`` is the L1 slope of the
    soft h rows. N is bounded by shared memory (:func:`qp_max_horizon`;
    ``ValueError`` beyond it)."""
    _reject_grad(qp, dx0)
    if dx0.dim() != 1 or qp.A.dim() != 3:
        raise ValueError("fused_barrier_qp_solve takes one problem (dx0 (nx,), A (N, nx, nx)); "
                         "use batched_fused_barrier_qp_solve for a fleet")
    if not _on_card(qp, dx0):
        return fused_barrier_qp_solve_plain(qp, dx0, num_iters, mu0, kappa, delta, stiffness,
                                            h_stiffness, h_slope)
    leaves, x0, _, _ = batch_leaves(qp, dx0, torch.float32)
    dX, dU, kkt = _launch(leaves, x0, 1, num_iters, mu0, kappa, delta, stiffness, h_stiffness,
                          h_slope)
    fused_barrier_qp_solve.launches += 1
    return dX[0], dU[0], kkt[0]


fused_barrier_qp_solve.launches = 0


def batched_fused_barrier_qp_solve(qp, dx0: torch.Tensor, num_iters: int = 12,
                                   mu0: float = 1.0e-1, kappa: float = 0.35,
                                   delta: float = 1.0e-3, stiffness: Optional[float] = None,
                                   h_stiffness: Optional[float] = None, h_slope: float = 0.0):
    """Solve B independent relaxed-barrier QPs in one launch, one warp per
    problem: (δX (B, N+1, nx), δU (B, N, nu), kkt (B,)), float32. Every leaf
    (and dx0) carries a leading B or is shared by all members; member b's
    result is the per-problem solve of member b's problem. N is bounded by
    shared memory (:func:`qp_max_horizon`; ``ValueError`` beyond it)."""
    _reject_grad(qp, dx0)
    if not _on_card(qp, dx0):
        return batched_fused_barrier_qp_solve_plain(qp, dx0, num_iters, mu0, kappa, delta,
                                                    stiffness, h_stiffness, h_slope)
    leaves, x0, B, _ = batch_leaves(qp, dx0, torch.float32)
    dX, dU, kkt = _launch(leaves, x0, B, num_iters, mu0, kappa, delta, stiffness, h_stiffness,
                          h_slope)
    batched_fused_barrier_qp_solve.launches += 1
    return dX, dU, kkt


batched_fused_barrier_qp_solve.launches = 0

__all__ = [
    "QP_LEAF_NDIM",
    "SUPPORTED_DIMS",
    "TABLES",
    "batch_leaves",
    "batched_fused_barrier_qp_solve",
    "batched_fused_barrier_qp_solve_plain",
    "check_horizon",
    "fused_barrier_qp_solve",
    "fused_barrier_qp_solve_plain",
    "kernel_tables",
    "qp_max_horizon",
    "qp_schedule",
    "qp_smem_bytes",
    "qp_stage_floats",
]
