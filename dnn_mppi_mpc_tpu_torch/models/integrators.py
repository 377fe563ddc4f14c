"""Integrators (counterpart of ``dnn_mppi_mpc_tpu/models/integrators.py``).

All are pure (no in-place op, no ``.item()``) and broadcast over leading
batch dims, so ``torch.func`` transforms go through them when the SQP engine
linearizes its shooting intervals.

Jacobians are taken with ``torch.func.jacrev``, where the JAX package uses
``jax.jacfwd``: in the installed PyTorch (2.11 to 2.13), forward mode gives
the tangent of a 0-d float32 tensor combined with a Python scalar (``x[2] /
2.0``, as the vehicle models write it) the dtype float64, and the next
matrix product of float32 primals with float64 tangents raises. Reverse
mode gives the same Jacobian in the inputs' dtype.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import torch
from torch.func import jacrev, vmap

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def euler_step(f: Dynamics, x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """Forward-Euler step, the MPPI rollout integrator."""
    return x + f(x, u) * dt


def rk4_step(f: Dynamics, x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """Classic RK4 step."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def erk_step(
    f: Dynamics, x: torch.Tensor, u: torch.Tensor, dt: float, num_steps: int = 3
) -> torch.Tensor:
    """RK4 with ``num_steps`` substeps over one control interval: acados' ERK
    with 4 stages and 3 steps, the NMPC engine's default integrator."""
    h = dt / num_steps
    for _ in range(num_steps):
        x = rk4_step(f, x, u, h)
    return x


def _gauss_legendre_tableau(num_stages: int):
    """Collocation Butcher tableau (c, A, b) on the Gauss-Legendre nodes, in
    float64 numpy: a_ij = ∫₀^{c_i} ℓ_j, b_j = ∫₀¹ ℓ_j with ℓ_j the Lagrange
    basis on the shifted Legendre roots."""
    nodes, _ = np.polynomial.legendre.leggauss(num_stages)
    c = 0.5 * (nodes + 1.0)  # [-1,1] → [0,1]
    A = np.zeros((num_stages, num_stages))
    b = np.zeros(num_stages)
    for j in range(num_stages):
        lj = np.poly1d([1.0])
        for m in range(num_stages):
            if m != j:
                lj = lj * np.poly1d([1.0, -c[m]]) / (c[j] - c[m])
        integ = lj.integ()
        b[j] = integ(1.0) - integ(0.0)
        for i in range(num_stages):
            A[i, j] = integ(c[i]) - integ(0.0)
    return c, A, b


@lru_cache(maxsize=None)
def _tableau_tensors(num_stages: int, dtype: torch.dtype, device: torch.device):
    """(A, b) of the tableau on ``device``, copied there once (a copy from
    the host waits for the card, so it is not made on every step)."""
    _, A, b = _gauss_legendre_tableau(num_stages)
    return (torch.as_tensor(A, dtype=dtype).to(device),
            torch.as_tensor(b, dtype=dtype).to(device))


def irk_step(
    f: Dynamics,
    x: torch.Tensor,
    u: torch.Tensor,
    dt: float,
    num_stages: int = 4,
    num_steps: int = 3,
    newton_iters: int = 3,
) -> torch.Tensor:
    """Implicit Runge-Kutta (Gauss-Legendre collocation) step, acados' IRK
    with 4 stages and 3 steps: A-stable, so stiff torque and tire dynamics
    stay bounded at the control rate.

    The stage equations K_i = f(x + hΣ_j a_ij K_j, u) are solved by
    ``newton_iters`` full Newton steps on the stacked (s·nx) system, with the
    Jacobian from ``torch.func.jacrev`` and ``torch.linalg.solve_ex`` (which,
    unlike ``solve``, makes no singular-matrix check that waits for the card;
    the library's small batched solve still synchronises on the card, about
    18 times a four-wheel SQP tick, which ``chip_smoke.py`` counts). A batch
    of states is flattened and vmapped over."""
    if x.dim() > 1:
        batch = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1])
        uf = u.expand(*batch, u.shape[-1]).reshape(-1, u.shape[-1])
        out = vmap(lambda xi, ui: irk_step(f, xi, ui, dt, num_stages, num_steps,
                                           newton_iters))(xf, uf)
        return out.reshape(x.shape)

    A, b = _tableau_tensors(num_stages, x.dtype, x.device)
    nx = x.shape[-1]
    s = num_stages
    h = dt / num_steps
    eye = torch.eye(s * nx, dtype=x.dtype, device=x.device)

    def f_aux(q):
        out = f(q, u)
        return out, out

    def substep(x):
        K = f(x, u).expand(s, nx)  # explicit-Euler stage init
        for _ in range(newton_iters):
            X_st = x[None, :] + h * (A @ K)  # (s, nx) stage states
            J, F = vmap(jacrev(f_aux, has_aux=True))(X_st)
            # ∂r_i/∂K_j = δ_ij I − h·a_ij·J_i  with r = K − F
            M = eye - h * (A[:, :, None, None] * J[:, None, :, :]).permute(0, 2, 1, 3).reshape(
                s * nx, s * nx)
            r = (K - F).reshape(s * nx)
            dK = torch.linalg.solve_ex(M, -r, check_errors=False)[0]
            K = K + dK.reshape(s, nx)
        return x + h * (b @ K)

    for _ in range(num_steps):
        x = substep(x)
    return x


def discretize(
    f: Dynamics,
    dt: float,
    method: str = "euler",
    num_steps: int = 1,
    num_stages: int = 4,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """A discrete transition ``F(x, u) -> x_next`` by ``method`` ('euler',
    'rk4', 'erk' or 'irk'; ``num_stages`` is the IRK collocation order)."""
    if method == "euler":
        return lambda x, u: euler_step(f, x, u, dt)
    if method == "rk4":
        return lambda x, u: rk4_step(f, x, u, dt)
    if method == "erk":
        return lambda x, u: erk_step(f, x, u, dt, num_steps=num_steps)
    if method == "irk":
        return lambda x, u: irk_step(f, x, u, dt, num_stages=num_stages, num_steps=num_steps)
    raise ValueError(f"unknown integrator method: {method!r}")


def rollout(
    step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    u_seq: torch.Tensor,
) -> torch.Tensor:
    """Roll a discrete transition over ``u_seq`` (T, ..., dim_u), time
    leading; returns the (T, ..., dim_x) visited states x1..xT."""
    xs = []
    x = x0
    for t in range(u_seq.shape[0]):
        x = step(x, u_seq[t])
        xs.append(x)
    return torch.stack(xs)


__all__ = ["euler_step", "rk4_step", "erk_step", "irk_step", "discretize", "rollout"]
