"""Control-noise sampling, tiny SPD factorizations and the tiny pivoted LU solve.

Counterpart of ``dnn_mppi_mpc_tpu/ops/sampling.py``. The scan path draws its
noise from a caller-owned ``torch.Generator``; it gives other numbers than
``jax.random`` for the same seed, so parity tests inject ε made with numpy.
"""

from __future__ import annotations

import torch


def small_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky–Crout of a tiny SPD matrix (dim_u ≤ ~8), in ``a``'s
    dtype, with the JAX package's scale-aware pivot floor: a pivot that f32
    cancellation pushes to or below zero is floored at 1e-6·|a_ii| + 1e-30
    instead of turning into NaN."""
    n = a.shape[-1]
    rows = [[None] * n for _ in range(n)]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for i in range(n):
        for j in range(i + 1):
            s = a[i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                floor = 1e-6 * torch.abs(a[i, i]) + 1e-30
                rows[i][j] = torch.sqrt(torch.maximum(s, floor))
            else:
                rows[i][j] = s / rows[j][j]
        for j in range(i + 1, n):
            rows[i][j] = zero
    return torch.stack([torch.stack(r) for r in rows])


def sigma_inverse(sigma: torch.Tensor) -> torch.Tensor:
    """Σ⁻¹ through the unrolled Cholesky factor, computed in float64 and
    returned in Σ's dtype."""
    a = sigma.to(torch.float64)
    n = a.shape[-1]
    L = small_cholesky(a)
    X = [[None] * n for _ in range(n)]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for j in range(n):
        for i in range(n):
            if i < j:
                X[i][j] = zero
            else:
                s = torch.ones_like(zero) if i == j else zero
                for k in range(j, i):
                    s = s - L[i, k] * X[k][j]
                X[i][j] = s / L[i, i]
    Linv = torch.stack([torch.stack(r) for r in X])
    return (Linv.T @ Linv).to(sigma.dtype)


def small_lu_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a·x = b for tiny ``a`` (..., n, n) by unrolled partial-pivot LU;
    ``b`` is (..., n) or (..., n, m), with the same leading dims.

    Partial pivoting, not Cholesky: the Riccati sweep's Luu = R + BᵀPB is
    only nominally SPD. In f32 the cost-to-go update cancels once the
    barrier's quadratic-extension stiffness (~1e6) enters the Hessians, and
    Luu can come out indefinite; LU with row pivoting then returns the same
    bounded step as a dense solve, which fraction-to-boundary damping
    corrects, where a clamped Cholesky pivot would blow the gain up to
    ~1e13. No data-dependent branch and no in-place op, so it runs under
    ``torch.func`` transforms and autograd and never waits for the card."""
    n = a.shape[-1]
    vec = b.dim() == a.dim() - 1
    B = b.unsqueeze(-1) if vec else b
    rows = [torch.cat([a[..., i, :], B[..., i, :]], dim=-1) for i in range(n)]
    for i in range(n):
        # bubble the max-|column i| row into position i
        for j in range(i + 1, n):
            swap = (torch.abs(rows[j][..., i]) > torch.abs(rows[i][..., i])).unsqueeze(-1)
            rows[i], rows[j] = (torch.where(swap, rows[j], rows[i]),
                                torch.where(swap, rows[i], rows[j]))
        piv = rows[i]
        inv_p = torch.reciprocal(piv[..., i])
        for j in range(i + 1, n):
            rows[j] = rows[j] - (rows[j][..., i] * inv_p).unsqueeze(-1) * piv
    xs: list = [None] * n
    for i in reversed(range(n)):  # back substitution
        s = rows[i][..., n:]
        for k in range(i + 1, n):
            s = s - rows[i][..., k:k + 1] * xs[k]
        xs[i] = s / rows[i][..., i:i + 1]
    X = torch.stack(xs, dim=-2)
    return X[..., 0] if vec else X


def sample_noise(
    generator: torch.Generator,
    sigma: torch.Tensor,
    num_samples: int,
    horizon: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """Draw ε ~ N(0, Σ) with shape (K, T, dim_u) from ``generator`` (which
    must live on Σ's device)."""
    dim_u = sigma.shape[-1]
    chol = small_cholesky(sigma.to(torch.float64)).to(dtype)
    z = torch.randn(
        (num_samples, horizon, dim_u), generator=generator, dtype=dtype,
        device=sigma.device,
    )
    # z @ cholᵀ written out elementwise: no matmul, so no TF32 path
    return (z.unsqueeze(-2) * chol).sum(-1)


__all__ = ["small_cholesky", "small_lu_solve", "sigma_inverse", "sample_noise"]
