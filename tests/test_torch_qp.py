"""The port's NMPC QP layer against the JAX package, on the CPU.

* ``small_lu_solve`` and ``relaxed_barrier`` against JAX, with an
  indefinite Luu among the LU cases (rtol 1e-6, atol 1e-7: the same
  operations in f32);
* ``riccati_solve`` with and without the cross term S against the JAX
  sequential sweep (rtol/atol 1e-5: the port solves [Lux | lu] in one LU,
  JAX in two, and matmuls round differently);
* the port's ``barrier_qp_solve`` against JAX ``barrier_qp_solve(parallel=
  False)`` on the ``_random_qp`` cases of tests/test_riccati_qp.py:22-52
  (n_h ∈ {0, 2} × S on/off, N = 12, 8 iterations) and the four-wheel shape
  (N = 10, nx = 5, nu = 4, n_h = 2, S), with that file's tolerances (δU and
  δX rtol/atol 2e-3, kkt rtol 5e-2 atol 1e-4);
* ``fused_barrier_qp_solve`` (on CPU tensors, its plain version) against
  the JAX kernel ``pallas_barrier_qp_solve(interpret=True)`` on the same
  cases and the four-wheel shape at N = 300 (past the card kernel's shared
  memory: its workspace route): the same algorithm in the same order in
  two frameworks, held to rtol/atol 1e-4 because the barrier stiffness
  1/δ² = 1e6 can magnify a rounding difference;
* ``batched_fused_barrier_qp_solve`` (plain) against JAX
  ``pallas_batched_barrier_qp_solve(interpret=True)`` at B = 5 (1e-4), member
  by member against the port's per-problem plain version (2e-5, as
  tests/test_riccati_qp.py:199-207 holds the two JAX kernels), with shared
  leaves broadcast, and at B = 130, N = 4;
* ``riccati_solve_parallel`` (the associative-scan Riccati) against JAX
  ``riccati_solve_parallel`` and the port's serial ``riccati_solve`` for
  N ∈ {1, 2, 7, 31, 60} (N + 1 a power of two and not), nx 2-5, nu 1-3,
  with and without S: float64 at tests/test_qp.py's rtol 1e-8, atol 1e-9,
  float32 at 1e-5; a B = 3 batch (a shared leaf among them) member by
  member against the unbatched calls (float64, rtol 1e-12, atol 1e-14: the
  same ops on a wider tensor); its gradients by ``gradcheck`` and a
  ``torch.func.jacrev`` through it; the Newton-step LQRs of a float32
  barrier solve at N = 256 ((5, 4), two h rows, S), where the scan is held
  to the serial sweep in float64 (1e-7 on seed 0; 5e-3 on seed 2, where
  the construction loses 1.3e-3); ``barrier_qp_solve(parallel=True)``
  against JAX ``parallel=True`` on the ``QP_CASES`` at their tolerances;
* the guards: an input that requires grad takes gradients (an unknown
  backward rule raises), an uninstantiated (nx, nu) on the card, the JAX
  backend names in ``SQPConfig`` and its ``parallel_riccati`` (JAX's
  default, read by the torch backend).

Every comparison prints its largest error.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.ops.pallas.riccati_qp import (
    pallas_barrier_qp_solve,
    pallas_batched_barrier_qp_solve,
)
from dnn_mppi_mpc_tpu.ops.sampling import small_lu_solve as j_lu
from dnn_mppi_mpc_tpu.solvers import qp as jqp
from dnn_mppi_mpc_tpu_torch.config import SQPConfig
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern
from dnn_mppi_mpc_tpu_torch.ops.cuda import riccati_qp as tkqp
from dnn_mppi_mpc_tpu_torch.ops.sampling import small_lu_solve
from dnn_mppi_mpc_tpu_torch.solvers import qp as tqp


def _random_qp_np(rng, N=12, nx=3, nu=2, n_h=0, with_S=False):
    """tests/test_riccati_qp.py:22-52's generator, as float32 numpy leaves."""
    f = np.float32

    def spd(n, scale=1.0):
        M = rng.normal(size=(n, n)) * 0.3
        return (M @ M.T + scale * np.eye(n)).astype(f)

    A = np.stack([np.eye(nx) + 0.05 * rng.normal(size=(nx, nx)) for _ in range(N)]).astype(f)
    B = (0.2 * rng.normal(size=(N, nx, nu))).astype(f)
    c = (0.05 * rng.normal(size=(N, nx))).astype(f)
    Q = np.stack([spd(nx) for _ in range(N + 1)])
    R = np.stack([spd(nu) for _ in range(N)])
    qxb = (0.5 * rng.normal(size=(N + 1, nx))).astype(f)
    rub = (0.5 * rng.normal(size=(N, nu))).astype(f)
    lbx = (1.5 + 0.2 * rng.random(size=(N + 1, nx))).astype(f)
    ubx = (1.5 + 0.2 * rng.random(size=(N + 1, nx))).astype(f)
    lbu = (1.0 + 0.2 * rng.random(size=(N, nu))).astype(f)
    ubu = (1.0 + 0.2 * rng.random(size=(N, nu))).astype(f)
    if n_h:
        Jh = rng.normal(size=(N + 1, n_h, nx)).astype(f)
        h0 = (1.0 + rng.random(size=(N + 1, n_h))).astype(f)
    else:
        Jh = h0 = None
    S = (0.1 * rng.normal(size=(N, nu, nx))).astype(f) if with_S else None
    return [A, B, c, Q, qxb, R, rub, lbx, ubx, lbu, ubu, Jh, h0, S]


def _jax(leaves):
    return jqp.BoxedQPData(*(None if a is None else jnp.asarray(a) for a in leaves))


def _torch(leaves):
    return tqp.BoxedQPData(*(None if a is None else torch.tensor(a) for a in leaves))


def _close(name, got, want, rtol, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    print(f"{name}: max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


# (n_h, with_S, seed, N, nx, nu): tests/test_riccati_qp.py's cases and the
# four-wheel shape
QP_CASES = [
    (0, False, 0, 12, 3, 2),
    (2, False, 0, 12, 3, 2),
    (0, True, 7, 12, 3, 2),
    (2, True, 7, 12, 3, 2),
    (2, True, 42, 10, 5, 4),
]
QP_IDS = ["nh0", "nh2", "S", "nh2_S", "four_wheel"]
# the four-wheel shape at N = 300, past what the kernel holds in shared
# memory (qp_max_horizon 234 there): the kernel's workspace route, whose
# plain version is the same; JAX's kernel takes any N
LONG_QP_CASE = (2, True, 42, 300, 5, 4)


def _case(n_h, with_S, seed, N, nx, nu):
    rng = np.random.default_rng(seed)
    leaves = _random_qp_np(rng, N=N, nx=nx, nu=nu, n_h=n_h, with_S=with_S)
    dx0 = (0.2 * rng.normal(size=(nx,))).astype(np.float32)
    return leaves, dx0


# --- the building blocks ------------------------------------------------------


@pytest.mark.parametrize("n,m,indefinite", [(2, 0, False), (2, 3, True), (4, 0, True),
                                            (4, 5, False)])
def test_small_lu_solve_matches_jax(n, m, indefinite):
    """Vector and matrix right-hand sides; an indefinite matrix (the f32
    Riccati failure mode the pivoting exists for) among them."""
    rng = np.random.default_rng(n * 10 + m)
    a = rng.normal(size=(n, n)).astype(np.float32)
    a = a @ a.T + np.eye(n, dtype=np.float32)
    if indefinite:
        a[0, 0] = -81.6  # a negative pivot, as observed under barrier stiffness
    b = rng.normal(size=(n,) if m == 0 else (n, m)).astype(np.float32)
    got = small_lu_solve(torch.tensor(a), torch.tensor(b)).numpy()
    _close("small_lu_solve", got, np.asarray(j_lu(jnp.asarray(a), jnp.asarray(b))), 1e-6, 1e-7)
    np.testing.assert_allclose(a @ got, b, rtol=1e-4, atol=1e-4)


def test_small_lu_solve_batched():
    """Leading batch dims: each member equals its own unbatched solve."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.normal(size=(4, 3, 3)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(4, 3, 2)).astype(np.float32))
    got = small_lu_solve(a, b)
    for i in range(4):
        assert torch.equal(got[i], small_lu_solve(a[i], b[i]))


def test_relaxed_barrier_matches_jax():
    w = np.linspace(-0.01, 0.05, 61).astype(np.float32)
    for mu, stiffness in ((0.1, None), (1e-4, 1e4)):
        got = tqp.relaxed_barrier(torch.tensor(w), mu, 1e-3, stiffness)
        want = jqp.relaxed_barrier(jnp.asarray(w), mu, 1e-3, stiffness)
        for name, g, j in zip(("psi", "dpsi", "d2psi"), got, want):
            _close(f"relaxed_barrier {name} mu={mu}", g.numpy(), np.asarray(j), 1e-6, 1e-7)


@pytest.mark.parametrize("with_S", [False, True], ids=["noS", "S"])
def test_riccati_solve_matches_jax(with_S):
    rng = np.random.default_rng(11)
    A, B, c, Q, qx, R, ru, *_ = _random_qp_np(rng, N=10, nx=3, nu=2)
    S = (0.1 * rng.normal(size=(10, 2, 3))).astype(np.float32) if with_S else None
    dx0 = (0.2 * rng.normal(size=(3,))).astype(np.float32)
    leaves = [A, B, c, Q, qx, R, ru, S]
    jd = jqp.LQRData(*(None if a is None else jnp.asarray(a) for a in leaves))
    td = tqp.LQRData(*(None if a is None else torch.tensor(a) for a in leaves))
    jX, jU = jqp.riccati_solve(jd, jnp.asarray(dx0))
    tX, tU = tqp.riccati_solve(td, torch.tensor(dx0))
    _close("riccati dX", tX.numpy(), np.asarray(jX), 1e-5, 1e-5)
    _close("riccati dU", tU.numpy(), np.asarray(jU), 1e-5, 1e-5)


# --- the associative-scan Riccati ----------------------------------------------


def _lqr_np(rng, N, nx, nu, with_S, dtype):
    """A random LQR of ``_random_qp_np``'s distribution: (leaves, dx0)."""
    A, B, c, Q, qx, R, ru, *_ = _random_qp_np(rng, N=N, nx=nx, nu=nu)
    S = (0.1 * rng.normal(size=(N, nu, nx))).astype(np.float32) if with_S else None
    dx0 = (0.2 * rng.normal(size=(nx,))).astype(np.float32)
    return [None if a is None else a.astype(dtype) for a in (A, B, c, Q, qx, R, ru, S)], \
        dx0.astype(dtype)


RICCATI_TOL = {"float64": (1e-8, 1e-9), "float32": (1e-5, 1e-5)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("with_S", [False, True], ids=["noS", "S"])
@pytest.mark.parametrize("N", [1, 2, 7, 31, 60])
def test_riccati_solve_parallel_matches_jax(N, with_S, dtype):
    """The scan against JAX's scan and against the port's serial sweep, on
    (nx, nu) drawn from the seed as tests/test_qp.py:276-301 draws them."""
    rng = np.random.default_rng(100 + N)
    nx, nu = int(rng.integers(2, 6)), int(rng.integers(1, 4))
    leaves, dx0 = _lqr_np(rng, N, nx, nu, with_S, np.dtype(dtype))
    jd = jqp.LQRData(*(None if a is None else jnp.asarray(a) for a in leaves))
    td = tqp.LQRData(*(None if a is None else torch.tensor(a) for a in leaves))
    jX, jU = jax.jit(jqp.riccati_solve_parallel)(jd, jnp.asarray(dx0))
    assert jX.dtype == jnp.dtype(dtype)
    tX, tU = tqp.riccati_solve_parallel(td, torch.tensor(dx0))
    sX, sU = tqp.riccati_solve(td, torch.tensor(dx0))
    assert tX.shape == (N + 1, nx) and tU.shape == (N, nu) and tX.dtype == td.A.dtype
    rtol, atol = RICCATI_TOL[dtype]
    tag = f"N={N} nx={nx} nu={nu} S={with_S} {dtype}"
    _close(f"parallel dX vs JAX {tag}", tX.numpy(), np.asarray(jX), rtol, atol)
    _close(f"parallel dU vs JAX {tag}", tU.numpy(), np.asarray(jU), rtol, atol)
    _close(f"parallel dX vs serial {tag}", tX.numpy(), sX.numpy(), rtol, atol)
    _close(f"parallel dU vs serial {tag}", tU.numpy(), sU.numpy(), rtol, atol)


def test_riccati_solve_parallel_batched_equals_members():
    """B = 3 problems (S on; A shared by the members, dx0 per member) in one
    call equal each member's own call."""
    rng = np.random.default_rng(5)
    per = [_lqr_np(rng, 9, 3, 2, True, np.float64) for _ in range(3)]
    shared_A = torch.tensor(per[0][0][0])
    stacked = [torch.stack([torch.tensor(p[0][i]) for p in per]) for i in range(8)]
    td = tqp.LQRData(shared_A, *stacked[1:])
    dx0 = torch.stack([torch.tensor(p[1]) for p in per])
    bX, bU = tqp.riccati_solve_parallel(td, dx0)
    assert bX.shape == (3, 10, 3) and bU.shape == (3, 9, 2)
    for b in range(3):
        one = tqp.LQRData(shared_A, *(t[b] for t in stacked[1:]))
        X, U = tqp.riccati_solve_parallel(one, dx0[b])
        _close(f"batched member {b} dX", bX[b].numpy(), X.numpy(), 1e-12, 1e-14)
        _close(f"batched member {b} dU", bU[b].numpy(), U.numpy(), 1e-12, 1e-14)


def test_riccati_solve_parallel_differentiates():
    """Autograd (``gradcheck`` in float64, through the S elimination, both
    scans and the pivoted solves) and ``torch.func.jacrev`` go through the
    scan; the jacobian in dx0 equals the serial sweep's."""
    rng = np.random.default_rng(9)
    leaves, dx0 = _lqr_np(rng, 5, 3, 2, True, np.float64)
    base = [torch.tensor(a) for a in leaves]

    def solve(qx, ru, S, x0):
        d = tqp.LQRData(base[0], base[1], base[2], base[3], qx, base[5], ru, S)
        return tqp.riccati_solve_parallel(d, x0)

    args = tuple(torch.tensor(a, requires_grad=True) for a in (leaves[4], leaves[6], leaves[7],
                                                                dx0))
    assert torch.autograd.gradcheck(solve, args)

    def roll(x0, lqr):
        return lqr(tqp.LQRData(*base), x0)[0]

    jac = torch.func.jacrev(roll)(torch.tensor(dx0), tqp.riccati_solve_parallel)
    want = torch.func.jacrev(roll)(torch.tensor(dx0), tqp.riccati_solve)
    _close("jacrev dX/dx0 parallel vs serial", jac.numpy(), want.numpy(), 1e-10, 1e-12)


# the scan against the serial sweep, both in float64, on the Newton-step LQRs
# of a float32 barrier solve at N = 256: seed 0 holds the odd/even scheme's
# point (Hillis-Steele's scan was 1.1e-2 off there, this one 1.1e-9); on
# seed 2 the construction itself loses 1.3e-3, in either scheme (ROADMAP §C)
LONG_STIFF_LIMIT = {0: 1e-7, 2: 5e-3}


@pytest.mark.parametrize("seed", list(LONG_STIFF_LIMIT))
def test_riccati_solve_parallel_long_stiff_lqr(seed):
    rng = np.random.default_rng(seed)
    leaves = _random_qp_np(rng, N=256, nx=5, nu=4, n_h=2, with_S=True)
    dx0 = torch.tensor((0.2 * rng.normal(size=(5,))).astype(np.float32))
    lqrs = []
    real = tqp.riccati_solve_parallel

    def spy(data, x0):
        lqrs.append((tqp.LQRData(*(None if t is None else t.double() for t in data)),
                     x0.double()))
        return real(data, x0)

    tqp.riccati_solve_parallel = spy
    try:
        tqp.barrier_qp_solve(_torch(leaves), dx0, parallel=True)
    finally:
        tqp.riccati_solve_parallel = real
    assert len(lqrs) == 12
    err = max(float((real(d, x)[1] - tqp.riccati_solve(d, x)[1]).abs().max()) for d, x in lqrs)
    print(f"seed {seed}: scan vs serial δU in float64 over 12 Newton LQRs {err:.3e}")
    assert err <= LONG_STIFF_LIMIT[seed]


@pytest.mark.parametrize("n_h,with_S,seed,N,nx,nu", QP_CASES, ids=QP_IDS)
def test_barrier_qp_solve_parallel_matches_jax(n_h, with_S, seed, N, nx, nu):
    """``parallel=True`` on both sides (the scan in every Newton step and
    the scanned condensing roll)."""
    leaves, dx0 = _case(n_h, with_S, seed, N, nx, nu)
    jX, jU, jk = jax.jit(lambda qp, x: jqp.barrier_qp_solve(
        qp, x, num_iters=8, parallel=True, return_kkt=True))(_jax(leaves), jnp.asarray(dx0))
    tX, tU, tk = tqp.barrier_qp_solve(_torch(leaves), torch.tensor(dx0), num_iters=8,
                                      parallel=True, return_kkt=True)
    _close("barrier_qp parallel dU", tU.numpy(), np.asarray(jU), 2e-3, 2e-3)
    _close("barrier_qp parallel dX", tX.numpy(), np.asarray(jX), 2e-3, 2e-3)
    _close("barrier_qp parallel kkt", float(tk), float(jk), 5e-2, 1e-4)


# --- the torch backend --------------------------------------------------------


@pytest.mark.parametrize("n_h,with_S,seed,N,nx,nu", QP_CASES, ids=QP_IDS)
def test_barrier_qp_solve_matches_jax(n_h, with_S, seed, N, nx, nu):
    leaves, dx0 = _case(n_h, with_S, seed, N, nx, nu)
    jX, jU, jk = jqp.barrier_qp_solve(_jax(leaves), jnp.asarray(dx0), num_iters=8,
                                      parallel=False, return_kkt=True)
    tX, tU, tk = tqp.barrier_qp_solve(_torch(leaves), torch.tensor(dx0), num_iters=8,
                                      return_kkt=True)
    _close("barrier_qp dU", tU.numpy(), np.asarray(jU), 2e-3, 2e-3)
    _close("barrier_qp dX", tX.numpy(), np.asarray(jX), 2e-3, 2e-3)
    _close("barrier_qp kkt", float(tk), float(jk), 5e-2, 1e-4)


def test_barrier_qp_solve_batched_equals_members():
    """A leading batch on some leaves (shared others) equals each member's
    own solve: the torch backend serves fleets without vmap."""
    cases = [_case(2, True, 20 + i, 6, 3, 2) for i in range(3)]
    shared = _torch(cases[0][0])
    qx = torch.stack([torch.tensor(c[0][4]) for c in cases])
    dx0 = torch.stack([torch.tensor(c[1]) for c in cases])
    qp_b = shared._replace(qx_base=qx)
    bX, bU, bk = tqp.barrier_qp_solve(qp_b, dx0, num_iters=6, return_kkt=True)
    assert bX.shape == (3, 7, 3) and bU.shape == (3, 6, 2) and bk.shape == (3,)
    for i in range(3):
        X, U, k = tqp.barrier_qp_solve(shared._replace(qx_base=qx[i]), dx0[i], num_iters=6,
                                       return_kkt=True)
        _close(f"batched member {i} dU", bU[i].numpy(), U.numpy(), 1e-5, 1e-6)
        _close(f"batched member {i} dX", bX[i].numpy(), X.numpy(), 1e-5, 1e-6)


# --- the kernel's plain versions ------------------------------------------------


@pytest.mark.parametrize("n_h,with_S,seed,N,nx,nu", QP_CASES + [LONG_QP_CASE],
                         ids=QP_IDS + ["four_wheel_N300"])
def test_fused_qp_plain_matches_jax_kernel(n_h, with_S, seed, N, nx, nu):
    leaves, dx0 = _case(n_h, with_S, seed, N, nx, nu)
    jX, jU, jk = pallas_barrier_qp_solve(_jax(leaves), jnp.asarray(dx0), num_iters=8,
                                         interpret=True)
    kern.reset_counts()
    tX, tU, tk = kern.fused_barrier_qp_solve(_torch(leaves), torch.tensor(dx0), num_iters=8)
    assert kern.fused_barrier_qp_solve_plain.calls == 1
    assert kern.fused_barrier_qp_solve.launches == 0
    assert tX.shape == (N + 1, nx) and tU.shape == (N, nu) and tk.shape == ()
    _close("fused dX", tX.numpy(), np.asarray(jX), 1e-4, 1e-4)
    _close("fused dU", tU.numpy(), np.asarray(jU), 1e-4, 1e-4)
    _close("fused kkt", float(tk), float(jk), 1e-4, 1e-4)


def _stack(leaf_lists):
    return [None if leaf_lists[0][k] is None else np.stack([ls[k] for ls in leaf_lists])
            for k in range(len(leaf_lists[0]))]


@pytest.mark.parametrize("n_h,with_S", [(0, False), (2, False), (2, True)],
                         ids=["nh0", "nh2", "nh2_S"])
def test_batched_fused_qp_plain_matches_jax_and_members(n_h, with_S):
    """B = 5 distinct problems (tests/test_riccati_qp.py:180-207): the JAX
    lane-batched kernel within 1e-4, the port's per-problem plain version
    member by member within 2e-5."""
    B = 5
    problems = [_random_qp_np(np.random.default_rng(10 + i), N=8, nx=3, nu=2, n_h=n_h,
                              with_S=with_S) for i in range(B)]
    dx0 = (0.2 * np.random.default_rng(3).normal(size=(B, 3))).astype(np.float32)
    stacked = _stack(problems)
    jX, jU, jk = pallas_batched_barrier_qp_solve(_jax(stacked), jnp.asarray(dx0), num_iters=8,
                                                 interpret=True)
    kern.reset_counts()
    tX, tU, tk = kern.batched_fused_barrier_qp_solve(_torch(stacked), torch.tensor(dx0),
                                                     num_iters=8)
    assert kern.batched_fused_barrier_qp_solve_plain.calls == 1
    assert tX.shape == (B, 9, 3) and tU.shape == (B, 8, 2) and tk.shape == (B,)
    _close("batched dX vs JAX", tX.numpy(), np.asarray(jX), 1e-4, 1e-4)
    _close("batched dU vs JAX", tU.numpy(), np.asarray(jU), 1e-4, 1e-4)
    _close("batched kkt vs JAX", tk.numpy(), np.asarray(jk), 1e-4, 1e-4)
    for i in range(B):
        X, U, k = kern.fused_barrier_qp_solve(_torch(problems[i]), torch.tensor(dx0[i]),
                                              num_iters=8)
        _close(f"member {i} dX", tX[i].numpy(), X.numpy(), 2e-5, 2e-5)
        _close(f"member {i} dU", tU[i].numpy(), U.numpy(), 2e-5, 2e-5)
        _close(f"member {i} kkt", float(tk[i]), float(k), 2e-4, 2e-6)


def test_batched_fused_qp_broadcasts_shared_leaves():
    """Leaves without the leading B are shared (the JAX batching rule,
    riccati_qp.py:755-764): qp unbatched and dx0 batched, as
    tests/test_riccati_qp.py:244-265."""
    leaves = _random_qp_np(np.random.default_rng(5), N=6, nx=3, nu=2, n_h=2)
    dx0 = (0.2 * np.random.default_rng(6).normal(size=(3, 3))).astype(np.float32)
    qp = _torch(leaves)
    bX, bU, bk = kern.batched_fused_barrier_qp_solve(qp, torch.tensor(dx0), num_iters=6)
    for i in range(3):
        X, U, k = kern.fused_barrier_qp_solve(qp, torch.tensor(dx0[i]), num_iters=6)
        _close(f"shared member {i} dU", bU[i].numpy(), U.numpy(), 2e-5, 2e-5)
        _close(f"shared member {i} dX", bX[i].numpy(), X.numpy(), 2e-5, 2e-5)
        _close(f"shared member {i} kkt", float(bk[i]), float(k), 2e-4, 2e-6)


def test_batched_fused_qp_130_members():
    """B = 130 (more than the JAX kernel's 128-lane block): members at both
    ends and across 128 equal their own solves."""
    B = 130
    base = _torch(_random_qp_np(np.random.default_rng(0), N=4, nx=2, nu=1))
    rng = np.random.default_rng(1)
    qxb = torch.tensor((0.5 * rng.normal(size=(B, 5, 2))).astype(np.float32))
    dx0 = torch.tensor((0.1 * rng.normal(size=(B, 2))).astype(np.float32))
    bX, bU, _ = kern.batched_fused_barrier_qp_solve(base._replace(qx_base=qxb), dx0,
                                                    num_iters=4)
    for i in (0, 63, 127, 128, 129):
        X, U, _ = kern.fused_barrier_qp_solve(base._replace(qx_base=qxb[i]), dx0[i], num_iters=4)
        _close(f"member {i} dU", bU[i].numpy(), U.numpy(), 2e-5, 2e-5)
        _close(f"member {i} dX", bX[i].numpy(), X.numpy(), 2e-5, 2e-5)


def test_fused_qp_plain_matches_torch_backend():
    """The kernel's algorithm and the torch backend agree in float64 terms
    up to f32 rounding on the SQP tick's shape (N = 30, 12 iterations)."""
    leaves, dx0 = _case(2, False, 4, 30, 3, 2)
    kX, kU, kk = kern.fused_barrier_qp_solve(_torch(leaves), torch.tensor(dx0))
    tX, tU, tk = tqp.barrier_qp_solve(_torch(leaves), torch.tensor(dx0), return_kkt=True)
    _close("kernel plain vs torch backend dU", kU.numpy(), tU.numpy(), 2e-3, 2e-3)
    _close("kernel plain vs torch backend dX", kX.numpy(), tX.numpy(), 2e-3, 2e-3)


# --- guards -----------------------------------------------------------------------


@pytest.mark.parametrize("wrapper", ["fused_barrier_qp_solve", "batched_fused_barrier_qp_solve"])
def test_requires_grad_raises(wrapper):
    """An input that requires grad takes the differentiable route: both
    wrappers return finite gradients (the plain version forward, the IFT
    backward, tests/test_torch_diff_nmpc.py holds them against JAX); only an
    unknown backward rule raises."""
    leaves, dx0 = _case(0, False, 0, 4, 3, 2)
    qp = _torch(leaves)
    qp = qp._replace(qx_base=qp.qx_base.requires_grad_())
    x0 = torch.tensor(dx0) if wrapper == "fused_barrier_qp_solve" else torch.tensor(dx0)[None]
    dX, dU, kkt = getattr(kern, wrapper)(qp, x0, num_iters=2)
    assert dX.requires_grad and dU.requires_grad and not kkt.requires_grad
    (g,) = torch.autograd.grad(dX.sum() + dU.sum(), qp.qx_base)
    assert g.shape == qp.qx_base.shape and torch.isfinite(g).all() and float(g.abs().sum()) > 0
    with pytest.raises(ValueError, match="backward must be one of"):
        getattr(kern, wrapper)(qp, x0, num_iters=2, backward="unrolled")


def test_per_problem_wrapper_rejects_a_batch():
    leaves, dx0 = _case(0, False, 0, 4, 3, 2)
    with pytest.raises(ValueError, match="one problem"):
        kern.fused_barrier_qp_solve(_torch(leaves), torch.tensor(dx0)[None], num_iters=2)


def test_uninstantiated_shape_raises_before_launch():
    """(nx, nu) outside the instantiated set raises ValueError naming the
    supported ones (the check the CUDA path makes before any launch)."""
    leaves = {n: torch.zeros(s) for n, s in dict(
        A=(1, 4, 6, 6), B=(1, 4, 6, 2), c=(1, 4, 6), Q=(1, 5, 6, 6), qx_base=(1, 5, 6),
        R=(1, 4, 2, 2), ru_base=(1, 4, 2), lbx=(1, 5, 6), ubx=(1, 5, 6), lbu=(1, 4, 2),
        ubu=(1, 4, 2)).items()}
    leaves.update(Jh=None, h0=None, S=None)
    with pytest.raises(ValueError, match=r"\(nx, nu\) in"):
        tkqp._check_dims(4, 6, 2, 0, leaves, 1, 12)
    assert (5, 4) in tkqp.SUPPORTED_DIMS and (3, 2) in tkqp.SUPPORTED_DIMS


@pytest.mark.parametrize("name,port", [("xla", "torch"), ("pallas", "kernel")])
def test_sqp_config_rejects_jax_backend_names(name, port, monkeypatch):
    """The JAX backend names raise, naming the port's; ``parallel_riccati``
    exists, defaults to True as JAX's does, and picks the torch backend's
    LQR (the kernel backend does not read it)."""
    from dnn_mppi_mpc_tpu.config import SQPConfig as JSQPConfig
    from dnn_mppi_mpc_tpu_torch.models.dynamics import unicycle
    from dnn_mppi_mpc_tpu_torch.solvers.sqp import NMPCSolver, ocp_params_from_numpy

    with pytest.raises(ValueError, match=f"'{port}'"):
        SQPConfig(N=5, dim_x=3, dim_u=2, dt=0.1, qp_backend=name)
    with pytest.raises(ValueError, match="qp_backend"):
        SQPConfig(N=5, dim_x=3, dim_u=2, dt=0.1, qp_backend="hpipm")
    cfg = SQPConfig(N=3, dim_x=3, dim_u=2, dt=0.1, qp_iters=2, qp_backend=port)
    assert cfg.parallel_riccati is True
    assert JSQPConfig(N=3, dim_x=3, dim_u=2, dt=0.1).parallel_riccati is True
    calls = {"riccati_solve": 0, "riccati_solve_parallel": 0}
    for fn in calls:
        real = getattr(tqp, fn)

        def spy(*a, _real=real, _fn=fn):
            calls[_fn] += 1
            return _real(*a)

        monkeypatch.setattr(tqp, fn, spy)
    params = ocp_params_from_numpy(np.eye(3), np.eye(2), np.eye(3), np.zeros((3, 5)),
                                   np.ones(3), -np.ones(3) * 5, np.ones(3) * 5, -np.ones(2),
                                   np.ones(2), device="cpu")
    x0 = torch.tensor([0.1, 0.2, 0.0])
    for parallel in (True, False):
        solver = NMPCSolver(dataclasses.replace(cfg, parallel_riccati=parallel), unicycle,
                            device="cpu")
        u0, _, aux = solver.solve(params, solver.init(x0), x0)
        assert torch.isfinite(u0).all() and int(aux.status) == 0
    want = {"riccati_solve": 2, "riccati_solve_parallel": 2} if port == "torch" else \
        {"riccati_solve": 0, "riccati_solve_parallel": 0}
    assert calls == want, calls


@pytest.mark.cuda
def test_fused_qp_kernel_on_the_card():
    """On the card: both wrappers launch the kernel and equal their plain
    versions within chip_smoke.py's TOL, the batched one at B = 130 also
    member by member against the per-problem kernel (run there: this
    machine has no card to collect it on with the JAX conftest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    leaves, dx0 = _case(2, True, 7, 30, 3, 2)
    dev = torch.device("cuda", 0)
    qp = tqp.BoxedQPData(*(None if a is None else torch.tensor(a, device=dev) for a in leaves))
    x0 = torch.tensor(dx0, device=dev)
    got = kern.fused_barrier_qp_solve(qp, x0)
    want = kern.fused_barrier_qp_solve_plain(qp, x0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)

    B = 130
    rng = np.random.default_rng(8)
    stacked = _stack([_random_qp_np(rng, N=30, nx=3, nu=2, n_h=1) for _ in range(B)])
    qp = tqp.BoxedQPData(*(None if a is None else torch.tensor(a, device=dev) for a in stacked))
    x0 = torch.tensor((0.2 * rng.normal(size=(B, 3))).astype(np.float32), device=dev)
    got = kern.batched_fused_barrier_qp_solve(qp, x0)
    want = kern.batched_fused_barrier_qp_solve_plain(qp, x0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    for b in (0, 127, 128, 129):
        one = kern.fused_barrier_qp_solve(
            tqp.BoxedQPData(*(None if t is None else t[b] for t in qp)), x0[b])
        for g, w in zip(got, one):
            torch.testing.assert_close(g[b], w, rtol=0, atol=0)
