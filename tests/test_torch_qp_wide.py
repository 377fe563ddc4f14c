"""The fused QP past the package library's 13 shapes, on the CPU: the port's
plain version at state and input widths up to (12, 6), against the JAX
package.

* ``fused_barrier_qp_solve`` (on CPU tensors, its plain version) against
  the JAX kernel ``pallas_barrier_qp_solve(interpret=True)`` at (6, 2) and
  (9, 4), N = 4, 4 iterations, two h rows and S: the same algorithm in the
  same order in two frameworks, held to rtol/atol 1e-4 as
  tests/test_torch_qp.py holds the 13 shapes (the barrier stiffness 1/δ² =
  1e6 can magnify a rounding difference); interpret mode traces for ~10 and
  ~30 s there, so no wider;
* the same plain version against JAX's XLA ``barrier_qp_solve`` (the
  serial sweep) at (7, 3), (12, 4) and (12, 6), N = 6, 8 iterations, at
  tests/test_riccati_qp.py's tolerances between JAX's own kernel and XLA
  routes (δX, δU rtol/atol 2e-3; kkt rtol 5e-2, atol 1e-4: the XLA route
  solves [Lux | lu] in two solves and its matmuls round otherwise);
* ``batched_fused_barrier_qp_solve`` (plain) at (9, 4), B = 5: member by
  member against the per-problem plain version (2e-5, as
  tests/test_torch_qp.py holds a batch to its members) and against JAX's
  XLA route (2e-3);
* the four-wheel NMPC in rate form (nx = 9, nu = 4; ``chip_smoke.py
  rate_form_nmpc``, IRK, two SQP iterations of 10-iteration QPs) on
  ``qp_backend="kernel"`` (its plain version on the CPU) against JAX's
  ``NMPCSolver`` on ``qp_backend="xla"`` (the serial sweep) with the same
  dynamics, costs and bounds: 3 closed-loop ticks from rest at N = 8, u0, X
  and U within rtol/atol 3e-3 each tick, the JAX tests' own limit between
  their kernel and XLA QP routes (tests/test_riccati_qp.py:100-103: the
  kernel's algorithm solves [Lux | lu] in one LU, XLA in two, and the
  barrier stiffness magnifies the difference on the first, unconverged
  ticks from rest), each tick's QPs through the plain version and none
  launched;
* the range: a (13, 4) QP raises ``ValueError`` naming the range at the
  check the wrappers make before any launch, and ``in_range`` takes
  exactly 2 ≤ nx ≤ 12, 1 ≤ nu ≤ min(nx, 6);
* the route: ``_launch`` launches the package library's 13 shapes from it
  and any other from the shape's own library (``_build.load_qp_kernels``),
  whose key follows its defines, whose build compiles
  ``csrc/riccati_qp.cu`` alone with the package's flags, which is reused
  from disk, and whose failed build raises.

Every comparison prints its largest error.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RATE_GOAL, RATE_STATE_COST, rate_form_nmpc
from dnn_mppi_mpc_tpu.config import SQPConfig as JSQPConfig
from dnn_mppi_mpc_tpu.models import dynamics as jdyn
from dnn_mppi_mpc_tpu.ops.pallas.riccati_qp import pallas_barrier_qp_solve
from dnn_mppi_mpc_tpu.solvers import qp as jqp
from dnn_mppi_mpc_tpu.solvers import sqp as jsqp
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern
from dnn_mppi_mpc_tpu_torch.ops.cuda import riccati_qp as rq
from test_torch_qp import _close, _jax, _random_qp_np, _stack, _torch


def _case(seed, N, nx, nu, n_h=2, with_S=True):
    rng = np.random.default_rng(seed)
    leaves = _random_qp_np(rng, N=N, nx=nx, nu=nu, n_h=n_h, with_S=with_S)
    return leaves, (0.2 * rng.normal(size=(nx,))).astype(np.float32)


def _plain(leaves, dx0, iters):
    kern.reset_counts()
    out = kern.fused_barrier_qp_solve(_torch(leaves), torch.tensor(dx0), num_iters=iters)
    assert kern.fused_barrier_qp_solve_plain.calls == 1
    assert kern.fused_barrier_qp_solve.launches == 0
    return out


@pytest.mark.parametrize("nx,nu", [(6, 2), (9, 4)])
def test_wide_plain_matches_jax_kernel(nx, nu):
    N, iters = 4, 4
    leaves, dx0 = _case(nx * 10 + nu, N, nx, nu)
    jX, jU, jk = pallas_barrier_qp_solve(_jax(leaves), jnp.asarray(dx0), num_iters=iters,
                                         interpret=True)
    tX, tU, tk = _plain(leaves, dx0, iters)
    assert tX.shape == (N + 1, nx) and tU.shape == (N, nu)
    _close(f"({nx}, {nu}) dX vs the JAX kernel", tX.numpy(), np.asarray(jX), 1e-4, 1e-4)
    _close(f"({nx}, {nu}) dU vs the JAX kernel", tU.numpy(), np.asarray(jU), 1e-4, 1e-4)
    _close(f"({nx}, {nu}) kkt vs the JAX kernel", float(tk), float(jk), 1e-4, 1e-4)


@pytest.mark.parametrize("nx,nu", [(7, 3), (12, 4), (12, 6)])
def test_wide_plain_matches_jax_xla(nx, nu):
    N, iters = 6, 8
    leaves, dx0 = _case(nx * 10 + nu, N, nx, nu)
    jX, jU, jk = jqp.barrier_qp_solve(_jax(leaves), jnp.asarray(dx0), num_iters=iters,
                                      return_kkt=True)
    tX, tU, tk = _plain(leaves, dx0, iters)
    _close(f"({nx}, {nu}) dX vs JAX XLA", tX.numpy(), np.asarray(jX), 2e-3, 2e-3)
    _close(f"({nx}, {nu}) dU vs JAX XLA", tU.numpy(), np.asarray(jU), 2e-3, 2e-3)
    _close(f"({nx}, {nu}) kkt vs JAX XLA", float(tk), float(jk), 5e-2, 1e-4)


def test_wide_batched_plain_matches_members_and_jax():
    B, N, nx, nu, iters = 5, 6, 9, 4, 8
    problems = [_case(30 + b, N, nx, nu) for b in range(B)]
    stacked = _stack([p[0] for p in problems])
    dx0 = np.stack([p[1] for p in problems])
    kern.reset_counts()
    bX, bU, bk = kern.batched_fused_barrier_qp_solve(_torch(stacked), torch.tensor(dx0),
                                                     num_iters=iters)
    assert kern.batched_fused_barrier_qp_solve_plain.calls == 1
    assert kern.batched_fused_barrier_qp_solve.launches == 0
    assert bX.shape == (B, N + 1, nx) and bU.shape == (B, N, nu) and bk.shape == (B,)
    for b, (leaves, x0) in enumerate(problems):
        X, U, k = _plain(leaves, x0, iters)
        _close(f"member {b} dX", bX[b].numpy(), X.numpy(), 2e-5, 2e-5)
        _close(f"member {b} dU", bU[b].numpy(), U.numpy(), 2e-5, 2e-5)
        _close(f"member {b} kkt", float(bk[b]), float(k), 2e-4, 2e-6)
        jX, jU = jqp.barrier_qp_solve(_jax(leaves), jnp.asarray(x0), num_iters=iters)
        _close(f"member {b} dX vs JAX XLA", bX[b].numpy(), np.asarray(jX), 2e-3, 2e-3)
        _close(f"member {b} dU vs JAX XLA", bU[b].numpy(), np.asarray(jU), 2e-3, 2e-3)


def _jax_rate_form(N: int):
    """The JAX package's NMPCSolver with ``rate_form_nmpc``'s model and
    settings on its XLA backend (the serial sweep)."""
    def rates(z, w):
        return jnp.concatenate([jdyn.four_wheel_torque(z[..., :5], z[..., 5:]), w], axis=-1)

    cfg = JSQPConfig(N=N, dim_x=9, dim_u=4, dt=0.1, sqp_iters=2, qp_iters=10, integrator="irk",
                     qp_backend="xla", parallel_riccati=False)
    lbx = jnp.asarray([-20.0] * 5 + [-5.0] * 4)
    Q = jnp.diag(jnp.asarray(RATE_STATE_COST))
    params = jsqp.OCPParams(
        Q=Q, R=0.01 * jnp.eye(4), Qe=Q,
        yref=jnp.concatenate([jnp.asarray(RATE_GOAL), jnp.zeros(4)])[None, :].repeat(N, axis=0),
        yref_e=jnp.asarray(RATE_GOAL), lbx=lbx, ubx=-lbx, lbu=jnp.full(4, -50.0),
        ubu=jnp.full(4, 50.0))
    return jsqp.NMPCSolver(cfg, rates), params


def test_rate_form_nmpc_matches_jax():
    N, ticks = 8, 3
    tsolver, tparams = rate_form_nmpc("cpu", N=N)
    jsolver, jparams = _jax_rate_form(N)
    assert tsolver.cfg.qp_backend == "kernel" and tsolver.cfg.integrator == "irk"
    tx, jx = torch.zeros(9), jnp.zeros(9)
    tst, jst = tsolver.init(tx), jsqp.NMPCState(X=jnp.zeros((N + 1, 9)), U=jnp.zeros((N, 4)))
    kern.reset_counts()
    for tick in range(ticks):
        tu0, tst, taux = tsolver.solve(tparams, tst, tx)
        ju0, jst, jaux = jsolver.solve(jparams, jst, jx)
        _close(f"tick {tick} u0", tu0.numpy(), np.asarray(ju0), 3e-3, 3e-3)
        _close(f"tick {tick} X", tst.X.numpy(), np.asarray(jst.X), 3e-3, 3e-3)
        _close(f"tick {tick} U", tst.U.numpy(), np.asarray(jst.U), 3e-3, 3e-3)
        assert int(taux.status) == int(jaux.status) == 0
        tx, jx = tsolver.dyn_step(tx, tu0), jsolver.dyn_step(jx, ju0)
    assert kern.fused_barrier_qp_solve_plain.calls == 2 * ticks
    assert kern.fused_barrier_qp_solve.launches == 0
    # the torques moved: the rate inputs reached the model's torque states
    assert float(tx[5:].abs().min()) > 0.1


def _zero_leaves(N, nx, nu):
    leaves = {n: torch.zeros((1,) + s) for n, s in dict(
        A=(N, nx, nx), B=(N, nx, nu), c=(N, nx), Q=(N + 1, nx, nx), qx_base=(N + 1, nx),
        R=(N, nu, nu), ru_base=(N, nu), lbx=(N + 1, nx), ubx=(N + 1, nx), lbu=(N, nu),
        ubu=(N, nu)).items()}
    leaves.update(Jh=None, h0=None, S=None)
    return leaves


def test_range_refuses_13_states_before_launch():
    N, nx, nu = 4, 13, 4
    leaves = _zero_leaves(N, nx, nu)
    with pytest.raises(ValueError, match=r"2 ≤ nx ≤ 12 and 1 ≤ nu ≤ min\(nx, 6\).*\(13, 4\)"):
        rq._check_dims(N, nx, nu, 0, leaves, 1, 12)
    # the same check on the launch path, before any library is built or loaded
    calls = []
    real_launch, real_load = rq.launch, rq.load_qp_kernels
    rq.launch = lambda *a: calls.append("launch")
    rq.load_qp_kernels = lambda *a: calls.append("load")
    try:
        with pytest.raises(ValueError, match="got \\(nx, nu\\) = \\(13, 4\\)"):
            rq._launch(leaves, torch.zeros((1, nx)), 1, 12, 0.1, 0.35, 1e-3, None, None, 0.0)
    finally:
        rq.launch, rq.load_qp_kernels = real_launch, real_load
    assert calls == []
    inside = {(nx, nu) for nx in range(0, 16) for nu in range(0, 10) if rq.in_range(nx, nu)}
    assert inside == {(nx, nu) for nx in range(2, 13) for nu in range(1, min(nx, 6) + 1)}
    assert set(rq.SUPPORTED_DIMS) < inside


def test_launch_routes_by_shape(monkeypatch):
    """The package library's shapes launch from it; any other shape of the
    range from its own library, loaded (and at its first use built) by
    ``_build.load_qp_kernels``."""
    seen, loaded = [], []
    monkeypatch.setattr(rq, "launch", lambda entry, args, dev, *lib: seen.append((args.nx, lib)))
    monkeypatch.setattr(rq, "load_qp_kernels", lambda nx, nu: loaded.append((nx, nu)) or "lib")
    for nx, nu in ((3, 2), (9, 4), (5, 4), (12, 6)):
        rq._launch(_zero_leaves(4, nx, nu), torch.zeros((1, nx)), 1, 2, 0.1, 0.35, 1e-3, None,
                   None, 0.0)
    assert seen == [(3, ()), (9, ("lib",)), (5, ()), (12, ("lib",))]
    assert loaded == [(9, 4), (12, 6)]


def test_first_use_library_key_and_build(tmp_path, monkeypatch):
    """A shape's library is keyed by its defines (with the sources and the
    flags), built from ``csrc/riccati_qp.cu`` alone with the package's
    flags, reused when it is on disk, and without it a failed build
    raises: nothing falls back."""
    from dnn_mppi_mpc_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.qp_flags(9, 4) == ("-DDMM_QP_ONLY_NX=9", "-DDMM_QP_ONLY_NU=4")
    path = _build.qp_library_path(9, 4)
    assert path.parent == tmp_path and path.name.startswith("libdmm_qp_9x4_")
    assert path == _build.qp_library_path(9, 4) != _build.qp_library_path(6, 2)
    cmds = []

    def run_all(batch):
        cmds.extend(batch)
        out = batch[0][batch[0].index("-o") + 1]
        open(out, "wb").close()

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_all", run_all)
    assert _build.build_qp(9, 4) == path and path.exists()
    (cmd,) = cmds
    assert cmd[0] == "nvcc" and "-fmad=false" in cmd and "-shared" in cmd
    assert [c for c in cmd if c.endswith(".cu")] == [str(_build.CSRC / "riccati_qp.cu")]
    assert "-DDMM_QP_ONLY_NX=9" in cmd and "-DDMM_QP_ONLY_NU=4" in cmd
    assert _build.build_qp(9, 4) == path and len(cmds) == 1  # on disk: no nvcc

    def no_nvcc():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_qp(6, 2)
