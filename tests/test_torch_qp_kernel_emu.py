"""The fused QP kernel's own source, run on the CPU.

``csrc/riccati_qp.cu`` is compiled with g++ against ``tests/cuda_emu.h``
by ``tests/cuda_emu.py`` (the CUDA builtins it uses; every thread a fiber
on the calling thread, a warp's 32 lanes meeting at every shuffle and
``__syncwarp``; ``-ffp-contract=off`` as nvcc's ``-fmad=false``), and
``ops/cuda/riccati_qp.py``'s ``_launch`` drives it through ctypes on CPU
tensors, with its real argument block (``kernel_tables``, strides, the
shared-memory record count). So the kernel's indexing, its four phases,
the shuffles of phase B and the warp trees are checked here, where there
is no card, for each of the 13 instantiated (nx, nu): every case must
equal the plain version (``_qp_plain``) bit for bit, as the kernel equals
it on the card (``chip_smoke.py``). The same cases, and a batch of five,
run again on the kernel's device-memory route (the records in a workspace
put into the argument block, as the wrapper does past ``qp_max_horizon``;
the workspace filled with NaN first, so a record read before it is written
shows). Also: the C struct's size against the ctypes mirror,
and the launch's refusals (a record count other than the kernel's, no
problem, no stage, no iteration, an uninstantiated shape). Skips without
g++.
"""

from __future__ import annotations

import ctypes

import cuda_emu
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu_torch import _build
from dnn_mppi_mpc_tpu_torch.ops.cuda import riccati_qp as rq
from dnn_mppi_mpc_tpu_torch.solvers.qp import BoxedQPData


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernel source built for the CPU emulation; ``_launch`` pointed at it."""
    lib = cuda_emu.build(["riccati_qp.cu"], tmp_path_factory.mktemp("qp_emu"))
    if lib is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    lib.dmm_barrier_qp.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dmm_barrier_qp.restype = ctypes.c_int
    lib.dmm_qp_args_size.restype = ctypes.c_int

    def launch(entry, args, device):
        assert entry == "dmm_barrier_qp" and device.type == "cpu"
        err = lib.dmm_barrier_qp(ctypes.addressof(args), None)
        if err != 0:
            raise RuntimeError(f"{entry}: error {err} at launch")

    mp = pytest.MonkeyPatch()
    mp.setattr(rq, "launch", launch)
    yield lib
    mp.undo()


def _random_qp(rng, N, nx, nu, n_h, with_S, B):
    """tests/test_riccati_qp.py's ``_random_qp`` generator, B problems."""
    lead = (B,)

    def spd(n):
        M = rng.normal(size=lead + (n, n)) * 0.3
        return M @ np.swapaxes(M, -1, -2) + np.eye(n)

    def t(a):
        return None if a is None else torch.tensor(a, dtype=torch.float32)

    qp = BoxedQPData(
        A=t(np.eye(nx) + 0.05 * rng.normal(size=lead + (N, nx, nx))),
        B=t(0.2 * rng.normal(size=lead + (N, nx, nu))),
        c=t(0.05 * rng.normal(size=lead + (N, nx))),
        Q=t(np.stack([spd(nx) for _ in range(N + 1)], axis=-3)),
        qx_base=t(0.5 * rng.normal(size=lead + (N + 1, nx))),
        R=t(np.stack([spd(nu) for _ in range(N)], axis=-3)),
        ru_base=t(0.5 * rng.normal(size=lead + (N, nu))),
        lbx=t(1.5 + 0.2 * rng.random(lead + (N + 1, nx))),
        ubx=t(1.5 + 0.2 * rng.random(lead + (N + 1, nx))),
        lbu=t(1.0 + 0.2 * rng.random(lead + (N, nu))),
        ubu=t(1.0 + 0.2 * rng.random(lead + (N, nu))),
        Jh=t(rng.normal(size=lead + (N + 1, n_h, nx))) if n_h else None,
        h0=t(1.0 + rng.random(lead + (N + 1, n_h))) if n_h else None,
        S=t(0.1 * rng.normal(size=lead + (N, nu, nx))) if with_S else None,
    )
    return qp, t(0.2 * rng.normal(size=(B, nx)))


def _solve_both(qp, dx0, iters):
    leaves, x0, B, _ = rq.batch_leaves(qp, dx0, torch.float32)
    kw = dict(num_iters=iters, mu0=1e-1, kappa=0.35, delta=1e-3, stiffness=None,
              h_stiffness=None, h_slope=0.0)
    got = rq._launch(leaves, x0, B, **kw)
    mus, misc = rq.qp_schedule(iters, 1e-1, 0.35, 1e-3, None, None, 0.0, x0.device)
    return got, rq._qp_plain(leaves, x0, mus, misc, iters)


def _assert_equal(got, want):
    for name, g, w in zip(("dX", "dU", "kkt"), got, want):
        err = float((g - w).abs().max())
        print(f"{name}: max abs err {err:.3e} (limit 0: bit for bit)")
        assert torch.isfinite(g).all() and torch.equal(g, w), name


# (N, nx, nu, n_h, S, iterations): every instantiated (nx, nu), among them
# nmpc_rti's shape, the four-wheel IRK's, and horizons past one lane round
# (33, 40) and of four (100); few iterations, as every emulated shuffle is a
# round of thread barriers
CASES = [
    (30, 3, 2, 2, False, 4),
    (30, 3, 2, 0, True, 3),
    (20, 5, 4, 0, False, 3),
    (33, 5, 1, 2, True, 3),
    (40, 4, 2, 1, False, 3),
    (9, 3, 3, 2, True, 6),
    (8, 2, 1, 0, False, 8),
    (100, 5, 4, 2, True, 1),
    (12, 2, 2, 1, True, 4),
    (10, 3, 1, 0, False, 5),
    (11, 4, 1, 2, False, 4),
    (10, 4, 3, 0, True, 4),
    (14, 4, 4, 1, False, 3),
    (35, 5, 2, 1, True, 2),
    (10, 5, 3, 2, False, 4),
]


@pytest.mark.parametrize("N,nx,nu,n_h,with_S,iters", CASES,
                         ids=[f"N{c[0]}_{c[1]}{c[2]}_nh{c[3]}{'_S' if c[4] else ''}"
                              for c in CASES])
def test_kernel_source_equals_plain_one_problem(emu, N, nx, nu, n_h, with_S, iters):
    qp, dx0 = _random_qp(np.random.default_rng(N * 10 + nx), N, nx, nu, n_h, with_S, 1)
    _assert_equal(*_solve_both(qp, dx0, iters))


@pytest.fixture
def workspace(emu, monkeypatch):
    """``_launch``'s own argument block with a workspace of Bn·(N + 1)
    records (NaN-filled) put in before the C entry runs it: the route the
    wrapper takes past ``qp_max_horizon``. Yields the workspaces handed over."""
    given = []

    def launch(entry, args, device):
        assert entry == "dmm_barrier_qp" and args.work is None
        work = torch.full((args.Bn * (args.N + 1) * args.stage_floats,), float("nan"))
        given.append(work)
        args.work = work.data_ptr()
        err = emu.dmm_barrier_qp(ctypes.addressof(args), None)
        if err != 0:
            raise RuntimeError(f"{entry}: error {err} at launch")

    monkeypatch.setattr(rq, "launch", launch)
    yield given


@pytest.mark.parametrize("N,nx,nu,n_h,with_S,iters", CASES,
                         ids=[f"N{c[0]}_{c[1]}{c[2]}_nh{c[3]}{'_S' if c[4] else ''}"
                              for c in CASES])
def test_workspace_route_equals_plain_one_problem(workspace, N, nx, nu, n_h, with_S, iters):
    qp, dx0 = _random_qp(np.random.default_rng(N * 10 + nx), N, nx, nu, n_h, with_S, 1)
    _assert_equal(*_solve_both(qp, dx0, iters))
    (work,) = workspace
    assert work.numel() == (N + 1) * rq.qp_stage_floats(nx, nu, n_h, with_S)
    # the records were written there: the iterate at stage 0 is dx0
    assert not bool(torch.isnan(work).all())


def test_workspace_route_equals_plain_batched(workspace):
    """B = 5 problems at (5, 4), two h rows and S, each at its own offset of
    the workspace, with one leaf shared by all (problem stride 0)."""
    B, N, nx = 5, 12, 5
    qp, dx0 = _random_qp(np.random.default_rng(5), N, nx, 4, 2, True, B)
    qp = qp._replace(ubx=qp.ubx[0])
    got, want = _solve_both(qp, dx0, 4)
    _assert_equal(got, want)
    (work,) = workspace
    ss = rq.qp_stage_floats(nx, 4, 2, True)
    assert work.numel() == B * (N + 1) * ss
    # problem b's records at b·(N + 1)·stage_floats: their δx field (offset
    # nx² + 3·nx in csrc/riccati_qp.cu Rec) holds b's own δX
    records = work.reshape(B, N + 1, ss)
    dx_off = nx * nx + 3 * nx
    assert torch.equal(records[:, :, dx_off:dx_off + nx], got[0])


def test_every_instantiation_is_covered():
    assert sorted({(c[1], c[2]) for c in CASES}) == sorted(rq.SUPPORTED_DIMS)


@pytest.mark.parametrize("B,iters", [(7, 6), (3, 12)])
def test_kernel_source_equals_plain_batched(emu, B, iters):
    """B problems, a block each, with one leaf shared by all (problem stride
    0), R one stage for all (stage stride 0) and A, B column blocks of one
    Jacobian (row stride nx + nu), as the fleet's QP hands them over."""
    N = 6
    qp, dx0 = _random_qp(np.random.default_rng(3), N, 3, 2, 1, False, B)
    AB = torch.cat([qp.A, qp.B], dim=3)
    qp = qp._replace(lbx=qp.lbx[0], R=qp.R[:1, :1].expand(B, N, 2, 2), A=AB[..., :3],
                     B=AB[..., 3:])
    _assert_equal(*_solve_both(qp, dx0, iters))


def test_argument_block_size(emu):
    assert emu.dmm_qp_args_size() == ctypes.sizeof(_build.DmmQPArgs)


@pytest.mark.parametrize("field,change", [("stage_floats", 2), ("Bn", -1), ("N", -4),
                                          ("num_iters", -2), ("nx", 3)])
def test_launch_refusals(emu, field, change):
    """The C entry refuses, without launching, a record count other than
    the kernel's, no problem, no stage, no iteration, or nx = 6."""
    qp, dx0 = _random_qp(np.random.default_rng(1), 4, 3, 2, 0, False, 1)
    leaves, x0, B, _ = rq.batch_leaves(qp, dx0, torch.float32)
    kw = dict(num_iters=2, mu0=1e-1, kappa=0.35, delta=1e-3, stiffness=None,
              h_stiffness=None, h_slope=0.0)
    real = rq.launch
    seen = []

    def capture(entry, args, device):
        seen.append(args)
        real(entry, args, device)

    rq.launch = capture
    try:
        rq._launch(leaves, x0, B, **kw)
    finally:
        rq.launch = real
    args = seen[0]
    assert args.stage_floats == rq.qp_stage_floats(3, 2, 0, False)
    bad = type(args).from_buffer_copy(args)
    setattr(bad, field, getattr(args, field) + change)
    assert emu.dmm_barrier_qp(ctypes.addressof(bad), None) != 0, field


def test_kernel_source_equals_plain_on_the_first_nmpc_rti_qp(emu):
    """The first nmpc_rti tick's own QP (from x0 = 0, θ = 0): half of its
    back-substitution dividends are exact zeros; the quotients' bits,
    signed zeros included, must be the plain version's."""
    from dnn_mppi_mpc_tpu_torch import presets
    from dnn_mppi_mpc_tpu_torch.solvers import sqp

    solver, params = presets.diff_drive_nmpc([3.0, 2.0, 0.0], N=30,
                                             obstacles=[[1.5, 1.0, 0.3], [2.5, 1.8, 0.3]],
                                             sqp_iters=1, qp_backend="kernel", device="cpu")
    seen = []
    real = sqp.fused_barrier_qp_solve

    def spy(qp, dx0, **kw):
        seen.append((qp, dx0, kw))
        return real(qp, dx0, **kw)

    sqp.fused_barrier_qp_solve = spy
    try:
        x0 = torch.zeros(3)
        solver.solve(params, solver.init(x0), x0)
    finally:
        sqp.fused_barrier_qp_solve = real
    qp, dx0, kw = seen[0]
    leaves, x0, B, _ = rq.batch_leaves(qp, dx0, torch.float32)
    kw = dict(kw, num_iters=3, stiffness=None)
    got = rq._launch(leaves, x0, B, **kw)
    mus, misc = rq.qp_schedule(3, kw["mu0"], kw["kappa"], kw["delta"], None,
                               kw["h_stiffness"], kw["h_slope"], x0.device)
    want = rq._qp_plain(leaves, x0, mus, misc, 3)
    _assert_equal(got, want)
    for g, w in zip(got, want):  # signed zeros too
        assert torch.equal(torch.signbit(g), torch.signbit(w))
