"""The fused QP kernel's layout, on the CPU: what the wrappers hand the
kernel, and the shared-memory budget that picks its route.

* ``qp_stage_floats`` against a field-by-field count of the stage record
  (csrc/riccati_qp.cu ``Rec``), for the 13 instantiated (nx, nu), n_h ∈
  {0, 2}, with and without S: N = 100 fits one block; at the largest N that
  ``qp_max_horizon`` names ``_launch`` hands the kernel no workspace (the
  records in shared memory), at N + 1 a workspace of (N + 2) records
  (device memory), and neither raises;
* ``kernel_tables``: problem-major tables, each the leaf's own memory (a
  view, not a copy) for contiguous leaves, leaves shared by all problems
  (problem stride 0), stage-invariant ones (stage stride 0, the fleet's R)
  and column blocks of one wider matrix (row stride nx + nu, the
  linearization's A and B); a leaf with a strided last dimension is
  copied; every element addressed as the kernel addresses it;
* ``_launch``'s argument block: one block a problem, the record length,
  and each table's pointer and strides as ``kernel_tables`` gives them.
"""

from __future__ import annotations

import pytest
import torch

from dnn_mppi_mpc_tpu_torch.ops.cuda import riccati_qp as rq
from dnn_mppi_mpc_tpu_torch.ops.cuda.common import MAX_SMEM_OPT_IN
from dnn_mppi_mpc_tpu_torch.solvers.qp import BoxedQPData

SHAPES = [(nx, nu, n_h, S) for nx, nu in rq.SUPPORTED_DIMS for n_h in (0, 2) for S in (False, True)]
SHAPE_IDS = [f"nx{nx}_nu{nu}_nh{n_h}{'_S' if S else ''}" for nx, nu, n_h, S in SHAPES]


def _record_floats(nx, nu, n_h, S):
    """The stage record's fields, one by one (csrc/riccati_qp.cu Rec)."""
    x_part = dict(Q=nx * nx, qx=nx, lbx=nx, ubx=nx, dX=nx, ddX=nx, Qxx=nx * nx, q=nx)
    u_part = dict(A=nx * nx, B=nx * nu, c=nx, R=nu * nu, ru=nu, lbu=nu, ubu=nu, dU=nu, ddU=nu,
                  K=nu * nx, k=nu, cr=nx, Ruu=nu * nu, r_u=nu)
    tail = dict(Jh=n_h * nx, h0=n_h, S=nu * nx if S else 0)
    n = sum(x_part.values()) + sum(u_part.values()) + sum(tail.values())
    return n + 1 - n % 2  # odd: 32 lanes on 32 stages hit 32 banks


def _zero_leaves(B, N, nx, nu, n_h, S):
    shapes = dict(A=(N, nx, nx), B=(N, nx, nu), c=(N, nx), Q=(N + 1, nx, nx),
                  qx_base=(N + 1, nx), R=(N, nu, nu), ru_base=(N, nu), lbx=(N + 1, nx),
                  ubx=(N + 1, nx), lbu=(N, nu), ubu=(N, nu), Jh=(N + 1, n_h, nx),
                  h0=(N + 1, n_h), S=(N, nu, nx))
    leaves = {n: torch.zeros((B,) + s) for n, s in shapes.items()}
    if not n_h:
        leaves["Jh"] = leaves["h0"] = None
    if not S:
        leaves["S"] = None
    return leaves


@pytest.mark.parametrize("nx,nu,n_h,S", SHAPES, ids=SHAPE_IDS)
def test_horizon_budget(nx, nu, n_h, S, monkeypatch):
    assert rq.qp_stage_floats(nx, nu, n_h, S) == _record_floats(nx, nu, n_h, S)
    assert rq.qp_smem_bytes(100, nx, nu, n_h, S) <= MAX_SMEM_OPT_IN
    assert not rq.qp_uses_workspace(100, nx, nu, n_h, S)
    n_max = rq.qp_max_horizon(nx, nu, n_h, S)
    assert n_max >= 100
    assert rq.qp_smem_bytes(n_max, nx, nu, n_h, S) <= MAX_SMEM_OPT_IN
    assert rq.qp_smem_bytes(n_max + 1, nx, nu, n_h, S) > MAX_SMEM_OPT_IN
    assert not rq.qp_uses_workspace(n_max, nx, nu, n_h, S)
    assert rq.qp_uses_workspace(n_max + 1, nx, nu, n_h, S)
    # the wrapper's launch path: shared memory up to n_max, a workspace of
    # the problem's records past it; no horizon raises
    seen = []
    monkeypatch.setattr(rq, "launch", lambda entry, args, dev: seen.append(args.work))
    for N in (n_max, n_max + 1):
        leaves = _zero_leaves(1, N, nx, nu, n_h, S)
        rq._launch(leaves, torch.zeros((1, nx)), 1, 12, 0.1, 0.35, 1e-3, None, None, 0.0)
    assert seen[0] is None and seen[1] is not None


def test_workspace_size(monkeypatch):
    """Past the boundary the workspace holds B·(N + 1) records of the
    problem's record length, float32, on the leaves' device."""
    B, N, nx, nu, n_h = 3, 300, 5, 4, 2
    assert rq.qp_uses_workspace(N, nx, nu, n_h, True)
    made = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made.append(t)
        return t

    seen = []
    monkeypatch.setattr(rq.torch, "empty", empty)
    monkeypatch.setattr(rq, "launch", lambda entry, args, dev: seen.append(args.work))
    rq._launch(_zero_leaves(B, N, nx, nu, n_h, True), torch.zeros((B, nx)), B, 12, 0.1, 0.35,
               1e-3, None, None, 0.0)
    (work,) = [t for t in made if t.data_ptr() == seen[0]]
    assert work.dtype == torch.float32 and work.device.type == "cpu"
    assert work.numel() == B * (N + 1) * rq.qp_stage_floats(nx, nu, n_h, True)


def _addressed(t, b_stride, s_stride, r_stride, b, i, rows, cols):
    """Stage i of problem b as the kernel reads it: element (row, col) at
    b·b_stride + i·s_stride + row·r_stride + col in the tensor's memory."""
    return torch.as_strided(t, (rows, cols), (r_stride, 1),
                            t.storage_offset() + b * b_stride + i * s_stride)


def test_kernel_tables_are_problem_major_views():
    B, N, nx, nu, n_h = 3, 5, 3, 2, 2
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    R_shared = rnd(nu, nu)
    AB = rnd(B, N, nx, nx + nu)  # one Jacobian [A | B] a stage
    qp = BoxedQPData(
        A=AB[..., :nx], B=AB[..., nx:], c=rnd(B, N, nx), Q=rnd(B, N + 1, nx, nx),
        qx_base=rnd(B, N + 1, nx), R=R_shared[None, None].expand(B, N, nu, nu),
        ru_base=rnd(B, N, nu), lbx=rnd(N + 1, nx), ubx=rnd(N + 1, nx), lbu=rnd(B, N, nu),
        ubu=rnd(B, N, nu), Jh=rnd(B, N + 1, n_h, nx), h0=rnd(B, N + 1, n_h),
        S=rnd(B, N, nx, nu).transpose(2, 3))
    dx0 = rnd(B, nx)
    leaves, x0, Bn, batched = rq.batch_leaves(qp, dx0, torch.float32)
    assert (Bn, batched) == (B, True)
    tabs = rq.kernel_tables(leaves, x0)
    assert len(tabs) == len(rq.TABLES) + 1
    for name, (t, b_stride, s_stride, r_stride) in zip(rq.TABLES + ("dx0",), tabs):
        leaf = x0[:, None] if name == "dx0" else leaves[name]
        if name == "S":  # a transposed leaf: its last dimension is strided, so copied
            assert t.data_ptr() != leaf.data_ptr() and t.is_contiguous()
        else:  # a view of the leaf's own memory
            assert t.data_ptr() == leaf.data_ptr(), name
        if name in ("lbx", "ubx"):  # shared by all problems
            assert b_stride == 0 and t.data_ptr() == getattr(qp, name).data_ptr()
        elif name == "R":  # one stage for all stages and problems
            assert (b_stride, s_stride) == (0, 0) and t.data_ptr() == R_shared.data_ptr()
        elif name in ("A", "B"):  # column blocks of the Jacobian
            assert (b_stride, s_stride, r_stride) == AB.stride()[:3], name
        else:
            assert (b_stride, s_stride) == (leaf[0].numel(), leaf[0, 0].numel()), name
        rows, cols = (leaf.shape[2], leaf.shape[3]) if leaf.dim() == 4 else (1, leaf.shape[2])
        for b in range(B):
            for i in range(leaf.shape[1]):
                torch.testing.assert_close(
                    _addressed(t, b_stride, s_stride, r_stride, b, i, rows, cols),
                    leaf[b, i].reshape(rows, cols), rtol=0, atol=0)


def test_kernel_tables_of_one_problem_are_the_leaves():
    """The per-problem wrapper's leaves (a batch of one) are passed as they
    lie; absent leaves are null."""
    leaves = _zero_leaves(1, 4, 3, 2, 0, False)
    x0 = torch.zeros((1, 3))
    tabs = rq.kernel_tables(leaves, x0)
    for name, (t, _, _, _) in zip(rq.TABLES, tabs):
        if leaves[name] is None:
            assert t is None
        else:
            assert t.data_ptr() == leaves[name].data_ptr()


def test_launch_argument_block(monkeypatch):
    """What ``_launch`` hands the C entry for B = 130 fleet-shaped problems
    (a block each): the shapes, the record length, the tables as
    ``kernel_tables`` passes them, and outputs of (B, N+1, nx), (B, N, nu)
    and (B,)."""
    B, N, nx, nu, n_h = 130, 30, 3, 2, 1
    leaves = _zero_leaves(B, N, nx, nu, n_h, False)
    leaves["lbx"] = torch.zeros(N + 1, nx).expand(B, N + 1, nx)  # shared by all
    x0 = torch.zeros((B, nx))
    seen = []
    monkeypatch.setattr(rq, "launch", lambda entry, args, dev: seen.append((entry, args)))
    dX, dU, kkt = rq._launch(leaves, x0, B, 12, 0.1, 0.35, 1e-3, None, None, 0.0)
    assert (dX.shape, dU.shape, kkt.shape) == ((B, N + 1, nx), (B, N, nu), (B,))
    (entry, args), = seen
    assert entry == "dmm_barrier_qp"
    assert (args.Bn, args.N, args.nx, args.nu, args.n_h, args.num_iters, args.has_S) == (
        B, N, nx, nu, n_h, 12, 0)
    assert args.stage_floats == rq.qp_stage_floats(nx, nu, n_h, False)
    assert (args.dX, args.dU, args.kkt) == (dX.data_ptr(), dU.data_ptr(), kkt.data_ptr())
    for j, (t, b_stride, s_stride, r_stride) in enumerate(rq.kernel_tables(leaves, x0)):
        assert args.tab[j] == (None if t is None else t.data_ptr())
        assert (args.b_stride[j], args.s_stride[j], args.r_stride[j]) == (
            b_stride, s_stride, r_stride)
    assert args.b_stride[rq.TABLES.index("lbx")] == 0
