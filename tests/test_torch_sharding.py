"""The port's sample-sharded two-phase tick and sharded fleet.

* world size 1 (a gloo group on an in-memory ``HashStore``): the port's
  ``make_sharded_fused_mppi_step(k_blk=128)`` against the JAX
  ``make_sharded_fused_mppi_step(gaussian="hash", interpret=True,
  k_blk=128)`` on 1-, 2- and 4-device meshes of the virtual CPU mesh, as
  __graft_entry__.py:258-317 sweeps it: the same u0 at every shard count
  (controls rtol 1e-4, atol 1e-5, as tests/test_sharded_fused.py:233);
* world size 1 against the port's own K-blocked tick: the same stream, so S
  is equal bit for bit and the update agrees to the reductions' order;
* two ranks spawned with ``torch.multiprocessing`` on a gloo group over a
  ``FileStore`` (no port for the rendezvous): u0 at world size 2 equals
  world size 1, and each rank's slice of the sharded fleet equals the
  whole fleet's members; the ranks are joined with their own time limit;
* the guards (B % n, ``fused=False`` without the costs, the divisibility of K
  and k_blk);
* the scan-path sharded step ``make_sharded_mppi_step`` with the generic
  rollout (four-wheel torque model) as its ``rollout_fn``: at world size 1
  against the JAX ``make_sharded_mppi_step`` with
  ``make_generic_pallas_rollout(interpret=True)`` on 1-, 2- and 4-device
  meshes, on the same injected ε (S rtol/atol 3e-4, controls rtol 1e-4 atol
  1e-5, as tests/test_generic_tick.py:114-123); on two gloo ranks equal to
  the unsharded step (u0 rtol 1e-5 atol 1e-6, costs 1e-4, as
  tests/test_generic_tick.py:367-370), and without injected ε each rank's
  own draws are N(0, Σ) by moments and give the step's u0;
* the sharded NMPC fleet ``make_sharded_nmpc_fleet`` (the suite's
  ``presets.nmpc_fleet`` at B = 4, N = 5, kernel QP backend, its plain
  version here): at world size 1 equal to ``batched_solve`` (exactly: the
  same ops), on two gloo ranks each rank's members equal the same members
  of the unsharded fleet (rtol 1e-5, atol 1e-6: the batched ops see two
  members instead of four), and B % n raises.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from jax.sharding import Mesh

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models.dynamics import four_wheel_torque as j_four_wheel
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.models.tile import four_wheel_torque_tile as j_four_wheel_tile
from dnn_mppi_mpc_tpu.parallel.sharding import make_sharded_fused_mppi_step as j_sharded
from dnn_mppi_mpc_tpu.parallel.sharding import make_sharded_mppi_step as j_sharded_scan
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch import parallel, presets
from dnn_mppi_mpc_tpu_torch.models import euler_step, four_wheel_torque, four_wheel_torque_tile, unicycle
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern
from dnn_mppi_mpc_tpu_torch.ops.sampling import sample_noise
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

K, T, W, DT, KB = 1024, 8, 8, 0.05, 128
JOIN_SECONDS = 120


def _problem():
    kw = dict(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT, lam=0.8, alpha=0.3,
              exploration=0.2, filter_window=4, waypoint_search_len=W)
    n = 40
    p = dict(
        sigma=np.array([[0.09, 0.0], [0.0, 0.04]], np.float32),
        stage_weight=np.array([3.0, 3.0, 1.0], np.float32),
        terminal_weight=np.array([5.0, 5.0, 2.0], np.float32),
        u_min=np.array([-2.0, -1.5], np.float32),
        u_max=np.array([2.0, 1.5], np.float32),
        ref_path=np.stack([np.linspace(0, 4, n), np.sin(np.linspace(0, 2, n)),
                           np.linspace(0.1, 0.5, n)], 1).astype(np.float32),
    )
    return kw, p


X0 = np.array([0.05, 0.1, 0.2], np.float32)
U_PREV = np.random.default_rng(3).normal(0, 0.3, (T, 2)).astype(np.float32)
KEY = [7, 0xC0FFEE]


def _port_step(k_blk=KB, **kw):
    cfg_kw, p = _problem()
    cfg = tcfg.MPPIConfig(**cfg_kw)
    step = parallel.make_sharded_fused_mppi_step(
        cfg, lambda x, u: euler_step(unicycle, x, u, DT), k_blk=k_blk, device="cpu", **kw)
    return step(tcfg.params_from_numpy(**p, device="cpu"),
                tmppi.state_from_numpy(U_PREV, 2, KEY, device="cpu"), torch.as_tensor(X0))


@pytest.fixture
def gloo_world1():
    """A single-process gloo group for the test, torn down after it."""
    assert not dist.is_initialized()
    assert parallel.initialize_distributed(device="cpu") == (0, 1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_sharded_step_world1_matches_jax_meshes(gloo_world1):
    u0_t, st_t, aux_t = _port_step(iso_xy=True)
    cfg_kw, p = _problem()
    jc = jcfg.MPPIConfig(**cfg_kw)
    jp = jcfg.MPPIParams(**{k: jnp.asarray(v) for k, v in p.items()})
    jst = jmppi.MPPIState(u_prev=jnp.asarray(U_PREV), waypoint_idx=jnp.asarray(2, jnp.int32),
                          key=jnp.asarray(KEY, jnp.uint32))
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        for n_sh in (1, 2, 4):
            mesh = Mesh(np.asarray(jax.devices()[:n_sh]), ("k",))
            f = j_sharded(jc, lambda x, u: j_euler(j_unicycle, x, u, DT), mesh, axis="k",
                          gaussian="hash", interpret=True, k_blk=KB, iso_xy=True)
            u0_j, st_j, aux_j = f(jp, jst, jnp.asarray(X0))
            np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev),
                                       rtol=1e-4, atol=1e-5)
            assert int(st_t.waypoint_idx) == int(st_j.waypoint_idx)
            assert int(aux_t.status) == int(aux_j.status)
            kd = np.asarray(jax.random.key_data(st_j.key)
                            if jnp.issubdtype(st_j.key.dtype, jax.dtypes.prng_key) else st_j.key)
            assert st_t.key.tolist() == kd.astype(np.int64).tolist()
            if n_sh == 1:
                np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs),
                                           rtol=2e-5, atol=2e-4)
    finally:
        jax.config.update("jax_enable_x64", old)


def test_sharded_step_world1_equals_the_blocked_tick(gloo_world1):
    """Phase 1 and phase 2 draw one stream: at world size 1 the sharded step
    is the K-blocked tick with the same seed and block size."""
    u0_s, st_s, aux_s = _port_step()
    cfg_kw, p = _problem()
    cfg = tcfg.MPPIConfig(**cfg_kw)
    tick = tmppi.make_cuda_diffdrive_tick_blocked(cfg, k_block=KB)
    u0_b, st_b, aux_b = tmppi.mppi_step(
        cfg, lambda x, u: euler_step(unicycle, x, u, DT), None, None,
        tcfg.params_from_numpy(**p, device="cpu"),
        tmppi.state_from_numpy(U_PREV, 2, KEY, device="cpu"),
        torch.as_tensor(X0), tick_fn=tick)
    torch.testing.assert_close(aux_s.costs, aux_b.costs, rtol=0, atol=0)
    torch.testing.assert_close(aux_s.weights, aux_b.weights, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(u0_s, u0_b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(st_s.u_prev, st_b.u_prev, rtol=1e-5, atol=1e-6)
    assert st_s.key.tolist() == st_b.key.tolist()


def test_sharded_guards_raise(gloo_world1):
    cfg_kw, _ = _problem()
    cfg = tcfg.MPPIConfig(**cfg_kw)
    plant = lambda x, u: euler_step(unicycle, x, u, DT)  # noqa: E731
    with pytest.raises(ValueError, match="k_blk"):
        parallel.make_sharded_fused_mppi_step(cfg, plant, k_blk=384, device="cpu")
    with pytest.raises(ValueError, match="SUM"):
        parallel.make_sharded_fused_mppi_step(
            dataclasses.replace(cfg, accumulation=tcfg.CostAccumulation.LAST), plant,
            k_blk=KB, device="cpu")
    with pytest.raises(ValueError, match="fused=False"):
        parallel.make_sharded_mppi_fleet(cfg, plant, fused=False, device="cpu")
    step, params, states, plant = presets.mppi_fleet(4, 128, 6, device="cpu")
    fleet = parallel.make_sharded_mppi_fleet(step.cfg, plant, device="cpu")
    assert fleet.members(4) == slice(0, 4)
    u0s, _, _ = fleet(params, states, torch.zeros(4, 3))
    u0f, _, _ = step(params, states, torch.zeros(4, 3))
    torch.testing.assert_close(u0s, u0f, rtol=0, atol=0)


# --- the scan-path sharded step with the generic rollout ---------------------------

KG, TG = 1024, 8
GEN_OBSTACLES = np.array([[1.2, 0.3, 0.3]], np.float32)
GEN_X0 = np.array([0.1, -0.05, 0.2, 0.3, 0.05], np.float32)
GEN_U_PREV = np.random.default_rng(4).normal(0, 0.3, (TG, 4)).astype(np.float32)


def _generic_problem():
    """The four-wheel problem of tests/test_generic_tick.py:336-358 with one
    circle obstacle: (config kwargs, params as numpy, injected ε (KG, TG, 4))."""
    kw = dict(num_samples=KG, horizon=TG, dim_x=5, dim_u=4, dt=DT, lam=0.8, alpha=0.3,
              exploration=0.25, filter_window=5, waypoint_search_len=8)
    rng = np.random.default_rng(13)
    A = rng.normal(0.0, 0.2, (4, 4))
    sigma = (A @ A.T + 0.05 * np.eye(4)).astype(np.float32)
    n = 40
    p = dict(sigma=sigma, stage_weight=np.array([4.0, 4.0, 0.5], np.float32),
             terminal_weight=np.array([9.0, 9.0, 2.0], np.float32),
             u_min=np.full(4, -2.0, np.float32), u_max=np.full(4, 2.0, np.float32),
             ref_path=np.stack([np.linspace(0, 4, n), np.sin(np.linspace(0, 2, n)),
                                np.linspace(0.1, 0.5, n)], 1).astype(np.float32),
             obstacles=GEN_OBSTACLES)
    eps = rng.multivariate_normal(np.zeros(4), sigma.astype(np.float64), (KG, TG))
    return kw, p, eps.astype(np.float32)


def _port_generic(cfg_kw=None):
    """The port's side: cfg, params, plant, costs and the generic rollout."""
    kw, p, eps = _generic_problem()
    cfg = tcfg.MPPIConfig(**(cfg_kw or kw))
    stage, terminal = tmppi.make_tracking_costs(cfg, collision="circle", robot_radius=0.4)
    rollout = tmppi.make_cuda_generic_rollout(cfg, four_wheel_torque_tile(DT), robot_radius=0.4)
    plant = lambda x, u: euler_step(four_wheel_torque, x, u, DT)  # noqa: E731
    return cfg, tcfg.params_from_numpy(**p, device="cpu"), plant, stage, terminal, rollout, eps


def _generic_state():
    return tmppi.state_from_numpy(GEN_U_PREV, 2, KEY, device="cpu")


def _unsharded_generic(eps):
    cfg, params, plant, stage, terminal, rollout, _ = _port_generic()
    return tmppi.mppi_step(cfg, plant, stage, terminal, params, _generic_state(),
                           torch.as_tensor(GEN_X0), torch.as_tensor(eps), rollout_fn=rollout)


def test_sharded_scan_step_world1_matches_jax_meshes(gloo_world1):
    cfg, params, plant, stage, terminal, rollout, eps = _port_generic()
    step = parallel.make_sharded_mppi_step(cfg, plant, stage, terminal, rollout_fn=rollout,
                                           device="cpu")
    assert step.samples == slice(0, KG)
    calls = kern.generic_rollout_costs_plain.calls
    u0_t, st_t, aux_t = step(params, _generic_state(), torch.as_tensor(GEN_X0),
                             torch.as_tensor(eps))
    assert kern.generic_rollout_costs_plain.calls == calls + 1
    kw, p, _ = _generic_problem()
    jc = jcfg.MPPIConfig(**kw)
    jp = jcfg.MPPIParams(**{k: jnp.asarray(v) for k, v in p.items()})
    jst = jmppi.MPPIState(u_prev=jnp.asarray(GEN_U_PREV), waypoint_idx=jnp.asarray(2, jnp.int32),
                          key=jnp.asarray(KEY, jnp.uint32))
    jstage, jterm = jmppi.make_tracking_costs(jc, collision="circle", robot_radius=0.4)
    jroll = jmppi.make_generic_pallas_rollout(jc, j_four_wheel_tile(DT, sincos="native"),
                                              robot_radius=0.4, interpret=True)
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        for n_sh in (1, 2, 4):
            mesh = Mesh(np.asarray(jax.devices()[:n_sh]), ("k",))
            f = j_sharded_scan(jc, lambda x, u: j_euler(j_four_wheel, x, u, DT), jstage, jterm,
                               mesh, axis="k", rollout_fn=jroll)
            u0_j, st_j, aux_j = f(jp, jst, jnp.asarray(GEN_X0), jnp.asarray(eps))
            np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs),
                                       rtol=3e-4, atol=3e-4)
            np.testing.assert_allclose(aux_t.weights.numpy(), np.asarray(aux_j.weights),
                                       rtol=3e-4, atol=1e-6)
            np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev),
                                       rtol=1e-4, atol=1e-5)
            assert int(st_t.waypoint_idx) == int(st_j.waypoint_idx)
            assert int(aux_t.status) == int(aux_j.status)
    finally:
        jax.config.update("jax_enable_x64", old)


def test_sharded_scan_step_guards(gloo_world1):
    cfg, params, plant, stage, terminal, rollout, eps = _port_generic()
    step = parallel.make_sharded_mppi_step(cfg, plant, stage, terminal, rollout_fn=rollout,
                                           device="cpu")
    with pytest.raises(ValueError, match="samples"):
        step(params, _generic_state(), torch.as_tensor(GEN_X0), torch.as_tensor(eps[:KG // 2]))
    with pytest.raises(ValueError, match="single-device"):
        tmppi.mppi_step(cfg, plant, stage, terminal, params, _generic_state(),
                        torch.as_tensor(GEN_X0), torch.as_tensor(eps), tick_fn=lambda *a: None,
                        group=dist.group.WORLD)


# --- two ranks -------------------------------------------------------------------


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of a two-process gloo group: the sharded tick, this rank's
    slice of a sharded fleet and the scan-path sharded step with the generic
    rollout, saved for the parent to compare."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank,
                            world_size=2)
    try:
        cfg, params, plant, stage, terminal, rollout, eps = _port_generic()
        gstep = parallel.make_sharded_mppi_step(cfg, plant, stage, terminal,
                                                rollout_fn=rollout, device="cpu")
        x0 = torch.as_tensor(GEN_X0)
        gu0, gst, gaux = gstep(params, _generic_state(), x0, torch.as_tensor(eps))
        drawn = gstep.generator.get_state()
        nu0, nst, _ = gstep(params, _generic_state(), x0)
        gstep.generator.set_state(drawn)
        own_eps = sample_noise(gstep.generator, params.sigma, KG // 2, TG)
        try:
            parallel.make_sharded_mppi_step(dataclasses.replace(cfg, num_samples=KG + 1), plant,
                                            stage, terminal, rollout_fn=rollout, device="cpu")
            k_raised = False
        except ValueError:
            k_raised = True
        torch.save(dict(u0=gu0, u_prev=gst.u_prev, costs=gaux.costs,
                        samples=(gstep.samples.start, gstep.samples.stop),
                        own_u0=nu0, own_u_prev=nst.u_prev, own_eps=own_eps, k_raised=k_raised),
                   f"{out_dir}/generic{rank}.pt")
        u0, st, aux = _port_step()
        fstep, params, states, plant = presets.mppi_fleet(4, 128, 6, device="cpu")
        fleet = parallel.make_sharded_mppi_fleet(fstep.cfg, plant, device="cpu")
        x0s = torch.tensor(np.random.default_rng(8).uniform(-0.3, 0.3, (4, 3)),
                           dtype=torch.float32)
        fu0, fst, _ = fleet(params, states, x0s)
        try:
            fleet(params, states, x0s[:3])
            odd_raised = False
        except ValueError:
            odd_raised = True
        nsolver, nparams, nstates, nx0s = presets.nmpc_fleet(B=4, N=5, device="cpu")
        nfleet = parallel.make_sharded_nmpc_fleet(nsolver, device="cpu")
        nu0, nst, naux = nfleet(nparams, nstates, nx0s)
        try:
            nfleet(nparams, nstates, nx0s[:3])
            nmpc_odd_raised = False
        except ValueError:
            nmpc_odd_raised = True
        torch.save(dict(u0=nu0, X=nst.X, kkt=naux.kkt_residual, odd_raised=nmpc_odd_raised,
                        members=(nfleet.members(4).start, nfleet.members(4).stop)),
                   f"{out_dir}/nmpc{rank}.pt")
        torch.save(dict(u0=u0, u_prev=st.u_prev, costs=aux.costs, fleet_u0=fu0,
                        fleet_u_prev=fst.u_prev, members=(fleet.members(4).start, fleet.members(4).stop),
                        odd_raised=odd_raised),
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Spawn the two gloo ranks once for the module; their saved outputs."""
    out = tmp_path_factory.mktemp("two_ranks")
    ctx = tmp.start_processes(_rank_main, args=(str(out / "store"), str(out)),
                              nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"the two ranks did not finish in {JOIN_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return out


def test_two_gloo_ranks_generic_scan_step_matches_unsharded(two_ranks):
    ranks = [torch.load(two_ranks / f"generic{r}.pt") for r in range(2)]
    _, _, eps = _generic_problem()
    u0_1, st_1, aux_1 = _unsharded_generic(eps)  # no group, in this process
    for r, out in enumerate(ranks):
        lo, hi = out["samples"]
        assert (lo, hi) == (r * KG // 2, (r + 1) * KG // 2)
        torch.testing.assert_close(out["u0"], u0_1, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out["u_prev"], st_1.u_prev, rtol=1e-5, atol=1e-6)
        # rank r rolled out samples [r·K/2, (r+1)·K/2) with their global index
        torch.testing.assert_close(out["costs"], aux_1.costs[lo:hi], rtol=1e-4,
                                   atol=1e-4)
        assert out["k_raised"]
    # without injected ε each rank drew its own slice: together N(0, Σ) ...
    own = torch.cat([out["own_eps"] for out in ranks])
    assert not torch.equal(ranks[0]["own_eps"], ranks[1]["own_eps"])
    e = own.reshape(-1, 4).double()
    s = torch.as_tensor(_generic_problem()[1]["sigma"]).double()
    d, n = torch.diagonal(s), e.shape[0]
    z_mean = (e.mean(0).abs() / torch.sqrt(d / n)).max()
    z_cov = ((torch.cov(e.T) - s).abs() / torch.sqrt((d[:, None] * d[None, :] + s**2) / n)).max()
    assert float(z_mean) < 4.0 and float(z_cov) < 4.0, (float(z_mean), float(z_cov))
    # ... and the step ran on exactly those draws
    u0_own, st_own, _ = _unsharded_generic(own)
    for out in ranks:
        torch.testing.assert_close(out["own_u0"], u0_own, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out["own_u_prev"], st_own.u_prev, rtol=1e-5, atol=1e-6)


def test_two_gloo_ranks_match_one(two_ranks, gloo_world1):
    ranks = [torch.load(two_ranks / f"rank{r}.pt") for r in range(2)]
    u0_1, st_1, aux_1 = _port_step()  # world size 1, in this process
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out["u0"], u0_1, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out["u_prev"], st_1.u_prev, rtol=1e-5, atol=1e-6)
        # rank r holds samples [r·K/2, (r+1)·K/2) of the one stream
        torch.testing.assert_close(out["costs"], aux_1.costs[r * K // 2:(r + 1) * K // 2],
                                   rtol=0, atol=0)
        assert out["odd_raised"]
    fstep, params, states, _ = presets.mppi_fleet(4, 128, 6, device="cpu")
    x0s = torch.tensor(np.random.default_rng(8).uniform(-0.3, 0.3, (4, 3)), dtype=torch.float32)
    fu0, fst, _ = fstep(params, states, x0s)
    for r, out in enumerate(ranks):
        assert out["members"] == (2 * r, 2 * r + 2)
        torch.testing.assert_close(out["fleet_u0"], fu0[2 * r:2 * r + 2], rtol=0, atol=0)
        torch.testing.assert_close(out["fleet_u_prev"], fst.u_prev[2 * r:2 * r + 2],
                                   rtol=0, atol=0)


# --- the sharded NMPC fleet ---------------------------------------------------------


def test_sharded_nmpc_fleet_world1_equals_batched_solve(gloo_world1):
    solver, params, states, x0s = presets.nmpc_fleet(B=4, N=5, device="cpu")
    fleet = parallel.make_sharded_nmpc_fleet(solver, device="cpu")
    assert fleet.members(4) == slice(0, 4)
    kern.reset_counts()
    u0s, st, aux = fleet(params, states, x0s)
    assert kern.batched_fused_barrier_qp_solve_plain.calls == solver.cfg.sqp_iters
    ref_u0, ref_st, ref_aux = solver.batched_solve()(params, states, x0s)
    torch.testing.assert_close(u0s, ref_u0, rtol=0, atol=0)
    torch.testing.assert_close(st.X, ref_st.X, rtol=0, atol=0)
    torch.testing.assert_close(aux.kkt_residual, ref_aux.kkt_residual, rtol=0, atol=0)


def test_sharded_nmpc_fleet_rejects_another_device(gloo_world1):
    solver, params, states, x0s = presets.nmpc_fleet(B=2, N=4, device="cpu")
    fleet = parallel.make_sharded_nmpc_fleet(solver, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        fleet(params, states, x0s.to("meta"))


def test_two_gloo_ranks_nmpc_fleet_slices(two_ranks):
    ranks = [torch.load(two_ranks / f"nmpc{r}.pt") for r in range(2)]
    solver, params, states, x0s = presets.nmpc_fleet(B=4, N=5, device="cpu")
    u0s, st, aux = solver.batched_solve()(params, states, x0s)
    for r, out in enumerate(ranks):
        assert out["members"] == (2 * r, 2 * r + 2)
        assert out["odd_raised"]
        torch.testing.assert_close(out["u0"], u0s[2 * r:2 * r + 2], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out["X"], st.X[2 * r:2 * r + 2], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out["kkt"], aux.kkt_residual[2 * r:2 * r + 2], rtol=1e-4,
                                   atol=1e-6)
