"""The batched collection: ``collect_residual_dataset`` running its series as
the members of one fleet step (row 5, ``fleet_mppi_tick``), on the CPU.

* the hash contract the route rests on: row 2's ε (the single-block tick,
  ``emit_eps``), the K-blocked tick's stream at K_BLK = K and fleet member
  b's ε with member b's seed are one stream, bit for bit — and JAX's
  K-blocked stream at K_BLK = K (``gaussian="hash"``, interpret mode) is
  the same within 1e-6 (its log and sin/cos);
* the CLI's collect protocol (``cli.collect_problem``) at the card's shape
  (K = 512, T = 20), 4 series × 30 ticks through both routes: tick 0 of
  every series with S bit-equal and u0 within 1e-6, and on the CPU the
  whole dataset bit-equal (all 200 ticks of 8 series are, too). On the
  card the two routes' reductions round differently and the closed loop
  amplifies that; ``chip_smoke.py`` holds the card to its measured spread.
  At K = 128, T = 8 the CPU's filter product rounds differently from tick
  1 (the loop grows that to 2.1e-5 by tick 5), so the tests that compare
  datasets run at the card's shape;
* (the other tests at K = 128, T = 8) the routing rule, by the plain
  versions' call counts: the fleet route
  (one fleet call a tick, no row 2 call) for ``mppi_controller`` over one
  fused-route solver with shared leaves; the series one after another for a
  plain function, the split route, a shared leaf that differs, an action
  cost, a ``StatusLog``-like solver wrapper, a lookahead carry;
* ``MPPISolver.fleet_step`` only for the single-block tick with the
  tick-level carry; the fleet step built from the solver's own binder
  options (soft obstacles, radius, margin), per-member obstacles stacked,
  bit-equal to the sequential route;
* the resumable collection on the fleet route: chunks of 2 equal one call
  bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.ops.pallas.mppi_tick_blocked import weighted_noise_reduce as j_wnr
from dnn_mppi_mpc_tpu_torch import cli
from dnn_mppi_mpc_tpu_torch.config import MPPIConfig
from dnn_mppi_mpc_tpu_torch.envs import closed_loop as cl
from dnn_mppi_mpc_tpu_torch.ops.cuda import mppi_tick as mt
from dnn_mppi_mpc_tpu_torch.ops.cuda import mppi_tick_blocked as mtb
from dnn_mppi_mpc_tpu_torch.ops.cuda.mathx import hash_noise
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

K, T, SERIES, TICKS = 128, 8, 4, 30
CPU = {"device": "cpu"}
CHOL = torch.tensor([[0.3, 0.0], [0.05, 0.2]])


def _problem(samples=K, horizon=T, **solver_kw):
    """The collect command's protocol (by default at a small K), optionally
    with the solver rebuilt with other options (its route, obstacles,
    costs)."""
    factory, plant, nominal, sampler = cli.collect_problem("cpu", samples, horizon)
    if not solver_kw:
        return factory, plant, nominal, sampler
    probe, _ = factory(torch.Generator().manual_seed(0))
    old = probe.solver
    solver = tmppi.MPPISolver(old.cfg, old.dynamics_step, old.stage_cost, old.terminal_cost,
                              device="cpu", **solver_kw)

    def rebuilt(gen):
        c, cs = factory(gen)
        return cl.mppi_controller(solver, c.params), cs

    return rebuilt, plant, nominal, sampler


def _sequential(factory):
    """The same factory with each controller wrapped in a plain function:
    the series run one after another."""
    def wrapped(gen):
        c, cs = factory(gen)
        return (lambda s, x: c(s, x)), cs
    return wrapped


def _counted(factory, plant, nominal, sampler, series=SERIES, ticks=TICKS):
    mt.diffdrive_mppi_tick_plain.calls = mtb.fleet_mppi_tick_plain.calls = 0
    ep = cl.collect_residual_dataset(factory, plant, nominal, sampler, 3, series, ticks, **CPU)
    return ep, {"diffdrive_mppi_tick": mt.diffdrive_mppi_tick_plain.calls,
                "fleet_mppi_tick": mtb.fleet_mppi_tick_plain.calls}


def _spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((kw, out))
        return out

    monkeypatch.setattr(module, name, spy)


def test_one_hash_stream_for_row_2_the_blocked_tick_and_fleet_members():
    seeds = torch.tensor([0x1234ABCD, 7, 0xFFFFFFFF], dtype=torch.int64)
    fleet = hash_noise(seeds, CHOL, 256, 6, 256, per_member=True)
    for b, seed in enumerate(seeds.tolist()):
        single = hash_noise(seed, CHOL, 256, 6, 256)
        assert torch.equal(fleet[b], single)
        # row 2's plain version draws it when no ε is injected
        args = dict(u=torch.zeros(6, 2), a=torch.zeros(6, 2), chol_sigma=CHOL,
                    x0=torch.zeros(3), window=torch.zeros(4, 3), stage_w=torch.ones(3),
                    term_w=torch.ones(3), u_min=-torch.ones(2), u_max=torch.ones(2), dt=0.1,
                    n_exploit=200.0, inv_temperature=1.0, K=256, T=6, W=4, emit_eps=True)
        eps_row2 = mt.diffdrive_mppi_tick_plain(torch.tensor([seed]), **args)[-1]
        assert torch.equal(eps_row2, single)
        _, eps_blocked = mtb.weighted_noise_reduce_plain(
            torch.tensor([seed]), torch.full((256,), 1 / 256), CHOL, K=256, T=6, K_BLK=256,
            emit_eps=True)
        assert torch.equal(eps_blocked, single)
    # JAX's K-blocked stream at K_BLK = K is the same (its fleet's per-member
    # oracle; JAX's single-block tick has no hash mode)
    _, jeps = j_wnr(jnp.asarray(7, jnp.int32), jnp.full((256,), 1 / 256), jnp.asarray(CHOL.numpy()),
                    0, K=256, T=6, K_BLK=256, interpret=True, gaussian="hash", emit_eps=True)
    np.testing.assert_allclose(np.asarray(jeps), fleet[1].numpy(), rtol=0, atol=1e-6)


def test_fleet_route_equals_the_sequential_route(monkeypatch):
    """At the card's shape (K = 512, T = 20), 4 series × 30 ticks."""
    factory, plant, nominal, sampler = _problem(512, 20)
    seen_fleet, seen_row2 = [], []
    _spy(monkeypatch, mtb, "fleet_mppi_tick", seen_fleet)
    _spy(monkeypatch, mt, "diffdrive_mppi_tick", seen_row2)
    fleet, n_fleet = _counted(factory, plant, nominal, sampler)
    factory, plant, nominal, sampler = _problem(512, 20)  # its solver binds the spied row 2
    seq, n_seq = _counted(_sequential(factory), plant, nominal, sampler)
    assert n_fleet == {"diffdrive_mppi_tick": 0, "fleet_mppi_tick": TICKS}
    assert n_seq == {"diffdrive_mppi_tick": SERIES * TICKS, "fleet_mppi_tick": 0}
    # tick 0 of every series: S bit-equal, u0 within 1e-6
    S_fleet = seen_fleet[0][1][0]
    for b in range(SERIES):
        S_b = seen_row2[b * TICKS][1][0]
        assert torch.equal(S_fleet[b], S_b), b
        torch.testing.assert_close(fleet.controls[b * TICKS], seq.controls[b * TICKS],
                                   rtol=0, atol=1e-6)
    assert fleet.states.shape == seq.states.shape == (SERIES * TICKS, 3)
    for name in cl.Episode._fields:
        assert torch.equal(getattr(fleet, name), getattr(seq, name)), name


def _with_params(factory, **changes):
    """Series 1's params changed by ``changes(params)`` (callables)."""
    calls = iter(range(10**6))

    def changed(gen):
        c, cs = factory(gen)
        if next(calls) == 1:
            c = cl.mppi_controller(c.solver, dataclasses.replace(
                c.params, **{k: fn(c.params) for k, fn in changes.items()}))
        return c, cs
    return changed


class _Logged:
    """A solver wrapper with ``step``, as chip_smoke's ``StatusLog``."""

    def __init__(self, solver):
        self.solver = solver

    def step(self, params, st, x):
        return self.solver.step(params, st, x)


ROUTES = {
    "mppi_controller, one fused solver": (lambda f: f, "fleet"),
    "a plain function": (_sequential, "sequential"),
    "a solver wrapper": (lambda f: (lambda g: (lambda c, cs: (
        cl.mppi_controller(_Logged(c.solver), c.params), cs))(*f(g))), "sequential"),
    "shared sigma differs": (lambda f: _with_params(f, sigma=lambda p: p.sigma * 1.5),
                             "sequential"),
    "equal copies of the shared leaves": (lambda f: _with_params(
        f, sigma=lambda p: p.sigma.clone(), u_max=lambda p: p.u_max.clone()), "fleet"),
    "an action cost": (lambda f: _with_params(f, control_weight=lambda p: torch.ones(2)),
                       "sequential"),
    "obstacles in one series only": (lambda f: _with_params(
        f, obstacles=lambda p: torch.tensor([[9.0, 9.0, 0.1]])), "sequential"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_rule(case):
    make, route = ROUTES[case]
    factory, plant, nominal, sampler = _problem()
    _, n = _counted(make(factory), plant, nominal, sampler, series=3, ticks=2)
    want = ({"diffdrive_mppi_tick": 0, "fleet_mppi_tick": 2} if route == "fleet"
            else {"diffdrive_mppi_tick": 6, "fleet_mppi_tick": 0})
    assert n == want


@pytest.mark.parametrize("solver_kw", [dict(use_kernel=True), dict(fused_tick=False)],
                         ids=["split route", "scan path"])
def test_other_routes_run_one_after_another(solver_kw):
    factory, plant, nominal, sampler = _problem(**solver_kw)
    ep, n = _counted(factory, plant, nominal, sampler, series=2, ticks=2)
    assert n == {"diffdrive_mppi_tick": 0, "fleet_mppi_tick": 0}
    assert ep.states.shape == (4, 3)


def test_lookahead_carry_runs_one_after_another():
    factory, plant, nominal, sampler = _problem()
    probe, _ = factory(torch.Generator().manual_seed(0))
    cfg = dataclasses.replace(probe.solver.cfg, waypoint_carry="rollout")
    solver = tmppi.MPPISolver(cfg, probe.solver.dynamics_step, *tmppi.make_tracking_costs(cfg),
                              fused_tick=True, device="cpu")

    def carried(gen):
        c, cs = factory(gen)
        return cl.mppi_controller(solver, c.params), cs

    _, n = _counted(carried, plant, nominal, sampler, series=2, ticks=2)
    assert n == {"diffdrive_mppi_tick": 4, "fleet_mppi_tick": 0}


@pytest.mark.parametrize("solver_kw,has_fleet", [
    (dict(fused_tick=True), True),
    (dict(fused_tick=True, samples=102_400), False),  # the K-blocked tick
    (dict(use_kernel=True), False),
    (dict(fused_tick=False), False),
    (dict(fused_tick=True, waypoint_carry="rollout"), False),
], ids=["single-block tick", "K-blocked tick", "split route", "scan path", "lookahead carry"])
def test_fleet_step_only_for_the_single_block_tick(solver_kw, has_fleet):
    solver_kw = dict(solver_kw)
    cfg = MPPIConfig(num_samples=solver_kw.pop("samples", K), horizon=T, dim_x=3, dim_u=2,
                     dt=0.05, waypoint_carry=solver_kw.pop("waypoint_carry", "tick"))
    solver = tmppi.MPPISolver(cfg, lambda x, u: x, *tmppi.make_tracking_costs(cfg),
                              device="cpu", **solver_kw)
    step = solver.fleet_step()
    assert (step is not None) == has_fleet
    if has_fleet:
        assert callable(step)


def test_fleet_step_takes_the_solvers_binder_options(monkeypatch):
    """A solver with soft obstacles, its own radius and margin: the fleet
    call gets them, each series' obstacles stacked on the member axis, and
    the dataset is the sequential route's bit for bit (the card's shape)."""
    opts = dict(fused_tick=True, collision="soft", robot_radius=0.3, safety_margin_rate=1.2,
                soft_safety_distance=1.5, soft_weight=50.0)
    factory, plant, nominal, sampler = _problem(512, 20, **opts)
    calls = iter(range(10**6))

    def with_obstacles(gen):
        c, cs = factory(gen)
        i = next(calls)
        obs = torch.tensor([[1.0 + i, 0.5, 0.3], [-1.0, 2.0 - i, 0.2]])
        return cl.mppi_controller(c.solver, dataclasses.replace(c.params, obstacles=obs)), cs

    seen = []
    _spy(monkeypatch, mtb, "fleet_mppi_tick", seen)
    fleet, n = _counted(with_obstacles, plant, nominal, sampler, series=3, ticks=3)
    assert n["fleet_mppi_tick"] == 3
    kw = seen[0][0]
    assert (kw["collision"], kw["robot_radius"], kw["safety_margin_rate"],
            kw["soft_safety_distance"], kw["soft_weight"]) == ("soft", 0.3, 1.2, 1.5, 50.0)
    assert kw["obstacles"].shape == (3, 2, 3) and float(kw["obstacles"][2, 0, 0]) == 3.0
    calls = iter(range(10**6))
    seq, _ = _counted(_sequential(with_obstacles), plant, nominal, sampler, series=3, ticks=3)
    for name in cl.Episode._fields:
        assert torch.equal(getattr(fleet, name), getattr(seq, name)), name


def test_resumable_collection_on_the_fleet_route(tmp_path):
    factory, plant, nominal, sampler = _problem()
    args = (factory, plant, nominal, sampler, 5, SERIES, 6)
    mtb.fleet_mppi_tick_plain.calls = 0
    chunked = cl.collect_residual_dataset_resumable(*args, out_dir=str(tmp_path),
                                                    series_per_chunk=2, **CPU)
    assert mtb.fleet_mppi_tick_plain.calls == 2 * 6  # two chunks of 6 fleet ticks
    one_call = cl.collect_residual_dataset(*args, **CPU)
    for got, want in zip(chunked, one_call):
        assert torch.equal(got, want)
