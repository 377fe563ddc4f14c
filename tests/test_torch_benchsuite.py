"""The port's benchmark suite (``utils/benchsuite.py``) and its chain runner
(``utils/benchtime.scan_chain_runner``) against the JAX package's, on the
CPU.

* ``ROWS`` equals JAX's, in order, and every row has a builder; an unknown
  row raises as JAX's does;
* ``run_suite`` on the two light rows at their CPU smoke shapes: one JSON
  line a row, ``cpu_smoke`` and ``"chain": "eager"``, member-solves for the
  fleet, no artifact; chain lengths, K, T and B those of JAX's builders
  (``run_suite`` takes its rows' from them);
* each row's problem at the CPU smoke shape (cfg fields, params leaves, x0,
  the initial state) equal to what the JAX row builds, with tolerance 0:
  JAX's params, x0 and state from its runner's closure (the sharded rows'
  with one device, the port's world of one rank), JAX's config from the
  presets at the arguments of the cited JAX lines. JAX's leaves are float64
  here (the test suite turns x64 on) and are cast to the port's float32;
  its int32 waypoint index and uint32 key words to the port's int64. The
  lines of ``paths.line`` (the fleets' and dnn_mppi's references) are one
  float32 ulp apart at most: JAX's ``linspace`` runs in float64 here and is
  rounded once, the port's in float32. The
  configs differ where stated: ``use_pallas``/``use_kernel`` (the routes'
  own names) and ``qp_backend`` (JAX's CPU rows take ``"xla"``, the port's
  rows the kernel route, whose plain version runs on the CPU);
* ``scan_chain_runner`` for n = 4 equals 4 eager ``body`` calls bit for bit
  on the flagship and nmpc_rti rows;
* the two sharded rows on a gloo group of one rank;
* ``chip_smoke.profile_sums``, which times the suite's and the other
  phases' profiles, and ``chip_smoke.host_ops``, which reads it, count the
  same top-level ATen ops as the profiler's own event tree on CPU profiles
  of the suite's ticks.
"""

from __future__ import annotations

import dataclasses
import enum
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from __graft_entry__ import _flagship as j_flagship
from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu import presets as jpresets
from dnn_mppi_mpc_tpu.paths import generators as jpaths
from dnn_mppi_mpc_tpu.utils import benchsuite as jbench
from dnn_mppi_mpc_tpu_torch import parallel
from dnn_mppi_mpc_tpu_torch.utils import benchsuite
from dnn_mppi_mpc_tpu_torch.utils.benchtime import scan_chain_runner

SHARDED = ("sharded_tick", "sharded_mppi_fleet")
# leaves built by ``paths.line``: a float64 linspace rounded to float32 in
# JAX here, a float32 linspace in the port
LINE_LEAVES = {"mppi_fleet.params.ref_path", "sharded_mppi_fleet.params.ref_path",
               "dnn_mppi.params.ref_path"}
# the config fields whose names or values the two packages' routes set apart
CFG_ROUTE_FIELDS = {"use_pallas", "use_kernel", "qp_backend"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gloo_world1():
    assert parallel.initialize_distributed(device="cpu") == (0, 1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _jax_cfg(name: str):
    """JAX's config of row ``name`` at its CPU smoke shape, from the presets
    with the arguments of ``dnn_mppi_mpc_tpu/utils/benchsuite.py``."""
    if name in ("flagship", "pod_k", "sharded_tick"):
        return j_flagship(512 if name == "flagship" else 1024, 25)[0]
    if name == "racecar":  # :144-165
        return jpresets.racecar_mppi(
            jpaths.lemniscate_with_speed(10.0, 200, speed=5.0), num_samples=256, horizon=20,
            obstacles=jnp.array([[5.0, 5.0, 1.0], [7.0, 7.0, 1.0]]))[0].cfg
    if name == "goal_seeking":  # :168-187
        return jpresets.goal_seeking_mppi(
            jnp.array([6.0, 6.0, 1.57]), num_samples=256,
            obstacles=jnp.array([[5.0, 4.0, 0.5], [3.5, 3.5, 0.5], [2.0, 5.0, 0.5]]),
            obstacle_velocities=0.09 * jnp.array([[0.2, 0.1], [-0.1, 0.1], [0.1, -0.2]]),
        )[0].cfg
    if name == "dnn_mppi":  # :190-206
        ref = jpaths.line(jnp.zeros(2), jnp.array([4.0, 4.0]), num_points=100)
        return jpresets.dnn_mppi(ref, lambda z: z[..., :3], num_samples=256,
                                 horizon=25)[0].cfg
    if name in ("mppi_fleet", "sharded_mppi_fleet"):  # :218-222, :418-422
        return jcfg.MPPIConfig(num_samples=128, horizon=10, dim_x=3, dim_u=2, dt=0.05,
                               waypoint_search_len=20)
    if name == "nmpc_rti":  # :292-307
        return jpresets.diff_drive_nmpc(
            jnp.array([3.0, 2.0, 0.0]), N=30,
            obstacles=jnp.array([[1.5, 1.0, 0.3], [2.5, 1.8, 0.3]]), sqp_iters=1,
            qp_backend="xla")[0].cfg
    assert name == "nmpc_fleet"  # :310-353
    return jpresets.diff_drive_nmpc(jnp.zeros(3, jnp.float32), N=10,
                                    obstacles=jnp.array([[1.0, 0.0, 0.3]], jnp.float32),
                                    qp_backend="xla")[0].cfg


def _jax_row(name: str, monkeypatch):
    """JAX's row ``name`` at its CPU smoke shape: its builder's workload and
    the params, initial state and x0 its runner closes over; the sharded
    rows see one device (the port's world of one rank)."""
    if name in SHARDED:
        one = jax.devices()[:1]
        monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    jw = jbench._BUILDERS[name](False)
    data = inspect.getclosurevars(jw.make_runner).nonlocals
    return jw, data["params"], data["st0"], data["x0"]


def _value(v):
    return v.value if isinstance(v, enum.Enum) else v


def _assert_leaf(where: str, want, got: torch.Tensor) -> None:
    want = np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        want = want.astype(np.float32)
    else:
        want = want.astype(np.int64)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.shape)
    if where in LINE_LEAVES:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


def _assert_dataclass(where: str, want, got) -> None:
    for f in dataclasses.fields(got):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if g is None or w is None:
            assert g is None and w is None, (where, f.name)
        elif isinstance(g, torch.Tensor):
            _assert_leaf(f"{where}.{f.name}", w, g)


def test_rows_equal_jax():
    assert benchsuite.ROWS == jbench.ROWS
    assert set(benchsuite.ROWS) == set(benchsuite._BUILDERS)


def test_unknown_row_raises():
    with pytest.raises(ValueError, match="unknown suite rows"):
        benchsuite.run_suite(rows=("no_such_row",), reps=1, device="cpu")
    with pytest.raises(ValueError, match="unknown suite rows"):
        benchsuite.build("no_such_row", device="cpu")


def test_suite_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the machine without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchsuite.run_suite(rows=("flagship",), reps=1)


def test_light_rows_run_on_cpu(capsys, tmp_path, monkeypatch):
    artifact = tmp_path / "suite.json"
    monkeypatch.setattr(benchsuite, "ARTIFACT", str(artifact))
    rows = benchsuite.run_suite(rows=("mppi_fleet", "goal_seeking"), reps=1, device="cpu")
    assert [r["workload"] for r in rows] == ["mppi_fleet", "goal_seeking"]
    for r in rows:
        assert r["cpu_smoke"] is True and r["chain"] == "eager"
        assert r["per_tick_ms_best"] >= 0 and r["solves_per_s"] > 0
        jw = jbench._BUILDERS[r["workload"]](False)
        assert r["chain_lengths"] == [jw.n1, jw.n2]
        for key in ("B", "K", "T"):
            assert r.get(key) == jw.meta.get(key), key
    assert rows[0]["B"] > 1
    out = capsys.readouterr().out
    assert out.count('"workload"') == 2 and "wrote" not in out
    assert not artifact.exists()


@pytest.mark.parametrize("name", [n for n in jbench.ROWS if n not in SHARDED])
def test_row_problem_equals_jax(name, monkeypatch):
    _check_row(name, monkeypatch)


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_row_problem_equals_jax(name, monkeypatch, gloo_world1):
    _check_row(name, monkeypatch)


def _check_row(name, monkeypatch):
    jw, j_params, j_st0, j_x0 = _jax_row(name, monkeypatch)
    w = benchsuite.build(name, device="cpu")
    assert (w.n1, w.n2, w.solves_per_tick) == (jw.n1, jw.n2, jw.solves_per_tick)
    for key in ("B", "K", "T", "N", "W", "n_obs", "sqp_iters", "devices"):
        assert w.meta.get(key) == jw.meta.get(key), key
    j_cfg = _jax_cfg(name)
    for f in dataclasses.fields(w.cfg):
        if f.name not in CFG_ROUTE_FIELDS:
            assert _value(getattr(w.cfg, f.name)) == _value(getattr(j_cfg, f.name)), f.name
    if hasattr(w.cfg, "qp_backend"):
        assert w.cfg.qp_backend == "kernel"
    _assert_dataclass(f"{name}.params", j_params, w.params)
    _assert_dataclass(f"{name}.st0", j_st0, w.st0)
    _assert_leaf(f"{name}.x0", j_x0, w.x0)


@pytest.mark.parametrize("name", ["flagship", "nmpc_rti"])
def test_chain_runner_equals_eager_ticks(name):
    w = benchsuite.build(name, device="cpu")
    x, y = scan_chain_runner(w.body, w.params, w.st0, w.x0, 4)()
    st, xe = w.st0, w.x0
    for _ in range(4):
        (st, xe), ye = w.body(w.params, st, xe)
    assert torch.equal(x, xe) and torch.equal(y, ye)
    # a second call starts again from st0 and x0
    x2, y2 = scan_chain_runner(w.body, w.params, w.st0, w.x0, 4)()
    assert torch.equal(x2, xe) and torch.equal(y2, ye)


def test_chain_runner_buffers_hold_the_state():
    w = benchsuite.build("flagship", device="cpu")
    run = scan_chain_runner(w.body, w.params, w.st0, w.x0, 3)
    run()
    st, x = w.st0, w.x0
    for _ in range(3):
        (st, x), _ = w.body(w.params, st, x)
    for n in ("u_prev", "waypoint_idx", "key"):
        assert torch.equal(getattr(run.tick.state, n), getattr(st, n)), n
    assert run.tick.graph is None  # no CUDA graph on the CPU


def test_sharded_rows_run_on_a_gloo_group(gloo_world1):
    rows = benchsuite.run_suite(rows=SHARDED, reps=1, device="cpu")
    assert [r["workload"] for r in rows] == list(SHARDED)
    for r in rows:
        assert r["devices"] == 1 and r["chain"] == "eager" and r["solves_per_s"] > 0
    assert dist.is_initialized()  # the caller's group is kept


def test_run_suite_destroys_the_group_it_made():
    assert not dist.is_initialized()
    benchsuite.run_suite(rows=("sharded_mppi_fleet",), reps=1, device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("name", ["flagship", "dnn_mppi"])
def test_chip_smoke_profile_sums_equal_the_profiler_tree(name):
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke  # run pytest from the repository root, as for the other chip_smoke tests

    w = benchsuite.build(name, device="cpu")
    st, x = w.st0, w.x0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            (st, x), _ = w.body(w.params, st, x)
        with torch.profiler.record_function("a range: the ops in it are not top-level"):
            torch.tanh(x).sum()
    by_name, count, spins, host_ops = chip_smoke.profile_sums(prof)
    tree = sum(e.name.startswith("aten::") and e.cpu_parent is None for e in prof.events())
    assert (dict(by_name), count, spins) == ({}, 0, 0)
    assert host_ops == tree and tree > 0
    assert chip_smoke.tree_sums(prof)[1:] == (0, 0, tree)


@pytest.mark.parametrize("name", ["flagship", "nmpc_rti"])
def test_chip_smoke_host_ops_equal_the_profiler_tree(name):
    """``chip_smoke.host_ops`` (the torch routes' host ops a QP and a tick)
    counts one tick's top-level ATen ops as the profiler's tree does."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    w = benchsuite.build(name, device="cpu")

    def tick():
        w.body(w.params, w.st0, w.x0)

    tick()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tick()
    tree = sum(e.name.startswith("aten::") and e.cpu_parent is None for e in prof.events())
    assert chip_smoke.host_ops(tick) == tree > 0
