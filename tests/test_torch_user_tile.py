"""Tile steps of the user's on the card: the tracer, its refusals, the build
key, and the rollout step t that F(x, u, t) receives.

* ``t``: JAX's ``dyn_tv`` (tests/test_time_varying.py:44, actuation decaying
  with t) through JAX's ``mppi_step`` scan and through the port's scan step
  on the same numpy noise, costs, u0 and the optimal trajectory within
  1e-6; every path that calls F(x, u, t) — the scan step, the optimal
  trajectory, sampled trajectories, CEM and the generic plain twin — hands
  it a 0-d int32 tensor (JAX's int32 index), from one ``arange`` a call;
* ``ops/cuda/user_tile.py``: the headers it emits (widths, TAKES_T, one
  sincosf for a sin and cos of one argument, hexadecimal float32 literals,
  the int t cast where the step casts it), the same step lowered once, and
  a refusal naming the cause for a matrix product past the weight limit
  (naming the count), ``irk_step``'s ``linalg_solve``, a reduction, Python
  branching on a value, a wrong state count and an nx/nu mismatch, on the
  card route (``kernel_model`` and
  ``MPPISolver(device="cuda")``), while the plain version still runs those
  steps on CPU tensors;
* ``_build.build_user``: the library's key changes with a constant of the
  step, the same step reuses the library on disk, and a build without nvcc
  raises;
* matrix products in a lifted step: ``x @ A.T``, ``torch.nn.functional.linear``
  and ``nn.Linear`` (traced as ``t`` + ``addmm``; ``linear`` and ``matmul``
  as a pre-dispatch trace keeps them, the same statements) lower to one
  statement an output lane summed in k order, the weights read from the
  packed device buffer (``w[i]``, staged) in first-read order, not in the
  header (other weights, the same library); the buffer packed again after a
  weight changes in place (an optimizer step, ``.data``), a literal that
  changed raising; relu, sigmoid and where after a product; a step
  capturing card tensors is traced on fake CUDA tiles; the twin's products
  (``functor_order``) sum in the functor's order, up to ``MAX_WEIGHTS``
  weights a step call; refusals: past ``MAX_WEIGHTS``
  (naming the count), a product of two traced values;
* JAX parity: the JAX fuzz test's linear step (tests/test_generic_tick.py
  :420-428; nx ∈ {3, 5}, nu ∈ {2, 4}) and a unicycle with a seeded
  5→16→16→3 tanh residual, both built from the same numpy parameters
  (``lift_linear``, ``lift_mlp_residual``), through JAX's interpret-mode
  ``make_generic_fused_tick`` (row 8) and ``make_generic_pallas_rollout``
  (row 9) and the port's plain twins on the same numpy noise (K = 256,
  T = 10): S, u and the optimal trajectory within 1e-5.

The generated kernels themselves run on the CPU emulator in
tests/test_torch_user_tile_emu.py, and on the card in ``chip_smoke.py``'s
``user_tile_*`` phases.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models import dynamics as jdyn
from dnn_mppi_mpc_tpu.models import tile as jtile
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import _build
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch.models import dynamics as tdyn
from dnn_mppi_mpc_tpu_torch.models import tile as ttile
from dnn_mppi_mpc_tpu_torch.models.integrators import euler_step, irk_step, rk4_step
from dnn_mppi_mpc_tpu_torch.ops.cuda import generic_tick as gt
from dnn_mppi_mpc_tpu_torch.ops.cuda import user_tile
from dnn_mppi_mpc_tpu_torch.solvers import cem as tcem
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi
from test_time_varying import _cfg as j_cfg
from test_time_varying import _noise as j_noise
from test_time_varying import _params as j_params
from test_time_varying import dyn_tv as j_dyn_tv

DT = 0.05


def t_dyn_tv(x, u, t):
    """JAX's dyn_tv in PyTorch, as its author would write it there."""
    decay = 1.0 / (1.0 + 0.1 * t.to(x.dtype) * DT)
    v, w, yaw = u[..., 0] * decay, u[..., 1] * decay, x[..., 2]
    return torch.stack([x[..., 0] + v * torch.cos(yaw) * DT,
                        x[..., 1] + v * torch.sin(yaw) * DT, yaw + w * DT], -1)


def _port_cfg(jc, **kw):
    fields = ("num_samples", "horizon", "dim_x", "dim_u", "dt", "lam", "alpha", "exploration",
              "filter_window", "waypoint_search_len", "time_varying_dynamics",
              "compute_optimal_traj")
    return tcfg.MPPIConfig(**{**{k: getattr(jc, k) for k in fields}, **kw},
                           temperature=tcfg.Temperature(jc.temperature.value),
                           filter=tcfg.SmoothingFilter(jc.filter.value))


def _port_params(jp):
    return tcfg.params_from_numpy(**{k: np.asarray(getattr(jp, k)) for k in (
        "sigma", "stage_weight", "terminal_weight", "u_min", "u_max", "ref_path")}, device="cpu")


def test_time_varying_scan_matches_jax():
    """dyn_tv through both scan steps on the same noise: S, u0 and the
    optimal trajectory within 1e-6 (ROADMAP §C: 2.4e-7, 9.3e-10 and 2.3e-10
    with t a 0-d int32 tensor; with t a Python int, as before, 2.4e-7,
    4.7e-10 and 5.8e-11 — decay = 1/(1 + 0.1·t·dt) in float64 then was one
    ulp off JAX's float32 chain at t = 6, 8 and 9, under the gate)."""
    jc, jp = j_cfg(compute_optimal_traj=True), j_params()
    stage, terminal = jmppi.make_tracking_costs(jc)
    x0, noise = np.array([0.0, 0.2, 0.1], np.float32), np.asarray(j_noise(3))
    u_j, _, aux_j = jax.jit(lambda p, s, x, n: jmppi.mppi_step(
        jc, j_dyn_tv, stage, terminal, p, s, x, n))(jp, jmppi.MPPIState.init(jc),
                                                    jnp.asarray(x0), jnp.asarray(noise))
    tc = _port_cfg(jc)
    solver = tmppi.MPPISolver(tc, t_dyn_tv, *tmppi.make_tracking_costs(tc), device="cpu")
    u_t, _, aux_t = solver.step(_port_params(jp), solver.init(), torch.as_tensor(x0),
                                torch.tensor(noise))
    np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux_t.optimal_traj.numpy(), np.asarray(aux_j.optimal_traj),
                               rtol=1e-6, atol=1e-6)


class _Recorder:
    """F(x, u, t) that records what it was handed as t."""

    def __init__(self):
        self.seen = []

    def __call__(self, x, u, t):
        self.seen.append(t)
        return t_dyn_tv(x, u, t)


def _check_seen(seen, T):
    assert len(seen) >= T
    for i, t in enumerate(seen[:T]):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32 and t.dim() == 0
        assert int(t) == i


@pytest.mark.parametrize("path", ["scan", "optimal_traj", "sampled_trajectories", "cem",
                                  "generic_plain"])
def test_f_receives_t_as_an_int32_tensor(path):
    jc = j_cfg(compute_optimal_traj=path == "optimal_traj", num_samples=128, horizon=6)
    tc, tp = _port_cfg(jc), _port_params(j_params())
    rec = _Recorder()
    x0 = torch.tensor([0.0, 0.2, 0.1])
    noise = torch.as_tensor(np.random.default_rng(1).normal(0, 0.1, (128, 6, 2)),
                            dtype=torch.float32)
    stage, terminal = tmppi.make_tracking_costs(tc)
    if path in ("scan", "optimal_traj"):
        solver = tmppi.MPPISolver(tc, t_dyn_tv, stage, terminal, device="cpu")
        solver.dynamics_step = rec
        solver.step(tp, solver.init(), x0, noise)
        if path == "optimal_traj":  # the scan's T calls, then the re-rollout's
            _check_seen(rec.seen[6:], 6)
    elif path == "sampled_trajectories":
        tmppi.sampled_trajectories(tc, rec, tp, tmppi.MPPIState.init(tc, device="cpu"), x0,
                                   noise, torch.zeros(128))
    elif path == "cem":
        ccfg = tcem.CEMConfig(num_samples=128, horizon=6, dim_x=3, dim_u=2, dt=DT, num_iters=2,
                              time_varying_dynamics=True)
        solver = tcem.CEMSolver(ccfg, rec, stage, terminal, device="cpu")
        solver.step(tp, solver.init(), x0)
    else:
        tc = dataclasses.replace(tc, time_varying_dynamics=True)
        tick = tmppi.make_cuda_generic_tick(tc, ttile.lift_dynamics_time_varying(rec))
        solver = tmppi.MPPISolver(tc, t_dyn_tv, stage, terminal, tick_fn=tick, device="cpu")
        solver.step(tp, solver.init(), x0, noise)
    _check_seen(rec.seen, 6)


# --- the tracer ---------------------------------------------------------------------


def _unicycle(dt):
    return ttile.lift_dynamics(lambda x, u: euler_step(tdyn.unicycle, x, u, dt))


def test_lowered_unicycle_header():
    """The lifted Euler unicycle: the widths, no t, one sincosf for cos(yaw)
    and sin(yaw), dt as a hexadecimal float32 literal, the state written
    back last."""
    low = user_tile.lower(_unicycle(0.02), 3, 2, False)
    h = low.header
    assert f"struct {low.name} {{" in h and f"using DmmUserTile = {low.name};" in h
    assert "static constexpr int NX = 3, NU = 2, WEIGHTS = 0, MACS = 0;" in h
    assert "static constexpr bool TAKES_T = false;" in h
    assert "void step(float* x, const float* v) const" in h
    assert h.count("sincosf(") == 1
    assert f"{float(np.float32(0.02)).hex()}f" in h
    assert h.index("sincosf(") < h.index("x[0] = ") < h.index("x[2] = ") < h.index("using")
    assert "aten.stack.default" in low.ops and "aten.cos.default" in low.ops


def test_lowered_time_varying_header():
    """dyn_tv: the step takes the int t, cast to float32 where the step
    casts it; 0.1 and dt as float32 literals."""
    low = user_tile.lower(ttile.lift_dynamics_time_varying(t_dyn_tv), 3, 2, True)
    assert "static constexpr bool TAKES_T = true;" in low.header
    assert "void step(float* x, const float* v, int t) const" in low.header
    assert "static_cast<float>(t)" in low.header
    assert f"{float(np.float32(0.1)).hex()}f" in low.header


def test_lowered_dynamic_bicycle_uses_atanf_and_its_guard():
    """torch.atan becomes dmm_user_atan (atanf on the card), never the
    atan_tile polynomial; the vx guard's 1e-6 is a float32 literal."""
    low = user_tile.lower(ttile.lift_dynamics(
        lambda x, u: euler_step(tdyn.dynamic_bicycle, x, u, DT)), 4, 2, False)
    assert low.header.count("dmm_user_atan(") == 3
    assert "dmm_atan_poly" not in low.header
    assert f"{float(np.float32(1e-6)).hex()}f" in low.header


def test_the_same_step_lowers_once():
    step = ttile.lift_dynamics(lambda x, u: rk4_step(tdyn.four_wheel_torque, x, u, DT))
    assert user_tile.lower(step, 5, 4, False) is user_tile.lower(step, 5, 4, False)


# weights past the generated functor's limit (3 × 6 000 > user_tile.MAX_WEIGHTS)
_WIDE = torch.zeros(3, 6000)


def _branching(x, u):
    if bool((x[..., 0] > 0).any()):
        return x
    return x + 1.0


def _three_of_two(xs, vs):
    return xs[0], xs[1]


# name -> (step, nx, nu, what the message names)
REFUSED = {
    "matrix product": (ttile.lift_dynamics(lambda x, u: x + (x @ _WIDE)[..., :3]), 3, 2,
                       "aten.mm.*18000"),
    "irk_step": (ttile.lift_dynamics(lambda x, u: irk_step(tdyn.unicycle, x, u, DT)), 3, 2,
                 "aten.argmax"),
    "reduction": (ttile.lift_dynamics(lambda x, u: x + u.sum(-1, keepdim=True)), 3, 2,
                  "aten.sum"),
    "python branching": (ttile.lift_dynamics(_branching), 3, 2, "data-dependent"),
    "wrong state count": (ttile.TileStep(None, None, None, (), False, _three_of_two), 3, 2,
                          "returned 2 state dims, expected nx=3"),
    "nx mismatch": (_unicycle(DT), 2, 2, "out of bounds"),
    "nu mismatch": (_unicycle(DT), 3, 1, "out of bounds"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_card_route_refuses_what_it_cannot_lower(case):
    step, nx, nu, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        gt.kernel_model(step, False, nx, nu)


@pytest.mark.parametrize("case", ["matrix product", "reduction", "python branching"])
def test_the_solver_on_the_card_refuses_at_construction(case, monkeypatch):
    """MPPISolver(device="cuda") traces the step before it touches the card."""
    step, nx, nu, match = REFUSED[case]
    monkeypatch.setattr(tmppi, "resolve_device", lambda d: torch.device("cuda"))
    cfg = tcfg.MPPIConfig(num_samples=128, horizon=6, dim_x=3, dim_u=2, dt=DT)
    with pytest.raises(ValueError, match=match):
        tmppi.MPPISolver(cfg, lambda x, u: x, *tmppi.make_tracking_costs(cfg), fused_tick=True,
                         tile_dynamics=step, device="cuda")


@pytest.mark.parametrize("case", ["matrix product", "irk_step", "reduction"])
def test_cpu_tensors_still_run_what_the_card_refuses(case):
    """The plain version runs a step the tracer refuses, on CPU tensors, as
    it did before the tracer existed — after the card route refused it too
    (a trace leaves no fake tensor in the IRK tableau's cache)."""
    step, nx, nu, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        gt.kernel_model(step, False, nx, nu)
    K, T = 128, 4
    rng = np.random.default_rng(0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    S, w, w_eps = gt.generic_mppi_tick(
        None, f(rng.normal(0, 0.3, (T, 2))), f(np.zeros((T, 2))), f(0.3 * np.eye(2)),
        f([0.1, 0.0, 0.2]), f(np.stack([np.linspace(0, 2, 8), np.zeros(8), np.zeros(8)], 1)),
        f([1.0, 1.0, 0.1]), f([2.0, 2.0, 0.2]), f([-2.0, -2.0]), f([2.0, 2.0]), DT, 0.9 * K,
        1.0, eps=f(rng.normal(0, 0.3, (K, T, 2))), step_tile=step, nx=nx, nu=nu, n_track=3,
        K=K, T=T, W=8)
    assert bool(torch.isfinite(S).all()) and abs(float(w.sum()) - 1.0) < 1e-5


# --- the build key --------------------------------------------------------------


def test_library_key_follows_the_generated_source(tmp_path, monkeypatch):
    """A constant of the step changes the key; the same step keeps it, and
    its library on disk is reused without nvcc; with no library and no nvcc
    the build raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    a = user_tile.lower(_unicycle(0.02), 3, 2, False).header
    b = user_tile.lower(_unicycle(0.021), 3, 2, False).header
    assert a != b and _build.user_library_path(a) != _build.user_library_path(b)
    assert _build.user_library_path(a) == _build.user_library_path(
        user_tile.lower(_unicycle(0.02), 3, 2, False).header)

    def no_nvcc():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    built = _build.user_library_path(a)
    built.write_bytes(b"")  # a library already built for this step
    assert _build.build_user(a) == built
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_user(b)


@pytest.mark.cuda
def test_lifted_unicycle_on_the_card_equals_its_plain_twin():
    """On the card: the lifted unicycle's generated kernel against the plain
    twin on the same injected ε (chip_smoke.py's user_tile_compare holds
    every case; this is the quick one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    K, T = 1024, 10
    rng = np.random.default_rng(0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    args = (None, f(rng.normal(0, 0.3, (T, 2))), f(np.zeros((T, 2))), f(0.3 * np.eye(2)),
            f([0.1, 0.0, 0.2]), f(np.stack([np.linspace(0, 2, 8), np.zeros(8), np.zeros(8)], 1)),
            f([1.0, 1.0, 0.1]), f([2.0, 2.0, 0.2]), f([-2.0, -2.0]), f([2.0, 2.0]), DT, 0.9 * K,
            1.0)
    kw = dict(eps=f(rng.normal(0, 0.3, (K, T, 2))), step_tile=_unicycle(DT), nx=3, nu=2,
              n_track=3, K=K, T=T, W=8)
    got = gt.generic_mppi_tick(*args, **kw)
    want = gt.generic_mppi_tick_plain(*args, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)


# --- matrix products in a lifted step --------------------------------------------


def _lit(v) -> str:
    return f"{float(np.float32(v)).hex()}f"


def linear_params(nx: int, nu: int, seed: int = 0):
    """The JAX fuzz test's stable-ish random linear model
    (tests/test_generic_tick.py:418-420): A (nx, nx), B (nx, nu), dt."""
    rng = np.random.default_rng(100 + seed)
    A = rng.normal(0.0, 0.3, (nx, nx)) - 0.5 * np.eye(nx)
    B = rng.normal(0.0, 0.5, (nx, nu))
    return A.astype(np.float32), B.astype(np.float32), 0.08


def mlp_params(widths, seed: int = 0, scale: float = 0.1):
    """A seeded MLP as (W (n_in, n_out), b) per layer, Flax's layout; the
    last layer scaled by ``scale``, so the residual stays a correction."""
    rng = np.random.default_rng(seed)
    layers = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        W = rng.normal(0.0, 1.0 / np.sqrt(a), (a, b)) * (scale if i == len(widths) - 2 else 1.0)
        layers.append((W.astype(np.float32), (0.05 * rng.normal(size=b)).astype(np.float32)))
    return layers


def t_mlp(layers):
    """The residual MLP in PyTorch on (K, n) batches, from the same numpy
    parameters: tanh after every layer but the last."""
    ps = [(torch.as_tensor(W), torch.as_tensor(b)) for W, b in layers]

    def f(h):
        for i, (W, b) in enumerate(ps):
            h = h @ W + b
            if i + 1 < len(ps):
                h = torch.tanh(h)
        return h

    return f


def j_const(a) -> jnp.ndarray:
    """numpy ``a`` as a JAX array built from Python floats where it is
    called: inside a Pallas kernel, ops and no captured constant (JAX's
    pallas_call refuses captured arrays, even in interpret mode; ROADMAP
    §C)."""
    a = np.asarray(a, np.float32)
    if a.ndim == 0:
        return jnp.full((), float(a), jnp.float32)
    return jnp.stack([j_const(row) for row in a])


def j_mlp(layers):
    def f(h):
        for i, (W, b) in enumerate(layers):
            h = h @ j_const(W) + j_const(b)
            if i + 1 < len(layers):
                h = jnp.tanh(h)
        return h

    return f


def product_problem(name: str):
    """(nx, nu, JAX F, port F, port tile step) of ``name``: "linear nx nu"
    or "mlp W" (the Euler unicycle plus a 5→W→W→3 tanh residual)."""
    if name.startswith("linear"):
        nx, nu = (int(v) for v in name.split()[1:])
        A, B, dtf = linear_params(nx, nu, nx)
        At, Bt = torch.as_tensor(A), torch.as_tensor(B)
        return (nx, nu, lambda x, u: x + (x @ j_const(A).T + u @ j_const(B).T) * dtf,
                lambda x, u: x + (x @ At.T + u @ Bt.T) * dtf,
                ttile.lift_linear(A, B, dtf, device="cpu"))
    width = int(name.split()[1])
    layers = mlp_params([5, width, width, 3], seed=width)
    jf, tf = j_mlp(layers), t_mlp(layers)

    def j_step(x, u):
        return j_euler(jdyn.unicycle, x, u, DT) + jf(jnp.concatenate([x, u], -1))

    def t_step(x, u):
        return euler_step(tdyn.unicycle, x, u, DT) + tf(torch.cat([x, u], -1))

    return 3, 2, j_step, t_step, ttile.lift_mlp_residual(
        lambda x, u: euler_step(tdyn.unicycle, x, u, DT), layers, device="cpu")


def test_lowered_linear_step_header():
    """lift_linear at the four-wheel example's widths: each output lane of
    x @ A.T one statement, Σ_k x_k·A[j, k] in k order, A's and B's 45
    float32 values read from the buffer (A's rows, then B's, as the functor
    first reads them), none in the header; 45 multiply-adds a step."""
    A, B, dtf = linear_params(5, 4)
    low = user_tile.lower(ttile.lift_linear(A, B, dtf, device="cpu"), 5, 4, False)
    assert "static constexpr int NX = 5, NU = 4, WEIGHTS = 45, MACS = 45;" in low.header
    row0 = " + ".join(f"x{k} * w[{k}]" for k in range(5))
    assert f"= {row0};  // aten.mm.default" in low.header
    ctl0 = " + ".join(f"v[{k}] * w[{25 + k}]" for k in range(4))
    assert f"= {ctl0};  // aten.mm.default" in low.header
    assert _lit(A[0, 0]) not in low.header
    np.testing.assert_array_equal(low.weights, np.concatenate([A.reshape(-1), B.reshape(-1)]))
    assert low.macs == 45 and low.ops.count("aten.mm.default") == 2


def test_lowered_mlp_reads_its_weight_buffer():
    """A 5→32→32→3 residual (1 347 weights) reads its weights from the
    buffer, staged in shared memory, in first-read order: layer 1's column 0
    (W[k, 0], k = 0..4), then its bias b[0], ...; the same net with other
    weights lowers to the same header (one library), its own buffer."""
    layers = mlp_params([5, 32, 32, 3], seed=32)
    nominal = lambda x, u: euler_step(tdyn.unicycle, x, u, DT)  # noqa: E731
    step = ttile.lift_mlp_residual(nominal, layers, device="cpu")
    low = user_tile.lower(step, 3, 2, False)
    assert "WEIGHTS = 1347, MACS = 1280;" in low.header
    assert ("= x0 * w[0] + x1 * w[1] + x2 * w[2] + v[0] * w[3] + v[1] * w[4] + w[5];  "
            "// aten.addmm.default") in low.header
    W1, b1 = layers[0]
    np.testing.assert_array_equal(low.weights[:6], np.append(W1[:, 0], b1[0]))
    assert sorted(low.weights.tolist()) == sorted(
        np.concatenate([np.concatenate([W.reshape(-1), b]) for W, b in layers]).tolist())
    assert low.ops.count("aten.addmm.default") == 3 and "aten.tanh.default" in low.ops
    other = mlp_params([5, 32, 32, 3], seed=33)
    again = user_tile.lower(ttile.lift_mlp_residual(nominal, other, device="cpu"), 3, 2, False)
    assert again.header == low.header and again.name == low.name
    np.testing.assert_array_equal(again.weights[:6], np.append(other[0][0][:, 0], other[0][1][0]))


def test_weight_buffer_is_packed_once_per_device():
    layers = mlp_params([5, 32, 32, 3], seed=32)
    low = user_tile.lower(ttile.lift_mlp_residual(
        lambda x, u: euler_step(tdyn.unicycle, x, u, DT), layers, device="cpu"), 3, 2, False)
    buf = user_tile.weight_buffer(low, torch.device("cpu"))
    assert buf.dtype == torch.float32 and buf.shape == (1347,)
    assert user_tile.weight_buffer(low, torch.device("cpu")) is buf
    linear = user_tile.lower(ttile.lift_linear(*linear_params(3, 2), device="cpu"), 3, 2, False)
    assert user_tile.weight_buffer(linear, torch.device("cpu")).shape == (3 * 3 + 3 * 2,)
    plain = user_tile.lower(ttile.lift_dynamics(
        lambda x, u: euler_step(tdyn.unicycle, x, u, DT)), 3, 2, False)
    assert len(plain.weights) == 0 and user_tile.weight_buffer(plain, torch.device("cpu")) is None


def _residual_net(seed: int) -> torch.nn.Sequential:
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(5, 16), torch.nn.Tanh(), torch.nn.Linear(16, 3))


def _packed(net) -> np.ndarray:
    """The net's weights in the functor's first-read order: per layer, each
    output's weight row, then its bias."""
    return np.concatenate([np.concatenate([lin.weight.detach().numpy(),
                                           lin.bias.detach().numpy()[:, None]], 1).reshape(-1)
                           for lin in net[::2]])


@pytest.mark.parametrize("change", ["optimizer step", "copy_ in no_grad", "data replaced"])
def test_weight_buffer_follows_weights_changed_in_place(change):
    """A residual net trained in place after the step's first launch: the
    next launch packs the buffer again from the new values (the same header
    and library), by the tensors' version counters and storage."""
    net = _residual_net(7)
    step = ttile.lift_dynamics(lambda x, u: x + net(torch.cat([x, u], -1)))
    low = user_tile.lower(step, 3, 2, False)
    cpu = torch.device("cpu")
    first = user_tile.weight_buffer(low, cpu)
    np.testing.assert_array_equal(first.numpy(), _packed(net))
    if change == "optimizer step":
        opt = torch.optim.SGD(net.parameters(), lr=0.1)
        net(torch.ones(4, 5)).square().sum().backward()
        opt.step()
    elif change == "copy_ in no_grad":
        with torch.no_grad():
            net[2].weight.copy_(net[2].weight * 2.0 + 1.0)
    else:
        net[0].bias.data = net[0].bias.data + 0.5
    again = user_tile.weight_buffer(low, cpu)
    assert again is not first and not np.array_equal(again.numpy(), first.numpy())
    np.testing.assert_array_equal(again.numpy(), _packed(net))
    assert user_tile.lower(step, 3, 2, False).header == low.header
    assert user_tile.weight_buffer(low, cpu) is again


def test_a_literal_changed_in_place_raises():
    """A captured 1-d tensor read elementwise is baked in as literals: after
    it changes in place the card route raises, naming it."""
    gain = torch.tensor([1.0, 0.5, 0.25])
    low = _lowered(lambda x, u: x + gain * u[..., :1] * DT)
    assert user_tile.weight_buffer(low, torch.device("cpu")) is None
    gain.mul_(2.0)
    with pytest.raises(ValueError, match=r"_tensor_constant0 \(3,\) changed in place"):
        user_tile.weight_buffer(low, torch.device("cpu"))


def _sequential(x, W):
    acc = x[:, :1] * W[:1]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k:k + 1] * W[k:k + 1]
    return acc


@pytest.mark.parametrize("case", ["within the limit", "past the limit", "past it in one call",
                                  "a weight read twice", "later entries"])
def test_functor_order_only_up_to_the_weight_limit(case):
    """functor_order sums a product sequentially while the weights read in
    one entry (each storage once) stay within MAX_WEIGHTS, as a functor
    holds them: past it (a step the card refuses) PyTorch's own product,
    one mm, from the product where the count passes it and in the same
    context's later entries."""
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=(64, 3)), dtype=torch.float32)
    small = torch.tensor(rng.normal(size=(3, 40)), dtype=torch.float32)
    big = torch.tensor(rng.normal(size=(3, user_tile.MAX_WEIGHTS // 3 + 1)), dtype=torch.float32)
    wide = torch.tensor(rng.normal(size=(3, user_tile.MAX_WEIGHTS // 3 - 20)),
                        dtype=torch.float32)
    with user_tile.functor_order():
        if case == "within the limit":
            assert torch.equal(x @ small, _sequential(x, small))
        elif case == "past the limit":
            assert torch.equal(x @ big, torch.mm(x, big.clone()))
        elif case == "past it in one call":
            assert torch.equal(x @ small, _sequential(x, small))
            assert torch.equal(x @ wide, torch.mm(x, wide.clone()))
        elif case == "a weight read twice":
            for _ in range(3):
                assert torch.equal(x @ wide, _sequential(x, wide))
    if case == "later entries":
        order = user_tile.functor_order()
        for _ in range(2):
            with order:
                assert torch.equal(x @ small, _sequential(x, small))
        with order:
            assert torch.equal(x @ big, torch.mm(x, big.clone()))
        with order:
            assert torch.equal(x @ small, torch.mm(x, small.clone()))
    with user_tile.functor_order():  # a new context counts anew
        assert torch.equal(x @ small, _sequential(x, small))


def _lowered(step, nx=3, nu=2):
    return user_tile.lower(ttile.lift_dynamics(step), nx, nu, False)


_B = torch.tensor(np.random.default_rng(4).normal(size=(3, 4)), dtype=torch.float32)


def test_activations_after_a_product_lower():
    """relu, sigmoid and where after a product: relu as x < 0 ? 0 : x,
    sigmoid through dmm_user_sigmoid, where a select."""
    low = _lowered(lambda x, u: x + torch.where(
        (x @ _B)[..., :3] > 0.0, torch.sigmoid(x @ _B)[..., 1:], torch.relu(x @ _B)[..., :3]))
    h = low.header
    assert "dmm_user_sigmoid(" in h and "aten.relu.default" in low.ops
    assert f" < {_lit(0.0)} ? {_lit(0.0)} : " in h
    assert "aten.where.self" in low.ops and low.macs == 3 * 12


def test_the_twin_sums_products_in_the_functors_order():
    """Under functor_order, mm, addmm, mv (and F.linear, matmul, nn.Linear,
    which reach them) are the sequential sums x0·W0 + x1·W1 + ... (+ b),
    bit for bit; outside, PyTorch's own (which differ in the last bits)."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(257, 33)), dtype=torch.float32)
    W = torch.tensor(rng.normal(size=(33, 17)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=17), dtype=torch.float32)
    want = x[:, :1] * W[:1]
    for k in range(1, 33):
        want = want + x[:, k:k + 1] * W[k:k + 1]
    with user_tile.functor_order():
        got = {"mm": x @ W, "addmm": torch.addmm(b, x, W) - b,
               "linear": torch.nn.functional.linear(x, W.T, b), "matmul": torch.matmul(x, W),
               "mv": x @ W[:, 3]}
    assert torch.equal(got["mm"], want) and torch.equal(got["matmul"], want)
    assert torch.equal(got["linear"], want + b)
    assert torch.equal(got["mv"], want[:, 3])
    torch.testing.assert_close(got["addmm"], want, rtol=1e-6, atol=1e-5)
    assert not torch.equal(x @ W, want)  # PyTorch's own order rounds otherwise


@pytest.mark.parametrize("case", ["past the weight limit", "two traced values"])
def test_products_the_functor_refuses(case):
    """Past MAX_WEIGHTS the refusal names the count; a product of two traced
    values (no captured operand) names the transpose it needs."""
    if case == "past the weight limit":
        big = torch.zeros(5, 3328)  # 16 640 weights
        step, match = (lambda x, u: x + (x @ big)[..., :5]), "16640 captured weight values"
        assert big.numel() > user_tile.MAX_WEIGHTS
        nx = 5
    else:
        step, match, nx = (lambda x, u: x + (x @ x.T)[..., :3]), "aten.permute", 3
    with pytest.raises(ValueError, match=match):
        user_tile.lower(ttile.lift_dynamics(step), nx, 2, False)


def test_a_step_of_card_tensors_is_traced_on_the_card(monkeypatch):
    """A step whose captured tensors lie on the card cannot be traced on CPU
    tiles (a device mismatch); the trace is then made again on fake tiles of
    the card's device (here "meta" stands in for it: this build of PyTorch
    has no CUDA to fake)."""
    monkeypatch.setattr(user_tile, "_CARD", "meta")
    seen = []

    def on_card(x, u):
        seen.append(x.device.type)
        if x.device.type != "meta":
            raise RuntimeError("Expected all tensors to be on the same device, but found at "
                               "least two devices, cuda:0 and cpu!")
        return x + u[..., :1] * 0.5

    low = user_tile.lower(ttile.lift_dynamics(on_card), 3, 2, False)
    assert seen[-2:] == ["cpu", "meta"] and low.nx == 3


@pytest.mark.cuda
def test_mlp_residual_on_the_card_equals_its_plain_twin():
    """On the card: the MLP residual's generated kernel (weights on the card,
    staged) against the plain twin on the same injected ε."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    layers = mlp_params([5, 32, 32, 3], seed=32)
    step = ttile.lift_mlp_residual(lambda x, u: euler_step(tdyn.unicycle, x, u, DT), layers,
                                   device=dev)
    K, T = 1024, 10
    rng = np.random.default_rng(0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    args = (None, f(rng.normal(0, 0.3, (T, 2))), f(np.zeros((T, 2))), f(0.3 * np.eye(2)),
            f([0.1, 0.0, 0.2]), f(np.stack([np.linspace(0, 2, 8), np.zeros(8), np.zeros(8)], 1)),
            f([1.0, 1.0, 0.1]), f([2.0, 2.0, 0.2]), f([-2.0, -2.0]), f([2.0, 2.0]), DT, 0.9 * K,
            1.0)
    kw = dict(eps=f(rng.normal(0, 0.3, (K, T, 2))), step_tile=step, nx=3, nu=2, n_track=3, K=K,
              T=T, W=8)
    got = gt.generic_mppi_tick(*args, **kw)
    want = gt.generic_mppi_tick_plain(*args, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)


# --- parity with JAX's interpret-mode generic kernels --------------------------------

PRODUCT_CASES = ["linear 3 2", "linear 5 4", "mlp 16"]


def jax_port_product_problem(nx: int, nu: int):
    """K = 256, T = 10, W = 8, a 40-point path tracked on (x, y, dim 2), Σ
    and the noise from numpy; compute_optimal_traj on."""
    K_, T_ = 256, 10
    kw = dict(num_samples=K_, horizon=T_, dim_x=nx, dim_u=nu, dt=DT, lam=0.8, alpha=0.3,
              exploration=0.25, filter_window=5, waypoint_search_len=8,
              compute_optimal_traj=True)
    jc = jcfg.MPPIConfig(**kw, temperature=jcfg.Temperature.LAMBDA,
                         filter=jcfg.SmoothingFilter.MOVING_AVERAGE_EDGE)
    tc = tcfg.MPPIConfig(**kw, temperature=tcfg.Temperature.LAMBDA,
                         filter=tcfg.SmoothingFilter.MOVING_AVERAGE_EDGE)
    rng = np.random.default_rng(7 + nx)
    n = 40
    path = np.stack([np.linspace(0.0, 2.0, n), 0.5 * np.sin(np.linspace(0.0, 2.0, n)),
                     rng.normal(0.0, 0.2, n).cumsum() * 0.1], 1).astype(np.float32)
    M = rng.normal(0.0, 0.2, (nu, nu))
    leaves = dict(sigma=M @ M.T + 0.05 * np.eye(nu), stage_weight=[4.0, 4.0, 0.5],
                  terminal_weight=[9.0, 9.0, 2.0], u_min=np.full(nu, -1.5),
                  u_max=np.full(nu, 1.5))
    leaves = {k: np.asarray(v, np.float32) for k, v in leaves.items()}
    eps = rng.multivariate_normal(np.zeros(nu), leaves["sigma"], (K_, T_)).astype(np.float32)
    u_prev = rng.normal(0.0, 0.3, (T_, nu)).astype(np.float32)
    x0 = np.concatenate([[0.1, -0.05, 0.2], np.full(nx - 3, 0.1)]).astype(np.float32)
    jp = jcfg.MPPIParams(**{k: jnp.asarray(v) for k, v in leaves.items()},
                         ref_path=jnp.asarray(path))
    tp = tcfg.params_from_numpy(**leaves, ref_path=path, device="cpu")
    return jc, jp, tc, tp, eps, u_prev, x0


def run_product_parity(name: str, row: str, port_solver=None):
    """One tick of ``name`` through JAX's interpret-mode kernel of ``row``
    (8: the fused tick, 9: the split rollout) and the port's solver (its
    plain twin unless ``port_solver`` binds another): (JAX's (u, state,
    aux), the port's)."""
    nx, nu, j_step, t_step, t_tile = product_problem(name)
    jc, jp, tc, tp, eps, u_prev, x0 = jax_port_product_problem(nx, nu)
    jsc, jtc = jmppi.make_tracking_costs(jc)
    if row == "8":
        jkw = dict(tick_fn=jmppi.make_generic_fused_tick(jc, jtile.lift_dynamics(j_step),
                                                         interpret=True))
        tkw = dict(fused_tick=True, tile_dynamics=t_tile)
    else:
        jkw = dict(rollout_fn=jmppi.make_generic_pallas_rollout(
            jc, jtile.lift_dynamics(j_step), interpret=True))
        tkw = dict(rollout_fn=tmppi.make_cuda_generic_rollout(tc, t_tile))
    j_state = dataclasses.replace(jmppi.MPPIState.init(jc), u_prev=jnp.asarray(u_prev))
    j_out = jax.jit(lambda p, s, x, n: jmppi.mppi_step(jc, j_step, jsc, jtc, p, s, x, n, **jkw))(
        jp, j_state, jnp.asarray(x0), jnp.asarray(eps))
    solver = (port_solver or tmppi.MPPISolver)(tc, t_step, *tmppi.make_tracking_costs(tc),
                                               device="cpu", **tkw)
    state = tmppi.state_from_numpy(u_prev, 0, [0, 0], device="cpu")
    t_out = solver.step(tp, state, torch.as_tensor(x0), torch.as_tensor(eps))
    return j_out, t_out


def check_product_parity(j_out, t_out, tol: float = 1e-5):
    (u_j, st_j, aux_j), (u_t, st_t, aux_t) = j_out, t_out
    np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs), rtol=tol, atol=tol)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(st_t.u_prev.numpy(), np.asarray(st_j.u_prev), rtol=tol, atol=tol)
    np.testing.assert_allclose(aux_t.optimal_traj.numpy(), np.asarray(aux_j.optimal_traj),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("row", ["8", "9"])
@pytest.mark.parametrize("name", PRODUCT_CASES)
def test_product_step_plain_twin_matches_jax(name, row):
    """Rows 8 and 9's plain twins on a lifted step with matrix products
    against JAX's interpret-mode generic kernels on the same numpy noise:
    S, u0, the updated sequence and the optimal trajectory within 1e-5."""
    plain = gt.generic_mppi_tick_plain if row == "8" else gt.generic_rollout_costs_plain
    calls = plain.calls
    j_out, t_out = run_product_parity(name, row)
    assert plain.calls == calls + 1
    assert float(np.abs(np.asarray(j_out[2].costs)).max()) > 0.1
    check_product_parity(j_out, t_out)
