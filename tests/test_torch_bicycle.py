"""The race car's kernels (ops/cuda/rollout_bicycle.py, bicycle_tick.py) and
building blocks against the JAX package.

* the split rollout's plain version against ``bicycle_rollout_costs(...,
  interpret=True)``: rtol 3e-4, atol 2e-2 as tests/test_pallas_bicycle.py:98
  (float32 sums of T stage costs from two libraries' sin/cos/tan; the atol
  covers the 1e7 collision penalties' neighbours);
* the fused tick's plain version against ``bicycle_mppi_tick(..., eps=...,
  interpret=True)``: S rtol/atol 3e-4, w rtol 3e-4 atol 1e-6 as
  tests/test_bicycle_tick.py:113-117, Σw·ε rtol 1e-4 atol 1e-5 as its
  control tolerance (:118-120);
* the hash ε mode against the injected mode with the same ε (exact: both
  run the same plain code);
* the bicycle model, the vehicle polygon and the two speed paths, unit by
  unit (rtol 1e-6 / atol 1e-6: one float32 rounding apart).

On the CPU the wrappers run their plain versions; the kernels are held
against them on the card (marked ``cuda``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.models.dynamics import BicycleParams as JBicycleParams
from dnn_mppi_mpc_tpu.models.dynamics import kinematic_bicycle as j_bicycle
from dnn_mppi_mpc_tpu.ops.costs import vehicle_polygon_collision as j_polygon
from dnn_mppi_mpc_tpu.ops.pallas.bicycle_tick import bicycle_mppi_tick as j_tick
from dnn_mppi_mpc_tpu.ops.pallas.rollout_bicycle import bicycle_rollout_costs as j_rollout
from dnn_mppi_mpc_tpu.paths import generators as jpaths
from dnn_mppi_mpc_tpu_torch.models import BicycleParams, kinematic_bicycle
from dnn_mppi_mpc_tpu_torch.ops import costs as tcosts
from dnn_mppi_mpc_tpu_torch.ops.cuda import bicycle_tick as ttick
from dnn_mppi_mpc_tpu_torch.ops.cuda import rollout_bicycle as trollout
from dnn_mppi_mpc_tpu_torch.ops.cuda.mathx import hash_noise
from dnn_mppi_mpc_tpu_torch.paths import circle_with_speed, lemniscate_with_speed

K, T, DT = 1024, 10, 0.05
SIGMA = np.array([[0.5, 0.0], [0.0, 0.1]])
# by the start pose's front and left outline points: most rollouts clip them
OBSTACLES = np.array([[10.4, 4.9, 0.5], [7.9, 2.0, 0.3]], np.float32)
ORDER = ["u", "a", "x0", "window", "stage_w", "term_w", "u_min", "u_max"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, *, alpha=1.0, path="lemniscate", start=0, W=100, obstacles=False):
    """Numpy inputs of one race-car rollout, K samples, window rows
    [start, start + W) of a 100-point lemniscate or a 400-point circle."""
    rng = np.random.default_rng(seed)
    if path == "lemniscate":
        ref = np.asarray(jpaths.lemniscate_with_speed(10.0, 100), np.float32)
        x0 = np.array([10.0, 0.5, np.pi / 2, 3.0], np.float32)
    else:
        ref = np.asarray(jpaths.circle_with_speed(8.0, 400, speed=4.0), np.float32)
        x0 = np.array([*ref[start + 5, :2] + [0.3, -0.2], ref[start + 5, 2], 3.5], np.float32)
    u = rng.normal(scale=0.1, size=(T, 2)).astype(np.float32)
    gamma = 50.0 * (1.0 - alpha)
    return dict(
        eps=rng.multivariate_normal(np.zeros(2), SIGMA, (K, T)).astype(np.float32),
        u=u,
        a=(gamma * (u @ np.linalg.inv(SIGMA))).astype(np.float32),
        x0=x0,
        window=np.ascontiguousarray(ref[start:start + W]),
        stage_w=np.array([50.0, 50.0, 1.0, 20.0], np.float32),
        term_w=np.array([40.0, 40.0, 2.0, 10.0], np.float32),
        u_min=np.array([-0.523, -2.0], np.float32),
        u_max=np.array([0.523, 2.0], np.float32),
        obstacles=OBSTACLES if obstacles else None,
    )


def _rollout(inputs, backend, n_exploit=0.99 * K):
    conv = jnp.asarray if backend == "jax" else torch.as_tensor
    arr = {k: None if v is None else conv(np.array(v)) for k, v in inputs.items()}
    fn = j_rollout if backend == "jax" else trollout.bicycle_rollout_costs
    extra = dict(interpret=True) if backend == "jax" else {}
    W = inputs["window"].shape[0]
    return np.asarray(fn(arr["eps"], *(arr[k] for k in ORDER), DT, n_exploit,
                         obstacles=arr["obstacles"], T=T, W=W, **extra))


ROLLOUT_CASES = {
    "free_alpha1": dict(alpha=1.0),
    "obstacles_alpha1": dict(alpha=1.0, obstacles=True),
    "free_alpha0.8": dict(alpha=0.8),
    "obstacles_alpha0.8": dict(alpha=0.8, obstacles=True),
    "moving_window": dict(alpha=0.8, path="circle", start=37, W=50),
}


@pytest.mark.parametrize("case", list(ROLLOUT_CASES))
def test_bicycle_rollout_matches_jax(f32_mode, case):
    inputs = _inputs(0, **ROLLOUT_CASES[case])
    want = _rollout(inputs, "jax")
    got = _rollout(inputs, "torch")
    if inputs["obstacles"] is not None:
        assert K // 50 < (want > 1e6).sum() < K  # some rollouts hit, not all
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=2e-2)


def _tick(inputs, backend, *, iso_xy, eps=True, seed=0):
    conv = jnp.asarray if backend == "jax" else torch.as_tensor
    arr = {k: None if v is None else conv(np.array(v)) for k, v in inputs.items()}
    chol = conv(np.linalg.cholesky(SIGMA).astype(np.float32))
    W = inputs["window"].shape[0]
    args = [arr["u"], arr["a"], chol, *(arr[k] for k in ORDER[2:])]
    common = dict(obstacles=arr["obstacles"], eps=arr["eps"] if eps else None, K=K, T=T, W=W,
                  iso_xy=iso_xy)
    if backend == "jax":
        out = j_tick(jnp.asarray(seed), *args, DT, 0.99 * K, 1.0 / 50.0, interpret=True,
                     **common)
    else:
        out = ttick.bicycle_mppi_tick(torch.tensor([seed]), *args, DT, 0.99 * K, 1.0 / 50.0,
                                      **common)
    return [np.asarray(v) for v in out]


@pytest.mark.parametrize("iso_xy", [False, True], ids=["general", "iso_xy"])
@pytest.mark.parametrize("obstacles", [False, True], ids=["free", "obstacles"])
def test_bicycle_tick_injected_matches_jax(f32_mode, iso_xy, obstacles):
    inputs = _inputs(1, alpha=0.8, obstacles=obstacles)
    inputs["term_w"] = inputs["stage_w"]  # iso_xy needs symmetric weights
    (jS, jw, jweps), (tS, tw, tweps) = (_tick(inputs, b, iso_xy=iso_xy) for b in ("jax", "torch"))
    np.testing.assert_allclose(tS, jS, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(tw, jw, rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(tweps, jweps, rtol=1e-4, atol=1e-5)


def test_bicycle_tick_moving_window_matches_jax(f32_mode):
    inputs = _inputs(2, alpha=0.8, path="circle", start=37, W=50, obstacles=False)
    (jS, jw, jweps), (tS, tw, tweps) = (_tick(inputs, b, iso_xy=False) for b in ("jax", "torch"))
    np.testing.assert_allclose(tS, jS, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(tw, jw, rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(tweps, jweps, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("iso_xy", [False, True], ids=["general", "iso_xy"])
def test_bicycle_tick_hash_eps_equals_injected_hash_noise(iso_xy):
    """Generate mode draws ε = hash_noise(seed, chol, K, T, K): injecting
    that ε gives the same S, w and Σw·ε exactly."""
    inputs = {k: None if v is None else torch.as_tensor(v)
              for k, v in _inputs(3, alpha=0.8, obstacles=True).items()}
    inputs["term_w"] = inputs["stage_w"]
    chol = torch.as_tensor(np.linalg.cholesky(SIGMA).astype(np.float32))
    seed = torch.tensor([0x2468ACE1])
    args = [inputs["u"], inputs["a"], chol, *(inputs[k] for k in ORDER[2:])]
    kw = dict(obstacles=inputs["obstacles"], K=K, T=T, W=100, iso_xy=iso_xy)
    S, w, w_eps, eps = ttick.bicycle_mppi_tick(seed, *args, DT, 0.99 * K, 0.02, emit_eps=True,
                                               **kw)
    torch.testing.assert_close(eps, hash_noise(seed, chol, K, T, K), rtol=0, atol=0)
    S2, w2, w_eps2 = ttick.bicycle_mppi_tick(seed, *args, DT, 0.99 * K, 0.02, eps=eps, **kw)
    for got, want in ((S2, S), (w2, w), (w_eps2, w_eps)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bicycle_wrappers_run_plain_on_cpu_and_count():
    inputs = {k: None if v is None else torch.as_tensor(v) for k, v in _inputs(4).items()}
    calls = trollout.bicycle_rollout_costs_plain.calls
    launches = trollout.bicycle_rollout_costs.launches
    S = trollout.bicycle_rollout_costs(inputs["eps"], *(inputs[k] for k in ORDER), DT, K,
                                       T=T, W=100)
    assert S.shape == (K,) and S.dtype == torch.float32 and bool(torch.isfinite(S).all())
    assert trollout.bicycle_rollout_costs_plain.calls == calls + 1
    assert trollout.bicycle_rollout_costs.launches == launches  # CPU: no launch
    calls, launches = ttick.bicycle_mppi_tick_plain.calls, ttick.bicycle_mppi_tick.launches
    chol = torch.as_tensor(np.linalg.cholesky(SIGMA).astype(np.float32))
    ttick.bicycle_mppi_tick(torch.tensor([1]), inputs["u"], inputs["a"], chol,
                            *(inputs[k] for k in ORDER[2:]), DT, K, 0.02, K=K, T=T, W=100)
    assert ttick.bicycle_mppi_tick_plain.calls == calls + 1
    assert ttick.bicycle_mppi_tick.launches == launches


def test_window_past_shared_memory_raises():
    """The kernels stage the whole window in shared memory: a window that
    does not fit raises instead of being cut short."""
    trollout.check_staging(20, 200, 2)  # the race car's suite shape fits
    ref = circle_with_speed(8.0, 3200, device="cpu")
    inputs = {k: None if v is None else torch.as_tensor(v) for k, v in _inputs(5).items()}
    with pytest.raises(ValueError, match="shared memory"):
        trollout.bicycle_rollout_costs(inputs["eps"], inputs["u"], inputs["a"], inputs["x0"],
                                       ref, *(inputs[k] for k in ORDER[4:]), DT, K,
                                       T=T, W=3200)


# --- building blocks ---------------------------------------------------------


def test_kinematic_bicycle_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    u = rng.uniform(-0.5, 0.5, size=(64, 2)).astype(np.float32)
    want = np.asarray(j_bicycle(jnp.asarray(x), jnp.asarray(u),
                                JBicycleParams(wheel_base=jnp.float32(2.5))))
    got = kinematic_bicycle(torch.as_tensor(x), torch.as_tensor(u), BicycleParams(2.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    default = kinematic_bicycle(torch.as_tensor(x), torch.as_tensor(u))  # L = 2.5
    np.testing.assert_array_equal(default.numpy(), got.numpy())


def test_vehicle_polygon_collision_matches_jax():
    assert tcosts.VEHICLE_OUTLINE_X == (-1.0, -1.0, 0.0, 1.0, 1.0, 1.0, 0.0, -1.0, -1.0)
    assert tcosts.VEHICLE_OUTLINE_Y == (0.0, 1.0, 1.0, 1.0, 0.0, -1.0, -1.0, -1.0, 0.0)
    rng = np.random.default_rng(7)
    pose = np.concatenate(
        [rng.uniform(2.0, 12.0, (16, 32, 2)), rng.uniform(-4.0, 4.0, (16, 32, 1)),
         rng.uniform(0.0, 5.0, (16, 32, 1))], -1).astype(np.float32)
    obs = np.array([[5.0, 5.0, 1.0], [7.0, 7.0, 1.0], [10.0, 3.0, 0.5]], np.float32)
    want = np.asarray(j_polygon(jnp.asarray(pose), jnp.asarray(obs), 4.0, 3.0, 1.5))
    got = tcosts.vehicle_polygon_collision(torch.as_tensor(pose), torch.as_tensor(obs),
                                           4.0, 3.0, 1.5)
    assert 0.1 < want.mean() < 0.9
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "name, args",
    [("lemniscate_with_speed", (10.0, 200, 5.0)), ("circle_with_speed", (8.0, 400, 4.0)),
     ("lemniscate_with_speed", (3.0, 7, 1.5))],
    ids=["lemniscate", "circle", "lemniscate_short"],
)
def test_speed_paths_match_jax(name, args):
    want = np.asarray(getattr(jpaths, name)(*args))
    got = {"lemniscate_with_speed": lemniscate_with_speed,
           "circle_with_speed": circle_with_speed}[name](*args, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape == (args[1], 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_bicycle_kernels_match_plain_on_card(cuda_device):
    inputs = {k: None if v is None else torch.as_tensor(v, device=cuda_device)
              for k, v in _inputs(8, alpha=0.8, obstacles=True).items()}
    args = [inputs["eps"], *(inputs[k] for k in ORDER)]
    kw = dict(obstacles=inputs["obstacles"], T=T, W=100)
    got = trollout.bicycle_rollout_costs(*args, DT, 0.99 * K, **kw)
    want = trollout.bicycle_rollout_costs_plain(*args, DT, 0.99 * K, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    chol = torch.as_tensor(np.linalg.cholesky(SIGMA).astype(np.float32), device=cuda_device)
    seed = torch.tensor([77], device=cuda_device)
    targs = [inputs["u"], inputs["a"], chol, *(inputs[k] for k in ORDER[2:])]
    got = ttick.bicycle_mppi_tick(seed, *targs, DT, 0.99 * K, 0.02, K=K, emit_eps=True, **kw)
    want = ttick.bicycle_mppi_tick_plain(seed, *targs, DT, 0.99 * K, 0.02, K=K, emit_eps=True,
                                         **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
