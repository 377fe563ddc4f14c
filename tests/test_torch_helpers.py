"""The port's cost and filter helpers and ``utils/profiling.py`` against the
JAX package's, on the CPU.

* ``quadratic_tracking_cost`` (with and without the yaw wrap),
  ``control_energy_cost`` and ``einsum_quadratic_cost`` against JAX's on the
  same arrays (float64, 1e-12) and tests/test_ops.py:164-173's closed forms;
* ``moving_average_edge``, ``moving_average_padded`` and ``savgol_filter``
  against the reference's scalar semantics and scipy (tests/test_ops.py:
  53-69's shapes, float64, 1e-10), against JAX's helpers, and against the
  port's own filter matrices (the form ``apply_filter`` runs);
* ``mppi_roofline``: operations, bytes and intensity equal to JAX's model,
  times against the H100 peaks the module names; ``Timer``, ``time_fn`` and
  ``trace`` on the CPU (the card's ``trace`` and ``time_fn`` raise without
  one).
"""

from __future__ import annotations

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import savgol_filter as scipy_savgol

from dnn_mppi_mpc_tpu.ops import costs as jcosts
from dnn_mppi_mpc_tpu.ops import filters as jfilters
from dnn_mppi_mpc_tpu.utils import profiling as jprof
from dnn_mppi_mpc_tpu_torch.config import SmoothingFilter
from dnn_mppi_mpc_tpu_torch.ops import costs as tcosts
from dnn_mppi_mpc_tpu_torch.ops import filters as tfilters
from dnn_mppi_mpc_tpu_torch.ops.sampling import sigma_inverse
from dnn_mppi_mpc_tpu_torch.utils import profiling as tprof


def _ref_moving_average_edge(xx, window_size):
    # the scalar semantics of mppi_differential_drive.py:257-271 (tests/test_ops.py)
    b = np.ones(window_size) / window_size
    out = np.zeros_like(xx)
    n_conv = math.ceil(window_size / 2)
    for d in range(xx.shape[1]):
        out[:, d] = np.convolve(xx[:, d], b, mode="same")
        out[0, d] *= window_size / n_conv
        for i in range(1, n_conv):
            out[i, d] *= window_size / (i + n_conv)
            out[-1, d] *= window_size / (i + n_conv - (window_size % 2))
    return out


def _ref_moving_average_padded(xx, window_size):
    # mppi_race_car_obstacle.py:228-239 (tests/test_ops.py)
    k = window_size
    kernel = np.ones(k) / k
    out = np.zeros_like(xx)
    for d in range(xx.shape[1]):
        padded = np.concatenate([xx[: k // 2, d], xx[:, d], xx[-(k // 2):, d]])
        out[:, d] = np.convolve(padded, kernel, mode="same")[k // 2: -(k // 2)]
    return out


def _t64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


@pytest.mark.parametrize("T,w", [(10, 10), (20, 10), (50, 10), (25, 7)])
def test_moving_average_edge(T, w):
    x = np.random.default_rng(0).normal(size=(T, 2))
    got = tfilters.moving_average_edge(_t64(x), w).numpy()
    np.testing.assert_allclose(got, _ref_moving_average_edge(x, w), rtol=1e-10)
    np.testing.assert_allclose(got, np.asarray(jfilters.moving_average_edge(jnp.asarray(x), w)),
                               rtol=1e-10, atol=1e-14)
    F = tfilters.filter_matrix(SmoothingFilter.MOVING_AVERAGE_EDGE.value, T, w)
    np.testing.assert_allclose(got, F @ x, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("T,w", [(10, 10), (20, 10), (50, 8), (9, 1)])
def test_moving_average_padded(T, w):
    x = np.random.default_rng(1).normal(size=(T, 2))
    got = tfilters.moving_average_padded(_t64(x), w).numpy()
    if w > 1:
        np.testing.assert_allclose(got, _ref_moving_average_padded(x, w), rtol=1e-10)
    np.testing.assert_allclose(got, np.asarray(jfilters.moving_average_padded(jnp.asarray(x), w)),
                               rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("T,w,p", [(50, 11, 3), (60, 21, 3), (50, 51, 3), (20, 8, 2)])
def test_savgol_filter(T, w, p):
    x = np.random.default_rng(2).normal(size=(T, 2))
    got = tfilters.savgol_filter(_t64(x), w, p).numpy()
    w_eff = min(w, T)
    if w_eff % 2 == 0:
        w_eff -= 1
    want = scipy_savgol(x, w_eff, min(p, w_eff - 1), axis=0, mode="interp")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(got, np.asarray(jfilters.savgol_filter(jnp.asarray(x), w, p)),
                               rtol=1e-9, atol=1e-12)
    F = tfilters.filter_matrix(SmoothingFilter.SAVGOL.value, T, w, p)
    np.testing.assert_allclose(got, F @ x, rtol=1e-9, atol=1e-12)


def test_filters_in_float32_follow_the_matrix():
    """In float32 each helper stays float32 and follows the float64 product
    F @ x (its product runs in full float32, ``matmul_f32``)."""
    x = np.random.default_rng(3).normal(size=(30, 2)).astype(np.float32)
    for fn, kind, args in ((tfilters.moving_average_edge, SmoothingFilter.MOVING_AVERAGE_EDGE,
                            (10,)),
                           (tfilters.moving_average_padded, SmoothingFilter.MOVING_AVERAGE_PADDED,
                            (10,)),
                           (tfilters.savgol_filter, SmoothingFilter.SAVGOL, (11, 3))):
        got = fn(torch.as_tensor(x), *args)
        assert got.dtype == torch.float32
        F = tfilters.filter_matrix(kind.value, 30, *args)
        np.testing.assert_allclose(got.numpy(), F @ x.astype(np.float64), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wrap_yaw", [False, True])
def test_quadratic_tracking_cost_matches_jax(wrap_yaw):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 7, 4)) * 3.0
    ref = rng.normal(size=(5, 7, 4))
    w = np.array([50.0, 50.0, 1.0, 20.0])
    got = tcosts.quadratic_tracking_cost(_t64(x), _t64(ref), _t64(w), wrap_yaw=wrap_yaw)
    want = jcosts.quadratic_tracking_cost(jnp.asarray(x), jnp.asarray(ref), jnp.asarray(w),
                                          wrap_yaw=wrap_yaw)
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_control_energy_cost():
    sigma = torch.tensor([[0.5, 0.0], [0.0, 0.1]])
    u, v = torch.tensor([1.0, 2.0]), torch.tensor([0.5, -1.0])
    got = float(tcosts.control_energy_cost(u, v, sigma_inverse(sigma), gamma=0.8))
    np.testing.assert_allclose(got, 0.8 * (1.0 / 0.5 * 0.5 + 2.0 / 0.1 * -1.0), rtol=1e-5)
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 3))
    s_inv, un, vv = a @ a.T + np.eye(3), rng.normal(size=(6, 3)), rng.normal(size=(4, 6, 3))
    np.testing.assert_allclose(
        tcosts.control_energy_cost(_t64(un), _t64(vv), _t64(s_inv), 0.3).numpy(),
        np.asarray(jcosts.control_energy_cost(jnp.asarray(un), jnp.asarray(vv),
                                              jnp.asarray(s_inv), 0.3)), rtol=1e-12)


def test_einsum_quadratic_cost():
    x, ref, q = torch.tensor([[1.0, 2.0, 3.0]]), torch.zeros(1, 3), torch.tensor([30.0, 5.0, 9.0])
    np.testing.assert_allclose(float(tcosts.einsum_quadratic_cost(x, ref, q)[0]), 30 + 20 + 81,
                               rtol=1e-6)
    rng = np.random.default_rng(6)
    xs, refs, qd = rng.normal(size=(8, 3)), rng.normal(size=(8, 3)), rng.random(3)
    np.testing.assert_allclose(
        tcosts.einsum_quadratic_cost(_t64(xs), _t64(refs), _t64(qd)).numpy(),
        np.asarray(jcosts.einsum_quadratic_cost(jnp.asarray(xs), jnp.asarray(refs),
                                                jnp.asarray(qd))), rtol=1e-12)


# --- profiling --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(10240, 50, 20, 2, 0), (1024, 25, 20, 4, 2), (128, 10, 1, 2, 3)])
def test_mppi_roofline_counts_as_jax(shape):
    K, T, W, nu, n_obs = shape
    got = tprof.mppi_roofline(K, T, W, dim_u=nu, n_obs=n_obs)
    want = jprof.mppi_roofline(K, T, W, dim_u=nu, n_obs=n_obs)
    for key in ("flops", "bytes", "arithmetic_intensity"):
        assert got[key] == want[key], key
    assert got["t_compute_us"] == pytest.approx(got["flops"] / 67e12 * 1e6)
    assert got["t_memory_us"] == pytest.approx(got["bytes"] / 3.35e12 * 1e6)
    assert got["bound"] == ("compute" if got["t_compute_us"] > got["t_memory_us"] else "memory")
    # with JAX's TPU peaks passed in, the JAX numbers
    tpu = tprof.mppi_roofline(K, T, W, dim_u=nu, n_obs=n_obs, hbm_bytes_per_s=820e9,
                              flops=3900e9)
    assert tpu["t_compute_us"] == pytest.approx(want["t_compute_us"])
    assert tpu["t_memory_us"] == pytest.approx(want["t_memory_us"])
    assert tpu["bound"] == want["bound"]


def test_peaks_are_the_bounds_of_chip_smoke():
    import chip_smoke

    assert chip_smoke.F32_PEAK == tprof.H100_F32_FLOPS == 67e12
    assert chip_smoke.BF16_PEAK == tprof.H100_BF16_FLOPS == 989e12
    assert chip_smoke.HBM_RATE == tprof.H100_HBM_BYTES_PER_S == 3.35e12


def test_timer_and_time_fn_on_the_cpu():
    t = tprof.Timer()
    assert t.summary() == {}
    for _ in range(5):
        with t:
            sum(range(1000))
    s = t.summary()
    assert s["n"] == 5 and s["p50_ms"] > 0 and s["hz"] == pytest.approx(1e3 / s["p50_ms"])
    calls = []
    out = tprof.time_fn(lambda a: calls.append(a), 3, iters=4, warmup=2, device="cpu")
    assert out["n"] == 4 and calls == [3] * 6


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()
