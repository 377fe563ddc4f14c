"""The split rollout (ops/cuda/rollout.py) against the JAX Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs ``diffdrive_rollout_costs`` in Pallas interpret mode. Same numpy inputs
(also with a NaN window row past row 0 and at row 0, and with rows that tie
exactly), the tolerances of tests/test_pallas_rollout.py (rtol 2e-4, atol 1e-3: float32
sums of T stage costs from two libraries' sin/cos). The kernel itself is
held against the plain version on the card (marked ``cuda``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.ops.pallas.rollout import diffdrive_rollout_costs as j_rollout
from dnn_mppi_mpc_tpu_torch.ops.cuda import rollout as trollout

K, T, W, DT = 1024, 10, 20, 0.1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, obstacles, window="plain"):
    """``window``: "nan_row7" / "nan_row0" set that window row all NaN;
    "tie" gives rows [10, 20) the (x, y) of rows [0, 10) with another yaw, so
    the nearest row always ties and the first of the two must win."""
    rng = np.random.default_rng(seed)
    n = 100
    path = np.stack(
        [np.linspace(0, 10, n), np.linspace(0, -5, n), np.full(n, np.arctan2(-5, 10))], 1
    ).astype(np.float32)
    if window in ("nan_row7", "nan_row0"):
        path[int(window[-1])] = np.nan
    elif window == "tie":
        path[10:W, :2] = path[:W - 10, :2]
        path[10:W, 2] += 1.0
    sigma = np.array([[0.1, 0.0], [0.0, 0.01]])
    u = rng.normal(scale=0.3, size=(T, 2)).astype(np.float32)
    u[:, 0] += 1.5
    return dict(
        eps=rng.multivariate_normal(np.zeros(2), sigma, size=(K, T)).astype(np.float32),
        u=u,
        a=(0.8 * (u @ np.linalg.inv(sigma))).astype(np.float32),
        x0=np.array([0.3, -0.1, -0.3], np.float32),
        window=path[:W],
        stage_w=np.array([5.0, 5.0, 10.0], np.float32),
        term_w=np.array([6.0, 4.0, 10.0], np.float32),
        u_min=np.array([-5.0, -3.14], np.float32),
        u_max=np.array([5.0, 3.14], np.float32),
        obstacles=np.array([[1.0, -0.5, 0.3], [1.6, -0.9, 0.2]], np.float32) if obstacles else None,
    )


def _run(inputs, backend, *, last_only, exploration, k_offset=0.0):
    conv = jnp.asarray if backend == "jax" else torch.as_tensor
    arrays = {k: None if v is None else conv(v) for k, v in inputs.items()}
    fn = j_rollout if backend == "jax" else trollout.diffdrive_rollout_costs
    extra = dict(interpret=True) if backend == "jax" else {}
    return np.asarray(fn(
        arrays["eps"], arrays["u"], arrays["a"], arrays["x0"], arrays["window"],
        arrays["stage_w"], arrays["term_w"], arrays["u_min"], arrays["u_max"],
        DT, (1.0 - exploration) * K, obstacles=arrays["obstacles"], k_offset=k_offset,
        T=T, W=W, last_only=last_only, **extra,
    ))


# (last_only, obstacles, window); the kernels' running min: a NaN row past
# row 0 is never the nearest, a NaN row 0 is kept (every cost NaN), and of
# two rows that tie exactly the first wins
ROLLOUT_CASES = {
    "False-False": (False, False, "plain"),
    "False-True": (False, True, "plain"),
    "True-False": (True, False, "plain"),
    "True-True": (True, True, "plain"),
    "nan_row7": (False, True, "nan_row7"),
    "nan_row0": (False, False, "nan_row0"),
    "tie": (True, False, "tie"),
}


@pytest.mark.parametrize("last_only, obstacles, window", list(ROLLOUT_CASES.values()),
                         ids=list(ROLLOUT_CASES))
def test_rollout_matches_jax(obstacles, last_only, window):
    inputs = _inputs(0, obstacles, window)
    want = _run(inputs, "jax", last_only=last_only, exploration=0.0001)
    got = _run(inputs, "torch", last_only=last_only, exploration=0.0001)
    if obstacles:
        assert (want > 1e6).sum() > K // 20  # the obstacles are hit
    assert np.isnan(want).all() if window == "nan_row0" else np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)


def test_rollout_exploration_split_with_offset_matches_jax():
    """Global sample indices (k + k_offset) decide the exploit/explore split."""
    inputs = _inputs(1, False)
    want = _run(inputs, "jax", last_only=False, exploration=0.3, k_offset=256.0)
    got = _run(inputs, "torch", last_only=False, exploration=0.3, k_offset=256.0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)


def test_rollout_plain_version_counts_calls():
    inputs = {k: None if v is None else torch.as_tensor(v) for k, v in _inputs(2, False).items()}
    before = trollout.diffdrive_rollout_costs_plain.calls
    launches = trollout.diffdrive_rollout_costs.launches
    S = trollout.diffdrive_rollout_costs(
        inputs["eps"], inputs["u"], inputs["a"], inputs["x0"], inputs["window"],
        inputs["stage_w"], inputs["term_w"], inputs["u_min"], inputs["u_max"],
        DT, K, T=T, W=W,
    )
    assert S.shape == (K,) and S.dtype == torch.float32
    assert trollout.diffdrive_rollout_costs_plain.calls == before + 1
    assert trollout.diffdrive_rollout_costs.launches == launches  # CPU: no launch


@pytest.mark.cuda
def test_rollout_kernel_matches_plain_on_card(cuda_device):
    inputs = _inputs(3, True)
    args = {k: None if v is None else torch.as_tensor(v, device=cuda_device)
            for k, v in inputs.items()}
    call = dict(dt=DT, n_exploit=0.9 * K, T=T, W=W)
    got = trollout.diffdrive_rollout_costs(**args, **call)
    want = trollout.diffdrive_rollout_costs_plain(**args, **call)
    torch.cuda.synchronize()
    # same operations in the same order; sincosf vs torch.sin/cos at most
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
