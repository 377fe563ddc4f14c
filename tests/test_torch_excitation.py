"""The port's excitation signals (``train/excitation.py``) against the JAX
package's, on the CPU.

* ``step_sequence``, ``ramp_sequence`` and ``sine_sequence`` equal JAX's
  (rtol 1e-6, atol 1e-7);
* the random ones draw from a ``torch.Generator``, so they are held to
  tests/test_train_extras.py:19-57's properties instead: ``random_sequence``'s
  zero-order hold and bounds, ``multisine_sequence``'s bound, and
  ``latin_hypercube``'s one sample per stratum in each dimension; the
  batched forms draw ``batch`` independent sequences of the same shape,
  and one seed repeats.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.train import excitation as jex
from dnn_mppi_mpc_tpu_torch.train import excitation as tex


def _close(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    print(f"{name}: max abs err {float(np.abs(got - want).max()):.3e} (rtol 1e-6, atol 1e-7)")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=name)


def _f32(*a):
    return jnp.asarray(np.asarray(a, np.float32))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_deterministic_sequences_match_jax():
    amps = [1.0, 0.5]
    _close("step", tex.step_sequence(40, amps, 10, device="cpu"),
           jex.step_sequence(40, _f32(*amps), 10))
    _close("ramp", tex.ramp_sequence(50, [0.1, 0.2], [2.0, 3.0], device="cpu"),
           jex.ramp_sequence(50, _f32(0.1, 0.2), _f32(2.0, 3.0)))
    _close("sine", tex.sine_sequence(100, amps, [1.0, 2.0], 0.01, device="cpu"),
           jex.sine_sequence(100, _f32(*amps), _f32(1.0, 2.0), 0.01))


def test_step_ramp_sine_shapes_and_bounds():
    s = tex.step_sequence(40, [1.0, 0.5], 10, device="cpu")
    assert s.shape == (40, 2) and s.dtype == torch.float32
    assert torch.equal(s.abs(), torch.tensor([1.0, 0.5]).expand(40, 2))
    assert torch.equal(s[0], -s[10])
    r = tex.ramp_sequence(50, [0.1, 0.2], [2.0, 3.0], device="cpu")
    assert float(r[:, 0].max()) <= 2.0 and float(r[:, 1].max()) <= 3.0
    w = tex.sine_sequence(100, [1.0, 0.5], [1.0, 2.0], dt=0.01, device="cpu")
    assert float(w.abs().max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("batch", [None, 3])
def test_random_sequence_hold(batch):
    u = tex.random_sequence(_gen(), 20, [-1.0, 0.0], [1.0, 2.0], hold=5, batch=batch,
                            device="cpu")
    u = u if batch else u[None]
    assert u.shape == (batch or 1, 20, 2)
    for b in range(4):
        assert torch.equal(u[:, 5 * b:5 * (b + 1)], u[:, 5 * b:5 * b + 1].expand(-1, 5, -1))
    assert float(u[..., 0].min()) >= -1.0 and float(u[..., 0].max()) < 1.0
    assert float(u[..., 1].min()) >= 0.0 and float(u[..., 1].max()) < 2.0
    if batch:
        assert not torch.equal(u[0], u[1])
    again = tex.random_sequence(_gen(), 20, [-1.0, 0.0], [1.0, 2.0], hold=5, batch=batch,
                                device="cpu")
    assert torch.equal(again if batch else again[None], u)


@pytest.mark.parametrize("batch", [None, 4])
def test_multisine_is_smooth_and_bounded(batch):
    u = tex.multisine_sequence(_gen(1), 200, 2, batch=batch, device="cpu")
    assert u.shape == ((batch,) if batch else ()) + (200, 2)
    assert float(u.abs().max()) < 2.0
    # smooth: a tone's frequency is at most 1 rad a tick
    assert float((u[..., 1:, :] - u[..., :-1, :]).abs().max()) < 1.5


def test_latin_hypercube_stratification():
    bounds = [[0.0, 1.0], [-2.0, 2.0], [5.0, 10.0]]
    n = 50
    x = tex.latin_hypercube(_gen(2), n, bounds, device="cpu").numpy()
    assert x.shape == (n, 3)
    for d, (lo, hi) in enumerate(bounds):
        assert np.all(x[:, d] >= lo) and np.all(x[:, d] <= hi)
        strata = ((x[:, d] - lo) / (hi - lo) * n).astype(int)
        assert len(np.unique(np.clip(strata, 0, n - 1))) == n
