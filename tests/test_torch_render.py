"""The port's rasterizer (``envs/render.py``) against the JAX package's
``raster_scene``, on the CPU: without obstacles, with them, on a batch of
poses and goals against JAX's per-frame ``vmap``, and
tests/test_train_extras.py:107-146's observability checks. JAX runs with
x64 off, as the package runs outside this suite (its grid is
``jnp.linspace`` of Python floats: float64 under the suite's x64 setting).

Tolerance rtol 1e-6, atol 4e-6: XLA's float32 ``linspace`` is within two
ulps at |x| ≤ 5 (9.5e-7) of the port's start·(1 − s) + stop·s, and no
closed form gives its bits; the steepest slope of a channel is the
obstacle ramp's 1/0.3 a metre (the blobs' are at most 1/(r·√e) ≈ 3.4 for
the heading marker, times 0.7), so a grid point one such step apart moves
a pixel by up to 3.3e-6."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.envs.render import raster_scene as j_raster
from dnn_mppi_mpc_tpu_torch.envs.render import raster_scene


def _close(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    print(f"{name}: max abs err {float(np.abs(got - want).max()):.3e} (rtol 1e-6, atol 4e-6)")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=4e-6, err_msg=name)


POSE, GOAL = np.float32([1.0, -2.0, 0.7]), np.float32([-3.0, 3.0])
OBSTACLES = np.float32([[0.0, 0.0, 0.8], [2.5, 1.0, 0.4]])


@pytest.mark.parametrize("obstacles", [None, OBSTACLES])
@pytest.mark.parametrize("size,extent", [(48, 5.0), (32, 4.0)])
def test_raster_scene_matches_jax(obstacles, size, extent):
    with jax.enable_x64(False):
        want = j_raster(jnp.asarray(POSE), jnp.asarray(GOAL),
                        None if obstacles is None else jnp.asarray(obstacles), size=size,
                        extent=extent)
    got = raster_scene(torch.from_numpy(POSE), torch.from_numpy(GOAL),
                       None if obstacles is None else torch.from_numpy(obstacles), size=size,
                       extent=extent)
    assert got.shape == (size, size, 3)
    _close(f"one frame, size {size}, obstacles {obstacles is not None}", got, want)


def test_batched_frames_match_jax_vmap():
    rng = np.random.default_rng(0)
    poses = rng.uniform(-2.0, 2.0, (2, 3, 3)).astype(np.float32)
    goals = rng.uniform(-2.0, 2.0, (2, 3, 2)).astype(np.float32)
    obstacles = rng.uniform(0.2, 1.5, (2, 3, 2, 3)).astype(np.float32)
    frame = jax.vmap(jax.vmap(lambda p, g, o: j_raster(p, g, o, size=24, extent=2.5)))
    with jax.enable_x64(False):
        want = frame(jnp.asarray(poses), jnp.asarray(goals), jnp.asarray(obstacles))
    got = raster_scene(*map(torch.from_numpy, (poses, goals, obstacles)), size=24, extent=2.5)
    assert got.shape == (2, 3, 24, 24, 3)
    _close("a (2, 3) batch with obstacles", got, want)
    # one goal for the whole batch broadcasts against the poses
    shared = raster_scene(torch.from_numpy(poses), torch.zeros(2), None, size=24, extent=2.5)
    assert shared.shape == (2, 3, 24, 24, 3)


def test_raster_scene_observability():
    size, extent = 32, 4.0
    img = raster_scene(torch.tensor([1.0, -2.0, 0.0]), torch.tensor([-3.0, 3.0]),
                       torch.tensor([[0.0, 0.0, 0.8]]), size=size, extent=extent)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0

    def to_px(x, y):  # column ~ x, row ~ y
        return (int(round((y + extent) / (2 * extent) * (size - 1))),
                int(round((x + extent) / (2 * extent) * (size - 1))))

    assert float(img[(*to_px(1.0, -2.0), 0)]) > 0.8
    assert float(img[(*to_px(-3.0, 3.0), 1)]) > 0.8
    assert float(img[(*to_px(0.0, 0.0), 2)]) > 0.9
    turned = raster_scene(torch.tensor([1.0, -2.0, 2.0]), torch.tensor([-3.0, 3.0]), None,
                          size=size, extent=extent)
    assert float((turned[..., 0] - img[..., 0]).abs().max()) > 0.3
