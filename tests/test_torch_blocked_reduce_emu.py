"""The K-blocked tick's chunked reductions, their own source run on the CPU.

``csrc/mppi_kernels.cu`` (with ``csrc/mppi_reductions.cuh``) is compiled
with g++ against ``tests/cuda_emu.h`` by ``tests/cuda_emu.py`` (every thread
a fiber on the calling thread, a block's threads meeting at each
``__syncthreads``, a warp's lanes at each shuffle), and ``launch_tick``
drives the K-blocked tick (eps_mode 2) through ctypes on CPU tensors with
its real argument block and the scratch the library sizes
(``dmm_chunk_scratch_floats``): the rollout, then the online softmax over C
chunks of K and Σ w·ε on the (C, ⌈T/5⌉) grid with ε drawn again, the
chunks' partials summed in chunk order. The library sizes the chunks from
the launch (the first layout of samples a thread and steps a block whose
Σ w·ε grid reaches 264 blocks), so at these small K every chunk is the
smallest, 256 samples or its noise-stream block, and every block does one
step: one chunk a block, three in one block with the last one shorter, two
full chunks at an offset block, two groups of steps. ρ, η, w and Σ w·ε must
match ``softmax_plain`` and ``weighted_noise_plain`` on the kernel's own S,
and S the plain rollout, within ``chip_smoke.py``'s TOL; a second call must
repeat the first bit for bit. Chunks of several samples a thread and several
steps a block run on the CPU in ``test_torch_diffdrive_kernel_emu.py`` (a
build with a smaller fill target) and on the card (``chip_smoke.py``: the
pod-K tick's 2 048 samples and five steps). Skips without g++.
"""

from __future__ import annotations

import ctypes

import cuda_emu
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from dnn_mppi_mpc_tpu_torch.ops.cuda import mppi_tick as mt
from dnn_mppi_mpc_tpu_torch.ops.cuda.common import (
    rollout_body_plain,
    softmax_plain,
    weighted_noise_plain,
)
from dnn_mppi_mpc_tpu_torch.ops.cuda.mathx import hash_noise

W, DT, SEED = 8, 0.1, 1234


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernel source built for the CPU; ``launch_tick`` pointed at it."""
    torch.set_num_threads(1)
    lib = cuda_emu.build(["mppi_kernels.cu"], tmp_path_factory.mktemp("blocked_emu"))
    if lib is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    cuda_emu.torch_math(lib)
    lib.dmm_mppi_tick.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dmm_chunk_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.dmm_chunk_scratch_floats.restype = ctypes.c_longlong

    def launch(entry, args, device):
        assert device.type == "cpu"
        err = getattr(lib, entry)(ctypes.addressof(args), None)
        if err != 0:
            raise RuntimeError(f"{entry}: error {err} at launch")

    mp = pytest.MonkeyPatch()
    mp.setattr(mt, "launch", launch)
    mp.setattr(mt, "load_kernels", lambda: lib)
    yield lib
    mp.undo()


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    sigma = np.array([[0.1, 0.02], [0.02, 0.05]])
    u = rng.normal(0.0, 0.3, (T, 2))
    u[:, 0] += 1.0
    path = np.stack([np.linspace(0, 4, W), np.linspace(0, -2, W), np.full(W, -0.46)], 1)
    f = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    return dict(u=f(u), a=f(0.5 * u @ np.linalg.inv(sigma)),
                chol_sigma=f(np.linalg.cholesky(sigma)), x0=f([0.1, -0.1, -0.3]),
                window=f(path), stage_w=f([5.0, 5.0, 1.0]), term_w=f([6.0, 6.0, 1.0]),
                u_min=f([-2.0, -1.5]), u_max=f([2.0, 1.5]))


def _tick(p, *, K, k_blk, T, inv_temperature, block_offset=0):
    return mt.launch_tick(
        **p, seed=torch.tensor([SEED]), dt=DT, n_exploit=0.9 * K,
        inv_temperature=inv_temperature, obstacles=None, obstacle_velocities=None,
        robot_radius=0.5, safety_margin_rate=1.5, soft_safety_distance=2.0, soft_weight=100.0,
        control_weight=None, filter_t=None, eps=None, eps_mode=2, k_blk=k_blk, K=K, T=T, W=W,
        last_only=False, collision="circle", iso_xy=False, k_offset=0.0,
        block_offset=block_offset)


def _close(name, got, want):
    atol, rtol = TOL[name]
    err = float((got - want).abs().max())
    print(f"{name}: max abs err {err:.3e} (atol {atol}, rtol {rtol})")
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


# (K, k_blk, T, block offset): chunks of one noise-stream block each (C = 3);
# a 640-sample block in three chunks of 214, 214 and 212; two full
# 256-sample chunks at an offset block; T = 2 over two groups of one step
CASES = {
    "C3 one chunk a block": (384, 128, 4, 0),
    "C3 ragged in one block": (640, 640, 2, 0),
    "C2 full chunks offset": (512, 256, 3, 5),
    "C2 two step groups": (256, 128, 2, 2),
}


@pytest.mark.parametrize("inv_t", [1.0 / 0.8, 1.0e4], ids=["lambda1.25", "lambda1e4"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_reductions_match_plain(emu, case, inv_t):
    K, k_blk, T, off = CASES[case]
    p = _inputs(T)
    out = _tick(p, K=K, k_blk=k_blk, T=T, inv_temperature=inv_t, block_offset=off)
    S = out["S"]
    eps = hash_noise(torch.tensor([SEED]), p["chol_sigma"], K, T, k_blk, off)
    want_S = rollout_body_plain(eps, *(p[k] for k in ("u", "a", "x0", "window", "stage_w",
                                                       "term_w", "u_min", "u_max")),
                                dt=DT, n_exploit=0.9 * K)
    _close("S", S, want_S)
    rho, eta, w = softmax_plain(S, inv_t)
    _close("rho", out["stats"][0], rho)
    _close("eta", out["stats"][1], eta)
    _close("w", out["w"], w)
    _close("w_eps", out["w_eps"], weighted_noise_plain(w, eps))
    again = _tick(p, K=K, k_blk=k_blk, T=T, inv_temperature=inv_t, block_offset=off)
    for name in ("S", "w", "w_eps", "stats"):
        assert torch.equal(again[name], out[name]), name


# (K, k_blk, T) -> floats: 2 per chunk (m_c, s_c) and a (T, C, 2) partial;
# -1 where K is no multiple of k_blk. A 4 480-sample block at T = 2 in 18
# chunks of 249 (247 the last): a grid of 18 blocks never reaches the fill
# target, so the chunks are the smallest. The pod-K tick: 10 blocks of
# 10 240 samples, five chunks each (its grid of 500 blocks fills the card).
SCRATCH = {
    (384, 128, 4): 2 * 3 + 4 * 3 * 2,
    (4480, 4480, 2): 2 * 18 + 2 * 18 * 2,
    (102400, 10240, 50): 2 * 50 + 50 * 50 * 2,
    (1000, 384, 3): -1,
}


@pytest.mark.parametrize("shape", list(SCRATCH), ids=str)
def test_scratch_floats_of_the_chunk_layout(emu, shape):
    assert mt.chunk_scratch_floats(*shape) == SCRATCH[shape]


def test_scratch_too_small_is_refused(emu, monkeypatch):
    p = _inputs(2)
    real = mt.chunk_scratch_floats
    monkeypatch.setattr(mt, "chunk_scratch_floats", lambda K, k_blk, T: real(K, k_blk, T) - 1)
    with pytest.raises(RuntimeError, match="error"):
        _tick(p, K=384, k_blk=128, T=2, inv_temperature=1.0)
