"""The sharded tick's weighted noise reduce, its own source run on the CPU.

``csrc/mppi_kernels.cu`` (with ``csrc/mppi_reductions.cuh``) is compiled
with g++ against ``tests/cuda_emu.h`` by ``tests/cuda_emu.py``, as it ships
and with a fill target of 4 blocks (``-DDMM_FILL_BLOCKS=4``: at these small
K the chunk layout then takes several samples a thread and several steps a
block, as at pod K). ``mppi_tick_blocked.launch_weighted_noise_reduce``
drives ``dmm_weighted_noise_reduce`` through ctypes on CPU tensors with its
real argument block and the scratch the library sizes: Σ w·ε from the given
weights on the (C, ⌈T/steps⌉) grid with ε drawn again, then the chunks'
partials summed in chunk order. Layouts: one chunk a noise-stream block,
three chunks in one block with the last one shorter, a block offset, and
the fill-4 build's chunks of two and three samples a thread over two step
groups.

Each layout: Σ w·ε within ``chip_smoke.TOL`` of
``weighted_noise_reduce_plain``, a second call bit-equal to the first, and
``w`` unchanged; handed the emulated K-blocked tick's own ``w`` (the same
seed, block offset and k_blk), the tick's ``w_eps`` bit for bit. Bad
arguments (K not a multiple of k_blk, k_blk or T out of range, scratch one
float short) are refused before any launch: the output and the scratch keep
what they held. Skips without g++.
"""

from __future__ import annotations

import contextlib
import ctypes
import shutil
from concurrent.futures import ThreadPoolExecutor

import cuda_emu
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from dnn_mppi_mpc_tpu_torch._build import DmmArgs
from dnn_mppi_mpc_tpu_torch.ops.cuda import mppi_tick as mt
from dnn_mppi_mpc_tpu_torch.ops.cuda import mppi_tick_blocked as mtb

W, DT, SEED = 8, 0.1, 0x13579BDF
SIGMA = np.array([[0.1, 0.02], [0.02, 0.05]])
BUILDS = {"shipped": (), "fill4": ("DMM_FILL_BLOCKS=4",)}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Each build of csrc/mppi_kernels.cu for the CPU, by name."""
    torch.set_num_threads(1)
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    work = {name: tmp_path_factory.mktemp(f"weighted_emu_{name}") for name in BUILDS}
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        futures = {name: pool.submit(cuda_emu.build, ["mppi_kernels.cu"], work[name], defines)
                   for name, defines in BUILDS.items()}
        built = {name: f.result() for name, f in futures.items()}
    for lib in built.values():
        cuda_emu.torch_math(lib)
        for entry in ("dmm_mppi_tick", "dmm_weighted_noise_reduce"):
            getattr(lib, entry).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dmm_chunk_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.dmm_chunk_scratch_floats.restype = ctypes.c_longlong
    return built


@contextlib.contextmanager
def running_on(lib):
    """Within the block the wrappers' launches go to ``lib``."""
    def launch(entry, args, device):
        assert device.type == "cpu"
        err = getattr(lib, entry)(ctypes.addressof(args), None)
        if err != 0:
            raise RuntimeError(f"{entry}: error {err} at launch")

    mp = pytest.MonkeyPatch()
    for mod in (mt, mtb):
        mp.setattr(mod, "launch", launch)
    mp.setattr(mt, "load_kernels", lambda: lib)
    try:
        yield
    finally:
        mp.undo()


def f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _tick_inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(0.0, 0.3, (T, 2))
    u[:, 0] += 1.0
    path = np.stack([np.linspace(0, 4, W), np.linspace(0, -2, W), np.full(W, -0.46)], 1)
    return dict(u=f32(u), a=f32(0.5 * u @ np.linalg.inv(SIGMA)),
                chol_sigma=f32(np.linalg.cholesky(SIGMA)), x0=f32([0.1, -0.1, -0.3]),
                window=f32(path), stage_w=f32([5.0, 5.0, 1.0]), term_w=f32([6.0, 6.0, 1.0]),
                u_min=f32([-2.0, -1.5]), u_max=f32([2.0, 1.5]))


def _blocked_tick(p, *, K, k_blk, T, inv_temperature, block_offset):
    return mt.launch_tick(
        **p, seed=torch.tensor([SEED]), dt=DT, n_exploit=0.9 * K,
        inv_temperature=inv_temperature, obstacles=None, obstacle_velocities=None,
        robot_radius=0.5, safety_margin_rate=1.5, soft_safety_distance=2.0, soft_weight=100.0,
        control_weight=None, filter_t=None, eps=None, eps_mode=2, k_blk=k_blk, K=K, T=T, W=W,
        last_only=False, collision="circle", iso_xy=False, k_offset=0.0,
        block_offset=block_offset)


def _reduce(w, *, K, k_blk, T, block_offset):
    return mtb.launch_weighted_noise_reduce(torch.tensor([SEED]), w,
                                            f32(np.linalg.cholesky(SIGMA)), block_offset,
                                            K=K, T=T, K_BLK=k_blk)


# name -> (build, K, k_blk, T, block offset, chunks C). Shipped: 256-sample
# chunks, one step a block: three blocks of one chunk each; one 640-sample
# block in chunks of 214, 214 and 212; two full chunks at block offset 5;
# eight chunks of 128, whose chunk-order sum another order would round
# otherwise.
# fill4: two blocks of one chunk each, five steps a block over T = 6 (two
# step groups), two samples a thread; then 640-sample chunks, two or three
# samples a thread, over T = 7
CASES = {
    "one chunk a block": ("shipped", 384, 128, 4, 0, 3),
    "ragged chunks in one block": ("shipped", 640, 640, 2, 0, 3),
    "offset block": ("shipped", 512, 256, 3, 5, 2),
    "eight blocks of one chunk": ("shipped", 1024, 128, 2, 3, 8),
    "several steps a block": ("fill4", 1024, 512, 6, 1, 2),
    "several samples a thread ragged": ("fill4", 1280, 640, 7, 2, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_plain_repeats_and_leaves_w(libs, case):
    build, K, k_blk, T, off, C = CASES[case]
    w = f32(np.random.default_rng(K + T).random(K))
    w = w / w.sum()
    before = w.clone()
    with running_on(libs[build]):
        assert mt.chunk_scratch_floats(K, k_blk, T) == 2 * C + T * C * 2
        got = _reduce(w, K=K, k_blk=k_blk, T=T, block_offset=off)
        again = _reduce(w, K=K, k_blk=k_blk, T=T, block_offset=off)
    want = mtb.weighted_noise_reduce_plain(torch.tensor([SEED]), w,
                                           f32(np.linalg.cholesky(SIGMA)), off, K=K, T=T,
                                           K_BLK=k_blk)
    atol, rtol = TOL["w_eps"]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    assert torch.equal(again, got)
    assert torch.equal(w, before)


@pytest.mark.parametrize("inv_t", [1.0e-3, 1.0 / 0.8, 1.0e4],
                         ids=["lambda1e-3", "lambda1.25", "lambda1e4"])
@pytest.mark.parametrize("case", list(CASES))
def test_equals_the_blocked_ticks_sum(libs, case, inv_t):
    """The tick's own w in, the tick's Σ w·ε out, bit for bit: the same
    layout, the same draws, the same in-block and chunk-order sums. At
    λ⁻¹ = 1e-3 the weights are near uniform, so every chunk's partial counts
    in the sum (at 1.25 one chunk holds nearly all the weight)."""
    build, K, k_blk, T, off, _ = CASES[case]
    p = _tick_inputs(T, seed=K)
    with running_on(libs[build]):
        tick = _blocked_tick(p, K=K, k_blk=k_blk, T=T, inv_temperature=inv_t, block_offset=off)
        w = tick["w"]
        before = w.clone()
        got = _reduce(w, K=K, k_blk=k_blk, T=T, block_offset=off)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, tick["w_eps"], rtol=0.0, atol=0.0)
    assert torch.equal(w, before)


# name -> (K, k_blk, T, scratch floats given: None is the library's size
# less one)
REFUSED = {
    "K not a multiple of k_blk": (384, 256, 2, 4096),
    "k_blk zero": (384, 0, 2, 4096),
    "T zero": (384, 128, 0, 4096),
    "T past the grid": (384, 128, 65536, 4096),
    "scratch one float short": (384, 128, 2, None),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_bad_arguments_are_refused_before_any_launch(libs, case):
    lib = libs["shipped"]
    K, k_blk, T, n = REFUSED[case]
    if n is None:
        n = lib.dmm_chunk_scratch_floats(K, k_blk, T) - 1
    w = torch.full((K,), 1.0 / K)
    w_eps = torch.full((max(T, 1), 2), float("nan"))
    scratch = torch.full((4096,), 7.0)
    seed = torch.tensor([SEED])
    chol = f32(np.linalg.cholesky(SIGMA))
    args = DmmArgs(seed=seed.data_ptr(), w=w.data_ptr(), chol=chol.data_ptr(),
                   w_eps=w_eps.data_ptr(), scratch=scratch.data_ptr(), scratch_floats=n,
                   K=K, T=T, k_blk=k_blk, block_offset=0)
    assert lib.dmm_weighted_noise_reduce(ctypes.addressof(args), None) != 0
    assert torch.isnan(w_eps).all()
    assert (scratch == 7.0).all()


def test_wrapper_raises_when_the_scratch_is_short(libs, monkeypatch):
    real = mt.chunk_scratch_floats
    monkeypatch.setattr(mtb, "chunk_scratch_floats", lambda K, k_blk, T: real(K, k_blk, T) - 1)
    with running_on(libs["shipped"]), pytest.raises(RuntimeError, match="error"):
        _reduce(torch.full((384,), 1.0 / 384), K=384, k_blk=128, T=2, block_offset=0)
