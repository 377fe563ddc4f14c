"""The diff-drive kernels' own source, run on the CPU.

``csrc/mppi_kernels.cu`` is compiled with g++ against ``tests/cuda_emu.h``
by ``tests/cuda_emu.py`` (every thread a fiber on the calling thread, a
warp's lanes meeting at each shuffle, a block's threads at each
``__syncthreads``; ``-ffp-contract=off`` as nvcc's ``-fmad=false``; sin and
cos PyTorch's, as in the plain version) once for each lane group G ∈
{1, 2, 4, 8} (``-DDMM_DIFFDRIVE_GROUP=G``, the builds ``chip_smoke.py``
times side by side; the shipped build's rule picks among them), once as it
ships and once with a fill target of 4 blocks (the chunk layouts of several
samples a thread and several steps a block). The real wrappers' launchers
(``rollout.launch_rollout``, ``mppi_tick.launch_tick``,
``mppi_tick_blocked.launch_fleet``) drive it through ctypes on CPU tensors
with their real argument blocks: the split rollout, the fused tick (ε
injected, hash ε with and without ``emit_eps``, the epilogue), the K-blocked
tick and its ``s_only``, and the fleet. So the lane groups' window search
(the partial running minima and their shuffle merge), the hash ε drawn a
step a lane, the chunked reductions and the epilogue fused with the chunk
sum are checked here, where there is no card.

In every case each G build's S equals the G = 1 build's bit for bit (NaN
where it is NaN): ISO on and off, LAST, circle and soft drifting obstacles,
a NaN window row past row 0 and at row 0, rows that tie exactly within one
lane (8 rows apart) and across lanes (3 apart), W = 13 (not a multiple of
G), W = 5 and 1 (fewer rows than lanes), and K = 44 (not a multiple of a
block's samples). Against ``rollout_body_plain`` S is bit-equal where the
source before the lane groups already was on the emulator (``BIT_EQUAL``:
every case but the soft obstacles, whose ``expf`` is the C library's and
not PyTorch's) and within ``TOL["S"]`` elsewhere. w, Σ w·ε, ρ, η, u_new and
u_shift stay within ``chip_smoke.TOL`` of the plain versions; the fused
tick's two hash-ε routes (ε stored, ε drawn again) are bit-equal, and a
second call repeats the first. The goal-seeking row's combination (W = 1,
three soft drifting obstacles, the action cost, the SavGol(50, 3)
epilogue, K = 640 in chunks of 214, 214 and 212) runs through every G
build, ε injected and drawn.

The fused tick's ``rollout_carry`` (waypoint_carry="rollout") runs through
every G build with ε injected and drawn, ISO on and off, on a 40-row carry
window searched 8 rows a step, one whose last rows repeat the path's end
(the clamped gather), rows that tie exactly, a NaN row inside the span, and
samples whose state goes NaN (ε NaN: the carry then keeps its start): S and
the furthest carried row bit-equal to the plain version, and to the G = 1
build's. Skips without g++.
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
from dnn_mppi_mpc_tpu_torch import _build
from dnn_mppi_mpc_tpu_torch.ops.cuda import mppi_tick as mt
from dnn_mppi_mpc_tpu_torch.ops.cuda import mppi_tick_blocked as mtb
from dnn_mppi_mpc_tpu_torch.ops.cuda import rollout as ro
from dnn_mppi_mpc_tpu_torch.ops.cuda.common import softmax_plain, weighted_noise_plain
from dnn_mppi_mpc_tpu_torch.ops.cuda.mathx import hash_noise
from dnn_mppi_mpc_tpu_torch.ops.filters import filter_matrix

T, DT, SEED = 6, 0.1, 0x2468ACE1
SIGMA = np.array([[0.1, 0.02], [0.02, 0.05]])
GROUPS = (1, 2, 4, 8)
BUILDS = {
    **{f"G{g}": (f"DMM_DIFFDRIVE_GROUP={g}",) for g in GROUPS},
    "shipped": (),
    # a fill target of 4 blocks: at these small K the chunk layout takes
    # several samples a thread and several steps a block, as at pod K
    "fill4": ("DMM_FILL_BLOCKS=4",),
}
# near the path's start, in front of the rollouts: some hit, not all
OBSTACLES = [[0.35, -0.18, 0.08], [0.5, -0.2, 0.1]]
VELOCITIES = [[0.5, -0.2], [-0.3, 0.4]]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Each build of csrc/mppi_kernels.cu for the CPU, by name."""
    torch.set_num_threads(1)
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    work = {name: tmp_path_factory.mktemp(f"diffdrive_emu_{name}") for name in BUILDS}
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        futures = {name: pool.submit(cuda_emu.build, ["mppi_kernels.cu"], work[name], defines)
                   for name, defines in BUILDS.items()}
        built = {name: f.result() for name, f in futures.items()}
    for lib in built.values():
        cuda_emu.torch_math(lib)
        for entry in ("dmm_rollout_costs", "dmm_mppi_tick", "dmm_fleet_mppi_tick"):
            getattr(lib, entry).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dmm_chunk_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.dmm_chunk_scratch_floats.restype = ctypes.c_longlong
        lib.dmm_rollout_group.argtypes = [ctypes.c_longlong]
        lib.dmm_rollout_group.restype = ctypes.c_int
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
    for mod in (ro, mt, mtb):
        mp.setattr(mod, "launch", launch)
    mp.setattr(mt, "load_kernels", lambda: lib)
    try:
        yield
    finally:
        mp.undo()


def f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _window(W=20, *, nan_row=None, twin=None, shift=0.0):
    """Rows [0, W) of a 40-point line from (0, 0) to (4, −2); ``nan_row``:
    that row all NaN; ``twin``: rows [twin, W) take the (x, y) of rows
    [0, W − twin) with another yaw, so the nearest row ties exactly."""
    n = 40
    path = np.stack([np.linspace(0, 4, n), np.linspace(0, -2, n) + shift,
                     np.full(n, -0.46)], 1)[:W].copy()
    if nan_row is not None:
        path[nan_row] = np.nan
    if twin is not None:
        path[twin:, :2] = path[:W - twin, :2]
        path[twin:, 2] = path[:W - twin, 2] + 1.0
    return f32(path)


def _inputs(K, *, seed=0, steps=T, **window):
    rng = np.random.default_rng(seed)
    u = rng.normal(0.0, 0.3, (steps, 2))
    u[:, 0] += 1.0
    return dict(
        eps=f32(rng.multivariate_normal(np.zeros(2), SIGMA, (K, steps))),
        u=f32(u), a=f32(0.5 * u @ np.linalg.inv(SIGMA)), chol_sigma=f32(np.linalg.cholesky(SIGMA)),
        x0=f32([0.1, -0.1, -0.3]), window=_window(**window), stage_w=f32([5.0, 5.0, 1.0]),
        term_w=f32([6.0, 6.0, 1.0]), u_min=f32([-2.0, -1.5]), u_max=f32([2.0, 1.5]),
    )


# name -> the window's shape; each runs through the split rollout (ISO off,
# circle obstacles where named) and the fused tick with ε injected (ISO on)
WINDOWS = {
    "W20": dict(),
    "W20 circle": dict(obstacles=True),
    "NaN row 7": dict(nan_row=7),
    "NaN row 0": dict(nan_row=0),
    "twins 8 apart": dict(W=16, twin=8),
    "twins 3 apart": dict(W=16, twin=3),
    "W13 circle": dict(W=13, obstacles=True),
    "W5": dict(W=5),
    "W1": dict(W=1),
}
# the cases where the source before the lane groups gave S bit-equal to the
# plain version on the emulator (the soft obstacles' expf is the C
# library's, not PyTorch's: within TOL["S"])
BIT_EQUAL = {"split " + c for c in WINDOWS} | {"fused " + c for c in WINDOWS} | {
    "fused injected LAST", "fused injected circle", "fused hash W20",
    "fused hash twins 3 apart", "fused hash W5"}
K_SPLIT = 44  # not a multiple of a block's samples at any G (64 / G)


def _check_S(case, got, want, g1):
    """S of a build: equal to the G = 1 build's bit for bit; to the plain
    version bit for bit in BIT_EQUAL, else within TOL["S"]."""
    torch.testing.assert_close(got, g1, rtol=0.0, atol=0.0, equal_nan=True)
    if case in BIT_EQUAL:
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0, equal_nan=True)
    else:
        _close("S", got, want)


def _close(name, got, want):
    atol, rtol = TOL[name]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def _split(p, obstacles, last_only=False):
    W = p["window"].shape[0]
    args = [p[k] for k in ("eps", "u", "a", "x0", "window", "stage_w", "term_w", "u_min",
                           "u_max")]
    obs = f32(OBSTACLES) if obstacles else None
    return ro.launch_rollout(*args, DT, 0.8 * K_SPLIT, obs, 0.05, 1.5, 0.0, T=T, W=W,
                             last_only=last_only)


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("case", list(WINDOWS))
def test_split_rollout(libs, build, case):
    kw = dict(WINDOWS[case])
    obstacles = kw.pop("obstacles", False)
    p = _inputs(K_SPLIT, **kw)
    with running_on(libs["G1"]):
        g1 = _split(p, obstacles)
    with running_on(libs[build]):
        got = _split(p, obstacles)
    want = ro.diffdrive_rollout_costs_plain(
        *(p[k] for k in ("eps", "u", "a", "x0", "window", "stage_w", "term_w", "u_min", "u_max")),
        DT, 0.8 * K_SPLIT, f32(OBSTACLES) if obstacles else None, 0.05, 1.5, T=T,
        W=p["window"].shape[0])
    if case == "NaN row 0":
        assert torch.isnan(want).all()
    else:
        assert torch.isfinite(want).all()
    if obstacles:
        assert 0 < int((want > 1e6).sum()) < K_SPLIT  # some rollouts hit, not all
    _check_S("split " + case, got, want, g1)


def _tick(p, *, K, inject, emit=False, iso=True, obstacles=None, **kw):
    """The fused tick with the epilogue through ``launch_tick``; the plain
    version on the ε the kernel used (drawn: ``hash_noise``)."""
    T_ = p["u"].shape[0]
    kw = dict(dict(last_only=False, collision="circle", obstacle_velocities=None), **kw)
    ft = f32(np.triu(np.ones((T_, T_))) / np.arange(1, T_ + 1)[None, :])  # a causal average
    W = p["window"].shape[0]
    common = dict(
        seed=torch.tensor([SEED]), u=p["u"], a=p["a"], chol_sigma=p["chol_sigma"], x0=p["x0"],
        window=p["window"], stage_w=p["stage_w"], term_w=p["term_w"], u_min=p["u_min"],
        u_max=p["u_max"], dt=DT, n_exploit=0.8 * K, inv_temperature=1.0 / 0.8,
        obstacles=obstacles, robot_radius=0.05, safety_margin_rate=1.5,
        soft_safety_distance=0.3, soft_weight=10.0, control_weight=kw.pop("control_weight", None),
        K=K, T=T_, W=W, iso_xy=iso, **kw)
    out = mt.launch_tick(**common, filter_t=ft, eps=p["eps"] if inject else None,
                         eps_mode=0 if inject else (1 if emit else 2), k_blk=K)
    eps = p["eps"] if inject else hash_noise(torch.tensor([SEED]), p["chol_sigma"], K, T_, K)
    return out, eps, common, ft


def _tick_plain(common, eps, ft):
    args = dict(common)
    for k in ("seed",):
        args.pop(k)
    return mt.diffdrive_mppi_tick_plain(
        None, eps=eps.contiguous(), filter_t=ft, fuse_epilogue=True, **args)


def _check_tick(case, out, plain, g1_S):
    S, w, w_eps, (u_new, u_shift, finite) = plain
    _check_S(case, out["S"], S, g1_S)
    _close("w", out["w"], w)
    _close("w_eps", out["w_eps"], w_eps)
    rho, eta, _ = softmax_plain(S, 1.0 / 0.8)
    _close("rho", out["stats"][0], rho)
    _close("eta", out["stats"][1], eta)
    _close("u_new", out["u_new"], u_new)
    _close("u_shift", out["u_shift"], u_shift)
    assert float(out["finite"]) == float(finite) == 1.0


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("case", [c for c in WINDOWS if c != "NaN row 0"])
def test_fused_tick_injected_iso(libs, build, case):
    kw = dict(WINDOWS[case])
    obstacles = f32(OBSTACLES) if kw.pop("obstacles", False) else None
    p = _inputs(K_SPLIT, **kw)
    with running_on(libs["G1"]):
        g1, *_ = _tick(p, K=K_SPLIT, inject=True, obstacles=obstacles)
    with running_on(libs[build]):
        out, eps, common, ft = _tick(p, K=K_SPLIT, inject=True, obstacles=obstacles)
    _check_tick("fused " + case, out, _tick_plain(common, eps, ft), g1["S"])


# the fused tick's other modes, ε injected: LAST, circle (ISO off, with a
# diagonal action cost), soft obstacles drifting (ISO off)
TICK_CASES = {
    "LAST": dict(last_only=True),
    "circle": dict(iso=False, obstacles="circle", control_weight=f32([0.3, 0.1])),
    "soft drift": dict(iso=False, obstacles="soft"),
}


def _tick_kw(case):
    kw = dict(TICK_CASES[case])
    obs = kw.pop("obstacles", None)
    if obs is not None:
        kw["obstacles"] = f32(OBSTACLES)
        kw["collision"] = obs
        if obs == "soft":
            kw["obstacle_velocities"] = f32(VELOCITIES)
    return kw


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("case", list(TICK_CASES))
def test_fused_tick_injected(libs, build, case):
    p = _inputs(K_SPLIT, seed=1)
    with running_on(libs["G1"]):
        g1, *_ = _tick(p, K=K_SPLIT, inject=True, **_tick_kw(case))
    with running_on(libs[build]):
        out, eps, common, ft = _tick(p, K=K_SPLIT, inject=True, **_tick_kw(case))
    if case != "LAST":
        assert 0 < int((out["S"] > 10.0 if case == "soft drift" else out["S"] > 1e6).sum()) < K_SPLIT
    _check_tick("fused injected " + case, out, _tick_plain(common, eps, ft), g1["S"])


# the suite's goal_seeking row in small: one goal row (W = 1, fewer rows than
# every lane group past G = 1), three soft obstacles drifting, the action
# cost, λ temperature with exploration 0 (n_exploit = K, γ = 0), and the
# SavGol(50, 3) filter as the epilogue's Fᵀ at T = 50; K = 640 takes the
# chunk layout of one sample a thread in chunks of 214, 214 and 212: the
# last chunk partial
GOAL_K, GOAL_T = 640, 50
GOAL_OBSTACLES = [[5.0, 4.0, 0.5], [3.5, 3.5, 0.5], [2.0, 5.0, 0.5]]
GOAL_VELOCITIES = [[0.018, 0.009], [-0.009, 0.009], [0.009, -0.018]]


def _goal_tick(inject, emit=False, seed=11):
    """One goal-seeking fused tick through ``launch_tick`` (ε injected, or
    hash ε stored or drawn again), and the plain version on the ε used."""
    rng = np.random.default_rng(seed)
    sigma = np.diag([0.5, 0.3])
    u = rng.normal(0.0, 0.5, (GOAL_T, 2))
    u[:, 0] += 0.8
    ft = f32(np.ascontiguousarray(filter_matrix("savgol", GOAL_T, 50, 3).T))
    common = dict(
        seed=torch.tensor([SEED]), u=f32(u), a=torch.zeros(GOAL_T, 2),
        chol_sigma=f32(np.linalg.cholesky(sigma)), x0=f32([2.5, 2.0, 0.8]),
        window=f32([[6.0, 6.0, 1.57]]), stage_w=f32([30.0, 5.0, 9.0]),
        term_w=f32([30.0, 5.0, 9.0]), u_min=f32([-2.0, -2.0]), u_max=f32([2.0, 2.0]), dt=0.05,
        n_exploit=float(GOAL_K), inv_temperature=1e-3,
        obstacles=f32(GOAL_OBSTACLES), obstacle_velocities=f32(GOAL_VELOCITIES),
        robot_radius=0.5, safety_margin_rate=1.5, soft_safety_distance=2.0, soft_weight=100.0,
        control_weight=f32([0.1, 0.1]), K=GOAL_K, T=GOAL_T, W=1, last_only=False,
        collision="soft", iso_xy=False)
    eps = f32(rng.multivariate_normal(np.zeros(2), sigma, (GOAL_K, GOAL_T)))
    out = mt.launch_tick(**common, filter_t=ft, eps=eps if inject else None,
                         eps_mode=0 if inject else (1 if emit else 2), k_blk=GOAL_K)
    if not inject:
        eps = hash_noise(torch.tensor([SEED]), common["chol_sigma"], GOAL_K, GOAL_T, GOAL_K)
    return out, eps, common, ft


@pytest.fixture(scope="module")
def goal_g1(libs):
    """The G = 1 build's goal-seeking tick, ε injected and drawn."""
    with running_on(libs["G1"]):
        return {noise: _goal_tick(noise == "injected")[0] for noise in ("injected", "hash")}


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("noise", ["injected", "hash"])
def test_goal_seeking_tick(libs, goal_g1, build, noise):
    """The goal-seeking combination (at a temperature of 1/1 000, where the
    weights spread over the samples): every output of every G build
    bit-equal to the G = 1 build's and within TOL of the plain version (S
    within TOL["S"]: the soft cost's expf is the C library's). Hash ε: the
    stored and the drawn-again routes give the same bits."""
    monkey = pytest.MonkeyPatch()
    monkey.setattr(mt, "load_kernels", lambda: libs[build])
    try:
        layout = mt.chunk_scratch_floats(GOAL_K, GOAL_K, GOAL_T)
    finally:
        monkey.undo()
    assert layout == 2 * 3 + GOAL_T * 3 * 2  # three chunks of 640: 214, 214, 212
    inject = noise == "injected"
    with running_on(libs[build]):
        out, eps, common, ft = _goal_tick(inject)
        stored = out if inject else _goal_tick(inject, emit=True)[0]
    for name in ("S", "w", "w_eps", "stats", "u_new", "u_shift", "finite"):
        assert torch.equal(out[name], goal_g1[noise][name]), name
        assert torch.equal(stored[name], out[name]), name
    S, w, w_eps, (u_new, u_shift, finite) = _tick_plain(common, eps, ft)
    assert 0 < int((S > S.min() + 100.0).sum()) < GOAL_K  # the soft cost binds some
    assert float(out["finite"]) == float(finite) == 1.0
    _close("S", out["S"], S)
    _close("w", out["w"], w)
    _close("w_eps", out["w_eps"], w_eps)
    _close("u_new", out["u_new"], u_new)
    _close("u_shift", out["u_shift"], u_shift)


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("case", ["W20", "twins 3 apart", "W5"])
def test_fused_tick_hash_routes(libs, build, case):
    """Hash ε at K = 128: stored (emit_eps) and drawn again give the same
    bits in every output; the stored ε is the stream's within a float32
    rounding of the C library's log, sin and cos; a second call repeats the
    first."""
    K = 128
    p = _inputs(K, seed=2, **WINDOWS[case])
    with running_on(libs["G1"]):
        g1, *_ = _tick(p, K=K, inject=False)
    with running_on(libs[build]):
        drawn, eps, common, ft = _tick(p, K=K, inject=False)
        stored, *_ = _tick(p, K=K, inject=False, emit=True)
        again, *_ = _tick(p, K=K, inject=False)
    assert drawn["eps"] is None
    for name in ("S", "w", "w_eps", "stats", "u_new", "u_shift", "finite"):
        assert torch.equal(stored[name], drawn[name]), name
        assert torch.equal(again[name], drawn[name]), name
    kernel_eps = stored["eps"].transpose(0, 1)
    torch.testing.assert_close(kernel_eps, eps, rtol=0.0, atol=TOL["eps"][0])
    _check_tick("fused hash " + case, drawn, _tick_plain(common, kernel_eps, ft), g1["S"])


def test_fused_tick_long_horizon(libs):
    """T = 120: the epilogue reads Fᵀ from device memory (it stages it in
    shared memory only up to T = 104) and its 256 threads own several rows
    each; u_new, u_shift and the flag within TOL of the plain epilogue."""
    p = _inputs(128, seed=8, steps=120)
    with running_on(libs["shipped"]):
        out, eps, common, ft = _tick(p, K=128, inject=True)
    _check_tick("fused long horizon", out, _tick_plain(common, eps, ft), out["S"])


def _blocked(p, *, K, k_blk, s_only, block_offset=1, k_offset=64.0):
    return mt.launch_tick(
        seed=torch.tensor([SEED]), u=p["u"], a=p["a"], chol_sigma=p["chol_sigma"], x0=p["x0"],
        window=p["window"], stage_w=p["stage_w"], term_w=p["term_w"], u_min=p["u_min"],
        u_max=p["u_max"], dt=DT, n_exploit=0.8 * K, inv_temperature=1.0 / 0.8,
        obstacles=f32(OBSTACLES), obstacle_velocities=None, robot_radius=0.05,
        safety_margin_rate=1.5, soft_safety_distance=2.0, soft_weight=100.0,
        control_weight=None, filter_t=None, eps=None, eps_mode=2, k_blk=k_blk, K=K, T=T,
        W=p["window"].shape[0], last_only=False, collision="circle", iso_xy=True,
        k_offset=k_offset, block_offset=block_offset, s_only=s_only)


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("s_only", [False, True], ids=["full", "s_only"])
def test_blocked_tick(libs, build, s_only):
    """The K-blocked tick (two noise-stream blocks from block 1, samples from
    64 on) and its s_only phase: S equal to the G = 1 build's, within TOL of
    the plain version on the stream's ε; ρ, η, Σ w·ε within TOL on the
    kernel's own S; a second call repeats the first."""
    K, k_blk = 256, 128
    p = _inputs(K, seed=3, W=20)
    with running_on(libs["G1"]):
        g1 = _blocked(p, K=K, k_blk=k_blk, s_only=True)
    with running_on(libs[build]):
        out = _blocked(p, K=K, k_blk=k_blk, s_only=s_only)
        again = _blocked(p, K=K, k_blk=k_blk, s_only=s_only)
    eps = hash_noise(torch.tensor([SEED]), p["chol_sigma"], K, T, k_blk, 1)
    want = mtb.diffdrive_mppi_tick_blocked_plain(
        torch.tensor([SEED]), *(p[k] for k in ("u", "a", "chol_sigma", "x0", "window", "stage_w",
                                               "term_w", "u_min", "u_max")),
        DT, 0.8 * K, 1.0 / 0.8, f32(OBSTACLES), 0.05, 1.5, k_offset=64.0, block_offset=1,
        K=K, T=T, W=20, K_BLK=k_blk, s_only=True, iso_xy=True)
    torch.testing.assert_close(out["S"], g1["S"], rtol=0.0, atol=0.0)
    _close("S", out["S"], want)
    assert torch.equal(again["S"], out["S"])
    if not s_only:
        rho, eta, w = softmax_plain(out["S"], 1.0 / 0.8)
        _close("rho", out["stats"][0], rho)
        _close("eta", out["stats"][1], eta)
        _close("w", out["w"], w)
        _close("w_eps", out["w_eps"], weighted_noise_plain(w, eps))
        for name in ("w", "w_eps", "stats"):
            assert torch.equal(again[name], out[name]), name


def _fleet_inputs(B, K, seed=4):
    rng = np.random.default_rng(seed)
    members = [_inputs(K, seed=seed + b, shift=0.1 * b) for b in range(B)]
    stack = {k: torch.stack([m[k] for m in members]) for k in ("u", "a", "x0", "window")}
    return dict(
        seeds=torch.tensor(rng.integers(0, 2**32, B), dtype=torch.int64), u=stack["u"],
        a=stack["a"], chol_sigma=members[0]["chol_sigma"], x0=stack["x0"],
        windows=stack["window"], stage_w=members[0]["stage_w"], term_w=members[0]["term_w"],
        u_min=members[0]["u_min"], u_max=members[0]["u_max"], dt=DT, n_exploit=0.8 * K,
        inv_temperature=1.0 / 0.8,
        obstacles=torch.stack([f32(OBSTACLES) + 0.0 * b for b in range(B)]), robot_radius=0.05,
        safety_margin_rate=1.5, obstacle_velocities=None, soft_safety_distance=2.0,
        soft_weight=100.0,
    )


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS] + ["shipped"])
def test_fleet(libs, build):
    """B = 3 members of K = 128 (ISO off, circle obstacles): S equal to the
    G = 1 build's and within TOL["S"] of the plain version on the stream's ε
    (drawn again by the plain version from each member's seed, where the C
    library's and PyTorch's log, sin and cos differ); w and Σ w·ε within
    TOL; a second call repeats the first. The shipped build runs G = 2
    here, by its rule."""
    B, K = 3, 128
    args = _fleet_inputs(B, K)
    kw = dict(B=B, K=K, T=T, W=20, last_only=False, collision="circle", iso_xy=False)
    with running_on(libs["G1"]):
        g1 = mtb.launch_fleet(*args.values(), **kw)
    with running_on(libs[build]):
        S, w, w_eps = mtb.launch_fleet(*args.values(), **kw)
        again = mtb.launch_fleet(*args.values(), **kw)
    pS, pw, pweps = mtb.fleet_mppi_tick_plain(*args.values(), **kw)
    assert 0 < int((pS > 1e6).sum()) < B * K
    torch.testing.assert_close(S, g1[0], rtol=0.0, atol=0.0)
    _close("S", S, pS)
    _close("w", w, pw)
    _close("w_eps", w_eps, pweps)
    for got, first in zip(again, (S, w, w_eps)):
        assert torch.equal(got, first)


@pytest.mark.parametrize("shape", ["blocked K1024 k_blk512", "fused K384"])
def test_chunk_layouts_of_several_samples_and_steps(libs, shape, monkeypatch):
    """The fill4 build's chunks: the K-blocked tick's 512 samples (two a
    thread) in two noise blocks, five steps a block over T = 6 (two step
    groups); the fused tick's 384 (one or two a thread) in one chunk, one
    step a block, hash ε drawn again, with the epilogue. S equal to the G = 1
    build's; ρ, η, w, Σ w·ε (and u_new, u_shift) within TOL of the plain
    versions; a second call repeats the first."""
    lib = libs["fill4"]
    monkeypatch.setattr(mt, "load_kernels", lambda: lib)
    layout = {"blocked K1024 k_blk512": (1024, 512, 6), "fused K384": (384, 384, 6)}
    K, k_blk, T_ = layout[shape]
    assert mt.chunk_scratch_floats(K, k_blk, T_) == 2 * (K // k_blk) + T_ * (K // k_blk) * 2
    if shape.startswith("blocked"):
        p = _inputs(K, seed=7, W=20)
        with running_on(libs["G1"]):
            g1 = _blocked(p, K=K, k_blk=k_blk, s_only=True)
        with running_on(lib):
            out = _blocked(p, K=K, k_blk=k_blk, s_only=False)
            again = _blocked(p, K=K, k_blk=k_blk, s_only=False)
        eps = hash_noise(torch.tensor([SEED]), p["chol_sigma"], K, T, k_blk, 1)
        torch.testing.assert_close(out["S"], g1["S"], rtol=0.0, atol=0.0)
        rho, eta, w = softmax_plain(out["S"], 1.0 / 0.8)
        _close("rho", out["stats"][0], rho)
        _close("eta", out["stats"][1], eta)
        _close("w", out["w"], w)
        _close("w_eps", out["w_eps"], weighted_noise_plain(w, eps))
        names = ("S", "w", "w_eps", "stats")
    else:
        p = _inputs(K, seed=9, W=20)
        with running_on(libs["G1"]):
            g1, *_ = _tick(p, K=K, inject=False)
        with running_on(lib):
            out, eps, common, ft = _tick(p, K=K, inject=False)
            again, *_ = _tick(p, K=K, inject=False)
        _check_tick("fused fill4", out, _tick_plain(common, eps, ft), g1["S"])
        names = ("S", "w", "w_eps", "stats", "u_new", "u_shift", "finite")
    for name in names:
        assert torch.equal(again[name], out[name]), name


# the carry (rollout_carry): a carry window and the per-step search span.
# Rows [start, start + 40) of a 60-point line, the last rows repeated past
# the path's end, ties, a NaN row; "NaN state": ε NaN for samples 5 and 30
CARRY_CASES = {
    "span 8": dict(start=0, span=8),
    "span 3": dict(start=0, span=3),
    "path end": dict(start=45, span=8, x0=[2.4, -1.15, -0.46]),
    "twins": dict(start=0, span=8, twin=4),
    "NaN row 5": dict(start=0, span=8, nan_row=5),
    "NaN state": dict(start=0, span=8, nan_eps=(5, 30)),
}


def _carry_window(start, twin=None, nan_row=None, rows=40, n=60):
    path = np.stack([np.linspace(0, 3, n), np.linspace(0, -1.5, n), np.full(n, -0.46)], 1)
    if twin is not None:  # rows twin apart share their (x, y): exact ties
        path[twin::twin * 2, :2] = path[0:-twin:twin * 2, :2][:len(path[twin::twin * 2])]
    window = path[np.minimum(start + np.arange(rows), n - 1)].copy()
    if nan_row is not None:
        window[nan_row] = np.nan
    return f32(window)


def _carry_tick(p, *, K, inject, iso, span, emit=False):
    """The fused tick with the carry and the epilogue through
    ``launch_tick``; the plain version on the ε the kernel used."""
    ft = f32(np.triu(np.ones((T, T))) / np.arange(1, T + 1)[None, :])
    common = dict(
        seed=torch.tensor([SEED]), u=p["u"], a=p["a"], chol_sigma=p["chol_sigma"], x0=p["x0"],
        window=p["window"], stage_w=p["stage_w"], term_w=p["term_w"], u_min=p["u_min"],
        u_max=p["u_max"], dt=DT, n_exploit=0.8 * K, inv_temperature=1.0 / 0.8,
        obstacles=None, obstacle_velocities=None, robot_radius=0.05, safety_margin_rate=1.5,
        soft_safety_distance=0.3, soft_weight=10.0, control_weight=None, K=K, T=T,
        W=p["window"].shape[0], last_only=False, collision="circle", iso_xy=iso)
    out = mt.launch_tick(**common, filter_t=ft, eps=p["eps"] if inject else None,
                         eps_mode=0 if inject else (1 if emit else 2), k_blk=K, carry_W=span)
    eps = p["eps"] if inject else hash_noise(torch.tensor([SEED]), p["chol_sigma"], K, T, K)
    args = dict(common)
    args.pop("seed")
    plain = mt.diffdrive_mppi_tick_plain(None, eps=eps.contiguous(), filter_t=ft,
                                         fuse_epilogue=True, rollout_carry=True, carry_W=span,
                                         **args)
    return out, plain


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("iso", [True, False], ids=["iso", "xy"])
@pytest.mark.parametrize("case", list(CARRY_CASES))
def test_fused_tick_carry_injected(libs, build, iso, case):
    """The carry with ε injected: S and the furthest carried row bit-equal to
    the plain version (NaN where it is NaN) and to the G = 1 build's; the
    carry moves past row 0; w, Σ w·ε and the epilogue within TOL where S is
    finite."""
    kw = dict(CARRY_CASES[case])
    span, nan_eps, x0 = kw.pop("span"), kw.pop("nan_eps", ()), kw.pop("x0", None)
    K = K_SPLIT
    p = _inputs(K, seed=5)
    p["window"] = _carry_window(**kw)
    if x0 is not None:
        p["x0"] = f32(x0)
    for k in nan_eps:
        p["eps"][k, 2:] = float("nan")
    with running_on(libs["G1"]):
        g1, _ = _carry_tick(p, K=K, inject=True, iso=iso, span=span)
    with running_on(libs[build]):
        out, plain = _carry_tick(p, K=K, inject=True, iso=iso, span=span)
    S, w, w_eps, (u_new, u_shift, finite), carried = plain
    torch.testing.assert_close(out["S"], g1["S"], rtol=0.0, atol=0.0, equal_nan=True)
    torch.testing.assert_close(out["S"], S, rtol=0.0, atol=0.0, equal_nan=True)
    assert int(out["wp_adv"][0]) == int(carried) == int(g1["wp_adv"][0])
    assert int(carried) > 0
    if nan_eps:
        assert torch.isnan(S[list(nan_eps)]).all() and torch.isfinite(S[:5]).all()
        return
    assert torch.isfinite(S).all()
    _close("w", out["w"], w)
    _close("w_eps", out["w_eps"], w_eps)
    _close("u_new", out["u_new"], u_new)
    _close("u_shift", out["u_shift"], u_shift)


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("case", ["span 8", "path end"])
def test_fused_tick_carry_hash(libs, build, case):
    """The carry with hash ε at K = 128, ISO on: the stored and the
    drawn-again routes give the same bits; S and the furthest carried row
    equal the plain version's on the kernel's stored ε, and the G = 1
    build's; a second call repeats the first."""
    kw = dict(CARRY_CASES[case])
    span, x0 = kw.pop("span"), kw.pop("x0", None)
    K = 128
    p = _inputs(K, seed=6)
    p["window"] = _carry_window(**kw)
    if x0 is not None:
        p["x0"] = f32(x0)
    with running_on(libs["G1"]):
        g1, _ = _carry_tick(p, K=K, inject=False, iso=True, span=span)
    with running_on(libs[build]):
        drawn, _ = _carry_tick(p, K=K, inject=False, iso=True, span=span)
        stored, _ = _carry_tick(p, K=K, inject=False, iso=True, span=span, emit=True)
        again, _ = _carry_tick(p, K=K, inject=False, iso=True, span=span)
    for name in ("S", "w", "w_eps", "stats", "u_new", "u_shift", "finite", "wp_adv"):
        assert torch.equal(stored[name], drawn[name]), name
        assert torch.equal(again[name], drawn[name]), name
        assert torch.equal(g1[name], drawn[name]), name
    p["eps"] = stored["eps"].transpose(0, 1).contiguous()
    with running_on(libs[build]):
        _, (S, *_, carried) = _carry_tick(p, K=K, inject=True, iso=True, span=span)
    torch.testing.assert_close(drawn["S"], S, rtol=0.0, atol=0.0)
    assert int(drawn["wp_adv"][0]) == int(carried) > 0


# the rule of the shipped build: lanes a sample by the launch's sample count
RULE = {10240: 2, 16384: 2, 16385: 1, 32768: 1, 102400: 1}


@pytest.mark.parametrize("samples", list(RULE))
def test_rollout_group_rule(libs, samples, monkeypatch):
    monkeypatch.setattr(mt, "load_kernels", lambda: libs["shipped"])
    assert mt.rollout_group(samples) == RULE[samples]


def test_forced_builds_run_their_group(libs):
    for g in GROUPS:
        assert libs[f"G{g}"].dmm_rollout_group(10240) == g
        assert libs[f"G{g}"].dmm_rollout_group(102400) == g


def test_argument_block_sizes(libs):
    lib = libs["shipped"]
    lib.dmm_args_size.restype = ctypes.c_int
    lib.dmm_fleet_args_size.restype = ctypes.c_int
    assert lib.dmm_args_size() == ctypes.sizeof(_build.DmmArgs)
    assert lib.dmm_fleet_args_size() == ctypes.sizeof(_build.DmmFleetArgs)


# fields of a valid argument block that a C entry must refuse. The split
# rollout: no sample, no step, an empty window, a negative obstacle count, a
# window too long to stage in shared memory, hash ε. The fused tick: an
# unknown ε mode, s_only outside the K-blocked tick, K no multiple of k_blk,
# a horizon past the epilogue's 1 024 rows, scratch one float short. The
# fleet: no member, ε not drawn, an epilogue.
REFUSED = {
    "split K": ("dmm_rollout_costs", {"K": 0}),
    "split T": ("dmm_rollout_costs", {"T": 0}),
    "split W": ("dmm_rollout_costs", {"W": 0}),
    "split n_obs": ("dmm_rollout_costs", {"n_obs": -1}),
    "split W staged": ("dmm_rollout_costs", {"W": 5000}),
    "split eps_mode": ("dmm_rollout_costs", {"eps_mode": 1}),
    "tick eps_mode": ("dmm_mppi_tick", {"eps_mode": 3}),
    "tick s_only": ("dmm_mppi_tick", {"s_only": 1}),
    "tick k_blk": ("dmm_mppi_tick", {"k_blk": 100}),
    "tick T": ("dmm_mppi_tick", {"T": 1025}),
    "tick scratch": ("dmm_mppi_tick", {"scratch_floats": -1}),
    "tick carry span": ("dmm_mppi_tick", {"carry_span": 6}),  # past the W = 5 rows
    "tick carry no output": ("dmm_mppi_tick", {"carry_span": 3, "wp_adv": None}),
    "tick carry blocked": ("dmm_mppi_tick", {"carry_span": 3, "block_offset": 1}),
    "split carry": ("dmm_rollout_costs", {"carry_span": 3}),
    "fleet carry": ("dmm_fleet_mppi_tick", {"carry_span": 3}),
    "fleet B": ("dmm_fleet_mppi_tick", {"B": 0}),
    "fleet eps_mode": ("dmm_fleet_mppi_tick", {"eps_mode": 1}),
    "fleet epilogue": ("dmm_fleet_mppi_tick", {"fuse_epilogue": 1}),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_launch_refuses(libs, case, monkeypatch):
    entry, fields = REFUSED[case]
    lib = libs["shipped"]
    captured = {}
    for mod in (ro, mt, mtb):
        monkeypatch.setattr(mod, "launch", lambda e, args, device: captured.update(args=args))
    monkeypatch.setattr(mt, "load_kernels", lambda: lib)
    p = _inputs(128, W=5)
    if entry == "dmm_rollout_costs":
        _split(p, False)
    elif entry == "dmm_mppi_tick":
        _tick(p, K=128, inject=False, emit=True)
    else:
        mtb.launch_fleet(*_fleet_inputs(2, 128).values(), B=2, K=128, T=T, W=20,
                         last_only=False, collision="circle", iso_xy=False)
    args = captured["args"]
    block = args.m if entry == "dmm_fleet_mppi_tick" else args
    for name, value in fields.items():
        if name == "scratch_floats":
            value = block.scratch_floats - 1
        setattr(args if name == "B" else block, name, value)
    assert getattr(lib, entry)(ctypes.addressof(args), None) != 0
