"""The generic kernels' own source, run on the CPU.

``csrc/generic_kernels.cu`` is compiled with g++ against ``tests/cuda_emu.h``
by ``tests/cuda_emu.py`` (every thread a fiber on the calling thread, a
warp's lanes meeting at each shuffle, a block's threads at each
``__syncthreads``; ``-ffp-contract=off`` as nvcc's ``-fmad=false``; sin, cos
and tan PyTorch's, as in the plain version) once for each lane group
G ∈ {1, 2, 4, 8} (``-DDMM_GENERIC_GROUP=G``, the builds ``chip_smoke.py``
times side by side; the shipped build's rule picks among them), once as it
ships and once with a fill target of 4 blocks (the chunk layouts of several
samples a thread and several steps a block). The wrapper's launchers
(``generic_tick.launch_generic_rollout``, ``generic_tick.launch_generic_tick``)
drive it through ctypes on CPU tensors with their real argument blocks: the
split rollout and the fused tick (ε injected, hash ε with and without
``emit_eps``, the epilogue) over the four tile-step families. So the lane
groups' window search (the partial running minima and their shuffle merge),
the hash ε drawn a step a lane and handed out by shuffle, the chunked
reductions at nu = 2 and 4 and the epilogue fused with the chunk sum are
checked here, where there is no card.

In every case each G build's S equals the G = 1 build's bit for bit (NaN
where it is NaN): the four families, circle obstacles, soft obstacles that
drift (the dynamic bicycle), SUM and LAST, wrap-yaw, n_track from 2 to 5, a
NaN window row past row 0 and at row 0, rows that tie exactly within one
lane (8 rows apart) and across lanes (3 apart), W = 13 (not a multiple of
G), W = 5 and 1 (fewer rows than lanes), and K = 44 (not a multiple of a
block's samples). Against ``generic_rollout_body_plain`` S is bit-equal
where the source before the lane groups already was on the emulator
(``BIT_EQUAL``: every case but the dynamic bicycle's, whose ``sinf`` is the
C library's and not PyTorch's, as is its soft obstacles' ``expf``: that
source gave S a few ulp off on some of them) and within ``TOL["S"]``
elsewhere. The obstacles are placed from the rollouts' own end points, so
that some rollouts hit and some do not. w, Σ w·ε, ρ, η,
u_new and u_shift stay within ``chip_smoke.TOL`` of the plain versions; the
tick's two hash-ε routes (ε stored, ε drawn again) are bit-equal, and a
second call repeats the first.

The tick's ``rollout_carry`` (waypoint_carry="rollout") runs through every
G build for every family, ε injected and drawn, on a 40-row carry window
searched a few rows a step: wrap-yaw, n_track 2, a window whose last rows
repeat the path's end, rows that tie exactly, a NaN row inside the span,
and samples whose state goes NaN. S and the furthest carried row equal the
G = 1 build's, and the plain version's (bit for bit outside the dynamic
bicycle, whose sinf is the C library's: S within TOL["S"] there). Skips
without g++.
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
from dnn_mppi_mpc_tpu_torch.models import tile as ttile
from dnn_mppi_mpc_tpu_torch.ops.cuda import generic_tick as gt
from dnn_mppi_mpc_tpu_torch.ops.cuda.common import softmax_plain
from dnn_mppi_mpc_tpu_torch.ops.cuda.mathx import hash_noise

T, DT, SEED = 6, 0.1, 0x2468ACE1
GROUPS = (1, 2, 4, 8)
BUILDS = {
    **{f"G{g}": (f"DMM_GENERIC_GROUP={g}",) for g in GROUPS},
    "shipped": (),
    # a fill target of 4 blocks: at these small K the chunk layout takes
    # several samples a thread and several steps a block
    "fill4": ("DMM_FILL_BLOCKS=4",),
}
# family -> (nx, nu, tile step)
FAMILIES = {
    "unicycle": (3, 2, ttile.unicycle_tile(DT)),
    "kinematic_bicycle": (4, 2, ttile.kinematic_bicycle_tile(DT, 2.5)),
    "four_wheel_torque": (5, 4, ttile.four_wheel_torque_tile(DT)),
    "dynamic_bicycle": (4, 2, ttile.dynamic_bicycle_tile(DT)),
}
VELOCITIES = [[0.5, -0.2], [-0.3, 0.4]]
RADIUS = 0.05  # each obstacle's; the robot's 0.05 × 1.5 beside it
K_SPLIT = 44  # not a multiple of a block's samples at any G (64 / G)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Each build of csrc/generic_kernels.cu for the CPU, by name."""
    torch.set_num_threads(1)
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    work = {name: tmp_path_factory.mktemp(f"generic_emu_{name}") for name in BUILDS}
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        futures = {name: pool.submit(cuda_emu.build, ["generic_kernels.cu"], work[name], defines)
                   for name, defines in BUILDS.items()}
        built = {name: f.result() for name, f in futures.items()}
    for lib in built.values():
        cuda_emu.torch_math(lib)
        for entry in ("dmm_generic_rollout_costs", "dmm_generic_tick"):
            getattr(lib, entry).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dmm_generic_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.dmm_generic_scratch_floats.restype = ctypes.c_longlong
        lib.dmm_generic_group.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        lib.dmm_generic_group.restype = ctypes.c_int
        lib.dmm_generic_args_size.restype = ctypes.c_int
    return built


@contextlib.contextmanager
def running_on(lib):
    """Within the block the generic wrappers' launches go to ``lib``."""
    def launch(entry, args, device, kernels=None):
        assert device.type == "cpu"
        err = getattr(lib, entry)(ctypes.addressof(args), None)
        if err != 0:
            raise RuntimeError(f"{entry}: error {err} at launch")

    mp = pytest.MonkeyPatch()
    mp.setattr(gt, "launch", launch)
    mp.setattr(gt, "load_kernels", lambda: lib)
    try:
        yield
    finally:
        mp.undo()


def f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _window(W, n_track, *, nan_row=None, twin=None):
    """Rows [0, W) of a 40-point curve from (0, 0) to (4, 1), its columns past
    (x, y) a heading, a speed and a yaw rate; ``nan_row``: that row all NaN;
    ``twin``: rows [twin, W) take the (x, y) of rows [0, W − twin) with other
    tracked columns, so the nearest row ties exactly."""
    n = 40
    xs = np.linspace(0.0, 4.0, n)
    cols = [xs, 0.5 * np.sin(xs / 2.0), np.full(n, 0.3), np.full(n, 0.9), np.full(n, 0.1)]
    path = np.stack(cols[:n_track], 1)[:W].copy()
    if nan_row is not None:
        path[nan_row] = np.nan
    if twin is not None:
        path[twin:, :2] = path[:W - twin, :2]
        path[twin:, 2:] = path[:W - twin, 2:] + 1.0
    return f32(path)


def _inputs(family, K, *, seed=0, steps=T, W=20, n_track=None, **window):
    """One tick's inputs for ``family``, made from ``seed`` with numpy."""
    nx, nu, _ = FAMILIES[family]
    n_track = nx if n_track is None else n_track
    rng = np.random.default_rng(seed)
    A = rng.normal(0.0, 0.2, (nu, nu))
    sigma = A @ A.T + 0.05 * np.eye(nu)
    u = rng.normal(0.0, 0.3, (steps, nu))
    x0 = [0.05, -0.02, 0.3, 0.9, 0.1][:nx]
    lo, hi = np.full(nu, -2.0), np.full(nu, 2.0)
    if family == "unicycle":
        u[:, 0] += 1.0
    elif family == "kinematic_bicycle":
        lo[0], hi[0] = -0.5, 0.5
    elif family == "four_wheel_torque":
        u += 0.3
    else:
        lo[1], hi[1] = -0.4, 0.4
    return dict(
        eps=f32(rng.multivariate_normal(np.zeros(nu), sigma, (K, steps))), u=f32(u),
        a=f32(0.56 * u @ np.linalg.inv(sigma)), chol_sigma=f32(np.linalg.cholesky(sigma)),
        x0=f32(x0), window=_window(W, n_track, **window),
        stage_w=f32(rng.uniform(1.0, 6.0, n_track)), term_w=f32(rng.uniform(2.0, 9.0, n_track)),
        u_min=f32(lo), u_max=f32(hi),
    )


# name -> (family, the inputs' options, the call's options); every one runs
# through the split rollout and the fused tick with ε injected
CASES = {
    "unicycle W20": ("unicycle", {}, {}),
    "unicycle LAST circle": ("unicycle", {}, dict(last_only=True, obstacles="circle")),
    "kinematic_bicycle wrap circle": ("kinematic_bicycle", {},
                                      dict(wrap_yaw=True, obstacles="circle")),
    "four_wheel_torque circle": ("four_wheel_torque", {}, dict(obstacles="circle")),
    "four_wheel_torque n_track 2": ("four_wheel_torque", dict(n_track=2), {}),
    "dynamic_bicycle wrap soft drift": ("dynamic_bicycle", dict(n_track=3),
                                        dict(wrap_yaw=True, obstacles="soft")),
    "dynamic_bicycle LAST": ("dynamic_bicycle", {}, dict(last_only=True)),
    "four_wheel_torque NaN row 7": ("four_wheel_torque", dict(nan_row=7), {}),
    "unicycle NaN row 0": ("unicycle", dict(nan_row=0), {}),
    "unicycle twins 8 apart": ("unicycle", dict(W=16, twin=8), {}),
    "four_wheel_torque twins 3 apart": ("four_wheel_torque", dict(W=16, twin=3), {}),
    "kinematic_bicycle W13 circle": ("kinematic_bicycle", dict(W=13),
                                     dict(obstacles="circle")),
    "four_wheel_torque W5": ("four_wheel_torque", dict(W=5), {}),
    "unicycle W1": ("unicycle", dict(W=1), {}),
}
# the cases where the source before the lane groups gave S bit-equal to the
# plain version on the emulator (the dynamic bicycle's sinf and its soft
# obstacles' expf are the C library's, not PyTorch's: within TOL["S"])
BIT_EQUAL = {f"{route} {case}" for route in ("split", "fused") for case in CASES
             if not case.startswith("dynamic_bicycle")}
BIT_EQUAL |= {f"fused hash {family}" for family in FAMILIES if family != "dynamic_bicycle"}


def _obstacles(family, p, n_exploit):
    """Two obstacles for the rollouts of ``p``: one whose edge runs through
    the median of the rollouts' end points, so that about half of them hit
    it (circle) or pass within the soft distance, one beside the path."""
    nx, nu, step = FAMILIES[family]
    K = p["eps"].shape[0]
    xs = tuple(p["x0"][i].expand(K) for i in range(nx))
    exploit = torch.arange(K) < n_exploit
    for t in range(p["u"].shape[0]):
        e = p["eps"][:, t]
        xs = step(xs, tuple(torch.clamp(torch.where(exploit, p["u"][t, j] + e[:, j], e[:, j]),
                                        p["u_min"][j], p["u_max"][j]) for j in range(nu)))
    mx, my = float(xs[0].median()), float(xs[1].median())
    rr = RADIUS + 0.05 * 1.5
    return f32([[mx, my + rr, RADIUS], [mx - 0.2, my - 0.3, RADIUS]])


def _call_kw(family, call, p):
    """The launchers' common keyword arguments for ``family`` on inputs ``p``."""
    nx, nu, step = FAMILIES[family]
    K = p["eps"].shape[0]
    call = dict(call)
    obs = call.pop("obstacles", None)
    kw = dict(dt=DT, n_exploit=0.8 * K, obstacles=None, robot_radius=0.05,
              safety_margin_rate=1.5, obstacle_velocities=None, soft_safety_distance=0.3,
              soft_weight=10.0, k_offset=0.0, step_tile=step, nx=nx, nu=nu, T=T,
              wrap_yaw=False, last_only=False, collision="circle",
              n_track=p["window"].shape[1], W=p["window"].shape[0])
    if obs is not None:
        kw.update(obstacles=_obstacles(family, p, kw["n_exploit"]), collision=obs)
        if obs == "soft":
            kw["obstacle_velocities"] = f32(VELOCITIES)
    kw.update(call)
    return kw


def _case(case, K, seed=0):
    family, opts, call = CASES[case]
    p = _inputs(family, K, seed=seed, **opts)
    return p, _call_kw(family, call, p)


ROLL = ("u", "a", "x0", "window", "stage_w", "term_w", "u_min", "u_max")


def _split(p, kw):
    return gt.launch_generic_rollout(eps=p["eps"], **{k: p[k] for k in ROLL}, **kw)


def _split_plain(p, kw):
    return gt.generic_rollout_costs_plain(
        p["eps"], *(p[k] for k in ROLL), kw["dt"], kw["n_exploit"], kw["obstacles"],
        kw["robot_radius"], kw["safety_margin_rate"], kw["obstacle_velocities"],
        kw["soft_safety_distance"], kw["soft_weight"], kw["k_offset"],
        **{k: kw[k] for k in ("step_tile", "nx", "nu", "n_track", "T", "W", "wrap_yaw",
                              "last_only", "collision")})


def _close(name, got, want):
    atol, rtol = TOL[name]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def _check_S(case, got, want, g1):
    """S of a build: equal to the G = 1 build's bit for bit; to the plain
    version bit for bit in BIT_EQUAL, else within TOL["S"]."""
    torch.testing.assert_close(got, g1, rtol=0.0, atol=0.0, equal_nan=True)
    if case in BIT_EQUAL:
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0, equal_nan=True)
    else:
        _close("S", got, want)


def _hits(case, S, K):
    """Some rollouts, not all, reach an obstacle where the case has some."""
    call = CASES[case][2]
    if call.get("obstacles") == "circle":
        assert 0 < int((S > 1e6).sum()) < K
    elif call.get("obstacles") == "soft":
        assert 0 < int((S > S.min() + 1.0).sum()) < K


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("case", list(CASES))
def test_split_rollout(libs, build, case):
    p, kw = _case(case, K_SPLIT)
    kw["k_offset"] = 7.0  # the shard's global offset moves the exploration split
    with running_on(libs["G1"]):
        g1 = _split(p, kw)
    with running_on(libs[build]):
        got = _split(p, kw)
    want = _split_plain(p, kw)
    if "NaN row 0" in case:
        assert torch.isnan(want).all()
    else:
        assert torch.isfinite(want).all()
        _hits(case, want, K_SPLIT)
    _check_S("split " + case, got, want, g1)


def _filter_t(T_):
    return f32(np.triu(np.ones((T_, T_))) / np.arange(1, T_ + 1)[None, :])  # a causal average


def _tick(p, kw, *, K, inject, emit=False):
    """The fused tick with the epilogue through ``launch_generic_tick``."""
    T_ = p["u"].shape[0]
    args = dict(kw, T=T_, K=K)
    return gt.launch_generic_tick(
        seed=torch.tensor([SEED]), chol_sigma=p["chol_sigma"], inv_temperature=1.0 / 0.8,
        filter_t=_filter_t(T_), eps=p["eps"] if inject else None, emit_eps=emit,
        **{k: p[k] for k in ROLL}, **args)


def _tick_plain(p, kw, eps, K):
    T_ = p["u"].shape[0]
    args = dict(kw, T=T_, K=K)
    return gt.generic_mppi_tick_plain(
        None, *(p[k] for k in ROLL[:2]), p["chol_sigma"], *(p[k] for k in ROLL[2:]),
        args.pop("dt"), args.pop("n_exploit"), 1.0 / 0.8, eps=eps.contiguous(),
        filter_t=_filter_t(T_), fuse_epilogue=True, **args)


def _check_tick(case, out, plain, g1_S):
    S, w, w_eps, (u_new, u_shift, finite) = plain
    _check_S(case, out["S"], S, g1_S)
    if not torch.isfinite(S).all():
        return
    _close("w", out["w"], w)
    _close("w_eps", out["w_eps"], w_eps)
    rho, eta, _ = softmax_plain(S, 1.0 / 0.8)
    _close("rho", out["stats"][0], rho)
    _close("eta", out["stats"][1], eta)
    _close("u_new", out["u_new"], u_new)
    _close("u_shift", out["u_shift"], u_shift)
    assert float(out["finite"]) == float(finite) == 1.0


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_tick_injected(libs, build, case):
    p, kw = _case(case, K_SPLIT, seed=1)
    with running_on(libs["G1"]):
        g1 = _tick(p, kw, K=K_SPLIT, inject=True)
    with running_on(libs[build]):
        out = _tick(p, kw, K=K_SPLIT, inject=True)
    plain = _tick_plain(p, kw, p["eps"], K_SPLIT)
    if "NaN row 0" in case:
        assert torch.isnan(plain[0]).all()
        assert float(out["finite"]) == float(plain[3][2]) == 0.0  # the update is held
        torch.testing.assert_close(out["u_new"], p["u"], rtol=0.0, atol=0.0)
    _check_tick("fused " + case, out, plain, g1["S"])


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_fused_tick_hash_routes(libs, build, family):
    """Hash ε at K = 128: stored (emit_eps) and drawn again give the same
    bits in every output; the stored ε is the stream's within a float32
    rounding of the C library's log, sin and cos; a second call repeats the
    first."""
    K = 128
    p = _inputs(family, K, seed=2)
    kw = _call_kw(family, dict(obstacles="soft" if family == "dynamic_bicycle" else "circle"), p)
    with running_on(libs["G1"]):
        g1 = _tick(p, kw, K=K, inject=False)
    with running_on(libs[build]):
        drawn = _tick(p, kw, K=K, inject=False)
        stored = _tick(p, kw, K=K, inject=False, emit=True)
        again = _tick(p, kw, K=K, inject=False)
    assert drawn["eps"] is None
    for name in ("S", "w", "w_eps", "stats", "u_new", "u_shift", "finite"):
        assert torch.equal(stored[name], drawn[name]), name
        assert torch.equal(again[name], drawn[name]), name
    kernel_eps = stored["eps"].transpose(0, 1)
    want_eps = hash_noise(torch.tensor([SEED]), p["chol_sigma"], K, T, K)
    torch.testing.assert_close(kernel_eps, want_eps, rtol=0.0, atol=TOL["eps"][0])
    _check_tick(f"fused hash {family}", drawn, _tick_plain(p, kw, kernel_eps, K), g1["S"])


def test_fused_tick_long_horizon(libs):
    """T = 120 at nu = 4: the epilogue reads Fᵀ from device memory (it stages
    it in shared memory only up to T = 106 at nu = 4) and its 256 threads own
    several rows each; u_new, u_shift and the flag within TOL of the plain
    epilogue."""
    p = _inputs("four_wheel_torque", 128, seed=8, steps=120)
    kw = _call_kw("four_wheel_torque", {}, p)
    with running_on(libs["shipped"]):
        out = _tick(p, kw, K=128, inject=True)
    _check_tick("fused long horizon", out, _tick_plain(p, kw, p["eps"], 128), out["S"])


@pytest.mark.parametrize("shape", ["K384 T6 four_wheel_torque", "K384 T20 unicycle"])
def test_chunk_layouts_of_several_samples_and_steps(libs, shape):
    """The fill4 build's chunks: 384 samples (one or two a thread) in one
    chunk, one step a block at T = 6 and five steps a block at T = 20 (four
    step groups); hash ε drawn again, with the epilogue. S equal to the G = 1
    build's; ρ, η, w, Σ w·ε, u_new and u_shift within TOL of the plain
    versions on the stored ε; a second call repeats the first."""
    K, steps, family = int(shape.split()[0][1:]), int(shape.split()[1][1:]), shape.split()[2]
    nu = FAMILIES[family][1]
    with running_on(libs["fill4"]):
        assert gt.scratch_floats(K, steps, nu) == 2 + steps * 1 * nu
    p = _inputs(family, K, seed=9, steps=steps)
    kw = _call_kw(family, {}, p)
    with running_on(libs["G1"]):
        g1 = _tick(p, kw, K=K, inject=False)
    with running_on(libs["fill4"]):
        out = _tick(p, kw, K=K, inject=False)
        stored = _tick(p, kw, K=K, inject=False, emit=True)
        again = _tick(p, kw, K=K, inject=False)
    kernel_eps = stored["eps"].transpose(0, 1)
    _check_tick(f"fused fill4 {shape}", out, _tick_plain(p, kw, kernel_eps, K), g1["S"])
    for name in ("S", "w", "w_eps", "stats", "u_new", "u_shift", "finite"):
        assert torch.equal(again[name], out[name]), name
        assert torch.equal(stored[name], out[name]), name


# the chunk layout of the generic tick at its main paths' shapes (K, T, nu):
# C chunks -> 2·C + T·C·nu floats of scratch (the four-wheel example: 8
# chunks of 256; K = 10 240, T = 50: 10 chunks of 1 024)
SCRATCH = {(2048, 25, 4): 2 * 8 + 25 * 8 * 4, (10240, 50, 4): 2 * 10 + 50 * 10 * 4,
           (10240, 50, 2): 2 * 10 + 50 * 10 * 2}


@pytest.mark.parametrize("shape", list(SCRATCH))
def test_scratch_floats(libs, shape):
    with running_on(libs["shipped"]):
        assert gt.scratch_floats(*shape) == SCRATCH[shape]


# the rule of the shipped build: lanes a sample by family, ε route (drawn,
# injected) and the launch's sample count: (few, many) either side of 4 096
RULE = {"unicycle": ((8, 2), (2, 1)), "kinematic_bicycle": ((2, 2), (1, 1)),
        "four_wheel_torque": ((8, 2), (1, 1)), "dynamic_bicycle": ((2, 1), (2, 1))}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_rollout_group_rule(libs, family):
    with running_on(libs["shipped"]):
        for hash_eps, (few, many) in zip((True, False), RULE[family]):
            for n in (44, 2048, 4096):
                assert gt.rollout_group(family, n, hash_eps) == few, (n, hash_eps)
            for n in (4097, 10240, 102400):
                assert gt.rollout_group(family, n, hash_eps) == many, (n, hash_eps)


def test_forced_builds_run_their_group(libs):
    for g in GROUPS:
        for model in range(len(FAMILIES)):
            for n in (44, 2048, 10240, 102400):
                for hash_eps in (0, 1):
                    assert libs[f"G{g}"].dmm_generic_group(model, n, hash_eps) == g
    assert libs["shipped"].dmm_generic_group(len(FAMILIES), 2048, 1) == -1


def test_argument_block_size(libs):
    assert libs["shipped"].dmm_generic_args_size() == ctypes.sizeof(_build.DmmGenericArgs)


# the carry: (family, span, the carry window's options, the inputs' options,
# the call's options). Rows [start, start + 40) of a 60-point curve, the
# last rows repeated past the path's end; "NaN state": ε NaN for samples
# 5 and 30 from step 2 on
CARRY_CASES = {
    "unicycle span 8": ("unicycle", 8, {}, {}, {}),
    "unicycle span 3 LAST": ("unicycle", 3, {}, {}, dict(last_only=True)),
    "kinematic_bicycle wrap span 5": ("kinematic_bicycle", 5, {}, {}, dict(wrap_yaw=True)),
    "four_wheel_torque span 8": ("four_wheel_torque", 8, {}, {}, {}),
    "four_wheel_torque n_track 2": ("four_wheel_torque", 8, {}, dict(n_track=2), {}),
    "dynamic_bicycle span 8": ("dynamic_bicycle", 8, {}, {}, {}),
    "unicycle path end": ("unicycle", 8, dict(start=50), dict(x0=[2.6, 0.45, 0.3]), {}),
    "four_wheel_torque twins": ("four_wheel_torque", 8, dict(twin=4), {}, {}),
    "unicycle NaN row 5": ("unicycle", 8, dict(nan_row=5), {}, {}),
    "four_wheel_torque NaN state": ("four_wheel_torque", 8, {}, dict(nan_eps=(5, 30)), {}),
}


def _carry_window(n_track, start=0, twin=None, nan_row=None, rows=40, n=60):
    xs = np.linspace(0.0, 3.0, n)
    cols = [xs, 0.5 * np.sin(xs / 2.0), np.full(n, 0.3), np.full(n, 0.9), np.full(n, 0.1)]
    path = np.stack(cols[:n_track], 1)
    if twin is not None:  # rows twin apart share their (x, y): exact ties
        path[twin::2 * twin, :2] = path[0:-twin:2 * twin, :2][:len(path[twin::2 * twin])]
    window = path[np.minimum(start + np.arange(rows), n - 1)].copy()
    if nan_row is not None:
        window[nan_row] = np.nan
    return f32(window)


def _carry_case(case, K, seed):
    family, span, win, opts, call = CARRY_CASES[case]
    opts = dict(opts)
    x0, nan_eps = opts.pop("x0", None), opts.pop("nan_eps", ())
    p = _inputs(family, K, seed=seed, **opts)
    p["window"] = _carry_window(p["stage_w"].shape[0], **win)
    if x0 is not None:
        p["x0"] = f32(x0[:FAMILIES[family][0]] + [0.9, 0.1][:FAMILIES[family][0] - 3])
    for k in nan_eps:
        p["eps"][k, 2:] = float("nan")
    return p, _call_kw(family, call, p), span, nan_eps


def _carry_tick(p, kw, span, *, K, inject, emit=False):
    T_ = p["u"].shape[0]
    return gt.launch_generic_tick(
        seed=torch.tensor([SEED]), chol_sigma=p["chol_sigma"], inv_temperature=1.0 / 0.8,
        filter_t=_filter_t(T_), eps=p["eps"] if inject else None, emit_eps=emit,
        carry_W=span, **{k: p[k] for k in ROLL}, **dict(kw, T=T_, K=K))


def _carry_plain(p, kw, span, eps, K):
    T_ = p["u"].shape[0]
    args = dict(kw, T=T_, K=K)
    return gt.generic_mppi_tick_plain(
        None, *(p[k] for k in ROLL[:2]), p["chol_sigma"], *(p[k] for k in ROLL[2:]),
        args.pop("dt"), args.pop("n_exploit"), 1.0 / 0.8, eps=eps.contiguous(),
        filter_t=_filter_t(T_), fuse_epilogue=True, rollout_carry=True, carry_W=span, **args)


def _check_carry(case, out, plain, g1):
    S, *_, carried = plain
    torch.testing.assert_close(out["S"], g1["S"], rtol=0.0, atol=0.0, equal_nan=True)
    assert torch.equal(out["wp_adv"], g1["wp_adv"])
    if case.startswith("dynamic_bicycle"):
        _close("S", out["S"], S)
    else:
        torch.testing.assert_close(out["S"], S, rtol=0.0, atol=0.0, equal_nan=True)
        assert int(out["wp_adv"][0]) == int(carried)
    assert int(carried) > 0


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("case", list(CARRY_CASES))
def test_fused_tick_carry_injected(libs, build, case):
    p, kw, span, nan_eps = _carry_case(case, K_SPLIT, seed=5)
    with running_on(libs["G1"]):
        g1 = _carry_tick(p, kw, span, K=K_SPLIT, inject=True)
    with running_on(libs[build]):
        out = _carry_tick(p, kw, span, K=K_SPLIT, inject=True)
    plain = _carry_plain(p, kw, span, p["eps"], K_SPLIT)
    _check_carry(case, out, plain, g1)
    if nan_eps:
        assert torch.isnan(plain[0][list(nan_eps)]).all() and torch.isfinite(plain[0][:5]).all()


@pytest.mark.parametrize("build", [f"G{g}" for g in GROUPS])
@pytest.mark.parametrize("case", ["unicycle span 8", "four_wheel_torque span 8",
                                  "unicycle path end"])
def test_fused_tick_carry_hash(libs, build, case):
    """The carry with hash ε at K = 128: the stored and drawn-again routes
    and a second call give the same bits, the G = 1 build's too; S and the
    furthest carried row equal the plain version's on the stored ε."""
    p, kw, span, _ = _carry_case(case, 128, seed=6)
    with running_on(libs["G1"]):
        g1 = _carry_tick(p, kw, span, K=128, inject=False)
    with running_on(libs[build]):
        drawn = _carry_tick(p, kw, span, K=128, inject=False)
        stored = _carry_tick(p, kw, span, K=128, inject=False, emit=True)
        again = _carry_tick(p, kw, span, K=128, inject=False)
    for name in ("S", "w", "w_eps", "stats", "u_new", "u_shift", "finite", "wp_adv"):
        assert torch.equal(stored[name], drawn[name]), name
        assert torch.equal(again[name], drawn[name]), name
    _check_carry(case, drawn, _carry_plain(p, kw, span, stored["eps"].transpose(0, 1), 128),
                 g1)


# fields of a valid argument block that a C entry must refuse. The split
# rollout: no sample, no step, an empty window, n_track below 2 or past nx,
# a negative obstacle count, a window too long to stage in shared memory,
# hash ε, an unknown family. The fused tick: an unknown ε mode, a horizon
# past the epilogue's 1 024 rows, scratch one float short, an epilogue
# without its filter, an unknown family.
REFUSED = {
    "split K": ("dmm_generic_rollout_costs", {"K": 0}),
    "split T": ("dmm_generic_rollout_costs", {"T": 0}),
    "split W": ("dmm_generic_rollout_costs", {"W": 0}),
    "split n_track 1": ("dmm_generic_rollout_costs", {"n_track": 1}),
    "split n_track 6": ("dmm_generic_rollout_costs", {"n_track": 6}),
    "split n_obs": ("dmm_generic_rollout_costs", {"n_obs": -1}),
    "split W staged": ("dmm_generic_rollout_costs", {"W": 5000}),
    "split eps_mode": ("dmm_generic_rollout_costs", {"eps_mode": 1}),
    "split model": ("dmm_generic_rollout_costs", {"model": 4}),
    "tick eps_mode": ("dmm_generic_tick", {"eps_mode": 3}),
    "tick T": ("dmm_generic_tick", {"T": 1025}),
    "tick scratch": ("dmm_generic_tick", {"scratch_floats": -1}),
    "tick filter": ("dmm_generic_tick", {"filter_t": None}),
    "tick model": ("dmm_generic_tick", {"model": 4}),
    "tick carry span": ("dmm_generic_tick", {"carry_span": 21}),  # past the W = 20 rows
    "tick carry no output": ("dmm_generic_tick", {"carry_span": 3, "wp_adv": None}),
    "split carry": ("dmm_generic_rollout_costs", {"carry_span": 3}),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_launch_refuses(libs, case, monkeypatch):
    entry, fields = REFUSED[case]
    lib = libs["shipped"]
    captured = {}
    monkeypatch.setattr(gt, "launch", lambda e, args, device, kernels=None:
                        captured.update(args=args))
    monkeypatch.setattr(gt, "load_kernels", lambda: lib)
    p, kw = _case("four_wheel_torque circle", 128)
    if entry == "dmm_generic_rollout_costs":
        _split(p, kw)
    else:
        _tick(p, kw, K=128, inject=False, emit=True)
    args = captured["args"]
    for name, value in fields.items():
        if name == "scratch_floats":
            value = args.scratch_floats - 1
        setattr(args, name, value)
    assert getattr(lib, entry)(ctypes.addressof(args), None) != 0
