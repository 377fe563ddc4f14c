"""Generated tile-step functors through the generic kernels' own source, on the CPU.

``ops/cuda/user_tile.py`` traces a tile step of the user's into a CUDA
functor (``dmm_user_tile.cuh``); ``csrc/generic_kernels.cu`` built with
``-DDMM_USER_TILE`` runs rows 8 and 9 on it. Here that source is compiled
with g++ against ``tests/cuda_emu.h`` by ``tests/cuda_emu.py`` (as
``tests/test_torch_generic_kernel_emu.py`` builds the built-in families;
``-ffp-contract=off`` as nvcc's ``-fmad=false``; sincosf, tanf and the
generated code's atan, atan2, exp, log, tanh and pow PyTorch's) once per
step, and the wrappers' launchers (``generic_tick.launch_generic_rollout``,
``generic_tick.launch_generic_tick``) drive it with their real argument
blocks, the library chosen as on the card (``generic_tick._kernels``).

The steps: ``lift_dynamics`` around the port's ``euler_step`` of the
unicycle, the four-wheel torque model and the dynamic bicycle, its
``rk4_step`` of the four-wheel model, and ``lift_dynamics_time_varying``
around JAX's ``dyn_tv`` (tests/test_time_varying.py:44, actuation decaying
with the int32 rollout step t). Against the plain twins
(``generic_rollout_costs_plain``, ``generic_mppi_tick_plain``, which call
the step with the same t) S is bit for bit equal in the split rollout
(k_offset 7, circle obstacles), the fused tick with injected ε and with hash
ε (the stored and drawn-again routes and a repeat bit-equal too), and the
tick's rollout carry (the furthest carried row exact); w, Σ w·ε, u_new and
u_shift within ``chip_smoke.TOL``. Soft drifting obstacles, whose ``expf``
in the hand-written cost is the C library's, hold S within TOL["S"]. A step
that calls every other lowered op (atan2 and a general power, which PyTorch
rounds otherwise inside a tensor than for an element alone, so the
emulator cannot match them bit for bit) holds S within 16 float32 ulps of
the plain twin's. Forced lane groups G = 1 and 8 give the shipped rule's S.

Matrix products (``user_tile``'s lowering): ``lift_linear`` at the
four-wheel example's widths (45 weights), ``lift_mlp_residual`` of the
Euler unicycle with a 5→16→16→3 tanh residual (419 weights) and two
5→32→32→3 ones of other weights (1 347 each, one header), and relu,
sigmoid and where after a product, every weight read from the step's device
buffer, staged in shared memory: S bit for bit against the plain twins in
every case above (the twin's products sum in the functor's order,
``user_tile.functor_order``); G = 1 on every route; the packed buffer
reaches the launch, and is packed again after a residual net is trained in
place, with the same library. The linear and the narrow MLP kernels in
the solver against JAX's interpret-mode tick: S, u and the optimal
trajectory within 1e-5.

Parity with JAX: ``MPPISolver(fused_tick=True, tile_dynamics=lift_dynamics(...),
device="cpu")`` with the generic tick routed to the emulated kernel against
JAX's ``mppi_step`` with ``make_generic_fused_tick(lift_dynamics(...),
interpret=True)`` on the problems of tests/test_generic_tick.py:229
(``test_lift_dynamics_adapter_matches_tile``) and
tests/test_time_varying.py:142 (``test_generic_tick_parity_with_scan``):
costs within rtol/atol 1e-5, u0 within rtol 1e-5, atol 1e-6. Skips without
g++.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import shutil
from concurrent.futures import ThreadPoolExecutor

import cuda_emu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models import dynamics as jdyn
from dnn_mppi_mpc_tpu.models import tile as jtile
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import _build
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch.models import dynamics as tdyn
from dnn_mppi_mpc_tpu_torch.models import tile as ttile
from dnn_mppi_mpc_tpu_torch.models.integrators import euler_step, rk4_step
from dnn_mppi_mpc_tpu_torch.ops.cuda import generic_tick as gt
from dnn_mppi_mpc_tpu_torch.ops.cuda import user_tile
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi
from test_time_varying import dyn_tv as j_dyn_tv
from test_torch_user_tile import (
    check_product_parity,
    mlp_params,
    product_problem,
    run_product_parity,
)

T, DT, SEED = 6, 0.05, 0x5EED1E
ULPS = 16  # the "every op" step: S within this many float32 ulps of |S|


def t_dyn_tv(x, u, t):
    """JAX's dyn_tv (tests/test_time_varying.py:44) in PyTorch: a unicycle
    whose actuation decays with the rollout step t."""
    decay = 1.0 / (1.0 + 0.1 * t.to(x.dtype) * DT)
    v, w, yaw = u[..., 0] * decay, u[..., 1] * decay, x[..., 2]
    return torch.stack([x[..., 0] + v * torch.cos(yaw) * DT,
                        x[..., 1] + v * torch.sin(yaw) * DT, yaw + w * DT], -1)


_SCALE = torch.tensor(0.75)  # a captured scalar tensor, baked in as a literal


def every_op(xs, vs, t):
    """A tile step of nx = 4, nu = 2 that calls the lowered ops the models
    above do not: atan2, a general power, exp, log, tanh, sqrt, clamp,
    minimum / maximum, where over comparisons and logical ops, floor, abs,
    integer t, stack / cat / unsqueeze / expand / unbind / slice on the last
    axis, full_like and a captured scalar."""
    x, y, yaw, v = xs
    a, b = vs
    tf = (t * 2 + 1).to(torch.float32)
    heading = torch.atan2(torch.sin(yaw), torch.cos(yaw))
    drag = torch.pow(torch.abs(v) + 0.5, 1.5) * 0.01
    gain = torch.exp(-0.1 * torch.abs(a)) * torch.log(torch.abs(b) + 1.0)
    lim = torch.clamp(a, -1.0, 1.0) + torch.minimum(b, torch.full_like(b, 0.3)) \
        - torch.maximum(b, torch.zeros_like(b))
    fast = torch.logical_and(v > 0.5, torch.logical_not(torch.abs(yaw) > 3.0))
    acc = torch.where(fast, lim * 0.5, lim) - drag + torch.tanh(gain) * 0.1
    pos = torch.stack([x, y], -1)
    step = torch.cat([torch.cos(heading).unsqueeze(-1), torch.sin(heading).unsqueeze(-1)], -1)
    pos = pos + step * (v * DT).unsqueeze(-1).expand(-1, 2) * _SCALE
    nx_, ny_ = pos.unbind(-1)
    floor_part = torch.floor(yaw * 0.25) * 1e-3
    yaw_n = yaw + b * DT + floor_part + torch.sqrt(torch.abs(a) + 1.0) * 1e-3 / tf
    v_n = torch.clamp(v + acc * DT, min=0.0)
    return nx_, ny_, yaw_n, pos[..., 0:1].squeeze(-1) * 0.0 + v_n


_B = torch.tensor(np.random.default_rng(4).normal(0.0, 0.5, (3, 4)), dtype=torch.float32)


def activations(x, u):
    """relu, sigmoid and where after a product (x @ B, B (3, 4) captured)."""
    h = x @ _B
    return x + 0.05 * torch.where(h[..., :3] > 0.0, torch.sigmoid(h)[..., 1:],
                                  torch.relu(h)[..., :3]) * u[..., :1]


def _nominal(x, u):
    return euler_step(tdyn.unicycle, x, u, DT)


# two 5→32→32→3 residuals (1 347 weights each) of other weights: one header
MLP_32 = ttile.lift_mlp_residual(_nominal, mlp_params([5, 32, 32, 3], seed=32), device="cpu")
MLP_32_RESEEDED = ttile.lift_mlp_residual(_nominal, mlp_params([5, 32, 32, 3], seed=33),
                                          device="cpu")

# name -> (tile step, nx, nu, x0)
STEPS = {
    "unicycle euler": (ttile.lift_dynamics(lambda x, u: euler_step(tdyn.unicycle, x, u, DT)),
                       3, 2, [0.05, -0.02, 0.3]),
    "four_wheel euler": (ttile.lift_dynamics(
        lambda x, u: euler_step(tdyn.four_wheel_torque, x, u, DT)), 5, 4,
        [0.05, -0.02, 0.3, 0.9, 0.1]),
    "four_wheel rk4": (ttile.lift_dynamics(
        lambda x, u: rk4_step(tdyn.four_wheel_torque, x, u, DT)), 5, 4,
        [0.05, -0.02, 0.3, 0.9, 0.1]),
    "dynamic_bicycle euler": (ttile.lift_dynamics(
        lambda x, u: euler_step(tdyn.dynamic_bicycle, x, u, DT)), 4, 2, [0.05, -0.02, 0.3, 1.2]),
    "dyn_tv": (ttile.lift_dynamics_time_varying(t_dyn_tv), 3, 2, [0.05, -0.02, 0.3]),
    "every op": (ttile.TileStep(None, None, None, (), True, every_op), 4, 2,
                 [0.05, -0.02, 0.3, 0.9]),
    "linear 5x4": (product_problem("linear 5 4")[4], 5, 4, [0.05, -0.02, 0.3, 0.9, 0.1]),
    "mlp residual": (product_problem("mlp 16")[4], 3, 2, [0.05, -0.02, 0.3]),
    "mlp residual 32": (MLP_32, 3, 2, [0.05, -0.02, 0.3]),
    "mlp residual 32 reseeded": (MLP_32_RESEEDED, 3, 2, [0.05, -0.02, 0.3]),
    "activations": (ttile.lift_dynamics(activations), 3, 2, [0.05, -0.02, 0.3]),
}
PRODUCTS = ["linear 5x4", "mlp residual", "mlp residual 32", "mlp residual 32 reseeded",
            "activations"]
BIT_EQUAL = [name for name in STEPS if name != "every op"]
BUILDS = {**{name: () for name in STEPS},
          **{f"unicycle euler G{g}": (f"DMM_GENERIC_GROUP={g}",) for g in (1, 8)}}
K_SPLIT = 44  # not a multiple of a block's samples at any G (64 / G)


def _step(build: str):
    return STEPS[build.split(" G")[0]]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """csrc/generic_kernels.cu built for the CPU around each step's
    generated header, by name."""
    torch.set_num_threads(1)
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")

    def build(name, header):
        work = tmp_path_factory.mktemp("user_emu")
        lib = cuda_emu.build(["generic_kernels.cu"], work, ("DMM_USER_TILE", *BUILDS[name]),
                             headers={_build.USER_TILE_HEADER: header})
        cuda_emu.torch_math(lib)
        _build._declare_generic(lib)
        return lib

    assert user_tile.lower(MLP_32, 3, 2, False).header == \
        user_tile.lower(MLP_32_RESEEDED, 3, 2, False).header
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        futures = {name: pool.submit(build, name, user_tile.lower(
            _step(name)[0], *_step(name)[1:3], _step(name)[0].takes_t).header)
            for name in BUILDS}
        return {name: f.result() for name, f in futures.items()}


@contextlib.contextmanager
def running_on(lib, every_call_on_card: bool = False):
    """Within the block the generic wrappers launch into ``lib`` (the
    generated functor's library); with ``every_call_on_card`` the wrappers
    take CPU tensors for the card's, so a solver's ticks launch too."""
    def launch(entry, args, device, kernels=None):
        assert device.type == "cpu" and kernels is lib
        err = getattr(lib, entry)(ctypes.addressof(args), None)
        if err != 0:
            raise RuntimeError(f"{entry}: error {err} at launch")

    mp = pytest.MonkeyPatch()
    mp.setattr(gt, "launch", launch)
    mp.setattr(gt, "load_user_kernels", lambda header: lib)
    if every_call_on_card:
        mp.setattr(gt, "on_cuda", lambda ref, **tensors: True)
    try:
        yield
    finally:
        mp.undo()


def f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _inputs(name, K, *, seed=0, steps=T, W=20):
    """One tick's inputs for step ``name``, made from ``seed`` with numpy:
    Σ, u, bounds, a 40-point curve's first W rows with its columns past
    (x, y) a heading, a speed and a yaw rate."""
    _, nx, nu, x0 = _step(name)
    rng = np.random.default_rng(seed)
    A = rng.normal(0.0, 0.2, (nu, nu))
    sigma = A @ A.T + 0.05 * np.eye(nu)
    u = rng.normal(0.0, 0.3, (steps, nu)) + 0.3
    n = 40
    xs = np.linspace(0.0, 4.0, n)
    cols = [xs, 0.5 * np.sin(xs / 2.0), np.full(n, 0.3), np.full(n, 0.9), np.full(n, 0.1)]
    return dict(
        eps=f32(rng.multivariate_normal(np.zeros(nu), sigma, (K, steps))), u=f32(u),
        a=f32(0.56 * u @ np.linalg.inv(sigma)), chol_sigma=f32(np.linalg.cholesky(sigma)),
        x0=f32(x0), window=f32(np.stack(cols[:nx], 1)[:W]),
        stage_w=f32(rng.uniform(1.0, 6.0, nx)), term_w=f32(rng.uniform(2.0, 9.0, nx)),
        u_min=f32(np.full(nu, -2.0)), u_max=f32(np.full(nu, 2.0)),
    )


def _obstacles(name, p, n_exploit):
    """Two obstacles: one whose edge runs through the median of the
    rollouts' end points, so that about half of them hit it, one beside."""
    step, nx, nu, _ = _step(name)
    K = p["eps"].shape[0]
    xs = tuple(p["x0"][i].expand(K) for i in range(nx))
    exploit = torch.arange(K) < n_exploit
    for t in range(p["u"].shape[0]):
        e = p["eps"][:, t]
        vs = tuple(torch.clamp(torch.where(exploit, p["u"][t, j] + e[:, j], e[:, j]),
                               p["u_min"][j], p["u_max"][j]) for j in range(nu))
        xs = step(xs, vs, torch.tensor(t, dtype=torch.int32)) if step.takes_t else step(xs, vs)
    mx, my = float(xs[0].median()), float(xs[1].median())
    return f32([[mx, my + 0.05 + 0.075, 0.05], [mx - 0.2, my - 0.3, 0.05]])


def _kw(name, p, collision="circle"):
    step, nx, nu, _ = _step(name)
    K = p["eps"].shape[0]
    kw = dict(dt=DT, n_exploit=0.8 * K, robot_radius=0.05, safety_margin_rate=1.5,
              obstacle_velocities=None, soft_safety_distance=0.3, soft_weight=10.0,
              k_offset=0.0, step_tile=step, nx=nx, nu=nu, T=p["u"].shape[0], wrap_yaw=False,
              last_only=False, collision=collision, n_track=nx, W=p["window"].shape[0],
              step_takes_t=step.takes_t)
    kw["obstacles"] = _obstacles(name, p, kw["n_exploit"])
    if collision == "soft":
        kw["obstacle_velocities"] = f32([[0.5, -0.2], [-0.3, 0.4]])
    return kw


ROLL = ("u", "a", "x0", "window", "stage_w", "term_w", "u_min", "u_max")


def _filter_t(T_):
    return f32(np.triu(np.ones((T_, T_))) / np.arange(1, T_ + 1)[None, :])


def _tick(p, kw, *, K, inject, emit=False, carry_W=0):
    return gt.launch_generic_tick(
        seed=torch.tensor([SEED]), chol_sigma=p["chol_sigma"], inv_temperature=1.0 / 0.8,
        filter_t=_filter_t(kw["T"]), eps=p["eps"] if inject else None, emit_eps=emit,
        carry_W=carry_W, **{k: p[k] for k in ROLL}, **dict(kw, K=K))


def _tick_plain(p, kw, eps, K, carry_W=0):
    args = dict(kw, K=K)
    return gt.generic_mppi_tick_plain(
        None, p["u"], p["a"], p["chol_sigma"], *(p[k] for k in ROLL[2:]), args.pop("dt"),
        args.pop("n_exploit"), 1.0 / 0.8, eps=eps.contiguous(), filter_t=_filter_t(kw["T"]),
        fuse_epilogue=True, rollout_carry=carry_W > 0, carry_W=carry_W, **args)


def _check_S(name, got, want):
    if name in BIT_EQUAL:
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0, equal_nan=True)
    else:
        ulp = torch.finfo(torch.float32).eps
        torch.testing.assert_close(got, want, rtol=ULPS * ulp, atol=0.0)


def _check_tick(name, out, plain):
    S, w, w_eps, (u_new, u_shift, finite) = plain[:4]
    _check_S(name, out["S"], S)
    for key, got, want in (("w", out["w"], w), ("w_eps", out["w_eps"], w_eps),
                           ("u_new", out["u_new"], u_new), ("u_shift", out["u_shift"], u_shift)):
        atol, rtol = TOL[key]
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    assert float(out["finite"]) == float(finite) == 1.0


@pytest.mark.parametrize("name", list(STEPS))
def test_split_rollout(libs, name):
    """Row 9 on the generated functor: S against the plain twin, k_offset 7,
    circle obstacles that some rollouts hit."""
    p = _inputs(name, K_SPLIT)
    kw = dict(_kw(name, p), k_offset=7.0)
    with running_on(libs[name]):
        got = gt.launch_generic_rollout(eps=p["eps"], **{k: p[k] for k in ROLL}, **kw)
    want = gt.generic_rollout_costs_plain(
        p["eps"], *(p[k] for k in ROLL), kw.pop("dt"), kw.pop("n_exploit"), kw.pop("obstacles"),
        kw.pop("robot_radius"), kw.pop("safety_margin_rate"), kw.pop("obstacle_velocities"),
        kw.pop("soft_safety_distance"), kw.pop("soft_weight"), kw.pop("k_offset"), **kw)
    assert torch.isfinite(want).all() and 0 < int((want > 1e6).sum()) < K_SPLIT
    _check_S(name, got, want)


@pytest.mark.parametrize("name", list(STEPS))
def test_fused_tick_injected(libs, name):
    p = _inputs(name, K_SPLIT, seed=1)
    kw = _kw(name, p)
    with running_on(libs[name]):
        out = _tick(p, kw, K=K_SPLIT, inject=True)
    _check_tick(name, out, _tick_plain(p, kw, p["eps"], K_SPLIT))


@pytest.mark.parametrize("name", list(STEPS))
def test_fused_tick_hash_routes(libs, name):
    """Hash ε at K = 128: stored (emit_eps) and drawn again give the same
    bits in every output, a second call repeats the first, and S equals
    the plain twin's on the stored ε."""
    K = 128
    p = _inputs(name, K, seed=2)
    kw = _kw(name, p)
    with running_on(libs[name]):
        drawn = _tick(p, kw, K=K, inject=False)
        stored = _tick(p, kw, K=K, inject=False, emit=True)
        again = _tick(p, kw, K=K, inject=False)
    for key in ("S", "w", "w_eps", "stats", "u_new", "u_shift", "finite"):
        assert torch.equal(stored[key], drawn[key]), key
        assert torch.equal(again[key], drawn[key]), key
    _check_tick(name, drawn, _tick_plain(p, kw, stored["eps"].transpose(0, 1), K))


@pytest.mark.parametrize("name", list(STEPS))
def test_fused_tick_rollout_carry(libs, name):
    """The tick's rollout carry on the generated functor: 40 carry-window
    rows searched 8 at a time; S and the furthest carried row equal the
    plain twin's."""
    p = _inputs(name, K_SPLIT, seed=5, W=40)
    kw = _kw(name, p)
    with running_on(libs[name]):
        out = _tick(p, kw, K=K_SPLIT, inject=True, carry_W=8)
    plain = _tick_plain(p, kw, p["eps"], K_SPLIT, carry_W=8)
    _check_S(name, out["S"], plain[0])
    assert int(out["wp_adv"][0]) == int(plain[-1]) > 0


@pytest.mark.parametrize("name", ["unicycle euler", "dyn_tv", "four_wheel rk4"])
def test_soft_drifting_obstacles(libs, name):
    """Soft obstacles that drift: S within TOL["S"] (the hand-written soft
    cost's expf is the C library's here, the plain twin's torch.exp)."""
    p = _inputs(name, K_SPLIT, seed=3)
    kw = _kw(name, p, collision="soft")
    with running_on(libs[name]):
        out = _tick(p, kw, K=K_SPLIT, inject=True)
    S = _tick_plain(p, kw, p["eps"], K_SPLIT)[0]
    assert int((S > S.min() + 1.0).sum()) > 0
    atol, rtol = TOL["S"]
    torch.testing.assert_close(out["S"], S, atol=atol, rtol=rtol)


@pytest.mark.parametrize("g", [1, 8])
def test_forced_lane_groups_match_the_rule(libs, g):
    """The generated functor at G = 1 and 8 (``-DDMM_GENERIC_GROUP``): S of
    the split rollout and of the hash-ε tick equal the shipped rule's build,
    bit for bit; the forced build reports its G."""
    name = "unicycle euler"
    p = _inputs(name, 128, seed=4)
    kw = _kw(name, p)
    outs = []
    for build in (name, f"{name} G{g}"):
        with running_on(libs[build]):
            outs.append((gt.launch_generic_rollout(eps=p["eps"], **{k: p[k] for k in ROLL},
                                                   **kw), _tick(p, kw, K=128, inject=False)["S"]))
        assert gt.rollout_group(None, 128, True, libs[build]) == (8 if build == name else g)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_the_rule_of_a_generated_functor(libs):
    """The shipped rule for a generated functor (csrc/generic_kernels.cu):
    hash ε 8 lanes up to 4 096 samples when NX + NU ≤ 9, else 2; injected
    ε 1; the library holds no built-in family."""
    for name, few in (("unicycle euler", 8), ("four_wheel euler", 8), ("every op", 8)):
        lib = libs[name]
        for n, want in ((2048, few), (4096, few), (4097, 2), (10240, 2)):
            assert gt.rollout_group(None, n, True, lib) == want
            assert gt.rollout_group(None, n, False, lib) == 1
        assert lib.dmm_generic_group(0, 2048, 1) == -1
        assert lib.dmm_generic_args_size() == ctypes.sizeof(_build.DmmGenericArgs)


@pytest.mark.parametrize("name", PRODUCTS)
def test_the_rule_of_a_functor_with_products(libs, name):
    """A generated functor that holds matrix products runs at G = 1 on every
    route and sample count; its header states its multiply-adds."""
    step, nx, nu, _ = STEPS[name]
    low = user_tile.lower(step, nx, nu, False)
    assert low.macs > 0 and f"MACS = {low.macs};" in low.header
    for n in (128, 2048, 4096, 4097, 10240):
        for hash_eps in (True, False):
            assert gt.rollout_group(None, n, hash_eps, libs[name]) == 1


def test_the_weights_reach_the_launch(libs, monkeypatch):
    """Each functor with weights gets its step's packed buffer as
    DmmGenericArgs::weights (two nets of one header, each its own); a
    functor without weights gets null; a library with weights refuses a
    launch without them."""
    seen = {}
    for name in ("mlp residual 32", "mlp residual 32 reseeded", "linear 5x4", "unicycle euler"):
        captured = {}
        monkeypatch.setattr(gt, "launch", lambda e, args, device, kernels=None:
                            captured.update(args=args))
        monkeypatch.setattr(gt, "load_user_kernels", lambda header, lib=libs[name]: lib)
        p = _inputs(name, 128)
        _tick(p, _kw(name, p), K=128, inject=True)
        seen[name] = captured["args"]
    for name in ("mlp residual 32", "mlp residual 32 reseeded", "linear 5x4"):
        step, nx, nu, _ = STEPS[name]
        buf = user_tile.weight_buffer(user_tile.lower(step, nx, nu, False), torch.device("cpu"))
        assert seen[name].weights == buf.data_ptr()
    assert not seen["unicycle euler"].weights
    args = seen["mlp residual 32"]
    args.weights = None
    assert libs["mlp residual 32"].dmm_generic_tick(ctypes.addressof(args), None) != 0


def test_a_net_trained_in_place_runs_its_new_weights(libs):
    """An nn.Sequential residual of the narrow MLP's header on row 9: after
    an optimizer step on its weights the same library runs the new weights
    (the buffer packed again), S bit for bit against the plain twin before
    and after."""
    layers = mlp_params([5, 16, 16, 3], seed=16)
    net = torch.nn.Sequential(torch.nn.Linear(5, 16), torch.nn.Tanh(), torch.nn.Linear(16, 16),
                              torch.nn.Tanh(), torch.nn.Linear(16, 3))
    with torch.no_grad():
        for lin, (W, b) in zip(net[::2], layers):
            lin.weight.copy_(torch.as_tensor(W.T))
            lin.bias.copy_(torch.as_tensor(b))
    step = ttile.lift_dynamics(lambda x, u: _nominal(x, u) + net(torch.cat([x, u], -1)))
    assert user_tile.lower(step, 3, 2, False).header == \
        user_tile.lower(STEPS["mlp residual"][0], 3, 2, False).header
    p = _inputs("mlp residual", K_SPLIT, seed=3)
    kw = dict(_kw("mlp residual", p), step_tile=step)
    costs = []
    for _ in range(2):
        with running_on(libs["mlp residual"]):
            got = gt.launch_generic_rollout(eps=p["eps"], **{k: p[k] for k in ROLL}, **kw)
        args = dict(kw)
        want = gt.generic_rollout_costs_plain(
            p["eps"], *(p[k] for k in ROLL), *(args.pop(k) for k in (
                "dt", "n_exploit", "obstacles", "robot_radius", "safety_margin_rate",
                "obstacle_velocities", "soft_safety_distance", "soft_weight", "k_offset")),
            **args)
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)
        costs.append(got)
        opt = torch.optim.SGD(net.parameters(), lr=0.5)
        net(torch.ones(4, 5)).square().sum().backward()
        opt.step()
    assert not torch.equal(costs[0], costs[1])


@pytest.mark.parametrize("name, case", [("linear 5x4", "linear 5 4"), ("mlp residual", "mlp 16")])
def test_product_kernel_matches_jax_generic_tick(libs, name, case):
    """The emulated generated kernel of a step with matrix products inside
    ``MPPISolver(fused_tick=True, tile_dynamics=...)`` against JAX's
    interpret-mode generic tick on the same numpy noise (the problem of
    tests/test_torch_user_tile.py): S, u and the optimal trajectory within
    1e-5."""
    t_tile = product_problem(case)[4]
    assert user_tile.lower(t_tile, *STEPS[name][1:3], False).header == \
        user_tile.lower(*STEPS[name][:3], False).header
    with running_on(libs[name], every_call_on_card=True):
        gt.generic_mppi_tick.launches = 0
        j_out, t_out = run_product_parity(case, "8")
        assert gt.generic_mppi_tick.launches == 1
    check_product_parity(j_out, t_out)


def test_a_generated_library_refuses_a_built_in_family(libs, monkeypatch):
    """DmmGenericArgs::model other than USER_MODEL is refused by the
    generated functor's library, before any launch."""
    name = "unicycle euler"
    lib = libs[name]
    captured = {}
    monkeypatch.setattr(gt, "launch", lambda e, args, device, kernels=None:
                        captured.update(args=args))
    monkeypatch.setattr(gt, "load_user_kernels", lambda header: lib)
    p = _inputs(name, 128)
    _tick(p, _kw(name, p), K=128, inject=False, emit=True)
    args = captured["args"]
    assert args.model == gt.USER_MODEL
    args.model = 0
    assert lib.dmm_generic_tick(ctypes.addressof(args), None) != 0


# --- parity with JAX's interpret-mode generic tick ---------------------------------


def _jax_port_problem(time_varying: bool):
    """tests/test_generic_tick.py:229's problem (K = 256, T = 10, lift_dynamics
    of the Euler unicycle) or tests/test_time_varying.py:142's (dyn_tv)."""
    K_, T_ = 256, 10
    kw = dict(num_samples=K_, horizon=T_, dim_x=3, dim_u=2, dt=DT, lam=0.8, alpha=0.3,
              exploration=0.25, filter_window=5, waypoint_search_len=8,
              time_varying_dynamics=time_varying)
    jc = jcfg.MPPIConfig(**kw, temperature=jcfg.Temperature.LAMBDA,
                         filter=jcfg.SmoothingFilter.MOVING_AVERAGE_EDGE)
    tc = tcfg.MPPIConfig(**kw, temperature=tcfg.Temperature.LAMBDA,
                         filter=tcfg.SmoothingFilter.MOVING_AVERAGE_EDGE)
    n = 40
    if time_varying:
        path = np.stack([np.linspace(0, 4, n), np.sin(np.linspace(0, 2, n)), np.zeros(n)], 1)
        leaves = dict(sigma=[[0.1, 0.0], [0.0, 0.05]], stage_weight=[5.0, 5.0, 1.0],
                      terminal_weight=[5.0, 5.0, 1.0], u_min=[-2.0, -2.0], u_max=[2.0, 2.0])
        eps = np.random.default_rng(3).normal(0, 0.1, (K_, T_, 2))
        u_prev, x0 = np.zeros((T_, 2)), [0.0, 0.2, 0.1]
    else:
        rng = np.random.default_rng(7)
        path = np.stack([np.linspace(0.0, 4.0, n), np.sin(np.linspace(0.0, 2.0, n)),
                         rng.normal(0.0, 0.4, n).cumsum() * 0.1], 1)
        leaves = dict(sigma=[[0.2, 0.05], [0.05, 0.1]], stage_weight=[4.0, 4.0, 0.5],
                      terminal_weight=[9.0, 9.0, 2.0], u_min=[-1.5, -2.0], u_max=[1.5, 2.0])
        eps = np.random.default_rng(3).multivariate_normal(np.zeros(2), leaves["sigma"],
                                                           (K_, T_))
        u_prev, x0 = np.random.default_rng(0).normal(0, 0.3, (T_, 2)), [0.1, -0.05, 0.2]
    leaves = {k: np.asarray(v, np.float32) for k, v in leaves.items()}
    path = path.astype(np.float32)
    eps, u_prev, x0 = (np.asarray(a, np.float32) for a in (eps, u_prev, x0))
    jp = jcfg.MPPIParams(**{k: jnp.asarray(v) for k, v in leaves.items()},
                         ref_path=jnp.asarray(path))
    tp = tcfg.params_from_numpy(**leaves, ref_path=path, device="cpu")
    return jc, jp, tc, tp, eps, u_prev, x0


@pytest.mark.parametrize("time_varying", [False, True],
                         ids=["lift_dynamics", "lift_dynamics_time_varying"])
def test_generated_kernel_matches_jax_generic_tick(libs, time_varying):
    jc, jp, tc, tp, eps, u_prev, x0 = _jax_port_problem(time_varying)
    if time_varying:
        j_dyn, t_dyn = j_dyn_tv, t_dyn_tv
        j_tile = jtile.lift_dynamics_time_varying(j_dyn_tv)
        t_tile, name = STEPS["dyn_tv"][0], "dyn_tv"
    else:
        j_dyn = lambda x, u: j_euler(jdyn.unicycle, x, u, DT)  # noqa: E731
        t_dyn = lambda x, u: euler_step(tdyn.unicycle, x, u, DT)  # noqa: E731
        j_tile, t_tile, name = jtile.lift_dynamics(j_dyn), STEPS["unicycle euler"][0], \
            "unicycle euler"
    jsc, jtc = jmppi.make_tracking_costs(jc)
    jtick = jmppi.make_generic_fused_tick(jc, j_tile, interpret=True)
    j_state = dataclasses.replace(jmppi.MPPIState.init(jc), u_prev=jnp.asarray(u_prev))
    u_j, _, aux_j = jax.jit(lambda p, s, x, n: jmppi.mppi_step(
        jc, j_dyn, jsc, jtc, p, s, x, n, tick_fn=jtick))(jp, j_state, jnp.asarray(x0),
                                                           jnp.asarray(eps))
    solver = tmppi.MPPISolver(tc, t_dyn, *tmppi.make_tracking_costs(tc), fused_tick=True,
                              tile_dynamics=t_tile, device="cpu")
    state = tmppi.state_from_numpy(u_prev, 0, [0, 0], device="cpu")
    with running_on(libs[name], every_call_on_card=True):
        gt.generic_mppi_tick.launches = 0
        u_t, _, aux_t = solver.step(tp, state, torch.as_tensor(x0), torch.as_tensor(eps))
        assert gt.generic_mppi_tick.launches == 1
    np.testing.assert_allclose(aux_t.costs.numpy(), np.asarray(aux_j.costs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-5, atol=1e-6)
