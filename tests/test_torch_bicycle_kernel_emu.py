"""The bicycle rollout kernel's own source, run on the CPU.

``csrc/bicycle_kernels.cu`` is compiled with g++ against ``tests/cuda_emu.h``
by ``tests/cuda_emu.py`` (every thread a fiber on the calling thread, a
warp's lanes meeting at each shuffle and ballot; ``-ffp-contract=off`` as
nvcc's ``-fmad=false``; sin, cos and tan PyTorch's, as in the plain
version), once as it ships (G = 8 lanes a sample) and once with
``-DDMM_BICYCLE_GROUP=16`` (the build ``chip_smoke.py`` times beside it), and
``launch_bicycle`` drives it through ctypes on CPU tensors with its real
argument block. So the lane groups' window search (the partial running
minima and their shuffle merge), the outline tests dealt over the lanes and
their ballot, and the hash ε drawn a step a lane are checked here, where
there is no card: for ISO and not, obstacles hit, a NaN window row past row
0 and at row 0, rows that tie exactly (in one lane and across lanes), W not
a multiple of G and W < G, S must equal ``bicycle_rollout_body_plain`` bit
for bit (NaN where it is NaN), as the kernel equals it on the card
(``chip_smoke.py``). Skips without g++.
"""

from __future__ import annotations

import ctypes

import cuda_emu
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu_torch import _build
from dnn_mppi_mpc_tpu_torch.ops.cuda import rollout_bicycle as rb
from dnn_mppi_mpc_tpu_torch.ops.cuda.mathx import hash_normal_pair
from dnn_mppi_mpc_tpu_torch.paths import lemniscate_with_speed

# K = 12 samples leave part of a 128-thread block idle at G = 8 and 16, and
# fill a second block at G = 16
K, T, DT = 12, 4, 0.05
SIGMA = np.array([[0.5, 0.0], [0.0, 0.1]])
# by the start pose's front outline points: 2-4 of the 12 rollouts clip one
OBSTACLES = [[9.6, 4.1, 0.3], [10.5, 4.3, 0.2]]
SEED = 0x2468ACE1


@pytest.fixture(scope="module", params=[8, 16], ids=["G8", "G16"])
def emu(request, tmp_path_factory):
    """The kernel source built for the CPU with G lanes a sample;
    ``launch_bicycle`` pointed at it."""
    torch.set_num_threads(1)
    defines = () if request.param == 8 else (f"DMM_BICYCLE_GROUP={request.param}",)
    lib = cuda_emu.build(["bicycle_kernels.cu"],
                         tmp_path_factory.mktemp(f"bicycle_emu_g{request.param}"), defines)
    if lib is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    cuda_emu.torch_math(lib)
    for entry in ("dmm_bicycle_rollout_costs", "dmm_bicycle_tick"):
        getattr(lib, entry).argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    def launch(entry, args, device):
        assert device.type == "cpu"
        err = getattr(lib, entry)(ctypes.addressof(args), None)
        if err != 0:
            raise RuntimeError(f"{entry}: error {err} at launch")

    mp = pytest.MonkeyPatch()
    mp.setattr(rb, "launch", launch)
    yield lib
    mp.undo()


def _inputs(W=20, *, obstacles=True, nan_row=None, twin=None, iso=False, seed=0):
    """One rollout's inputs on the CPU: window rows [0, W) of a 100-point
    lemniscate (the race car starts at its row 0); ``nan_row``: that row
    all NaN; ``twin``: rows [twin, W) take the (x, y) of rows [0, W − twin)
    with another yaw and speed, so the nearest row always ties."""
    rng = np.random.default_rng(seed)
    window = lemniscate_with_speed(10.0, 100, device="cpu")[:W].clone()
    if nan_row is not None:
        window[nan_row] = float("nan")
    if twin is not None:
        window[twin:, :2] = window[:W - twin, :2]
        window[twin:, 2:] = window[:W - twin, 2:] + torch.tensor([1.0, 2.0])
    u = rng.normal(scale=0.1, size=(T, 2)).astype(np.float32)
    weights = [50.0, 50.0, 1.0, 20.0]
    f = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    return dict(
        eps=f(rng.multivariate_normal(np.zeros(2), SIGMA, (K, T))),
        u=f(u), a=f(10.0 * (u @ np.linalg.inv(SIGMA))), x0=f([10.0, 0.5, np.pi / 2, 3.0]),
        window=window, stage_w=f(weights), term_w=f(weights if iso else [40.0, 40.0, 2.0, 10.0]),
        u_min=f([-0.523, -2.0]), u_max=f([0.523, 2.0]),
        obstacles=f(OBSTACLES) if obstacles else None,
    )


def _both(p, *, iso=False, hash_eps=False):
    """(kernel S, plain S, the ε the kernel used): the split rollout with ε
    injected, the fused tick with hash ε."""
    vehicle = rb.vehicle_scalars()
    common = dict(dt=DT, n_exploit=0.75 * K, vehicle=vehicle, K=K, T=T, W=p["window"].shape[0],
                  iso_xy=iso)
    out = rb.launch_bicycle(
        **{k: p[k] for k in ("u", "a", "x0", "window", "stage_w", "term_w", "u_min", "u_max",
                             "obstacles")},
        eps=None if hash_eps else p["eps"], seed=torch.tensor([SEED]),
        chol_sigma=torch.tensor(np.linalg.cholesky(SIGMA), dtype=torch.float32),
        fused=hash_eps, **common)
    eps = out["eps"].transpose(0, 1).contiguous()
    want = rb.bicycle_rollout_body_plain(
        eps, *(p[k] for k in ("u", "a", "x0", "window", "stage_w", "term_w", "u_min", "u_max")),
        dt=DT, n_exploit=0.75 * K, vehicle=vehicle, obstacles=p["obstacles"], iso_xy=iso)
    return out["S"], want, eps


def _assert_bit_equal(got, want):
    print(f"S: max abs err {float((got - want).abs().nan_to_num().max()):.3e} (limit 0)")
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0, equal_nan=True)


CASES = {
    "W20 obstacles": dict(),
    "W20 obstacles iso": dict(iso=True),
    "NaN row 7": dict(nan_row=7),
    "NaN row 7 iso": dict(nan_row=7, iso=True),
    "NaN row 0": dict(nan_row=0),
    "twins 8 apart": dict(W=16, twin=8),
    "twins 10 apart iso": dict(W=20, twin=10, iso=True),
    "W13": dict(W=13),
    "W5 free": dict(W=5, obstacles=False),
    "W1 free": dict(W=1, obstacles=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_equals_plain(emu, case):
    kw = dict(CASES[case])
    iso = kw.pop("iso", False)
    p = _inputs(**kw, iso=iso)
    got, want, _ = _both(p, iso=iso)
    if case == "NaN row 0":
        assert torch.isnan(want).all()
    else:
        assert torch.isfinite(want).all()
    if p["obstacles"] is not None and case != "NaN row 0":
        assert 0 < int((want > 1e6).sum()) < K  # some rollouts hit an obstacle, not all
    _assert_bit_equal(got, want)


def test_hash_eps_drawn_a_step_a_lane(emu):
    """With hash ε (the fused tick) each lane draws every G-th step (T = 4 <
    G: lanes 0-3 draw, the others idle): the stored ε is the stream's at
    counter t·K + k (the C library's sin, cos and log against PyTorch's, a
    float32 rounding or two), and S is the plain version's on that ε, bit
    for bit."""
    p = _inputs(seed=3)
    got, want, eps = _both(p, hash_eps=True)
    z0, z1 = hash_normal_pair(SEED, 0, (T, K))
    L = np.linalg.cholesky(SIGMA).astype(np.float32)
    ref = torch.stack([L[0, 0] * z0, L[1, 0] * z0 + L[1, 1] * z1], -1).transpose(0, 1)
    torch.testing.assert_close(eps, ref, rtol=0.0, atol=1e-5)
    _assert_bit_equal(got, want)


def test_argument_block_size(emu):
    emu.dmm_bicycle_args_size.restype = ctypes.c_int
    assert emu.dmm_bicycle_args_size() == ctypes.sizeof(_build.DmmBicycleArgs)


# fields of a valid argument block that the C entry must refuse: no
# sample, no step, an empty window, a negative obstacle count, a window too
# long to stage in shared memory; and hash ε through the split rollout
REFUSED = {"K": 0, "T": 0, "W": 0, "n_obs": -1, "W staged": 4000, "eps_mode": 1}


@pytest.mark.parametrize("field", list(REFUSED))
def test_launch_refuses(emu, field, monkeypatch):
    captured = {}
    monkeypatch.setattr(rb, "launch", lambda entry, args, device: captured.update(args=args))
    _both(_inputs(W=5))
    args = captured["args"]
    setattr(args, field.split()[0], REFUSED[field])
    assert emu.dmm_bicycle_rollout_costs(ctypes.addressof(args), None) != 0
