"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` at first use into one
shared library with a plain C ABI, ``_build/libdmm_kernels_<hash>.so``
(keyed by a hash of the sources and flags, so an edited source rebuilds),
and loaded with ctypes. Each ``.cu`` file is compiled by its own ``nvcc``,
all started together, and the objects are linked in one more call. No
PyTorch headers are involved, which keeps the build to seconds. A failed
build raises; nothing falls back.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 -std=c++17`` and
``-fmad=false``. The last one keeps nvcc from contracting a*b+c into one
FMA, so a kernel rounds operation for operation like its plain PyTorch
version; no ``--use_fast_math``, so sincosf/expf/logf/tanf stay full
precision.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-shared",)


# kOutlinePoints in csrc/bicycle_rollout.cuh: the vehicle outline's length
OUTLINE_POINTS = 9


class DmmArgs(ctypes.Structure):
    """ctypes mirror of ``struct DmmArgs`` in csrc/diffdrive_rollout.cuh."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "seed", "u", "a", "chol", "x0", "window", "stage_w", "term_w",
            "u_min", "u_max", "obstacles", "control_w", "filter_t", "eps",
            "S", "w", "w_eps", "stats", "u_new", "u_shift", "finite",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "K", "T", "W", "n_obs", "k_blk", "eps_mode", "iso_xy",
            "last_only", "obs_mode", "drift", "fuse_epilogue", "block_offset",
            "s_only",
        )
    ] + [
        (name, ctypes.c_float)
        for name in (
            "dt", "n_exploit", "k_offset", "inv_temp", "obs_radius",
            "soft_dist", "soft_w",
        )
    ]


class DmmFleetArgs(ctypes.Structure):
    """ctypes mirror of ``struct DmmFleetArgs`` in csrc/diffdrive_rollout.cuh:
    member 0's argument block and the member count B."""

    _fields_ = [("m", DmmArgs), ("B", ctypes.c_int)]


class DmmBicycleArgs(ctypes.Structure):
    """ctypes mirror of ``struct DmmBicycleArgs`` in csrc/bicycle_rollout.cuh."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "seed", "u", "a", "chol", "x0", "window", "stage_w", "term_w",
            "u_min", "u_max", "obstacles", "eps", "S", "w", "w_eps", "stats",
        )
    ] + [
        (name, ctypes.c_int) for name in ("K", "T", "W", "n_obs", "eps_mode", "iso_xy")
    ] + [
        (name, ctypes.c_float)
        for name in (
            "dt", "n_exploit", "k_offset", "inv_temp", "inv_wheel_base",
            "half_l", "half_w", "penalty",
        )
    ] + [
        ("outline_x", ctypes.c_float * OUTLINE_POINTS),
        ("outline_y", ctypes.c_float * OUTLINE_POINTS),
    ]


# DmmGenericArgs::c in csrc/generic_rollout.cuh: the tile step's constants
GENERIC_CONSTANTS = 8


class DmmGenericArgs(ctypes.Structure):
    """ctypes mirror of ``struct DmmGenericArgs`` in csrc/generic_rollout.cuh."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "seed", "u", "a", "chol", "x0", "window", "stage_w", "term_w",
            "u_min", "u_max", "obstacles", "filter_t", "eps", "S", "w", "w_eps",
            "stats", "u_new", "u_shift", "finite",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "model", "K", "T", "W", "n_track", "n_obs", "eps_mode", "last_only",
            "obs_mode", "drift", "wrap_yaw", "fuse_epilogue",
        )
    ] + [
        (name, ctypes.c_float)
        for name in (
            "dt", "n_exploit", "k_offset", "inv_temp", "obs_radius", "soft_dist", "soft_w",
        )
    ] + [("c", ctypes.c_float * GENERIC_CONSTANTS)]


# kNumQPTables in csrc/riccati_qp.cu: the QP's stage tables and dx0
QP_TABLES = 15


class DmmQPArgs(ctypes.Structure):
    """ctypes mirror of ``struct DmmQPArgs`` in csrc/riccati_qp.cu."""

    _fields_ = [
        ("mus", ctypes.c_void_p),
        ("misc", ctypes.c_void_p),
        ("tab", ctypes.c_void_p * QP_TABLES),
        ("b_stride", ctypes.c_longlong * QP_TABLES),
        ("s_stride", ctypes.c_longlong * QP_TABLES),
        ("r_stride", ctypes.c_longlong * QP_TABLES),
    ] + [(name, ctypes.c_void_p) for name in ("dX", "dU", "kkt")] + [
        (name, ctypes.c_int)
        for name in ("Bn", "N", "nx", "nu", "n_h", "num_iters", "has_S", "stage_floats")
    ]


# DMM_MLP_MAX_LAYERS in csrc/mlp_step.cu
MLP_MAX_LAYERS = 16


class DmmMlpArgs(ctypes.Structure):
    """ctypes mirror of ``struct DmmMlpArgs`` in csrc/mlp_step.cu."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("W", ctypes.c_void_p * MLP_MAX_LAYERS),
        ("b", ctypes.c_void_p * MLP_MAX_LAYERS),
        ("dims", ctypes.c_int * (MLP_MAX_LAYERS + 1)),
    ] + [(name, ctypes.c_int)
         for name in ("n_layers", "K", "bf16", "d_max", "stage_floats")]


# DMM_CHAIN_MAX_LAYERS and DMM_CHAIN_MAX_BLOCKS in csrc/dense_chain.cu
CHAIN_MAX_LAYERS = 64
CHAIN_MAX_BLOCKS = 16


class DmmChainArgs(ctypes.Structure):
    """ctypes mirror of ``struct DmmChainArgs`` in csrc/dense_chain.cu."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("W", ctypes.c_void_p * CHAIN_MAX_LAYERS),
        ("b", ctypes.c_void_p * CHAIN_MAX_LAYERS),
        ("c_in", ctypes.c_int * CHAIN_MAX_LAYERS),
        ("k_pad", ctypes.c_int * CHAIN_MAX_LAYERS),
        ("n_pad", ctypes.c_int * CHAIN_MAX_LAYERS),
        ("down", ctypes.c_int * CHAIN_MAX_BLOCKS),
    ] + [(name, ctypes.c_int * CHAIN_MAX_LAYERS) for name in ("bm", "bn")] + [
        (name, ctypes.c_void_p) for name in ("h", "r", "y0", "y1")
    ] + [
        (name, ctypes.c_int)
        for name in ("B", "B_pad", "grid", "n_layers", "n_blocks", "n_convs", "out_dim",
                     "c_max", "y_max")
    ]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdmm_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails, after all have ended."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{text}")


def build() -> Path:
    """Compile the sources into the library unless it is already there."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [str(Path(work) / f"{src.stem}.o") for src in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj] for src, obj in zip(srcs, objs)])
        lib = str(Path(work) / "lib.so")
        _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, out)  # atomic: a concurrent build sees all or nothing
    return out


@lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    lib.dmm_args_size.argtypes = []
    lib.dmm_args_size.restype = ctypes.c_int
    lib.dmm_bicycle_args_size.argtypes = []
    lib.dmm_bicycle_args_size.restype = ctypes.c_int
    lib.dmm_fleet_args_size.argtypes = []
    lib.dmm_fleet_args_size.restype = ctypes.c_int
    lib.dmm_generic_args_size.argtypes = []
    lib.dmm_generic_args_size.restype = ctypes.c_int
    lib.dmm_qp_args_size.argtypes = []
    lib.dmm_qp_args_size.restype = ctypes.c_int
    lib.dmm_mlp_args_size.argtypes = []
    lib.dmm_mlp_args_size.restype = ctypes.c_int
    lib.dmm_chain_args_size.argtypes = []
    lib.dmm_chain_args_size.restype = ctypes.c_int
    lib.dmm_chain_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.dmm_chain_occupancy.restype = ctypes.c_int
    for fn in (lib.dmm_rollout_costs, lib.dmm_mppi_tick, lib.dmm_weighted_noise_reduce,
               lib.dmm_fleet_mppi_tick, lib.dmm_bicycle_rollout_costs, lib.dmm_bicycle_tick,
               lib.dmm_generic_rollout_costs, lib.dmm_generic_tick, lib.dmm_barrier_qp,
               lib.dmm_fused_mlp, lib.dmm_resnet_chain):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for struct, size_fn in ((DmmArgs, lib.dmm_args_size),
                            (DmmFleetArgs, lib.dmm_fleet_args_size),
                            (DmmBicycleArgs, lib.dmm_bicycle_args_size),
                            (DmmGenericArgs, lib.dmm_generic_args_size),
                            (DmmQPArgs, lib.dmm_qp_args_size),
                            (DmmMlpArgs, lib.dmm_mlp_args_size),
                            (DmmChainArgs, lib.dmm_chain_args_size)):
        if size_fn() != ctypes.sizeof(struct):
            raise RuntimeError(
                f"{struct.__name__} layout mismatch: C {size_fn()} bytes, "
                f"ctypes {ctypes.sizeof(struct)} bytes"
            )
    return lib


def launch(entry: str, args: ctypes.Structure, device: torch.device) -> None:
    """Call C entry ``entry`` on the current stream of ``device``; raise on a
    non-zero ``cudaGetLastError``."""
    fn = getattr(load_kernels(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")


__all__ = [
    "CHAIN_MAX_BLOCKS",
    "CHAIN_MAX_LAYERS",
    "MLP_MAX_LAYERS",
    "OUTLINE_POINTS",
    "QP_TABLES",
    "DmmArgs",
    "DmmBicycleArgs",
    "DmmChainArgs",
    "DmmFleetArgs",
    "DmmGenericArgs",
    "DmmMlpArgs",
    "DmmQPArgs",
    "GENERIC_CONSTANTS",
    "build",
    "launch",
    "library_path",
    "load_kernels",
]
