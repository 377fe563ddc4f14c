"""Build a CUDA source of the port for the CPU, against tests/cuda_emu.h.

Every file of ``dnn_mppi_mpc_tpu_torch/csrc`` is copied into a work
directory with its launches ``kernel<<<grid, block, bytes, stream>>>(a)``
rewritten into ``emu_run([&] { kernel(a); }, grid, block, bytes, stream)``, its
``extern __shared__`` arrays pointed at the emulator's shared memory and
``<cuda_runtime.h>`` replaced by the emulator; the named ``.cu`` files are
then compiled with g++ (``-ffp-contract=off``, as nvcc's ``-fmad=false``;
``defines`` as ``-D`` flags, ``headers`` written beside the sources, as the
generated tile step's ``dmm_user_tile.cuh``) into one shared library.
:func:`torch_math` hands the library PyTorch's float sin, cos and tan, and
the atan, atan2, exp, log, tanh, pow and sigmoid a generated tile step
calls: the plain versions' own.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import torch

from dnn_mppi_mpc_tpu_torch import _build

HERE = Path(__file__).resolve().parent
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(\s*(.*?)\s*\);", re.S)
DYNAMIC_SHARED = re.compile(r"extern __shared__ float (\w+)\[\];")


def emulated(source: str) -> str:
    """``source`` rewritten for the emulator."""
    source = source.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    source = DYNAMIC_SHARED.sub(r"float* const \1 = emu_smem;", source)
    return LAUNCH.sub(r"emu_run([&] { \1(\3); }, \2);", source)


def build(names: list[str], work: Path, defines: tuple = (),
          headers: dict = None) -> ctypes.CDLL:
    """The ``.cu`` files ``names`` of csrc built for the CPU in ``work``,
    each of ``defines`` (``NAME=value``) passed as ``-D`` and each of
    ``headers`` (file name → text) written beside them; None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    for src in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        (work / src.name).write_text(emulated(src.read_text()))
    for name, text in (headers or {}).items():
        (work / name).write_text(emulated(text))
    lib = work / "libemu.so"
    run = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                          "-pthread", "-Wno-unknown-pragmas", f"-I{HERE}", f"-I{work}",
                          *(f"-D{d}" for d in defines),
                          "-x", "c++", *(str(work / n) for n in names), "-o", str(lib)],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"g++ failed on {names}:\n{run.stderr}")
    return ctypes.CDLL(str(lib))


_OPS = (torch.sin, torch.cos, torch.tan, torch.atan, torch.atan2, torch.exp, torch.log,
        torch.tanh, torch.pow, torch.sigmoid)
# sigmoid rounds otherwise for an element alone than inside a tensor on the
# CPU: it is taken inside a tensor of this many copies, as the twin's lanes are
_SIGMOID_COPIES = 64


@ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float)
def _torch_op(op, x, y):
    xt = torch.tensor([x], dtype=torch.float32)
    if op == 4:
        return torch.atan2(xt, torch.tensor([y], dtype=torch.float32)).item()
    if op == 8:
        return torch.pow(xt, y).item()
    if op == 9:
        return torch.sigmoid(xt.expand(_SIGMOID_COPIES).contiguous())[0].item()
    return _OPS[op](xt).item()


def torch_math(lib: ctypes.CDLL) -> None:
    """Point the library's sincosf and tanf, and the atan, atan2, exp, log,
    tanh, pow and sigmoid of a generated tile step, at PyTorch's (torch gives
    the same bits for an element alone as inside a tensor for all but atan2,
    pow and sigmoid; sigmoid is taken inside a tensor)."""
    ctypes.c_void_p.in_dll(lib, "emu_math").value = ctypes.cast(_torch_op, ctypes.c_void_p).value
