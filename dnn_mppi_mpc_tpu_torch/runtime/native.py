"""ctypes bindings for the dmmrt native runtime (counterpart of
``dnn_mppi_mpc_tpu/runtime/native.py``).

``src/dmmrt.cpp`` (the rate pacer, the telemetry ring and the state
channel, vendored from the JAX package) is compiled with the host C++
compiler at first use into ``dnn_mppi_mpc_tpu_torch/_build/``, keyed by a
hash of the source, and bound with ctypes (plain C ABI). Without a compiler
:func:`build_library` raises ``RuntimeError``: there is no Python-timing
fallback, since the pacer is what the real-time loop measures.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .._build import BUILD_DIR

SRC_DIR = Path(__file__).resolve().parent / "src"
SOURCE = SRC_DIR / "dmmrt.cpp"
STRESS_SOURCE = SRC_DIR / "stress_dmmrt.cpp"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def compiler() -> str:
    """The host C++ compiler ($CXX, else g++ or c++); ``RuntimeError``
    without one."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("the real-time runtime needs a host C++ compiler (g++): none found; "
                       "set CXX to one")


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libdmmrt_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``src/dmmrt.cpp`` into ``_build/`` unless it is already there
    (an atomic rename, so a concurrent build sees all or nothing)."""
    out = library_path()
    with _LOCK:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        run = subprocess.run([compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{run.stderr}")
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.pacer_create.restype = p
    lib.pacer_create.argtypes = [i64]
    lib.pacer_wait.restype = i64
    lib.pacer_wait.argtypes = [p]
    for f in ("pacer_ticks", "pacer_overruns", "pacer_worst_late_ns", "pacer_mean_late_ns"):
        getattr(lib, f).restype = i64
        getattr(lib, f).argtypes = [p]
    lib.pacer_destroy.argtypes = [p]
    lib.ring_create.restype = p
    lib.ring_create.argtypes = [i64, i64]
    lib.ring_push.restype = ctypes.c_int32
    lib.ring_push.argtypes = [p, ctypes.c_void_p]
    lib.ring_pop.restype = i64
    lib.ring_pop.argtypes = [p, ctypes.c_void_p, i64]
    lib.ring_dropped.restype = i64
    lib.ring_dropped.argtypes = [p]
    lib.ring_destroy.argtypes = [p]
    lib.chan_create.restype = p
    lib.chan_create.argtypes = [i64]
    lib.chan_write.argtypes = [p, ctypes.c_void_p]
    lib.chan_read.restype = i64
    lib.chan_read.argtypes = [p, ctypes.c_void_p]
    lib.chan_destroy.argtypes = [p]
    _lib = lib
    return lib


def _handle(obj):
    """The native handle, or ``RuntimeError`` once closed (a NULL handle
    through ctypes would crash in C)."""
    h = obj._h
    if not h:
        raise RuntimeError(f"{type(obj).__name__} is closed")
    return h


class RatePacer:
    """Absolute-deadline loop pacing (native ``clock_nanosleep``)."""

    def __init__(self, hz: float) -> None:
        if not hz > 0:
            raise ValueError(f"hz must be positive, got {hz}")
        self._lib = load_library()
        self._h = self._lib.pacer_create(int(1e9 / hz))
        if not self._h:
            raise MemoryError("pacer_create failed")

    def wait(self) -> int:
        """Sleep until the next deadline; returns the lateness in ns."""
        return self._lib.pacer_wait(_handle(self))

    @property
    def stats(self) -> dict:
        h = _handle(self)
        return {
            "ticks": self._lib.pacer_ticks(h),
            "overruns": self._lib.pacer_overruns(h),
            "worst_late_ns": self._lib.pacer_worst_late_ns(h),
            "mean_late_ns": self._lib.pacer_mean_late_ns(h),
        }

    def close(self) -> None:
        if self._h:
            self._lib.pacer_destroy(self._h)
            self._h = None


class TelemetryRing:
    """Lock-free single-producer single-consumer ring of fixed-dtype
    records (the control loop's telemetry)."""

    def __init__(self, capacity: int, dtype: np.dtype) -> None:
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self._lib = load_library()
        self.dtype = np.dtype(dtype)
        self._h = self._lib.ring_create(capacity, self.dtype.itemsize)
        if not self._h:
            raise MemoryError("ring_create failed")

    def push(self, record: np.ndarray) -> bool:
        """False when the ring is full (the record is dropped and counted)."""
        rec = np.ascontiguousarray(record, dtype=self.dtype)
        return bool(self._lib.ring_push(_handle(self), rec.ctypes.data_as(ctypes.c_void_p)))

    def pop(self, max_records: int) -> np.ndarray:
        out = np.empty(max_records, dtype=self.dtype)
        n = self._lib.ring_pop(_handle(self), out.ctypes.data_as(ctypes.c_void_p), max_records)
        return out[:n]

    @property
    def dropped(self) -> int:
        return self._lib.ring_dropped(_handle(self))

    def close(self) -> None:
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None


class StateChannel:
    """Seqlock double buffer: a wait-free writer, readers that see whole
    snapshots."""

    def __init__(self, dtype: np.dtype) -> None:
        self._lib = load_library()
        self.dtype = np.dtype(dtype)
        self._h = self._lib.chan_create(self.dtype.itemsize)
        if not self._h:
            raise MemoryError("chan_create failed")

    def write(self, value: np.ndarray) -> None:
        v = np.ascontiguousarray(value, dtype=self.dtype)
        self._lib.chan_write(_handle(self), v.ctypes.data_as(ctypes.c_void_p))

    def read(self) -> Optional[np.ndarray]:
        """The last snapshot written, or None before the first write."""
        out = np.empty(1, dtype=self.dtype)
        seq = self._lib.chan_read(_handle(self), out.ctypes.data_as(ctypes.c_void_p))
        if seq < 0:
            return None
        return out[0]

    def close(self) -> None:
        if self._h:
            self._lib.chan_destroy(self._h)
            self._h = None


__all__ = ["RatePacer", "StateChannel", "TelemetryRing", "build_library", "compiler",
           "library_path", "load_library"]
