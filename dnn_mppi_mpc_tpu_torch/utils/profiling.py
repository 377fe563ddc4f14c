"""Profiling and roofline accounting (counterpart of
``dnn_mppi_mpc_tpu/utils/profiling.py``).

* :func:`trace` — a context manager around ``torch.profiler`` (CPU and, on
  the card, CUDA activities) that writes a Chrome trace into a directory.
* :class:`Timer` — a wall-clock latency collector with p50/p90/p99.
* :func:`time_fn` — :class:`Timer` over a function, the card synchronised
  around each call, so a call's time is its work and not its enqueue.
* :func:`mppi_roofline` — the JAX package's operation and byte model of the
  diff-drive rollout, against the H100's float32 and HBM peaks.

The peaks are NVIDIA's data-sheet rates of one H100 SXM at its 700 W limit:
``chip_smoke.py`` bounds every kernel with these constants.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

from ..config import resolve_device

H100_F32_FLOPS = 67e12  # FLOP/s: float32 outside the tensor cores
H100_BF16_FLOPS = 989e12  # FLOP/s: bfloat16, dense tensor cores
H100_HBM_BYTES_PER_S = 3.35e12  # bytes/s


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """``with trace(logdir): run()`` profiles ``run`` and writes
    ``logdir/trace.json`` (Chrome trace format; chrome://tracing or
    Perfetto). On the card (the default) the CUDA activity is recorded
    beside the CPU's; ``device="cpu"`` records the CPU alone. Yields the
    profiler (``key_averages()`` for sums by kernel)."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    """Latency collector with percentile reporting.

    >>> t = Timer()
    >>> for _ in range(100):
    ...     with t:
    ...         step(...); torch.cuda.synchronize()
    >>> t.summary()  # {'p50_ms': ..., 'p99_ms': ..., 'hz': ...}

    The timer reads the host's clock: the block must wait for the card
    itself (:func:`time_fn` does)."""

    def __init__(self) -> None:
        self.samples: list[float] = []
        self._t0: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.samples.append(time.perf_counter() - self._t0)

    def percentile(self, q: float) -> float:
        s = sorted(self.samples)
        return s[min(len(s) - 1, int(len(s) * q))]

    def summary(self) -> dict:
        if not self.samples:
            return {}
        p50 = self.percentile(0.5)
        return {
            "n": len(self.samples),
            "p50_ms": p50 * 1e3,
            "p90_ms": self.percentile(0.9) * 1e3,
            "p99_ms": self.percentile(0.99) * 1e3,
            "mean_ms": sum(self.samples) / len(self.samples) * 1e3,
            "hz": 1.0 / p50,
        }


def time_fn(fn: Callable, *args, iters: int = 50, warmup: int = 2, device="cuda") -> dict:
    """The :class:`Timer` summary of ``iters`` calls of ``fn(*args)`` after
    ``warmup`` untimed ones. On the card (the default) each timed call
    starts after and ends with ``torch.cuda.synchronize``; ``device="cpu"``
    times CPU work."""
    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn(*args)
    sync()
    t = Timer()
    for _ in range(iters):
        with t:
            fn(*args)
            sync()
    return t.summary()


def mppi_roofline(
    K: int,
    T: int,
    W: int,
    dim_u: int = 2,
    n_obs: int = 0,
    hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S,
    flops: float = H100_F32_FLOPS,
) -> dict:
    """The JAX package's analytic model of the diff-drive rollout
    (``ops/cuda/rollout.py``), against the card's peaks.

    Per (sample, step): ~10 dynamics and clamp operations, ~10·W for the
    window search and ~8·n_obs for the obstacles. Bytes: ε in (K·T·dim_u·4)
    and S out (K·4). Returns the least time on each roofline axis."""
    ops = K * T * (10 + 10 * W + 8 * n_obs)
    bytes_moved = K * T * dim_u * 4 + K * 4
    t_compute = ops / flops
    t_memory = bytes_moved / hbm_bytes_per_s
    return {
        "flops": ops,
        "bytes": bytes_moved,
        "t_compute_us": t_compute * 1e6,
        "t_memory_us": t_memory * 1e6,
        "bound": "compute" if t_compute > t_memory else "memory",
        "arithmetic_intensity": ops / bytes_moved,
    }


__all__ = ["H100_BF16_FLOPS", "H100_F32_FLOPS", "H100_HBM_BYTES_PER_S", "Timer", "mppi_roofline",
           "time_fn", "trace"]
