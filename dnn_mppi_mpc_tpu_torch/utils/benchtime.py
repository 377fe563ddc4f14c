"""Two-length chained-tick slope estimator on the card.

Counterpart of ``dnn_mppi_mpc_tpu/utils/benchtime.py``. Run the control tick
chained n1 and n2 > n1 times and take

    per_tick = (wall(n2) − wall(n1)) / (n2 − n1)

which cancels every fixed per-chain cost. A wall is taken with CUDA events
recorded on the current stream around the chain and ended by an event
synchronize, so it is device time of work that has finished; there is no
CPU fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import torch


@dataclass(frozen=True)
class SlopeTiming:
    """Result of :func:`slope_timing`. All times in seconds."""

    tau: float  # best-wall slope: sustained per-tick time
    p50: float  # median per-tick estimate over the long-chain walls
    p99: float  # tail per-tick estimate
    n1: int
    n2: int
    walls_short: List[float]  # sorted per-chain walls at n1
    walls_long: List[float]  # sorted per-chain walls at n2

    @property
    def ticks_per_s(self) -> float:
        return 1.0 / self.tau


def cuda_event_wall(run: Callable[[], None]) -> float:
    """Seconds between CUDA events recorded before and after ``run()``."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_event_wall times the card: no CUDA device is available")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def slope_timing(
    make_runner: Callable[[int], Callable[[], None]],
    n1: int,
    n2: int,
    reps: int,
    wall: Callable[[Callable[[], None]], float] = cuda_event_wall,
) -> SlopeTiming:
    """Sustained per-tick time from two chain lengths.

    ``make_runner(n)`` returns a zero-argument callable that enqueues an
    n-tick chain; each runner runs once to warm up, then ``reps`` times
    under ``wall``."""
    if not (0 < n1 < n2):
        raise ValueError(f"need 0 < n1 < n2, got n1={n1} n2={n2}")
    run1, run2 = make_runner(n1), make_runner(n2)
    wall(run1)
    wall(run2)
    w1 = sorted(wall(run1) for _ in range(reps))
    w2 = sorted(wall(run2) for _ in range(reps))
    # a non-positive slope is noise: floor it so rates stay finite
    tau = max((w2[0] - w1[0]) / (n2 - n1), 1e-9)
    overhead = w1[len(w1) // 2] - n1 * tau
    per_tick = sorted(max((w - overhead) / n2, 1e-9) for w in w2)

    def pct(xs: List[float], q: float) -> float:
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    return SlopeTiming(
        tau=tau,
        p50=pct(per_tick, 0.50),
        p99=pct(per_tick, 0.99),
        n1=n1,
        n2=n2,
        walls_short=w1,
        walls_long=w2,
    )


__all__ = ["SlopeTiming", "cuda_event_wall", "slope_timing"]
