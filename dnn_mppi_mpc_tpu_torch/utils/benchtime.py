"""Two-length chained-tick slope estimator on the card.

Counterpart of ``dnn_mppi_mpc_tpu/utils/benchtime.py``. Run the control tick
chained n1 and n2 > n1 times and take

    per_tick = (wall(n2) − wall(n1)) / (n2 − n1)

which cancels every fixed per-chain cost. A wall is taken with CUDA events
recorded on the current stream around the chain and ended by an event
synchronize, so it is device time of work that has finished; there is no
CPU fallback (:func:`host_wall` times the CPU's runs, whose ops are
synchronous).

:func:`scan_chain_runner` is the counterpart of JAX's
``scan_chain_runner`` (``dnn_mppi_mpc_tpu/utils/benchtime.py:100``): where
JAX chains n ticks on the device as one jitted ``lax.scan``, the card
replays one tick captured as a CUDA graph (:class:`ChainGraph`) n times, so
the slope measures the tick and not the host's enqueue of its ops.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, List, Sequence

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


def host_wall(run: Callable[[], None]) -> float:
    """Seconds of ``run()`` on the host's clock."""
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def _leaves(state) -> List[str]:
    """The names of the tensor fields of a dataclass state."""
    return [f.name for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)]


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class ChainGraph:
    """One tick of ``body(params, state, x) -> ((state, x), y)`` over static
    buffers, captured once as a CUDA graph on the card.

    ``state`` is a dataclass of tensors (an ``MPPIState``, an ``NMPCState``,
    a fleet's with its leading B); ``self.state`` and ``self.x`` hold copies
    of ``st0`` and ``x0`` that each :meth:`replay` advances in place: the
    tick is ``body`` and then a copy of every tensor leaf of the new state
    and of the new x into the buffers (a new leaf that shares memory with a
    buffer is cloned first, so no buffer is read after it is written).
    :meth:`replay` returns the tick's y, a tensor of the graph's pool that
    the next replay overwrites.

    On the card the tick runs twice on a side stream before the capture
    (the kernels' build, their first launches, the solvers' one-time host
    checks), the buffers are restored, and then the capture records the
    launches alone (``runtime.realtime_bench.GraphedTick`` is the real-time
    loop's tick + plant as one). Each
    ``torch.Generator`` the tick draws from must be in ``generators``: it is
    registered with the graph, so each replay advances it as an eager tick
    does. A tick that cannot be captured (a host sync, a pageable
    host-to-device copy, an allocation outside the graph's pool) raises;
    nothing falls back to eager ticks. On the CPU, where CUDA graphs do not
    exist, :meth:`replay` runs the tick eagerly."""

    def __init__(self, body, params, st0, x0: torch.Tensor,
                 generators: Sequence[torch.Generator] = ()):
        self.body, self.params = body, params
        self.names = _leaves(st0)
        self.state = dataclasses.replace(
            st0, **{n: getattr(st0, n).clone() for n in self.names})
        self.x = x0.clone()
        self.y = None
        self.graph = None
        if not x0.is_cuda:
            return
        dev = x0.device
        start = [b.clone() for b in self.buffers()]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._tick()
        torch.cuda.current_stream(dev).wait_stream(side)
        for b, s in zip(self.buffers(), start):
            b.copy_(s)
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        # thread_local: a watchdog thread (NCCL's) may query its events while
        # this thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.y = self._tick()

    def buffers(self) -> List[torch.Tensor]:
        """The state's tensor leaves, then x: the tick's static buffers."""
        return [getattr(self.state, n) for n in self.names] + [self.x]

    def _tick(self):
        (st, x), y = self.body(self.params, self.state, self.x)
        bufs = self.buffers()
        new = [getattr(st, n) for n in self.names] + [x]
        new = [t.clone() if t is not b and any(_shares_storage(t, c) for c in bufs) else t
               for t, b in zip(new, bufs)]
        for b, t in zip(bufs, new):
            if t is not b:
                b.copy_(t)
        return y

    def load(self, st0, x0: torch.Tensor) -> None:
        """Copy ``st0`` and ``x0`` into the buffers."""
        for n in self.names:
            getattr(self.state, n).copy_(getattr(st0, n))
        self.x.copy_(x0)

    def replay(self):
        """One tick; returns its y."""
        if self.graph is None:
            self.y = self._tick()
        else:
            self.graph.replay()
        return self.y


def scan_chain_runner(body, params, st0, x0: torch.Tensor, n: int, sync=None,
                      generators: Sequence[torch.Generator] = ()):
    """A zero-argument runner of n ticks of ``body(params, state, x) ->
    ((state, x), y)`` chained from ``st0`` and ``x0``; it returns the final
    x and the last y (tensors of the runner's buffers, which its next call
    overwrites). The contract of JAX's ``scan_chain_runner``.

    On the card one tick is captured as a CUDA graph (:class:`ChainGraph`,
    with ``generators``) when the runner is made; each call copies st0 and
    x0 into its buffers and replays the graph n times. A replay costs the
    host a few µs and the start copy cancels in a slope; n ticks are never
    captured as one graph, which would hold n times the tick's nodes. On the
    CPU the runner runs ``body`` eagerly n times. ``sync``, when given, is
    called on (x, y) after the chain: JAX's place for its fetch barrier. A
    wall of :func:`cuda_event_wall` needs none, since its end event's
    synchronize is the barrier."""
    tick = ChainGraph(body, params, st0, x0, generators)

    def run():
        tick.load(st0, x0)
        y = None
        for _ in range(n):
            y = tick.replay()
        if sync is not None:
            sync(tick.x, y)
        return tick.x, y

    run.tick = tick
    return run


__all__ = ["ChainGraph", "SlopeTiming", "cuda_event_wall", "host_wall", "scan_chain_runner",
           "slope_timing"]
