"""The port's real-time runtime (mirrors tests/test_runtime.py and
tests/test_runtime_stress.py): the vendored native library builds into
``dnn_mppi_mpc_tpu_torch/_build/`` and raises without a compiler; the
pacer's rate and stats; the telemetry ring's order, its drops when full and
a threaded single-producer run; the state channel's snapshots;
``RealtimeLoop`` with a fake plant and the kill switch; the stress harness
in its optimised build (its ThreadSanitizer form stays ``slow``); and
``run_realtime_e2e`` on the CPU with its output keys. The graph against
eager ticks is a card test (skipped here; ``chip_smoke.py`` runs it).
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu_torch import _build
from dnn_mppi_mpc_tpu_torch.runtime import native
from dnn_mppi_mpc_tpu_torch.runtime.loop import RealtimeLoop
from dnn_mppi_mpc_tpu_torch.runtime.native import (
    RatePacer,
    StateChannel,
    TelemetryRing,
    build_library,
)

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


@needs_gxx
def test_library_builds_into_the_build_directory():
    path = build_library()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libdmmrt_")
    assert path.exists() and build_library() == path  # built once


def test_no_compiler_raises(monkeypatch, tmp_path):
    """Without a C++ compiler the build raises: there is no Python-timing
    fallback."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        native.build_library()


@needs_gxx
def test_pacer_rate_and_stats():
    pacer = RatePacer(hz=200.0)  # 5 ms period
    t0 = time.perf_counter()
    n = 40
    for _ in range(n):
        pacer.wait()
    elapsed = time.perf_counter() - t0
    assert 0.15 < elapsed < 0.6, elapsed  # 40 ticks at 5 ms ≈ 200 ms
    assert pacer.stats["ticks"] == n
    pacer.close()
    with pytest.raises(RuntimeError, match="closed"):
        pacer.wait()
    with pytest.raises(ValueError, match="positive"):
        RatePacer(hz=0.0)


@needs_gxx
def test_ring_push_pop_order():
    dtype = np.dtype([("a", np.int64), ("b", np.float32)])
    ring = TelemetryRing(64, dtype)
    for i in range(10):
        rec = np.zeros((), dtype=dtype)
        rec["a"] = i
        rec["b"] = i * 0.5
        assert ring.push(rec)
    out = ring.pop(100)
    assert out.shape[0] == 10
    np.testing.assert_array_equal(out["a"], np.arange(10))
    np.testing.assert_array_equal(out["b"], np.arange(10) * 0.5)
    ring.close()
    with pytest.raises(ValueError, match="power of two"):
        TelemetryRing(48, dtype)


@needs_gxx
def test_ring_drops_when_full_never_blocks():
    dtype = np.dtype([("a", np.int64)])
    ring = TelemetryRing(8, dtype)
    rec = np.zeros((), dtype=dtype)
    oks = [ring.push(rec) for _ in range(12)]
    assert sum(oks) == 8
    assert ring.dropped == 4
    ring.close()


@needs_gxx
def test_ring_threaded_spsc_integrity():
    """A producer thread pushes a sequence, retrying a full ring; the
    consumer reads it in order with no gap, and ``dropped`` counts exactly
    the producer's rejections."""
    dtype = np.dtype([("seq", np.int64)])
    ring = TelemetryRing(1024, dtype)
    N = 20000
    received = []
    rejections = 0

    def producer():
        nonlocal rejections
        rec = np.zeros((), dtype=dtype)
        i = 0
        while i < N:
            rec["seq"] = i
            if ring.push(rec):
                i += 1
            else:
                rejections += 1

    def consumer():
        while len(received) < N:
            out = ring.pop(256)
            if out.shape[0]:
                received.extend(out["seq"].tolist())

    tp = threading.Thread(target=producer, daemon=True)
    tc = threading.Thread(target=consumer, daemon=True)
    tp.start(), tc.start()
    tp.join(timeout=30), tc.join(timeout=30)
    assert received == list(range(N))
    assert ring.dropped == rejections
    ring.close()


@needs_gxx
def test_state_channel_snapshot_consistency():
    dtype = np.dtype([("x", np.float64, (3,)), ("stamp", np.int64)])
    chan = StateChannel(dtype)
    assert chan.read() is None  # nothing written yet
    v = np.zeros((), dtype=dtype)
    v["x"] = [1.0, 2.0, 3.0]
    v["stamp"] = 42
    chan.write(v)
    got = chan.read()
    np.testing.assert_array_equal(got["x"], [1.0, 2.0, 3.0])
    assert got["stamp"] == 42

    stop = threading.Event()
    torn = []

    def writer():
        w = np.zeros((), dtype=dtype)
        i = 0
        while not stop.is_set():
            w["x"] = [i, i, i]  # all three always match
            w["stamp"] = i
            chan.write(w)
            i += 1

    def reader():
        while not stop.is_set():
            g = chan.read()
            if g is not None and not g["x"][0] == g["x"][1] == g["x"][2]:
                torn.append(g)

    tw = threading.Thread(target=writer)
    trs = [threading.Thread(target=reader) for _ in range(2)]
    tw.start()
    [t.start() for t in trs]
    time.sleep(0.3)
    stop.set()
    tw.join(), [t.join() for t in trs]
    assert not torn, f"torn reads: {torn[:3]}"
    chan.close()


@needs_gxx
def test_realtime_loop_with_fake_plant():
    """Fifty paced ticks of a constant controller on a fake plant (numpy
    state), then the same loop with torch tensors passed through as they
    are (``convert_arrays=False``, telemetry records timing only)."""
    state = {"x": np.zeros(3)}

    def apply_control(u):
        state["x"] = state["x"] + 0.01 * np.array([u[0], u[1], 0.0])

    loop = RealtimeLoop(lambda x: np.array([1.0, -1.0]), lambda: state["x"], apply_control,
                        hz=500.0)
    stats = loop.run(50)
    assert stats["ticks"] == 50 and stats["ticks_run"] == 50
    tel = loop.drain_telemetry()
    loop.close()
    assert tel.shape[0] == 50
    assert np.all(np.diff(tel["tick"]) == 1)
    np.testing.assert_array_equal(tel["control"][:, :2], np.tile([1.0, -1.0], (50, 1)))
    assert state["x"][0] > 0.4  # controls applied (warm-up call not applied)

    held = {"x": torch.zeros(3)}
    seen = []

    def t_apply(u):
        seen.append(u)
        held["x"] = held["x"] + 0.01 * u

    loop = RealtimeLoop(lambda x: torch.ones(3), lambda: held["x"], t_apply, hz=500.0,
                        convert_arrays=False, rt_scheduling=False)
    loop.run(20)
    tel = loop.drain_telemetry()
    loop.close()
    assert all(isinstance(u, torch.Tensor) for u in seen) and len(seen) == 20
    assert float(held["x"][0]) == pytest.approx(0.2)
    assert not tel["state"].any()  # timing only


@needs_gxx
def test_kill_switch_stops_loop_gracefully():
    """SIGINT mid-run stops the paced loop at a tick boundary; the stats
    record the early stop; a loop handed the set event exits at once."""
    def controller(x):
        return np.zeros(2)

    loop = RealtimeLoop(controller, lambda: np.zeros(3), lambda u: None, hz=200.0,
                        rt_scheduling=False)
    stop = loop.install_kill_switch()
    killer = threading.Timer(0.15, lambda: os.kill(os.getpid(), signal.SIGINT))
    killer.start()
    try:
        stats = loop.run(100_000)  # ~8 min without the switch
    finally:
        killer.cancel()
        loop.close()
    assert stats["stopped_by_operator"] is True
    assert 0 < stats["ticks_run"] < 100_000
    assert stop.is_set()
    loop2 = RealtimeLoop(controller, lambda: np.zeros(3), lambda u: None, hz=200.0,
                         rt_scheduling=False)
    loop2._stop = stop
    try:
        stats2 = loop2.run(50)
    finally:
        loop2.close()
    assert stats2["ticks_run"] == 0 and stats2["stopped_by_operator"]


@needs_gxx
def test_pacer_jitter_p99_within_50hz_period():
    """The host side of the 50 Hz claim: over 100 deadlines the pacer's p99
    lateness stays within the 20 ms period and its median under 2 ms, under
    ``realtime_scheduling`` (GC frozen; FIFO where permitted)."""
    from dnn_mppi_mpc_tpu_torch.runtime.loop import realtime_scheduling

    with realtime_scheduling():
        pacer = RatePacer(hz=50.0)
        late = np.array([pacer.wait() for _ in range(100)], dtype=np.int64)
        pacer.close()
    p99 = np.percentile(late, 99)
    assert p99 < 20e6, f"p99 lateness {p99 / 1e6:.2f} ms exceeds the 20 ms period"
    assert np.median(late) < 2e6, f"median lateness {np.median(late) / 1e6:.2f} ms"


def _stress(tmp_path, flags, args):
    exe = str(tmp_path / "stress")
    subprocess.run(["g++", "-std=c++17", "-pthread", *flags, "-o", exe, str(native.SOURCE),
                    str(native.STRESS_SOURCE)], check=True, capture_output=True)
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1")
    proc = subprocess.run([exe, *map(str, args)], capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout
    return proc


@needs_gxx
def test_stress_optimized(tmp_path):
    """The vendored stress harness, -O2: the ring's FIFO, exactly-once and
    payload checks, the seqlock's torn-snapshot check, the pacer's
    accounting."""
    _stress(tmp_path, ["-O2"], [500000, 300000, 2])


@needs_gxx
@pytest.mark.slow
def test_stress_tsan(tmp_path):
    """The same invariants under ThreadSanitizer; any data race fails."""
    try:
        proc = _stress(tmp_path, ["-O1", "-g", "-fsanitize=thread"], [60000, 30000, 1])
    except subprocess.CalledProcessError as e:  # pragma: no cover
        pytest.skip(f"TSAN unavailable: {e.stderr[:200]}")
    except AssertionError as e:  # pragma: no cover
        if "ThreadSanitizer:" in str(e) and "data race" not in str(e):
            pytest.skip(f"TSAN cannot run here: {str(e)[:200]}")
        raise
    assert "WARNING: ThreadSanitizer" not in proc.stderr


E2E_KEYS = ("metric", "hz", "ticks", "K", "T", "device", "solver_path", "ack_p50_ms",
            "ack_p99_ms", "ack_max_ms", "ack_p99_ex_stall_ms", "late_p50_ms", "late_p99_ms",
            "late_max_ms", "misses_per_10k", "pacer_overruns", "rt_scheduling", "device_pace",
            "all_ticks_executed", "device_fits_budget", "spike_ticks", "meets_budget_p99")


@needs_gxx
@pytest.mark.parametrize("fused_plant", [True, False], ids=["fused", "eager"])
def test_realtime_e2e_cpu_smoke(fused_plant):
    """The end-to-end measurement on the CPU (the scan path, no traced
    segment): JAX's output keys but the tunnel's, the ticks run, and the
    plant advanced."""
    from dnn_mppi_mpc_tpu_torch.runtime.realtime_bench import run_realtime_e2e

    out = run_realtime_e2e(hz=200.0, ticks=40, K=256, T=10, fused_plant=fused_plant,
                           device="cpu")
    for key in E2E_KEYS:
        assert key in out, key
    assert "tunnel_defers_execution" not in out
    assert out["ticks"] == 40 and out["device"] == "cpu"
    assert out["device_pace"] is None and out["graph"] is False
    assert out["solver_path"] == "scan"
    assert out["ack_p50_ms"] > 0.0


def test_realtime_main_parses_its_flags(monkeypatch, capsys):
    """``main`` hands its flags to ``run_realtime_e2e`` and prints one JSON
    line last."""
    from dnn_mppi_mpc_tpu_torch.runtime import realtime_bench as rb

    got = {}
    monkeypatch.setattr(rb, "run_realtime_e2e", lambda **kw: got.update(kw) or {"ok": 1})
    rb.main(["--hz", "100", "--ticks", "7", "--k", "256", "--t", "10", "--no-fused-plant",
             "--device", "cpu"])
    assert got == dict(hz=100.0, ticks=7, K=256, T=10, fused_plant=False, device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == '{"ok": 1}'


@pytest.mark.cuda
def test_graph_replays_equal_eager_ticks():
    """On the card: 10 replays of the captured tick + plant against 10
    eager ticks from the same state, bit for bit (u, x, key, index)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dnn_mppi_mpc_tpu_torch import presets
    from dnn_mppi_mpc_tpu_torch.runtime.realtime_bench import GraphedTick
    from dnn_mppi_mpc_tpu_torch.solvers.mppi import MPPISolver

    cfg, params, step, stage, terminal = presets.flagship(10240, 50, "cuda")
    solver = MPPISolver(cfg, step, stage, terminal, fused_tick=True, iso_xy=True)
    st, x = solver.init([0, 3]), torch.zeros(3, device="cuda")
    g = GraphedTick(solver, params, step, st, x)
    for _ in range(10):
        g.replay()
        u0, st, _ = solver.step(params, st, x)
        x = step(x, u0)
    for a, b in ((g.state.u_prev, st.u_prev), (g.x, x), (g.state.key, st.key),
                 (g.state.waypoint_idx, st.waypoint_idx)):
        assert torch.equal(a, b)
