"""The port's command line, ``python -m dnn_mppi_mpc_tpu_torch <command>``
(mirrors tests/test_cli.py): ``main([...])`` in process with ``--device
cpu``, the last stdout line parsed as JSON. ``info``; each of the six demos
runs and stays finite at small sizes; ``diff-drive-mppi --lookahead``; the
goal-seeking demo within 1 m of its goal (tests/test_cli.py:78-84); collect
→ train with a checkpoint; the bench; and what raises: ``--fused`` and
``--device cuda`` without a card, ``demo --out`` without matplotlib.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dnn_mppi_mpc_tpu_torch.cli import main as cli_main

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_cli(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(args + ["--device", "cpu"])
    out = buf.getvalue().strip()
    assert out, f"cli {args} printed nothing"
    return json.loads(out.splitlines()[-1])


def test_cli_info():
    out = _run_cli(["info"])
    assert out["backend"] == "cpu" and out["device_count"] == 1
    assert sorted(out["demos"]) == sorted(["diff-drive-mppi", "racecar-mppi", "goal-seeking-mppi",
                                           "diff-drive-nmpc", "racecar-nmpc", "four-wheel-nmpc"])
    assert out["commands"] == ["info", "demo", "bench", "collect", "train", "realtime"]
    assert out["version"]


@pytest.mark.parametrize("name,extra", [
    ("diff-drive-mppi", ["--samples", "128", "--obstacles"]),
    ("diff-drive-mppi", ["--samples", "128", "--lookahead"]),
    ("goal-seeking-mppi", ["--samples", "128", "--horizon", "25"]),
    ("racecar-mppi", ["--samples", "128", "--ticks", "10"]),
    ("diff-drive-nmpc", ["--ticks", "15"]),
    ("racecar-nmpc", ["--ticks", "5"]),
    ("four-wheel-nmpc", ["--ticks", "5"]),
], ids=["diff-drive-mppi", "diff-drive-mppi-lookahead", "goal-seeking-mppi", "racecar-mppi",
        "diff-drive-nmpc", "racecar-nmpc", "four-wheel-nmpc"])
def test_cli_demo_runs_finite(name, extra):
    out = _run_cli(["demo", name, "--ticks", "20"] + extra)
    assert out["finite"], out
    assert out["ticks_per_s"] > 0 and out["artifacts"] == []
    assert out["demo"] == name


def test_cli_lookahead_progresses_further():
    """--lookahead (the per-rollout carry, persisted) gets further along the
    line than the tick anchor over the same ticks."""
    base = ["demo", "diff-drive-mppi", "--ticks", "40", "--samples", "128"]
    anchored = _run_cli(base)
    carried = _run_cli(base + ["--lookahead"])
    assert carried["lookahead"] and not anchored["lookahead"]
    assert carried["goal_distance_final_m"] < anchored["goal_distance_final_m"], (anchored,
                                                                                   carried)


def test_cli_demo_goal_seeking_reaches_goal():
    out = _run_cli(["demo", "goal-seeking-mppi", "--ticks", "120", "--samples", "256",
                    "--horizon", "25"])
    assert out["goal_distance_final_m"] < 1.0, out


def test_cli_collect_then_train_roundtrip(tmp_path):
    data = str(tmp_path / "data.npz")
    ckpt = str(tmp_path / "state.pt")
    out = _run_cli(["collect", "--series", "2", "--ticks", "25", "--samples", "96",
                    "--out", data])
    assert out["rows"] == 2 * 25
    assert out["mean_abs_residual"] > 0  # the plant is not the nominal model
    out = _run_cli(["train", "--data", data, "--model", "mlp", "--hidden", "32", "--depth", "1",
                    "--epochs", "4", "--ckpt", ckpt])
    assert 0 < out["final_val_mse"] < 100
    assert out["checkpoint"] == ckpt and os.path.exists(ckpt)
    tree = torch.load(ckpt, weights_only=False)
    assert set(tree) == {"params", "opt_state", "in_scaler", "out_scaler"}


def test_cli_bench_smoke():
    out = _run_cli(["bench", "--k", "128", "--t", "8"])
    assert out["unit"] == "solves/s" and out["value"] > 0
    assert out["metric"] == "mppi_solves_per_s_K128_T8"
    assert out["cuda_fused_tick"] is False  # the CPU runs the scan path


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
@pytest.mark.parametrize("argv,match", [
    (["info"], "--device cpu"),
    (["demo", "diff-drive-mppi", "--ticks", "2"], "--device cpu"),
    (["bench", "--k", "128", "--t", "8"], "--device cpu"),
])
def test_cli_without_a_card_names_device_cpu(argv, match):
    with pytest.raises(RuntimeError, match=match):
        cli_main(argv)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_cli_fused_without_a_card_raises():
    with pytest.raises(RuntimeError, match="--fused"):
        cli_main(["demo", "diff-drive-mppi", "--ticks", "2", "--fused", "--device", "cpu"])


def test_cli_out_raises(tmp_path, monkeypatch):
    """On a host without matplotlib (the card's) ``demo --out`` raises
    before the demo runs: nothing written, no line printed, no fallback
    (tests/test_torch_plotting.py writes the plots where it is present)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "dnn_mppi_mpc_tpu_torch.utils.plotting", raising=False)
    buf = io.StringIO()
    with pytest.raises(ImportError, match="matplotlib"), contextlib.redirect_stdout(buf):
        cli_main(["demo", "diff-drive-mppi", "--ticks", "2", "--device", "cpu",
                  "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir()) and buf.getvalue() == ""


def test_cli_realtime_hands_its_flags_on(monkeypatch):
    from dnn_mppi_mpc_tpu_torch.runtime import realtime_bench as rb

    got = {}
    monkeypatch.setattr(rb, "main", lambda argv: got.update(argv=argv))
    cli_main(["realtime", "--ticks", "5", "--k", "256", "--t", "10", "--no-fused-plant",
              "--device", "cpu"])
    assert got["argv"] == ["--hz", "50.0", "--ticks", "5", "--k", "256", "--t", "10",
                           "--device", "cpu", "--no-fused-plant"]


def test_python_dash_m_runs_the_cli():
    """``python -m dnn_mppi_mpc_tpu_torch info --device cpu`` in a fresh
    interpreter: one JSON line last, and JAX never imported."""
    code = ("import runpy, sys; sys.argv = ['x', 'info', '--device', 'cpu'];"
            "runpy.run_module('dnn_mppi_mpc_tpu_torch', run_name='__main__');"
            "assert 'jax' not in sys.modules")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout.strip().splitlines()[-1])["backend"] == "cpu"
