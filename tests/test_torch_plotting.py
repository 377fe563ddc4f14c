"""The port's vendored plots (``utils/plotting.py``) and ``demo --out``, on
the CPU.

* the copy equals the JAX package's: the same syntax tree but for the
  docstrings, and every plot, both animations among them, written to the
  same bytes from the same seeded inputs;
* ``demo diff-drive-mppi --out DIR --device cpu`` writes the JAX command
  line's two PNGs (``<name>_trajectory.png``, ``<name>_controls.png``),
  non-empty, and lists them as its artifacts;
* with matplotlib hidden (``sys.modules["matplotlib"] = None``) the module
  and ``demo --out`` raise ``ImportError`` naming matplotlib: no fallback.
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from dnn_mppi_mpc_tpu.utils import plotting as jplot
from dnn_mppi_mpc_tpu_torch.cli import main as cli_main
from dnn_mppi_mpc_tpu_torch.utils import plotting as tplot

REPO = Path(__file__).resolve().parents[1]
PLOTTING = "dnn_mppi_mpc_tpu_torch.utils.plotting"


def _code_without_docstrings(path: Path) -> str:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


def test_vendored_plotting_is_the_jax_packages_code():
    assert (_code_without_docstrings(REPO / "dnn_mppi_mpc_tpu_torch/utils/plotting.py")
            == _code_without_docstrings(REPO / "dnn_mppi_mpc_tpu/utils/plotting.py"))
    assert tplot.__all__ == jplot.__all__


def _inputs():
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 2.0, 12)
    states = np.stack([t, np.sin(t), 0.3 * t, 1.0 + 0.1 * t], axis=1)
    return dict(
        states=states,
        controls=rng.normal(size=(12, 2)),
        ref=np.stack([t, np.sin(t) + 0.1], axis=1),
        sampled=rng.normal(size=(5, 8, 2)).cumsum(axis=1),
        planned=rng.normal(size=(12, 6, 2)).cumsum(axis=1),
        obstacles=np.array([[0.5, 0.4, 0.2], [1.5, 1.1, 0.3]]),
        history={"train_mse": [1.0, 0.5, 0.2], "val_mse": [1.1, 0.6, 0.3],
                 "train_mae": [0.8, 0.4, 0.2], "val_mae": [0.9, 0.5, 0.3]},
    )


PLOTS = {
    "plot_trajectory": lambda m, p, d: m.plot_trajectory(
        p, d["states"][:, :3], ref_path=d["ref"], sampled_trajs=d["sampled"],
        optimal_traj=d["planned"][0], obstacles=d["obstacles"], title="t"),
    "plot_controls": lambda m, p, d: m.plot_controls(p, d["controls"], 0.1, labels=["v", "w"]),
    "plot_training_curves": lambda m, p, d: m.plot_training_curves(p, d["history"]),
    "save_animation": lambda m, p, d: m.save_animation(
        p, d["states"][:4, :3], ref_path=d["ref"], planned_trajs=d["planned"],
        obstacles=d["obstacles"], fps=5),
    "save_racecar_animation": lambda m, p, d: m.save_racecar_animation(
        p, d["states"][:3], d["controls"][:3], ref_path=d["ref"], fps=5),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_vendored_plots_bit_equal_to_jax(name, tmp_path):
    ext = "gif" if name.startswith("save_") else "png"
    files = {}
    for tag, module in (("port", tplot), ("jax", jplot)):
        files[tag] = tmp_path / f"{tag}.{ext}"
        PLOTS[name](module, str(files[tag]), _inputs())
    port, jax_bytes = files["port"].read_bytes(), files["jax"].read_bytes()
    assert len(port) > 1000
    assert port == jax_bytes


def _run_cli(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(args + ["--device", "cpu"])
    return buf.getvalue().strip()


def test_demo_out_writes_the_jax_cli_plots(tmp_path):
    out = tmp_path / "plots"
    line = json.loads(_run_cli(["demo", "diff-drive-mppi", "--ticks", "10", "--samples", "128",
                                "--out", str(out)]).splitlines()[-1])
    want = [out / "diff-drive-mppi_trajectory.png", out / "diff-drive-mppi_controls.png"]
    assert line["artifacts"] == [str(p) for p in want]
    for png in want:
        data = png.read_bytes()
        assert data.startswith(b"\x89PNG") and len(data) > 1000, png


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib as a host without it sees it: every import of it raises."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, PLOTTING, raising=False)


def test_plotting_without_matplotlib_raises(no_matplotlib):
    with pytest.raises(ImportError, match="matplotlib"):
        importlib.import_module(PLOTTING)


def test_demo_out_without_matplotlib_raises(no_matplotlib, tmp_path):
    with pytest.raises(ImportError, match="matplotlib"):
        _run_cli(["demo", "diff-drive-nmpc", "--ticks", "2", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
