"""``chip_smoke.py`` phase 12's one-step compare, on the CPU: the card's
training step is held against the CPU's step taken on the card's ReLU
branches (``chip_smoke.ReluBranches``), and a branch may differ only where
its pre-activation lies within the limit of zero (``branch_differences``).
Here both sides run on the CPU, so they agree bit for bit; the tests check
that imposing a run's own branches changes nothing, that a changed branch
is counted with its margin and does change the gradients, that a branch
taken far from zero reads a margin past the limit, and that the compare of
one device with itself reads 0.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dnn_mppi_mpc_tpu_torch.models import learned as tl
from dnn_mppi_mpc_tpu_torch.train import training as ttr


@pytest.fixture(scope="module")
def resnet_batch():
    rng = np.random.default_rng(0)
    net = tl.ResNet1D(out_dim=3, variant="18", device="cpu",
                      generator=torch.Generator().manual_seed(0))
    x = torch.tensor(rng.normal(size=(32, 1, 5)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=(32, 3)), dtype=torch.float32)
    return net, x, y


def _step(net, x, y, given=None):
    m = copy.deepcopy(net)
    branches = cs.ReluBranches(given)
    with branches:
        ttr.make_train_step(m, torch.optim.SGD(m.parameters(), lr=1e-3))(x, y)
    return {k: p.grad.detach().clone() for k, p in m.named_parameters()}, branches.inputs


def _largest_rel(a, b):
    return max(float((a[k] - b[k]).abs().max() / b[k].abs().max()) for k in b)


def test_own_branches_change_nothing(resnet_batch):
    grads, inputs = _step(*resnet_batch)
    again, seen = _step(*resnet_batch, given=inputs)
    assert len(inputs) == 17  # the stem, two in each of the eight blocks
    for k in grads:
        assert torch.equal(grads[k], again[k]), k
    assert cs.branch_differences(inputs, seen) == {
        "relu_calls": 17, "branches_differ": 0, "branch_margin": 0.0}


@pytest.mark.parametrize("which", ["nearest zero", "farthest from zero"])
def test_a_changed_branch_is_counted_with_its_margin(resnet_batch, which):
    grads, inputs = _step(*resnet_batch)
    call = 5
    x = inputs[call]
    flat = x.abs().flatten()
    if which == "nearest zero":
        nonzero = torch.nonzero(flat > 0).flatten()
        at = int(nonzero[flat[nonzero].argmin()])
    else:
        at = int(flat.argmax())
    given = [t.clone() for t in inputs]
    given[call].view(-1)[at] = -given[call].view(-1)[at]
    changed, seen = _step(*resnet_batch, given=given)
    report = cs.branch_differences(given, seen)
    margin = float(flat[at] / flat.max())
    moved = _largest_rel(changed, grads)
    print(which, report, f"gradients moved {moved:.3e}")
    assert report["relu_calls"] == 17
    # the gradients follow the branch: one unit of one row changing it moves
    # them by a few per cent of each tensor's largest entry (4.6e-2 for the
    # unit nearest zero here, 9.5e-5 of its layer's largest from zero)
    assert moved > 1e-2
    if which == "nearest zero":
        assert report["branches_differ"] == 1
        assert report["branch_margin"] == pytest.approx(margin, rel=1e-6)
    else:
        # the changed branch, and those downstream that it moves across zero
        assert report["branches_differ"] > 1
        assert report["branch_margin"] == 1.0 > cs.STEP_RTOL["resnet18"]


def test_relu_call_counts_must_agree(resnet_batch):
    _, inputs = _step(*resnet_batch)
    with pytest.raises(AssertionError, match="relu calls"):
        cs.branch_differences(inputs, inputs[:-1])


@pytest.mark.parametrize("name", ["mlp", "resnet18"])
def test_step_line_on_one_device_is_exact(resnet_batch, name):
    net, x, y = resnet_batch
    if name == "mlp":
        net, x = tl.MLP(out_dim=3, hidden=32, depth=2, device="cpu",
                        generator=torch.Generator().manual_seed(0)), x[:, 0]
    opt = ttr.make_optimizer(net, ttr.TrainConfig(learning_rate=1e-3))
    ttr.make_train_step(net, opt)(x, y)
    line = cs.step_line(name, net, opt.state_dict(), ttr.TrainConfig(learning_rate=1e-3), x, y)
    print(line)
    assert line["ok"]
    assert line["relu_calls"] == (17 if name == "resnet18" else 0)
    for key in ("mse_rel_err", "grad_rel_err", "param_rel_err", "branch_margin"):
        assert line[key] == 0.0, key
    assert line["branches_differ"] == 0


def _line(direct, card_f64, cpu_f64, margin=0.0, cpu_orders=None, card64=(0.0, 0.0, 0.0)):
    keys = cs.STEP_ERRORS
    return {**dict(zip(keys, direct)), "branch_margin": margin,
            "f64": {"card": dict(zip(keys, card_f64)), "cpu": dict(zip(keys, cpu_f64)),
                    "cpu_orders": dict(zip(keys, cpu_orders or cpu_f64)),
                    "card64": dict(zip(keys, card64))}}


STEP_OK_CASES = {
    # every error within the limit against the CPU's float32 step
    "agrees with the CPU": (_line((1e-6, 4e-5, 1e-6), (1e-6, 9e-5, 1e-6), (1e-6, 1e-5, 1e-6)),
                            True),
    # past it, but no further from float64 than the CPU's float32 step, which
    # float32 cannot bring within the limit on this minibatch
    "as exact as the CPU": (_line((1e-6, 4.6e-4, 1e-6), (1e-6, 2.1e-4, 1e-6),
                                  (1e-6, 3.4e-4, 1e-6)), True),
    "within the limit of float64": (_line((1e-6, 5.3e-5, 1e-6), (1e-6, 3.0e-5, 1e-6),
                                          (1e-6, 2.7e-5, 1e-6)), True),
    # past it against the CPU and further from float64 than the CPU's step,
    # within the spread of float32's draws
    "further than the CPU": (_line((1e-6, 9e-5, 1e-6), (1e-6, 9.6e-5, 1e-6),
                                   (1e-6, 6.3e-5, 1e-6)), True),
    "past it, the CPU exact": (_line((1e-6, 6e-5, 1e-6), (1e-6, 6e-5, 1e-6),
                                     (1e-6, 1e-6, 1e-6)), False),
    # a branch taken far from zero fails whatever the errors
    "branch far from zero": (_line((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                                   margin=1e-3), False),
    # the compare that failed a run on an H100, had the CPU taken its step
    # in the minibatch's order alone: 4.4× that one draw (the row orders
    # are what bound such a draw)
    "the refused run": (_line((0.0, 1.35e-4, 3.3e-6), (1.0e-7, 1.72e-4, 4.1e-6),
                              (1.0e-7, 3.87e-5, 9.2e-7)), False),
    # a compare of tools/step_compare_spread.py: past the CPU's farthest
    # step over the row orders, within STEP_SPREAD times it
    "within the spread over row orders": (
        _line((1.72e-6, 2.0e-4, 1.58e-6), (6.88e-7, 1.149e-4, 9.60e-7),
              (1.03e-6, 8.49e-5, 6.24e-7), margin=1.53e-6,
              cpu_orders=(1.03e-6, 9.04e-5, 7.20e-7), card64=(4.2e-15, 4.6e-13, 3.8e-15)), True),
    "past the spread over row orders": (
        _line((1.72e-6, 2.0e-4, 1.58e-6), (6.88e-7, 4.0e-4, 9.60e-7),
              (1.03e-6, 8.49e-5, 6.24e-7), cpu_orders=(1.03e-6, 9.04e-5, 7.20e-7)), False),
    # the card's float64 step must be the CPU's: a different function fails
    # however close its float32 step lies
    "float64 step apart": (_line((1e-6, 4e-5, 1e-6), (1e-6, 9e-5, 1e-6), (1e-6, 1e-5, 1e-6),
                                 card64=(1e-12, 3e-6, 1e-12)), False),
}


@pytest.mark.parametrize("case", list(STEP_OK_CASES))
def test_step_ok_rule(case):
    """``step_ok``: the card's float64 step the CPU's, and its float32 step
    against the CPU's at the limit, or, where float32 cannot resolve the
    step to the limit, no further from the float64 step than
    ``STEP_SPREAD`` times the farthest of the CPU's float32 steps over the
    row orders (the figures of the cases are measured ones but the two
    past a limit, tools/step_compare_spread.py and chip_smoke.py phase 12)."""
    line, want = STEP_OK_CASES[case]
    assert cs.step_ok(line, cs.STEP_RTOL["resnet18"]) is want


def test_step_line_reports_the_float64_step(resnet_batch):
    """On one device the card's and the CPU's float32 steps are the same
    step: both stand as far from the float64 step, within float32 rounding
    of it."""
    net, x, y = resnet_batch
    opt = ttr.make_optimizer(net, ttr.TrainConfig(learning_rate=1e-3))
    ttr.make_train_step(net, opt)(x, y)
    line = cs.step_line("resnet18", net, opt.state_dict(), ttr.TrainConfig(learning_rate=1e-3),
                        x, y)
    assert line["f64"]["card"] == line["f64"]["cpu"]
    assert 0.0 < line["f64"]["cpu"]["grad_rel_err"] < 1e-4
    # the card's float64 step is the CPU's here, and the row orders are
    # other float32 steps at float32's distance from the float64 step
    assert line["f64"]["card64"] == {k: 0.0 for k in cs.STEP_ERRORS}
    assert line["f64"]["orders"] == cs.STEP_ORDERS + 1
    for k in cs.STEP_ERRORS:
        assert line["f64"]["cpu"][k] <= line["f64"]["cpu_orders"][k] < 1e-4, k


def test_row_orders_are_the_same_step(resnet_batch):
    """A permutation of the minibatch's rows, its ReLU branches permuted
    alike, is the same step: in float64 it lands on the original order's
    within float64 rounding, and its recorded branches are the original's
    permuted."""
    net, x, y = resnet_batch
    cfg = ttr.TrainConfig(learning_rate=1e-3)
    opt = ttr.make_optimizer(net, cfg)
    ttr.make_train_step(net, opt)(x, y)
    state = opt.state_dict()
    ref = cs.step_run(net, state, cfg, x, y, "cpu64")
    order = cs.step_orders(x.shape[0], 1)[0]
    assert not torch.equal(order, torch.arange(x.shape[0]))
    moved = cs.step_run(net, state, cfg, x, y, "cpu64", given=ref[3], order=order)
    assert max(cs.step_errs(moved, ref).values()) < 1e-12
    for seen, mine in zip(moved[3], ref[3]):
        assert torch.equal(seen > 0, mine[order] > 0)

