"""The JAX package's CPU run of ``chip_smoke.py`` phase 12's ResNet-18 leg:
the CLI's collection (as tests/test_torch_train_reference.py makes it), a
ResNet-18 residual trained by JAX's ``train_residual_model`` with
train-mode BatchNorm (30 epochs, batch 128, lr 2e-3:
tests/test_resnet_dynamics.py:81-84), its residual fit over every row (gate
0.7, :94) and one 80-tick ``presets.dnn_mppi`` episode over it (K = 1 024,
T = 25; the steady-state RMS distance to the path, gate 0.5, :106), held
to ``chip_smoke.RESNET_JAX_REFERENCE`` to 1e-2. JAX runs with x64 off, as
the package runs outside this suite. Its own file, so that the worker pool
runs it beside the MLP's. Run pytest from the repository root.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc_tpu.models.learned import ResNet1D, residual_from_train_state
from dnn_mppi_mpc_tpu.train.training import TrainConfig, train_residual_model
from test_torch_train_reference import collect, fit_ratio, tracking_rmse


def test_chip_smoke_resnet_jax_references():
    import chip_smoke as cs

    with jax.enable_x64(False):
        ep = collect(cs)
        model = ResNet1D(out_dim=3, variant="18")
        tstate, hist = train_residual_model(model, ep.states, ep.controls, ep.errors,
                                            TrainConfig(**cs.RESNET_TRAIN_CFG))
        net = residual_from_train_state(model, tstate)
        got = {"resnet_fit_ratio": fit_ratio(net, ep),
               "rmse_resnet_m": tracking_rmse(cs, net, cs.RESNET_DEPLOY_TICKS, [0])}
    print("JAX CPU references:", got, "val_mse", hist["val_mse"][0], hist["val_mse"][-1])
    assert hist["val_mse"][-1] < hist["val_mse"][0]
    assert got["resnet_fit_ratio"] < cs.FIT_RATIO_RESNET and got["rmse_resnet_m"] < cs.RMSE_LIMIT
    for key, value in got.items():
        np.testing.assert_allclose(value, cs.RESNET_JAX_REFERENCE[key], rtol=0.0, atol=1e-2,
                                   err_msg=key)
    assert jnp.isfinite(jnp.asarray(hist["val_mse"])).all()
