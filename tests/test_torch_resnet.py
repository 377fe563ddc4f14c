"""The port's ResNet dense chain (``ops/cuda/dense_chain.py``) against the
JAX package's (``ops/pallas/dense_chain.py``, Pallas in interpret mode), on
the CPU, with the same Flax weights loaded into the port's ``ResNet1D``.

* the plain chain of ``make_resnet_chain_fn`` against JAX's interpret-mode
  ``make_resnet_chain_fn`` at B = 16, both variants. Both round at the same
  points to bfloat16, but sum in other orders, so an activation one float32
  ulp apart can round to bfloat16 values one ulp (2⁻⁸ relative) apart and
  carry that through the later layers (ResNet-18 read 1.2e-7 here, ResNet-50
  7.7e-3): atol 2e-2, the JAX test's own gate for a bfloat16 chain;
* the plain chain against the port's float32 fold within the JAX test's
  gate, 2e-2, on that test's net (the Flax init; tests/test_resnet_dynamics.py:
  218-228);
* the wrappers raise on inputs that require grad and on a wrong width;
* one ``presets.dnn_mppi`` tick over the chain (ResNet-18, residual × 0.05
  as tests/test_resnet_dynamics.py:163): finite, the plain version called
  once per rollout step.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.ops.pallas import dense_chain as jchain
from dnn_mppi_mpc_tpu_torch import presets
from dnn_mppi_mpc_tpu_torch.models import learned as tl
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern

from test_torch_learned import _close, flax_resnet


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread spares every op the
    thread pool's wake-up cost, which would dominate its time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", ["18", "50"])
def test_plain_chain_matches_jax_kernel(variant):
    jm, variables, tm = flax_resnet(variant, seed=2)
    x = np.random.default_rng(3).normal(size=(16, 5)).astype(np.float32)
    want = jchain.make_resnet_chain_fn(jm, variables, b_block=16, interpret=True)(jnp.asarray(x))
    fn = kern.make_resnet_chain_fn(tl.ResNet1D(out_dim=3, variant=variant, device="cpu"),
                                   variables, device="cpu")
    assert fn.n_layers == (21 if variant == "18" else 54) and fn.c_in == 5
    kern.reset_counts()
    got = fn(torch.from_numpy(x))
    assert kern.resnet_chain_plain.calls == 1 and kern.resnet_chain.launches == 0
    _close(f"ResNet-{variant} chain vs JAX interpret kernel", got.numpy(), np.asarray(want),
           0.0, 2e-2)


@pytest.mark.parametrize("variant", ["18", "50"])
def test_plain_chain_matches_f32_fold(variant):
    _, _, tm = flax_resnet(variant, seed=4, perturb=False)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(21, 5)).astype(np.float32))
    got = kern.make_resnet_chain_fn(tm, device="cpu")(x)
    assert got.shape == (21, 3)
    _close(f"ResNet-{variant} chain vs float32 fold", got.numpy(),
           tl.fold_resnet1d_l1(tm)(x).numpy(), 0.0, 2e-2)


@pytest.mark.parametrize("wrapper", ["resnet_chain", "fused_mlp_apply"])
def test_wrappers_raise_on_requires_grad(wrapper):
    x = torch.zeros(4, 5, requires_grad=True)
    if wrapper == "resnet_chain":
        fn = kern.make_resnet_chain_fn(tl.ResNet1D(3, "18", device="cpu"), device="cpu")
        with pytest.raises(ValueError, match="backward"):
            fn(x)
        with pytest.raises(ValueError, match=r"\(B, 5\)"):
            fn(torch.zeros(4, 6))
    else:
        ws, bs = kern.fold_residual_mlp(tl.MLP(hidden=8, depth=1, device="cpu"))
        with pytest.raises(ValueError, match="backward"):
            kern.fused_mlp_apply(x, ws, bs)
        w_grad = [w.clone().requires_grad_() for w in ws]
        with pytest.raises(ValueError, match="backward"):
            kern.fused_mlp_apply(x.detach(), w_grad, bs)


def test_dnn_mppi_tick_over_the_chain():
    tm = tl.ResNet1D(3, "18", device="cpu", generator=torch.Generator().manual_seed(6))
    fn = kern.make_resnet_chain_fn(tm, device="cpu")
    ref = np.stack([np.linspace(0, 2, 40), np.linspace(0, 1, 40), np.zeros(40)], 1)
    solver, params = presets.dnn_mppi(ref, lambda f: 0.05 * fn(f), num_samples=32, horizon=5,
                                      device="cpu")
    kern.reset_counts()
    u0, st, aux = solver.step(params, solver.init(), torch.tensor([0.0, 0.1, 0.0]))
    assert u0.shape == (2,) and bool(torch.isfinite(u0).all())
    assert bool(torch.isfinite(aux.costs).all())
    assert kern.resnet_chain_plain.calls == 5  # one net evaluation per rollout step


@pytest.mark.cuda
def test_resnet_chain_kernel_on_card():
    """The kernel against its plain version (one call; chip_smoke.py covers
    ResNet-50 at the main path's batch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tm = tl.ResNet1D(3, "18", device="cpu", generator=torch.Generator().manual_seed(0))
    fn = kern.make_resnet_chain_fn(tm.to("cuda"), device="cuda")
    x = torch.randn(37, 5, generator=torch.Generator().manual_seed(1)).to("cuda")
    torch.testing.assert_close(fn(x), kern.resnet_chain_plain(x, fn.chain), rtol=1e-5, atol=1e-6)
