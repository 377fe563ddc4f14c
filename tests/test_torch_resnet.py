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
  once per rollout step;
* the tensor cores' packing: each packed (n_pad, k_pad) weight unpacks to
  ``fold_resnet1d_l1_arrays``' weight in bfloat16, the padding zero, and the
  plain chain read from the packed views equals the plain chain on the
  unpadded (c_in, even c_out) layout;
* the scratch and grid arithmetic of the cooperative launch, and the raises
  on programs the kernel does not take.
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.ops.pallas import dense_chain as jchain
from dnn_mppi_mpc_tpu_torch import presets
from dnn_mppi_mpc_tpu_torch.models import learned as tl
from dnn_mppi_mpc_tpu_torch.ops import cuda as kern
from dnn_mppi_mpc_tpu_torch.ops.cuda import dense_chain as dc

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


def _fold_layers(tm):
    """fold_resnet1d_l1_arrays' (W, b) pairs in the chain's order."""
    stem, blocks, head = tl.fold_resnet1d_l1_arrays(tm)
    layers = [stem]
    for convs, down in blocks:
        layers += ([down] if down is not None else []) + list(convs)
    return layers + [head]


@pytest.mark.parametrize("variant", ["18", "50"])
def test_packed_weights_unpack_to_the_fold(variant):
    tm = tl.ResNet1D(3, variant, device="cpu", generator=torch.Generator().manual_seed(7))
    chain = kern.make_resnet_chain_fn(tm, device="cpu").chain
    layers = _fold_layers(tm)
    assert chain.n_layers == len(layers)
    for i, ((w, b), wp, bp) in enumerate(zip(layers, chain.packed, chain.packed_bias)):
        c_in, c_out = w.shape
        n_pad, k_pad = wp.shape
        assert wp.dtype == torch.bfloat16 and wp.is_contiguous() and bp.dtype == torch.float32
        assert n_pad % dc.COL_ALIGN == 0 and n_pad - c_out < dc.COL_ALIGN
        align = dc.STEM_K_ALIGN if i == 0 else dc.COL_ALIGN
        assert k_pad % align == 0 and k_pad - c_in < align
        assert torch.equal(wp[:c_out, :c_in].T.float(), w.to(torch.bfloat16).float())
        assert torch.equal(bp[:c_out], b.float())
        assert not wp[c_out:].any() and not wp[:, c_in:].any() and not bp[c_out:].any()
        # the plain version's view: (c_in, c_out rounded up to even)
        assert tuple(chain.weights[i].shape) == (c_in, c_out + (c_out & 1))
    assert chain.c_max == (512 if variant == "18" else 2048) and chain.y_max == 512


def _unpadded_chain(tm):
    """The chain as the plain version read it before the tensor-core packing:
    (c_in, c_out rounded up to even) bfloat16 weights, (ld,) float32 biases."""
    stem, blocks, head = tl.fold_resnet1d_l1_arrays(tm)
    ws, bs = [], []
    for w, b in _fold_layers(tm):
        ld = w.shape[1] + (w.shape[1] & 1)
        wp, bp = torch.zeros(w.shape[0], ld), torch.zeros(ld)
        wp[:, :w.shape[1]], bp[:w.shape[1]] = w, b
        ws.append(wp.to(torch.bfloat16))
        bs.append(bp)
    return types.SimpleNamespace(weights=ws, biases=bs, in_dim=5, out_dim=3,
                                 down=tuple(d is not None for _, d in blocks),
                                 n_convs=len(blocks[0][0]))


@pytest.mark.parametrize("variant", ["18", "50"])
def test_plain_chain_from_packed_equals_unpadded(variant):
    tm = tl.ResNet1D(3, variant, device="cpu", generator=torch.Generator().manual_seed(8))
    fn = kern.make_resnet_chain_fn(tm, device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(9, 5)).astype(np.float32))
    assert torch.equal(fn(x), kern.resnet_chain_plain(x, _unpadded_chain(tm)))


def test_scratch_and_grid_arithmetic():
    tm = tl.ResNet1D(3, "50", device="cpu", generator=torch.Generator().manual_seed(0))
    chain = kern.make_resnet_chain_fn(tm, device="cpu").chain
    off, nbytes = dc.scratch_layout(chain, 1024)
    # h 4 MB bf16, r 8 MB float32, y0 and y1 1 MB bf16 each
    assert off == {"h": 0, "r": 4 << 20, "y0": 12 << 20, "y1": 13 << 20}
    assert nbytes == 14 << 20
    off, nbytes = dc.scratch_layout(chain, 896)
    assert all(o % 256 == 0 for o in off.values())
    assert nbytes == 896 * (2 * 2048 + 4 * 2048 + 2 * 2 * 512)
    assert dc.cooperative_grid(1, 132) == 132 and dc.cooperative_grid(2, 132) == 264
    with pytest.raises(RuntimeError, match="co-scheduled"):
        dc.cooperative_grid(0, 132)


@pytest.mark.parametrize("variant,B_pad,grid", [("50", 1024, 132), ("18", 1024, 132),
                                                ("50", 896, 132), ("50", 128, 8)])
def test_chain_plan(variant, B_pad, grid):
    """Every layer gets a tile the kernel has that divides its padded
    shape, the one of least modelled time."""
    tm = tl.ResNet1D(3, variant, device="cpu", generator=torch.Generator().manual_seed(0))
    chain = kern.make_resnet_chain_fn(tm, device="cpu").chain
    plan = dc.chain_plan(chain, B_pad, grid)
    assert len(plan["bm"]) == len(plan["bn"]) == chain.n_layers
    for w, bm, bn in zip(chain.packed, plan["bm"], plan["bn"]):
        n_pad, k_pad = w.shape
        assert (bm, bn) in dc.TILES and n_pad % bn == 0 and B_pad % bm == 0
        assert (bm, bn) == dc.layer_plan(n_pad, k_pad, B_pad, grid)


def test_layer_plan_follows_the_fitted_costs():
    # ResNet-50 at K = 1 024 on 132 SMs: the 2 048-wide layers take 128×128
    # tiles (128 of them, one wave), the 512-wide 2 048-deep ones 64×64 (128)
    assert dc.layer_plan(2048, 1024, 1024, 132) == (128, 128)
    assert dc.layer_plan(512, 2048, 1024, 132) == (64, 64)
    assert dc.layer_plan(32, 2048, 1024, 132) == (32, 32)  # the head: only 32×32 divides 32
    # on fewer blocks the small tiles need more waves, and larger ones win
    assert dc.layer_plan(512, 2048, 1024, 8) == (128, 128)


def _toy_program(n_blocks, n_convs, width=8):
    g = torch.Generator().manual_seed(1)

    def lin(a, b):
        return torch.randn(a, b, generator=g), torch.randn(b, generator=g)

    blocks = [([lin(width, width) for _ in range(n_convs)], None) for _ in range(n_blocks)]
    return lin(5, width), blocks, lin(width, 3)


def test_chain_programs_the_kernel_does_not_take():
    ok = dc.pack_resnet_chain(*_toy_program(16, 2), device="cpu")
    dc.check_chain_program(ok)
    args, off, nbytes = dc._call_args(ok, 300, 132)
    assert args.n_layers == 34 and args.B_pad == 384 and args.grid == 132
    assert dc._call_args(ok, 300, 132)[0].bm[0] == args.bm[0]  # planned once
    with pytest.raises(ValueError, match="16 blocks"):  # a block too many
        dc.check_chain_program(dc.pack_resnet_chain(*_toy_program(17, 2), device="cpu"))
    with pytest.raises(ValueError, match="64 layers"):  # 2 + 16·4 = 66 layers
        dc.check_chain_program(dc.pack_resnet_chain(*_toy_program(16, 4), device="cpu"))
    with pytest.raises(ValueError, match="two convs"):
        dc.check_chain_program(dc.pack_resnet_chain(*_toy_program(2, 1), device="cpu"))
    # widths the scratch cannot hold: one width per buffer, so a layer must
    # take its producer's width, and a residual add needs equal widths
    stem, blocks, head = _toy_program(2, 2)
    bad = [([blocks[0][0][0], (torch.zeros(9, 8), torch.zeros(8))], None)]
    with pytest.raises(ValueError, match="conv 1 takes 9 channels"):
        dc.pack_resnet_chain(stem, bad, head, device="cpu")
    bad = [([blocks[0][0][0], (torch.zeros(8, 16), torch.zeros(16))], None)]
    with pytest.raises(ValueError, match="residual add"):
        dc.pack_resnet_chain(stem, bad, head, device="cpu")
    with pytest.raises(ValueError, match="the head"):
        dc.pack_resnet_chain(stem, blocks, (torch.zeros(16, 3), torch.zeros(3)), device="cpu")


@pytest.mark.cuda
def test_resnet_chain_kernel_on_card():
    """The kernel against its plain version (one call; chip_smoke.py covers
    ResNet-50 at the main path's batch). The tensor cores sum in another
    order than the plain version, so one bf16 flip may carry through the
    later layers: atol 2e-2, chip_smoke.py's TOL["chain"]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tm = tl.ResNet1D(3, "18", device="cpu", generator=torch.Generator().manual_seed(0))
    fn = kern.make_resnet_chain_fn(tm.to("cuda"), device="cuda")
    x = torch.randn(37, 5, generator=torch.Generator().manual_seed(1)).to("cuda")
    torch.testing.assert_close(fn(x), kern.resnet_chain_plain(x, fn.chain), rtol=0.0, atol=2e-2)


def test_chain_tiles_fit_recovers_the_model():
    """utils/chain_tiles.fit on timings made from known constants."""
    from dnn_mppi_mpc_tpu_torch.utils import chain_tiles

    tile_us, chunk = 1.5, {(128, 128): 1.7, (64, 128): 1.0, (64, 64): 0.7, (32, 64): 0.6,
                           (32, 32): 0.5}
    rows = []
    for i, (n, k) in enumerate([(64, 64), (256, 256), (512, 2048), (2048, 512), (128, 512)]):
        for (bm, bn), c in chunk.items():
            if n % bn == 0:
                waves = -(-(1024 // bm) * (n // bn) // 132)
                rows.append((n, k, bm, bn, 3.0 + i + waves * (tile_us + -(-k // 64) * c)))
    got = chain_tiles.fit(rows, 132)
    assert got["rms_us"] < 1e-9 and abs(got["TILE_US"] - tile_us) < 1e-9
    assert all(abs(got["CHUNK_US"][f"{bm}x{bn}"] - c) < 1e-9 for (bm, bn), c in chunk.items())
