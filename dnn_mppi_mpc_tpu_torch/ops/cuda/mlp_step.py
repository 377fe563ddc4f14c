"""The fused residual-MLP dynamics step: the whole folded net in one launch.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/mlp_step.py``:

* :func:`fused_mlp_apply` (``:78``) applies a Dense chain (linear, tanh
  after layers 1 … L−2, linear) to ``feats (K, F0)``: on CUDA tensors in
  one launch of ``dmm_fused_mlp`` (csrc/mlp_step.cu), on CPU tensors in its
  plain version, :func:`fused_mlp_apply_plain`, which sums each output from
  its first term in feature order as the kernel does;
* :func:`fold_residual_mlp` (``:150``) folds the standardizers and the
  residual scale into the first and last layers;
* :func:`make_fused_residual_step` (``:194``) gives the MPPI rollout's
  dynamics step x⁺ = euler(analytic) + s·residual over any leading batch
  shape, one launch per call.

``compute_dtype=torch.bfloat16`` rounds each product's operands to bfloat16
(float32 sums and bias), as the JAX kernel's option does; any other dtype
than float32 or bfloat16 raises. The TPU knobs ``block_rows`` and
``interpret`` are not ported: the row tile is the kernel's own (8 rows a
block), and no feature is padded. The kernel stages each layer's weights in shared
memory and keeps the float32 products off the tensor cores, each output
summed by one thread in feature order, so it equals the plain version but
for tanhf. The kernel has no backward, so inputs that require grad raise
``ValueError``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..._build import MLP_MAX_LAYERS, DmmMlpArgs, launch
from ...config import resolve_device
from ...models.integrators import euler_step
from ..filters import matmul_f32
from .common import MAX_SMEM_OPT_IN, on_cuda

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
ROWS = 8  # kRows in csrc/mlp_step.cu: the rows one block owns
THREADS = 256  # kThreads
MAX_RN = 8  # kMaxRN: the most columns a thread owns
STAGE_FLOATS = 16384  # a weight stage: 64 KB, two of them


def _layer_rn(width: int) -> int:
    """The columns a thread owns in a layer of ``width`` outputs: the
    smallest power of two with THREADS·RN ≥ width."""
    rn = 1
    while rn * THREADS < width:
        rn *= 2
    return rn


def mlp_launch_plan(dims: Sequence[int]) -> tuple[int, int]:
    """(floats a weight stage, shared-memory bytes) of the kernel for the
    chain's widths ``dims`` [F0, d_1, …, d_L]: two 8-row activation buffers
    of the widest width and two weight stages of at most STAGE_FLOATS.
    Raises ``ValueError`` on a layer wider than THREADS·MAX_RN or widths whose
    activations leave no room for a stage of one weight row."""
    outs = list(dims[1:])
    if max(_layer_rn(d) for d in outs) > MAX_RN:
        raise ValueError(f"the fused MLP kernel takes layers up to {THREADS * MAX_RN} wide, got "
                         f"{max(outs)}")
    act = 2 * 4 * ROWS * max(dims)
    stage = min(STAGE_FLOATS, (MAX_SMEM_OPT_IN - act) // 8 // 4 * 4)
    if stage < max(outs):
        raise ValueError(f"widths {list(dims)} need {act} bytes of shared memory for the "
                         f"activations, leaving no room for two {max(outs)}-float weight rows "
                         f"under the {MAX_SMEM_OPT_IN}-byte limit")
    return stage, act + 8 * stage


def _operand(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if compute_dtype == torch.bfloat16 else t


def _check(feats, weights, biases, compute_dtype) -> list:
    """The chain's widths [F0, d_1, …, d_L]; raise on a dtype, shape or
    grad the kernel does not take."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, got "
                         f"{compute_dtype}")
    if feats.dim() != 2:
        raise ValueError(f"feats must be (K, F0), got shape {tuple(feats.shape)}")
    n = len(weights)
    if n < 1 or len(biases) != n:
        raise ValueError(f"need one bias per weight and at least one layer, got {n} weights "
                         f"and {len(biases)} biases")
    if weights[0].dim() != 2 or weights[0].shape[0] != feats.shape[1]:
        raise ValueError(f"feats have {feats.shape[1]} features, the first layer expects "
                         f"{weights[0].shape[0] if weights[0].dim() else '?'}")
    dims = [feats.shape[1]]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dim() != 2 or w.shape[0] != dims[-1]:
            raise ValueError(f"layer {i - 1}→{i} width mismatch: weight {i} is "
                             f"{tuple(w.shape)}, expected ({dims[-1]}, ·)")
        if tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"bias {i} must have shape ({w.shape[1]},), got {tuple(b.shape)}")
        dims.append(w.shape[1])
    if any(t.requires_grad for t in (feats, *weights, *biases)):
        raise ValueError("the fused MLP kernel has no backward: detach its inputs (the plain "
                         "net of models.learned.make_residual_fn is the differentiable route)")
    return dims


def fused_mlp_apply_plain(feats: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor],
                          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mlp_apply`, in the kernel's
    order: each output summed from its first term over the input features in
    order (a multiply and an add per term), then the bias; tanh after layers
    1 … L−2."""
    fused_mlp_apply_plain.calls += 1
    _check(feats, weights, biases, compute_dtype)
    n = len(weights)
    h = feats.float()
    for i, (w, b) in enumerate(zip(weights, biases)):
        hh, ww = _operand(h, compute_dtype), _operand(w.float(), compute_dtype)
        y = hh[:, 0:1] * ww[0:1, :]
        for k in range(1, ww.shape[0]):
            y = y + hh[:, k:k + 1] * ww[k:k + 1, :]
        h = y + b.float()
        if 1 <= i <= n - 2:
            h = torch.tanh(h)
    return h


fused_mlp_apply_plain.calls = 0


def fused_mlp_apply(feats: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor],
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Apply the Dense chain ``weights`` (d_l, d_{l+1}) / ``biases``
    (d_{l+1},) — linear, tanh after layers 1 … L−2, linear — to ``feats (K,
    F0)``: (K, d_L) float32. On CUDA tensors one launch, the activations
    never leaving the chip; every tensor must then be contiguous float32 on
    one device, with at most 16 layers, every layer at most 2 048 wide and
    the widths within the shared memory (:func:`mlp_launch_plan`)."""
    dims = _check(feats, weights, biases, compute_dtype)
    if not on_cuda(feats, **{f"weights[{i}]": w for i, w in enumerate(weights)},
                   **{f"biases[{i}]": b for i, b in enumerate(biases)}):
        return fused_mlp_apply_plain(feats, weights, biases, compute_dtype)
    for name, t in (("feats", feats), *((f"weights[{i}]", w) for i, w in enumerate(weights)),
                    *((f"biases[{i}]", b) for i, b in enumerate(biases))):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on the card, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    n = len(weights)
    if n > MLP_MAX_LAYERS:
        raise ValueError(f"the fused MLP kernel takes at most {MLP_MAX_LAYERS} layers, got {n}")
    stage, _ = mlp_launch_plan(dims)
    K = feats.shape[0]
    out = torch.empty((K, dims[-1]), dtype=torch.float32, device=feats.device)
    args = DmmMlpArgs(x=feats.data_ptr(), out=out.data_ptr(), n_layers=n, K=K,
                      bf16=int(compute_dtype == torch.bfloat16), d_max=max(dims),
                      stage_floats=stage)
    for i in range(n):
        args.W[i] = weights[i].data_ptr()
        args.b[i] = biases[i].data_ptr()
    for i, d in enumerate(dims):
        args.dims[i] = d
    launch("dmm_fused_mlp", args, feats.device)
    fused_mlp_apply.launches += 1
    return out


fused_mlp_apply.launches = 0


def _dense_layers(params):
    """(weights (in, out), biases) of an MLP: the port's ``models.learned.MLP``
    or a Flax ``Dense_i`` tree as numpy leaves (``{"params": …}`` or the
    inner dict)."""
    if isinstance(params, torch.nn.Module):
        ws, bs = params.dense()
        return [w.T for w in ws], bs
    p = params.get("params", params)
    names = sorted((n for n in p if n.startswith("Dense_")), key=lambda n: int(n.split("_")[1]))
    if not names:
        raise ValueError("no Dense_* layers found: expected a models.learned.MLP tree")
    return ([torch.from_numpy(np.array(p[n]["kernel"], np.float32)) for n in names],
            [torch.from_numpy(np.array(p[n]["bias"], np.float32)) for n in names])


def fold_residual_mlp(params, in_scaler=None, out_scaler=None, dt: float = 1.0,
                      device=None):
    """Fold the standardizers and the scale ``dt`` into the MLP's layers:
    W₀′ = W₀/σ[:, None], b₀′ = b₀ − (μ/σ)·W₀ (the in-scaler) and Wₕ′ =
    Wₕ·σₒ·dt, bₕ′ = (bₕ·σₒ + μₒ)·dt (the out-scaler's inverse and dt).
    ``params`` is the port's MLP or a Flax ``Dense_i`` tree; returns
    (weights, biases), float32 (in, out) / (out,) tensors on ``device``
    (default the MLP's own, the CPU for a tree), detached."""
    with torch.no_grad():
        ws, bs = _dense_layers(params)
        if device is None:
            device = ws[0].device
        ws = [w.to(device=device, dtype=torch.float32) for w in ws]
        bs = [b.to(device=device, dtype=torch.float32) for b in bs]

        def vec(a):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.array(a, np.float32))
            return a.to(device=device, dtype=torch.float32)

        if in_scaler is not None:
            mu, sd = vec(in_scaler.mean), vec(in_scaler.std)
            bs[0] = bs[0] - matmul_f32(mu / sd, ws[0])
            ws[0] = ws[0] / sd[:, None]
        scale = torch.tensor(dt, dtype=torch.float32).to(device)
        if out_scaler is not None:
            so, mo = vec(out_scaler.std), vec(out_scaler.mean)
            bs[-1] = (bs[-1] * so + mo) * scale
            ws[-1] = ws[-1] * (so[None, :] * scale)
        else:
            ws[-1] = ws[-1] * scale
            bs[-1] = bs[-1] * scale
    return [w.contiguous() for w in ws], [b.contiguous() for b in bs]


def make_fused_residual_step(analytic: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                             mlp, dt: float, in_scaler=None, out_scaler=None,
                             residual_scale: Optional[float] = None,
                             compute_dtype: torch.dtype = torch.float32,
                             device="cuda") -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Batched discrete step x⁺ = euler(analytic) + s·MLP(x, u), the MLP
    run by :func:`fused_mlp_apply` (one launch per call on the card): the
    Euler discretization of ``models.dynamics.residual_dynamics`` with
    ``models.learned.make_residual_fn``. ``mlp`` is the port's MLP or a
    Flax ``Dense_i`` tree (numpy leaves); its folded weights live on
    ``device``. ``residual_scale`` s defaults to ``dt`` (a net that predicts
    a rate); pass 1.0 for a net trained on one-step errors. Any leading
    batch shape (…, nx) / (…, nu)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, got "
                         f"{compute_dtype}")
    device = resolve_device(device)
    scale = dt if residual_scale is None else residual_scale
    ws, bs = fold_residual_mlp(mlp, in_scaler, out_scaler, scale, device=device)

    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        feats = torch.cat([x.float(), u.float()], dim=-1)
        batch = feats.shape[:-1]
        resid = fused_mlp_apply(feats.reshape(-1, feats.shape[-1]), ws, bs, compute_dtype)
        return euler_step(analytic, x, u, dt) + resid.reshape(batch + (ws[-1].shape[1],)).to(x.dtype)

    step.weights, step.biases = ws, bs
    return step


__all__ = [
    "COMPUTE_DTYPES",
    "MAX_RN",
    "ROWS",
    "STAGE_FLOATS",
    "THREADS",
    "fold_residual_mlp",
    "fused_mlp_apply",
    "fused_mlp_apply_plain",
    "make_fused_residual_step",
    "mlp_launch_plan",
]
