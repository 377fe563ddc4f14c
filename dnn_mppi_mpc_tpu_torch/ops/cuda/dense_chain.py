"""The ResNet dense chain: a whole folded ResNet-18/50 per launch.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/dense_chain.py``.
:func:`make_resnet_chain_fn` (``:104``) folds a :class:`ResNet1D` at L = 1
(``models/learned.py fold_resnet1d_l1_arrays``), stores the chain's weights
once as bfloat16 and returns a (B, in_dim) → (B, out_dim) function. On CUDA
tensors it runs :func:`resnet_chain`, one launch of ``dmm_resnet_chain``
(csrc/dense_chain.cu) per net evaluation; on CPU tensors the plain version
:func:`resnet_chain_plain`. Both round where the TPU kernel rounds: the input
and every ReLU'd activation to bfloat16, the products (bfloat16 operands,
exact) summed in float32 from zero in input-channel order, the bias in
float32, the downsample and the last conv of a block in float32 until
h = bf16(relu(y + r)), the head tanh(float32). So the kernel equals the
plain version but for tanhf in the head; against the float32 fold both sit
within the JAX test's 2e-2.

The TPU knobs ``b_block`` and ``interpret`` are not ported: the kernel takes
any batch, 8 rows a block. The kernel has no backward, so an input that
requires grad raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..._build import CHAIN_MAX_BLOCKS, CHAIN_MAX_LAYERS, DmmChainArgs, launch
from ...config import resolve_device
from ...models.learned import ResNet1D, fold_resnet1d_l1_arrays, load_flax_resnet
from .common import MAX_SMEM_OPT_IN, on_cuda

ROWS = 8  # kRows in csrc/dense_chain.cu: the rows one block owns


@dataclasses.dataclass
class ResNetChain:
    """A folded ResNet packed for the chain: per layer, in execution order
    (stem; per block its downsample if any, then its convs; head), the
    weights (c_in, ld) bfloat16 and the bias (ld,) float32 with ld the
    output width rounded up to even (the padding column zero)."""

    weights: list
    biases: list
    down: tuple  # per block: has a downsample
    n_convs: int
    in_dim: int
    out_dim: int
    c_max: int  # widest block input/output (h and r)
    y_max: int  # widest inner activation (the input, the inner convs)
    _args: object = dataclasses.field(default=None, repr=False)  # DmmChainArgs but x, out, B

    @property
    def n_layers(self) -> int:
        return len(self.weights)


def pack_resnet_chain(stem, blocks, head, device) -> ResNetChain:
    """Pack ``fold_resnet1d_l1_arrays``' (stem, blocks, head) on ``device``."""
    weights, biases = [], []

    def add(w, b):
        c_in, c_out = w.shape
        ld = c_out + (c_out & 1)
        wp = torch.zeros((c_in, ld), dtype=torch.float32, device=w.device)
        wp[:, :c_out] = w
        bp = torch.zeros((ld,), dtype=torch.float32, device=w.device)
        bp[:c_out] = b
        weights.append(wp.to(device=device, dtype=torch.bfloat16).contiguous())
        biases.append(bp.to(device).contiguous())

    with torch.no_grad():
        add(*stem)
        y_max = stem[0].shape[0]
        c_max = stem[0].shape[1]
        for convs, down in blocks:
            if down is not None:
                add(*down)
            for c, (w, b) in enumerate(convs):
                add(w, b)
                c_max = max(c_max, w.shape[0])
                if c < len(convs) - 1:
                    y_max = max(y_max, w.shape[1])
                else:
                    c_max = max(c_max, w.shape[1])
        add(*head)
    n_convs = {len(convs) for convs, _ in blocks}
    if len(n_convs) != 1:
        raise ValueError(f"every block must have the same number of convs, got {n_convs}")
    return ResNetChain(weights, biases, tuple(down is not None for _, down in blocks),
                       n_convs.pop(), stem[0].shape[0], head[0].shape[1], c_max, y_max)


def _check(x: torch.Tensor, chain: ResNetChain) -> None:
    if x.dim() != 2 or x.shape[1] != chain.in_dim:
        raise ValueError(f"x must be (B, {chain.in_dim}), got {tuple(x.shape)}")
    if x.requires_grad:
        raise ValueError("the ResNet chain kernel has no backward: detach its input (the "
                         "float32 fold, models.learned.fold_resnet1d_l1, is differentiable)")


def resnet_chain_plain(x: torch.Tensor, chain: ResNetChain) -> torch.Tensor:
    """Plain PyTorch version of :func:`resnet_chain`, in the kernel's order
    (each product of bfloat16 operands added in input-channel order, one
    ``addcmul_`` per input channel: exact products, so a fused multiply-add
    and a multiply then an add round alike)."""
    resnet_chain_plain.calls += 1
    _check(x, chain)
    layers = iter(zip(chain.weights, chain.biases))

    def bf16(t):
        return t.to(torch.bfloat16).float()

    def dense(h, layer):
        w, b = layer
        w = w.float()
        y = torch.zeros((h.shape[0], w.shape[1]), dtype=torch.float32, device=h.device)
        for k in range(w.shape[0]):
            y.addcmul_(h[:, k:k + 1], w[k:k + 1, :])
        return y + b

    h = bf16(torch.relu(dense(bf16(x.float()), next(layers))))
    for has_down in chain.down:
        r = dense(h, next(layers)) if has_down else h
        y = h
        for c in range(chain.n_convs):
            y = dense(y, next(layers))
            if c < chain.n_convs - 1:
                y = bf16(torch.relu(y))
        h = bf16(torch.relu(y + r))
    return torch.tanh(dense(h, next(layers)))[:, :chain.out_dim]


resnet_chain_plain.calls = 0


def resnet_chain(x: torch.Tensor, chain: ResNetChain) -> torch.Tensor:
    """The folded net of ``chain`` on ``x (B, in_dim)``: (B, out_dim)
    float32. On CUDA tensors one launch (``x`` contiguous float32 on the
    chain's device); on CPU tensors :func:`resnet_chain_plain`."""
    _check(x, chain)
    if not on_cuda(x, weights=chain.weights[0]):
        return resnet_chain_plain(x, chain)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 on the card, got {x.dtype}")
    out = torch.empty((x.shape[0], chain.out_dim), dtype=torch.float32, device=x.device)
    args = _chain_args(chain)
    args.x, args.out, args.B = x.data_ptr(), out.data_ptr(), x.shape[0]
    launch("dmm_resnet_chain", args, x.device)
    resnet_chain.launches += 1
    return out


resnet_chain.launches = 0


def _chain_args(chain: ResNetChain) -> DmmChainArgs:
    """The launch arguments of ``chain`` but x, out and B: built once per
    chain and copied for each call."""
    base = chain._args
    if base is None:
        if chain.n_layers > CHAIN_MAX_LAYERS or len(chain.down) > CHAIN_MAX_BLOCKS:
            raise ValueError(f"the chain kernel takes at most {CHAIN_MAX_LAYERS} layers and "
                             f"{CHAIN_MAX_BLOCKS} blocks, got {chain.n_layers} and "
                             f"{len(chain.down)}")
        smem = 4 * ROWS * (2 * chain.c_max + 2 * chain.y_max)
        if smem > MAX_SMEM_OPT_IN:
            raise ValueError(f"widths {chain.c_max}/{chain.y_max} need {smem} bytes of shared "
                             f"memory for the activations, over the {MAX_SMEM_OPT_IN}-byte limit")
        base = DmmChainArgs(n_layers=chain.n_layers, n_blocks=len(chain.down),
                            n_convs=chain.n_convs, out_dim=chain.out_dim, c_max=chain.c_max,
                            y_max=chain.y_max)
        for i, (w, b) in enumerate(zip(chain.weights, chain.biases)):
            base.W[i], base.b[i] = w.data_ptr(), b.data_ptr()
            base.c_in[i], base.ld[i] = w.shape[0], w.shape[1]
        for j, d in enumerate(chain.down):
            base.down[j] = int(d)
        chain._args = base
    return DmmChainArgs.from_buffer_copy(base)


def make_resnet_chain_fn(model: ResNet1D, variables=None, device="cuda"):
    """Bind a :class:`ResNet1D` into a (…, in_dim) → (…, out_dim) function
    running the chain kernel, one launch per call over the flattened leading
    dims (on CPU tensors its plain version). With ``variables`` (a Flax
    ResNet1D tree as numpy leaves) the tree is loaded into ``model`` first;
    the folded bfloat16 weights live on ``device``. The function carries
    ``c_in``, ``n_layers`` and ``chain``."""
    device = resolve_device(device)
    if variables is not None:
        load_flax_resnet(model, variables)
    chain = pack_resnet_chain(*fold_resnet1d_l1_arrays(model), device=device)

    def f(x: torch.Tensor) -> torch.Tensor:
        out = resnet_chain(x.reshape(-1, x.shape[-1]), chain)
        return out.reshape(x.shape[:-1] + (chain.out_dim,))

    f.c_in, f.n_layers, f.chain = chain.in_dim, chain.n_layers, chain
    return f


__all__ = [
    "ResNetChain",
    "make_resnet_chain_fn",
    "pack_resnet_chain",
    "resnet_chain",
    "resnet_chain_plain",
]
