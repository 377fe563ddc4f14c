"""The ResNet dense chain: a whole folded ResNet-18/50 per launch.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/dense_chain.py``.
:func:`make_resnet_chain_fn` (``:104``) folds a :class:`ResNet1D` at L = 1
(``models/learned.py fold_resnet1d_l1_arrays``), packs the chain's weights
once as bfloat16 in the tensor cores' layout and returns a (B, in_dim) →
(B, out_dim) function. On CUDA tensors it runs :func:`resnet_chain`, one
cooperative launch of ``dmm_resnet_chain`` (csrc/dense_chain.cu) per net
evaluation; on CPU tensors the plain version :func:`resnet_chain_plain`.
Both round where the TPU kernel rounds: the input and every ReLU'd
activation to bfloat16, the products (bfloat16 operands, exact) summed in
float32, the bias in float32, the downsample and the last conv of a block in
float32 until h = bf16(relu(y + r)), the head tanh(float32). The plain
version sums in input-channel order, the kernel's tensor cores in their own:
an output one float32 ulp apart can round to another bfloat16, and the
difference carries through the later layers (``chip_smoke.py`` states the
limits); against the float32 fold both sit within the JAX test's 2e-2.

The kernel is one persistent cooperative launch, one block per SM, with a
grid-wide barrier between dependent layers, so the whole grid must be
co-resident: the occupancy is queried once per device, and a card that
cannot hold the grid raises. The activations live in a scratch that each
call allocates (:func:`scratch_layout`). The TPU knobs ``b_block`` and
``interpret`` are not ported. The kernel has no backward, so an input that
requires grad raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import torch

from ..._build import CHAIN_MAX_BLOCKS, CHAIN_MAX_LAYERS, DmmChainArgs, launch, load_kernels
from ...config import resolve_device
from ...models.learned import ResNet1D, fold_resnet1d_l1_arrays, load_flax_resnet
from .common import on_cuda

ROW_ALIGN = 128  # kRowAlign in csrc/dense_chain.cu: B_pad, a multiple of every tile's rows
COL_ALIGN = 32  # kColAlign: c_out (and so every later c_in) padded to the smallest tile
STEM_K_ALIGN = 16  # the stem's c_in padded to one MMA depth
BK = 64  # kBK: the k depth of a staged chunk
# The plan's cost model of one output tile on one SM, in µs: a fixed
# TILE_US (its first chunks' latency, the epilogue) and, per 64-deep chunk,
# CHUNK_US of its tile shape (rows × columns, largest first: the tiles the
# kernel has). Least-squares fit to the per-layer device times of every
# ResNet-50 layer shape under every tile on one H100 80GB HBM3 (700 W):
# ``python -m dnn_mppi_mpc_tpu_torch.utils.chain_tiles``.
TILE_US = 1.97
CHUNK_US = {(128, 128): 1.26, (64, 128): 0.88, (64, 64): 0.52, (32, 64): 0.59, (32, 32): 0.52}
TILES = tuple(CHUNK_US)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass
class ResNetChain:
    """A folded ResNet packed for the chain, per layer in execution order
    (stem; per block its downsample if any, then its convs; head):

    * ``packed``: the weights as the tensor cores' B operand, (n_pad, k_pad)
      bfloat16 (W transposed, c_in contiguous), c_out padded to
      ``COL_ALIGN`` and c_in to ``COL_ALIGN`` (the stem's to
      ``STEM_K_ALIGN``), the padding zero; ``packed_bias`` (n_pad,) float32;
    * ``weights`` (c_in, ld) and ``biases`` (ld,): views of the packed
      tensors with ld the output width rounded up to even, the layout the
      plain version reads.

    ``c_max`` and ``y_max`` are the scratch's column counts: the widest
    padded block input/output (h and r) and the widest padded inner conv
    output."""

    packed: list
    packed_bias: list
    weights: list
    biases: list
    down: tuple  # per block: has a downsample
    n_convs: int
    in_dim: int
    out_dim: int
    c_max: int
    y_max: int
    _plans: dict = dataclasses.field(default_factory=dict, repr=False)  # (B_pad, grid) → args

    @property
    def n_layers(self) -> int:
        return len(self.packed)


def pack_resnet_chain(stem, blocks, head, device) -> ResNetChain:
    """Pack ``fold_resnet1d_l1_arrays``' (stem, blocks, head) on ``device``.
    Raises ``ValueError`` where a layer's input width is not its producer's
    output width (the scratch holds one width per buffer) or the blocks
    differ in their conv count."""
    packed, packed_bias, weights, biases = [], [], [], []

    def add(w, b, k_align=COL_ALIGN):
        c_in, c_out = w.shape
        n_pad, k_pad = _round_up(c_out, COL_ALIGN), _round_up(c_in, k_align)
        wp = torch.zeros((n_pad, k_pad), dtype=torch.float32, device=w.device)
        wp[:c_out, :c_in] = w.T
        bp = torch.zeros((n_pad,), dtype=torch.float32, device=w.device)
        bp[:c_out] = b
        wp = wp.to(device=device, dtype=torch.bfloat16).contiguous()
        bp = bp.to(device).contiguous()
        ld = c_out + (c_out & 1)
        packed.append(wp)
        packed_bias.append(bp)
        weights.append(wp[:ld, :c_in].T)
        biases.append(bp[:ld])
        return n_pad

    def expect(what, got, want):
        if got != want:
            raise ValueError(f"{what} takes {got} channels, its input has {want}")

    n_convs = {len(convs) for convs, _ in blocks}
    if len(n_convs) > 1:
        raise ValueError(f"every block must have the same number of convs, got {n_convs}")
    with torch.no_grad():
        c_max, y_max = add(*stem, k_align=STEM_K_ALIGN), COL_ALIGN
        width = stem[0].shape[1]
        for j, (convs, down) in enumerate(blocks):
            if down is not None:
                expect(f"block {j}'s downsample", down[0].shape[0], width)
                c_max = max(c_max, add(*down))
            c_in = width
            for c, (w, b) in enumerate(convs):
                expect(f"block {j}'s conv {c}", w.shape[0], c_in)
                n_pad = add(w, b)
                if c < len(convs) - 1:
                    y_max = max(y_max, n_pad)
                c_in = w.shape[1]
            res = down[0].shape[1] if down is not None else width
            expect(f"block {j}'s residual add", c_in, res)
            width = c_in
            c_max = max(c_max, n_pad)
        expect("the head", head[0].shape[0], width)
        add(*head)
    return ResNetChain(packed, packed_bias, weights, biases,
                       tuple(down is not None for _, down in blocks),
                       n_convs.pop() if n_convs else 2, stem[0].shape[0], head[0].shape[1],
                       c_max, y_max)


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


def scratch_layout(chain: ResNetChain, B_pad: int):
    """The activation scratch of one call over B_pad rows: ({buffer: byte
    offset}, total bytes). h is (B_pad, c_max) bf16, r (B_pad, c_max)
    float32, y0 and y1 (B_pad, y_max) bf16, each at a 256-byte boundary."""
    offsets, at = {}, 0
    for name, nbytes in (("h", 2 * B_pad * chain.c_max), ("r", 4 * B_pad * chain.c_max),
                         ("y0", 2 * B_pad * chain.y_max), ("y1", 2 * B_pad * chain.y_max)):
        offsets[name] = at
        at += _round_up(nbytes, 256)
    return offsets, at


def layer_plan(n_pad: int, k_pad: int, B_pad: int, grid: int) -> tuple[int, int]:
    """(bm, bn): the tile of one layer with the least modelled time, waves
    of tiles over the grid × (TILE_US + chunks × CHUNK_US[tile])."""
    nk = -(-k_pad // BK)

    def cost(tile):
        bm, bn = tile
        return -(-(B_pad // bm) * (n_pad // bn) // grid) * (TILE_US + nk * CHUNK_US[tile])

    return min((t for t in TILES if n_pad % t[1] == 0), key=cost)


def chain_plan(chain: ResNetChain, B_pad: int, grid: int) -> dict:
    """The launch plan of ``chain`` over B_pad rows on ``grid`` blocks: each
    layer's tile rows ``bm`` and columns ``bn`` (:func:`layer_plan`)."""
    tiles = [layer_plan(*w.shape, B_pad, grid) for w in chain.packed]
    return {"bm": [t[0] for t in tiles], "bn": [t[1] for t in tiles]}


def cooperative_grid(blocks_per_sm: int, num_sms: int) -> int:
    """The chain's grid: every block the card holds at once. Raises
    ``RuntimeError`` if it cannot hold one block an SM (the grid-wide
    barrier needs every block co-resident; nothing falls back)."""
    if blocks_per_sm < 1 or num_sms < 1:
        raise RuntimeError(f"the chain kernel cannot be co-scheduled: {blocks_per_sm} "
                           f"block(s) per SM fit, on {num_sms} SMs")
    return blocks_per_sm * num_sms


@lru_cache(maxsize=None)
def _grid(device_index: int) -> int:
    """The cooperative grid for card ``device_index``, queried once."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device_index):
        err = load_kernels().dmm_chain_occupancy(*(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"dmm_chain_occupancy: CUDA error {err}")
    return cooperative_grid(vals[0].value, vals[1].value)


def resnet_chain(x: torch.Tensor, chain: ResNetChain) -> torch.Tensor:
    """The folded net of ``chain`` on ``x (B, in_dim)``: (B, out_dim)
    float32. On CUDA tensors one cooperative launch (``x`` contiguous
    float32 on the chain's device); on CPU tensors :func:`resnet_chain_plain`."""
    _check(x, chain)
    if not on_cuda(x, weights=chain.packed[0]):
        return resnet_chain_plain(x, chain)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 on the card, got {x.dtype}")
    B = x.shape[0]
    args, offsets, nbytes = _call_args(chain, B, _grid(x.device.index))
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
    out = torch.empty((B, chain.out_dim), dtype=torch.float32, device=x.device)
    args.x, args.out, args.B = x.data_ptr(), out.data_ptr(), B
    base = scratch.data_ptr()
    args.h, args.r, args.y0, args.y1 = (base + offsets[k] for k in ("h", "r", "y0", "y1"))
    launch("dmm_resnet_chain", args, x.device)
    resnet_chain.launches += 1
    return out


resnet_chain.launches = 0


def check_chain_program(chain: ResNetChain) -> None:
    """Raise ``ValueError`` on a chain the kernel does not take: more than
    ``CHAIN_MAX_LAYERS`` layers or ``CHAIN_MAX_BLOCKS`` blocks, fewer than two
    convs a block."""
    if chain.n_layers > CHAIN_MAX_LAYERS or len(chain.down) > CHAIN_MAX_BLOCKS:
        raise ValueError(f"the chain kernel takes at most {CHAIN_MAX_LAYERS} layers and "
                         f"{CHAIN_MAX_BLOCKS} blocks, got {chain.n_layers} and "
                         f"{len(chain.down)}")
    if chain.down and chain.n_convs < 2:
        raise ValueError(f"the chain kernel takes blocks of at least two convs, got "
                         f"{chain.n_convs}")


def _call_args(chain: ResNetChain, B: int, grid: int):
    """(the launch arguments but x, out, B and the scratch's pointers, the
    scratch's offsets, its bytes) of a call over ``B`` rows on ``grid``
    blocks: built and planned once per (B_pad, grid), copied for each call."""
    B_pad = _round_up(B, ROW_ALIGN)
    key = (B_pad, grid)
    if key not in chain._plans:
        check_chain_program(chain)
        args = DmmChainArgs(n_layers=chain.n_layers, n_blocks=len(chain.down),
                            n_convs=chain.n_convs, out_dim=chain.out_dim, c_max=chain.c_max,
                            y_max=chain.y_max, B_pad=B_pad, grid=grid)
        plan = chain_plan(chain, B_pad, grid)
        for i, (w, b, view) in enumerate(zip(chain.packed, chain.packed_bias, chain.weights)):
            args.W[i], args.b[i] = w.data_ptr(), b.data_ptr()
            args.n_pad[i], args.k_pad[i] = w.shape
            args.c_in[i] = view.shape[0]
            args.bm[i], args.bn[i] = plan["bm"][i], plan["bn"][i]
        for j, d in enumerate(chain.down):
            args.down[j] = int(d)
        chain._plans[key] = (args, *scratch_layout(chain, B_pad))
    args, offsets, nbytes = chain._plans[key]
    return DmmChainArgs.from_buffer_copy(args), offsets, nbytes


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
    "COL_ALIGN",
    "ROW_ALIGN",
    "ResNetChain",
    "STEM_K_ALIGN",
    "TILES",
    "chain_plan",
    "check_chain_program",
    "cooperative_grid",
    "layer_plan",
    "make_resnet_chain_fn",
    "pack_resnet_chain",
    "resnet_chain",
    "resnet_chain_plain",
    "scratch_layout",
]
