"""Learned residual dynamics as ``torch.nn`` modules.

Counterpart of ``dnn_mppi_mpc_tpu/models/learned.py``:

* :class:`MLP` — a linear input layer, ``depth`` tanh layers and a linear
  head (zero-initialized unless ``zero_init_head=False``);
* :class:`BasicBlock1D`, :class:`BottleneckBlock1D` and :class:`ResNet1D` —
  the 1-D conv ResNet-18/50 over channel-last (B, L, C) inputs, BatchNorm
  from its running statistics (the modules stay in eval mode), a tanh head;
* :class:`Standardizer` — the in-graph feature scaler (population std);
* :func:`load_flax_mlp` / :func:`load_flax_resnet` — a Flax variable tree,
  given as nested dicts of numpy arrays, into these modules (the card's
  machine has no Flax, so the loaders read numpy only);
* :func:`fold_resnet1d_l1_arrays` / :func:`fold_resnet1d_l1` — a ResNet1D
  at L = 1 folded into a dense matmul chain;
* :func:`make_residual_fn` / :func:`residual_from_train_state` — a module
  bound into a plain feature → residual function, the ``learned`` argument
  of :func:`..models.dynamics.residual_dynamics`.

Unlike Flax, a torch layer needs its input width at construction, so the
modules take ``in_dim`` (default 5, the (x, y, yaw, v, ω) features). They
initialize like Flax (LeCun-normal kernels, zero biases, BatchNorm scale 1,
shift 0, mean 0, var 1) from ``generator`` on the CPU and then move to
``device``, the card unless the caller passes ``device="cpu"``.

The bound residual functions use the modules' parameters detached, so
``torch.func`` transforms (the NMPC linearization) differentiate with
respect to the features only, and nothing they return requires grad.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device
from ..ops.filters import full_f32, matmul_f32

# Flax's LeCun-normal: a normal truncated at ±2 std, rescaled to the target
# variance (jax.nn.initializers.variance_scaling, "truncated_normal")
_TRUNC_STD = 0.87962566103423978
BN_EPS = 1e-5


def _lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _linear(d_in: int, d_out: int, generator, zero: bool = False) -> nn.Linear:
    layer = nn.utils.skip_init(nn.Linear, d_in, d_out, device="cpu")
    with torch.no_grad():
        if zero:
            layer.weight.zero_()
        else:
            _lecun_normal_(layer.weight, generator)
        layer.bias.zero_()
    return layer


def _conv(c_in: int, c_out: int, k: int, stride: int, padding: int, generator) -> nn.Conv1d:
    conv = nn.utils.skip_init(nn.Conv1d, c_in, c_out, k, stride=stride, padding=padding,
                              bias=False, device="cpu")
    with torch.no_grad():
        _lecun_normal_(conv.weight, generator)
    return conv


def _bn(c: int) -> nn.BatchNorm1d:
    bn = nn.BatchNorm1d(c, eps=BN_EPS, device="cpu")
    bn.eval()
    return bn


def mlp_forward(x: torch.Tensor, weights, biases) -> torch.Tensor:
    """The MLP's layer rule on (W (out, in), b) pairs: linear, tanh after
    layers 1 … L−2, linear (the reference applies no activation after the
    input layer)."""
    n = len(weights)
    with full_f32():
        for i, (w, b) in enumerate(zip(weights, biases)):
            x = F.linear(x, w, b)
            if 1 <= i <= n - 2:
                x = torch.tanh(x)
    return x


class MLP(nn.Module):
    """tanh MLP residual regressor: ``in_dim → hidden`` (linear), ``depth``
    × tanh(``hidden → hidden``), ``hidden → out_dim`` (linear). The
    defaults are the reference's 512-wide, depth-2 net; the head starts at
    zero unless ``zero_init_head=False``. Flax names the layers ``Dense_0``
    … ``Dense_{depth+1}``; here they are ``layers[0]`` … ``layers[depth+1]``."""

    def __init__(self, out_dim: int = 3, hidden: int = 512, depth: int = 2,
                 zero_init_head: bool = True, in_dim: int = 5, *, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.in_dim, self.out_dim, self.hidden, self.depth = in_dim, out_dim, hidden, depth
        dims = [in_dim] + [hidden] * (depth + 1) + [out_dim]
        n = len(dims) - 1
        self.layers = nn.ModuleList(
            _linear(a, b, generator, zero=zero_init_head and i == n - 1)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
        )
        self.to(device)

    def dense(self):
        """The layers' (weights, biases), detached."""
        return ([layer.weight.detach() for layer in self.layers],
                [layer.bias.detach() for layer in self.layers])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(x, [l.weight for l in self.layers], [l.bias for l in self.layers])


class _Block1D(nn.Module):
    """A residual block over (B, C, L): ``convs[i]`` / ``bns[i]`` are Flax's
    ``Conv_i`` / ``BatchNorm_i``; the downsample, when there is one, is the
    index after the main convs."""

    def __init__(self, convs, out_planes: int, in_planes: int, stride: int, generator):
        super().__init__()
        self.n_convs = len(convs)
        self.has_down = stride != 1 or in_planes != out_planes
        if self.has_down:
            convs = convs + [_conv(in_planes, out_planes, 1, stride, 0, generator)]
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(_bn(c.out_channels) for c in convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n_convs):
            y = self.bns[i](self.convs[i](y))
            if i < self.n_convs - 1:
                y = torch.relu(y)
        r = self.bns[-1](self.convs[-1](x)) if self.has_down else x
        return torch.relu(y + r)


class BasicBlock1D(_Block1D):
    """ResNet-18 basic block: conv3(stride)-BN-relu-conv3-BN, plus the
    identity or a 1-wide strided conv-BN downsample, then relu."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None) -> None:
        convs = [_conv(in_planes, planes, 3, stride, 1, generator),
                 _conv(planes, planes, 3, 1, 1, generator)]
        super().__init__(convs, planes, in_planes, stride, generator)


class BottleneckBlock1D(_Block1D):
    """ResNet-50 bottleneck: conv1-BN-relu-conv3(stride)-BN-relu-conv1
    (×expansion)-BN, plus the identity or a downsample, then relu."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None) -> None:
        out = planes * self.expansion
        convs = [_conv(in_planes, planes, 1, 1, 0, generator),
                 _conv(planes, planes, 3, stride, 1, generator),
                 _conv(planes, out, 1, 1, 0, generator)]
        super().__init__(convs, out, in_planes, stride, generator)


class ResNet1D(nn.Module):
    """1-D conv ResNet over channel-last (B, L, in_dim) inputs with a tanh
    regression head. ``variant='18'``: BasicBlock × [2, 2, 2, 2] after a
    3-wide stem; ``'50'``: Bottleneck × [3, 4, 6, 3] after a 7-wide stride-2
    stem and a 3-wide stride-2 max-pool. Then the mean over L, a linear
    layer and tanh. The module stays in eval mode: BatchNorm uses its
    running statistics, as the JAX package's ``train=False``."""

    def __init__(self, out_dim: int, variant: str = "18", in_dim: int = 5, *, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        if variant == "18":
            counts, block_cls, stem = [2, 2, 2, 2], BasicBlock1D, (3, 1, 1)
        elif variant == "50":
            counts, block_cls, stem = [3, 4, 6, 3], BottleneckBlock1D, (7, 2, 3)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        self.variant, self.in_dim, self.out_dim = variant, in_dim, out_dim
        self.stem = _conv(in_dim, 64, *stem, generator)
        self.stem_bn = _bn(64)
        blocks, c = [], 64
        for stage, n in enumerate(counts):
            planes = 64 * 2 ** stage
            for b in range(n):
                blocks.append(block_cls(c, planes, 2 if stage > 0 and b == 0 else 1, generator))
                c = planes * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = _linear(c, out_dim, generator)
        self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with full_f32():
            h = torch.relu(self.stem_bn(self.stem(x.transpose(1, 2))))
            if self.variant == "50":
                h = F.max_pool1d(h, 3, 2, padding=1)
            for block in self.blocks:
                h = block(h)
            return torch.tanh(self.head(h.mean(dim=-1)))


@dataclasses.dataclass
class Standardizer:
    """Feature scaler folded in-graph: ``transform`` maps raw features to
    z-scores, ``inverse`` maps network outputs back to physical units."""

    mean: torch.Tensor
    std: torch.Tensor

    @classmethod
    def fit(cls, data: torch.Tensor) -> "Standardizer":
        """Mean and population std (+1e-8) of ``data`` over its first axis,
        as ``jnp.std`` computes it (``torch.std`` would default to the
        unbiased one)."""
        return cls(mean=data.mean(0), std=data.std(0, correction=0) + 1e-8)

    @classmethod
    def from_numpy(cls, mean, std, *, device="cuda") -> "Standardizer":
        """A scaler on ``device`` from any arrays numpy reads (the JAX
        package's Standardizer leaves among them)."""
        device = resolve_device(device)
        return cls(*(torch.tensor(np.asarray(a, np.float32), device=device) for a in (mean, std)))

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        return z * self.std + self.mean


# --- loading Flax variable trees -----------------------------------------------------


def _np_leaf(tree: Mapping, key: str, where: str) -> np.ndarray:
    if key not in tree:
        raise ValueError(f"{where}: missing {key!r}")
    return np.asarray(tree[key], np.float32)


def _copy(param: torch.Tensor, value: np.ndarray, where: str) -> None:
    if tuple(param.shape) != value.shape:
        raise ValueError(f"{where}: shape {value.shape} does not fit {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(value, np.float32)))


def _check_names(tree: Mapping, want: list, where: str) -> None:
    have = set(tree)
    missing, extra = sorted(set(want) - have), sorted(have - set(want))
    if missing or extra:
        raise ValueError(f"{where}: missing {missing}, unexpected {extra}")


def _load_dense(layer: nn.Linear, tree: Mapping, where: str) -> None:
    _check_names(tree, ["kernel", "bias"], where)
    _copy(layer.weight, _np_leaf(tree, "kernel", where).T, f"{where}/kernel")
    _copy(layer.bias, _np_leaf(tree, "bias", where), f"{where}/bias")


def load_flax_mlp(model: MLP, variables: Mapping) -> MLP:
    """Copy a Flax ``models.learned.MLP`` tree (``{"params": {"Dense_i":
    {"kernel" (in, out), "bias"}}}`` or the inner dict, numpy leaves) into
    ``model``: ``layers[i].weight = Dense_i.kernel.T``. A missing or extra
    ``Dense_*`` or a shape that does not fit raises ``ValueError``."""
    p = variables.get("params", variables)
    names = [f"Dense_{i}" for i in range(len(model.layers))]
    _check_names(p, names, "MLP params")
    for name, layer in zip(names, model.layers):
        _load_dense(layer, p[name], name)
    return model


def _load_conv_bn(conv: nn.Conv1d, bn: nn.BatchNorm1d, p: Mapping, s: Mapping, i: int,
                  where: str) -> None:
    cw, bw = f"{where}/Conv_{i}", f"{where}/BatchNorm_{i}"
    for tree, key in ((p, f"Conv_{i}"), (p, f"BatchNorm_{i}"), (s, f"BatchNorm_{i}")):
        if key not in tree:
            raise ValueError(f"{where}: missing {key!r}")
    _check_names(p[f"Conv_{i}"], ["kernel"], cw)
    _check_names(p[f"BatchNorm_{i}"], ["scale", "bias"], bw)
    _check_names(s[f"BatchNorm_{i}"], ["mean", "var"], f"{bw} stats")
    # Flax kernels are (k, c_in, c_out); Conv1d weights (c_out, c_in, k)
    _copy(conv.weight, _np_leaf(p[f"Conv_{i}"], "kernel", cw).transpose(2, 1, 0), cw)
    _copy(bn.weight, _np_leaf(p[f"BatchNorm_{i}"], "scale", bw), f"{bw}/scale")
    _copy(bn.bias, _np_leaf(p[f"BatchNorm_{i}"], "bias", bw), f"{bw}/bias")
    _copy(bn.running_mean, _np_leaf(s[f"BatchNorm_{i}"], "mean", bw), f"{bw}/mean")
    _copy(bn.running_var, _np_leaf(s[f"BatchNorm_{i}"], "var", bw), f"{bw}/var")


def load_flax_resnet(model: ResNet1D, variables: Mapping) -> ResNet1D:
    """Copy a Flax ``models.learned.ResNet1D`` variable tree (``params`` and
    ``batch_stats``, numpy leaves) into ``model``: ``Conv_i.kernel (k, c_in,
    c_out)`` → ``weight.permute(2, 1, 0)``, ``BatchNorm_i`` {scale, bias}
    and {mean, var} → weight, bias, running_mean, running_var, the blocks
    ``BasicBlock1D_j`` / ``BottleneckBlock1D_j`` with their inner
    ``Conv_*`` / ``BatchNorm_*``, ``Dense_0`` the head. A tree without
    ``batch_stats``, a missing or extra entry, or a shape that does not fit
    raises ``ValueError``."""
    if "params" not in variables or "batch_stats" not in variables:
        raise ValueError("a ResNet1D tree needs 'params' and 'batch_stats' (BatchNorm's running "
                         "statistics)")
    p, s = variables["params"], variables["batch_stats"]
    prefix = type(model.blocks[0]).__name__
    blocks = [f"{prefix}_{j}" for j in range(len(model.blocks))]
    _check_names(p, ["Conv_0", "BatchNorm_0", "Dense_0"] + blocks, "ResNet1D params")
    _check_names(s, ["BatchNorm_0"] + blocks, "ResNet1D batch_stats")
    _load_conv_bn(model.stem, model.stem_bn, p, s, 0, "stem")
    for name, block in zip(blocks, model.blocks):
        n = len(block.convs)
        _check_names(p[name], [f"{k}_{i}" for i in range(n) for k in ("Conv", "BatchNorm")], name)
        _check_names(s[name], [f"BatchNorm_{i}" for i in range(n)], f"{name} stats")
        for i in range(n):
            _load_conv_bn(block.convs[i], block.bns[i], p[name], s[name], i, name)
    _load_dense(model.head, p["Dense_0"], "Dense_0")
    return model


# --- the L = 1 fold --------------------------------------------------------------------


def _conv_bn_fold(conv: nn.Conv1d, bn: nn.BatchNorm1d):
    """The center tap of ``conv`` times BatchNorm's scale, and BatchNorm's
    shift: (W (c_in, c_out), b (c_out,)) float32."""
    w = conv.weight.detach()
    s = bn.weight.detach() / torch.sqrt(bn.running_var + bn.eps)
    return w[:, :, w.shape[2] // 2].T * s[None, :], bn.bias.detach() - bn.running_mean * s


def fold_resnet1d_l1_arrays(model: ResNet1D):
    """The folded (stem, blocks, head) of the L = 1 dense chain: stem and
    head are (W (c_in, c_out), b) pairs, blocks a list of (convs, down) with
    convs a list of (W, b) and down a (W, b) or None. Shared by
    :func:`fold_resnet1d_l1` and the chain kernel
    (``ops/cuda/dense_chain.make_resnet_chain_fn``). A torch BatchNorm1d
    always carries running statistics, so every block folds."""
    with torch.no_grad():
        stem = _conv_bn_fold(model.stem, model.stem_bn)
        blocks = []
        for block in model.blocks:
            n = block.n_convs
            convs = [_conv_bn_fold(block.convs[i], block.bns[i]) for i in range(n)]
            down = _conv_bn_fold(block.convs[n], block.bns[n]) if block.has_down else None
            blocks.append((convs, down))
        head = (model.head.weight.detach().T.contiguous(), model.head.bias.detach())
    return stem, blocks, head


def fold_resnet1d_l1(model: ResNet1D, compute_dtype: Optional[torch.dtype] = None
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A ResNet1D at L = 1 as a (B, in_dim) → (B, out_dim) dense matmul
    chain, folded once here. At L = 1 each conv (width k, padding k // 2)
    sees one real input, so it is a product with its center tap; the
    stride-2 stem and the max-pool are identities and the mean over L is a
    no-op; eval BatchNorm is affine and folds into the product. In float32
    (TF32 off on the card) it equals the conv forward up to rounding;
    ``compute_dtype=torch.bfloat16`` casts the weights once and runs the
    chain in bfloat16, returning the input's dtype."""
    dt = compute_dtype
    stem, blocks, (head_w, head_b) = fold_resnet1d_l1_arrays(model)
    if dt is not None:
        def cast(wb):
            return wb[0].to(dt), wb[1].to(dt)

        stem = cast(stem)
        blocks = [([cast(c) for c in convs], None if down is None else cast(down))
                  for convs, down in blocks]
        head_w, head_b = head_w.to(dt), head_b.to(dt)
    mm = matmul_f32 if dt is None else torch.matmul

    def f(x: torch.Tensor) -> torch.Tensor:
        out_dtype = x.dtype
        if dt is not None:
            x = x.to(dt)
        h = torch.relu(mm(x, stem[0]) + stem[1])
        for convs, down in blocks:
            r = h if down is None else mm(h, down[0]) + down[1]
            y = h
            for c, (w, b) in enumerate(convs):
                y = mm(y, w) + b
                if c < len(convs) - 1:
                    y = torch.relu(y)
            h = torch.relu(y + r)
        y = torch.tanh(mm(h, head_w) + head_b)
        return y.to(out_dtype) if dt is not None else y

    return f


# --- binding a module into a residual function ---------------------------------------


def make_residual_fn(model: nn.Module, in_scaler: Optional[Standardizer] = None,
                     out_scaler: Optional[Standardizer] = None, needs_length_axis: bool = False,
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Bind a module into a plain feature → residual function over any
    leading batch shape: the in-scaler, the net, the out-scaler's inverse.
    An :class:`MLP` runs its layer rule on its detached weights;
    ``needs_length_axis`` marks a :class:`ResNet1D` on L = 1 inputs, which is
    folded into its dense chain (:func:`fold_resnet1d_l1`, in
    ``compute_dtype``) once, here."""
    if needs_length_axis:
        net = fold_resnet1d_l1(model, compute_dtype=compute_dtype)
    elif isinstance(model, MLP):
        ws, bs = model.dense()

        def net(z):
            return mlp_forward(z, ws, bs)
    else:
        raise ValueError(f"make_residual_fn binds an MLP, or a ResNet1D with "
                         f"needs_length_axis=True; got {type(model).__name__}")

    def f(feats: torch.Tensor) -> torch.Tensor:
        z = in_scaler.transform(feats) if in_scaler is not None else feats
        batch = z.shape[:-1]
        out = net(z.reshape(-1, z.shape[-1]))
        out = out.reshape(batch + out.shape[-1:])
        return out_scaler.inverse(out) if out_scaler is not None else out

    return f


def _as_standardizer(s, device) -> Optional[Standardizer]:
    if s is None:
        return None
    if isinstance(s, Standardizer):
        return Standardizer(s.mean.to(device), s.std.to(device))
    return Standardizer.from_numpy(s.mean, s.std, device=device)


def residual_from_train_state(model: nn.Module, tstate) -> Callable[[torch.Tensor], torch.Tensor]:
    """Bind a trained model and its scalers into a feature → residual
    function. ``tstate`` is any object with ``params`` (a Flax variable tree
    as numpy leaves, loaded into ``model`` first; None keeps the module's
    own weights), ``in_scaler`` and ``out_scaler`` (Standardizers, or
    anything with numpy-readable ``mean`` and ``std``, or None). A
    :class:`ResNet1D` gets the L = 1 fold, as the JAX package inserts its
    length axis."""
    is_resnet = isinstance(model, ResNet1D)
    if tstate.params is not None:
        (load_flax_resnet if is_resnet else load_flax_mlp)(model, tstate.params)
    device = next(model.parameters()).device
    return make_residual_fn(model, _as_standardizer(tstate.in_scaler, device),
                            _as_standardizer(tstate.out_scaler, device),
                            needs_length_axis=is_resnet)


__all__ = [
    "BN_EPS",
    "BasicBlock1D",
    "BottleneckBlock1D",
    "MLP",
    "ResNet1D",
    "Standardizer",
    "fold_resnet1d_l1",
    "fold_resnet1d_l1_arrays",
    "load_flax_mlp",
    "load_flax_resnet",
    "make_residual_fn",
    "mlp_forward",
    "residual_from_train_state",
]
