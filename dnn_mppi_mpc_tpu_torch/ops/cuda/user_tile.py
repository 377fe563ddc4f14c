"""Trace a tile step of the user's into a CUDA functor for the generic kernels.

The JAX generic tick takes any Python tile step and traces it into its
Pallas kernel (``dnn_mppi_mpc_tpu/ops/pallas/generic_tick.py:1-20``): a
``lift_dynamics`` step around any F(x, u), or a
``lift_dynamics_time_varying`` step around F(x, u, t). This module is the
port's counterpart, a small compiler. :func:`lower` traces the step with
``torch.fx.experimental.proxy_tensor.make_fx`` on fake tensors (nx + nu
float32 tiles of shape (K,), and a 0-d int32 ``t`` when the step takes the
rollout step) to a graph of ATen ops, and emits one C++ statement per node,
in graph order and in the node's own dtype, as a functor shaped like the
four hand-written ones of ``csrc/generic_rollout.cuh``::

    struct DmmUserTile_<hash> {
      static constexpr int NX, NU;
      static constexpr bool TAKES_T;
      __device__ void step(float* x, const float* v[, int t]) const;
    };

``_build.load_user_kernels`` compiles ``csrc/generic_kernels.cu`` around
that header into a library of its own (rows 8 and 9: ``dmm_generic_tick``
and ``dmm_generic_rollout_costs`` on the generated functor), keyed by a hash
of the header. Fake tensors carry no values, so a step that branches in
Python on a tensor's value, or reads one with ``int()``, ``float()`` or
``.item()``, fails the trace, as it fails JAX's.

Rounding. The library is built ``-fmad=false``, and each node becomes the
operation PyTorch runs on a CPU tensor of the node's compute dtype: a Python
number rounded to that dtype, a division a division, ``pow`` by 2, 3, −2,
0.5, −0.5 and −1 as PyTorch writes them (products, a quotient, a square
root), ``clamp`` as ``min(max(x, lo), hi)`` and ``minimum`` / ``maximum``
passing NaN on. sin and cos go through ``sincosf`` and tan through ``tanf``,
as the built-in functors call them; atan, atan2, exp, log, tanh, sigmoid
and a general power through the ``dmm_user_*`` functions of
generic_rollout.cuh (``atanf``, ``atan2f``, ``expf``, ``logf``, ``tanhf``,
1 / (1 + ``expf``(−x)), ``powf``), which the CPU emulator of the tests points
at PyTorch's; ``relu`` as ``x < 0 ? 0 : x`` (NaN and −0 pass, as PyTorch's).
So the generated kernel rounds like its plain twin on CPU tensors, bit for
bit where PyTorch's own math gives an element the same bits alone as inside
a tensor (all but atan2 and a general power; the emulator takes sigmoid
inside a tensor). On CUDA tensors PyTorch multiplies by the reciprocal of a
Python-number divisor, and the kernel divides: there the plain twin may be
an ulp off the kernel where a step divides by a number.

Values. A tensor of the trace is (), (K,), (K, n) or (n,); its lanes are the
n entries of its last axis (one for () and (K,)), each a register of the
thread that runs the sample. ``select``, ``slice``, ``unbind``, ``stack``,
``cat``, ``unsqueeze``, ``squeeze``, ``expand`` and views work on the last
axis and move lanes, emitting nothing. A captured tensor of one or a few
values is baked in as literals, hexadecimal for floats.

Products. ``mm``, ``addmm``, ``linear``, ``mv`` and ``matmul`` of a (K, n)
lane block by a captured float32 tensor (through ``t``, ``permute`` or
``transpose``) lower to one statement per output lane, the dot product
Σ_k x_k·W[k, j] summed in k order from k = 0, then + b_j where the op adds a
bias: ``x0 * W0j + x1 * W1j + ... + bj``, each product and sum rounded on
its own. The step's weights (every captured tensor a product reads, or of
more than one axis, or of more than :data:`MAX_CONSTANT_LANES` values) are
one float32 device buffer (``w``, packed in the order the functor first
reads them, :func:`weight_buffer`), which the block stages in shared memory;
above :data:`MAX_WEIGHTS` values the step is refused, naming the count (the
products are unrolled, so the functor's length grows with its weights).
The weights are not in the header, so a step of the same shape with other
weights builds no new library. The plain twin runs the products in that
order too, up to MAX_WEIGHTS values (:func:`functor_order`), so the
emulator holds it bit for bit.

Captured tensors are read at lowering and copied: the buffer is packed at
the step's first launch on a device, and packed again at a launch after a
weight changed in place (its version counter or its storage moved, as an
optimizer step or ``load_state_dict`` moves them). A write through
``.data`` moves neither and is not seen; a tensor baked in as literals that
changed raises ``ValueError`` naming it (lift the step anew).

Devices. The step is traced on fake CPU tiles, or on fake CUDA tiles when
the step captures card tensors (its weights on the card).

Refused: any other ATen op raises ``ValueError`` naming it — ``argmax`` and
``gather`` (``irk_step``'s pivoted solve), a reduction, an in-place update, a
product of two traced values —, as does a step that returns another number
of state dims than nx, or one that is not (K,) float32. Nothing falls back.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import operator
import threading
from typing import Callable, Optional

from torch.utils._python_dispatch import TorchDispatchMode

import numpy as np
import torch

# The samples of the fake tiles: a prime that no lane axis is likely to equal.
K_TRACE = 1031
# A captured tensor that no product reads is baked in as literals up to this
# many values (and of at most one axis).
MAX_CONSTANT_LANES = 64
# The step's weights (the values of every captured tensor a product reads, or
# that passes MAX_CONSTANT_LANES or has two axes): one device buffer, staged
# in shared memory (64 KB at most; the rollout's other staging is under
# 48 KB); refused above MAX_WEIGHTS, where the unrolled products (one multiply
# and one add a weight) make the functor too long to build at the step's
# first use.
MAX_WEIGHTS = 16384

_CTYPES = {torch.float32: "float", torch.float64: "double", torch.int32: "int",
           torch.int64: "long long", torch.bool: "bool"}

aten = torch.ops.aten
_TRACING = threading.Lock()
# the device of the fake tiles for a step that captures card tensors
_CARD = "cuda"


@dataclasses.dataclass(frozen=True)
class UserTile:
    """A lowered tile step: the functor's name, its widths, and the header
    (``dmm_user_tile.cuh``) that defines it and ``DmmUserTile``."""

    name: str
    nx: int
    nu: int
    takes_t: bool
    header: str
    ops: tuple  # the ATen ops of the trace, in graph order
    # the weights the functor reads from its device buffer, in its order, and
    # the products' multiply-adds a step
    weights: np.ndarray = dataclasses.field(compare=False, repr=False,
                                            default_factory=lambda: np.zeros(0, np.float32))
    macs: int = 0
    # the captured tensors the functor holds (_Captured), as they were read
    captured: tuple = dataclasses.field(compare=False, repr=False, default=())
    _buffers: dict = dataclasses.field(compare=False, repr=False, default_factory=dict)


@dataclasses.dataclass
class _Captured:
    """A captured tensor of the step: its get_attr target, the tensor, its
    version counter and storage when its values were read, and, for a weight,
    the buffer slots its flat elements fill (None where they are literals)."""

    name: str
    tensor: torch.Tensor
    version: int
    ptr: int
    slots: Optional[np.ndarray] = None
    flat: Optional[np.ndarray] = None

    def changed(self) -> bool:
        return self.tensor._version != self.version or self.tensor.data_ptr() != self.ptr


@dataclasses.dataclass
class _Val:
    """A traced tensor: its dtype, one C expression per lane, and whether its
    shape has a lane axis (the last)."""

    dtype: torch.dtype
    lanes: list
    axis: bool


@dataclasses.dataclass
class _Const:
    """A captured weight tensor, as a product reads it: the get_attr target
    of its source and, for each element of this view, the flat index of the
    source's element (a transpose permutes them)."""

    src: str
    index: np.ndarray


class _Refused(ValueError):
    pass


def _refuse(node, why: str):
    raise _Refused(f"{node.target} ({why}): the generated CUDA functor cannot run it")


def _shape_kind(node, shape) -> tuple[bool, int]:
    """(has a lane axis, lane count) of a traced shape; raise for a shape the
    functor does not hold."""
    shape = tuple(int(s) for s in shape)
    if shape == ():
        return False, 1
    if shape == (K_TRACE,):
        return False, 1
    if len(shape) == 1:
        return True, shape[0]
    if len(shape) == 2 and shape[0] == K_TRACE and shape[1] != K_TRACE:
        return True, shape[1]
    _refuse(node, f"a tensor of shape {shape} — a tile step computes on (), (K,), (K, n) "
                  "and (n,) tensors, each sample apart")


def _ctype(node, dtype: torch.dtype) -> str:
    if dtype not in _CTYPES:
        _refuse(node, f"dtype {dtype}: the functor computes in float32, float64, int32, "
                      "int64 and bool")
    return _CTYPES[dtype]


def _float_literal(v: float, dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        f = np.float32(v)
        if np.isfinite(f):
            return f"{float(f).hex()}f"
        return f"dmm_user_bits(0x{int(f.view(np.uint32)):08x}u)"
    if np.isfinite(v):
        return float(v).hex()
    return f"static_cast<double>(dmm_user_bits(0x{int(np.float32(v).view(np.uint32)):08x}u))"


def _literal(node, v, dtype: torch.dtype) -> str:
    _ctype(node, dtype)
    if dtype == torch.bool:
        return "true" if bool(v) else "false"
    if dtype in (torch.float32, torch.float64):
        return _float_literal(float(v), dtype)
    if isinstance(v, float) and not float(v).is_integer():
        _refuse(node, f"the number {v} in an integer op")
    suffix = "LL" if dtype == torch.int64 else ""
    return f"{int(v)}{suffix}"


def _cast(expr: str, src: torch.dtype, dst: torch.dtype) -> str:
    return expr if src == dst else f"static_cast<{_CTYPES[dst]}>({expr})"


def _result_type(a, b) -> torch.dtype:
    """PyTorch's promotion of two operands, traced tensors (by dtype and
    whether they are 0-d) or Python numbers: the dtype a comparison of them
    computes in."""
    def stand_in(x):
        if isinstance(x, torch.Tensor):
            return torch.empty(() if x.dim() == 0 else (1,), dtype=x.dtype)
        return x

    return torch.result_type(stand_in(a), stand_in(b))


# --- the emitter ---------------------------------------------------------------


class _Emitter:
    def __init__(self, gm: torch.fx.GraphModule, weights: dict):
        self.gm = gm
        self.lines: list = []
        self.count = 0
        self.trig: dict = {}  # float argument → (sin, cos) names of one sincosf
        self.env: dict = {}
        self.wvals = weights  # get_attr target → its float32 values, flat
        self.literals: list = []  # the captured tensors baked in as literals
        self.slots: dict = {}  # (target, flat index) → its place in the buffer
        self.packed: list = []  # the buffer's values, in the functor's first-read order
        self.macs = 0

    def weight(self, c: _Const, i) -> str:
        """Element ``i`` of weight view ``c``: its read from the buffer,
        where it gets a place at its first read."""
        flat = int(c.index[i])
        slot = self.slots.get((c.src, flat))
        if slot is None:
            slot = self.slots[(c.src, flat)] = len(self.packed)
            self.packed.append(self.wvals[c.src][flat])
        return f"w[{slot}]"

    def lanes_of(self, node, c: _Const) -> _Val:
        """A weight view read elementwise: a 0-d or 1-d one as lanes."""
        if c.index.ndim > 1:
            _refuse(node, f"a captured {c.index.shape} matrix read other than by a matrix "
                          "product")
        return _Val(torch.float32, [self.weight(c, i) for i in np.ndindex(*c.index.shape)],
                    c.index.ndim == 1)

    def stmt(self, node, dtype: torch.dtype, expr: str) -> str:
        name = f"n{self.count}"
        self.count += 1
        self.lines.append(f"    const {_ctype(node, dtype)} {name} = {expr};  // {node.target}")
        return name

    def operand(self, node, a, j: int, dtype: torch.dtype) -> Optional[str]:
        """Lane j of argument ``a`` (a traced value or a Python number) in
        ``dtype``."""
        if a is None:
            return None
        if isinstance(a, _Val):
            expr = a.lanes[j if len(a.lanes) > 1 else 0]
            return _cast(expr, a.dtype, dtype)
        if isinstance(a, (bool, int, float)):
            return _literal(node, a, dtype)
        _refuse(node, f"an argument of type {type(a).__name__}")

    def meta(self, node):
        return node.meta["val"]

    def elementwise(self, node, args, fmt: Callable, dtypes=None) -> _Val:
        """One statement a lane: ``fmt`` of the arguments' lanes, each cast to
        its compute dtype (``dtypes``, default the node's dtype)."""
        out = self.meta(node)
        axis, n = _shape_kind(node, out.shape)
        dtypes = dtypes or [out.dtype] * len(args)
        lanes = []
        for j in range(n):
            ops = [self.operand(node, a, j, d) for a, d in zip(args, dtypes)]
            lanes.append(self.stmt(node, out.dtype, fmt(*ops)))
        return _Val(out.dtype, lanes, axis)

    def trig_of(self, node, x: str, which: int) -> str:
        """sin (0) or cos (1) of the float ``x``: one sincosf per argument."""
        if x not in self.trig:
            s, c = f"s{self.count}", f"c{self.count}"
            self.count += 1
            self.lines.append(f"    float {s}, {c};")
            self.lines.append(f"    sincosf({x}, &{s}, &{c});  // {node.target}")
            self.trig[x] = (s, c)
        return self.trig[x][which]


def _alpha(node, args, kwargs) -> None:
    alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
    if alpha != 1:
        _refuse(node, f"alpha={alpha}: write the product out")


def _math(fname: str, dname: str):
    """A unary math function: ``fname`` in float32, ``dname`` in float64."""
    def lower(em, node, args, kwargs):
        dt = em.meta(node).dtype
        name = fname if dt == torch.float32 else dname
        if dt not in (torch.float32, torch.float64):
            _refuse(node, f"{node.target} in {dt}")
        return em.elementwise(node, args[:1], lambda a: f"{name}({a})")
    return lower


def _trig(which: int, dname: str):
    def lower(em, node, args, kwargs):
        dt = em.meta(node).dtype
        if dt == torch.float64:
            return em.elementwise(node, args[:1], lambda a: f"{dname}({a})")
        if dt != torch.float32:
            _refuse(node, f"{node.target} in {dt}")
        out = em.meta(node)
        axis, n = _shape_kind(node, out.shape)
        lanes = [em.trig_of(node, em.operand(node, args[0], j, dt), which) for j in range(n)]
        return _Val(dt, lanes, axis)
    return lower


def _binary(fmt: Callable, alpha: bool = False, swap: bool = False):
    def lower(em, node, args, kwargs):
        if alpha:
            _alpha(node, args, kwargs)
        a, b = (args[1], args[0]) if swap else (args[0], args[1])
        return em.elementwise(node, [a, b], fmt)
    return lower


def _compare(op: str):
    def lower(em, node, args, kwargs):
        cdt = _result_type(*[em.meta(a) if isinstance(a, torch.fx.Node) else a
                             for a in node.args[:2]])
        return em.elementwise(node, args[:2], lambda a, b: f"{a} {op} {b}", [cdt, cdt])
    return lower


def _logical(fmt: Callable, n_args: int):
    def lower(em, node, args, kwargs):
        return em.elementwise(node, args[:n_args], fmt, [torch.bool] * n_args)
    return lower


def _bitwise(bool_fmt: Callable, int_fmt: Callable, n_args: int):
    def lower(em, node, args, kwargs):
        dt = em.meta(node).dtype
        if dt == torch.bool:
            return em.elementwise(node, args[:n_args], bool_fmt)
        if dt in (torch.int32, torch.int64):
            return em.elementwise(node, args[:n_args], int_fmt)
        _refuse(node, f"a bitwise op in {dt}")
    return lower


def _is_float(dt) -> bool:
    return dt in (torch.float32, torch.float64)


def _div(em, node, args, kwargs):
    mode = kwargs.get("rounding_mode", args[2] if len(args) > 2 else None)
    if mode is not None:
        _refuse(node, f"rounding_mode={mode!r}")
    return em.elementwise(node, args[:2], lambda a, b: f"{a} / {b}")


def _neg(em, node, args, kwargs):
    if em.meta(node).dtype == torch.bool:
        _refuse(node, "negating a bool tensor")
    return em.elementwise(node, args[:1], lambda a: f"-{a}")


def _reciprocal(em, node, args, kwargs):
    one = _literal(node, 1.0, em.meta(node).dtype)
    return em.elementwise(node, args[:1], lambda a: f"{one} / {a}")


def _rsqrt(em, node, args, kwargs):
    dt = em.meta(node).dtype
    one, sq = _literal(node, 1.0, dt), "sqrtf" if dt == torch.float32 else "sqrt"
    return em.elementwise(node, args[:1], lambda a: f"{one} / {sq}({a})")


def _pow(em, node, args, kwargs):
    """pow(x, e) for a Python number e, as PyTorch's kernel writes it."""
    dt = em.meta(node).dtype
    e = args[1]
    if not _is_float(dt) or not isinstance(e, (int, float)) or isinstance(e, bool):
        _refuse(node, "pow takes a float tensor and a Python-number exponent here")
    one = _literal(node, 1.0, dt)
    sq = "sqrtf" if dt == torch.float32 else "sqrt"
    special = {2: lambda a: f"{a} * {a}", 3: lambda a: f"{a} * {a} * {a}",
               -2: lambda a: f"{one} / ({a} * {a})", 0.5: lambda a: f"{sq}({a})",
               -0.5: lambda a: f"{one} / {sq}({a})", -1: lambda a: f"{one} / {a}"}
    if e in special:
        return em.elementwise(node, args[:1], special[e])
    name = "dmm_user_pow" if dt == torch.float32 else "pow"
    lit = _literal(node, e, dt)
    return em.elementwise(node, args[:1], lambda a: f"{name}({a}, {lit})")


def _atan2(em, node, args, kwargs):
    if em.meta(node).dtype != torch.float32:
        _refuse(node, "atan2 outside float32")
    return em.elementwise(node, args[:2], lambda a, b: f"dmm_user_atan2({a}, {b})")


def _abs(em, node, args, kwargs):
    dt = em.meta(node).dtype
    if dt == torch.bool:
        return em.elementwise(node, args[:1], lambda a: a)
    if _is_float(dt):
        name = "fabsf" if dt == torch.float32 else "fabs"
        return em.elementwise(node, args[:1], lambda a: f"{name}({a})")
    return em.elementwise(node, args[:1], lambda a: f"({a} < 0 ? -{a} : {a})")


def _rounding(fname: str):
    def lower(em, node, args, kwargs):
        dt = em.meta(node).dtype
        if not _is_float(dt):  # an integer is its own floor and ceiling
            return em.elementwise(node, args[:1], lambda a: a)
        name = fname + "f" if dt == torch.float32 else fname
        return em.elementwise(node, args[:1], lambda a: f"{name}({a})")
    return lower


def _extremum(helper: str, pick: str):
    """minimum / maximum: NaN passes on in floats (``dmm_user_min`` /
    ``dmm_user_max``); in integers ``pick`` (b < a or a < b) picks b."""
    def lower(em, node, args, kwargs):
        dt = em.meta(node).dtype
        if dt == torch.float32:
            return em.elementwise(node, args[:2], lambda a, b: f"{helper}({a}, {b})")
        if dt == torch.float64:
            _refuse(node, "minimum / maximum in float64")
        return em.elementwise(node, args[:2],
                              lambda a, b: f"({pick.format(a=a, b=b)} ? {b} : {a})")
    return lower


def _clamp(em, node, args, kwargs):
    """clamp(x, lo, hi) as PyTorch's CPU kernel: min(max(x, lo), hi) with
    std::max(x, lo) = x < lo ? lo : x, so a NaN x passes on; a tensor bound
    that is NaN gives NaN, as in PyTorch."""
    target = node.target
    lo = kwargs.get("min", args[1] if len(args) > 1 else None)
    hi = kwargs.get("max", args[2] if len(args) > 2 else None)
    if target.overloadpacket is aten.clamp_min:
        lo, hi = args[1], None
    elif target.overloadpacket is aten.clamp_max:
        lo, hi = None, args[1]
    tensor_bounds = isinstance(lo, _Val) or isinstance(hi, _Val)
    dt = em.meta(node).dtype
    nan = _literal(node, float("nan"), dt) if _is_float(dt) else None

    def fmt(a, lo_, hi_):
        m = a if lo_ is None else f"({a} < {lo_} ? {lo_} : {a})"
        m = m if hi_ is None else f"({hi_} < {m} ? {hi_} : {m})"
        if tensor_bounds and nan is not None:
            bad = " || ".join(f"{b} != {b}" for b in (lo_, hi_) if b is not None)
            m = f"({bad}) ? {nan} : {m}"
        return m

    return em.elementwise(node, [args[0], lo, hi], fmt)


def _where(em, node, args, kwargs):
    dt = em.meta(node).dtype
    return em.elementwise(node, args[:3], lambda c, a, b: f"{c} ? {a} : {b}",
                          [torch.bool, dt, dt])


def _filled(value_of: Callable):
    """full_like / zeros_like / ones_like / full / zeros / ones /
    scalar_tensor: every lane the literal of the node's dtype."""
    def lower(em, node, args, kwargs):
        out = em.meta(node)
        axis, n = _shape_kind(node, out.shape)
        lit = _literal(node, value_of(args, kwargs), out.dtype)
        return _Val(out.dtype, [lit] * n, axis)
    return lower


def _copy(em, node, args, kwargs):
    """clone, alias, detach, lift_fresh_copy, _to_copy, to: the same lanes,
    cast to the node's dtype (a statement a lane where the dtype changes);
    a captured weight tensor as itself (on any device), in float32."""
    a, out = args[0], em.meta(node)
    if isinstance(a, _Const):
        if out.dtype != torch.float32:
            _refuse(node, f"a cast of captured weights to {out.dtype}")
        return a
    if not isinstance(a, _Val):
        _refuse(node, "a copy of a non-tensor")
    if a.dtype == out.dtype:
        return _Val(a.dtype, list(a.lanes), a.axis)
    return em.elementwise(node, [a], lambda x: x, [out.dtype])


def _lane_dim(node, dim: int, ndim: int) -> int:
    """``dim`` normalised; raise unless it is the last of ``ndim`` axes."""
    d = dim + ndim if dim < 0 else dim
    if ndim == 0 or d != ndim - 1:
        _refuse(node, f"dim {dim} of a {ndim}-d tensor: the functor moves lanes along the "
                      "last axis only, each sample apart")
    return d


def _in_meta(node, i: int = 0):
    return node.args[i].meta["val"]


def _select(em, node, args, kwargs):
    a = args[0]
    _lane_dim(node, args[1], _in_meta(node).dim())
    if not a.axis:
        _refuse(node, "select of a sample")
    idx = args[2] + len(a.lanes) if args[2] < 0 else args[2]
    return _Val(a.dtype, [a.lanes[idx]], False)


def _slice(em, node, args, kwargs):
    a = args[0]
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    _lane_dim(node, dim, _in_meta(node).dim())
    start = args[2] if len(args) > 2 else kwargs.get("start")
    end = args[3] if len(args) > 3 else kwargs.get("end")
    step = args[4] if len(args) > 4 else kwargs.get("step", 1)
    if not a.axis:
        _refuse(node, "slice of the samples")
    return _Val(a.dtype, a.lanes[slice(start, end, step)], True)


def _stack(em, node, args, kwargs):
    out = em.meta(node)
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    _lane_dim(node, dim, out.dim())
    vals = args[0]
    if any(v.axis for v in vals):
        _refuse(node, "stacking tensors that have a lane axis")
    return _Val(out.dtype, [_cast(v.lanes[0], v.dtype, out.dtype) for v in vals], True)


def _cat(em, node, args, kwargs):
    out = em.meta(node)
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    _lane_dim(node, dim, out.dim())
    lanes = []
    for v in args[0]:
        lanes += [_cast(x, v.dtype, out.dtype) for x in v.lanes]
    return _Val(out.dtype, lanes, True)


def _unbind(em, node, args, kwargs):
    a = args[0]
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    _lane_dim(node, dim, _in_meta(node).dim())
    if not a.axis:
        _refuse(node, "unbind of the samples")
    return [_Val(a.dtype, [x], False) for x in a.lanes]


def _same_lanes(em, node, args, kwargs):
    """A view (unsqueeze, squeeze, view, reshape): allowed where it keeps the
    samples and the lanes, as a trailing axis of one added or removed."""
    a, out, src = args[0], em.meta(node), _in_meta(node)
    axis, n = _shape_kind(node, out.shape)
    per_in = src.dim() > 0 and int(src.shape[0]) == K_TRACE
    per_out = out.dim() > 0 and int(out.shape[0]) == K_TRACE
    if per_in != per_out or n != len(a.lanes):
        _refuse(node, f"a view from {tuple(src.shape)} to {tuple(out.shape)} that mixes "
                      "samples and lanes")
    return _Val(a.dtype, list(a.lanes), axis)


def _expand(em, node, args, kwargs):
    a, out = args[0], em.meta(node)
    axis, n = _shape_kind(node, out.shape)
    if len(a.lanes) not in (1, n):
        _refuse(node, f"expand of {len(a.lanes)} lanes to {n}")
    return _Val(a.dtype, a.lanes * n if len(a.lanes) == 1 else list(a.lanes), axis)


def _relu(em, node, args, kwargs):
    dt = em.meta(node).dtype
    if not _is_float(dt):
        _refuse(node, f"relu in {dt}")
    zero = _literal(node, 0.0, dt)
    return em.elementwise(node, args[:1], lambda a: f"{a} < {zero} ? {zero} : {a}")


def _sigmoid(em, node, args, kwargs):
    if em.meta(node).dtype != torch.float32:
        _refuse(node, "sigmoid outside float32")
    return em.elementwise(node, args[:1], lambda a: f"dmm_user_sigmoid({a})")


# --- matrix products ------------------------------------------------------------


def _transpose(em, node, args, kwargs):
    """t / permute / transpose of a captured weight tensor: a view of its
    elements (nothing is emitted); of a traced value only where it moves no
    axis (0-d and 1-d ``t``)."""
    a = args[0]
    packet = _packet(node)
    if isinstance(a, _Const):
        if packet is aten.permute:
            return _Const(a.src, np.transpose(a.index, args[1]))
        if packet is aten.transpose:
            return _Const(a.src, np.swapaxes(a.index, args[1], args[2]))
        return _Const(a.src, a.index.T)
    if packet is aten.t and _in_meta(node).dim() < 2:
        return a
    _refuse(node, "a transpose of a traced value: the functor transposes captured weights only")


def _block(em, node, a, i: int = 0) -> _Val:
    """The product's traced operand: a float32 (K, n) lane block."""
    shape = tuple(int(d) for d in _in_meta(node, i).shape)
    if not isinstance(a, _Val) or len(shape) != 2 or shape[0] != K_TRACE:
        _refuse(node, f"a product whose operand {i} is of shape {shape}: a tile step "
                      "multiplies a (K, n) block of traced values by a captured tensor")
    if a.dtype != torch.float32:
        _refuse(node, f"a product in {a.dtype}: the functor's products are float32")
    return a


def _weights(node, c, shape: tuple) -> _Const:
    if not isinstance(c, _Const):
        _refuse(node, "a product of two traced values: one operand of a tile step's product "
                      "is a captured tensor (its weights)")
    if c.index.shape != shape:
        _refuse(node, f"a product with weights of shape {c.index.shape}, expected {shape}")
    return c


def _dot(em, node, x: _Val, W: _Const, bias=None) -> _Val:
    """Output lane j = x0 * W[0, j] + x1 * W[1, j] + ... (+ bias_j): the
    sum in k order from k = 0, one statement a lane; W (n, m), or (n,) for
    one lane without a lane axis; ``bias`` traced lanes or captured (one
    value a lane, or one for all)."""
    out = em.meta(node)
    axis, m = _shape_kind(node, out.shape)
    cols = W.index if W.index.ndim == 2 else W.index[:, None]
    n = cols.shape[0]
    lanes = []
    for j in range(m):
        terms = [f"{x.lanes[k]} * {em.weight(_Const(W.src, cols[:, j]), k)}" for k in range(n)]
        if isinstance(bias, _Const):  # read where the lane adds it: the buffer's order
            flat = bias.index.reshape(-1)
            terms.append(em.weight(_Const(bias.src, flat), j if flat.size > 1 else 0))
        elif bias is not None:
            terms.append(em.operand(node, bias, j, torch.float32))
        lanes.append(em.stmt(node, torch.float32, " + ".join(terms)))
    em.macs += n * m
    return _Val(torch.float32, lanes, axis)


def _mm(em, node, args, kwargs):
    x = _block(em, node, args[0])
    return _dot(em, node, x, _weights(node, args[1], (len(x.lanes), em.meta(node).shape[-1])))


def _addmm(em, node, args, kwargs):
    for name, i in (("beta", 3), ("alpha", 4)):
        v = kwargs.get(name, args[i] if len(args) > i else 1)
        if v != 1:
            _refuse(node, f"{name}={v}: write the scaling out")
    x = _block(em, node, args[1], 1)
    W = _weights(node, args[2], (len(x.lanes), em.meta(node).shape[-1]))
    return _dot(em, node, x, W, args[0])


def _linear(em, node, args, kwargs):
    x = _block(em, node, args[0])
    w = _weights(node, args[1], (em.meta(node).shape[-1], len(x.lanes)))
    bias = kwargs.get("bias", args[2] if len(args) > 2 else None)
    return _dot(em, node, x, _Const(w.src, w.index.T), bias)


def _mv(em, node, args, kwargs):
    x = _block(em, node, args[0])
    return _dot(em, node, x, _weights(node, args[1], (len(x.lanes),)))


def _matmul(em, node, args, kwargs):
    if isinstance(args[1], _Const) and args[1].index.ndim == 1:
        return _mv(em, node, args, kwargs)
    return _mm(em, node, args, kwargs)


def _fill_value(i: int, default=None):
    return lambda args, kwargs: kwargs.get("fill_value", args[i] if len(args) > i else default)


_LOWER = {
    aten.add: _binary(lambda a, b: f"{a} + {b}", alpha=True),
    aten.sub: _binary(lambda a, b: f"{a} - {b}", alpha=True),
    aten.rsub: _binary(lambda a, b: f"{a} - {b}", alpha=True, swap=True),
    aten.mul: _binary(lambda a, b: f"{a} * {b}"),
    aten.div: _div,
    aten.true_divide: _div,
    aten.neg: _neg,
    aten.reciprocal: _reciprocal,
    aten.pow: _pow,
    aten.sqrt: _math("sqrtf", "sqrt"),
    aten.rsqrt: _rsqrt,
    aten.sin: _trig(0, "sin"),
    aten.cos: _trig(1, "cos"),
    aten.tan: _math("tanf", "tan"),
    aten.atan: _math("dmm_user_atan", "atan"),
    aten.atan2: _atan2,
    aten.exp: _math("dmm_user_exp", "exp"),
    aten.log: _math("dmm_user_log", "log"),
    aten.tanh: _math("dmm_user_tanh", "tanh"),
    aten.abs: _abs,
    aten.floor: _rounding("floor"),
    aten.ceil: _rounding("ceil"),
    aten.minimum: _extremum("dmm_user_min", "{b} < {a}"),
    aten.maximum: _extremum("dmm_user_max", "{a} < {b}"),
    aten.clamp: _clamp,
    aten.clamp_min: _clamp,
    aten.clamp_max: _clamp,
    aten.eq: _compare("=="),
    aten.ne: _compare("!="),
    aten.lt: _compare("<"),
    aten.le: _compare("<="),
    aten.gt: _compare(">"),
    aten.ge: _compare(">="),
    aten.logical_and: _logical(lambda a, b: f"{a} && {b}", 2),
    aten.logical_or: _logical(lambda a, b: f"{a} || {b}", 2),
    aten.logical_xor: _logical(lambda a, b: f"{a} != {b}", 2),
    aten.logical_not: _logical(lambda a: f"!{a}", 1),
    aten.bitwise_and: _bitwise(lambda a, b: f"{a} && {b}", lambda a, b: f"{a} & {b}", 2),
    aten.bitwise_or: _bitwise(lambda a, b: f"{a} || {b}", lambda a, b: f"{a} | {b}", 2),
    aten.bitwise_xor: _bitwise(lambda a, b: f"{a} != {b}", lambda a, b: f"{a} ^ {b}", 2),
    aten.bitwise_not: _bitwise(lambda a: f"!{a}", lambda a: f"~{a}", 1),
    aten.where: _where,
    aten.full_like: _filled(_fill_value(1)),
    aten.zeros_like: _filled(lambda args, kwargs: 0),
    aten.ones_like: _filled(lambda args, kwargs: 1),
    aten.full: _filled(_fill_value(1)),
    aten.zeros: _filled(lambda args, kwargs: 0),
    aten.ones: _filled(lambda args, kwargs: 1),
    aten.scalar_tensor: _filled(lambda args, kwargs: args[0]),
    aten.clone: _copy,
    aten.alias: _copy,
    aten.detach: _copy,
    aten.lift_fresh_copy: _copy,
    aten._to_copy: _copy,
    aten.to: _copy,
    aten.select: _select,
    aten.slice: _slice,
    aten.stack: _stack,
    aten.cat: _cat,
    aten.unbind: _unbind,
    aten.unsqueeze: _same_lanes,
    aten.squeeze: _same_lanes,
    aten.view: _same_lanes,
    aten._unsafe_view: _same_lanes,
    aten.reshape: _same_lanes,
    aten.expand: _expand,
    aten.relu: _relu,
    aten.sigmoid: _sigmoid,
    aten.t: _transpose,
    aten.permute: _transpose,
    aten.transpose: _transpose,
    aten.mm: _mm,
    aten.addmm: _addmm,
    aten.linear: _linear,
    aten.mv: _mv,
    aten.matmul: _matmul,
}
# the ops that read a captured weight tensor as such (the rest read it as lanes)
_PRODUCTS = (aten.mm, aten.addmm, aten.linear, aten.mv, aten.matmul)
_WEIGHT_VIEWS = (aten.t, aten.permute, aten.transpose, aten.detach, aten.clone, aten.alias,
                 aten.lift_fresh_copy, aten._to_copy, aten.to)

# what the error message offers instead
SUPPORTED = ("add, sub, mul, div, neg, pow by a number, sin, cos, tan, atan, atan2, exp, "
             "log, sqrt, tanh, sigmoid, relu, abs, floor, minimum, maximum, clamp, "
             "comparisons, logical ops, where, full_like / zeros_like / ones_like, scalar "
             "tensors, dtype casts, select, slice, stack, cat, unsqueeze, expand and unbind "
             "on the last axis, and matrix products (mm, addmm, linear, mv, matmul, through "
             "t / permute / transpose) of a (K, n) block by captured float32 weights, up to "
             f"{MAX_WEIGHTS} weight values")


def _packet(node):
    return getattr(node.target, "overloadpacket", None)


def _resolve(em: _Emitter, a):
    if isinstance(a, torch.fx.Node):
        return em.env[a]
    if isinstance(a, (list, tuple)):
        return [_resolve(em, x) for x in a]
    return a


def _constant(em: _Emitter, node):
    if node.target in em.wvals:
        value = getattr(em.gm, node.target)
        return _Const(node.target, np.arange(value.numel()).reshape(tuple(value.shape)))
    value = getattr(em.gm, node.target)
    if not isinstance(value, torch.Tensor) or value.dim() > 1:
        _refuse(node, "a captured tensor of more than one axis that no product reads")
    em.literals.append((node.target, value))
    vals = value.detach().cpu().reshape(-1).tolist()
    return _Val(value.dtype, [_literal(node, v, value.dtype) for v in vals], value.dim() == 1)


def _weight_tensors(gm: torch.fx.GraphModule) -> dict:
    """get_attr target → captured tensor, for each of the step's weights:
    a tensor a product reads (through views and copies), or of two or more
    axes, or of more than MAX_CONSTANT_LANES values."""
    def read_by_product(node) -> bool:
        return any(_packet(user) in _PRODUCTS
                   or (_packet(user) in _WEIGHT_VIEWS and read_by_product(user))
                   for user in node.users)

    out = {}
    for node in gm.graph.nodes:
        if node.op != "get_attr":
            continue
        value = getattr(gm, node.target)
        if isinstance(value, torch.Tensor) and (
                value.dim() > 1 or value.numel() > MAX_CONSTANT_LANES or read_by_product(node)):
            out[node.target] = value
    return out


def _weight_values(gm: torch.fx.GraphModule, tensors: dict) -> dict:
    """The weights' float32 values by target; ``ValueError`` naming the
    count above MAX_WEIGHTS."""
    n = sum(v.numel() for v in tensors.values())
    if n > MAX_WEIGHTS:
        ops = sorted({str(node.target) for node in gm.graph.nodes if _packet(node) in _PRODUCTS})
        shapes = ", ".join(str(tuple(v.shape)) for v in tensors.values())
        raise ValueError(
            f"the tile step's matrix products ({', '.join(ops) or 'none'}) read {n} captured "
            f"weight values ({shapes}), above the generated functor's limit of {MAX_WEIGHTS}: "
            "it unrolls every product, one multiply and one add a weight. Run such a step "
            "on the scan path, or in the plain version on CPU tensors"
        )
    for target, v in tensors.items():
        if v.dim() > 2 or v.dtype != torch.float32:
            raise ValueError(f"the tile step captures a {tuple(v.shape)} {v.dtype} weight "
                             "tensor: the generated functor's weights are float32 of at most "
                             "two axes")
    return {t: _flat_values(v) for t, v in tensors.items()}


def _flat_values(v: torch.Tensor) -> np.ndarray:
    return v.detach().to("cpu", torch.float32).reshape(-1).numpy()


# how fake tensors report operands on two devices (by PyTorch version)
_MISMATCH = ("Expected all tensors to be on the same device", "found two different devices")


def _device_mismatch(e: Optional[BaseException]) -> bool:
    while e is not None:
        if any(text in str(e) for text in _MISMATCH):
            return True
        e = e.__cause__ or e.__context__
    return False


def _trace(step: Callable, nx: int, nu: int, takes_t: bool) -> torch.fx.GraphModule:
    """make_fx of the step on fake (K_TRACE,) tiles on the CPU, or on the
    card where the step captures card tensors (fake CUDA tiles need no
    card)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    def flat(*args):
        xs, vs = tuple(args[:nx]), tuple(args[nx:nx + nu])
        return tuple(step(xs, vs, args[-1]) if takes_t else step(xs, vs))

    def traced(device: str):
        with FakeTensorMode(allow_non_fake_inputs=True):
            inputs = [torch.zeros(K_TRACE, device=device) for _ in range(nx + nu)]
            if takes_t:
                inputs.append(torch.zeros((), dtype=torch.int32, device=device))
        return make_fx(flat, tracing_mode="fake", _allow_non_fake_inputs=True)(*inputs)

    try:
        with _TRACING:  # make_fx patches module state: one trace at a time
            try:
                gm = traced("cpu")
            except Exception as e:  # noqa: BLE001 - a step of card tensors
                if not _device_mismatch(e):
                    raise
                gm = traced(_CARD)
    except Exception as e:  # noqa: BLE001 - re-raised with the cause named
        first = str(e).strip().splitlines()[0] if str(e).strip() else ""
        raise ValueError(
            f"the tile step cannot be traced for the card ({type(e).__name__}: {first}). "
            "A step for the generic kernels computes with tensor operations on nx state and "
            "nu control tiles: Python control flow on a tensor's value, and int(), float() "
            "or .item() of a tensor, cannot be traced (data-dependent)"
        ) from e
    gm.graph.eliminate_dead_code()
    return gm


def _as_lanes(em: _Emitter, node, a):
    """``a`` with each captured weight view in it read as lanes."""
    if isinstance(a, _Const):
        return em.lanes_of(node, a)
    if isinstance(a, (list, tuple)):
        return [_as_lanes(em, node, x) for x in a]
    return a


def _emit(gm: torch.fx.GraphModule, nx: int, nu: int, takes_t: bool) -> _Emitter:
    """The emitter after the step's body: its statements, output lanes
    (``em.outs``), packed weights and multiply-adds."""
    nodes = list(gm.graph.nodes)
    bad = []
    for node in nodes:
        if node.op == "call_function" and node.target is not operator.getitem \
                and _packet(node) not in _LOWER and str(node.target) not in bad:
            bad.append(str(node.target))
    if bad:
        raise ValueError(
            f"the tile step calls {', '.join(bad)}, which the generated CUDA functor cannot "
            f"run on the card. A step for the card may use {SUPPORTED}. A linear solve "
            "(irk_step), a reduction or an in-place update has no lowering: run such a step "
            "on the scan path, or in the plain version on CPU tensors"
        )
    em = _Emitter(gm, _weight_values(gm, _weight_tensors(gm)))
    placeholders = [n for n in nodes if n.op == "placeholder"]
    for i, node in enumerate(placeholders):
        if i < nx:
            em.env[node] = _Val(torch.float32, [f"x{i}"], False)
            em.lines.append(f"    const float x{i} = x[{i}];")
        elif i < nx + nu:
            em.env[node] = _Val(torch.float32, [f"v[{i - nx}]"], False)
        else:
            em.env[node] = _Val(torch.int32, ["t"], False)
    outputs = None
    for node in nodes:
        if node.op == "get_attr":
            em.env[node] = _constant(em, node)
        elif node.op == "call_function":
            if node.target is operator.getitem:
                em.env[node] = em.env[node.args[0]][node.args[1]]
                continue
            args = [_resolve(em, a) for a in node.args]
            kwargs = {k: _resolve(em, v) for k, v in node.kwargs.items()}
            if _packet(node) not in _PRODUCTS + _WEIGHT_VIEWS:
                args, kwargs = _as_lanes(em, node, args), {
                    k: _as_lanes(em, node, v) for k, v in kwargs.items()}
            em.env[node] = _LOWER[_packet(node)](em, node, args, kwargs)
        elif node.op == "output":
            outputs = node.args[0]
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
    if len(outputs) != nx:
        raise ValueError(f"the tile step returned {len(outputs)} state dims, expected nx={nx}")
    lanes = []
    for i, out in enumerate(outputs):
        meta = out.meta.get("val") if isinstance(out, torch.fx.Node) else None
        if meta is None or tuple(meta.shape) != (K_TRACE,) or meta.dtype != torch.float32:
            got = "not a tensor" if meta is None else f"{tuple(meta.shape)} {meta.dtype}"
            raise ValueError(f"state dim {i} of the tile step is {got}, expected a (K,) "
                             "float32 tile")
        lanes.append(em.env[out].lanes[0])
    em.outs = lanes
    return em


def _header(nx: int, nu: int, takes_t: bool, em: _Emitter, ops: tuple) -> UserTile:
    """The header: the functor, its widths, its weights (WEIGHTS values at
    ``w``, staged in shared memory by the rollout) and its products'
    multiply-adds a step (MACS, which sets its lanes a sample,
    csrc/generic_kernels.cu GenericRule)."""
    args = "float* x, const float* v, int t" if takes_t else "float* x, const float* v"
    code = "\n".join(em.lines + [f"    x[{i}] = {o};" for i, o in enumerate(em.outs)])
    decl = (f"  static constexpr int NX = {nx}, NU = {nu}, WEIGHTS = {len(em.packed)}, "
            f"MACS = {em.macs};")
    digest = hashlib.sha256(f"{decl} {int(takes_t)}\n{code}".encode()).hexdigest()[:16]
    name = f"DmmUserTile_{digest}"
    header = "\n".join([
        "// Generated by dnn_mppi_mpc_tpu_torch/ops/cuda/user_tile.py from a traced tile",
        "// step: one statement per ATen node of the trace, in its order and dtype; a",
        "// matrix product one statement an output lane, x0 * W0j + x1 * W1j + ... (+ bj).",
        "#pragma once",
        "",
        f"struct {name} {{",
        decl,
        f"  static constexpr bool TAKES_T = {'true' if takes_t else 'false'};",
        "  const float* w;  // the WEIGHTS weights, staged in shared memory",
        f"  __device__ {name}(const float*, const float* weights) : w(weights) {{}}",
        f"  __device__ __forceinline__ void step({args}) const {{",
        code,
        "  }",
        "};",
        f"using DmmUserTile = {name};",
        "",
    ])
    slots: dict = {}
    for (src, flat), slot in em.slots.items():
        slots.setdefault(src, []).append((slot, flat))
    captured = [_Captured(src, t, t._version, t.data_ptr(),
                          np.array([s for s, _ in slots[src]], np.int64),
                          np.array([f for _, f in slots[src]], np.int64))
                for src, t in ((s, getattr(em.gm, s)) for s in slots)]
    captured += [_Captured(src, t, t._version, t.data_ptr()) for src, t in em.literals]
    return UserTile(name, nx, nu, takes_t, header, ops, np.asarray(em.packed, np.float32),
                    em.macs, tuple(captured))


def _lower(step: Callable, nx: int, nu: int, takes_t: bool) -> UserTile:
    gm = _trace(step, nx, nu, takes_t)
    try:
        em = _emit(gm, nx, nu, takes_t)
    except _Refused as e:
        raise ValueError(f"the tile step calls {e}. A step for the card may use "
                         f"{SUPPORTED}") from None
    ops = tuple(str(n.target) for n in gm.graph.nodes if n.op == "call_function")
    return _header(nx, nu, takes_t, em, ops)


@functools.lru_cache(maxsize=64)
def _lower_cached(step: Callable, nx: int, nu: int, takes_t: bool) -> UserTile:
    return _lower(step, nx, nu, takes_t)


def lower(step: Callable, nx: Optional[int], nu: Optional[int], takes_t: bool) -> UserTile:
    """The generated functor of tile step ``step`` (nx state and nu control
    tiles, and the rollout step ``t`` when ``takes_t``), or ``ValueError``
    naming what cannot run on the card. The same step lowers once."""
    if nx is None or nu is None:
        raise ValueError("a lifted tile step takes its widths from the config: pass nx and nu")
    try:
        hash(step)
    except TypeError:
        return _lower(step, int(nx), int(nu), bool(takes_t))
    return _lower_cached(step, int(nx), int(nu), bool(takes_t))


def weight_buffer(tile: UserTile, device: torch.device) -> Optional[torch.Tensor]:
    """The functor's weights on ``device`` (None where it reads none),
    packed at the step's first launch there, and packed again from the
    captured tensors where one changed in place since they were read (its
    version counter or storage; reading a card tensor then waits for the
    card). ``ValueError`` naming a captured tensor baked in as literals that
    changed."""
    stale = [c for c in tile.captured if c.changed()]
    for c in stale:
        if c.slots is None:
            raise ValueError(
                f"the tile step's captured tensor {c.name} {tuple(c.tensor.shape)} changed in "
                "place since the step was lowered, and its generated functor holds its values "
                "as literals: lift the step anew to run it on the card")
    for c in stale:
        tile.weights[c.slots] = _flat_values(c.tensor)[c.flat]
        c.version, c.ptr = c.tensor._version, c.tensor.data_ptr()
        tile._buffers.clear()
    if not len(tile.weights):
        return None
    buf = tile._buffers.get(device)
    if buf is None:
        buf = tile._buffers[device] = torch.tensor(tile.weights, device=device)  # a copy
    return buf


def _sequential_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (K, n) @ b (n, m) as the functor sums it: a[:, 0]·b[0] + a[:, 1]·b[1]
    + ..., each product and sum rounded on its own."""
    acc = a[:, :1] * b[:1]
    for k in range(1, a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k:k + 1]
    return acc


class _FunctorOrder(TorchDispatchMode):
    """mm, addmm and mv of a 2-d block in the generated functor's order of
    summation while the weights they read in one entry of the context (each
    tensor's storage counted once) stay within MAX_WEIGHTS, the most a
    functor holds; past that, and every other op, as PyTorch runs it. Once
    an entry passes the limit, so do the later entries of the same object
    (the twin's later steps of a step the card refuses)."""

    def __init__(self):
        super().__init__()
        self.past = False

    def __enter__(self):
        self.read = {}  # storage → its values
        return super().__enter__()

    def _within(self, *weights) -> bool:
        for w in weights:
            if isinstance(w, torch.Tensor):
                st = w.untyped_storage()
                self.read[st.data_ptr()] = st.nbytes() // w.element_size()
        self.past = self.past or sum(self.read.values()) > MAX_WEIGHTS
        return not self.past

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet is aten.mm and args[0].dim() == 2 and self._within(args[1]):
            return _sequential_mm(args[0], args[1])
        if packet is aten.mv and args[0].dim() == 2 and self._within(args[1]):
            return _sequential_mm(args[0], args[1][:, None])[:, 0]
        if (packet is aten.addmm and kwargs.get("beta", 1) == 1 and kwargs.get("alpha", 1) == 1
                and self._within(args[2], args[0])):
            return _sequential_mm(args[1], args[2]) + args[0]
        return func(*args, **kwargs)


def functor_order() -> TorchDispatchMode:
    """A context, entered once a tile step call, in which the step's matrix
    products run in the generated functor's order (Σ_k in k order, then the
    bias): the plain twin's products, so that it rounds like the functor.
    It trades the CPU's speed for the kernel's rounding (n broadcast
    multiply-adds a product of n inputs where ``torch.mm`` makes one call),
    so only up to the weights a functor holds: the products of a step past
    MAX_WEIGHTS, which the card refuses, run as PyTorch runs them from the
    one where the count passes it, and in every later entry."""
    return _FunctorOrder()


__all__ = ["K_TRACE", "MAX_CONSTANT_LANES", "MAX_WEIGHTS", "SUPPORTED", "UserTile",
           "functor_order", "lower", "weight_buffer"]
