"""SameDiff graph layer (↔ deeplearning4j_tpu/autodiff/samediff.py).

ref: org.nd4j.autodiff.samediff.SameDiff, SDVariable, the SD op namespaces
(SDMath/SDNN/SDCNN/SDRNN/SDLoss), InferenceSession, TrainingConfig.

The same define-by-run graph as the JAX package: ops are recorded by
registered name with JSON-able attrs, and ``output`` replays the recorded
ops that an output needs. What differs, and why:

- **Device.** Each SameDiff lives on one device, the first CUDA card
  unless the caller asks for another (``SameDiff.create(device="cpu")``).
  VARIABLE and CONSTANT values are tensors on that device, so a call
  copies only its feeds there; ``get_value`` returns numpy.
- **Replay.** The JAX package compiles the replay with ``jax.jit``. Here
  the default ("compiled") path is a cached plan: the op list an output
  needs, each op's callable and attrs resolved once, run as one Python
  call with no per-op hooks. ``interpreted=True`` walks the graph op by
  op and fires the op listeners, as in the JAX package. Both run the same
  torch ops, so they give the same numbers. Outputs are tensors on the
  graph's device.
- **Dtypes.** The JAX package runs with x64 off: a 64-bit array becomes
  32-bit when it enters a computation (float64 → float32, int64 →
  int32). The port keeps that rule (``_canon``): host values, feeds and
  every op's outputs are narrowed to 32 bits, so a graph gives the JAX
  package's output dtypes. ``enable_x64()`` switches the rule off, as
  ``jax_enable_x64`` does: the float64 checks (``validation``) run under
  it. Variable metadata keeps the dtype of the value as given (a Python
  float constant is ``"float64"``), as the JAX package records it.
- **Shape inference.** ``jax.eval_shape`` becomes a run of the op on
  ``device="meta"`` tensors; an op that needs data (``.item()``, a data
  dependent shape) fails there, and the output's shape is unknown
  (``_UnknownStruct``), where the JAX package's abstract evaluation
  fails too.
- **Gradients and fit** run on ``torch.autograd``; ``fit`` steps through
  the port's updaters (``train/updaters.py``), with the updater state on
  the device. ``save`` writes the JAX package's zip (graph.json,
  arrays.npz with the subgraphs' values under ``__sub__|`` keys,
  updater.npz with the leaves in pytree order: dict keys sorted), so
  files move between the two packages both ways, control flow included.

- **Control flow** (``cond``, ``while_loop``; the ops ``__cond__`` and
  ``__while__``, with their branches as subgraphs) runs eagerly where the
  JAX package lowers to ``lax.cond``/``lax.scan``/``lax.while_loop``. A
  loop whose trip count is static (``_while_static_trip``: integer
  counters, a positive constant step, CONSTANT inits; every imported
  Keras RNN) replays its body ``trip`` times in Python with no host read,
  and differentiates like the JAX package's ``lax.scan``. A data-dependent
  loop reads its condition once an iteration (one host sync each) and
  refuses reverse-mode differentiation, as ``lax.while_loop`` does.
  ``cond`` reads its predicate and runs one branch; gradients flow through
  the branch taken. Each branch's plan is bound once and cached in its
  subgraph. ``loop_stats()`` counts the routes taken.
- **Whole-graph export.** ``export_stablehlo`` keeps the JAX package's
  name and signature; the blob is a ``torch.export`` archive of an
  ``ExportedProgram`` over the placeholders in sorted order. Inside it a
  static-trip loop unrolls, a data-dependent loop is
  ``torch._higher_order_ops.while_loop`` and ``cond`` is ``torch.cond``;
  an op that cannot be exported raises naming its node. ``run_stablehlo``
  returns tensors on the program's device, as ``output`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import inspect
import io
import json
import keyword
import re
import time
import warnings
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import cnn as ops_cnn
from deeplearning4j_tpu_torch.ops import loss as ops_loss
from deeplearning4j_tpu_torch.ops import math as ops_math
from deeplearning4j_tpu_torch.ops import nn as ops_nn
from deeplearning4j_tpu_torch.ops import rnn as ops_rnn
from deeplearning4j_tpu_torch.runtime.device import resolve_device
from deeplearning4j_tpu_torch.utils.pytree import (
    flatten_with_names,
    tree_leaves,
    tree_map_with_names,
)

# ---------------------------------------------------------------------------
# dtypes: names, torch dtypes, and the JAX package's x64-off rule
# ---------------------------------------------------------------------------

_X64 = False

_BY_NAME = {
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
for _n in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _n):
        _BY_NAME[_n] = getattr(torch, _n)
_NAME_OF = {d: n for n, d in _BY_NAME.items()}
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}
if hasattr(torch, "uint64"):
    _NARROW[torch.uint64] = torch.uint32


@contextlib.contextmanager
def enable_x64():
    """Keep 64-bit values 64-bit inside the block (↔ ``jax_enable_x64``):
    the float64 checks run under it."""
    global _X64
    old, _X64 = _X64, True
    try:
        yield
    finally:
        _X64 = old


def torch_dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(d, torch.dtype):
        return d
    name = d if isinstance(d, str) else str(np.dtype(d))
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {d!r}") from None


def dtype_name(d) -> str:
    """The numpy name of a dtype (``"float32"``, ``"bfloat16"``)."""
    if isinstance(d, torch.dtype):
        return _NAME_OF[d]
    if isinstance(d, str) and d in _BY_NAME:
        return d
    return str(np.dtype(d))


def _canon(dtype: torch.dtype) -> torch.dtype:
    return dtype if _X64 else _NARROW.get(dtype, dtype)


def _narrow(out):
    """An op's outputs under the x64 rule."""
    if _X64:
        return out
    if isinstance(out, torch.Tensor):
        d = _NARROW.get(out.dtype)
        return out if d is None else out.to(d)
    if isinstance(out, (tuple, list)):
        return type(out)(_narrow(o) for o in out)
    return out


def _as_tensor(value, device) -> torch.Tensor:
    """A host or device value as a tensor on ``device`` under the x64
    rule: one copy (host to device, or a host copy for the CPU); a tensor
    already there with its dtype is taken as it is."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return t.to(device=device, dtype=_canon(t.dtype))
    arr = np.asarray(value)
    if arr.dtype.kind in "OSUV":
        raise TypeError(f"cannot hold a {arr.dtype} array as a tensor")
    with warnings.catch_warnings():
        # a read-only view (a GraphDef's tensor_content) is copied below
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=_canon(t.dtype), copy=True)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bfloat16 (which numpy lacks) as float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# Op registry: op-name -> callable over tensors (↔ OpRegistrator). Recorded
# kwargs must be JSON-able.
# ---------------------------------------------------------------------------

OP_REGISTRY: Dict[str, Callable] = {}


def register_op(name: str, fn: Callable) -> None:
    OP_REGISTRY[name] = fn


def _register_module(prefix: str, module, names: Optional[Sequence[str]] = None):
    for attr in names if names is not None else dir(module):
        if attr.startswith("_"):
            continue
        fn = getattr(module, attr, None)
        if callable(fn):
            register_op(f"{prefix}.{attr}", fn)


_register_module("math", ops_math)
_register_module("nn", ops_nn)
_register_module("cnn", ops_cnn)
_register_module("rnn", ops_rnn)
_register_module("loss", ops_loss)


def _op_fn(op: str) -> Callable:
    if op not in OP_REGISTRY and op.startswith("tfimport."):
        # a loaded graph that was imported from TF in another process
        from deeplearning4j_tpu_torch.modelimport import tf  # noqa: F401
    if op not in OP_REGISTRY and op.startswith("onnximport."):
        # ... or from ONNX
        from deeplearning4j_tpu_torch.modelimport import onnx  # noqa: F401
    if op not in OP_REGISTRY:
        raise KeyError(f"op {op!r} not registered")
    return OP_REGISTRY[op]


def promote(*xs):
    """jnp's type promotion for the ops that torch does not promote
    (matmul, stack, einsum)."""
    dt = xs[0].dtype
    if all(x.dtype == dt for x in xs):
        return list(xs)  # nothing to convert: no op (an export records one)
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def matmul(a, b):
    a, b = promote(a, b)
    return torch.matmul(a, b)


def _dims(x, axis):
    """``axis`` (None | int | list) → torch's ``dim``; None = every dim."""
    if axis is None:
        return tuple(range(x.dim()))
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _reduction(fn, float_only=False):
    def reduce(x, axis=None, keepdims=False):
        if isinstance(axis, (list, tuple)) and len(axis) == 0:
            return x  # jnp: reducing over no axes is the identity
        if float_only and not (x.is_floating_point() or x.is_complex()):
            x = x.to(torch.float32)
        return fn(x, dim=_dims(x, axis), keepdim=keepdims)

    return reduce


def _moment(fn):
    def moment(x, axis=None, keepdims=False, bias_corrected=True):
        if not x.is_floating_point():
            x = x.to(torch.float32)
        return fn(x, dim=_dims(x, axis), keepdim=keepdims,
                  correction=1 if bias_corrected else 0)

    return moment


def _index(x, idx):
    """``x[idx]`` for a tuple of ints and slices, negative steps included
    (torch's indexing takes positive steps only: such a slice is taken
    forward, then flipped)."""
    pos, flips, out_dim = [], [], 0
    for d, s in enumerate(idx):
        if not isinstance(s, slice):
            pos.append(s)
            continue
        start, stop, step = s.indices(x.shape[d])
        if step < 0:
            r = range(start, stop, step)
            pos.append(slice(r[-1], r[0] + 1, -step) if r else slice(0, 0))
            flips.append(out_dim)
        else:
            pos.append(slice(start, stop, step))
        out_dim += 1
    out = x[tuple(pos)]
    return torch.flip(out, flips) if flips else out


def _gather(x, indices, axis=0):
    """``jnp.take``: negative ids count from the end; an id outside
    [-n, n) reads the fill value (NaN for floats, the dtype's minimum for
    ints), as ``jnp.take``'s default mode does. Never raises, never syncs."""
    idx = torch.as_tensor(indices, device=x.device).long()
    axis = axis % x.dim()
    n = x.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = torch.index_select(x, axis, idx.clamp(0, max(n - 1, 0)).reshape(-1))
    out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    if x.is_floating_point() or x.is_complex():
        fill = float("nan")
    elif x.dtype == torch.bool:
        fill = True
    else:
        fill = torch.iinfo(x.dtype).min
    mask = valid.reshape((1,) * axis + idx.shape
                         + (1,) * (x.dim() - axis - 1))
    return out.masked_fill(~mask, fill)  # a fill kernel, no host copy


def _dynamic_slice(x, begin, size):
    """``lax.dynamic_slice``: a negative start counts from the end, and the
    start is clamped so the window fits. A start given as a tensor stays
    on the device (an ``index_select`` of the window: no host read,
    differentiable, exportable)."""
    for d, (b, s) in enumerate(zip(begin, size)):
        n, s = x.shape[d], int(s)
        if isinstance(b, torch.Tensor):
            start = b.reshape(())
            start = torch.where(start < 0, start + n, start).clamp(
                0, max(n - s, 0))
            x = torch.index_select(x, d, start + torch.arange(
                s, device=x.device))
        else:
            b = int(b)
            x = x.narrow(d, min(max(b + n if b < 0 else b, 0), n - s), s)
    return x


def _expand_dims(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=_dims(x, axis))


def _transpose(x, axes=None):
    return x.permute(*(axes if axes is not None
                       else reversed(range(x.dim()))))


def where(c, a, b):
    """``jnp.where``: any nonzero condition selects ``a``."""
    return torch.where(c if c.dtype == torch.bool else c != 0, a, b)


def _int32(v, device=None):
    return torch.tensor(v, dtype=torch.int32, device=device)


# Core structural ops (↔ the reference's SDBaseOps on SameDiff itself).
_CORE_OPS = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "pow": torch.pow,
    "mod": torch.remainder,
    "neg": torch.neg,
    "matmul": matmul,
    "reshape": lambda x, shape: x.reshape(shape),
    "transpose": _transpose,
    "permute": lambda x, axes: x.permute(*axes),
    "expand_dims": _expand_dims,
    "squeeze": _squeeze,
    "concat": lambda *xs, axis=0: torch.cat(xs, dim=axis),
    "stack": lambda *xs, axis=0: torch.stack(promote(*xs), dim=axis),
    "unstack": lambda x, axis=0: tuple(x.unbind(axis)),
    "slice": _dynamic_slice,
    "strided_slice": lambda x, begin, end, strides: _index(
        x, tuple(slice(b, e, s) for b, e, s in zip(begin, end, strides))),
    "gather": _gather,
    "tile": lambda x, reps: torch.tile(x, tuple(reps)),
    "cast": lambda x, dtype: x.to(_canon(torch_dtype(dtype))),
    "sum": _reduction(torch.sum),
    "mean": _reduction(torch.mean, float_only=True),
    "max": _reduction(torch.amax),
    "min": _reduction(torch.amin),
    "prod": _reduction(lambda x, dim, keepdim: _prod(x, dim, keepdim)),
    "std": _moment(torch.std),
    "var": _moment(torch.var),
    "argmax": lambda x, axis=None: torch.argmax(x, dim=axis),
    "argmin": lambda x, axis=None: torch.argmin(x, dim=axis),
    "softmax": lambda x, axis=-1: torch.softmax(x, dim=axis),
    "log_softmax": lambda x, axis=-1: torch.log_softmax(x, dim=axis),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "relu6": F.relu6,
    "leaky_relu": lambda x, alpha=0.01: F.leaky_relu(x, alpha),
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "selu": F.selu,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "swish": F.silu,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "abs": torch.abs,
    "eq": torch.eq,
    "neq": torch.ne,
    "gt": torch.gt,
    "gte": torch.ge,
    "lt": torch.lt,
    "lte": torch.le,
    "where": where,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "cumsum": lambda x, axis=0: torch.cumsum(x, dim=axis),
    "cumprod": lambda x, axis=0: torch.cumprod(x, dim=axis),
    "zeros_like": torch.zeros_like,
    "ones_like": torch.ones_like,
    "identity": lambda x: x,
    "shape_of": lambda x: _int32(list(x.shape), x.device),
    "size": lambda x: _int32(x.numel(), x.device),
    "rank": lambda x: _int32(x.dim(), x.device),
}


def _prod(x, dim, keepdim):
    for d in sorted((dim,) if isinstance(dim, int) else dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


for _n, _f in _CORE_OPS.items():
    register_op(_n, _f)


class VariableType(str, enum.Enum):
    """ref: org.nd4j.autodiff.samediff.VariableType."""

    VARIABLE = "VARIABLE"
    CONSTANT = "CONSTANT"
    PLACEHOLDER = "PLACEHOLDER"
    ARRAY = "ARRAY"


@dataclasses.dataclass
class OpNode:
    """One recorded graph op (↔ SameDiffOp: op + input/output var names)."""

    op: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]
    subgraphs: Optional[Dict[str, "SameDiff"]] = None


class SDVariable:
    """Symbolic handle into a SameDiff graph (↔ org.nd4j.autodiff.samediff.SDVariable)."""

    def __init__(self, sd: "SameDiff", name: str, var_type: VariableType,
                 shape=None, dtype=None):
        self.sd = sd
        self.name = name
        self.var_type = var_type
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_name(dtype) if dtype is not None else None

    # -- arithmetic sugar (↔ SDVariable.add/sub/mul/... and rsub/rdiv) -----
    def _bin(self, op, other, reverse=False):
        other = self.sd._lift(other)
        a, b = (other, self) if reverse else (self, other)
        return self.sd._record(op, [a, b], {})

    def __add__(self, o):
        return self._bin("add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, reverse=True)

    def __mul__(self, o):
        return self._bin("mul", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("div", o, reverse=True)

    def __pow__(self, o):
        return self._bin("pow", o)

    def __matmul__(self, o):
        return self._bin("matmul", o)

    def __neg__(self):
        return self.sd._record("neg", [self], {})

    # DL4J method names
    def add(self, o):
        return self + o

    def sub(self, o):
        return self - o

    def mul(self, o):
        return self * o

    def div(self, o):
        return self / o

    def rsub(self, o):
        return self._bin("sub", o, reverse=True)

    def rdiv(self, o):
        return self._bin("div", o, reverse=True)

    def mmul(self, o):
        return self @ o

    def dot(self, o):
        return self @ o

    # comparisons
    def eq(self, o):
        return self._bin("eq", o)

    def neq(self, o):
        return self._bin("neq", o)

    def gt(self, o):
        return self._bin("gt", o)

    def gte(self, o):
        return self._bin("gte", o)

    def lt(self, o):
        return self._bin("lt", o)

    def lte(self, o):
        return self._bin("lte", o)

    # shape ops
    def reshape(self, *shape):
        shape = shape[0] if len(shape) == 1 and isinstance(shape[0], (tuple, list)) else shape
        return self.sd._record("reshape", [self], {"shape": list(shape)})

    def transpose(self, axes=None):
        return self.sd._record("transpose", [self], {"axes": list(axes) if axes else None})

    def permute(self, *axes):
        axes = axes[0] if len(axes) == 1 and isinstance(axes[0], (tuple, list)) else axes
        return self.sd._record("permute", [self], {"axes": list(axes)})

    def cast(self, dtype):
        return self.sd._record("cast", [self], {"dtype": dtype_name(dtype)})

    # reductions
    def sum(self, axis=None, keepdims=False):
        return self.sd._record("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return self.sd._record("mean", [self], {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False):
        return self.sd._record("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return self.sd._record("min", [self], {"axis": axis, "keepdims": keepdims})

    def std(self, bias_corrected=True, axis=None, keepdims=False):
        return self.sd._record(
            "std", [self],
            {"axis": axis, "keepdims": keepdims, "bias_corrected": bias_corrected})

    def norm2(self, axis=None):
        return self.sd._record("math.norm2", [self], {"axis": axis})

    def argmax(self, axis=None):
        return self.sd._record("argmax", [self], {"axis": axis})

    def argmin(self, axis=None):
        return self.sd._record("argmin", [self], {"axis": axis})

    # evaluation
    def eval(self, feeds: Optional[Dict[str, Any]] = None):
        """Evaluate this variable (↔ SDVariable.eval()): a tensor on the
        graph's device."""
        return self.sd.output(feeds or {}, [self.name])[self.name]

    def __repr__(self):
        return (f"SDVariable(name={self.name!r}, type={self.var_type.value}, "
                f"shape={self.shape}, dtype={self.dtype})")


class _Namespace:
    """Recording wrapper over one ops module (↔ SDMath/SDNN/SDCNN/SDRNN/SDLoss)."""

    def __init__(self, sd: "SameDiff", prefix: str):
        self._sd = sd
        self._prefix = prefix

    def __getattr__(self, opname: str):
        full = f"{self._prefix}.{opname}"
        if full not in OP_REGISTRY:
            raise AttributeError(f"no op {full!r} in registry")
        sd = self._sd

        def record(*args, **kwargs):
            var_args = [sd._lift(a) if _is_arrayish(a) or isinstance(a, SDVariable) else a
                        for a in args]
            inputs = [a for a in var_args if isinstance(a, SDVariable)]
            # Non-variable positional args (ints, tuples...) become attrs by
            # position; the replay reconstructs the original arg order.
            arg_kinds = ["var" if isinstance(a, SDVariable) else "attr" for a in var_args]
            attr_pos = [a for a in var_args if not isinstance(a, SDVariable)]
            attrs = dict(kwargs)
            attrs["__argspec__"] = arg_kinds
            attrs["__posattrs__"] = attr_pos
            return sd._record(full, inputs, attrs)

        return record


def _is_arrayish(a) -> bool:
    # Python scalars stay attrs (serializable); arrays become constants.
    return isinstance(a, (np.ndarray, torch.Tensor))


def _bind(fn, attrs: Dict[str, Any]) -> Callable:
    """``fn`` with a node's attrs resolved once: a callable over the
    node's input values."""
    attrs = dict(attrs)
    argspec = attrs.pop("__argspec__", None)
    posattrs = [_dejson_val(a) for a in attrs.pop("__posattrs__", [])]
    kwargs = _dejson(attrs)
    if argspec is None:
        return lambda vals: fn(*vals, **kwargs)

    def call(vals):
        vi = iter(vals)
        ai = iter(posattrs)
        return fn(*[next(vi) if kind == "var" else next(ai)
                    for kind in argspec], **kwargs)

    return call


def _dejson(attrs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _dejson_val(v) for k, v in attrs.items()}


def _dejson_val(v):
    if isinstance(v, list):
        return tuple(_dejson_val(x) for x in v)
    return v


def _replay(node: OpNode, fn, vals: List[Any]):
    return _narrow(_bind(fn, node.attrs)(vals))


_CONTROL_FLOW = ("__cond__", "__while__")
_BRANCH_KEY = ("__branch__",)  # a subgraph's cached branch fn
_EXPORTING = False  # set while export_stablehlo traces the plan
_LOOP_STATS: Dict[str, Any] = {}


def reset_loop_stats() -> None:
    _LOOP_STATS.clear()
    _LOOP_STATS.update({"static": {}, "dynamic_loops": 0,
                        "dynamic_iterations": 0, "cond": 0})


reset_loop_stats()


def loop_stats() -> Dict[str, Any]:
    """The control-flow routes run since ``reset_loop_stats``: static
    loops by trip count, data-dependent loops and their iterations (each
    one host read of the condition), and conds (one host read each)."""
    return {"static": dict(_LOOP_STATS["static"]),
            **{k: v for k, v in _LOOP_STATS.items() if k != "static"}}


def _as_tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _unaliased(fn):
    """``fn`` with every output cloned: the export's ``torch.cond`` and
    ``while_loop`` take no output that aliases an input (a pass-through
    loop var, an identity branch), and the branch is traced by dynamo,
    which cannot compare tensors by identity."""
    def call(*vals):
        out = fn(*vals)
        outs = tuple(o.clone() for o in _as_tuple(out))
        return outs if isinstance(out, tuple) else outs[0]

    return call


def _cond_call(node: OpNode) -> Callable:
    true_fn = node.subgraphs["true"]._as_branch_fn()
    false_fn = node.subgraphs["false"]._as_branch_fn()

    def run(vals):
        pred, *operands = vals
        if _EXPORTING:
            return torch.cond(pred.reshape(()) != 0, _unaliased(true_fn),
                              _unaliased(false_fn), tuple(operands))
        _LOOP_STATS["cond"] += 1
        return (true_fn if bool(pred.reshape(()) != 0) else false_fn)(
            *operands)

    return run


def _while_call(sd: "SameDiff", node: OpNode) -> Callable:
    body = node.subgraphs["body"]._as_branch_fn()
    cond = node.subgraphs["cond"]._as_branch_fn()
    trip = _while_static_trip(sd, node)  # one host read, at bind time

    def run(vals):
        carry = tuple(vals)
        if trip is not None:  # lax.scan's route: the body `trip` times
            stats = _LOOP_STATS["static"]
            stats[trip] = stats.get(trip, 0) + 1
            for _ in range(trip):
                carry = _as_tuple(body(*carry))
            return carry
        if _EXPORTING:
            from torch._higher_order_ops.while_loop import while_loop

            return tuple(while_loop(
                lambda *c: _as_tuple(cond(*c))[0].reshape(()) != 0,
                lambda *c: _as_tuple(_unaliased(body)(*c)), carry))
        if torch.is_grad_enabled() and any(
                isinstance(c, torch.Tensor) and c.requires_grad
                for c in carry):
            raise ValueError(
                "Reverse-mode differentiation does not work for a "
                "while_loop with a data-dependent trip count (as "
                "lax.while_loop / lax.fori_loop with dynamic bounds); "
                "express the loop with a static trip count")
        _LOOP_STATS["dynamic_loops"] += 1
        while bool(_as_tuple(cond(*carry))[0].reshape(()) != 0):
            _LOOP_STATS["dynamic_iterations"] += 1
            carry = _as_tuple(body(*carry))
        return carry

    return run


def _bind_node(sd: "SameDiff", node: OpNode) -> Callable:
    """A callable over the node's input values: control flow runs its
    subgraphs, every other op its registered callable with the attrs
    resolved once."""
    if node.op == "__cond__":
        return _cond_call(node)
    if node.op == "__while__":
        return _while_call(sd, node)
    return _bind(_op_fn(node.op), node.attrs)


def _meta_branch(sub: "SameDiff", metas: List[torch.Tensor]):
    """The branch outputs of ``sub`` on ``meta`` tensors (shape and dtype
    only; nothing runs on a device)."""
    env: Dict[str, Any] = {n: torch.empty(v.shape, dtype=v.dtype,
                                          device="meta")
                           for n, v in sub._values.items()}
    env.update(zip(sub._placeholder_names(), metas))
    outs = sub._branch_output_names()
    for idx in sub._ancestors(outs):
        node = sub._nodes[idx]
        vals = [env[n] for n in node.inputs]
        if node.op in _CONTROL_FLOW:
            out = _meta_control(node.op, vals, node.subgraphs)
        else:
            out = _replay(node, _op_fn(node.op), vals)
        _store(env, node, out)
    return [env[n] for n in outs]


def _same_types(what, got, want) -> None:
    if len(got) != len(want) or any(
            g.dtype != w.dtype or tuple(g.shape) != tuple(w.shape)
            for g, w in zip(got, want)):
        raise TypeError(f"{what}: {[(tuple(g.shape), g.dtype) for g in got]}"
                        f" vs {[(tuple(w.shape), w.dtype) for w in want]}")


def _meta_control(op, metas, subgraphs) -> list:
    """``jax.eval_shape`` of ``lax.cond``/``lax.while_loop``: a cond's
    branches must agree, a loop's body must give its carry's types back,
    its condition a boolean scalar."""
    if op == "__cond__":
        pred, *operands = metas
        t = _meta_branch(subgraphs["true"], operands)
        _same_types("true and false branches differ", t,
                    _meta_branch(subgraphs["false"], operands))
        return t
    _same_types("body output and carry differ",
                _meta_branch(subgraphs["body"], metas), metas)
    (c, *rest) = _meta_branch(subgraphs["cond"], metas)
    if rest or c.dtype != torch.bool or c.dim() != 0:
        raise TypeError(f"cond must return a boolean scalar, got "
                        f"{tuple(c.shape)} {c.dtype}")
    return [torch.empty(m.shape, dtype=m.dtype, device="meta") for m in metas]


def _store(env, node: OpNode, out) -> None:
    if isinstance(out, (tuple, list)):
        for n, o in zip(node.outputs, out):
            env[n] = o
    else:
        env[node.outputs[0]] = out


class SameDiff:
    """The graph builder + executor (↔ org.nd4j.autodiff.samediff.SameDiff).

    Usage mirrors the reference::

        sd = SameDiff.create(device="cpu")
        x = sd.placeholder("x", (None, 784), "float32")
        w = sd.var("w", np.zeros((784, 10), np.float32))
        b = sd.var("b", np.zeros((10,), np.float32))
        logits = x.mmul(w) + b
        probs = sd.nn.softmax(logits)  # recorded op
        out = probs.eval({"x": batch})  # a tensor on the graph's device
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._vars: Dict[str, SDVariable] = {}
        self._values: Dict[str, torch.Tensor] = {}  # VARIABLE + CONSTANT data
        self._nodes: List[OpNode] = []
        self._producer: Dict[str, int] = {}  # var name -> node index
        self._counter = 0
        self._fn_cache: Dict[Tuple, Callable] = {}
        self.math = _Namespace(self, "math")
        self.nn = _Namespace(self, "nn")
        self.cnn = _Namespace(self, "cnn")
        self.rnn = _Namespace(self, "rnn")
        self.loss = _Namespace(self, "loss")
        self.training_config: Optional[TrainingConfig] = None
        self._updater_state = None
        self._updater_leaves = None  # loaded-from-checkpoint leaves, pending restore
        self._iteration = 0
        self.listeners: List[Any] = []
        # When this graph is a control-flow branch (cond/while subgraph),
        # an explicit ordered output list; None = the terminal-vars
        # heuristic in _branch_output_names. The TF importer sets it: a
        # FunctionDef's rets are named and ordered, and the loop carry's
        # order must match the while's inputs exactly.
        self.branch_outputs: Optional[List[str]] = None

    # -- construction ------------------------------------------------------

    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    def _fresh_name(self, base: str) -> str:
        self._counter += 1
        name = f"{base}_{self._counter}"
        while name in self._vars:
            self._counter += 1
            name = f"{base}_{self._counter}"
        return name

    def _add_var(self, name, var_type, shape=None, dtype=None) -> SDVariable:
        if name in self._vars:
            raise ValueError(f"variable {name!r} already exists")
        v = SDVariable(self, name, var_type, shape, dtype)
        self._vars[name] = v
        return v

    def _hold(self, name, var_type, value) -> SDVariable:
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        t = _as_tensor(value, self.device)
        v = self._add_var(name, var_type, tuple(value.shape), value.dtype)
        self._values[name] = t
        return v

    def var(self, name: str, value=None, shape=None, dtype="float32",
            initializer=None, seed: int = 0) -> SDVariable:
        """Trainable VARIABLE (↔ sd.var). Give ``value`` or ``shape``+init
        (the port's initializers draw from a CPU generator of ``seed``:
        other numbers than the JAX package's, from the same distribution)."""
        if value is None:
            if shape is None:
                raise ValueError("var needs value or shape")
            if initializer is None:
                value = np.zeros(shape, dtype)
            else:
                from deeplearning4j_tpu_torch.nn.initializers import (
                    get_initializer,
                )
                init = get_initializer(initializer)
                value = init(tuple(shape), torch.Generator().manual_seed(seed),
                             torch_dtype(dtype))
        return self._hold(name, VariableType.VARIABLE, value)

    def constant(self, name: str, value) -> SDVariable:
        return self._hold(name, VariableType.CONSTANT, value)

    def placeholder(self, name: str, shape=None, dtype="float32") -> SDVariable:
        return self._add_var(name, VariableType.PLACEHOLDER, shape, dtype)

    def convert_to_variable(self, name: str) -> SDVariable:
        """CONSTANT → trainable VARIABLE in place (↔ sd.convertToVariable).

        The model-import path creates weights as constants; fine-tuning an
        imported graph promotes them so gradients/updaters apply.
        """
        v = self._vars[name]
        if v.var_type == VariableType.VARIABLE:
            return v
        if v.var_type != VariableType.CONSTANT:
            raise ValueError(f"{name!r} is {v.var_type.value}, not constant")
        v.var_type = VariableType.VARIABLE
        self._fn_cache.clear()
        # Updater state is keyed to the trainable set; a stale tree would
        # mismatch on the next fit().
        self._updater_state = None
        self._updater_leaves = None
        return v

    def convert_to_constant(self, name: str) -> SDVariable:
        """VARIABLE → CONSTANT in place (↔ sd.convertToConstant) — e.g.
        freezing layers before fine-tuning."""
        v = self._vars[name]
        if v.var_type == VariableType.CONSTANT:
            return v
        if v.var_type != VariableType.VARIABLE:
            raise ValueError(f"{name!r} is {v.var_type.value}, not variable")
        v.var_type = VariableType.CONSTANT
        self._fn_cache.clear()
        self._updater_state = None
        self._updater_leaves = None
        return v

    def _lift(self, value) -> SDVariable:
        """Wrap a literal array/scalar as an (anonymous) constant variable."""
        if isinstance(value, SDVariable):
            return value
        return self._hold(self._fresh_name("const"), VariableType.CONSTANT,
                          value)

    # -- recording ---------------------------------------------------------

    def _record(self, op: str, inputs: List[SDVariable], attrs: Dict[str, Any],
                subgraphs: Optional[Dict[str, "SameDiff"]] = None):
        _op_fn(op)
        for v in inputs:
            if v.sd is not self:
                raise ValueError(f"variable {v.name} belongs to another graph")
        out_structs = self._infer(op, inputs, attrs, subgraphs)
        base = op.split(".")[-1]
        outs: List[SDVariable] = []
        for s in out_structs:
            name = self._fresh_name(base)
            shape = getattr(s, "shape", None)
            dtype = getattr(s, "dtype", None)
            outs.append(self._add_var(name, VariableType.ARRAY, shape, dtype))
        node = OpNode(op, [v.name for v in inputs], [v.name for v in outs],
                      _jsonable_attrs(attrs), subgraphs)
        idx = len(self._nodes)
        self._nodes.append(node)
        for v in outs:
            self._producer[v.name] = idx
        self._fn_cache.clear()
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _infer(self, op, inputs, attrs, subgraphs):
        """Shape/dtype inference by running the op on ``meta`` tensors (↔
        libnd4j shape functions; the JAX package's ``jax.eval_shape``).
        Control flow runs its branches on ``meta`` tensors once (a loop's
        body once, never the loop) and MUST infer: its output arity is the
        carry's or the branches', and a silent unknown would mis-wire
        every consumer."""
        fn = _op_fn(op)
        node = OpNode(op, [v.name for v in inputs], [], dict(attrs), subgraphs)
        try:
            metas = []
            for v in inputs:
                shape = tuple(2 if (d is None or d == -1) else d
                              for d in (v.shape or ()))
                metas.append(torch.empty(
                    shape, dtype=_canon(torch_dtype(v.dtype or "float32")),
                    device="meta"))
            if op in _CONTROL_FLOW:
                out = _meta_control(op, metas, subgraphs)
            else:
                out = _replay(node, fn, metas)
        except Exception as e:
            if op in _CONTROL_FLOW:
                raise ValueError(f"control-flow op {op} failed shape "
                                 f"inference: {e}") from e
            return [_UnknownStruct()]
        leaves = out if isinstance(out, (tuple, list)) else [out]
        sym = any(v.shape is not None and any(d in (None, -1) for d in v.shape)
                  for v in inputs)
        if sym:
            # dims were substituted; keep rank/dtype, drop dim values we faked
            return [_UnknownStruct(getattr(s, "dtype", None)) for s in leaves]
        return list(leaves)

    # -- execution ---------------------------------------------------------

    def _ancestors(self, names: Sequence[str]) -> List[int]:
        """Node indices needed to compute `names`, in topological order."""
        needed: set = set()
        stack = [n for n in names if n in self._producer]
        while stack:
            vn = stack.pop()
            idx = self._producer.get(vn)
            if idx is None or idx in needed:
                continue
            needed.add(idx)
            stack.extend(self._nodes[idx].inputs)
        return sorted(needed)

    def _build_fn(self, output_names: Tuple[str, ...], placeholder_names: Tuple[str, ...]):
        """fn(variables, constants, placeholders) -> outputs: the recorded
        ops an output needs, each bound to its callable and attrs once."""
        plan = [(self._nodes[i], _bind_node(self, self._nodes[i]))
                for i in self._ancestors(output_names)]

        def fn(variables, constants, placeholders):
            env: Dict[str, Any] = {}
            env.update(constants)
            env.update(variables)
            env.update(placeholders)
            for node, call in plan:
                vals = [env[n] for n in node.inputs]
                if _EXPORTING:
                    try:
                        out = call(vals)
                    except Exception as e:
                        raise RuntimeError(
                            f"cannot export node {node.outputs[0]!r} (op "
                            f"{node.op}): {type(e).__name__}: {e}") from e
                else:
                    out = call(vals)
                _store(env, node, _narrow(out))
            missing = [n for n in output_names if n not in env]
            if missing:
                raise KeyError(f"outputs not computable: {missing}")
            return {n: env[n] for n in output_names}

        return fn

    def _split_feeds(self, feeds: Dict[str, Any]):
        placeholders = {}
        for k, v in feeds.items():
            if k not in self._vars:
                raise KeyError(f"unknown placeholder {k!r}")
            vt = self._vars[k].var_type
            if vt != VariableType.PLACEHOLDER:
                # Feeding a VARIABLE/CONSTANT would silently shadow its
                # stored value; state changes go through set_value /
                # convert_to_variable instead.
                raise ValueError(
                    f"cannot feed {vt.name} {k!r}: only placeholders accept "
                    "feeds (use set_value to change stored values)")
            placeholders[k] = _as_tensor(v, self.device)
        variables = {n: self._values[n] for n, v in self._vars.items()
                     if v.var_type == VariableType.VARIABLE}
        constants = {n: self._values[n] for n, v in self._vars.items()
                     if v.var_type == VariableType.CONSTANT}
        return variables, constants, placeholders

    def output(self, feeds: Dict[str, Any], outputs: Sequence[str],
               interpreted: bool = False) -> Dict[str, torch.Tensor]:
        """Run the graph (↔ SameDiff.output / InferenceSession): tensors on
        the graph's device, by output name.

        The default path replays the cached plan; ``interpreted=True``
        walks the graph op by op, and op listeners (``listeners`` with
        ``on_op(node, outputs)``) fire only in this mode.
        """
        outputs = tuple(outputs)
        variables, constants, placeholders = self._split_feeds(feeds)
        with torch.no_grad():
            if interpreted:
                return self._interpret(variables, constants, placeholders,
                                       outputs)
            key = (outputs, tuple(sorted(placeholders)))
            if key not in self._fn_cache:
                self._fn_cache[key] = self._build_fn(
                    outputs, tuple(sorted(placeholders)))
            return self._fn_cache[key](variables, constants, placeholders)

    def _interpret(self, variables, constants, placeholders, outputs):
        env = {**constants, **variables, **placeholders}
        for idx in self._ancestors(outputs):
            node = self._nodes[idx]
            out = _narrow(_bind_node(self, node)([env[n] for n in node.inputs]))
            _store(env, node, out)
            for lst in self.listeners:
                if hasattr(lst, "on_op"):
                    lst.on_op(node, {n: env[n] for n in node.outputs})
        return {n: env[n] for n in outputs}

    def batch_output(self, feeds, outputs):
        return self.output(feeds, outputs)

    # -- gradients (↔ SameDiff.createGradFunction / calculateGradients) ----

    def calculate_gradients(self, feeds: Dict[str, Any], loss: str,
                            wrt: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
        """Gradients of scalar `loss` w.r.t. VARIABLEs (default: all), as
        tensors on the graph's device; a variable the loss does not reach
        gets zeros, as ``jax.grad`` gives."""
        variables, constants, placeholders = self._split_feeds(feeds)
        wrt = tuple(wrt) if wrt is not None else tuple(sorted(variables))
        fn = self._build_fn((loss,), tuple(sorted(placeholders)))
        with torch.enable_grad():
            params = {n: variables[n].detach().requires_grad_(True)
                      for n in wrt}
            merged = dict(variables)
            merged.update(params)
            out = fn(merged, constants, placeholders)[loss]
            if out.dim() != 0:
                raise ValueError(f"loss {loss!r} is not scalar: shape "
                                 f"{tuple(out.shape)}")
            return _grads(out, params)

    def grad(self, feeds, loss, var_name):
        return self.calculate_gradients(feeds, loss, [var_name])[var_name]

    # -- control flow (↔ sd.ifCond / sd.whileLoop) --------------------------

    def cond(self, pred: SDVariable, true_graph: "SameDiff",
             false_graph: "SameDiff", inputs: Sequence[SDVariable]):
        """Record an If: the branch subgraphs map their placeholders
        (declared order) to ``inputs`` (↔ sd.ifCond). It reads ``pred`` and
        runs one branch; gradients flow through the branch taken."""
        return self._record("__cond__", [pred, *inputs], {},
                            {"true": true_graph, "false": false_graph})

    def while_loop(self, cond_graph: "SameDiff", body_graph: "SameDiff",
                   inits: Sequence[SDVariable]):
        """Record a While (↔ sd.whileLoop). A counter-bounded loop (see
        ``_while_static_trip``) replays its body a fixed number of times
        and is differentiable; a data-dependent one reads its condition
        each iteration, and ``calculate_gradients``/``fit`` through it
        raise, as the JAX package's ``lax.while_loop`` does."""
        return self._record("__while__", list(inits), {},
                            {"cond": cond_graph, "body": body_graph})

    def _placeholder_names(self) -> List[str]:
        return [n for n, v in self._vars.items()
                if v.var_type == VariableType.PLACEHOLDER]

    def _branch_output_names(self) -> List[str]:
        """``branch_outputs`` when set (explicit, ordered; may name
        placeholders, for pass-through loop vars), else every terminal
        ARRAY var (no consumer)."""
        if self.branch_outputs is not None:
            return list(self.branch_outputs)
        consumed = {n for node in self._nodes for n in node.inputs}
        return [n for n, v in self._vars.items()
                if v.var_type == VariableType.ARRAY and n not in consumed]

    def _as_branch_fn(self) -> Callable:
        """This graph as fn(*placeholder_values) -> an output or a tuple
        of outputs, its plan bound once and cached until the graph
        changes; the stored values are read at each call."""
        fn = self._fn_cache.get(_BRANCH_KEY)
        if fn is None:
            ph = self._placeholder_names()
            outs = self._branch_output_names()
            plan = self._build_fn(tuple(outs), tuple(ph))

            def fn(*vals):
                res = plan({}, self._values, dict(zip(ph, vals)))
                out_vals = tuple(res[n] for n in outs)
                return out_vals[0] if len(out_vals) == 1 else out_vals

            self._fn_cache[_BRANCH_KEY] = fn
        return fn

    # -- training (↔ TrainingSession + SameDiff.fit) -----------------------

    def fit(self, data, config: Optional["TrainingConfig"] = None, *,
            epochs: int = 1, listeners: Optional[List] = None):
        """Train the graph's VARIABLEs. `data` yields dict batches mapping
        placeholder names -> arrays. Returns each epoch's mean loss."""
        from deeplearning4j_tpu_torch.train.updaters import (
            apply_updates,
            resolve_updater,
        )

        config = config or self.training_config
        if config is None:
            raise ValueError("no TrainingConfig set")
        self.training_config = config
        listeners = listeners or []

        upd_init, upd_update = resolve_updater(config.updater, **config.updater_args).make()
        variables, constants, _ = self._split_feeds({})
        trainable = dict(variables)
        if self._updater_state is not None:
            opt_state = self._updater_state
        else:
            opt_state = upd_init(trainable)
            if self._updater_leaves is not None:
                # restore a loaded checkpoint's optimizer state into the
                # freshly-built state's tree structure
                opt_state = self._fill_tree(opt_state, self._updater_leaves)
                self._updater_leaves = None
        ph_names = tuple(sorted(config.placeholders(self)))
        fn = self._build_fn((config.loss_variable,), ph_names)

        def step(params, opt_state, step_i, batch):
            with torch.enable_grad():
                p = {n: t.detach().requires_grad_(True)
                     for n, t in params.items()}
                loss = fn(p, constants, batch)[config.loss_variable]
                if config.l2 > 0:
                    loss = loss + config.l2 * sum(
                        torch.sum(torch.square(x)) for x in tree_leaves(p))
                if config.l1 > 0:
                    loss = loss + config.l1 * sum(
                        torch.sum(torch.abs(x)) for x in tree_leaves(p))
                grads = _grads(loss, p)
            with torch.no_grad():
                updates, new_opt = upd_update(grads, opt_state, params, step_i)
                return apply_updates(params, updates), new_opt, loss.detach()

        it_count = self._iteration
        history = []
        for epoch in range(epochs):
            epoch_losses = []
            for batch in data:
                batch = {k: _as_tensor(v, self.device)
                         for k, v in batch.items() if k in ph_names}
                trainable, opt_state, loss = step(
                    trainable, opt_state, it_count, batch)
                it_count += 1
                epoch_losses.append(loss)
                for lst in listeners:
                    if hasattr(lst, "on_iteration"):
                        lst.on_iteration(epoch, it_count, None,
                                         {"total_loss": loss})
            if not epoch_losses:
                if epoch == 0:
                    raise ValueError("fit(): data iterable yielded no batches")
                break  # one-shot generator exhausted; don't record stale epochs
            if hasattr(data, "reset"):
                data.reset()
            history.append(float(np.mean(
                torch.stack(epoch_losses).float().cpu().numpy())))
        self._values.update(trainable)
        self._updater_state = opt_state
        self._iteration = it_count
        return history

    def _fill_tree(self, structure, leaves):
        """``structure`` with its leaves (in pytree order: dict keys
        sorted) replaced by ``leaves``, as tensors on the device."""
        names = [n for n, _ in flatten_with_names(structure)]
        if len(names) != len(leaves):
            raise ValueError(f"updater state has {len(names)} leaves, the "
                             f"checkpoint {len(leaves)}")
        by_name = {n: _as_tensor(v, self.device)
                   for n, v in zip(names, leaves)}
        return tree_map_with_names(lambda n, _: by_name[n], structure)

    # -- introspection -----------------------------------------------------

    def variables(self) -> List[SDVariable]:
        return list(self._vars.values())

    def get_variable(self, name: str) -> SDVariable:
        return self._vars[name]

    def get_value(self, name: str) -> np.ndarray:
        return _to_numpy(self._values[name])

    def set_value(self, name: str, value) -> None:
        if self._vars[name].var_type not in (VariableType.VARIABLE, VariableType.CONSTANT):
            raise ValueError(f"{name} holds no persistent value")
        self._values[name] = _as_tensor(value, self.device)

    def ops(self) -> List[OpNode]:
        return list(self._nodes)

    def summary(self) -> str:
        lines = [f"SameDiff: {len(self._vars)} vars, {len(self._nodes)} ops"]
        for n, v in self._vars.items():
            if v.var_type != VariableType.ARRAY:
                lines.append(f"  {v.var_type.value:<12} {n:<24} {v.shape} {v.dtype}")
        for node in self._nodes:
            lines.append(f"  op {node.op:<20} {node.inputs} -> {node.outputs}")
        return "\n".join(lines)

    # -- serialization (↔ SameDiff.save/load FlatBuffers .fb) --------------

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "format": "deeplearning4j_tpu.samediff.v1",
            "variables": [
                {"name": n, "type": v.var_type.value, "shape": list(v.shape) if v.shape else None,
                 "dtype": v.dtype}
                for n, v in self._vars.items()
            ],
            "ops": [
                {"op": node.op, "inputs": node.inputs,
                 "outputs": node.outputs, "attrs": node.attrs,
                 "subgraphs": {k: g.to_dict()
                               for k, g in node.subgraphs.items()}
                 if node.subgraphs else None}
                for node in self._nodes
            ],
            "training_config": dataclasses.asdict(self.training_config)
            if self.training_config else None,
            "iteration": self._iteration,
        }
        if self.branch_outputs is not None:
            d["branch_outputs"] = list(self.branch_outputs)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any], device=None) -> "SameDiff":
        sd = SameDiff(device)
        for v in d["variables"]:
            sd._vars[v["name"]] = SDVariable(
                sd, v["name"], VariableType(v["type"]), v["shape"], v["dtype"])
        for i, o in enumerate(d["ops"]):
            subgraphs = {k: SameDiff.from_dict(g, sd.device)
                         for k, g in o["subgraphs"].items()} \
                if o.get("subgraphs") else None
            node = OpNode(o["op"], list(o["inputs"]), list(o["outputs"]),
                          dict(o["attrs"]), subgraphs)
            sd._nodes.append(node)
            for out in node.outputs:
                sd._producer[out] = i
        if d.get("training_config"):
            sd.training_config = TrainingConfig(**d["training_config"])
        sd._iteration = int(d.get("iteration", 0))
        sd._counter = len(sd._vars)
        if d.get("branch_outputs") is not None:
            sd.branch_outputs = list(d["branch_outputs"])
        return sd

    def _collect_subgraph_values(self, prefix: str, out: Dict[str, Any]) -> None:
        """Flatten control-flow subgraph values into npz keys
        ``__sub__|<node_idx>|<subgraph_key>|...|<var_name>`` (the JAX
        package's layout): subgraphs hold their own values (loop bounds,
        or captured weights of a functional TF import), which the
        top-level arrays otherwise never see."""
        for i, node in enumerate(self._nodes):
            if not node.subgraphs:
                continue
            for k, g in node.subgraphs.items():
                p = f"{prefix}{i}|{k}|"
                for n, v in g._values.items():
                    if "|" in n:
                        raise ValueError(
                            f"subgraph variable name {n!r} contains '|'")
                    out[f"__sub__|{p}{n}"] = _to_numpy(v)
                g._collect_subgraph_values(p, out)

    def _inject_subgraph_value(self, key: str, value) -> None:
        tokens = key.split("|")
        g = self
        while len(tokens) > 1:
            g = g._nodes[int(tokens[0])].subgraphs[tokens[1]]
            tokens = tokens[2:]
        g._values[tokens[0]] = _as_tensor(value, g.device)

    def save(self, path, save_updater_state: bool = True) -> None:
        """One-file zip: graph.json + arrays.npz (+ updater.npz, its
        leaves ``leaf_<i>`` in pytree order). The arrays are stored
        uncompressed: float weights barely deflate."""
        leaves = None
        if save_updater_state:
            leaves = (tree_leaves(self._updater_state)
                      if self._updater_state is not None
                      else self._updater_leaves)
        sub_vals: Dict[str, Any] = {}
        self._collect_subgraph_values("", sub_vals)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("graph.json", json.dumps(self.to_dict(), indent=1))
            buf = io.BytesIO()
            np.savez(buf, **{n: _to_numpy(v) for n, v in self._values.items()},
                     **sub_vals)
            zf.writestr("arrays.npz", buf.getvalue(),
                        compress_type=zipfile.ZIP_STORED)
            if leaves is not None:
                ubuf = io.BytesIO()
                np.savez(ubuf, **{f"leaf_{i}": _to_numpy(torch.as_tensor(x))
                                  for i, x in enumerate(leaves)})
                zf.writestr("updater.npz", ubuf.getvalue(),
                            compress_type=zipfile.ZIP_STORED)

    @staticmethod
    def load(path, device=None) -> "SameDiff":
        with zipfile.ZipFile(path, "r") as zf:
            sd = SameDiff.from_dict(json.loads(zf.read("graph.json")), device)
            with np.load(io.BytesIO(zf.read("arrays.npz"))) as npz:
                sd._values = {k: _as_tensor(npz[k], sd.device)
                              for k in npz.files
                              if not k.startswith("__sub__|")}
                for k in npz.files:
                    if k.startswith("__sub__|"):
                        sd._inject_subgraph_value(k[len("__sub__|"):],
                                                  npz[k])
            if "updater.npz" in zf.namelist():
                with np.load(io.BytesIO(zf.read("updater.npz"))) as unpz:
                    sd._updater_leaves = [
                        unpz[f"leaf_{i}"] for i in range(len(unpz.files))]
        return sd

    # -- whole-graph export (↔ the JAX package's StableHLO export) ----------

    def _export(self, outputs, feed_specs):
        """The ExportedProgram of ``outputs`` over the placeholders of
        ``feed_specs`` ({name: (shape, dtype name)}) in sorted order, with
        the values it reads as buffers, and its input and output lists."""
        outputs = tuple(outputs)
        self._require_placeholders(feed_specs)
        ph_names = tuple(sorted(feed_specs))
        program = _Program(self, outputs, ph_names)
        dtypes = [dtype_name(_canon(torch_dtype(feed_specs[n][1])))
                  for n in ph_names]
        example = tuple(
            torch.zeros(tuple(feed_specs[n][0]), dtype=torch_dtype(d),
                        device=self.device)
            for n, d in zip(ph_names, dtypes))
        global _EXPORTING
        _EXPORTING = True
        try:
            with torch.no_grad():
                ep = torch.export.export(program, example, strict=False)
        finally:
            _EXPORTING = False
        meta = {"inputs": list(ph_names), "dtypes": dtypes,
                "outputs": list(outputs), "device": str(self.device)}
        return ep, meta

    def export_stablehlo(self, outputs: Sequence[str],
                         feed_specs: Dict[str, Tuple[Tuple[int, ...], str]]) -> bytes:
        """The whole graph from the placeholders to ``outputs`` as one
        program: a ``torch.export.save`` archive of its ExportedProgram
        (the JAX package's name; there a serialized ``jax.export``).
        feed_specs maps placeholder name -> (shape, dtype). Exported on the
        graph's device, the program runs there."""
        t0 = time.perf_counter()
        ep, meta = self._export(outputs, feed_specs)
        t1 = time.perf_counter()
        buf = io.BytesIO()
        torch.export.save(ep, buf, extra_files={_EXPORT_META: json.dumps(meta)})
        # host seconds of the last export: tracing, and writing the archive
        self.export_seconds = {"export_s": t1 - t0,
                               "save_s": time.perf_counter() - t1}
        return buf.getvalue()

    def _require_placeholders(self, names) -> None:
        """Exported-program inputs must be PLACEHOLDERs: a VARIABLE or
        CONSTANT name here would silently become a runtime input shadowing
        its stored value (the hazard _split_feeds rejects for feeds)."""
        for n in names:
            if n not in self._vars:
                raise KeyError(f"unknown placeholder {n!r}")
            vt = self._vars[n].var_type
            if vt != VariableType.PLACEHOLDER:
                raise ValueError(
                    f"export input {n!r} is {vt.name}, not a placeholder")

    @staticmethod
    def load_stablehlo(blob: bytes) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
        """The program of an ``export_stablehlo`` blob, loaded once, as
        run(feeds) -> {output name: tensor on the program's device}."""
        extra = {_EXPORT_META: ""}
        module = torch.export.load(io.BytesIO(blob),
                                   extra_files=extra).module()
        meta = json.loads(extra[_EXPORT_META])
        device = torch.device(meta["device"])
        specs = list(zip(meta["inputs"], meta["dtypes"]))

        def run(feeds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
            args = [_as_tensor(feeds[n], device).to(torch_dtype(d))
                    for n, d in specs]
            with torch.no_grad():
                out = module(*args)
            return dict(zip(meta["outputs"], out))

        return run

    @staticmethod
    def run_stablehlo(blob: bytes, feeds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Load an ``export_stablehlo`` blob and run it on ``feeds``."""
        return SameDiff.load_stablehlo(blob)(feeds)

    def export_stablehlo_text(self, outputs: Sequence[str],
                              feed_specs: Dict[str, Tuple[Tuple[int, ...], str]]
                              ) -> Tuple[str, List[str]]:
        """The exported program printed (its graph signature and ATen
        graph), and the positional argument order (the sorted placeholder
        names). Every declared placeholder stays an argument, whether or
        not an output reads it (the JAX package's ``keep_unused=True``)."""
        ep, meta = self._export(outputs, feed_specs)
        return str(ep), list(meta["inputs"])


_EXPORT_META = "samediff_program.json"


class _Program(torch.nn.Module):
    """``outputs`` of a SameDiff as a module over its placeholders: the
    plan bound once, the stored values it reads held as buffers. Its
    ``forward`` takes one argument a placeholder, named after it (made an
    identifier), so the exported program's signature names them."""

    def __init__(self, sd: SameDiff, outputs, ph_names):
        super().__init__()
        fn = sd._build_fn(outputs, ph_names)
        read = {n for i in sd._ancestors(outputs) for n in sd._nodes[i].inputs}
        names = [n for n in sd._values if n in read | set(outputs)]
        for i, n in enumerate(names):
            self.register_buffer(f"v{i}", sd._values[n])

        def forward(*placeholders):
            values = {n: getattr(self, f"v{i}") for i, n in enumerate(names)}
            out = fn({}, values, dict(zip(ph_names, placeholders)))
            return tuple(out[o] for o in outputs)

        taken: set = set()
        params = []
        for n in ph_names:
            ident = re.sub(r"\W", "_", n)
            ident = ident if ident[:1].isalpha() else f"p_{ident}"
            while ident in taken or keyword.iskeyword(ident):
                ident += "_"
            taken.add(ident)
            params.append(inspect.Parameter(
                ident, inspect.Parameter.POSITIONAL_OR_KEYWORD))
        forward.__signature__ = inspect.Signature(params)
        self.forward = forward


def _scalar(sd: SameDiff, name: str, var_type: VariableType):
    """The value of a one-element ``var_type`` variable of ``sd`` as a
    Python number (a host read), else None."""
    v = sd._vars.get(name)
    if v is None or v.var_type != var_type:
        return None
    t = sd._values[name]
    return t.reshape(()).item() if t.numel() == 1 else None


def _while_static_trip(sd: SameDiff, node: OpNode) -> Optional[int]:
    """Static trip count of a counter-bounded while, or None (the JAX
    package's rule, exactly).

    Recognizes conds that are (conjunctions of) ``lt(counter, bound)``
    where each counter carry slot is updated by ``add(counter, step)``
    with a positive body-constant step, the bound is a cond-graph
    constant or a pass-through carry slot, and every needed init is a
    CONSTANT of the outer graph: the loop TF/Keras RNN imports produce
    (loop_counter < max_iterations AND time < T).
    """
    cond_sd = (node.subgraphs or {}).get("cond")
    body_sd = (node.subgraphs or {}).get("body")
    if cond_sd is None or body_sd is None:
        return None
    if cond_sd.branch_outputs is None or body_sd.branch_outputs is None:
        return None
    phc = cond_sd._placeholder_names()
    phb = body_sd._placeholder_names()
    if len(phc) != len(node.inputs) or len(phb) != len(node.inputs):
        return None
    slot_c = {n: i for i, n in enumerate(phc)}
    b_outs = body_sd.branch_outputs
    if len(b_outs) != len(node.inputs):
        return None
    const = VariableType.CONSTANT

    def body_step(j):
        idx = body_sd._producer.get(b_outs[j])
        if idx is None:
            return None
        nd = body_sd._nodes[idx]
        if nd.op != "add" or len(nd.inputs) != 2:
            return None
        a, b = nd.inputs
        other = b if a == phb[j] else (a if b == phb[j] else None)
        if other is None:
            return None
        step = _scalar(body_sd, other, const)
        return step if step is not None and step > 0 else None

    def analyze(name):
        idx = cond_sd._producer.get(name)
        if idx is None:
            return None
        nd = cond_sd._nodes[idx]
        if nd.op == "math.logical_and" and len(nd.inputs) == 2:
            left = analyze(nd.inputs[0])
            right = analyze(nd.inputs[1])
            return None if left is None or right is None else left + right
        if nd.op == "lt" and len(nd.inputs) == 2:
            j = slot_c.get(nd.inputs[0])
            if j is None:
                return None
            bound = _scalar(cond_sd, nd.inputs[1], const)
            if bound is None:
                m = slot_c.get(nd.inputs[1])
                if m is None or b_outs[m] != phb[m]:
                    return None  # bound must be invariant
                bound = _scalar(sd, node.inputs[m], const)
            i0 = _scalar(sd, node.inputs[j], const)
            step = body_step(j)
            if bound is None or i0 is None or step is None:
                return None
            # INTEGER counters only: a float counter's accumulated value
            # can disagree with ceil((bound-i0)/step)
            if not (float(step).is_integer() and float(bound).is_integer()
                    and float(i0).is_integer()):
                return None
            return [max(0, -(-(int(bound) - int(i0)) // int(step)))]
        return None

    trips = analyze(cond_sd.branch_outputs[0])
    return None if trips is None else int(min(trips))


def _control_flow_impl(*a, **k):
    raise RuntimeError("control flow is replayed by _bind_node")


# Registered at import so a graph holding control flow runs after load() in
# a fresh process.
register_op("__cond__", _control_flow_impl)
register_op("__while__", _control_flow_impl)


def _grads(loss, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    names = list(params)
    if not loss.requires_grad:  # no variable reaches the loss: zeros
        return {n: torch.zeros_like(params[n]) for n in names}
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    return {n: (g if g is not None else torch.zeros_like(params[n]))
            for n, g in zip(names, grads)}


class _UnknownStruct:
    """Shape-inference fallback: dtype may be known, shape is not."""

    def __init__(self, dtype=None):
        self.shape = None
        self.dtype = dtype


def _jsonable_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    def conv(v):
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        if isinstance(v, (tuple, list)):
            return [conv(x) for x in v]
        if v is None or isinstance(v, (bool, int, float, str, dict)):
            return v
        raise TypeError(
            f"op attr {v!r} ({type(v).__name__}) is not serializable; "
            "pass arrays as SDVariables/constants")

    return {k: conv(v) for k, v in attrs.items()}


@dataclasses.dataclass
class TrainingConfig:
    """↔ org.nd4j.autodiff.samediff.TrainingConfig: updater, regularization,
    and the feature/label placeholder mapping."""

    loss_variable: str
    feature_placeholders: List[str] = dataclasses.field(default_factory=list)
    label_placeholders: List[str] = dataclasses.field(default_factory=list)
    updater: str = "adam"
    updater_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    l1: float = 0.0
    l2: float = 0.0

    def placeholders(self, sd: SameDiff) -> List[str]:
        names = list(self.feature_placeholders) + list(self.label_placeholders)
        if not names:
            names = [n for n, v in sd._vars.items()
                     if v.var_type == VariableType.PLACEHOLDER]
        return names
