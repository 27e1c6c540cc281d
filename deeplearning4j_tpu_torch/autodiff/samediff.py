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
  arrays.npz, updater.npz with the leaves in pytree order: dict keys
  sorted), so files move between the two packages both ways.

Not ported yet: ``cond``/``while_loop`` and the StableHLO export (ROADMAP
queue 1 item 11). A saved graph that holds control flow is refused at
``load``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import io
import json
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
    if op in ("__cond__", "__while__"):
        raise NotImplementedError(
            f"control-flow op {op} is not ported yet (SameDiff cond / "
            "while_loop)")
    if op not in OP_REGISTRY:
        raise KeyError(f"op {op!r} not registered")
    return OP_REGISTRY[op]


def promote(*xs):
    """jnp's type promotion for the ops that torch does not promote
    (matmul, stack, einsum)."""
    dt = xs[0].dtype
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
    """``lax.dynamic_slice``: ``begin`` is clamped so the window fits."""
    for d, (b, s) in enumerate(zip(begin, size)):
        b = min(max(int(b), 0), x.shape[d] - int(s))
        x = x.narrow(d, b, int(s))
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
        libnd4j shape functions; the JAX package's ``jax.eval_shape``)."""
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
            out = _replay(node, fn, metas)
        except Exception:
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
        plan = [(self._nodes[i], _bind(_op_fn(self._nodes[i].op),
                                       self._nodes[i].attrs))
                for i in self._ancestors(output_names)]

        def fn(variables, constants, placeholders):
            env: Dict[str, Any] = {}
            env.update(constants)
            env.update(variables)
            env.update(placeholders)
            for node, call in plan:
                _store(env, node, _narrow(call([env[n] for n in node.inputs])))
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
            f = _op_fn(node.op)
            out = _replay(node, f, [env[n] for n in node.inputs])
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
        return {
            "format": "deeplearning4j_tpu.samediff.v1",
            "variables": [
                {"name": n, "type": v.var_type.value, "shape": list(v.shape) if v.shape else None,
                 "dtype": v.dtype}
                for n, v in self._vars.items()
            ],
            "ops": [
                {"op": node.op, "inputs": node.inputs,
                 "outputs": node.outputs, "attrs": node.attrs,
                 "subgraphs": None}
                for node in self._nodes
            ],
            "training_config": dataclasses.asdict(self.training_config)
            if self.training_config else None,
            "iteration": self._iteration,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any], device=None) -> "SameDiff":
        if d.get("branch_outputs") is not None or any(
                o.get("subgraphs") for o in d["ops"]):
            raise NotImplementedError(
                "the graph holds control flow; SameDiff cond / while_loop "
                "are not ported yet")
        sd = SameDiff(device)
        for v in d["variables"]:
            sd._vars[v["name"]] = SDVariable(
                sd, v["name"], VariableType(v["type"]), v["shape"], v["dtype"])
        for i, o in enumerate(d["ops"]):
            node = OpNode(o["op"], list(o["inputs"]), list(o["outputs"]),
                          dict(o["attrs"]))
            sd._nodes.append(node)
            for out in node.outputs:
                sd._producer[out] = i
        if d.get("training_config"):
            sd.training_config = TrainingConfig(**d["training_config"])
        sd._iteration = int(d.get("iteration", 0))
        sd._counter = len(sd._vars)
        return sd

    def save(self, path, save_updater_state: bool = True) -> None:
        """One-file zip: graph.json + arrays.npz (+ updater.npz, its
        leaves ``leaf_<i>`` in pytree order). The arrays are stored
        uncompressed: float weights barely deflate."""
        leaves = None
        if save_updater_state:
            leaves = (tree_leaves(self._updater_state)
                      if self._updater_state is not None
                      else self._updater_leaves)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("graph.json", json.dumps(self.to_dict(), indent=1))
            buf = io.BytesIO()
            np.savez(buf, **{n: _to_numpy(v) for n, v in self._values.items()})
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
                              for k in npz.files}
            if "updater.npz" in zf.namelist():
                with np.load(io.BytesIO(zf.read("updater.npz"))) as unpz:
                    sd._updater_leaves = [
                        unpz[f"leaf_{i}"] for i in range(len(unpz.files))]
        return sd


def _grads(loss, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    names = list(params)
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
