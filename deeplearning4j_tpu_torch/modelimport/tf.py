"""TF frozen-GraphDef import → SameDiff program (↔ deeplearning4j_tpu/modelimport/tf.py).

ref: nd4j/samediff-import-tensorflow (OpMappingRegistry, TensorflowImporter)
and the legacy TFGraphMapper: per-op mapping rules translate GraphDef nodes
into SameDiff ops, here the port's ``autodiff.SameDiff`` on one device.

The GraphDef is read with the port's own wire codec (``tf_proto``), so
neither TensorFlow nor protobuf is needed; ``import_tf_graph`` takes the
serialized bytes, a path, TensorFlow's own GraphDef object (anything with
``SerializeToString()``) or a decoded ``tf_proto.GraphDef``.

This slice imports straight-line graphs: every mapper of the JAX package
that is not control flow. A graph with TF control flow (TF1 frames:
Enter/Merge/Switch/NextIteration/Exit/LoopCond; functional While/If;
TensorList loops) raises ``TFImportError`` naming the op (ROADMAP queue 1
item 11 lists what waits). The ``tfimport.*`` ops below are the JAX
package's, in torch; a GraphDef's Const weights become CONSTANTs on the
graph's device (``convert_to_variable`` promotes them for fine-tuning).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.samediff import (
    OP_REGISTRY,
    SameDiff,
    SDVariable,
    _index,
    matmul,
    promote,
    register_op,
    where,
)
from deeplearning4j_tpu_torch.modelimport import tf_proto
from deeplearning4j_tpu_torch.ops import cnn as ops_cnn


class TFImportError(Exception):
    pass


# --- extra ops needed by TF graphs (registered under tfimport.*) -----------


def _strided_slice(x, begin, end, strides, begin_mask=0, end_mask=0,
                   shrink_axis_mask=0, new_axis_mask=0, ellipsis_mask=0):
    if ellipsis_mask or new_axis_mask:
        raise NotImplementedError("ellipsis/new_axis in StridedSlice")
    idx = []
    for i in range(len(begin)):
        b = None if (begin_mask >> i) & 1 else begin[i]
        e = None if (end_mask >> i) & 1 else end[i]
        s = strides[i]
        if (shrink_axis_mask >> i) & 1:
            idx.append(begin[i])
        else:
            idx.append(slice(b, e, s))
    return _index(x, tuple(idx))


def _fused_batch_norm(x, scale, offset, mean, var, epsilon=1e-3):
    inv = scale * torch.rsqrt(var + epsilon)
    return x * inv + (offset - mean * inv)


def _conv2d(x, w, strides, padding, dilations=(1, 1, 1, 1)):
    return ops_cnn.conv2d(x, w, stride=tuple(strides[1:3]), padding=padding,
                          dilation=tuple(dilations[1:3]))


def _depthwise_conv2d(x, w, strides, padding, dilations=(1, 1, 1, 1)):
    return ops_cnn.depthwise_conv2d(x, w, stride=tuple(strides[1:3]),
                                    padding=padding,
                                    dilation=tuple(dilations[1:3]))


def _pool_pads(x, ksize, strides, padding):
    """NHWC → NCHW with XLA's padding of ``reduce_window``."""
    return ops_cnn._pads(padding, x.shape[1:3], ksize[1:3], strides[1:3],
                         (1, 1))


def _pool(x, ksize, strides, padding, kind):
    """``lax.reduce_window`` pooling of NHWC ``x``; a SAME average divides
    by the real elements under the window only."""
    (ph0, ph1), (pw0, pw1) = _pool_pads(x, ksize, strides, padding)
    pads = (pw0, pw1, ph0, ph1)
    k, s = tuple(ksize[1:3]), tuple(strides[1:3])
    xc = x.permute(0, 3, 1, 2)
    if kind == "max":
        y = F.max_pool2d(F.pad(xc, pads, value=float("-inf")), k, s)
    else:
        y = F.avg_pool2d(F.pad(xc, pads), k, s)
        if padding != "VALID":
            y = y / F.avg_pool2d(F.pad(torch.ones_like(xc[:1, :1]), pads),
                                 k, s)
    return y.permute(0, 2, 3, 1)


def _batch_matmul(a, b, adj_x=False, adj_y=False):
    if adj_x:
        a = a.transpose(-1, -2)
    if adj_y:
        b = b.transpose(-1, -2)
    return matmul(a, b)


def _reverse_axes(x):
    return x.permute(*reversed(range(x.dim())))


def _matmul_t(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = _reverse_axes(a)
    if transpose_b:
        b = _reverse_axes(b)
    return matmul(a, b)


def _torch_pad(paddings):
    """[[before, after]] per dim (first dim first) → F.pad's order."""
    out = []
    for lo, hi in reversed(paddings):
        out += [int(lo), int(hi)]
    return out


def _pad(x, paddings, constant_value=0.0):
    return F.pad(x, _torch_pad(paddings), value=constant_value)


def _split(x, num_or_sizes, axis):
    if isinstance(num_or_sizes, int):  # equal sections, as jnp.split
        if x.shape[axis] % num_or_sizes:
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(torch.split(x, x.shape[axis] // num_or_sizes, dim=axis))
    return tuple(torch.tensor_split(x, list(num_or_sizes), dim=axis))


def _einsum(*xs, equation):
    return torch.einsum(equation, *promote(*xs))


def _cumsum(x, axis=0, exclusive=False, reverse=False):
    if reverse:
        x = torch.flip(x, (axis,))
    y = torch.cumsum(x, dim=axis)
    if exclusive:
        y = y - x  # shift: sum of strictly-earlier elements
    if reverse:
        y = torch.flip(y, (axis,))
    return y


def _top_k(x, k):
    v, i = torch.topk(x, k)
    return v, i.to(torch.int32)  # lax.top_k's index dtype


def _resize(x, size, method):
    """``jax.image.resize`` (half-pixel centres): bilinear with
    antialiasing when it shrinks, nearest as ``floor((i + ½)·in/out)``."""
    size = (int(size[0]), int(size[1]))
    xc = x.permute(0, 3, 1, 2)
    if method == "nearest":
        y = F.interpolate(xc, size=size, mode="nearest-exact")
    else:
        shrink = size[0] < x.shape[1] or size[1] < x.shape[2]
        y = F.interpolate(xc, size=size, mode="bilinear", align_corners=False,
                          antialias=shrink)
    return y.permute(0, 2, 3, 1)


def _conv2d_backprop_input(w, dy, input_sizes, strides, padding):
    """The gradient of a NHWC/HWIO conv with respect to its input: the
    full transposed correlation of ``dy`` with ``w`` (no padding), cropped
    to the forward conv's XLA padding and the input's size."""
    n, h, wd, c = (int(v) for v in input_sizes)
    kh, kw = w.shape[0], w.shape[1]
    s = tuple(int(v) for v in strides[1:3])
    (ph, _), (pw, _) = ops_cnn._pads(padding, (h, wd), (kh, kw), s, (1, 1))
    full = F.conv_transpose2d(dy.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                              stride=s)
    full = F.pad(full, (0, max(0, pw + wd - full.shape[3]),
                        0, max(0, ph + h - full.shape[2])))
    return full[:, :, ph:ph + h, pw:pw + wd].permute(0, 2, 3, 1)


def _reflect_index(n, lo, hi, mode):
    i = np.arange(-lo, n + hi)
    if mode == "REFLECT":
        i = np.where(i < 0, -i, i)
        i = np.where(i >= n, 2 * (n - 1) - i, i)
    else:  # SYMMETRIC
        i = np.where(i < 0, -i - 1, i)
        i = np.where(i >= n, 2 * n - 1 - i, i)
    return i


def _mirror_pad(x, paddings, mode="REFLECT"):
    for d, (lo, hi) in enumerate(paddings):
        if lo or hi:
            idx = _reflect_index(x.shape[d], int(lo), int(hi), mode)
            x = torch.index_select(x, d, torch.as_tensor(idx,
                                                         device=x.device))
    return x


def _fill(dims, value):
    return torch.broadcast_to(value, tuple(int(d) for d in dims))


def _range(start, limit, delta):
    return torch.arange(start.item(), limit.item(), delta.item(),
                        device=start.device)


_TFIMPORT_OPS = {
    "tfimport.einsum": _einsum,
    "tfimport.cumsum": _cumsum,
    "tfimport.top_k": _top_k,
    "tfimport.resize": _resize,
    "tfimport.conv2d_backprop_input": _conv2d_backprop_input,
    "tfimport.mirror_pad": _mirror_pad,
    "tfimport.strided_slice": _strided_slice,
    "tfimport.fused_batch_norm": _fused_batch_norm,
    "tfimport.conv2d": _conv2d,
    "tfimport.depthwise_conv2d": _depthwise_conv2d,
    "tfimport.max_pool": lambda x, ksize, strides, padding: _pool(
        x, ksize, strides, padding, "max"),
    "tfimport.avg_pool": lambda x, ksize, strides, padding: _pool(
        x, ksize, strides, padding, "avg"),
    "tfimport.batch_matmul": _batch_matmul,
    "tfimport.matmul": _matmul_t,
    "tfimport.pad": _pad,
    "tfimport.split": _split,
    "tfimport.leaky_relu": lambda x, alpha=0.2: F.leaky_relu(x, alpha),
    "tfimport.squared_difference": lambda a, b: torch.square(a - b),
    "tfimport.rsqrt": torch.rsqrt,
    "tfimport.erf": torch.erf,
    "tfimport.select": where,
    "tfimport.range": _range,
    "tfimport.fill": _fill,
    "tfimport.floor_div": lambda a, b: torch.div(a, b, rounding_mode="floor"),
    "tfimport.floor_mod": torch.remainder,
}


def ensure_tfimport_ops():
    """Register the tfimport.* ops (idempotent). They are registered when
    this module is imported; a SameDiff replaying a loaded graph that holds
    them imports it on demand."""
    for name, fn in _TFIMPORT_OPS.items():
        register_op(name, fn)


ensure_tfimport_ops()


# --- node attr helpers -----------------------------------------------------


def _attr(node, name, default=None):
    a = node.attr.get(name)
    if a is None:
        return default
    kind, v = a.kind, a.value
    if kind == "i":
        return int(v)
    if kind == "f":
        return float(v)
    if kind == "b":
        return bool(v)
    if kind == "s":
        return v.decode()
    if kind == "list":
        if v.i:
            return [int(x) for x in v.i]
        if v.f:
            return [float(x) for x in v.f]
        if v.s:
            return [x.decode() for x in v.s]
        return []
    if kind == "type":
        return int(v)
    if kind == "shape":
        return [d.size for d in v.dim]
    if kind == "tensor":
        return v
    return default


# The JAX package's table, as it is (22 and 23 are DT_UINT32 / DT_UINT64 in
# TensorFlow's types.proto, DT_UINT16 is 17: ROADMAP §3 lists the gap).
_TF_DTYPES = {
    1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16",
    6: "int8", 9: "int64", 10: "bool", 14: "bfloat16", 19: "float16",
    22: "uint16", 23: "uint32",
}


def _np_dtype(tf_type: int) -> str:
    if tf_type not in _TF_DTYPES:
        raise TFImportError(f"unsupported TF dtype enum {tf_type}")
    return _TF_DTYPES[tf_type]


# --- host constant folding --------------------------------------------------
# Frozen graphs from real exporters compute Reshape/BroadcastTo arguments
# with on-graph shape arithmetic: Shape → StridedSlice → Pack / Mul /
# ConcatV2. The Shape mapper records its host value; these folders
# propagate it so const_value() consumers succeed. Best-effort; never
# replaces the emitted graph ops.


def _tf_fold_strided_slice(node, arrs):
    x, begin, end, strides = (np.asarray(a) for a in arrs[:4])
    if _attr(node, "new_axis_mask", 0) or _attr(node, "ellipsis_mask", 0):
        raise ValueError("unhandled mask")
    bm = _attr(node, "begin_mask", 0)
    em = _attr(node, "end_mask", 0)
    sm = _attr(node, "shrink_axis_mask", 0)
    sl = []
    shrink = []
    for i in range(len(begin)):
        if (sm >> i) & 1:
            sl.append(slice(int(begin[i]), int(begin[i]) + 1
                            if int(begin[i]) != -1 else None, 1))
            shrink.append(i)
            continue
        b = None if (bm >> i) & 1 else int(begin[i])
        e = None if (em >> i) & 1 else int(end[i])
        sl.append(slice(b, e, int(strides[i])))
    out = x[tuple(sl)]
    for i in reversed(shrink):
        out = np.squeeze(out, axis=i)
    return out


def _tf_fold_cast(node, arrs):
    return arrs[0].astype(_np_dtype(_attr(node, "DstT", 1)))


_FOLD_SIZE_CAP = 4096


def _capped(arr):
    if arr.size > _FOLD_SIZE_CAP:
        raise ValueError("fold output exceeds size cap")
    return arr


def _capped_fill(dims, value):
    n = 1
    for d in dims:
        n *= max(int(d), 0)
    if n > _FOLD_SIZE_CAP:
        raise ValueError("fold output exceeds size cap")
    return np.full(dims, value)


def _fold_reduce(fn, node, arrs):
    axes = tuple(np.atleast_1d(arrs[1]).astype(int))
    if not axes:
        return arrs[0]
    return fn(arrs[0], axis=axes,
              keepdims=bool(_attr(node, "keep_dims", 0)))


_TF_HOST_FOLDABLE = {
    "Pack": lambda n, a: np.stack(a, axis=_attr(n, "axis", 0)),
    "ConcatV2": lambda n, a: np.concatenate(
        [np.atleast_1d(x) for x in a[:-1]], axis=int(np.asarray(a[-1]))),
    "StridedSlice": _tf_fold_strided_slice,
    "Slice": lambda n, a: a[0][tuple(
        slice(int(b), int(b) + int(s)) if int(s) != -1 else slice(int(b), None)
        for b, s in zip(np.asarray(a[1]).reshape(-1),
                        np.asarray(a[2]).reshape(-1)))],
    "GatherV2": lambda n, a: np.take(
        a[0], a[1].astype(np.int64),
        axis=int(np.asarray(a[2]).reshape(())) if len(a) > 2 else 0),
    "Add": lambda n, a: a[0] + a[1],
    "AddV2": lambda n, a: a[0] + a[1],
    "Sub": lambda n, a: a[0] - a[1],
    "Mul": lambda n, a: a[0] * a[1],
    "Maximum": lambda n, a: np.maximum(a[0], a[1]),
    "Minimum": lambda n, a: np.minimum(a[0], a[1]),
    "FloorDiv": lambda n, a: a[0] // a[1],
    "FloorMod": lambda n, a: a[0] % a[1],
    "Neg": lambda n, a: -a[0],
    "Cast": _tf_fold_cast,
    "Squeeze": lambda n, a: np.squeeze(
        a[0], axis=tuple(_attr(n, "squeeze_dims", []) or []) or None),
    "ExpandDims": lambda n, a: np.expand_dims(
        a[0], int(np.asarray(a[1]).reshape(()))),
    "Prod": lambda n, a: np.prod(
        a[0], axis=tuple(np.atleast_1d(a[1]).astype(int)),
        keepdims=bool(_attr(n, "keep_dims", 0))),
    "Max": lambda n, a: _fold_reduce(np.max, n, a),
    "Min": lambda n, a: _fold_reduce(np.min, n, a),
    # Range/Fill GROW output from tiny inputs — cap the result size too
    "Range": lambda n, a: _capped(np.arange(
        *(np.asarray(x).reshape(()) for x in a))),
    "Fill": lambda n, a: _capped_fill(
        [int(v) for v in np.asarray(a[0]).reshape(-1)],
        np.asarray(a[1]).reshape(())),
    "Reshape": lambda n, a: a[0].reshape(
        [int(v) for v in np.asarray(a[1]).reshape(-1)]),
}

# TF control flow: waits for the next slice of the import (ROADMAP queue 1
# item 11); a graph holding one of these raises TFImportError naming it.
_CONTROL_FLOW_OPS = frozenset({
    "Enter", "Merge", "Switch", "NextIteration", "Exit", "LoopCond",
    "RefEnter", "RefMerge", "RefSwitch", "RefNextIteration", "RefExit",
    "While", "StatelessWhile", "If", "StatelessIf", "TensorListReserve",
    "TensorListFromTensor",
    "TensorListStack", "TensorListGetItem", "TensorListSetItem",
    "TensorListLength",
})


class _GraphImporter:
    """Walks GraphDef nodes, emitting SameDiff ops via the mapper registry
    (↔ TFGraphMapper.importGraph)."""

    def __init__(self, graph_def, input_shapes: Dict[str, Tuple], sd: SameDiff):
        self.gd = graph_def
        self.sd = sd
        self.input_shapes = input_shapes
        self.vars: Dict[str, Any] = {}  # tf tensor name -> SDVariable
        self.consts: Dict[str, np.ndarray] = {}  # host-known constant values

    def tensor(self, ref: str) -> SDVariable:
        name = ref.split(":")[0].lstrip("^")
        idx = int(ref.split(":")[1]) if ":" in ref else 0
        v = self.vars.get(name)
        if v is None:
            raise TFImportError(f"tensor {ref!r} produced by unknown node")
        if isinstance(v, tuple):
            return v[idx]
        if idx != 0:
            raise TFImportError(f"node {name} has one output; wanted :{idx}")
        return v

    def const_value(self, ref: str) -> np.ndarray:
        """Host-side value of a constant input (shapes, perms, axes...)."""
        name = ref.split(":")[0]
        if name not in self.consts:
            raise TFImportError(
                f"op needs host-known constant for {ref!r}, but {name!r} "
                "is not a Const node")
        return self.consts[name]

    def _try_fold(self, node) -> None:
        """Best-effort host evaluation when every input is host-known (see
        _TF_HOST_FOLDABLE); failures leave the graph untouched. The size
        cap keeps weight-sized const chains off the fold path."""
        fold = _TF_HOST_FOLDABLE.get(node.op)
        if fold is None or node.name in self.consts:
            return
        refs = [r.split(":")[0].lstrip("^") for r in node.input
                if not r.startswith("^")]
        if not all(r in self.consts for r in refs):
            return
        if any(self.consts[r].size > 4096 for r in refs):
            return
        try:
            self.consts[node.name] = np.asarray(
                fold(node, [self.consts[r] for r in refs]))
        except Exception:  # noqa: BLE001 - folding is advisory only
            pass

    def _process_node(self, node) -> None:
        op = node.op
        if op in _CONTROL_FLOW_OPS:
            raise TFImportError(
                f"TF control-flow op {op!r} (node {node.name}) is not "
                "supported yet: import straight-line graphs")
        if op == "Placeholder":
            shape = self.input_shapes.get(node.name)
            if shape is None:
                shape = _attr(node, "shape")
                if shape is None:
                    raise TFImportError(
                        f"placeholder {node.name} needs an input_shapes entry")
                shape = tuple(None if d in (-1, None) else d for d in shape)
            dtype = _np_dtype(_attr(node, "dtype", 1))
            self.vars[node.name] = self.sd.placeholder(
                node.name, shape, dtype)
        elif op == "Const":
            tensor = node.attr["value"].value
            try:
                arr = tf_proto.make_ndarray(tensor)
            except ValueError as e:
                raise TFImportError(f"Const {node.name}: {e}") from None
            if isinstance(arr, np.ndarray):
                self.consts[node.name] = arr
            self.vars[node.name] = self.sd.constant(
                _uniq(self.sd, node.name), arr)
        elif op in ("Identity", "StopGradient", "PreventGradient",
                    "CheckNumerics"):
            self.vars[node.name] = self.tensor(node.input[0])
            # Const→Identity chains (grappler leaves these) must keep the
            # host-known value visible to shape/axis consumers.
            src = node.input[0].split(":")[0].lstrip("^")
            if src in self.consts:
                self.consts[node.name] = self.consts[src]
        elif op == "NoOp":
            return
        else:
            mapper = TF_OP_MAPPERS.get(op)
            if mapper is None:
                raise TFImportError(
                    f"no mapper for TF op {op!r} (node {node.name}); "
                    f"supported: {sorted(TF_OP_MAPPERS)}")
            self.vars[node.name] = mapper(self, node)
            self._try_fold(node)

    def run(self, outputs: Sequence[str]) -> Dict[str, str]:
        # data-consumer map: placeholders nobody reads are skipped
        data_consumed = {r.split(":")[0] for n in self.gd.node
                         for r in n.input if not r.startswith("^")}
        for node in self.gd.node:
            if (node.op == "Placeholder" and node.name not in data_consumed
                    and node.name not in (outputs or [])
                    and node.name not in self.input_shapes):
                continue
            self._process_node(node)
        return {out: self.tensor(out).name for out in outputs}


def _uniq(sd: SameDiff, base: str) -> str:
    name = base
    i = 0
    while name in sd._vars:
        i += 1
        name = f"{base}__{i}"
    return name


# mapper(importer, node) -> SDVariable | tuple

TF_OP_MAPPERS: Dict[str, Callable] = {}


def tf_op(*names):
    def deco(fn):
        for n in names:
            TF_OP_MAPPERS[n] = fn
        return fn

    return deco


def _simple(op_name):
    """Mapper for ops that take their TF inputs positionally."""

    def mapper(imp: _GraphImporter, node):
        ins = [imp.tensor(r) for r in node.input if not r.startswith("^")]
        return imp.sd._record(op_name, ins, {
            "__argspec__": ["var"] * len(ins), "__posattrs__": []})

    return mapper


for tf_name, our_op in {
    "Add": "add", "AddV2": "add", "Sub": "sub", "Mul": "mul",
    "RealDiv": "div", "Div": "div", "Pow": "pow", "Neg": "neg",
    "Maximum": "maximum", "Minimum": "minimum",
    "Relu": "relu", "Relu6": "relu6", "Elu": "elu", "Selu": "selu",
    "Sigmoid": "sigmoid", "Tanh": "tanh", "Softplus": "softplus",
    "Exp": "exp", "Log": "log", "Sqrt": "sqrt", "Square": "square",
    "Abs": "abs", "Sign": "math.sign", "Floor": "math.floor",
    "Ceil": "math.ceil", "Round": "math.round", "Sin": "math.sin",
    "Cos": "math.cos", "Erf": "tfimport.erf", "Rsqrt": "tfimport.rsqrt",
    "LogicalAnd": "math.logical_and" if "math.logical_and" in OP_REGISTRY else "mul",
    "Equal": "eq", "NotEqual": "neq", "Greater": "gt",
    "GreaterEqual": "gte", "Less": "lt", "LessEqual": "lte",
    "SquaredDifference": "tfimport.squared_difference",
    "Select": "tfimport.select", "SelectV2": "tfimport.select",
    "FloorDiv": "tfimport.floor_div", "FloorMod": "tfimport.floor_mod",
    "ZerosLike": "zeros_like", "OnesLike": "ones_like",
}.items():
    TF_OP_MAPPERS[tf_name] = _simple(our_op)


@tf_op("MatMul")
def _matmul(imp, node):
    a, b = (imp.tensor(r) for r in node.input[:2])
    return imp.sd._record("tfimport.matmul", [a, b], {
        "__argspec__": ["var", "var"], "__posattrs__": [],
        "transpose_a": _attr(node, "transpose_a", False),
        "transpose_b": _attr(node, "transpose_b", False)})


@tf_op("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3")
def _batch_matmul_op(imp, node):
    a, b = (imp.tensor(r) for r in node.input[:2])
    return imp.sd._record("tfimport.batch_matmul", [a, b], {
        "__argspec__": ["var", "var"], "__posattrs__": [],
        "adj_x": _attr(node, "adj_x", False),
        "adj_y": _attr(node, "adj_y", False)})


@tf_op("BiasAdd")
def _bias_add(imp, node):
    a, b = (imp.tensor(r) for r in node.input[:2])
    if _attr(node, "data_format", "NHWC") == "NCHW":
        raise TFImportError("BiasAdd NCHW unsupported")
    return imp.sd._record("add", [a, b], {})


@tf_op("Softmax")
def _softmax(imp, node):
    return imp.sd._record("softmax", [imp.tensor(node.input[0])], {"axis": -1})


@tf_op("LogSoftmax")
def _log_softmax(imp, node):
    return imp.sd._record("log_softmax", [imp.tensor(node.input[0])], {"axis": -1})


@tf_op("LeakyRelu")
def _leaky(imp, node):
    return imp.sd._record("tfimport.leaky_relu", [imp.tensor(node.input[0])], {
        "__argspec__": ["var"], "__posattrs__": [],
        "alpha": _attr(node, "alpha", 0.2)})


@tf_op("Cast")
def _cast(imp, node):
    return imp.sd._record("cast", [imp.tensor(node.input[0])], {
        "dtype": _np_dtype(_attr(node, "DstT", 1))})


def _reduction(our_op):
    def mapper(imp, node):
        x = imp.tensor(node.input[0])
        axes = imp.const_value(node.input[1])
        axes = [int(a) for a in np.atleast_1d(axes)]
        # axes=[] (reduce over no axes) is the identity reduction
        return imp.sd._record(our_op, [x], {
            "axis": axes if len(axes) != 1 else axes[0],
            "keepdims": bool(_attr(node, "keep_dims", False))})

    return mapper


TF_OP_MAPPERS["Mean"] = _reduction("mean")
TF_OP_MAPPERS["Sum"] = _reduction("sum")
TF_OP_MAPPERS["Max"] = _reduction("max")
TF_OP_MAPPERS["Min"] = _reduction("min")
TF_OP_MAPPERS["Prod"] = _reduction("prod")


@tf_op("Reshape")
def _reshape(imp, node):
    x = imp.tensor(node.input[0])
    shape = [int(v) for v in imp.const_value(node.input[1])]
    return imp.sd._record("reshape", [x], {"shape": shape})


@tf_op("Transpose")
def _transpose(imp, node):
    x = imp.tensor(node.input[0])
    perm = [int(v) for v in imp.const_value(node.input[1])]
    return imp.sd._record("permute", [x], {"axes": perm})


@tf_op("ExpandDims")
def _expand_dims(imp, node):
    x = imp.tensor(node.input[0])
    axis = int(np.atleast_1d(imp.const_value(node.input[1]))[0])
    return imp.sd._record("expand_dims", [x], {"axis": axis})


@tf_op("Squeeze")
def _squeeze(imp, node):
    dims = _attr(node, "squeeze_dims", []) or None
    return imp.sd._record("squeeze", [imp.tensor(node.input[0])], {
        "axis": dims if dims else None})


@tf_op("ConcatV2")
def _concat(imp, node):
    xs = [imp.tensor(r) for r in node.input[:-1]]
    axis = int(np.atleast_1d(imp.const_value(node.input[-1]))[0])
    return imp.sd._record("concat", xs, {
        "__argspec__": ["var"] * len(xs), "__posattrs__": [], "axis": axis})


@tf_op("Pack")
def _pack(imp, node):
    xs = [imp.tensor(r) for r in node.input]
    return imp.sd._record("stack", xs, {
        "__argspec__": ["var"] * len(xs), "__posattrs__": [],
        "axis": _attr(node, "axis", 0)})


@tf_op("StridedSlice")
def _strided_slice_op(imp, node):
    x = imp.tensor(node.input[0])
    try:
        begin = [int(v) for v in imp.const_value(node.input[1])]
        end = [int(v) for v in imp.const_value(node.input[2])]
        strides = [int(v) for v in imp.const_value(node.input[3])]
    except TFImportError:
        raise TFImportError(
            f"StridedSlice {node.name}: begin/end/strides must be host-known "
            "constants (traced indices come with the control-flow import)"
        ) from None
    return imp.sd._record("tfimport.strided_slice", [x], {
        "__argspec__": ["var"], "__posattrs__": [],
        "begin": begin, "end": end, "strides": strides,
        "begin_mask": _attr(node, "begin_mask", 0),
        "end_mask": _attr(node, "end_mask", 0),
        "shrink_axis_mask": _attr(node, "shrink_axis_mask", 0),
        "new_axis_mask": _attr(node, "new_axis_mask", 0),
        "ellipsis_mask": _attr(node, "ellipsis_mask", 0)})


@tf_op("GatherV2", "Gather")
def _gather(imp, node):
    params, indices = imp.tensor(node.input[0]), imp.tensor(node.input[1])
    axis = 0
    if len(node.input) > 2:
        axis = int(np.atleast_1d(imp.const_value(node.input[2]))[0])
    return imp.sd._record("gather", [params, indices], {
        "__argspec__": ["var", "var"], "__posattrs__": [], "axis": axis})


@tf_op("OneHot")
def _one_hot(imp, node):
    indices = imp.tensor(node.input[0])
    depth = int(np.atleast_1d(imp.const_value(node.input[1]))[0])
    on = float(np.atleast_1d(imp.const_value(node.input[2]))[0])
    off = float(np.atleast_1d(imp.const_value(node.input[3]))[0])
    return imp.sd._record("math.one_hot", [indices], {
        "__argspec__": ["var"], "__posattrs__": [],
        "depth": depth, "on_value": on, "off_value": off,
        "axis": _attr(node, "axis", -1)})


@tf_op("Pad", "PadV2")
def _pad_op(imp, node):
    x = imp.tensor(node.input[0])
    paddings = [[int(a), int(b)] for a, b in imp.const_value(node.input[1])]
    cval = 0.0
    if len(node.input) > 2:
        cval = float(np.atleast_1d(imp.const_value(node.input[2]))[0])
    return imp.sd._record("tfimport.pad", [x], {
        "__argspec__": ["var"], "__posattrs__": [],
        "paddings": paddings, "constant_value": cval})


@tf_op("Tile")
def _tile(imp, node):
    x = imp.tensor(node.input[0])
    reps = [int(v) for v in imp.const_value(node.input[1])]
    return imp.sd._record("tile", [x], {"reps": reps})


@tf_op("Fill")
def _fill_op(imp, node):
    dims = [int(v) for v in imp.const_value(node.input[0])]
    value = imp.tensor(node.input[1])
    return imp.sd._record("tfimport.fill", [value], {
        "__argspec__": ["attr", "var"], "__posattrs__": [dims]})


@tf_op("Range")
def _range_op(imp, node):
    start, limit, delta = (np.atleast_1d(imp.const_value(r))[0]
                           for r in node.input[:3])
    dtype = _np_dtype(_attr(node, "Tidx", _attr(node, "Tout", 1)))
    arr = np.arange(start, limit, delta).astype(dtype)
    return imp.sd.constant(_uniq(imp.sd, node.name), arr)


@tf_op("Conv2D")
def _conv2d_op(imp, node):
    x, w = imp.tensor(node.input[0]), imp.tensor(node.input[1])
    if _attr(node, "data_format", "NHWC") != "NHWC":
        raise TFImportError("Conv2D NCHW unsupported")
    return imp.sd._record("tfimport.conv2d", [x, w], {
        "__argspec__": ["var", "var"], "__posattrs__": [],
        "strides": _attr(node, "strides", [1, 1, 1, 1]),
        "padding": _attr(node, "padding", "SAME"),
        "dilations": _attr(node, "dilations", [1, 1, 1, 1])})


@tf_op("DepthwiseConv2dNative")
def _depthwise(imp, node):
    x, w = imp.tensor(node.input[0]), imp.tensor(node.input[1])
    return imp.sd._record("tfimport.depthwise_conv2d", [x, w], {
        "__argspec__": ["var", "var"], "__posattrs__": [],
        "strides": _attr(node, "strides", [1, 1, 1, 1]),
        "padding": _attr(node, "padding", "SAME"),
        "dilations": _attr(node, "dilations", [1, 1, 1, 1])})


@tf_op("MaxPool")
def _max_pool(imp, node):
    return imp.sd._record("tfimport.max_pool", [imp.tensor(node.input[0])], {
        "__argspec__": ["var"], "__posattrs__": [],
        "ksize": _attr(node, "ksize"), "strides": _attr(node, "strides"),
        "padding": _attr(node, "padding", "VALID")})


@tf_op("AvgPool")
def _avg_pool(imp, node):
    return imp.sd._record("tfimport.avg_pool", [imp.tensor(node.input[0])], {
        "__argspec__": ["var"], "__posattrs__": [],
        "ksize": _attr(node, "ksize"), "strides": _attr(node, "strides"),
        "padding": _attr(node, "padding", "VALID")})


@tf_op("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_bn(imp, node):
    if _attr(node, "is_training", True):
        raise TFImportError("FusedBatchNorm training mode unsupported "
                            "(freeze the graph for inference import)")
    x, scale, offset, mean, var = (imp.tensor(r) for r in node.input[:5])
    out = imp.sd._record("tfimport.fused_batch_norm",
                         [x, scale, offset, mean, var], {
                             "__argspec__": ["var"] * 5, "__posattrs__": [],
                             "epsilon": _attr(node, "epsilon", 1e-3)})
    # TF yields 6 outputs (y, batch stats, reserves); only y is consumed in
    # frozen inference graphs.
    return (out,)


@tf_op("Shape")
def _shape(imp, node):
    x = imp.tensor(node.input[0])
    if x.shape is None or any(d is None for d in x.shape):
        raise TFImportError(f"Shape of dynamic tensor {node.input[0]!r}")
    arr = np.asarray(x.shape, np.int32)
    # host-known: downstream shape arithmetic folds from this
    imp.consts[node.name] = arr
    return imp.sd.constant(_uniq(imp.sd, node.name), arr)


@tf_op("Split")
def _split_op(imp, node):
    axis = int(np.atleast_1d(imp.const_value(node.input[0]))[0])
    x = imp.tensor(node.input[1])
    num = _attr(node, "num_split")
    return imp.sd._record("tfimport.split", [x], {
        "__argspec__": ["var"], "__posattrs__": [],
        "num_or_sizes": num, "axis": axis})


def import_tf_graph(
    graph_def,
    inputs: Optional[Dict[str, Tuple]] = None,
    outputs: Optional[Sequence[str]] = None,
    *,
    device=None,
) -> Tuple[SameDiff, Dict[str, str], Dict[str, str]]:
    """Import a frozen GraphDef into a SameDiff on ``device`` (the first
    CUDA card by default).

    graph_def: serialized bytes, a path, an object with
    ``SerializeToString()`` or a ``tf_proto.GraphDef``.
    inputs: optional {placeholder_name: shape} overriding/providing
    placeholder shapes (None dims allowed for batch).
    outputs: tensor names to expose; default = nodes nobody consumes.

    Returns (sd, input_map, output_map): maps from TF names to SameDiff
    variable names.
    """
    gd = tf_proto.as_graph_def(graph_def)
    if outputs is None:
        consumed = {r.split(":")[0].lstrip("^")
                    for n in gd.node for r in n.input}
        outputs = [n.name for n in gd.node
                   if n.name not in consumed and n.op not in ("Const", "NoOp")]
    sd = SameDiff.create(device)
    imp = _GraphImporter(gd, dict(inputs or {}), sd)
    out_map = imp.run(list(outputs))
    in_map = {n.name: n.name for n in gd.node
              if n.op == "Placeholder" and n.name in imp.vars}
    return sd, in_map, out_map


@tf_op("Einsum")
def _einsum_op(imp, node):
    xs = [imp.tensor(r) for r in node.input]
    return imp.sd._record("tfimport.einsum", xs, {
        "__argspec__": ["var"] * len(xs), "__posattrs__": [],
        "equation": _attr(node, "equation")})


@tf_op("Slice")
def _slice(imp, node):
    x = imp.tensor(node.input[0])
    begin = [int(v) for v in np.atleast_1d(imp.const_value(node.input[1]))]
    size = [int(v) for v in np.atleast_1d(imp.const_value(node.input[2]))]
    if x.shape is None or any(d is None for d in x.shape):
        raise TFImportError("Slice needs a static input shape")
    # TF size=-1 means "to the end of the dim"; resolve here where the dim
    # is known.
    size = [d - b if s == -1 else s
            for s, b, d in zip(size, begin, x.shape)]
    return imp.sd._record("slice", [x], {
        "__argspec__": ["var"], "__posattrs__": [],
        "begin": begin, "size": size})


@tf_op("SplitV")
def _split_v(imp, node):
    x = imp.tensor(node.input[0])
    sizes = [int(v) for v in np.atleast_1d(imp.const_value(node.input[1]))]
    axis = int(np.atleast_1d(imp.const_value(node.input[2]))[0])
    if sizes.count(-1) > 1:
        raise TFImportError("SplitV: at most one -1 size")
    if -1 in sizes:
        dim = (x.shape or [None])[axis]
        if dim is None:
            raise TFImportError("SplitV with -1 needs a static dim")
        sizes[sizes.index(-1)] = dim - (sum(sizes) + 1)
    # the split takes cut INDICES when given a list — convert sizes.
    idxs = list(np.cumsum(sizes)[:-1])
    return imp.sd._record("tfimport.split", [x], {
        "__argspec__": ["var"], "__posattrs__": [],
        "num_or_sizes": [int(i) for i in idxs], "axis": axis})


@tf_op("Unpack")
def _unpack(imp, node):
    x = imp.tensor(node.input[0])
    return imp.sd._record("unstack", [x], {"axis": _attr(node, "axis", 0)})


@tf_op("ArgMax", "ArgMin")
def _argminmax(imp, node):
    x = imp.tensor(node.input[0])
    axis = int(np.atleast_1d(imp.const_value(node.input[1]))[0])
    op = "argmax" if node.op == "ArgMax" else "argmin"
    return imp.sd._record(op, [x], {"axis": axis})


@tf_op("Cumsum")
def _cumsum_op(imp, node):
    x = imp.tensor(node.input[0])
    axis = int(np.atleast_1d(imp.const_value(node.input[1]))[0])
    return imp.sd._record("tfimport.cumsum", [x], {
        "__argspec__": ["var"], "__posattrs__": [],
        "axis": axis, "exclusive": bool(_attr(node, "exclusive", False)),
        "reverse": bool(_attr(node, "reverse", False))})


@tf_op("TopKV2")
def _top_k_op(imp, node):
    x = imp.tensor(node.input[0])
    k = int(np.atleast_1d(imp.const_value(node.input[1]))[0])
    return imp.sd._record("tfimport.top_k", [x], {
        "__argspec__": ["var"], "__posattrs__": [], "k": k})


@tf_op("ResizeBilinear", "ResizeNearestNeighbor")
def _resize_op(imp, node):
    x = imp.tensor(node.input[0])
    size = [int(v) for v in np.atleast_1d(imp.const_value(node.input[1]))]
    if _attr(node, "align_corners", False):
        raise TFImportError(
            f"{node.op}: align_corners=True (TF1 legacy grid) is not "
            "supported; re-export with tf.image.resize")
    if not _attr(node, "half_pixel_centers", False):
        raise TFImportError(
            f"{node.op}: half_pixel_centers=False (legacy asymmetric grid) "
            "is not supported; re-export with tf.image.resize")
    method = "linear" if node.op == "ResizeBilinear" else "nearest"
    return imp.sd._record("tfimport.resize", [x], {
        "__argspec__": ["var"], "__posattrs__": [],
        "size": size, "method": method})


@tf_op("Conv2DBackpropInput")
def _conv2d_backprop_input_op(imp, node):
    input_sizes = [int(v)
                   for v in np.atleast_1d(imp.const_value(node.input[0]))]
    w = imp.tensor(node.input[1])
    dy = imp.tensor(node.input[2])
    if _attr(node, "data_format", "NHWC") != "NHWC":
        raise TFImportError("Conv2DBackpropInput: only NHWC")
    return imp.sd._record("tfimport.conv2d_backprop_input", [w, dy], {
        "__argspec__": ["var", "var"], "__posattrs__": [],
        "input_sizes": input_sizes, "strides": _attr(node, "strides"),
        "padding": _attr(node, "padding")})


@tf_op("MirrorPad")
def _mirror_pad_op(imp, node):
    x = imp.tensor(node.input[0])
    paddings = [[int(a), int(b)] for a, b in imp.const_value(node.input[1])]
    mode = _attr(node, "mode", "REFLECT")
    return imp.sd._record("tfimport.mirror_pad", [x], {
        "__argspec__": ["var"], "__posattrs__": [],
        "paddings": paddings, "mode": mode})
