"""TF frozen-GraphDef import → SameDiff program (↔ deeplearning4j_tpu/modelimport/tf.py).

ref: nd4j/samediff-import-tensorflow (OpMappingRegistry, TensorflowImporter)
and the legacy TFGraphMapper: per-op mapping rules translate GraphDef nodes
into SameDiff ops, here the port's ``autodiff.SameDiff`` on one device.

The GraphDef is read with the port's own wire codec (``tf_proto``), so
neither TensorFlow nor protobuf is needed; ``import_tf_graph`` takes the
serialized bytes, a path, TensorFlow's own GraphDef object (anything with
``SerializeToString()``) or a decoded ``tf_proto.GraphDef``.

Every mapper of the JAX package is here, TF control flow included:

- TF1 frames (Enter/Merge/Switch/NextIteration/Exit/LoopCond, what
  ``convert_variables_to_constants_v2`` lowers a loop to) are raised back
  to ``SameDiff.while_loop`` subgraphs, nested frames recursively, and a
  lowered ``tf.cond`` (Switch/Merge outside a frame, or inside one) to one
  ``SameDiff.cond`` however many outputs it has.
- Functional ``While``/``StatelessWhile`` and ``If``/``StatelessIf``
  (``lower_control_flow=False``; every Keras RNN) import their
  FunctionDefs from the graph's library as subgraphs.
- TensorList ops (Keras RNNs, TensorArray loops) are dense [L, ...]
  tensors: ``TensorListReserve`` a broadcast zero (``tfimport.fill``),
  ``GetItem``/``SetItem`` ``tfimport.list_get``/``list_set``, which run on
  the device with no host read (a read clamps its index, a write out of
  range is dropped, as the JAX package's dynamic indexing and
  ``.at[].set``), ``FromTensor``/``Stack`` the identity. A list without a
  static element shape is refused.

The ``tfimport.*`` ops below are the JAX package's, in torch; a GraphDef's
Const weights become CONSTANTs on the graph's device
(``convert_to_variable`` promotes them for fine-tuning).
``freeze_tf_function`` and ``import_tf_saved_model`` import TensorFlow
inside the call only.
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
    VariableType,
    _dynamic_slice,
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


def _list_get(handle, index):
    """``handle[index]`` with a device-side index: ``lax.dynamic_slice``'s
    rule (a negative index counts from the end, then it is clamped)."""
    return _dynamic_slice(handle, (index,), (1,)).squeeze(0)


def _list_set(handle, index, item):
    """``handle.at[index].set(item)`` out of place (autograd takes it): a
    negative index counts from the end; one still out of range matches no
    row and leaves ``handle`` as it is."""
    n = handle.shape[0]
    i = index.reshape(())
    i = torch.where(i < 0, i + n, i)
    row = torch.arange(n, device=handle.device) == i
    if item.dtype != handle.dtype:
        item = item.to(handle.dtype)
    return torch.where(row.reshape((n,) + (1,) * (handle.dim() - 1)), item,
                       handle)


def _index_dyn(x, begin):
    """A pure-index StridedSlice with traced indices (``x[i, j]`` in a
    loop body): each index read as ``_list_get`` reads it."""
    for k in range(begin.shape[0]):
        x = _list_get(x, begin[k])
    return x


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
    "tfimport.index_dyn": _index_dyn,
    "tfimport.list_get": _list_get,
    "tfimport.list_set": _list_set,
    "tfimport.list_length": lambda x: torch.full(
        (), x.shape[0], dtype=torch.int32, device=x.device),
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

class _GraphImporter:
    """Walks GraphDef nodes, emitting SameDiff ops via the mapper registry
    (↔ TFGraphMapper.importGraph)."""

    def __init__(self, graph_def, input_shapes: Dict[str, Tuple], sd: SameDiff):
        self.gd = graph_def
        self.sd = sd
        self.input_shapes = input_shapes
        self.vars: Dict[str, Any] = {}  # tf tensor name -> SDVariable
        self.consts: Dict[str, np.ndarray] = {}  # host-known constant values
        # name -> FunctionDef, for functional control flow (While/If attrs
        # reference these)
        lib = graph_def.library if graph_def is not None else None
        self.library = {f.signature.name: f for f in lib.function} if lib else {}

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
        """Dispatch one NodeDef into the SameDiff graph. Shared by the
        top-level walk, FunctionDef bodies, and raised TF1 frame
        subgraphs."""
        op = node.op
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
                    "CheckNumerics", "LoopCond"):
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
        frames = _collect_frames(self.gd)
        frame_of: Dict[str, Any] = {}
        for fr in frames:
            for n in fr.members:
                frame_of[n] = fr
        clusters = _collect_cond_clusters(self.gd, set(frame_of))
        for cl in clusters:
            for n in cl.members:
                frame_of.setdefault(n, cl)  # same skip/trigger protocol
        # data-consumer map: placeholders nobody reads (the lowered form
        # emits unused_control_flow_input placeholders) are skipped, and
        # control-only stragglers of a processed frame are droppable
        data_consumed = {r.split(":")[0] for n in self.gd.node
                         for r in n.input if not r.startswith("^")}
        for node in self.gd.node:
            fr = frame_of.get(node.name)
            if fr is not None:
                if not fr.done and fr.ready(self):
                    fr.process(self)
                continue
            if (node.op == "Placeholder" and node.name not in data_consumed
                    and node.name not in (outputs or [])
                    and node.name not in self.input_shapes):
                continue
            try:
                self._process_node(node)
            except TFImportError:
                # a control-only consumer of frame internals (e.g. the
                # loop_body_control Identity): droppable iff nothing reads
                # its data output
                if node.name not in data_consumed and any(
                        _src(r) in frame_of for r in node.input):
                    continue
                raise
        undone = [fr.name for fr in frames if not fr.done]
        undone += [m.name for cl in clusters if not cl.done
                   for m in cl.merges]
        if undone:
            raise TFImportError(
                f"could not resolve TF1 control-flow structure(s) "
                f"{undone}: entry inputs never became available "
                "(malformed or unsupported graph)")
        return {out: self.tensor(out).name for out in outputs}


# --- control flow: TF1 frame raising + FunctionDef import ------------------
#
# The reference's TF import executes Switch/Merge/Enter/Exit/NextIteration
# frames with control-flow-aware sessions. Here, as in the JAX package,
# TF1 frames are RAISED back to functional cond/body subgraphs and TF2
# functional While/If (FunctionDef-carried) map directly onto
# SameDiff.while_loop / SameDiff.cond: structured control flow instead of
# a dataflow interpreter.

_FRAME_OPS = ("Enter", "Merge", "Switch", "NextIteration", "Exit", "LoopCond")


def _src(ref: str) -> str:
    """The node name of a tensor reference (``^ctrl``, ``node:1``)."""
    return ref.split(":")[0].lstrip("^")


class _SubgraphImporter(_GraphImporter):
    """Demand-driven import of a subset of GraphDef nodes into a fresh
    SameDiff, with boundary tensors (loop-var Merges/Switches, invariant
    Enters) pre-bound to placeholders. Used for raised TF1 frame bodies,
    where node order in the GraphDef is not topological (cycles through
    NextIteration). ``child_frames`` maps member names of NESTED frames
    to their _Frame: reaching one (its Exit, from the parent body's
    compute) raises the inner loop recursively within THIS subgraph."""

    def __init__(self, by_name, library, sd: SameDiff, boundary,
                 child_frames=None):
        self.gd = None
        self.sd = sd
        self.input_shapes = {}
        self.vars = dict(boundary)  # boundary name -> placeholder (any :idx)
        self._boundary = set(boundary)
        self.consts = {}
        self.library = library
        self.by_name = by_name
        self.child_frames = child_frames or {}

    def tensor(self, ref: str) -> SDVariable:
        name = _src(ref)
        if name in self._boundary:
            return self.vars[name]  # Switch:1 / Merge:0 both mean "the var"
        if name not in self.vars:
            self._ensure(name)
        return super().tensor(ref)

    def const_value(self, ref: str) -> np.ndarray:
        name = ref.split(":")[0]
        if name not in self.consts and name not in self.vars \
                and name not in self._boundary:
            self._ensure(name)
        return super().const_value(ref)

    def _ensure(self, name: str) -> None:
        unit = self.child_frames.get(name)  # nested _Frame or _CondCluster
        if unit is not None:
            # processed per importer (keyed on the provided names being in
            # OUR vars, not unit.done): a child read from both the parent's
            # cond and body subgraphs raises into each
            if not any(p in self.vars for p in unit.provided_names()):
                unit.process(self, self.by_name)
            if name not in self.vars:
                raise TFImportError(
                    f"control-flow-internal node {name!r} is consumed "
                    "outside its structure (only Exit/Merge values may "
                    "escape)")
            return
        node = self.by_name.get(name)
        if node is None:
            raise TFImportError(f"tensor {name!r}: no such node in graph")
        if node.op in _FRAME_OPS:
            raise TFImportError(
                f"node {name!r} ({node.op}) belongs to unstructured "
                "control flow this importer cannot raise (freeze with "
                "lower_control_flow=False for functional While/If)")
        for r in node.input:
            if r.startswith("^"):
                continue
            src = r.split(":")[0]
            if src not in self.vars and src not in self._boundary:
                self._ensure(src)
        self._process_node(node)


def _placeholder_like(sd: SameDiff, name: str, v: SDVariable) -> SDVariable:
    return sd.placeholder(name, v.shape, v.dtype or "float32")


class _Frame:
    """One TF1 while-loop frame and its functional reconstruction:

        init_m  = Enter_m.input                     (outer graph)
        carry_m = Merge_m(Enter_m, NextIteration_m) (loop header phi)
        pred    = cond(carries) -> LoopCond
        Switch_m(carry_m, pred): :1 -> body, :0 -> Exit_m
        body outputs = NextIteration_m.input

    Loop-invariant Enters (is_constant=true, no Merge) become
    pass-through loop vars so in-body reads see a stable carry."""

    def __init__(self, name: str):
        self.name = name
        self.enters: list = []       # loop-var Enter, merge order
        self.inv_enters: list = []   # loop-invariant Enter
        self.merges: list = []
        self.switches: list = []     # per loop var; None if unused in body
        self.next_iters: list = []
        self.exits: Dict[int, Any] = {}
        self.loop_cond = None
        self.members: set = set()
        self.children: list = []     # frames nested inside this one
        self.cond_pred_ref = None
        self.done = False

    def ready(self, imp: _GraphImporter) -> bool:
        return all(_src(e.input[0]) in imp.vars
                   for e in self.enters + self.inv_enters)

    def provided_names(self) -> list:
        return [ex.name for ex in self.exits.values()]

    def _child_frame_map(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for ch in self.children:  # nested _Frame or in-frame _CondCluster
            for n in ch.members:
                out.setdefault(n, ch)
        return out

    def process(self, imp: _GraphImporter, by_name=None) -> None:
        if by_name is None:
            by_name = {n.name: n for n in imp.gd.node}
        inits = [_init_var(imp, e.input[0])
                 for e in self.enters + self.inv_enters]
        cond_sd = SameDiff.create(imp.sd.device)
        body_sd = SameDiff.create(imp.sd.device)
        cond_bound, body_bound = {}, {}
        # placeholders declared in loop-var order: the branch fn maps them
        # positionally onto the while carry
        for i, m in enumerate(self.merges):
            v = inits[i]
            cond_bound[m.name] = _placeholder_like(cond_sd, m.name, v)
            sw = self.switches[i]
            bname = sw.name if sw is not None else f"__var{i}_unused"
            body_bound[bname] = _placeholder_like(body_sd, bname, v)
        for j, e in enumerate(self.inv_enters):
            v = inits[len(self.merges) + j]
            cond_bound[e.name] = _placeholder_like(cond_sd, e.name, v)
            body_bound[e.name] = _placeholder_like(body_sd, e.name, v)
        kids = self._child_frame_map()
        cimp = _SubgraphImporter(by_name, imp.library, cond_sd, cond_bound,
                                 child_frames=kids)
        cond_sd.branch_outputs = [cimp.tensor(self.cond_pred_ref).name]
        bimp = _SubgraphImporter(by_name, imp.library, body_sd, body_bound,
                                 child_frames=kids)
        outs = [bimp.tensor(ni.input[0]).name for ni in self.next_iters]
        outs += [body_bound[e.name].name for e in self.inv_enters]
        body_sd.branch_outputs = outs
        res = imp.sd.while_loop(cond_sd, body_sd, inits)
        res = res if isinstance(res, tuple) else (res,)
        for i, ex in self.exits.items():
            imp.vars[ex.name] = res[i]
        self.done = True


def _collect_frames(gd) -> list:
    """Identify TF1 while frames (grouped by Enter frame_name) and
    precompute their membership + structure for raising. Nested frames
    are resolved recursively: an outer frame's interior walk absorbs any
    inner frame it reaches (via the inner Exit its body consumes) into
    its membership and records it as a child; the raising then happens
    inside the outer body's subgraph import. Returns only ROOT frames;
    children hang off ``frame.children``."""
    if gd is None:
        return []
    by_name = {n.name: n for n in gd.node}
    consumers: Dict[str, list] = {}
    data_consumed = set()
    for n in gd.node:
        for r in n.input:
            if not r.startswith("^"):
                consumers.setdefault(r.split(":")[0], []).append((n, r))
                data_consumed.add(r.split(":")[0])
    enters_by_frame: Dict[str, list] = {}
    for n in gd.node:
        if n.op == "Enter":
            enters_by_frame.setdefault(_attr(n, "frame_name"), []).append(n)

    # phase 1: structure (enters/merges/switches/NIs/exits/LoopCond)
    frames: list = []
    struct_of: Dict[str, _Frame] = {}  # structural member name -> frame
    for fname, enters in enters_by_frame.items():
        fr = _Frame(fname)
        enter_names = {e.name for e in enters}
        merge_for_enter: Dict[str, Any] = {}
        for n in gd.node:
            if n.op == "Merge":
                for r in n.input:
                    src = r.split(":")[0]
                    if src in enter_names:
                        merge_for_enter[src] = n
        for e in enters:
            m = merge_for_enter.get(e.name)
            if m is None:
                fr.inv_enters.append(e)
                continue
            fr.enters.append(e)
            fr.merges.append(m)
            ni_name = next((r.split(":")[0] for r in m.input
                            if r.split(":")[0] != e.name), None)
            ni = by_name.get(ni_name)
            if ni is None or ni.op != "NextIteration":
                raise TFImportError(
                    f"frame {fname!r}: Merge {m.name} lacks a "
                    "NextIteration input (unsupported frame shape)")
            fr.next_iters.append(ni)
            sw = next((c for c, _ in consumers.get(m.name, [])
                       if c.op == "Switch"), None)
            fr.switches.append(sw)
            if sw is not None:
                lc = by_name.get(sw.input[1].split(":")[0])
                if lc is None or lc.op != "LoopCond":
                    raise TFImportError(
                        f"frame {fname!r}: Switch {sw.name} predicate is "
                        f"not a LoopCond")
                fr.loop_cond = lc
                ex = next((c for c, ref in consumers.get(sw.name, [])
                           if c.op == "Exit"), None)
                if ex is not None:
                    fr.exits[len(fr.merges) - 1] = ex
        if fr.loop_cond is None:
            raise TFImportError(
                f"frame {fname!r}: no LoopCond found (cond-only Switch/"
                "Merge graphs are not raiseable as loops)")
        fr.cond_pred_ref = fr.loop_cond.input[0]
        for nd in (fr.enters + fr.inv_enters + fr.merges + fr.next_iters
                   + [s for s in fr.switches if s is not None]
                   + list(fr.exits.values()) + [fr.loop_cond]):
            struct_of[nd.name] = fr
        frames.append(fr)

    # phase 2: full membership, innermost-first via recursion: an interior
    # walk reaching ANOTHER frame's structural node absorbs that frame
    # (children import inside the parent's body subgraph)
    def full_members(fr: _Frame, visiting: set) -> set:
        if fr.members:
            return fr.members
        if fr.name in visiting:
            raise TFImportError(
                f"frames {sorted(visiting)} are mutually entangled; "
                "cannot raise")
        visiting = visiting | {fr.name}
        boundary = ({m.name for m in fr.merges}
                    | {s.name for s in fr.switches if s is not None}
                    | {e.name for e in fr.inv_enters})
        interior: set = set()
        cond_kids: Dict[str, _CondCluster] = {}  # in-frame conds, by pred
        stack = [fr.cond_pred_ref] + [ni.input[0] for ni in fr.next_iters]
        stack = [_src(r) for r in stack]
        while stack:
            name = stack.pop()
            if name in boundary or name in interior:
                continue
            other = struct_of.get(name)
            if other is not None and other is not fr:
                if other not in fr.children:
                    fr.children.append(other)
                    interior |= full_members(other, visiting)
                    # the child's loop-entry values are computed in OUR
                    # body: keep walking from its Enter inputs
                    stack.extend(_src(e.input[0])
                                 for e in other.enters + other.inv_enters)
                continue
            node = by_name.get(name)
            if node is None:
                raise TFImportError(
                    f"frame {fr.name!r}: interior ref {name!r} missing")
            if node.op == "Merge":
                # a lowered tf.cond INSIDE the loop body: absorb it as a
                # child cluster (raised within the body subgraph import),
                # grouped by predicate so a multi-output cond still runs
                # its branches once, and keep walking from its operands
                single = _build_merge_cluster(node, by_name)
                cl = cond_kids.get(single.pred_ref)
                if cl is None:
                    cond_kids[single.pred_ref] = single
                else:
                    cl.absorb(single)
                interior |= single.members
                for sw in single.switches:
                    stack.append(_src(sw.input[0]))
                    stack.append(_src(sw.input[1]))
                continue
            if node.op in _FRAME_OPS:
                raise TFImportError(
                    f"frame {fr.name!r} touches unstructured {node.op} "
                    f"node {name!r}; cannot raise")
            interior.add(name)
            for r in node.input:
                stack.append(_src(r))
        # control-only stragglers hanging off loop machinery (pivot
        # identities, control NoOps): anything consuming a Switch/Merge
        # that only feeds control edges
        for s in list(boundary):
            for c, _ref in consumers.get(s, []):
                if (c.op in ("Identity", "NoOp")
                        and c.name not in data_consumed):
                    interior.add(c.name)
        fr.children.extend(cond_kids.values())
        fr.members = (interior | boundary
                      | {e.name for e in fr.enters + fr.inv_enters}
                      | {ni.name for ni in fr.next_iters}
                      | {e.name for e in fr.exits.values()}
                      | {fr.loop_cond.name})
        return fr.members

    for fr in frames:
        full_members(fr, set())
    nested = {ch.name for fr in frames for ch in fr.children
              if isinstance(ch, _Frame)}
    return [fr for fr in frames if fr.name not in nested]


class _CondCluster:
    """One lowered tf.cond: Switch(data, pred) pairs gate two branch
    bodies joined by Merges (one per cond output; a multi-output cond
    emits several Merges over ONE Switch set). Raised to a SINGLE
    SameDiff.cond so shared branch computation runs once:

        pred = Switch.input[1]            (shared across the cluster)
        Switch_i(data_i, pred): :1 -> true branch, :0 -> false branch
        Merge_j(true_out_j, false_out_j) -> cond output j

    Branch membership of each Merge input is decided by WHICH switch
    output index its backward closure consumes (a constant-only branch
    still reaches its pivot Switch through control edges)."""

    def __init__(self, pred_ref: str):
        self.pred_ref = pred_ref
        self.merges: list = []
        self.true_refs: list = []
        self.false_refs: list = []
        self.switches: list = []
        self.members: set = set()
        self.done = False

    def absorb(self, other: "_CondCluster") -> None:
        """Another Merge of the same predicate: one more output."""
        self.merges.extend(other.merges)
        self.true_refs.extend(other.true_refs)
        self.false_refs.extend(other.false_refs)
        for sw in other.switches:
            if sw.name not in {s.name for s in self.switches}:
                self.switches.append(sw)
        self.members |= other.members

    def provided_names(self) -> list:
        return [m.name for m in self.merges]

    def ready(self, imp: _GraphImporter) -> bool:
        return all(_src(sw.input[0]) in imp.vars
                   and _src(sw.input[1]) in imp.vars
                   for sw in self.switches)

    def process(self, imp: _GraphImporter, by_name=None) -> None:
        if by_name is None:
            by_name = {n.name: n for n in imp.gd.node}
        pred = imp.tensor(self.pred_ref)
        datas = [imp.tensor(sw.input[0]) for sw in self.switches]

        def build(branch_refs) -> SameDiff:
            sub = SameDiff.create(imp.sd.device)
            bound = {sw.name: _placeholder_like(sub, sw.name, d)
                     for sw, d in zip(self.switches, datas)}
            bimp = _SubgraphImporter(by_name, imp.library, sub, bound)
            sub.branch_outputs = [bimp.tensor(r).name for r in branch_refs]
            return sub

        res = imp.sd.cond(pred, build(self.true_refs),
                          build(self.false_refs), datas)
        res = res if isinstance(res, tuple) else (res,)
        for m, out in zip(self.merges, res):
            imp.vars[m.name] = out
        self.done = True


def _walk_cond_branch(by_name, start_ref: str, merge_name: str):
    """Backward closure (data + control) from one Merge input, stopping at
    Switch nodes. Returns (interior names, switch nodes in discovery
    order, consumed switch-output indices)."""
    interior, switches, idxs = set(), [], set()
    seen_sw = set()
    stack = [start_ref]
    while stack:
        ref = stack.pop()
        name = _src(ref)
        if name in interior:
            continue
        node = by_name.get(name)
        if node is None:
            raise TFImportError(
                f"cond at Merge {merge_name!r}: ref {name!r} missing")
        if node.op == "Switch":
            if name not in seen_sw:
                seen_sw.add(name)
                switches.append(node)
            parts = ref.lstrip("^").split(":")
            idxs.add(int(parts[1]) if len(parts) > 1 else 0)
            continue
        if node.op in ("Merge", "Enter", "Exit", "NextIteration",
                       "LoopCond"):
            raise TFImportError(
                f"cond at Merge {merge_name!r} touches {node.op} node "
                f"{name!r}: nested lowered control flow is not supported "
                "(freeze with lower_control_flow=False)")
        interior.add(name)
        stack.extend(node.input)
    return interior, switches, idxs


def _build_merge_cluster(n, by_name) -> _CondCluster:
    """Single-Merge cond cluster: walk both inputs to the gating Switch
    set, decide true/false by consumed output index, validate one shared
    predicate. Raises TFImportError for unraiseable shapes."""
    data_in = [r for r in n.input if not r.startswith("^")]
    if len(data_in) != 2:
        raise TFImportError(
            f"Merge {n.name}: {len(data_in)} data inputs; only 2-way "
            "(tf.cond) merges are raiseable")
    sides = {}
    interior = set()
    switches = []
    for ref in data_in:
        br_interior, br_switches, idxs = _walk_cond_branch(
            by_name, ref, n.name)
        interior |= br_interior
        for sw in br_switches:
            if sw.name not in {s.name for s in switches}:
                switches.append(sw)
        if idxs == {1}:
            sides["true"] = ref
        elif idxs == {0}:
            sides["false"] = ref
        else:
            raise TFImportError(
                f"Merge {n.name}: branch {ref!r} consumes switch "
                f"outputs {sorted(idxs)}; cannot assign it to one side")
    if set(sides) != {"true", "false"}:
        raise TFImportError(
            f"Merge {n.name}: could not identify both branches")
    if not switches:
        raise TFImportError(f"Merge {n.name}: no gating Switch found")
    preds = {sw.input[1] for sw in switches}
    if len(preds) > 1:
        raise TFImportError(
            f"Merge {n.name}: switches disagree on the predicate "
            f"({sorted(preds)}); unsupported cond shape")
    cl = _CondCluster(switches[0].input[1])
    cl.merges.append(n)
    cl.true_refs.append(sides["true"])
    cl.false_refs.append(sides["false"])
    cl.switches.extend(switches)
    cl.members = interior | {n.name} | {sw.name for sw in switches}
    return cl


def _collect_cond_clusters(gd, exclude: set) -> list:
    """Identify lowered tf.cond clusters: Merges OUTSIDE while frames,
    grouped by predicate so a multi-output cond (several Merges over one
    Switch set) raises to ONE SameDiff.cond with shared branch bodies."""
    if gd is None:
        return []
    by_name = {n.name: n for n in gd.node}
    by_pred: Dict[str, _CondCluster] = {}
    for n in gd.node:
        if n.op != "Merge" or n.name in exclude:
            continue
        single = _build_merge_cluster(n, by_name)
        if any(_src(sw.input[0]) in exclude or _src(sw.input[1]) in exclude
               for sw in single.switches):
            # frame-internal debris: a dead in-frame cond Merge (no live
            # consumer, unpruned freeze) gated by frame machinery: its
            # switch inputs can never resolve at top level
            continue
        cl = by_pred.get(single.pred_ref)
        if cl is None:
            by_pred[single.pred_ref] = single
        else:
            cl.absorb(single)
    return list(by_pred.values())


_TF_OUT_ARG_OFFSETS = {
    # multi-output-arg ops: FunctionDef refs are 'node:out_arg:idx'; flat
    # tuple position = offset(out_arg) + idx
    "TopKV2": {"values": 0, "indices": 1},
    "FusedBatchNorm": {"y": 0}, "FusedBatchNormV2": {"y": 0},
    "FusedBatchNormV3": {"y": 0},
    "Split": {"output": 0}, "SplitV": {"output": 0}, "Unpack": {"output": 0},
}


class _FunctionImporter(_GraphImporter):
    """Imports a FunctionDef (TF2 functional While/If branch) into a fresh
    SameDiff subgraph. FunctionDef tensor refs are 'node:out_arg:idx'
    (GraphDef uses 'node:idx') and function inputs are bare arg names;
    placeholders are declared in signature order so the branch maps
    positionally onto call-site operands."""

    def __init__(self, fdef, library, sd: SameDiff, arg_vars):
        self.gd = None
        self.sd = sd
        self.input_shapes = {}
        self.vars = {}
        self.consts = {}
        self.library = library
        self.fdef = fdef
        self._node_ops: Dict[str, str] = {}
        sig = fdef.signature
        if len(arg_vars) != len(sig.input_arg):
            raise TFImportError(
                f"function {sig.name!r} takes {len(sig.input_arg)} args, "
                f"got {len(arg_vars)}")
        for arg, v in zip(sig.input_arg, arg_vars):
            self.vars[arg.name] = _placeholder_like(self.sd, arg.name, v)

    def tensor(self, ref: str) -> SDVariable:
        parts = ref.lstrip("^").split(":")
        name = parts[0]
        if len(parts) >= 3:
            off = _TF_OUT_ARG_OFFSETS.get(
                self._node_ops.get(name, ""), {}).get(parts[1], 0)
            flat = off + int(parts[2])
        elif len(parts) == 2 and parts[1].isdigit():
            flat = int(parts[1])
        else:
            flat = 0
        v = self.vars.get(name)
        if v is None:
            raise TFImportError(f"tensor {ref!r} produced by unknown node")
        if isinstance(v, tuple):
            return v[flat]
        if flat != 0:
            raise TFImportError(f"node {name} has one output; wanted {ref!r}")
        return v

    def run_function(self) -> None:
        pending = list(self.fdef.node_def)
        while pending:
            rest = []
            for nd in pending:
                # control inputs (^node) don't gate dataflow readiness:
                # their targets (NoOps) register nothing in vars
                refs = [r.split(":")[0] for r in nd.input
                        if not r.startswith("^")]
                if all(r in self.vars for r in refs):
                    self._node_ops[nd.name] = nd.op
                    self._process_node(nd)
                else:
                    rest.append(nd)
            if len(rest) == len(pending):
                missing = sorted({r.split(":")[0] for nd in rest
                                  for r in nd.input
                                  if not r.startswith("^")
                                  and r.split(":")[0] not in self.vars})
                raise TFImportError(
                    f"function {self.fdef.signature.name!r}: unresolvable "
                    f"refs {missing[:5]} (cycle or unsupported structure)")
            pending = rest
        self.sd.branch_outputs = [
            self.tensor(self.fdef.ret[oa.name]).name
            for oa in self.fdef.signature.output_arg]


def _import_function(imp: _GraphImporter, fname: str, arg_vars) -> SameDiff:
    fdef = imp.library.get(fname)
    if fdef is None:
        raise TFImportError(
            f"function {fname!r} not found in the graph's function library")
    sub = SameDiff.create(imp.sd.device)
    _FunctionImporter(fdef, imp.library, sub, arg_vars).run_function()
    return sub


def _func_name_attr(node, key: str) -> str:
    a = node.attr.get(key)
    if a is None or a.kind != "func" or not a.value.name:
        raise TFImportError(
            f"node {node.name} ({node.op}) lacks function attr {key!r}")
    return a.value.name


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


@tf_op("TensorListReserve")
def _tensor_list_reserve(imp, node):
    """A reserved TensorList of static length and element shape is a dense
    [num_elements, *element_shape] zero: a broadcast scalar
    (``tfimport.fill``), not a constant the size of the list. A dynamic
    element shape (a graph frozen with a symbolic batch) is refused."""
    shp = np.atleast_1d(imp.const_value(node.input[0])).astype(np.int64)
    num = int(np.atleast_1d(imp.const_value(node.input[1]))[0])
    if shp.ndim != 1 or any(int(d) < 0 for d in shp) or num < 0:
        raise TFImportError(
            f"TensorListReserve {node.name}: dynamic element_shape "
            f"{shp.tolist()} / num_elements {num}; freeze the graph with "
            "concrete shapes (fixed batch) to import TensorList loops")
    dtype = _np_dtype(_attr(node, "element_dtype", 1))
    zero = imp.sd.constant(_uniq(imp.sd, f"{node.name}_zero"),
                           np.zeros((), dtype))
    return imp.sd._record("tfimport.fill", [zero], {
        "__argspec__": ["attr", "var"],
        "__posattrs__": [[num, *[int(d) for d in shp]]]})


@tf_op("TensorListFromTensor", "TensorListStack")
def _tensor_list_identity(imp, node):
    return imp.tensor(node.input[0])


@tf_op("TensorListGetItem")
def _tensor_list_get_item(imp, node):
    handle, idx = imp.tensor(node.input[0]), imp.tensor(node.input[1])
    return imp.sd._record("tfimport.list_get", [handle, idx], {
        "__argspec__": ["var", "var"], "__posattrs__": []})


@tf_op("TensorListSetItem")
def _tensor_list_set_item(imp, node):
    handle, idx, item = (imp.tensor(r) for r in node.input[:3])
    return imp.sd._record("tfimport.list_set", [handle, idx, item], {
        "__argspec__": ["var", "var", "var"], "__posattrs__": []})


@tf_op("TensorListLength")
def _tensor_list_length(imp, node):
    return imp.sd._record("tfimport.list_length", [imp.tensor(node.input[0])],
                          {"__argspec__": ["var"], "__posattrs__": []})


def _init_var(imp, ref):
    """Resolve a loop-entry input, promoting a host-known value (folded
    shape math like Keras' maximum_iterations) to a CONSTANT: the static
    trip count is found from CONSTANT inits, which a computed ARRAY var
    would hide."""
    parts = ref.lstrip("^").split(":")
    name = parts[0]
    idx0 = len(parts) == 1 or parts[-1] in ("0", "")
    v = imp.tensor(ref)  # ensures the producer (and any folding) ran
    # consts is keyed by NODE name and holds output 0: never promote a
    # :k>0 ref from it
    if v.var_type != VariableType.CONSTANT and idx0 and name in imp.consts:
        return imp.sd.constant(_uniq(imp.sd, name), imp.consts[name])
    return v


@tf_op("While", "StatelessWhile")
def _while_functional(imp, node):
    """TF2 functional while: cond/body FunctionDefs -> SameDiff.while_loop.
    Loop vars map positionally (While is N-in/N-out)."""
    inits = [_init_var(imp, r) for r in node.input if not r.startswith("^")]
    cond_sd = _import_function(imp, _func_name_attr(node, "cond"), inits)
    body_sd = _import_function(imp, _func_name_attr(node, "body"), inits)
    return imp.sd.while_loop(cond_sd, body_sd, inits)


@tf_op("If", "StatelessIf")
def _if_functional(imp, node):
    """TF2 functional cond: then/else FunctionDefs -> SameDiff.cond."""
    ins = [r for r in node.input if not r.startswith("^")]
    pred = imp.tensor(ins[0])
    args = [imp.tensor(r) for r in ins[1:]]
    t_sd = _import_function(imp, _func_name_attr(node, "then_branch"), args)
    f_sd = _import_function(imp, _func_name_attr(node, "else_branch"), args)
    return imp.sd.cond(pred, t_sd, f_sd, args)


@tf_op("StridedSlice")
def _strided_slice_op(imp, node):
    x = imp.tensor(node.input[0])
    try:
        begin = [int(v) for v in imp.const_value(node.input[1])]
        end = [int(v) for v in imp.const_value(node.input[2])]
        strides = [int(v) for v in imp.const_value(node.input[3])]
    except TFImportError:
        # Loop-var-dependent slicing (x[i] inside a while body): the bounds
        # are computed, not host constants. Supported for the pure-index
        # (all-shrink) form, read on the device; ranges with computed
        # bounds have no static shape and stay refused.
        bvar = imp.tensor(node.input[1])
        k = (bvar.shape or [1])[0] or 1
        if (_attr(node, "new_axis_mask", 0) or _attr(node, "ellipsis_mask", 0)
                or _attr(node, "begin_mask", 0) or _attr(node, "end_mask", 0)
                or _attr(node, "shrink_axis_mask", 0) != (1 << k) - 1):
            raise TFImportError(
                f"StridedSlice {node.name}: non-constant begin/end is only "
                "supported for pure-index (all-shrink) slices like x[i]")
        return imp.sd._record("tfimport.index_dyn", [x, bvar], {
            "__argspec__": ["var", "var"], "__posattrs__": []})
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
    # unconsumed placeholders (the lowered control-flow form emits
    # unused_control_flow_input stubs) are skipped by the walk and are not
    # advertised as feedable inputs
    in_map = {n.name: n.name for n in gd.node
              if n.op == "Placeholder" and n.name in imp.vars}
    return sd, in_map, out_map


def freeze_tf_function(fn, *example_args):
    """tf.function → frozen GraphDef + input/output tensor names (a helper
    for tests and tools; needs TensorFlow, imported here only)."""
    try:
        import tensorflow as tf
        from tensorflow.python.framework.convert_to_constants import (
            convert_variables_to_constants_v2,
        )
    except ImportError as e:
        raise TFImportError(
            "freeze_tf_function needs tensorflow installed") from e

    conc = tf.function(fn).get_concrete_function(*example_args)
    frozen = convert_variables_to_constants_v2(conc)
    gd = frozen.graph.as_graph_def()
    in_names = [t.name.split(":")[0] for t in frozen.inputs]
    out_names = [t.name for t in frozen.outputs]
    return gd, in_names, out_names


def import_tf_saved_model(path, *, signature: str = "serving_default",
                          outputs: Optional[Sequence[str]] = None,
                          device=None):
    """Import a TF2 SavedModel directory: the chosen signature is frozen
    with convert_variables_to_constants_v2 (``lower_control_flow=False``:
    While/If stay functional, the route for Keras RNNs' TensorList loops)
    and imported by ``import_tf_graph`` onto ``device``.

    Returns (sd, input_map, output_map) like import_tf_graph; input_map
    keys are the signature's input tensor names (":0" stripped). Needs
    TensorFlow at call time (imported here only)."""
    try:
        import tensorflow as tf
        from tensorflow.python.framework.convert_to_constants import (
            convert_variables_to_constants_v2,
        )
    except ImportError as e:
        raise TFImportError(
            "import_tf_saved_model needs tensorflow installed to load and "
            "freeze the SavedModel; export a frozen GraphDef and use "
            "import_tf_graph instead") from e

    loaded = tf.saved_model.load(str(path))
    sigs = getattr(loaded, "signatures", {})
    if signature not in sigs:
        raise TFImportError(
            f"SavedModel has no signature {signature!r}; available: "
            f"{sorted(sigs)}")
    frozen = convert_variables_to_constants_v2(
        sigs[signature], lower_control_flow=False)
    gd = frozen.graph.as_graph_def()
    # keep full name:idx ("split:1" must not collapse to output 0); ":0"
    # is dropped for cosmetics only
    out_names = [t.name[:-2] if t.name.endswith(":0") else t.name
                 for t in frozen.outputs]
    return import_tf_graph(gd, outputs=list(outputs or out_names),
                           device=device)


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
