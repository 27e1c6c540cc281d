"""YOLOv2 object detection family (↔ deeplearning4j_tpu/models/zoo/yolo.py).

``Yolo2OutputLayer`` (↔ DL4J's objdetect.Yolo2OutputLayer) takes a
feature map ``[N, H, W, B*(5+C)]`` and decodes it to ``[N, H, W, B, 5+C]``
(sigmoid xy, anchor-scaled wh, sigmoid confidence, softmax classes); its
loss takes the dense grid labels ``[N, gridH, gridW, 5+C]`` of
``make_yolo_labels`` — ``(objectness, x, y, w, h, class one-hot)``, x/y
cell-relative, w/h in grid units, one object a cell — with the
responsible anchor of an object cell the argmax of its shape-IOU with
the priors (darknet's rule), λ_coord 5 and λ_noobj 0.5, as in the JAX
package.

``decode_predictions`` and ``non_max_suppression`` are fixed-shape tensor
code that runs on the model's device. They give the JAX package's
indices at every position where scores tie: the top-K is the head of a
stable descending sort (``jax.lax.top_k`` puts the lower index first;
``torch.topk`` does not promise an order among ties) and NMS orders by a
stable sort of ``-scores`` (``jnp.argsort`` is stable). The clip of the
wh logits is ``minimum(maximum(x, -8), 8)``, as ``jnp.clip`` computes it,
so its gradient at exactly ±8 is the JAX package's 0.5 (``torch.clamp``
passes 1).

Zoo entries: ``tiny_yolo`` (↔ zoo TinyYOLO, 416², 20 classes) as a
``SequentialConfig``, ``yolo2`` (↔ zoo YOLO2, 608², 80 classes) as a
``GraphConfig`` with the JAX package's vertex names, its 38×38×512 stage
put through ``SpaceToDepth(2)`` and merged before the 19×19×1024 head.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.config import (
    GraphConfig,
    GraphVertex,
    LayerConfig,
    NeuralNetConfiguration,
    SequentialConfig,
    register_config,
)
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2D,
    Pooling2D,
    SpaceToDepth,
)
from deeplearning4j_tpu_torch.nn.model import GraphModel, SequentialModel

# anchor priors in grid units (↔ the reference zoo models' priorBoxes)
TINY_YOLO_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                     (9.42, 5.11), (16.62, 10.52))
YOLO2_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
                 (7.88282, 3.52778), (9.77052, 9.16828))


def _clip(x, lo, hi):
    """``jnp.clip``'s function and gradient: 0.5 at either bound."""
    lo = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _floor(x, eps):
    """``jnp.maximum(x, eps)`` in x's dtype."""
    return torch.maximum(x, torch.tensor(eps, dtype=x.dtype, device=x.device))


def _shape_iou(wh_a, wh_b):
    """IOU of boxes sharing a center — darknet's anchor-assignment rule."""
    inter = torch.minimum(wh_a[..., 0], wh_b[..., 0]) * \
        torch.minimum(wh_a[..., 1], wh_b[..., 1])
    union = wh_a[..., 0] * wh_a[..., 1] + wh_b[..., 0] * wh_b[..., 1] - inter
    return inter / _floor(union, 1e-9)


def _box_iou(xy_a, wh_a, xy_b, wh_b):
    """IOU of center-format boxes (same units both sides)."""
    lo = torch.maximum(xy_a - wh_a / 2, xy_b - wh_b / 2)
    hi = torch.minimum(xy_a + wh_a / 2, xy_b + wh_b / 2)
    inter = torch.prod(_floor(hi - lo, 0.0), dim=-1)
    union = (wh_a[..., 0] * wh_a[..., 1] + wh_b[..., 0] * wh_b[..., 1]
             - inter)
    return inter / _floor(union, 1e-9)


def _sum_img(a):
    """Sum over every axis but the batch."""
    return torch.sum(a, dim=tuple(range(1, a.ndim)))


@register_config
@dataclass
class Yolo2OutputLayer(LayerConfig):
    """↔ org.deeplearning4j.nn.layers.objdetect.Yolo2OutputLayer.

    Consumes a feature map ``[N, H, W, B*(5+C)]`` (B = len(anchors)).
    ``apply`` returns decoded ``(xy, wh, conf, class_probs)`` concatenated
    as ``[N, H, W, B, 5+C]``; ``compute_loss`` takes the dense grid labels
    described in the module docstring. No params.
    """

    anchors: Sequence[Tuple[float, float]] = field(
        default_factory=lambda: TINY_YOLO_ANCHORS)
    num_classes: int = 20
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5

    def output_shape(self, input_shape):
        h, w, c = input_shape
        b = len(self.anchors)
        assert c == b * (5 + self.num_classes), (
            f"feature channels {c} != {b}*(5+{self.num_classes})")
        return (h, w, b, 5 + self.num_classes)

    def init(self, generator, input_shape, dtype):
        return {}, {}

    def _anchors(self, x):
        return torch.tensor(self.anchors, dtype=x.dtype, device=x.device)

    def _split(self, x):
        n, h, w, _ = x.shape
        x = x.reshape(n, h, w, len(self.anchors), 5 + self.num_classes)
        txy, twh, to, tc = x[..., 0:2], x[..., 2:4], x[..., 4], x[..., 5:]
        xy = torch.sigmoid(txy)                                 # cell-relative
        wh = self._anchors(x) * torch.exp(_clip(twh, -8.0, 8.0))  # grid units
        return xy, wh, to, tc

    def apply(self, params, state, x, *, train=False, generator=None):
        xy, wh, to, tc = self._split(x)
        out = torch.cat([xy, wh, torch.sigmoid(to)[..., None],
                         torch.softmax(tc, dim=-1)], dim=-1)
        return out, state

    def compute_loss(self, params, state, x, labels, *, mask=None,
                     weights=None):
        xy, wh, to, tc = self._split(x)        # [N,H,W,B,*]
        obj = labels[..., 0]                   # [N,H,W]
        txy = labels[..., 1:3]                 # cell-relative target
        twh = labels[..., 3:5]                 # grid-unit target
        tcls = labels[..., 5:]

        anchors = self._anchors(x)             # [B,2]
        # responsible anchor per object cell: best shape-IOU vs priors
        prior_iou = _shape_iou(anchors[None, None, None, :, :],
                               twh[..., None, :])      # [N,H,W,B]
        resp = torch.nn.functional.one_hot(
            torch.argmax(prior_iou, dim=-1), len(self.anchors)).to(x.dtype)
        resp = resp * obj[..., None]

        # live IOU of each predicted box vs the cell's target (same units),
        # a target of the confidence: no gradient through it
        live_iou = _box_iou(xy, wh, txy[..., None, :],
                            twh[..., None, :]).detach()

        coord = _sum_img(resp[..., None] * (
            torch.square(xy - txy[..., None, :])
            + torch.square(torch.sqrt(_floor(wh, 1e-9))
                           - torch.sqrt(_floor(twh[..., None, :], 1e-9)))))
        conf = torch.sigmoid(to)
        conf_obj = _sum_img(resp * torch.square(conf - live_iou))
        conf_noobj = _sum_img((1.0 - resp) * torch.square(conf))
        logp = torch.log_softmax(tc, dim=-1)
        cls = -_sum_img(resp[..., None] * tcls[..., None, :] * logp)

        per_image = (self.lambda_coord * coord + conf_obj
                     + self.lambda_noobj * conf_noobj + cls)   # [N]
        w = mask if mask is not None else weights
        if w is not None:
            w = torch.as_tensor(w, dtype=per_image.dtype,
                                device=per_image.device).reshape(
                                    per_image.shape)
            return torch.sum(per_image * w) / _floor(torch.sum(w), 1e-12)
        return torch.mean(per_image)


def decode_predictions(decoded, *, top_k: int = 20):
    """↔ YoloUtils.getPredictedObjects, on the tensor's device.

    decoded: Yolo2OutputLayer.apply output [N,H,W,B,5+C]. Returns
    (boxes [N,K,4] as (x1,y1,x2,y2) in [0,1] image coords, scores [N,K],
    classes [N,K] int32), top-K by confidence*class score, ties in index
    order (``jax.lax.top_k``'s).
    """
    n, h, w, b, _ = decoded.shape
    top_k = min(top_k, h * w * b)
    xy, wh = decoded[..., 0:2], decoded[..., 2:4]
    conf, probs = decoded[..., 4], decoded[..., 5:]
    cols = torch.arange(w, dtype=decoded.dtype, device=decoded.device)
    rows = torch.arange(h, dtype=decoded.dtype, device=decoded.device)
    cx = (xy[..., 0] + cols[None, None, :, None]) / w
    cy = (xy[..., 1] + rows[None, :, None, None]) / h
    bw = wh[..., 0] / w
    bh = wh[..., 1] / h
    cls_score = torch.amax(probs, dim=-1) * conf
    cls_id = torch.argmax(probs, dim=-1)

    def flat(a):
        return a.reshape(n, h * w * b)

    scores, idx = torch.sort(flat(cls_score), dim=1, descending=True,
                             stable=True)
    scores, idx = scores[:, :top_k], idx[:, :top_k]

    def take(a):
        return torch.gather(flat(a), 1, idx)

    x1 = take(cx) - take(bw) / 2
    y1 = take(cy) - take(bh) / 2
    x2 = take(cx) + take(bw) / 2
    y2 = take(cy) + take(bh) / 2
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    return boxes, scores, take(cls_id).to(torch.int32)


def non_max_suppression(boxes, scores, *, iou_threshold: float = 0.45):
    """Fixed-iteration NMS over top-K candidates (static shapes, batched).

    Returns ``keep`` [N,K] {0,1} in the input order: greedy suppression in
    score order — for each candidate in descending-score order (ties in
    index order), drop it if it overlaps an already-kept higher-scoring box
    above the threshold.
    """
    n, k = scores.shape
    order = torch.argsort(-scores, dim=1, stable=True)
    bx = torch.gather(boxes, 1, order[..., None].expand(n, k, 4))

    x1, y1, x2, y2 = bx[..., 0], bx[..., 1], bx[..., 2], bx[..., 3]
    area = _floor(x2 - x1, 0.0) * _floor(y2 - y1, 0.0)
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = _floor(ix2 - ix1, 0.0) * _floor(iy2 - iy1, 0.0)
    iou = inter / _floor(area[:, :, None] + area[:, None, :] - inter, 1e-9)

    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=boxes.device).tril(-1)   # j < i
    keep = torch.ones((n, k), dtype=boxes.dtype, device=boxes.device)
    for i in range(k):
        # suppressed iff any kept earlier box overlaps too much
        over = (iou[:, i] > iou_threshold) & earlier[i] & (keep > 0)
        keep[:, i] = (~torch.any(over, dim=1)).to(boxes.dtype)
    return torch.empty_like(keep).scatter_(1, order, keep)


# --- zoo entries ------------------------------------------------------------


def _cbl(filters, kernel):
    return [Conv2D(filters=filters, kernel=kernel, use_bias=False),
            BatchNorm(activation="leakyrelu")]


def tiny_yolo_config(*, num_classes: int = 20, input_shape=(416, 416, 3),
                     anchors=TINY_YOLO_ANCHORS, updater=None,
                     seed: int = 12345) -> SequentialConfig:
    """↔ zoo TinyYOLO: 9-conv darknet-tiny backbone, stride 32, B=5."""
    net = NeuralNetConfiguration(seed=seed, updater=updater,
                                 weight_init="relu")
    b = len(anchors)
    layers = []
    for filters in (16, 32, 64, 128, 256):
        layers += _cbl(filters, 3) + [Pooling2D(pool_type="max", window=2)]
    layers += _cbl(512, 3)
    layers += _cbl(1024, 3) + _cbl(1024, 3)
    layers += [Conv2D(filters=b * (5 + num_classes), kernel=1),
               Yolo2OutputLayer(anchors=tuple(anchors),
                                num_classes=num_classes)]
    return SequentialConfig(net=net, layers=layers, input_shape=input_shape)


def tiny_yolo(device=None, **kw) -> SequentialModel:
    return SequentialModel(tiny_yolo_config(**kw), device=device)


def yolo2_config(*, num_classes: int = 80, input_shape=(608, 608, 3),
                 anchors=YOLO2_ANCHORS, updater=None,
                 seed: int = 12345) -> GraphConfig:
    """↔ zoo YOLO2: darknet19 backbone + reorg passthrough (the stride-16
    stage is space-to-depth'd and concatenated with the stride-32 head)."""
    net = NeuralNetConfiguration(seed=seed, updater=updater,
                                 weight_init="relu")
    b = len(anchors)
    v: Dict[str, GraphVertex] = {}

    def add(name, layer, inp):
        v[name] = GraphVertex(kind="layer", inputs=[inp], layer=layer)
        return name

    def cbl(name, inp, filters, kernel):
        c = add(f"{name}_c", Conv2D(filters=filters, kernel=kernel,
                                    use_bias=False), inp)
        return add(f"{name}_bn", BatchNorm(activation="leakyrelu"), c)

    def pool(name, inp):
        return add(name, Pooling2D(pool_type="max", window=2), inp)

    x = cbl("s1", "input", 32, 3)
    x = pool("p1", x)
    x = cbl("s2", x, 64, 3)
    x = pool("p2", x)
    for i, f in enumerate((128, 64, 128)):
        x = cbl(f"s3_{i}", x, f, 3 if f == 128 else 1)
    x = pool("p3", x)
    for i, f in enumerate((256, 128, 256)):
        x = cbl(f"s4_{i}", x, f, 3 if f == 256 else 1)
    x = pool("p4", x)
    for i, f in enumerate((512, 256, 512, 256, 512)):
        x = cbl(f"s5_{i}", x, f, 3 if f == 512 else 1)
    passthrough = x                      # the stride-16 stage, 512 channels
    x = pool("p5", x)
    for i, f in enumerate((1024, 512, 1024, 512, 1024)):
        x = cbl(f"s6_{i}", x, f, 3 if f == 1024 else 1)
    x = cbl("head1", x, 1024, 3)
    x = cbl("head2", x, 1024, 3)

    reorg = add("reorg", SpaceToDepth(block_size=2), passthrough)
    v["route"] = GraphVertex(kind="merge", inputs=[reorg, x])
    x = cbl("head3", "route", 1024, 3)
    x = add("head_out", Conv2D(filters=b * (5 + num_classes), kernel=1), x)
    v["yolo"] = GraphVertex(
        kind="layer", inputs=[x],
        layer=Yolo2OutputLayer(anchors=tuple(anchors),
                               num_classes=num_classes))
    return GraphConfig(net=net, inputs=["input"],
                       input_shapes={"input": tuple(input_shape)},
                       vertices=v, outputs=["yolo"])


def yolo2(device=None, **kw) -> GraphModel:
    return GraphModel(yolo2_config(**kw), device=device)


def make_yolo_labels(objects: List[List[Tuple[float, float, float, float, int]]],
                     *, grid: Tuple[int, int], num_classes: int) -> np.ndarray:
    """Host-side labels: per image a list of (cx, cy, w, h, cls) in
    [0,1] image coords → dense [N, gridH, gridW, 5+C] grid labels. A centre
    at 1.0 falls in the last row or column; a later object in a cell
    overwrites the earlier one's box (its class bit is added)."""
    gh, gw = grid
    n = len(objects)
    out = np.zeros((n, gh, gw, 5 + num_classes), np.float32)
    for i, objs in enumerate(objects):
        for (cx, cy, w, h, cls) in objs:
            col = min(int(cx * gw), gw - 1)
            row = min(int(cy * gh), gh - 1)
            out[i, row, col, 0] = 1.0
            out[i, row, col, 1] = cx * gw - col
            out[i, row, col, 2] = cy * gh - row
            out[i, row, col, 3] = w * gw
            out[i, row, col, 4] = h * gh
            out[i, row, col, 5 + cls] = 1.0
    return out
