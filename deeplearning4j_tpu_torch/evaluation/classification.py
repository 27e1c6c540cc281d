"""Classification evaluation (↔ deeplearning4j_tpu/evaluation/classification.py: ``Evaluation``, ``evaluate_model``).

The per-batch statistic is a confusion-matrix accumulation on the
predictions' device (one ``bincount``), float32 as in the JAX package;
accuracy, precision, recall and F1 are derived on the host at report
time, with the JAX package's formulas, so both packages report the same
numbers for the same predictions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.data.dataset import as_batch_dict
from deeplearning4j_tpu_torch.runtime.distributed import full_tensor


def _as_tensor(a, device=None):
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t if device is None else t.to(device)


def _class_ids(labels, scores):
    """Integer class ids from one-hot/dense labels (argmax) or ids."""
    if labels.ndim == scores.ndim:
        return torch.argmax(labels, dim=-1)
    return labels.long()


def _confusion_update(cm, scores, labels, mask=None):
    """cm + the confusion counts of [N,C] (or flattened [N,T,C]) scores;
    ``mask`` weights exclude entries (padded steps). Rows whose label lies
    outside [0, k) are dropped, as the JAX package's ``segment_sum`` drops
    their out-of-range index."""
    k = cm.shape[0]
    pred = torch.argmax(scores, dim=-1).reshape(-1)
    lab = _class_ids(labels, scores).reshape(-1)
    w = None if mask is None else mask.to(torch.float32).reshape(-1)
    keep = (lab >= 0) & (lab < k)
    idx = (lab * k + pred)[keep]
    w = None if w is None else w[keep]
    counts = torch.bincount(idx, weights=w, minlength=k * k)
    return cm + counts.to(torch.float32).reshape(k, k)


def _topn_update(correct, scores, labels, n, mask=None):
    """correct + the rows whose true class is among the n highest scores.
    Among equal scores the lower class index ranks first (a stable
    descending sort, ``lax.top_k``'s order)."""
    lab = _class_ids(labels, scores).reshape(-1)
    flat = scores.reshape(-1, scores.shape[-1])
    top = torch.sort(flat, dim=-1, descending=True, stable=True).indices[
        :, :n]
    hit = torch.any(top == lab[:, None], dim=-1).to(torch.float32)
    if mask is not None:
        hit = hit * mask.to(torch.float32).reshape(-1)
    return correct + torch.sum(hit)


class Evaluation:
    """↔ org.nd4j.evaluation.classification.Evaluation.

    ``top_n``: like the reference's ``Evaluation(int topN)``, also tracks
    top-N accuracy (the true class among the N highest scores).
    """

    def __init__(self, num_classes: int, labels_list: Optional[list] = None,
                 top_n: Optional[int] = None):
        self.num_classes = num_classes
        self.labels_list = labels_list or [str(i) for i in range(num_classes)]
        self.cm = torch.zeros((num_classes, num_classes), dtype=torch.float32)
        if top_n is not None and not 1 <= top_n <= num_classes:
            raise ValueError(
                f"top_n={top_n} must be in [1, num_classes={num_classes}]")
        self.top_n = top_n
        self._topn_correct = torch.zeros((), dtype=torch.float32)
        self._topn_total = 0

    def _inputs(self, labels, predictions, mask=None):
        """Tensors on the predictions' device; the counts move there."""
        predictions = _as_tensor(predictions)
        dev = predictions.device
        self.cm = self.cm.to(dev)
        self._topn_correct = self._topn_correct.to(dev)
        m = None if mask is None else _as_tensor(mask, dev)
        return _as_tensor(labels, dev), predictions, m

    # -- accumulation ------------------------------------------------------

    def eval(self, labels, predictions):
        """Accumulate one batch. For sequence outputs ([N,T,C]) use
        eval_time_series (mask-aware)."""
        labels, predictions, _ = self._inputs(labels, predictions)
        if predictions.ndim == 3:
            return self.eval_time_series(labels, predictions)
        self.cm = _confusion_update(self.cm, predictions, labels)
        if self.top_n:
            self._topn_correct = _topn_update(
                self._topn_correct, predictions, labels, self.top_n)
            self._topn_total += predictions.shape[0]
        return self

    def top_n_accuracy(self) -> float:
        """↔ Evaluation.topNAccuracy()."""
        if not self.top_n:
            raise ValueError("construct Evaluation(..., top_n=N) to track it")
        return float(self._topn_correct) / max(int(self._topn_total), 1)

    def eval_time_series(self, labels, predictions, mask=None):
        """↔ Evaluation.evalTimeSeries: per-timestep accumulation over
        [N,T,C] predictions; an [N,T] mask excludes padded steps (from
        the top-N counts too)."""
        labels, predictions, m = self._inputs(labels, predictions, mask)
        self.cm = _confusion_update(self.cm, predictions, labels, m)
        if self.top_n:
            self._topn_correct = _topn_update(
                self._topn_correct, predictions, labels, self.top_n, m)
            self._topn_total += (int(np.prod(predictions.shape[:-1]))
                                 if m is None else int(torch.sum(m)))
        return self

    def merge(self, other: "Evaluation"):
        """↔ Evaluation.merge (for sharded/parallel eval)."""
        if self.top_n != other.top_n:
            raise ValueError(
                f"cannot merge top_n={self.top_n} with top_n={other.top_n}")
        self.cm = self.cm + other.cm.to(self.cm.device)
        self._topn_correct = (self._topn_correct
                              + other._topn_correct.to(self.cm.device))
        self._topn_total += other._topn_total
        return self

    # -- derived metrics (host side) ---------------------------------------

    def _np(self):
        return self.cm.cpu().numpy()

    def accuracy(self) -> float:
        cm = self._np()
        return float(np.trace(cm) / max(cm.sum(), 1))

    def precision(self, cls: Optional[int] = None,
                  average: str = "macro") -> float:
        cm = self._np()
        tp = np.diag(cm)
        denom = cm.sum(axis=0)
        per = np.divide(tp, denom, out=np.zeros_like(tp), where=denom > 0)
        if cls is not None:
            return float(per[cls])
        if average == "macro":
            present = denom > 0
            return float(per[present].mean()) if present.any() else 0.0
        return float(tp.sum() / max(cm.sum(), 1))

    def recall(self, cls: Optional[int] = None,
               average: str = "macro") -> float:
        cm = self._np()
        tp = np.diag(cm)
        denom = cm.sum(axis=1)
        per = np.divide(tp, denom, out=np.zeros_like(tp), where=denom > 0)
        if cls is not None:
            return float(per[cls])
        if average == "macro":
            present = denom > 0
            return float(per[present].mean()) if present.any() else 0.0
        return float(tp.sum() / max(cm.sum(), 1))

    def f1(self, cls: Optional[int] = None, average: str = "macro") -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / max(p + r, 1e-12)
        cm = self._np()
        tp = np.diag(cm)
        pden = cm.sum(axis=0)
        rden = cm.sum(axis=1)
        p = np.divide(tp, pden, out=np.zeros_like(tp), where=pden > 0)
        r = np.divide(tp, rden, out=np.zeros_like(tp), where=rden > 0)
        f = np.divide(2 * p * r, p + r, out=np.zeros_like(tp),
                      where=(p + r) > 0)
        present = rden > 0
        return float(f[present].mean()) if present.any() else 0.0

    def confusion(self) -> np.ndarray:
        return self._np()

    def stats(self, *, confusion: bool = True,
              per_class: bool = True) -> str:
        """↔ Evaluation.stats(): headline metrics, the confusion matrix
        (rows = actual, cols = predicted) and per-class precision, recall
        and F1; both blocks can be left out."""
        cm = self._np()
        lines = [
            f"# examples: {int(cm.sum())}",
            f"Accuracy:  {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f} (macro)",
            f"Recall:    {self.recall():.4f} (macro)",
            f"F1 Score:  {self.f1():.4f} (macro)",
        ]
        if self.top_n:
            lines.append(
                f"Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        k = cm.shape[0]
        if confusion:
            w = max(5, len(str(int(cm.max()))) + 1)
            lines.append("")
            lines.append("Confusion matrix (rows=actual, cols=predicted):")
            lines.append(" " * 6 + "".join(f"{c:>{w}}" for c in range(k)))
            for r in range(k):
                lines.append(f"{r:>5} " + "".join(
                    f"{int(cm[r, c]):>{w}}" for c in range(k)))
        if per_class:
            lines.append("")
            lines.append(f"{'class':>5}  {'precision':>9}  {'recall':>9}  "
                         f"{'f1':>9}  {'support':>8}")
            for c in range(k):
                lines.append(
                    f"{c:>5}  {self.precision(c):>9.4f}  "
                    f"{self.recall(c):>9.4f}  {self.f1(c):>9.4f}  "
                    f"{int(cm[c].sum()):>8}")
        return "\n".join(lines)


def _select_output(out, output_name, caller: str):
    """A graph model's output dict → the one output to evaluate; a
    multi-output dict needs ``output_name``. Non-dicts pass through."""
    if not isinstance(out, dict):
        return out
    if output_name is not None:
        if output_name not in out:
            raise KeyError(
                f"{caller}: output '{output_name}' not found; model "
                f"outputs are {sorted(out)}")
        return out[output_name]
    if len(out) == 1:
        return next(iter(out.values()))
    raise ValueError(
        f"{caller}: model has multiple outputs {sorted(out)}; pass "
        f"output_name= to choose which one to evaluate")


def evaluate_model(model, variables, data_iter, num_classes: int,
                   mesh=None,
                   output_name: Optional[str] = None) -> Evaluation:
    """↔ MultiLayerNetwork.evaluate(DataSetIterator): each batch's
    inference forward (``model.output``, on the model's device) and its
    confusion counts accumulated there, with no host sync inside the loop.
    For a multi-output graph model ``output_name`` picks the head.

    With ``mesh`` (every rank calls it with the same batches): each rank
    forwards and counts its contiguous block of each batch's rows (a tail
    batch the ranks do not divide is split unevenly, so every row counts
    once), and the confusion matrix is summed over the ranks at the end —
    the counts of the single-process evaluation."""
    ev = Evaluation(num_classes)
    cm = ev.cm.to(model.device)
    for batch in data_iter:
        b = as_batch_dict(batch)
        feats, labels = b["features"], b["labels"]
        if mesh is not None:
            feats, labels = (_rank_rows(full_tensor(v))
                             for v in (feats, labels))
            if labels.shape[0] == 0:
                continue
        out = _select_output(model.output(variables, feats), output_name,
                             "evaluate_model")
        cm = _confusion_update(cm, out, _as_tensor(labels, model.device))
    if mesh is not None:
        dist.all_reduce(cm)
    ev.cm = cm
    return ev


def _rank_rows(v):
    """This rank's contiguous block of ``v``'s rows (``np.array_split``'s
    division)."""
    n, p, r = v.shape[0], dist.get_world_size(), dist.get_rank()
    per, rem = divmod(n, p)
    lo = r * per + min(r, rem)
    return v[lo:lo + per + (r < rem)]
