#!/usr/bin/env python3
"""CUDA's average-pool backward over channels-last memory, and what it does to NASNet-A's gradients, on one NVIDIA Hopper card.

    python3 pool_ab.py            # needs the card; ~1 minute

Two measurements (float32, TF32 off):

1. op — ``F.avg_pool2d`` (window sums, ``divisor_override=1``, as
   ``ops/cnn._pool`` calls it) on the card over an NHWC-contiguous input
   (the channels-last memory the port's convs hand on) and over an
   NCHW-contiguous copy, and the port's ``ops/cnn.avg_pool2d``: the output
   and the gradient into the input against the same op on the CPU in
   float64 (max |error| over the float64 max), at NASNet-A Mobile's pool
   shapes, with a contiguous and a sliced output gradient (the slice of a
   concat's gradient that NASNet's cells hand the pools).
2. nasnet — ``chip_smoke.py``'s NASNet-A Mobile (batch 16 of its data,
   dropout masks from one seed): one float32 step's loss and gradients
   against the float64 copy (relative L2 over all leaves, the worst leaf,
   the float64 copy's own change under 2^-24 noise) and one step's wall
   and device time, with the port's pool and with the pool run straight
   on channels-last memory (``ops/cnn``'s path before this fix).

Prints one JSON line per measurement, then the card's nvidia-smi line;
exits 1 if the port's pool or its NASNet step fails its limit
(``chip_smoke.TOL_GRAD_L2``; the op to 1e-5).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TOL_OP = 1e-5
# (NHWC input, window, stride, padding): NASNet-A Mobile's normal-cell pools
# (stride 1 SAME at 112² × 44 and 28² × 176), a reduction cell's (stride 2)
POOL_CASES = {
    "normal_112x112x44": ((16, 112, 112, 44), 3, 1, 1),
    "normal_28x28x176": ((16, 28, 28, 176), 3, 1, 1),
    "reduction_56x56x88": ((16, 56, 56, 88), 3, 2, 1),
}


def _frac(got, want):
    return float((got.detach().double().cpu() - want).abs().max()
                 / want.abs().max())


def op(dev) -> dict:
    from deeplearning4j_tpu_torch.ops import cnn

    out = {}
    for name, (shape, window, stride, pad) in POOL_CASES.items():
        g = torch.Generator().manual_seed(0)
        x = torch.randn(shape, generator=g)

        def raw(a, layout):
            if layout == "nchw":
                a = a.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            return F.avg_pool2d(a.permute(0, 3, 1, 2), window, stride, pad,
                                count_include_pad=True,
                                divisor_override=1).permute(0, 2, 3, 1)

        def port(a, layout):
            return cnn.avg_pool2d(a, window, stride, "SAME")

        with torch.no_grad():
            n_out = raw(x, "nhwc").shape
        wide = torch.randn((*n_out[:3], 3 * n_out[3]), generator=g)
        k = n_out[3]
        for grad in ("contiguous", "sliced"):
            for fn_name, fn, layouts in (("F.avg_pool2d", raw,
                                          ("nhwc", "nchw")),
                                         ("ops.cnn.avg_pool2d", port,
                                          ("nhwc",))):
                for layout in layouts:
                    def run(device, dtype):
                        a = x.to(device, dtype).requires_grad_()
                        w = wide.to(device, dtype)
                        c = (w[..., k:2 * k] if grad == "sliced"
                             else w[..., :k].contiguous())
                        y = fn(a, layout)
                        return y, torch.autograd.grad(y, a, c)[0]

                    want_y, want_g = run("cpu", torch.float64)
                    y, gx = run(dev, torch.float32)
                    row = {"y_err": _frac(y, want_y),
                           "dx_err": _frac(gx, want_g)}
                    out[f"{name}/{fn_name}/{layout}/{grad}_grad"] = row
                    print(f"[op] {name} {fn_name} over {layout} memory, "
                          f"{grad} gradient: output {row['y_err']:.3e}, dx "
                          f"{row['dx_err']:.3e}", flush=True)
    return out


def _raw_pool():
    """``ops/cnn._pool`` as it was: the window sum straight on the input's
    memory."""
    from deeplearning4j_tpu_torch.ops import cnn

    fixed = cnn._pool

    def pool(x, init, op_name, window, stride, padding, data_format="NHWC"):
        if op_name != "add":
            return fixed(x, init, op_name, window, stride, padding,
                         data_format)
        window, stride = cnn._pair(window), cnn._pair(stride)
        xc = cnn._nchw(x, data_format)
        (t, b), (lft, r) = cnn._pads(padding, xc.shape[2:], window, stride,
                                     (1, 1))
        if t != b or lft != r:
            xc = F.pad(xc, (lft, r, t, b), value=0.0)
            t = lft = 0
        y = F.avg_pool2d(xc, window, stride, (t, lft),
                         count_include_pad=True, divisor_override=1)
        return cnn._back(y, data_format)
    return fixed, pool


def nasnet(dev, smi) -> dict:
    from deeplearning4j_tpu_torch.models.zoo import nasnet as build
    from deeplearning4j_tpu_torch.ops import cnn
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    model = build(device=dev, updater=Adam(1e-3), seed=cs.SEED,
                  **cs.NASNET_KW)
    trainer = Trainer(model)
    ts = trainer.init_state()
    batch = batch_to_device(cs._image_batches(1, cs.NASNET_BATCH,
                                              cs.NASNET_SIZE,
                                              cs.NASNET_CLASSES)[0], dev)
    fixed, raw = _raw_pool()
    out = {}
    try:
        for name, pool in (("port", fixed), ("channels_last_pool", raw),
                           ("channels_last_pool_again", raw),
                           ("port_again", fixed)):
            cnn._pool = pool
            if name.endswith("again"):
                b = cs._step_breakdown(trainer, ts, batch, ())
                out[name.replace("_again", "")]["step"] = {
                    k: b[k] for k in ("wall_ms", "device_ms",
                                      "device_idle_share")}
                out[name.replace("_again", "")]["step_pool_ms"] = \
                    b["classes_ms"].get("pool", 0.0)
                continue
            f64 = _vs_float64_ungated(name, trainer, ts, batch)
            out[name] = {"vs_float64": f64}
    finally:
        cnn._pool = fixed
    out["card"] = smi
    return out


def _vs_float64_ungated(name, trainer, ts, batch) -> dict:
    """``chip_smoke._vs_float64``'s numbers, and where it fails its gate
    (the pool straight on channels-last memory does), the loss and
    gradient errors alone."""
    try:
        return cs._vs_float64(f"pool_ab {name}", trainer, ts, batch,
                              per_leaf_max=False, dropout_seed=cs.SEED)
    except SystemExit:
        p64 = cs._float64_copy(ts.params)
        s64 = cs._float64_copy(ts.model_state)
        b64 = dict(batch, features=batch["features"].double())
        l32, _, g32 = cs._grads_by_name(trainer, ts.params, ts.model_state,
                                        batch, cs.SEED)
        l64, _, g64 = cs._grads_by_name(trainer, p64, s64, b64, cs.SEED)
        leaf, all_l2 = cs._l2_errors(g32, g64)
        worst = max(leaf, key=leaf.get)
        return {"loss_rel": abs(l32 - l64) / abs(l64), "l2_err": all_l2,
                "worst_l2_leaf": worst, "worst_l2_err": leaf[worst],
                "gate": "missed"}


def main() -> int:
    dev, smi = cs.phase_device()
    ops = op(dev)
    print(json.dumps({"op": ops}), flush=True)
    net = nasnet(dev, smi)
    print(json.dumps({"nasnet": net}), flush=True)
    print(smi, flush=True)
    port_ok = all(r["y_err"] <= TOL_OP and r["dx_err"] <= TOL_OP
                  for k, r in ops.items() if "ops.cnn" in k)
    net_ok = net["port"]["vs_float64"]["l2_err"] <= cs.TOL_GRAD_L2
    return 0 if port_ok and net_ok else 1


if __name__ == "__main__":
    sys.exit(main())
