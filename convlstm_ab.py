#!/usr/bin/env python3
"""Where the next-frame ConvLSTM's time and float32 error go, on one NVIDIA Hopper card.

    python3 convlstm_ab.py            # needs the card; ~2 minutes

Two measurements of ``chip_smoke.py``'s Keras next-frame model (406,681
parameters, batch 10 × 15 × 40 × 40 × 1, float32, TF32 off):

1. layout — ``ConvLSTM2D``'s forward as the port runs it (time-major NCHW
   inside, the steps unbound) against the same layer with an NHWC carry
   (each step's conv on a channels_last view, the gates indexed out of one
   [N, T, ...] tensor), in turns (NHWC, NCHW, NCHW, NHWC): a train step,
   a TBPTT window and a bucket-8 forward, each's wall, device and idle
   share and device time by kernel class (``chip_smoke._step_breakdown``),
   and the kernel launches of one call (the profiler's
   ``cudaLaunchKernel*`` count); the two forwards' losses must be equal.
2. drift — one TBPTT batch (3 windows of 5 frames) in float32 against the
   float64 copy run apart from the first state: each window's carries
   (each leaf's max |float32 − float64| over its max) under cuDNN's
   default, deterministic and disabled algorithms, on the card's CPU at
   batch 2, and the inference forward over all 15 frames.

Prints one JSON line per measurement, then the card's nvidia-smi line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def forward_nhwc_carry(self, params, x, initial_state):
    """``ConvLSTM2D._forward`` with the carry in NHWC, the JAX layer's
    layout, through the loop: every recurrent conv takes a channels_last
    view and each step indexes the gates of one [N, T, OH, OW, 4F]
    tensor. The same function as the port's forward."""
    from deeplearning4j_tpu_torch.nn.activations import get_activation
    from deeplearning4j_tpu_torch.ops import cnn as opscnn

    act = get_activation(self.activation)
    rec_act = get_activation(self.recurrent_activation)
    n, t, h, w, c = x.shape
    f = self.filters
    (kh, kw), (sh, sw) = self._pairs()
    xg = opscnn.conv2d(x.reshape(n * t, h, w, c), params["W"],
                       params.get("b"), stride=(sh, sw), padding=self.padding)
    oh, ow = xg.shape[1], xg.shape[2]
    xg = xg.reshape(n, t, oh, ow, 4 * f)
    if initial_state is not None:
        h_t, c_t = initial_state
    else:
        h_t = torch.zeros((n, oh, ow, f), dtype=x.dtype, device=x.device)
        c_t = torch.zeros_like(h_t)
    rw = params["RW"].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    pads = [opscnn._same_pads(oh, kh, 1, 1), opscnn._same_pads(ow, kw, 1, 1)]
    ys = []
    for s in range(t):
        rec = opscnn._conv_nd(h_t.permute(0, 3, 1, 2), rw, None, (1, 1),
                              pads, (1, 1)).permute(0, 2, 3, 1)
        i, fg, g, o = torch.split(xg[:, s] + rec, f, dim=-1)
        c_t = rec_act(fg) * c_t + rec_act(i) * act(g)
        h_t = rec_act(o) * act(c_t)
        ys.append(h_t)
    return torch.stack(ys, dim=1), (h_t, c_t)


def _launches(fn) -> int:
    """Kernel launches the host makes in one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))


def layout(dev) -> dict:
    from deeplearning4j_tpu_torch.nn.layers import recurrent
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device

    model = cs._next_frame_model(dev)
    trainer = Trainer(model)
    ts = trainer.init_state()
    batch = batch_to_device(cs._movie_batches(1, cs.CONVLSTM_BATCH)[0], dev)
    tbptt = Trainer(cs._with_tbptt(cs._next_frame_model(dev),
                                   cs.CONVLSTM_TBPTT))
    windows = cs._tbptt_windows(batch, cs.CONVLSTM_TBPTT)
    nchw = recurrent.ConvLSTM2D._forward
    out = {}
    try:
        for name, fwd in (("nhwc_carry", forward_nhwc_carry), ("nchw", nchw),
                          ("nchw", nchw), ("nhwc_carry", forward_nhwc_carry)):
            recurrent.ConvLSTM2D._forward = fwd
            _, carries, _ = tbptt.train_step_tbptt(
                ts, windows[0], tbptt._zero_carries(ts, windows[0][
                    "features"]))
            calls = {
                "step": lambda: trainer.train_step(ts, batch),
                "window": lambda: tbptt.train_step_tbptt(ts, windows[1],
                                                         carries),
                "forward_bucket8": lambda: model.output(
                    trainer.variables(ts), batch["features"][:8])}
            for what, fn in calls.items():
                bd = cs._step_breakdown(trainer, ts, None, (), step=fn)
                out.setdefault(name, {}).setdefault(what, []).append({
                    "wall_ms": bd["wall_ms"], "device_ms": bd["device_ms"],
                    "device_idle_share": bd["device_idle_share"],
                    "classes_ms": bd["classes_ms"],
                    "launches": _launches(fn)})
            loss, _, _, _ = trainer._grad_of(ts.params, ts.model_state,
                                             batch, None)
            out[name].setdefault("loss", []).append(float(loss))
    finally:
        recurrent.ConvLSTM2D._forward = nchw
    if len(set(out["nchw"]["loss"] + out["nhwc_carry"]["loss"])) != 1:
        raise SystemExit(f"convlstm_ab: the two layouts' losses differ: {out}")
    return out


def _drift(dev, n, flags) -> dict:
    """Each window's worst carry leaf against float64 (run apart from the
    first state), and the inference forward's over all 15 frames."""
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device

    model = cs._with_tbptt(cs._next_frame_model(dev), cs.CONVLSTM_TBPTT)
    trainer = Trainer(model)
    ts = trainer.init_state()
    batch = batch_to_device(cs._movie_batches(1, cs.CONVLSTM_BATCH)[0], dev)
    batch = {k: v[:n] for k, v in batch.items()}
    windows = cs._tbptt_windows(batch, cs.CONVLSTM_TBPTT)
    with torch.backends.cudnn.flags(**flags):
        _, _, c32 = cs._run_windows(trainer, ts, windows)
        _, _, c64 = cs._run_windows(trainer, cs._float64_state(ts), [
            dict(w, features=w["features"].double()) for w in windows])
        v32 = trainer.variables(ts)
        with torch.no_grad():
            f32 = model.apply_tbptt(v32, batch["features"], None)[2]
            f64 = model.apply_tbptt(cs._float64_copy(v32),
                                    batch["features"].double(), None)[2]
    return {"windows": [cs._carry_frac(a, b) for a, b in zip(c32, c64)],
            "by_layer_after_window_1": {
                name: cs._carry_frac(c32[0][name], c64[0][name])
                for name in c32[0]},
            "inference_15_frames": cs._carry_frac(f32, f64)}


def drift(dev) -> dict:
    base = dict(enabled=True, benchmark=False, deterministic=False,
                allow_tf32=False)
    out = {"cuda_default": _drift(dev, cs.CONVLSTM_BATCH, base),
           "cuda_deterministic": _drift(dev, cs.CONVLSTM_BATCH,
                                        dict(base, deterministic=True)),
           "cuda_no_cudnn": _drift(dev, cs.CONVLSTM_BATCH,
                                   dict(base, enabled=False)),
           "cuda_batch2": _drift(dev, 2, base)}
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        out["cpu_batch2"] = _drift(torch.device("cpu"), 2, base)
    finally:
        torch.set_num_threads(threads)
    return out


def main() -> int:
    dev, smi = cs.phase_device()
    print(json.dumps({"layout": layout(dev)}), flush=True)
    print(json.dumps({"drift": drift(dev)}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
