#!/usr/bin/env python3
"""Old against new recurrent-sweep kernels (GRU and LSTM) on one NVIDIA Hopper card.

    python3 scan_ab.py --parent DIR [--out build/scan_ab.json]

``DIR`` holds an older checkout of this repository (for instance
``git archive <commit> | tar -x -C DIR``). The sources named in SOURCES
(``deeplearning4j_tpu_torch/kernels/csrc/<name>.cu``) are compiled from it
beside this checkout's, with the same flags (``flash_ab.build_parent``),
and the port's wrappers are pointed at one library set or the other in
turn. On the same inputs it then

1. checks, at ``chip_smoke.GRU_CASES`` (the char-GRU's training shape
   N=64, T=100, H=1024 from h0 = 0 and from a non-zero h0, the serving
   bucket N=8 without the workspace, N=3 at H=200): each library's hs,
   final state and workspace (the gates and h·RW_n) against the plain
   ``reference_gru_fwd``, and its dz̃ and dL/dh0, fed the new library's
   workspace, against the plain ``reference_gru_bwd``, within
   ``chip_smoke.TOL_GRU`` of max(1, |plain|); and old against new on the
   same tolerance, and bit for bit where the two ``gru_scan.cu`` are the
   same file; then at ``chip_smoke.LSTM_CASES`` the same for the LSTM:
   hs, the final state and the workspace (gates, cell states) against
   ``reference_lstm_fwd`` within ``chip_smoke.TOL_LSTM_FWD`` (absolute),
   dz, dL/dh0 and dL/dc0, fed the new library's workspace, against
   ``reference_lstm_bwd`` within ``chip_smoke.TOL_LSTM_BWD`` of max(1,
   |plain|), and old against new on the same tolerances;
2. times both sweeps of each at its training shape (GRU N=64, T=100,
   H=1024; LSTM N=32, T=256, H=256 with Graves peepholes) and each
   forward at the N=8 serving bucket, old and new in turns (old, new,
   new, old): CUDA events over back-to-back calls, the kernel launches a
   call and their busy time from the profiler, beside both bounds
   (``chip_smoke._gru_bound``, ``_lstm_bound``);
3. times the port's GRU and LSTM ops forward and backward (the x·W
   product, the kernels, the weight-gradient products) against
   torch.nn.GRU / torch.nn.LSTM (cuDNN, TF32 off, the LSTM without
   peepholes) on the same input and weights, with each library in turns;
4. breaks down one char-GRU and one char-RNN train step and one serving
   forward of each (bucket 8) per library, in turns: wall time, device
   busy time, idle share and each recurrent kernel's part;
5. reads the new libraries: ptxas's registers and spills of each
   kernel, and its SASS (``cuobjdump``) counted by instruction: the
   tensor-core products (HMMA) against everything else;
6. measures the rate ``mma.sync.m16n8k8`` reaches in TF32 on the card
   (independent products, 8 warps an SM, every SM), the ceiling of the
   kernels' products below the data sheet's 495 TFLOP/s.

It prints one JSON object as its last line and writes it to ``--out``.
Exit code 1 if a check of step 1 fails.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from flash_ab import build_parent

ROOT = Path(__file__).resolve().parent
# the recurrent sources compared
SOURCES = ("gru_scan", "lstm_scan")
ORDER = ("old", "new", "new", "old")


def load_libs(parent: Path) -> dict:
    """{"old": {source: CDLL}, "new": {source: CDLL}}, built in parallel."""
    from deeplearning4j_tpu_torch.kernels import _build

    with ThreadPoolExecutor(2 * len(SOURCES)) as pool:
        new = {n: pool.submit(lambda n=n: _build.build(n).path)
               for n in SOURCES}
        old = {n: pool.submit(build_parent, parent, n) for n in SOURCES}
        return {"old": {n: ctypes.CDLL(str(f.result())) for n, f in
                        old.items()},
                "new": {n: ctypes.CDLL(str(f.result())) for n, f in
                        new.items()}}


def use(libs: dict) -> None:
    """Point the port's wrappers at one library set (the wrappers set
    each library's argtypes on its first call)."""
    from deeplearning4j_tpu_torch.kernels import _build

    _build._libs.update(libs)


def _within(got, want, tol=cs.TOL_GRU) -> dict:
    """The largest of max |a - w| / max(1, max |w|) over the pairs, and
    whether it is within ``tol``."""
    frac = max(cs._frac(a, w) for a, w in zip(got, want))
    return {"max_err_frac": frac, "ok": frac <= tol}


def _within_abs(got, want, tol) -> dict:
    """The largest max |a - w| over the pairs, and whether it is within
    ``tol``."""
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    return {"max_abs_err": err, "ok": err <= tol}


def _same_source(parent: Path, name: str) -> bool:
    rel = Path("deeplearning4j_tpu_torch/kernels/csrc") / f"{name}.cu"
    return (parent / rel).read_bytes() == (ROOT / rel).read_bytes()


def check(dev, libs, parent) -> dict:
    from deeplearning4j_tpu_torch.kernels.gru_scan import (
        gru_bwd_cuda,
        gru_fwd_cuda,
        reference_gru_bwd,
        reference_gru_fwd,
    )

    rows = {}
    same = _same_source(parent, "gru_scan")
    for name, n, t, h, init, workspace, _ in cs.GRU_CASES:
        xp, rw, b, h0, gh = cs._gru_inputs(dev, n, t, h, init,
                                           seed=n + t + h)
        want = reference_gru_fwd(xp, rw, b, h0, save_workspace=workspace)
        fwd = {}
        for which in ("old", "new"):
            use(libs[which])
            fwd[which] = gru_fwd_cuda(xp, rw, b, h0,
                                      save_workspace=workspace)
        row = {f"fwd_{which}_vs_plain": _within(fwd[which], want)
               for which in ("old", "new")}
        row["fwd_old_vs_new"] = _within(fwd["new"], fwd["old"])
        if same:  # the same source, built twice: the same bits
            row["fwd_bit_identical"] = {"ok": all(
                torch.equal(a, w) for a, w in zip(fwd["new"], fwd["old"]))}
        if workspace:  # both backwards read the new forward's workspace
            hs, _, gates, hpn = fwd["new"]
            h_prev = torch.cat([h0[None], hs[:-1]])
            dwant = reference_gru_bwd(gates, hpn, h_prev, gh, rw)
            bwd = {}
            for which in ("old", "new"):
                use(libs[which])
                bwd[which] = gru_bwd_cuda(gates, hpn, hs, h0, gh, rw)
            row.update({f"bwd_{which}_vs_plain": _within(bwd[which], dwant)
                        for which in ("old", "new")})
            row["bwd_old_vs_new"] = _within(bwd["new"], bwd["old"])
            if same:
                row["bwd_bit_identical"] = {"ok": all(
                    torch.equal(a, w) for a, w in zip(bwd["new"],
                                                      bwd["old"]))}
        torch.cuda.synchronize()
        rows[name] = row
        _log_check(name, row)
    rows.update(check_lstm(dev, libs))
    return rows


def _log_check(name, row):
    def fmt(r):
        err = r.get("max_err_frac", r.get("max_abs_err"))
        return ("" if err is None else f" {err:.3e}") + (
            "" if r["ok"] else " FAIL")
    cs.log(f"[check] {name}: " + ", ".join(
        f"{k}{fmt(r)}" for k, r in row.items()))


def check_lstm(dev, libs) -> dict:
    """The LSTM rows of step 1, at chip_smoke.LSTM_CASES."""
    from deeplearning4j_tpu_torch.kernels.lstm_scan import (
        lstm_bwd_cuda,
        lstm_fwd_cuda,
        reference_lstm_bwd,
        reference_lstm_fwd,
    )

    rows = {}
    for name, n, t, h, peep, fb, init, _ in cs.LSTM_CASES:
        xp, rw, b, h0, c0, pe, gh, gc = cs._lstm_inputs(dev, n, t, h, peep,
                                                        init, seed=n + t + h)
        want = reference_lstm_fwd(xp, rw, b, h0, c0, pe, fb,
                                  save_workspace=True)
        fwd = {}
        for which in ("old", "new"):
            use(libs[which])
            fwd[which] = lstm_fwd_cuda(xp, rw, b, h0, c0, pe, fb,
                                       save_workspace=True)
        row = {f"fwd_{which}_vs_plain": _within_abs(fwd[which], want,
                                                    cs.TOL_LSTM_FWD)
               for which in ("old", "new")}
        row["fwd_old_vs_new"] = _within_abs(fwd["new"], fwd["old"],
                                            cs.TOL_LSTM_FWD)
        gates, cstates = fwd["new"][3], fwd["new"][4]
        c_prev = torch.cat([c0[None], cstates[:-1]])
        dwant = reference_lstm_bwd(gates, cstates, c_prev, gh, gc, rw, pe)
        bwd = {}
        for which in ("old", "new"):
            use(libs[which])
            bwd[which] = lstm_bwd_cuda(gates, cstates, c0, gh, gc, rw, pe)
        row.update({f"bwd_{which}_vs_plain": _within(bwd[which], dwant,
                                                     cs.TOL_LSTM_BWD)
                    for which in ("old", "new")})
        row["bwd_old_vs_new"] = _within(bwd["new"], bwd["old"],
                                        cs.TOL_LSTM_BWD)
        torch.cuda.synchronize()
        rows[f"lstm_{name}"] = row
        _log_check(f"lstm_{name}", row)
    return rows


def time_kernels(dev, libs) -> dict:
    """Both sweeps at the training shape and the forward at N=8, each
    library in turns: CUDA events, the step launches and busy time."""
    from deeplearning4j_tpu_torch.kernels.gru_scan import (
        gru_bwd_cuda,
        gru_fwd_cuda,
    )

    n, t, h = cs.GRU_BATCH, cs.GRU_T, cs.GRU_HIDDEN
    xp, rw, b, h0, gh = cs._gru_inputs(dev, n, t, h, False, seed=n + t + h)
    use(libs["new"])
    hs, _, gates, hpn = gru_fwd_cuda(xp, rw, b, h0, save_workspace=True)
    xp8, h08 = xp[:, :8].contiguous(), h0[:8].contiguous()
    fns = {
        "gru_fwd": lambda: gru_fwd_cuda(xp, rw, b, h0, save_workspace=True),
        "gru_bwd": lambda: gru_bwd_cuda(gates, hpn, hs, h0, gh, rw),
        "gru_fwd_n8": lambda: gru_fwd_cuda(xp8, rw, b, h08),
    }
    runs = {k: {"old": [], "new": []} for k in fns}
    for which in ORDER:
        use(libs[which])
        for key, fn in fns.items():
            kernel = key[:7]
            spans = []
            steps, _, _ = cs._step_launches(
                fn, kernel, t + (kernel == "gru_bwd"), spans=spans)
            runs[key][which].append({
                "ms": cs._time_ms(fn, iters=10, warmup=2),
                "device_ms": cs._busy_us(spans, f"{kernel}_step_kernel",
                                         5) / 1e3,
                "step_launches": steps})
    rows = {}
    for key, by_lib in runs.items():
        kernel = key[:7]
        bound = cs._gru_bound(kernel, 8 if key.endswith("n8") else n, t, h,
                              True, workspace=key == "gru_fwd")
        row = {"shape": [8 if key.endswith("n8") else n, t, h],
               "runs": by_lib, "bound_ms": bound[0], "bound_by": bound[1],
               "bound_cuda_cores_ms": bound[4]}
        for which in ("old", "new"):
            row[f"{which}_ms"] = min(r["ms"] for r in by_lib[which])
            row[f"{which}_device_ms"] = min(r["device_ms"]
                                            for r in by_lib[which])
        row["speedup"] = row["old_ms"] / row["new_ms"]
        rows[key] = row
        cs.log(f"[time] {key}: old {row['old_ms']:.4f} ms, new "
               f"{row['new_ms']:.4f} ms ({row['speedup']:.2f}x; device "
               f"{row['old_device_ms']:.4f} -> {row['new_device_ms']:.4f}), "
               f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, tensor "
               f"cores), {row['bound_cuda_cores_ms']:.4f} ms on the CUDA "
               f"cores; runs {by_lib}")
    return rows


def _lstm_route(lib_set, n, h, dev) -> str:
    """The route a library set's lstm_scan takes for N rows and H units:
    a library without ``dl4j_lstm_plan`` (older than the resident route)
    launches every step."""
    from deeplearning4j_tpu_torch.kernels.lstm_scan import launch_plan

    try:
        lib_set["lstm_scan"].dl4j_lstm_plan
    except AttributeError:
        return "step"
    use(lib_set)
    return launch_plan(n, h, dev)["route"]


def time_lstm_kernels(dev, libs) -> dict:
    """Both LSTM sweeps at the char-RNN's training shape (Graves
    peepholes, forget bias 1) and the forward at N=8 without the
    workspace, each library in turns: CUDA events, the kernel launches a
    call for its route (one persistent kernel, or T / T + 1 step kernels)
    and their busy time."""
    from deeplearning4j_tpu_torch.kernels.lstm_scan import (
        lstm_bwd_cuda,
        lstm_fwd_cuda,
    )

    n, t, h = cs.CHAR_BATCH, cs.CHAR_T, cs.CHAR_HIDDEN
    xp, rw, b, h0, c0, pe, gh, gc = cs._lstm_inputs(dev, n, t, h, True,
                                                    False, seed=n + t + h)
    use(libs["new"])
    _, _, _, gates, cstates = lstm_fwd_cuda(xp, rw, b, h0, c0, pe, 1.0,
                                            save_workspace=True)
    xp8, h08, c08 = (a[..., :8, :].contiguous() for a in (xp, h0, c0))
    fns = {
        "lstm_fwd": lambda: lstm_fwd_cuda(xp, rw, b, h0, c0, pe, 1.0,
                                          save_workspace=True),
        "lstm_bwd": lambda: lstm_bwd_cuda(gates, cstates, c0, gh, gc, rw,
                                          pe),
        "lstm_fwd_n8": lambda: lstm_fwd_cuda(xp8, rw, b, h08, c08, pe, 1.0),
    }
    routes = {which: {key: _lstm_route(libs[which],
                                       8 if key.endswith("n8") else n, h,
                                       dev) for key in fns}
              for which in ("old", "new")}
    runs = {k: {"old": [], "new": []} for k in fns}
    for which in ORDER:
        use(libs[which])
        for key, fn in fns.items():
            kernel = key[:8]
            route = routes[which][key]
            if route == "resident":
                name, want = f"{kernel}_persistent_kernel", 1
            else:
                name, want = f"{kernel}_step_kernel", t + (
                    kernel == "lstm_bwd")
            spans = []
            launches, _, _ = cs._step_launches(fn, kernel, want,
                                               spans=spans, name=name)
            runs[key][which].append({
                "ms": cs._time_ms(fn, iters=10, warmup=2),
                "device_ms": cs._busy_us(spans, f"{kernel}_", 5) / 1e3,
                "route": route, "launches": launches})
    rows = {}
    for key, by_lib in runs.items():
        kernel = key[:8]
        rows_n = 8 if key.endswith("n8") else n
        bound = cs._lstm_bound(kernel, rows_n, t, h, True, True,
                               workspace=key == "lstm_fwd")
        row = {"shape": [rows_n, t, h], "runs": by_lib,
               "bound_ms": bound[0], "bound_by": bound[1],
               "bound_cuda_cores_ms": bound[4]}
        for which in ("old", "new"):
            row[f"{which}_ms"] = min(r["ms"] for r in by_lib[which])
            row[f"{which}_device_ms"] = min(r["device_ms"]
                                            for r in by_lib[which])
        row["speedup"] = row["old_ms"] / row["new_ms"]
        rows[key] = row
        cs.log(f"[time] {key}: old {row['old_ms']:.4f} ms, new "
               f"{row['new_ms']:.4f} ms ({row['speedup']:.2f}x; device "
               f"{row['old_device_ms']:.4f} -> {row['new_device_ms']:.4f}), "
               f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, tensor "
               f"cores), {row['bound_cuda_cores_ms']:.4f} ms on the CUDA "
               f"cores; runs {by_lib}")
    return rows


def time_lstm_ops(dev, libs) -> dict:
    """The port's LSTM op against torch.nn.LSTM (cuDNN, no peepholes),
    each library in turns (``chip_smoke._time_cudnn``)."""
    n, t, h = cs.CHAR_BATCH, cs.CHAR_T, cs.CHAR_HIDDEN
    _, rw, b, *_ = cs._lstm_inputs(dev, n, t, h, False, False,
                                   seed=n + t + h)
    runs = {"old": [], "new": []}
    for which in ORDER:
        use(libs[which])
        runs[which].append(cs._time_cudnn(dev, rw, b, 1.0))
    row = {"runs": runs}
    for key in ("op_fwd_ms", "op_bwd_ms"):
        for which in ("old", "new"):
            row[f"{which}_{key}"] = min(r[key] for r in runs[which])
    for key in ("cudnn_fwd_ms", "cudnn_bwd_ms"):
        row[key] = min(r[key] for rs in runs.values() for r in rs)
    cs.log(f"[op] LSTM forward old {row['old_op_fwd_ms']:.4f} -> new "
           f"{row['new_op_fwd_ms']:.4f} ms, cuDNN {row['cudnn_fwd_ms']:.4f}"
           f" ms; backward old {row['old_op_bwd_ms']:.4f} -> new "
           f"{row['new_op_bwd_ms']:.4f} ms, cuDNN {row['cudnn_bwd_ms']:.4f}"
           f" ms")
    return row


def char_rnn(dev, libs) -> dict:
    """One char-RNN train step and one serving forward (bucket 8) per
    library, in turns."""
    from deeplearning4j_tpu_torch.models.zoo.classic import next_char_probs
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    model = cs._char_rnn(dev, "pallas", Adam(cs.CHAR_LR))
    trainer = Trainer(model)
    ts = trainer.init_state()
    batch = batch_to_device(cs._char_batches()[0], dev)
    variables = trainer.variables(ts)
    ids8 = torch.from_numpy(np.ascontiguousarray(cs._text_windows(
        cs.CHAR_VOCAB, 8, cs.CHAR_T)[0][:, :-1]).astype(np.int32)).to(dev)
    runs = {"step": {"old": [], "new": []},
            "serving_forward": {"old": [], "new": []}}
    for which in ORDER:
        use(libs[which])
        step = cs._step_breakdown(trainer, ts, batch,
                                  ("lstm_fwd", "lstm_bwd"))
        fwd = cs._forward_breakdown(
            lambda: next_char_probs(model, variables, ids8), "lstm_fwd")
        runs["step"][which].append(step)
        runs["serving_forward"][which].append(fwd)
        cs.log(f"[char_rnn] {which}: step wall {step['wall_ms']:.2f} ms, "
               f"device {step['device_ms']:.3f} ms, idle "
               f"{step['device_idle_share']:.3f}, lstm_fwd "
               f"{step['kernels']['lstm_fwd']['ms']:.3f} ms, lstm_bwd "
               f"{step['kernels']['lstm_bwd']['ms']:.3f} ms; serving "
               f"forward wall {fwd['wall_ms']:.3f} ms, device "
               f"{fwd['device_ms']:.3f} ms, lstm_fwd {fwd['lstm_fwd_ms']:.3f}"
               f" ms, idle {fwd['device_idle_share']:.3f}")
    return runs


def time_ops(dev, libs) -> dict:
    """The port's GRU op against torch.nn.GRU (cuDNN), each library in
    turns (``chip_smoke._time_cudnn_gru``)."""
    n, t, h = cs.GRU_BATCH, cs.GRU_T, cs.GRU_HIDDEN
    _, rw, b, _, _ = cs._gru_inputs(dev, n, t, h, False, seed=n + t + h)
    runs = {"old": [], "new": []}
    for which in ORDER:
        use(libs[which])
        runs[which].append(cs._time_cudnn_gru(dev, rw, b))
    row = {"runs": runs}
    for key in ("op_fwd_ms", "op_bwd_ms"):
        for which in ("old", "new"):
            row[f"{which}_{key}"] = min(r[key] for r in runs[which])
    for key in ("cudnn_fwd_ms", "cudnn_bwd_ms"):
        row[key] = min(r[key] for rs in runs.values() for r in rs)
    cs.log(f"[op] forward old {row['old_op_fwd_ms']:.4f} -> new "
           f"{row['new_op_fwd_ms']:.4f} ms, cuDNN {row['cudnn_fwd_ms']:.4f}"
           f" ms; backward old {row['old_op_bwd_ms']:.4f} -> new "
           f"{row['new_op_bwd_ms']:.4f} ms, cuDNN {row['cudnn_bwd_ms']:.4f}"
           f" ms")
    return row


def char_gru(dev, libs) -> dict:
    """One char-GRU train step and one serving forward (bucket 8) per
    library, in turns."""
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    model = cs._char_gru(dev, "pallas", Adam(cs.GRU_LR))
    trainer = Trainer(model)
    ts = trainer.init_state()
    batch = batch_to_device(cs._gru_batches()[0], dev)
    variables = trainer.variables(ts)
    ids8 = batch["features"][:8]
    runs = {"step": {"old": [], "new": []},
            "serving_forward": {"old": [], "new": []}}
    for which in ORDER:
        use(libs[which])
        step = cs._step_breakdown(trainer, ts, batch, ("gru_fwd", "gru_bwd"))
        fwd = cs._forward_breakdown(
            lambda: cs._next_char_gru_probs(model, variables, ids8),
            "gru_fwd")
        runs["step"][which].append(step)
        runs["serving_forward"][which].append(fwd)
        cs.log(f"[char_gru] {which}: step wall {step['wall_ms']:.2f} ms, "
               f"device {step['device_ms']:.3f} ms, idle "
               f"{step['device_idle_share']:.3f}, gru_fwd "
               f"{step['kernels']['gru_fwd']['ms']:.3f} ms, gru_bwd "
               f"{step['kernels']['gru_bwd']['ms']:.3f} ms; serving forward "
               f"wall {fwd['wall_ms']:.3f} ms, device {fwd['device_ms']:.3f}"
               f" ms, gru_fwd {fwd['gru_fwd_ms']:.3f} ms")
    return runs


def read_library(source) -> dict:
    """ptxas's report and the SASS instruction counts of the new
    library's kernels of ``source``."""
    from deeplearning4j_tpu_torch.kernels import _build

    built = _build.build(source)
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(built.path)],
                         capture_output=True, text=True)
    counts, kernel = {}, None
    for line in res.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            kernel = head.group(1)
            counts[kernel] = collections.Counter()
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      line)
        if kernel and op:
            counts[kernel][op.group(1).split(".")[0]] += 1
    sass = {k: {"instructions": sum(c.values()), "HMMA": c["HMMA"],
                "LDS": c["LDS"], "LDSM": c["LDSM"],
                "top": dict(c.most_common(8))}
            for k, c in counts.items()}
    for k, r in sass.items():
        cs.log(f"[sass] {k[:90]}: {r}")
    if res.returncode != 0:
        cs.log(f"[sass] cuobjdump failed: {res.stderr.strip()[:300]}")
    return {"ptxas": ptxas, "sass": sass}


MMA_RATE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// 8 independent m16n8k8 TF32 accumulators a warp, `iters` rounds
__global__ void mma_rate(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b[2] = {5u, threadIdx.x};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int blocks, int iters, float* out, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  mma_rate<<<blocks, 256>>>(out, iters);
  cudaEventRecord(e0);
  mma_rate<<<blocks, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_rate(dev) -> dict:
    """TF32 FLOP/s of mma.sync.m16n8k8 with 8 warps on every SM."""
    from deeplearning4j_tpu_torch.kernels import _build

    src = ROOT / "build" / "scan_ab" / "mma_rate.cu"
    lib_path = src.with_suffix(".so")
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(MMA_RATE_CU)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                          str(lib_path), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"scan_ab: nvcc failed on {src}:\n{res.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 256, device=dev)
    ms = ctypes.c_float()
    iters = 4000
    rc = lib.run(sms, iters, out.data_ptr(), ctypes.byref(ms))
    if rc != 0:
        raise SystemExit(f"scan_ab: the mma.sync rate kernel failed ({rc})")
    flops = 2 * 16 * 8 * 8 * 8 * iters * 8 * sms  # 8 warps of 8 chains
    row = {"tf32_tflops": flops / (ms.value * 1e-3) / 1e12, "sms": sms,
           "ms": ms.value}
    cs.log(f"[mma] mma.sync.m16n8k8 TF32: {row['tf32_tflops']:.1f} TFLOP/s "
           f"on {sms} SMs (8 warps each)")
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "scan_ab.json")
    args = ap.parse_args()
    dev, smi = cs.phase_device()
    parent = args.parent.resolve()
    libs = load_libs(parent)
    from deeplearning4j_tpu_torch.kernels import gru_scan, lstm_scan

    use(libs["new"])
    plans = {f"gru_n{n}_h{h}": gru_scan.launch_plan(n, h, dev)
             for n, h in ((cs.GRU_BATCH, cs.GRU_HIDDEN), (8, cs.GRU_HIDDEN))}
    plans.update({f"lstm_n{n}_h{h}": lstm_scan.launch_plan(n, h, dev)
                  for n, h in ((cs.CHAR_BATCH, cs.CHAR_HIDDEN),
                               (8, cs.CHAR_HIDDEN), (8, 1024))})
    cs.log(f"[plan] new library: {plans}")
    checks = check(dev, libs, parent)
    kernels = time_kernels(dev, libs)
    kernels.update(time_lstm_kernels(dev, libs))
    ops = time_ops(dev, libs)
    lstm_ops = time_lstm_ops(dev, libs)
    steps = char_gru(dev, libs)
    lstm_steps = char_rnn(dev, libs)
    use(libs["new"])
    library = {source: read_library(source) for source in SOURCES}
    rate = mma_rate(dev)
    bad = [f"{case}.{k}" for case, row in checks.items()
           for k, r in row.items() if not r["ok"]]
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "checks_pass": not bad,
              "failed": bad, "plans": plans, "checks": checks,
              "kernels": kernels, "ops": ops, "lstm_ops": lstm_ops,
              "char_gru": steps, "char_rnn": lstm_steps,
              "library": library, "mma_sync_rate": rate}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(smi, flush=True)
    print(json.dumps({
        "checks_pass": not bad, "failed": bad,
        "speedup": {k: r["speedup"] for k, r in kernels.items()},
        "new_ms": {k: r["new_ms"] for k, r in kernels.items()},
        "mma_sync_tf32_tflops": rate["tf32_tflops"],
        "op_vs_cudnn": {
            "fwd": [ops["new_op_fwd_ms"], ops["cudnn_fwd_ms"]],
            "bwd": [ops["new_op_bwd_ms"], ops["cudnn_bwd_ms"]]},
        "lstm_op_vs_cudnn": {
            "fwd": [lstm_ops["new_op_fwd_ms"], lstm_ops["cudnn_fwd_ms"]],
            "bwd": [lstm_ops["new_op_bwd_ms"], lstm_ops["cudnn_bwd_ms"]]},
        "out": str(args.out)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
