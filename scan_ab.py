#!/usr/bin/env python3
"""Old against new recurrent-sweep kernels on one NVIDIA Hopper card.

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
   same tolerance;
2. times both sweeps at the training shape and the forward at the N=8
   serving bucket, old and new in turns (old, new, new, old): CUDA events
   over back-to-back calls, the step launches and the steps' busy time
   from the profiler, beside both bounds (``chip_smoke._gru_bound``);
3. times the port's GRU op forward and backward (the x·W product, the
   kernels, the weight-gradient products) against torch.nn.GRU (cuDNN,
   TF32 off) on the same input and weights, with each library in turns;
4. breaks down one char-GRU train step and one serving forward (bucket
   8) per library, in turns: wall time, device busy time, idle share and
   each GRU kernel's part;
5. reads the new library: ptxas's registers and spills of each step
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

import torch

import chip_smoke as cs
from flash_ab import build_parent

ROOT = Path(__file__).resolve().parent
# the recurrent sources compared; the LSTM's redesign adds "lstm_scan"
SOURCES = ("gru_scan",)
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


def _within(got, want) -> dict:
    """The largest of max |a - w| / max(1, max |w|) over the pairs, and
    whether it is within TOL_GRU."""
    frac = max(cs._frac(a, w) for a, w in zip(got, want))
    return {"max_err_frac": frac, "ok": frac <= cs.TOL_GRU}


def check(dev, libs) -> dict:
    from deeplearning4j_tpu_torch.kernels.gru_scan import (
        gru_bwd_cuda,
        gru_fwd_cuda,
        reference_gru_bwd,
        reference_gru_fwd,
    )

    rows = {}
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
        torch.cuda.synchronize()
        rows[name] = row
        cs.log(f"[check] {name}: " + ", ".join(
            f"{k} {r['max_err_frac']:.3e}{'' if r['ok'] else ' FAIL'}"
            for k, r in row.items()))
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


def read_library() -> dict:
    """ptxas's report and the SASS instruction counts of the new
    library's step kernels."""
    from deeplearning4j_tpu_torch.kernels import _build

    built = _build.build("gru_scan")
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
    libs = load_libs(args.parent.resolve())
    from deeplearning4j_tpu_torch.kernels.gru_scan import launch_plan

    use(libs["new"])
    plans = {f"n{n}_h{h}": launch_plan(n, h, dev)
             for n, h in ((cs.GRU_BATCH, cs.GRU_HIDDEN), (8, cs.GRU_HIDDEN))}
    cs.log(f"[plan] new library: {plans}")
    checks = check(dev, libs)
    kernels = time_kernels(dev, libs)
    ops = time_ops(dev, libs)
    steps = char_gru(dev, libs)
    use(libs["new"])
    library = read_library()
    rate = mma_rate(dev)
    bad = [f"{case}.{k}" for case, row in checks.items()
           for k, r in row.items() if not r["ok"]]
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "checks_pass": not bad,
              "failed": bad, "plans": plans, "checks": checks,
              "kernels": kernels, "ops": ops, "char_gru": steps,
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
        "out": str(args.out)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
