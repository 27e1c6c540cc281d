#!/usr/bin/env python3
"""Old against new flash-attention kernels on one NVIDIA Hopper card.

    python3 flash_ab.py --parent DIR [--out build/flash_ab.json]

``DIR`` holds an older checkout of this repository (for instance
``git archive <commit> | tar -x -C DIR``). Its
``deeplearning4j_tpu_torch/kernels/csrc/flash_fwd.cu`` and ``flash_bwd.cu``
are compiled beside this checkout's, with the same flags, and the port's
wrappers are pointed at one library pair or the other in turn. On the
same inputs it then

1. checks, at BERT-base's training shape (B=32, H=12, T=S=128, D=64, the
   first training batch's key lengths), at GPT-2-small's causal shapes
   (B=8, T=S=512 and B=4, T=S=1024) and at one D = 32 and one D = 128
   case: that the bf16 forward's output and LSE are bit-identical
   (``torch.equal``); that the float32 forward's output and LSE, old
   against new and each against the plain ``reference_attention_lse``,
   agree within TOL_FP32 of max(1, |reference|), entry by entry, over
   the rows that see a key, while the rows that see none give 0 and an
   LSE of at most ``chip_smoke.LSE_DEAD``; that the float32 backward
   kernels' dq, dk and dv, fed the same forward output, LSE and delta,
   are bit-identical; and that the bf16 backward kernels (fed the same)
   are within ``chip_smoke.TOL_BWD`` of max(1, |plain|) of the plain
   ``reference_attention_bwd``, new no further from it than old
   (whether they are bit-identical is reported);
2. times the bf16 and float32 forward, old and new in turns (old, new,
   new, old), at the training and the serving shape (CUDA events over
   back-to-back calls, as ``chip_smoke.py`` times kernels, and the
   profiler's device time), beside SDPA and the bound on the tensor cores
   (and, for float32, on the CUDA cores);
3. times the backward at BERT-base's training shape and GPT-2-small's
   two causal shapes in both dtypes, old and new in turns: each kernel's
   device time per launch (profiler) and the pair with its delta (CUDA
   events), beside SDPA's backward and the bounds;
4. breaks down one float32 and one mixed-precision BERT-base train step
   (``bench.py`` ``bench_bert``'s configuration) and one mixed-precision
   GPT-2-small step (``bench_gpt``'s) with each library pair, in turns:
   wall time, device time, idle share and each flash kernel's device
   time;
5. reads the new ``flash_bwd`` library: ptxas's registers, spills and
   warnings of each kernel, and its SASS (``cuobjdump``) counted by
   instruction (HGMMA, the WARPGROUP arrives and waits, barriers, local
   memory); a kernel with as many arrives as HGMMAs had its wgmmas
   serialized by ptxas, and fails the run.

"Old" is the parent's backward as its wrapper ran it: delta summed by the
torch expression (``reference_delta``) and the parent's two kernels; a
parent older than this source's ``dl4j_flash_bwd_delta`` entry has no
delta kernel.

It prints one JSON object as its last line and writes it to ``--out``.
Exit code 1 if a check of step 1 or 5 fails.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCES = ("flash_fwd", "flash_bwd")
# the float32 forward, old against new and against the plain version, as a
# fraction of max(1, |reference|) entry by entry: float32-grade
# (tests/test_torch_flash_cuda.py TOL_FP32_GRADE)
TOL_FP32 = 1e-5
# (name, B, H, T, S, D, causal, key lengths; "train": the first training
# batch's)
SAME_CASES = [
    ("bert_base_train", 32, 12, 128, 128, 64, False, "train"),
    ("gpt2_small_train", 8, 12, 512, 512, 64, True, None),
    ("gpt_causal_t1024", 4, 12, 1024, 1024, 64, True, None),
    ("d32_causal_ragged", 3, 4, 100, 130, 32, True, [130, 61, 0]),
    ("d128_padded_s300", 2, 4, 200, 300, 128, False, [300, 129]),
]
# (name, B, H, T, S, D, key lengths), timed in bf16 and float32
TIMED_CASES = [
    ("bert_base_train", 32, 12, 128, 128, 64, "train"),
    ("bert_base_serving", 8, 12, 128, 128, 64, cs.BERT_LENGTHS),
]
# (name, B, H, T, S, D, causal, key lengths), the backward timed in both
# dtypes: the training shapes of the BERT and GPT main paths, and GPT-2's
# context
BWD_TIMED_CASES = [
    ("bert_base_train", 32, 12, 128, 128, 64, False, "train"),
    ("gpt2_small_train", 8, 12, 512, 512, 64, True, None),
    ("gpt_causal_t1024", 4, 12, 1024, 1024, 64, True, None),
]


def build_parent(parent: Path, name: str) -> Path:
    """``parent``'s csrc/<name>.cu compiled with this checkout's flags."""
    from deeplearning4j_tpu_torch.kernels import _build

    src = parent / "deeplearning4j_tpu_torch" / "kernels" / "csrc" / \
        f"{name}.cu"
    out = ROOT / "build" / "flash_ab" / f"lib{name}-parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                          str(out), str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"flash_ab: nvcc failed on {src}:\n{res.stderr}")
    return out


def load_pairs(parent: Path) -> dict:
    """{"old": {source: CDLL}, "new": {source: CDLL}}, built in parallel,
    the backward entries' argtypes set."""
    from deeplearning4j_tpu_torch.kernels import _build
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        set_bwd_argtypes,
    )

    with ThreadPoolExecutor(2 * len(SOURCES)) as pool:
        new = {n: pool.submit(lambda n=n: _build.build(n).path)
               for n in SOURCES}
        old = {n: pool.submit(build_parent, parent, n) for n in SOURCES}
        pairs = {"old": {n: ctypes.CDLL(str(f.result())) for n, f in
                         old.items()},
                 "new": {n: ctypes.CDLL(str(f.result())) for n, f in
                         new.items()}}
    for pair in pairs.values():
        set_bwd_argtypes(pair["flash_bwd"])
    _build._libs.update(pairs["new"])
    return pairs


@contextlib.contextmanager
def use(pairs: dict, which: str):
    """Point the port's wrappers at one library pair. With a parent
    library that has no delta entry ("old" here), the backward sums delta
    by the torch expression, as the parent's wrapper did."""
    from deeplearning4j_tpu_torch.kernels import _build
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    pair = pairs[which]
    _build._libs.update(pair)
    try:
        if hasattr(pair["flash_bwd"], "dl4j_flash_bwd_delta"):
            yield
        else:
            with mock.patch.object(fa, "flash_bwd_delta_cuda",
                                   fa.reference_delta):
                yield
    finally:
        _build._libs.update(pairs["new"])


def _lengths(lengths, train_lengths):
    return train_lengths if lengths == "train" else lengths


def _close(a, want, live) -> dict:
    """max |a - want| / max(1, |want|) over the entries ``live`` and whether
    it is within TOL_FP32."""
    diff = (a.float() - want.float())[live].abs()
    frac = float((diff / want.float()[live].abs().clamp(min=1.0)).max())
    return {"max_err_frac": frac, "ok": frac <= TOL_FP32}


def check_same(dev, pairs, train_lengths) -> dict:
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_bwd_kernels_cuda,
        reference_attention_bwd,
        reference_attention_lse,
        reference_delta,
    )

    rows = {}
    for name, b, h, t, s, d, causal, lengths in SAME_CASES:
        lengths = _lengths(lengths, train_lengths)
        # [b, h, t]: the query rows that see a key
        sees = cs._visible_pairs(b, t, s, causal, lengths).any(-1)
        sees = sees[:, None, :].expand(b, h, t).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = cs._attention_inputs(dev, b, h, t, s, d, dtype,
                                                 lengths, seed=len(name))
            dout = torch.randn((b, h, t, d), generator=torch.Generator()
                               .manual_seed(len(name) + 1)).to(dev, dtype)
            got = {}
            for which in ("old", "new"):
                with use(pairs, which):
                    got[which] = flash_attention_cuda(q, k, v, mask,
                                                      causal=causal,
                                                      return_lse=True)
            out, lse = got["new"]  # both backwards read the same forward
            delta = reference_delta(out, dout)  # and the same delta
            grads = {which: flash_bwd_kernels_cuda(
                pairs[which]["flash_bwd"], q, k, v, mask, lse, dout, delta,
                causal=causal) for which in ("old", "new")}
            torch.cuda.synchronize()
            same = {n: torch.equal(a, c) for n, a, c in zip(
                ("dq", "dk", "dv"), grads["old"], grads["new"])}
            if dtype == torch.bfloat16:
                same.update({
                    "fwd_out": torch.equal(got["old"][0], got["new"][0]),
                    "fwd_lse": torch.equal(got["old"][1], got["new"][1])})
                # the redesigned kernels: against the plain backward, and
                # no further from it than the parent's
                bit_same = {n: same.pop(n) for n in ("dq", "dk", "dv")}
                want = reference_attention_bwd(q, k, v, mask, out, lse,
                                               dout, causal=causal)
                for n, w, a_old, a_new in zip(("dq", "dk", "dv"), want,
                                              grads["old"], grads["new"]):
                    ref = max(1.0, float(w.float().abs().max()))
                    err = {which: float((a.float() - w.float()).abs().max())
                           for which, a in (("old", a_old), ("new", a_new))}
                    same[f"{n}_within_tol"] = (
                        err["new"] <= cs.TOL_BWD[dtype] * ref)
                    same[f"{n}_no_worse_than_old"] = err["new"] <= err["old"]
                    same[f"{n}_err_old"], same[f"{n}_err_new"] = (
                        err["old"], err["new"])
                    same[f"{n}_bit_identical_info"] = bit_same[n]
            else:  # the changed kernel: float32-grade, not bit for bit
                plain = reference_attention_lse(q, k, v, causal=causal,
                                                key_mask=mask)
                live = {"out": sees[..., None].expand(b, h, t, d),
                        "lse": sees.reshape(b * h, t)}
                for i, part in enumerate(("out", "lse")):
                    close = {
                        "old_vs_new": _close(got["new"][i], got["old"][i],
                                             live[part]),
                        "old_vs_plain": _close(got["old"][i], plain[i],
                                               live[part]),
                        "new_vs_plain": _close(got["new"][i], plain[i],
                                               live[part])}
                    same.update({f"fwd_{part}_{c}": r["ok"]
                                 for c, r in close.items()})
                    same.update({f"fwd_{part}_{c}_max_err_frac":
                                 r["max_err_frac"]
                                 for c, r in close.items()})
                for which in ("old", "new"):
                    o, l_ = got[which]
                    same[f"fwd_dead_rows_{which}"] = bool(
                        (o[~live["out"]] == 0).all()
                        and (l_[~live["lse"]] <= cs.LSE_DEAD).all())
            key = f"{name}_{str(dtype)[6:]}"
            rows[key] = same
            cs.log(f"[same] {key}: {same}")
    return rows


def time_forward(dev, pairs, train_lengths) -> dict:
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda,
    )

    rows = {}
    for name, b, h, t, s, d, lengths in TIMED_CASES:
        lengths = _lengths(lengths, train_lengths)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = cs._attention_inputs(dev, b, h, t, s, d, dtype,
                                                 lengths, seed=len(name))
            kernel = lambda: flash_attention_cuda(q, k, v, mask)  # noqa
            ms = {"old": [], "new": []}
            device_ms = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                with use(pairs, which):
                    ms[which].append(cs._time_ms(kernel))
                    device_ms[which].append(cs._device_ms(kernel))
            bool_mask = (mask > 0)[:, None, None, :]
            sdpa_ms = cs._time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bool_mask))
            bound_ms, bound_by, _, _, cores_ms = cs._bound(
                b, h, t, s, d, dtype, False, lengths)
            row = {"shape": [b, h, t, s, d], "old_ms": min(ms["old"]),
                   "new_ms": min(ms["new"]), "runs_ms": ms,
                   "old_device_ms": min(device_ms["old"]),
                   "new_device_ms": min(device_ms["new"]),
                   "device_runs_ms": device_ms, "sdpa_ms": sdpa_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_cuda_cores_ms": cores_ms}
            row["speedup"] = row["old_ms"] / row["new_ms"]
            key = f"{name}_{str(dtype)[6:]}"
            rows[key] = row
            cores = ("" if cores_ms is None
                     else f"; {cores_ms:.4f} ms on the CUDA cores")
            cs.log(f"[time] {key}: old {row['old_ms']:.4f} ms, new "
                   f"{row['new_ms']:.4f} ms ({row['speedup']:.2f}x; device "
                   f"{row['old_device_ms']:.4f} -> {row['new_device_ms']:.4f}"
                   f"), sdpa {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms "
                   f"({bound_by}, tensor cores{cores}); runs {ms}")
    return rows


def time_backward(dev, pairs, train_lengths) -> dict:
    """The backward at BWD_TIMED_CASES in both dtypes, timed by
    ``chip_smoke._time_bwd`` with each library pair in turns (old, new,
    new, old): each kernel's device time per launch (profiler), the pair
    with its delta (the parent's torch expression, or the delta kernel),
    the plain backward and SDPA's backward (CUDA events), and the
    bounds."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda,
    )

    rows = {}
    for name, b, h, t, s, d, causal, lengths in BWD_TIMED_CASES:
        lengths = _lengths(lengths, train_lengths)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = cs._attention_inputs(dev, b, h, t, s, d, dtype,
                                                 lengths, seed=len(name))
            dout = torch.randn((b, h, t, d), generator=torch.Generator()
                               .manual_seed(len(name) + 1)).to(dev, dtype)
            out, lse = flash_attention_cuda(q, k, v, mask, causal=causal,
                                            return_lse=True)
            runs = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                with use(pairs, which):
                    runs[which].append(cs._time_bwd(
                        q, k, v, mask, out, lse, dout, lengths, causal))
            row = {"shape": [b, h, t, s, d], "causal": causal, "runs": runs,
                   "sdpa_ms": min(r["library_ms"] for rs in runs.values()
                                  for r in rs)}
            row.update({k: x for k, x in runs["new"][0].items()
                        if "bound" in k})
            for key in ("pair_ms", "delta_ms", "flash_bwd_dkv_ms",
                        "flash_bwd_dq_ms"):
                for which in ("old", "new"):
                    row[f"{which}_{key}"] = min(r[key] for r in runs[which])
                row[f"speedup_{key}"] = row[f"old_{key}"] / row[f"new_{key}"]
            row["new_flash_bwd_delta_ms"] = min(
                r["flash_bwd_delta_ms"] for r in runs["new"])
            row["new_kernels_ms"] = (row["new_flash_bwd_dkv_ms"]
                                     + row["new_flash_bwd_dq_ms"])
            row["new_pair_vs_sdpa"] = row["new_pair_ms"] / row["sdpa_ms"]
            key = f"{name}_{str(dtype)[6:]}"
            rows[key] = row
            cs.log(f"[bwd] {key}: dkv {row['old_flash_bwd_dkv_ms']:.4f} -> "
                   f"{row['new_flash_bwd_dkv_ms']:.4f} ms "
                   f"({row['speedup_flash_bwd_dkv_ms']:.2f}x), dq "
                   f"{row['old_flash_bwd_dq_ms']:.4f} -> "
                   f"{row['new_flash_bwd_dq_ms']:.4f} ms "
                   f"({row['speedup_flash_bwd_dq_ms']:.2f}x), delta "
                   f"{row['old_delta_ms']:.4f} -> {row['new_delta_ms']:.4f}"
                   f" ms (kernel {row['new_flash_bwd_delta_ms']:.4f}, bound "
                   f"{row['flash_bwd_delta_bound_ms']:.4f}); pair with "
                   f"delta {row['old_pair_ms']:.4f} -> "
                   f"{row['new_pair_ms']:.4f} ms "
                   f"({row['speedup_pair_ms']:.2f}x); sdpa backward "
                   f"{row['sdpa_ms']:.4f} ms (new / sdpa "
                   f"{row['new_pair_vs_sdpa']:.3f}); bounds dkv "
                   f"{row['flash_bwd_dkv_bound_ms']:.4f} dq "
                   f"{row['flash_bwd_dq_bound_ms']:.4f} ms")
    return rows


def train_step(dev, pairs, model_name, batch, mixed_precision) -> dict:
    """One train step of BERT-base or GPT-2-small (``bench.py``'s
    configurations), float32 or mixed precision, with each library pair,
    in turns (old, new, new, old)."""
    from deeplearning4j_tpu_torch.models.bert import bert_base
    from deeplearning4j_tpu_torch.models.gpt import gpt2_small
    from deeplearning4j_tpu_torch.nn import config as nnconfig
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    gpt = model_name == "gpt2_small"
    net = nnconfig.NeuralNetConfiguration(
        seed=cs.SEED, updater=Adam(1e-4), mixed_precision=mixed_precision,
        rng_impl="rbg" if gpt else None)
    model = (gpt2_small(device=dev, max_position=cs.GPT_T, net=net) if gpt
             else bert_base(device=dev, net=net))
    trainer = Trainer(model)
    ts = trainer.init_state()
    on_dev = batch_to_device(batch, dev)
    runs = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        with use(pairs, which):
            bd = cs._step_breakdown(trainer, ts, on_dev, cs.FLASH_KERNELS)
        runs[which].append(bd)
        flash = ", ".join(
            f"{kn} {r['ms']:.4f} ms ({r['share_of_device']:.4f})"
            for kn, r in bd["kernels"].items())
        cs.log(f"[step] {model_name} "
               f"{'mixed' if mixed_precision else 'float32'} "
               f"{which}: wall {bd['wall_ms']:.2f} ms, device "
               f"{bd['device_ms']:.3f} ms, idle "
               f"{bd['device_idle_share']:.3f}, {flash}")
    del model, trainer, ts
    torch.cuda.empty_cache()
    return runs


def read_library(source="flash_bwd") -> dict:
    """ptxas's report and the SASS instruction counts of the new
    library's kernels of ``source``."""
    from deeplearning4j_tpu_torch.kernels import _build

    built = _build.build(source)
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln
             or "C75" in ln or "serializ" in ln]
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(built.path)],
                         capture_output=True, text=True)
    counts, kernel = {}, None
    for line in res.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            kernel = head.group(1)
            counts[kernel] = collections.Counter()
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z0-9_.]+)", line)
        if kernel and op:
            name = op.group(1)
            counts[kernel][name if name.startswith("WARPGROUP")
                           else name.split(".")[0]] += 1
    sass = {k: {"instructions": sum(c.values()), "HGMMA": c["HGMMA"],
                "warpgroup": {o: n for o, n in c.items()
                              if o.startswith("WARPGROUP")},
                "BAR": c["BAR"], "LDL": c["LDL"], "STL": c["STL"],
                "top": dict(c.most_common(8))}
            for k, c in counts.items()}
    for line in ptxas:
        cs.log(f"[ptxas] {line}")
    for k, r in sass.items():
        cs.log(f"[sass] {k[:100]}: {r}")
    if res.returncode != 0:
        cs.log(f"[sass] cuobjdump failed: {res.stderr.strip()[:300]}")
    return {"ptxas": ptxas, "sass": sass}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "flash_ab.json")
    args = ap.parse_args()
    dev, smi = cs.phase_device()
    pairs = load_pairs(args.parent.resolve())
    library = read_library()
    batches = cs._train_batches()
    train_lengths = [int(n) for n in
                     batches[0]["features"]["mask"].sum(axis=1)]
    same = check_same(dev, pairs, train_lengths)
    timed = time_forward(dev, pairs, train_lengths)
    bwd = time_backward(dev, pairs, train_lengths)
    gpt_batch = cs._gpt_batches(50257)[0]
    steps = {
        "float32_step": train_step(dev, pairs, "bert_base", batches[0],
                                   False),
        "mixed_precision_step": train_step(dev, pairs, "bert_base",
                                           batches[0], True),
        "gpt_mixed_precision_step": train_step(dev, pairs, "gpt2_small",
                                               gpt_batch, True)}
    bad = [f"{case}.{k}" for case, row in same.items()
           for k, ok in row.items() if ok is False
           and not k.endswith("_info")]
    # ptxas serializes a kernel's wgmmas when it cannot follow their
    # pipeline: then every HGMMA has its own arrive
    bad += [f"sass.{k[:80]}.serialized" for k, r in library["sass"].items()
            if r["HGMMA"] and r["warpgroup"].get("WARPGROUP.ARRIVE", 0)
            >= r["HGMMA"]]
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "checks_pass": not bad,
              "failed": bad, "same": same, "forward": timed,
              "backward": bwd, **steps, "library": library}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(smi, flush=True)
    print(json.dumps({
        "checks_pass": not bad, "failed": bad,
        "speedup_forward": {k: r["speedup"] for k, r in timed.items()},
        "backward": {k: {
            **{f"speedup_{kn}": r[f"speedup_{kn}_ms"] for kn in (
                "flash_bwd_dkv", "flash_bwd_dq", "delta", "pair")},
            "old_pair_ms": r["old_pair_ms"], "new_pair_ms": r["new_pair_ms"],
            "sdpa_ms": r["sdpa_ms"],
            "new_delta_kernel_ms": r["new_flash_bwd_delta_ms"],
            "delta_bound_ms": r["flash_bwd_delta_bound_ms"]}
            for k, r in bwd.items()},
        "out": str(args.out)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
