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
   first training batch's key lengths) and at one D = 32 and one D = 128
   case: that the bf16 forward's output and LSE and the backward's dq, dk
   and dv in both dtypes, fed the same forward output and LSE, are
   bit-identical (``torch.equal``); and that the float32 forward's output
   and LSE, old against new and each against the plain
   ``reference_attention_lse``, agree within TOL_FP32 of max(1,
   |reference|), entry by entry, over the rows that see a key, while the
   rows that see none give 0 and an LSE of at most ``chip_smoke.LSE_DEAD``;
2. times the bf16 and float32 forward, old and new in turns (old, new,
   new, old), at the training and the serving shape (CUDA events over
   back-to-back calls, as ``chip_smoke.py`` times kernels, and the
   profiler's device time), beside SDPA and the bound on the tensor cores
   (and, for float32, on the CUDA cores);
3. times the backward at the training shape in both dtypes, old and new
   in turns: each kernel's device time per launch (profiler) and the
   wrapper's pair with its delta reduction (CUDA events), beside SDPA's
   backward and the bounds;
4. breaks down one float32 and one mixed-precision BERT-base train step
   (``bench.py`` ``bench_bert``'s configuration) with each library pair,
   in turns: wall time, device time, idle share and each flash kernel's
   device time.

It prints one JSON object as its last line and writes it to ``--out``.
Exit code 1 if a check of step 1 fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
    ("d32_causal_ragged", 3, 4, 100, 130, 32, True, [130, 61, 0]),
    ("d128_padded_s300", 2, 4, 200, 300, 128, False, [300, 129]),
]
# (name, B, H, T, S, D, key lengths), timed in bf16 and float32
TIMED_CASES = [
    ("bert_base_train", 32, 12, 128, 128, 64, "train"),
    ("bert_base_serving", 8, 12, 128, 128, 64, cs.BERT_LENGTHS),
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


def use(pair: dict) -> None:
    """Point the port's wrappers at one library pair (the wrappers set
    each library's argtypes on its first call)."""
    from deeplearning4j_tpu_torch.kernels import _build

    _build._libs.update(pair)


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
        flash_attention_bwd_cuda,
        flash_attention_cuda,
        reference_attention_lse,
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
                use(pairs[which])
                got[which] = flash_attention_cuda(q, k, v, mask,
                                                  causal=causal,
                                                  return_lse=True)
            out, lse = got["new"]  # both backwards read the same forward
            grads = {}
            for which in ("old", "new"):
                use(pairs[which])
                grads[which] = flash_attention_bwd_cuda(
                    q, k, v, mask, out, lse, dout, causal=causal)
            torch.cuda.synchronize()
            same = {n: torch.equal(a, c) for n, a, c in zip(
                ("dq", "dk", "dv"), grads["old"], grads["new"])}
            if dtype == torch.bfloat16:
                same.update({
                    "fwd_out": torch.equal(got["old"][0], got["new"][0]),
                    "fwd_lse": torch.equal(got["old"][1], got["new"][1])})
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
                use(pairs[which])
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
    """The backward at the training shape in both dtypes, timed by
    ``chip_smoke._time_bwd`` with each library pair in turns (old, new,
    new, old): each kernel's device time per launch (profiler), the
    wrapper's pair with its delta reduction, the plain backward and
    SDPA's backward (CUDA events), and the bounds."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda,
    )

    name, b, h, t, s, d, lengths = TIMED_CASES[0]
    lengths = _lengths(lengths, train_lengths)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, mask = cs._attention_inputs(dev, b, h, t, s, d, dtype,
                                             lengths, seed=len(name))
        dout = torch.randn((b, h, t, d), generator=torch.Generator()
                           .manual_seed(len(name) + 1)).to(dev, dtype)
        use(pairs["new"])
        out, lse = flash_attention_cuda(q, k, v, mask, return_lse=True)
        runs = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            use(pairs[which])
            runs[which].append(cs._time_bwd(q, k, v, mask, out, lse, dout,
                                            lengths))
        row = {"shape": [b, h, t, s, d], "runs": runs,
               "sdpa_ms": min(r["library_ms"] for rs in runs.values()
                              for r in rs)}
        row.update({k: x for k, x in runs["new"][0].items() if "bound" in k})
        for key in ("pair_ms", "flash_bwd_dkv_ms", "flash_bwd_dq_ms"):
            for which in ("old", "new"):
                row[f"{which}_{key}"] = min(r[key] for r in runs[which])
            row[f"speedup_{key}"] = row[f"old_{key}"] / row[f"new_{key}"]
        row["new_kernels_ms"] = (row["new_flash_bwd_dkv_ms"]
                                 + row["new_flash_bwd_dq_ms"])
        key = f"{name}_{str(dtype)[6:]}"
        rows[key] = row
        cs.log(f"[bwd] {key}: dkv {row['old_flash_bwd_dkv_ms']:.4f} -> "
               f"{row['new_flash_bwd_dkv_ms']:.4f} ms "
               f"({row['speedup_flash_bwd_dkv_ms']:.2f}x), dq "
               f"{row['old_flash_bwd_dq_ms']:.4f} -> "
               f"{row['new_flash_bwd_dq_ms']:.4f} ms "
               f"({row['speedup_flash_bwd_dq_ms']:.2f}x); both kernels "
               f"{row['new_kernels_ms']:.4f} ms; pair with delta "
               f"{row['old_pair_ms']:.4f} -> {row['new_pair_ms']:.4f} ms; "
               f"sdpa backward {row['sdpa_ms']:.4f} ms; bounds dkv "
               f"{row['flash_bwd_dkv_bound_ms']:.4f} dq "
               f"{row['flash_bwd_dq_bound_ms']:.4f} ms")
    return rows


def train_step(dev, pairs, batch, mixed_precision) -> dict:
    """One BERT-base train step, float32 or mixed precision, with each
    library pair, in turns (old, new, new, old)."""
    from deeplearning4j_tpu_torch.models.bert import bert_base
    from deeplearning4j_tpu_torch.nn import config as nnconfig
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    model = bert_base(device=dev, net=nnconfig.NeuralNetConfiguration(
        seed=cs.SEED, updater=Adam(1e-4), mixed_precision=mixed_precision))
    trainer = Trainer(model)
    ts = trainer.init_state()
    on_dev = batch_to_device(batch, dev)
    runs = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        use(pairs[which])
        bd = cs._step_breakdown(trainer, ts, on_dev, (
            "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
        runs[which].append(bd)
        flash = ", ".join(
            f"{kn} {r['ms']:.4f} ms ({r['share_of_device']:.4f})"
            for kn, r in bd["kernels"].items())
        cs.log(f"[step] {'mixed' if mixed_precision else 'float32'} "
               f"{which}: wall {bd['wall_ms']:.2f} ms, device "
               f"{bd['device_ms']:.3f} ms, idle "
               f"{bd['device_idle_share']:.3f}, {flash}")
    del model, trainer, ts
    torch.cuda.empty_cache()
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "flash_ab.json")
    args = ap.parse_args()
    dev, smi = cs.phase_device()
    pairs = load_pairs(args.parent.resolve())
    batches = cs._train_batches()
    train_lengths = [int(n) for n in
                     batches[0]["features"]["mask"].sum(axis=1)]
    same = check_same(dev, pairs, train_lengths)
    timed = time_forward(dev, pairs, train_lengths)
    bwd = time_backward(dev, pairs, train_lengths)
    steps = {"float32_step": train_step(dev, pairs, batches[0], False),
             "mixed_precision_step": train_step(dev, pairs, batches[0],
                                                True)}
    use(pairs["new"])
    bad = [f"{case}.{k}" for case, row in same.items()
           for k, ok in row.items() if ok is False]
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "checks_pass": not bad,
              "failed": bad, "same": same, "forward": timed,
              "backward": bwd, **steps}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(smi, flush=True)
    print(json.dumps({
        "checks_pass": not bad, "failed": bad,
        "speedup_forward": {k: r["speedup"] for k, r in timed.items()},
        "speedup_backward": {k: {kn: r[f"speedup_{kn}_ms"] for kn in (
            "flash_bwd_dkv", "flash_bwd_dq", "pair")}
            for k, r in bwd.items()},
        "out": str(args.out)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
