#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py      # needs one H100/H200 and the CUDA toolkit

Phases, each of which fails the run (non-zero exit) rather than being
caught:

1. device — CUDA present, compute capability 9.0; prints the card's name
   and power limit as nvidia-smi gives them. TF32 is switched off for
   matmuls and cuDNN, so float32 bounds below are float32 bounds.
2. build — compiles every kernel source of the port from the checkout
   (one nvcc per source, all started together; sm_90a) and prints the
   build seconds and ptxas' report.
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the main paths give it (and at the other head sizes, masks
   and dtypes the kernel takes), with the tolerance stated per dtype; then
   the kernel, the plain version and one PyTorch library call timed,
   beside the least time the card could take (``bound_ms``). The forward
   at the serving shape, the two backward kernels at the training shape.
4. slice — BERT-base at full width (12 layers, width 768, 12 heads, vocab
   30522), weights drawn from a seed on the card, served by the port's
   ModelServer → ModelRegistry → ParallelInference (batched, max batch 8)
   to concurrent ServingClient requests; every response is held against
   the same model run with plain attention on the card, and the flash
   launch count must be 12 per dispatched batch.
5. train — BERT-base at full width and depth trained by the port's
   Trainer.fit (Adam 1e-4, dropout 0.1, batches of 32 x 128 from
   make_mlm_batch, BERT phase-1 pretraining shapes): the loss and every
   gradient through the kernels against the plain path; 30 steps of fit
   with 12 launches per step of each flash kernel and a falling loss; a
   checkpoint restored bit-equal with the same next-step loss; three
   mixed-precision (bf16) steps; step time, throughput, peak memory, the
   device's idle share and each flash kernel's share of a step.

It prints the kernels line ({"kernels": [...]}), the serving line, the
training line, the nvidia-smi line and, last, {"ok": true, "device":
{...}}. It imports nothing of JAX nor of the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet; dense): float32 on the CUDA
# cores, bf16 on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_PER_S = 3.35e12

# kernel vs plain version, max |difference| over rows that see a key:
# float32 — both sides float32; the kernel sums scores and outputs blockwise
#   in another order (and uses exp2): a few ulp of O(1) values.
# bfloat16 — the plain version rounds the scores and the probabilities to
#   bf16 before its second matmul, the kernel keeps them in float32; both
#   round the output to bf16 (eps 2^-8): a few bf16 ulp of O(1) values.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# backward kernels vs the plain backward, max |difference| over dq, dk, dv
# as a fraction of max(1, max |plain|): both compute in float32 from the
# same inputs and LSE; float32 differs by the order of the sums, bfloat16
# also by the final rounding of each gradient to bf16 (eps 2^-8).
TOL_BWD = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# served BERT-base vs the same model with plain attention, float32: 12
# layers pass the kernel's ~1e-6 differences on through LayerNorms.
TOL_PROBS = 1e-4
TOL_HIDDEN = 5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


# -- 1. device ----------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; it runs on an "
                         "NVIDIA Hopper card")
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.runtime import device as rdev

    dev = rdev.require_hopper(rdev.default_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = rdev.describe(dev)
    smi = info["nvidia_smi"]
    if not smi:
        raise SystemExit("chip_smoke: nvidia-smi does not list the card")
    log(f"[device] {info['name']} | nvidia-smi: {smi} | capability "
        f"{info['capability']} | cards {info['count']} | torch "
        f"{info['torch']} cuda {info['cuda']} | tf32 off")
    return dev, smi


# -- 2. build -----------------------------------------------------------------

KERNEL_SOURCES = ("flash_fwd", "flash_bwd")


def phase_build():
    from deeplearning4j_tpu_torch.kernels import _build

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = dict(zip(KERNEL_SOURCES,
                         pool.map(_build.build, KERNEL_SOURCES)))
    log(f"[build] {len(built)} sources in {time.monotonic() - t0:.2f} s")
    for name, b in built.items():
        log(f"[build] {name}: {b.seconds:.2f} s nvcc -> "
            f"{b.path.relative_to(ROOT)}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")


# -- 3. kernels ---------------------------------------------------------------

def _attention_inputs(dev, b, h, t, s, d, dtype, lengths, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, d), generator=g).to(dev, dtype)
               for n in (t, s, s))
    mask = None
    if lengths is not None:
        mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None])
        mask = mask.to(dev, torch.float32)
    return q, k, v, mask


def _visible(b, t, s, causal, lengths):
    """What this run's masks leave visible, per head: query-key pairs,
    query rows that see at least one key, and keys that some row sees."""
    qi = torch.arange(t)[:, None]
    kj = torch.arange(s)[None, :]
    vis = (qi + (s - t) >= kj) if causal else torch.ones(t, s,
                                                         dtype=torch.bool)
    n = torch.full((b,), s) if lengths is None else torch.tensor(lengths)
    vis = vis[None] & (kj[None] < n[:, None, None])  # [b, t, s]
    return (int(vis.sum()), int(vis.any(-1).sum()), int(vis.any(-2).sum()))


def _bound(b, h, t, s, d, dtype, causal, lengths):
    """Least time for this run's work, operations and bytes counted on one
    rule: only what the masks leave visible. Operations: 4·D per visible
    query-key pair. Bytes: O in full, Q of the rows that see a key, K and
    V of the keys some row sees, and the float32 mask."""
    es = torch.finfo(dtype).bits // 8
    pairs, rows, keys = _visible(b, t, s, causal, lengths)
    ops = 4.0 * d * h * pairs
    nbytes = es * h * d * (b * t + rows + 2 * keys) + (
        4 * b * s if lengths is not None else 0)
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def _time_ms(fn, iters=200, warmup=20) -> float:
    """Device time per call of ``fn``, from CUDA events around ``iters``
    back-to-back calls. The card first spins for about 0.1 s
    (``torch.cuda._sleep``) while the host queues every call behind it,
    so the events time the card running the calls, not the host's
    Python launching them. Inputs stay in the 50 MB L2 between calls, as
    q/k/v do in the model, where the projections have just written them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us_by_kernel(fn, iters=50) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, in µs,
    from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)
            out[e.key] = out.get(e.key, 0.0) + us / iters
    return out


def _device_ms(fn) -> float:
    """Device time per call: the sum of its CUDA kernels' time."""
    return sum(_device_us_by_kernel(fn).values()) / 1e3


# (name, B, H, T, S, D, dtype, causal, key lengths per batch row, timed)
BERT_LENGTHS = [128, 97, 64, 33, 128, 5, 77, 0]  # one all-zero-mask row
KERNEL_CASES = [
    ("bert_base_serving_fp32", 8, 12, 128, 128, 64, torch.float32, False,
     BERT_LENGTHS, True),
    ("bert_base_serving_bf16", 8, 12, 128, 128, 64, torch.bfloat16, False,
     BERT_LENGTHS, True),
    ("causal_t64_s128_fp32", 2, 12, 64, 128, 64, torch.float32, True,
     None, False),
    ("causal_t64_s128_bf16", 2, 12, 64, 128, 64, torch.bfloat16, True,
     None, False),
    ("d32_causal_ragged_fp32", 3, 4, 100, 100, 32, torch.float32, True,
     [100, 61, 0], False),
    ("d128_padded_ragged_fp32", 2, 4, 200, 300, 128, torch.float32, False,
     [300, 129], False),
    ("d128_causal_bf16", 2, 4, 160, 160, 128, torch.bfloat16, True,
     [160, 90], False),
]


def phase_kernels(dev):
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda,
        reference_attention,
    )

    results = {}
    for (name, b, h, t, s, d, dtype, causal, lengths,
         timed) in KERNEL_CASES:
        q, k, v, mask = _attention_inputs(dev, b, h, t, s, d, dtype, lengths,
                                          seed=len(name))
        got, lse = flash_attention_cuda(q, k, v, mask, causal=causal,
                                        return_lse=True)
        want = reference_attention(q, k, v, causal=causal, key_mask=mask)
        torch.cuda.synchronize()
        live = (torch.ones(b, dtype=torch.bool) if lengths is None
                else torch.tensor(lengths) > 0).to(dev)
        err = float((got.float() - want.float())[live].abs().max())
        finite = bool(torch.isfinite(got).all())
        dead_zero = bool((got[~live] == 0).all())
        lse_ok = bool(torch.isfinite(lse).all())
        ok = err <= TOL[dtype] and finite and dead_zero and lse_ok
        log(f"[kernels] {name}: max_abs_err {err:.3e} (tol {TOL[dtype]:.0e})"
            f" finite={finite} zero_on_masked_rows={dead_zero} "
            f"lse_finite={lse_ok} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: kernel case {name} failed")
        if not timed:
            continue
        bool_mask = (mask > 0)[:, None, None, :]
        kernel = lambda: flash_attention_cuda(q, k, v, mask)  # noqa: E731
        plain = lambda: reference_attention(q, k, v, key_mask=mask)  # noqa
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=bool_mask)
        bound_ms, bound_by, ops, nbytes = _bound(b, h, t, s, d, dtype,
                                                 causal, lengths)
        row = {"shape": [b, h, t, s, d], "dtype": str(dtype)[6:],
               "max_abs_err": err, "bound_ms": bound_ms,
               "bound_by": bound_by, "ops": ops, "bytes": nbytes}
        # one call each in turn, twice (kernel, plain, library, library,
        # plain, kernel): the spread between the two shows the noise
        ms = {"kernel": [], "plain": [], "library": []}
        for which in ("kernel", "plain", "library", "library", "plain",
                      "kernel"):
            fn = {"kernel": kernel, "plain": plain, "library": library}[which]
            ms[which].append(_time_ms(fn))
        row.update({f"{w}_ms": min(v) for w, v in ms.items()})
        row.update({f"{w}_ms_runs": v for w, v in ms.items()})
        row["kernel_device_ms"] = _device_ms(kernel)
        row["plain_device_ms"] = _device_ms(plain)
        row["library_device_ms"] = _device_ms(library)
        log(f"[kernels] {name}: kernel {row['kernel_ms']:.4f} ms "
            f"(device {row['kernel_device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        results[name] = row
    return results


def _bound_bwd(kernel, b, h, t, s, d, dtype, causal, lengths):
    """Least time for one backward kernel's work, on the forward's rule:
    only what the masks leave visible. Operations per visible query-key
    pair: 8·D for flash_bwd_dkv (scores, dP, dV and dK products), 6·D for
    flash_bwd_dq (scores, dP, dQ). Bytes: Q and dO of the rows that see a
    key, K and V of the keys some row sees, the float32 LSE and delta of
    those rows and the mask; the outputs written in full (dK and dV, or
    dQ)."""
    es = torch.finfo(dtype).bits // 8
    pairs, rows, keys = _visible(b, t, s, causal, lengths)
    ops = (8.0 if kernel == "flash_bwd_dkv" else 6.0) * d * h * pairs
    outputs = 2 * b * s if kernel == "flash_bwd_dkv" else b * t
    nbytes = (es * h * d * (2 * rows + 2 * keys + outputs) + 8 * h * rows
              + (4 * b * s if lengths is not None else 0))
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


# (name, B, H, T, S, D, dtype, causal, key lengths per batch row, timed);
# the training shape's lengths are those of the first training batch
BWD_CASES = [
    ("bert_base_train_fp32", 32, 12, 128, 128, 64, torch.float32, False,
     "train", True),
    ("bert_base_train_bf16", 32, 12, 128, 128, 64, torch.bfloat16, False,
     "train", True),
    ("causal_t64_s128_fp32", 2, 12, 64, 128, 64, torch.float32, True,
     None, False),
    ("causal_t64_s128_bf16", 2, 12, 64, 128, 64, torch.bfloat16, True,
     None, False),
    ("d32_causal_ragged_fp32", 3, 4, 100, 100, 32, torch.float32, True,
     [100, 61, 0], False),
    ("d32_padded_bf16", 3, 4, 96, 96, 32, torch.bfloat16, False,
     [96, 40, 0], False),
    ("d128_padded_ragged_fp32", 2, 4, 200, 300, 128, torch.float32, False,
     [300, 129], False),
    ("d128_causal_bf16", 2, 4, 160, 160, 128, torch.bfloat16, True,
     [160, 90], False),
]


def phase_kernels_bwd(dev, train_lengths):
    """Both backward kernels against ``reference_attention_bwd`` on the
    same inputs, forward output and LSE; then timed at the training shape
    beside SDPA's backward."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda,
        flash_attention_cuda,
        reference_attention_bwd,
    )

    results = {}
    for (name, b, h, t, s, d, dtype, causal, lengths,
         timed) in BWD_CASES:
        if lengths == "train":
            lengths = train_lengths
        q, k, v, mask = _attention_inputs(dev, b, h, t, s, d, dtype, lengths,
                                          seed=len(name))
        dout = torch.randn((b, h, t, d), generator=torch.Generator()
                           .manual_seed(len(name) + 1)).to(dev, dtype)
        out, lse = flash_attention_cuda(q, k, v, mask, causal=causal,
                                        return_lse=True)
        got = flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout,
                                       causal=causal)
        want = reference_attention_bwd(q, k, v, mask, out, lse, dout,
                                       causal=causal)
        torch.cuda.synchronize()
        errs = {}
        ok = True
        for which, a, w in zip(("dq", "dk", "dv"), got, want):
            err = float((a.float() - w.float()).abs().max())
            ref = max(1.0, float(w.float().abs().max()))
            errs[which] = err
            ok &= err <= TOL_BWD[dtype] * ref and bool(torch.isfinite(a).all())
        dead = (torch.tensor(lengths) == 0 if lengths is not None
                else torch.zeros(b, dtype=torch.bool)).to(dev)
        dead_zero = all(bool((a[dead] == 0).all()) for a in got)
        ok &= dead_zero
        log(f"[kernels] bwd {name}: max_abs_err dq {errs['dq']:.3e} dk "
            f"{errs['dk']:.3e} dv {errs['dv']:.3e} (tol "
            f"{TOL_BWD[dtype]:.0e} x max(1, |plain|)) zero_on_masked_rows="
            f"{dead_zero} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: backward kernel case {name} "
                             "failed")
        row = {"shape": [b, h, t, s, d], "dtype": str(dtype)[6:],
               "max_abs_err": errs}
        if timed:
            row.update(_time_bwd(q, k, v, mask, out, lse, dout, lengths))
            log(f"[kernels] bwd {name}: dkv {row['flash_bwd_dkv_ms']:.4f} ms "
                f"(bound {row['flash_bwd_dkv_bound_ms']:.4f}, "
                f"{row['flash_bwd_dkv_bound_by']}), dq "
                f"{row['flash_bwd_dq_ms']:.4f} ms (bound "
                f"{row['flash_bwd_dq_bound_ms']:.4f}, "
                f"{row['flash_bwd_dq_bound_by']}); pair with delta "
                f"{row['pair_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"sdpa backward {row['library_ms']:.4f} ms")
        results[name] = row
    return results


def _time_bwd(q, k, v, mask, out, lse, dout, lengths):
    """Times at one shape: each backward kernel's device time per launch
    (profiler), the wrapper's pair of launches with its delta reduction,
    the plain backward and SDPA's backward (CUDA events)."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda,
        reference_attention_bwd,
    )

    b, h, t, d = q.shape
    s = k.shape[2]
    pair = lambda: flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, mask, out, lse, dout)
    plain = lambda: reference_attention_bwd(  # noqa: E731
        q, k, v, mask, out, lse, dout)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(
        *leaves, attn_mask=(mask > 0)[:, None, None, :])
    library = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, leaves, dout, retain_graph=True)
    ms = {"pair": [], "plain": [], "library": []}
    for which in ("pair", "plain", "library", "library", "plain", "pair"):
        fn = {"pair": pair, "plain": plain, "library": library}[which]
        ms[which].append(_time_ms(fn, iters=50, warmup=5))
    row = {f"{w}_ms": min(v) for w, v in ms.items()}
    row.update({f"{w}_ms_runs": v for w, v in ms.items()})
    by_kernel = _device_us_by_kernel(pair, iters=20)
    row["pair_device_us_by_kernel"] = {k[:60]: us
                                       for k, us in by_kernel.items()}
    for kernel in ("flash_bwd_dkv", "flash_bwd_dq"):
        row[f"{kernel}_ms"] = sum(us for name, us in by_kernel.items()
                                  if f"{kernel}_kernel" in name) / 1e3
        bound_ms, bound_by, ops, nbytes = _bound_bwd(
            kernel, b, h, t, s, d, q.dtype, False, lengths)
        row.update({f"{kernel}_bound_ms": bound_ms,
                    f"{kernel}_bound_by": bound_by,
                    f"{kernel}_ops": ops, f"{kernel}_bytes": nbytes})
    return row


# -- 4. slice: BERT-base behind the port's ModelServer ------------------------

# Closed loop: CLIENT_THREADS clients, each sending its next request when
# the last one returns. 1000 requests leave 10 samples beyond the p99.
N_REQUESTS = 1000
CLIENT_THREADS = 8
T = 128


def _nsp_softmax(model, x):
    return torch.softmax(model.nsp_logits(model(x)), dim=-1)


def _request(i, vocab):
    r = np.random.default_rng(1000 + i)
    rows = 1 + i % 4
    lengths = r.integers(8, T + 1, rows)
    return {
        "token_ids": r.integers(0, vocab, (rows, T)).astype(np.int32),
        "segment_ids": (np.arange(T)[None, :] >= lengths[:, None] // 2
                        ).astype(np.int32),
        "mask": (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32),
    }


def _on(dev, feats):
    return {k: torch.from_numpy(v).to(dev) for k, v in feats.items()}


def phase_slice(dev, smi):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reference_attention,
    )
    from deeplearning4j_tpu_torch.models.bert import BertConfig, bert_base
    from deeplearning4j_tpu_torch.nn import config as nnconfig
    from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry,
        ModelServer,
        ServingClient,
        spec,
    )
    from deeplearning4j_tpu_torch.train.updaters import Adam

    t0 = time.monotonic()
    model = bert_base(device=dev, net=nnconfig.NeuralNetConfiguration(
        seed=SEED, updater=Adam(1e-4)))
    cfg: BertConfig = model.config
    log(f"[slice] bert_base: {model.num_params():,} parameters on {dev}, "
        f"seed {SEED}, built in {time.monotonic() - t0:.1f} s")

    reg = ModelRegistry()
    entry = reg.register(
        "bert_base", _nsp_softmax, model,
        input_spec={"token_ids": spec((T,), np.int32, high=cfg.vocab_size),
                    "segment_ids": spec((T,), np.int32, high=cfg.type_vocab),
                    "mask": spec((T,), np.float32)},
        mode="batched", max_batch_size=8)
    server = ModelServer(reg, port=0)
    t0 = time.monotonic()
    server.start(warm=True)
    client = ServingClient(server.url, timeout=120)
    if not client.ready()["ready"]:
        raise SystemExit("chip_smoke: /readyz not ready after warm start")
    log(f"[slice] server warm and ready in {time.monotonic() - t0:.2f} s "
        f"(buckets {sorted(entry.batch_stats().items())})")

    requests = [_request(i, cfg.vocab_size) for i in range(N_REQUESTS)]
    latencies = [0.0] * N_REQUESTS

    def call(i):
        t_start = time.monotonic()
        resp = client.predict("bert_base", requests[i])
        latencies[i] = time.monotonic() - t_start
        return resp

    _dispatch.reset_launch_counts()
    before = entry.batch_stats()
    t0 = time.monotonic()
    with ThreadPoolExecutor(CLIENT_THREADS) as pool:
        responses = list(pool.map(call, range(N_REQUESTS)))
    wall = time.monotonic() - t0
    launches = _dispatch.launch_counts().get("flash_fwd", 0)
    after = entry.batch_stats()
    batches = after["batches"] - before["batches"]
    rows = after["rows"] - before["rows"]
    drained = server.stop()
    log(f"[slice] {N_REQUESTS} requests ({rows} rows) in {wall:.3f} s over "
        f"{batches} batches; flash_fwd launches {launches} "
        f"(= 12 x {launches / max(batches, 1):.2f}); drained={drained}")
    if batches < 1 or launches != cfg.num_layers * batches:
        raise SystemExit(
            f"chip_smoke: {launches} flash_fwd launches for {batches} "
            f"batches; want {cfg.num_layers} per batch")
    if not drained:
        raise SystemExit("chip_smoke: server did not drain on stop")

    # Every response against the same model with plain attention.
    worst_probs = 0.0
    with mock.patch.object(attention_mod, "flash_attention",
                           reference_attention), torch.inference_mode():
        for req, resp in zip(requests, responses):
            out = np.asarray(resp["outputs"], dtype=np.float64)
            n = req["mask"].shape[0]
            if out.shape != (n, 2) or not np.all(np.isfinite(out)) or \
                    np.abs(out.sum(-1) - 1).max() > 1e-5:
                raise SystemExit(f"chip_smoke: bad served output {out}")
            want = _nsp_softmax(model, _on(dev, req)).double().cpu().numpy()
            worst_probs = max(worst_probs, float(np.abs(out - want).max()))
    # And the encoder itself, kernel vs plain, on one full batch.
    batch = {k: np.concatenate([r[k] for r in requests[:4]])[:8]
             for k in requests[0]}
    with torch.inference_mode():
        _dispatch.reset_launch_counts()
        h_kernel = model(_on(dev, batch))
        if _dispatch.launch_counts().get("flash_fwd") != cfg.num_layers:
            raise SystemExit("chip_smoke: the encoder bypassed flash_fwd")
        with mock.patch.object(attention_mod, "flash_attention",
                               reference_attention):
            h_plain = model(_on(dev, batch))
    worst_hidden = float((h_kernel - h_plain).abs().max())
    breakdown = _forward_breakdown(model, _on(dev, batch))
    log(f"[slice] one bucket-8 forward: {breakdown}")
    log(f"[slice] served NSP probabilities vs plain attention: max_abs_err "
        f"{worst_probs:.3e} (tol {TOL_PROBS:.0e}); hidden [8,128,768]: "
        f"{worst_hidden:.3e} (tol {TOL_HIDDEN:.0e})")
    if worst_probs > TOL_PROBS or worst_hidden > TOL_HIDDEN:
        raise SystemExit("chip_smoke: served outputs disagree with plain "
                         "attention")
    lat_ms = np.asarray(latencies) * 1e3
    log(f"[slice] {N_REQUESTS / wall:.1f} requests/s ({rows / wall:.1f} "
        f"rows/s), p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.2f} ms over {N_REQUESTS} requests, "
        f"{CLIENT_THREADS} clients, on {smi}")
    return {"model": "bert_base", "seq_len": T, "requests": N_REQUESTS,
            "rows": rows, "client_threads": CLIENT_THREADS,
            "batches": batches, "flash_fwd_launches": launches,
            "requests_per_s": N_REQUESTS / wall, "rows_per_s": rows / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "max_abs_err_probs": worst_probs,
            "max_abs_err_hidden": worst_hidden, "forward_bucket8": breakdown,
            "card": smi}


def _forward_breakdown(model, feats) -> dict:
    """Where one bucket-8 forward's time goes: host wall time (synchronised,
    median of 10), device kernel time and the flash kernel's part of it."""
    fwd = lambda: _nsp_softmax(model, feats)  # noqa: E731
    with torch.inference_mode():
        walls = []
        for _ in range(13):
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        by_kernel = _device_us_by_kernel(fwd, iters=10)
    wall_ms = float(np.median(walls[3:])) * 1e3
    device_ms = sum(by_kernel.values()) / 1e3
    flash_ms = sum(us for k, us in by_kernel.items()
                   if "flash_fwd_kernel" in k) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "flash_fwd_ms": flash_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "flash_share_of_device": flash_ms / device_ms,
            "top_kernels_us": {k[:60]: round(us, 1) for k, us in top}}


# -- 5. train: BERT-base through the port's Trainer.fit ---------------------

# BERT phase-1 pretraining (google-research/bert: max_seq_length=128,
# max_predictions_per_seq=20, masked_lm_prob=0.15) at one card's share of
# the batch, with padding so the key-mask path runs.
TRAIN_BATCH, TRAIN_T, MAX_PRED = 32, 128, 20
TRAIN_BATCHES = 3          # fixed batches, cycled by the epochs of fit
FIT_EPOCHS = 10            # 30 steps
MIXED_STEPS = 3
# kernel path vs plain path, one loss and gradient of BERT-base (float32,
# same dropout masks): the loss to a relative 1e-5; each gradient leaf's
# max |difference| to 1e-3 of that leaf's max |gradient|, that max floored
# at 1e-4 of the largest gradient of the model for leaves whose exact
# gradient is 0 (the key biases: softmax ignores a shift of a whole row;
# theirs are float32 rounding noise, ~1e-9 of the largest on the CPU).
TOL_LOSS_REL = 1e-5
TOL_GRAD_FRAC = 1e-3
TOL_GRAD_FLOOR = 1e-4
# bf16 compute vs float32, first step on the same batch and dropout masks
TOL_MIXED_REL = 2e-2


def _loss_and_grads(trainer, params, batch, dev, seed):
    """One loss and every gradient leaf (by name) of the train step's
    differentiated function, with the dropout masks of ``seed``."""
    from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

    gen = torch.Generator(dev).manual_seed(seed)
    loss, _, _, grads = trainer._grad_of(params, {}, batch, gen)
    return float(loss), dict(flatten_with_names(grads))


def phase_train(dev, smi, batches):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reference_attention,
    )
    from deeplearning4j_tpu_torch.models.bert import bert_base
    from deeplearning4j_tpu_torch.nn import config as nnconfig
    from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod
    from deeplearning4j_tpu_torch.serde.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
    )
    from deeplearning4j_tpu_torch.train.listeners import (
        CheckpointListener,
        ScoreIterationListener,
        TrainingListener,
    )
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    class StepEvents(TrainingListener):
        """Records a CUDA event at every iteration (no host sync) and keeps
        each step's loss tensor: the steps' spacing on the device timeline
        and their losses, read after the fit."""

        def __init__(self):
            self.events, self.losses = [], []

        def on_iteration(self, epoch, step, ts, metrics):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            self.losses.append(metrics["total_loss"])
            return False

    t0 = time.monotonic()
    model = bert_base(device=dev, net=nnconfig.NeuralNetConfiguration(
        seed=SEED, updater=Adam(1e-4)))
    cfg = model.config
    layers = cfg.num_layers
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    log(f"[train] bert_base: {model.num_params():,} parameters, dropout "
        f"{cfg.dropout}/{cfg.attention_dropout}, Adam(1e-4), batches "
        f"{TRAIN_BATCH}x{TRAIN_T} (max_predictions {MAX_PRED}), built in "
        f"{time.monotonic() - t0:.1f} s")
    on_dev = [batch_to_device(b, dev) for b in batches]

    # 1. one loss and gradient, kernels vs the plain path
    _dispatch.reset_launch_counts()
    loss_k, g_kernel = _loss_and_grads(trainer, ts0.params, on_dev[0], dev,
                                       SEED)
    counts = _dispatch.launch_counts()
    want = {"flash_fwd": layers, "flash_bwd_dkv": layers,
            "flash_bwd_dq": layers}
    if counts != want:
        raise SystemExit(f"chip_smoke: one loss+grad launched {counts}, "
                         f"want {want}")
    with mock.patch.object(attention_mod, "flash_attention",
                           reference_attention):
        loss_p, g_plain = _loss_and_grads(trainer, ts0.params, on_dev[0],
                                          dev, SEED)
    top = max(float(g.abs().max()) for g in g_plain.values())
    worst_name, worst = None, 0.0
    for name, gp in g_plain.items():
        diff = float((g_kernel[name] - gp).abs().max())
        ratio = diff / max(float(gp.abs().max()), TOL_GRAD_FLOOR * top)
        if ratio > worst:
            worst_name, worst = name, ratio
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[train] kernel vs plain path: loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {loss_rel:.2e}, tol {TOL_LOSS_REL:.0e}); worst gradient leaf "
        f"{worst_name} at {worst:.2e} of its max (tol {TOL_GRAD_FRAC:.0e})")
    if loss_rel > TOL_LOSS_REL or worst > TOL_GRAD_FRAC:
        raise SystemExit("chip_smoke: the kernel path's loss or gradients "
                         "disagree with the plain path")
    del g_kernel, g_plain

    # 2. Trainer.fit: 30 steps over the fixed batches
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        score = ScoreIterationListener(every=10)
        steps = StepEvents()
        ckpts = CheckpointListener(str(ckpt_dir), every_epochs=None,
                                   every_iters=10, keep_last=2, model=model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _dispatch.reset_launch_counts()
        t0 = time.monotonic()
        ts = trainer.fit(ts0, on_dev, epochs=FIT_EPOCHS,
                         listeners=[score, steps, ckpts])
        torch.cuda.synchronize()
        fit_s = time.monotonic() - t0
        counts = fit_counts = _dispatch.launch_counts()
        n_steps = ts.step
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        losses = [float(x) for x in steps.losses]
        gaps = [a.elapsed_time(b) for a, b in zip(steps.events,
                                                  steps.events[1:])]
        step_ms = float(np.median(gaps[3:]))
        log(f"[train] fit: {n_steps} steps in {fit_s:.2f} s (3 checkpoints "
            f"included); launches {counts}; losses first "
            f"{[round(x, 4) for x in losses[:3]]} last "
            f"{[round(x, 4) for x in losses[-3:]]}; median step "
            f"{step_ms:.2f} ms; peak memory {peak_gib:.2f} GiB")
        want = {k: layers * n_steps for k in want}
        if n_steps != TRAIN_BATCHES * FIT_EPOCHS or counts != want:
            raise SystemExit(f"chip_smoke: fit launched {counts} over "
                             f"{n_steps} steps, want {want}")
        first, last = np.mean(losses[:TRAIN_BATCHES]), np.mean(
            losses[-TRAIN_BATCHES:])
        if not (np.all(np.isfinite(losses)) and last < first):
            raise SystemExit(f"chip_smoke: the loss did not fall "
                             f"({first:.4f} -> {last:.4f})")

        # 3. the last checkpoint restores bit-equal, with the same next loss
        path = latest_checkpoint(ckpt_dir)
        restored = restore_checkpoint(path, trainer.init_state())
        same = restored.step == ts.step and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(restored.params),
                                              tree_leaves(ts.params)))
        same_opt = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(restored.opt_state), tree_leaves(ts.opt_state)))
        nxt = on_dev[ts.step % TRAIN_BATCHES]
        _, m_live = trainer.train_step(ts, nxt)
        _, m_back = trainer.train_step(restored, nxt)
        next_live, next_back = (float(m_live["total_loss"]),
                                float(m_back["total_loss"]))
        log(f"[train] restored {Path(path).name}: params bit-equal={same}, "
            f"updater state bit-equal={same_opt}; next-step loss "
            f"{next_live:.6f} live vs {next_back:.6f} restored")
        if not (same and same_opt and next_live == next_back):
            raise SystemExit("chip_smoke: the checkpoint did not restore "
                             "the training state")
        del restored
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # 4. mixed precision: bf16 compute, float32 master params and state
    mp_model = copy.copy(model)  # shares the parameters, not the config
    mp_model.config = dataclasses.replace(cfg, net=dataclasses.replace(
        cfg.net, mixed_precision=True))
    mp_trainer = Trainer(mp_model)
    mts = mp_trainer.init_state(trainer.variables(ts0))
    _dispatch.reset_launch_counts()
    mp_losses = []
    for i in range(MIXED_STEPS):
        mts, m = mp_trainer.train_step(mts, on_dev[i % TRAIN_BATCHES])
        mp_losses.append(float(m["total_loss"]))
    counts = _dispatch.launch_counts()
    mp_rel = abs(mp_losses[0] - losses[0]) / abs(losses[0])
    log(f"[train] mixed precision: losses {mp_losses} (first vs float32 "
        f"{losses[0]:.6f}: rel {mp_rel:.2e}, tol {TOL_MIXED_REL:.0e}); "
        f"launches {counts}")
    want_mp = {k: layers * MIXED_STEPS for k in want}
    if (not np.all(np.isfinite(mp_losses)) or mp_rel > TOL_MIXED_REL
            or counts != want_mp):
        raise SystemExit("chip_smoke: the mixed-precision steps failed")
    del mts, mp_trainer

    # 5. where one step's time goes
    breakdown = _step_breakdown(trainer, ts, on_dev[0])
    log(f"[train] one step: {breakdown}")
    tokens = TRAIN_BATCH * TRAIN_T
    real_tokens = int(sum(float(b["features"]["mask"].sum()) for b in batches)
                      / len(batches))
    return {
        "model": "bert_base", "batch": TRAIN_BATCH, "seq_len": TRAIN_T,
        "max_predictions": MAX_PRED, "steps": n_steps,
        "launches": fit_counts,
        "losses": losses, "loss_first_epoch": float(first),
        "loss_last_epoch": float(last),
        "median_step_ms": step_ms, "step_ms_gaps": gaps,
        "samples_per_s": TRAIN_BATCH / (step_ms / 1e3),
        "tokens_per_s": tokens / (step_ms / 1e3),
        "real_tokens_per_s": real_tokens / (step_ms / 1e3),
        "peak_memory_gib": peak_gib, "fit_seconds": fit_s,
        "kernel_vs_plain": {"loss_kernel": loss_k, "loss_plain": loss_p,
                            "loss_rel": loss_rel,
                            "worst_grad_leaf": worst_name,
                            "worst_grad_frac": worst},
        "checkpoint_next_loss": next_back, "mixed_precision_losses":
            mp_losses, "mixed_vs_fp32_rel": mp_rel,
        "step_breakdown": breakdown, "card": smi,
    }


def _step_breakdown(trainer, ts, batch) -> dict:
    """One train step: host wall time (synchronised, median of 5 after 2
    warm-up), device kernel time from the profiler, the device's idle
    share of the wall time, and each flash kernel's share of the device
    time."""
    step = lambda: trainer.train_step(ts, batch)  # noqa: E731
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = float(np.median(walls[2:])) * 1e3
    by_kernel = _device_us_by_kernel(step, iters=3)
    device_ms = sum(by_kernel.values()) / 1e3
    shares = {}
    for kernel in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        k_ms = sum(us for k, us in by_kernel.items()
                   if f"{kernel}_kernel" in k) / 1e3
        shares[kernel] = {"ms": k_ms, "share_of_device": k_ms / device_ms}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "flash": shares,
            "top_kernels_us": {k[:60]: round(us, 1) for k, us in top}}


def _train_batches():
    from deeplearning4j_tpu_torch.models.bert import make_mlm_batch

    return [make_mlm_batch(SEED + i, TRAIN_BATCH, TRAIN_T, 30522,
                           mask_frac=0.15, pad_frac=0.1,
                           max_predictions=MAX_PRED)
            for i in range(TRAIN_BATCHES)]


def main() -> int:
    t_start = time.monotonic()
    dev, smi = phase_device()
    phase_build()
    from deeplearning4j_tpu_torch.kernels import _dispatch

    batches = _train_batches()
    train_lengths = [int(n) for n in
                     batches[0]["features"]["mask"].sum(axis=1)]
    cases = phase_kernels(dev)
    bwd_cases = phase_kernels_bwd(dev, train_lengths)
    serving = phase_slice(dev, smi)
    training = phase_train(dev, smi, batches)
    main_case = cases["bert_base_serving_fp32"]
    fwd = {
        "name": "flash_fwd", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:115",
        "launches": serving["flash_fwd_launches"],
        "launches_by_path": {"serving": serving["flash_fwd_launches"],
                             "training": training["launches"]["flash_fwd"]},
        "launches_per_forward": (serving["flash_fwd_launches"]
                                 / serving["batches"]),
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"], "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "library_ms": main_case["library_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "cases": cases, "card": smi,
    }
    entries = [fwd]
    for kernel, line in (("flash_bwd_dkv", 321), ("flash_bwd_dq", 352)):
        def err(row):  # this kernel's outputs
            e = row["max_abs_err"]
            return max(e["dk"], e["dv"]) if kernel == "flash_bwd_dkv" \
                else e["dq"]

        timed = {c: bwd_cases[c] for c in ("bert_base_train_fp32",
                                           "bert_base_train_bf16")}
        main_row = timed["bert_base_train_fp32"]
        entries.append({
            "name": kernel, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/flash_bwd.cu",
            "replaces": f"deeplearning4j_tpu/kernels/flash_attention.py:"
                        f"{line}",
            "launches": training["launches"][kernel],
            "launches_per_step": (training["launches"][kernel]
                                  / training["steps"]),
            "max_abs_err": err(main_row),
            "max_abs_err_by_case": {c: err(r) for c, r in bwd_cases.items()},
            "ms": main_row[f"{kernel}_ms"],
            "plain_ms": main_row["plain_ms"],
            "library_ms": main_row["library_ms"],
            "bound_ms": main_row[f"{kernel}_bound_ms"],
            "bound_by": main_row[f"{kernel}_bound_by"],
            "by_dtype": {r["dtype"]: {
                "ms": r[f"{kernel}_ms"], "pair_ms": r["pair_ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "bound_ms": r[f"{kernel}_bound_ms"],
                "bound_by": r[f"{kernel}_bound_by"]} for r in timed.values()},
            "ms_is": "device time per launch (torch.profiler)",
            "plain_and_library_cover": "dq, dk and dv together: "
                                       "reference_attention_bwd, and "
                                       "scaled_dot_product_attention's "
                                       "backward",
            "shape": main_row["shape"], "card": smi,
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    log(f"[done] {time.monotonic() - t_start:.1f} s; launch counts now "
        f"{_dispatch.launch_counts()}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
