#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py      # needs one H100/H200 and the CUDA toolkit

Phases, each of which fails the run (non-zero exit) rather than being
caught:

1. device — CUDA present, compute capability 9.0; prints the card's name
   and power limit as nvidia-smi gives them. TF32 is switched off for
   matmuls and cuDNN, so float32 bounds below are float32 bounds.
2. build — compiles every kernel of the port from the checkout's sources
   (nvcc, sm_90a) and prints the build seconds and ptxas' report.
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it (and at the other head sizes and
   masks the kernel takes), with the tolerance stated per dtype; then the
   kernel, the plain version and one PyTorch library call timed with CUDA
   events, beside the least time the card could take (``bound_ms``).
4. slice — BERT-base at full width (12 layers, width 768, 12 heads, vocab
   30522), weights drawn from a seed on the card, served by the port's
   ModelServer → ModelRegistry → ParallelInference (batched, max batch 8)
   to concurrent ServingClient requests; every response is held against
   the same model run with plain attention on the card, and the flash
   launch count must be 12 per dispatched batch.

It prints the kernels line ({"kernels": [...]}), the serving line, the
nvidia-smi line and, last, {"ok": true, "device": {...}}. It imports
nothing of JAX nor of the JAX package.
"""

from __future__ import annotations

import json
import sys
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

def phase_build():
    from deeplearning4j_tpu_torch.kernels import _build

    t0 = time.monotonic()
    built = _build.build("flash_fwd")
    log(f"[build] flash_fwd: {built.seconds:.2f} s nvcc "
        f"({time.monotonic() - t0:.2f} s total) -> "
        f"{built.path.relative_to(ROOT)}")
    for line in built.log.splitlines():
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


def main() -> int:
    t_start = time.monotonic()
    dev, smi = phase_device()
    phase_build()
    from deeplearning4j_tpu_torch.kernels import _dispatch

    cases = phase_kernels(dev)
    serving = phase_slice(dev, smi)
    main_case = cases["bert_base_serving_fp32"]
    entry = {
        "name": "flash_fwd", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:115",
        "launches": serving["flash_fwd_launches"],
        "launches_per_forward": (serving["flash_fwd_launches"]
                                 / serving["batches"]),
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"], "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "library_ms": main_case["library_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "cases": cases, "card": smi,
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    log(f"[done] {time.monotonic() - t_start:.1f} s; launch counts now "
        f"{_dispatch.launch_counts()}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
