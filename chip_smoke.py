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
   beside the least time the card could take (``bound_ms``). Every flash
   kernel runs its products on the tensor cores (bf16 on wgmma, float32
   in 3xTF32 on mma.sync, whose bound is also given on the CUDA cores).
   The forward at the serving shape and at the training shape (both
   dtypes) and at GPT-2-small's causal shapes (T = S = 512 and 1024), its
   row LSE held against the plain one; the two backward kernels and the
   delta pre-pass (flash_bwd_delta against reference_delta, per row to
   TOL_DELTA of the row's sum of |O dO|) at the same training shapes
   (both dtypes); the error of SDPA's backward against the same plain
   version is logged beside the kernels'.
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
   device's idle share and each flash kernel's share of a step, of a
   float32 step and of a mixed-precision one (a flash kernel that reads
   no device time there fails the run).
6. kernels (LSTM) — lstm_fwd and lstm_bwd against their plain versions at
   the char-RNN's training shape (N=32, T=256, H=256, Graves peepholes,
   forget bias 1), without peepholes, at H=200 with N=3, from a non-zero
   initial state and at H=1024 (the step route: RW too large to stay in
   a cluster's shared memory); the launch plan of each logged; then
   timed beside their bounds (3xTF32 on the tensor cores, and on the
   CUDA cores), the plain versions and torch.nn.LSTM (cuDNN, the case
   without peepholes; also the forward at the serving bucket N=8), the
   kernel launches a call counted by the profiler (one persistent kernel
   on the resident route). It runs right
   after phase 3, before phases 4 and 5.
7. char-RNN serving — text_generation_lstm (vocab 77, hidden 256, seq
   256, GravesLSTM, backend "pallas"), weights from a seed, behind
   ModelServer (batched, max batch 8): int char ids in, the last step's
   next-char probabilities out, one-hot encoded on the card; every
   response held against the same model with plain LSTMs on the card;
   exactly 2 lstm_fwd launches per dispatched batch.
8. char-RNN training — Trainer.fit with Adam(1e-3) on batches of 32 x
   256 one-hot chars of a learnable synthetic text from the seed: loss
   and every gradient through the kernels against the plain path; 30
   steps with 2 lstm_fwd + 2 lstm_bwd launches each and a loss that falls
   by at least LOSS_FALL; a checkpoint restored bit-equal with the same
   next-step loss; step time, tokens/s, peak memory, the device's idle
   share and each LSTM kernel's share of a step.

9. kernels (GRU) — gru_fwd and gru_bwd against their plain versions at
   the char-GRU's training shape (N=64, T=100, H=1024) from h0 = 0 and
   from a non-zero h0, at the serving bucket N=8 without the workspace,
   and at H=200 with N=3; then timed beside their bounds (3xTF32 on the
   tensor cores, and on the CUDA cores), the plain versions and
   torch.nn.GRU (cuDNN; also the forward at the serving bucket N=8), the
   step launches counted by the profiler, the launch plan (clusters,
   grid, shared memory) logged.
10. char-GRU serving — the TensorFlow tutorial's char-GRU (Embedding(66,
   256) → GRU(1024) → softmax, seq 100, backend "pallas"), weights from a
   seed, behind ModelServer (batched, max batch 8): int char ids in, the
   last step's next-char probabilities out; every response held against
   the same model with the plain GRU on the card; exactly 1 gru_fwd
   launch per dispatched batch.
11. char-GRU training — Trainer.fit with Adam(1e-3) on batches of 64 x
   100 char ids of the synthetic text: loss and every gradient through
   the kernels against the plain path; 30 steps with 1 gru_fwd + 1
   gru_bwd launch each and a loss that falls by at least LOSS_FALL; a
   checkpoint restored bit-equal; step time, tokens/s, peak memory, the
   device's idle share and each GRU kernel's share of a step.
12. bitmap — bitmap_encode (the bitmap_pack kernel) against the plain
   codec of ops/compression, bit for bit, at sizes around a word and a
   tile and at BERT-base's parameter count, on the char-GRU's gradient
   leaves and in bfloat16 (against the kernel's plain version); timed at
   BERT-base's size beside its bound.
13. LeNet-5 training — lenet (bench.py's bench_lenet: batch 256, Adam
   1e-3) on load_mnist's synthetic set: one step's loss and every
   gradient leaf against a float64 copy of the model on the card (1e-5,
   1e-3 of the leaf's max); 30 steps of Trainer.fit through
   ArrayDataSetIterator → AsyncDataSetIterator with a falling loss and a
   checkpoint restored bit-equal; evaluate_model's accuracy on the test
   split above 0.5; step time, samples/s, peak memory, idle share.
14. ResNet-50 training — resnet50 (bench_resnet50: batch 32 × 224 × 224
   × 3, 1000 classes, Adam 1e-3): one step against the float64 copy
   (loss, BatchNorm state, gradients by relative L2 error; see
   TOL_GRAD_L2), 30 float32 steps and then 30 mixed-precision steps of
   fit, each with a falling loss and a checkpoint restored bit-equal
   (BatchNorm state included), the first mixed step against the float64
   loss; step time, samples/s, peak memory, idle share and device time
   by kernel class (conv, elementwise, reduce, ...).
15. ResNet-50 serving — the trained ResNet-50 behind ModelServer
   (batched, max batch 8), 100 requests of 1–2 NHWC images as JSON from
   4 client threads; every response against output_single to 1e-5;
   requests/s, p50/p99, a bucket-8 forward's wall and device time, and
   the host time of one request's JSON.
16. GPT-2-small training — gpt2_small (bench.py's bench_gpt: 12 x 768,
   12 heads, vocab 50257, head tied to embeddings/word, max_position 512,
   batch 8 x 512 random ids, Adam 1e-4, bf16 mixed precision, rbg rng,
   dropout 0.1), 124,096,849 parameters: one float32 loss and every
   gradient through the causal flash kernels against plain attention
   (BERT's limits), then 30 mixed-precision steps of fit with 12 launches
   of each flash kernel a step, a falling loss, a checkpoint (rbg key
   included) restored bit-equal and the first mixed step's loss against
   the float32 plain loss; step time, tokens/s, peak memory, idle share,
   device time by kernel class.
17. GPT-2-small serving — the trained model (float32) in a
   GenerationEngine (8 slots, max_len 512, 32 new tokens) behind
   ModelServer's :generate route, 64 streamed requests from 8 client
   threads (prompts of 8–200 ids, half greedy); every stream's length or
   eos checked and every greedy token held against the argmax of the
   full forward with plain attention; tokens/s, requests/s, time to
   first token and inter-token p50/p99, slot occupancy, the KV slab
   bytes, and one decode step's wall and device time.

18. kernels at the seq2seq slice's shapes — head sizes the kernels lack,
   zero-padded by flash_attention to the next kernel size (D = 16 at the
   seq2seq CrossAttention's shape, 1024 x 4 x 10 x 10, both dtypes; D =
   48 with masked keys): the forward and the three backward kernels once
   each, against the plain version at D; timed beside SDPA at D = 16 and
   the bounds of the work at D. Then LearnedSelfAttention (4 learned
   queries: the forward kernel at T = 4) against its plain attention, and
   RecurrentAttention (plain torch) against the same layer on the CPU,
   forward and backward. It runs right after phase 3's backward kernels;
   the forward cases at T = 1 and 4 are in phase 3, the encoder's LSTM
   shape (N=1024, T=10, H=32, cuDNN beside it) in phase 6.
19. seq2seq training — examples/seq2seq_attention.py's graph (Embedding
   → Bidirectional(LSTM(32)) encoder, PositionalEmbedding queries, a
   two-input CrossAttention of 4 heads of 16, RnnOutputLayer; vocab 12,
   T=10, 1024 sequences, Adam(3e-3)), built from its config JSON: one
   loss and every gradient through the kernels against the plain route
   (plain attention, the eager LSTM loop); 600 full-batch steps of fit
   with 1 flash_fwd, 1 each of the backward kernels, 2 lstm_fwd and 2
   lstm_bwd a step, a falling loss, the example's reversal accuracy
   (> 0.9 on the first 64 rows) and evaluate_model's, a checkpoint
   restored bit-equal; step time, peak memory, idle share, classes.
20. seq2seq serving — the trained model behind ModelServer (batched,
   max batch 8) with a dict input spec (int tokens, float qpos): 200
   requests of 1–4 sequences from 8 client threads, every response
   against the plain forward to 1e-4, 1 flash_fwd and 2 lstm_fwd per
   dispatched batch; requests/s, p50/p99. Phases 19 and 20 run after
   phase 8.

21. char-RNN by truncated BPTT — the char-RNN of phase 8 with
   backprop_type "tbptt" and tbptt_length 50 (GravesLSTMCharModellingExample's
   tbpttLength): a batch of 256 steps is 5 windows and a tail of 6, one
   Adam update each, 12 lstm_fwd + 12 lstm_bwd launches (the dispatch
   counts, and the persistent kernels by the profiler). One batch window
   by window through the kernels and through the plain route from the same
   state: each window's loss to 1e-5 relative, the carries handed on to
   TOL_CARRY of their max, the params after the batch to TOL_ADAM_STEP of
   an Adam step; one window over the whole sequence against the standard
   step, bit for bit; 30 batches of Trainer.fit (a listener callback a
   window), a falling loss, a checkpoint restored bit-equal that continues
   with the live state's loss; batch time, windows/s, tokens/s, peak
   memory and one window's idle share.
22. char-RNN sampling — the trained model: RnnTimeStepper primed with 64
   chars at N=32 (one lstm_fwd a layer; its carries against 64 plain
   steps), 256 single steps (the cells, no sweep) against the plain full
   forward, a greedy generate of 200 chars at batch 8 whose every id is
   the plain full forward's argmax (ties within TOL_GREEDY_TIE counted),
   a sampled generate twice from one seed; chars/s. Phases 21 and 22 run
   right after phase 6.
23. char-GRU by truncated BPTT — the char-GRU on one-hot chars through a
   bias-free Dense(66 → 256) (TBPTT splits features of rank >= 3 only, so
   the Embedding's int ids are refused), tbptt_length 50 over T=100: one
   batch of 2 windows against the plain route (phase 21's limits), 2
   gru_fwd + 2 gru_bwd launches a batch; batch time. It runs after
   phase 11. The kernel phases 6 and 9 also hold and time the TBPTT
   window shapes (T=50 from carried state, the T=6 tail, the T=64 prime)
   beside torch.nn.LSTM / torch.nn.GRU from the same initial state.

No TPU kernel lies on phases 13–15 and 17: the convolutions run in cuDNN
(as the JAX package leaves them to XLA), and generation's prefill and
decode attend with plain matmuls (as the JAX package's einsums,
models/gpt.py:298-304, :370-375); they launch none of the port's hand
kernels.

On the recurrent paths the plain ops/rnn.lstm and ops/rnn.gru must never
see a CUDA tensor (they are the plain paths the kernels are held against,
run separately).

It prints the kernels line ({"kernels": [...]}), the serving, training,
char-RNN (TBPTT and sampling too), char-GRU (TBPTT too), bitmap, LeNet-5,
ResNet-50, GPT-2-small and seq2seq lines,
the nvidia-smi line and, last, {"ok": true, "device": {...}}. It imports nothing of JAX
nor of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
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
# cores, bf16 on the tensor cores, HBM3 bandwidth; TF32 on the tensor
# cores, where a float32-grade product (3xTF32) takes three passes.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12
TF32_PASSES = 3
PEAK_BYTES_PER_S = 3.35e12

# kernel vs plain version, max |difference| over rows that see a key:
# float32 — both sides float32; the kernel's products are 3xTF32 (about 21
#   bits of each operand), it sums scores and outputs blockwise in another
#   order (and uses exp2): a few ulp of O(1) values.
# bfloat16 — both round the probabilities to bf16 before the second
#   matmul, at another point: the plain version the normalised p (and its
#   scores to bf16 first), the kernel (tensor cores) the unnormalised p as
#   the Pallas kernel does; both round the output to bf16 (eps 2^-8): a few
#   bf16 ulp of O(1) values.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the forward's row LSE vs the plain one of the inputs in float32, over
# rows that see a key, as a fraction of max(1, |plain|): float32 sums in
# another order; the bf16 kernel's bf16 x bf16 products are exact in
# float32. Rows that see no key must read at most -1e20 (the backward's
# clamp).
TOL_LSE = 1e-4
LSE_DEAD = -1e20
# backward kernels vs the plain backward, max |difference| over dq, dk, dv
# as a fraction of max(1, max |plain|): both compute in float32 from the
# same inputs and LSE; float32 differs by the order of the sums and by the
# kernels' 3xTF32 products (about 21 bits of each operand), bfloat16 also
# by the final rounding of each gradient to bf16 (eps 2^-8).
TOL_BWD = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# flash_bwd_delta vs reference_delta, per row, as a fraction of the row's
# sum of |O dO|: both multiply the same float32 values (bf16 x bf16 is
# exact in float32) and sum D products in float32 in another order
TOL_DELTA = 1e-6
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

KERNEL_SOURCES = ("flash_fwd", "flash_bwd", "lstm_scan", "gru_scan",
                  "bitmap_pack")


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


def _visible_pairs(b, t, s, causal, lengths):
    """[b, t, s] bool: the query-key pairs this run's masks leave visible."""
    qi = torch.arange(t)[:, None]
    kj = torch.arange(s)[None, :]
    vis = (qi + (s - t) >= kj) if causal else torch.ones(t, s,
                                                         dtype=torch.bool)
    n = torch.full((b,), s) if lengths is None else torch.tensor(lengths)
    return vis[None] & (kj[None] < n[:, None, None])


def _visible(b, t, s, causal, lengths):
    """What this run's masks leave visible, per head: query-key pairs,
    query rows that see at least one key, and keys that some row sees."""
    vis = _visible_pairs(b, t, s, causal, lengths)
    return (int(vis.sum()), int(vis.any(-1).sum()), int(vis.any(-2).sum()))


def _floor(ops, nbytes, dtype):
    """The least time for ``ops`` operations and ``nbytes`` bytes on the
    card: the larger of the bytes at PEAK_BYTES_PER_S and the operations
    on the tensor cores, bf16 at its peak and float32 as 3xTF32
    (TF32_PASSES passes at PEAK_TF32). Returns (ms, bound by, ms on the
    float32 CUDA cores): the last, max(bytes, operations at 67 TFLOP/s),
    is the bound of a float32 kernel on the CUDA cores (None for bf16)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    cuda_cores_ms = None
    if dtype == torch.float32:
        t_ops = TF32_PASSES * ops / PEAK_TF32
        cuda_cores_ms = max(ops / PEAK_FLOPS[dtype], t_bytes) * 1e3
    else:
        t_ops = ops / PEAK_FLOPS[dtype]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", cuda_cores_ms)


def _bound(b, h, t, s, d, dtype, causal, lengths):
    """Least time for the forward's work (``_floor``), operations and bytes
    counted on one rule: only what the masks leave visible. Operations:
    4·D per visible query-key pair. Bytes: O in full, Q of the rows that
    see a key, K and V of the keys some row sees, and the float32 mask.
    Returns (ms, bound by, operations, bytes, ms on the CUDA cores)."""
    es = torch.finfo(dtype).bits // 8
    pairs, rows, keys = _visible(b, t, s, causal, lengths)
    ops = 4.0 * d * h * pairs
    nbytes = es * h * d * (b * t + rows + 2 * keys) + (
        4 * b * s if lengths is not None else 0)
    ms, by, cores_ms = _floor(ops, nbytes, dtype)
    return ms, by, ops, nbytes, cores_ms


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


# Idle host time between the edges of a profiler's recording window and
# the first and last kernel it records: kernels that ran close to an edge
# were sometimes left out of the trace (seen on the card: up to 4 of 5
# recorded calls of a sweep; 4 of 174 short traces without a margin, none
# of 348 with 0.05 or 0.25 s).
TRACE_EDGE_S = 0.1


def _busy_us(spans, match="", calls=1) -> float:
    """The device's busy time per call, in µs: the length of the union of
    the (start, end, name) kernel intervals whose name contains ``match``,
    over ``calls``. Where kernels overlap (a GRU step starts while the one
    before it ends) it is less than the sum of their durations."""
    total, end = 0.0, None
    for a, b, _ in sorted(x for x in spans if match in x[2]):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total / calls


def _device_us_by_kernel(fn, iters=50, launches=None, spans=None) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, in µs,
    from the profiler. A dict passed as ``launches`` receives each
    kernel's launches per call, as the profiler counted them; a list
    passed as ``spans`` the (start, end, name) of every kernel of the
    ``iters`` recorded calls (for ``_busy_us``). The
    profiler traces one call as warm-up and discards it (tracing that
    starts with a burst of launches misses the first few), then records
    ``iters`` calls, TRACE_EDGE_S after its window opens and before it
    closes."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    averages, recorded = [], []

    def ready(p):
        averages.append(p.key_averages())
        recorded.extend(
            (e.time_range.start, e.time_range.end, e.name) for e in p.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=iters, repeat=1),
                 on_trace_ready=ready) as prof:
        for i in range(iters + 1):
            if i == 1:
                time.sleep(TRACE_EDGE_S)
            fn()
            torch.cuda.synchronize()
            if i == iters:
                time.sleep(TRACE_EDGE_S)
            prof.step()
    out = {}
    for e in averages[0]:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)
            out[e.key] = out.get(e.key, 0.0) + us / iters
            if launches is not None:
                launches[e.key] = launches.get(e.key, 0) + e.count / iters
    if spans is not None:
        spans.extend(recorded)
    return out


def _device_ms(fn) -> float:
    """Device time per call: the sum of its CUDA kernels' time."""
    return sum(_device_us_by_kernel(fn).values()) / 1e3


def _step_launches(fn, kernel: str, want: int, attempts: int = 3,
                   spans=None, name=None, route_only=False):
    """The launches per call of ``kernel``'s step kernel (or of the CUDA
    kernel whose name contains ``name``) as the profiler counts them, and
    that trace's device µs by kernel (a list passed as ``spans`` receives
    its kernel intervals, 5 calls). A trace may lose kernel records (seen
    on the card: a few to 63 of a call's launches missing, never one too
    many), so a count under ``want`` is retaken, up to ``attempts``
    traces; a count over it, or none that reaches it, fails the run. With
    ``route_only`` (the persistent LSTM sweeps, one kernel a call, whose
    traces kept 3 or 4 of 5 records in every attempt in some full runs,
    at T = 50, 6, 64 and once at T = 256, while other cases of the same
    run kept all: PR 17) a count of at least half of ``want`` shows the route
    and passes; the launches themselves are the dispatch counts'.
    Returns (count, µs by kernel, every count taken)."""
    name = name or f"{kernel}_step_kernel"
    counts = []
    for _ in range(attempts):
        launches, recorded = {}, []
        by_kernel = _device_us_by_kernel(fn, iters=5, launches=launches,
                                         spans=recorded)
        steps = sum(c for k, c in launches.items() if name in k)
        counts.append(steps)
        if steps >= want:
            break
    log(f"[kernels] {kernel}: {steps} launches of {name} per call "
        f"(profiler; expected {want}; traces {counts})")
    if route_only and want / 2 <= steps < want:
        log(f"[kernels] {kernel}: the profiler kept {steps / want:.0%} of "
            f"the records; the route holds (no launch over {want})")
        if spans is not None:
            spans.extend(recorded)
        return steps, by_kernel, counts
    if steps != want:
        log(f"[kernels] {kernel}: the last trace's launches per call by "
            f"kernel: {launches}")
        raise SystemExit(f"chip_smoke: {kernel} launched {steps} {name} "
                         f"per call, expected {want}")
    if spans is not None:
        spans.extend(recorded)
    return steps, by_kernel, counts


# (name, B, H, T, S, D, dtype, causal, key lengths per batch row, timed);
# "train": the first training batch's key lengths
BERT_LENGTHS = [128, 97, 64, 33, 128, 5, 77, 0]  # one all-zero-mask row
KERNEL_CASES = [
    ("bert_base_serving_fp32", 8, 12, 128, 128, 64, torch.float32, False,
     BERT_LENGTHS, True),
    ("bert_base_serving_bf16", 8, 12, 128, 128, 64, torch.bfloat16, False,
     BERT_LENGTHS, True),
    ("bert_base_train_bf16", 32, 12, 128, 128, 64, torch.bfloat16, False,
     "train", True),
    ("bert_base_train_fp32", 32, 12, 128, 128, 64, torch.float32, False,
     "train", True),
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
    ("d32_ragged_dead_row_bf16", 3, 4, 100, 130, 32, torch.bfloat16, False,
     [130, 61, 0], False),
    ("d128_padded_s300_bf16", 2, 4, 200, 300, 128, torch.bfloat16, False,
     [300, 129], False),
    # the float32 kernel's 64-row tile edges: T and S not multiples of 64,
    # 64-key tiles whose keys are all masked, a dead row at D = 32, causal
    # with T < S at D = 64 and D = 128
    ("t130_s100_d128_fp32", 2, 2, 130, 100, 128, torch.float32, False,
     [100, 37], False),
    ("masked_key_tiles_fp32", 2, 2, 100, 200, 64, torch.float32, False,
     [200, 40], False),
    ("d32_dead_row_fp32", 2, 3, 70, 100, 32, torch.float32, False,
     [100, 0], False),
    ("causal_t64_s130_fp32", 2, 3, 64, 130, 64, torch.float32, True,
     None, False),
    ("causal_t70_s200_d128_fp32", 1, 2, 70, 200, 128, torch.float32, True,
     [200], False),
    # GPT-2-small's causal attention: the training shape of bench.py's
    # bench_gpt (batch 8 x 512, eight 64-row tiles: the early loop end and
    # the diagonal tiles' masks over all of them), a ragged causal batch
    # with a dead row, and T = S = 1024 (GPT-2's context, and the length
    # from which the JAX package runs its Pallas kernel)
    ("gpt2_small_train_bf16", 8, 12, 512, 512, 64, torch.bfloat16, True,
     None, True),
    ("gpt2_small_train_fp32", 8, 12, 512, 512, 64, torch.float32, True,
     None, True),
    ("gpt_causal_ragged_t512_fp32", 4, 12, 512, 512, 64, torch.float32,
     True, [512, 377, 63, 0], False),
    ("gpt_causal_ragged_t512_bf16", 4, 12, 512, 512, 64, torch.bfloat16,
     True, [512, 377, 63, 0], False),
    ("gpt_causal_t1024_bf16", 4, 12, 1024, 1024, 64, torch.bfloat16, True,
     None, True),
    ("gpt_causal_t1024_fp32", 4, 12, 1024, 1024, 64, torch.float32, True,
     None, True),
]
# LearnedSelfAttention's few learned queries: one query tile of 1 or 4 rows
# (the rest of the tile dead) against one key tile (S = 64) or three, the
# last ragged (S = 130); causal aligns the few queries to the last keys.
# Timed at S = 130 without the causal mask.
KERNEL_CASES += [
    (f"t{t}_s{s}{'_causal' if causal else ''}_{tag}", 2, 3, t, s, 64, dtype,
     causal, None, s == 130 and not causal)
    for t in (1, 4) for s in (64, 130) for causal in (False, True)
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"))]


def _sdpa_call(q, k, v, mask, causal):
    """``scaled_dot_product_attention`` computing the same function: the
    key mask as a boolean mask, causal as ``is_causal`` (T = S on every
    timed causal case), or both folded into one boolean mask."""
    if mask is None:
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
    keep = (mask > 0)[:, None, None, :]
    if causal:
        t, s = q.shape[2], k.shape[2]
        keep = keep & (torch.arange(t, device=q.device)[:, None] + (s - t)
                       >= torch.arange(s, device=q.device)[None, :])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)


def _lse_err(q, k, v, mask, causal, lse, lengths):
    """The kernel's row LSE against ``reference_attention_lse`` of the
    inputs in float32: the worst |difference| / max(1, |plain|) over rows
    that see a key, and whether every row that sees none reads at most
    LSE_DEAD."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reference_attention_lse,
    )

    b, h, t, _ = q.shape
    s = k.shape[2]
    _, want = reference_attention_lse(q.float(), k.float(), v.float(),
                                      causal=causal, key_mask=mask)
    rows = _visible_pairs(b, t, s, causal, lengths).any(-1)  # [b, t]
    rows = rows[:, None, :].expand(b, h, t).reshape(b * h, t).to(q.device)
    frac = float(((lse - want).abs() / want.abs().clamp(min=1.0))[rows].max())
    dead_ok = bool((lse[~rows] <= LSE_DEAD).all())
    return frac, dead_ok


def phase_kernels(dev, train_lengths):
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda,
        reference_attention,
    )

    results = {}
    for (name, b, h, t, s, d, dtype, causal, lengths,
         timed) in KERNEL_CASES:
        if lengths == "train":
            lengths = train_lengths
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
        lse_frac, lse_dead = _lse_err(q, k, v, mask, causal, lse, lengths)
        ok = (err <= TOL[dtype] and finite and dead_zero and lse_ok
              and lse_frac <= TOL_LSE and lse_dead)
        log(f"[kernels] {name}: max_abs_err {err:.3e} (tol {TOL[dtype]:.0e})"
            f" finite={finite} zero_on_masked_rows={dead_zero} "
            f"lse_finite={lse_ok} lse_err {lse_frac:.2e} x max(1, |plain|) "
            f"(tol {TOL_LSE:.0e}) lse_dead<={LSE_DEAD:.0e}={lse_dead} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: kernel case {name} failed")
        if not timed:
            results[name] = {"shape": [b, h, t, s, d],
                             "dtype": str(dtype)[6:], "causal": causal,
                             "max_abs_err": err, "lse_err_frac": lse_frac}
            continue
        kernel = lambda: flash_attention_cuda(  # noqa: E731
            q, k, v, mask, causal=causal)
        plain = lambda: reference_attention(  # noqa: E731
            q, k, v, causal=causal, key_mask=mask)
        library = _sdpa_call(q, k, v, mask, causal)
        bound_ms, bound_by, ops, nbytes, cores_ms = _bound(
            b, h, t, s, d, dtype, causal, lengths)
        row = {"shape": [b, h, t, s, d], "dtype": str(dtype)[6:],
               "causal": causal,
               "max_abs_err": err, "lse_err_frac": lse_frac,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_cuda_cores_ms": cores_ms, "ops": ops, "bytes": nbytes}
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
        by_kernel = _device_us_by_kernel(library)
        row["library_device_ms"] = sum(by_kernel.values()) / 1e3
        row["library_device_us_by_kernel"] = {kn[:80]: us for kn, us in
                                              by_kernel.items()}
        cores = ("" if cores_ms is None
                 else f", {cores_ms:.4f} ms on the CUDA cores")
        log(f"[kernels] {name}: kernel {row['kernel_ms']:.4f} ms "
            f"(device {row['kernel_device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, tensor cores{cores}); "
            f"sdpa's kernels {sorted(row['library_device_us_by_kernel'])}")
        results[name] = row
    return results


def _bound_bwd(kernel, b, h, t, s, d, dtype, causal, lengths):
    """Least time for one backward kernel's work (``_floor``), on the
    forward's rule: only what the masks leave visible. Operations per
    visible query-key pair: 8·D for flash_bwd_dkv (scores, dP, dV and dK
    products), 6·D for flash_bwd_dq (scores, dP, dQ). Bytes: Q and dO of
    the rows that see a key, K and V of the keys some row sees, the
    float32 LSE and delta of those rows and the mask; the outputs written
    in full (dK and dV, or dQ). Returns (ms, bound by, operations, bytes,
    ms on the CUDA cores)."""
    es = torch.finfo(dtype).bits // 8
    pairs, rows, keys = _visible(b, t, s, causal, lengths)
    ops = (8.0 if kernel == "flash_bwd_dkv" else 6.0) * d * h * pairs
    outputs = 2 * b * s if kernel == "flash_bwd_dkv" else b * t
    nbytes = (es * h * d * (2 * rows + 2 * keys + outputs) + 8 * h * rows
              + (4 * b * s if lengths is not None else 0))
    ms, by, cores_ms = _floor(ops, nbytes, dtype)
    return ms, by, ops, nbytes, cores_ms


def _bound_delta(b, h, t, d, dtype):
    """Least time for flash_bwd_delta's work (rowsum(dO·O) over B·H·T
    rows): O and dO read once, delta written once in float32; 2·D
    operations a row, at the float32 CUDA cores' rate (67 TFLOP/s).
    Returns (ms, bound by, operations, bytes)."""
    es = torch.finfo(dtype).bits // 8
    rows = b * h * t
    nbytes = 2 * es * rows * d + 4 * rows
    ops = 2.0 * d * rows
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", ops, nbytes)


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
    # the float32 kernels' 64-row tile edges: T and S not multiples of 64,
    # 64-key tiles whose keys are all masked, a dead row at D = 32, causal
    # with T < S at D = 64 and D = 128
    ("t130_s100_d128_fp32", 2, 2, 130, 100, 128, torch.float32, False,
     [100, 37], False),
    ("masked_key_tiles_fp32", 2, 2, 100, 200, 64, torch.float32, False,
     [200, 40], False),
    ("d32_dead_row_fp32", 2, 3, 70, 100, 32, torch.float32, False,
     [100, 0], False),
    ("causal_t64_s130_fp32", 2, 3, 64, 130, 64, torch.float32, True,
     None, False),
    ("causal_t70_s200_d128_fp32", 1, 2, 70, 200, 128, torch.float32, True,
     [200], False),
    # GPT-2-small's causal attention, as in KERNEL_CASES: the dkv kernel
    # starts each key tile's query loop at the diagonal, the dq kernel
    # stops each query tile's key loop there
    ("gpt2_small_train_fp32", 8, 12, 512, 512, 64, torch.float32, True,
     None, True),
    ("gpt2_small_train_bf16", 8, 12, 512, 512, 64, torch.bfloat16, True,
     None, True),
    ("gpt_causal_ragged_t512_fp32", 4, 12, 512, 512, 64, torch.float32,
     True, [512, 377, 63, 0], False),
    ("gpt_causal_ragged_t512_bf16", 4, 12, 512, 512, 64, torch.bfloat16,
     True, [512, 377, 63, 0], False),
    ("gpt_causal_t1024_fp32", 4, 12, 1024, 1024, 64, torch.float32, True,
     None, True),
    ("gpt_causal_t1024_bf16", 4, 12, 1024, 1024, 64, torch.bfloat16, True,
     None, True),
]


def phase_kernels_bwd(dev, train_lengths):
    """The delta pre-pass against ``reference_delta`` and both backward
    kernels against ``reference_attention_bwd`` on the same inputs,
    forward output and LSE, SDPA's backward's error against the same
    plain version logged beside theirs; then timed at the training shape
    beside SDPA's backward."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda,
        flash_attention_cuda,
        flash_bwd_delta_cuda,
        reference_attention_bwd,
        reference_delta,
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
        delta = flash_bwd_delta_cuda(out, dout)
        delta_want = reference_delta(out, dout)
        torch.cuda.synchronize()
        delta_err = (delta - delta_want).abs()
        delta_frac = float((delta_err / (out.float() * dout.float()).abs()
                            .sum(-1).reshape(delta.shape).clamp(min=1e-30))
                           .max())
        errs = {"delta": float(delta_err.max())}
        ok = delta_frac <= TOL_DELTA
        for which, a, w in zip(("dq", "dk", "dv"), got, want):
            err = float((a.float() - w.float()).abs().max())
            ref = max(1.0, float(w.float().abs().max()))
            errs[which] = err
            ok &= err <= TOL_BWD[dtype] * ref and bool(torch.isfinite(a).all())
        dead = (torch.tensor(lengths) == 0 if lengths is not None
                else torch.zeros(b, dtype=torch.bool)).to(dev)
        dead_zero = all(bool((a[dead] == 0).all()) for a in got)
        ok &= dead_zero
        sdpa = _sdpa_bwd_err(q, k, v, mask, dout, causal, want)
        log(f"[kernels] bwd {name}: max_abs_err dq {errs['dq']:.3e} dk "
            f"{errs['dk']:.3e} dv {errs['dv']:.3e} (tol "
            f"{TOL_BWD[dtype]:.0e} x max(1, |plain|)), delta "
            f"{errs['delta']:.3e} ({delta_frac:.2e} of the row's sum of "
            f"|O dO|, tol {TOL_DELTA:.0e}) zero_on_masked_rows="
            f"{dead_zero} -> {'ok' if ok else 'FAIL'}; sdpa backward vs "
            f"the same plain: dq {sdpa['dq']:.3e} dk {sdpa['dk']:.3e} dv "
            f"{sdpa['dv']:.3e}")
        if not ok:
            raise SystemExit(f"chip_smoke: backward kernel case {name} "
                             "failed")
        row = {"shape": [b, h, t, s, d], "dtype": str(dtype)[6:],
               "causal": causal,
               "max_abs_err": errs, "delta_err_frac": delta_frac,
               "sdpa_max_abs_err": sdpa}
        if timed:
            row.update(_time_bwd(q, k, v, mask, out, lse, dout, lengths,
                                 causal))
            cores = "".join(
                f", {kn[10:]} {row[f'{kn}_bound_cuda_cores_ms']:.4f} on the"
                " CUDA cores" for kn in ("flash_bwd_dkv", "flash_bwd_dq")
                if row[f"{kn}_bound_cuda_cores_ms"] is not None)
            log(f"[kernels] bwd {name}: delta {row['flash_bwd_delta_ms']:.4f}"
                f" ms (bound {row['flash_bwd_delta_bound_ms']:.4f}, "
                f"{row['flash_bwd_delta_bound_by']}; plain "
                f"{row['delta_plain_ms']:.4f}), dkv "
                f"{row['flash_bwd_dkv_ms']:.4f} ms "
                f"(bound {row['flash_bwd_dkv_bound_ms']:.4f}, "
                f"{row['flash_bwd_dkv_bound_by']}), dq "
                f"{row['flash_bwd_dq_ms']:.4f} ms (bound "
                f"{row['flash_bwd_dq_bound_ms']:.4f}, "
                f"{row['flash_bwd_dq_bound_by']}{cores}); pair with delta "
                f"{row['pair_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"sdpa backward {row['library_ms']:.4f} ms; sdpa's kernels "
                f"{sorted(row['library_device_us_by_kernel'])}")
        results[name] = row
    return results


def _sdpa_bwd_err(q, k, v, mask, dout, causal, want):
    """SDPA's backward (its own forward, the same key mask and
    bottom-right causal mask) against the plain backward ``want``: max
    |difference| of dq over the rows that see a key, of dk and dv over
    the keys some row sees (SDPA gives NaN on rows that see none)."""
    b, h, t, d = q.shape
    s = k.shape[2]
    keep = torch.ones((b, 1, t, s), dtype=torch.bool, device=q.device)
    if mask is not None:
        keep = keep & (mask[:, None, None, :] > 0)
    if causal:
        keep = keep & (torch.arange(t, device=q.device)[:, None] + (s - t)
                       >= torch.arange(s, device=q.device)[None, :])
    rows = keep.any(-1, keepdim=True)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=keep | ~rows)
    grads = torch.autograd.grad(out, leaves, dout * rows)
    live = {"dq": rows.expand(-1, h, -1, d),
            "dk": keep.any(-2)[..., None].expand(-1, h, -1, d)}
    live["dv"] = live["dk"]
    return {n: float((g.float() - w.float())[live[n]].abs().max())
            for n, g, w in zip(("dq", "dk", "dv"), grads, want)}


def _time_bwd(q, k, v, mask, out, lse, dout, lengths, causal):
    """Times at one shape: each backward kernel's device time per launch
    (profiler; ``delta_ms`` is the pair's device time outside dkv and dq,
    the delta pre-pass), the wrapper's launches with its delta, the plain
    backward and SDPA's backward (CUDA events), the device time of each
    kernel SDPA's backward launches (profiler), and the delta alone: the
    kernel, ``reference_delta`` and, for float32, ``torch.linalg.vecdot``
    (CUDA events; bf16 has no one call that sums in float32)."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda,
        flash_bwd_delta_cuda,
        reference_attention_bwd,
        reference_delta,
    )

    b, h, t, d = q.shape
    s = k.shape[2]
    pair = lambda: flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, mask, out, lse, dout, causal=causal)
    plain = lambda: reference_attention_bwd(  # noqa: E731
        q, k, v, mask, out, lse, dout, causal=causal)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    sdpa_out = _sdpa_call(*leaves, mask, causal)()
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
    row["library_device_us_by_kernel"] = {
        k[:80]: us for k, us in _device_us_by_kernel(library,
                                                      iters=20).items()}
    for kernel in ("flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq"):
        row[f"{kernel}_ms"] = sum(us for name, us in by_kernel.items()
                                  if f"{kernel}_kernel" in name) / 1e3
    row["delta_ms"] = (sum(by_kernel.values()) / 1e3
                       - row["flash_bwd_dkv_ms"] - row["flash_bwd_dq_ms"])
    for kernel in ("flash_bwd_dkv", "flash_bwd_dq"):
        bound_ms, bound_by, ops, nbytes, cores_ms = _bound_bwd(
            kernel, b, h, t, s, d, q.dtype, causal, lengths)
        row.update({f"{kernel}_bound_ms": bound_ms,
                    f"{kernel}_bound_by": bound_by,
                    f"{kernel}_bound_cuda_cores_ms": cores_ms,
                    f"{kernel}_ops": ops, f"{kernel}_bytes": nbytes})
    bound_ms, bound_by, ops, nbytes = _bound_delta(b, h, t, d, q.dtype)
    row.update({"flash_bwd_delta_bound_ms": bound_ms,
                "flash_bwd_delta_bound_by": bound_by,
                "flash_bwd_delta_ops": ops, "flash_bwd_delta_bytes": nbytes})
    row["delta_kernel_ms"] = _time_ms(lambda: flash_bwd_delta_cuda(out, dout))
    row["delta_plain_ms"] = _time_ms(lambda: reference_delta(out, dout))
    row["delta_library_ms"] = (
        _time_ms(lambda: torch.linalg.vecdot(out, dout, dim=-1))
        if q.dtype == torch.float32 else None)
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
    feats = _on(dev, batch)
    breakdown = _forward_breakdown(lambda: _nsp_softmax(model, feats),
                                   "flash_fwd")
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
    return {"model": "bert_base", "num_params": model.num_params(),
            "seq_len": T, "requests": N_REQUESTS,
            "rows": rows, "client_threads": CLIENT_THREADS,
            "batches": batches, "flash_fwd_launches": launches,
            "requests_per_s": N_REQUESTS / wall, "rows_per_s": rows / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "max_abs_err_probs": worst_probs,
            "max_abs_err_hidden": worst_hidden, "forward_bucket8": breakdown,
            "card": smi}


def _forward_breakdown(fwd, kernel=None) -> dict:
    """Where one forward's time goes: host wall time (synchronised,
    median of 10), device busy time (the union of its kernels' intervals),
    its kernel classes and ``kernel``'s part of it (where named)."""
    with torch.inference_mode():
        walls = []
        for _ in range(13):
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        spans = []
        by_kernel = _device_us_by_kernel(fwd, iters=10, spans=spans)
    wall_ms = float(np.median(walls[3:])) * 1e3
    # busy time: kernels that overlap (dependent launches) count once
    device_ms = _busy_us(spans, "", 10) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
           "classes_ms": _kernel_classes(spans, 10),
           "top_kernels_us": {k[:60]: round(us, 1) for k, us in top}}
    if kernel is not None:
        kernel_ms = _busy_us(spans, f"{kernel}_", 10) / 1e3
        out[f"{kernel}_ms"] = kernel_ms
        out[f"{kernel}_share_of_device"] = kernel_ms / device_ms
    return out


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


def _check_grads(tag, loss_k, loss_p, g_kernel, g_plain):
    """Kernel path vs plain path: the loss to TOL_LOSS_REL and each
    gradient leaf to TOL_GRAD_FRAC of its floored max; fails the run
    otherwise. Returns (loss rel, worst leaf, its fraction)."""
    top = max(float(g.abs().max()) for g in g_plain.values())
    worst_name, worst = None, 0.0
    for name, gp in g_plain.items():
        diff = float((g_kernel[name] - gp).abs().max())
        ratio = diff / max(float(gp.abs().max()), TOL_GRAD_FLOOR * top)
        if ratio > worst:
            worst_name, worst = name, ratio
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[{tag}] kernel vs plain path: loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {loss_rel:.2e}, tol {TOL_LOSS_REL:.0e}); worst gradient leaf "
        f"{worst_name} at {worst:.2e} of its max (tol {TOL_GRAD_FRAC:.0e})")
    if loss_rel > TOL_LOSS_REL or worst > TOL_GRAD_FRAC:
        raise SystemExit("chip_smoke: the kernel path's loss or gradients "
                         "disagree with the plain path")
    return loss_rel, worst_name, worst


# the flash kernels a training step launches, each once per layer
FLASH_KERNELS = ("flash_fwd", "flash_bwd_delta", "flash_bwd_dkv",
                 "flash_bwd_dq")


def phase_train(dev, smi, batches):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reference_attention,
    )
    from deeplearning4j_tpu_torch.models.bert import bert_base
    from deeplearning4j_tpu_torch.nn import config as nnconfig
    from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

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
    want = {k: layers for k in FLASH_KERNELS}
    if counts != want:
        raise SystemExit(f"chip_smoke: one loss+grad launched {counts}, "
                         f"want {want}")
    with mock.patch.object(attention_mod, "flash_attention",
                           reference_attention):
        loss_p, g_plain = _loss_and_grads(trainer, ts0.params, on_dev[0],
                                          dev, SEED)
    loss_rel, worst_name, worst = _check_grads("train", loss_k, loss_p,
                                               g_kernel, g_plain)
    del g_kernel, g_plain

    # 2. Trainer.fit: 30 steps over the fixed batches; 3. the last
    # checkpoint restores bit-equal, with the same next-step loss
    fit = _fit_and_restore("train", trainer, ts0, on_dev, FIT_EPOCHS, dev)
    ts, counts, losses = fit["ts"], fit["launches"], fit["losses"]
    fit_counts, n_steps, step_ms = counts, ts.step, fit["median_step_ms"]
    want = {k: layers * n_steps for k in want}
    if n_steps != TRAIN_BATCHES * FIT_EPOCHS or counts != want:
        raise SystemExit(f"chip_smoke: fit launched {counts} over "
                         f"{n_steps} steps, want {want}")
    first, last = np.mean(losses[:TRAIN_BATCHES]), np.mean(
        losses[-TRAIN_BATCHES:])
    if not (np.all(np.isfinite(losses)) and last < first):
        raise SystemExit(f"chip_smoke: the loss did not fall "
                         f"({first:.4f} -> {last:.4f})")

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
    # where a mixed-precision step's time goes (the configuration of
    # bench.py's bench_bert, mixed_precision=True)
    mp_breakdown = _step_breakdown(mp_trainer, mts, on_dev[0],
                                   FLASH_KERNELS)
    log(f"[train] one mixed-precision step: {mp_breakdown}")
    _require_kernel_time("mixed-precision step", mp_breakdown)
    del mts, mp_trainer

    # 5. where one step's time goes
    breakdown = _step_breakdown(trainer, ts, on_dev[0],
                                FLASH_KERNELS)
    log(f"[train] one step: {breakdown}")
    _require_kernel_time("float32 step", breakdown)
    tokens = TRAIN_BATCH * TRAIN_T
    real_tokens = int(sum(float(b["features"]["mask"].sum()) for b in batches)
                      / len(batches))
    return {
        "model": "bert_base", "batch": TRAIN_BATCH, "seq_len": TRAIN_T,
        "max_predictions": MAX_PRED, "steps": n_steps,
        "launches": fit_counts,
        "losses": losses, "loss_first_epoch": float(first),
        "loss_last_epoch": float(last),
        "median_step_ms": step_ms, "step_ms_gaps": fit["step_ms_gaps"],
        "samples_per_s": TRAIN_BATCH / (step_ms / 1e3),
        "tokens_per_s": tokens / (step_ms / 1e3),
        "real_tokens_per_s": real_tokens / (step_ms / 1e3),
        "peak_memory_gib": fit["peak_memory_gib"],
        "fit_seconds": fit["fit_seconds"],
        "kernel_vs_plain": {"loss_kernel": loss_k, "loss_plain": loss_p,
                            "loss_rel": loss_rel,
                            "worst_grad_leaf": worst_name,
                            "worst_grad_frac": worst},
        "checkpoint_next_loss": fit["checkpoint_next_loss"],
        "mixed_precision_losses":
            mp_losses, "mixed_vs_fp32_rel": mp_rel,
        "mixed_precision_step_breakdown": mp_breakdown,
        "step_breakdown": breakdown, "card": smi,
    }


def _require_kernel_time(tag, breakdown):
    """Fail unless each named kernel of a step breakdown read device time:
    0 ms means no profiled kernel name contained the kernel's."""
    for kernel, row in breakdown["kernels"].items():
        if not row["ms"] > 0:
            raise SystemExit(f"chip_smoke: the {tag} read no device time "
                             f"for {kernel}")


def _step_events():
    """A listener that records a CUDA event at every iteration (no host
    sync) and keeps each step's loss tensor: the steps' spacing on the
    device timeline and their losses, read after the fit."""
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener

    class StepEvents(TrainingListener):
        def __init__(self):
            self.events, self.losses = [], []

        def on_iteration(self, epoch, step, ts, metrics):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            self.losses.append(metrics["total_loss"])
            return False

    return StepEvents()


def _fit_and_restore(tag, trainer, ts0, batches, epochs, dev,
                     next_batch=None, per_batch=1, step=None) -> dict:
    """Trainer.fit over ``batches`` (a list, or an iterator with
    ``next_batch`` given) for ``epochs`` with a checkpoint every 10
    batches (keep 2); the launch counts, losses, median step (CUDA
    events between steps, after 3), peak memory; then the last checkpoint
    restored must give bit-equal params, layer state and updater state
    and the same next-step loss as the live state. ``per_batch``: the
    iterations a batch makes (its truncated-BPTT windows; the median is
    then one batch's); ``step(ts, batch) -> (ts, metrics)``: the next
    step (default ``trainer.train_step``)."""
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.serde.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
    )
    from deeplearning4j_tpu_torch.train.listeners import (
        CheckpointListener,
        ScoreIterationListener,
    )
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        steps = _step_events()
        ckpts = CheckpointListener(str(ckpt_dir), every_epochs=None,
                                   every_iters=10 * per_batch, keep_last=2,
                                   model=trainer.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _dispatch.reset_launch_counts()
        t0 = time.monotonic()
        ts = trainer.fit(ts0, batches, epochs=epochs, listeners=[
            ScoreIterationListener(every=10), steps, ckpts])
        torch.cuda.synchronize()
        fit_s = time.monotonic() - t0
        counts = _dispatch.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        losses = [float(x) for x in steps.losses]
        ends = steps.events[per_batch - 1::per_batch]
        gaps = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        step_ms = float(np.median(gaps[3:]))
        log(f"[{tag}] fit: {ts.step} steps in {fit_s:.2f} s (checkpoints "
            f"included); launches {counts}; losses first "
            f"{[round(x, 4) for x in losses[:3]]} last "
            f"{[round(x, 4) for x in losses[-3:]]}; median step "
            f"{step_ms:.2f} ms; peak memory {peak_gib:.2f} GiB")

        path = latest_checkpoint(ckpt_dir)
        restored = restore_checkpoint(path, trainer.init_state())
        same = restored.step == ts.step and restored.rng == ts.rng and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(restored.params),
                                              tree_leaves(ts.params)))
        same_opt = all(torch.equal(a, b) for a, b in zip(
            tree_leaves((restored.opt_state, restored.model_state)),
            tree_leaves((ts.opt_state, ts.model_state))))
        nxt = (batches[(ts.step // per_batch) % len(batches)]
               if next_batch is None else next_batch)
        step = step or trainer.train_step
        _, m_live = step(ts, nxt)
        _, m_back = step(restored, nxt)
        next_live, next_back = (float(m_live["total_loss"]),
                                float(m_back["total_loss"]))
        log(f"[{tag}] restored {Path(path).name} (rng {restored.rng}): "
            f"step, rng and params bit-equal={same}, "
            f"updater and layer state bit-equal={same_opt}; next-step loss "
            f"{next_live:.6f} live vs {next_back:.6f} restored")
        if not (same and same_opt and next_live == next_back):
            raise SystemExit("chip_smoke: the checkpoint did not restore "
                             "the training state")
        del restored
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"ts": ts, "launches": counts, "losses": losses,
            "median_step_ms": step_ms, "step_ms_gaps": gaps,
            "peak_memory_gib": peak_gib, "fit_seconds": fit_s,
            "checkpoint_next_loss": next_back}


# Kernel classes of a step's device time, by the CUDA kernel's name: the
# convolutions (cuDNN's implicit-GEMM, xmma, FFT and Winograd kernels), the
# dense layers' GEMMs, reductions (BatchNorm's statistics, pools' sums,
# the loss), pooling, and the elementwise kernels (BatchNorm's normalise,
# activations, adds, casts, the updater); the rest as "other".
KERNEL_CLASSES = (
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "xmma", "implicit",
              "cudnn", "winograd", "fft")),
    ("gemm", ("gemm", "cutlass", "cublas")),
    ("pool", ("pool",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "foreach")),
)


def _kernel_classes(spans, calls) -> dict:
    """Device busy ms per call of each kernel class (``KERNEL_CLASSES``),
    from the profiler's (start, end, name) spans."""
    def klass(name):
        low = name.lower()
        for cls, keys in KERNEL_CLASSES:
            if any(k in low for k in keys):
                return cls
        return "other"

    by_class = {}
    for a, b, name in spans:
        by_class.setdefault(klass(name), []).append((a, b, name))
    return {cls: _busy_us(sp, "", calls) / 1e3
            for cls, sp in sorted(by_class.items())}


def _step_breakdown(trainer, ts, batch, kernels, step=None) -> dict:
    """One train step (or ``step()``, a callable): host wall time
    (synchronised, median of 5 after 2 warm-up), device busy time from the
    profiler (the union of its kernels' intervals), the device's idle
    share of the wall time, and each named kernel's share of the device
    time."""
    step = step or (lambda: trainer.train_step(ts, batch))
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = float(np.median(walls[2:])) * 1e3
    spans = []
    by_kernel = _device_us_by_kernel(step, iters=3, spans=spans)
    # busy time: kernels that overlap (dependent launches) count once
    device_ms = _busy_us(spans, "", 3) / 1e3
    shares = {}
    for kernel in kernels:
        k_ms = _busy_us(spans, f"{kernel}_", 3) / 1e3
        shares[kernel] = {"ms": k_ms, "share_of_device": k_ms / device_ms}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    classes = _kernel_classes(spans, 3)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "kernels": shares,
            "classes_ms": classes,
            "class_share_of_device": {c: ms / device_ms
                                      for c, ms in classes.items()},
            "top_kernels_us": {k[:60]: round(us, 1) for k, us in top},
            "top_kernel_share_of_device": {
                k[:60]: us / 1e3 / device_ms for k, us in top}}


def _train_batches():
    from deeplearning4j_tpu_torch.models.bert import make_mlm_batch

    return [make_mlm_batch(SEED + i, TRAIN_BATCH, TRAIN_T, 30522,
                           mask_frac=0.15, pad_frac=0.1,
                           max_predictions=MAX_PRED)
            for i in range(TRAIN_BATCHES)]


# -- 6. kernels (LSTM) --------------------------------------------------------

# The char-RNN of bench.py's bench_lstm: text_generation_lstm at vocab 77,
# hidden 256, seq 256, two GravesLSTM layers, batch 32.
CHAR_VOCAB, CHAR_HIDDEN, CHAR_T, CHAR_BATCH = 77, 256, 256, 32
# truncated BPTT of the char-RNN: GravesLSTMCharModellingExample's
# tbpttLength(50), over T=256 five windows of 50 and a tail of 6; the
# rnnTimeStep prime of 64 chars
CHAR_TBPTT, CHAR_PRIME = 50, 64
# lstm_fwd / lstm_bwd vs their plain versions, float32 on both sides,
# differing in the order of the sums of h·RW over H terms and of dz·RWᵀ
# over 4H (and, on the resident route, in its 3xTF32 products, about 21
# bits of each operand): forward outputs (|h| <= 1, |c| of order 1) to
# 1e-5 absolute; backward dz and the carries to 1e-5 of max(1, max
# |plain|).
TOL_LSTM_FWD = 1e-5
TOL_LSTM_BWD = 1e-5

# (name, N, T, H, Graves peepholes, forget bias, non-zero initial state,
#  timed); every H <= 320 takes the resident route (one persistent launch
#  a call), H=1024 the step route (one launch a step)
LSTM_CASES = [
    ("char_rnn_train_graves", CHAR_BATCH, CHAR_T, CHAR_HIDDEN, True, 1.0,
     False, True),
    ("char_rnn_train_no_peepholes", CHAR_BATCH, CHAR_T, CHAR_HIDDEN, False,
     1.0, False, True),
    ("h200_n3_graves", 3, CHAR_T, 200, True, 1.0, False, False),
    ("init_state_n8_graves", 8, 64, CHAR_HIDDEN, True, 1.0, True, False),
    ("h1024_n8_graves_step_route", 8, 32, 1024, True, 1.0, False, False),
    # each direction of the seq2seq example's biLSTM encoder (1024
    # sequences of 10 steps, 32 units, no peepholes): 128 clusters of 16
    # blocks, 2 units a block
    ("seq2seq_encoder_n1024_t10_h32", 1024, 10, 32, False, 1.0, False,
     True),
    # the char-RNN's TBPTT windows (from the carries the window before
    # left) and tail, and the rnnTimeStep prime (from zeros)
    ("charrnn_tbptt_window_t50", CHAR_BATCH, CHAR_TBPTT, CHAR_HIDDEN, True,
     1.0, True, True),
    ("charrnn_tbptt_tail_t6", CHAR_BATCH, CHAR_T % CHAR_TBPTT, CHAR_HIDDEN,
     True, 1.0, True, True),
    ("charrnn_prime_t64", CHAR_BATCH, CHAR_PRIME, CHAR_HIDDEN, True, 1.0,
     False, True),
]
# the cases with peepholes whose library yardstick is torch.nn.LSTM at the
# same shape without them, from the case's (h0, c0)
LSTM_LIBRARY_AT_SHAPE = ("charrnn_tbptt_window_t50", "charrnn_tbptt_tail_t6",
                         "charrnn_prime_t64")
# the input (N, T, width) torch.nn.LSTM is timed on beside a case without
# peepholes: the char-RNN's batch by default; the seq2seq encoder's reads
# the 64-wide embedding
LSTM_CUDNN_INPUT = {"seq2seq_encoder_n1024_t10_h32": (1024, 10, 64)}


def _lstm_inputs(dev, n, t, h, peep, init, seed):
    """xp_tm, rw, b, h0, c0, peep, gh_tm, gcT: float32 on the card, RW
    glorot-normal as the layers draw it."""
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn((t, n, 4 * h), generator=g)
    rw = (2.0 / (5 * h)) ** 0.5 * torch.randn((h, 4 * h), generator=g)
    b = 0.1 * torch.randn((4 * h,), generator=g)
    if init:
        h0 = torch.tanh(torch.randn((n, h), generator=g))
        c0 = torch.randn((n, h), generator=g)
    else:
        h0 = c0 = torch.zeros((n, h))
    pe = 0.1 * torch.randn((3, h), generator=g) if peep else None
    gh = torch.randn((t, n, h), generator=g)
    gc = torch.randn((n, h), generator=g)
    return [None if a is None else a.to(dev)
            for a in (xp, rw, b, h0, c0, pe, gh, gc)]


def _lstm_bound(kernel, n, t, h, peep, zero_init, workspace=True):
    """Least time for one sweep (``_floor``): the products in float32
    grade on the tensor cores, three TF32 passes, and beside it the bound
    on the float32 CUDA cores. Operations: the recurrent products,
    2·N·H·4H per product this run needs — forward one per step but the
    first when h0 is 0, backward the T-1 carries dz·RWᵀ and the one to
    h0; the gate math (tens of operations per unit and step, under 2% of
    the products at H=256) is not counted. Bytes, float32, each input read
    once and each output written once: forward xp, RW, b, the peepholes,
    h0 and c0 in; hs and, with the workspace, gates and cell states out
    (without it c_T); backward gates, cell states, dL/dh, dL/dc_T, RW, the
    peepholes and c0 in; dz, dh0 and dc0 out. Returns (ms, bound by,
    operations, bytes, ms on the CUDA cores)."""
    prod = 2.0 * n * h * 4 * h
    nh, nh4 = n * h, 4 * n * h
    pbytes = 3 * h if peep else 0
    if kernel == "lstm_fwd":
        ops = prod * (t - 1 if zero_init else t)
        out = t * nh4 + t * nh if workspace else nh
        nbytes = 4 * (t * nh4 + 4 * h * h + 4 * h + pbytes + 2 * nh
                      + t * nh + out)
    else:
        ops = prod * t
        nbytes = 4 * (t * nh4 + 2 * t * nh + nh + 4 * h * h + pbytes + nh
                      + t * nh4 + 2 * nh)
    ms, by, cores_ms = _floor(ops, nbytes, torch.float32)
    return ms, by, ops, nbytes, cores_ms


def phase_kernels_lstm(dev):
    """lstm_fwd and lstm_bwd against reference_lstm_fwd/_bwd on the same
    inputs (the backward on the kernel's own workspace); then timed at the
    training shape."""
    from deeplearning4j_tpu_torch.kernels.lstm_scan import (
        launch_plan,
        lstm_bwd_cuda,
        lstm_fwd_cuda,
        reference_lstm_bwd,
        reference_lstm_fwd,
    )

    results = {}
    for name, n, t, h, peep, fb, init, timed in LSTM_CASES:
        plan = launch_plan(n, h, dev)
        log(f"[kernels] lstm {name}: launch plan {plan}")
        xp, rw, b, h0, c0, pe, gh, gc = _lstm_inputs(dev, n, t, h, peep,
                                                     init, seed=n + t + h)
        got = lstm_fwd_cuda(xp, rw, b, h0, c0, pe, fb, save_workspace=True)
        want = reference_lstm_fwd(xp, rw, b, h0, c0, pe, fb,
                                  save_workspace=True)
        fwd_err = max(float((a - w).abs().max()) for a, w in zip(got, want))
        gates, cs = got[3], got[4]
        c_prev = torch.cat([c0[None], cs[:-1]])
        dgot = lstm_bwd_cuda(gates, cs, c0, gh, gc, rw, pe)
        dwant = reference_lstm_bwd(gates, cs, c_prev, gh, gc, rw, pe)
        torch.cuda.synchronize()
        bwd_abs = max(float((a - w).abs().max()) for a, w in zip(dgot,
                                                                 dwant))
        bwd_frac = max(float((a - w).abs().max())
                       / max(1.0, float(w.abs().max()))
                       for a, w in zip(dgot, dwant))
        finite = all(bool(torch.isfinite(a).all()) for a in (*got, *dgot))
        ok = fwd_err <= TOL_LSTM_FWD and bwd_frac <= TOL_LSTM_BWD and finite
        log(f"[kernels] lstm {name}: lstm_fwd max_abs_err {fwd_err:.3e} "
            f"(tol {TOL_LSTM_FWD:.0e}); lstm_bwd max_abs_err {bwd_abs:.3e}, "
            f"{bwd_frac:.3e} of max(1, |plain|) (tol {TOL_LSTM_BWD:.0e}); "
            f"finite={finite} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: LSTM kernel case {name} failed")
        row = {"shape": [n, t, h], "peepholes": peep, "forget_bias": fb,
               "init_state": init, "launch_plan": plan,
               "lstm_fwd_max_abs_err": fwd_err,
               "lstm_bwd_max_abs_err": bwd_abs,
               "lstm_bwd_max_err_frac": bwd_frac}
        if timed:
            row.update(_time_lstm(dev, xp, rw, b, h0, c0, pe, fb, gh, gc,
                                  gates, cs, plan["route"]))
            log(f"[kernels] lstm {name} ({plan['route']} route): lstm_fwd "
                f"{row['lstm_fwd_ms']:.4f} ms (device "
                f"{row['lstm_fwd_device_ms']:.4f}, bound "
                f"{row['lstm_fwd_bound_ms']:.4f} {row['lstm_fwd_bound_by']}"
                f" on the tensor cores, "
                f"{row['lstm_fwd_bound_cuda_cores_ms']:.4f} on the CUDA "
                f"cores; serving N=8 without workspace "
                f"{row['lstm_fwd_n8_ms']:.4f}), plain "
                f"{row['lstm_fwd_plain_ms']:.4f} ms; lstm_bwd "
                f"{row['lstm_bwd_ms']:.4f} ms (device "
                f"{row['lstm_bwd_device_ms']:.4f}, bound "
                f"{row['lstm_bwd_bound_ms']:.4f} "
                f"{row['lstm_bwd_bound_by']} on the tensor cores, "
                f"{row['lstm_bwd_bound_cuda_cores_ms']:.4f} on the CUDA "
                f"cores), plain {row['lstm_bwd_plain_ms']:.4f} ms")
            if not peep:
                n_in, t_in, width = LSTM_CUDNN_INPUT.get(
                    name, (CHAR_BATCH, CHAR_T, h))
                row.update(_time_cudnn(dev, rw, b, fb, n_in, t_in, width))
                row["cudnn_input"] = [n_in, t_in, width]
                log(f"[kernels] lstm {name} vs torch.nn.LSTM (cuDNN), input "
                    f"{n_in} x {t_in} x {width}: forward op "
                    f"{row['op_fwd_ms']:.4f}"
                    f" ms vs cuDNN {row['cudnn_fwd_ms']:.4f} ms; backward "
                    f"op {row['op_bwd_ms']:.4f} ms vs cuDNN "
                    f"{row['cudnn_bwd_ms']:.4f} ms; outputs agree to "
                    f"{row['cudnn_max_abs_err']:.3e}; serving N=8 forward: "
                    f"kernel {row['lstm_fwd_n8_ms']:.4f}, plain "
                    f"{row['lstm_fwd_n8_plain_ms']:.4f}, op "
                    f"{row['op_fwd_n8_ms']:.4f} vs cuDNN "
                    f"{row['cudnn_fwd_n8_ms']:.4f} ms")
            elif name in LSTM_LIBRARY_AT_SHAPE:
                row.update(_time_cudnn(dev, rw, b, fb, n, t, h,
                                       *((h0, c0) if init else ())))
                row["cudnn_input"] = [n, t, h]
                log(f"[kernels] lstm {name} beside torch.nn.LSTM (cuDNN, no "
                    f"peepholes, the case's h0/c0), input {n} x {t} x {h}: "
                    f"forward without workspace: kernel "
                    f"{row['lstm_fwd_no_ws_ms']:.4f} ms (bound "
                    f"{row['lstm_fwd_no_ws_bound_ms']:.4f}), plain "
                    f"{row['lstm_fwd_no_ws_plain_ms']:.4f}, op "
                    f"{row['op_fwd_ms']:.4f} vs cuDNN "
                    f"{row['cudnn_fwd_ms']:.4f} ms; backward op "
                    f"{row['op_bwd_ms']:.4f} vs cuDNN "
                    f"{row['cudnn_bwd_ms']:.4f} ms")
        results[name] = row
    return results


def _time_lstm(dev, xp, rw, b, h0, c0, pe, fb, gh, gc, gates, cs, route):
    """Both kernels and both plain versions by CUDA events (one call each
    in turn, twice: kernel, plain, plain, kernel), the kernels' device
    time (busy time) and launches a call from the profiler — on the
    resident route one persistent kernel a call, on the step route T
    forward and T + 1 backward, or the run fails — and the forward without
    the workspace (as inference runs it) at the case's N and at the
    serving bucket N=8, beside its plain version. On the resident route
    the profiler's count shows the route only (``_step_launches``'s
    ``route_only``)."""
    from deeplearning4j_tpu_torch.kernels.lstm_scan import (
        lstm_bwd_cuda,
        lstm_fwd_cuda,
        reference_lstm_bwd,
        reference_lstm_fwd,
    )

    t, n, h4 = xp.shape
    h = h4 // 4
    c_prev = torch.cat([c0[None], cs[:-1]])
    xp8, h08, c08 = (a[..., :8, :].contiguous() for a in (xp, h0, c0))
    fns = {
        "lstm_fwd": lambda: lstm_fwd_cuda(xp, rw, b, h0, c0, pe, fb,
                                          save_workspace=True),
        "lstm_fwd_plain": lambda: reference_lstm_fwd(
            xp, rw, b, h0, c0, pe, fb, save_workspace=True),
        "lstm_bwd": lambda: lstm_bwd_cuda(gates, cs, c0, gh, gc, rw, pe),
        "lstm_bwd_plain": lambda: reference_lstm_bwd(gates, cs, c_prev, gh,
                                                     gc, rw, pe),
        "lstm_fwd_n8": lambda: lstm_fwd_cuda(xp8, rw, b, h08, c08, pe, fb),
        "lstm_fwd_n8_plain": lambda: reference_lstm_fwd(xp8, rw, b, h08,
                                                        c08, pe, fb),
        "lstm_fwd_no_ws": lambda: lstm_fwd_cuda(xp, rw, b, h0, c0, pe, fb),
        "lstm_fwd_no_ws_plain": lambda: reference_lstm_fwd(xp, rw, b, h0,
                                                           c0, pe, fb),
    }
    runs = {k: [] for k in fns}
    for k in ("lstm_fwd", "lstm_fwd_plain", "lstm_fwd_plain", "lstm_fwd",
              "lstm_bwd", "lstm_bwd_plain", "lstm_bwd_plain", "lstm_bwd",
              "lstm_fwd_n8", "lstm_fwd_n8_plain", "lstm_fwd_n8_plain",
              "lstm_fwd_n8", "lstm_fwd_no_ws", "lstm_fwd_no_ws_plain",
              "lstm_fwd_no_ws_plain", "lstm_fwd_no_ws"):
        runs[k].append(_time_ms(fns[k], iters=10, warmup=2))
    row = {f"{k}_ms": min(v) for k, v in runs.items()}
    row.update({f"{k}_ms_runs": v for k, v in runs.items()})
    peep = pe is not None
    zero_init = not bool(h0.any())
    for kernel in ("lstm_fwd", "lstm_bwd"):
        # as the profiler counted them on the card: one persistent kernel
        # a call, or one step kernel per time step (and one more for dh0
        # backward)
        if route == "resident":
            name, want = f"{kernel}_persistent_kernel", 1
        else:
            name, want = f"{kernel}_step_kernel", t + (kernel == "lstm_bwd")
        spans = []
        launches, by_kernel, traces = _step_launches(
            fns[kernel], kernel, want, spans=spans, name=name,
            route_only=route == "resident")
        # busy time a call; where the profiler lost records, a recorded
        # launch's
        row[f"{kernel}_device_ms"] = (_busy_us(spans, f"{kernel}_", 5)
                                      / 1e3 * want / launches)
        row[f"{kernel}_route"] = route
        row[f"{kernel}_launches_per_call"] = launches
        row[f"{kernel}_launch_traces"] = traces
        row[f"{kernel}_device_by_kernel_us"] = {
            k[:60]: us for k, us in by_kernel.items()}
        bound_ms, bound_by, ops, nbytes, cores_ms = _lstm_bound(
            kernel, n, t, h, peep, zero_init)
        row.update({f"{kernel}_bound_ms": bound_ms,
                    f"{kernel}_bound_by": bound_by,
                    f"{kernel}_bound_cuda_cores_ms": cores_ms,
                    f"{kernel}_ops": ops, f"{kernel}_bytes": nbytes})
    n8 = _lstm_bound("lstm_fwd", 8, t, h, peep, zero_init, workspace=False)
    row["lstm_fwd_n8_bound_ms"] = n8[0]
    row["lstm_fwd_n8_bound_cuda_cores_ms"] = n8[4]
    no_ws = _lstm_bound("lstm_fwd", n, t, h, peep, zero_init,
                        workspace=False)
    row["lstm_fwd_no_ws_bound_ms"], row["lstm_fwd_no_ws_bound_by"] = no_ws[:2]
    return row


def _time_cudnn(dev, rw, b, fb, n=CHAR_BATCH, t=CHAR_T, width=None,
                h0=None, c0=None):
    """torch.nn.LSTM (cuDNN) on an input x [n, t, width] (width H by
    default) beside the port's op on the same x and weights (forget bias
    folded into b_ih's f slice, RW transposed to weight_hh, gate order
    i,f,g,o as the port's), forward without grad (also at the serving
    bucket N=8) and backward to x and every weight: the library yardstick
    of the case without peepholes. With ``h0``/``c0`` both start from that
    state. The outputs must agree."""
    from deeplearning4j_tpu_torch.kernels.lstm_scan import lstm
    from deeplearning4j_tpu_torch.ops.rnn import LSTMState

    h = rw.shape[0]
    width = width or h
    g = torch.Generator().manual_seed(7)
    x = torch.randn((n, t, width), generator=g).to(dev)
    w_x = ((2.0 / (width + 4 * h)) ** 0.5
           * torch.randn((width, 4 * h), generator=g)).to(dev)
    cudnn = torch.nn.LSTM(width, h, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_x.t())
        cudnn.weight_hh_l0.copy_(rw.t())
        bias = b.clone()
        bias[h:2 * h] += fb
        cudnn.bias_ih_l0.copy_(bias)
        cudnn.bias_hh_l0.zero_()
    state = None if h0 is None else (h0, c0)
    state8 = None if h0 is None else (h0[:8].contiguous(),
                                      c0[:8].contiguous())

    def op(inp, w_x, rw, b, st=state):
        return lstm(inp, w_x, rw, b, forget_bias=fb,
                    init_state=None if st is None else LSTMState(*st))

    def lib(inp, st=state):
        return cudnn(inp) if st is None else cudnn(
            inp, (st[0][None], st[1][None]))

    with torch.no_grad():
        err = float((lib(x)[0] - op(x, w_x, rw, b)[0]).abs().max())
    if err > 1e-4:
        raise SystemExit(f"chip_smoke: torch.nn.LSTM disagrees with the "
                         f"port's op by {err:.3e}: not the same function")
    leaves = [a.clone().requires_grad_() for a in (x, w_x, rw, b)]
    out_op = op(*leaves)[0]
    xg = x.clone().requires_grad_()
    out_lib = lib(xg)[0]
    dout = torch.randn(out_lib.shape, generator=g).to(dev)
    lib_leaves = [xg, *cudnn.parameters()]
    x8 = x[:8].contiguous()
    fns = {
        "op_fwd": lambda: op(x, w_x, rw, b),
        "cudnn_fwd": lambda: lib(x),
        "op_fwd_n8": lambda: op(x8, w_x, rw, b, state8),
        "cudnn_fwd_n8": lambda: lib(x8, state8),
        "op_bwd": lambda: torch.autograd.grad(out_op, leaves, dout,
                                              retain_graph=True),
        "cudnn_bwd": lambda: torch.autograd.grad(out_lib, lib_leaves, dout,
                                                 retain_graph=True),
    }
    runs = {k: [] for k in fns}
    with torch.no_grad():
        for k in ("op_fwd", "cudnn_fwd", "cudnn_fwd", "op_fwd",
                  "op_fwd_n8", "cudnn_fwd_n8", "cudnn_fwd_n8", "op_fwd_n8"):
            runs[k].append(_time_ms(fns[k], iters=10, warmup=2))
    for k in ("op_bwd", "cudnn_bwd", "cudnn_bwd", "op_bwd"):
        runs[k].append(_time_ms(fns[k], iters=10, warmup=2))
    row = {f"{k}_ms": min(v) for k, v in runs.items()}
    row.update({f"{k}_ms_runs": v for k, v in runs.items()})
    row["cudnn_max_abs_err"] = err
    return row


@contextlib.contextmanager
def _plain_rnn_guard(op="lstm"):
    """Records every call of the plain ops/rnn.<op> (lstm or gru) on a CUDA
    tensor: the recurrent main paths must make none (the kernels carry
    every recurrence)."""
    from deeplearning4j_tpu_torch.ops import rnn as opsrnn

    calls = []
    plain = getattr(opsrnn, op)

    def guarded(x, *args, **kwargs):
        if x.is_cuda:
            calls.append(tuple(x.shape))
        return plain(x, *args, **kwargs)

    with mock.patch.object(opsrnn, op, guarded):
        yield calls


@contextlib.contextmanager
def _gc_pauses():
    """Records (start, seconds, generation) of every Python garbage
    collection."""
    pauses, began = [], []

    def on_gc(phase, info):
        if phase == "start":
            began.append(time.monotonic())
        elif began:
            t = began.pop()
            pauses.append((t, time.monotonic() - t, info["generation"]))

    gc.callbacks.append(on_gc)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(on_gc)


def _char_rnn(dev, backend, updater=None):
    from deeplearning4j_tpu_torch.models.zoo.classic import (
        text_generation_lstm,
    )

    return text_generation_lstm(device=dev, vocab_size=CHAR_VOCAB,
                                hidden=CHAR_HIDDEN, seq_len=CHAR_T,
                                graves=True, backend=backend,
                                updater=updater, seed=SEED)


# -- 7. char-RNN serving ------------------------------------------------------

CHAR_REQUESTS = 400
# served next-char probabilities vs the same model with plain LSTMs,
# float32: two layers carry the kernels' ~1e-7 step differences over 256
# steps into a softmax over 77 characters.
TOL_CHAR_PROBS = 1e-5


def _char_request(i):
    r = np.random.default_rng(5000 + i)
    return r.integers(0, CHAR_VOCAB, (1 + i % 4, CHAR_T)).astype(np.int32)


def phase_charrnn_serving(dev, smi):
    from functools import partial

    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.models.zoo.classic import next_char_probs
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry,
        ModelServer,
        ServingClient,
        spec,
    )

    model = _char_rnn(dev, "pallas")
    variables = model.init()
    log(f"[char_serve] text_generation_lstm: {model.num_params(variables):,}"
        f" parameters on {dev}, seed {SEED}, layers {model.layer_names}")
    reg = ModelRegistry()
    entry = reg.register(
        "char_rnn", partial(next_char_probs, model), variables,
        input_spec=spec((CHAR_T,), np.int32, high=CHAR_VOCAB),
        mode="batched", max_batch_size=8)
    server = ModelServer(reg, port=0)
    t0 = time.monotonic()
    server.start(warm=True)
    client = ServingClient(server.url, timeout=120)
    if not client.ready()["ready"]:
        raise SystemExit("chip_smoke: /readyz not ready after warm start")
    log(f"[char_serve] server warm and ready in {time.monotonic() - t0:.2f}"
        f" s (buckets {sorted(entry.batch_stats().items())})")

    requests = [_char_request(i) for i in range(CHAR_REQUESTS)]
    latencies = [0.0] * CHAR_REQUESTS
    starts = [0.0] * CHAR_REQUESTS

    def call(i):
        t_start = time.monotonic()
        resp = client.predict("char_rnn", requests[i])
        latencies[i] = time.monotonic() - t_start
        starts[i] = t_start
        return resp

    with _plain_rnn_guard() as plain_calls, _gc_pauses() as pauses:
        _dispatch.reset_launch_counts()
        before = entry.batch_stats()
        t0 = time.monotonic()
        with ThreadPoolExecutor(CLIENT_THREADS) as pool:
            responses = list(pool.map(call, range(CHAR_REQUESTS)))
        wall = time.monotonic() - t0
        counts = _dispatch.launch_counts()
        after = entry.batch_stats()
    batches = after["batches"] - before["batches"]
    rows = after["rows"] - before["rows"]
    drained = server.stop()
    log(f"[char_serve] {CHAR_REQUESTS} requests ({rows} rows) in "
        f"{wall:.3f} s over {batches} batches; launches {counts}; plain "
        f"ops/rnn.lstm calls on the card {len(plain_calls)}; "
        f"drained={drained}")
    if batches < 1 or counts != {"lstm_fwd": 2 * batches} or plain_calls:
        raise SystemExit(f"chip_smoke: {counts} for {batches} batches and "
                         f"{len(plain_calls)} plain LSTM calls; want 2 "
                         f"lstm_fwd per batch and none")
    if not drained:
        raise SystemExit("chip_smoke: server did not drain on stop")

    # every response against the same model with plain LSTMs, all rows
    # in one batch
    got = [np.asarray(r["outputs"], np.float64) for r in responses]
    for req, out in zip(requests, got):
        if out.shape != (req.shape[0], CHAR_VOCAB) or not np.all(
                np.isfinite(out)) or np.abs(out.sum(-1) - 1).max() > 1e-5:
            raise SystemExit(f"chip_smoke: bad served output {out}")
    all_ids = torch.from_numpy(np.concatenate(requests)).to(dev)
    want = next_char_probs(_char_rnn(dev, "plain"), variables,
                           all_ids).double().cpu().numpy()
    worst = float(np.abs(np.concatenate(got) - want).max())
    ids8 = all_ids[:8]
    breakdown = _forward_breakdown(
        lambda: next_char_probs(model, variables, ids8), "lstm_fwd")
    log(f"[char_serve] one bucket-8 forward: {breakdown}")
    log(f"[char_serve] served next-char probabilities vs plain LSTMs: "
        f"max_abs_err {worst:.3e} (tol {TOL_CHAR_PROBS:.0e}) over "
        f"{all_ids.shape[0]} rows")
    if worst > TOL_CHAR_PROBS:
        raise SystemExit("chip_smoke: served char-RNN outputs disagree with "
                         "plain LSTMs")
    lat_ms = np.asarray(latencies) * 1e3
    # The tail: which requests were slow, when they started, and the
    # garbage collections that ran meanwhile.
    slowest = [{"request": int(i), "start_ms": (starts[i] - t0) * 1e3,
                "latency_ms": float(lat_ms[i])}
               for i in np.argsort(lat_ms)[::-1][:6]]
    gc_long = max(((d * 1e3, g, (st - t0) * 1e3) for st, d, g in pauses),
                  default=(0.0, None, 0.0))
    log(f"[char_serve] slowest requests (index, start after t0 ms, "
        f"latency ms): " + "; ".join(
            f"{r['request']}, {r['start_ms']:.1f}, {r['latency_ms']:.1f}"
            for r in slowest)
        + f"; {len(pauses)} garbage collections, longest {gc_long[0]:.2f} "
        f"ms (generation {gc_long[1]}, start after t0 {gc_long[2]:.1f} ms)")
    log(f"[char_serve] {CHAR_REQUESTS / wall:.1f} requests/s "
        f"({rows / wall:.1f} rows/s), p50 {np.percentile(lat_ms, 50):.2f} "
        f"ms, p99 {np.percentile(lat_ms, 99):.2f} ms over {CHAR_REQUESTS} "
        f"requests, {CLIENT_THREADS} clients, on {smi}")
    return {"model": "text_generation_lstm", "vocab": CHAR_VOCAB,
            "hidden": CHAR_HIDDEN, "seq_len": CHAR_T,
            "requests": CHAR_REQUESTS, "rows": rows,
            "client_threads": CLIENT_THREADS, "batches": batches,
            "lstm_fwd_launches": counts["lstm_fwd"],
            "requests_per_s": CHAR_REQUESTS / wall,
            "rows_per_s": rows / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "max_abs_err_probs": worst, "forward_bucket8": breakdown,
            "slowest_requests": slowest, "gc_pauses": len(pauses),
            "gc_longest_ms": gc_long[0], "card": smi}


# -- 8. char-RNN training -----------------------------------------------------

CHAR_LR = 1e-3
CHAR_PERIOD = 16        # the synthetic text repeats a random 16-char string
CHAR_TRAIN_BATCHES = 10
CHAR_EPOCHS = 3         # 30 steps
# The loss starts near ln(77) = 4.34; learning the text's 16 characters
# alone takes it towards ln(16) = 2.77 (4.34 -> 2.78 over these 30 steps
# on the CPU's plain path). The mean of the last three steps must lie at
# least this far below the first three's.
LOSS_FALL = 1.0


def _text_windows(vocab, batch, t_len):
    """CHAR_TRAIN_BATCHES arrays of char ids [batch, t_len + 1]: a random
    string of CHAR_PERIOD chars from the seed, repeated, each row a window
    shifted by its row and batch."""
    r = np.random.default_rng(SEED)
    base = r.integers(0, vocab, CHAR_PERIOD)
    text = np.tile(base, (t_len + 1) // CHAR_PERIOD + 2)
    out = []
    for b in range(CHAR_TRAIN_BATCHES):
        offs = (np.arange(batch) * 7 + b * 13) % CHAR_PERIOD
        out.append(np.stack([text[o:o + t_len + 1] for o in offs]))
    return out


def _char_batches():
    """The char-RNN's batches: one-hot chars of the synthetic text, labels
    the next chars."""
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    return [{"features": eye[ids[:, :-1]], "labels": eye[ids[:, 1:]]}
            for ids in _text_windows(CHAR_VOCAB, CHAR_BATCH, CHAR_T)]


def phase_charrnn_train(dev, smi):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    model = _char_rnn(dev, "pallas", Adam(CHAR_LR))
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    on_dev = [batch_to_device(b, dev) for b in _char_batches()]
    log(f"[char_train] text_generation_lstm: "
        f"{model.num_params(trainer.variables(ts0)):,}"
        f" parameters, Adam({CHAR_LR}), batches {CHAR_BATCH}x{CHAR_T} "
        f"one-hot of {CHAR_VOCAB}")

    # 1. one loss and gradient, kernels vs plain LSTMs (backend "plain")
    with _plain_rnn_guard() as plain_calls:
        _dispatch.reset_launch_counts()
        loss_k, g_kernel = _loss_and_grads(trainer, ts0.params, on_dev[0],
                                           dev, SEED)
        counts = _dispatch.launch_counts()
    want = {"lstm_fwd": 2, "lstm_bwd": 2}
    if counts != want or plain_calls:
        raise SystemExit(f"chip_smoke: one loss+grad launched {counts} and "
                         f"made {len(plain_calls)} plain LSTM calls; want "
                         f"{want} and none")
    plain_trainer = Trainer(_char_rnn(dev, "plain", Adam(CHAR_LR)))
    loss_p, g_plain = _loss_and_grads(plain_trainer, ts0.params, on_dev[0],
                                      dev, SEED)
    loss_rel, worst_name, worst = _check_grads("char_train", loss_k, loss_p,
                                               g_kernel, g_plain)
    del g_kernel, g_plain

    # 2. Trainer.fit, 30 steps; 3. checkpoint restore
    with _plain_rnn_guard() as plain_calls:
        fit = _fit_and_restore("char_train", trainer, ts0, on_dev,
                               CHAR_EPOCHS, dev)
    ts, counts, losses = fit["ts"], fit["launches"], fit["losses"]
    n_steps = CHAR_TRAIN_BATCHES * CHAR_EPOCHS
    want = {"lstm_fwd": 2 * n_steps, "lstm_bwd": 2 * n_steps}
    if ts.step != n_steps or counts != want or plain_calls:
        raise SystemExit(f"chip_smoke: fit launched {counts} over {ts.step}"
                         f" steps with {len(plain_calls)} plain LSTM calls; "
                         f"want {want} and none")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    log(f"[char_train] loss {first:.4f} (first 3 steps) -> {last:.4f} "
        f"(last 3), fall {first - last:.4f} (must be >= {LOSS_FALL})")
    if not (np.all(np.isfinite(losses)) and first - last >= LOSS_FALL):
        raise SystemExit("chip_smoke: the char-RNN's loss did not fall by "
                         f"{LOSS_FALL}")

    # 4. where one step's time goes
    breakdown = _step_breakdown(trainer, ts, on_dev[0],
                                ("lstm_fwd", "lstm_bwd"))
    log(f"[char_train] one step: {breakdown}")
    step_ms = fit["median_step_ms"]
    tokens = CHAR_BATCH * CHAR_T
    log(f"[char_train] median step {step_ms:.2f} ms, "
        f"{tokens / (step_ms / 1e3):,.0f} tokens/s, peak memory "
        f"{fit['peak_memory_gib']:.2f} GiB, on {smi}")
    return {
        "model": "text_generation_lstm", "vocab": CHAR_VOCAB,
        "hidden": CHAR_HIDDEN, "batch": CHAR_BATCH, "seq_len": CHAR_T,
        "steps": ts.step, "launches": counts, "losses": losses,
        "loss_first3": first, "loss_last3": last,
        "median_step_ms": step_ms, "step_ms_gaps": fit["step_ms_gaps"],
        "tokens_per_s": tokens / (step_ms / 1e3),
        "peak_memory_gib": fit["peak_memory_gib"],
        "fit_seconds": fit["fit_seconds"],
        "kernel_vs_plain": {"loss_kernel": loss_k, "loss_plain": loss_p,
                            "loss_rel": loss_rel,
                            "worst_grad_leaf": worst_name,
                            "worst_grad_frac": worst},
        "checkpoint_next_loss": fit["checkpoint_next_loss"],
        "step_breakdown": breakdown, "card": smi,
    }


# -- 21. char-RNN by truncated BPTT -------------------------------------------

# kernels vs the plain route over one batch, window by window from the same
# variables: each window's loss to TOL_LOSS_REL relative and each carry
# handed on to TOL_CARRY of its max |plain|. After the batch the params:
# the two routes' gradients differ by ~1e-6 of a leaf's max (the 3xTF32
# products; 1.29e-6 measured on the char-RNN), which Adam, m/sqrt(v) per
# entry, turns into a difference of lr · 1e-6 · max / |g| in an entry's
# step. So every entry whose plain gradient stays above TOL_ADAM_FLOOR of
# its leaf's max in every window is held to TOL_ADAM_STEP of one Adam step
# (lr); the others (gradients near 0, whose sign the two routes may take
# differently) to 2·lr per window. A skipped or misdirected update moves
# the held entries by ~lr.
TOL_CARRY = 1e-5
TOL_ADAM_FLOOR = 1e-3
TOL_ADAM_STEP = 0.1
CHAR_TBPTT_EPOCHS = 3   # 10 batches, 30 batches of 6 windows: 180 updates


def _tbptt_windows(batch, length):
    """A batch cut into its TBPTT windows as the Trainer cuts it."""
    from deeplearning4j_tpu_torch.train.trainer import _is_time_distributed

    t_len = batch["features"].shape[1]
    bounds = list(range(0, t_len, length)) + [t_len]
    return [{k: v[:, lo:hi] if _is_time_distributed(k, v, t_len) else v
             for k, v in batch.items()}
            for lo, hi in zip(bounds, bounds[1:])]


def _run_windows(trainer, ts, windows, grads=None):
    """The windows one update each from zero carries → (ts, losses,
    carries handed on after each window); ``grads`` collects each
    window's gradient."""
    finish = trainer._finish_step

    def record(ts, g, *a):
        grads.append(g)
        return finish(ts, g, *a)

    carries = trainer._zero_carries(ts, windows[0]["features"])
    losses, handed = [], []
    with (mock.patch.object(trainer, "_finish_step", record)
          if grads is not None else contextlib.nullcontext()):
        for wb in windows:
            ts, carries, m = trainer.train_step_tbptt(ts, wb, carries)
            losses.append(float(m["total_loss"]))
            handed.append(carries)
    return ts, losses, handed


def _tbptt_vs_plain(tag, trainer, plain_trainer, ts0, batch, op, want,
                    lr) -> dict:
    """One batch by TBPTT, window by window, through the kernels and
    through the plain route (``backend="plain"``) from the same TrainState:
    the kernel launches (``want``), each window's loss, the carries handed
    on and the params after the batch (see TOL_ADAM_STEP)."""
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

    windows = _tbptt_windows(batch, trainer.net.tbptt_length)
    with _plain_rnn_guard(op) as plain_calls:
        _dispatch.reset_launch_counts()
        ts_k, loss_k, carry_k = _run_windows(trainer, ts0, windows)
        counts = _dispatch.launch_counts()
    if counts != want or plain_calls:
        raise SystemExit(f"chip_smoke: one TBPTT batch launched {counts} "
                         f"with {len(plain_calls)} plain {op} calls; want "
                         f"{want} and none")
    grads = []
    ts_p, loss_p, carry_p = _run_windows(plain_trainer, ts0, windows, grads)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_k, loss_p))
    carry_frac = 0.0
    for ck, cp in zip(carry_k, carry_p):
        for (n, a), (_, w) in zip(flatten_with_names(ck),
                                  flatten_with_names(cp)):
            carry_frac = max(carry_frac, float((a - w).abs().max())
                             / float(w.abs().max()))
    g_named = [dict(flatten_with_names(g)) for g in grads]
    held_err = free_err = 0.0
    n_free = n_all = 0
    kernel_params = dict(flatten_with_names(ts_k.params))
    for n, w in flatten_with_names(ts_p.params):
        got = kernel_params[n]
        held = torch.ones_like(w, dtype=torch.bool)
        for g in g_named:
            held &= g[n].abs() >= TOL_ADAM_FLOOR * g[n].abs().max()
        err = (got - w).abs()
        held_err = max(held_err, float(err[held].max()) if held.any()
                       else 0.0)
        free_err = max(free_err, float(err.max()))
        n_free += int((~held).sum())
        n_all += w.numel()
    ok = (loss_rel <= TOL_LOSS_REL and carry_frac <= TOL_CARRY
          and held_err <= TOL_ADAM_STEP * lr
          and free_err <= 2 * lr * len(windows))
    log(f"[{tag}] one batch, {len(windows)} windows "
        f"({[w['features'].shape[1] for w in windows]} steps), kernels vs "
        f"plain: launches {counts}; losses {[round(x, 6) for x in loss_k]} "
        f"vs {[round(x, 6) for x in loss_p]} (worst rel {loss_rel:.2e}, tol "
        f"{TOL_LOSS_REL:.0e}); carries handed on to {carry_frac:.2e} of "
        f"their max (tol {TOL_CARRY:.0e}); params after the batch: "
        f"{n_all - n_free} entries whose gradient stays above "
        f"{TOL_ADAM_FLOOR:.0e} of their leaf's max to {held_err:.3e} (tol "
        f"{TOL_ADAM_STEP * lr:.0e}), the other {n_free} "
        f"({n_free / n_all:.2%}) to {free_err:.3e} (tol "
        f"{2 * lr * len(windows):.0e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {tag}: the kernel route's TBPTT "
                         "batch disagrees with the plain route")
    return {"windows": [w["features"].shape[1] for w in windows],
            "launches_per_batch": counts, "losses_kernel": loss_k,
            "losses_plain": loss_p, "loss_rel": loss_rel,
            "carry_err_frac": carry_frac, "param_err_held": held_err,
            "param_err_all": free_err, "param_near_zero_grad_share":
                n_free / n_all, "ts": ts_k}


def _with_tbptt(model, length):
    """The model with net.backprop_type "tbptt" and ``length``."""
    from deeplearning4j_tpu_torch.nn.model import SequentialModel

    cfg = dataclasses.replace(model.config, net=dataclasses.replace(
        model.config.net, backprop_type="tbptt", tbptt_length=length))
    return SequentialModel(cfg, device=model.device)


def _tbptt_batch_step(trainer):
    """(ts, batch) → (ts, the last window's metrics): one TBPTT batch, the
    step ``_fit_and_restore`` continues with."""
    def step(ts, batch):
        ts, wmetrics = trainer._fit_tbptt_batch(ts, batch)
        return ts, wmetrics[-1]

    return step


def phase_charrnn_tbptt(dev, smi):
    """Returns the phase's line, the kernel route's model and its trained
    variables (for phase 22)."""
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    t0 = time.monotonic()
    model = _with_tbptt(_char_rnn(dev, "pallas", Adam(CHAR_LR)), CHAR_TBPTT)
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    on_dev = [batch_to_device(b, dev) for b in _char_batches()]
    n_win = -(-CHAR_T // CHAR_TBPTT)
    log(f"[char_tbptt] text_generation_lstm by truncated BPTT, "
        f"tbptt_length {CHAR_TBPTT} over T={CHAR_T}: {n_win} windows a "
        f"batch of {CHAR_BATCH}, Adam({CHAR_LR})")

    # 1. one batch, kernels vs plain, window by window
    plain = Trainer(_with_tbptt(_char_rnn(dev, "plain", Adam(CHAR_LR)),
                                CHAR_TBPTT))
    want = {"lstm_fwd": 2 * n_win, "lstm_bwd": 2 * n_win}
    vs_plain = _tbptt_vs_plain("char_tbptt", trainer, plain, ts0, on_dev[0],
                               "lstm", want, CHAR_LR)
    ts_loop = vs_plain.pop("ts")
    ts_fit, _ = trainer._fit_tbptt_batch(ts0, on_dev[0])
    same_fit = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(ts_fit.params), tree_leaves(ts_loop.params)))
    # the persistent kernels per batch, as the profiler counts them
    prof = {}
    for kernel in ("lstm_fwd", "lstm_bwd"):
        prof[kernel] = _step_launches(
            lambda: trainer._fit_tbptt_batch(ts0, on_dev[0]), kernel,
            2 * n_win, name=f"{kernel}_persistent_kernel",
            route_only=True)[0]

    # 2. tbptt_length >= T: one window, the standard step's params
    whole = Trainer(_with_tbptt(model, CHAR_T))
    ts_w, wm = whole._fit_tbptt_batch(ts0, on_dev[0])
    std = Trainer(_char_rnn(dev, "pallas", Adam(CHAR_LR)))
    ts_s, m_s = std.train_step(ts0, on_dev[0])
    whole_diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(ts_w.params), tree_leaves(ts_s.params)))
    log(f"[char_tbptt] the fit's windows give the loop's params bit-equal="
        f"{same_fit}; profiler: {prof} persistent kernels a batch; "
        f"tbptt_length {CHAR_T} (one window): loss "
        f"{float(wm[0]['total_loss']):.6f} vs the standard step's "
        f"{float(m_s['total_loss']):.6f}, params max diff {whole_diff:.3e}")
    if len(wm) != 1 or whole_diff != 0.0 or not same_fit:
        raise SystemExit("chip_smoke: one window over the whole sequence is "
                         "not the standard step, or the fit's windows not "
                         "the loop's")
    del plain, whole, std, ts_w, ts_s, ts_fit, ts_loop

    # 3. Trainer.fit, 30 batches (180 windows), checkpoint restore
    with _plain_rnn_guard() as plain_calls:
        fit = _fit_and_restore("char_tbptt", trainer, ts0, on_dev,
                               CHAR_TBPTT_EPOCHS, dev, per_batch=n_win,
                               step=_tbptt_batch_step(trainer))
    ts, counts, losses = fit["ts"], fit["launches"], fit["losses"]
    n_batches = CHAR_TRAIN_BATCHES * CHAR_TBPTT_EPOCHS
    want = {k: v * n_batches for k, v in want.items()}
    if (ts.step != n_win * n_batches or len(losses) != n_win * n_batches
            or counts != want or plain_calls):
        raise SystemExit(f"chip_smoke: fit made {len(losses)} iterations, "
                         f"step {ts.step}, launches {counts}, "
                         f"{len(plain_calls)} plain LSTM calls; want "
                         f"{n_win} a batch, {want} and none")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    log(f"[char_tbptt] {len(losses)} listener callbacks over {n_batches} "
        f"batches ({n_win} a batch); loss {first:.4f} (first 3 windows) -> "
        f"{last:.4f} (last 3), fall {first - last:.4f} (must be >= "
        f"{LOSS_FALL})")
    if not (np.all(np.isfinite(losses)) and first - last >= LOSS_FALL):
        raise SystemExit("chip_smoke: the TBPTT char-RNN's loss did not "
                         f"fall by {LOSS_FALL}")

    # 4. where one window's time goes: the second window, from the carries
    # the first left
    w = _tbptt_windows(on_dev[0], CHAR_TBPTT)
    _, carries, _ = trainer.train_step_tbptt(
        ts, w[0], trainer._zero_carries(ts, w[0]["features"]))
    breakdown = _step_breakdown(
        trainer, ts, None, ("lstm_fwd", "lstm_bwd"),
        step=lambda: trainer.train_step_tbptt(ts, w[1], carries))
    log(f"[char_tbptt] one window ({CHAR_TBPTT} steps): {breakdown}")
    batch_ms = fit["median_step_ms"]
    tokens = CHAR_BATCH * CHAR_T
    log(f"[char_tbptt] median batch {batch_ms:.2f} ms ({n_win} windows), "
        f"{n_win / (batch_ms / 1e3):,.1f} windows/s, "
        f"{tokens / (batch_ms / 1e3):,.0f} tokens/s, peak memory "
        f"{fit['peak_memory_gib']:.2f} GiB, phase "
        f"{time.monotonic() - t0:.1f} s, on {smi}")
    return {
        "model": "text_generation_lstm", "backprop_type": "tbptt",
        "tbptt_length": CHAR_TBPTT, "vocab": CHAR_VOCAB,
        "hidden": CHAR_HIDDEN, "batch": CHAR_BATCH, "seq_len": CHAR_T,
        "windows_per_batch": n_win, "batches": n_batches,
        "steps": ts.step, "launches": counts,
        "profiler_launches_per_batch": prof, "kernel_vs_plain": vs_plain,
        "whole_sequence_window_vs_standard_max_diff": whole_diff,
        "listener_callbacks": len(losses), "losses": losses,
        "loss_first3": first, "loss_last3": last,
        "median_batch_ms": batch_ms, "batch_ms_gaps": fit["step_ms_gaps"],
        "windows_per_s": n_win / (batch_ms / 1e3),
        "tokens_per_s": tokens / (batch_ms / 1e3),
        "peak_memory_gib": fit["peak_memory_gib"],
        "fit_seconds": fit["fit_seconds"],
        "checkpoint_next_loss": fit["checkpoint_next_loss"],
        "window_breakdown": breakdown, "phase_seconds":
            time.monotonic() - t0, "card": smi,
    }, model, trainer.variables(ts)


# -- 22. char-RNN sampling: rnnTimeStep and generate ---------------------------

GEN_STEPS, GEN_BATCH, GEN_CHARS = 256, 8, 200
GEN_TEMPERATURE = 0.3


def _carry_frac(got, want) -> float:
    """max |got - plain| over the carries, as a fraction of max |plain|."""
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    return max(float((a - w).abs().max()) / float(w.abs().max())
               for a, w in zip(tree_leaves(got), tree_leaves(want)))


def phase_charrnn_generate(dev, smi, model, variables):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.nn.generation import (
        RnnTimeStepper,
        generate,
    )

    t_phase = time.monotonic()
    plain = _char_rnn(dev, "plain")
    ids = torch.from_numpy(_text_windows(
        CHAR_VOCAB, CHAR_BATCH, CHAR_PRIME + GEN_STEPS)[3]).to(dev)
    eye = torch.eye(CHAR_VOCAB, device=dev)
    x = eye[ids[:, :-1]]

    # 1. the prime: one sweep a layer, against plain stepping
    stepper = RnnTimeStepper(model, variables)
    with _plain_rnn_guard() as plain_calls:
        _dispatch.reset_launch_counts()
        out = stepper.time_step(x[:, :CHAR_PRIME])
        torch.cuda.synchronize()
        prime_counts = _dispatch.launch_counts()
    ref = RnnTimeStepper(plain, variables)
    for t in range(CHAR_PRIME):
        out_p = ref.time_step(x[:, t])
    carry_err = _carry_frac(stepper.carries, ref.carries)
    prime_err = float((out - out_p).abs().max())
    log(f"[char_gen] RnnTimeStepper prime of {CHAR_PRIME} chars at N="
        f"{CHAR_BATCH}: launches {prime_counts}, plain LSTM calls "
        f"{len(plain_calls)}; carries vs {CHAR_PRIME} plain steps to "
        f"{carry_err:.2e} of their max (tol {TOL_CARRY:.0e}), "
        f"probabilities to {prime_err:.2e} (tol {TOL_CHAR_PROBS:.0e})")
    if (prime_counts != {"lstm_fwd": 2} or plain_calls
            or carry_err > TOL_CARRY or prime_err > TOL_CHAR_PROBS):
        raise SystemExit("chip_smoke: the rnnTimeStep prime did not run one "
                         "lstm_fwd a layer or disagrees with plain stepping")

    # 2. single steps: plain torch ops (the cells), no sweep
    _dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(CHAR_PRIME, CHAR_PRIME + GEN_STEPS):
        out = stepper.time_step(x[:, t])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_counts = _dispatch.launch_counts()
    want = plain.output(variables, x)[:, -1]
    step_err = float((out - want).abs().max())
    log(f"[char_gen] {GEN_STEPS} single steps at N={CHAR_BATCH}: "
        f"{step_s * 1e3 / GEN_STEPS:.3f} ms a step, "
        f"{CHAR_BATCH * GEN_STEPS / step_s:,.0f} chars/s; launches "
        f"{step_counts}; the last step's probabilities vs the plain full "
        f"forward over all {CHAR_PRIME + GEN_STEPS} chars: {step_err:.2e} "
        f"(tol {TOL_CHAR_PROBS:.0e})")
    if step_counts or step_err > TOL_CHAR_PROBS:
        raise SystemExit("chip_smoke: rnnTimeStep's single steps disagree "
                         "with the full forward")

    # 3. greedy generate: every id the full forward's argmax
    prime = ids[:GEN_BATCH, :CHAR_PRIME]
    generate(model, variables, n_steps=4, rng=SEED, prime=prime,
             temperature=0.0, batch_size=GEN_BATCH)  # warm-up
    with _plain_rnn_guard() as plain_calls:
        _dispatch.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy = generate(model, variables, n_steps=GEN_CHARS, rng=SEED,
                          prime=prime, temperature=0.0,
                          batch_size=GEN_BATCH)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_counts = _dispatch.launch_counts()
    seq = torch.cat([prime, greedy.long()], dim=1)
    probs = plain.output(variables, eye[seq[:, :-1]])[:, CHAR_PRIME - 1:]
    lg = torch.log(probs.double())
    picked = lg.gather(2, greedy.long()[..., None])[..., 0]
    gap = (lg.max(-1).values - picked).cpu().numpy()
    ties, worst_gap = int(np.sum(gap > 0)), float(gap.max())
    log(f"[char_gen] greedy generate of {GEN_CHARS} chars at batch "
        f"{GEN_BATCH}: {gen_s:.3f} s, {GEN_BATCH * GEN_CHARS / gen_s:,.0f} "
        f"chars/s; launches {gen_counts}, plain LSTM calls "
        f"{len(plain_calls)}; {gap.size} ids against the plain full "
        f"forward's argmax: {ties} ties within {TOL_GREEDY_TIE:.0e} (worst "
        f"gap {worst_gap:.3e})")
    if (gen_counts != {"lstm_fwd": 2} or plain_calls
            or worst_gap > TOL_GREEDY_TIE or greedy.shape != (GEN_BATCH,
                                                             GEN_CHARS)):
        raise SystemExit("chip_smoke: greedy generation is not the full "
                         "forward's argmax, or its prime did not run one "
                         "lstm_fwd a layer")

    # 4. sampled generate: the same generator seed gives the same ids
    sampled = [generate(model, variables, n_steps=GEN_CHARS, rng=SEED + 1,
                        prime=prime, temperature=GEN_TEMPERATURE,
                        batch_size=GEN_BATCH) for _ in range(2)]
    same = torch.equal(*sampled)
    in_range = bool(((sampled[0] >= 0) & (sampled[0] < CHAR_VOCAB)).all())
    differs = int((sampled[0] != greedy).sum())
    log(f"[char_gen] sampled generate (temperature {GEN_TEMPERATURE}, seed "
        f"{SEED + 1}) twice: identical={same}, ids in range={in_range}, "
        f"{differs} of {greedy.numel()} ids differ from the greedy ones; "
        f"phase {time.monotonic() - t_phase:.1f} s, on {smi}")
    if not (same and in_range):
        raise SystemExit("chip_smoke: sampled generation does not follow "
                         "its seed")
    return {"model": "text_generation_lstm", "prime_chars": CHAR_PRIME,
            "prime_batch": CHAR_BATCH, "prime_launches": prime_counts,
            "prime_carry_err_frac": carry_err,
            "prime_probs_max_abs_err": prime_err,
            "single_steps": GEN_STEPS,
            "single_step_ms": step_s * 1e3 / GEN_STEPS,
            "single_step_chars_per_s": CHAR_BATCH * GEN_STEPS / step_s,
            "single_step_probs_max_abs_err": step_err,
            "greedy_chars": GEN_CHARS, "greedy_batch": GEN_BATCH,
            "greedy_seconds": gen_s,
            "greedy_chars_per_s": GEN_BATCH * GEN_CHARS / gen_s,
            "greedy_launches": gen_counts, "greedy_ties": ties,
            "greedy_worst_gap": worst_gap,
            "sampled_identical": same, "sampled_differs_from_greedy": differs,
            "phase_seconds": time.monotonic() - t_phase, "card": smi}


# -- 23. char-GRU by truncated BPTT --------------------------------------------

GRU_TBPTT_TIMED = 5  # batches timed after one warm-up


def _char_gru_onehot(dev, backend, updater=None):
    """The char-GRU for truncated BPTT: one-hot chars [N, T, 66] through a
    bias-free Dense(66 → 256), the embedding as a product, then GRU(1024)
    and the softmax head, tbptt_length GRU_TBPTT. Truncated BPTT splits
    features of rank >= 3 only, in both packages, so the Embedding's int
    ids [N, T] are refused (``_fit_tbptt_batch``)."""
    from deeplearning4j_tpu_torch.nn.config import (
        NeuralNetConfiguration,
        SequentialConfig,
    )
    from deeplearning4j_tpu_torch.nn.layers import GRU, Dense, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.model import SequentialModel

    cfg = SequentialConfig(
        net=NeuralNetConfiguration(seed=SEED, updater=updater,
                                   weight_init="xavier",
                                   backprop_type="tbptt",
                                   tbptt_length=GRU_TBPTT),
        layers=[Dense(units=GRU_EMBED, use_bias=False),
                GRU(units=GRU_HIDDEN, backend=backend),
                RnnOutputLayer(units=GRU_VOCAB, activation="softmax",
                               loss="mcxent")],
        input_shape=(GRU_T, GRU_VOCAB))
    return SequentialModel(cfg, device=dev)


def phase_gru_tbptt(dev, smi):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    t0 = time.monotonic()
    model = _char_gru_onehot(dev, "pallas", Adam(GRU_LR))
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    eye = np.eye(GRU_VOCAB, dtype=np.float32)
    on_dev = [batch_to_device(dict(b, features=eye[b["features"]]), dev)
              for b in _gru_batches()[:1 + GRU_TBPTT_TIMED]]
    n_win = GRU_T // GRU_TBPTT
    log(f"[gru_tbptt] char-GRU (one-hot → Dense 256 → GRU {GRU_HIDDEN}) by "
        f"truncated BPTT, tbptt_length {GRU_TBPTT} over T={GRU_T}: {n_win} "
        f"windows a batch of {GRU_BATCH}, "
        f"{model.num_params(trainer.variables(ts0)):,} parameters")
    plain = Trainer(_char_gru_onehot(dev, "plain", Adam(GRU_LR)))
    want = {"gru_fwd": n_win, "gru_bwd": n_win}
    vs_plain = _tbptt_vs_plain("gru_tbptt", trainer, plain, ts0, on_dev[0],
                               "gru", want, GRU_LR)
    ts = vs_plain.pop("ts")
    del plain
    with _plain_rnn_guard("gru") as plain_calls:
        _dispatch.reset_launch_counts()
        ts, _ = trainer._fit_tbptt_batch(ts, on_dev[1])  # warm-up
        gaps = []
        for b in on_dev[1:]:
            torch.cuda.synchronize()
            t_b = time.perf_counter()
            ts, wm = trainer._fit_tbptt_batch(ts, b)
            torch.cuda.synchronize()
            gaps.append((time.perf_counter() - t_b) * 1e3)
        counts = _dispatch.launch_counts()
    n_b = 1 + len(gaps)
    if counts != {k: v * n_b for k, v in want.items()} or plain_calls:
        raise SystemExit(f"chip_smoke: {n_b} TBPTT batches launched "
                         f"{counts} with {len(plain_calls)} plain GRU "
                         f"calls; want {want} a batch and none")
    losses = [float(m["total_loss"]) for m in wm]
    batch_ms = float(np.median(gaps))
    tokens = GRU_BATCH * GRU_T
    log(f"[gru_tbptt] {n_b} batches, launches {counts}; {len(gaps)} timed: "
        f"median {batch_ms:.2f} ms "
        f"({n_win} windows), {n_win / (batch_ms / 1e3):,.1f} windows/s, "
        f"{tokens / (batch_ms / 1e3):,.0f} tokens/s; the last batch's "
        f"window losses {[round(x, 4) for x in losses]}; phase "
        f"{time.monotonic() - t0:.1f} s, on {smi}")
    if not np.all(np.isfinite(losses)):
        raise SystemExit("chip_smoke: the TBPTT char-GRU's loss is not "
                         "finite")
    return {"model": "char_gru_onehot", "backprop_type": "tbptt",
            "tbptt_length": GRU_TBPTT, "hidden": GRU_HIDDEN,
            "batch": GRU_BATCH, "seq_len": GRU_T,
            "windows_per_batch": n_win, "batches": n_b, "launches": counts,
            "kernel_vs_plain": vs_plain, "median_batch_ms": batch_ms,
            "batch_ms": gaps, "windows_per_s": n_win / (batch_ms / 1e3),
            "tokens_per_s": tokens / (batch_ms / 1e3),
            "phase_seconds": time.monotonic() - t0, "card": smi}


def _lstm_entries(cases, serving, training, s2s_serving, s2s_training,
                  tbptt, gen, smi):
    """The kernels-line entries of lstm_fwd and lstm_bwd: times at the
    char-RNN's training shape with Graves peepholes (no library call
    computes those), the case without peepholes beside torch.nn.LSTM, the
    TBPTT window, tail and prime shapes beside torch.nn.LSTM from the same
    state, and the launches of every path that runs them."""
    main_row = cases["char_rnn_train_graves"]
    nopeep = cases["char_rnn_train_no_peepholes"]
    s2s = cases["seq2seq_encoder_n1024_t10_h32"]
    by_path = {
        "lstm_fwd": {"serving": serving["lstm_fwd_launches"],
                     "training": training["launches"]["lstm_fwd"],
                     "seq2seq_serving": s2s_serving["launches"]["lstm_fwd"],
                     "seq2seq_training":
                         s2s_training["launches"]["lstm_fwd"],
                     "tbptt_training": tbptt["launches"]["lstm_fwd"],
                     "rnn_time_step_prime":
                         gen["prime_launches"]["lstm_fwd"],
                     "generate": gen["greedy_launches"]["lstm_fwd"]},
        "lstm_bwd": {"training": training["launches"]["lstm_bwd"],
                     "seq2seq_training":
                         s2s_training["launches"]["lstm_bwd"],
                     "tbptt_training": tbptt["launches"]["lstm_bwd"]},
    }
    library = {"lstm_fwd": ("cudnn_fwd_ms", "op_fwd_ms"),
               "lstm_bwd": ("cudnn_bwd_ms", "op_bwd_ms")}
    entries = []
    for kernel, line in (("lstm_fwd", 47), ("lstm_bwd", 186)):
        lib_key, op_key = library[kernel]
        entries.append({
            "name": kernel, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/lstm_scan.cu",
            "replaces": f"deeplearning4j_tpu/kernels/lstm_scan.py:{line}",
            "launches": sum(by_path[kernel].values()),
            "launches_by_path": by_path[kernel],
            "route": main_row[f"{kernel}_route"],
            "kernel_launches_per_call": main_row[
                f"{kernel}_launches_per_call"],
            "max_abs_err": main_row[f"{kernel}_max_abs_err"],
            "max_abs_err_by_case": {c: r[f"{kernel}_max_abs_err"]
                                    for c, r in cases.items()},
            "ms": main_row[f"{kernel}_ms"],
            "device_ms": main_row[f"{kernel}_device_ms"],
            "plain_ms": main_row[f"{kernel}_plain_ms"],
            "bound_ms": main_row[f"{kernel}_bound_ms"],
            "bound_by": main_row[f"{kernel}_bound_by"],
            "bound_cuda_cores_ms": main_row[
                f"{kernel}_bound_cuda_cores_ms"],
            "bound_is": "the floor on the tensor cores: max(bytes, "
                        "operations as three TF32 passes)",
            "library_ms": None,
            "library_note": "no library call computes Graves peepholes; "
                            "torch.nn.LSTM (cuDNN) times the case without "
                            "them under no_peepholes",
            "no_peepholes": {
                "ms": nopeep[f"{kernel}_ms"],
                "plain_ms": nopeep[f"{kernel}_plain_ms"],
                "bound_ms": nopeep[f"{kernel}_bound_ms"],
                "op_ms": nopeep[op_key], "library_ms": nopeep[lib_key],
                "library": "torch.nn.LSTM (cuDNN), input width "
                           f"{CHAR_HIDDEN}; op_ms is the port's lstm op "
                           "on the same input (x·W product + kernel"
                           + (", wgrad products" if kernel == "lstm_bwd"
                              else "") + ")"},
            "serving_n8_no_workspace_ms": (main_row["lstm_fwd_n8_ms"]
                                           if kernel == "lstm_fwd"
                                           else None),
            "serving_n8": None if kernel != "lstm_fwd" else {
                "ms": main_row["lstm_fwd_n8_ms"],
                "plain_ms": main_row["lstm_fwd_n8_plain_ms"],
                "bound_ms": main_row["lstm_fwd_n8_bound_ms"],
                "library_ms": None,
                "no_peepholes": {
                    "ms": nopeep["lstm_fwd_n8_ms"],
                    "plain_ms": nopeep["lstm_fwd_n8_plain_ms"],
                    "op_ms": nopeep["op_fwd_n8_ms"],
                    "library_ms": nopeep["cudnn_fwd_n8_ms"]}},
            "tbptt_and_prime": {
                c: {"shape": r["shape"], "init_state": r["init_state"],
                    "route": r[f"{kernel}_route"],
                    "ms": r[f"{kernel}_ms"],
                    "device_ms": r[f"{kernel}_device_ms"],
                    "plain_ms": r[f"{kernel}_plain_ms"],
                    "bound_ms": r[f"{kernel}_bound_ms"],
                    "bound_by": r[f"{kernel}_bound_by"],
                    "no_workspace": None if kernel != "lstm_fwd" else {
                        "ms": r["lstm_fwd_no_ws_ms"],
                        "plain_ms": r["lstm_fwd_no_ws_plain_ms"],
                        "bound_ms": r["lstm_fwd_no_ws_bound_ms"],
                        "bound_by": r["lstm_fwd_no_ws_bound_by"]},
                    "op_ms": r[op_key], "library_ms": r[lib_key],
                    "library": "torch.nn.LSTM (cuDNN) without peepholes "
                               "from the case's (h0, c0), input width "
                               f"{CHAR_HIDDEN}; op_ms the port's lstm op "
                               "on it"}
                for c, r in cases.items() if c in LSTM_LIBRARY_AT_SHAPE},
            "seq2seq_encoder": {
                "shape": s2s["shape"], "route": s2s[f"{kernel}_route"],
                "ms": s2s[f"{kernel}_ms"],
                "device_ms": s2s[f"{kernel}_device_ms"],
                "plain_ms": s2s[f"{kernel}_plain_ms"],
                "bound_ms": s2s[f"{kernel}_bound_ms"],
                "bound_by": s2s[f"{kernel}_bound_by"],
                "op_ms": s2s[op_key], "library_ms": s2s[lib_key],
                "library": "torch.nn.LSTM (cuDNN) on the encoder's input "
                           f"{s2s['cudnn_input']}; op_ms the port's lstm "
                           "op on it"},
            "shape": main_row["shape"], "card": smi,
        })
    return entries


# -- 9. kernels (GRU) ---------------------------------------------------------

# The char-GRU of the TensorFlow tutorial "Text generation with an RNN":
# Embedding(66, 256) -> GRU(1024) -> softmax over 66, seq 100, batch 64.
GRU_VOCAB, GRU_EMBED, GRU_HIDDEN, GRU_T, GRU_BATCH = 66, 256, 1024, 100, 64
GRU_TBPTT = 50  # two truncated-BPTT windows over T=100
# gru_fwd / gru_bwd vs their plain versions, float32 on both sides,
# differing in the order of the sums of h·RW over H terms and of the
# carry's product over 3H, and in the kernels' 3xTF32 products (about 21
# bits of each operand): hs (|h| <= 1), the workspace, dz̃ and dh0 to 1e-5
# of max(1, max |plain|).
TOL_GRU = 1e-5

# (name, N, T, H, non-zero initial state, workspace, timed)
GRU_CASES = [
    ("char_gru_train", GRU_BATCH, GRU_T, GRU_HIDDEN, False, True, True),
    ("char_gru_train_init", GRU_BATCH, GRU_T, GRU_HIDDEN, True, True, False),
    ("serving_n8_no_workspace", 8, GRU_T, GRU_HIDDEN, False, False, False),
    ("untiled_n3_h200", 3, GRU_T, 200, False, True, False),
    # a truncated-BPTT window of the char-GRU (tbptt_length 50 over T=100)
    # from the carry the window before left
    ("gru_tbptt_window_t50", GRU_BATCH, GRU_TBPTT, GRU_HIDDEN, True, True,
     True),
]


def _gru_inputs(dev, n, t, h, init, seed):
    """xp_tm, rw, b, h0, gh_tm: float32 on the card, RW glorot-normal as
    the layer draws it."""
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn((t, n, 3 * h), generator=g)
    rw = (2.0 / (4 * h)) ** 0.5 * torch.randn((h, 3 * h), generator=g)
    b = 0.1 * torch.randn((3 * h,), generator=g)
    h0 = (torch.tanh(torch.randn((n, h), generator=g)) if init
          else torch.zeros((n, h)))
    gh = torch.randn((t, n, h), generator=g)
    return [a.to(dev) for a in (xp, rw, b, h0, gh)]


def _gru_bound(kernel, n, t, h, zero_init, workspace=True):
    """Least time for one sweep (``_floor``): the products in float32
    grade on the tensor cores, three TF32 passes, and beside it the bound
    on the float32 CUDA cores. Operations: the recurrent products,
    2·N·H·3H per product this run needs — forward one per step but the
    first when h0 is 0, backward the T-1 carries and the one to h0; the
    gate math (tens of operations per unit and step, under 1% of the
    products at H=1024) is not counted. Bytes, float32, each input read
    once and each output written once: forward xp, RW, b and h0 in; hs
    and, with the workspace, the gates and h·RW_n out; backward the gates,
    h·RW_n, hs, h0, dL/dh and RW in; dz̃ and dh0 out. Returns (ms, bound
    by, operations, bytes, ms on the CUDA cores)."""
    prod = 2.0 * n * h * 3 * h
    nh, nh3 = n * h, 3 * n * h
    if kernel == "gru_fwd":
        ops = prod * (t - 1 if zero_init else t)
        out = t * nh3 + t * nh if workspace else 0
        nbytes = 4 * (t * nh3 + 3 * h * h + 3 * h + nh + t * nh + out)
    else:
        ops = prod * t
        nbytes = 4 * (t * nh3 + 3 * t * nh + nh + 3 * h * h + t * nh3 + nh)
    ms, by, cores_ms = _floor(ops, nbytes, torch.float32)
    return ms, by, ops, nbytes, cores_ms


def _frac(a, w):
    """max |a - w| as a fraction of max(1, max |w|)."""
    return float((a - w).abs().max()) / max(1.0, float(w.abs().max()))


def phase_kernels_gru(dev):
    """gru_fwd and gru_bwd against reference_gru_fwd/_bwd on the same
    inputs (the backward on the kernel's own workspace); then timed at the
    training shape, beside cuDNN's torch.nn.GRU."""
    from deeplearning4j_tpu_torch.kernels.gru_scan import (
        gru_bwd_cuda,
        gru_fwd_cuda,
        reference_gru_bwd,
        reference_gru_fwd,
    )

    from deeplearning4j_tpu_torch.kernels.gru_scan import launch_plan

    results = {}
    for name, n, t, h, init, workspace, timed in GRU_CASES:
        log(f"[kernels] gru {name}: launch plan {launch_plan(n, h, dev)}")
        xp, rw, b, h0, gh = _gru_inputs(dev, n, t, h, init, seed=n + t + h)
        got = gru_fwd_cuda(xp, rw, b, h0, save_workspace=workspace)
        want = reference_gru_fwd(xp, rw, b, h0, save_workspace=workspace)
        fwd_err = max(_frac(a, w) for a, w in zip(got, want))
        fwd_abs = max(float((a - w).abs().max()) for a, w in zip(got, want))
        bwd_err = bwd_abs = None
        dgot = ()
        if workspace:
            hs, _, gates, hpn = got
            h_prev = torch.cat([h0[None], hs[:-1]])
            dgot = gru_bwd_cuda(gates, hpn, hs, h0, gh, rw)
            dwant = reference_gru_bwd(gates, hpn, h_prev, gh, rw)
            bwd_err = max(_frac(a, w) for a, w in zip(dgot, dwant))
            bwd_abs = max(float((a - w).abs().max())
                          for a, w in zip(dgot, dwant))
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(a).all()) for a in (*got, *dgot))
        ok = fwd_err <= TOL_GRU and (bwd_err or 0.0) <= TOL_GRU and finite
        log(f"[kernels] gru {name}: gru_fwd max_abs_err {fwd_abs:.3e}, "
            f"{fwd_err:.3e} of max(1, |plain|)"
            + (f"; gru_bwd max_abs_err {bwd_abs:.3e}, {bwd_err:.3e} of "
               f"max(1, |plain|)" if workspace else
               " (no workspace, forward only)")
            + f" (tol {TOL_GRU:.0e}); finite={finite} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: GRU kernel case {name} failed")
        row = {"shape": [n, t, h], "init_state": init,
               "workspace": workspace, "gru_fwd_max_abs_err": fwd_abs,
               "gru_fwd_max_err_frac": fwd_err, "gru_bwd_max_abs_err": bwd_abs,
               "gru_bwd_max_err_frac": bwd_err}
        if timed:
            hs, _, gates, hpn = got
            row.update(_time_gru(dev, xp, rw, b, h0, gh, hs, gates, hpn))
            log(f"[kernels] gru {name}: gru_fwd {row['gru_fwd_ms']:.4f} ms "
                f"(device {row['gru_fwd_device_ms']:.4f}, bound "
                f"{row['gru_fwd_bound_ms']:.4f} {row['gru_fwd_bound_by']} "
                f"on the tensor cores, "
                f"{row['gru_fwd_bound_cuda_cores_ms']:.4f} on the CUDA "
                f"cores; serving N=8 without workspace "
                f"{row['gru_fwd_n8_ms']:.4f}, bound "
                f"{row['gru_fwd_n8_bound_ms']:.4f} / "
                f"{row['gru_fwd_n8_bound_cuda_cores_ms']:.4f}), plain "
                f"{row['gru_fwd_plain_ms']:.4f} ms; gru_bwd "
                f"{row['gru_bwd_ms']:.4f} ms (device "
                f"{row['gru_bwd_device_ms']:.4f}, bound "
                f"{row['gru_bwd_bound_ms']:.4f} {row['gru_bwd_bound_by']} "
                f"on the tensor cores, "
                f"{row['gru_bwd_bound_cuda_cores_ms']:.4f} on the CUDA "
                f"cores), plain {row['gru_bwd_plain_ms']:.4f} ms")
            row.update(_time_cudnn_gru(dev, rw, b, t,
                                       h0 if init else None))
            log(f"[kernels] gru {name} vs torch.nn.GRU (cuDNN), input width "
                f"{GRU_EMBED}: forward op {row['op_fwd_ms']:.4f} ms vs cuDNN "
                f"{row['cudnn_fwd_ms']:.4f} ms; backward op "
                f"{row['op_bwd_ms']:.4f} ms vs cuDNN "
                f"{row['cudnn_bwd_ms']:.4f} ms; outputs agree to "
                f"{row['cudnn_max_abs_err']:.3e}; serving N=8 forward: "
                f"kernel {row['gru_fwd_n8_ms']:.4f}, plain "
                f"{row['gru_fwd_n8_plain_ms']:.4f}, op "
                f"{row['op_fwd_n8_ms']:.4f} vs cuDNN "
                f"{row['cudnn_fwd_n8_ms']:.4f} ms")
        results[name] = row
    return results


def _time_gru(dev, xp, rw, b, h0, gh, hs, gates, hpn):
    """Both kernels and both plain versions by CUDA events (one call each
    in turn, twice: kernel, plain, plain, kernel), the kernels' device
    time and step launches from the profiler (T forward, T + 1 backward,
    or the run fails), and the forward at the serving bucket N=8 without
    the workspace, beside its plain version. A step may start while the
    one before it ends (dependent launches), so the device time is the
    steps' busy time, the union of their intervals."""
    from deeplearning4j_tpu_torch.kernels.gru_scan import (
        gru_bwd_cuda,
        gru_fwd_cuda,
        reference_gru_bwd,
        reference_gru_fwd,
    )

    t, n, h3 = xp.shape
    h = h3 // 3
    h_prev = torch.cat([h0[None], hs[:-1]])
    xp8, h08 = xp[:, :8].contiguous(), h0[:8].contiguous()
    fns = {
        "gru_fwd": lambda: gru_fwd_cuda(xp, rw, b, h0, save_workspace=True),
        "gru_fwd_plain": lambda: reference_gru_fwd(xp, rw, b, h0,
                                                   save_workspace=True),
        "gru_bwd": lambda: gru_bwd_cuda(gates, hpn, hs, h0, gh, rw),
        "gru_bwd_plain": lambda: reference_gru_bwd(gates, hpn, h_prev, gh,
                                                   rw),
        "gru_fwd_n8": lambda: gru_fwd_cuda(xp8, rw, b, h08),
        "gru_fwd_n8_plain": lambda: reference_gru_fwd(xp8, rw, b, h08),
    }
    runs = {k: [] for k in fns}
    for k in ("gru_fwd", "gru_fwd_plain", "gru_fwd_plain", "gru_fwd",
              "gru_bwd", "gru_bwd_plain", "gru_bwd_plain", "gru_bwd",
              "gru_fwd_n8", "gru_fwd_n8_plain", "gru_fwd_n8_plain",
              "gru_fwd_n8"):
        runs[k].append(_time_ms(fns[k], iters=10, warmup=2))
    row = {f"{k}_ms": min(v) for k, v in runs.items()}
    row.update({f"{k}_ms_runs": v for k, v in runs.items()})
    zero_init = not bool(h0.any())
    for key, kernel in (("gru_fwd", "gru_fwd"), ("gru_bwd", "gru_bwd"),
                        ("gru_fwd_n8", "gru_fwd")):
        # one step kernel per time step (and one more for dh0 backward),
        # as the profiler counted them on the card
        spans = []
        steps, by_kernel, traces = _step_launches(
            fns[key], kernel, t + (kernel == "gru_bwd"), spans=spans)
        row[f"{key}_device_ms"] = _busy_us(spans, f"{kernel}_step_kernel",
                                           5) / 1e3
        row[f"{key}_step_launches_per_call"] = steps
        row[f"{key}_step_launch_traces"] = traces
        row[f"{key}_device_by_kernel_us"] = {
            k[:60]: us for k, us in by_kernel.items()}
    for kernel in ("gru_fwd", "gru_bwd"):
        bound_ms, bound_by, ops, nbytes, cores_ms = _gru_bound(
            kernel, n, t, h, zero_init)
        row.update({f"{kernel}_bound_ms": bound_ms,
                    f"{kernel}_bound_by": bound_by,
                    f"{kernel}_bound_cuda_cores_ms": cores_ms,
                    f"{kernel}_ops": ops, f"{kernel}_bytes": nbytes})
    n8 = _gru_bound("gru_fwd", 8, t, h, zero_init, workspace=False)
    row["gru_fwd_n8_bound_ms"] = n8[0]
    row["gru_fwd_n8_bound_cuda_cores_ms"] = n8[4]
    return row


def _time_cudnn_gru(dev, rw, b, t=GRU_T, h0=None):
    """torch.nn.GRU (cuDNN) on an input x [N,T,E] beside the port's op on
    the same x and weights (W and RW transposed to weight_ih/weight_hh,
    b to bias_ih, bias_hh zero; gate order r,z,n and the reset applied
    after the recurrent product, as the port's), forward without grad
    (also at the serving bucket N=8) and backward to x and every weight:
    the library yardstick, over ``t`` steps from ``h0`` (zeros when None).
    The outputs must agree."""
    from deeplearning4j_tpu_torch.kernels.gru_scan import gru

    h = rw.shape[0]
    g = torch.Generator().manual_seed(7)
    n = GRU_BATCH if h0 is None else h0.shape[0]
    x = torch.randn((n, t, GRU_EMBED), generator=g).to(dev)
    h8 = None if h0 is None else h0[:8].contiguous()
    w_x = ((2.0 / (GRU_EMBED + 3 * h)) ** 0.5
           * torch.randn((GRU_EMBED, 3 * h), generator=g)).to(dev)
    cudnn = torch.nn.GRU(GRU_EMBED, h, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_x.t())
        cudnn.weight_hh_l0.copy_(rw.t())
        cudnn.bias_ih_l0.copy_(b)
        cudnn.bias_hh_l0.zero_()

    def op(inp, w_x, rw, b, hh=h0):
        return gru(inp, w_x, rw, b, init_h=hh)

    def lib(inp, hh=h0):
        return cudnn(inp) if hh is None else cudnn(inp, hh[None])

    with torch.no_grad():
        err = float((lib(x)[0] - op(x, w_x, rw, b)[0]).abs().max())
    if err > 1e-4:
        raise SystemExit(f"chip_smoke: torch.nn.GRU disagrees with the "
                         f"port's op by {err:.3e}: not the same function")
    leaves = [a.clone().requires_grad_() for a in (x, w_x, rw, b)]
    out_op = op(*leaves)[0]
    xg = x.clone().requires_grad_()
    out_lib = lib(xg)[0]
    dout = torch.randn(out_lib.shape, generator=g).to(dev)
    lib_leaves = [xg, *cudnn.parameters()]
    x8 = x[:8].contiguous()
    fns = {
        "op_fwd": lambda: op(x, w_x, rw, b),
        "cudnn_fwd": lambda: lib(x),
        "op_fwd_n8": lambda: op(x8, w_x, rw, b, h8),
        "cudnn_fwd_n8": lambda: lib(x8, h8),
        "op_bwd": lambda: torch.autograd.grad(out_op, leaves, dout,
                                              retain_graph=True),
        "cudnn_bwd": lambda: torch.autograd.grad(out_lib, lib_leaves, dout,
                                                 retain_graph=True),
    }
    runs = {k: [] for k in fns}
    with torch.no_grad():
        for k in ("op_fwd", "cudnn_fwd", "cudnn_fwd", "op_fwd",
                  "op_fwd_n8", "cudnn_fwd_n8", "cudnn_fwd_n8", "op_fwd_n8"):
            runs[k].append(_time_ms(fns[k], iters=10, warmup=2))
    for k in ("op_bwd", "cudnn_bwd", "cudnn_bwd", "op_bwd"):
        runs[k].append(_time_ms(fns[k], iters=10, warmup=2))
    row = {f"{k}_ms": min(v) for k, v in runs.items()}
    row.update({f"{k}_ms_runs": v for k, v in runs.items()})
    row["cudnn_max_abs_err"] = err
    return row


def _char_gru(dev, backend, updater=None):
    """The char-GRU: Embedding(66, 256) → GRU(1024) → softmax
    RnnOutputLayer (mcxent), seq 100, weights from SEED (the tutorial's
    Dense head with sparse cross-entropy from logits is the same
    function)."""
    from deeplearning4j_tpu_torch.nn.config import (
        NeuralNetConfiguration,
        SequentialConfig,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        GRU,
        Embedding,
        RnnOutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.model import SequentialModel

    cfg = SequentialConfig(
        net=NeuralNetConfiguration(seed=SEED, updater=updater,
                                   weight_init="xavier"),
        layers=[Embedding(vocab_size=GRU_VOCAB, units=GRU_EMBED),
                GRU(units=GRU_HIDDEN, backend=backend),
                RnnOutputLayer(units=GRU_VOCAB, activation="softmax",
                               loss="mcxent")],
        input_shape=(GRU_T,))
    return SequentialModel(cfg, device=dev)


def _next_char_gru_probs(model, variables, ids):
    """The char-GRU's serving forward: int char ids [rows, T] → the
    next-char probabilities after the last step [rows, vocab]."""
    return model.output(variables, ids)[:, -1, :]


# -- 10. char-GRU serving -----------------------------------------------------

GRU_REQUESTS = 400
# served next-char probabilities vs the same model with the plain GRU,
# float32: the kernels' ~1e-7 step differences over 100 steps into a
# softmax over 66 characters.
TOL_GRU_PROBS = 1e-5


def _gru_request(i):
    r = np.random.default_rng(7000 + i)
    return r.integers(0, GRU_VOCAB, (1 + i % 4, GRU_T)).astype(np.int32)


def phase_chargru_serving(dev, smi):
    from functools import partial

    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry,
        ModelServer,
        ServingClient,
        spec,
    )

    model = _char_gru(dev, "pallas")
    variables = model.init()
    log(f"[gru_serve] char-GRU: {model.num_params(variables):,} parameters "
        f"on {dev}, seed {SEED}, layers {model.layer_names}")
    reg = ModelRegistry()
    entry = reg.register(
        "char_gru", partial(_next_char_gru_probs, model), variables,
        input_spec=spec((GRU_T,), np.int32, high=GRU_VOCAB),
        mode="batched", max_batch_size=8)
    server = ModelServer(reg, port=0)
    t0 = time.monotonic()
    server.start(warm=True)
    client = ServingClient(server.url, timeout=120)
    if not client.ready()["ready"]:
        raise SystemExit("chip_smoke: /readyz not ready after warm start")
    log(f"[gru_serve] server warm and ready in {time.monotonic() - t0:.2f} "
        f"s (buckets {sorted(entry.batch_stats().items())})")

    requests = [_gru_request(i) for i in range(GRU_REQUESTS)]
    latencies = [0.0] * GRU_REQUESTS

    def call(i):
        t_start = time.monotonic()
        resp = client.predict("char_gru", requests[i])
        latencies[i] = time.monotonic() - t_start
        return resp

    with _plain_rnn_guard("gru") as plain_calls:
        _dispatch.reset_launch_counts()
        before = entry.batch_stats()
        t0 = time.monotonic()
        with ThreadPoolExecutor(CLIENT_THREADS) as pool:
            responses = list(pool.map(call, range(GRU_REQUESTS)))
        wall = time.monotonic() - t0
        counts = _dispatch.launch_counts()
        after = entry.batch_stats()
    batches = after["batches"] - before["batches"]
    rows = after["rows"] - before["rows"]
    drained = server.stop()
    log(f"[gru_serve] {GRU_REQUESTS} requests ({rows} rows) in {wall:.3f} s "
        f"over {batches} batches; launches {counts}; plain ops/rnn.gru "
        f"calls on the card {len(plain_calls)}; drained={drained}")
    if batches < 1 or counts != {"gru_fwd": batches} or plain_calls:
        raise SystemExit(f"chip_smoke: {counts} for {batches} batches and "
                         f"{len(plain_calls)} plain GRU calls; want 1 "
                         f"gru_fwd per batch and none")
    if not drained:
        raise SystemExit("chip_smoke: server did not drain on stop")

    # every response against the same model with the plain GRU, all rows
    # in one batch
    got = [np.asarray(r["outputs"], np.float64) for r in responses]
    for req, out in zip(requests, got):
        if out.shape != (req.shape[0], GRU_VOCAB) or not np.all(
                np.isfinite(out)) or np.abs(out.sum(-1) - 1).max() > 1e-5:
            raise SystemExit(f"chip_smoke: bad served output {out}")
    all_ids = torch.from_numpy(np.concatenate(requests)).to(dev)
    want = _next_char_gru_probs(_char_gru(dev, "plain"), variables,
                                all_ids).double().cpu().numpy()
    worst = float(np.abs(np.concatenate(got) - want).max())
    ids8 = all_ids[:8]
    breakdown = _forward_breakdown(
        lambda: _next_char_gru_probs(model, variables, ids8), "gru_fwd")
    log(f"[gru_serve] one bucket-8 forward: {breakdown}")
    log(f"[gru_serve] served next-char probabilities vs the plain GRU: "
        f"max_abs_err {worst:.3e} (tol {TOL_GRU_PROBS:.0e}) over "
        f"{all_ids.shape[0]} rows")
    if worst > TOL_GRU_PROBS:
        raise SystemExit("chip_smoke: served char-GRU outputs disagree with "
                         "the plain GRU")
    lat_ms = np.asarray(latencies) * 1e3
    log(f"[gru_serve] {GRU_REQUESTS / wall:.1f} requests/s ({rows / wall:.1f}"
        f" rows/s), p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.2f} ms over {GRU_REQUESTS} requests, "
        f"{CLIENT_THREADS} clients, on {smi}")
    return {"model": "char_gru", "vocab": GRU_VOCAB, "embed": GRU_EMBED,
            "hidden": GRU_HIDDEN, "seq_len": GRU_T,
            "requests": GRU_REQUESTS, "rows": rows,
            "client_threads": CLIENT_THREADS, "batches": batches,
            "gru_fwd_launches": counts["gru_fwd"],
            "gru_fwd_launches_per_batch": counts["gru_fwd"] / batches,
            "requests_per_s": GRU_REQUESTS / wall, "rows_per_s": rows / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "max_abs_err_probs": worst, "forward_bucket8": breakdown,
            "card": smi}


# -- 11. char-GRU training ----------------------------------------------------

GRU_LR = 1e-3


def _gru_batches():
    """The char-GRU's batches: GRU_BATCH rows of GRU_T char ids of the
    synthetic text, labels the next chars one-hot."""
    eye = np.eye(GRU_VOCAB, dtype=np.float32)
    return [{"features": ids[:, :-1].astype(np.int32),
             "labels": eye[ids[:, 1:]]}
            for ids in _text_windows(GRU_VOCAB, GRU_BATCH, GRU_T)]


def phase_chargru_train(dev, smi):
    """Returns the phase's line and one step's gradient leaves (the
    bitmap phase encodes them)."""
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    model = _char_gru(dev, "pallas", Adam(GRU_LR))
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    on_dev = [batch_to_device(b, dev) for b in _gru_batches()]
    log(f"[gru_train] char-GRU: {model.num_params(trainer.variables(ts0)):,}"
        f" parameters, Adam({GRU_LR}), batches {GRU_BATCH}x{GRU_T} char ids "
        f"of {GRU_VOCAB}")

    # 1. one loss and gradient, kernels vs the plain GRU (backend "plain")
    with _plain_rnn_guard("gru") as plain_calls:
        _dispatch.reset_launch_counts()
        loss_k, g_kernel = _loss_and_grads(trainer, ts0.params, on_dev[0],
                                           dev, SEED)
        counts = _dispatch.launch_counts()
    want = {"gru_fwd": 1, "gru_bwd": 1}
    if counts != want or plain_calls:
        raise SystemExit(f"chip_smoke: one loss+grad launched {counts} and "
                         f"made {len(plain_calls)} plain GRU calls; want "
                         f"{want} and none")
    plain_trainer = Trainer(_char_gru(dev, "plain", Adam(GRU_LR)))
    loss_p, g_plain = _loss_and_grads(plain_trainer, ts0.params, on_dev[0],
                                      dev, SEED)
    loss_rel, worst_name, worst = _check_grads("gru_train", loss_k, loss_p,
                                               g_kernel, g_plain)
    del g_plain

    # 2. Trainer.fit, 30 steps; 3. checkpoint restore
    with _plain_rnn_guard("gru") as plain_calls:
        fit = _fit_and_restore("gru_train", trainer, ts0, on_dev,
                               CHAR_EPOCHS, dev)
    ts, counts, losses = fit["ts"], fit["launches"], fit["losses"]
    n_steps = CHAR_TRAIN_BATCHES * CHAR_EPOCHS
    want = {"gru_fwd": n_steps, "gru_bwd": n_steps}
    if ts.step != n_steps or counts != want or plain_calls:
        raise SystemExit(f"chip_smoke: fit launched {counts} over {ts.step}"
                         f" steps with {len(plain_calls)} plain GRU calls; "
                         f"want {want} and none")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    log(f"[gru_train] loss {first:.4f} (first 3 steps) -> {last:.4f} "
        f"(last 3), fall {first - last:.4f} (must be >= {LOSS_FALL})")
    if not (np.all(np.isfinite(losses)) and first - last >= LOSS_FALL):
        raise SystemExit("chip_smoke: the char-GRU's loss did not fall by "
                         f"{LOSS_FALL}")

    # 4. where one step's time goes
    breakdown = _step_breakdown(trainer, ts, on_dev[0],
                                ("gru_fwd", "gru_bwd"))
    log(f"[gru_train] one step: {breakdown}")
    step_ms = fit["median_step_ms"]
    tokens = GRU_BATCH * GRU_T
    log(f"[gru_train] median step {step_ms:.2f} ms, "
        f"{tokens / (step_ms / 1e3):,.0f} tokens/s, peak memory "
        f"{fit['peak_memory_gib']:.2f} GiB, on {smi}")
    return {
        "model": "char_gru", "vocab": GRU_VOCAB, "embed": GRU_EMBED,
        "hidden": GRU_HIDDEN, "batch": GRU_BATCH, "seq_len": GRU_T,
        "steps": ts.step, "launches": counts,
        "launches_per_step": {k: v / ts.step for k, v in counts.items()},
        "losses": losses, "loss_first3": first, "loss_last3": last,
        "median_step_ms": step_ms, "step_ms_gaps": fit["step_ms_gaps"],
        "tokens_per_s": tokens / (step_ms / 1e3),
        "peak_memory_gib": fit["peak_memory_gib"],
        "fit_seconds": fit["fit_seconds"],
        "kernel_vs_plain": {"loss_kernel": loss_k, "loss_plain": loss_p,
                            "loss_rel": loss_rel,
                            "worst_grad_leaf": worst_name,
                            "worst_grad_frac": worst},
        "checkpoint_next_loss": fit["checkpoint_next_loss"],
        "step_breakdown": breakdown, "card": smi,
    }, g_kernel


# -- 12. bitmap gradient codec ------------------------------------------------

BITMAP_THR = 0.7  # leaves all three codes populated in N(0, 1) data
BITMAP_SIZES = (1, 15, 16, 2047, 2048, 2049)  # and BERT-base's parameters


def _bitmap_grad(dev, n, seed):
    """n float32 N(0, 1) values on the card, with code 2 in slot 15 of the
    first word (bit 31 set: a negative packed word)."""
    g = torch.randn((n,), generator=torch.Generator(dev).manual_seed(seed),
                    device=dev)
    if n >= 16:
        g[15] = -2.0
    return g


def _bitmap_check(tag, g, thr, packed, resid):
    """The kernel's words and residual against the plain codec
    (ops/compression, bit for bit), and decode + residual against g (1
    ulp); fails the run otherwise."""
    from deeplearning4j_tpu_torch.ops import compression

    want_p, want_r = compression.bitmap_encode(g, thr)
    same = (torch.equal(packed, want_p)
            and torch.equal(resid.view(torch.int32), want_r.view(torch.int32)))
    back = compression.bitmap_decode(packed, thr, g.shape) + resid
    ulp_ok = bool(((back - g).abs() <= 2 ** -23 * g.abs()).all())
    dec = compression.bitmap_decode(packed, thr, g.shape)
    codes = sorted({c for c, present in ((0, (dec == 0).any()),
                                         (1, (dec > 0).any()),
                                         (2, (dec < 0).any())) if present})
    if not (same and ulp_ok):
        raise SystemExit(f"chip_smoke: bitmap_pack {tag}: bit-identical="
                         f"{same}, decode + residual within 1 ulp={ulp_ok}")
    return codes


def phase_bitmap(dev, smi, n_bert, grads):
    """bitmap_encode on the card (the kernel) against the plain codec: the
    sizes around a word and a 2048-element tile, BERT-base's parameter
    count, the char-GRU's gradient leaves of one step, and bfloat16 against
    the kernel's plain version; then timed at BERT-base's size."""
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.kernels.bitmap_pack import (
        bitmap_encode,
        reference_bitmap_encode,
    )

    sizes = BITMAP_SIZES + (n_bert,)
    rows = {}
    _dispatch.reset_launch_counts()
    main_calls = 0
    for n in sizes:
        g = _bitmap_grad(dev, n, seed=n)
        packed, resid = bitmap_encode(g, BITMAP_THR)
        main_calls += 1
        codes = _bitmap_check(f"n={n}", g, BITMAP_THR, packed, resid)
        negative = bool(packed[0] < 0) if n >= 16 else None
        if n >= 16 and (codes != [0, 1, 2] or not negative):
            raise SystemExit(f"chip_smoke: bitmap n={n}: codes {codes}, "
                             f"first word negative {negative}")
        rows[f"n={n}"] = {"codes": codes, "first_word_negative": negative}
        log(f"[bitmap] n={n}: {packed.numel()} words, bit-identical to the "
            f"codec, decode + residual within 1 ulp; codes {codes}")
    del g, packed, resid
    # one char-GRU training step's gradient leaves, each against its own
    # threshold: its mean |g| (all three codes populated)
    for name, leaf in grads.items():
        thr = float(leaf.abs().mean())
        packed, resid = bitmap_encode(leaf, thr)
        main_calls += 1
        rows[f"grad {name}"] = {
            "n": leaf.numel(), "threshold": thr,
            "codes": _bitmap_check(name, leaf, thr, packed, resid)}
    log(f"[bitmap] {len(grads)} char-GRU gradient leaves, each at its mean "
        f"|g|: bit-identical to the codec: "
        + "; ".join(f"{k[5:]} codes {v['codes']}" for k, v in rows.items()
                    if k.startswith("grad ")))
    # bfloat16: the kernel's rule (float32 compare and subtract, residual
    # rounded once), bit for bit against its plain version
    for n in (2049, 1 << 20):
        g16 = _bitmap_grad(dev, n, seed=n + 1).to(torch.bfloat16)
        packed, resid = bitmap_encode(g16, BITMAP_THR)
        main_calls += 1
        want_p, want_r = reference_bitmap_encode(g16, BITMAP_THR)
        if not (torch.equal(packed, want_p) and torch.equal(
                resid.view(torch.int16), want_r.view(torch.int16))):
            raise SystemExit(f"chip_smoke: bitmap_pack bf16 n={n} differs "
                             "from its plain version")
        rows[f"bf16 n={n}"] = "bit-identical to reference_bitmap_encode"
    counts = _dispatch.launch_counts()
    log(f"[bitmap] bfloat16: bit-identical to reference_bitmap_encode; "
        f"launches {counts} for {main_calls} calls")
    if counts != {"bitmap_pack": main_calls}:
        raise SystemExit(f"chip_smoke: bitmap launches {counts}, want "
                         f"{main_calls}")

    # timed at BERT-base's size
    g = _bitmap_grad(dev, n_bert, seed=1)
    kernel = lambda: bitmap_encode(g, BITMAP_THR)  # noqa: E731
    plain = lambda: bitmap_encode(g, BITMAP_THR, backend="xla")  # noqa
    ms = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        ms[which].append(_time_ms(kernel if which == "kernel" else plain,
                                  iters=10, warmup=2))
    nbytes = 4 * n_bert + 4 * n_bert + 4 * ((n_bert + 15) // 16)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    row = {"n": n_bert, "kernel_ms": min(ms["kernel"]),
           "plain_ms": min(ms["plain"]), "kernel_ms_runs": ms["kernel"],
           "plain_ms_runs": ms["plain"],
           "kernel_device_ms": _device_ms(kernel), "bound_ms": bound_ms,
           "bound_by": "bytes", "bytes": nbytes, "launches": main_calls,
           "cases": rows, "card": smi}
    log(f"[bitmap] n={n_bert} (BERT-base): kernel {row['kernel_ms']:.4f} ms "
        f"(device {row['kernel_device_ms']:.4f}), plain codec "
        f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms (bytes), on "
        f"{smi}")
    return row


def _gru_entries(cases, serving, training, tbptt, bitmap, smi):
    """The kernels-line entries of gru_fwd, gru_bwd and bitmap_pack."""
    main_row = cases["char_gru_train"]
    window = cases["gru_tbptt_window_t50"]
    by_path = {
        "gru_fwd": {"serving": serving["gru_fwd_launches"],
                    "training": training["launches"]["gru_fwd"],
                    "tbptt_training": tbptt["launches"]["gru_fwd"]},
        "gru_bwd": {"training": training["launches"]["gru_bwd"],
                    "tbptt_training": tbptt["launches"]["gru_bwd"]},
    }
    library = {"gru_fwd": ("cudnn_fwd_ms", "op_fwd_ms"),
               "gru_bwd": ("cudnn_bwd_ms", "op_bwd_ms")}
    entries = []
    for kernel, line in (("gru_fwd", 52), ("gru_bwd", 152)):
        lib_key, op_key = library[kernel]
        entries.append({
            "name": kernel, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/gru_scan.cu",
            "replaces": f"deeplearning4j_tpu/kernels/gru_scan.py:{line}",
            "launches": sum(by_path[kernel].values()),
            "launches_by_path": by_path[kernel],
            "step_launches_per_call": main_row[
                f"{kernel}_step_launches_per_call"],
            "max_abs_err": main_row[f"{kernel}_max_abs_err"],
            "max_err_frac_by_case": {c: r[f"{kernel}_max_err_frac"]
                                     for c, r in cases.items()},
            "ms": main_row[f"{kernel}_ms"],
            "device_ms": main_row[f"{kernel}_device_ms"],
            "plain_ms": main_row[f"{kernel}_plain_ms"],
            "bound_ms": main_row[f"{kernel}_bound_ms"],
            "bound_by": main_row[f"{kernel}_bound_by"],
            "bound_cuda_cores_ms": main_row[
                f"{kernel}_bound_cuda_cores_ms"],
            "bound_is": "the floor on the tensor cores: max(bytes, "
                        "operations as three TF32 passes)",
            "device_ms_is": "busy time of the step kernels (steps overlap "
                            "by dependent launch)",
            "library_ms": main_row[lib_key],
            "library": "torch.nn.GRU (cuDNN), input width "
                       f"{GRU_EMBED}, bias_hh 0; op_ms is the port's gru op "
                       "on the same input (x·W product + kernel"
                       + (", wgrad products" if kernel == "gru_bwd" else "")
                       + ")",
            "op_ms": main_row[op_key],
            "serving_n8_no_workspace_ms": (main_row["gru_fwd_n8_ms"]
                                           if kernel == "gru_fwd" else None),
            "serving_n8": None if kernel != "gru_fwd" else {
                "ms": main_row["gru_fwd_n8_ms"],
                "plain_ms": main_row["gru_fwd_n8_plain_ms"],
                "bound_ms": main_row["gru_fwd_n8_bound_ms"],
                "op_ms": main_row["op_fwd_n8_ms"],
                "library_ms": main_row["cudnn_fwd_n8_ms"]},
            "tbptt_window": {
                "shape": window["shape"], "init_state": True,
                "ms": window[f"{kernel}_ms"],
                "device_ms": window[f"{kernel}_device_ms"],
                "plain_ms": window[f"{kernel}_plain_ms"],
                "bound_ms": window[f"{kernel}_bound_ms"],
                "bound_by": window[f"{kernel}_bound_by"],
                "op_ms": window[op_key], "library_ms": window[lib_key],
                "library": "torch.nn.GRU (cuDNN) from the case's h0"},
            "shape": main_row["shape"], "card": smi,
        })
    entries.append({
        "name": "bitmap_pack", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/bitmap_pack.cu",
        "replaces": "deeplearning4j_tpu/kernels/bitmap_pack.py:36",
        "launches": bitmap["launches"], "max_abs_err": 0.0,
        "max_abs_err_is": "bit-identical to ops/compression.bitmap_encode",
        "ms": bitmap["kernel_ms"], "device_ms": bitmap["kernel_device_ms"],
        "plain_ms": bitmap["plain_ms"], "bound_ms": bitmap["bound_ms"],
        "bound_by": bitmap["bound_by"], "library_ms": None,
        "library": "no PyTorch call computes the codec",
        "shape": [bitmap["n"]], "card": smi,
    })
    return entries


# -- 13. LeNet-5 training -----------------------------------------------------

# bench.py's bench_lenet: LeNet-5 (conv5x5x20, maxpool 2, conv5x5x50,
# maxpool 2, dense 500, softmax 10) on 28x28x1, batch 256, Adam 1e-3; the
# data is load_mnist's deterministic synthetic set (no idx files ship with
# the repository), 10 batches an epoch, 3 epochs: 30 steps.
LENET_BATCH, LENET_EPOCHS = 256, 3
LENET_TRAIN, LENET_TEST = 10 * LENET_BATCH, 2048
LENET_ACCURACY = 0.5


def _tree_map(fn, tree):
    from deeplearning4j_tpu_torch.utils.pytree import tree_map

    return tree_map(fn, tree)


def _float64_copy(tree):
    return _tree_map(lambda a: a.to(torch.float64), tree)


def _grads_by_name(trainer, params, state, batch):
    """Loss, new layer state and every gradient leaf (by name) of the
    train step's differentiated function, no dropout."""
    from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

    loss, new_state, _, grads = trainer._grad_of(params, state, batch, None)
    return (float(loss), dict(flatten_with_names(new_state)),
            dict(flatten_with_names(grads)))


def _l2_errors(got, want):
    """Each leaf's relative L2 error |got − want| / |want| and the whole
    tree's."""
    leaf = {n: float((got[n].double() - w).norm() / w.norm().clamp_min(
        1e-300)) for n, w in want.items()}
    num = sum(float((got[n].double() - w).norm()) ** 2
              for n, w in want.items())
    den = sum(float(w.norm()) ** 2 for w in want.values())
    return leaf, (num / den) ** 0.5


def _vs_float64(tag, trainer, ts, batch, *, per_leaf_max: bool) -> dict:
    """One loss, BatchNorm state and gradient of the float32 train step
    against the same model run in float64 on the card (cuDNN's float64
    convolutions), on the same batch. The loss to TOL_LOSS_REL and the
    layer state to TOL_STATE of max(1, |float64|) always; the gradients
    either per leaf to TOL_GRAD_FRAC of the leaf's floored max
    (``per_leaf_max``, as _check_grads does) or, for a net too deep for
    that (ResNet-50: see TOL_GRAD_L2), by relative L2 error, beside the
    float64 copy's own change under float32-sized noise on its features
    and params."""
    p64, s64 = _float64_copy(ts.params), _float64_copy(ts.model_state)
    b64 = dict(batch, features=batch["features"].double())
    loss32, state32, g32 = _grads_by_name(trainer, ts.params,
                                          ts.model_state, batch)
    loss64, state64, g64 = _grads_by_name(trainer, p64, s64, b64)
    loss_rel = abs(loss32 - loss64) / abs(loss64)
    state_err = max((float((state32[n].double() - w).abs().max())
                     / max(1.0, float(w.abs().max())) for n, w in
                     state64.items()), default=0.0)
    top = max(float(g.abs().max()) for g in g64.values())
    fracs = {n: float((g32[n].double() - w).abs().max())
             / max(float(w.abs().max()), TOL_GRAD_FLOOR * top)
             for n, w in g64.items()}
    worst_name = max(fracs, key=fracs.get)
    leaf_l2, all_l2 = _l2_errors(g32, g64)
    worst_l2 = max(leaf_l2, key=leaf_l2.get)
    out = {"loss_float32": loss32, "loss_float64": loss64,
           "loss_rel": loss_rel, "state_err": state_err,
           "worst_grad_leaf": worst_name,
           "worst_grad_frac": fracs[worst_name],
           "worst_l2_leaf": worst_l2, "worst_l2_err": leaf_l2[worst_l2],
           "l2_err": all_l2}
    ok = loss_rel <= TOL_LOSS_REL and state_err <= TOL_STATE
    if per_leaf_max:
        ok = ok and fracs[worst_name] <= TOL_GRAD_FRAC
    else:
        # the float64 copy's own spread: features and params each moved by
        # a relative N(0, 2^-24), float32's rounding
        gen = torch.Generator(batch["features"].device).manual_seed(SEED)

        def nudge(a):
            return a * (1 + 2.0 ** -24 * torch.randn(
                a.shape, generator=gen, device=a.device, dtype=a.dtype))

        _, _, g_noise = _grads_by_name(
            trainer, _tree_map(nudge, p64), s64,
            dict(b64, features=nudge(b64["features"])))
        noise_leaf, noise_all = _l2_errors(g_noise, g64)
        out.update(noise_l2_err=noise_all,
                   noise_worst_l2_err=max(noise_leaf.values()))
        ok = ok and leaf_l2[worst_l2] <= TOL_GRAD_L2 and \
            all_l2 <= TOL_GRAD_L2
        del g_noise
    log(f"[{tag}] float32 vs float64 on the card: loss {loss32:.7f} vs "
        f"{loss64:.7f} (rel {loss_rel:.2e}, tol {TOL_LOSS_REL:.0e}); layer "
        f"state {state_err:.2e} of max(1, |float64|) (tol {TOL_STATE:.0e}); "
        f"worst gradient leaf {worst_name} at {fracs[worst_name]:.2e} of "
        f"its max" + (f" (tol {TOL_GRAD_FRAC:.0e})" if per_leaf_max else
                      f"; relative L2 error {all_l2:.2e} over all leaves, "
                      f"worst leaf {worst_l2} {leaf_l2[worst_l2]:.2e} (tol "
                      f"{TOL_GRAD_L2:.0e}); the float64 copy's own under "
                      f"2^-24 noise {out['noise_l2_err']:.2e}, worst leaf "
                      f"{out['noise_worst_l2_err']:.2e}"))
    if not ok:
        raise SystemExit(f"chip_smoke: {tag}: the float32 step disagrees "
                         "with float64")
    del p64, s64, g64, g32
    return out


def phase_lenet_train(dev, smi):
    from deeplearning4j_tpu_torch.data import (
        ArrayDataSetIterator,
        AsyncDataSetIterator,
        load_mnist,
    )
    from deeplearning4j_tpu_torch.evaluation import evaluate_model
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    t0 = time.monotonic()
    (xtr, ytr), (xte, yte), real = load_mnist(n_train=LENET_TRAIN,
                                              n_test=LENET_TEST)
    model = lenet(device=dev, updater=Adam(1e-3), seed=SEED)
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    log(f"[lenet_train] lenet: {model.num_params(trainer.variables(ts0)):,} "
        f"parameters, Adam(1e-3), batch {LENET_BATCH}, MNIST "
        f"{'idx files' if real else 'synthetic'} {xtr.shape} / {xte.shape}, "
        f"built in {time.monotonic() - t0:.1f} s")
    first = batch_to_device({"features": xtr[:LENET_BATCH],
                             "labels": ytr[:LENET_BATCH]}, dev)
    f64 = _vs_float64("lenet_train", trainer, ts0, first, per_leaf_max=True)

    data = AsyncDataSetIterator(
        ArrayDataSetIterator(xtr, ytr, LENET_BATCH, seed=SEED),
        device_put_to=dev)
    fit = _fit_and_restore("lenet_train", trainer, ts0, data, LENET_EPOCHS,
                           dev, next_batch=first)
    ts, losses, step_ms = fit["ts"], fit["losses"], fit["median_step_ms"]
    per_epoch = len(losses) // LENET_EPOCHS
    first_loss, last_loss = (np.mean(losses[:per_epoch]),
                             np.mean(losses[-per_epoch:]))
    if ts.step != LENET_EPOCHS * (LENET_TRAIN // LENET_BATCH) or not (
            np.all(np.isfinite(losses)) and last_loss < first_loss):
        raise SystemExit(f"chip_smoke: LeNet-5 did not train ({ts.step} "
                         f"steps, loss {first_loss:.4f} -> {last_loss:.4f})")
    t0 = time.monotonic()
    ev = evaluate_model(model, trainer.variables(ts), ArrayDataSetIterator(
        xte, yte, LENET_BATCH, shuffle=False, drop_last=False), 10)
    accuracy = ev.accuracy()
    eval_s = time.monotonic() - t0
    breakdown = _step_breakdown(trainer, ts, first, ())
    log(f"[lenet_train] one step: {breakdown}")
    log(f"[lenet_train] {ts.step} steps: loss {first_loss:.4f} -> "
        f"{last_loss:.4f}; median step {step_ms:.3f} ms "
        f"({LENET_BATCH / (step_ms / 1e3):.1f} samples/s), peak memory "
        f"{fit['peak_memory_gib']:.2f} GiB; evaluate_model on "
        f"{xte.shape[0]} test images: accuracy {accuracy:.4f} (must exceed "
        f"{LENET_ACCURACY}) in {eval_s:.2f} s; on {smi}")
    if not accuracy > LENET_ACCURACY:
        raise SystemExit(f"chip_smoke: LeNet-5 accuracy {accuracy:.4f}")
    return {"model": "lenet", "batch": LENET_BATCH, "steps": ts.step,
            "mnist": "idx" if real else "synthetic",
            "launches": fit["launches"], "losses": losses,
            "loss_first_epoch": float(first_loss),
            "loss_last_epoch": float(last_loss),
            "median_step_ms": step_ms, "step_ms_gaps": fit["step_ms_gaps"],
            "samples_per_s": LENET_BATCH / (step_ms / 1e3),
            "peak_memory_gib": fit["peak_memory_gib"],
            "fit_seconds": fit["fit_seconds"],
            "checkpoint_next_loss": fit["checkpoint_next_loss"],
            "vs_float64": f64, "test_accuracy": accuracy,
            "evaluate_seconds": eval_s, "step_breakdown": breakdown,
            "card": smi}


# -- 14. ResNet-50 training ---------------------------------------------------

# bench.py's bench_resnet50: ResNet-50 (blocks 3, 4, 6, 3; 25,557,032
# parameters) on 224x224x3, 1000 classes, batch 32, Adam 1e-3; float32
# (TF32 off) and mixed precision as bench_resnet50 runs it. Random images
# and labels from the seed; 3 fixed batches cycled by 10 epochs: 30 steps.
RESNET_BATCH, RESNET_BATCHES, RESNET_EPOCHS = 32, 3, 10
# float32 vs the float64 copy, one step from the same init on the same
# batch. The loss to TOL_LOSS_REL (relative) and every BatchNorm running
# statistic to TOL_STATE of max(1, |float64|): both are sums that float32
# computes to a few ulp of the 53-layer forward. The gradients are not
# held per leaf to TOL_GRAD_FRAC: a BatchNorm ReLU net of this depth at
# init turns a perturbation at rounding level into changes of whole
# percents of a leaf's largest entry, in float64 as in float32, so no
# float32 implementation can be held to that. They
# are held by relative L2 error, each leaf and all of them, to
# TOL_GRAD_L2; the float64 copy's own change when its features and params
# move by a relative 2^-24 (float32's rounding) is logged beside it. The
# LeNet-5 phase keeps the per-leaf check.
TOL_STATE = 1e-5
TOL_GRAD_L2 = 1e-1


def _resnet_batches():
    """bench_resnet50's batch: N(0, 1) images, one-hot labels, here one per
    seed."""
    out = []
    for i in range(RESNET_BATCHES):
        r = np.random.default_rng(SEED + i)
        out.append({
            "features": r.normal(size=(RESNET_BATCH, 224, 224, 3)).astype(
                np.float32),
            "labels": np.eye(1000, dtype=np.float32)[
                r.integers(0, 1000, RESNET_BATCH)]})
    return out


def _train_resnet(tag, trainer, ts0, on_dev, dev):
    """30 steps of fit with checkpoints (the loss must fall over them),
    then one step's breakdown: the fit's record."""
    fit = _fit_and_restore(tag, trainer, ts0, on_dev, RESNET_EPOCHS, dev)
    losses = fit["losses"]
    first, last = (np.mean(losses[:RESNET_BATCHES]),
                   np.mean(losses[-RESNET_BATCHES:]))
    if fit["ts"].step != RESNET_BATCHES * RESNET_EPOCHS or not (
            np.all(np.isfinite(losses)) and last < first):
        raise SystemExit(f"chip_smoke: {tag}: the loss did not fall "
                         f"({first:.4f} -> {last:.4f})")
    breakdown = _step_breakdown(trainer, fit["ts"], on_dev[0], ())
    step_ms = fit["median_step_ms"]
    shares = {c: round(v, 3)
              for c, v in breakdown["class_share_of_device"].items()}
    log(f"[{tag}] one step: {breakdown}")
    log(f"[{tag}] {fit['ts'].step} steps: loss {first:.4f} -> {last:.4f}; "
        f"median step {step_ms:.2f} ms ({RESNET_BATCH / (step_ms / 1e3):.1f}"
        f" samples/s), peak memory {fit['peak_memory_gib']:.2f} GiB; one "
        f"step {breakdown['wall_ms']:.2f} ms wall, "
        f"{breakdown['device_ms']:.2f} device, idle "
        f"{breakdown['device_idle_share']:.1%}; device time by class "
        f"{shares}")
    return fit, {
        "steps": fit["ts"].step, "launches": fit["launches"],
        "losses": losses, "loss_first_epoch": float(first),
        "loss_last_epoch": float(last), "median_step_ms": step_ms,
        "step_ms_gaps": fit["step_ms_gaps"],
        "samples_per_s": RESNET_BATCH / (step_ms / 1e3),
        "peak_memory_gib": fit["peak_memory_gib"],
        "fit_seconds": fit["fit_seconds"],
        "checkpoint_next_loss": fit["checkpoint_next_loss"],
        "step_breakdown": breakdown}


def phase_resnet_train(dev, smi):
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    t0 = time.monotonic()
    model = resnet50(device=dev, updater=Adam(1e-3), seed=SEED)
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    on_dev = [batch_to_device(b, dev) for b in _resnet_batches()]
    n_params = model.num_params(trainer.variables(ts0))
    log(f"[resnet_train] resnet50: {n_params:,} parameters, "
        f"{len(model.order)} vertices, Adam(1e-3), batches "
        f"{RESNET_BATCH}x224x224x3, built in {time.monotonic() - t0:.1f} s")
    f64 = _vs_float64("resnet_train", trainer, ts0, on_dev[0],
                      per_leaf_max=False)
    fit, fp32 = _train_resnet("resnet_train", trainer, ts0, on_dev, dev)
    trained = trainer.variables(fit["ts"])

    # mixed precision as bench_resnet50 runs it: bf16 compute, float32
    # master params, updater state and BatchNorm statistics
    mp_model = resnet50(device=dev, updater=Adam(1e-3), seed=SEED)
    mp_model.net.mixed_precision = True
    mp_trainer = Trainer(mp_model)
    mts0 = mp_trainer.init_state(trainer.variables(ts0))
    mts1, m = mp_trainer.train_step(mts0, on_dev[0])
    mp_loss = float(m["total_loss"])
    mp_rel = abs(mp_loss - f64["loss_float64"]) / abs(f64["loss_float64"])
    state_f32 = all(a.dtype == torch.float32 for a in tree_leaves(
        (mts1.params, mts1.model_state, mts1.opt_state)))
    log(f"[resnet_mixed] first step's loss {mp_loss:.6f} vs float64 "
        f"{f64['loss_float64']:.6f} (rel {mp_rel:.2e}, tol "
        f"{TOL_MIXED_REL:.0e}); params, BatchNorm and updater state float32:"
        f" {state_f32}")
    if mp_rel > TOL_MIXED_REL or not state_f32:
        raise SystemExit("chip_smoke: the mixed-precision ResNet-50 step "
                         "failed")
    del mts1
    _, mixed = _train_resnet("resnet_mixed", mp_trainer, mts0, on_dev, dev)
    mixed["first_loss_vs_float64_rel"] = mp_rel
    del mts0, ts0
    return {"model": "resnet50", "batch": RESNET_BATCH, "image": 224,
            "num_params": model.num_params(trained), "vs_float64": f64,
            "float32": fp32, "mixed_precision": mixed, "card": smi}, \
        model, trained


# -- 15. ResNet-50 serving ----------------------------------------------------

# Closed loop: RESNET_CLIENTS client threads, requests of 1-2 NHWC float
# images (224x224x3, sent as JSON numbers), batched mode, max batch 8.
RESNET_REQUESTS, RESNET_CLIENTS, RESNET_MAX_BATCH = 100, 4, 8
TOL_RESNET_PROBS = 1e-5


def _resnet_probs(model, variables, images):
    """The served function: NHWC images → softmax probabilities."""
    return model.output_single(variables, images)


def _image_request(i):
    r = np.random.default_rng(2000 + i)
    return r.normal(size=(1 + i % 2, 224, 224, 3)).astype(np.float32)


def phase_resnet_serve(dev, smi, model, variables):
    import functools

    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry,
        ModelServer,
        ServingClient,
        spec,
    )

    reg = ModelRegistry()
    entry = reg.register(
        "resnet50", functools.partial(_resnet_probs, model), variables,
        input_spec=spec((224, 224, 3), np.float32), mode="batched",
        max_batch_size=RESNET_MAX_BATCH)
    server = ModelServer(reg, port=0)
    t0 = time.monotonic()
    server.start(warm=True)
    client = ServingClient(server.url, timeout=120)
    if not client.ready()["ready"]:
        raise SystemExit("chip_smoke: /readyz not ready after warm start")
    log(f"[resnet_serve] server warm and ready in {time.monotonic() - t0:.2f}"
        f" s (buckets {sorted(entry.batch_stats().items())})")
    requests = [_image_request(i) for i in range(RESNET_REQUESTS)]
    latencies = [0.0] * RESNET_REQUESTS

    def call(i):
        t_start = time.monotonic()
        resp = client.predict("resnet50", requests[i])
        latencies[i] = time.monotonic() - t_start
        return resp

    _dispatch.reset_launch_counts()
    before = entry.batch_stats()
    t0 = time.monotonic()
    with ThreadPoolExecutor(RESNET_CLIENTS) as pool:
        responses = list(pool.map(call, range(RESNET_REQUESTS)))
    wall = time.monotonic() - t0
    launches = _dispatch.launch_counts()
    after = entry.batch_stats()
    batches = after["batches"] - before["batches"]
    rows = after["rows"] - before["rows"]
    drained = server.stop()
    log(f"[resnet_serve] {RESNET_REQUESTS} requests ({rows} rows) in "
        f"{wall:.3f} s over {batches} batches; hand-kernel launches "
        f"{launches} (the path has none); drained={drained}")
    if batches < 1 or not drained:
        raise SystemExit("chip_smoke: the ResNet-50 server did not serve "
                         "and drain")
    worst = 0.0
    for req, resp in zip(requests, responses):
        out = np.asarray(resp["outputs"], dtype=np.float64)
        if out.shape != (req.shape[0], 1000) or not np.all(
                np.isfinite(out)) or np.abs(out.sum(-1) - 1).max() > 1e-5:
            raise SystemExit(f"chip_smoke: bad served output {out.shape}")
        want = _resnet_probs(model, variables, req).double().cpu().numpy()
        worst = max(worst, float(np.abs(out - want).max()))
    # host cost of one 2-image request's JSON: encode (client), decode and
    # coerce to the input spec (server), 301,056 numbers
    req2 = requests[1]
    t0 = time.perf_counter()
    body = json.dumps({"inputs": req2.tolist()})
    t1 = time.perf_counter()
    parsed = entry.parse_inputs(json.loads(body)["inputs"])
    t2 = time.perf_counter()
    json_ms = {"encode_ms": (t1 - t0) * 1e3, "decode_and_coerce_ms":
               (t2 - t1) * 1e3, "body_mib": len(body) / 2**20}
    if not np.array_equal(parsed, req2):
        raise SystemExit("chip_smoke: a request did not survive JSON")
    x8 = torch.from_numpy(np.concatenate(requests[:6])[:8]).to(dev)
    breakdown = _forward_breakdown(
        lambda: _resnet_probs(model, variables, x8))
    lat_ms = np.asarray(latencies) * 1e3
    log(f"[resnet_serve] one bucket-8 forward: {breakdown}")
    log(f"[resnet_serve] a 2-image request's JSON: {json_ms}")
    log(f"[resnet_serve] served probabilities vs output_single: max_abs_err "
        f"{worst:.3e} (tol {TOL_RESNET_PROBS:.0e}); "
        f"{RESNET_REQUESTS / wall:.1f} requests/s ({rows / wall:.1f} "
        f"images/s), p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.2f} ms, {RESNET_CLIENTS} clients, on "
        f"{smi}")
    if worst > TOL_RESNET_PROBS:
        raise SystemExit("chip_smoke: served ResNet-50 probabilities "
                         "disagree with output_single")
    return {"model": "resnet50", "requests": RESNET_REQUESTS, "rows": rows,
            "client_threads": RESNET_CLIENTS, "batches": batches,
            "kernel_launches": launches,
            "requests_per_s": RESNET_REQUESTS / wall,
            "images_per_s": rows / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "max_abs_err_probs": worst, "json_2_images": json_ms,
            "forward_bucket8": breakdown, "card": smi}


# -- 16. GPT-2-small training ---------------------------------------------

# bench.py's bench_gpt: GPT-2-small (12 x 768, 12 heads, vocab 50257, the
# head tied to embeddings/word), max_position = max(512, seq_len), batch
# 8 x 512 random ids, Adam 1e-4, bf16 mixed precision, rbg rng, dropout
# 0.1. Three fixed batches from the seed, cycled by fit's epochs.
GPT_BATCH, GPT_T, GPT_BATCHES, GPT_EPOCHS = 8, 512, 3, 10   # 30 steps
GPT_PARAMS = 124_096_849


def _gpt_batches(vocab):
    return [{"features": {"token_ids": np.random.default_rng(SEED + i)
                          .integers(0, vocab, (GPT_BATCH, GPT_T))
                          .astype(np.int32)}}
            for i in range(GPT_BATCHES)]


def phase_gpt_train(dev, smi):
    """Returns the phase's line, the float32 model and the trained
    variables (the serving phase serves them)."""
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reference_attention,
    )
    from deeplearning4j_tpu_torch.models.gpt import gpt2_small
    from deeplearning4j_tpu_torch.nn import config as nnconfig
    from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod
    from deeplearning4j_tpu_torch.train.trainer import (
        RngKey,
        Trainer,
        batch_to_device,
    )
    from deeplearning4j_tpu_torch.train.updaters import Adam
    from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

    t0 = time.monotonic()
    net = nnconfig.NeuralNetConfiguration(seed=SEED, updater=Adam(1e-4),
                                          mixed_precision=True,
                                          rng_impl="rbg")
    mp_model = gpt2_small(device=dev, max_position=max(512, GPT_T), net=net)
    cfg = mp_model.config
    layers = cfg.num_layers
    n_params = mp_model.num_params()
    # the float32 twin shares the parameters, not the config
    model = copy.copy(mp_model)
    model.config = dataclasses.replace(cfg, net=dataclasses.replace(
        net, mixed_precision=False))
    trainer, mp_trainer = Trainer(model), Trainer(mp_model)
    ts0 = mp_trainer.init_state()
    log(f"[gpt_train] gpt2_small: {n_params:,} parameters (want "
        f"{GPT_PARAMS:,}), {layers} x {cfg.hidden}, vocab {cfg.vocab_size}, "
        f"max_position {cfg.max_position}, dropout "
        f"{cfg.dropout}/{cfg.attention_dropout}, Adam(1e-4), rng "
        f"{ts0.rng}, batches {GPT_BATCH}x{GPT_T}, built in "
        f"{time.monotonic() - t0:.1f} s")
    if n_params != GPT_PARAMS or ts0.rng != RngKey(SEED, "rbg"):
        raise SystemExit("chip_smoke: GPT-2-small's parameter count or rng "
                         "is not bench_gpt's")
    batches = _gpt_batches(cfg.vocab_size)
    on_dev = [batch_to_device(b, dev) for b in batches]
    want = {k: layers for k in FLASH_KERNELS}

    # 1. one float32 loss and gradient, causal kernels vs plain attention,
    # with the dropout masks of fit's first step
    def loss_and_grads():
        loss, _, _, grads = trainer._grad_of(
            ts0.params, {}, on_dev[0], ts0.rng.generator(dev, ts0.step))
        return float(loss), dict(flatten_with_names(grads))

    _dispatch.reset_launch_counts()
    loss_k, g_kernel = loss_and_grads()
    counts = _dispatch.launch_counts()
    if counts != want:
        raise SystemExit(f"chip_smoke: GPT's loss+grad launched {counts}, "
                         f"want {want}")
    with mock.patch.object(attention_mod, "flash_attention",
                           reference_attention):
        loss_p, g_plain = loss_and_grads()
    loss_rel, worst_name, worst = _check_grads("gpt_train", loss_k, loss_p,
                                               g_kernel, g_plain)
    del g_kernel, g_plain

    # 2. 30 mixed-precision steps of fit; the last checkpoint (rbg key
    # included) restores bit-equal with the same next-step loss
    fit = _fit_and_restore("gpt_train", mp_trainer, ts0, on_dev, GPT_EPOCHS,
                           dev)
    ts, counts, losses = fit["ts"], fit["launches"], fit["losses"]
    n_steps = ts.step
    want_fit = {k: v * n_steps for k, v in want.items()}
    if n_steps != GPT_BATCHES * GPT_EPOCHS or counts != want_fit:
        raise SystemExit(f"chip_smoke: GPT's fit launched {counts} over "
                         f"{n_steps} steps, want {want_fit}")
    first, last = np.mean(losses[:GPT_BATCHES]), np.mean(
        losses[-GPT_BATCHES:])
    mp_rel = abs(losses[0] - loss_p) / abs(loss_p)
    log(f"[gpt_train] first mixed step's loss {losses[0]:.6f} vs the "
        f"float32 plain loss {loss_p:.6f}: rel {mp_rel:.2e} (tol "
        f"{TOL_MIXED_REL:.0e}); mean of the first three {first:.4f}, of the "
        f"last three {last:.4f}")
    if not (np.all(np.isfinite(losses)) and last < first
            and mp_rel <= TOL_MIXED_REL):
        raise SystemExit("chip_smoke: GPT's mixed-precision fit failed")

    # 3. where a mixed-precision step's time goes
    breakdown = _step_breakdown(mp_trainer, ts, on_dev[0],
                                FLASH_KERNELS)
    log(f"[gpt_train] one mixed-precision step: {breakdown}")
    _require_kernel_time("GPT mixed-precision step", breakdown)
    step_ms = fit["median_step_ms"]
    tokens = GPT_BATCH * GPT_T
    variables = mp_trainer.variables(ts)
    return {
        "model": "gpt2_small", "num_params": n_params, "batch": GPT_BATCH,
        "seq_len": GPT_T, "dtype": "bf16-mixed", "rng": ts.rng.impl,
        "steps": n_steps, "launches": counts,
        "launches_per_step": {k: v / n_steps for k, v in counts.items()},
        "losses": losses, "loss_first_three": float(first),
        "loss_last_three": float(last),
        "median_step_ms": step_ms, "step_ms_gaps": fit["step_ms_gaps"],
        "tokens_per_s": tokens / (step_ms / 1e3),
        "peak_memory_gib": fit["peak_memory_gib"],
        "fit_seconds": fit["fit_seconds"],
        "fp32_kernel_vs_plain": {"loss_kernel": loss_k, "loss_plain": loss_p,
                                 "loss_rel": loss_rel,
                                 "worst_grad_leaf": worst_name,
                                 "worst_grad_frac": worst},
        "first_mixed_vs_fp32_plain_rel": mp_rel,
        "checkpoint_next_loss": fit["checkpoint_next_loss"],
        "step_breakdown": breakdown, "card": smi,
    }, model, variables


# -- 17. GPT-2-small generation serving -------------------------------------

# The trained GPT-2-small (float32 weights, TF32 off) in a GenerationEngine
# behind ModelServer's :generate route: GEN_REQUESTS streamed requests
# from GEN_CLIENTS client threads (closed loop), prompts of 8-200 random
# ids from the seed, every other request greedy (the rest at temperature
# 0.8), every fourth with an eos_id.
GEN_SLOTS, GEN_MAX_LEN, GEN_NEW = 8, 512, 32
GEN_REQUESTS, GEN_CLIENTS = 64, 8
# a greedy token agrees with the full forward's argmax when its logit is
# within this of the top logit (a tie in float32 arithmetic that sums in
# another order); ties are counted and printed
TOL_GREEDY_TIE = 1e-3


def _gen_request(i, vocab):
    r = np.random.default_rng(3000 + i)
    prompt = r.integers(0, vocab, int(r.integers(8, 201)))
    return {"prompt": prompt.astype(np.int32),
            "temperature": 0.0 if i % 2 == 0 else 0.8,
            "eos_id": int(r.integers(0, vocab)) if i % 4 == 3 else None}


def phase_gpt_serve(dev, smi, model, variables):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reference_attention,
    )
    from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine,
        ModelServer,
        ServingClient,
    )

    vocab = model.config.vocab_size
    engine = GenerationEngine(model, variables, num_slots=GEN_SLOTS,
                              max_len=GEN_MAX_LEN, max_new_tokens=GEN_NEW,
                              seed=SEED)
    server = ModelServer(port=0, generators={"gpt2": engine})
    t0 = time.monotonic()
    server.start(warm=True)
    client = ServingClient(server.url, timeout=300)
    ready = client.ready()
    if not (ready["ready"] and ready.get("generators") == {"gpt2": True}):
        raise SystemExit(f"chip_smoke: /readyz not ready after warm start: "
                         f"{ready}")
    log(f"[gpt_serve] engine warm ({len(engine.prompt_buckets)} prompt "
        f"buckets, {len(engine.slot_buckets) * len(engine.kv_buckets)} "
        f"decode shapes) and ready in {time.monotonic() - t0:.2f} s; KV "
        f"slabs {engine.kv_bytes / 2**20:.1f} MiB")
    requests = [_gen_request(i, vocab) for i in range(GEN_REQUESTS)]
    times = [None] * GEN_REQUESTS

    def call(i):
        req = requests[i]
        t_start = time.monotonic()
        toks, stamps = [], []
        for tok in client.generate("gpt2", req["prompt"],
                                   temperature=req["temperature"],
                                   eos_id=req["eos_id"]):
            toks.append(tok)
            stamps.append(time.monotonic())
        times[i] = (t_start, stamps)
        return toks

    before = engine.describe()
    _dispatch.reset_launch_counts()
    t0 = time.monotonic()
    with ThreadPoolExecutor(GEN_CLIENTS) as pool:
        outputs = list(pool.map(call, range(GEN_REQUESTS)))
    wall = time.monotonic() - t0
    launches = _dispatch.launch_counts()
    after = engine.describe()
    drained = server.stop()
    steps = after["decode_steps"] - before["decode_steps"]
    occupancy = ((after["active_rows_total"] - before["active_rows_total"])
                 / max(1, steps * GEN_SLOTS))
    n_tokens = sum(len(o) for o in outputs)
    log(f"[gpt_serve] {GEN_REQUESTS} requests, {n_tokens} tokens in "
        f"{wall:.3f} s over {steps} decode steps (mean slot occupancy "
        f"{occupancy:.3f}); hand-kernel launches {launches} (the path has "
        f"none); shapes run after warm-up {after['shapes_after_warm']}; "
        f"drained={drained}")
    if launches or not drained or after["shapes_after_warm"]:
        raise SystemExit("chip_smoke: GPT serving launched a hand kernel, "
                         "ran an unwarmed shape or did not drain")

    # every response: length or eos, and every greedy token the argmax of
    # the full forward (plain attention) over prompt + generated prefix
    eos_stops = ties = checked = 0
    worst_gap = 0.0
    with mock.patch.object(attention_mod, "flash_attention",
                           reference_attention), torch.inference_mode():
        for req, toks in zip(requests, outputs):
            eos = req["eos_id"]
            if eos is not None and eos in toks:
                if toks.index(eos) != len(toks) - 1:
                    raise SystemExit("chip_smoke: a stream ran past its eos")
                eos_stops += 1
            elif len(toks) != GEN_NEW:
                raise SystemExit(f"chip_smoke: a stream gave {len(toks)} "
                                 f"tokens, want {GEN_NEW}")
            if min(toks) < 0 or max(toks) >= vocab:
                raise SystemExit("chip_smoke: a token id outside the vocab")
            if req["temperature"] != 0.0:
                continue
            p = len(req["prompt"])
            ids = np.concatenate([req["prompt"], toks[:-1]])[None]
            logits, _ = model.apply(variables, torch.from_numpy(ids).to(dev))
            lg = logits[0, p - 1:].double()
            picked = lg.gather(1, torch.tensor(toks, device=dev)[:, None])
            gap = (lg.max(-1).values - picked[:, 0]).cpu().numpy()
            worst_gap = max(worst_gap, float(gap.max()))
            ties += int(np.sum(gap > 0))
            checked += len(toks)
            if gap.max() > TOL_GREEDY_TIE:
                raise SystemExit(f"chip_smoke: a greedy token is not the "
                                 f"argmax of the full forward (gap "
                                 f"{gap.max():.3e})")
    log(f"[gpt_serve] {checked} greedy tokens against the full forward's "
        f"argmax: {ties} ties within {TOL_GREEDY_TIE:.0e} (worst gap "
        f"{worst_gap:.3e}); {eos_stops} streams stopped at their eos_id")

    ttft = np.array([(s[0] - t) * 1e3 for t, s in times])
    gaps = np.concatenate([np.diff(s) * 1e3 for _, s in times])
    # one decode step at 8 slots over 256 KV columns, the engine stopped
    slot_idx = list(range(GEN_SLOTS))
    step = lambda: engine.run_decode(  # noqa: E731
        256, slot_idx, [11] * GEN_SLOTS, [100 + 17 * i for i in slot_idx],
        [0.0] * GEN_SLOTS)
    decode = _forward_breakdown(step)
    log(f"[gpt_serve] one decode step (8 slots, kv 256): {decode}")
    out = {"model": "gpt2_small", "requests": GEN_REQUESTS,
           "client_threads": GEN_CLIENTS, "num_slots": GEN_SLOTS,
           "max_len": GEN_MAX_LEN, "max_new_tokens": GEN_NEW,
           "tokens": n_tokens, "decode_steps": steps,
           "kernel_launches": launches,
           "generated_tokens_per_s": n_tokens / wall,
           "requests_per_s": GEN_REQUESTS / wall,
           "ttft_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_p99_ms": float(np.percentile(ttft, 99)),
           "inter_token_p50_ms": float(np.percentile(gaps, 50)),
           "inter_token_p99_ms": float(np.percentile(gaps, 99)),
           "mean_slot_occupancy": occupancy,
           "kv_slab_bytes": engine.kv_bytes,
           "greedy_tokens_checked": checked, "greedy_ties": ties,
           "greedy_worst_gap": worst_gap, "eos_stops": eos_stops,
           "decode_step_8x256": decode, "card": smi}
    log(f"[gpt_serve] {out['generated_tokens_per_s']:.1f} tokens/s, "
        f"{out['requests_per_s']:.2f} requests/s, ttft p50 "
        f"{out['ttft_p50_ms']:.2f} p99 {out['ttft_p99_ms']:.2f} ms, "
        f"inter-token p50 {out['inter_token_p50_ms']:.2f} p99 "
        f"{out['inter_token_p99_ms']:.2f} ms, on {smi}")
    return out


# -- 18. kernels at the seq2seq slice's shapes ---------------------------------

# Head sizes the kernels lack, run zero-padded by flash_attention
# (pad_head): forward and backward through autograd, against the plain
# version at the original D (forward in the inputs' dtype to TOL, the
# gradients against autograd of the plain version of the inputs in
# float32 to TOL_BWD of max(1, |plain|)). (name, B, H, T, S, D, dtype,
# causal, key lengths, timed): the seq2seq CrossAttention's shape (1024
# sequences x 4 heads of 16, T = S = 10, padded to 32) and D = 48 (to 64).
PADDED_CASES = [
    ("seq2seq_xatt_d16_fp32", 1024, 4, 10, 10, 16, torch.float32, False,
     None, True),
    ("seq2seq_xatt_d16_bf16", 1024, 4, 10, 10, 16, torch.bfloat16, False,
     None, True),
    ("d48_masked_fp32", 2, 3, 70, 100, 48, torch.float32, False, [100, 41],
     False),
    ("d48_causal_bf16", 2, 3, 70, 100, 48, torch.bfloat16, True, [100, 41],
     False),
]


def phase_kernels_padded(dev):
    """The PADDED_CASES through flash_attention with grad: one launch of
    each flash kernel per forward and backward, outputs and gradients
    against the plain version at D; the timed cases also timed (kernel
    on the padded tensors, the wrapper with its pad and slice, the plain
    version and SDPA at D = 16), bounds counted at the original D."""
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention,
        kernel_head_size,
        reference_attention,
    )

    results = {}
    for (name, b, h, t, s, d, dtype, causal, lengths,
         timed) in PADDED_CASES:
        q, k, v, mask = _attention_inputs(dev, b, h, t, s, d, dtype, lengths,
                                          seed=len(name))
        dout = torch.randn((b, h, t, d), generator=torch.Generator()
                           .manual_seed(len(name) + 1)).to(dev, dtype)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        _dispatch.reset_launch_counts()
        out = flash_attention(*leaves, causal=causal, key_mask=mask)
        grads = torch.autograd.grad(out, leaves, dout)
        counts = _dispatch.launch_counts()
        want = reference_attention(q, k, v, causal=causal, key_mask=mask)
        plain = [x.float().requires_grad_() for x in (q, k, v)]
        want_g = torch.autograd.grad(
            reference_attention(*plain, causal=causal, key_mask=mask), plain,
            dout.float())
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        errs = {}
        ok = (err <= TOL[dtype] and counts == dict.fromkeys(FLASH_KERNELS, 1)
              and out.shape == q.shape)
        for which, a, w in zip(("dq", "dk", "dv"), grads, want_g):
            errs[which] = float((a.float() - w).abs().max())
            ok &= (a.shape == w.shape and bool(torch.isfinite(a).all())
                   and errs[which] <= TOL_BWD[dtype]
                   * max(1.0, float(w.abs().max())))
        log(f"[kernels] padded {name} (D={d} run at "
            f"{kernel_head_size(d)}): forward max_abs_err {err:.3e} (tol "
            f"{TOL[dtype]:.0e}); dq {errs['dq']:.3e} dk {errs['dk']:.3e} dv "
            f"{errs['dv']:.3e} (tol {TOL_BWD[dtype]:.0e} x max(1, |plain|))"
            f"; launches {counts} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: padded head case {name} failed")
        row = {"shape": [b, h, t, s, d], "dtype": str(dtype)[6:],
               "causal": causal, "run_at_head_size": kernel_head_size(d),
               "max_abs_err": err, "max_abs_err_bwd": errs,
               "launches": counts}
        if timed:
            row.update(_time_padded(q, k, v, mask, dout, causal, lengths))
            log(f"[kernels] padded {name}: forward kernel "
                f"{row['kernel_ms']:.4f} ms (device "
                f"{row['kernel_device_ms']:.4f}; with the pad and slice "
                f"{row['wrapper_ms']:.4f}), plain {row['plain_ms']:.4f}, "
                f"sdpa at D={d} {row['library_ms']:.4f}, bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']}); backward delta "
                f"{row['flash_bwd_delta_ms']:.4f} dkv "
                f"{row['flash_bwd_dkv_ms']:.4f} dq {row['flash_bwd_dq_ms']:.4f}"
                f" ms (device), pair with delta {row['pair_ms']:.4f} ms, "
                f"plain {row['bwd_plain_ms']:.4f}, sdpa backward "
                f"{row['bwd_library_ms']:.4f}; bounds delta "
                f"{row['flash_bwd_delta_bound_ms']:.4f} dkv "
                f"{row['flash_bwd_dkv_bound_ms']:.4f} dq "
                f"{row['flash_bwd_dq_bound_ms']:.4f}")
        results[name] = row
    return results


def _time_padded(q, k, v, mask, dout, causal, lengths):
    """Times at a padded head size: the forward kernel on the zero-padded
    tensors with D's scale, flash_attention with its pad and slice, the
    plain forward and SDPA at D (CUDA events; the kernel's device time by
    the profiler); the backward pair with its delta on the padded tensors
    (CUDA events, and each kernel's device time by the profiler), the
    plain backward and SDPA's backward at D. Bounds: the work at D
    (``_bound``, ``_bound_bwd``, ``_bound_delta``)."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_cuda,
        flash_attention_cuda,
        kernel_head_size,
        reference_attention,
        reference_attention_bwd,
        reference_attention_lse,
    )

    b, h, t, d = q.shape
    s = k.shape[2]
    pad = (0, kernel_head_size(d) - d)
    qp, kp, vp, gp = (F.pad(x, pad).contiguous() for x in (q, k, v, dout))
    scale = d ** -0.5
    out_p, lse_p = flash_attention_cuda(qp, kp, vp, mask, causal=causal,
                                        scale=scale, return_lse=True)
    out, lse = reference_attention_lse(q, k, v, causal=causal, key_mask=mask)
    fns = {
        "kernel": lambda: flash_attention_cuda(qp, kp, vp, mask,
                                               causal=causal, scale=scale),
        "wrapper": lambda: flash_attention(q, k, v, causal=causal,
                                           key_mask=mask),
        "plain": lambda: reference_attention(q, k, v, causal=causal,
                                             key_mask=mask),
        "library": _sdpa_call(q, k, v, mask, causal),
        "pair": lambda: flash_attention_bwd_cuda(
            qp, kp, vp, mask, out_p, lse_p, gp, causal=causal, scale=scale),
        "bwd_plain": lambda: reference_attention_bwd(
            q, k, v, mask, out, lse, dout, causal=causal),
    }
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    sdpa_out = _sdpa_call(*leaves, mask, causal)()
    fns["bwd_library"] = lambda: torch.autograd.grad(
        sdpa_out, leaves, dout, retain_graph=True)
    runs = {k: [] for k in fns}
    with torch.no_grad():
        for which in ("kernel", "wrapper", "plain", "library", "library",
                      "plain", "wrapper", "kernel"):
            runs[which].append(_time_ms(fns[which]))
    for which in ("pair", "bwd_plain", "bwd_library", "bwd_library",
                  "bwd_plain", "pair"):
        runs[which].append(_time_ms(fns[which], iters=50, warmup=5))
    row = {f"{w}_ms": min(r) for w, r in runs.items()}
    row.update({f"{w}_ms_runs": r for w, r in runs.items()})
    row["kernel_device_ms"] = _device_ms(fns["kernel"])
    by_kernel = _device_us_by_kernel(fns["pair"], iters=20)
    for kernel in ("flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq"):
        row[f"{kernel}_ms"] = sum(us for name, us in by_kernel.items()
                                  if f"{kernel}_kernel" in name) / 1e3
    bound_ms, bound_by, ops, nbytes, cores_ms = _bound(
        b, h, t, s, d, q.dtype, causal, lengths)
    row.update({"bound_ms": bound_ms, "bound_by": bound_by,
                "bound_cuda_cores_ms": cores_ms, "ops": ops,
                "bytes": nbytes})
    for kernel in ("flash_bwd_dkv", "flash_bwd_dq"):
        k_ms, k_by, _, _, k_cores = _bound_bwd(kernel, b, h, t, s, d,
                                               q.dtype, causal, lengths)
        row.update({f"{kernel}_bound_ms": k_ms, f"{kernel}_bound_by": k_by,
                    f"{kernel}_bound_cuda_cores_ms": k_cores})
    d_ms, d_by, _, _ = _bound_delta(b, h, t, d, q.dtype)
    row.update({"flash_bwd_delta_bound_ms": d_ms,
                "flash_bwd_delta_bound_by": d_by})
    return row


# LearnedSelfAttention (4 learned queries: the forward kernel at T = 4)
# and RecurrentAttention on the card, forward and backward with a key
# mask, against their plain route: LearnedSelfAttention with the plain
# attention in the kernels' place, RecurrentAttention (plain torch on
# both devices, no hand kernel) against the same layer on the CPU. Both
# float32: outputs and every gradient to TOL_LAYER of max(1, |plain|).
LAYER_N, LAYER_T, LAYER_E = 64, 10, 64
TOL_LAYER = 1e-5


def phase_attention_layers(dev):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reference_attention,
    )
    from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod
    from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

    g = torch.Generator().manual_seed(SEED)
    x = torch.randn((LAYER_N, LAYER_T, LAYER_E), generator=g)
    lengths = torch.randint(1, LAYER_T + 1, (LAYER_N,), generator=g)
    mask = (torch.arange(LAYER_T)[None, :] < lengths[:, None]).float()
    w_out = torch.randn((LAYER_N, LAYER_T, LAYER_E), generator=g)
    results = {}
    for name, layer, want_launches in (
            ("learned_self_attention_q4",
             attention_mod.LearnedSelfAttention(num_heads=4, n_queries=4),
             dict.fromkeys(FLASH_KERNELS, 1)),
            ("recurrent_attention",
             attention_mod.RecurrentAttention(units=LAYER_E, num_heads=4),
             {})):
        params, _ = layer.init(torch.Generator().manual_seed(1),
                               (LAYER_T, LAYER_E), torch.float32)

        def run(device, plain_attention=False):
            p = {k: a.to(device).requires_grad_() for k, a in params.items()}
            xd = x.to(device).requires_grad_()
            ctx = (mock.patch.object(attention_mod, "flash_attention",
                                     reference_attention)
                   if plain_attention else contextlib.nullcontext())
            with ctx:
                y, _ = layer.apply(p, {}, xd, mask=mask.to(device))
                w = w_out[:, :y.shape[1], :y.shape[2]].to(device)
                grads = torch.autograd.grad((y * w).sum(),
                                            [xd, *p.values()])
            return [y.detach(), *grads], ["y", "x", *p]

        _dispatch.reset_launch_counts()
        got, names = run(dev)
        counts = _dispatch.launch_counts()
        want, _ = (run(dev, True) if want_launches else run("cpu"))
        torch.cuda.synchronize()
        errs = {n: float((a.cpu() - w.cpu()).abs().max())
                / max(1.0, float(w.abs().max()))
                for n, a, w in zip(names, got, want)}
        ok = counts == want_launches and max(errs.values()) <= TOL_LAYER
        plain = ("the plain attention on the card" if want_launches
                 else "the same layer on the CPU")
        log(f"[layers] {name}: output {tuple(got[0].shape)}, launches "
            f"{counts}; worst of output and gradients vs {plain}: "
            f"{max(errs, key=errs.get)} {max(errs.values()):.2e} of max(1, "
            f"|plain|) (tol {TOL_LAYER:.0e}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                             "route or missed its kernels")
        results[name] = {"launches": counts, "err_frac": errs,
                         "shape": [LAYER_N, LAYER_T, LAYER_E]}
    return results


# -- 19. seq2seq training ------------------------------------------------------

# examples/seq2seq_attention.py at its own widths (vocab 12, T=10, hidden
# 64, 1024 sequences, 600 full-batch Adam(3e-3) steps): nothing cut
S2S_VOCAB, S2S_T, S2S_HIDDEN, S2S_QPOS = 12, 10, 64, 64
S2S_N, S2S_STEPS, S2S_LR = 1024, 600, 3e-3
S2S_EVAL_ROWS = 64
S2S_ACCURACY = 0.9  # the example's own check after 600 steps
# the kernels one training step launches: one CrossAttention, the two
# directions of the biLSTM
S2S_STEP_LAUNCHES = {"flash_fwd": 1, "flash_bwd_delta": 1,
                     "flash_bwd_dkv": 1, "flash_bwd_dq": 1, "lstm_fwd": 2,
                     "lstm_bwd": 2}


def seq2seq_config(backend="xla"):
    """examples/seq2seq_attention.py's ``build()`` in the port's classes,
    through its JSON: the dict the JAX package's ``config_to_dict`` writes
    for the example (``tests/test_torch_seq2seq.py`` holds them equal).
    The biLSTM's ``backend`` is the JAX default "xla" (the sweeps, the
    CUDA kernels on the card); "plain" gives the eager loop."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.config import (
        GraphConfig,
        GraphVertex,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.train.updaters import Adam

    verts = {
        "embed": GraphVertex(kind="layer", inputs=["tokens"],
                             layer=L.Embedding(vocab_size=S2S_VOCAB,
                                               units=S2S_HIDDEN)),
        "enc": GraphVertex(kind="layer", inputs=["embed"],
                           layer=L.Bidirectional(L.LSTM(
                               units=S2S_HIDDEN // 2, backend=backend))),
        "queries": GraphVertex(kind="layer", inputs=["qpos"],
                               layer=L.PositionalEmbedding(max_len=S2S_T)),
        "xatt": GraphVertex(kind="layer", inputs=["queries", "enc"],
                            layer=L.CrossAttention(num_heads=4,
                                                   out_size=S2S_HIDDEN)),
        "out": GraphVertex(kind="layer", inputs=["xatt"],
                           layer=L.RnnOutputLayer(units=S2S_VOCAB,
                                                  activation="softmax",
                                                  loss="mcxent")),
    }
    cfg = GraphConfig(
        net=NeuralNetConfiguration(seed=0, updater=Adam(S2S_LR)),
        inputs=["tokens", "qpos"],
        input_shapes={"tokens": (S2S_T,), "qpos": (S2S_T, S2S_QPOS)},
        vertices=verts, outputs=["out"])
    return GraphConfig.from_json(cfg.to_json())


def seq2seq_batch(n=S2S_N, seed=SEED):
    """The example's data: random tokens in [2, vocab), the targets the
    sequences reversed, zero ``qpos`` carriers; → (batch, targets)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, S2S_VOCAB, size=(n, S2S_T)).astype(np.int32)
    targets = tokens[:, ::-1]
    eye = np.eye(S2S_VOCAB, dtype=np.float32)
    qpos = np.zeros((n, S2S_T, S2S_QPOS), np.float32)
    return ({"features": {"tokens": tokens, "qpos": qpos},
             "labels": {"out": eye[targets]}}, np.ascontiguousarray(targets))


def _seq2seq_model(dev, backend="xla"):
    from deeplearning4j_tpu_torch.nn.model import GraphModel

    return GraphModel(seq2seq_config(backend), device=dev)


def _reversal_accuracy(model, variables, batch, targets):
    """The example's check: argmax of the first S2S_EVAL_ROWS rows'
    outputs against the reversed sequences, per token."""
    feats = {k: a[:S2S_EVAL_ROWS] for k, a in batch["features"].items()}
    out = model.output(variables, feats)["out"]
    pred = out.argmax(-1).cpu().numpy()
    return float((pred == targets[:S2S_EVAL_ROWS]).mean())


def phase_seq2seq_train(dev, smi):
    """The example's graph, built from its config JSON, trained by
    Trainer.fit: one loss and every gradient through the kernels against
    the plain route (plain attention, the eager LSTM loop) on the same
    weights; 600 full-batch steps with S2S_STEP_LAUNCHES a step, a falling
    loss, the example's reversal accuracy and a checkpoint restored
    bit-equal; evaluate_model against that accuracy; the step's time."""
    from deeplearning4j_tpu_torch.evaluation import evaluate_model
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reference_attention,
    )
    from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device

    model = _seq2seq_model(dev)
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    batch, targets = seq2seq_batch()
    on_dev = batch_to_device(batch, dev)
    log(f"[seq2seq_train] examples/seq2seq_attention.py: "
        f"{model.num_params(trainer.variables(ts0)):,} parameters, order "
        f"{model.order}, {S2S_N} sequences of {S2S_T}, vocab {S2S_VOCAB}, "
        f"hidden {S2S_HIDDEN}, Adam({S2S_LR})")

    # 1. one loss and gradient: kernels vs the plain route
    with _plain_rnn_guard() as plain_calls:
        _dispatch.reset_launch_counts()
        loss_k, g_kernel = _loss_and_grads(trainer, ts0.params, on_dev, dev,
                                           SEED)
        counts = _dispatch.launch_counts()
    if counts != S2S_STEP_LAUNCHES or plain_calls:
        raise SystemExit(f"chip_smoke: one seq2seq loss+grad launched "
                         f"{counts} with {len(plain_calls)} plain LSTM "
                         f"calls; want {S2S_STEP_LAUNCHES} and none")
    plain_trainer = Trainer(_seq2seq_model(dev, "plain"))
    with mock.patch.object(attention_mod, "flash_attention",
                           reference_attention):
        _dispatch.reset_launch_counts()
        loss_p, g_plain = _loss_and_grads(plain_trainer, ts0.params, on_dev,
                                          dev, SEED)
        if _dispatch.launch_counts():
            raise SystemExit("chip_smoke: the plain route launched "
                             f"{_dispatch.launch_counts()}")
    loss_rel, worst_name, worst = _check_grads("seq2seq_train", loss_k,
                                               loss_p, g_kernel, g_plain)
    del g_kernel, g_plain

    # 2. Trainer.fit, 600 full-batch steps; 3. checkpoint restore
    with _plain_rnn_guard() as plain_calls:
        fit = _fit_and_restore("seq2seq_train", trainer, ts0, [on_dev],
                               S2S_STEPS, dev)
    ts, counts, losses = fit["ts"], fit["launches"], fit["losses"]
    want = {k: n * S2S_STEPS for k, n in S2S_STEP_LAUNCHES.items()}
    if ts.step != S2S_STEPS or counts != want or plain_calls:
        raise SystemExit(f"chip_smoke: fit launched {counts} over {ts.step}"
                         f" steps with {len(plain_calls)} plain LSTM calls; "
                         f"want {want} and none")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    variables = trainer.variables(ts)
    accuracy = _reversal_accuracy(model, variables, on_dev, targets)
    eye = np.eye(S2S_VOCAB, dtype=np.float32)
    ev = evaluate_model(model, variables, [{
        "features": {k: a[:S2S_EVAL_ROWS]
                     for k, a in on_dev["features"].items()},
        "labels": eye[targets[:S2S_EVAL_ROWS]]}], S2S_VOCAB)
    log(f"[seq2seq_train] loss {first:.4f} (first 3 steps) -> {last:.4f} "
        f"(last 3); reversal accuracy on the first {S2S_EVAL_ROWS} rows "
        f"{accuracy:.4f} (must be > {S2S_ACCURACY}); evaluate_model "
        f"accuracy {ev.accuracy():.4f} over {int(ev.confusion().sum())} "
        f"tokens")
    if not (np.all(np.isfinite(losses)) and last < first
            and accuracy > S2S_ACCURACY
            and abs(ev.accuracy() - accuracy) < 1e-6):
        raise SystemExit("chip_smoke: the seq2seq model did not learn to "
                         "reverse its sequences")

    # 4. where one step's time goes
    breakdown = _step_breakdown(trainer, ts, on_dev,
                                tuple(S2S_STEP_LAUNCHES))
    _require_kernel_time("seq2seq step", breakdown)
    log(f"[seq2seq_train] one step: {breakdown}")
    step_ms = fit["median_step_ms"]
    log(f"[seq2seq_train] median step {step_ms:.3f} ms, "
        f"{S2S_N / (step_ms / 1e3):,.0f} sequences/s, peak memory "
        f"{fit['peak_memory_gib']:.3f} GiB, on {smi}")
    return {
        "model": "examples/seq2seq_attention.py", "vocab": S2S_VOCAB,
        "seq_len": S2S_T, "hidden": S2S_HIDDEN, "batch": S2S_N,
        "steps": ts.step, "launches": counts,
        "launches_per_step": S2S_STEP_LAUNCHES,
        "loss_first3": first, "loss_last3": last,
        "losses_every_50": losses[::50],
        "reversal_accuracy": accuracy,
        "evaluate_model_accuracy": ev.accuracy(),
        "median_step_ms": step_ms,
        "sequences_per_s": S2S_N / (step_ms / 1e3),
        "peak_memory_gib": fit["peak_memory_gib"],
        "fit_seconds": fit["fit_seconds"],
        "kernel_vs_plain": {"loss_kernel": loss_k, "loss_plain": loss_p,
                            "loss_rel": loss_rel,
                            "worst_grad_leaf": worst_name,
                            "worst_grad_frac": worst},
        "checkpoint_next_loss": fit["checkpoint_next_loss"],
        "step_breakdown": breakdown, "card": smi,
    }, model, variables


# -- 20. seq2seq serving -------------------------------------------------------

S2S_REQUESTS = 200
# served probabilities vs the plain forward (plain attention, the eager
# LSTM loop), float32: the kernels' ~1e-6 differences through a softmax
TOL_S2S_PROBS = 1e-4


def _s2s_probs(model, variables, feats):
    """The served function: {"tokens", "qpos"} → [n, T, vocab]."""
    return model.output(variables, feats)["out"]


def phase_seq2seq_serve(dev, smi, model, variables):
    from functools import partial

    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reference_attention,
    )
    from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry,
        ModelServer,
        ServingClient,
        spec,
    )

    reg = ModelRegistry()
    entry = reg.register(
        "seq2seq", partial(_s2s_probs, model), variables,
        input_spec={"tokens": spec((S2S_T,), np.int32, high=S2S_VOCAB),
                    "qpos": spec((S2S_T, S2S_QPOS), np.float32)},
        mode="batched", max_batch_size=8)
    server = ModelServer(reg, port=0)
    t0 = time.monotonic()
    server.start(warm=True)
    client = ServingClient(server.url, timeout=120)
    if not client.ready()["ready"]:
        raise SystemExit("chip_smoke: /readyz not ready after warm start")
    log(f"[seq2seq_serve] server warm and ready in "
        f"{time.monotonic() - t0:.2f} s")
    requests = [seq2seq_batch(1 + i % 4, 6000 + i)[0]["features"]
                for i in range(S2S_REQUESTS)]
    latencies = [0.0] * S2S_REQUESTS

    def call(i):
        t_start = time.monotonic()
        resp = client.predict("seq2seq", {
            "tokens": requests[i]["tokens"].tolist(),
            "qpos": requests[i]["qpos"].tolist()})
        latencies[i] = time.monotonic() - t_start
        return resp

    with _plain_rnn_guard() as plain_calls:
        _dispatch.reset_launch_counts()
        before = entry.batch_stats()
        t0 = time.monotonic()
        with ThreadPoolExecutor(CLIENT_THREADS) as pool:
            responses = list(pool.map(call, range(S2S_REQUESTS)))
        wall = time.monotonic() - t0
        counts = _dispatch.launch_counts()
        after = entry.batch_stats()
    batches = after["batches"] - before["batches"]
    rows = after["rows"] - before["rows"]
    drained = server.stop()
    want = {"flash_fwd": batches, "lstm_fwd": 2 * batches}
    log(f"[seq2seq_serve] {S2S_REQUESTS} requests ({rows} sequences) in "
        f"{wall:.3f} s over {batches} batches; launches {counts}; plain "
        f"ops/rnn.lstm calls on the card {len(plain_calls)}; "
        f"drained={drained}")
    if batches < 1 or counts != want or plain_calls or not drained:
        raise SystemExit(f"chip_smoke: {counts} for {batches} batches, "
                         f"{len(plain_calls)} plain LSTM calls, drained="
                         f"{drained}; want {want}, none and a drain")

    got = [np.asarray(r["outputs"], np.float64) for r in responses]
    for req, out in zip(requests, got):
        if out.shape != (req["tokens"].shape[0], S2S_T, S2S_VOCAB) or not (
                np.all(np.isfinite(out))
                and np.abs(out.sum(-1) - 1).max() <= 1e-5):
            raise SystemExit(f"chip_smoke: bad served output {out.shape}")
    feats = {k: np.concatenate([r[k] for r in requests])
             for k in ("tokens", "qpos")}
    with mock.patch.object(attention_mod, "flash_attention",
                           reference_attention):
        want_probs = _s2s_probs(_seq2seq_model(dev, "plain"), variables,
                                feats).double().cpu().numpy()
    worst = float(np.abs(np.concatenate(got) - want_probs).max())
    log(f"[seq2seq_serve] served probabilities vs the plain forward: "
        f"max_abs_err {worst:.3e} (tol {TOL_S2S_PROBS:.0e}) over "
        f"{feats['tokens'].shape[0]} sequences")
    if worst > TOL_S2S_PROBS:
        raise SystemExit("chip_smoke: served seq2seq outputs disagree with "
                         "the plain forward")
    feats8 = {k: torch.from_numpy(a[:8]).to(dev) for k, a in feats.items()}
    breakdown = _forward_breakdown(
        lambda: _s2s_probs(model, variables, feats8), "flash_fwd")
    log(f"[seq2seq_serve] one bucket-8 forward: {breakdown}")
    lat_ms = np.asarray(latencies) * 1e3
    log(f"[seq2seq_serve] {S2S_REQUESTS / wall:.1f} requests/s "
        f"({rows / wall:.1f} sequences/s), p50 "
        f"{np.percentile(lat_ms, 50):.2f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.2f} ms over {S2S_REQUESTS} requests, "
        f"{CLIENT_THREADS} clients, on {smi}")
    return {"model": "examples/seq2seq_attention.py",
            "requests": S2S_REQUESTS, "rows": rows,
            "client_threads": CLIENT_THREADS, "batches": batches,
            "launches": counts, "requests_per_s": S2S_REQUESTS / wall,
            "rows_per_s": rows / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "max_abs_err_probs": worst, "forward_bucket8": breakdown,
            "card": smi}


def _delta_entry(bwd_cases, training, gpt_training, s2s_training,
                 smi) -> dict:
    """The kernels line's entry of flash_bwd_delta: the main row is the
    float32 BERT-base training shape, as for dkv and dq."""
    timed = {c: r for c, r in bwd_cases.items() if "flash_bwd_delta_ms" in r}
    main_row = timed["bert_base_train_fp32"]
    return {
        "name": "flash_bwd_delta", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/flash_bwd.cu",
        "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:389",
        "replaces_is": "the rowsum(dO*O) that _flash_bwd_impl leaves to "
                       "XLA before its two Pallas kernels (no pallas_call)",
        "launches": training["launches"]["flash_bwd_delta"],
        "launches_by_path": {
            "training": training["launches"]["flash_bwd_delta"],
            "gpt_training": gpt_training["launches"]["flash_bwd_delta"],
            "seq2seq_training":
                s2s_training["launches"]["flash_bwd_delta"]},
        "launches_per_step": (training["launches"]["flash_bwd_delta"]
                              / training["steps"]),
        "max_abs_err": main_row["max_abs_err"]["delta"],
        "max_abs_err_by_case": {c: r["max_abs_err"]["delta"]
                                for c, r in bwd_cases.items()},
        "err_frac_by_case": {c: r["delta_err_frac"]
                             for c, r in bwd_cases.items()},
        "ms": main_row["flash_bwd_delta_ms"],
        "kernel_event_ms": main_row["delta_kernel_ms"],
        "plain_ms": main_row["delta_plain_ms"],
        "library_ms": main_row["delta_library_ms"],
        "library_is": "torch.linalg.vecdot (float32; in bf16 it sums into "
                      "bf16, not the same function)",
        "bound_ms": main_row["flash_bwd_delta_bound_ms"],
        "bound_by": main_row["flash_bwd_delta_bound_by"],
        "by_case": {c: {
            "ms": r["flash_bwd_delta_ms"],
            "kernel_event_ms": r["delta_kernel_ms"],
            "plain_ms": r["delta_plain_ms"],
            "library_ms": r["delta_library_ms"],
            "bound_ms": r["flash_bwd_delta_bound_ms"],
            "bound_by": r["flash_bwd_delta_bound_by"]}
            for c, r in timed.items()},
        "ms_is": "device time per launch (torch.profiler)",
        "shape": main_row["shape"], "card": smi,
    }


def main() -> int:
    t_start = time.monotonic()
    dev, smi = phase_device()
    phase_build()
    from deeplearning4j_tpu_torch.kernels import _dispatch

    batches = _train_batches()
    train_lengths = [int(n) for n in
                     batches[0]["features"]["mask"].sum(axis=1)]
    cases = phase_kernels(dev, train_lengths)
    bwd_cases = phase_kernels_bwd(dev, train_lengths)
    padded_cases = phase_kernels_padded(dev)
    layer_cases = phase_attention_layers(dev)
    # before BERT's long profiled phases: after them the profiler kept 2 of
    # 5 records of a persistent LSTM sweep (seen on the card), all 5 before
    lstm_cases = phase_kernels_lstm(dev)
    # the persistent LSTM kernels are counted by the profiler here too, so
    # before BERT's phases as well
    char_tbptt, tbptt_model, tbptt_vars = phase_charrnn_tbptt(dev, smi)
    char_gen = phase_charrnn_generate(dev, smi, tbptt_model, tbptt_vars)
    del tbptt_model, tbptt_vars
    serving = phase_slice(dev, smi)
    training = phase_train(dev, smi, batches)
    char_serving = phase_charrnn_serving(dev, smi)
    char_training = phase_charrnn_train(dev, smi)
    s2s_training, s2s_model, s2s_vars = phase_seq2seq_train(dev, smi)
    s2s_serving = phase_seq2seq_serve(dev, smi, s2s_model, s2s_vars)
    del s2s_model, s2s_vars
    gru_cases = phase_kernels_gru(dev)
    gru_serving = phase_chargru_serving(dev, smi)
    gru_training, gru_grads = phase_chargru_train(dev, smi)
    gru_tbptt = phase_gru_tbptt(dev, smi)
    bitmap = phase_bitmap(dev, smi, serving["num_params"], gru_grads)
    del gru_grads
    lenet_training = phase_lenet_train(dev, smi)
    resnet_training, resnet_model, resnet_vars = phase_resnet_train(dev, smi)
    resnet_serving = phase_resnet_serve(dev, smi, resnet_model, resnet_vars)
    del resnet_model, resnet_vars
    gpt_training, gpt_model, gpt_vars = phase_gpt_train(dev, smi)
    gpt_serving = phase_gpt_serve(dev, smi, gpt_model, gpt_vars)
    del gpt_model, gpt_vars
    main_case = cases["bert_base_serving_fp32"]
    fwd = {
        "name": "flash_fwd", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:115",
        "launches": serving["flash_fwd_launches"],
        "launches_by_path": {"serving": serving["flash_fwd_launches"],
                             "training": training["launches"]["flash_fwd"],
                             "gpt_training":
                                 gpt_training["launches"]["flash_fwd"],
                             "gpt_serving": gpt_serving["kernel_launches"]
                                 .get("flash_fwd", 0),
                             "seq2seq_training":
                                 s2s_training["launches"]["flash_fwd"],
                             "seq2seq_serving":
                                 s2s_serving["launches"]["flash_fwd"]},
        "launches_per_forward": (serving["flash_fwd_launches"]
                                 / serving["batches"]),
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"], "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "library_ms": main_case["library_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "bound_cuda_cores_ms": main_case["bound_cuda_cores_ms"],
        "bound_is": "the floor on the tensor cores: max(bytes, operations "
                    "at the dtype's tensor-core rate, float32 as three TF32 "
                    "passes)",
        "cases": cases,
        "padded_head_cases": padded_cases,
        "padded_head_is": "head sizes the kernels lack, zero-padded to the "
                          "next kernel size by flash_attention (pad_head); "
                          "bound_ms and library_ms (SDPA) at the original D",
        "attention_layers": layer_cases, "card": smi,
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
            "launches_by_path": {
                "training": training["launches"][kernel],
                "gpt_training": gpt_training["launches"][kernel],
                "seq2seq_training": s2s_training["launches"][kernel]},
            "launches_per_step": (training["launches"][kernel]
                                  / training["steps"]),
            "max_abs_err": err(main_row),
            "max_abs_err_by_case": {c: err(r) for c, r in bwd_cases.items()},
            "ms": main_row[f"{kernel}_ms"],
            "plain_ms": main_row["plain_ms"],
            "library_ms": main_row["library_ms"],
            "bound_ms": main_row[f"{kernel}_bound_ms"],
            "bound_by": main_row[f"{kernel}_bound_by"],
            "bound_cuda_cores_ms": main_row[
                f"{kernel}_bound_cuda_cores_ms"],
            "bound_is": "the floor on the tensor cores: max(bytes, "
                        "operations at the dtype's tensor-core rate, "
                        "float32 as three TF32 passes)",
            "causal_gpt": {c: {
                "ms": r[f"{kernel}_ms"], "plain_ms": r["plain_ms"],
                "library_ms": r["library_ms"],
                "bound_ms": r[f"{kernel}_bound_ms"],
                "bound_by": r[f"{kernel}_bound_by"],
                "max_abs_err": err(r)}
                for c, r in bwd_cases.items() if "library_ms" in r
                and r["causal"]},
            "by_dtype": {r["dtype"]: {
                "ms": r[f"{kernel}_ms"], "pair_ms": r["pair_ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "bound_ms": r[f"{kernel}_bound_ms"],
                "bound_by": r[f"{kernel}_bound_by"],
                "bound_cuda_cores_ms": r[f"{kernel}_bound_cuda_cores_ms"],
                "max_abs_err": err(r),
                "library_max_abs_err": r["sdpa_max_abs_err"]}
                for r in timed.values()},
            "ms_is": "device time per launch (torch.profiler)",
            "plain_and_library_cover": "dq, dk and dv together: "
                                       "reference_attention_bwd, and "
                                       "scaled_dot_product_attention's "
                                       "backward",
            "shape": main_row["shape"], "card": smi,
        })
    entries.append(_delta_entry(bwd_cases, training, gpt_training,
                                s2s_training, smi))
    entries += _lstm_entries(lstm_cases, char_serving, char_training,
                             s2s_serving, s2s_training, char_tbptt,
                             char_gen, smi)
    entries += _gru_entries(gru_cases, gru_serving, gru_training, gru_tbptt,
                            bitmap, smi)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"char_rnn_serving": char_serving}), flush=True)
    print(json.dumps({"char_rnn_training": char_training}), flush=True)
    print(json.dumps({"char_rnn_tbptt": char_tbptt}), flush=True)
    print(json.dumps({"char_rnn_generate": char_gen}), flush=True)
    print(json.dumps({"char_gru_serving": gru_serving}), flush=True)
    print(json.dumps({"char_gru_training": gru_training}), flush=True)
    print(json.dumps({"char_gru_tbptt": gru_tbptt}), flush=True)
    print(json.dumps({"bitmap": bitmap}), flush=True)
    print(json.dumps({"lenet_training": lenet_training}), flush=True)
    print(json.dumps({"resnet_training": resnet_training}), flush=True)
    print(json.dumps({"resnet_serving": resnet_serving}), flush=True)
    print(json.dumps({"gpt_training": gpt_training}), flush=True)
    print(json.dumps({"gpt_serving": gpt_serving}), flush=True)
    print(json.dumps({"seq2seq_training": s2s_training}), flush=True)
    print(json.dumps({"seq2seq_serving": s2s_serving}), flush=True)
    log(f"[done] {time.monotonic() - t_start:.1f} s; launch counts now "
        f"{_dispatch.launch_counts()}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
