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
   (batched, max batch 8), 25 requests of 1–2 NHWC images as JSON from
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

24. GPT-2-small serving with prefix-KV reuse — the gpt_serve engine with
   prefix_cache=True, a ServingMetrics bundle and a warmup manifest behind
   ModelServer: 64 streamed requests from 8 client threads, each one of 2
   fixed 256-id system prompts and a distinct 8–32-id suffix, half greedy.
   Hits must equal 64 less the publishes, the /metrics scrape's prefix
   counters the store's describe(), no shape may run first after warm
   (the grafts included), every greedy token must be the full forward's
   argmax and every greedy hit's tokens those of the same prompt served by
   an engine without a store (parting only at a tie); TTFT p50/p99 for
   hits and misses, the suffix feeds a hit took, the store's bytes; then
   the same requests from the same clients through that store-less engine
   behind a server of its own, its TTFT p50/p99 and tokens/s beside the
   store's.
25. warm restart — BERT-base and GPT-2-small behind one ModelServer with
   a warmup manifest, a traffic mix on a strict subset of the buckets,
   stop; a fresh server from the manifest file with warm_async=True,
   /readyz polled (503 progress bodies) until 200; the warm ran fewer
   shapes than the full vocabulary, the replayed mix runs no shape first
   after warm on either plane, BERT outputs bit-equal to the first
   server's with 12 flash_fwd launches a dispatched batch; warm seconds,
   full against manifest. Phases 24 and 25 run after phase 17.
26. loss guard — in a child process, sparse_softmax_cross_entropy on CUDA
   tensors with class ids -1 and C raises cleanly and the card goes on
   computing in that process (run right after phase 1). Phase 16 also
   times a mixed-precision GPT step with the loss's range check and
   without it, step by step in alternating pairs, and reads one step of
   each in turns through the profiler (device busy ms, idle share).

27. Xception training — the zoo's xception (299x299x3, 1000 classes,
   22,855,952 parameters, 34 SeparableConv2D), batch 32 of
   bench_resnet50's data at 299, Adam 1e-3: one step against the float64
   copy with ResNet-50's limits, 30 float32 and 30 mixed-precision steps
   of fit (falling loss, checkpoint restored bit-equal; the first mixed
   step's loss to 2e-2 of float32's), step time, images/s, peak memory,
   idle share, device time by class; then the CUDA kernels that run the
   34 depthwise convs (forward, dx, dW by input shape, from the profiler)
   and their share of a step.
28. Xception serving — the trained model behind ModelServer (max batch
   8), 20 requests of 1–2 images from 4 clients, every response against
   output_single to 1e-5; requests/s, rows/s, p50/p99, a 2-image
   request's JSON host time (536,406 numbers).
29. U-Net training — the zoo's unet at its defaults (128x128x3,
   base_filters 32, depth 4, one class: sigmoid / binary cross-entropy
   through PixelOutput), batch 16 of N(0, 1) images with one disc each,
   the disc's mask the label: one step against the float64 copy (LeNet-5's
   limits), 30 float32 steps of fit with the last loss below the first,
   pixel accuracy, step time, images/s, peak memory, idle share.
30. U-Net serving — behind ModelServer (max batch 8), 50 requests of 1–4
   disc images from 8 clients; every mask [n, 128, 128, 1] against
   output_single to 1e-5; requests/s, p50/p99, JSON host time.
31. zoo_cnn — alexnet, vgg16, vgg19, simplecnn, darknet19 and squeezenet
   at their zoo defaults, batch 4: the output (1e-4 of its max) and one
   step against a float64 copy on the card (the same dropout masks in both
   copies; LeNet-5's limits for AlexNet and SqueezeNet, ResNet-50's for
   the BatchNorm models and VGG16/19: see ZOO_PER_LEAF), then 3 steps of
   fit: median step ms, peak memory, one step's breakdown.
32. conv_layers — every layer class of nn/layers/conv.py the CNN slice
   ported, LayerNorm, LocalResponseNormalization, Dropout (eval) and
   PixelOutput once on the card at a small shape: forward and backward
   against the same layer in float64 on the card, to 1e-5 of the max, the
   outputs on the card. Phases 27–32 run after the rest.
33. samediff_bert — a frozen full-width BERT-base GraphDef (the port's
   bert_base weights from the seed as Const nodes, laid out as
   TensorFlow's convert_variables_to_constants_v2 lays out a tf.function
   of Bert.encode; 1,302 nodes) written with the port's codec
   (modelimport/tf_proto), decoded and imported with import_tf_graph onto
   the card (node count, op histogram, decode and import seconds);
   served by sd.output at batch 32 x 128 under
   torch.cuda.set_sync_debug_mode("error") (nothing copied to the host),
   the cached plan and the interpreter equal, the hidden states against
   the native Bert.encode and a float64 run of the same graph (TOL_HIDDEN
   each way); the weights promoted to VARIABLEs, a [CLS] head and the
   sparse cross-entropy added through the SameDiff API;
   calculate_gradients in float32 against float64 (ResNet-50's limits,
   each leaf's norm floored at TOL_GRAD_FLOOR of the largest); 20 Adam
   steps of sd.fit on one batch with a falling loss; save -> load with
   identical outputs and updater state, and the next fit step the same
   on both; serving and training tokens/s beside the native forward's,
   idle shares. No hand kernel runs on it (launch counts {}, read for
   serving and for fit).
34. convlstm_train — Keras 2's examples/conv_lstm.py next-frame model at
   its full width (4 × [ConvLSTM2D(40, 3×3, SAME) → BatchNorm], Conv3D(1,
   3×3×3) with sigmoid + binary cross-entropy, AdaDelta(rho 0.95, eps
   1e-7); 406,681 parameters) on the example's generate_movies (15 frames
   of 40 × 40, moving squares with noise rings, the next frame the
   target), batch 10: one step against the float64 copy (U-Net's limits),
   30 float32 steps of fit with a falling loss and a checkpoint restored
   bit-equal; step time, movies/s, frames/s, peak memory, idle share,
   device time by class.
35. convlstm_tbptt — the same model with backprop_type "tbptt" and
   tbptt_length 5 (3 windows a movie): one batch window by window in
   float32 and in the float64 copy from one state (each window's loss 1e-5
   relative, the carries handed on TOL_CARRY of their max); tbptt_length
   15 (one window) against the standard step, bit for bit (cuDNN held to
   its deterministic algorithms on both sides); 10 batches of fit with a
   checkpoint restored bit-equal; batch time, windows/s, a window's
   breakdown.
36. convlstm_serve — the trained model behind ModelServer (max batch 8),
   50 requests of 1–2 held-out movies from 4 clients, the frames back as
   JSON, each against output to 1e-5; requests/s, movies/s, p50/p99, the
   JSON host time of a 2-movie request beside a bucket-8 forward; then
   the example's rollout: 7 frames of a held-out movie, 8 more predicted
   one at a time by sending the whole track to the served model (an entry
   a track length), each new frame within TOL_ROLLOUT of its max of the
   float64 copy's rollout. Their launch counts must be {}.
37. yolo2_train — the zoo's yolo2 at its defaults (608x608x3, 80 classes,
   5 priors, 67,445,065 parameters; darknet19 with the reorg passthrough
   into Yolo2OutputLayer), batch 8 of synthetic boxes (_box_batch: N(0, 1)
   images with 1–3 boxes, DISC_SHIFT on the class's channel inside each,
   make_yolo_labels on the 19x19 grid), Adam 1e-3: one step against the
   float64 copy (ResNet-50's limits; the loss in two parts: the output
   layer's input to TOL_ZOO_OUT of its max and the layer's float32 loss of
   the float64 map to TOL_LOSS_REL, the end-to-end loss reported beside
   the float64 copy's own change under 2^-24 noise), 30 float32 steps of
   fit (the last loss below the first, a checkpoint restored bit-equal),
   the mixed-precision loss within 2e-2 of float32 at the trained weights
   on every batch (at init reported), 30 mixed-precision steps; step
   time, images/s, peak memory, idle share, device time by class.
38. tiny_yolo_train — the zoo's tiny_yolo (416x416x3, 20 classes,
   15,861,773 parameters), batch 8 of the same data: the same float64
   check and 30 steps; step time and idle share.
39. yolo2_serve — the trained YOLOv2 behind ModelServer (max batch 8), 12
   requests of 1–2 images from 4 clients, every grid [n, 19, 19, 5, 85]
   checked (xy and confidence in [0, 1], wh > 0, class probabilities
   summing to 1) and held against output_single on the request padded to
   the server's bucket it matches (TOL_SERVED, wh relative);
   decode_predictions (K = 20) and non_max_suppression of the served
   grids on the card against the CPU (classes and keep equal, boxes and
   scores to TOL_DECODE) and against a numpy decode and greedy sweep in
   stable order; tests/test_yolo.py's
   planted box found on the card; requests/s, p50/p99, JSON host time,
   a bucket-8 forward, detections kept an image. Phases 34–39 run last;
   their launch counts must be {}.

No TPU kernel lies on phases 13–15, 17, 24 and 27–39: the convolutions,
transposed convs and pools run in cuDNN and PyTorch (as the JAX package
leaves them to XLA: lax.conv_general_dilated, conv_transpose,
reduce_window), and generation's prefill and decode attend with plain
matmuls (as the JAX package's einsums, models/gpt.py:298-304, :370-375);
they launch none of the port's hand kernels. An imported graph's
attention (phase 33) is BatchMatMulV2 + Softmax, computed by
torch.matmul, as the JAX package's SameDiff leaves it to XLA. ConvLSTM2D
(phases 34–36) is, in the JAX package, a lax.scan over XLA convs
(deeplearning4j_tpu/nn/layers/recurrent.py:316-432); in the port an eager
loop over cuDNN convs. The YOLO family's output layer, decode and NMS
(phases 37–39) are plain jnp in the JAX package
(deeplearning4j_tpu/models/zoo/yolo.py:56-224) and plain torch here.

On the recurrent paths the plain ops/rnn.lstm and ops/rnn.gru must never
see a CUDA tensor (they are the plain paths the kernels are held against,
run separately).

It prints the kernels line ({"kernels": [...]}), the serving, training,
char-RNN (TBPTT and sampling too), char-GRU (TBPTT too), bitmap, LeNet-5,
ResNet-50, GPT-2-small (prefix serving and the warm restart too), loss
guard, seq2seq, Xception, U-Net, zoo_cnn, conv_layers, samediff_bert,
convlstm (training, TBPTT, serving) and YOLO (yolo2 training, tiny_yolo
training, yolo2 serving) lines,
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


_T_START = time.monotonic()


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the script
    started."""
    print(f"[{time.monotonic() - _T_START:6.1f} s] {msg}", flush=True)


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


def _window_start(recorded, iters) -> int:
    """The index of the first record of the traced calls in ``recorded``
    ((start µs, end µs, name), sorted): past the pause of TRACE_EDGE_S
    that opens the window, where a trace kept records of the warm-up call
    before it (seen on the card: 6 records for 5 calls of an LSTM sweep).
    0 where no pause of 0.8 TRACE_EDGE_S lies between kernels, where more
    than one does (a pause inside the function), or where more records
    lie before it than one call leaves."""
    pauses, end = [], None
    for k, (a, b, _) in enumerate(recorded):
        if end is not None and a - end >= 0.8 * TRACE_EDGE_S * 1e6:
            pauses.append(k)
        end = b if end is None else max(end, b)
    if len(pauses) == 1 and pauses[0] <= (len(recorded) - pauses[0]) / iters:
        return pauses[0]
    return 0


def _device_us_by_kernel(fn, iters=50, launches=None, spans=None) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, in µs,
    from the profiler. A dict passed as ``launches`` receives each
    kernel's launches per call, as the profiler counted them; a list
    passed as ``spans`` the (start, end, name) of every kernel of the
    ``iters`` recorded calls (for ``_busy_us``). The
    profiler traces one call as warm-up and discards it (tracing that
    starts with a burst of launches misses the first few), then records
    ``iters`` calls, TRACE_EDGE_S after its window opens and before it
    closes. Records of the warm-up call that a trace kept all the same
    are dropped (``_window_start``)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    recorded = []

    def ready(p):
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
    recorded.sort()
    opened = _window_start(recorded, iters)
    if opened:
        log(f"[kernels] the trace kept {opened} records of the warm-up "
            f"call; dropped")
    recorded = recorded[opened:]
    count, total = {}, {}
    for a, b, n in recorded:
        count[n] = count.get(n, 0) + 1
        total[n] = total.get(n, 0.0) + b - a
    out = {n: us / iters for n, us in total.items()}
    if launches is not None:
        for n, c in count.items():
            launches[n] = launches.get(n, 0) + c / iters
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
# layout copies (PyTorch's copy kernels, cuDNN's NCHW<->NHWC transforms),
# the convolutions (cuDNN's implicit-GEMM, FFT and Winograd kernels), the
# dense layers' GEMMs, reductions (BatchNorm's statistics, pools' sums,
# the loss), pooling, and the elementwise kernels (BatchNorm's normalise,
# activations, adds, casts, the updater); the rest as "other".
# cuBLAS names its Hopper/Ampere GEMMs ``sm80_xmma_gemm_*``, and cuDNN its
# implicit-GEMM convs ``*_xmma_fprop_implicit_gemm_*``: a conv is told by its
# conv keys, matched after the copies, and ``xmma`` alone says nothing of
# the class. cuDNN's FFT convs run complex products (cuBLAS's ``cf32``
# GEMMs, ``pointwise_mult_and_sum_complex``): they count as convs.
KERNEL_CLASSES = (
    ("copy", ("copy_kernel", "nchwtonhwc", "nhwctonchw")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "implicit",
              "cudnn", "winograd", "fft", "cf32", "complex")),
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


def _dropout_generator(batch, seed):
    """None (no dropout), or a generator from ``seed`` on the batch's
    device: two copies of a model handed generators of one seed draw the
    same dropout masks (the draws are float32 whatever the dtype)."""
    if seed is None:
        return None
    return torch.Generator(batch["features"].device).manual_seed(seed)


def _grads_by_name(trainer, params, state, batch, dropout_seed=None):
    """Loss, new layer state and every gradient leaf (by name) of the
    train step's differentiated function; dropout off, or drawn from
    ``dropout_seed``."""
    from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

    loss, new_state, _, grads = trainer._grad_of(
        params, state, batch, _dropout_generator(batch, dropout_seed))
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


def _vs_float64(tag, trainer, ts, batch, *, per_leaf_max: bool,
                dropout_seed=None, gate_loss=True) -> dict:
    """One loss, BatchNorm state and gradient of the float32 train step
    against the same model run in float64 on the card (cuDNN's float64
    convolutions), on the same batch (and, with ``dropout_seed``, the
    same dropout masks in both copies). The loss to TOL_LOSS_REL and the
    layer state to TOL_STATE of max(1, |float64|) always; the gradients
    either per leaf to TOL_GRAD_FRAC of the leaf's floored max
    (``per_leaf_max``, as _check_grads does) or, for a net too deep for
    that (ResNet-50: see TOL_GRAD_L2), by relative L2 error, beside the
    float64 copy's own change under float32-sized noise on its features
    and params (its loss's change reported too). ``gate_loss=False``: the
    loss is reported and the caller holds it (YOLO: _yolo_loss_parts)."""
    p64, s64 = _float64_copy(ts.params), _float64_copy(ts.model_state)
    b64 = dict(batch, features=batch["features"].double())
    loss32, state32, g32 = _grads_by_name(trainer, ts.params,
                                          ts.model_state, batch,
                                          dropout_seed)
    loss64, state64, g64 = _grads_by_name(trainer, p64, s64, b64,
                                          dropout_seed)
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
    ok = (loss_rel <= TOL_LOSS_REL or not gate_loss) and \
        state_err <= TOL_STATE
    if per_leaf_max:
        ok = ok and fracs[worst_name] <= TOL_GRAD_FRAC
    else:
        # the float64 copy's own spread: features and params each moved by
        # a relative N(0, 2^-24), float32's rounding
        gen = torch.Generator(batch["features"].device).manual_seed(SEED)

        def nudge(a):
            return a * (1 + 2.0 ** -24 * torch.randn(
                a.shape, generator=gen, device=a.device, dtype=a.dtype))

        loss_noise, _, g_noise = _grads_by_name(
            trainer, _tree_map(nudge, p64), s64,
            dict(b64, features=nudge(b64["features"])), dropout_seed)
        noise_leaf, noise_all = _l2_errors(g_noise, g64)
        out.update(noise_l2_err=noise_all,
                   noise_worst_l2_err=max(noise_leaf.values()),
                   noise_loss_rel=abs(loss_noise - loss64) / abs(loss64))
        ok = ok and leaf_l2[worst_l2] <= TOL_GRAD_L2 and \
            all_l2 <= TOL_GRAD_L2
        del g_noise
    loss_tol = f"tol {TOL_LOSS_REL:.0e}" if gate_loss else "held in parts"
    if not per_leaf_max:
        loss_tol += (f"; the float64 copy's own under 2^-24 noise "
                     f"{out['noise_loss_rel']:.2e}")
    log(f"[{tag}] float32 vs float64 on the card: loss {loss32:.7f} vs "
        f"{loss64:.7f} (rel {loss_rel:.2e}, {loss_tol}); layer "
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


def _image_batches(n_batches, batch, size, classes, seed=SEED):
    """bench_resnet50's batches: N(0, 1) NHWC images of ``size`` and
    one-hot labels of ``classes``, one batch per seed."""
    out = []
    for i in range(n_batches):
        r = np.random.default_rng(seed + i)
        out.append({
            "features": r.normal(size=(batch, size, size, 3)).astype(
                np.float32),
            "labels": np.eye(classes, dtype=np.float32)[
                r.integers(0, classes, batch)]})
    return out


def _resnet_batches():
    """bench_resnet50's batch at 224 × 224, 1000 classes."""
    return _image_batches(RESNET_BATCHES, RESNET_BATCH, 224, 1000)


def _train_resnet(tag, trainer, ts0, on_dev, dev, batch=RESNET_BATCH,
                  epochs=RESNET_EPOCHS):
    """``epochs`` × len(on_dev) steps of fit with checkpoints (the loss
    must fall over them), then one step's breakdown: the fit's record
    (samples/s at ``batch`` images a step)."""
    fit = _fit_and_restore(tag, trainer, ts0, on_dev, epochs, dev)
    losses = fit["losses"]
    n = len(on_dev)
    first, last = np.mean(losses[:n]), np.mean(losses[-n:])
    if fit["ts"].step != n * epochs or not (
            np.all(np.isfinite(losses)) and last < first):
        raise SystemExit(f"chip_smoke: {tag}: the loss did not fall "
                         f"({first:.4f} -> {last:.4f})")
    breakdown = _step_breakdown(trainer, fit["ts"], on_dev[0], ())
    step_ms = fit["median_step_ms"]
    shares = {c: round(v, 3)
              for c, v in breakdown["class_share_of_device"].items()}
    log(f"[{tag}] one step: {breakdown}")
    log(f"[{tag}] {fit['ts'].step} steps: loss {first:.4f} -> {last:.4f}; "
        f"median step {step_ms:.2f} ms ({batch / (step_ms / 1e3):.1f}"
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
        "samples_per_s": batch / (step_ms / 1e3),
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
# images (224x224x3, sent as JSON numbers), batched mode, max batch 8. 25
# requests (100 before the ConvLSTM phases joined the script, 50 before
# the YOLO phases: the phase is bound by JSON on the host at ~2
# requests/s).
RESNET_REQUESTS, RESNET_CLIENTS, RESNET_MAX_BATCH = 25, 4, 8
# served outputs against output_single on the same card, both float32 (the
# same function, run at another batch bucket)
TOL_SERVED = 1e-5


def _output_single(model):
    """The served function of a single-output graph: NHWC images → its
    output (``output_single``)."""
    return lambda variables, images: model.output_single(variables, images)


def _image_request(i):
    r = np.random.default_rng(2000 + i)
    return r.normal(size=(1 + i % 2, 224, 224, 3)).astype(np.float32)


def _serve_images(tag, dev, smi, name, forward, variables, requests, *,
                  clients, max_batch, tol, check):
    """``forward(variables, NHWC images)`` behind ModelServer →
    ModelRegistry → ParallelInference (batched, buckets up to
    ``max_batch``), ``requests`` sent as JSON by ``clients`` closed-loop
    threads; every response ``check``ed (shape, range) and held against
    ``forward`` on its request to ``tol`` (max |difference|; None: the
    caller holds them, handed back in request order under "outputs", as
    float32); the host cost of one 2-image request's JSON; one
    bucket-``max_batch`` forward's breakdown."""
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry,
        ModelServer,
        ServingClient,
        spec,
    )

    shape = requests[0].shape[1:]
    reg = ModelRegistry()
    entry = reg.register(name, forward, variables,
                         input_spec=spec(shape, np.float32), mode="batched",
                         max_batch_size=max_batch, devices=[dev])
    server = ModelServer(reg, port=0)
    t0 = time.monotonic()
    server.start(warm=True)
    client = ServingClient(server.url, timeout=120)
    if not client.ready()["ready"]:
        raise SystemExit("chip_smoke: /readyz not ready after warm start")
    log(f"[{tag}] server warm and ready in {time.monotonic() - t0:.2f}"
        f" s (buckets {sorted(entry.batch_stats().items())})")
    n_req = len(requests)
    latencies = [0.0] * n_req

    def call(i):
        t_start = time.monotonic()
        resp = client.predict(name, requests[i])
        latencies[i] = time.monotonic() - t_start
        return resp

    _dispatch.reset_launch_counts()
    before = entry.batch_stats()
    t0 = time.monotonic()
    with ThreadPoolExecutor(clients) as pool:
        responses = list(pool.map(call, range(n_req)))
    wall = time.monotonic() - t0
    launches = _dispatch.launch_counts()
    after = entry.batch_stats()
    batches = after["batches"] - before["batches"]
    rows = after["rows"] - before["rows"]
    drained = server.stop()
    log(f"[{tag}] {n_req} requests ({rows} rows) in {wall:.3f} s over "
        f"{batches} batches; hand-kernel launches {launches} (the path has "
        f"none); drained={drained}")
    if batches < 1 or not drained:
        raise SystemExit(f"chip_smoke: the {tag} server did not serve and "
                         "drain")
    worst = 0.0
    for req, resp in zip(requests, responses):
        out = np.asarray(resp["outputs"], dtype=np.float64)
        if not np.all(np.isfinite(out)) or not check(out, req):
            raise SystemExit(f"chip_smoke: {tag}: bad served output "
                             f"{out.shape}")
        if tol is not None:
            want = forward(variables, req).double().cpu().numpy()
            worst = max(worst, float(np.abs(out - want).max()))
    # host cost of one 2-image request's JSON: encode (client), decode and
    # coerce to the input spec (server)
    req2 = requests[1]
    t0 = time.perf_counter()
    body = json.dumps({"inputs": req2.tolist()})
    t1 = time.perf_counter()
    parsed = entry.parse_inputs(json.loads(body)["inputs"])
    t2 = time.perf_counter()
    json_ms = {"encode_ms": (t1 - t0) * 1e3, "decode_and_coerce_ms":
               (t2 - t1) * 1e3, "body_mib": len(body) / 2**20,
               "numbers": int(req2.size)}
    if not np.array_equal(parsed, req2):
        raise SystemExit("chip_smoke: a request did not survive JSON")
    x8 = torch.from_numpy(
        np.concatenate(requests[:max_batch])[:max_batch]).to(dev)
    breakdown = _forward_breakdown(lambda: forward(variables, x8))
    lat_ms = np.asarray(latencies) * 1e3
    log(f"[{tag}] one bucket-{max_batch} forward: {breakdown}")
    log(f"[{tag}] a 2-image request's JSON: {json_ms}")
    held = ("held by the caller" if tol is None else
            f"max_abs_err {worst:.3e} (tol {tol:.0e})")
    log(f"[{tag}] served outputs vs the same forward: {held}; "
        f"{n_req / wall:.1f} requests/s "
        f"({rows / wall:.1f} images/s), p50 {np.percentile(lat_ms, 50):.2f}"
        f" ms, p99 {np.percentile(lat_ms, 99):.2f} ms, {clients} clients, "
        f"on {smi}")
    if tol is not None and worst > tol:
        raise SystemExit(f"chip_smoke: {tag}: served outputs disagree with "
                         "the forward")
    out = {"requests": n_req, "rows": rows, "client_threads": clients,
           "batches": batches, "kernel_launches": launches,
           "requests_per_s": n_req / wall, "images_per_s": rows / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "json_2_images": json_ms, "forward_bucket8": breakdown,
           "card": smi}
    if tol is None:
        out["outputs"] = [np.asarray(r["outputs"], np.float32)
                          for r in responses]
    else:
        out["max_abs_err"] = worst
    return out


def _softmax_rows(classes):
    """A served-output check: [rows, classes] probabilities summing to 1."""
    return lambda out, req: out.shape == (req.shape[0], classes) and \
        np.abs(out.sum(-1) - 1).max() <= 1e-5


def phase_resnet_serve(dev, smi, model, variables):
    requests = [_image_request(i) for i in range(RESNET_REQUESTS)]
    out = _serve_images(
        "resnet_serve", dev, smi, "resnet50",
        _output_single(model), variables, requests,
        clients=RESNET_CLIENTS, max_batch=RESNET_MAX_BATCH,
        tol=TOL_SERVED, check=_softmax_rows(1000))
    out["max_abs_err_probs"] = out.pop("max_abs_err")
    return {"model": "resnet50", **out}


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
    loss_check = _time_loss_check(mp_trainer, ts, on_dev[0])
    log(f"[gpt_train] a mixed-precision step with the sparse loss's range "
        f"check {loss_check['checked_median_ms']:.2f} ms, without it "
        f"{loss_check['unchecked_median_ms']:.2f} ms (medians over "
        f"{loss_check['pairs']} alternating pairs); with less without, "
        f"paired: {loss_check['paired_diff_ms']} ms; one step's wall, "
        f"device ms and idle share with it "
        f"{loss_check['checked_breakdown']}, without it "
        f"{loss_check['unchecked_breakdown']}")
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
        "step_breakdown": breakdown, "loss_range_check": loss_check,
        "card": smi,
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


def _full_forward_gaps(model, variables, dev, prompt, toks):
    """For each generated token, the top logit of the full forward (plain
    attention) over prompt + the tokens before it, minus the token's own
    logit: 0 for the argmax, small for a tie."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reference_attention,
    )
    from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod

    p = len(prompt)
    ids = np.concatenate([prompt, toks[:-1]])[None]
    with mock.patch.object(attention_mod, "flash_attention",
                           reference_attention), torch.inference_mode():
        logits, _ = model.apply(variables, torch.from_numpy(ids).to(dev))
        lg = logits[0, p - 1:].double()
        picked = lg.gather(1, torch.tensor(toks, device=dev)[:, None])
        return (lg.max(-1).values - picked[:, 0]).cpu().numpy()


def _check_streams(model, variables, dev, requests, outputs):
    """Every stream: ``GEN_NEW`` tokens or ending at its eos_id, ids in the
    vocab, and every greedy token the argmax of the full forward with plain
    attention over prompt + generated prefix (a tie within TOL_GREEDY_TIE
    counted). Returns (greedy tokens checked, ties, worst gap, eos stops)."""
    vocab = model.config.vocab_size
    eos_stops = ties = checked = 0
    worst_gap = 0.0
    for req, toks in zip(requests, outputs):
        eos = req.get("eos_id")
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
        gap = _full_forward_gaps(model, variables, dev, req["prompt"], toks)
        worst_gap = max(worst_gap, float(gap.max()))
        ties += int(np.sum(gap > 0))
        checked += len(toks)
        if gap.max() > TOL_GREEDY_TIE:
            raise SystemExit(f"chip_smoke: a greedy token is not the "
                             f"argmax of the full forward (gap "
                             f"{gap.max():.3e})")
    return checked, ties, worst_gap, eos_stops


def phase_gpt_serve(dev, smi, model, variables):
    from deeplearning4j_tpu_torch.kernels import _dispatch
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

    checked, ties, worst_gap, eos_stops = _check_streams(
        model, variables, dev, requests, outputs)
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


# -- 24. GPT-2-small serving with prefix-KV reuse -----------------------------

# Shared-system-prompt chat traffic: the gpt_serve engine (8 slots, 512
# positions, 32 new tokens) with a prefix store, a ServingMetrics bundle
# and a warmup manifest, behind ModelServer. PREFIX_REQUESTS streamed
# requests from GEN_CLIENTS client threads, each one of PREFIX_SYSTEMS
# fixed system prompts of PREFIX_T ids (from the seed) and a distinct
# suffix of 8-32 ids; every other request greedy, the rest at 0.8.
PREFIX_T, PREFIX_SYSTEMS, PREFIX_REQUESTS = 256, 2, 64
PREFIX_SUFFIX = (8, 32)


def _prefix_requests(vocab):
    systems = [np.random.default_rng(SEED + 7000 + k).integers(
        0, vocab, PREFIX_T) for k in range(PREFIX_SYSTEMS)]
    out = []
    for i in range(PREFIX_REQUESTS):
        r = np.random.default_rng(6000 + i)
        suffix = r.integers(0, vocab, int(r.integers(PREFIX_SUFFIX[0],
                                                     PREFIX_SUFFIX[1] + 1)))
        out.append({"prompt": np.concatenate(
                        [systems[(i // 2) % PREFIX_SYSTEMS], suffix]
                    ).astype(np.int32),
                    "temperature": 0.0 if i % 2 == 0 else 0.8})
    return out


def _prom_samples(text):
    """A Prometheus text scrape → {(name, ((label, value), ...)): value}."""
    import re

    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$', line)
        if m is None:
            raise SystemExit(f"chip_smoke: /metrics line does not parse: "
                             f"{line!r}")
        labels = tuple(sorted(re.findall(r'([a-zA-Z_]\w*)="([^"]*)"',
                                         m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def _first_divergence_is_a_tie(model, variables, dev, prompt, got, want):
    """Two greedy streams of one prompt that differ: at the first position
    where they part, both tokens must lie within TOL_GREEDY_TIE of the top
    logit of the full forward over their common prefix."""
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    gaps = [float(_full_forward_gaps(model, variables, dev, prompt,
                                     list(s[:k + 1]))[-1])
            for s in (got, want)]
    return max(gaps) <= TOL_GREEDY_TIE


def _drive_prefix_mix(client, engine, requests):
    """The requests streamed through the server's :generate from
    GEN_CLIENTS client threads: each one's tokens, its (start, token
    stamps) on the client's clock and its engine stream, and the wall
    seconds of the whole."""
    times = [None] * len(requests)
    streams = {}
    submit = engine.submit

    def keep(prompt, **kw):  # the server's submit, stream kept
        stream = submit(prompt, **kw)
        streams[tuple(int(t) for t in prompt)] = stream
        return stream

    def call(i):
        req = requests[i]
        t_start = time.monotonic()
        toks, stamps = [], []
        for tok in client.generate("gpt2", req["prompt"],
                                   temperature=req["temperature"]):
            toks.append(tok)
            stamps.append(time.monotonic())
        times[i] = (t_start, stamps)
        return toks

    t0 = time.monotonic()
    with mock.patch.object(engine, "submit", keep), \
            ThreadPoolExecutor(GEN_CLIENTS) as pool:
        outputs = list(pool.map(call, range(len(requests))))
    wall = time.monotonic() - t0
    handles = [streams[tuple(int(t) for t in r["prompt"])] for r in requests]
    return outputs, times, handles, wall


def phase_gpt_prefix_serve(dev, smi, model, variables):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine,
        ModelServer,
        ServingClient,
        ServingMetrics,
    )

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_prefix_"))
    engine = GenerationEngine(model, variables, num_slots=GEN_SLOTS,
                              max_len=GEN_MAX_LEN, max_new_tokens=GEN_NEW,
                              seed=SEED, prefix_cache=True)
    server = ModelServer(port=0, generators={"gpt2": engine},
                         metrics=ServingMetrics(),
                         warmup_manifest=str(tmp / "warmup_manifest.json"))
    try:
        t0 = time.monotonic()
        server.start(warm=True)
        client = ServingClient(server.url, timeout=300)
        if not client.ready()["ready"]:
            raise SystemExit("chip_smoke: the prefix server is not ready")
        warmed = engine.describe()["shapes_run"]
        log(f"[gpt_prefix_serve] engine warm ({warmed} shapes: prefill, "
            f"decode and {len(engine.prompt_buckets)} grafts) in "
            f"{time.monotonic() - t0:.2f} s")
        requests = _prefix_requests(model.config.vocab_size)
        _dispatch.reset_launch_counts()
        outputs, times, handles, wall = _drive_prefix_mix(client, engine,
                                                          requests)
        launches = _dispatch.launch_counts()
        after = engine.describe()
        store = after["prefix_cache"]
        scrape = _prom_samples(client.metrics_text())
    finally:
        drained = server.stop()
    manifest = json.loads((tmp / "warmup_manifest.json").read_text())
    shutil.rmtree(tmp, ignore_errors=True)

    hit = [h.prefix_len > 0 for h in handles]
    hits, publishes = store["hits"], store["insertions"]
    model_l = (("model", "gpt2"),)
    counters = {
        "hits": scrape.get(("cache_prefix_requests_total",
                            (("model", "gpt2"), ("outcome", "hit")))),
        "misses": scrape.get(("cache_prefix_requests_total",
                              (("model", "gpt2"), ("outcome", "miss")))),
        "insertions": scrape.get(("cache_prefix_insertions_total",
                                  model_l)),
        "entries": scrape.get(("cache_prefix_entries", model_l)),
        "bytes": scrape.get(("cache_prefix_bytes", model_l))}
    ttft_count = scrape.get(("generation_ttft_seconds_count", model_l))
    log(f"[gpt_prefix_serve] {PREFIX_REQUESTS} requests in {wall:.3f} s; "
        f"store {store}; scrape {counters}, ttft count {ttft_count}; "
        f"shapes run after warm-up {after['shapes_after_warm']}; "
        f"hand-kernel launches {launches}; manifest "
        f"{len(manifest['entries'])} entries; drained={drained}")
    if not (hits > 0 and hits == PREFIX_REQUESTS - publishes
            and sum(hit) == hits and all(
                counters[k] == store[k] for k in counters)
            and ttft_count == PREFIX_REQUESTS):
        raise SystemExit("chip_smoke: prefix hits, publishes and the "
                         "/metrics scrape disagree")
    if launches or not drained or after["shapes_after_warm"]:
        raise SystemExit("chip_smoke: prefix serving launched a hand "
                         "kernel, ran an unwarmed shape or did not drain")

    checked, ties, worst_gap, _ = _check_streams(model, variables, dev,
                                                 requests, outputs)
    # the same requests from the same clients through an engine without a
    # store: its timings beside the store's, and each greedy hit's tokens
    # against the same prompt served there
    plain = GenerationEngine(model, variables, num_slots=GEN_SLOTS,
                             max_len=GEN_MAX_LEN, max_new_tokens=GEN_NEW,
                             seed=SEED, prefix_cache=False)
    plain_server = ModelServer(port=0, generators={"gpt2": plain})
    try:
        plain_server.start(warm=True)
        plain_out, plain_times, _, plain_wall = _drive_prefix_mix(
            ServingClient(plain_server.url, timeout=300), plain, requests)
        plain_after = plain.describe()["shapes_after_warm"]
    finally:
        plain_drained = plain_server.stop()
    if plain_after or not plain_drained:
        raise SystemExit("chip_smoke: the store-less engine ran an unwarmed "
                         "shape or did not drain")
    greedy_hits = [i for i, r in enumerate(requests)
                   if r["temperature"] == 0.0 and hit[i]]
    tie_splits = 0
    for i in greedy_hits:
        want = plain_out[i]
        if outputs[i] == want:
            continue
        if not _first_divergence_is_a_tie(model, variables, dev,
                                          requests[i]["prompt"], outputs[i],
                                          want):
            raise SystemExit("chip_smoke: a prefix hit's greedy tokens "
                             "differ from the store-less engine's")
        tie_splits += 1
    log(f"[gpt_prefix_serve] {checked} greedy tokens against the full "
        f"forward's argmax: {ties} ties within {TOL_GREEDY_TIE:.0e} (worst "
        f"gap {worst_gap:.3e}); {len(greedy_hits)} greedy hits against the "
        f"store-less engine: {len(greedy_hits) - tie_splits} equal, "
        f"{tie_splits} parting at a tie")

    client_ttft = np.array([(s[0] - t) * 1e3 for t, s in times])
    plain_ttft = np.array([(s[0] - t) * 1e3 for t, s in plain_times])
    server_ttft = np.array([(h.t_first - h.t_submit) * 1e3
                            for h in handles])
    feeds = np.array([h.prompt_len - h.prefix_len
                      for h, is_hit in zip(handles, hit) if is_hit])
    hit_a = np.array(hit)

    def pct(a):
        return {"p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)), "n": int(a.size)}

    out = {"model": "gpt2_small", "requests": PREFIX_REQUESTS,
           "client_threads": GEN_CLIENTS, "system_prompts": PREFIX_SYSTEMS,
           "system_prompt_tokens": PREFIX_T,
           "suffix_tokens": list(PREFIX_SUFFIX), "num_slots": GEN_SLOTS,
           "max_len": GEN_MAX_LEN, "max_new_tokens": GEN_NEW,
           "wall_s": wall, "hits": hits, "misses": store["misses"],
           "publishes": publishes, "store": store, "scrape": counters,
           "ttft_ms_hit": pct(client_ttft[hit_a]),
           "ttft_ms_miss": pct(client_ttft[~hit_a]),
           "server_ttft_ms_hit": pct(server_ttft[hit_a]),
           "server_ttft_ms_miss": pct(server_ttft[~hit_a]),
           "suffix_feeds_per_hit": {"min": int(feeds.min()),
                                    "mean": float(feeds.mean()),
                                    "max": int(feeds.max())},
           "shapes_after_warm": after["shapes_after_warm"],
           "kernel_launches": launches,
           "greedy_tokens_checked": checked, "greedy_ties": ties,
           "greedy_worst_gap": worst_gap,
           "greedy_hits_vs_storeless": len(greedy_hits),
           "greedy_hits_parting_at_a_tie": tie_splits,
           "generated_tokens_per_s": sum(map(len, outputs)) / wall,
           "ttft_ms_all": pct(client_ttft),
           "storeless": {"wall_s": plain_wall,
                         "ttft_ms_all": pct(plain_ttft),
                         "generated_tokens_per_s":
                             sum(map(len, plain_out)) / plain_wall},
           "manifest_entries": len(manifest["entries"]), "card": smi}
    log(f"[gpt_prefix_serve] ttft (client) hit p50 "
        f"{out['ttft_ms_hit']['p50']:.2f} p99 {out['ttft_ms_hit']['p99']:.2f}"
        f" ms over {out['ttft_ms_hit']['n']}, miss p50 "
        f"{out['ttft_ms_miss']['p50']:.2f} p99 "
        f"{out['ttft_ms_miss']['p99']:.2f} ms over "
        f"{out['ttft_ms_miss']['n']}; suffix feeds a hit "
        f"{out['suffix_feeds_per_hit']}; store {store['bytes'] / 2**20:.1f} "
        f"MiB in {store['entries']} slabs; "
        f"{out['generated_tokens_per_s']:.1f} tokens/s, on {smi}")
    log(f"[gpt_prefix_serve] the same {PREFIX_REQUESTS} requests from "
        f"{GEN_CLIENTS} clients, with the store against without it: ttft "
        f"(client, all) p50 {out['ttft_ms_all']['p50']:.2f} against "
        f"{out['storeless']['ttft_ms_all']['p50']:.2f} ms, p99 "
        f"{out['ttft_ms_all']['p99']:.2f} against "
        f"{out['storeless']['ttft_ms_all']['p99']:.2f} ms; "
        f"{out['generated_tokens_per_s']:.1f} against "
        f"{out['storeless']['generated_tokens_per_s']:.1f} tokens/s; wall "
        f"{wall:.3f} against {plain_wall:.3f} s, on {smi}")
    return out


# -- 25. warm restart from a traffic-derived manifest --------------------------

# BERT-base (phase 4's server, max batch 8) and GPT-2-small (the gpt_serve
# engine) behind one ModelServer with a warmup manifest: a traffic mix
# that touches a strict subset of the buckets (sequential BERT requests of
# 1-2 rows; sequential greedy generations of 8-16-id prompts), then stop;
# a fresh server from the same manifest file with warm_async=True, polled
# at /readyz until 200, replays the mix.
RESTART_BERT = [1 + i % 2 for i in range(12)]   # buckets 1 and 2
RESTART_GPT = [8, 13, 16, 11]                   # prompt buckets 8 and 16


def _restart_server(bert, gpt_model, gpt_vars, manifest_path):
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine,
        ModelRegistry,
        ModelServer,
        spec,
    )

    cfg = bert.config
    reg = ModelRegistry()
    entry = reg.register(
        "bert_base", _nsp_softmax, bert,
        input_spec={"token_ids": spec((T,), np.int32, high=cfg.vocab_size),
                    "segment_ids": spec((T,), np.int32, high=cfg.type_vocab),
                    "mask": spec((T,), np.float32)},
        mode="batched", max_batch_size=8)
    engine = GenerationEngine(gpt_model, gpt_vars, num_slots=GEN_SLOTS,
                              max_len=GEN_MAX_LEN, max_new_tokens=GEN_NEW,
                              seed=SEED)
    server = ModelServer(reg, port=0, generators={"gpt2": engine},
                         warmup_manifest=str(manifest_path))
    return server, entry, engine


def _restart_mix(client, vocab_bert, vocab_gpt):
    """The traffic mix, sequential (so each BERT request is its own
    batch): BERT outputs and greedy GPT tokens."""
    bert_out = []
    for i, rows in enumerate(RESTART_BERT):
        req = {k: v[:rows] for k, v in _request(i, vocab_bert).items()}
        bert_out.append(client.predict("bert_base", req)["outputs"])
    gpt_out = [client.generate_tokens(
        "gpt2", np.random.default_rng(8000 + i).integers(0, vocab_gpt, n),
        temperature=0.0)["tokens"] for i, n in enumerate(RESTART_GPT)]
    return bert_out, gpt_out


def _poll_ready(server, client, vocab_bert, limit_s=120.0):
    """Poll /readyz until 200: the 503 progress bodies on the way, what a
    predict made while warming got, and the 200 body."""
    import urllib.error
    import urllib.request

    from deeplearning4j_tpu_torch.serving import NotReadyError

    progress, shed = [], None
    t0 = time.monotonic()
    while time.monotonic() - t0 < limit_s:
        try:
            with urllib.request.urlopen(server.url + "/readyz",
                                        timeout=60) as r:
                return progress, shed, json.loads(r.read())
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            if e.code != 503 or "total" not in body:
                raise SystemExit(f"chip_smoke: /readyz said {e.code} {body}")
            progress.append({k: body[k] for k in
                             ("warmed", "total", "retry_after_ms")})
            if shed is None:
                try:
                    client.predict("bert_base", {
                        k: v[:1] for k, v in _request(0, vocab_bert).items()})
                    shed = "served"
                except NotReadyError as err:
                    shed = f"NotReadyError retryable={err.retryable}"
        # a busy poll would take the interpreter lock from the warm thread
        time.sleep(0.01)
    raise SystemExit("chip_smoke: the restarted server never turned ready")


def phase_warm_restart(dev, smi, gpt_model, gpt_vars):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.models.bert import bert_base
    from deeplearning4j_tpu_torch.nn import config as nnconfig
    from deeplearning4j_tpu_torch.observability.metrics import (
        get_warmstart_metrics,
    )
    from deeplearning4j_tpu_torch.serving import ServingClient
    from deeplearning4j_tpu_torch.serving.warmup import bucket_sizes
    from deeplearning4j_tpu_torch.train.updaters import Adam

    bert = bert_base(device=dev, net=nnconfig.NeuralNetConfiguration(
        seed=SEED, updater=Adam(1e-4)))
    vb, vg = bert.config.vocab_size, gpt_model.config.vocab_size
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_restart_"))
    path = tmp / "warmup_manifest.json"
    wm = get_warmstart_metrics()

    def after_warm():
        return {p: wm.recompiles_after_warm_total.value(plane=p)
                for p in ("predict", "generation")}

    try:
        # 1. the first server: the full vocabulary warmed, then the mix
        server, entry, engine = _restart_server(bert, gpt_model, gpt_vars,
                                                path)
        full = (len(bucket_sizes(8)) + len(engine.prompt_buckets)
                + len(engine.slot_buckets) * len(engine.kv_buckets))
        t0 = time.monotonic()
        server.start(warm=True)
        full_s = time.monotonic() - t0
        try:
            bert_1, gpt_1 = _restart_mix(
                ServingClient(server.url, timeout=300), vb, vg)
        finally:
            server.stop()
        rows = json.loads(path.read_text())["entries"]
        log(f"[warm_restart] first server: full warm of {full} shapes in "
            f"{full_s:.3f} s; the mix left {len(rows)} manifest entries: "
            f"{[(r['plane'], r['model'], r['shape']) for r in rows]}")

        # 2. a fresh server from the same file, warming in the background
        server, entry, engine = _restart_server(bert, gpt_model, gpt_vars,
                                                path)
        before = after_warm()
        client = ServingClient(server.url, timeout=300)
        t0 = time.monotonic()
        server.start(warm=True, warm_async=True)
        try:
            progress, shed, ready = _poll_ready(server, client, vb)
            manifest_s = time.monotonic() - t0
            total = len(entry.warmed_buckets) + \
                engine.describe()["shapes_run"]
            log(f"[warm_restart] restarted server ready in "
                f"{manifest_s:.3f} s after warming {total} of {full} shapes "
                f"(BERT buckets {sorted(entry.warmed_buckets)}); "
                f"{len(progress)} 503 progress bodies on the way, first "
                f"{progress[:1]}, last {progress[-1:]}; a predict while "
                f"warming: {shed}; /readyz {ready}")
            # 3. the mix again: no shape first run after warm, the same
            # BERT outputs bit for bit, 12 flash_fwd a dispatched batch
            _dispatch.reset_launch_counts()
            b0 = entry.batch_stats()["batches"]
            bert_2, gpt_2 = _restart_mix(client, vb, vg)
            batches = entry.batch_stats()["batches"] - b0
            launches = _dispatch.launch_counts().get("flash_fwd", 0)
            shapes_after = engine.describe()["shapes_after_warm"]
        finally:
            drained = server.stop()
        delta = {p: v - before[p] for p, v in after_warm().items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[warm_restart] replay: {batches} BERT batches, flash_fwd launches "
        f"{launches} (= 12 x {launches / max(batches, 1):.2f}); shapes first "
        f"run after warm: predict {delta['predict']:.0f}, generation "
        f"{delta['generation']:.0f} (engine {shapes_after}); BERT outputs "
        f"bit-equal {bert_2 == bert_1}; GPT greedy tokens equal "
        f"{gpt_2 == gpt_1}; drained={drained}")
    if not total < full:
        raise SystemExit("chip_smoke: the manifest warm ran the full "
                         "vocabulary")
    if delta["predict"] or delta["generation"] or shapes_after:
        raise SystemExit("chip_smoke: the replay ran a shape the manifest "
                         "warm left out")
    if bert_2 != bert_1 or gpt_2 != gpt_1:
        raise SystemExit("chip_smoke: the restarted server's outputs differ")
    if batches != len(RESTART_BERT) or launches != 12 * batches:
        raise SystemExit(f"chip_smoke: {launches} flash_fwd launches for "
                         f"{batches} BERT batches; want 12 a batch")
    if not drained:
        raise SystemExit("chip_smoke: the restarted server did not drain")
    log(f"[warm_restart] warm {full_s:.3f} s for the full vocabulary "
        f"({full} shapes) against {manifest_s:.3f} s to ready from the "
        f"manifest ({total} shapes), on {smi}")
    return {"models": ["bert_base", "gpt2_small"],
            "bert_requests": len(RESTART_BERT),
            "gpt_requests": len(RESTART_GPT), "manifest_entries": len(rows),
            "full_shapes": full, "manifest_shapes": total,
            "bert_buckets_warmed": sorted(entry.warmed_buckets),
            "full_warm_s": full_s, "manifest_warm_to_ready_s": manifest_s,
            "readyz_503_bodies": len(progress),
            "readyz_first": progress[:1], "predict_while_warming": shed,
            "replay_shapes_after_warm": {**delta, "engine": shapes_after},
            "replay_bert_batches": batches, "flash_fwd_launches": launches,
            "bert_bit_equal": bert_2 == bert_1,
            "gpt_tokens_equal": gpt_2 == gpt_1, "card": smi}


# -- 26. the sparse loss on out-of-range class ids -----------------------------

# In a child process: sparse_softmax_cross_entropy on CUDA tensors with
# class ids -1 and C must raise cleanly ("out of bounds"), and the card
# must go on computing in that process. A device-side assert would break
# the child's CUDA context, not this run's.
LOSS_CHILD = """
import torch
from deeplearning4j_tpu_torch.ops.loss import sparse_softmax_cross_entropy

dev = torch.device("cuda", 0)
logits = torch.randn(4, 7, device=dev)
for bad in (-1, 7):
    try:
        sparse_softmax_cross_entropy(logits, torch.tensor([0, 6, bad, 3],
                                                          device=dev))
    except RuntimeError as e:
        assert "out of bounds" in str(e), e
        print(f"id {bad}: {e}")
    else:
        raise SystemExit(f"no error for class id {bad}")
loss = sparse_softmax_cross_entropy(logits, torch.tensor([0, 6, 2, 3],
                                                         device=dev))
x = torch.randn(256, 256, device=dev)
torch.cuda.synchronize()
print(f"the card goes on: loss {loss.item():.4f}, "
      f"matmul {float((x @ x).sum().item()):.2f}")
"""


def phase_loss_guard():
    import subprocess

    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-c", LOSS_CHILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    lines = res.stdout.strip().splitlines()
    log(f"[loss_guard] child exit {res.returncode} in "
        f"{time.monotonic() - t0:.1f} s: {lines}")
    if res.returncode != 0 or not lines or "goes on" not in lines[-1]:
        raise SystemExit(f"chip_smoke: the sparse loss did not raise "
                         f"cleanly on a CUDA tensor: {res.stderr[-2000:]}")
    return {"exit": res.returncode, "child_stdout": lines}


def _unchecked_sparse_ce(logits, label_ids, weights=None, reduction="mean"):
    """``sparse_softmax_cross_entropy`` as it was before its range check:
    the gather alone (the comparison that times the check)."""
    from deeplearning4j_tpu_torch.ops.loss import _reduce

    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, label_ids.long()[..., None])[..., 0]
    return _reduce(ce, reduction, weights)


def _time_loss_check(trainer, ts, batch, pairs=40) -> dict:
    """A train step's wall ms (synchronised) with the sparse loss's range
    check and without it, alternating step by step over ``pairs`` pairs
    (check first in every other pair): each one's median and the median
    of the paired differences, which host drift across the run cancels
    out of. Then each one's ``_step_breakdown`` in turns (check,
    unchecked, unchecked, check): wall, device busy ms and the device's
    idle share, which a host sync that stalls the queue raises."""
    from deeplearning4j_tpu_torch.ops import loss as loss_mod

    def unchecked():
        return mock.patch.object(loss_mod, "sparse_softmax_cross_entropy",
                                 _unchecked_sparse_ce)

    def step_ms(checked):
        with contextlib.nullcontext() if checked else unchecked():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(ts, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

    walls = {True: [], False: []}
    for n in range(pairs):
        for checked in ((True, False) if n % 2 == 0 else (False, True)):
            walls[checked].append(step_ms(checked))
    diffs = np.array(walls[True]) - np.array(walls[False])

    def breakdown(checked):
        with contextlib.nullcontext() if checked else unchecked():
            b = _step_breakdown(trainer, ts, batch, [])
        return {k: b[k] for k in ("wall_ms", "device_ms",
                                  "device_idle_share")}

    idle = {True: [], False: []}
    for checked in (True, False, False, True):
        idle[checked].append(breakdown(checked))
    return {"pairs": pairs,
            "checked_median_ms": float(np.median(walls[True])),
            "unchecked_median_ms": float(np.median(walls[False])),
            "paired_diff_ms": {q: float(np.percentile(diffs, p)) for q, p in
                               (("p25", 25), ("p50", 50), ("p75", 75))},
            "checked_breakdown": idle[True],
            "unchecked_breakdown": idle[False]}


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


# -- 27. Xception training ----------------------------------------------

# Xception (the JAX zoo's: 299x299x3, 1000 classes, 22,855,952 parameters,
# 34 SeparableConv2D), batch 32, Adam 1e-3, bench_resnet50's data at 299:
# float32 (TF32 off) and mixed precision, 3 fixed batches cycled by 10
# epochs each (30 steps). The float64 check and the fit helpers are
# ResNet-50's (its tolerances: a BatchNorm ReLU net of this depth).
XCEPTION_BATCH, XCEPTION_BATCHES, XCEPTION_EPOCHS = 32, 3, 10
XCEPTION_SIZE, XCEPTION_CLASSES = 299, 1000
XCEPTION_PARAMS = 22_855_952


def _depthwise_groups(model):
    """The model's SeparableConv2D vertices grouped by what their
    depthwise half computes: {(input (H, W, C), kernel, stride,
    multiplier): [vertex names]}."""
    groups = {}
    for name in model.order:
        layer = model.config.vertices[name].layer
        if type(layer).__name__ == "SeparableConv2D":
            key = (tuple(model.shapes[model.config.vertices[name].inputs[0]]),
                   layer.kernel, layer.stride, layer.depth_multiplier)
            groups.setdefault(key, []).append(name)
    return groups


def _depthwise_census(model, dev, batch) -> dict:
    """The CUDA kernels that run the model's depthwise convs at ``batch``
    images, forward and backward (dx and dW), by group of
    ``_depthwise_groups``: each kernel's name and device µs a call from
    the profiler, and the group's total times its layers. The names say
    whether cuDNN (or PyTorch's own depthwise kernels) runs them, or a
    grouped GEMM."""
    from deeplearning4j_tpu_torch.ops import cnn as opscnn

    rows, total_us = [], 0.0
    for (shape, kernel, stride, mult), names in _depthwise_groups(
            model).items():
        gen = torch.Generator(dev).manual_seed(SEED)
        x = torch.randn((batch, *shape), generator=gen, device=dev,
                        requires_grad=True)
        w = torch.randn((*opscnn._pair(kernel), shape[-1], mult),
                        generator=gen, device=dev, requires_grad=True)
        with torch.no_grad():
            dy = torch.randn_like(opscnn.depthwise_conv2d(
                x, w, stride=stride, padding="SAME"))

        def fn():
            y = opscnn.depthwise_conv2d(x, w, stride=stride, padding="SAME")
            torch.autograd.grad(y, (x, w), dy)

        by_kernel = _device_us_by_kernel(fn, iters=5)
        us = sum(by_kernel.values())
        total_us += us * len(names)
        named = {}
        for k, v in by_kernel.items():  # variants that share a prefix
            named[k[:100]] = named.get(k[:100], 0.0) + v
        rows.append({"input_hwc": list(shape), "kernel": kernel,
                     "stride": stride, "layers": len(names),
                     "us_per_layer": us,
                     "kernels_us": {k: round(v, 1) for k, v in sorted(
                         named.items(), key=lambda kv: -kv[1])}})
        del x, w, dy
    return {"layers": sum(r["layers"] for r in rows),
            "ms_per_step": total_us / 1e3, "groups": rows}


def phase_xception_train(dev, smi):
    from deeplearning4j_tpu_torch.models.zoo.graphs import xception
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    t0 = time.monotonic()
    model = xception(device=dev, updater=Adam(1e-3), seed=SEED)
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    on_dev = [batch_to_device(b, dev) for b in _image_batches(
        XCEPTION_BATCHES, XCEPTION_BATCH, XCEPTION_SIZE, XCEPTION_CLASSES)]
    n_params = model.num_params(trainer.variables(ts0))
    log(f"[xception_train] xception: {n_params:,} parameters, "
        f"{len(model.order)} vertices, {len(_depthwise_groups(model))} "
        f"depthwise shapes, Adam(1e-3), batches "
        f"{XCEPTION_BATCH}x{XCEPTION_SIZE}x{XCEPTION_SIZE}x3, built in "
        f"{time.monotonic() - t0:.1f} s")
    if n_params != XCEPTION_PARAMS:
        raise SystemExit(f"chip_smoke: xception has {n_params} parameters")
    f64 = _vs_float64("xception_train", trainer, ts0, on_dev[0],
                      per_leaf_max=False)
    fit, fp32 = _train_resnet("xception_train", trainer, ts0, on_dev, dev,
                              batch=XCEPTION_BATCH, epochs=XCEPTION_EPOCHS)
    trained = trainer.variables(fit["ts"])
    census = _depthwise_census(model, dev, XCEPTION_BATCH)
    device_ms = fp32["step_breakdown"]["device_ms"]
    census["share_of_step_device"] = census["ms_per_step"] / device_ms
    for row in census["groups"]:
        log(f"[xception_train] depthwise {row['input_hwc']} k{row['kernel']}"
            f" s{row['stride']} x{row['layers']}: {row['us_per_layer']:.1f}"
            f" us a layer (forward + dx + dW): {row['kernels_us']}")
    log(f"[xception_train] the {census['layers']} depthwise convs: "
        f"{census['ms_per_step']:.2f} ms of a step's {device_ms:.2f} device "
        f"ms ({census['share_of_step_device']:.1%})")

    mp_model = xception(device=dev, updater=Adam(1e-3), seed=SEED)
    mp_model.net.mixed_precision = True
    mp_trainer = Trainer(mp_model)
    mts0 = mp_trainer.init_state(trainer.variables(ts0))
    mts1, m = mp_trainer.train_step(mts0, on_dev[0])
    mp_loss = float(m["total_loss"])
    mp_rel = abs(mp_loss - f64["loss_float32"]) / abs(f64["loss_float32"])
    state_f32 = all(a.dtype == torch.float32 for a in tree_leaves(
        (mts1.params, mts1.model_state, mts1.opt_state)))
    log(f"[xception_mixed] first step's loss {mp_loss:.6f} vs float32 "
        f"{f64['loss_float32']:.6f} (rel {mp_rel:.2e}, tol "
        f"{TOL_MIXED_REL:.0e}); params, BatchNorm and updater state float32:"
        f" {state_f32}")
    if mp_rel > TOL_MIXED_REL or not state_f32:
        raise SystemExit("chip_smoke: the mixed-precision Xception step "
                         "failed")
    del mts1
    _, mixed = _train_resnet("xception_mixed", mp_trainer, mts0, on_dev, dev,
                             batch=XCEPTION_BATCH, epochs=XCEPTION_EPOCHS)
    mixed["first_loss_vs_float32_rel"] = mp_rel
    del mts0, ts0, mp_trainer, mp_model, on_dev
    return {"model": "xception", "batch": XCEPTION_BATCH,
            "image": XCEPTION_SIZE, "num_params": n_params,
            "vs_float64": f64, "float32": fp32, "mixed_precision": mixed,
            "depthwise": census, "card": smi}, model, trained


# -- 28. Xception serving --------------------------------------------------

# Closed loop: 4 client threads, 20 requests of 1-2 299x299x3 images as
# JSON (268,203 numbers an image; 40 before the YOLO phases joined the
# script, JSON-bound at ~1.7 requests/s), batched mode, max batch 8.
XCEPTION_REQUESTS, XCEPTION_CLIENTS, XCEPTION_MAX_BATCH = 20, 4, 8


def _xception_request(i):
    r = np.random.default_rng(3000 + i)
    return r.normal(size=(1 + i % 2, XCEPTION_SIZE, XCEPTION_SIZE,
                          3)).astype(np.float32)


def phase_xception_serve(dev, smi, model, variables):
    requests = [_xception_request(i) for i in range(XCEPTION_REQUESTS)]
    out = _serve_images(
        "xception_serve", dev, smi, "xception", _output_single(model),
        variables, requests, clients=XCEPTION_CLIENTS,
        max_batch=XCEPTION_MAX_BATCH, tol=TOL_SERVED,
        check=_softmax_rows(XCEPTION_CLASSES))
    return {"model": "xception", **out}


# -- 29. U-Net training -----------------------------------------------------

# The JAX zoo's U-Net at its defaults: 128x128x3, base_filters 32, depth 4,
# one class (sigmoid / binary cross-entropy through PixelOutput), 7,846,657
# parameters; batch 16, Adam 1e-3, 3 fixed batches of N(0, 1) images with
# one disc each (DISC_SHIFT added inside it) whose mask is the label,
# cycled by 10 epochs (30 steps). No BatchNorm: LeNet-5's float64 limits.
UNET_BATCH, UNET_BATCHES, UNET_EPOCHS, UNET_SIZE = 16, 3, 10, 128
UNET_PARAMS = 7_846_657
DISC_SHIFT = 2.0


def _disc_batch(n, size, seed):
    """``n`` images N(0, 1) of ``size``² × 3, each plus DISC_SHIFT inside
    one disc, and the discs' masks [n, size, size, 1] as labels. Radii in
    [size/16, size/4) and centres that keep the disc inside the image,
    from ``seed``."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, size, size, 3)).astype(np.float32)
    rad = r.uniform(size / 16, size / 4, n)
    cy, cx = (r.uniform(rad, size - rad) for _ in range(2))
    yy, xx = np.mgrid[:size, :size]
    mask = ((yy[None] - cy[:, None, None]) ** 2
            + (xx[None] - cx[:, None, None]) ** 2
            <= rad[:, None, None] ** 2).astype(np.float32)[..., None]
    return {"features": x + DISC_SHIFT * mask, "labels": mask}


def _pixel_accuracy(model, variables, batch) -> float:
    """The share of pixels whose thresholded mask (p > 0.5) is the
    label's."""
    probs = model.output_single(variables, batch["features"])
    return float(((probs > 0.5).float() == batch["labels"]).float().mean())


def phase_unet_train(dev, smi):
    from deeplearning4j_tpu_torch.models.zoo.graphs import unet
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    t0 = time.monotonic()
    model = unet(device=dev, updater=Adam(1e-3), seed=SEED)
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    on_dev = [batch_to_device(_disc_batch(UNET_BATCH, UNET_SIZE, SEED + i),
                              dev) for i in range(UNET_BATCHES)]
    n_params = model.num_params(trainer.variables(ts0))
    fg = float(torch.stack([b["labels"].mean() for b in on_dev]).mean())
    log(f"[unet_train] unet: {n_params:,} parameters, {len(model.order)} "
        f"vertices, Adam(1e-3), batches {UNET_BATCH}x{UNET_SIZE}x"
        f"{UNET_SIZE}x3 with one disc each ({fg:.1%} of pixels), built in "
        f"{time.monotonic() - t0:.1f} s")
    if n_params != UNET_PARAMS:
        raise SystemExit(f"chip_smoke: unet has {n_params} parameters")
    f64 = _vs_float64("unet_train", trainer, ts0, on_dev[0],
                      per_leaf_max=True)
    acc0 = _pixel_accuracy(model, trainer.variables(ts0), on_dev[0])
    fit, fp32 = _train_resnet("unet_train", trainer, ts0, on_dev, dev,
                              batch=UNET_BATCH, epochs=UNET_EPOCHS)
    losses = fit["losses"]
    trained = trainer.variables(fit["ts"])
    acc = _pixel_accuracy(model, trained, on_dev[0])
    log(f"[unet_train] loss first step {losses[0]:.4f}, last "
        f"{losses[-1]:.4f}; pixel accuracy {acc0:.4f} -> {acc:.4f} "
        f"(background share {1 - fg:.4f}); on {smi}")
    if not losses[-1] < losses[0]:
        raise SystemExit("chip_smoke: the U-Net's last loss is not below "
                         "its first")
    del ts0, on_dev
    return {"model": "unet", "batch": UNET_BATCH, "image": UNET_SIZE,
            "num_params": n_params, "vs_float64": f64, "float32": fp32,
            "pixel_accuracy_first": acc0, "pixel_accuracy": acc,
            "foreground_share": fg, "card": smi}, model, trained


# -- 30. U-Net serving ------------------------------------------------------

# Closed loop: 8 client threads, 50 requests of 1-4 disc images
# (128x128x3) as JSON (100 before the ConvLSTM phases joined the script;
# JSON-bound at ~3 requests/s), batched mode, max batch 8; each answer a
# mask of probabilities [n, 128, 128, 1], the first rank-4 output served.
UNET_REQUESTS, UNET_CLIENTS, UNET_MAX_BATCH = 50, 8, 8


def _unet_request(i):
    return _disc_batch(1 + i % 4, UNET_SIZE, 4000 + i)["features"]


def _masks(out, req):
    """A served-output check: [rows, H, W, 1] probabilities."""
    return out.shape == (*req.shape[:3], 1) and out.min() >= 0 and \
        out.max() <= 1


def phase_unet_serve(dev, smi, model, variables):
    requests = [_unet_request(i) for i in range(UNET_REQUESTS)]
    out = _serve_images(
        "unet_serve", dev, smi, "unet", _output_single(model), variables,
        requests, clients=UNET_CLIENTS, max_batch=UNET_MAX_BATCH,
        tol=TOL_SERVED, check=_masks)
    return {"model": "unet", **out}


# -- 31. the classic CNN zoo entries -----------------------------------------

# Each at its zoo default input shape and class count (224x224x3 and 1000,
# SimpleCNN 48x48x3 and 10), batch 4 of bench_resnet50's data, Adam 1e-3:
# the output and one step (Dropout's masks drawn alike in both copies)
# against a float64 copy on the card, then ZOO_STEPS steps of fit and one
# step's breakdown. The gradients per leaf (LeNet-5's limits) for the
# shallow nets without BatchNorm, by relative L2 (ResNet-50's) for the
# BatchNorm models and for VGG16/19: 13-16 ReLU convs without BatchNorm
# at the JAX zoo's init, whose float32 step on an H100 put 1.18e-2 of a
# bias leaf's max between float32 and float64 (VGG16, 11_conv2d/b; the
# trace's float32 convs include cuDNN's FFT algorithms, cf32 GEMMs),
# where AlexNet held 3.4e-6.
ZOO_CNN = ("alexnet", "vgg16", "vgg19", "simplecnn", "darknet19",
           "squeezenet")
ZOO_PER_LEAF = ("alexnet", "squeezenet")
ZOO_BATCH, ZOO_STEPS = 4, 3
# the float32 output (softmax probabilities) against float64's, as a
# fraction of its largest entry: float32 rounding carried through up to
# 19 layers (VGG16 read 9.9e-6 on an H100)
TOL_ZOO_OUT = 1e-4


def _zoo_case(model):
    """(input size, classes) of a zoo model's config."""
    cfg = model.config
    shape = (cfg.input_shape if hasattr(cfg, "input_shape")
             else cfg.input_shapes["input"])
    out = (model.shapes[-1] if isinstance(model.shapes, list)
           else model.shapes["output"])
    return shape[0], out[-1]


def _model_output(model, variables, x):
    out = model.output(variables, x)
    return out if torch.is_tensor(out) else out["output"]


def phase_zoo_cnn(dev, smi):
    from deeplearning4j_tpu_torch.models.zoo import get_model
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    results = {}
    for name in ZOO_CNN:
        t0 = time.monotonic()
        model = get_model(name, device=dev, updater=Adam(1e-3), seed=SEED)
        trainer = Trainer(model)
        ts0 = trainer.init_state()
        size, classes = _zoo_case(model)
        on_dev = [batch_to_device(b, dev) for b in _image_batches(
            ZOO_STEPS, ZOO_BATCH, size, classes)]
        variables = trainer.variables(ts0)
        n_params = model.num_params(variables)
        x = on_dev[0]["features"]
        out32 = _model_output(model, variables, x)
        out64 = _model_output(model, _float64_copy(variables), x.double())
        out_err = float((out32.double() - out64).abs().max()
                        / out64.abs().max())
        log(f"[zoo_cnn] {name}: {n_params:,} parameters, {size}x{size}x3, "
            f"{classes} classes, built in {time.monotonic() - t0:.1f} s; "
            f"output vs float64 {out_err:.2e} of its max (tol "
            f"{TOL_ZOO_OUT:.0e})")
        if not out_err <= TOL_ZOO_OUT:
            raise SystemExit(f"chip_smoke: zoo {name}: the output disagrees "
                             "with float64")
        f64 = _vs_float64(f"zoo_{name}", trainer, ts0, on_dev[0],
                          per_leaf_max=name in ZOO_PER_LEAF,
                          dropout_seed=SEED)
        steps = _step_events()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ts = trainer.fit(ts0, on_dev, epochs=1, listeners=[steps])
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        losses = [float(v) for v in steps.losses]
        gaps = [a.elapsed_time(b) for a, b in zip(steps.events,
                                                  steps.events[1:])]
        step_ms = float(np.median(gaps))
        log(f"[zoo_cnn] {name}: {ts.step} steps, losses "
            f"{[round(v, 4) for v in losses]}, median step {step_ms:.2f} ms "
            f"({ZOO_BATCH / (step_ms / 1e3):.1f} images/s), peak memory "
            f"{peak_gib:.2f} GiB")
        if ts.step != ZOO_STEPS or not np.all(np.isfinite(losses)):
            raise SystemExit(f"chip_smoke: zoo {name} did not train")
        breakdown = _step_breakdown(trainer, ts, on_dev[0], ())
        log(f"[zoo_cnn] {name}: one step {breakdown['wall_ms']:.2f} ms "
            f"wall, {breakdown['device_ms']:.2f} device, idle "
            f"{breakdown['device_idle_share']:.1%}; top kernels "
            f"{breakdown['top_kernels_us']}")
        results[name] = {"num_params": n_params, "image": size,
                         "classes": classes, "batch": ZOO_BATCH,
                         "output_vs_float64": out_err, "vs_float64": f64,
                         "losses": losses, "median_step_ms": step_ms,
                         "step_ms_gaps": gaps, "peak_memory_gib": peak_gib,
                         "step_breakdown": breakdown}
        del model, trainer, ts0, ts, on_dev, variables, out32, out64
        gc.collect()
        torch.cuda.empty_cache()
    return {"models": results, "card": smi}


# -- 32. every new layer once on the card ------------------------------------

# (layer class, its fields, batchless input shape): every layer class the
# CNN slice ported (nn/layers/conv.py), LayerNorm,
# LocalResponseNormalization, Dropout (eval mode) and PixelOutput, at small
# shapes. Forward and the gradients of Σ y·c (input and every param) in
# float32 against the same layer in float64 on the card, each to
# TOL_LAYER_F64 of its float64 max.
CONV_LAYER_CASES = [
    ("Conv1D", dict(filters=8, kernel=3, stride=2, dilation=1), (33, 5)),
    ("Conv3D", dict(filters=6, kernel=(2, 3, 3), stride=(1, 2, 2)),
     (6, 9, 10, 4)),
    ("Deconv2D", dict(filters=6, kernel=3, stride=2), (9, 10, 4)),
    ("DepthwiseConv2D", dict(depth_multiplier=2, kernel=3, stride=2),
     (15, 14, 8)),
    ("SeparableConv2D", dict(filters=12, kernel=3, depth_multiplier=1),
     (15, 14, 8)),
    ("Upsampling2D", dict(scale=(2, 3)), (5, 6, 4)),
    ("ZeroPadding2D", dict(padding=(1, 2, 0, 3)), (5, 6, 4)),
    ("Cropping2D", dict(cropping=(1, 0, 2, 1)), (7, 8, 4)),
    ("SpaceToDepth", dict(block_size=2), (8, 10, 4)),
    ("Pooling1D", dict(pool_type="max", window=3, stride=2,
                       padding="SAME"), (17, 6)),
    ("ZeroPadding1D", dict(padding=(1, 2)), (9, 6)),
    ("Cropping1D", dict(cropping=(1, 2)), (9, 6)),
    ("Upsampling1D", dict(size=3), (9, 6)),
    ("Deconv3D", dict(filters=4, kernel=2, stride=2), (4, 5, 6, 3)),
    ("Pooling3D", dict(pool_type="avg", window=2, padding="SAME"),
     (5, 6, 7, 3)),
    ("Upsampling3D", dict(scale=(1, 2, 2)), (3, 4, 5, 3)),
    ("ZeroPadding3D", dict(padding=(1, 0, 2, 1, 0, 1)), (3, 4, 5, 3)),
    ("Cropping3D", dict(cropping=(1, 0, 0, 1, 1, 0)), (4, 5, 6, 3)),
    ("DepthToSpace", dict(block_size=2), (4, 5, 12)),
    ("LocallyConnected2D", dict(filters=6, kernel=3, stride=2), (9, 10, 4)),
    ("LocallyConnected1D", dict(filters=6, kernel=3), (12, 5)),
    ("LayerNorm", dict(), (7, 16)),
    ("LocalResponseNormalization", dict(), (5, 6, 32)),
    ("Dropout", dict(rate=0.5), (7, 16)),
    ("PixelOutput", dict(num_classes=1), (9, 10, 8)),
    ("PixelOutput", dict(num_classes=3), (9, 10, 8)),
]
TOL_LAYER_F64 = 1e-5


def _layer_vs_float64(name, kw, shape, dev, seed=SEED) -> dict:
    """One layer (by ``@class`` name) on ``dev`` in float32 against itself
    in float64 on ``dev``: its forward (inference) and the gradients of
    Σ y·c for a cotangent c, into the input and every param; every param
    leaf drawn from the seed. Errors as fractions of the float64 max."""
    import deeplearning4j_tpu_torch.models.zoo.pixel  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers  # noqa: F401
    from deeplearning4j_tpu_torch.nn.config import CONFIG_REGISTRY

    layer = CONFIG_REGISTRY[name](**kw)
    gen = torch.Generator().manual_seed(seed)
    params, state = layer.init(gen, shape, torch.float32)
    params = {k: 0.5 * torch.randn(p.shape, generator=gen)
              for k, p in params.items()}
    x = torch.randn((2, *shape), generator=gen)
    ct = torch.randn((2, *layer.output_shape(shape)), generator=gen)

    def run(dtype):
        p = {k: a.to(dev, dtype).requires_grad_() for k, a in params.items()}
        xd = x.to(dev, dtype).requires_grad_()
        y, _ = layer.apply(p, state, xd, train=False)
        grads = torch.autograd.grad((y * ct.to(dev, dtype)).sum(),
                                    [xd, *p.values()])
        return y, dict(zip(["x", *p], grads))

    y32, g32 = run(torch.float32)
    y64, g64 = run(torch.float64)

    def frac(a, b):
        a, b = a.detach().double(), b.detach()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    errors = {"y": frac(y32, y64),
              **{f"d{k}": frac(g32[k], g64[k]) for k in g64}}
    return {"out_shape": list(y32.shape), "device": str(y32.device),
            "max_err": max(errors.values()), "errors": errors}


def phase_conv_layers(dev, smi):
    cases = {}
    for name, kw, shape in CONV_LAYER_CASES:
        tag = f"{name}({', '.join(f'{k}={v}' for k, v in kw.items())})"
        row = _layer_vs_float64(name, kw, shape, dev)
        cases[tag] = row
        log(f"[conv_layers] {tag} on {row['device']}: out "
            f"{row['out_shape']}, float32 vs float64 {row['max_err']:.2e} of"
            f" the max (tol {TOL_LAYER_F64:.0e})")
        if not row["device"].startswith("cuda") or \
                not row["max_err"] <= TOL_LAYER_F64:
            raise SystemExit(f"chip_smoke: conv_layers: {tag} failed")
    return {"cases": cases, "card": smi}


# -- 33. samediff_bert: a frozen BERT-base GraphDef through SameDiff --------

# The frozen graph's feeds and output: the names of Bert.encode's features
BERT_GRAPH_INPUTS = ("token_ids", "segment_ids", "mask")
BERT_GRAPH_OUTPUT = "hidden"
# masked keys: the additive bias of the original BERT (exp(-1e4) is 0 in
# float32 and float64, as the flash kernel's masked keys are)
BERT_MASK_BIAS = -10000.0
GELU_C = 0.7978845608028654  # sqrt(2/pi): the tanh form, jax.nn.gelu's
SD_BATCH, SD_T = 32, 128      # bench.py bench_bert's shape (:483)
SD_CALLS = 20                 # timed sd.output calls
SD_FIT_STEPS = 20
# Adam's first step moves every weight of the random encoder by ~lr (a
# sign step) and lifts the loss before it falls: at 1e-5 to 1.54 from
# 0.79, at 2e-5 to 2.61, ending 0.43 and 0.66 (on an H100)
SD_LR = 1e-5
SD_CLASSES = 2
SD_MARKERS = (1, 2)           # the token at [CLS]'s position names the class
TOL_SD_INTERP = 1e-6          # interpreted vs the cached plan, max |diff|
# calculate_gradients' relative L2 over all leaves, beside ResNet-50's
# TOL_GRAD_L2: float32 reads ~7e-7 against float64 (the float64 copy's own
# noise ~7e-7 on an H100), a TF32 or bf16 backward 1e-3 or more
TOL_SD_GRAD_L2 = 1e-4


def bert_encoder_params(model) -> dict:
    """The encoder's weights of a port ``Bert`` as host float32 arrays,
    under the JAX package's names (the MLM, pooler and NSP heads left
    out)."""
    from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

    return {n: p.detach().float().cpu().numpy()
            for n, p in flatten_with_names(model.variables()["params"])
            if n.startswith(("embeddings/", "layer_"))}


class _GraphWriter:
    """NodeDefs in creation order, named as TensorFlow names them (a name
    taken twice gets ``_1``, ``_2``...)."""

    def __init__(self):
        from deeplearning4j_tpu_torch.modelimport import tf_proto

        self.pb = tf_proto
        self.nodes = []
        self.taken = {}
        self.reads = []

    def _name(self, base):
        n = self.taken.get(base, 0)
        self.taken[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    def attr(self, kind, value):
        return self.pb.AttrValue(kind, value)

    def type_(self, dt):
        return self.attr("type", dt)

    def node(self, op, inputs, attrs=None, name=None):
        name = name or self._name(op)
        self.nodes.append(self.pb.NodeDef(name=name, op=op, input=list(inputs),
                                          attr=dict(attrs or {})))
        return name

    def const(self, name, arr):
        """A Const node: a scalar in its typed field (as TensorFlow writes
        a Python number), an array in tensor_content."""
        arr = np.asarray(arr)
        if arr.ndim == 0:
            dt = self.pb.NUMPY_DT[str(arr.dtype)]
            field = {1: "float_val", 3: "int_val"}[dt]
            t = self.pb.TensorProto(dtype=dt, vals={field: arr.reshape(1)})
        else:
            t = self.pb.make_tensor_proto(arr)
        return self.node("Const", [], {
            "value": self.attr("tensor", t), "dtype": self.type_(t.dtype)},
            name=self._name(name))

    def weight(self, name, arr):
        """A frozen variable read: Const → Identity, as TensorFlow's
        convert_variables_to_constants_v2 leaves a ReadVariableOp."""
        c = self.const(name, arr)
        read = self.node("Identity", [c], {"T": self.type_(1)},
                         name=self._name(f"{name}/read"))
        self.reads.append(read)
        return read

    def op(self, op, *inputs, **attrs):
        a = {"T": self.type_(1)}
        a.update(attrs)
        return self.node(op, inputs, a)


def bert_graph_def(params, *, num_heads, eps, batch, seq_len) -> bytes:
    """A frozen GraphDef of ``Bert.encode`` with ``params`` (numpy, the
    JAX package's names) as Const nodes: the graph TensorFlow's
    ``convert_variables_to_constants_v2`` gives for a ``tf.function`` of
    the same encoder at a fixed [batch, seq_len] (the test
    tests/test_torch_tfimport.py holds the two to the same ops and
    outputs). Embedding tables are gathered straight from their Const
    (ResourceGather → GatherV2), every other weight read through an
    Identity; positions are ``GatherV2(Range)``; masked keys get
    BERT_MASK_BIAS; LayerNorm is the population-variance decomposition;
    gelu the tanh form. The one output, ``hidden`` [batch, seq_len,
    width], hangs off a NoOp that holds every read, as in TF's graph."""
    g = _GraphWriter()
    pb = g.pb
    n, t = batch, seq_len
    width = params["embeddings/word"].shape[1]
    head = width // num_heads
    layers = sorted({k.split("/")[0] for k in params
                     if k.startswith("layer_")}, key=lambda s: int(s[6:]))
    f32, i32 = np.float32, np.int32

    def shape_attr(dims):
        return g.attr("shape", pb.TensorShapeProto([pb.Dim(d) for d in dims]))

    ids = g.node("Placeholder", [], {"dtype": g.type_(3),
                                     "shape": shape_attr((n, t))},
                 name=BERT_GRAPH_INPUTS[0])
    seg = g.node("Placeholder", [], {"dtype": g.type_(3),
                                     "shape": shape_attr((n, t))},
                 name=BERT_GRAPH_INPUTS[1])
    mask = g.node("Placeholder", [], {"dtype": g.type_(1),
                                      "shape": shape_attr((n, t))},
                  name=BERT_GRAPH_INPUTS[2])

    def gather(table, idx):
        return g.node("GatherV2", [table, idx,
                                   g.const("Gather/axis", i32(0))],
                      {"Tparams": g.type_(1), "Tindices": g.type_(3),
                       "Taxis": g.type_(3), "batch_dims": g.attr("i", 0)})

    def matmul(a, b, adj_y=False):
        return g.op("BatchMatMulV2", a, b, adj_x=g.attr("b", False),
                    adj_y=g.attr("b", adj_y))

    def mean(x):
        return g.op("Mean", x, g.const("Mean/reduction_indices", i32(-1)),
                    keep_dims=g.attr("b", True), Tidx=g.type_(3))

    def layer_norm(x, prefix, gamma, beta):
        m = mean(x)
        centred = g.op("Sub", x, m)
        var = mean(g.op("SquaredDifference", x, m))
        inv = g.op("Rsqrt", g.op("AddV2", var, g.const("add/y", f32(eps))))
        scaled = g.op("Mul", g.op("Mul", centred, inv),
                      g.weight(f"{prefix}{gamma}", params[f"{prefix}{gamma}"]))
        return g.op("AddV2", scaled,
                    g.weight(f"{prefix}{beta}", params[f"{prefix}{beta}"]))

    def reshape(x, dims):
        return g.op("Reshape", x, g.const("Reshape/shape", i32(dims)),
                    Tshape=g.type_(3))

    def transpose(x, perm):
        return g.op("Transpose", x, g.const("transpose/perm", i32(perm)),
                    Tperm=g.type_(3))

    def dense(x, w, b):
        return g.op("AddV2", matmul(x, g.weight(w, params[w])),
                    g.weight(b, params[b]))

    def heads(x):
        return transpose(reshape(x, [n, t, num_heads, head]), [0, 2, 1, 3])

    def gelu(x):
        cube = g.op("Mul", g.const("Gelu/Cast/x", f32(0.044715)),
                    g.op("Pow", x, g.const("Gelu/Pow/y", f32(3.0))))
        inner = g.op("Mul", g.const("Gelu/mul_2/x", f32(GELU_C)),
                     g.op("AddV2", x, cube))
        half = g.op("Mul", g.const("Gelu/mul/x", f32(0.5)), x)
        return g.op("Mul", half, g.op("AddV2", g.const("Gelu/add_1/x",
                                                       f32(1.0)),
                                      g.op("Tanh", inner)))

    positions = g.node("Range", [g.const("range/start", i32(0)),
                                 g.const("range/limit", i32(t)),
                                 g.const("range/delta", i32(1))],
                       {"Tidx": g.type_(3)}, name="range")
    x = g.op("AddV2", gather(g.const("embeddings/word",
                                     params["embeddings/word"]), ids),
             gather(g.const("embeddings/position",
                            params["embeddings/position"]), positions))
    x = g.op("AddV2", x, gather(g.const("embeddings/type",
                                        params["embeddings/type"]), seg))
    x = layer_norm(x, "embeddings/", "ln_gamma", "ln_beta")
    bias = g.op("Mul", g.op("Sub", g.const("sub/x", f32(1.0)),
                            reshape(mask, [n, 1, 1, t])),
                g.const("mul/y", f32(BERT_MASK_BIAS)))
    for layer in layers:
        p = f"{layer}/attention/"
        q = heads(dense(x, p + "Wq", p + "bq"))
        k = heads(dense(x, p + "Wk", p + "bk"))
        v = heads(dense(x, p + "Wv", p + "bv"))
        scores = g.op("Mul", matmul(q, k, adj_y=True),
                      g.const("mul/y", f32(head ** -0.5)))
        probs = g.op("Softmax", g.op("AddV2", scores, bias))
        ctx = reshape(transpose(matmul(probs, v), [0, 2, 1, 3]), [n, t, width])
        x = layer_norm(g.op("AddV2", x, dense(ctx, p + "Wo", p + "bo")),
                       f"{layer}/", "ln1_gamma", "ln1_beta")
        ffn = dense(gelu(dense(x, f"{layer}/W1", f"{layer}/b1")),
                    f"{layer}/W2", f"{layer}/b2")
        x = layer_norm(g.op("AddV2", x, ffn), f"{layer}/", "ln2_gamma",
                       "ln2_beta")
    hold = g.node("NoOp", [f"^{r}" for r in g.reads])
    g.node("Identity", [x, f"^{hold}"], {"T": g.type_(1)},
           name=BERT_GRAPH_OUTPUT)
    return pb.GraphDef(node=g.nodes).encode()


def _sd_batch(vocab, seed=SEED):
    """[SD_BATCH, SD_T] ids, segments and a key mask (lengths 8..T, no row
    fully masked: the flash kernel gives such a row zeros, the graph's
    softmax a uniform row), and class labels, learnable from the batch:
    the first token (where [CLS] stands) is SD_MARKERS[label]."""
    r = np.random.default_rng(seed)
    lengths = r.integers(8, SD_T + 1, SD_BATCH)
    pos = np.arange(SD_T)[None, :]
    labels = r.integers(0, SD_CLASSES, SD_BATCH).astype(np.int32)
    ids = r.integers(0, vocab, (SD_BATCH, SD_T)).astype(np.int32)
    ids[:, 0] = np.asarray(SD_MARKERS, np.int32)[labels]
    return {
        "token_ids": ids,
        "segment_ids": (pos >= lengths[:, None] // 2).astype(np.int32),
        "mask": (pos < lengths[:, None]).astype(np.float32),
        "labels": labels,
    }


def _sd_float64(sd):
    """The same graph with every floating value in float64, on the same
    device (built from to_dict; under enable_x64 the values keep 64
    bits)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, enable_x64

    with enable_x64():
        sd64 = SameDiff.from_dict(sd.to_dict(), device=sd.device)
        for name, value in sd._values.items():
            sd64.set_value(name, value.double() if value.is_floating_point()
                           else value)
    return sd64


def _sd_timed(fn, calls=SD_CALLS):
    """Per-call wall ms of ``fn`` (synchronised), after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(ms)


def phase_samediff_bert(dev, smi):
    """A frozen full-width BERT-base GraphDef, written with the port's
    codec from ``Bert.init(SEED)``'s weights, decoded and imported with
    ``import_tf_graph`` onto the card; served with ``sd.output`` (against
    the native ``Bert.encode`` and a float64 run of the same graph),
    then fine-tuned with ``sd.fit`` through a [CLS] head, saved and
    loaded."""
    from collections import Counter

    from deeplearning4j_tpu_torch.autodiff import (
        SameDiff,
        TrainingConfig,
        enable_x64,
    )
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.modelimport import import_tf_graph, tf_proto
    from deeplearning4j_tpu_torch.models.bert import bert_base
    from deeplearning4j_tpu_torch.nn import config as nnconfig
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    model = bert_base(device=dev, net=nnconfig.NeuralNetConfiguration(
        seed=SEED))
    cfg = model.config
    params = bert_encoder_params(model)
    t0 = time.monotonic()
    blob = bert_graph_def(params, num_heads=cfg.num_heads, eps=cfg.eps,
                          batch=SD_BATCH, seq_len=SD_T)
    write_s = time.monotonic() - t0
    t0 = time.monotonic()
    gd = tf_proto.GraphDef.decode(blob)
    decode_s = time.monotonic() - t0
    t0 = time.monotonic()
    sd, in_map, out_map = import_tf_graph(gd, device=dev)
    torch.cuda.synchronize()
    import_s = time.monotonic() - t0
    hist = dict(sorted(Counter(nd.op for nd in gd.node).items(),
                       key=lambda kv: -kv[1]))
    hidden = out_map[BERT_GRAPH_OUTPUT]
    n_params = sum(a.size for a in params.values())
    log(f"[samediff_bert] frozen BERT-base GraphDef ({n_params:,} encoder "
        f"parameters): {len(blob):,} bytes, "
        f"{len(gd.node)} nodes {hist}; written in {write_s:.2f} s, decoded "
        f"in {decode_s:.3f} s, imported in {import_s:.2f} s "
        f"({len(sd.ops())} SameDiff ops)")
    graph_bytes = len(blob)
    del blob

    batch = _sd_batch(cfg.vocab_size)
    feeds = {in_map[k]: torch.from_numpy(batch[k]).to(dev)
             for k in BERT_GRAPH_INPUTS}
    tokens = SD_BATCH * SD_T

    # -- serve: the path, with every count at 0 before it ------------------
    _dispatch.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")  # a copy to the host raises
    try:
        h_plan = sd.output(feeds, [hidden])[hidden]
        h_interp = sd.output(feeds, [hidden], interpreted=True)[hidden]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    serve_ms = _sd_timed(lambda: sd.output(feeds, [hidden]))
    launches = {"serving": dict(_dispatch.launch_counts())}
    interp_err = float((h_plan - h_interp).abs().max())

    # -- against the native encoder and a float64 run of the same graph ----
    with torch.inference_mode():
        fb = {k: torch.from_numpy(batch[k]).to(dev) for k in BERT_GRAPH_INPUTS}
        h_native = model.encode(fb)
        native_ms = _sd_timed(lambda: model.encode(fb))
    sd64 = _sd_float64(sd)
    with enable_x64():
        h64 = sd64.output(feeds, [hidden])[hidden]
    del sd64
    err_native = float((h_plan - h_native).abs().max())
    err_64 = float((h_plan.double() - h64).abs().max())
    err_native_64 = float((h_native.double() - h64).abs().max())
    width = cfg.hidden
    log(f"[samediff_bert] sd.output hidden [{SD_BATCH},{SD_T},{width}] vs "
        f"Bert.encode {err_native:.3e}, vs float64 {err_64:.3e}, Bert.encode "
        f"vs float64 {err_native_64:.3e} (tol {TOL_HIDDEN:.0e}); interpreted"
        f" vs cached plan {interp_err:.3e} (tol {TOL_SD_INTERP:.0e})")
    if not (h_plan.dtype == torch.float32 and h64.dtype == torch.float64
            and tuple(h_plan.shape) == (SD_BATCH, SD_T, width)
            and bool(torch.isfinite(h_plan).all())):
        raise SystemExit("chip_smoke: samediff_bert: bad served hidden "
                         "states")
    if max(err_native, err_64, err_native_64) > TOL_HIDDEN or \
            interp_err > TOL_SD_INTERP:
        raise SystemExit("chip_smoke: samediff_bert: outputs disagree")
    del h_native, h64, h_interp

    # -- fine-tune: weights promoted, a [CLS] head and the sparse loss ------
    weights = [n for n in params if n in sd._vars]
    for name in weights:
        sd.convert_to_variable(name)
    h = sd.get_variable(hidden)
    select = np.zeros((1, SD_T), np.float32)
    select[0, 0] = 1.0  # [CLS]: row 0 of every sequence
    cls = sd.constant("cls_select", select).mmul(h).reshape(SD_BATCH, width)
    rng = np.random.default_rng(SEED)
    w_cls = sd.var("classifier/W", (0.02 * rng.standard_normal(
        (width, SD_CLASSES))).astype(np.float32))
    b_cls = sd.var("classifier/b", np.zeros(SD_CLASSES, np.float32))
    labels = sd.placeholder("labels", (SD_BATCH,), "int32")
    loss = sd.loss.sparse_softmax_cross_entropy(cls.mmul(w_cls) + b_cls,
                                                labels)
    train_feeds = dict(feeds, labels=torch.from_numpy(
        batch["labels"]).to(dev))
    tcfg = TrainingConfig(
        loss_variable=loss.name, feature_placeholders=list(feeds),
        label_placeholders=["labels"], updater="adam",
        updater_args={"learning_rate": SD_LR})
    events = _step_events()
    _dispatch.reset_launch_counts()
    t0 = time.monotonic()
    history = sd.fit([train_feeds], tcfg, epochs=SD_FIT_STEPS,
                     listeners=[events])
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches["fit"] = dict(_dispatch.launch_counts())
    step_ms = np.asarray([a.elapsed_time(b) for a, b in
                          zip(events.events, events.events[1:])])
    log(f"[samediff_bert] hand-kernel launches serving and over "
        f"{SD_FIT_STEPS} fit steps: {launches} (this path runs none)")
    if launches["serving"] or launches["fit"]:
        raise SystemExit("chip_smoke: samediff_bert launched a hand kernel")

    # -- no fallback: every value, state leaf and output on the card -------
    off = [n for n, v in sd._values.items() if v.device.type != "cuda"]
    off += [f"updater leaf {i}" for i, v in
            enumerate(tree_leaves(sd._updater_state))
            if v.device.type != "cuda"]
    if off or h_plan.device.type != "cuda":
        raise SystemExit(f"chip_smoke: samediff_bert: off the card: "
                         f"{off[:5]}")

    # gradients of the trained graph, float32 against float64
    loss32 = float(sd.output(train_feeds, [loss.name])[loss.name])
    g32 = sd.calculate_gradients(train_feeds, loss.name)
    sd64 = _sd_float64(sd)
    with enable_x64():
        loss64 = float(sd64.output(train_feeds, [loss.name])[loss.name])
        g64 = sd64.calculate_gradients(train_feeds, loss.name)
        gen = torch.Generator(dev).manual_seed(SEED)
        for name in g64:  # the float64 copy's own spread (params moved by 2^-24)
            w = sd64._values[name]
            sd64.set_value(name, w * (1 + 2.0 ** -24 * torch.randn(
                w.shape, generator=gen, device=dev, dtype=w.dtype)))
        g_noise = sd64.calculate_gradients(train_feeds, loss.name)
    del sd64
    loss_rel = abs(loss32 - loss64) / abs(loss64)
    # ResNet-50's relative L2 limits, each leaf's norm floored at
    # TOL_GRAD_FLOOR of the largest leaf's (as _check_grads floors a max):
    # the key biases' gradient is zero but for rounding (softmax ignores a
    # shift of a query's scores), and an error over zero has no scale
    top = max(float(w.norm()) for w in g64.values())
    floors = {n: max(float(w.norm()), TOL_GRAD_FLOOR * top)
              for n, w in g64.items()}
    floored = sorted(n for n, w in g64.items()
                     if float(w.norm()) < TOL_GRAD_FLOOR * top)
    _, all_l2 = _l2_errors(g32, g64)
    leaf_l2 = {n: float((g32[n].double() - w).norm()) / floors[n]
               for n, w in g64.items()}
    worst = max(leaf_l2, key=leaf_l2.get)
    noise_all = _l2_errors(g_noise, g64)[1]
    noise_worst = max(float((g_noise[n] - w).norm()) / floors[n]
                      for n, w in g64.items())
    del g32, g64, g_noise
    log(f"[samediff_bert] calculate_gradients float32 vs float64 over "
        f"{len(leaf_l2)} variables: loss {loss32:.7f} vs {loss64:.7f} (rel "
        f"{loss_rel:.2e}, tol {TOL_LOSS_REL:.0e}); relative L2 {all_l2:.2e} "
        f"(tol {TOL_SD_GRAD_L2:.0e}), worst {worst} {leaf_l2[worst]:.2e} "
        f"(tol {TOL_GRAD_L2:.0e}); the "
        f"float64 copy's own under 2^-24 noise {noise_all:.2e}, worst leaf "
        f"{noise_worst:.2e}; {len(floored)} leaves floored at "
        f"{TOL_GRAD_FLOOR:.0e} of the largest norm ({floored[:4]}...)")
    if loss_rel > TOL_LOSS_REL or all_l2 > min(TOL_GRAD_L2, TOL_SD_GRAD_L2) \
            or leaf_l2[worst] > TOL_GRAD_L2:
        raise SystemExit("chip_smoke: samediff_bert: float32 gradients "
                         "disagree with float64")
    if not (np.all(np.isfinite(history)) and history[-1] < history[0]):
        raise SystemExit(f"chip_smoke: samediff_bert: the loss did not fall "
                         f"over {SD_FIT_STEPS} fit steps: {history}")
    log(f"[samediff_bert] sd.fit {SD_FIT_STEPS} Adam({SD_LR}) steps on one "
        f"batch: loss {' '.join(f'{h:.4f}' for h in history)}; step "
        f"{np.median(step_ms):.2f} ms median "
        f"({tokens / np.median(step_ms) * 1e3:.0f} tokens/s), fit wall "
        f"{fit_s:.2f} s")

    # -- save -> load: the same outputs, and fit resumes its Adam state ----
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bert_base.sdz"
        t0 = time.monotonic()
        sd.save(path)
        save_s = time.monotonic() - t0
        size = path.stat().st_size
        t0 = time.monotonic()
        sd2 = SameDiff.load(path, device=dev)
        load_s = time.monotonic() - t0
    outs = [hidden, loss.name]
    a, b = sd.output(train_feeds, outs), sd2.output(train_feeds, outs)
    same_out = all(torch.equal(a[k], b[k]) for k in outs)
    saved = [v.cpu().numpy() for v in tree_leaves(sd._updater_state)]
    same_state = len(saved) == len(sd2._updater_leaves) and all(
        np.array_equal(x, y) for x, y in zip(saved, sd2._updater_leaves))
    next_a = sd.fit([train_feeds], epochs=1)[0]
    next_b = sd2.fit([train_feeds], epochs=1)[0]
    step_gap = max(float((sd._values[n] - sd2._values[n]).abs().max())
                   for n in weights)
    log(f"[samediff_bert] save {size / 2**20:.1f} MiB in {save_s:.2f} s, "
        f"load {load_s:.2f} s: outputs identical {same_out}, updater leaves "
        f"identical {same_state}; the next step's loss {next_a:.7f} vs "
        f"{next_b:.7f}, weights after it {step_gap:.2e} apart (limit "
        f"{0.01 * SD_LR:.0e}: a fresh Adam state moves them by ~{SD_LR:.0e})")
    if not (same_out and same_state and sd2._iteration == sd._iteration
            and next_a == next_b and step_gap <= 0.01 * SD_LR):
        raise SystemExit("chip_smoke: samediff_bert: save/load did not "
                         "resume")
    del sd2

    serve_bd = _step_breakdown(None, None, None, (),
                               step=lambda: sd.output(feeds, [hidden]))
    train_bd = _step_breakdown(None, None, None, (),
                               step=lambda: sd.fit([train_feeds], epochs=1))
    out = {
        "graph_bytes": graph_bytes, "nodes": len(gd.node),
        "encoder_params": n_params,
        "op_histogram": hist, "samediff_ops": len(sd.ops()),
        "write_s": write_s, "decode_s": decode_s, "import_s": import_s,
        "batch": SD_BATCH, "seq_len": SD_T, "calls": SD_CALLS,
        "serve_tokens_per_s": tokens / (np.median(serve_ms) / 1e3),
        "serve_p50_ms": float(np.percentile(serve_ms, 50)),
        "serve_p99_ms": float(np.percentile(serve_ms, 99)),
        "native_tokens_per_s": tokens / (np.median(native_ms) / 1e3),
        "native_p50_ms": float(np.percentile(native_ms, 50)),
        "native_p99_ms": float(np.percentile(native_ms, 99)),
        "max_abs_err_vs_native": err_native, "max_abs_err_vs_float64": err_64,
        "native_max_abs_err_vs_float64": err_native_64,
        "interpreted_vs_plan": interp_err,
        "loss_rel_vs_float64": loss_rel, "grad_l2_vs_float64": all_l2,
        "worst_grad_leaf": worst, "worst_grad_l2": leaf_l2[worst],
        "noise_grad_l2": noise_all, "noise_worst_grad_l2": noise_worst,
        "grad_leaves_floored": floored,
        "fit_steps": SD_FIT_STEPS, "fit_lr": SD_LR, "loss_history": history,
        "train_step_ms": float(np.median(step_ms)),
        "train_tokens_per_s": tokens / (np.median(step_ms) / 1e3),
        "save_s": save_s, "load_s": load_s, "saved_bytes": size,
        "launches": launches, "serve_breakdown": serve_bd,
        "train_breakdown": train_bd, "card": smi,
    }
    log(f"[samediff_bert] serving {out['serve_tokens_per_s']:.0f} tokens/s "
        f"(p50 {out['serve_p50_ms']:.2f} ms, p99 {out['serve_p99_ms']:.2f} ms"
        f" a call) beside the native Bert.encode's "
        f"{out['native_tokens_per_s']:.0f} (p50 {out['native_p50_ms']:.2f} ms)"
        f"; training {out['train_tokens_per_s']:.0f} tokens/s; idle share "
        f"serving {serve_bd['device_idle_share']:.1%}, training "
        f"{train_bd['device_idle_share']:.1%}, on {smi}")
    return out


# -- 34-36. the Keras next-frame ConvLSTM model ------------------------------

# Keras 2's examples/conv_lstm.py ("next-frame prediction of artificially
# generated movies with moving squares"): 4 × [ConvLSTM2D(40, 3×3, same,
# return_sequences) → BatchNormalization], Conv3D(1, 3×3×3, same) with a
# sigmoid and binary cross-entropy, adadelta (rho 0.95, epsilon 1e-7), batch
# 10 of 15-frame 40×40 movies; 406,681 parameters, nothing of the width
# cut. BatchNorm at the JAX package's defaults (decay 0.9, eps 1e-5; Keras'
# 0.99 and 1e-3). Cut: 30 steps on 100 movies (the example: 300 epochs of
# 950).
CONVLSTM_T, CONVLSTM_SIZE, CONVLSTM_FILTERS, CONVLSTM_DEPTH = 15, 40, 40, 4
CONVLSTM_PARAMS = 406_681
CONVLSTM_BATCH, CONVLSTM_BATCHES, CONVLSTM_EPOCHS = 10, 10, 3  # 30 steps
CONVLSTM_TBPTT = 5       # 3 windows a batch of 15 frames
# 50 requests (100 before the YOLO phases joined the script: JSON-bound)
CONVLSTM_REQUESTS, CONVLSTM_CLIENTS, CONVLSTM_MAX_BATCH = 50, 4, 8
# the example's rollout: 7 frames seen, then each new frame predicted from
# the whole track so far, 8 times
ROLLOUT_SEEN, ROLLOUT_NEW = 7, 8
TOL_ROLLOUT = 1e-4


def generate_movies(n_samples, n_frames=CONVLSTM_T, seed=SEED):
    """A numpy port of the example's ``generate_movies``: on 80×80
    canvases, 3–7 squares each (side 2w, w = 2 or 3: ``randint(2, 4)``)
    start in [20, 60)², move by −1, 0 or +1 pixel a frame on each axis;
    each frame of each square gets, with probability 1/2, a ±0.1 ring one
    pixel wider; the target is the same squares one frame later, without
    noise. Both cropped to [20:60]² and clipped at 1 → (noisy movies,
    next frames), float32 [n, n_frames, 40, 40, 1], from ``seed``."""
    r = np.random.default_rng(seed)
    noisy = np.zeros((n_samples, n_frames, 80, 80, 1))
    shifted = np.zeros_like(noisy)
    for i in range(n_samples):
        for _ in range(r.integers(3, 8)):
            x0, y0 = r.integers(20, 60, 2)
            dx, dy = r.integers(0, 3, 2) - 1
            w = r.integers(2, 4)
            for t in range(n_frames):
                xs, ys = x0 + dx * t, y0 + dy * t
                noisy[i, t, xs - w:xs + w, ys - w:ys + w, 0] += 1
                if r.integers(0, 2):
                    sign = (-1) ** r.integers(0, 2)
                    noisy[i, t, xs - w - 1:xs + w + 1,
                          ys - w - 1:ys + w + 1, 0] += sign * 0.1
                xs, ys = x0 + dx * (t + 1), y0 + dy * (t + 1)
                shifted[i, t, xs - w:xs + w, ys - w:ys + w, 0] += 1
    noisy = np.minimum(noisy[:, :, 20:60, 20:60], 1.0)
    shifted = np.minimum(shifted[:, :, 20:60, 20:60], 1.0)
    return noisy.astype(np.float32), shifted.astype(np.float32)


def next_frame_config(t=CONVLSTM_T, size=CONVLSTM_SIZE,
                      filters=CONVLSTM_FILTERS, depth=CONVLSTM_DEPTH,
                      seed=SEED):
    """The example's model as a SequentialConfig of the port's layers."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.config import (
        NeuralNetConfiguration,
        SequentialConfig,
    )
    from deeplearning4j_tpu_torch.train.updaters import AdaDelta

    layers = []
    for _ in range(depth):
        layers += [L.ConvLSTM2D(filters=filters, kernel=3, padding="SAME",
                                return_sequences=True), L.BatchNorm()]
    layers += [L.Conv3D(filters=1, kernel=3, padding="SAME"),
               L.LossLayer(activation="sigmoid", loss="xent")]
    return SequentialConfig(
        net=NeuralNetConfiguration(seed=seed,
                                   updater=AdaDelta(rho=0.95, eps=1e-7)),
        layers=layers, input_shape=(t, size, size, 1))


def _next_frame_model(dev, **kw):
    from deeplearning4j_tpu_torch.nn.model import SequentialModel

    return SequentialModel(next_frame_config(**kw), device=dev)


def _movie_batches(n_batches, batch, seed=SEED, **kw):
    """``n_batches`` batches of ``batch`` movies (features) and their next
    frames (labels), one draw of ``generate_movies``."""
    x, y = generate_movies(n_batches * batch, seed=seed, **kw)
    return [{"features": x[i * batch:(i + 1) * batch],
             "labels": y[i * batch:(i + 1) * batch]}
            for i in range(n_batches)]


def _no_hand_kernels(tag, counts):
    """No Pallas kernel lies on the ConvLSTM path (the JAX layer is a
    lax.scan over XLA convs) nor on the YOLO family's (XLA convs, pools
    and plain jnp for the output layer, decode and NMS): the launch counts
    must stay {}."""
    if counts:
        raise SystemExit(f"chip_smoke: {tag} launched hand kernels "
                         f"{counts}; the path has none")


def phase_convlstm_train(dev, smi):
    """Returns the phase's line, the model and its trained variables (for
    phase 36)."""
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device

    t0 = time.monotonic()
    model = _next_frame_model(dev)
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    on_dev = [batch_to_device(b, dev) for b in
              _movie_batches(CONVLSTM_BATCHES, CONVLSTM_BATCH)]
    n_params = model.num_params(trainer.variables(ts0))
    fg = float(torch.stack([b["labels"].mean() for b in on_dev]).mean())
    log(f"[convlstm_train] next-frame ConvLSTM: {n_params:,} parameters, "
        f"{CONVLSTM_DEPTH} x ConvLSTM2D({CONVLSTM_FILTERS}) + BatchNorm, "
        f"Conv3D(1), AdaDelta(rho 0.95, eps 1e-7), batches "
        f"{CONVLSTM_BATCH}x{CONVLSTM_T}x{CONVLSTM_SIZE}x{CONVLSTM_SIZE}x1 "
        f"({fg:.1%} of target pixels on), built in "
        f"{time.monotonic() - t0:.1f} s")
    if n_params != CONVLSTM_PARAMS:
        raise SystemExit(f"chip_smoke: the next-frame model has {n_params} "
                         "parameters")
    f64 = _vs_float64("convlstm_train", trainer, ts0, on_dev[0],
                      per_leaf_max=True)
    fit, fp32 = _train_resnet("convlstm_train", trainer, ts0, on_dev, dev,
                              batch=CONVLSTM_BATCH, epochs=CONVLSTM_EPOCHS)
    _no_hand_kernels("convlstm_train", fit["launches"])
    movies_s = fp32["samples_per_s"]
    log(f"[convlstm_train] {movies_s:.1f} movies/s, "
        f"{movies_s * CONVLSTM_T:.1f} frames/s; phase "
        f"{time.monotonic() - t0:.1f} s, on {smi}")
    trained = trainer.variables(fit["ts"])
    del ts0
    return {"model": "keras_conv_lstm_next_frame", "batch": CONVLSTM_BATCH,
            "frames": CONVLSTM_T, "image": CONVLSTM_SIZE,
            "num_params": n_params, "target_on_share": fg,
            "vs_float64": f64, "float32": fp32, "movies_per_s": movies_s,
            "frames_per_s": movies_s * CONVLSTM_T,
            "phase_seconds": time.monotonic() - t0, "card": smi}, \
        model, trained


def _cudnn_deterministic():
    """cuDNN held to its deterministic algorithms (and TF32 off) inside a
    ``with``: where a check compares two runs of the same work bit for
    bit, not the atomic reductions of cuDNN's faster backward
    algorithms."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _float64_state(ts):
    """The TrainState with every floating leaf in float64."""
    def f64(a):
        return a.double() if a.is_floating_point() else a

    return dataclasses.replace(ts, params=_tree_map(f64, ts.params),
                               model_state=_tree_map(f64, ts.model_state),
                               opt_state=_tree_map(f64, ts.opt_state))


def _windows_vs_float64(trainer, ts0, windows) -> dict:
    """A batch's TBPTT windows in float32 against the float64 copy. Gated
    (by the caller): each window run by both from one state, the float32
    run's state before it (params, layer and updater state, the carries
    it was handed) promoted for the float64 copy: the window's loss and
    the carries it hands on. Reported beside them: the two run apart from
    the first state (``_run_windows``), whose gap also carries the float32
    rounding of every earlier window's update forward."""
    def f64(a):
        return a.double() if a.is_floating_point() else a

    ts, carries = ts0, trainer._zero_carries(ts0, windows[0]["features"])
    loss_rel, carry_frac, losses = [], [], []
    for wb in windows:
        nxt, c32, m32 = trainer.train_step_tbptt(ts, wb, carries)
        _, c64, m64 = trainer.train_step_tbptt(
            _float64_state(ts), dict(wb, features=wb["features"].double()),
            _tree_map(f64, carries))
        a, b = float(m32["total_loss"]), float(m64["total_loss"])
        losses.append(a)
        loss_rel.append(abs(a - b) / abs(b))
        carry_frac.append(_carry_frac(c32, c64))
        ts, carries = nxt, c32
    _, l32, h32 = _run_windows(trainer, ts0, windows)
    _, l64, h64 = _run_windows(trainer, _float64_state(ts0), [
        dict(w, features=w["features"].double()) for w in windows])
    return {"losses": losses, "loss_rel": loss_rel,
            "carry_err_frac": carry_frac,
            "apart_loss_rel": [abs(a - b) / abs(b) for a, b in zip(l32, l64)],
            "apart_carry_err_frac": [_carry_frac(a, b) for a, b in
                                     zip(h32, h64)]}


def phase_convlstm_tbptt(dev, smi):
    from deeplearning4j_tpu_torch.kernels import _dispatch
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    t0 = time.monotonic()
    model = _with_tbptt(_next_frame_model(dev), CONVLSTM_TBPTT)
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    on_dev = [batch_to_device(b, dev) for b in
              _movie_batches(CONVLSTM_BATCHES, CONVLSTM_BATCH)]
    n_win = -(-CONVLSTM_T // CONVLSTM_TBPTT)

    # 1. one batch window by window, float32 against the float64 copy
    windows = _tbptt_windows(on_dev[0], CONVLSTM_TBPTT)
    _dispatch.reset_launch_counts()
    vs64 = _windows_vs_float64(trainer, ts0, windows)
    counts = _dispatch.launch_counts()
    log(f"[convlstm_tbptt] one batch, {len(windows)} windows "
        f"({[w['features'].shape[1] for w in windows]} frames), float32 vs "
        f"float64, each window from one state: losses rel "
        f"{[f'{x:.2e}' for x in vs64['loss_rel']]} (tol "
        f"{TOL_LOSS_REL:.0e}), carries handed on "
        f"{[f'{x:.2e}' for x in vs64['carry_err_frac']]} of their max (tol "
        f"{TOL_CARRY:.0e}); the two run apart from the first state: losses "
        f"rel {[f'{x:.2e}' for x in vs64['apart_loss_rel']]}, carries "
        f"{[f'{x:.2e}' for x in vs64['apart_carry_err_frac']]} of their "
        f"max; launches {counts}")
    _no_hand_kernels("convlstm_tbptt", counts)
    if len(windows) != n_win or max(vs64["loss_rel"] + vs64[
            "apart_loss_rel"]) > TOL_LOSS_REL or max(
            vs64["carry_err_frac"]) > TOL_CARRY:
        raise SystemExit("chip_smoke: convlstm_tbptt: the float32 windows "
                         "disagree with float64")

    # 2. tbptt_length >= T: one window, the standard step bit for bit
    whole = Trainer(_with_tbptt(model, CONVLSTM_T))
    std = Trainer(_next_frame_model(dev))
    with _cudnn_deterministic():
        ts_w, wm = whole._fit_tbptt_batch(ts0, on_dev[0])
        ts_s, m_s = std.train_step(ts0, on_dev[0])
    whole_diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves((ts_w.params, ts_w.model_state)),
        tree_leaves((ts_s.params, ts_s.model_state))))
    log(f"[convlstm_tbptt] tbptt_length {CONVLSTM_T} (one window): loss "
        f"{float(wm[0]['total_loss']):.6f} vs the standard step's "
        f"{float(m_s['total_loss']):.6f}, params and BatchNorm state max "
        f"diff {whole_diff:.3e}")
    if len(wm) != 1 or whole_diff != 0.0:
        raise SystemExit("chip_smoke: convlstm_tbptt: one window over the "
                         "whole movie is not the standard step")
    del whole, std, ts_w, ts_s

    # 3. Trainer.fit, 10 batches of 3 windows, checkpoint restore (the
    # next batch after it, live and restored, with deterministic cuDNN: its
    # second and third windows run on params the first's backward moved)
    batch_step = _tbptt_batch_step(trainer)

    def next_batch_step(ts, batch):
        with _cudnn_deterministic():
            return batch_step(ts, batch)

    fit = _fit_and_restore("convlstm_tbptt", trainer, ts0, on_dev, 1, dev,
                           per_batch=n_win, step=next_batch_step)
    ts, losses = fit["ts"], fit["losses"]
    _no_hand_kernels("convlstm_tbptt", fit["launches"])
    if ts.step != n_win * CONVLSTM_BATCHES or len(losses) != ts.step or \
            not np.all(np.isfinite(losses)):
        raise SystemExit(f"chip_smoke: convlstm_tbptt: fit made "
                         f"{len(losses)} iterations, step {ts.step}; want "
                         f"{n_win * CONVLSTM_BATCHES}, finite losses")

    # 4. one window's time, from the carries the first left
    _, carries, _ = trainer.train_step_tbptt(
        ts, windows[0], trainer._zero_carries(ts, windows[0]["features"]))
    breakdown = _step_breakdown(
        trainer, ts, None, (),
        step=lambda: trainer.train_step_tbptt(ts, windows[1], carries))
    batch_ms = fit["median_step_ms"]
    log(f"[convlstm_tbptt] one window ({CONVLSTM_TBPTT} frames): "
        f"{breakdown}")
    log(f"[convlstm_tbptt] {len(losses)} windows over {CONVLSTM_BATCHES} "
        f"batches: loss {np.mean(losses[:n_win]):.4f} (first batch) -> "
        f"{np.mean(losses[-n_win:]):.4f} (last); median batch "
        f"{batch_ms:.2f} ms ({n_win} windows), "
        f"{n_win / (batch_ms / 1e3):,.1f} windows/s, "
        f"{CONVLSTM_BATCH / (batch_ms / 1e3):,.1f} movies/s, peak memory "
        f"{fit['peak_memory_gib']:.2f} GiB, phase "
        f"{time.monotonic() - t0:.1f} s, on {smi}")
    return {"model": "keras_conv_lstm_next_frame", "backprop_type": "tbptt",
            "tbptt_length": CONVLSTM_TBPTT, "windows_per_batch": n_win,
            "batches": CONVLSTM_BATCHES, "steps": ts.step,
            "launches": fit["launches"], "vs_float64": vs64,
            "whole_sequence_window_vs_standard_max_diff": whole_diff,
            "losses": losses, "median_batch_ms": batch_ms,
            "batch_ms_gaps": fit["step_ms_gaps"],
            "windows_per_s": n_win / (batch_ms / 1e3),
            "movies_per_s": CONVLSTM_BATCH / (batch_ms / 1e3),
            "peak_memory_gib": fit["peak_memory_gib"],
            "fit_seconds": fit["fit_seconds"],
            "checkpoint_next_loss": fit["checkpoint_next_loss"],
            "window_breakdown": breakdown,
            "phase_seconds": time.monotonic() - t0, "card": smi}


def _movie_request(i):
    """1–2 held-out movies [n, 15, 40, 40, 1] (seeds apart from the
    training movies')."""
    return generate_movies(1 + i % 2, seed=6000 + i)[0]


def _frames(out, req):
    """A served-output check: next-frame probabilities of the request's
    shape."""
    return out.shape == req.shape and out.min() >= 0 and out.max() <= 1


def _rollout(tag, dev, model, variables, movie):
    """The example's rollout behind ModelServer: the first ROLLOUT_SEEN
    frames of ``movie``, then ROLLOUT_NEW times the whole track so far
    sent to the served model and its last frame's prediction appended;
    one registry entry a track length (the input spec is fixed-shape)
    → (the predicted frames [ROLLOUT_NEW, 40, 40, 1], seconds)."""
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry,
        ModelServer,
        ServingClient,
        spec,
    )

    reg = ModelRegistry()
    size = movie.shape[1:]
    for t in range(ROLLOUT_SEEN, ROLLOUT_SEEN + ROLLOUT_NEW):
        reg.register(f"next_frame_t{t}", _sequential_output(model),
                     variables, input_spec=spec((t, *size), np.float32),
                     mode="instant", devices=[dev])
    server = ModelServer(reg, port=0)
    server.start(warm=True)
    try:
        client = ServingClient(server.url, timeout=120)
        track = movie[:ROLLOUT_SEEN]
        t0 = time.monotonic()
        for _ in range(ROLLOUT_NEW):
            resp = client.predict(f"next_frame_t{len(track)}", track[None])
            new = np.asarray(resp["outputs"], dtype=np.float32)[0, -1]
            track = np.concatenate([track, new[None]])
        seconds = time.monotonic() - t0
    finally:
        drained = server.stop()
    if not drained:
        raise SystemExit(f"chip_smoke: the {tag} rollout server did not "
                         "drain")
    return track[ROLLOUT_SEEN:], seconds


def _rollout_direct(model, variables, movie, dtype):
    """The same rollout through ``model.output`` on the card in ``dtype``
    (the float64 copy's)."""
    track = torch.from_numpy(movie[:ROLLOUT_SEEN]).to(model.device, dtype)
    for _ in range(ROLLOUT_NEW):
        new = model.output(variables, track[None])[0, -1]
        track = torch.cat([track, new[None]])
    return track[ROLLOUT_SEEN:].cpu().numpy()


def _sequential_output(model):
    """The served function of a SequentialModel: its ``output``."""
    return lambda variables, x: model.output(variables, x)


def phase_convlstm_serve(dev, smi, model, variables):
    t0 = time.monotonic()
    requests = [_movie_request(i) for i in range(CONVLSTM_REQUESTS)]
    out = _serve_images(
        "convlstm_serve", dev, smi, "next_frame", _sequential_output(model),
        variables, requests, clients=CONVLSTM_CLIENTS,
        max_batch=CONVLSTM_MAX_BATCH, tol=TOL_SERVED, check=_frames)
    _no_hand_kernels("convlstm_serve", out["kernel_launches"])
    rows_s = out.pop("images_per_s")
    out["json_2_movies"] = out.pop("json_2_images")

    movies, nxt = generate_movies(1, seed=7000)
    got, roll_s = _rollout("convlstm_serve", dev, model, variables,
                           movies[0])
    want = _rollout_direct(model, _float64_copy(variables), movies[0],
                           torch.float64)
    fracs = [float(np.abs(g - w).max() / np.abs(w).max())
             for g, w in zip(got, want)]
    # how near the 30-step model's rollout comes to the movie's own future
    # (reported: the example trains 300 epochs)
    truth = nxt[0, ROLLOUT_SEEN - 1:ROLLOUT_SEEN - 1 + ROLLOUT_NEW]
    hit = [float(((g > 0.5) == (y > 0.5)).mean()) for g, y in
           zip(got, truth)]
    background = [float((y <= 0.5).mean()) for y in truth]
    log(f"[convlstm_serve] rollout: {ROLLOUT_SEEN} frames seen, "
        f"{ROLLOUT_NEW} predicted one at a time through the served model "
        f"in {roll_s:.3f} s; each against the float64 copy's rollout "
        f"{[f'{f:.1e}' for f in fracs]} of its max (tol {TOL_ROLLOUT:.0e}); "
        f"pixels thresholded at 0.5 equal to the movie's own frames "
        f"{[round(h, 3) for h in hit]} (background "
        f"{[round(b, 3) for b in background]}); phase "
        f"{time.monotonic() - t0:.1f} s, on {smi}")
    if max(fracs) > TOL_ROLLOUT or not np.all(np.isfinite(got)):
        raise SystemExit("chip_smoke: convlstm_serve: the served rollout "
                         "disagrees with the float64 copy's")
    return {"model": "keras_conv_lstm_next_frame", **out,
            "movies_per_s": rows_s,
            "frames_per_s": rows_s * CONVLSTM_T,
            "rollout_seen": ROLLOUT_SEEN, "rollout_new": ROLLOUT_NEW,
            "rollout_seconds": roll_s, "rollout_err_frac_vs_float64": fracs,
            "rollout_pixel_agreement_with_the_movie": hit,
            "rollout_movie_background_share": background,
            "phase_seconds": time.monotonic() - t0}


# -- 37.-39. the YOLO family --------------------------------------------------

# The JAX zoo's detectors at their defaults: YOLOv2 (608x608x3, 80 COCO
# classes, 5 priors, 67,445,065 parameters; darknet's yolov2.cfg and the
# DL4J zoo's YOLO2) and Tiny-YOLO (416x416x3, 20 VOC classes, 15,861,773;
# the DL4J zoo's TinyYOLO). Batch 8 (yolov2.cfg's mini-batch: batch 64 /
# subdivisions 8), Adam 1e-3, 3 fixed batches cycled by 10 epochs (30
# steps), float32 (TF32 off) and, for YOLOv2, mixed precision. Synthetic
# detection data from the seed (_box_batch). The float64 check is
# ResNet-50's (23 BatchNorm leaky-ReLU layers) but for the loss, held in
# two parts (_yolo_loss_parts): the loss passes the wh logits through exp,
# so it turns the feature map's absolute float32 rounding (2.9e-5 of its
# max after 23 train-mode BatchNorms, on an H100) into relative error of
# the loss: 1.52e-5 from float64 on the first batch, the float64 copy's
# own 8.0e-7 under 2^-24 noise (the JAX package's own float32 loss lies
# up to 4.7e-5 from float64 at 64-128² on the CPU).
YOLO_BATCH, YOLO_BATCHES, YOLO_EPOCHS = 8, 3, 10
YOLO2_SIZE, YOLO2_CLASSES, YOLO2_PARAMS = 608, 80, 67_445_065
TINY_YOLO_SIZE, TINY_YOLO_CLASSES, TINY_YOLO_PARAMS = 416, 20, 15_861_773
# The mixed-precision (bf16) loss against float32 is held at the float32
# run's trained weights, on every batch: at init YOLOv2's loss is 14,440
# no-object confidences near 0.5 a batch that bf16's rounding of the
# weights and BatchNorm means shifts together (the first batch's bf16
# loss 4.2e-2 from float32, float32 with the weights rounded to bf16
# alone 2.7e-3; after 30 steps 2.6e-4 to 2.5e-3 on an H100). The init
# step's is reported.
# Closed loop: 4 client threads, 12 requests of 1-2 608x608x3 images as
# JSON (1,108,992 numbers an image), batched mode, max batch 8; each
# answer the decoded grid [n, 19, 19, 5, 85].
YOLO_REQUESTS, YOLO_CLIENTS, YOLO_MAX_BATCH = 12, 4, 8
# Served grids against output_single on the request zero-padded to the
# server's bucket it matches, every channel to TOL_SERVED: xy, confidence
# and class probabilities absolutely, wh (anchor × exp(logit), grid units)
# relatively. A forward at another batch size runs other cuDNN algorithms
# (FFT convs at bucket 8): against the request alone, wh read 4.5e-5 to
# 7.7e-5 and the other channels 5.6e-6 to over 1e-5 on an H100; reported.
YOLO_TOP_K = 20
# decode on the card against the same function on the CPU, on the same
# served numbers: boxes and scores to 1e-6 of max(1, |CPU|) (boxes are in
# image units, their widths anchors x exp(logit) / grid)
TOL_DECODE = 1e-6


def _box_batch(n, size, classes, seed):
    """``n`` images N(0, 1) of ``size``² × 3 with 1–3 boxes each: w and h
    uniform in [0.1, 0.4] of the image, centres that keep the box inside
    it, a class each; DISC_SHIFT added inside a box on channel class % 3.
    The labels are ``make_yolo_labels``' on the stride-32 grid; the boxes
    (cx, cy, w, h, class) too, under "objects"."""
    from deeplearning4j_tpu_torch.models.zoo.yolo import make_yolo_labels

    r = np.random.default_rng(seed)
    x = r.normal(size=(n, size, size, 3)).astype(np.float32)
    objects = []
    for i in range(n):
        objs = []
        for _ in range(int(r.integers(1, 4))):
            w, h = r.uniform(0.1, 0.4, 2)
            cx, cy = r.uniform(w / 2, 1 - w / 2), r.uniform(h / 2, 1 - h / 2)
            cls = int(r.integers(0, classes))
            x0, x1 = int(round((cx - w / 2) * size)), int(round(
                (cx + w / 2) * size))
            y0, y1 = int(round((cy - h / 2) * size)), int(round(
                (cy + h / 2) * size))
            x[i, y0:y1, x0:x1, cls % 3] += DISC_SHIFT
            objs.append((float(cx), float(cy), float(w), float(h), cls))
        objects.append(objs)
    labels = make_yolo_labels(objects, grid=(size // 32, size // 32),
                              num_classes=classes)
    return {"features": x, "labels": labels, "objects": objects}


def _yolo_batches(size, classes):
    return [{k: v for k, v in _box_batch(YOLO_BATCH, size, classes,
                                         SEED + i).items()
             if k != "objects"} for i in range(YOLO_BATCHES)]


def _head_input(model, variables, x):
    """The feature map a YOLO model's output layer reads, from a training
    forward (batch statistics), and that layer."""
    if hasattr(model, "order"):   # a GraphModel
        v = model.config.vertices[model.config.outputs[0]]
        values, _ = model.feed_forward(variables, x, train=True)
        return values[v.inputs[0]], v.layer
    x, _ = model.apply(variables, x, train=True,
                       up_to=len(model.layers) - 1)
    return x, model.layers[-1]


def _yolo_loss_parts(tag, model, ts, batch) -> dict:
    """The float32 loss against float64 in two parts: the feature map the
    output layer reads (a training forward) to TOL_ZOO_OUT of its max, and
    the output layer's float32 loss of the float64 copy's feature map
    (rounded to float32) to TOL_LOSS_REL of the float64 loss."""
    v32 = {"params": ts.params, "state": ts.model_state}
    with torch.no_grad():
        f32, layer = _head_input(model, v32, batch["features"])
        f64, _ = _head_input(model, _float64_copy(v32),
                             batch["features"].double())
        labels = batch["labels"]
        loss64 = float(layer.compute_loss({}, {}, f64, labels))
        loss32 = float(layer.compute_loss({}, {}, f64.float(), labels))
    feat_err = float((f32.double() - f64).abs().max() / f64.abs().max())
    layer_rel = abs(loss32 - loss64) / abs(loss64)
    log(f"[{tag}] the loss in parts: the output layer's input "
        f"{tuple(f32.shape)} float32 vs float64 {feat_err:.2e} of its max "
        f"(tol {TOL_ZOO_OUT:.0e}); the layer's float32 loss of the float64 "
        f"map {layer_rel:.2e} relative (tol {TOL_LOSS_REL:.0e})")
    if not (feat_err <= TOL_ZOO_OUT and layer_rel <= TOL_LOSS_REL):
        raise SystemExit(f"chip_smoke: {tag}: the float32 loss disagrees "
                         "with float64")
    return {"feature_err_frac": feat_err, "layer_loss_rel": layer_rel}


def _train_yolo(tag, model, trainer, ts0, on_dev, dev, n_params, smi):
    """The float64 check (ResNet-50's limits, the loss in parts) and 30
    steps of fit, the last loss below the first; no hand kernel on the
    path."""
    layer = type(model.named_layers()[-1][1]).__name__
    log(f"[{tag}] {n_params:,} parameters, {len(model.named_layers())} "
        f"layers to {layer}, Adam(1e-3), batches {YOLO_BATCH}x"
        f"{on_dev[0]['features'].shape[1]}²x3, label cells with an object "
        f"{int(sum(float(b['labels'][..., 0].sum()) for b in on_dev))} of "
        f"{sum(b['labels'][..., 0].numel() for b in on_dev)}")
    f64 = _vs_float64(tag, trainer, ts0, on_dev[0], per_leaf_max=False,
                      gate_loss=False)
    f64["loss_parts"] = _yolo_loss_parts(tag, model, ts0, on_dev[0])
    fit, out = _train_resnet(tag, trainer, ts0, on_dev, dev,
                             batch=YOLO_BATCH, epochs=YOLO_EPOCHS)
    _no_hand_kernels(tag, fit["launches"])
    losses = fit["losses"]
    log(f"[{tag}] loss first step {losses[0]:.4f}, last {losses[-1]:.4f}; "
        f"on {smi}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: {tag}: the last loss is not below "
                         "the first")
    return f64, fit, out


def _mixed_vs_float32(model, mp_trainer, ts, batches) -> list:
    """Each batch's mixed-precision loss (bf16 params and features, as
    the train step casts them) against the float32 loss, relative, at the
    variables of ``ts``."""
    out = []
    with torch.no_grad():
        for b in batches:
            l32 = float(model.loss_fn(ts.params, ts.model_state, b)[0])
            lmix = float(mp_trainer.model.loss_fn(
                _tree_map(lambda a: a.to(torch.bfloat16)
                          if a.dtype == torch.float32 else a, ts.params),
                ts.model_state, mp_trainer._cast_batch(b))[0])
            out.append(abs(lmix - l32) / abs(l32))
    return out


def phase_yolo2_train(dev, smi):
    """Returns the phase's line, the model and its trained variables (for
    phase 39)."""
    from deeplearning4j_tpu_torch.models.zoo.yolo import yolo2
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    t0 = time.monotonic()
    model = yolo2(device=dev, updater=Adam(1e-3), seed=SEED)
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    n_params = model.num_params(trainer.variables(ts0))
    if n_params != YOLO2_PARAMS:
        raise SystemExit(f"chip_smoke: yolo2 has {n_params} parameters")
    on_dev = [batch_to_device(b, dev) for b in
              _yolo_batches(YOLO2_SIZE, YOLO2_CLASSES)]
    f64, fit, fp32 = _train_yolo("yolo2_train", model, trainer, ts0, on_dev,
                                 dev, n_params, smi)
    trained = trainer.variables(fit["ts"])

    # mixed precision: bf16 features, params and activations (the loss
    # sees bf16 features and bf16 anchors), float32 master params, updater
    # state and BatchNorm statistics
    mp_model = yolo2(device=dev, updater=Adam(1e-3), seed=SEED)
    mp_model.net.mixed_precision = True
    mp_trainer = Trainer(mp_model)
    mixed_rel = _mixed_vs_float32(model, mp_trainer, fit["ts"], on_dev)
    del fit
    mts0 = mp_trainer.init_state(trainer.variables(ts0))
    mts1, m = mp_trainer.train_step(mts0, on_dev[0])
    mp_loss = float(m["total_loss"])
    init_rel = abs(mp_loss - f64["loss_float32"]) / abs(f64["loss_float32"])
    state_f32 = all(a.dtype == torch.float32 for a in tree_leaves(
        (mts1.params, mts1.model_state, mts1.opt_state)))
    log(f"[yolo2_mixed] the mixed-precision loss vs float32 at the 30-step "
        f"weights, by batch: {[f'{r:.2e}' for r in mixed_rel]} (tol "
        f"{TOL_MIXED_REL:.0e}); the first mixed step's from init "
        f"{mp_loss:.6f} vs float32 {f64['loss_float32']:.6f} (rel "
        f"{init_rel:.2e}, reported); params, BatchNorm and updater state "
        f"float32: {state_f32}")
    if max(mixed_rel) > TOL_MIXED_REL or not state_f32:
        raise SystemExit("chip_smoke: the mixed-precision YOLOv2 step "
                         "failed")
    del mts1
    mp_fit, mixed = _train_resnet("yolo2_mixed", mp_trainer, mts0, on_dev,
                                  dev, batch=YOLO_BATCH, epochs=YOLO_EPOCHS)
    _no_hand_kernels("yolo2_mixed", mp_fit["launches"])
    if not mp_fit["losses"][-1] < mp_fit["losses"][0]:
        raise SystemExit("chip_smoke: yolo2_mixed: the last loss is not "
                         "below the first")
    mixed["loss_vs_float32_rel_trained"] = mixed_rel
    mixed["first_loss_vs_float32_rel_init"] = init_rel
    del mts0, ts0, mp_trainer, mp_model, mp_fit, on_dev
    return {"model": "yolo2", "batch": YOLO_BATCH, "image": YOLO2_SIZE,
            "classes": YOLO2_CLASSES, "num_params": n_params,
            "vs_float64": f64, "float32": fp32, "mixed_precision": mixed,
            "phase_seconds": time.monotonic() - t0, "card": smi}, \
        model, trained


def phase_tiny_yolo_train(dev, smi):
    from deeplearning4j_tpu_torch.models.zoo.yolo import tiny_yolo
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    t0 = time.monotonic()
    model = tiny_yolo(device=dev, updater=Adam(1e-3), seed=SEED)
    trainer = Trainer(model)
    ts0 = trainer.init_state()
    n_params = model.num_params(trainer.variables(ts0))
    if n_params != TINY_YOLO_PARAMS:
        raise SystemExit(f"chip_smoke: tiny_yolo has {n_params} parameters")
    on_dev = [batch_to_device(b, dev) for b in
              _yolo_batches(TINY_YOLO_SIZE, TINY_YOLO_CLASSES)]
    f64, fit, fp32 = _train_yolo("tiny_yolo_train", model, trainer, ts0,
                                 on_dev, dev, n_params, smi)
    del fit, ts0, on_dev
    return {"model": "tiny_yolo", "batch": YOLO_BATCH,
            "image": TINY_YOLO_SIZE, "classes": TINY_YOLO_CLASSES,
            "num_params": n_params, "vs_float64": f64, "float32": fp32,
            "phase_seconds": time.monotonic() - t0, "card": smi}


def _yolo_request(i):
    return _box_batch(1 + i % 2, YOLO2_SIZE, YOLO2_CLASSES,
                      5000 + i)["features"]


def _yolo_grids(grid, anchors, classes):
    """A served-output check: the decoded grid [rows, grid, grid, anchors,
    5 + classes], xy in [0, 1], wh > 0, confidence in [0, 1], class
    probabilities summing to 1 within 1e-5."""
    def check(out, req):
        return (out.shape == (req.shape[0], grid, grid, anchors,
                              5 + classes)
                and 0 <= out[..., 0:2].min() and out[..., 0:2].max() <= 1
                and out[..., 2:4].min() > 0
                and 0 <= out[..., 4].min() and out[..., 4].max() <= 1
                and np.abs(out[..., 5:].sum(-1) - 1).max() <= 1e-5)
    return check


def _decode_numpy(decoded, top_k):
    """decode_predictions in numpy (float32), the top-K by a stable
    descending sort: (boxes, scores, classes)."""
    n, h, w, b, _ = decoded.shape
    xy, wh = decoded[..., 0:2], decoded[..., 2:4]
    conf, probs = decoded[..., 4], decoded[..., 5:]
    cx = (xy[..., 0] + np.arange(w, dtype=np.float32)[None, None, :, None]) / w
    cy = (xy[..., 1] + np.arange(h, dtype=np.float32)[None, :, None, None]) / h
    bw, bh = wh[..., 0] / w, wh[..., 1] / h
    score = (probs.max(-1) * conf).reshape(n, -1)
    idx = np.argsort(-score, axis=1, kind="stable")[:, :top_k]

    def take(a):
        return np.take_along_axis(a.reshape(n, -1), idx, axis=1)

    boxes = np.stack([take(cx) - take(bw) / 2, take(cy) - take(bh) / 2,
                      take(cx) + take(bw) / 2, take(cy) + take(bh) / 2], -1)
    return boxes, take(score), take(probs.argmax(-1)).astype(np.int32)


def _nms_numpy(boxes, scores, thr=0.45):
    """Greedy NMS box by box in stable descending-score order (a kept
    box suppresses a later one whose IOU with it exceeds ``thr``):
    keep [N, K] in the input order."""
    keep = np.zeros(scores.shape, np.float32)
    for n in range(scores.shape[0]):
        bx, kept = boxes[n], []
        for i in np.argsort(-scores[n], kind="stable"):
            ok = True
            for j in kept:
                iw = min(bx[i, 2], bx[j, 2]) - max(bx[i, 0], bx[j, 0])
                ih = min(bx[i, 3], bx[j, 3]) - max(bx[i, 1], bx[j, 1])
                inter = max(0.0, iw) * max(0.0, ih)
                union = (max(0.0, bx[i, 2] - bx[i, 0])
                         * max(0.0, bx[i, 3] - bx[i, 1])
                         + max(0.0, bx[j, 2] - bx[j, 0])
                         * max(0.0, bx[j, 3] - bx[j, 1]) - inter)
                if inter / max(union, 1e-9) > thr:
                    ok = False
                    break
            if ok:
                keep[n, i] = 1.0
                kept.append(i)
    return keep


def _detections(decoded, dev, top_k=YOLO_TOP_K) -> dict:
    """decode_predictions and non_max_suppression of ``decoded`` (numpy
    [N, H, W, B, 5 + C]) on ``dev`` and on the CPU from the same numbers:
    classes and keep equal, boxes and scores to TOL_DECODE of max(1,
    |CPU|); the CPU's against the numpy decode, whose top-K is a stable
    sort (classes equal, boxes and scores to TOL_DECODE), and keep
    against the numpy greedy sweep, equal."""
    from deeplearning4j_tpu_torch.models.zoo.yolo import (
        decode_predictions,
        non_max_suppression,
    )

    def run(device):
        boxes, scores, classes = decode_predictions(
            torch.from_numpy(decoded).to(device), top_k=top_k)
        keep = non_max_suppression(boxes, scores)
        return [a.cpu().numpy() for a in (boxes, scores, classes, keep)]

    card, cpu = run(dev), run("cpu")

    def frac(a, b):
        return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())

    nboxes, nscores, nclasses = _decode_numpy(decoded, top_k)
    errs = {"card_boxes": frac(card[0], cpu[0]),
            "card_scores": frac(card[1], cpu[1]),
            "numpy_boxes": frac(cpu[0], nboxes),
            "numpy_scores": frac(cpu[1], nscores)}
    equal = {"card_classes": bool(np.array_equal(card[2], cpu[2])),
             "card_keep": bool(np.array_equal(card[3], cpu[3])),
             "numpy_classes": bool(np.array_equal(cpu[2], nclasses)),
             "numpy_keep": bool(np.array_equal(
                 cpu[3], _nms_numpy(cpu[0], cpu[1])))}
    ties = sum(len(row) - len(set(row)) for row in cpu[1].tolist())
    ok = all(equal.values()) and max(errs.values()) <= TOL_DECODE
    return {"ok": ok, "images": int(decoded.shape[0]), "top_k": top_k,
            "err_frac": errs, "equal": equal, "tied_scores": ties,
            "kept_per_image": float(cpu[3].sum(1).mean())}


def _planted_box(dev) -> dict:
    """tests/test_yolo.py's planted box on ``dev``: Tiny-YOLO's priors, 4
    classes, a 2×2 grid of logits at −8 (every other score ties) but cell
    (1, 0), anchor 2, class 3; decode (K = 3) must find its box, class and
    anchor's size, as on the CPU."""
    from deeplearning4j_tpu_torch.models.zoo.yolo import (
        TINY_YOLO_ANCHORS,
        Yolo2OutputLayer,
        decode_predictions,
    )

    c, b = 4, len(TINY_YOLO_ANCHORS)
    feat = np.full((1, 2, 2, b, 5 + c), -8.0, np.float32)
    feat[0, 1, 0, 2, 0:4] = 0.0
    feat[0, 1, 0, 2, 4] = 8.0
    feat[0, 1, 0, 2, 5 + 3] = 8.0
    layer = Yolo2OutputLayer(anchors=TINY_YOLO_ANCHORS, num_classes=c)
    x = torch.from_numpy(feat.reshape(1, 2, 2, b * (5 + c))).to(dev)
    decoded = layer.apply({}, {}, x)[0]
    boxes, scores, classes = (a.cpu().numpy() for a in decode_predictions(
        decoded, top_k=3))
    aw, ah = TINY_YOLO_ANCHORS[2]
    x1, y1, x2, y2 = boxes[0, 0]
    got = [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1]
    want = [0.25, 0.75, aw / 2, ah / 2]
    det = _detections(decoded.cpu().numpy(), dev, top_k=3)
    ok = (scores[0, 0] > 0.9 and classes[0, 0] == 3 and det["ok"]
          and np.allclose(got, want, rtol=1e-5, atol=1e-5))
    return {"ok": bool(ok), "score": float(scores[0, 0]),
            "class": int(classes[0, 0]), "box_cxcywh": [float(v) for v in
                                                        got],
            "want_cxcywh": want, "decode": det}


def _grid_errors(out, want) -> tuple:
    """The largest absolute error of xy, confidence and class
    probabilities, and the largest relative error of wh."""
    err = np.abs(out - want)
    return (float(np.delete(err, (2, 3), -1).max()),
            float((err[..., 2:4] / want[..., 2:4]).max()))


def _served_grid_errors(served, requests, forward, variables,
                        max_batch) -> dict:
    """Each served grid against ``forward`` on its request, zero-padded
    as the batched server pads it to each bucket it can ride in (the
    powers of two from its own bucket up to ``max_batch``): the errors at
    the bucket it matches best, worst over the requests, the buckets
    matched, and the errors against ``forward`` on the request alone
    (another batch size, so other cuDNN algorithms)."""
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference

    bounded = wh = alone_bounded = alone_wh = 0.0
    matched = {}
    for out, req in zip(served, requests):
        n = req.shape[0]
        errs = {}
        bucket = ParallelInference._bucket(n, max_batch)
        while not errs or bucket <= max_batch:
            x = np.concatenate([req, np.zeros((bucket - n, *req.shape[1:]),
                                              req.dtype)])
            want = forward(variables, x)[:n].double().cpu().numpy()
            errs[bucket] = _grid_errors(out, want)
            bucket *= 2
        best = min(errs, key=lambda b: max(errs[b]))
        matched[best] = matched.get(best, 0) + 1
        bounded = max(bounded, errs[best][0])
        wh = max(wh, errs[best][1])
        a_b, a_wh = (errs[n] if n in errs else _grid_errors(
            out, forward(variables, req).double().cpu().numpy()))
        alone_bounded, alone_wh = max(alone_bounded, a_b), max(alone_wh,
                                                                a_wh)
    return {"max_abs_err_bounded": bounded, "max_rel_err_wh": wh,
            "matched_buckets": dict(sorted(matched.items())),
            "alone_max_abs_err_bounded": alone_bounded,
            "alone_max_rel_err_wh": alone_wh}


def phase_yolo2_serve(dev, smi, model, variables):
    t0 = time.monotonic()
    requests = [_yolo_request(i) for i in range(YOLO_REQUESTS)]
    grid = YOLO2_SIZE // 32
    forward = _output_single(model)
    out = _serve_images(
        "yolo2_serve", dev, smi, "yolo2", forward, variables, requests,
        clients=YOLO_CLIENTS, max_batch=YOLO_MAX_BATCH, tol=None,
        check=_yolo_grids(grid, 5, YOLO2_CLASSES))
    _no_hand_kernels("yolo2_serve", out["kernel_launches"])
    outputs = out.pop("outputs")
    errs = _served_grid_errors(outputs, requests, forward, variables,
                               YOLO_MAX_BATCH)
    out.update(errs)
    log(f"[yolo2_serve] served grids vs output_single on the request "
        f"padded to the bucket it matches ({errs['matched_buckets']} "
        f"requests a bucket): xy, confidence and class probabilities "
        f"{errs['max_abs_err_bounded']:.3e}, wh {errs['max_rel_err_wh']:.3e}"
        f" relative (tol {TOL_SERVED:.0e}); against the request alone "
        f"{errs['alone_max_abs_err_bounded']:.3e} and "
        f"{errs['alone_max_rel_err_wh']:.3e} (reported)")
    if not (errs["max_abs_err_bounded"] <= TOL_SERVED
            and errs["max_rel_err_wh"] <= TOL_SERVED):
        raise SystemExit("chip_smoke: yolo2_serve: served grids disagree "
                         "with the forward")
    served = np.concatenate(outputs)
    t1 = time.monotonic()
    det = _detections(served, dev)
    det_s = time.monotonic() - t1
    planted = _planted_box(dev)
    log(f"[yolo2_serve] decode (K={YOLO_TOP_K}) and NMS of the "
        f"{det['images']} served images on the card against the CPU and "
        f"numpy: {det['equal']}, errors {det['err_frac']} (tol "
        f"{TOL_DECODE:.0e}), {det['tied_scores']} tied scores, "
        f"{det['kept_per_image']:.2f} detections kept an image, "
        f"{det_s:.2f} s; planted box: score {planted['score']:.4f}, class "
        f"{planted['class']}, (cx, cy, w, h) {planted['box_cxcywh']} for "
        f"{planted['want_cxcywh']}; phase {time.monotonic() - t0:.1f} s, "
        f"on {smi}")
    if not (det["ok"] and planted["ok"]):
        raise SystemExit("chip_smoke: yolo2_serve: decode or NMS on the card "
                         "disagrees, or the planted box was not found")
    out["json_2_images"]["response_numbers"] = 2 * grid * grid * 5 * (
        5 + YOLO2_CLASSES)
    return {"model": "yolo2", **out, "detections": det,
            "planted_box": planted, "decode_seconds": det_s,
            "phase_seconds": time.monotonic() - t0}


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
    loss_guard = phase_loss_guard()
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
    gpt_prefix = phase_gpt_prefix_serve(dev, smi, gpt_model, gpt_vars)
    warm_restart = phase_warm_restart(dev, smi, gpt_model, gpt_vars)
    del gpt_model, gpt_vars
    xception_training, xception_model, xception_vars = phase_xception_train(
        dev, smi)
    xception_serving = phase_xception_serve(dev, smi, xception_model,
                                            xception_vars)
    del xception_model, xception_vars
    unet_training, unet_model, unet_vars = phase_unet_train(dev, smi)
    unet_serving = phase_unet_serve(dev, smi, unet_model, unet_vars)
    del unet_model, unet_vars
    zoo_cnn = phase_zoo_cnn(dev, smi)
    conv_layers = phase_conv_layers(dev, smi)
    samediff_bert = phase_samediff_bert(dev, smi)
    convlstm_training, convlstm_model, convlstm_vars = phase_convlstm_train(
        dev, smi)
    convlstm_tbptt = phase_convlstm_tbptt(dev, smi)
    convlstm_serving = phase_convlstm_serve(dev, smi, convlstm_model,
                                            convlstm_vars)
    del convlstm_model, convlstm_vars
    log("[convlstm] phase seconds: train "
        f"{convlstm_training['phase_seconds']:.1f}, tbptt "
        f"{convlstm_tbptt['phase_seconds']:.1f}, serve "
        f"{convlstm_serving['phase_seconds']:.1f}")
    yolo2_training, yolo2_model, yolo2_vars = phase_yolo2_train(dev, smi)
    tiny_yolo_training = phase_tiny_yolo_train(dev, smi)
    yolo2_serving = phase_yolo2_serve(dev, smi, yolo2_model, yolo2_vars)
    del yolo2_model, yolo2_vars
    log("[yolo] phase seconds: yolo2_train "
        f"{yolo2_training['phase_seconds']:.1f}, tiny_yolo_train "
        f"{tiny_yolo_training['phase_seconds']:.1f}, yolo2_serve "
        f"{yolo2_serving['phase_seconds']:.1f}")
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
                                 s2s_serving["launches"]["flash_fwd"],
                             "gpt_prefix_serving": gpt_prefix[
                                 "kernel_launches"].get("flash_fwd", 0),
                             "warm_restart_replay":
                                 warm_restart["flash_fwd_launches"]},
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
    print(json.dumps({"gpt_prefix_serving": gpt_prefix}), flush=True)
    print(json.dumps({"warm_restart": warm_restart}), flush=True)
    print(json.dumps({"loss_guard": loss_guard}), flush=True)
    print(json.dumps({"seq2seq_training": s2s_training}), flush=True)
    print(json.dumps({"seq2seq_serving": s2s_serving}), flush=True)
    print(json.dumps({"xception_training": xception_training}), flush=True)
    print(json.dumps({"xception_serving": xception_serving}), flush=True)
    print(json.dumps({"unet_training": unet_training}), flush=True)
    print(json.dumps({"unet_serving": unet_serving}), flush=True)
    print(json.dumps({"zoo_cnn": zoo_cnn}), flush=True)
    print(json.dumps({"conv_layers": conv_layers}), flush=True)
    print(json.dumps({"samediff_bert": samediff_bert}), flush=True)
    print(json.dumps({"convlstm_training": convlstm_training}), flush=True)
    print(json.dumps({"convlstm_tbptt": convlstm_tbptt}), flush=True)
    print(json.dumps({"convlstm_serving": convlstm_serving}), flush=True)
    print(json.dumps({"yolo2_training": yolo2_training}), flush=True)
    print(json.dumps({"tiny_yolo_training": tiny_yolo_training}),
          flush=True)
    print(json.dumps({"yolo2_serving": yolo2_serving}), flush=True)
    log(f"[done] {time.monotonic() - t_start:.1f} s; launch counts now "
        f"{_dispatch.launch_counts()}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
