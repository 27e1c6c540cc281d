"""Generative serving engine: continuous batching over bucketed KV slabs,
streaming decode (↔ deeplearning4j_tpu/serving/generation.py).

- **decode slots**: up to ``num_slots`` sequences share one batched decode
  step. A request joins the batch the step after its prefill and leaves it
  the step it finishes: admission is per iteration, not per batch.
- **KV slabs**: every sequence's K/V lives in a preallocated slab row
  ``[num_slots+1, heads, max_len, head_dim]`` per layer on the model's
  device; row ``num_slots`` is scratch, where padded batch rows write.
  A decode step runs at a (slot-count bucket, kv-length bucket) pair,
  powers of two, and attends over the first ``kv`` positions only.
- **prefill/decode split**: a prompt is padded to its prompt bucket and
  run through ``Gpt.prefill_chunk`` (full causal attention), which writes
  its K/V into the slot's slab row; its first token is sampled from the
  logits at the last real position. Decode masks every column past each
  row's position, so a bucket's padded columns never become live.
- **streaming**: tokens go onto a per-request queue as each step returns;
  ``ModelServer`` writes them to the client as ndjson lines.
- **priorities**: a waiting ``critical`` request evicts the lowest-class
  active slot; the victim fails retryably with ``SLOT_PREEMPTED``.
- **prefix-KV reuse** (``prefix_cache=``, serving/prefixkv.py): after a
  normal prefill the slot's KV columns for the largest prompt bucket
  below the prompt length are published as a shared slab; a later
  request whose prompt starts with the same tokens grafts the slab into
  its slot row (one copy per layer's K and V) and feeds only its suffix,
  token by token, through the warmed single-row decode step at bucket
  (1, kv). Each feed writes KV column j as prefill would; the last
  feed's sample is the first generated token. On an H100 this makes
  shared-prompt traffic slower today, not faster: each suffix token is
  one eager, host-bound decode step, where a miss's whole prompt is one
  prefill. A captured decode step (ROADMAP queue 1 item 1) is what would
  make a graft pay; until then leave ``prefix_cache`` off for speed.
- **warm start** (``attach_manifest``, serving/warmstart.py): every
  prefill bucket and decode pair that runs is noted in the warmup
  manifest; ``manifest_warm_plan`` gives the shapes a restart warms.
- **telemetry**: the ``generation_*`` families of ``ServingMetrics``
  (``metrics=`` or ``attach_metrics``; TTFT, latency, tokens, decode
  steps, slot occupancy, queue depth, slots, KV bytes, preemptions,
  sheds), ``warmup_*`` of ``WarmstartMetrics``, and
  ``generation.join``/``leave``/``preempt``/``shed``/``warmup``/
  ``compile`` flight events.

One scheduler thread owns the slabs and makes every device call;
``submit``/``cancel`` only touch the waiting queue and the slot table under
the engine's lock. The JAX package compiles each bucket's prefill and
decode step (and each graft) into one program; here each runs eagerly
(``warm`` runs every shape once so the first request finds the allocator
primed; a shape first run after ``warm`` counts in ``shapes_after_warm``
and ``warmup_recompiles_after_warm_total{plane="generation"}``, the eager
counterpart of the JAX package's compile after warmup). No path launches
a hand kernel: the JAX package attends with plain einsums there, and the
port with ``torch.matmul``.

Not ported: the overload plane's slot clamp, tenant quotas and the
token-brownout rung (``brownout_max_new_tokens`` raises; ROADMAP queue 1
item 9), the request ledger, tracing and correlation-id exemplars
(item 12).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.generation import sample_token
from deeplearning4j_tpu_torch.observability.flightrecorder import record_event
from deeplearning4j_tpu_torch.observability.metrics import (
    warmstart_metrics_or_none,
)
from deeplearning4j_tpu_torch.serving.errors import (
    BadRequestError,
    NotReadyError,
    QueueFullError,
    SlotPreemptedError,
)
from deeplearning4j_tpu_torch.serving.overload import PRIORITIES
from deeplearning4j_tpu_torch.serving.prefixkv import resolve_prefix_store
from deeplearning4j_tpu_torch.serving.warmup import bucket_sizes
from deeplearning4j_tpu_torch.utils.pytree import tree_map

_PRIO_RANK = {p: i for i, p in enumerate(PRIORITIES)}  # critical first

_WAITING, _ACTIVE, _DONE = "waiting", "active", "done"


def _bucket(sizes: List[int], n: int) -> int:
    for s in sizes:
        if s >= n:
            return s
    return sizes[-1]


class GenerationStream:
    """One generation request: the client-side stream handle and the
    scheduler's per-sequence record. Single consumer: ``tokens()`` /
    ``result()`` / ``wire_events()`` drain the same queue."""

    def __init__(self, engine: "GenerationEngine", req_id: int,
                 prompt: np.ndarray, max_new_tokens: int,
                 temperature: float, eos_id: Optional[int],
                 priority: str, t_submit: float):
        self._engine = engine
        self.id = req_id
        self.prompt = prompt
        self.prompt_len = int(prompt.shape[0])
        self.max_new_tokens = max_new_tokens
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.priority = priority
        self.t_submit = t_submit
        self.t_first: Optional[float] = None
        self.prefix_len = 0     # the grafted prefix's length on a hit
        # scheduler state (engine lock)
        self.state = _WAITING
        self.slot: Optional[int] = None
        self.pos = 0            # next KV write position
        self.last_tok = 0       # sampled but not yet fed back
        self.generated = 0
        self.finish_reason: Optional[str] = None
        self.error: Optional[Exception] = None
        self._wire_timeout: Optional[float] = None  # set by the server
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()

    # -- consumer side -------------------------------------------------------

    def tokens(self, timeout: Optional[float] = None):
        """Yield token ids as they are produced; raises the typed
        ``ServingError`` on preemption or failure, returns on completion.
        ``timeout`` bounds the wait per token (``queue.Empty``)."""
        while True:
            kind, val = self._q.get(timeout=timeout)
            if kind == "token":
                yield val
            elif kind == "error":
                raise val
            else:
                return

    def result(self, timeout: Optional[float] = None) -> dict:
        """Collect the whole stream: ``{"tokens", "finish_reason"}``.
        ``timeout`` is the total budget of the stream, not a per-token
        gap; ``queue.Empty`` on expiry."""
        deadline = None if timeout is None else time.monotonic() + timeout
        toks = []
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise queue.Empty()
            kind, val = self._q.get(timeout=remaining)
            if kind == "token":
                toks.append(val)
            elif kind == "error":
                raise val
            else:
                return {"tokens": toks, "finish_reason": self.finish_reason}

    @staticmethod
    def _wire_error(e: Exception) -> dict:
        if hasattr(e, "to_json"):
            return e.to_json()
        return {"error": {"code": "INTERNAL", "message": str(e)[:300],
                          "retryable": False}}

    def wire_events(self, timeout: Optional[float] = None):
        """The HTTP streaming protocol: one dict per ndjson line —
        ``{"token": id}`` per token, then ``{"done": ...}`` or a terminal
        ``{"error": {...}}``. ``timeout`` (default: the server-set
        ``_wire_timeout``, the request's deadline) is the total budget of
        the stream: on expiry the request is cancelled and the stream ends
        with ``DEADLINE_EXCEEDED``."""
        if timeout is None:
            timeout = self._wire_timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        n = 0
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
            try:
                if remaining is not None and remaining <= 0:
                    raise queue.Empty()
                kind, val = self._q.get(timeout=remaining)
            except queue.Empty:
                self._expire()
                yield {"error": {
                    "code": "DEADLINE_EXCEEDED",
                    "message": "generation did not finish before the "
                               "deadline",
                    "retryable": False}}
                return
            if kind == "token":
                n += 1
                yield {"token": val}
            elif kind == "error":
                yield self._wire_error(val)
                return
            else:
                yield {"done": True, "n_tokens": n,
                       "finish_reason": self.finish_reason}
                return

    def cancel(self):
        """Abort this request (the client went away): frees its slot or
        drops its queue entry. Idempotent; a finished stream is left."""
        self._engine._cancel(self)

    def _expire(self):
        self._engine._cancel(self, outcome="deadline")

    # -- scheduler side ------------------------------------------------------

    def _push_token(self, tok: int):
        self._q.put(("token", tok))

    def _push_done(self):
        self._q.put(("done", None))

    def _push_error(self, err: Exception):
        self._q.put(("error", err))


class GenerationEngine:
    """The continuous-batching decode scheduler for one ``Gpt`` model.

    Deploy: build, :meth:`warm` (runs every prompt bucket and every
    (slot bucket, kv bucket) decode step once, and the graft of every
    prompt bucket with a prefix store), :meth:`start` (the scheduler
    thread), then :meth:`submit` from any thread.
    ``ModelServer(generators={name: engine})`` does all of this.
    ``variables`` are the model's (``{"params": tree}``, tensors or numpy
    arrays); the engine keeps its own copy on the model's device.
    ``prefix_cache``: False, None (the ``DL4J_TPU_PREFIX_CACHE`` env), True
    or a ``PrefixKVStore``; ``metrics``: a ``ServingMetrics`` bundle.
    """

    def __init__(self, model, variables, *, name: str = "model",
                 version: str = "v1", num_slots: int = 4,
                 max_len: Optional[int] = None, max_new_tokens: int = 64,
                 max_waiting: int = 64, min_kv_bucket: int = 8,
                 min_prompt_bucket: int = 8, idle_wait_s: float = 0.05,
                 temperature: float = 1.0, seed: int = 0,
                 brownout_max_new_tokens: Optional[int] = None,
                 prefix_cache=None, metrics=None):
        if brownout_max_new_tokens is not None:
            raise NotImplementedError(
                "GenerationEngine(brownout_max_new_tokens=...) is not ported "
                "yet (the overload plane, ROADMAP queue 1 item 9)")
        cfg = model.config
        self._model = model
        self.device = model.device
        self._params = tree_map(
            lambda a: torch.as_tensor(a).to(self.device), variables["params"])
        self.name = name
        self.version = version
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = int(num_slots)
        L = max_len if max_len is not None else min(cfg.max_position, 1024)
        if not 2 <= L <= cfg.max_position:
            raise ValueError(
                f"max_len must be in [2, max_position={cfg.max_position}], "
                f"got {L}")
        self.max_len = int(L)
        self.max_prompt = self.max_len - 1  # at least one generated token
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.default_max_new_tokens = int(max_new_tokens)
        self.max_waiting = int(max_waiting)
        self.default_temperature = float(temperature)
        self.idle_wait_s = float(idle_wait_s)
        # closed bucket sets: a step only ever runs at a warmed shape
        self.slot_buckets = bucket_sizes(self.num_slots)
        self.kv_buckets = bucket_sizes(
            self.max_len, lo=min(min_kv_bucket, self.max_len))
        self.prompt_buckets = bucket_sizes(
            self.max_prompt, lo=min(min_prompt_bucket, self.max_prompt))
        # one slab row per slot + a scratch row for padded batch rows
        self._scratch = self.num_slots
        self._alloc_slabs()
        self.kv_bytes = int(sum(a.numel() * a.element_size()
                                for a in self._kslabs) * 2)
        self._gen = torch.Generator(self.device).manual_seed(int(seed))
        # None defers to DL4J_TPU_PREFIX_CACHE; default off
        self.prefix_cache = resolve_prefix_store(prefix_cache, model=name)
        self.warmed = False
        # shapes (prefill buckets, decode pairs) run so far; one run for
        # the first time after warm() is the eager counterpart of the JAX
        # package's recompile after warmup
        self._shapes: set = set()
        self.shapes_after_warm = 0
        # scheduler state
        self._cv = threading.Condition()
        self._waiting: List[GenerationStream] = []
        self._slots: List[Optional[GenerationStream]] = \
            [None] * self.num_slots
        self._seq = itertools.count(1)
        self.steps = 0              # decode iterations run
        self.active_rows_total = 0  # sum over steps of the live rows
        self.bucket_rows_total = 0  # sum over steps of the slot bucket
        self._stream_ewma_s: Optional[float] = None
        self._stopflag = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[str] = None
        self._metrics = None
        self._manifest = None
        if metrics is not None:
            self.attach_metrics(metrics)

    def _alloc_slabs(self):
        """(Re)build the zeroed KV slab pool: construction and the
        post-failure recovery path share the layout."""
        cfg = self._model.config
        hd = cfg.hidden // cfg.num_heads
        dtype = self._params["embeddings"]["word"].dtype
        shape = (self.num_slots + 1, cfg.num_heads, self.max_len, hd)
        self._kslabs = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(cfg.num_layers)]
        self._vslabs = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(cfg.num_layers)]

    # -- wiring --------------------------------------------------------------

    def attach_metrics(self, metrics):
        """Wire the ``ServingMetrics`` bundle (``generation_*`` families)."""
        self._metrics = metrics
        if metrics is not None:
            metrics.generation_kv_bytes.set(self.kv_bytes, model=self.name)
            metrics.generation_max_new_tokens.set(
                self.default_max_new_tokens, model=self.name)
            metrics.generation_slot_limit.set(self.num_slots,
                                              model=self.name)

    def attach_manifest(self, manifest):
        """Wire a warmup manifest (serving/warmstart.py): every prefill
        bucket and (slot, kv) decode pair that runs feeds the live
        traffic mix a restarted server warms against."""
        self._manifest = manifest

    def _note_traffic(self, kind: str, *args):
        wm = self._manifest
        if wm is None:
            return
        try:
            if kind == "prefill":
                wm.note_prefill(self.name, args[0])
            else:
                wm.note_decode(self.name, args[0], args[1])
        except Exception:  # noqa: BLE001 — recording traffic never
            pass           # fails the scheduler

    def _note_shape(self, key: tuple):
        if key in self._shapes:
            return
        self._shapes.add(key)
        if self.warmed:
            # the bucket sets are closed and warmed in full unless a
            # manifest restricted the warm: this is the stall warm-up
            # exists to prevent
            self.shapes_after_warm += 1
            record_event("generation.compile", model=self.name,
                         kind=key[0], key="x".join(map(str, key[1:])),
                         after_warm=True)
            wm = warmstart_metrics_or_none()
            if wm is not None:
                wm.recompiles_after_warm_total.inc(plane="generation")

    # -- device steps (scheduler thread, or warm() before start) -------------

    def _on_device(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    @torch.inference_mode()
    def run_prefill(self, slot: int, prompt: np.ndarray, t0: int,
                    temperature: float) -> int:
        """Prefill the padded ``prompt`` [p] (its first ``t0`` ids real)
        into slab row ``slot`` and sample the first token from the logits
        at position ``t0 - 1``."""
        p = int(prompt.shape[0])
        self._note_shape(("prefill", p))
        logits, kvs = self._model.prefill_chunk(
            self._params, self._on_device(prompt[None], torch.long))
        for i, kv in enumerate(kvs):
            self._kslabs[i][slot, :, :p] = kv["k"][0]
            self._vslabs[i][slot, :, :p] = kv["v"][0]
        temp = self._on_device([temperature], torch.float32)
        return int(sample_token(logits[0, t0 - 1][None], self._gen,
                                temp)[0])

    @torch.inference_mode()
    def run_graft(self, slot: int, kvs) -> None:
        """Copy a prefix slab (per layer ``(k, v)`` [heads, P, head_dim])
        into the first P columns of slab row ``slot``: one copy per
        layer's K and V."""
        p = int(kvs[0][0].shape[1])
        self._note_shape(("graft", p))
        for ks, vs, (k, v) in zip(self._kslabs, self._vslabs, kvs):
            ks[slot, :, :p].copy_(k)
            vs[slot, :, :p].copy_(v)

    @torch.inference_mode()
    def run_decode(self, kv: int, slot_idx, ids, pos, temps) -> torch.Tensor:
        """One decode step over the slab rows ``slot_idx`` [b] (padded rows
        name the scratch row) attending over the first ``kv`` columns:
        feeds ``ids`` at positions ``pos``, writes back only the new K/V
        column of each row and returns the sampled tokens [b] (on the
        device)."""
        b = len(slot_idx)
        self._note_shape(("decode", b, kv))
        slot_idx = self._on_device(slot_idx, torch.long)
        pos = self._on_device(pos, torch.long)
        caches = [{"k": ks[slot_idx, :, :kv], "v": vs[slot_idx, :, :kv]}
                  for ks, vs in zip(self._kslabs, self._vslabs)]
        logits, new = self._model.decode_step_slots(
            self._params, caches, self._on_device(ids, torch.long), pos)
        rows = torch.arange(b, device=self.device)
        for ks, vs, c in zip(self._kslabs, self._vslabs, new):
            ks[slot_idx, :, pos] = c["k"][rows, :, pos]
            vs[slot_idx, :, pos] = c["v"][rows, :, pos]
        return sample_token(logits, self._gen,
                            self._on_device(temps, torch.float32))

    # -- warmup --------------------------------------------------------------

    def manifest_warm_plan(self, manifest=None) -> Tuple[
            List[int], List[Tuple[int, int]]]:
        """The (prompt buckets, decode pairs) a warm pass should run: the
        manifest's observed shapes when it has data for this engine, the
        full bucket vocabulary otherwise. Observed shapes outside the
        vocabulary are dropped, and an empty intersection falls back to
        the full set: a stale manifest never yields a warm of no shapes
        that declares a cold engine ready."""
        p_list = list(self.prompt_buckets)
        pairs = [(b, kv) for b in self.slot_buckets
                 for kv in self.kv_buckets]
        if manifest is None:
            manifest = self._manifest
        if manifest is not None:
            obs_p = manifest.prefill_buckets(self.name)
            if obs_p:
                keep = [p for p in p_list if p in set(obs_p)]
                if keep:
                    p_list = keep
            obs_d = manifest.decode_pairs(self.name)
            if obs_d:
                keep = [pr for pr in pairs if pr in set(obs_d)]
                if keep:
                    pairs = keep
        return p_list, pairs

    def warm(self, *, prompt_buckets: Optional[List[int]] = None,
             decode_pairs: Optional[List[Tuple[int, int]]] = None,
             progress=None, source: str = "full") -> dict:
        """Run prompt buckets and (slot bucket, kv bucket) decode steps
        once against the scratch row, before any traffic, and set
        ``warmed``. Defaults to the full bucket vocabulary; pass
        ``prompt_buckets`` / ``decode_pairs`` (e.g. from
        :meth:`manifest_warm_plan`) to warm exactly the live traffic mix.
        With a prefix store, the graft of every warmed prompt bucket runs
        too. ``progress`` is an optional ``(key, seconds)`` callback a
        shape (the ``/readyz`` progress body); ``source`` labels
        ``warmup_shapes_total`` (manifest | full). Returns {kind: {bucket:
        seconds}}."""
        if self.running:
            raise RuntimeError(
                "warm() must run before start() (or after stop())")
        if prompt_buckets is None:
            prompt_buckets = list(self.prompt_buckets)
        if decode_pairs is None:
            decode_pairs = [(b, kv) for b in self.slot_buckets
                            for kv in self.kv_buckets]
        wm = warmstart_metrics_or_none()
        stats: Dict[str, Dict[str, float]] = {"prefill": {}, "decode": {}}

        def note(kind, key, t0):
            seconds = round(time.monotonic() - t0, 4)
            stats[kind][key] = seconds
            if wm is not None:
                wm.warmup_shapes_total.inc(plane="generation",
                                           source=source)
                wm.warmup_seconds.observe(seconds, plane="generation")
            if progress is not None:
                progress(key if kind != "graft" else f"graft:{key}",
                         seconds)

        t_all = time.monotonic()
        for p in prompt_buckets:
            t0 = time.monotonic()
            self.run_prefill(self._scratch, np.zeros(p, np.int64), p, 0.0)
            note("prefill", str(p), t0)
        for b, kv in decode_pairs:
            t0 = time.monotonic()
            self.run_decode(kv, [self._scratch] * b, [0] * b, [0] * b,
                            [0.0] * b).cpu()
            note("decode", f"{b}x{kv}", t0)
        if self.prefix_cache is not None:
            # the first prefix hit after readiness must not be a shape
            # first run after warm
            stats["graft"] = {}
            ks = self._kslabs[0]
            for p in prompt_buckets:
                t0 = time.monotonic()
                zero = torch.zeros((ks.shape[1], p, ks.shape[3]),
                                   dtype=ks.dtype, device=self.device)
                self.run_graft(self._scratch, [(zero, zero)]
                               * len(self._kslabs))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                note("graft", str(p), t0)
        self.warmed = True
        record_event("generation.warmup", model=self.name,
                     programs=len(self._shapes),
                     seconds=round(time.monotonic() - t_all, 3))
        return stats

    # -- submit path (any thread) --------------------------------------------

    def _retry_hint_ms(self, waiting: int) -> float:
        ewma = self._stream_ewma_s
        if ewma is None:
            return 100.0
        return round(min(30000.0, max(
            1.0, ewma * 1000.0 * (waiting + 1) / max(1, self.num_slots))), 1)

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               eos_id: Optional[int] = None,
               priority: str = "normal") -> GenerationStream:
        """Queue one generation request; returns its stream handle. A full
        waiting queue sheds with ``QueueFullError``; a draining engine
        raises ``NotReadyError``; a bad argument ``BadRequestError``."""
        if priority not in _PRIO_RANK:
            raise BadRequestError(
                f"priority must be one of {list(PRIORITIES)}, "
                f"got {priority!r}")
        try:
            raw = np.asarray(prompt).reshape(-1)
            if raw.dtype.kind == "f":
                # JSON floats arrive here: 463.7 is a 400, not token 463
                if not np.all(np.isfinite(raw)) \
                        or np.any(raw != np.trunc(raw)):
                    raise BadRequestError(
                        "prompt token ids must be whole numbers")
            elif raw.dtype.kind not in "iu":
                raise BadRequestError(
                    f"prompt token ids must be integers, got dtype "
                    f"{raw.dtype}")
            ids = raw.astype(np.int64)
        except BadRequestError:
            raise
        except (TypeError, ValueError) as e:
            raise BadRequestError(f"prompt must be a flat list of token "
                                  f"ids: {e}") from None
        if ids.size < 1:
            raise BadRequestError("prompt must hold at least one token")
        if ids.size > self.max_prompt:
            raise BadRequestError(
                f"prompt of {ids.size} tokens exceeds this engine's "
                f"max prompt length {self.max_prompt}")
        vocab = self._model.config.vocab_size
        if ids.min() < 0 or ids.max() >= vocab:
            raise BadRequestError(
                f"prompt token ids must be in [0, {vocab})")
        if max_new_tokens is None:
            max_new_tokens = self.default_max_new_tokens
        if max_new_tokens < 1:
            raise BadRequestError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature is None:
            temperature = self.default_temperature
        if temperature < 0:
            raise BadRequestError(
                f"temperature must be >= 0, got {temperature}")
        if eos_id is not None and not 0 <= int(eos_id) < vocab:
            raise BadRequestError(f"eos_id must be in [0, {vocab})")
        with self._cv:
            if self._stopflag or self._draining:
                raise NotReadyError("generation engine is draining")
            waiting = len(self._waiting)
            if waiting >= self.max_waiting:
                self._shed("queue_full", priority)
                raise QueueFullError(
                    f"generation queue full ({waiting} waiting)",
                    retry_after_ms=self._retry_hint_ms(waiting))
            req = GenerationStream(
                self, next(self._seq), ids, int(max_new_tokens),
                float(temperature), None if eos_id is None else int(eos_id),
                priority, time.monotonic())
            # priority-ordered insert, FIFO within a class
            rank = _PRIO_RANK[priority]
            at = len(self._waiting)
            for i, other in enumerate(self._waiting):
                if _PRIO_RANK[other.priority] > rank:
                    at = i
                    break
            self._waiting.insert(at, req)
            self._report_queue_locked()
            self._cv.notify_all()
        return req

    def _shed(self, reason: str, priority: str):
        m = self._metrics
        if m is not None:
            m.generation_requests_total.inc(model=self.name, outcome="shed")
        record_event("generation.shed", model=self.name, reason=reason,
                     priority=priority)

    def _cancel(self, req: GenerationStream, outcome: str = "cancelled"):
        with self._cv:
            if req.state == _DONE:
                return
            if req.state == _WAITING and req in self._waiting:
                self._waiting.remove(req)
            elif req.state == _ACTIVE and req.slot is not None:
                self._slots[req.slot] = None
            req.state = _DONE
            req.finish_reason = outcome
            m = self._metrics
            if m is not None:
                m.generation_requests_total.inc(model=self.name,
                                                outcome=outcome)
            self._report_queue_locked()
        record_event("generation.leave", model=self.name, req=req.id,
                     slot=req.slot, step=self.steps, reason=outcome,
                     tokens=req.generated)
        self._close_request(req, outcome)

    def _close_request(self, req: GenerationStream, outcome: str):
        """The end-to-end latency of a stream the server finished (client
        cancels excluded), once a stream: every caller flips ``state`` to
        done under the lock first."""
        m = self._metrics
        if m is not None and outcome != "cancelled":
            m.generation_latency.observe(
                max(0.0, time.monotonic() - req.t_submit), model=self.name)

    def _report_queue_locked(self):
        m = self._metrics
        if m is not None:
            m.generation_queue_depth.set(len(self._waiting), model=self.name)
            m.generation_active_slots.set(
                sum(1 for s in self._slots if s is not None),
                model=self.name)
            m.generation_slot_limit.set(self.num_slots, model=self.name)

    # -- scheduler (single thread) -------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "GenerationEngine":
        if self.running:
            return self
        self._stopflag = False
        self._draining = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"generation-{self.name}")
        self._thread.start()
        return self

    def _loop(self):
        while True:
            with self._cv:
                while (not self._stopflag and not self._waiting
                       and all(s is None for s in self._slots)):
                    self._cv.wait(self.idle_wait_s)
                if self._stopflag:
                    break
            try:
                self._admit()
                self._decode_once()
            except Exception as e:  # noqa: BLE001 — the scheduler must
                # survive a bad step: fail the in-flight work truthfully
                # and keep serving
                self.last_error = f"{type(e).__name__}: {e}"[:300]
                record_event("generation.error", model=self.name,
                             error=str(e)[:200])
                self._fail_active(e)

    def _admit(self):
        while True:
            req = None
            victim = None
            with self._cv:
                if not self._waiting:
                    return
                head = self._waiting[0]
                free = [i for i, s in enumerate(self._slots) if s is None]
                if free:
                    self._waiting.pop(0)
                    head.slot = free[0]
                    head.state = _ACTIVE
                    self._slots[head.slot] = head
                    self._report_queue_locked()
                    req = head
                elif head.priority == "critical":
                    victim = self._preempt_locked()
                    if victim is None:
                        return
                else:
                    return
            if victim is not None:
                record_event("generation.preempt", model=self.name,
                             victim=victim.id, slot=victim.slot,
                             step=self.steps,
                             victim_priority=victim.priority,
                             tokens=victim.generated)
                self._close_request(victim, "preempted")
                victim._push_error(victim.error)
                continue  # a slot was freed; admit again
            self._prefill(req)

    def _preempt_locked(self) -> Optional[GenerationStream]:
        """Evict the lowest-class active slot for a waiting critical
        request: the worst class, the newest join within it. Never
        evicts critical. Caller holds the lock; returns the victim (state
        done, error set) or None."""
        victim = None
        for s in self._slots:
            if s is None or s.priority == "critical":
                continue
            if victim is None \
                    or _PRIO_RANK[s.priority] > _PRIO_RANK[victim.priority] \
                    or (_PRIO_RANK[s.priority] == _PRIO_RANK[victim.priority]
                        and s.id > victim.id):
                victim = s
        if victim is None:
            return None
        self._slots[victim.slot] = None
        victim.state = _DONE
        victim.finish_reason = "preempted"
        victim.error = SlotPreemptedError(
            f"decode slot preempted by a critical request after "
            f"{victim.generated} tokens",
            retry_after_ms=self._retry_hint_ms(len(self._waiting)))
        m = self._metrics
        if m is not None:
            m.generation_preemptions_total.inc(model=self.name,
                                               priority=victim.priority)
            m.generation_requests_total.inc(model=self.name,
                                            outcome="preempted")
        self._report_queue_locked()
        return victim

    def _prefill(self, req: GenerationStream):
        t0v = req.prompt_len
        pc = self.prefix_cache
        if pc is not None:
            entry = pc.acquire(self.version, req.prompt,
                               self.prompt_buckets)
            if entry is not None:
                try:
                    self._prefill_from_prefix(req, entry)
                finally:
                    pc.release(entry)
                return
        p = _bucket(self.prompt_buckets, t0v)
        self._note_traffic("prefill", p)
        prompt = np.zeros(p, np.int64)
        prompt[:t0v] = req.prompt
        tok = self.run_prefill(req.slot, prompt, t0v, req.temperature)
        if pc is not None:
            self._publish_prefix(req, t0v)
        self._first_token(req, tok)

    def _prefill_from_prefix(self, req: GenerationStream, entry):
        """Prefix-hit prefill: graft the shared slab into the slot's first
        P KV columns, then feed the suffix tokens one by one through the
        warmed single-row decode step: the feed of ``prompt[j]`` at
        position ``j`` writes KV column ``j`` as prefill would (the column
        depends only on the input token and its position); the last
        feed's sample is the first generated token."""
        t0v = req.prompt_len
        P = entry.length
        self.run_graft(req.slot, entry.kvs)
        b = _bucket(self.slot_buckets, 1)
        toks = None
        for j in range(P, t0v):
            kv = _bucket(self.kv_buckets, min(j + 1, self.max_len))
            self._note_traffic("decode", b, kv)
            slot_idx = [self._scratch] * b
            ids, pos, temps = [0] * b, [0] * b, [0.0] * b
            slot_idx[0], ids[0] = req.slot, int(req.prompt[j])
            pos[0], temps[0] = j, req.temperature
            toks = self.run_decode(kv, slot_idx, ids, pos, temps)
        req.prefix_len = P
        self._first_token(req, int(toks[0]))

    def _first_token(self, req: GenerationStream, tok: int):
        with self._cv:
            # a client that went away while the prefill ran gets nothing
            if req.state != _ACTIVE:
                return
            req.pos = req.prompt_len
            req.last_tok = tok
            req.generated = 1
            req.t_first = time.monotonic()
        m = self._metrics
        if m is not None:
            m.generation_ttft.observe(req.t_first - req.t_submit,
                                      model=self.name)
            m.generation_tokens_total.inc(model=self.name)
        record_event("generation.join", model=self.name, req=req.id,
                     slot=req.slot, step=self.steps,
                     prompt_len=req.prompt_len, prefix_len=req.prefix_len,
                     priority=req.priority)
        req._push_token(tok)
        self._maybe_finish(req, tok)

    def _publish_prefix(self, req: GenerationStream, t0v: int):
        """After a normal prefill: clone the slot's KV columns for the
        largest prompt bucket strictly below the prompt length (a hit
        needs at least one suffix token to feed) and publish them as a
        shared slab; the slot row keeps decoding over its own copy."""
        pc = self.prefix_cache
        cands = [p for p in self.prompt_buckets
                 if p < t0v and p >= pc.min_tokens]
        if not cands:
            return
        P = max(cands)
        prefix = np.asarray(req.prompt[:P], dtype=np.int64)
        if pc.has(self.version, prefix):
            return
        kvs = [(ks[req.slot, :, :P].clone(), vs[req.slot, :, :P].clone())
               for ks, vs in zip(self._kslabs, self._vslabs)]
        pc.insert(self.version, prefix, kvs)

    def _decode_once(self):
        with self._cv:
            active = [s for s in self._slots if s is not None]
        if not active:
            return
        b = _bucket(self.slot_buckets, len(active))
        kv = _bucket(self.kv_buckets,
                     min(max(r.pos for r in active) + 1, self.max_len))
        slot_idx = [self._scratch] * b
        ids, pos, temps = [0] * b, [0] * b, [0.0] * b
        for i, r in enumerate(active):
            slot_idx[i], ids[i] = r.slot, r.last_tok
            pos[i], temps[i] = r.pos, r.temperature
        self._note_traffic("decode", b, kv)
        toks = self.run_decode(kv, slot_idx, ids, pos, temps).tolist()
        self.steps += 1
        self.active_rows_total += len(active)
        self.bucket_rows_total += b
        m = self._metrics
        if m is not None:
            m.generation_decode_steps_total.inc(model=self.name)
            m.generation_slot_occupancy.observe(len(active) / b,
                                               model=self.name)
        pushed = 0
        for r, tok in zip(active, toks):
            with self._cv:
                if r.state != _ACTIVE:  # cancelled or preempted mid-step
                    continue
                r.pos += 1
                r.generated += 1
                r.last_tok = tok
            r._push_token(tok)
            pushed += 1
            self._maybe_finish(r, tok)
        # only tokens actually streamed, never a cancel-race phantom
        if m is not None and pushed:
            m.generation_tokens_total.inc(pushed, model=self.name)

    def _maybe_finish(self, req: GenerationStream, tok: int):
        reason = None
        if req.eos_id is not None and tok == req.eos_id:
            reason = "eos"
        elif req.generated >= min(req.max_new_tokens,
                                  self.default_max_new_tokens):
            reason = "length"
        elif req.pos >= self.max_len:
            reason = "length"  # KV slab exhausted
        if reason is None:
            return
        with self._cv:
            if req.state != _ACTIVE:
                return
            req.state = _DONE
            req.finish_reason = reason
            self._slots[req.slot] = None
            dur = time.monotonic() - req.t_submit
            if self._stream_ewma_s is None:
                self._stream_ewma_s = dur
            else:
                self._stream_ewma_s += 0.3 * (dur - self._stream_ewma_s)
            m = self._metrics
            if m is not None:
                m.generation_requests_total.inc(model=self.name,
                                                outcome="completed")
            self._report_queue_locked()
        record_event("generation.leave", model=self.name, req=req.id,
                     slot=req.slot, step=self.steps, reason=reason,
                     tokens=req.generated)
        self._close_request(req, "completed")
        req._push_done()

    def _fail_active(self, exc: Exception):
        """A device step failed: rebuild the slabs and fail every active
        request."""
        self._alloc_slabs()
        failed = []
        with self._cv:
            for i, r in enumerate(self._slots):
                if r is not None:
                    self._slots[i] = None
                    r.state = _DONE
                    r.finish_reason = "failed"
                    r.error = exc
                    failed.append(r)
            m = self._metrics
            if m is not None:
                for _ in failed:
                    m.generation_requests_total.inc(model=self.name,
                                                    outcome="failed")
            self._report_queue_locked()
        for r in failed:
            self._close_request(r, "failed")
            r._push_error(RuntimeError(f"generation step failed: {exc}"))

    # -- lifecycle / rendering ------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting, let in-flight streams finish; True if empty in
        time."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._draining = True
        while time.monotonic() < deadline:
            with self._cv:
                if not self._waiting \
                        and all(s is None for s in self._slots):
                    return True
            time.sleep(0.01)
        return False

    def stop(self):
        """Stop the scheduler; waiting and active requests fail with a
        retryable ``NotReadyError`` (``drain()`` first for an honest
        drain, as ``ModelServer.stop`` does)."""
        with self._cv:
            self._stopflag = True
            self._draining = True
            victims = list(self._waiting) + \
                [s for s in self._slots if s is not None]
            self._waiting.clear()
            self._slots = [None] * self.num_slots
            for r in victims:
                r.state = _DONE
                r.finish_reason = "failed"
            m = self._metrics
            if m is not None:
                for _ in victims:
                    m.generation_requests_total.inc(model=self.name,
                                                    outcome="failed")
            self._report_queue_locked()
            self._cv.notify_all()
        for r in victims:
            self._close_request(r, "failed")
            r._push_error(NotReadyError("generation engine stopped"))
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def describe(self) -> dict:
        with self._cv:
            return {
                "name": self.name,
                "version": self.version,
                "warmed": self.warmed,
                "num_slots": self.num_slots,
                "active": sum(1 for s in self._slots if s is not None),
                "waiting": len(self._waiting),
                "max_len": self.max_len,
                "max_prompt": self.max_prompt,
                "max_new_tokens": self.default_max_new_tokens,
                "slot_buckets": list(self.slot_buckets),
                "kv_buckets": list(self.kv_buckets),
                "prompt_buckets": list(self.prompt_buckets),
                "kv_bytes": self.kv_bytes,
                "decode_steps": self.steps,
                "active_rows_total": self.active_rows_total,
                "bucket_rows_total": self.bucket_rows_total,
                "shapes_run": len(self._shapes),
                "shapes_after_warm": self.shapes_after_warm,
                "stream_ewma_s": self._stream_ewma_s,
                "last_error": self.last_error,
                "prefix_cache": (self.prefix_cache.describe()
                                 if self.prefix_cache is not None
                                 else None),
            }


__all__ = ["GenerationEngine", "GenerationStream"]
