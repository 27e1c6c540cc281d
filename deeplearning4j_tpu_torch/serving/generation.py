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

One scheduler thread owns the slabs and makes every device call;
``submit``/``cancel`` only touch the waiting queue and the slot table under
the engine's lock. The JAX package compiles each bucket's prefill and
decode step into one program; here each runs eagerly (``warm`` runs every
shape once so the first request finds the allocator primed). Neither
path launches a hand kernel: the JAX package attends with plain einsums
there, and the port with ``torch.matmul``.

Not ported (each constructor argument raises when it is not None):
``prefix_cache`` and the graft path (ROADMAP queue 1 item 6), the
serving metrics bundle (item 9), the overload plane's slot clamp, tenant
quotas and the token-brownout rung (item 9), and the warmup manifest,
request ledger, tracing and flight-recorder hooks (items 6 and 12).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.generation import sample_token
from deeplearning4j_tpu_torch.serving.errors import (
    BadRequestError,
    NotReadyError,
    QueueFullError,
    SlotPreemptedError,
)
from deeplearning4j_tpu_torch.serving.overload import PRIORITIES
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
    (slot bucket, kv bucket) decode step once), :meth:`start` (the
    scheduler thread), then :meth:`submit` from any thread.
    ``ModelServer(generators={name: engine})`` does all of this.
    ``variables`` are the model's (``{"params": tree}``, tensors or numpy
    arrays); the engine keeps its own copy on the model's device.
    """

    def __init__(self, model, variables, *, name: str = "model",
                 version: str = "v1", num_slots: int = 4,
                 max_len: Optional[int] = None, max_new_tokens: int = 64,
                 max_waiting: int = 64, min_kv_bucket: int = 8,
                 min_prompt_bucket: int = 8, idle_wait_s: float = 0.05,
                 temperature: float = 1.0, seed: int = 0,
                 brownout_max_new_tokens: Optional[int] = None,
                 prefix_cache=None, metrics=None):
        for arg, value, item in (
                ("prefix_cache", prefix_cache, "ROADMAP queue 1 item 6"),
                ("metrics", metrics, "ROADMAP queue 1 item 9"),
                ("brownout_max_new_tokens", brownout_max_new_tokens,
                 "the overload plane, ROADMAP queue 1 item 9")):
            if value is not None:
                raise NotImplementedError(
                    f"GenerationEngine({arg}=...) is not ported yet ({item})")
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

    def _note_shape(self, key: tuple):
        if key not in self._shapes:
            self._shapes.add(key)
            if self.warmed:
                self.shapes_after_warm += 1

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

    def warm(self) -> dict:
        """Run every prompt bucket and every (slot bucket, kv bucket)
        decode step once against the scratch row, before any traffic, and
        set ``warmed``. Returns {kind: {bucket: seconds}}."""
        if self.running:
            raise RuntimeError(
                "warm() must run before start() (or after stop())")
        stats: Dict[str, Dict[str, float]] = {"prefill": {}, "decode": {}}
        for p in self.prompt_buckets:
            t0 = time.monotonic()
            self.run_prefill(self._scratch, np.zeros(p, np.int64), p, 0.0)
            stats["prefill"][str(p)] = round(time.monotonic() - t0, 4)
        for b, kv in ((b, kv) for b in self.slot_buckets
                      for kv in self.kv_buckets):
            t0 = time.monotonic()
            self.run_decode(kv, [self._scratch] * b, [0] * b, [0] * b,
                            [0.0] * b).cpu()
            stats["decode"][f"{b}x{kv}"] = round(time.monotonic() - t0, 4)
        self.warmed = True
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
            self._cv.notify_all()
        return req

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
                    req = head
                elif head.priority == "critical":
                    victim = self._preempt_locked()
                    if victim is None:
                        return
                else:
                    return
            if victim is not None:
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
        return victim

    def _prefill(self, req: GenerationStream):
        t0v = req.prompt_len
        p = _bucket(self.prompt_buckets, t0v)
        prompt = np.zeros(p, np.int64)
        prompt[:t0v] = req.prompt
        tok = self.run_prefill(req.slot, prompt, t0v, req.temperature)
        with self._cv:
            # a client that went away while the prefill ran gets nothing
            if req.state != _ACTIVE:
                return
            req.pos = t0v
            req.last_tok = tok
            req.generated = 1
            req.t_first = time.monotonic()
        req._push_token(tok)
        self._maybe_finish(req, tok)

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
        toks = self.run_decode(kv, slot_idx, ids, pos, temps).tolist()
        self.steps += 1
        self.active_rows_total += len(active)
        self.bucket_rows_total += b
        for r, tok in zip(active, toks):
            with self._cv:
                if r.state != _ACTIVE:  # cancelled or preempted mid-step
                    continue
                r.pos += 1
                r.generated += 1
                r.last_tok = tok
            r._push_token(tok)
            self._maybe_finish(r, tok)

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
        for r in failed:
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
            self._cv.notify_all()
        for r in victims:
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
            }


__all__ = ["GenerationEngine", "GenerationStream"]
