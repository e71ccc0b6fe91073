"""Continuous-batching autoregressive decode with a paged KV cache.

Counterpart of `mxnet_tpu/serving/generate.py`:

  * `KVPageAllocator` hands out fixed-size KV pages from a free list; a
    sequence reserves its worst-case pages (prompt + max_new_tokens) at
    admission and returns them the step it finishes.
  * `GenerateScheduler` admits and retires requests at STEP granularity:
    each lap prefills the waiting requests that fit, then runs ONE decode
    step for the whole active set, padded to a power-of-two batch bucket.
  * `TransformerLMEngine` runs a `TransformerLM` incrementally: prefill is
    the full causal forward of a padded prompt, writing every token's K/V
    into the sequence's pages; each decode step feeds one token per
    sequence, appends its K/V and attends over the page table through
    `ops.pallas_kernels.paged_attention` (the CUDA kernel on the card).
  * `ServedLM` is the repository-facing model, in-process. The pooled
    replica path of the JAX package is not ported yet.

The port runs eagerly: there is no compile registry. Float32 matrix
products run in full float32 (TF32 is switched off for the card), so
greedy decoding on the card matches the full-sequence forward.
"""
from __future__ import annotations

import collections
import itertools
import json
import logging
import math
import os
import threading
import time

import numpy as _np
import torch

from .. import convert as _convert
from .. import env as _env
from .. import random as _random
from .. import telemetry
from ..base import MXNetError, atomic_writer
from ..context import resolve_device
from ..gluon.model_zoo.transformer import TransformerLM
from ..ops.pallas_kernels import _NEG_INF, paged_attention
from ..ops.random_ops import sample_token_logits
from .batcher import (DeadlineExceededError, DrainingError, QueueFullError,
                      ServingError, bucket_for, drain_timeout_s,
                      power_of_two_buckets)

__all__ = ["KVPageAllocator", "GenRequest", "GenerateScheduler",
           "TransformerLMEngine", "ServedLM", "save_lm", "load_lm"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving.generate")

_LM_FORMAT = "mxtpu-lm-v1"


# ---------------------------------------------------------------------------
# KV page allocator
# ---------------------------------------------------------------------------

class KVPageAllocator:
    """Free-list allocator over a fixed pool of KV-cache pages.

    Pages are identity-only here (integers 0..num_pages-1); the tensor they
    index lives in the engine. Allocation is all-or-nothing (`alloc`
    returns None rather than a partial grant); `free` returns pages for
    immediate reuse. Occupancy rides the ``mxtpu_serve_kv_pages_{total,
    used}`` gauges.
    """

    def __init__(self, num_pages, page_size, name="default"):
        if num_pages < 1 or page_size < 1:
            raise MXNetError("KV pool needs >=1 pages of >=1 tokens, got "
                             "%d x %d" % (num_pages, page_size))
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # LIFO free list: recently-freed pages are re-issued first
        self._free = list(range(self.num_pages - 1, -1, -1))
        labels = {"model": name}
        self._m_total = telemetry.gauge("mxtpu_serve_kv_pages_total", labels)
        self._m_used = telemetry.gauge("mxtpu_serve_kv_pages_used", labels)
        self._m_occ = telemetry.gauge("mxtpu_serve_kv_occupancy", labels)
        self._m_total.set(self.num_pages)
        self._m_used.set(0)
        self._m_occ.set(0.0)

    def pages_for(self, tokens):
        """Pages needed to hold ``tokens`` tokens."""
        return -(-int(tokens) // self.page_size)

    @property
    def free_pages(self):
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self):
        return self.num_pages - self.free_pages

    def alloc(self, n):
        """Grant ``n`` pages, or None when the pool cannot serve them."""
        n = int(n)
        with self._lock:
            if n < 0 or n > len(self._free):
                return None
            pages = self._free[-n:][::-1] if n else []
            del self._free[len(self._free) - n:]
            self._set_used_locked()
        return pages

    def free(self, pages):
        """Return a grant to the pool (a double free raises: a page owned
        by two sequences corrupts both)."""
        with self._lock:
            live = set(self._free)
            for p in pages:
                if p in live or not (0 <= p < self.num_pages):
                    raise MXNetError("double-free/corrupt KV page %r" % (p,))
            self._free.extend(pages)
            self._set_used_locked()

    def _set_used_locked(self):
        used = self.num_pages - len(self._free)
        self._m_used.set(used)
        self._m_occ.set(used / float(self.num_pages))


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

class GenRequest:
    """One admitted generation request. ``wait()`` yields the generated
    token list (prompt excluded); `finish_reason` is ``eos`` / ``length``
    after a normal completion."""

    __slots__ = ("tokens", "max_new_tokens", "temperature", "top_k",
                 "top_p", "deadline", "outputs", "finish_reason", "error",
                 "_event", "_rlock", "_t_submit")

    def __init__(self, tokens, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=1.0, deadline=None):
        self.tokens = [int(t) for t in tokens]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.deadline = deadline
        self.outputs = None
        self.finish_reason = None
        self.error = None
        self._event = threading.Event()
        self._rlock = threading.Lock()
        self._t_submit = time.monotonic()

    def done(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        self._event.wait(timeout)
        if not self._event.is_set():
            raise DeadlineExceededError(
                "generation expired after %.0f ms"
                % ((time.monotonic() - self._t_submit) * 1e3))
        if self.error is not None:
            raise self.error
        return self.outputs

    def _resolve(self, outputs=None, finish_reason=None, error=None):
        # first resolution wins, atomically (scheduler thread, abort paths
        # and deadline expiry can race)
        with self._rlock:
            if self._event.is_set():
                return
            self.outputs = outputs
            self.finish_reason = finish_reason
            self.error = error
            self._event.set()


# ---------------------------------------------------------------------------
# the continuous-batching scheduler
# ---------------------------------------------------------------------------

class _Sequence:
    """Scheduler-internal state of one RUNNING sequence."""

    __slots__ = ("req", "pages", "page_row", "pos", "generated", "t_last")

    def __init__(self, req, pages, page_row, pos, first_token):
        self.req = req
        self.pages = pages
        self.page_row = page_row
        self.pos = pos            # position of the NEXT token to feed
        self.generated = [first_token]
        self.t_last = time.monotonic()


_SCHED_SEQ = itertools.count()


class GenerateScheduler:
    """Token-level continuous batching over one decode engine.

    One daemon worker thread (``mxtpu-decode-<name>``) owns the engine, the
    active set and the page allocator's grants. Each lap:

      1. **admit**: pop waiting requests while batch slots AND worst-case
         pages are available; run one PREFILL each, which also samples the
         first token.
      2. **decode**: one step for the whole active set, padded to the
         smallest power-of-two batch bucket.
      3. **retire**: sequences hitting EOS / ``max_new_tokens`` / their
         deadline resolve at once and return their pages.

    Only the worker thread (and `close` after joining it) touches the
    engine.
    """

    def __init__(self, engine, name="default", queue_depth=None, warm=True):
        self.engine = engine
        self.name = str(name)
        self.buckets = sorted(int(b) for b in engine.buckets)
        self.max_active = self.buckets[-1]
        if queue_depth is None:
            queue_depth = _env.get("MXTPU_SERVE_QUEUE_DEPTH")
        self.queue_depth = max(1, int(queue_depth))
        self.allocator = KVPageAllocator(engine.num_pages, engine.page_size,
                                         name=self.name)

        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._active = []     # _Sequence list; mutated under _cv
        self._stop = False
        self._draining = False

        labels = {"model": self.name}
        self._m_queue = telemetry.gauge("mxtpu_serve_queue_depth", labels)
        self._m_reqs = telemetry.counter("mxtpu_serve_requests_total", labels)
        self._m_active = telemetry.gauge("mxtpu_serve_active_sequences",
                                         labels)
        self._m_steps = telemetry.counter("mxtpu_serve_decode_steps_total",
                                          labels)
        self._m_tokens = telemetry.counter(
            "mxtpu_serve_generated_tokens_total", labels)
        self._m_rej_full = telemetry.counter(
            "mxtpu_serve_rejected_total",
            {"model": self.name, "reason": "queue_full"})
        self._m_rej_dead = telemetry.counter(
            "mxtpu_serve_rejected_total",
            {"model": self.name, "reason": "deadline"})
        # in-flight expiry is not an admission rejection
        self._m_expired = telemetry.counter(
            "mxtpu_serve_rejected_total",
            {"model": self.name, "reason": "decode_expired"})
        self._m_intertoken = telemetry.histogram(
            "mxtpu_serve_intertoken_seconds", labels,
            bounds=(.001, .0025, .005, .01, .025, .05, .1, .25, .5, 1., 2.5))
        self._m_prefill = telemetry.histogram("mxtpu_serve_prefill_seconds",
                                              labels)
        # the worker thread's sampling generator is seeded from the
        # constructing thread's seed, the pid and a per-process index
        self._rng_seed = _random.worker_seed(
            _random.current_seed(), os.getpid(), next(_SCHED_SEQ))

        self.warm_seconds = None
        if warm:
            self.warm_seconds = engine.warm()
        self._worker = threading.Thread(
            target=self._loop, name="mxtpu-decode-%s" % self.name,
            daemon=True)
        self._worker.start()

    # -- admission ---------------------------------------------------------
    def submit(self, tokens, max_new_tokens=None, temperature=0.0, top_k=0,
               top_p=1.0, deadline=None):
        """Admit one generation request; returns a `GenRequest`."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise MXNetError("generation needs at least one prompt token")
        if len(tokens) > self.engine.max_prompt:
            raise MXNetError(
                "prompt has %d tokens; this model admits up to %d "
                "(MXTPU_SERVE_MAX_PROMPT)" % (len(tokens),
                                              self.engine.max_prompt))
        vocab = self.engine.vocab_size
        if any(t < 0 or t >= vocab for t in tokens):
            raise MXNetError("prompt token out of range [0, %d)" % vocab)
        cap = self.engine.max_new_tokens
        if max_new_tokens is None:
            max_new_tokens = cap
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1 or max_new_tokens > cap:
            raise MXNetError(
                "max_new_tokens must be in 1..%d (MXTPU_SERVE_MAX_NEW_"
                "TOKENS), got %d" % (cap, max_new_tokens))
        req = GenRequest(tokens, max_new_tokens, temperature=temperature,
                         top_k=top_k, top_p=top_p, deadline=deadline)
        with self._cv:
            if self._stop or self._draining:
                raise DrainingError("model %r is draining" % self.name)
            if len(self._queue) >= self.queue_depth:
                self._m_rej_full.inc()
                raise QueueFullError(
                    "generation queue for %r is full (%d requests; "
                    "MXTPU_SERVE_QUEUE_DEPTH)" % (self.name,
                                                  self.queue_depth))
            self._queue.append(req)
            self._m_queue.set(len(self._queue))
            self._m_reqs.inc()
            self._cv.notify()
        return req

    def pending(self):
        with self._cv:
            return len(self._queue) + len(self._active)

    # -- shutdown ----------------------------------------------------------
    def drain(self, timeout=None):
        """Stop admitting; let running sequences finish. Bounded."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        if timeout is None:
            timeout = drain_timeout_s()
        deadline = time.monotonic() + timeout
        while self.pending():
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        return True

    def abort_pending(self, error=None):
        """Force-resolve every queued and RUNNING request. Running
        sequences' pages are reclaimed by the worker on its next lap (or by
        `close` once the worker is joined)."""
        if error is None:
            error = DrainingError(
                "model %r drain timed out; generation force-completed"
                % self.name)
        with self._cv:
            victims = list(self._queue) + [s.req for s in self._active
                                           if not s.req.done()]
            self._queue.clear()
            self._m_queue.set(0)
        for req in victims:
            req._resolve(error=error)
        return len(victims)

    def close(self, drain=True, timeout=None):
        drained = self.drain(timeout) if drain else False
        with self._cv:
            self._stop = True
            self._draining = True
            self._cv.notify_all()
        self._worker.join(timeout=10.0)
        self.abort_pending(DrainingError(
            "model %r shut down before this generation ran" % self.name))
        if not self._worker.is_alive():
            with self._cv:
                leftovers, self._active = self._active, []
            for seq in leftovers:
                self.allocator.free(seq.pages)
            self._m_active.set(0)
        return drained

    # -- the worker --------------------------------------------------------
    def _loop(self):
        _random.seed(self._rng_seed)   # this thread's sampling generator
        gen = _random.generator(getattr(self.engine, "device", "cpu"))
        while True:
            with self._cv:
                while not self._queue and not self._active:
                    if self._stop:
                        return
                    self._cv.wait(0.05)
                if self._stop:
                    return
            try:
                self._admit(gen)
                if self._active:
                    self._step(gen)
            except Exception as e:  # the lone decode worker must not die
                telemetry.record_event("serve_decode_error",
                                       model=self.name, error=repr(e))
                _LOG.exception("decode loop error on %r", self.name)
                err = ServingError("decode loop for %r failed: %r"
                                   % (self.name, e))
                err.__cause__ = e
                with self._cv:
                    dead, self._active = self._active, []
                for seq in dead:
                    self.allocator.free(seq.pages)
                    seq.req._resolve(error=err)
                self._m_active.set(0)

    def _admit(self, gen):
        """Pop waiting requests while batch slots + worst-case pages are
        available and run their prefill."""
        while len(self._active) < self.max_active:
            with self._cv:
                if not self._queue:
                    break
                req = self._queue[0]
                now = time.monotonic()
                if req.deadline is not None and now >= req.deadline:
                    self._queue.popleft()
                    self._m_queue.set(len(self._queue))
                    self._m_rej_dead.inc()
                    req._resolve(error=DeadlineExceededError(
                        "deadline expired after %.0f ms in queue"
                        % ((now - req._t_submit) * 1e3)))
                    continue
                if req.done():       # externally aborted while queued
                    self._queue.popleft()
                    self._m_queue.set(len(self._queue))
                    continue
                # worst-case reservation: a RUNNING sequence never stalls
                # mid-decode waiting for the pool
                need = self.allocator.pages_for(
                    len(req.tokens) + req.max_new_tokens)
                pages = self.allocator.alloc(need)
                if pages is None:
                    break            # pool pressure: stays queued
                self._queue.popleft()
                self._m_queue.set(len(self._queue))
            page_row = _np.zeros(self.engine.max_pages_per_seq, _np.int32)
            page_row[:len(pages)] = pages
            t0 = time.monotonic()
            try:
                first = self.engine.prefill(
                    req.tokens, page_row,
                    (req.temperature, req.top_k, req.top_p), gen)
            except Exception as e:  # bad prompt/model: answer, free pages
                self.allocator.free(pages)
                err = ServingError("prefill on %r failed: %r"
                                   % (self.name, e))
                err.__cause__ = e
                telemetry.record_event("serve_decode_error",
                                       model=self.name, error=repr(e))
                req._resolve(error=err)
                continue
            self._m_prefill.observe(time.monotonic() - t0)
            self._m_tokens.inc()
            seq = _Sequence(req, pages, page_row, len(req.tokens), first)
            if not self._finish_if_done(seq):
                with self._cv:
                    self._active.append(seq)
            self._m_active.set(len(self._active))

    def _step(self, gen):
        """One decode step for the whole active set, padded to the
        smallest batch bucket; then retire finished sequences."""
        now = time.monotonic()
        live = []
        for seq in self._active:
            if seq.req.done():
                self.allocator.free(seq.pages)
            elif seq.req.deadline is not None and now >= seq.req.deadline:
                self._retire(seq, None, error=DeadlineExceededError(
                    "deadline expired after %d generated token(s)"
                    % len(seq.generated)))
            else:
                live.append(seq)
        if len(live) != len(self._active):
            with self._cv:
                self._active = live
            self._m_active.set(len(live))
        if not live:
            return
        bucket = bucket_for(len(live), self.buckets)
        ps = self.engine.page_size
        tokens = _np.zeros(bucket, _np.int32)
        positions = _np.zeros(bucket, _np.int32)
        dest_pages = _np.full(bucket, self.engine.num_pages, _np.int32)
        dest_slots = _np.zeros(bucket, _np.int32)
        tables = _np.zeros((bucket, self.engine.max_pages_per_seq),
                           _np.int32)
        lengths = _np.zeros(bucket, _np.int32)
        temps = _np.zeros(bucket, _np.float32)
        top_ks = _np.zeros(bucket, _np.int32)
        top_ps = _np.ones(bucket, _np.float32)
        for i, seq in enumerate(live):
            tokens[i] = seq.generated[-1]
            positions[i] = seq.pos
            dest_pages[i] = seq.page_row[seq.pos // ps]
            dest_slots[i] = seq.pos % ps
            tables[i] = seq.page_row
            lengths[i] = seq.pos + 1
            temps[i] = seq.req.temperature
            top_ks[i] = seq.req.top_k
            top_ps[i] = seq.req.top_p
        nxt = self.engine.decode_step(tokens, positions, dest_pages,
                                      dest_slots, tables, lengths, temps,
                                      top_ks, top_ps, gen)
        self._m_steps.inc()
        now = time.monotonic()
        still = []
        for i, seq in enumerate(live):
            seq.pos += 1
            seq.generated.append(int(nxt[i]))
            self._m_tokens.inc()
            self._m_intertoken.observe(now - seq.t_last)
            seq.t_last = now
            if not self._finish_if_done(seq):
                still.append(seq)
        with self._cv:
            self._active = still
        self._m_active.set(len(still))

    def _finish_if_done(self, seq):
        """Retire a sequence that hit EOS or its token budget."""
        eos = self.engine.eos_id
        if eos is not None and seq.generated[-1] == eos:
            self._retire(seq, "eos")
            return True
        if len(seq.generated) >= seq.req.max_new_tokens:
            self._retire(seq, "length")
            return True
        return False

    def _retire(self, seq, finish_reason, error=None):
        self.allocator.free(seq.pages)
        if error is not None:
            self._m_expired.inc()
            seq.req._resolve(error=error)
        else:
            seq.req._resolve(outputs=list(seq.generated),
                             finish_reason=finish_reason)


# ---------------------------------------------------------------------------
# the Transformer-LM decode engine
# ---------------------------------------------------------------------------

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TransformerLMEngine:
    """Incremental (paged-KV) execution of a `TransformerLM`.

    Prefill computes the full causal forward of a padded prompt bucket,
    writes every live token's K/V into the sequence's pages and samples the
    first token; `decode_step` feeds one token per row, appends its K/V and
    attends over the page table (`ops.pallas_kernels.paged_attention`).

    The KV pool is one ``(layers, 2, pages, heads, page_size, head_dim)``
    tensor on the engine's device, allocated in full at construction and
    updated IN PLACE: the port's replacement for the JAX engine's
    ``donate_argnums=(1,)``, which let XLA alias the pool instead of copying
    it each step. No step ever copies the pool.

    ``lm`` is a port `TransformerLM` (moved to ``device``); alternatively
    ``params`` (the JAX package's ``decode_params()`` dict) plus
    ``config``. ``device`` defaults to the CUDA card and raises without
    one. Only the scheduler's worker may drive an engine.
    """

    def __init__(self, lm=None, params=None, config=None, num_pages=None,
                 page_size=None, max_prompt=None, max_new_tokens=None,
                 max_batch=None, decode_buckets=None, prefill_buckets=None,
                 eos_id=None, kv_dtype="float32", device=None):
        self.device = resolve_device(device)
        if lm is None:
            if config is None or params is None:
                raise MXNetError("TransformerLMEngine needs an lm= module or "
                                 "params= + config=")
            lm = TransformerLM(**config, device=self.device)
            lm.load_state_dict(_convert.params_from_jax(
                params, dropout=config.get("dropout", 0.0)))
        self.lm = lm.to(device=self.device, dtype=torch.float32).eval()
        config = lm.config
        self.config = dict(config)
        self.vocab_size = int(config["vocab_size"])
        self.units = int(config["units"])
        self.num_heads = int(config["num_heads"])
        self.head_dim = self.units // self.num_heads
        self.num_layers = int(config["num_layers"])
        self.eos_id = None if eos_id is None else int(eos_id)
        self.page_size = int(page_size if page_size is not None
                             else _env.get("MXTPU_SERVE_KV_PAGE_SIZE"))
        self.num_pages = int(num_pages if num_pages is not None
                             else _env.get("MXTPU_SERVE_KV_PAGES"))
        self.max_prompt = int(max_prompt if max_prompt is not None
                              else _env.get("MXTPU_SERVE_MAX_PROMPT"))
        self.max_new_tokens = int(
            max_new_tokens if max_new_tokens is not None
            else _env.get("MXTPU_SERVE_MAX_NEW_TOKENS"))
        max_total = self.max_prompt + self.max_new_tokens
        if max_total > int(config["max_length"]):
            raise MXNetError(
                "max_prompt + max_new_tokens = %d exceeds the model's "
                "position table (max_length=%d)"
                % (max_total, config["max_length"]))
        self.max_pages_per_seq = -(-max_total // self.page_size)
        if self.max_pages_per_seq > self.num_pages:
            raise MXNetError(
                "one sequence can need %d pages but the pool has only %d "
                "(MXTPU_SERVE_KV_PAGES)" % (self.max_pages_per_seq,
                                            self.num_pages))
        if decode_buckets is None:
            if max_batch is None:
                max_batch = _env.get("MXTPU_SERVE_MAX_BATCH")
            decode_buckets = power_of_two_buckets(max_batch)
        self.buckets = sorted(int(b) for b in decode_buckets)
        if prefill_buckets is None:
            lo = min(8, self.max_prompt)
            prefill_buckets = [b for b in
                               power_of_two_buckets(self.max_prompt)
                               if b >= lo]
        self.prefill_buckets = sorted(int(b) for b in prefill_buckets)
        if str(kv_dtype) not in _KV_DTYPES:
            raise MXNetError("kv_dtype must be one of %s, got %r"
                             % (sorted(_KV_DTYPES), kv_dtype))
        self.kv_dtype = str(kv_dtype)
        if self.device.type == "cuda":
            # full-f32 products: greedy parity with the full forward must
            # not be lost to TF32's 10-bit mantissa
            torch.backends.cuda.matmul.allow_tf32 = False
        self._scale = 1.0 / math.sqrt(self.head_dim)
        self._kv = torch.zeros(
            (self.num_layers, 2, self.num_pages, self.num_heads,
             self.page_size, self.head_dim),
            dtype=_KV_DTYPES[self.kv_dtype], device=self.device)

    # -- sizing ------------------------------------------------------------
    def kv_bytes(self):
        """Device bytes of the page pool (allocated in full at load)."""
        return int(self._kv.numel() * self._kv.element_size())

    def param_bytes(self):
        return self.lm.param_bytes()

    def geometry(self):
        return {"num_pages": self.num_pages, "page_size": self.page_size,
                "max_pages_per_seq": self.max_pages_per_seq,
                "max_prompt": self.max_prompt,
                "max_new_tokens": self.max_new_tokens,
                "decode_buckets": list(self.buckets),
                "prefill_buckets": list(self.prefill_buckets),
                "kv_dtype": self.kv_dtype,
                "kv_bytes": self.kv_bytes(),
                "param_bytes": self.param_bytes(),
                "device": str(self.device)}

    # -- the layer stack ---------------------------------------------------
    def _cells(self, x, attend, write_kv):
        """Run every layer on ``x`` (n, C): ``write_kv(li, k, v)`` stores the
        layer's keys/values into the pool, ``attend(li, q, k, v)`` returns
        the (n, H, Dh) attention output."""
        n = x.shape[0]
        H, Dh = self.num_heads, self.head_dim
        for li, cell in enumerate(self.lm.cells):
            att = cell.attention
            qh = att.proj_query(x).reshape(n, H, Dh)
            kh = att.proj_key(x).reshape(n, H, Dh)
            vh = att.proj_value(x).reshape(n, H, Dh)
            write_kv(li, kh, vh)
            a = attend(li, qh, kh, vh).reshape(n, self.units)
            x = cell.attention_norm(x + att.proj_out(a))
            x = cell.ffn_norm(x + cell.ffn(x))
        return x

    def _write(self, li, pages, slots, rows, k, v):
        # torch's index_put_ has no "drop" mode for out-of-range pages, so
        # padding rows were taken out of ``rows`` on the host beforehand
        kv = self._kv[li]
        kv[0, pages, :, slots, :] = k[rows].to(kv.dtype)
        kv[1, pages, :, slots, :] = v[rows].to(kv.dtype)

    # -- driving -----------------------------------------------------------
    def prefill(self, tokens, page_row, sampling, generator):
        """Run one prompt through its padded prefill bucket; writes the
        prompt's K/V into ``page_row``'s pages and returns the sampled first
        token (int)."""
        n = len(tokens)
        lp = bucket_for(n, self.prefill_buckets)
        if lp is None:
            raise MXNetError("prompt of %d tokens overflows the prefill "
                             "buckets %s" % (n, self.prefill_buckets))
        page_row = _np.asarray(page_row, _np.int64)
        self._check_pages(page_row)
        padded = _np.zeros(lp, _np.int64)
        padded[:n] = tokens
        t_idx = _np.arange(n)
        dev = self.device
        lm = self.lm
        with torch.no_grad():
            tok = torch.from_numpy(padded).to(dev)
            pages = torch.from_numpy(page_row[t_idx // self.page_size]).to(dev)
            slots = torch.from_numpy(t_idx % self.page_size).to(dev)
            rows = torch.arange(n, device=dev)
            pos = torch.arange(lp, device=dev)
            causal = (pos[None, :] <= pos[:, None])[None]
            word = lm._held("word_weight")
            x = word[tok] + lm.position_embed._held("weight")[:lp]
            x = lm.embed_norm(x)

            def write_kv(li, k, v):
                self._write(li, pages, slots, rows, k, v)

            def attend(li, q, k, v):
                s = torch.einsum("qhd,khd->hqk", q, k) * self._scale
                s = torch.where(causal, s, torch.full_like(s, _NEG_INF))
                p = torch.softmax(s, dim=-1)
                return torch.einsum("hqk,khd->qhd", p, v)

            x = self._cells(x, attend, write_kv)
            logits = torch.matmul(x[n - 1], word.t())
            temp, top_k, top_p = sampling
            out = sample_token_logits(logits[None], [float(temp)],
                                      [int(top_k)], [float(top_p)],
                                      generator=generator)
            return int(out[0])

    def decode_step(self, tokens, positions, dest_pages, dest_slots,
                    tables, lengths, temps, top_ks, top_ps, generator):
        """One token for every row. A row with length 0 is inert padding:
        its destination page is out of range (``num_pages``), so its K/V
        write is dropped, and its sampled token is discarded by the caller.
        Returns an int32 numpy array of next tokens."""
        tables = _np.ascontiguousarray(tables, _np.int32)
        self._check_pages(tables)
        dest_pages = _np.asarray(dest_pages, _np.int64)
        rows = _np.nonzero(dest_pages < self.num_pages)[0]
        self._check_pages(dest_pages[rows])
        dev = self.device
        lm = self.lm
        with torch.no_grad():
            tok = torch.from_numpy(_np.asarray(tokens, _np.int64)).to(dev)
            pos = torch.from_numpy(_np.asarray(positions, _np.int64)).to(dev)
            tbl = torch.from_numpy(tables).to(dev)
            lens = torch.from_numpy(
                _np.ascontiguousarray(lengths, _np.int32)).to(dev)
            pages = torch.from_numpy(dest_pages[rows]).to(dev)
            slots = torch.from_numpy(
                _np.asarray(dest_slots, _np.int64)[rows]).to(dev)
            rows_t = torch.from_numpy(rows).to(dev)
            word = lm._held("word_weight")
            x = word[tok] + lm.position_embed._held("weight")[pos]
            x = lm.embed_norm(x)

            def write_kv(li, k, v):
                self._write(li, pages, slots, rows_t, k, v)

            def attend(li, q, k, v):
                return paged_attention(q, self._kv[li, 0], self._kv[li, 1],
                                       tbl, lens, sm_scale=self._scale)

            x = self._cells(x, attend, write_kv)
            logits = torch.matmul(x, word.t())
            out = sample_token_logits(logits, temps, top_ks, top_ps,
                                      generator=generator)
            return out.cpu().numpy()

    def _check_pages(self, table):
        """Page ids that reach the device must name pages of the pool (an
        out-of-range id would read or write outside it)."""
        if table.size and (table.min() < 0 or table.max() >= self.num_pages):
            raise MXNetError("page table holds ids outside [0, %d)"
                             % self.num_pages)

    def warm(self):
        """Run every prefill and decode bucket once on dummy data (decode
        writes dropped) so every kernel of the path is built and
        first-launched before any request is timed. Warm-up samples at
        temperature 1: that path runs the greedy argmax too, while an
        all-greedy batch skips the sampling kernels, and the first sampled
        request would load them. Returns seconds."""
        t0 = time.monotonic()
        maxp = self.max_pages_per_seq
        for lp in self.prefill_buckets:
            self.prefill([1] * lp, _np.zeros(maxp, _np.int32),
                         (1.0, 0, 1.0), None)
        for b in self.buckets:
            self.decode_step(
                _np.zeros(b, _np.int32), _np.zeros(b, _np.int32),
                _np.full(b, self.num_pages, _np.int32),
                _np.zeros(b, _np.int32), _np.zeros((b, maxp), _np.int32),
                _np.zeros(b, _np.int32), _np.ones(b, _np.float32),
                _np.zeros(b, _np.int32), _np.ones(b, _np.float32), None)
            telemetry.record_event("serve_decode_warm", model="engine",
                                   bucket=b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic() - t0


# ---------------------------------------------------------------------------
# artifact IO — <prefix>-lmconfig.json + <prefix>-lm.params
# ---------------------------------------------------------------------------

def save_lm(lm, prefix):
    """Write a generation-serving artifact in the JAX package's format: the
    architecture header (``mxtpu-lm-v1``) and the parameters as an npz
    under the JAX package's keys, so either package can load it."""
    prefix = os.fspath(prefix)
    with atomic_writer(prefix + "-lmconfig.json", "w") as f:
        json.dump({"format": _LM_FORMAT, "config": lm.config}, f, indent=1)
    arrays = _convert.npz_from_state(lm.state_dict(),
                                     dropout=lm.config.get("dropout", 0.0))
    with atomic_writer(prefix + "-lm.params", "wb") as f:
        _np.savez(f, **arrays)
    return prefix


def load_lm(prefix, device=None):
    """Rebuild a `TransformerLM` on ``device`` (default: the CUDA card)
    from a ``save_lm`` artifact of either package."""
    device = resolve_device(device)
    prefix = os.fspath(prefix)
    cfg_path = prefix + "-lmconfig.json"
    if not os.path.exists(cfg_path):
        raise MXNetError("no generation artifact at %r (expected %s)"
                         % (prefix, cfg_path))
    with open(cfg_path) as f:
        header = json.load(f)
    if header.get("format") != _LM_FORMAT:
        raise MXNetError("%s: unknown LM artifact format %r"
                         % (cfg_path, header.get("format")))
    with _np.load(prefix + "-lm.params") as arrays:
        state = _convert.state_from_npz(arrays)
    lm = TransformerLM(**header["config"], device=device)
    lm.load_state_dict(state)
    return lm


# ---------------------------------------------------------------------------
# the repository-facing served model
# ---------------------------------------------------------------------------

class ServedLM:
    """One served generation model (`ModelRepository` duck type), owning
    an in-process `GenerateScheduler`."""

    def __init__(self, name, version, scheduler, meta=None):
        self.name = str(name)
        self.version = int(version)
        self._scheduler = scheduler
        self.meta = dict(meta or {})
        self.loaded_at = time.time()
        self.generate_info = dict(scheduler.engine.geometry())
        self.warm_seconds = scheduler.warm_seconds
        self.memory_bytes = (
            (self.generate_info.get("kv_bytes") or 0)
            + (self.generate_info.get("param_bytes") or 0)) or None
        if self.memory_bytes:
            telemetry.gauge("mxtpu_serve_model_memory_bytes",
                            {"model": "%s/%d" % (self.name, self.version)}
                            ).set(self.memory_bytes)

    @staticmethod
    def load(name, version, prefix, queue_depth=None, device=None,
             **engine_kwargs):
        """Load a ``save_lm`` artifact as a served generation model on
        ``device`` (default: the CUDA card), in this process (the JAX
        package's pooled replicas are not ported yet). ``engine_kwargs`` go
        to `TransformerLMEngine`."""
        device = resolve_device(device)
        engine = TransformerLMEngine(lm=load_lm(prefix, device=device),
                                     device=device, **engine_kwargs)
        sched = GenerateScheduler(engine, name="%s/%d" % (name, version),
                                  queue_depth=queue_depth)
        return ServedLM(name, version, sched,
                        meta={"artifact": "generate",
                              "path": os.fspath(prefix)})

    @property
    def scheduler(self):
        return self._scheduler

    def generate(self, tokens, max_new_tokens=None, temperature=0.0,
                 top_k=0, top_p=1.0, timeout_ms=None):
        """Admit one generation request and wait for it: returns
        ``{"tokens": [...], "finish_reason": ...}``. Raises the typed
        admission errors (429/503/504/400 mapping)."""
        if timeout_ms is None:
            timeout_ms = _env.get("MXTPU_SERVE_TIMEOUT_MS")
        deadline = None
        if timeout_ms and timeout_ms > 0:
            deadline = time.monotonic() + float(timeout_ms) / 1e3
        req = self._scheduler.submit(
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, deadline=deadline)
        timeout = None if deadline is None \
            else max(0.0, deadline - time.monotonic())
        out = req.wait(timeout)
        return {"tokens": out, "finish_reason": req.finish_reason}

    def pending(self):
        return self._scheduler.pending()

    def drain(self, timeout=None):
        return self._scheduler.drain(timeout)

    def abort_pending(self, error=None):
        return self._scheduler.abort_pending(error)

    def close(self, drain=True, timeout=None):
        return self._scheduler.close(drain=drain, timeout=timeout)

    def describe(self):
        alloc = self._scheduler.allocator
        return {
            "name": self.name,
            "version": self.version,
            "kind": "generate",
            "generate": dict(self.generate_info),
            "warmed": True,
            "warm_seconds": self.warm_seconds,
            "pending": self.pending(),
            "loaded_at": self.loaded_at,
            "meta": self.meta,
            "memory": {"total_bytes": self.memory_bytes},
            "kv": {"pages_total": alloc.num_pages,
                   "pages_used": alloc.used_pages,
                   "page_size": alloc.page_size},
        }
