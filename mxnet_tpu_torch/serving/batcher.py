"""Serving errors, batch buckets and the dynamic micro-batcher.

Counterpart of `mxnet_tpu/serving/batcher.py`. The typed admission errors
carry their HTTP mapping; the power-of-two padding buckets serve both the
generation path and predict serving. `DynamicBatcher` is the request queue
of predict serving:

  * concurrent requests land in a bounded queue (admission control:
    ``MXTPU_SERVE_QUEUE_DEPTH``; overflow is rejected at once, HTTP 429);
  * one worker thread coalesces them into a batch, closing it when it
    holds ``MXTPU_SERVE_MAX_BATCH`` examples or when the oldest admitted
    request has waited ``MXTPU_SERVE_MAX_DELAY_MS``; a request is never
    split, and a batch never exceeds the largest bucket;
  * the batch is zero-padded up to a power-of-two bucket (one bound
    executor a bucket), run, and its outputs unpadded and split back per
    request by the shared `base.unpad_outputs`.

The ``runner`` owns the model (numpy in, numpy out) and is only ever
called from the worker thread. A replica pool takes the batches over
instead (``dispatcher=``), sheds load at admission (``admission_gate=``)
and puts a dead replica's batch back at the front of the queue
(`DynamicBatcher.requeue`, exactly once a request). Each request carries
the trace context of the thread that admitted it, and its phases emit
spans under it (``serve.assembly``, ``serve.queue``, ``serve.compute``,
``serve.unpad``). Telemetry goes under the JAX package's metric names, and
each batcher registers its model's built-in SLO objectives (p99 latency,
availability, queue-depth ceiling; `telemetry.slo`) until it closes.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as _np

from .. import env as _env
from .. import telemetry
from ..base import MXNetError, unpad_outputs
from ..telemetry import slo as _slo
from ..telemetry import tracing as _tracing

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "ModelUnavailableError", "DrainingError", "OverloadedError",
           "MemoryBudgetError", "drain_timeout_s", "power_of_two_buckets",
           "bucket_for", "pad_batch", "ServeRequest", "DynamicBatcher"]


def drain_timeout_s():
    """Graceful-drain budget in seconds (`MXTPU_SERVE_DRAIN_TIMEOUT_MS`)."""
    return _env.get("MXTPU_SERVE_DRAIN_TIMEOUT_MS") / 1e3


class ServingError(MXNetError):
    """Base serving-layer error; `status` is the HTTP mapping and
    `retry_after` (seconds, optional) becomes a ``Retry-After`` header."""

    status = 500
    retry_after = None


class QueueFullError(ServingError):
    """Admission control: the bounded request queue is full."""

    status = 429
    retry_after = 1


class DeadlineExceededError(ServingError):
    """The request's deadline expired before a result was produced."""

    status = 504


class ModelUnavailableError(ServingError):
    """No such model/version (or it has been unloaded)."""

    status = 404


class DrainingError(ServingError):
    """The server/model is draining and admits no new work."""

    status = 503


class OverloadedError(ServingError):
    """Deterministic load shedding: a degraded replica pool refuses work it
    could only queue into a black hole (``Retry-After`` scales with the
    healthy-replica count). Raised by the replica pools."""

    status = 503

    def __init__(self, msg, retry_after=1):
        super().__init__(msg)
        self.retry_after = max(1, int(retry_after))


class MemoryBudgetError(ServingError):
    """A load whose device footprint exceeds ``MXTPU_SERVE_MEMORY_BUDGET``
    is rejected before it publishes (`ModelRepository.load` / `add`): 507
    Insufficient Storage. ``details`` carries the machine-readable
    footprint breakdown (requested bytes, each resident model's effective
    bytes, budget, headroom, shortfall), which the HTTP 507 body ships."""

    status = 507

    def __init__(self, msg, details=None):
        super().__init__(msg)
        self.details = details


def power_of_two_buckets(max_batch):
    """Every power of two below ``max_batch``, plus ``max_batch`` itself as
    the terminal bucket."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise MXNetError("max_batch must be >= 1, got %d" % max_batch)
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return buckets


def bucket_for(n, buckets):
    """Smallest bucket holding ``n`` (None when n overflows)."""
    for b in buckets:
        if n <= b:
            return b
    return None


def pad_batch(batch, total, buckets):
    """Concatenate the requests' input arrays and zero-pad up to the
    smallest bucket holding ``total`` examples. Returns ``(padded_arrays,
    bucket)``."""
    bucket = bucket_for(total, buckets)
    padded = {}
    for name in batch[0].arrays:
        parts = [r.arrays[name] for r in batch]
        a = parts[0] if len(parts) == 1 else _np.concatenate(parts)
        if a.shape[0] < bucket:
            pad = _np.zeros((bucket - a.shape[0],) + a.shape[1:],
                            dtype=a.dtype)
            a = _np.concatenate([a, pad])
        padded[name] = a
    return padded, bucket


class ServeRequest:
    """One admitted request: ``arrays`` maps input name -> numpy array whose
    leading dim is this request's example count ``n``."""

    __slots__ = ("arrays", "n", "deadline", "outputs", "error", "bucket",
                 "_event", "_rlock", "_t_submit", "queue_seconds",
                 "compute_seconds", "retried", "trace")

    def __init__(self, arrays, n, deadline):
        self.arrays = arrays
        self.n = n
        self.deadline = deadline
        self.outputs = None
        self.error = None
        self.bucket = None
        self.queue_seconds = None
        self.compute_seconds = None
        self.retried = False  # failed over once already (exactly once)
        # the admitting thread's span context (the HTTP handler's request
        # span): every later phase, in whichever thread or process, parents
        # its spans here
        self.trace = _tracing.capture()
        self._event = threading.Event()
        self._rlock = threading.Lock()
        self._t_submit = time.monotonic()

    def done(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        """Block until the batcher resolves this request (or ``timeout``
        passes: 504). Returns the per-request output list or raises the
        ServingError the batcher recorded."""
        self._event.wait(timeout)
        if not self._event.is_set():
            raise DeadlineExceededError(
                "request expired after %.0f ms in queue"
                % ((time.monotonic() - self._t_submit) * 1e3))
        if self.error is not None:
            raise self.error
        return self.outputs

    def _resolve(self, outputs=None, error=None):
        # the first resolution wins, atomically: the worker, the drain's
        # abort_pending and the expiry path can race here
        with self._rlock:
            if self._event.is_set():
                return
            self.outputs = outputs
            self.error = error
            self._event.set()


class DynamicBatcher:
    """Coalesce concurrent requests into padded, bucketed batches.

    Parameters
    ----------
    runner : callable(batch_arrays, bucket, n) -> list of numpy arrays
        Runs one padded batch (leading dim == bucket) and returns the
        model's outputs, each with leading dim == bucket. Called only from
        the batcher's worker thread.
    buckets : list of int
        The padding buckets; the largest is the most a batch holds.
    max_delay_ms / queue_depth : coalescing and admission knobs
        Default to ``MXTPU_SERVE_MAX_DELAY_MS`` / ``MXTPU_SERVE_QUEUE_DEPTH``.
    name : str
        Telemetry label (``model="<name>"`` on every serving metric).
    dispatcher : callable(batch, total), optional
        Takes batch execution over (the replica pool's hook): called from
        the worker thread with an assembled batch whose expired members
        were pruned; it must route every request through `resolve_batch`,
        `fail_batch` or `requeue`, so the in-flight accounting closes.
        None (default) runs batches inline on ``runner``.
    admission_gate : callable(queued_len) -> ServingError or None, optional
        Consulted under the queue lock on every submit before the depth
        check: the replica pool sheds load here when degraded (an error
        is raised to the caller; the request never queues).
    """

    def __init__(self, runner, buckets, max_delay_ms=None, queue_depth=None,
                 name="default", dispatcher=None, admission_gate=None):
        self._runner = runner
        self._dispatcher = dispatcher
        self._admission_gate = admission_gate
        self.buckets = sorted(int(b) for b in buckets)
        if not self.buckets:
            raise MXNetError("need at least one bucket")
        self.max_batch = self.buckets[-1]
        if max_delay_ms is None:
            max_delay_ms = _env.get("MXTPU_SERVE_MAX_DELAY_MS")
        if queue_depth is None:
            queue_depth = _env.get("MXTPU_SERVE_QUEUE_DEPTH")
        self.max_delay_s = max(0.0, float(max_delay_ms)) / 1e3
        self.queue_depth = max(1, int(queue_depth))
        self.name = name

        self._queue = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._draining = False
        # popped but not yet resolved: a set, so a forced drain can resolve
        # work stuck inside a wedged runner
        self._inflight = set()

        labels = {"model": name}
        self._m_queue = telemetry.gauge("mxtpu_serve_queue_depth", labels)
        self._m_reqs = telemetry.counter("mxtpu_serve_requests_total", labels)
        self._m_examples = telemetry.counter("mxtpu_serve_examples_total",
                                             labels)
        self._m_batches = telemetry.counter("mxtpu_serve_batches_total",
                                            labels)
        self._m_rej_full = telemetry.counter(
            "mxtpu_serve_rejected_total",
            {"model": name, "reason": "queue_full"})
        self._m_rej_dead = telemetry.counter(
            "mxtpu_serve_rejected_total",
            {"model": name, "reason": "deadline"})
        self._m_rej_shed = telemetry.counter(
            "mxtpu_serve_rejected_total", {"model": name, "reason": "shed"})
        # how full each dispatched bucket was (n / bucket)
        self._m_occupancy = telemetry.histogram(
            "mxtpu_serve_batch_occupancy", labels,
            bounds=tuple(i / 10.0 for i in range(1, 11)))
        self._m_batch_size = telemetry.histogram(
            "mxtpu_serve_batch_size", labels,
            bounds=tuple(float(b) for b in self.buckets))
        # queue wait vs compute per request, and admission -> resolution
        self._m_queue_s = telemetry.histogram("mxtpu_serve_queue_seconds",
                                              labels)
        self._m_compute_s = telemetry.histogram(
            "mxtpu_serve_compute_seconds", labels)
        self._m_request_s = telemetry.histogram(
            "mxtpu_serve_request_seconds", labels)
        # the model's built-in SLOs, dropped again in close()
        _slo.wire_serving_objectives(name, queue_depth=self.queue_depth)

        self._worker = threading.Thread(
            target=self._loop, name="mxtpu-serve-batcher-%s" % name,
            daemon=True)
        self._worker.start()

    # -- admission ---------------------------------------------------------
    def submit(self, arrays, deadline=None):
        """Admit one request. ``arrays``: dict name -> numpy array, leading
        dim = example count (1..max_batch). Returns a `ServeRequest` whose
        ``wait()`` yields the unpadded per-request outputs."""
        ns = {int(a.shape[0]) for a in arrays.values()}
        if not ns:
            raise MXNetError("request carries no input arrays")
        if len(ns) != 1:
            raise MXNetError("inconsistent leading dims across inputs: %s"
                             % sorted(ns))
        n = ns.pop()
        if n < 1 or n > self.max_batch:
            raise MXNetError(
                "request carries %d examples; this model serves 1..%d per "
                "request (MXTPU_SERVE_MAX_BATCH)" % (n, self.max_batch))
        req = ServeRequest(arrays, n, deadline)
        with self._cv:
            if self._stop or self._draining:
                raise DrainingError("model %r is draining" % self.name)
            if self._admission_gate is not None:
                err = self._admission_gate(len(self._queue))
                if err is not None:
                    self._m_rej_shed.inc()
                    raise err
            if len(self._queue) >= self.queue_depth:
                self._m_rej_full.inc()
                raise QueueFullError(
                    "queue for model %r is full (%d requests; "
                    "MXTPU_SERVE_QUEUE_DEPTH)" % (self.name,
                                                  self.queue_depth))
            self._queue.append(req)
            self._m_queue.set(len(self._queue))
            self._m_reqs.inc()
            self._cv.notify()
        return req

    def pending(self):
        """Queued + in-flight request count (drain progress)."""
        with self._cv:
            return len(self._queue) + len(self._inflight)

    # -- shutdown ----------------------------------------------------------
    def drain(self, timeout=None):
        """Stop admitting, let the worker finish everything queued, and wait
        up to ``timeout`` seconds (default `MXTPU_SERVE_DRAIN_TIMEOUT_MS`).
        Returns True when fully drained."""
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
        """Force-resolve every queued and in-flight request with ``error``
        (default a 503): a wedged runner must not strand its waiters.
        Returns how many were force-resolved."""
        if error is None:
            error = DrainingError(
                "model %r drain timed out; request force-completed"
                % self.name)
        with self._cv:
            victims = list(self._queue) + \
                [r for r in self._inflight if not r.done()]
            self._queue.clear()
            self._inflight.clear()
            self._m_queue.set(0)
        for req in victims:
            req._resolve(error=error)
        return len(victims)

    def close(self, drain=True, timeout=None):
        """Drain (optionally), then stop the worker thread."""
        drained = self.drain(timeout) if drain else False
        with self._cv:
            self._stop = True
            self._draining = True
            self._cv.notify_all()
        self._worker.join(timeout=5.0)
        self.abort_pending(DrainingError(
            "model %r shut down before this request ran" % self.name))
        # verdicts for a gone model are noise on /statusz
        _slo.unregister_model(self.name)
        return drained

    def requeue(self, batch):
        """Failover: put a dead replica's in-flight batch back at the
        FRONT of the queue, exactly once a request (predict is idempotent,
        so one retry is safe; more could double work without bound).
        Expired members answer 504; members that already failed over once
        get a retryable 503. Returns how many requests went back."""
        now = time.monotonic()
        requeued = 0
        # the requests THIS call put back: `retried` alone cannot tell them
        # from those whose one retry was spent earlier (503 below)
        taken = set()
        with self._cv:
            self._inflight.difference_update(batch)
            accept = not (self._stop or self._draining)
            for req in reversed(batch):
                if req.done():
                    continue
                if req.deadline is not None and now >= req.deadline:
                    continue  # expired: resolved below, outside the lock
                if req.retried or not accept:
                    continue
                req.retried = True
                taken.add(req)
                self._queue.appendleft(req)
                requeued += 1
            self._m_queue.set(len(self._queue))
            if requeued:
                self._cv.notify()
        for req in batch:
            if req in taken or req.done():
                continue
            if req.deadline is not None and now >= req.deadline:
                self._expire(req, now)
            elif req.retried:
                # a second replica death under the same request
                req._resolve(error=OverloadedError(
                    "request already failed over once on model %r"
                    % self.name))
            else:
                req._resolve(error=OverloadedError(
                    "model %r is draining; in-flight request not retried"
                    % self.name))
        return requeued

    # -- the worker --------------------------------------------------------
    def _pop_live(self, max_n=None):
        """Pop the next request that is still live (expired ones are
        resolved 504 on the spot) and fits within ``max_n`` examples; the
        fit is checked on the request actually popped. None when the queue
        is empty or the next live request would overflow. Caller holds
        _cv."""
        now = time.monotonic()
        while self._queue:
            req = self._queue[0]
            if req.deadline is not None and now >= req.deadline:
                self._queue.popleft()
                self._m_queue.set(len(self._queue))
                self._expire(req, now)
                continue
            if max_n is not None and req.n > max_n:
                return None  # stays queued for the next batch
            self._queue.popleft()
            self._m_queue.set(len(self._queue))
            self._inflight.add(req)
            return req
        return None

    def _expire(self, req, now=None):
        """Resolve one request 504 (in-flight accounting is the caller's)."""
        if now is None:
            now = time.monotonic()
        self._m_rej_dead.inc()
        req._resolve(error=DeadlineExceededError(
            "deadline expired after %.0f ms in queue"
            % ((now - req._t_submit) * 1e3)))

    def _prune_expired(self, batch):
        """504 every member of an assembled batch whose deadline passed in
        the coalescing window; returns the live remainder, so the runner
        never computes an answer nobody waits for."""
        now = time.monotonic()
        live, dead = [], []
        for req in batch:
            if req.done():
                continue
            if req.deadline is not None and now >= req.deadline:
                dead.append(req)
            else:
                live.append(req)
        if dead:
            with self._cv:
                self._inflight.difference_update(dead)
            for req in dead:
                self._expire(req, now)
        return live

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue:
                    if self._stop:
                        return
                    self._cv.wait(0.05)
                first = self._pop_live()
            if first is None:
                continue
            batch = [first]
            total = first.n
            t_assembly = time.monotonic()
            close_at = t_assembly + self.max_delay_s
            # coalesce until the largest bucket is full or the delay window
            # closes; a draining batcher takes what is queued, no waiting
            while total < self.max_batch:
                with self._cv:
                    req = self._pop_live(self.max_batch - total)
                    if req is None:
                        if self._queue:
                            break  # the live head would overflow
                        if self._draining or self._stop:
                            break
                        remaining = close_at - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(min(remaining, 0.05))
                        continue
                batch.append(req)
                total += req.n
            batch = self._prune_expired(batch)
            total = sum(r.n for r in batch)
            if not batch:
                continue
            # the coalescing window, a span a traced request (emitted after
            # the fact: only the window's end knows the batch)
            assembly_s = time.monotonic() - t_assembly
            assembly_wall = time.time() - assembly_s
            for req in batch:
                _tracing.emit_span("serve.assembly", assembly_wall,
                                   assembly_s, req.trace, component="router",
                                   attrs={"batch": len(batch), "n": total})
            try:
                if self._dispatcher is not None:
                    self._dispatcher(batch, total)
                else:
                    self._dispatch(batch, total)
            except Exception as e:  # the lone worker must never die
                telemetry.record_event("serve_batcher_error",
                                       model=self.name, error=repr(e))
                self.fail_batch(batch, ServingError(
                    "batcher for %r failed: %r" % (self.name, e)))

    # -- batch resolution --------------------------------------------------
    def resolve_batch(self, batch, outputs, bucket, total, compute_s):
        """Unpad ``outputs`` (leading dim == bucket), split them back per
        request in ``batch`` order, resolve every request, and close the
        in-flight accounting."""
        now = time.monotonic()
        t_unpad = time.perf_counter()
        unpad_wall = time.time()
        outs = unpad_outputs(outputs, bucket - total)
        offset = 0
        splits = []
        for req in batch:
            req.bucket = bucket
            req.queue_seconds = max(0.0, now - compute_s - req._t_submit)
            req.compute_seconds = compute_s
            self._m_queue_s.observe(req.queue_seconds)
            self._m_request_s.observe(max(0.0, now - req._t_submit))
            # the queue phase, its start the request's submit time on the
            # wall clock
            _tracing.emit_span(
                "serve.queue", unpad_wall - (now - req._t_submit),
                req.queue_seconds, req.trace, component="router")
            splits.append((req, [o[offset:offset + req.n].copy()
                                 for o in outs]))
            offset += req.n
        unpad_s = time.perf_counter() - t_unpad
        for req, per_req in splits:
            _tracing.emit_span("serve.unpad", unpad_wall, unpad_s,
                               req.trace, component="router",
                               attrs={"bucket": bucket,
                                      "pad": bucket - total})
            req._resolve(outputs=per_req)
        with self._cv:
            self._inflight.difference_update(batch)
        self._m_examples.inc(total)
        self._m_batches.inc()
        self._m_batch_size.observe(total)
        self._m_occupancy.observe(total / float(bucket))
        self._m_compute_s.observe(compute_s)

    def fail_batch(self, batch, error, compute_s=None):
        """Resolve every request of ``batch`` with ``error`` and close the
        accounting; a failed batch still counts in the volume metrics."""
        for req in batch:
            req._resolve(error=error)
        with self._cv:
            self._inflight.difference_update(batch)
        total = sum(r.n for r in batch)
        self._m_examples.inc(total)
        self._m_batches.inc()
        self._m_batch_size.observe(total)
        if compute_s is not None:
            self._m_compute_s.observe(compute_s)

    def _dispatch(self, batch, total):
        t0 = time.monotonic()
        try:
            padded, bucket = pad_batch(batch, total, self.buckets)
            t_run = time.monotonic()
            run_wall = time.time()
            outs = self._runner(padded, bucket, total)
            compute_s = time.monotonic() - t_run
            for req in batch:
                _tracing.emit_span("serve.compute", run_wall, compute_s,
                                   req.trace, component="worker",
                                   attrs={"bucket": bucket, "n": total})
            self.resolve_batch(batch, outs, bucket, total,
                               time.monotonic() - t0)
        except ServingError as e:
            self.fail_batch(batch, e, compute_s=time.monotonic() - t0)
        except Exception as e:  # a model failure answers 500, never hangs
            err = ServingError("model %r failed: %r" % (self.name, e))
            err.__cause__ = e
            telemetry.record_event("serve_batch_error", model=self.name,
                                   error=repr(e))
            self.fail_batch(batch, err, compute_s=time.monotonic() - t0)
