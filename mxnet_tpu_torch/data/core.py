"""The shared asynchronous input-pipeline core (counterpart of
`mxnet_tpu/data/core.py`).

One thread/queue implementation behind every prefetching surface of the
port: ``io.PrefetchingIter``, ``image.ImageRecordIterPy``, the gluon
``DataLoader`` threaded path and the device prefetcher
(``data.device_prefetch``). Reference: src/io/iter_prefetcher.h (the
double-buffered prefetcher stage) + src/io/iter_image_recordio_2.cc's
threaded parser pool.

Two primitives:

* ``PrefetchBuffer`` — a single producer thread filling a bounded queue
  (depth = how many batches may be staged ahead). The worker captures the
  queue and stop event as LOCALS (the PR-12 ``PrefetchingIter`` fix): a
  worker that outlives a timed-out close must never feed a successor
  generation's queue, and a cleared live Event must never resurrect its
  loop. Errors travel the queue as data and re-raise at the consumer.
  The producer calls the fault-injection hook
  (``resilience.maybe_inject_data_stall``, ``slow_batch@step=,ms=``)
  with the ordinal of each batch it made.

* ``DecodePool`` — a pipelined decode/augment stage: one feeder thread
  pulls the (not thread-safe) source sequentially, N ``mxtpu-data-worker``
  threads decode in parallel, and delivery is re-sequenced so the consumer
  sees source order deterministically. In-flight work is bounded by a
  semaphore the consumer releases, so an abandoned consumer backpressures
  the whole pipeline instead of buffering the dataset.

Both stop the same way: set the stop event, drain, join within
``MXTPU_DATA_JOIN_TIMEOUT_S``, and raise ``MXNetError`` if a worker cannot
be joined — proceeding would rewind reader state under a live reader.
"""
from __future__ import annotations

import queue
import threading
import time

from .. import env as _env
from .. import telemetry
from ..base import MXNetError

__all__ = ["PrefetchBuffer", "DecodePool"]

# queue sentinel marking normal end-of-stream (StopIteration in the
# producer); module-private on purpose — it must never be a legal payload
_END = object()


class _Raised:
    """Error envelope: a producer exception travels the queue as data and
    re-raises at the consumer (a bare Exception instance must stay a legal
    payload for producers that yield exceptions as values)."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


def join_timeout():
    """Seconds close()/reset() wait for pipeline threads to stop."""
    return float(_env.get("MXTPU_DATA_JOIN_TIMEOUT_S"))


def _put_bounded(q, item, stop):
    """Bounded put that honors the stop signal; False if stopped first."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class PrefetchBuffer:
    """Single-producer bounded prefetch queue.

    ``produce`` is called repeatedly on a background thread; items are
    staged in a queue of ``depth`` so the consumer's ``get()`` overlaps
    with production of the next items. ``StopIteration`` from ``produce``
    ends the stream (``get()`` raises it to the consumer); any other
    exception is re-raised at the consumer's next ``get()``.

    ``get()`` also attributes each delivery as a prefetch *hit* (item was
    already staged — the pipeline kept up) or *miss* (the consumer
    blocked — production is the bottleneck), exported as the
    ``mxtpu_data_prefetch_{hits,misses}_total{src=...}`` counters.
    """

    def __init__(self, produce, depth=2, name="mxtpu-data-prefetch",
                 owner="PrefetchBuffer", src="data"):
        self._produce = produce
        self._depth = max(1, int(depth))
        self._name = name
        self._owner = owner
        self._hits = telemetry.counter("mxtpu_data_prefetch_hits_total",
                                       {"src": src})
        self._misses = telemetry.counter("mxtpu_data_prefetch_misses_total",
                                         {"src": src})
        self._thread = None
        self._stop = None
        self._queue = None
        self._finished = False
        self._start()

    @property
    def depth(self):
        return self._depth

    def _start(self):
        # capture-as-local: the worker must never read self._queue /
        # self._stop live — a stale worker surviving a timed-out close
        # would otherwise feed the NEXT generation's queue
        self._stop = stop = threading.Event()
        self._queue = q = queue.Queue(maxsize=self._depth)
        self._finished = False
        produce = self._produce

        def run():
            from ..parallel import resilience

            n = 0
            while not stop.is_set():
                try:
                    item = produce()
                except StopIteration:
                    _put_bounded(q, _END, stop)
                    return
                except Exception as e:
                    _put_bounded(q, _Raised(e), stop)
                    return
                n += 1
                # the producer-side chaos hook (one cached check unless
                # MXTPU_FAULT_INJECT is set): a stall of production that a
                # buffer of depth x step time absorbs
                resilience.maybe_inject_data_stall(n)
                if not _put_bounded(q, item, stop):
                    return

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=self._name)
        self._thread.start()

    def get(self):
        """Next produced item; raises StopIteration at end-of-stream and
        re-raises producer errors."""
        if self._finished:
            raise StopIteration
        try:
            item = self._queue.get_nowait()
            self._hits.inc()
        except queue.Empty:
            self._misses.inc()
            item = self._queue.get()
        if item is _END:
            self._finished = True
            raise StopIteration
        if isinstance(item, _Raised):
            self._finished = True
            raise item.exc
        return item

    def close(self):
        """Stop + join the producer (draining the queue so a blocked put
        wakes up). Raises MXNetError when the worker cannot be joined —
        the caller must NOT rewind reader state under a live reader."""
        if self._thread is None:
            return
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        timeout = join_timeout()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise MXNetError(
                "%s: prefetch worker did not stop within %.0fs (stalled "
                "read?); cannot safely rewind" % (self._owner, timeout))
        self._thread = None

    def restart(self):
        """Start a fresh producer generation (after close() + the caller
        rewinding its source)."""
        if self._thread is not None:
            raise MXNetError("%s: restart() before close()" % self._owner)
        self._start()


class _PoolGen:
    """One DecodePool generation's shared state. Every pipeline thread
    captures the generation object as a local at spawn (capture-as-local):
    a reset swaps in a whole new generation, so a straggler thread from a
    timed-out close can only ever touch its own dead generation."""

    __slots__ = ("cv", "stop", "tasks", "results", "slots", "end_seq",
                 "next_seq")

    def __init__(self, depth, workers):
        self.cv = threading.Condition()
        self.stop = threading.Event()
        # feeder -> workers; bounded so the feeder cannot race ahead
        self.tasks = queue.Queue(maxsize=depth)
        # seq -> decoded item (or _Raised); delivery re-sequences on seq
        self.results = {}
        # total in-flight items (queued + decoding + decoded-undelivered):
        # acquired by the feeder per record, released by the consumer per
        # delivery — the end-to-end backpressure bound
        self.slots = threading.Semaphore(depth + workers)
        self.end_seq = None   # set (under cv) when the source is exhausted
        self.next_seq = 0     # next sequence number the consumer delivers


def _pool_feed(gen, source, nworkers):
    """Feeder thread: pulls the source sequentially (record readers are
    not thread-safe), tags records with sequence numbers, and fans them
    out to the workers."""
    seq = 0
    while not gen.stop.is_set():
        if not gen.slots.acquire(timeout=0.1):
            continue
        try:
            raw = source()
        except StopIteration:
            gen.slots.release()
            break
        except Exception as e:
            # source errors are ordered like data: delivered at this seq,
            # after every earlier record, then the stream ends
            with gen.cv:
                gen.results[seq] = _Raised(e)
                gen.cv.notify_all()
            seq += 1
            break
        if not _put_bounded(gen.tasks, (seq, raw), gen.stop):
            return
        seq += 1
    with gen.cv:
        gen.end_seq = seq
        gen.cv.notify_all()
    for _ in range(nworkers):
        _put_bounded(gen.tasks, _END, gen.stop)


def _pool_work(gen, decode):
    """Worker thread: decode records; errors become that record's result
    so the consumer sees them at the deterministic source position."""
    while not gen.stop.is_set():
        try:
            task = gen.tasks.get(timeout=0.1)
        except queue.Empty:
            continue
        if task is _END:
            return
        seq, raw = task
        try:
            item = decode(raw)
        except Exception as e:
            item = _Raised(e)
        with gen.cv:
            gen.results[seq] = item
            gen.cv.notify_all()


class DecodePool:
    """Pipelined decode stage: N parallel workers, source-order delivery.

    ``source()`` returns the next raw record (StopIteration at end);
    ``decode(raw)`` runs on the worker threads. ``get()`` returns decoded
    items in exact source order regardless of which worker finished first
    — determinism the shuffle/cursor machinery depends on.
    """

    def __init__(self, source, decode, workers=1, depth=2,
                 name="mxtpu-data-worker", owner="DecodePool"):
        self._source = source
        self._decode = decode
        self._workers = max(1, int(workers))
        self._depth = max(1, int(depth))
        self._name = name
        self._owner = owner
        self._gen = None
        self._threads = ()

    @property
    def workers(self):
        return self._workers

    def _start(self):
        gen = _PoolGen(self._depth, self._workers)
        source, decode, nworkers = self._source, self._decode, self._workers
        threads = [threading.Thread(
            target=_pool_feed, args=(gen, source, nworkers), daemon=True,
            name="mxtpu-data-feeder")]
        for i in range(nworkers):
            threads.append(threading.Thread(
                target=_pool_work, args=(gen, decode), daemon=True,
                name="%s-%d" % (self._name, i)))
        for t in threads:
            t.start()
        self._gen = gen
        self._threads = tuple(threads)

    def get(self):
        """Next decoded item in source order; StopIteration at the end,
        decode/source errors re-raised at their source position."""
        if self._gen is None:
            self._start()
        gen = self._gen
        with gen.cv:
            while True:
                if gen.next_seq in gen.results:
                    item = gen.results.pop(gen.next_seq)
                    gen.next_seq += 1
                    gen.slots.release()
                    if isinstance(item, _Raised):
                        raise item.exc
                    return item
                if gen.end_seq is not None and gen.next_seq >= gen.end_seq:
                    raise StopIteration
                gen.cv.wait(timeout=0.5)

    def close(self):
        """Stop + join feeder and workers; MXNetError if any survive the
        join window (the caller must not rewind the source under them)."""
        gen = self._gen
        if gen is None:
            return
        gen.stop.set()
        try:
            while True:
                gen.tasks.get_nowait()
        except queue.Empty:
            pass
        with gen.cv:
            gen.cv.notify_all()
        timeout = join_timeout()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.05, deadline - time.monotonic()))
        if any(t.is_alive() for t in self._threads):
            raise MXNetError(
                "%s: decode pipeline did not stop within %.0fs (stalled "
                "read?); cannot safely rewind" % (self._owner, timeout))
        self._gen = None
        self._threads = ()

    def reset(self):
        """Stop the pipeline; the next get() starts a fresh generation
        (the caller rewinds the source in between)."""
        self.close()
