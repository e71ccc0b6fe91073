"""DataLoader (counterpart of `mxnet_tpu/gluon/data/dataloader.py`;
reference: python/mxnet/gluon/data/dataloader.py:98-120).

- ``num_workers=0`` loads in the calling thread: samples are made where
  the dataset makes them (an image decoded by `image.imdecode` lands on
  `current_context`, the card by default) and stacked there.
- ``num_workers>0`` decodes and transforms in worker *processes*
  (Python-side decode and augmentation hold the GIL, so threads cannot
  scale them), forked by default (``MXTPU_DATALOADER_CTX``). A worker
  never touches CUDA: it runs under ``context.scope(cpu())``, so its
  NDArrays are host tensors, and it hands each batch back as numpy in
  POSIX shared memory. Before any torch op it calls
  ``torch.set_num_threads(1)`` (a fork taken while torch's OpenMP pool is
  live can deadlock the child) and it restores SIGTERM's default action,
  so ``Pool.terminate`` ends it even when the parent had installed a
  handler. The parent copies each batch out of shared memory into pinned
  memory and from there to `current_context` (non-blocking on the card).
- At the pool's creation one sample is fetched inside a real worker; a
  dataset that cannot be unpickled there or returns card arrays (it holds
  CUDA tensors) makes the loader warn and load on a thread instead.
- ``thread_pool=True`` loads on one `data.PrefetchBuffer` thread.
- ``timeout`` (default ``MXTPU_DATALOADER_TIMEOUT``) bounds the wait for a
  worker's batch: a dead or stuck worker raises `MXNetError` instead of
  hanging the loop.
"""
from __future__ import annotations

import atexit
import logging
import pickle
import signal
import time

import numpy as _np
import torch

from ... import context as _context
from ... import env as _env
from ... import telemetry
from ...base import MXNetError
from ...ndarray import NDArray, array, stack
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference: dataloader.py
    default_batchify_fn): NDArrays stacked where they lie, tuples field by
    field, anything else through numpy (float64 as float32) onto
    `current_context`."""
    if isinstance(data[0], NDArray):
        return stack(*data, axis=0)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = _np.asarray(data)
    return array(data, dtype=data.dtype if data.dtype != _np.float64
                 else "float32")


# ---------------------------------------------------------------------------
# worker-process machinery
# ---------------------------------------------------------------------------

def _np_batchify(data):
    """Worker-side batchify: `default_batchify_fn`'s stacking, into plain
    numpy."""
    first = data[0]
    if isinstance(first, NDArray):
        return _np.stack([d.asnumpy() for d in data])
    if isinstance(first, (tuple, list)):
        return tuple(_np_batchify(list(f)) for f in zip(*data))
    arr = _np.asarray(data)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    return arr


def _to_shm(obj, segments):
    """Replace the numpy arrays of a (nested tuple) batch by shared-memory
    descriptors; the segments made collect into ``segments``."""
    from multiprocessing import resource_tracker, shared_memory

    if isinstance(obj, tuple):
        return tuple(_to_shm(o, segments) for o in obj)
    assert isinstance(obj, _np.ndarray)
    if obj.nbytes == 0:
        return ("__nd0__", obj.shape, obj.dtype.str, None)
    shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
    view = _np.ndarray(obj.shape, dtype=obj.dtype, buffer=shm.buf)
    view[:] = obj
    # ownership passes to the parent, which unlinks after its copy; this
    # process's resource tracker would unlink it a second time at exit
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass
    segments.append(shm)
    return ("__nd__", obj.shape, obj.dtype.str, shm.name)


def _is_desc(desc):
    return isinstance(desc, tuple) and len(desc) == 4 and \
        desc[0] in ("__nd__", "__nd0__")


def _from_shm(desc, dev):
    """Parent side: NDArrays on ``dev`` from shm descriptors; each segment
    is copied (into pinned memory for a card) and released."""
    from multiprocessing import shared_memory

    if not _is_desc(desc):
        return [_from_shm(d, dev) for d in desc]
    tag, shape, dtype, name = desc
    if tag == "__nd0__":
        return NDArray(torch.from_numpy(_np.empty(shape, _np.dtype(dtype)))
                       .to(dev))
    shm = shared_memory.SharedMemory(name=name)
    try:
        view = torch.from_numpy(_np.ndarray(shape, dtype=_np.dtype(dtype),
                                            buffer=shm.buf))
        host = torch.empty(view.shape, dtype=view.dtype,
                           pin_memory=dev.type == "cuda")
        host.copy_(view)
        del view   # no export of the segment may outlive its close
    finally:
        shm.close()
        shm.unlink()
    if dev.type == "cuda":
        # the caching host allocator keeps the pinned block until this
        # copy completes
        return NDArray(host.to(dev, non_blocking=True))
    return NDArray(host)


def _unlink_desc(desc):
    """Release the segments of a batch nobody consumed."""
    from multiprocessing import shared_memory

    if _is_desc(desc):
        if desc[3] is not None:
            try:
                shm = shared_memory.SharedMemory(name=desc[3])
                shm.close()
                shm.unlink()
            except Exception:
                pass
        return
    for d in desc:
        _unlink_desc(d)


# one worker process's state, set by its initializer
_WORKER = {}


def _worker_initializer(dataset_bytes, batchify_bytes):
    """Runs once in each worker process, before any torch op."""
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    torch.set_num_threads(1)
    scope = _context.scope(_context.cpu())
    scope.__enter__()   # for the life of the process: host arrays only
    _WORKER["scope"] = scope
    try:
        _WORKER["dataset"] = pickle.loads(dataset_bytes)
        _WORKER["batchify"] = pickle.loads(batchify_bytes) \
            if batchify_bytes else None
    except Exception as e:   # reported by the probe, not by a dead pool
        _WORKER["error"] = e


def _on_card(x):
    if isinstance(x, NDArray):
        return x.context.type != "cpu"
    if isinstance(x, torch.Tensor):
        return x.device.type != "cpu"
    if isinstance(x, (tuple, list)):
        return any(_on_card(i) for i in x)
    return False


def _worker_probe():
    """Runs INSIDE a worker: whether one sample loads there and is host
    data."""
    if "error" in _WORKER:
        return False
    try:
        return not _on_card(_WORKER["dataset"][0])
    except Exception:
        return False


def _host_safe_probe(dataset, pool_factory, timeout=None):
    """(True, pool) when the dataset pickles and one sample round-trips
    through a real worker as host data within ``timeout``
    (``MXTPU_DATALOADER_PROBE_TIMEOUT``); else (False, None)."""
    if timeout is None:
        timeout = _env.get("MXTPU_DATALOADER_PROBE_TIMEOUT")
    try:
        pickle.dumps(dataset)
    except Exception:
        return False, None
    pool = pool_factory()
    try:
        ok = bool(pool.apply_async(_worker_probe).get(timeout=timeout))
    except Exception:
        ok = False
    if not ok:
        pool.terminate()
        pool.join()
        pool = None
    return ok, pool


def _worker_fn(indices):
    dataset, batchify = _WORKER["dataset"], _WORKER["batchify"]
    samples = [dataset[i] for i in indices]
    if batchify is not None:
        def to_np(b):
            if isinstance(b, NDArray):
                return b.asnumpy()
            if isinstance(b, (list, tuple)):
                return tuple(to_np(x) for x in b)
            return _np.asarray(b)

        batch = to_np(batchify(samples))
    else:
        batch = _np_batchify(samples)
    segments = []
    desc = _to_shm(batch if isinstance(batch, tuple) else (batch,), segments)
    single = not isinstance(batch, tuple)
    for s in segments:
        s.close()   # the parent unlinks
    return single, desc


class _MultiWorkerIter:
    """Ordered iterator over a process pool (reference: dataloader.py
    _MultiWorkerIter): ``prefetch`` batches requested ahead, delivered in
    batch order."""

    def __init__(self, pool, batch_sampler, prefetch, timeout):
        self._pool = pool
        self._batches = iter(batch_sampler)
        self._pending = {}
        self._sent = 0
        self._recv = 0
        self._exhausted = False
        self._timeout = timeout
        for _ in range(max(1, prefetch)):
            self._push_next()

    def _push_next(self):
        if self._exhausted:
            return
        try:
            batch = next(self._batches)
        except StopIteration:
            self._exhausted = True
            return
        self._pending[self._sent] = self._pool.apply_async(
            _worker_fn, (list(batch),))
        self._sent += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._recv == self._sent and self._exhausted:
            raise StopIteration
        result = self._pending.pop(self._recv)
        self._recv += 1
        self._push_next()
        try:
            single, desc = result.get(timeout=self._timeout)
        except Exception as e:
            self.close()
            raise MXNetError(
                "DataLoader worker batch did not arrive within %.0fs "
                "(worker died or is stuck; raise the timeout for very slow "
                "pipelines): %r" % (self._timeout, e)) from e
        out = _from_shm(desc, _context.current_context())
        return out[0] if single else out

    def close(self):
        """Unlink the segments of batches produced but never consumed (an
        iterator abandoned mid-epoch must not leak /dev/shm)."""
        self._exhausted = True
        for idx in sorted(self._pending):
            result = self._pending.pop(idx)
            try:
                _, desc = result.get(timeout=self._timeout)
                _unlink_desc(desc)
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DataLoader:
    """Batches of a `Dataset` (reference: dataloader.py DataLoader); see the
    module docstring for the worker modes. `close` ends the worker pool."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, ctx=None, timeout=None):
        self._mp_ctx = ctx or _env.get("MXTPU_DATALOADER_CTX")
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size required when batch_sampler "
                                 "is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError("batch_size/shuffle/sampler/last_batch "
                             "incompatible with batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._custom_batchify = batchify_fn
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._timeout = float(timeout if timeout is not None
                              else _env.get("MXTPU_DATALOADER_TIMEOUT"))
        self._pool = None
        self._host_safe = None

    def __len__(self):
        return len(self._batch_sampler)

    def _load(self, batch_indices):
        return self._batchify_fn([self._dataset[i] for i in batch_indices])

    def _make_pool(self):
        import multiprocessing as mp

        ctx = mp.get_context(self._mp_ctx)
        return ctx.Pool(
            self._num_workers, initializer=_worker_initializer,
            initargs=(pickle.dumps(self._dataset),
                      pickle.dumps(self._custom_batchify)
                      if self._custom_batchify else b""))

    def _adopt(self, pool):
        self._pool = pool
        # terminate at exit while the interpreter is intact
        atexit.register(pool.terminate)

    def close(self):
        """Terminate and join the worker processes."""
        pool, self._pool = self._pool, None
        if pool is not None:
            atexit.unregister(pool.terminate)
            pool.terminate()
            pool.join()

    def __del__(self):
        try:
            if self._pool is not None:
                self._pool.terminate()
        except Exception:
            pass   # interpreter teardown: pool internals may be gone

    def __iter__(self):
        """Yields the batches while counting the seconds this consumer
        waited for each (``mxtpu_data_wait_seconds_total``) and held it
        (``mxtpu_data_compute_seconds_total``), ``src="dataloader"``."""
        tm_wait = telemetry.counter("mxtpu_data_wait_seconds_total",
                                    {"src": "dataloader"})
        tm_compute = telemetry.counter("mxtpu_data_compute_seconds_total",
                                       {"src": "dataloader"})
        tm_batches = telemetry.counter("mxtpu_data_batches_total",
                                       {"src": "dataloader"})
        inner = self._iter_raw()
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(inner)
            except StopIteration:
                return
            t1 = time.perf_counter()
            tm_wait.inc(t1 - t0)
            tm_batches.inc()
            yield batch
            tm_compute.inc(time.perf_counter() - t1)

    def _iter_raw(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._load(batch)
            return
        if self._thread_pool:
            yield from self._iter_threaded()
            return
        if self._host_safe is None:
            self._host_safe, pool = _host_safe_probe(self._dataset,
                                                     self._make_pool)
            if pool is not None:
                self._adopt(pool)
            if not self._host_safe:
                logging.warning(
                    "DataLoader(num_workers=%d): the dataset does not load "
                    "as host data in a worker process (unpicklable, or it "
                    "holds card tensors); loading on a thread instead.",
                    self._num_workers)
        if not self._host_safe:
            yield from self._iter_threaded()
            return
        if self._pool is None:
            self._adopt(self._make_pool())
        it = _MultiWorkerIter(self._pool, self._batch_sampler,
                              self._prefetch, self._timeout)
        try:
            yield from it
        finally:
            it.close()

    def _iter_threaded(self):
        from ...data.core import PrefetchBuffer

        batches = iter(self._batch_sampler)

        def produce():
            return self._load(next(batches))

        buf = PrefetchBuffer(_context.in_scope_of(produce),
                             depth=self._prefetch or 2,
                             name="mxtpu-dataloader-prefetch",
                             owner="DataLoader", src="dataloader")
        try:
            while True:
                try:
                    yield buf.get()
                except StopIteration:
                    return
        finally:
            buf.close()
