"""Device prefetcher: host-to-device copies staged ahead of the consumer
(counterpart of `mxnet_tpu/data/device_prefetch.py`).

``PrefetchBuffer`` overlaps host decode with compute; ``DevicePrefetcher``
also moves the host-to-device copy off the step. Its producer thread, for
each batch the inner iterator yields:

1. copies every host leaf into pinned host memory (so the inner iterator
   may overwrite its own buffers as soon as it is asked for the next
   batch);
2. issues ``.to(device, non_blocking=True)`` of those buffers on a CUDA
   stream of its own;
3. records an event on that stream;
4. reuses a pinned buffer only after the event of the copy that read it
   has completed.

The consumer makes its current stream wait on the batch's event and calls
``record_stream`` on the arrived tensors, so the caching allocator cannot
hand their memory out while the consumer's stream still uses it. The JAX
package gets the same overlap from an asynchronous ``jax.device_put``. On
the CPU the prefetcher is a plain copy.

Cursor semantics: each staged batch carries the inner iterator's
``state()`` snapshot taken right after it was produced; ``state()`` here
returns the snapshot of the last batch the CONSUMER received, so a
checkpoint taken between steps describes exactly the batches the model has
seen, not the batches the pipeline read ahead.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import env as _env
from ..base import MXNetError
from ..context import current_context, in_scope_of, resolve_device
from ..ndarray import NDArray
from .core import PrefetchBuffer

__all__ = ["DevicePrefetcher", "place_batch"]


def _device_of(mesh):
    """The one device of ``mesh`` (None: `current_context`; a device; or a
    sequence of one device, as `parallel.DistributedTrainer` takes)."""
    if mesh is None:
        return current_context()
    if isinstance(mesh, (list, tuple)):
        if len(mesh) != 1:
            raise MXNetError("a mesh of %d devices is not ported yet (one "
                             "card; NCCL comes in a later slice)" % len(mesh))
        mesh = mesh[0]
    return resolve_device(mesh)


def _map_leaves(batch, fn):
    """``batch`` with every array leaf (NDArray, tensor, numpy) replaced by
    ``fn(tensor)``: an NDArray stays an NDArray, a numpy leaf becomes a
    tensor. Handles `io.DataBatch` and nested lists, tuples and dicts;
    anything else passes through."""
    from ..io import DataBatch

    if isinstance(batch, DataBatch):
        return DataBatch(
            data=_map_leaves(batch.data, fn),
            label=_map_leaves(batch.label, fn),
            pad=batch.pad, index=batch.index, bucket_key=batch.bucket_key,
            provide_data=batch.provide_data,
            provide_label=batch.provide_label)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_leaves(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_leaves(v, fn) for k, v in batch.items()}
    if isinstance(batch, NDArray):
        return NDArray(fn(batch._data))
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, _np.ndarray):
        return fn(torch.from_numpy(_np.ascontiguousarray(batch)))
    return batch


def place_batch(batch, mesh=None):
    """Copy every array leaf of ``batch`` to the device of ``mesh`` (see
    `_device_of`) and return the same structure; the copies are finished
    when it returns, so the caller may reuse its buffers."""
    dev = _device_of(mesh)
    return _map_leaves(batch, lambda t: t.to(dev, copy=True))


class _Slot:
    """Pinned host buffers of one batch in flight, and the event recorded
    after the copies that read them."""

    __slots__ = ("bufs", "event")

    def __init__(self):
        self.bufs = []
        self.event = None


class _CardStager:
    """The producer's half on a CUDA device: pinned staging, copies on a
    stream of its own, one event a batch. ``slots`` staging sets are
    reused in turn, each only after its last copy completed."""

    def __init__(self, dev, slots):
        self._dev = dev
        self._stream = torch.cuda.Stream(device=dev)
        self._slots = [_Slot() for _ in range(slots)]
        self._next = 0

    def stage(self, batch):
        slot = self._slots[self._next % len(self._slots)]
        self._next += 1
        if slot.event is not None:
            slot.event.synchronize()   # its last copies have read the bufs
        used = []

        def put(t):
            if t.device == self._dev:
                return t
            if t.device.type != "cpu":
                return t.to(self._dev, non_blocking=True)
            i = len(used)
            buf = slot.bufs[i] if i < len(slot.bufs) else None
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            used.append(buf)
            return buf.to(self._dev, non_blocking=True)

        with torch.cuda.device(self._dev), torch.cuda.stream(self._stream):
            placed = _map_leaves(batch, put)
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.bufs = used
        slot.event = event
        return placed, event

    def arrive(self, placed, event):
        """Order the consumer's current stream after the batch's copies."""
        cur = torch.cuda.current_stream(self._dev)
        cur.wait_event(event)

        def mark(t):
            if t.device == self._dev:
                t.record_stream(cur)
            return t

        _map_leaves(placed, mark)
        return placed


class DevicePrefetcher:
    """Bounded queue of batches already copied to the device, over any
    iterator or DataIter of batches.

    ``depth`` (default ``MXTPU_DATA_PREFETCH_DEPTH``) batches are staged
    ahead by a producer thread. Iterator protocol plus the DataIter surface
    the training loops use (``next`` / ``reset`` / ``provide_data`` /
    ``provide_label``), plus the cursor passthrough (``state`` /
    ``set_state``) when the inner iterator has one. ``mesh``: None (the
    caller's `current_context`), a device, or a sequence of one device."""

    def __init__(self, it, depth=None, mesh=None, src="fit"):
        if depth is None:
            depth = _env.get("MXTPU_DATA_PREFETCH_DEPTH")
        self._it = it
        self._depth = max(1, int(depth))
        self._dev = _device_of(mesh)
        self._src = src
        self.batch_size = getattr(it, "batch_size", 0)
        self._buf = None
        self._stager = None
        self._last_state = None

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label

    def _produce(self):
        batch = next(self._it)
        st = self._it.state() if hasattr(self._it, "state") else None
        if self._stager is None:
            placed = _map_leaves(batch, lambda t: t.to(self._dev, copy=True))
            return st, placed, None
        placed, event = self._stager.stage(batch)
        return st, placed, event

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self._buf is None:
            if self._dev.type == "cuda" and self._stager is None:
                # staged batches in flight: the queue, the one being
                # produced and the one the consumer holds
                self._stager = _CardStager(self._dev, self._depth + 2)
            self._buf = PrefetchBuffer(
                in_scope_of(self._produce), depth=self._depth,
                name="mxtpu-data-device-prefetch",
                owner="DevicePrefetcher", src=self._src)
        st, batch, event = self._buf.get()
        if event is not None:
            batch = self._stager.arrive(batch, event)
        if st is not None:
            # the cursor a checkpoint should record: batches DELIVERED,
            # not batches the pipeline read ahead
            self._last_state = st
        return batch

    def reset(self):
        self.close()
        self._it.reset()

    def close(self):
        """Stop and join the producer."""
        if self._buf is not None:
            self._buf.close()
            self._buf = None

    def state(self):
        if self._last_state is not None:
            return self._last_state
        if hasattr(self._it, "state"):
            return self._it.state()
        raise MXNetError("DevicePrefetcher: inner iterator %r has no "
                         "state()" % (type(self._it).__name__,))

    def set_state(self, st):
        if not hasattr(self._it, "set_state"):
            raise MXNetError("DevicePrefetcher: inner iterator %r has no "
                             "set_state()" % (type(self._it).__name__,))
        self.close()
        self._it.set_state(st)
        self._last_state = None
