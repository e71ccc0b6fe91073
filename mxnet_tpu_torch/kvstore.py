"""The key-value store (counterpart of `mxnet_tpu/kvstore.py`; reference:
python/mxnet/kvstore.py:97 and src/kvstore/kvstore.cc:40-72).

`KVStore` keeps one dense value a key on the device it was initialized
on. `push` sums the values given for a key in their order (row_sparse
ones with `ndarray.sparse.add`, over the union of their rows), quantizes
dense ones first when 2-bit gradient compression is set (a residual a key
and `Context`), and then either runs the installed updater
(`set_optimizer`, `set_updater`: the reference's update on the kvstore)
or stores the sum. `pull` copies the value into dense outputs;
`row_sparse_pull` gives the requested rows, as a row_sparse array over
those rows into a row_sparse output and as the gathered rows into a dense
one.

`_DistKVStore` (every ``dist_*`` name but ``dist_async``, ``horovod``,
``tpu``; the JAX package's ``_DistKVStore``, kvstore.py:264-326) is the
same store across the processes of `parallel.collectives`' group, which
making it joins (bounded by ``MXTPU_RENDEZVOUS_TIMEOUT``; a missing peer
raises `MXNetError`). Its `init` hands every rank rank 0's value; its
`push` sums this process's values, then the ranks' sums in rank order (an
all-gather and a sum, as `collectives.all_reduce_arrays` adds them), so
every rank stores the same bits, and only then runs the updater. A
row_sparse push is summed dense across ranks (the store is dense). Over
gloo a card tensor goes through the host, as it must when ranks share a
card; over NCCL it stays on the card. In one process it is the local
store, rank 0 of 1. ``dist_async`` raises, as in the JAX package: the
asynchronous parameter server is not reproduced.

`create` makes one for ``local``, ``device``, ``nccl`` and the
``local_*`` names, and a `_DistKVStore` for the distributed ones.
"""
from __future__ import annotations

from .base import MXNetError, atomic_writer
from .ndarray import NDArray
from .ndarray.sparse import (BaseSparseNDArray, RowSparseNDArray,
                             add as _sparse_add)
from .telemetry.core import counter as _tm_counter

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu",
          "local_allreduce_device", "device", "nccl")
_DIST = ("dist_sync", "dist_device_sync", "dist_sync_device", "horovod",
         "tpu")


def _key_list(key):
    if isinstance(key, (list, tuple)):
        return list(key), True
    return [key], False


def _group_vals(vals, nkeys, batched):
    """Push / pull values as a list (one a key) of lists of NDArrays."""
    if not batched:
        vals = [vals]
    out = [[v] if isinstance(v, NDArray) else list(v) for v in vals]
    if len(out) != nkeys:
        raise MXNetError("number of keys != number of value groups")
    return out


class KVStore:
    """In-process key-value store (see the module docstring)."""

    def __init__(self, name="local"):
        self._type = name
        self._store = {}          # key -> dense NDArray
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._compression_params = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        """This process's rank (reference: kvstore.py:513): one process."""
        return 0

    @property
    def num_workers(self):
        """reference: kvstore.py:526: one process."""
        return 1

    def _value(self, k):
        if k not in self._store:
            raise MXNetError("key %r has not been initialized" % (k,))
        return self._store[k]

    def init(self, key, value):
        """Initialize each key with its value, once (reference:
        kvstore.py:138); a sparse value is stored dense."""
        keys, batched = _key_list(key)
        for k, vgroup in zip(keys, _group_vals(value, len(keys), batched)):
            if k in self._store:
                continue
            self._store[k] = vgroup[0].tostype("default").copy()
            if self._compression is not None:
                self._compression.reset(k)

    def push(self, key, value, priority=0):
        """Sum the values of each key into the store, or hand the sum to
        the updater (reference: kvstore.py:160)."""
        keys, batched = _key_list(key)
        vals = _group_vals(value, len(keys), batched)
        _tm_counter("mxtpu_kvstore_ops_total", {"op": "push"}).inc(len(keys))
        for k, vgroup in zip(keys, vals):
            stored = self._value(k)
            merged = self._merge(k, vgroup)
            if self._updater is not None:
                self._updater(k, merged, stored)
            else:
                stored._set_data(merged.tostype("default")
                                 .as_in_context(stored.context)._data)

    def _merge(self, k, vgroup):
        """The sum of this process's values for key ``k``, in their
        order."""
        if self._compression is not None \
                and not isinstance(vgroup[0], BaseSparseNDArray):
            # one residual a (key, context): stable whatever the number or
            # order of the values pushed (reference: a residual a worker,
            # kvstore_dist.h gc_->Quantize)
            vgroup = [self._compression.quantize((k, v.context), v)
                      for v in vgroup]
        merged = vgroup[0]
        for v in vgroup[1:]:
            if isinstance(merged, BaseSparseNDArray) \
                    or isinstance(v, BaseSparseNDArray):
                merged = _sparse_add(merged, v)
            else:
                merged = merged + v.as_in_context(merged.context)
        return merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's value into its dense outputs (reference:
        kvstore.py:240); a sparse output is skipped (``ignore_sparse``) or
        refused: it takes `row_sparse_pull`."""
        keys, batched = _key_list(key)
        outs = _group_vals(out, len(keys), batched)
        _tm_counter("mxtpu_kvstore_ops_total", {"op": "pull"}).inc(len(keys))
        for k, ogroup in zip(keys, outs):
            src = self._value(k)
            for o in ogroup:
                if isinstance(o, BaseSparseNDArray):
                    if ignore_sparse:
                        continue
                    raise MXNetError("pull into a sparse array is not "
                                     "supported; use row_sparse_pull (as "
                                     "in the reference, kvstore.py:240)")
                o._set_data(src._data.to(o._data.device))

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """The rows ``row_ids`` of each key's value (reference:
        kvstore.py:314): into a row_sparse output, a row_sparse array of
        the value's shape over those rows (sorted, repeats dropped); into
        a dense output, the gathered rows in the order asked."""
        if row_ids is None:
            raise MXNetError("row_ids is required for row_sparse_pull")
        keys, batched = _key_list(key)
        outs = _group_vals(out, len(keys), batched)
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        if len(rids) == 1 and len(outs[0]) > 1:
            rids = rids * len(outs[0])
        for k, ogroup in zip(keys, outs):
            src = self._value(k)
            for o, rid in zip(ogroup, rids):
                rows = rid._data.to(src._data.device).long().reshape(-1)
                if isinstance(o, RowSparseNDArray):
                    rows = rows.unique()   # sorted
                    dev = o._device
                    o._assign(RowSparseNDArray._new(
                        {"data": src._data.index_select(0, rows).to(dev),
                         "indices": rows.to(dev, o._data["indices"].dtype)},
                        src.shape))
                else:
                    o._set_data(src._data.index_select(0, rows)
                                .to(o._data.device))

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority=priority)
        self.pull(key, out=out if out is not None else value,
                  priority=priority)

    def set_updater(self, updater):
        """Run ``updater(key, pushed, stored)`` at each push (reference:
        kvstore.py:420)."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Update with ``optimizer`` at each push (reference:
        kvstore.py:450; the reference's server update, in process here)."""
        from . import optimizer as opt

        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit compression of every dense pushed value, with error
        feedback (reference: kvstore.py:398); ``{"type": "none"}`` turns
        it off."""
        from .gradient_compression import GradientCompression

        params = dict(compression_params)
        self._compression_params = params
        self._compression = None if params.get("type", "2bit") == "none" \
            else GradientCompression(**params)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The updater's states, written atomically (reference:
        kvstore.py:482)."""
        if self._updater is None:
            raise MXNetError("no optimizer installed on this kvstore")
        with atomic_writer(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer installed on this kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        """One process: wait for the stored values' pending work."""
        for v in self._store.values():
            v.wait_to_read()

    def _send_command_to_servers(self, head, body):
        """No servers in one process."""

    def __repr__(self):
        return "KVStore(type=%s, keys=%d)" % (self._type, len(self._store))


class _DistKVStore(KVStore):
    """The synchronous store across the processes of the group (see the
    module docstring)."""

    def __init__(self, name="dist_sync"):
        super().__init__(name)
        from .parallel import collectives

        # a worker that never called init_process_group joins here, and a
        # peer that never arrives raises within MXTPU_RENDEZVOUS_TIMEOUT
        collectives.init_process_group()
        self._collectives = collectives

    @property
    def rank(self):
        """This process's rank in the group (reference: kvstore.py:513)."""
        return self._collectives.rank()

    @property
    def num_workers(self):
        """The group's size (reference: kvstore.py:526)."""
        return self._collectives.num_workers()

    def init(self, key, value):
        """As `KVStore.init`, with rank 0's value on every rank (the
        reference's server keeps worker 0's init): ranks that drew their
        initial values apart train one replica."""
        keys, _ = _key_list(key)
        new = [k for k in keys if k not in self._store]
        super().init(key, value)
        if self.num_workers > 1:
            for k in new:
                stored = self._store[k]
                stored._set_data(self._collectives.broadcast_arrays(
                    stored._data, [stored._data.device])[0])

    def _merge(self, k, vgroup):
        """This process's sum, then the ranks' sums in rank order."""
        merged = super()._merge(k, vgroup)
        if self.num_workers > 1:
            if isinstance(merged, BaseSparseNDArray):
                merged = merged.tostype("default")
            merged = NDArray(self._collectives.all_reduce_arrays(
                [merged._data])[0], merged._ctx)
        return merged

    def barrier(self):
        """Every rank waits for every other (reference: kvstore.h:364)."""
        super().barrier()
        self._collectives.barrier()

    def _send_command_to_servers(self, head, body):
        """No servers: every process is a worker (`kvstore_server`)."""


def create(name="local"):
    """A kvstore of type ``name`` (reference: src/kvstore/kvstore.cc:40-72):
    the single-process store for the local names, `_DistKVStore` for the
    distributed ones; ``dist_async`` raises."""
    if not isinstance(name, str):
        raise MXNetError("name must be str")
    name = name.lower()
    if name in _LOCAL:
        return KVStore(name)
    if name in _DIST:
        return _DistKVStore(name)
    if name.startswith("dist_async"):
        raise MXNetError(
            "dist_async is not supported by the TPU backend: asynchronous "
            "parameter-server semantics were replaced by synchronous XLA "
            "collectives (see SURVEY.md §2.3). Use dist_sync.")
    raise MXNetError("unknown kvstore type %r" % (name,))
