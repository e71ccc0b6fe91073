"""Sharded RecordIO streaming with a checkpointable cursor (counterpart of
`mxnet_tpu/data/sharded_stream.py`).

Reference: the distributed split of src/io/iter_image_recordio_2.cc
(part_index/num_parts record partitioning):

* **static file ownership** — rank ``r`` of ``world`` owns
  ``files[r::world]``. When ``world > len(files)`` the ranks sharing file
  ``f`` stride its index (``keys[sub::nsub]``), so every record is owned
  by exactly one rank per epoch at any world size — no central iterator,
  no handshake.
* **deterministic per-epoch shuffle** — the epoch's record order is a
  pure function of ``(seed, epoch)``; every generation of a restarted
  rank reproduces it exactly, which is what makes the cursor meaningful,
  and it is the JAX package's order for the same files.
* **checkpointable cursor** — ``state()``/``set_state()`` capture
  (epoch, position), so a resume re-enters the SAME epoch order at the
  exact record boundary instead of blindly fast-forwarding.

`StreamDataIter` batches are host (CPU) NDArrays.
"""
from __future__ import annotations

import os

import numpy as _np

from ..base import MXNetError
import torch

from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import NDArray

__all__ = ["ShardedRecordStream", "StreamDataIter"]


def _epoch_rng(seed, epoch):
    # mixed so (seed, epoch) pairs land on distinct streams; modulo keeps
    # it a legal RandomState seed
    return _np.random.RandomState((seed * 1000003 + epoch) % (2 ** 32))


class ShardedRecordStream:
    """This rank's deterministic stream of RecordIO records.

    ``files`` — list of ``.rec`` paths (each needs its ``.idx`` sibling:
    striding and shuffle are random-access) or explicit ``(idx, rec)``
    pairs. One instance per rank; ranks never communicate."""

    def __init__(self, files, rank=0, world=1, shuffle=False, seed=0):
        if not files:
            raise MXNetError("ShardedRecordStream: no record files")
        if not 0 <= rank < world:
            raise MXNetError("ShardedRecordStream: rank %d outside world %d"
                             % (rank, world))
        self._files = []
        for f in files:
            if isinstance(f, (tuple, list)):
                idx_path, rec_path = f
            else:
                rec_path = f
                idx_path = os.path.splitext(f)[0] + ".idx"
            if not os.path.exists(idx_path):
                raise MXNetError(
                    "ShardedRecordStream: %s has no index file %s (striding "
                    "and shuffle need random access)" % (rec_path, idx_path))
            self._files.append((idx_path, rec_path))
        self.rank = int(rank)
        self.world = int(world)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        nfiles = len(self._files)
        if self.world <= nfiles:
            # whole files, strided over ranks
            self._owned = [(i, 0, 1) for i in range(self.rank, nfiles,
                                                    self.world)]
        else:
            # more ranks than files: the ranks sharing file f stride its
            # key list — still exactly-once coverage per epoch
            f = self.rank % nfiles
            nsub = (self.world - f - 1) // nfiles + 1
            self._owned = [(f, self.rank // nfiles, nsub)]
        self._readers = {}
        self._keys = {}
        self._epoch = 0
        self._pos = 0
        self._order = self._build_order(0)

    def _reader(self, file_idx):
        r = self._readers.get(file_idx)
        if r is None:
            from .. import recordio

            idx_path, rec_path = self._files[file_idx]
            r = recordio.MXIndexedRecordIO(idx_path, rec_path, "r")
            self._readers[file_idx] = r
        return r

    def _file_keys(self, file_idx):
        keys = self._keys.get(file_idx)
        if keys is None:
            keys = list(self._reader(file_idx).keys)
            self._keys[file_idx] = keys
        return keys

    def _build_order(self, epoch):
        order = [(fi, k) for fi, sub, nsub in self._owned
                 for k in self._file_keys(fi)[sub::nsub]]
        if self.shuffle:
            perm = _epoch_rng(self.seed, epoch).permutation(len(order))
            order = [order[i] for i in perm]
        return order

    def __len__(self):
        return len(self._order)

    @property
    def epoch(self):
        return self._epoch

    @property
    def position(self):
        return self._pos

    def next_record(self):
        """Raw bytes of the next owned record; StopIteration ends the
        epoch (advance_epoch() starts the next one)."""
        if self._pos >= len(self._order):
            raise StopIteration
        file_idx, key = self._order[self._pos]
        self._pos += 1
        return self._reader(file_idx).read_idx(key)

    def advance_epoch(self):
        self._epoch += 1
        self._pos = 0
        self._order = self._build_order(self._epoch)

    def state(self):
        """Checkpointable cursor (JSON-safe)."""
        return {"version": 1, "epoch": self._epoch, "pos": self._pos,
                "seed": self.seed, "rank": self.rank, "world": self.world,
                "nfiles": len(self._files)}

    def set_state(self, st):
        """Restore a cursor. The topology must match — a cursor taken at a
        different (rank, world, file-set, seed) indexes a DIFFERENT record
        order, and silently resuming there would double/drop records."""
        for key, mine in (("rank", self.rank), ("world", self.world),
                          ("seed", self.seed),
                          ("nfiles", len(self._files))):
            if int(st.get(key, mine)) != mine:
                raise MXNetError(
                    "ShardedRecordStream.set_state: cursor %s=%s does not "
                    "match this stream's %s=%s — resuming it here would "
                    "break exactly-once coverage" % (key, st.get(key), key,
                                                     mine))
        self._epoch = int(st["epoch"])
        self._order = self._build_order(self._epoch)
        pos = int(st["pos"])
        if not 0 <= pos <= len(self._order):
            raise MXNetError("ShardedRecordStream.set_state: pos %d outside "
                             "epoch of %d records" % (pos, len(self._order)))
        self._pos = pos

    def close(self):
        for r in self._readers.values():
            r.close()
        self._readers = {}


class StreamDataIter(DataIter):
    """DataIter over a ShardedRecordStream with optional pipelined decode
    workers (``mxtpu-data-worker-*``) and the checkpointable cursor.

    ``decode_fn(record_bytes) -> (data, label)`` runs per sample — on the
    worker pool when ``workers > 0``, inline otherwise; delivery order is
    source order either way. ``reset()`` advances to the next epoch (the
    ``module.fit`` contract: one reset per epoch; the first reset on a
    fresh iterator is a no-op so epoch 0 is not skipped), except
    immediately after ``set_state()``, which arms a one-shot skip so the
    restored cursor survives fit's epoch-top reset."""

    def __init__(self, stream, batch_size, decode_fn, data_shape,
                 label_shape=(), data_name="data",
                 label_name="softmax_label", workers=0, depth=None):
        super().__init__(batch_size)
        self._stream = stream
        self._decode = decode_fn
        self._data_shape = tuple(data_shape)
        self._label_shape = tuple(label_shape)
        self._data_name = data_name
        self._label_name = label_name
        self._pool = None
        if workers > 0:
            from .core import DecodePool

            self._pool = DecodePool(
                stream.next_record, decode_fn, workers=workers,
                depth=depth if depth is not None else 2 * workers,
                owner="StreamDataIter")
        self._delivered = 0
        self._skip_reset = False

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name,
                         (self.batch_size,) + self._label_shape)]

    def _next_sample(self):
        if self._pool is not None:
            return self._pool.get()
        return self._decode(self._stream.next_record())

    def next(self):
        batch_data = []
        batch_label = []
        pad = 0
        for _ in range(self.batch_size):
            try:
                data, label = self._next_sample()
            except StopIteration:
                if not batch_data:
                    raise
                pad = self.batch_size - len(batch_data)
                k = 0
                while len(batch_data) < self.batch_size:
                    batch_data.append(batch_data[k])
                    batch_label.append(batch_label[k])
                    k += 1
                break
            batch_data.append(_np.asarray(data, dtype=_np.float32))
            batch_label.append(_np.asarray(label, dtype=_np.float32))
        self._delivered += self.batch_size - pad
        return DataBatch(data=[NDArray(torch.from_numpy(
                             _np.stack(batch_data)))],
                         label=[NDArray(torch.from_numpy(
                             _np.stack(batch_label)))], pad=pad)

    def reset(self):
        if self._skip_reset:
            # one-shot: set_state() just restored a mid-epoch cursor and
            # fit's epoch-top reset must not advance past it
            self._skip_reset = False
            return
        if self._pool is not None:
            self._pool.reset()
        if self._delivered == 0 and self._stream.position == 0:
            return  # fresh iterator: first reset must not skip epoch 0
        self._stream.advance_epoch()
        self._delivered = 0

    def state(self):
        """Cursor in DELIVERED samples — read-ahead by the decode pool is
        deliberately excluded, so a checkpoint taken between batches
        describes exactly what the consumer has seen."""
        st = self._stream.state()
        st["pos"] = self._delivered
        return st

    def set_state(self, st):
        if self._pool is not None:
            self._pool.reset()
        self._stream.set_state(st)
        self._delivered = int(st["pos"])
        self._skip_reset = True

    def close(self):
        """Join pipeline threads and release record readers (clean
        shutdown on close/preemption)."""
        if self._pool is not None:
            self._pool.close()
        self._stream.close()
