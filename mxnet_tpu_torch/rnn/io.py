"""Bucketing data iterator for language models (counterpart of
`mxnet_tpu/rnn/io.py`; reference: python/mxnet/rnn/io.py —
encode_sentences :30, BucketSentenceIter :84). Feeds `BucketingModule`:
each batch carries its bucket_key (its sequence length). Batches are
shuffled with Python's `random` and numpy's global generator, as in the
JAX package, so seeding both gives both packages the same batches."""
from __future__ import annotations

import bisect
import random

import numpy as _np

from .. import ndarray
from ..io import DataBatch, DataDesc, DataIter


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Encode tokenized sentences to ids, building/extending the vocab
    (reference: io.py:30)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
        if vocab:
            idx = max(max(vocab.values()) + 1, start_label)
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab or unknown_token, \
                    "Unknown token %s" % word
                if idx == invalid_label:
                    idx += 1
                if unknown_token:
                    word = unknown_token
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed language-model iterator: label[t] = data[t+1], batches
    grouped by bucketed sequence length (reference: io.py:84)."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32", layout="NT"):
        super().__init__(batch_size=batch_size)
        if not buckets:
            buckets = [i for i, j in enumerate(
                _np.bincount([len(s) for s in sentences]))
                if j >= batch_size]
        buckets = sorted(buckets)

        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = _np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        used = [i for i, d in enumerate(self.data) if d]
        self.buckets = [buckets[i] for i in used]
        self.data = [_np.asarray(self.data[i], dtype=dtype) for i in used]
        if ndiscard:
            import logging

            logging.getLogger("mxnet_tpu_torch.rnn").warning(
                "discarded %d sentences longer than the largest bucket.",
                ndiscard)

        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(self.buckets)

        shape = (batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else \
            (self.default_bucket_key, batch_size)
        if self.major_axis not in (0, 1):
            raise ValueError("Invalid layout %s: must be NT (batch major) "
                             "or TN (time major)" % layout)
        self.provide_data = [DataDesc(name=self.data_name, shape=shape,
                                      layout=self.layout)]
        self.provide_label = [DataDesc(name=self.label_name, shape=shape,
                                       layout=self.layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            _np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = _np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(ndarray.array(buck, dtype=self.dtype))
            self.ndlabel.append(ndarray.array(label, dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(name=self.label_name,
                                    shape=label.shape,
                                    layout=self.layout)])
