"""Contrib datasets and samplers (counterpart of
`mxnet_tpu/gluon/contrib/data.py`; reference:
python/mxnet/gluon/contrib/data): `IntervalSampler`, and the word-level
`WikiText2` / `WikiText103` language-model datasets over the extracted
token files (``wiki.train.tokens``, ``wiki.valid.tokens``,
``wiki.test.tokens``) already in ``root``. They never fetch: a missing
file raises, naming it.
"""
from __future__ import annotations

import os

import numpy as _np

from ...base import MXNetError
from .. import data as _gdata
from ... import ndarray as nd

__all__ = ["IntervalSampler", "WikiText2", "WikiText103"]

EOS_TOKEN = "<eos>"


class IntervalSampler(_gdata.Sampler):
    """Samples [0, length) at fixed strides (reference: contrib/data/
    sampler.py:25): 0, k, 2k, ...; with `rollover` it restarts from each
    skipped offset until every index is visited exactly once."""

    def __init__(self, length, interval, rollover=True):
        if not 1 <= interval <= length:
            raise MXNetError("interval %d must be in [1, length=%d]"
                             % (interval, length))
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))


class _WikiText(_gdata.Dataset):
    """Word-level LM dataset over an extracted WikiText token file: one
    long token stream (EOS appended per line), indexed into (seq_len,)
    data/label windows shifted by one token (reference: contrib/data/
    text.py:58)."""

    _filename = None  # subclass: {segment: file name}

    def __init__(self, root, segment="train", vocab=None, seq_len=35):
        self._root = os.path.expanduser(root)
        self._segment = segment
        self._seq_len = seq_len
        if segment not in self._filename:
            raise MXNetError("segment must be one of %s"
                             % sorted(self._filename))
        path = os.path.join(self._root, self._filename[segment])
        if not os.path.exists(path):
            raise MXNetError(
                "%s not found. The port downloads nothing: extract the %s "
                "archive's token files into %r (the reference's layout)."
                % (path, type(self).__name__, self._root))
        with open(path, encoding="utf8") as f:
            content = f.read()
        tokens = []
        for line in content.splitlines():
            words = line.strip().split()
            if words:
                tokens.extend(words)
                tokens.append(EOS_TOKEN)
        if vocab is None:
            import collections

            from ...contrib.text import Vocabulary

            vocab = Vocabulary(collections.Counter(tokens))
        self.vocabulary = vocab
        idx = _np.asarray(vocab.to_indices(tokens), dtype=_np.int32)
        n = (len(idx) - 1) // seq_len
        self._data = idx[:n * seq_len].reshape(n, seq_len)
        self._label = idx[1:n * seq_len + 1].reshape(n, seq_len)

    def __getitem__(self, i):
        # a window at a time, as NDArrays on the current context (a
        # DataLoader worker's is the host)
        return (nd.array(self._data[i], dtype="int32"),
                nd.array(self._label[i], dtype="int32"))

    def __len__(self):
        return len(self._label)


class WikiText2(_WikiText):
    """reference: contrib/data/text.py:105 (wiki.{train,valid,test}.tokens)."""

    _filename = {"train": "wiki.train.tokens",
                 "validation": "wiki.valid.tokens",
                 "test": "wiki.test.tokens"}


class WikiText103(_WikiText):
    """reference: contrib/data/text.py:143 (same layout, 103M-token corpus)."""

    _filename = WikiText2._filename
