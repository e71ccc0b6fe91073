"""Automatic symbol naming (counterpart of `mxnet_tpu/name.py`; reference:
python/mxnet/name.py).

`NameManager` gives an op without a name ``<hint><n>`` (``fullyconnected0``,
``fullyconnected1``, ...), counted per hint; `Prefix` prepends a prefix
inside its scope. The symbol layer asks the innermost manager.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = [NameManager()]
    return _state.stack


class NameManager:
    """Assigns unique names per op hint (reference: name.py:25)."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        c = self._counter.get(hint, 0)
        self._counter[hint] = c + 1
        return "%s%d" % (hint, c)

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


class Prefix(NameManager):
    """NameManager adding a constant prefix (reference: name.py:70)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    return _stack()[-1]
