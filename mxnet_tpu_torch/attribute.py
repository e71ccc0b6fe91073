"""Scoped symbol attributes (counterpart of `mxnet_tpu/attribute.py`;
reference: python/mxnet/attribute.py).

``with AttrScope(ctx_group="dev1", lr_mult="0.5"):`` stamps its attributes
onto every symbol created inside it; scopes nest, the inner one winning.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = [AttrScope()]
    return _state.stack


class AttrScope:
    """Attribute manager for symbol scoping (reference: attribute.py:25)."""

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("attributes must be strings")
        self._attr = kwargs

    def get(self, attr=None):
        """The scope's attributes merged with ``attr`` (``attr`` wins;
        reference: attribute.py:49)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        stack = _stack()
        merged = dict(stack[-1]._attr)
        merged.update(self._attr)
        scope = AttrScope()
        scope._attr = merged
        stack.append(scope)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


def current():
    """The innermost active AttrScope."""
    return _stack()[-1]
