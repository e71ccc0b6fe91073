"""Generic object registry factories (counterpart of `mxnet_tpu/registry.py`;
reference: python/mxnet/registry.py: get_register_func / get_alias_func /
get_create_func, the machinery behind ``@mx.optimizer.register``, metric
lookup and initializer strings).

A framework base class resolves onto the store its subsystem already uses
(`optimizer`, `initializer` and `metric` each keep a ``_REGISTRY`` dict of
lower-case names), so ``create("adam")`` here and ``optimizer.create
("adam")`` find the same class, and a class registered through either is
seen by both. A third-party base class gets a store of its own, even when
its nickname is a subsystem's. Creation takes a name, a ``(name, kwargs)``
pair, a JSON ``'["name", {...}]'`` spec, the reference's keyword form
(``create(optimizer="sgd", ...)``), or passes an instance through.
"""
from __future__ import annotations

import json

from .base import MXNetError

__all__ = ["get_registry", "get_register_func", "get_alias_func",
           "get_create_func", "register", "alias", "create"]

_REGISTRY = {}  # base_class -> _Store


class _Store:
    """A name -> class map under a kind's name (the storage a base class
    resolves onto)."""

    def __init__(self, kind, mapping=None):
        self.kind = kind
        self._map = {} if mapping is None else mapping

    def register(self, obj, name=None):
        self._map[(name or obj.__name__).lower()] = obj
        return obj

    def get(self, name):
        key = name.lower()
        if key not in self._map:
            raise MXNetError("Cannot find %s '%s'. Valid: %s"
                             % (self.kind, name, sorted(self._map)))
        return self._map[key]

    def create(self, name, *args, **kwargs):
        return self.get(name)(*args, **kwargs)


def _subsystems():
    """kind -> the dict its subsystem registers into."""
    from . import initializer, metric, optimizer

    return {"optimizer": optimizer._REGISTRY,
            "initializer": initializer._REGISTRY,
            "metric": metric._REGISTRY}


def _reg_for(base_class, nickname, create_if_missing=True):
    reg = _REGISTRY.get(base_class)
    if reg is not None:
        return reg
    # only the framework's own base classes claim a subsystem's store: by
    # nickname, by class name, or by the kind the class name ends with
    # (EvalMetric -> metric)
    if (base_class.__module__ or "").startswith("mxnet_tpu_torch"):
        stores = _subsystems()
        cls_lower = base_class.__name__.lower()
        kind = next((c for c in (nickname, cls_lower) if c in stores), None)
        if kind is None:
            kind = next((k for k in stores if cls_lower.endswith(k)), None)
        if kind is not None:
            reg = _Store(kind, stores[kind])
    if reg is None:
        if not create_if_missing:
            return None
        reg = _Store("%s(%s)" % (nickname, base_class.__name__))
    _REGISTRY[base_class] = reg
    return reg


def get_registry(base_class):
    """A copy of the name -> class map for ``base_class`` (reference:
    registry.py:32)."""
    reg = _reg_for(base_class, base_class.__name__.lower(),
                   create_if_missing=False)
    return dict(reg._map) if reg is not None else {}


def get_register_func(base_class, nickname):
    """reference: registry.py:49."""
    reg = _reg_for(base_class, nickname)

    def register(klass, name=None):
        if not issubclass(klass, base_class):
            raise MXNetError("can only register subclass of %s"
                             % base_class.__name__)
        reg.register(klass, name)
        return klass

    register.__doc__ = "Register %s to the %s factory" % (
        base_class.__name__, nickname)
    return register


def get_alias_func(base_class, nickname):
    """reference: registry.py:88."""
    register_fn = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register_fn(klass, name)
            return klass

        return reg

    return alias


def get_create_func(base_class, nickname):
    """reference: registry.py:115."""
    reg = _reg_for(base_class, nickname)

    def create(*args, **kwargs):
        if args and isinstance(args[0], base_class):
            if len(args) > 1 or kwargs:
                raise MXNetError(
                    "%s is already an instance; additional arguments are "
                    "invalid" % nickname)
            return args[0]
        if args and isinstance(args[0], (list, tuple)):
            spec = args[0]
            return create(spec[0], **(spec[1] if len(spec) > 1 else {}))
        if not args and nickname in kwargs:
            name = kwargs.pop(nickname)
            return create(name, **kwargs)
        if not args or not isinstance(args[0], str):
            raise MXNetError("%s.create needs a name string, (name, kwargs) "
                             "pair, or an instance" % nickname)
        name = args[0]
        if name.startswith("[") or name.startswith("{"):
            spec = json.loads(name)
            if isinstance(spec, dict):
                return create(spec["name"], **spec.get("params", {}))
            return create(spec[0], **(spec[1] if len(spec) > 1 else {}))
        return reg.create(name, *args[1:], **kwargs)

    create.__doc__ = "Create a %s instance from config" % nickname
    return create


def register(base_class, nickname="object"):
    return get_register_func(base_class, nickname)


def alias(base_class, nickname="object"):
    return get_alias_func(base_class, nickname)


def create(base_class, nickname="object"):
    return get_create_func(base_class, nickname)
