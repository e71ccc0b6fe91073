"""Ops of the port and their registry (counterpart of `mxnet_tpu.ops`).

The modules hold what the generation, ResNet, BERT and word-LM paths use
(`nn`, `rnn`, `contrib`, `optimizer_ops`, `random_ops`, the kernel
wrappers of `pallas_kernels`) and the registered ops behind ``mx.nd``:
every op of `mxnet_tpu/ops/tensor.py` (`tensor`), ``softmax`` /
``log_softmax`` (`nn`) and the 17 optimizer updates (`optimizer_ops`).

A registered op is a plain function on torch tensors,
``fn(*tensors, **attrs) -> tensor | tuple``, run eagerly by
`invoke_torch`; PyTorch needs no per-op compile cache.
"""
from __future__ import annotations

import dataclasses
import typing as _t

from ..base import MXNetError

__all__ = ["OpDef", "register", "get", "list_ops", "invoke_torch"]


@dataclasses.dataclass
class OpDef:
    """One registered op."""
    name: str
    fn: _t.Callable
    num_outputs: int = 1          # -1: variadic/tuple output
    aliases: tuple = ()
    num_outputs_fn: _t.Callable = None  # attrs -> output count (variadic)


_REGISTRY: dict = {}


def register(name, num_outputs=1, aliases=(), num_outputs_fn=None):
    """Decorator registering a torch op function under `name`."""

    def deco(fn):
        op = OpDef(name, fn, num_outputs, tuple(aliases), num_outputs_fn)
        _REGISTRY[name] = op
        for a in aliases:
            _REGISTRY[a] = op
        return fn

    return deco


def get(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError("operator '%s' is not registered" % name) from None


def list_ops():
    return sorted(_REGISTRY)


def invoke_torch(name, tensors, attrs):
    """Run op `name` on torch tensors (the counterpart of `invoke_jax`)."""
    return get(name).fn(*tensors, **attrs)


# populate the registry
from . import tensor as _tensor  # noqa: E402,F401
from . import nn as _nn  # noqa: E402,F401
from . import optimizer_ops as _optimizer_ops  # noqa: E402,F401
