"""Ops of the port and their registry (counterpart of `mxnet_tpu.ops`).

The modules hold what the generation, ResNet, BERT and word-LM paths use
(`nn`, `rnn`, `contrib`, `optimizer_ops`, `random_ops`, the kernel
wrappers of `pallas_kernels`) and the registered ops behind ``mx.nd`` and
``mx.sym``: every op of `mxnet_tpu/ops/tensor.py` (`tensor`), the layers,
loss heads, ``softmax`` / ``log_softmax`` and ``Dropout`` of `nn`, the
``RNN`` op and its zero states (`rnn`), and the 17 optimizer updates
(`optimizer_ops`), the four image ops behind ``mx.nd.image``
(`image_ops`), the 22 random ops behind ``mx.nd.random`` (`random_ops`),
the 15 linear-algebra ops behind ``mx.nd.linalg`` (`linalg`), and
``CTCLoss`` (`rnn`), ``_contrib_flash_attention`` and the detection ops
(`contrib`), the 9 int8 quantization ops (`quantization`) and the 6 DGL
graph ops (`dgl`, host ops over csr arrays) behind ``mx.nd.contrib``.

A registered op is a plain function on torch tensors,
``fn(*tensors, **attrs) -> tensor | tuple``, run eagerly by
`invoke_torch`; PyTorch needs no per-op compile cache. An op that draws
random numbers (``needs_rng``) takes a ``generator`` keyword, the
`torch.Generator` its caller chose; an op whose trailing outputs are
hidden (``num_visible_outputs``, BatchNorm's moving statistics) writes
them into its trailing inputs in place and returns them too. A ``host``
op takes and returns NDArrays instead (sparse ones included), and an op
with a ``sparse_fn`` (the lazy optimizer updates) runs it when an input is
sparse; any other op given a sparse input sees its dense values.
"""
from __future__ import annotations

import dataclasses
import inspect
import typing as _t

from ..base import MXNetError

__all__ = ["OpDef", "register", "get", "list_ops", "invoke_torch",
           "takes_is_train"]


@dataclasses.dataclass
class OpDef:
    """One registered op."""
    name: str
    fn: _t.Callable
    num_outputs: int = 1          # -1: variadic/tuple output
    aliases: tuple = ()
    num_outputs_fn: _t.Callable = None  # attrs -> output count (variadic)
    needs_rng: bool = False       # fn takes a ``generator`` keyword
    num_visible_outputs: int = None  # outputs shown to the user; the rest
                                     # are the updated aux inputs
    size_attrs: tuple = ()        # attrs whose magnitude sizes an index
                                  # space (Embedding input_dim, one_hot
                                  # depth); recorded as the JAX registry
                                  # does, read by no dispatch here
    host: bool = False            # fn takes and returns NDArrays (sparse
                                  # ones too) and computes on the host
    sparse_fn: _t.Callable = None  # called with the NDArrays instead of fn
                                   # when an input is sparse

    @property
    def visible_outputs(self):
        return self.num_outputs if self.num_visible_outputs is None \
            else self.num_visible_outputs


_REGISTRY: dict = {}


def register(name, num_outputs=1, aliases=(), num_outputs_fn=None,
             needs_rng=False, num_visible_outputs=None, size_attrs=(),
             host=False, sparse_fn=None):
    """Decorator registering a torch op function under `name`."""

    def deco(fn):
        op = OpDef(name, fn, num_outputs, tuple(aliases), num_outputs_fn,
                   needs_rng, num_visible_outputs, tuple(size_attrs), host,
                   sparse_fn)
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


def takes_is_train(opdef):
    """Whether the op's function has an ``is_train`` parameter (its mode
    comes from the caller: autograd's training mode for ``mx.nd``, the
    executor's ``is_train`` for a bound symbol)."""
    v = _TAKES_IS_TRAIN.get(opdef.name)
    if v is None:
        try:
            v = "is_train" in inspect.signature(opdef.fn).parameters
        except (TypeError, ValueError):
            v = False
        _TAKES_IS_TRAIN[opdef.name] = v
    return v


_TAKES_IS_TRAIN: dict = {}


def invoke_torch(name, tensors, attrs):
    """Run op `name` on torch tensors (the counterpart of `invoke_jax`)."""
    return get(name).fn(*tensors, **attrs)


# populate the registry
from . import tensor as _tensor  # noqa: E402,F401
from . import nn as _nn  # noqa: E402,F401
from . import optimizer_ops as _optimizer_ops  # noqa: E402,F401
from . import rnn as _rnn  # noqa: E402,F401
from . import image_ops as _image_ops  # noqa: E402,F401
from . import random_ops as _random_ops  # noqa: E402,F401
from . import linalg as _linalg  # noqa: E402,F401
from . import contrib as _contrib  # noqa: E402,F401
from . import quantization as _quantization  # noqa: E402,F401
from . import dgl as _dgl  # noqa: E402,F401
