"""Weight initializers (counterpart of `mxnet_tpu/initializer.py`:
`Initializer`, `Xavier`, `Zero`, `One`, and the fill of a whole module).

An initializer fills a tensor in place, chosen by the parameter's name as
in the JAX package: ``*weight`` from the initializer's own rule, ``*bias``
and ``*beta`` 0, ``*gamma`` 1, ``*running_mean`` 0, ``*running_var`` 1.
Random values are drawn on the host from an explicit `torch.Generator`
and copied to the tensor's device, so a seed gives the same weights on
every device. They are not the JAX package's numbers (it draws from
numpy's global state); the rule and its scale are the same.
"""
from __future__ import annotations

import itertools

import numpy as _np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Xavier", "Zero", "One", "create", "initialize",
           "xavier_scale"]


class Initializer:
    """Base initializer: dispatches on the parameter's name."""

    def __call__(self, name, arr, generator=None):
        name = name.lower()
        if name.endswith("weight"):
            self._init_weight(name, arr, generator)
        elif name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            arr.fill_(0.0)
        elif name.endswith(("gamma", "running_var", "moving_var")):
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def __repr__(self):
        return "%s()" % type(self).__name__


def xavier_scale(shape, factor_type="avg", magnitude=3):
    """Half-width (uniform) or standard deviation (gaussian) of the Xavier
    rule for a weight of ``shape``, with the JAX package's fans: fan_in =
    shape[1] * prod(shape[2:]), fan_out = shape[0] * prod(shape[2:]),
    applied to the shape as stored (a channels-last conv weight is
    (O, kh, kw, I))."""
    if len(shape) < 2:
        raise ValueError("Xavier requires ndim >= 2, got %s" % (shape,))
    hw_scale = float(_np.prod(shape[2:])) if len(shape) > 2 else 1.0
    fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
    if factor_type == "avg":
        factor = (fan_in + fan_out) / 2.0
    elif factor_type == "in":
        factor = fan_in
    elif factor_type == "out":
        factor = fan_out
    else:
        raise ValueError("Xavier: unknown factor_type %r" % factor_type)
    return float(_np.sqrt(float(magnitude) / factor))


class Xavier(Initializer):
    """Uniform (default) or gaussian weights scaled by the fan average (or
    fan in / fan out): uniform on [-s, s] with s = sqrt(magnitude /
    factor)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = tuple(arr.shape)
        scale = xavier_scale(shape, self.factor_type, self.magnitude)
        val = torch.empty(shape, dtype=torch.float32)
        if self.rnd_type == "uniform":
            val.uniform_(-scale, scale, generator=generator)
        else:
            val.normal_(0.0, scale, generator=generator)
        arr.copy_(val)

    def __repr__(self):
        return "Xavier(rnd_type=%r, factor_type=%r, magnitude=%g)" % (
            self.rnd_type, self.factor_type, self.magnitude)


class Zero(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.fill_(0.0)


class One(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.fill_(1.0)


_BY_NAME = {"xavier": Xavier, "zero": Zero, "zeros": Zero, "one": One,
            "ones": One}


def create(init):
    """An `Initializer` from an instance or a registered name."""
    if isinstance(init, Initializer):
        return init
    cls = _BY_NAME.get(str(init).lower())
    if cls is None:
        raise MXNetError("unknown initializer %r" % (init,))
    return cls()


def initialize(module, init="xavier", seed=None):
    """Fill every parameter and buffer of ``module`` in place by its name
    (see `Initializer`). Random draws come from a CPU generator seeded with
    ``seed``, or, when ``seed`` is None, from this thread's generator
    (`mxnet_tpu_torch.random`). Returns ``module``."""
    init = create(init)
    gen = (torch.Generator().manual_seed(int(seed)) if seed is not None
           else _random.generator("cpu"))
    with torch.no_grad():
        for name, t in itertools.chain(module.named_parameters(),
                                       module.named_buffers()):
            init(name, t, gen)
    return module
