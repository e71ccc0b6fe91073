"""Weight initializers (counterpart of `mxnet_tpu/initializer.py`: the
registry, `InitDesc`, `Initializer` and its kinds, and the fill of a whole
module).

An initializer fills an array (a tensor or an NDArray) in place, chosen by
the parameter's name as in the JAX package: ``*weight`` from the
initializer's own rule, ``*bias`` and ``*beta`` 0, ``*gamma`` 1,
``*running_mean`` 0, ``*running_var`` 1. Random values are drawn on the host
from an explicit `torch.Generator` and copied to the array's device, so a
seed gives the same weights on every device. They are not the JAX package's
numbers (it draws from numpy's global state); the rule and its scale are
the same. ``FusedRNN`` fills a `rnn.FusedRNNCell`'s flat parameter vector
gate by gate.
"""
from __future__ import annotations

import itertools
import json
import re

import numpy as _np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Zero", "One",
           "Constant", "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear",
           "LSTMBias", "FusedRNN", "Load", "Mixed", "register", "create",
           "initialize", "xavier_scale"]

_REGISTRY = {}


def register(klass):
    """Register an `Initializer` class under its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs):
    """An `Initializer` from an instance, a registered name (``"xavier"``),
    or the ``dumps`` form ``'["name", {kwargs}]'``; None gives `Uniform`."""
    if init is None:
        return Uniform()
    if isinstance(init, Initializer):
        return init
    name = str(init)
    if name.startswith("["):
        name, kwargs = json.loads(name)
    cls = _REGISTRY.get(name.lower())
    if cls is None:
        raise MXNetError("unknown initializer %r (ported: %s)"
                         % (init, sorted(_REGISTRY)))
    return cls(**kwargs)


class InitDesc(str):
    """A parameter's name with hints (reference: initializer.py:38):
    ``attrs["__init__"]`` names an initializer that overrides the one
    called."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


def _tensor(arr):
    return arr._data if hasattr(arr, "_data") else arr


class Initializer:
    """Base initializer: dispatches on the parameter's name. ``arr`` is a
    tensor or an NDArray, filled in place; ``generator`` is the CPU
    `torch.Generator` random kinds draw from (default: this thread's,
    `mxnet_tpu_torch.random`)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """The ``'["name", {kwargs}]'`` form `create` reads back."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, generator=None):
        t = _tensor(arr)
        gen = generator if generator is not None \
            else _random.generator("cpu")
        with torch.no_grad():
            hint = getattr(desc, "attrs", {}).get("__init__", "")
            if hint:
                create(hint)._init_weight(desc, t, gen)
                return
            name = str(desc).lower()
            if name.endswith("weight"):
                self._init_weight(desc, t, gen)
            elif name.endswith("bias"):
                self._init_bias(desc, t, gen)
            elif name.endswith("gamma"):
                self._init_gamma(desc, t, gen)
            elif name.endswith("beta"):
                self._init_beta(desc, t, gen)
            elif name.endswith(("running_mean", "moving_mean", "min",
                                "max")):
                t.fill_(0.0)
            elif name.endswith(("running_var", "moving_var")):
                t.fill_(1.0)
            else:
                self._init_default(desc, t, gen)

    def _init_weight(self, desc, arr, generator):
        raise NotImplementedError

    def _init_bias(self, desc, arr, generator):
        arr.fill_(0.0)

    def _init_gamma(self, desc, arr, generator):
        arr.fill_(1.0)

    def _init_beta(self, desc, arr, generator):
        arr.fill_(0.0)

    def _init_default(self, desc, arr, generator):
        self._init_weight(desc, arr, generator)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._kwargs)


def _fill(arr, val):
    src = val if torch.is_tensor(val) else torch.as_tensor(val, device="cpu")
    arr.copy_(src.to(arr.device, arr.dtype))


@register
class Uniform(Initializer):
    """Uniform on [-scale, scale]."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr, generator):
        val = torch.empty(tuple(arr.shape), dtype=torch.float32, device="cpu")
        _fill(arr, val.uniform_(-self.scale, self.scale, generator=generator))


@register
class Normal(Initializer):
    """Normal with mean 0 and standard deviation ``sigma``."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr, generator):
        val = torch.empty(tuple(arr.shape), dtype=torch.float32, device="cpu")
        _fill(arr, val.normal_(0.0, self.sigma, generator=generator))


@register
class Zero(Initializer):
    def _init_weight(self, desc, arr, generator):
        arr.fill_(0.0)


@register
class One(Initializer):
    def _init_weight(self, desc, arr, generator):
        arr.fill_(1.0)


_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    """Every element ``value`` (a number, or an array broadcast to the
    shape)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr, generator):
        v = self.value
        v = v.asnumpy() if hasattr(v, "asnumpy") else v
        _fill(arr, torch.as_tensor(_np.asarray(v, _np.float32))
              .expand(tuple(arr.shape)))


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


@register
class Xavier(Initializer):
    """Uniform (default) or gaussian weights scaled by the fan average (or
    fan in / fan out): uniform on [-s, s] with s = sqrt(magnitude /
    factor)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr, generator):
        shape = tuple(arr.shape)
        scale = xavier_scale(shape, self.factor_type, self.magnitude)
        val = torch.empty(shape, dtype=torch.float32, device="cpu")
        if self.rnd_type == "uniform":
            val.uniform_(-scale, scale, generator=generator)
        else:
            val.normal_(0.0, scale, generator=generator)
        _fill(arr, val)

    def __repr__(self):
        return "Xavier(rnd_type=%r, factor_type=%r, magnitude=%g)" % (
            self.rnd_type, self.factor_type, self.magnitude)


@register
class MSRAPrelu(Xavier):
    """He initialisation: gaussian Xavier with magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal factor (the SVD's U or V) of a
    uniform [-1, 1] (or normal) matrix of (shape[0], prod(shape[1:]))."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr, generator):
        nout = arr.shape[0]
        nin = int(_np.prod(tuple(arr.shape[1:])))
        tmp = torch.empty((nout, nin), dtype=torch.float64, device="cpu")
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _fill(arr, (self.scale * q).reshape(tuple(arr.shape)))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a (C, 1, k, k) deconvolution."""

    def _init_weight(self, desc, arr, generator):
        shape = tuple(arr.shape)
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = _np.arange(int(_np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - _np.abs(x / f - c)) * (1 - _np.abs(y / f - c))
        _fill(arr, w.reshape(shape).astype(_np.float32))


@register
class LSTMBias(Initializer):
    """An LSTM bias: ``forget_bias`` on the forget gate's quarter (the
    second of i, f, c, o), 0 elsewhere."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr, generator):
        b = _np.zeros(tuple(arr.shape), dtype=_np.float32)
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias
        _fill(arr, b)

    _init_bias = _init_weight
    _init_default = _init_weight


@register
class FusedRNN(Initializer):
    """A `rnn.FusedRNNCell`'s flat parameter vector (reference:
    initializer.py:702): unpacked into per-gate matrices and biases, each
    filled by ``init`` (default: the caller's ``global_init`` if the
    parameter's `InitDesc` has one, else `Uniform`), the LSTM forget-gate
    biases set to ``forget_bias``, and packed back, as the JAX package
    does."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            init = create(init)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr, generator):
        from .ndarray import NDArray
        from .rnn import rnn_cell

        cell = rnn_cell.FusedRNNCell(
            self._num_hidden, self._num_layers, self._mode,
            self._bidirectional, forget_bias=self._forget_bias, prefix="")
        args = cell.unpack_weights(
            {"parameters": NDArray(arr.detach().float().cpu().contiguous())})
        global_init = getattr(desc, "global_init", None)
        inner = self._init or global_init or Uniform()
        for name, sub in args.items():
            if self._mode == "lstm" and name.endswith("_f_bias"):
                sub._data.fill_(self._forget_bias)
            else:
                inner(InitDesc(name, global_init=global_init), sub,
                      generator)
        _fill(arr, cell.pack_weights(args)["parameters"]._data)


@register
class Load(Initializer):
    """Values by name from a dict of arrays (``arg:`` / ``aux:`` prefixes
    dropped), else ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, desc, arr, generator=None):
        name = str(desc)
        if name in self.param:
            src = self.param[name]
            src = src.asnumpy() if hasattr(src, "asnumpy") else src
            t = _tensor(arr)
            if tuple(t.shape) != tuple(_np.shape(src)):
                raise MXNetError("Load: %s has shape %s, the array %s"
                                 % (name, _np.shape(src), tuple(t.shape)))
            with torch.no_grad():
                _fill(t, _np.asarray(src))
        elif self.default_init is not None:
            create(self.default_init)(desc, arr, generator)
        else:
            raise MXNetError("Load: no value for %s" % name)


@register
class Mixed(Initializer):
    """The initializer of the first pattern (a regular expression) that
    matches the name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = list(zip([re.compile(p) for p in patterns],
                            [create(i) for i in initializers]))

    def __call__(self, desc, arr, generator=None):
        for prog, init in self.map:
            if prog.match(str(desc)):
                init(desc, arr, generator)
                return
        raise MXNetError("Mixed: no pattern matches %s" % str(desc))


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
