"""Basic layers.

Counterpart of `mxnet_tpu/gluon/nn/basic_layers.py` (Sequential,
HybridSequential, Dense, Activation, LeakyReLU, PReLU, ELU, SELU, Swish,
GELU, Flatten, BatchNorm, InstanceNorm, LayerNorm, Embedding, Dropout,
Lambda, HybridLambda) as `HybridBlock`s that compute on tensors over
`ops.nn`. Parameter names and shapes are the JAX package's (``weight``,
``bias``, ``gamma``, ``beta``, ``running_mean``, ``running_var``; the
running statistics are module buffers). A size left at 0 (``in_units``,
``in_channels``) is taken from the first input, the parameters being made
then (deferred initialisation). The module attribute of a parameter is its
gluon `Parameter` (``dense.weight.lr_mult``, ``dense.weight.data()``), as
in the JAX package; the module holds its tensor (``state_dict``,
``Block._held``), which the forwards compute with.

A layer trains (Dropout drops, BatchNorm uses and updates the batch
statistics) under ``autograd.is_training()`` when called with NDArrays,
and under the module's ``training`` flag (``train()`` / ``eval()``) when
called with tensors. ``device``: where the parameters of a known shape are
made (the CPU when None, until `initialize` places them).

Called with `Symbol`s (`HybridBlock.export`), ``hybrid_forward`` composes
the JAX package's op of each layer (FullyConnected, Activation,
LeakyReLU, Dropout, Flatten, BatchNorm / BatchNormRelu /
BatchNormAddRelu, InstanceNorm, LayerNorm, Embedding); a `Lambda` (a plain
`Block`) has none and raises.
"""
from __future__ import annotations

import numpy as _np
from torch import nn

from ... import initializer as _init
from ... import ndarray as _nd
from ... import ops as _registry
from ... import random as _random
from ...autograd import layer_training
from ...base import MXNetError
from ...ops import nn as _ops
from ..block import Block, HybridBlock, _deferred, _has_nd

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU", "Flatten",
           "BatchNorm", "InstanceNorm", "LayerNorm", "Embedding", "Dropout",
           "Lambda", "HybridLambda"]


def _materialize(*params):
    """Make the tensors of deferred parameters whose shapes are now known."""
    for p in params:
        if p is not None and p._nd is None:
            _deferred(p)
            p._finish_deferred_init()


class Sequential(Block, nn.Sequential):
    """Blocks applied in order (reference: basic_layers.py:29); children
    are named "0", "1", ... as in the JAX package."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        """The child at ``key``; a slice gives a container of the same type
        holding those children (reference: basic_layers.py:64)."""
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    forward = nn.Sequential.forward


class HybridSequential(HybridBlock, Sequential):
    """Hybridizable `Sequential` (reference: basic_layers.py:99)."""

    forward = nn.Sequential.forward

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


class _TensorOps:
    """The registered ops as functions of tensors (``F.concat`` is the
    ``concat`` op's torch function): the ``F`` of `_Layer.forward`.
    ``F.contrib.X`` is the op ``_contrib_X``, as in ``mx.nd`` and
    ``mx.sym``."""

    def __init__(self, prefix=""):
        self._prefix = prefix

    def __getattr__(self, name):
        if name == "contrib" and not self._prefix:
            return _TensorOps("_contrib_")
        return _registry.get(self._prefix + name).fn


_TENSOR_F = _TensorOps()


class _Layer(HybridBlock):
    """A port layer: its forward computes on tensors. The default forward
    runs ``hybrid_forward`` with ``F`` the registered ops on tensors and
    each parameter as the module's tensor (the one
    `torch.func.functional_call` substitutes), so a block written as the
    JAX package's ``hybrid_forward`` over children and ops runs on tensors
    too."""

    _tensor_forward = True

    def forward(self, *args):
        params = {name: self._held(name) for name in self._reg_params}
        return self.hybrid_forward(_TENSOR_F, *args, **params)

    def hybrid_forward(self, F, x, *args, **params):
        raise MXNetError("%s has no symbol form in the port: it cannot be "
                         "exported" % type(self).__name__)


class Dense(_Layer):
    """Fully-connected layer: weight (units, in_units), bias (units,);
    ``flatten`` reshapes the input to (N, -1) first; ``activation`` (an
    `ops.nn.activation` type) is applied to the output."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, device=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._act_type = activation
        self._flatten = flatten
        with self.name_scope():
            self._param("weight", device=device, shape=(units, in_units),
                        init=weight_initializer, dtype=dtype,
                        allow_deferred_init=True)
            if use_bias:
                self._param("bias", device=device, shape=(units,),
                            init=bias_initializer, dtype=dtype,
                            allow_deferred_init=True)
            else:
                self.register_parameter("bias", None)

    def forward(self, x):
        if self._held("weight") is None:
            in_units = int(_np.prod(x.shape[1:])) if self._flatten \
                else x.shape[-1]
            weight = self._reg_params["weight"]
            weight.shape = (self._units, in_units)
            _materialize(weight, self._reg_params.get("bias"))
        out = _ops.fully_connected(x, self._held("weight"),
                                   self._held("bias"), flatten=self._flatten)
        if self._act_type is not None:
            out = _ops.activation(out, act_type=self._act_type)
        return out

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               flatten=self._flatten, no_bias=bias is None)
        if self._act_type is not None:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Activation(_Layer):
    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return _ops.activation(x, act_type=self._act_type)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class LeakyReLU(_Layer):
    """``x`` where ``x >= 0``, else ``alpha * x``."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(_Layer):
    """LeakyReLU with a learned slope ``alpha`` (shape (1,), 0.25 unless
    ``alpha_initializer`` says otherwise)."""

    def __init__(self, alpha_initializer=None, device=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._param("alpha", device=device, shape=(1,),
                        init=alpha_initializer or _init.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(_Layer):
    """``x`` where ``x >= 0``, else ``alpha * (exp(x) - 1)``."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(_Layer):
    """Scaled ELU with the self-normalizing constants."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(_Layer):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class Flatten(_Layer):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class BatchNorm(_Layer):
    """Batch normalization over ``axis`` (default 1, or -1 when built inside
    a channels-last `layout_scope`): eps 1e-5, momentum 0.9.

    ``act_type="relu"`` folds the following ReLU into the op
    (BatchNormRelu), and calling the layer with a second input,
    ``bn(x, residual)``, folds a residual add in front of the activation
    (BatchNormAddRelu). In training mode it normalizes with the batch
    statistics through the conv-epilogue kernels and updates the running
    statistics in place; otherwise it uses the running statistics. The
    running statistics stay f32 whatever the compute dtype."""

    def __init__(self, axis=None, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 act_type=None, device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if axis is None:
            from .conv_layers import in_channels_last_scope

            axis = -1 if in_channels_last_scope() else 1
        self._act_type = act_type
        self._axis = axis
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        c = (int(in_channels),)
        with self.name_scope():
            self._stats = [
                self._param("gamma", device=device,
                            grad_req="write" if scale else "null", shape=c,
                            init=gamma_initializer, allow_deferred_init=True,
                            differentiable=scale),
                self._param("beta", device=device,
                            grad_req="write" if center else "null", shape=c,
                            init=beta_initializer, allow_deferred_init=True,
                            differentiable=center),
                self._param("running_mean", "buffer", device=device,
                            grad_req="null", shape=c,
                            init=running_mean_initializer,
                            allow_deferred_init=True, differentiable=False),
                self._param("running_var", "buffer", device=device,
                            grad_req="null", shape=c,
                            init=running_variance_initializer,
                            allow_deferred_init=True, differentiable=False)]

    def cast(self, dtype):
        if _np.dtype(dtype) == _np.float16:
            dtype = "float32"  # BN stats stay f32, as in the reference
        return super().cast(dtype)

    def forward(self, x, addend=None):
        if self._held("gamma") is None:
            for p in self._stats:
                p.shape = (x.shape[self._axis],)
            _materialize(*self._stats)
        train = layer_training(self)
        stats = [self._held(n) for n in ("gamma", "beta", "running_mean",
                                         "running_var")]
        if addend is not None:
            if self._act_type is None:
                raise ValueError("BatchNorm: a residual input requires "
                                 "act_type (the fused BatchNormAddRelu "
                                 "path)")
            return _ops.batch_norm_add_relu(
                x, addend, *stats, act_type=self._act_type, is_train=train,
                **self._kwargs)[0]
        if self._act_type is not None:
            return _ops.batch_norm_relu(
                x, *stats, act_type=self._act_type, is_train=train,
                **self._kwargs)[0]
        return _ops.batch_norm(x, *stats, is_train=train,
                               **self._kwargs)[0]

    def hybrid_forward(self, F, x, addend=None, gamma=None, beta=None,
                       running_mean=None, running_var=None):
        kw = self._kwargs
        if addend is not None:
            if self._act_type is None:
                raise ValueError("BatchNorm: a residual input requires "
                                 "act_type (the fused BatchNormAddRelu "
                                 "path)")
            return F.BatchNormAddRelu(x, addend, gamma, beta, running_mean,
                                      running_var, act_type=self._act_type,
                                      **kw)
        if self._act_type is not None:
            return F.BatchNormRelu(x, gamma, beta, running_mean, running_var,
                                   act_type=self._act_type, **kw)
        return F.BatchNorm(x, gamma, beta, running_mean, running_var, **kw)


class Embedding(_Layer):
    """Lookup table: weight (input_dim, output_dim); indices are clipped to
    [0, input_dim - 1]. ``sparse_grad=True`` makes the weight's
    ``grad_stype`` row_sparse: `gluon.Trainer` casts its gradient to
    row_sparse, and an optimizer with ``supports_sparse`` updates only the
    looked-up rows (lazily: wd, momentum and Adam's moments of the other
    rows stay as they were, as in the reference)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, device=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim, self._output_dim = input_dim, output_dim
        with self.name_scope():
            self._param("weight", device=device,
                        shape=(input_dim, output_dim),
                        init=weight_initializer, dtype=dtype,
                        grad_stype="row_sparse" if sparse_grad
                        else "default")

    def forward(self, x):
        return _ops.embedding(x, self._held("weight"))

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class InstanceNorm(_Layer):
    """Instance normalization (`ops.nn.instance_norm`): each sample's
    channel normalized over its spatial axes, then ``gamma`` and ``beta``
    a channel (axis 1). ``scale`` False (the default) leaves gamma at 1
    without gradient."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._epsilon = epsilon
        self._axis = axis
        c = (int(in_channels),)
        with self.name_scope():
            self._norm = [
                self._param("gamma", device=device,
                            grad_req="write" if scale else "null", shape=c,
                            init=gamma_initializer, allow_deferred_init=True),
                self._param("beta", device=device,
                            grad_req="write" if center else "null", shape=c,
                            init=beta_initializer, allow_deferred_init=True)]

    def forward(self, x):
        if self._held("gamma") is None:
            for p in self._norm:
                p.shape = (x.shape[self._axis],)
            _materialize(*self._norm)
        return _ops.instance_norm(x, self._held("gamma"), self._held("beta"),
                                  eps=self._epsilon)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class LayerNorm(_Layer):
    """LayerNorm over ``axis`` (``in_channels`` units; 0 takes them from
    the first input), ``gamma`` 1 and ``beta`` 0, computed by
    `ops.nn.layer_norm`. ``in_channels`` comes first, as the port's models
    pass it."""

    def __init__(self, in_channels=0, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones", axis=-1,
                 device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self.eps = float(epsilon)
        c = (int(in_channels),)
        with self.name_scope():
            self._norm = [
                self._param("gamma", device=device,
                            grad_req="write" if scale else "null", shape=c,
                            init=gamma_initializer, allow_deferred_init=True),
                self._param("beta", device=device,
                            grad_req="write" if center else "null", shape=c,
                            init=beta_initializer, allow_deferred_init=True)]

    def forward(self, x):
        if self._held("gamma") is None:
            for p in self._norm:
                p.shape = (x.shape[self._axis],)
            _materialize(*self._norm)
        gamma, beta = self._held("gamma"), self._held("beta")
        if self._axis in (-1, x.dim() - 1):
            return _ops.layer_norm(x, gamma, beta, self.eps)
        return _registry.invoke_torch("LayerNorm", (x, gamma, beta),
                                      {"axis": self._axis, "eps": self.eps})

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self.eps)


class GELU(_Layer):
    """Exact (erf) GELU."""

    def forward(self, x):
        return _ops.gelu(x)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Dropout(_Layer):
    """Dropout of ``rate`` in training mode (keep mask from this thread's
    generator for the input's device, `mxnet_tpu_torch.random`; one draw
    shared along each of ``axes``); the identity otherwise."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = float(rate)
        self._axes = tuple(axes)

    def forward(self, x):
        if not layer_training(self) or self._rate <= 0.0:
            return x
        return _ops.dropout(x, self._rate, is_train=True,
                            generator=_random.generator(x.device),
                            axes=self._axes)

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class Lambda(Block):
    """A function as a Block: ``function`` a callable, or the name of an
    ``mx.nd`` function (on tensors, the registered op of that name)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            if not hasattr(_nd, function):
                raise MXNetError("function %s not found in nd" % function)
            self._func_impl = getattr(_nd, function)
            self._op_name = function
        else:
            self._func_impl = function
            self._op_name = None

    def forward(self, *args):
        if self._op_name is not None and not _has_nd(args, {}):
            return _registry.get(self._op_name).fn(*args)
        return self._func_impl(*args)


class HybridLambda(_Layer):
    """A function as a HybridBlock: ``function`` a callable, applied to the
    inputs as they come (tensors, NDArrays or Symbols), or the name of a
    registered op (``F.<name>`` for Symbols, the op itself on tensors)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name, self._func = function, None
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "lambda")

    def hybrid_forward(self, F, *args):
        fn = self._func if self._func is not None \
            else getattr(F, self._func_name)
        return fn(*args)
