"""Basic layers.

Counterpart of `mxnet_tpu/gluon/nn/basic_layers.py` (HybridSequential,
Dense, Activation, Flatten, BatchNorm, Embedding, LayerNorm, GELU,
Dropout) as `torch.nn.Module`s over `ops.nn`. Parameter names and shapes
are the JAX package's (``weight``, ``bias``, ``gamma``, ``beta``;
BatchNorm's ``running_mean`` and ``running_var`` are buffers). A layer is
in training mode when its module's ``training`` flag is set (``train()`` /
``eval()``), the counterpart of the JAX package's autograd training
scope.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import random as _random
from ...base import MXNetError
from ...ops import nn as _ops

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Flatten", "BatchNorm", "Embedding", "LayerNorm", "GELU",
           "Dropout"]


class Sequential(nn.Sequential):
    """Sequential container with the JAX package's ``add``."""

    def add(self, *blocks):
        for block in blocks:
            self.append(block)


HybridSequential = Sequential


class Dense(nn.Module):
    """Fully-connected layer: weight (units, in_units), bias (units,);
    ``flatten`` reshapes the input to (N, -1) first; ``activation`` (an
    `ops.nn.activation` type) is applied to the output."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 in_units=0, device=None):
        super().__init__()
        if not in_units:
            raise MXNetError("Dense: in_units must be given (the port does "
                             "not infer shapes at the first forward)")
        self._act_type = activation
        self._flatten = flatten
        self.weight = nn.Parameter(torch.zeros((units, in_units),
                                               device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(units, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        out = _ops.fully_connected(x, self.weight, self.bias,
                                   flatten=self._flatten)
        if self._act_type is not None:
            out = _ops.activation(out, act_type=self._act_type)
        return out


class Activation(nn.Module):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return _ops.activation(x, act_type=self._act_type)


class Flatten(nn.Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class BatchNorm(nn.Module):
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
                 scale=True, use_global_stats=False, in_channels=0,
                 act_type=None, device=None):
        super().__init__()
        if not in_channels:
            raise MXNetError("BatchNorm: in_channels must be given (the "
                             "port does not infer shapes at the first "
                             "forward)")
        if axis is None:
            from .conv_layers import in_channels_last_scope

            axis = -1 if in_channels_last_scope() else 1
        self._act_type = act_type
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        c = int(in_channels)
        self.gamma = nn.Parameter(torch.ones(c, device=device),
                                  requires_grad=scale)
        self.beta = nn.Parameter(torch.zeros(c, device=device),
                                 requires_grad=center)
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x, addend=None):
        if addend is not None:
            if self._act_type is None:
                raise ValueError("BatchNorm: a residual input requires "
                                 "act_type (the fused BatchNormAddRelu "
                                 "path)")
            return _ops.batch_norm_add_relu(
                x, addend, self.gamma, self.beta, self.running_mean,
                self.running_var, act_type=self._act_type,
                is_train=self.training, **self._kwargs)[0]
        if self._act_type is not None:
            return _ops.batch_norm_relu(
                x, self.gamma, self.beta, self.running_mean,
                self.running_var, act_type=self._act_type,
                is_train=self.training, **self._kwargs)[0]
        return _ops.batch_norm(x, self.gamma, self.beta, self.running_mean,
                               self.running_var, is_train=self.training,
                               **self._kwargs)[0]


class Embedding(nn.Module):
    """Lookup table: weight (input_dim, output_dim); indices are clipped to
    [0, input_dim - 1]."""

    def __init__(self, input_dim, output_dim, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((input_dim, output_dim),
                                               device=device))

    def forward(self, x):
        return _ops.embedding(x, self.weight)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis (``in_channels`` units), ``gamma`` 1
    and ``beta`` 0 at construction, computed by `ops.nn.layer_norm`."""

    def __init__(self, in_channels, epsilon=1e-5, device=None):
        super().__init__()
        self.eps = float(epsilon)
        self.gamma = nn.Parameter(torch.ones(in_channels, device=device))
        self.beta = nn.Parameter(torch.zeros(in_channels, device=device))

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, self.eps)


class GELU(nn.Module):
    """Exact (erf) GELU."""

    def forward(self, x):
        return _ops.gelu(x)


class Dropout(nn.Module):
    """Dropout of ``rate`` in training mode (keep mask from this thread's
    generator for the input's device, `mxnet_tpu_torch.random`); the
    identity otherwise."""

    def __init__(self, rate):
        super().__init__()
        self._rate = float(rate)

    def forward(self, x):
        if not self.training or self._rate <= 0.0:
            return x
        return _ops.dropout(x, self._rate, is_train=True,
                            generator=_random.generator(x.device))
