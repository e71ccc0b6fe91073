"""Basic layers.

Counterpart of `mxnet_tpu/gluon/nn/basic_layers.py` (HybridSequential,
Dense, Activation, Flatten, BatchNorm) as `torch.nn.Module`s over
`ops.nn`. Parameter names and shapes are the JAX package's (``weight``,
``bias``, ``gamma``, ``beta``; BatchNorm's ``running_mean`` and
``running_var`` are buffers). A layer is in training mode when its
module's ``training`` flag is set (``train()`` / ``eval()``), the
counterpart of the JAX package's autograd training scope.
"""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...ops import nn as _ops

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Flatten", "BatchNorm"]


class Sequential(nn.Sequential):
    """Sequential container with the JAX package's ``add``."""

    def add(self, *blocks):
        for block in blocks:
            self.append(block)


HybridSequential = Sequential


class Dense(nn.Module):
    """Fully-connected layer: weight (units, in_units), bias (units,);
    ``flatten`` reshapes the input to (N, -1) first."""

    def __init__(self, units, use_bias=True, flatten=True, in_units=0,
                 device=None):
        super().__init__()
        if not in_units:
            raise MXNetError("Dense: in_units must be given (the port does "
                             "not infer shapes at the first forward)")
        self._flatten = flatten
        self.weight = nn.Parameter(torch.zeros((units, in_units),
                                               device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(units, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return _ops.fully_connected(x, self.weight, self.bias,
                                    flatten=self._flatten)


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
