"""Optimizers (counterpart of `mxnet_tpu/optimizer.py`: the `Optimizer`
base with per-parameter lr/wd multipliers, `SGD`, `Adam`, and
`create`).

The JAX package traces `update` into its fused step; here `update` runs
eagerly and changes the weight and its state in place (see
`ops.optimizer_ops`).
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer from an instance or a registered name (``"sgd"``)."""
    if isinstance(name, Optimizer):
        return name
    cls = _REGISTRY.get(str(name).lower())
    if cls is None:
        raise MXNetError("unknown optimizer %r (ported: %s)"
                         % (name, sorted(_REGISTRY)))
    return cls(**kwargs)


class Optimizer:
    """Base optimizer.

    The learning rate and weight decay of parameter ``index`` are ``lr``
    and ``wd`` times its multipliers, looked up as in the JAX package: the
    ``lr_mult`` / ``wd_mult`` attribute of ``param_dict[index]`` (1 when
    the parameter has none), else the ``lr_mult`` / ``wd_mult`` dicts by
    index. ``num_update`` is the largest per-parameter update count.
    Learning-rate schedulers are not ported yet."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, begin_num_update=0, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.param_dict = param_dict or {}

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_learning_rate(self, lr):
        self.lr = lr

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        return getattr(self, attr).get(index, 1.0)

    def _common(self, index):
        self._update_count(index)
        return dict(lr=self.lr * self._mult(index, "lr_mult"),
                    wd=self.wd * self._mult(index, "wd_mult"),
                    rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient
                    if self.clip_gradient else -1.0)


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` > 0 (an f32 momentum buffer a
    parameter)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros(weight.shape, dtype=torch.float32,
                           device=weight.device)

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        if state is None:
            _ops.sgd_update(weight, grad, **kw)
        else:
            _ops.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                                **kw)


@register
class Adam(Optimizer):
    """Adam with f32 first and second moments a parameter. The bias
    correction is folded into the step's learning rate, ``lr * sqrt(1 -
    beta2^t) / (1 - beta1^t)`` with ``t`` the parameter's own update
    count, as in the JAX package. Gradients are dense: a sparse gradient
    raises, and so does ``lazy_update`` (the JAX package's lazy row-sparse
    update is not ported)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(torch.zeros(weight.shape, dtype=torch.float32,
                                 device=weight.device) for _ in range(2))

    def update(self, index, weight, grad, state):
        if grad.layout != torch.strided:
            raise MXNetError("Adam: sparse gradients (%s) are not ported; "
                             "the update takes a dense gradient"
                             % grad.layout)
        kw = self._common(index)
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        kw["lr"] = kw["lr"] * coef2 ** 0.5 / coef1
        mean, var = state
        _ops.adam_update(weight, grad, mean, var, beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon, **kw)
