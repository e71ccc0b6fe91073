"""Optimizers (counterpart of `mxnet_tpu/optimizer.py`; reference:
python/mxnet/optimizer/optimizer.py): the `Optimizer` base with
per-parameter lr / wd multipliers and an ``lr_scheduler``, every optimizer
the JAX package registers (SGD, NAG, Adam, AdamW, AdaGrad, AdaDelta,
RMSProp, Ftrl, FTML, Signum, SGLD, DCASGD, Adamax, Nadam, LBSGD and the
``ccsgd`` alias), `Updater` and `get_updater`.

The JAX package traces ``update`` into its fused step; here ``update``
runs eagerly and changes the weight and its state in place (see
`ops.optimizer_ops`), off the tape. The weight and gradient are tensors
(`parallel.DistributedTrainer`) or NDArrays (`gluon.Trainer`); states are
f32 tensors on the weight's device.

A row_sparse gradient (`ndarray.sparse.RowSparseNDArray`) reaches the
optimizers whose ``supports_sparse`` is set, as in the JAX package: SGD
and Adam take the lazy row update of `ndarray.sparse` when
``lazy_update`` (the default) and densify the gradient otherwise, AdaGrad
always takes it. The lazy updates touch only the gradient's rows, so wd,
momentum and Adam's moments of the other rows stay as they were. Any other
optimizer refuses a sparse gradient.
"""
from __future__ import annotations

import pickle

import numpy as _np
import torch

from . import random as _random
from .base import MXNetError
from .ndarray import sparse as _sparse
from .ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "FTML", "Signum", "SGLD", "DCASGD", "Adamax",
           "Nadam", "LBSGD", "Updater", "get_updater", "create", "register"]

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


def _t(x):
    """The tensor of an NDArray (a tensor as it is); a sparse array has
    none."""
    t = x._data if hasattr(x, "_data") else x
    if isinstance(t, dict):
        raise MXNetError("a %s gradient reaches only the optimizers with "
                         "supports_sparse (SGD, Adam, AdaGrad); densify it "
                         "with tostype('default')" % x.stype)
    if t.layout != torch.strided:
        raise MXNetError("a torch sparse tensor (%s) is not a gradient the "
                         "updates take: use ndarray.sparse's row_sparse "
                         "arrays" % t.layout)
    return t


def _is_row_sparse(arr):
    return getattr(arr, "stype", "default") == "row_sparse"


def _zeros(weight):
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.device)


class Optimizer:
    """Base optimizer (reference: optimizer.py:46).

    The learning rate of parameter ``index`` is ``lr_scheduler(num_update)``
    (or ``lr``) times its ``lr_mult``, and its weight decay ``wd`` times its
    ``wd_mult``, looked up as in the JAX package: the attribute of
    ``param_dict[index]`` (1 when it has none), else the ``lr_mult`` /
    ``wd_mult`` dicts by index or by name (``param_idx2name``).
    ``num_update`` is the largest per-parameter update count."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}

    #: True where a lazy row_sparse update exists (reference: the Rsp
    #: updates of src/operator/optimizer_op.cc)
    supports_sparse = False

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    def create_state(self, index, weight):
        return None

    @staticmethod
    def _is_half(dtype):
        return dtype in (torch.float16, torch.bfloat16)

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision`` and a half-precision weight: (the state
        of an f32 master copy, the copy)."""
        w = _t(weight)
        if self.multi_precision and self._is_half(w.dtype):
            w32 = w.detach().float().clone()
            return (self.create_state(index, w32), w32)
        return self.create_state(index, w)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        w = _t(weight)
        if self.multi_precision and self._is_half(w.dtype):
            s, w32 = state
            self.update(index, w32, grad.astype("float32")
                        if _is_row_sparse(grad) else _t(grad).float(), s)
            with torch.no_grad():
                w.copy_(w32)
        else:
            self.update(index, w, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; cannot override lr")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr):
        table = getattr(self, attr)
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult")

    def _common(self, index):
        self._update_count(index)
        return dict(lr=self._get_lr(index), wd=self._get_wd(index),
                    rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient
                    if self.clip_gradient else -1.0)

    def _clipped(self, grad, kw):
        g = _t(grad).float() * kw["rescale_grad"]
        if kw["clip_gradient"] > 0:
            g = g.clamp(-kw["clip_gradient"], kw["clip_gradient"])
        return g

    def __getstate__(self):
        d = self.__dict__.copy()
        d["param_dict"] = {}
        return d


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` > 0 (an f32 momentum buffer a
    parameter). ``lazy_update`` concerns row-sparse gradients only."""

    supports_sparse = True

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(_t(weight))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        if _is_row_sparse(grad):
            if self.lazy_update:
                if state is None:
                    _sparse.sgd_update(weight, grad, **kw)
                else:
                    _sparse.sgd_mom_update(weight, grad, state,
                                           momentum=self.momentum, **kw)
                return
            grad = grad.tostype("default")
        if state is None:
            _ops.sgd_update(_t(weight), _t(grad), **kw)
        else:
            _ops.sgd_mom_update(_t(weight), _t(grad), state,
                                momentum=self.momentum, **kw)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(_t(weight))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        if state is None:
            _ops.sgd_update(_t(weight), _t(grad), **kw)
        else:
            _ops.nag_mom_update(_t(weight), _t(grad), state,
                                momentum=self.momentum, **kw)


@register
class Adam(Optimizer):
    """Adam with f32 first and second moments a parameter. The bias
    correction is folded into the step's learning rate, ``lr * sqrt(1 -
    beta2^t) / (1 - beta1^t)`` with ``t`` the parameter's own update
    count, as in the JAX package. ``lazy_update`` concerns row-sparse
    gradients only."""

    supports_sparse = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(_t(weight)), _zeros(_t(weight)))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        kw["lr"] = kw["lr"] * coef2 ** 0.5 / coef1
        mean, var = state
        if _is_row_sparse(grad):
            if self.lazy_update:
                _sparse.adam_update(weight, grad, mean, var,
                                    beta1=self.beta1, beta2=self.beta2,
                                    epsilon=self.epsilon, **kw)
                return
            grad = grad.tostype("default")
        _ops.adam_update(_t(weight), _t(grad), mean, var, beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon, **kw)


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (reference: contrib adamw)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon, self.eta = epsilon, eta

    def create_state(self, index, weight):
        return (_zeros(_t(weight)), _zeros(_t(weight)))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        mean, var = state
        _ops.adamw_update(_t(weight), _t(grad), mean, var, beta1=self.beta1,
                          beta2=self.beta2, epsilon=self.epsilon,
                          eta=self.eta, **kw)


@register
class AdaGrad(Optimizer):
    """AdaGrad; a row_sparse gradient always takes the lazy update."""

    supports_sparse = True

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(_t(weight))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        if _is_row_sparse(grad):
            _sparse.adagrad_update(weight, grad, state,
                                   epsilon=self.float_stable_eps, **kw)
            return
        _ops.adagrad_update(_t(weight), _t(grad), state,
                            epsilon=self.float_stable_eps, **kw)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(_t(weight)), _zeros(_t(weight)))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        kw.pop("lr")
        acc_g, acc_d = state
        _ops.adadelta_update(_t(weight), _t(grad), acc_g, acc_d,
                             rho=self.rho, epsilon=self.epsilon, **kw)


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros(_t(weight)) for _ in range(3))
        return _zeros(_t(weight))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        kw["clip_weights"] = self.clip_weights if self.clip_weights else -1.0
        if self.centered:
            n, g, delta = state
            _ops.rmspropalex_update(_t(weight), _t(grad), n, g, delta,
                                    gamma1=self.gamma1, gamma2=self.gamma2,
                                    epsilon=self.epsilon, **kw)
        else:
            _ops.rmsprop_update(_t(weight), _t(grad), state,
                                gamma1=self.gamma1, epsilon=self.epsilon,
                                **kw)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(_t(weight)), _zeros(_t(weight)))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        z, n = state
        _ops.ftrl_update(_t(weight), _t(grad), z, n, lamda1=self.lamda1,
                         beta=self.beta, **kw)


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros(_t(weight)) for _ in range(3))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        kw["clip_grad"] = kw.pop("clip_gradient")
        d, v, z = state
        _ops.ftml_update(_t(weight), _t(grad), d, v, z, beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon,
                         t=self._index_update_count[index], **kw)


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(_t(weight))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        if state is None:
            _ops.signsgd_update(_t(weight), _t(grad), **kw)
        else:
            _ops.signum_update(_t(weight), _t(grad), state,
                               momentum=self.momentum, wd_lh=self.wd_lh,
                               **kw)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.py:1083):
    a half SGD step plus gaussian noise of variance lr, drawn from this
    thread's generator for the weight's device."""

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        w = _t(weight)
        g = self._clipped(grad, kw)
        noise = torch.randn(w.shape, generator=_random.generator(w.device),
                            device=w.device) * float(_np.sqrt(kw["lr"]))
        with torch.no_grad():
            w32 = w.float()
            w.copy_(w32 - kw["lr"] / 2 * (g + kw["wd"] * w32) + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: optimizer.py:975)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        w = _t(weight)
        mom = None if self.momentum == 0.0 else _zeros(w)
        return (mom, w.detach().float().clone())

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        w = _t(weight)
        g = self._clipped(grad, kw)
        mom, prev = state
        with torch.no_grad():
            w32 = w.float()
            comp = g + kw["wd"] * w32 + self.lamda * g * g * (w32 - prev)
            if mom is None:
                delta = -kw["lr"] * comp
            else:
                mom.mul_(self.momentum).sub_(kw["lr"] * comp)
                delta = mom
            prev.copy_(w32)
            w.copy_(w32 + delta)


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(_t(weight)), _zeros(_t(weight)))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        t = self._index_update_count[index]
        lr = kw["lr"] / (1.0 - self.beta1 ** t)
        m, u = state
        w = _t(weight)
        with torch.no_grad():
            w32 = w.float()
            g = _t(grad).float() * kw["rescale_grad"] + kw["wd"] * w32
            if kw["clip_gradient"] > 0:
                g = g.clamp(-kw["clip_gradient"], kw["clip_gradient"])
            m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
            u.copy_(torch.maximum(self.beta2 * u, g.abs()))
            w.copy_(w32 - lr * m / (u + 1e-8))


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(_t(weight)), _zeros(_t(weight)))

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        t = self._index_update_count[index]
        w = _t(weight)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule *= momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        with torch.no_grad():
            w32 = w.float()
            g = _t(grad).float() * kw["rescale_grad"] + kw["wd"] * w32
            if kw["clip_gradient"] > 0:
                g = g.clamp(-kw["clip_gradient"], kw["clip_gradient"])
            m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
            v.copy_(self.beta2 * v + (1.0 - self.beta2) * g * g)
            g_prime = g / (1.0 - self.m_schedule)
            m_prime = m / (1.0 - m_schedule_next)
            v_prime = v / (1.0 - self.beta2 ** t)
            m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
            w.copy_(w32 - kw["lr"] * m_bar / (v_prime.sqrt() + self.epsilon))


@register
class LBSGD(SGD):
    """Large-batch SGD (reference: optimizer.py:782): the step's learning
    rate scaled by ||w|| / ||g|| (at most 10x), layer by layer. Its update
    is dense only."""

    supports_sparse = False

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)
        self.warmup_strategy = warmup_strategy

    def update(self, index, weight, grad, state):
        kw = self._common(index)
        w, g = _t(weight), _t(grad)
        wnorm = float(w.detach().float().norm())
        gnorm = float(g.float().norm())
        if wnorm > 0 and gnorm > 0:
            kw["lr"] = kw["lr"] * min(
                wnorm / (gnorm * kw["rescale_grad"] + 1e-12), 10.0)
        if state is None:
            _ops.sgd_update(w, g, **kw)
        else:
            _ops.sgd_mom_update(w, g, state, momentum=self.momentum, **kw)


ccSGD = SGD  # legacy alias (the reference registers ccSGD -> SGD)
_REGISTRY["ccsgd"] = SGD


def _host(s):
    if torch.is_tensor(s):
        t = s.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    if isinstance(s, (tuple, list)):
        return tuple(_host(x) for x in s)
    return s


def _device(s, like):
    if isinstance(s, _np.ndarray):
        return torch.from_numpy(s.copy()).to(like.device)
    if isinstance(s, (tuple, list)):
        return tuple(_device(x, like) for x in s)
    return s


class Updater:
    """Applies an `Optimizer` with a state a parameter index (reference:
    optimizer.py:1621 get_updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        elif not self.states_synced.get(index, True):
            # loaded by set_states: onto the weight's device
            self.states[index] = _device(self.states[index], _t(weight))
        self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        """Restore `get_states`' bytes (with the optimizer's attributes when
        they were dumped)."""
        data = pickle.loads(states)
        if isinstance(data, tuple) and len(data) == 2:
            loaded, opt_state = data
            self.optimizer.__dict__.update(opt_state)
        else:
            loaded = data
        self.states = dict(loaded)
        self.states_synced = {k: False for k in self.states}

    def get_states(self, dump_optimizer=False):
        """The states as pickled host arrays (the port's own format)."""
        states = {k: _host(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((states, self.optimizer.__getstate__()))
        return pickle.dumps(states)


def get_updater(optimizer):
    return Updater(optimizer)
