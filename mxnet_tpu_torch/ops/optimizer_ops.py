"""Optimizer update ops (counterpart of `mxnet_tpu/ops/optimizer_ops.py`;
reference: src/operator/optimizer_op.cc and contrib/adamw.cc).

Each update is a function on tensors that changes the weight and its
state IN PLACE (no second copy of either) and returns them, in the order
the JAX package's pure functions return their new values; the arithmetic
is the same, in f32: ``g = clip(grad * rescale_grad) + wd * weight``. The
optimizers of `mxnet_tpu_torch.optimizer` call these.

Behind ``mx.nd`` each is registered under its JAX name as an op that leaves
its inputs alone and returns the new values, so
``nd.sgd_mom_update(w, g, m, out=[w, m], ...)`` writes them through
``out=``, in place (off the tape for a gluon Parameter's array). The
updates run one tensor at a time; the multi-tensor form is ROADMAP queue 1
item 2.

A row_sparse gradient: ``sgd_update``, ``sgd_mom_update`` and
``adam_update`` with ``lazy_update=True``, and ``adagrad_update`` (alias
``_sparse_adagrad_update``, the reference's row_sparse AdaGrad) always,
take the lazy row update of `ndarray.sparse`; otherwise the gradient is
densified and the update is the dense one (the JAX package's ops take
dense gradients only).
"""
from __future__ import annotations

import functools
import inspect

import torch

from . import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "nag_mom_update", "adam_update",
           "adamw_update", "rmsprop_update", "rmspropalex_update",
           "ftrl_update", "ftml_update", "signsgd_update", "signum_update",
           "adagrad_update", "adadelta_update", "multi_sgd_update",
           "multi_sgd_mom_update"]


def _grad(grad, rescale_grad, clip_gradient):
    g = grad.float()
    if rescale_grad != 1.0:
        g = g * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _prep(grad, rescale_grad, clip_gradient, wd, weight):
    g = _grad(grad, rescale_grad, clip_gradient)
    if wd:
        g = g + wd * weight.float()
    return g


def _set(weight, value):
    if weight.dtype == value.dtype:
        weight.copy_(value)
    else:
        weight.copy_(value.to(weight.dtype))


def _functional(inplace, written):
    """The registered, pure form of ``inplace``: the tensors at positions
    ``written(n_inputs)`` are cloned, updated, and returned in order."""

    @functools.wraps(inplace)
    def op(*tensors, **attrs):
        pos = written(len(tensors))
        tensors = list(tensors)
        for i in pos:
            tensors[i] = tensors[i].clone()
        inplace(*tensors, **attrs)
        out = tuple(tensors[i] for i in pos)
        return out[0] if len(out) == 1 else out

    return op


def _lazy_form(inplace, positions, lazy_name, always=False):
    """The ``sparse_fn`` of a registered update: with a row_sparse gradient
    and ``lazy_update`` (or ``always``), copies of the weight and states
    take `ndarray.sparse`'s lazy update named ``lazy_name``; otherwise the
    dense update runs on the densified arrays."""
    defaults = {k: p.default
                for k, p in inspect.signature(inplace).parameters.items()
                if p.default is not inspect.Parameter.empty}
    defaults.pop("lazy_update", None)

    def op(*arrays, lazy_update=False, **attrs):
        from ..ndarray import sparse

        grad = arrays[1]
        if (lazy_update or always) and grad.stype == "row_sparse":
            tensors = [grad if i == 1 else a.tostype("default")._data.clone()
                       for i, a in enumerate(arrays)]
            getattr(sparse, lazy_name)(*tensors, **dict(defaults, **attrs))
            out = tuple(tensors[i] for i in positions)
        else:
            out = _functional(inplace, lambda n: positions)(
                *[a.tostype("default")._data for a in arrays], **attrs)
        return out

    return op


def _op(name, *positions, aliases=(), lazy=None, always=False):
    def deco(fn):
        register(name, num_outputs=len(positions), aliases=aliases,
                 sparse_fn=None if lazy is None else
                 _lazy_form(fn, positions, lazy, always))(
            _functional(fn, lambda n: positions))
        return fn

    return deco


@_op("sgd_update", 0, lazy="sgd_update")
@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=False):
    """``weight -= lr * g``. Returns ``weight``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    weight.copy_(weight.float() - lr * g)
    return weight


@_op("sgd_mom_update", 0, 2, lazy="sgd_mom_update")
@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False):
    """``mom = momentum * mom - lr * g``, then ``weight += mom``. ``mom`` is
    f32. Returns ``(weight, mom)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mom.mul_(momentum).sub_(lr * g)
    if weight.dtype == torch.float32:
        weight.add_(mom)
    else:
        weight.copy_(weight.float() + mom)
    return weight, mom


@_op("mp_sgd_update", 0, 2)
@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=False):
    """SGD on the f32 master ``weight32``, copied into ``weight``. Returns
    ``(weight, weight32)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight32)
    weight32.sub_(lr * g)
    _set(weight, weight32)
    return weight, weight32


@_op("mp_sgd_mom_update", 0, 2, 3)
@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=False):
    """SGD with momentum on the f32 master ``weight32``. Returns ``(weight,
    mom, weight32)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight32)
    mom.mul_(momentum).sub_(lr * g)
    weight32.add_(mom)
    _set(weight, weight32)
    return weight, mom, weight32


@_op("nag_mom_update", 0, 2)
@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov: ``mom = momentum * mom + g``, ``weight -= lr * (g +
    momentum * mom)``. Returns ``(weight, mom)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mom.mul_(momentum).add_(g)
    _set(weight, weight.float() - lr * (g + momentum * mom))
    return weight, mom


@_op("adam_update", 0, 2, 3, lazy="adam_update")
@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=False):
    """``mean = beta1 * mean + (1 - beta1) * g``, ``var = beta2 * var + (1 -
    beta2) * g^2`` (both f32), then ``weight -= lr * mean / (sqrt(var) +
    epsilon)``. ``lr`` is taken as given (the `Adam` optimizer folds the
    bias correction into it). Returns ``(weight, mean, var)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mean.mul_(beta1).add_(g * (1 - beta1))
    var.mul_(beta2).add_(g.square() * (1 - beta2))
    step = (lr * mean).div_(var.sqrt().add_(epsilon))
    if weight.dtype == torch.float32:
        weight.sub_(step)
    else:
        weight.copy_(weight.float() - step)
    return weight, mean, var


@_op("adamw_update", 0, 2, 3, aliases=("_contrib_adamw_update",))
@torch.no_grad()
def adamw_update(weight, grad, mean, var, rescale_grad=1.0, lr=0.001,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=-1.0):
    """Adam with decoupled weight decay: ``weight -= eta * (lr * mean /
    (sqrt(var) + epsilon) + wd * weight)``. Returns ``(weight, mean,
    var)``."""
    g = _grad(grad, rescale_grad, clip_gradient)
    mean.mul_(beta1).add_(g * (1 - beta1))
    var.mul_(beta2).add_(g.square() * (1 - beta2))
    w = weight.float()
    _set(weight, w - eta * (lr * mean / (var.sqrt() + epsilon) + wd * w))
    return weight, mean, var


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return torch.clamp(w, -clip_weights, clip_weights)
    return w


@_op("rmsprop_update", 0, 2)
@torch.no_grad()
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """``n = gamma1 * n + (1 - gamma1) * g^2``, ``weight -= lr * g /
    (sqrt(n) + epsilon)``. Returns ``(weight, n)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    n.mul_(gamma1).add_((1 - gamma1) * g.square())
    _set(weight, _clip_weights(weight.float() - lr * g / (n.sqrt() + epsilon),
                               clip_weights))
    return weight, n


@_op("rmspropalex_update", 0, 2, 3, 4)
@torch.no_grad()
def rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves). Returns ``(weight, n, g_state,
    delta)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    n.mul_(gamma1).add_((1 - gamma1) * g.square())
    g_state.mul_(gamma1).add_((1 - gamma1) * g)
    delta.mul_(gamma2).sub_(lr * g / torch.sqrt(n - g_state.square()
                                                + epsilon))
    _set(weight, _clip_weights(weight.float() + delta, clip_weights))
    return weight, n, g_state, delta


@_op("ftrl_update", 0, 2, 3)
@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """Follow the regularized leader. Returns ``(weight, z, n)``."""
    g = _grad(grad, rescale_grad, clip_gradient)
    w32 = weight.float()
    new_n = n + g.square()
    sigma = (new_n.sqrt() - n.sqrt()) / lr
    z.add_(g - sigma * w32)
    n.copy_(new_n)
    w = torch.where(z.abs() <= lamda1, torch.zeros_like(w32),
                    -(z - torch.sign(z) * lamda1)
                    / ((beta + n.sqrt()) / lr + wd))
    _set(weight, w)
    return weight, z, n


@_op("ftml_update", 0, 2, 3, 4)
@torch.no_grad()
def ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1):
    """Follow the moving leader at step ``t``. Returns ``(weight, d, v,
    z)``."""
    g = _prep(grad, rescale_grad, clip_grad, wd, weight)
    v.mul_(beta2).add_((1 - beta2) * g.square())
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(v / (1 - beta2 ** t))
                                   + epsilon)
    sigma = d_t - beta1 * d
    z.mul_(beta1).add_((1 - beta1) * g - sigma * weight.float())
    d.copy_(d_t)
    _set(weight, -z / d_t)
    return weight, d, v, z


@_op("signsgd_update", 0)
@torch.no_grad()
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """``weight = weight * (1 - lr * wd) - lr * sign(g)``. Returns
    ``weight``."""
    g = _grad(grad, rescale_grad, clip_gradient)
    _set(weight, weight.float() * (1 - lr * wd) - lr * torch.sign(g))
    return weight


@_op("signum_update", 0, 2)
@torch.no_grad()
def signum_update(weight, grad, mom, lr=0.01, momentum=0.9, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """``mom = momentum * mom - (1 - momentum) * g``, ``weight = weight *
    (1 - lr * wd_lh) + lr * sign(mom)``. Returns ``(weight, mom)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mom.mul_(momentum).sub_((1 - momentum) * g)
    _set(weight, weight.float() * (1 - lr * wd_lh) + lr * torch.sign(mom))
    return weight, mom


@_op("adagrad_update", 0, 2, aliases=("_sparse_adagrad_update",),
     lazy="adagrad_update", always=True)
@torch.no_grad()
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """``history += g^2``, ``weight -= lr * g / (sqrt(history) +
    epsilon)``. Returns ``(weight, history)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    history.add_(g.square())
    _set(weight, weight.float() - lr * g / (history.sqrt() + epsilon))
    return weight, history


@_op("adadelta_update", 0, 2, 3)
@torch.no_grad()
def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdaDelta. Returns ``(weight, acc_g, acc_delta)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    acc_g.mul_(rho).add_((1 - rho) * g.square())
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(acc_g + epsilon) * g
    acc_delta.mul_(rho).add_((1 - rho) * delta.square())
    _set(weight, weight.float() - delta)
    return weight, acc_g, acc_delta


@torch.no_grad()
def multi_sgd_update(*args, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    """SGD over ``num_weights`` weights, the inputs interleaved (w0, g0,
    w1, g1, ...) as the reference lays them out. Returns the weights."""
    weights, grads = args[0::2], args[1::2]
    for i in range(num_weights):
        sgd_update(weights[i], grads[i], lr=lrs[i], wd=wds[i],
                   rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    return tuple(weights[:num_weights])


@torch.no_grad()
def multi_sgd_mom_update(*args, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1):
    """SGD with momentum over (w0, g0, m0, w1, g1, m1, ...). Returns the
    weights, then the momenta."""
    weights, grads, moms = args[0::3], args[1::3], args[2::3]
    for i in range(num_weights):
        sgd_mom_update(weights[i], grads[i], moms[i], lr=lrs[i],
                       momentum=momentum, wd=wds[i],
                       rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient)
    return tuple(weights[:num_weights]) + tuple(moms[:num_weights])


register("multi_sgd_update", num_outputs=-1)(_functional(
    multi_sgd_update, lambda n: tuple(range(0, n, 2))))
register("multi_sgd_mom_update", num_outputs=-1)(_functional(
    multi_sgd_mom_update,
    lambda n: tuple(range(0, n, 3)) + tuple(range(2, n, 3))))
