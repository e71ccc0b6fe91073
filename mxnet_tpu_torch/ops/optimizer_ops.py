"""Optimizer update ops (counterpart of `mxnet_tpu/ops/optimizer_ops.py`:
`sgd_update`, `sgd_mom_update`, `adam_update`).

The JAX package's updates are pure functions that return the new weight
and state. Here they update the tensors IN PLACE (the weight, and the
momentum or moment buffers), which keeps no second copy of either; the
arithmetic is the same, in f32: ``g = clip(grad * rescale_grad) + wd *
weight``.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _prep(grad, rescale_grad, clip_gradient, wd, weight):
    g = grad.float()
    if rescale_grad != 1.0:
        g = g * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd:
        g = g + wd * weight.float()
    return g


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """In place: ``weight -= lr * g``. Returns ``weight``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    weight.copy_(weight.float() - lr * g)
    return weight


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """In place: ``mom = momentum * mom - lr * g``, then ``weight +=
    mom``. ``mom`` is f32. Returns ``(weight, mom)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mom.mul_(momentum).sub_(lr * g)
    if weight.dtype == torch.float32:
        weight.add_(mom)
    else:
        weight.copy_(weight.float() + mom)
    return weight, mom


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """In place: ``mean = beta1 * mean + (1 - beta1) * g``, ``var = beta2 *
    var + (1 - beta2) * g^2`` (both f32), then ``weight -= lr * mean /
    (sqrt(var) + epsilon)``. ``lr`` is taken as given (the `Adam`
    optimizer folds the bias correction into it). Returns ``(weight, mean,
    var)``."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mean.mul_(beta1).add_(g * (1 - beta1))
    var.mul_(beta2).add_(g.square() * (1 - beta2))
    step = (lr * mean).div_(var.sqrt().add_(epsilon))
    if weight.dtype == torch.float32:
        weight.sub_(step)
    else:
        weight.copy_(weight.float() - step)
    return weight, mean, var
