"""Neural-network ops.

Counterpart of the `mxnet_tpu/ops/nn.py` functions that the port's models
use:

* the generation path: LayerNorm with the JAX package's one-pass,
  proxy-shifted moments (`_ln_core_fwd`), the dense projection, erf GELU;
* the BERT training path: LayerNorm's hand-written backward
  (`_ln_core_bwd`), the clipped embedding gather, dropout;
* the ResNet training path: convolution, pooling, the fully-connected
  layer, activations, BatchNorm / BatchNormRelu / BatchNormAddRelu
  (`_bn_act`), log-softmax and softmax cross-entropy;
* ``mx.nd``: ``softmax`` (with ``temperature`` and ``length``) and
  ``log_softmax``, registered as ops (`mxnet_tpu/ops/nn.py` ``softmax``,
  ``log_softmax``).

Layouts are the JAX package's: a channels-last activation is a logical
(N, *spatial, C) tensor and its conv weight is (O, *k, I). Convolution and
pooling hand PyTorch (cuDNN on the card) permuted views of those tensors,
which are channels-last in memory, so no copy is made; the JAX package
left these ops to XLA. Training-mode BatchNorm goes through
`pallas_kernels.conv_epilogue`, whose four hand-written kernels run for
CUDA tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import register
from .tensor import _inexact

__all__ = ["layer_norm", "embedding", "dropout", "dense", "gelu",
           "convolution", "pooling",
           "fully_connected", "activation", "batch_norm", "batch_norm_relu",
           "batch_norm_add_relu", "softmax", "log_softmax",
           "softmax_cross_entropy"]


def _ln_fwd(data, gamma, beta, eps):
    """`_ln_core_fwd`: the output and the f32 row mean and inverse std."""
    proxy = data[..., 0:1].float()
    d = data.float() - proxy
    s1 = d.mean(dim=-1, keepdim=True)
    s2 = d.square().mean(dim=-1, keepdim=True)
    mean = proxy + s1
    inv = torch.rsqrt(torch.clamp(s2 - s1.square(), min=0.0) + eps)
    dt = data.dtype
    xhat = (data - mean.to(dt)) * inv.to(dt)
    return xhat * gamma.to(dt) + beta.to(dt), mean, inv


class _LayerNorm(torch.autograd.Function):
    """The JAX package's custom_vjp `_ln_core`: the backward is
    `_ln_core_bwd`, with dgamma and dbeta summed in f32, the row
    corrections m1 and m2 in f32, and dx in the input dtype."""

    @staticmethod
    def forward(ctx, data, gamma, beta, eps):
        out, mean, inv = _ln_fwd(data, gamma, beta, eps)
        ctx.save_for_backward(data, gamma, mean, inv)
        ctx.beta_dtype = beta.dtype
        return out

    @staticmethod
    def backward(ctx, ct):
        data, gamma, mean, inv = ctx.saved_tensors
        dt = data.dtype
        red = tuple(range(data.dim() - 1))
        xhat = (data - mean.to(dt)) * inv.to(dt)
        dgamma = (ct * xhat).float().sum(dim=red)
        dbeta = ct.float().sum(dim=red)
        g = ct * gamma.to(dt)
        m1 = g.float().mean(dim=-1, keepdim=True)
        m2 = (g * xhat).float().mean(dim=-1, keepdim=True)
        dx = inv.to(dt) * (g - m1.to(dt) - xhat * m2.to(dt))
        return dx, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), None


def layer_norm(data, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis. Both moments come from one pass over
    ``d = x - proxy``, where the proxy is the row's first element, so the
    ``E[d^2] - E[d]^2`` form cannot cancel catastrophically for
    large-mean/small-spread rows. Moments are f32; the normalize runs in
    the input dtype. The gradient is the JAX package's hand-written one
    (`_LayerNorm`), not autograd through the forward."""
    return _LayerNorm.apply(data, gamma, beta, float(eps))


def embedding(data, weight):
    """Rows of ``weight`` (V, C) at the integer indices ``data``, clipped to
    [0, V-1] (the JAX package's ``mode="clip"``)."""
    return F.embedding(data.long().clamp(0, weight.shape[0] - 1), weight)


def dropout(data, p=0.5, is_train=False, generator=None):
    """Inverted dropout: each element kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)``, in the input dtype; the identity when
    ``p <= 0`` or not training. The keep mask is drawn from ``generator``
    (on data's device); it cannot reproduce the JAX package's threefry
    bits."""
    if not is_train or p <= 0.0:
        return data
    keep = 1.0 - p
    mask = torch.rand(data.shape, generator=generator, device=data.device)
    return data * (mask < keep).to(data.dtype) / keep


def dense(x, weight, bias=None):
    """``x @ weight.T + bias`` with the (units, in_units) weight layout."""
    return F.linear(x, weight, bias)


def gelu(x):
    """Exact (erf) GELU, as ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x, approximate="none")


# --------------------------------------------------------------------------
# layouts
# --------------------------------------------------------------------------

def _channels_last(layout):
    return layout is not None and str(layout).endswith("C") \
        and len(str(layout)) > 2


def _tup(v, n, default):
    if v is None or v == ():
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(i) for i in v)



# --------------------------------------------------------------------------
# FullyConnected, Convolution, Pooling, Activation
# --------------------------------------------------------------------------

def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T (+ bias)``, weight (num_hidden, in_units); with
    ``flatten`` the input is first reshaped to (N, -1)."""
    if data.dim() < 1:
        raise MXNetError("FullyConnected: data must have at least 1 "
                         "dimension, got shape %s" % (tuple(data.shape),))
    x = data.reshape(data.shape[0], -1) if flatten else data
    return F.linear(x, weight, bias)


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_group=1, layout=None):
    """2-D convolution over (N, C, H, W) with an (O, I, kh, kw) weight or,
    with the channels-last ``layout`` "NHWC", over (N, H, W, C) with an
    (O, kh, kw, I) weight. The channels-last case hands PyTorch (cuDNN on
    the card) the views ``data.permute(0, 3, 1, 2)`` and
    ``weight.permute(0, 3, 1, 2)``, channels-last in memory, and permutes
    the result back: a contiguous channels-last input gives a contiguous
    channels-last output, and no copy is made."""
    if data.dim() != 4:
        raise MXNetError("Convolution: 2-D convolution only in the port, "
                         "got shape %s" % (tuple(data.shape),))
    ch_last = _channels_last(layout)
    w_spatial = tuple(weight.shape[1:3] if ch_last else weight.shape[2:])
    if kernel and _tup(kernel, 2, 0) != w_spatial:
        raise MXNetError("Convolution: kernel attr %s != weight spatial "
                         "shape %s" % (tuple(kernel), w_spatial))
    if ch_last:
        data = data.permute(0, 3, 1, 2)
        weight = weight.permute(0, 3, 1, 2)
    out = F.conv2d(data, weight, bias, stride=_tup(stride, 2, 1),
                   padding=_tup(pad, 2, 0), dilation=_tup(dilate, 2, 1),
                   groups=int(num_group))
    return out.permute(0, 2, 3, 1) if ch_last else out


def pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
            pad=(), pooling_convention="valid", layout=None):
    """2-D max pooling (padded with -inf), or the global average pool
    (``global_pool``, pool_type "avg": the mean over the spatial extent,
    taken in f32 and kept as 1 x 1), of (N, C, H, W), or (N, H, W, C)
    under the channels-last layout. ``pooling_convention="full"`` gives
    MXNet's ceil((H + 2 p - k) / s) + 1 windows a side: the bottom and right
    are padded with -inf up to that size, so a last window that starts in
    the padding is kept (PyTorch's ``ceil_mode`` drops it). The other pool
    types are not ported yet."""
    if data.dim() != 4:
        raise MXNetError("Pooling: 2-D pooling only in the port, got shape "
                         "%s" % (tuple(data.shape),))
    ch_last = _channels_last(layout)
    if global_pool and pool_type == "avg":
        dims = (1, 2) if ch_last else (2, 3)
        return data.float().mean(dim=dims, keepdim=True).to(data.dtype)
    if global_pool or pool_type != "max":
        raise MXNetError("Pooling: %s%s pooling is not ported yet"
                         % ("global " if global_pool else "", pool_type))
    x = data.permute(0, 3, 1, 2) if ch_last else data
    kernel, stride = _tup(kernel, 2, 1), _tup(stride, 2, 1)
    pad = _tup(pad, 2, 0)
    if pooling_convention == "full":
        extra = []
        for size, k, s, p in zip(x.shape[2:], kernel, stride, pad):
            out_d = -(-(size + 2 * p - k) // s) + 1
            extra.append(max((out_d - 1) * s + k - (size + 2 * p), 0))
        x = F.pad(x, (0, extra[1], 0, extra[0]), value=float("-inf"))
    out = F.max_pool2d(x, kernel, stride, pad)
    return out.permute(0, 2, 3, 1) if ch_last else out


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh}


def activation(data, act_type="relu"):
    """relu, sigmoid or tanh."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError("Activation: unsupported act_type %r" % act_type)
    return fn(data)


# --------------------------------------------------------------------------
# BatchNorm (+ add) (+ ReLU)
# --------------------------------------------------------------------------

# rows of the stats proxy (the kernels' kProxyRows)
_BN_PROXY_ROWS = 8


def _bn_stats(x2d):
    """Per-channel batch mean and biased variance, f32 (C,), of rows x2d
    (R, C) in one pass: both moments come from ``d = x - proxy``, where the
    proxy is the mean of the first 8 rows (held constant), so
    ``E[d^2] - E[d]^2`` cannot cancel catastrophically for
    large-mean/small-spread channels; var is clamped at 0. The plain
    version of the ``epi_stats`` kernel's first pass; which rows make the
    proxy is not part of the result."""
    xf = x2d.float()
    proxy = xf[:_BN_PROXY_ROWS].mean(dim=0).detach()
    d = xf - proxy
    s1 = d.mean(dim=0)
    s2 = d.square().mean(dim=0)
    return proxy + s1, torch.clamp(s2 - s1.square(), min=0.0)


def _bn_frozen(data, gamma, beta, mean, var, ax, eps, fix_gamma):
    """Normalize with given statistics (inference or use_global_stats):
    per-channel scale and shift in f32, rounded once to the input dtype,
    then one multiply-add in the input dtype."""
    inv = torch.rsqrt(var.float() + eps)
    g = torch.ones_like(inv) if fix_gamma else gamma.float()
    scale = g * inv
    shift = beta.float() - mean.float() * scale
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    dt = data.dtype
    return data * scale.to(dt).reshape(bshape) \
        + shift.to(dt).reshape(bshape)


def _bn_act(data, addend, gamma, beta, moving_mean, moving_var, eps,
            momentum, fix_gamma, use_global_stats, axis, act, is_train):
    """Shared BatchNorm(+add)(+ReLU) core behind `batch_norm`,
    `batch_norm_relu` and `batch_norm_add_relu`. Returns
    ``(out, moving_mean, moving_var)``; in training the moving statistics
    are updated IN PLACE (``m = m * momentum + batch * (1 - momentum)``,
    with the biased batch variance, as the JAX package's functional update)
    and the same tensors are returned.

    Training with batch statistics goes through
    `pallas_kernels.conv_epilogue` (its kernels for CUDA tensors). With the
    channel axis last, as in the channels-last models, the (R, C) view is
    free; another channel axis is moved last first, which costs a copy in
    and out (the JAX package's channels-first path ran plain jnp
    instead)."""
    ax = axis % data.dim()
    eps = float(eps)
    fix_gamma = bool(fix_gamma)
    relu = act == "relu"
    if act not in (None, "relu"):
        raise MXNetError("BatchNorm: unsupported act_type %r" % act)
    if is_train and not use_global_stats:
        from . import pallas_kernels

        if gamma.dtype != beta.dtype:   # one of them frozen outside amp
            gamma = gamma.to(beta.dtype)

        last = ax == data.dim() - 1
        x = data if last else data.movedim(ax, -1).contiguous()
        res = addend
        if addend is not None and not last:
            res = addend.movedim(ax, -1).contiguous()
        out, mean, var = pallas_kernels.conv_epilogue(
            x, gamma, beta, res, eps=eps, fix_gamma=fix_gamma, relu=relu)
        if not last:
            out = out.movedim(-1, ax)
        with torch.no_grad():
            moving_mean.mul_(momentum).add_(
                mean.to(moving_mean.dtype) * (1 - momentum))
            moving_var.mul_(momentum).add_(
                var.to(moving_var.dtype) * (1 - momentum))
        return out, moving_mean, moving_var
    out = _bn_frozen(data, gamma, beta, moving_mean, moving_var, ax, eps,
                     fix_gamma)
    if addend is not None:
        out = out + addend
    if relu:
        out = torch.relu(out)
    return out, moving_mean, moving_var


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
               is_train=False):
    """BatchNorm; returns ``(out, moving_mean, moving_var)`` (see
    `_bn_act`: the moving statistics are updated in place in training)."""
    return _bn_act(data, None, gamma, beta, moving_mean, moving_var, eps,
                   momentum, fix_gamma, use_global_stats, axis, None,
                   is_train)


def batch_norm_relu(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                    momentum=0.9, fix_gamma=True, use_global_stats=False,
                    axis=1, act_type="relu", is_train=False):
    """BatchNorm + ReLU as one op (the fused conv epilogue)."""
    if act_type != "relu":
        raise MXNetError("BatchNormRelu: unsupported act_type %r" % act_type)
    return _bn_act(data, None, gamma, beta, moving_mean, moving_var, eps,
                   momentum, fix_gamma, use_global_stats, axis, act_type,
                   is_train)


def batch_norm_add_relu(data, addend, gamma, beta, moving_mean, moving_var,
                        eps=1e-3, momentum=0.9, fix_gamma=True,
                        use_global_stats=False, axis=1, act_type="relu",
                        is_train=False):
    """BatchNorm + residual add + ReLU as one op, the ResNet block tail:
    ``out = relu(bn(data) + addend)``."""
    if act_type != "relu":
        raise MXNetError("BatchNormAddRelu: unsupported act_type %r"
                         % act_type)
    return _bn_act(data, addend, gamma, beta, moving_mean, moving_var, eps,
                   momentum, fix_gamma, use_global_stats, axis, act_type,
                   is_train)


# --------------------------------------------------------------------------
# softmax family
# --------------------------------------------------------------------------

@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None):
    """Softmax along ``axis``; integer input is promoted to float32 first,
    as jax.nn.softmax does."""
    data = _inexact(data)
    x = data if temperature in (None, 1.0) else data / temperature
    if length is not None:
        steps = torch.arange(data.shape[axis], device=data.device)
        bshape = [1] * data.ndim
        bshape[axis] = data.shape[axis]
        mask = steps.reshape(bshape) < length.reshape(
            (-1,) + (1,) * (data.ndim - 1))
        x = torch.where(mask, x, torch.full((), float("-inf"),
                                            dtype=x.dtype, device=x.device))
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    """Log-softmax along ``axis``; integer input is promoted to float32
    first, as jax.nn.log_softmax does."""
    data = _inexact(data)
    x = data if temperature in (None, 1.0) else data / temperature
    return torch.log_softmax(x, dim=axis)


def softmax_cross_entropy(data, label):
    """Summed negative log-likelihood of integer ``label`` (N,) under
    ``log_softmax(data)`` (N, K)."""
    logp = torch.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.long()[:, None]).sum()
