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
  ``log_softmax``);
* ``mx.nd`` and ``mx.sym``: the registered layers ``FullyConnected``,
  ``Convolution``, ``Pooling``, ``BatchNorm`` (3 outputs, 1 visible),
  ``Activation`` and ``Dropout`` over the functions above, and the loss
  heads ``SoftmaxOutput`` / ``Softmax``, ``LinearRegressionOutput``,
  ``LogisticRegressionOutput``, ``MAERegressionOutput`` and ``MakeLoss``:
  autograd Functions whose backward ignores the head gradient, as the
  reference's loss heads do.

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
           "convolution", "deconvolution", "pooling", "instance_norm",
           "l2_normalization", "lrn", "leaky_relu", "im2col", "col2im",
           "upsampling", "correlation", "identity_attach_kl_sparse_reg",
           "fully_connected", "activation", "batch_norm", "batch_norm_relu",
           "batch_norm_add_relu", "softmax", "log_softmax",
           "softmax_cross_entropy", "softmax_output"]


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


def dropout(data, p=0.5, is_train=False, generator=None, axes=()):
    """Inverted dropout: each element kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)``, in the input dtype; the identity when
    ``p <= 0`` or not training. The keep mask is drawn from ``generator``
    (on data's device), one value shared along each of ``axes``; it cannot
    reproduce the JAX package's threefry bits."""
    if not is_train or p <= 0.0:
        return data
    keep = 1.0 - p
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    mask = torch.rand(shape, generator=generator, device=data.device)
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


def _to_channels_first(x, ch_last):
    """(N, *spatial, C) -> the (N, C, *spatial) view, channels-last in
    memory (no copy); the identity for a channels-first tensor."""
    return x.movedim(-1, 1) if ch_last else x


def _from_channels_first(x, ch_last):
    return x.movedim(1, -1) if ch_last else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _nspatial(data, what):
    nsp = data.dim() - 2
    if nsp not in (1, 2, 3):
        raise MXNetError("%s: 1-D, 2-D or 3-D data only, got shape %s"
                         % (what, tuple(data.shape)))
    return nsp


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_group=1, layout=None):
    """1-D, 2-D or 3-D convolution over (N, C, *spatial) with an
    (O, I/g, *k) weight or, under a channels-last ``layout`` ("NWC",
    "NHWC", "NDHWC"), over (N, *spatial, C) with an (O, *k, I/g) weight.
    The channels-last case hands PyTorch (cuDNN on the card) the views with
    the channel axis moved to 1, channels-last in memory, and moves it back
    in the result: a contiguous channels-last input gives a contiguous
    channels-last output, and no copy is made."""
    nsp = _nspatial(data, "Convolution")
    ch_last = _channels_last(layout)
    w_spatial = tuple(weight.shape[1:-1] if ch_last else weight.shape[2:])
    if kernel and _tup(kernel, nsp, 0) != w_spatial:
        raise MXNetError("Convolution: kernel attr %s != weight spatial "
                         "shape %s" % (tuple(kernel), w_spatial))
    out = _CONV[nsp](_to_channels_first(data, ch_last),
                     _to_channels_first(weight, ch_last), bias,
                     stride=_tup(stride, nsp, 1), padding=_tup(pad, nsp, 0),
                     dilation=_tup(dilate, nsp, 1), groups=int(num_group))
    return _from_channels_first(out, ch_last)


def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_group=1, layout=None):
    """Transposed convolution with the JAX package's weight: (I, O/g, *k),
    or (I, *k, O/g) under a channels-last layout. Each side's output is
    ``(in - 1) * stride - 2 * pad + dilate * (k - 1) + 1 + adj``, ``adj``
    computed from ``target_shape`` when one is given. PyTorch's transposed
    convolution runs without padding (its weight layout is the same), and
    the window ``[pad, pad + out)`` of that full output is taken, zeros
    beyond its end: so any ``adj`` works, where PyTorch's own
    ``output_padding`` must stay below the stride."""
    nsp = _nspatial(data, "Deconvolution")
    ch_last = _channels_last(layout)
    x = _to_channels_first(data, ch_last)
    w = _to_channels_first(weight, ch_last)
    stride, dilate = _tup(stride, nsp, 1), _tup(dilate, nsp, 1)
    pad, adj = _tup(pad, nsp, 0), _tup(adj, nsp, 0)
    k = w.shape[2:]
    if target_shape:
        adj = tuple(int(target_shape[i]) - ((x.shape[2 + i] - 1) * stride[i]
                                            - 2 * pad[i]
                                            + dilate[i] * (k[i] - 1) + 1)
                    for i in range(nsp))
    full = _DECONV[nsp](x, w, None, stride=stride, groups=int(num_group),
                        dilation=dilate)
    index = [slice(None), slice(None)]
    grow = []
    for i in range(nsp):
        size = (x.shape[2 + i] - 1) * stride[i] - 2 * pad[i] \
            + dilate[i] * (k[i] - 1) + 1 + adj[i]
        index.append(slice(pad[i], pad[i] + size))
        grow.append(max(pad[i] + size - full.shape[2 + i], 0))
    out = full[tuple(index)]
    if any(grow):
        pads = []
        for g in reversed(grow):
            pads += [0, g]
        out = F.pad(out, pads)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nsp).to(out.dtype)
    return _from_channels_first(out, ch_last)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pad_spatial(x, pads, value):
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _torch_pad(pads, kernel):
    """The padding a PyTorch pool takes itself for ``pads`` (its implicit
    padding is symmetric and at most half the window), else None."""
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        return tuple(lo for lo, _ in pads)
    return None


def _window_mean(x, kernel, stride, pads):
    """Mean of every window of the zero-padded channels-first floating
    ``x``, the padding counted: PyTorch's avg pool, which accumulates a
    bf16 window in f32 and rounds the mean once. The JAX package sums bf16
    windows in bf16 (`lax.reduce_window`), so the port's bf16 results are
    the closer ones, within a few bf16 steps of it. The padding is made
    explicitly, never by the pool: on the card (PyTorch 2.11, CUDA 12.8,
    H100) the avg pool's backward over a channels-last tensor with
    implicit padding gives wrong input gradients (its forward is right),
    and explicit zeros then a pool without padding compute the same mean,
    gradient included."""
    return _AVG_POOL[len(kernel)](_pad_spatial(x, pads, 0.0), kernel,
                                  stride, 0, count_include_pad=True)


def _window_sum(x, kernel, stride, pads):
    """Sum of every window of the zero-padded channels-first ``x``, in f32
    for a bf16 or f16 ``x`` (see `_window_mean`) and in f64 for an integer
    one."""
    if not x.is_floating_point():
        x = x.double()
    elif x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    n = 1
    for k in kernel:
        n *= k
    return _window_mean(x, kernel, stride, pads) * n


def _int_window_max(x, kernel, stride, pads):
    """Max of every window of an integer channels-first ``x`` padded with the
    dtype's minimum (PyTorch's max pools take floats only)."""
    x = _pad_spatial(x, pads, torch.iinfo(x.dtype).min)
    for i, (k, s) in enumerate(zip(kernel, stride)):
        x = x.unfold(2 + i, k, s)
    return x.flatten(-len(kernel)).amax(-1)


def pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
            pad=(), pooling_convention="valid", count_include_pad=True,
            p_value=2, layout=None):
    """1-D, 2-D or 3-D pooling (`mxnet_tpu/ops/nn.py` ``pooling``) of
    (N, C, *spatial), or (N, *spatial, C) under a channels-last layout:
    ``pool_type`` max (padded with -inf, or the integer dtype's minimum),
    avg, sum or lp (``(sum |x|^p)^(1/p)``); ``global_pool`` takes the whole
    spatial extent as the window. ``pooling_convention="full"`` gives
    MXNet's ceil((size + 2 p - k) / s) + 1 windows a side: the bottom and
    right are padded up to that size, and that padding is part of every
    window it reaches: an avg window with ``count_include_pad`` divides by
    its full size, PyTorch's ``ceil_mode`` would drop the padding (and a
    last window that starts in it). ``count_include_pad=False`` divides by
    the count of real elements. Window means and sums accumulate in f32 (see
    `_window_mean`), and so does the global average, a mean over the
    spatial axes."""
    nsp = _nspatial(data, "Pooling")
    ch_last = _channels_last(layout)
    if global_pool and pool_type == "avg":
        dims = tuple(range(1, 1 + nsp) if ch_last else range(2, 2 + nsp))
        out = data.float().mean(dim=dims, keepdim=True)
        return out.to(data.dtype if data.is_floating_point()
                      else torch.float32)
    x = _to_channels_first(data, ch_last)
    if global_pool:
        kernel, stride, pad = tuple(x.shape[2:]), (1,) * nsp, (0,) * nsp
    else:
        kernel, stride = _tup(kernel, nsp, 1), _tup(stride, nsp, 1)
        pad = _tup(pad, nsp, 0)
    pads = []
    for size, k, s, p in zip(x.shape[2:], kernel, stride, pad):
        hi = p
        if pooling_convention == "full" and not global_pool:
            out_d = -(-(size + 2 * p - k) // s) + 1
            hi += max((out_d - 1) * s + k - (size + 2 * p), 0)
        pads.append((p, hi))
    floating = x.is_floating_point()
    if pool_type == "max":
        if not floating:
            out = _int_window_max(x, kernel, stride, pads)
        else:
            tp = _torch_pad(pads, kernel)
            if tp is None:
                x, tp = _pad_spatial(x, pads, float("-inf")), 0
            out = _MAX_POOL[nsp](x, kernel, stride, tp)
        return _from_channels_first(out, ch_last)
    if pool_type not in ("avg", "sum", "lp"):
        raise MXNetError("Pooling: unknown pool_type %r" % (pool_type,))
    if pool_type == "avg" and count_include_pad and floating:
        return _from_channels_first(_window_mean(x, kernel, stride, pads),
                                    ch_last)
    src = x.abs().pow(p_value) if pool_type == "lp" else x
    s = _window_sum(src, kernel, stride, pads)
    if pool_type == "sum":
        out = s.to(x.dtype)
    else:
        if pool_type == "lp":
            out = s.pow(1.0 / p_value)
        elif count_include_pad:
            n = 1
            for k in kernel:
                n *= k
            out = s / n
        else:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=s.dtype,
                              device=x.device)
            out = s / _window_sum(ones, kernel, stride, pads)
        # an integer input's mean or norm is f32, as jnp's true division
        out = out.to(x.dtype if floating else torch.float32)
    return _from_channels_first(out, ch_last)


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


def activation(data, act_type="relu"):
    """relu, sigmoid, tanh, softrelu (softplus) or softsign."""
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

        # the kernels take dense (R, C) rows: a channels-last activation
        # is one already (no copy) unless an op before it left it strided
        # (a convolution whose output is not channels-last in memory); a
        # channel axis elsewhere is moved last, a copy in and out
        last = ax == data.dim() - 1
        x = data.contiguous() if last else data.movedim(ax, -1).contiguous()
        res = addend
        if addend is not None:
            res = addend.contiguous() if last \
                else addend.movedim(ax, -1).contiguous()
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


# --------------------------------------------------------------------------
# registered layers: the JAX package's op signatures over the functions
# above (the symbol layer reads the array slots and attrs from them)
# --------------------------------------------------------------------------

@register("FullyConnected")
def _fully_connected_op(data, weight, bias=None, num_hidden=None,
                        no_bias=False, flatten=True):
    return fully_connected(data, weight, None if no_bias else bias,
                           flatten=flatten)


@register("Convolution")
def _convolution_op(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                    pad=(), num_filter=0, num_group=1, no_bias=False,
                    cudnn_tune=None, cudnn_off=False, workspace=1024,
                    layout=None):
    return convolution(data, weight, None if no_bias else bias, kernel,
                       stride, dilate, pad, num_group, layout)


@register("Pooling")
def _pooling_op(data, kernel=(), pool_type="max", global_pool=False,
                stride=(), pad=(), pooling_convention="valid",
                count_include_pad=True, p_value=2, cudnn_off=False,
                layout=None):
    return pooling(data, kernel, pool_type, global_pool, stride, pad,
                   pooling_convention, count_include_pad, p_value, layout)


@register("BatchNorm", num_outputs=3, num_visible_outputs=1)
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False,
                   is_train=False):
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps,
                      momentum, fix_gamma, use_global_stats, axis, is_train)


@register("BatchNormRelu", aliases=("_contrib_BatchNormRelu",),
          num_outputs=3, num_visible_outputs=1)
def _batch_norm_relu_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                        momentum=0.9, fix_gamma=True, use_global_stats=False,
                        output_mean_var=False, axis=1, act_type="relu",
                        cudnn_off=False, is_train=False):
    return batch_norm_relu(data, gamma, beta, moving_mean, moving_var, eps,
                           momentum, fix_gamma, use_global_stats, axis,
                           act_type, is_train)


@register("BatchNormAddRelu", aliases=("_contrib_BatchNormAddRelu",),
          num_outputs=3, num_visible_outputs=1)
def _batch_norm_add_relu_op(data, addend, gamma, beta, moving_mean,
                            moving_var, eps=1e-3, momentum=0.9,
                            fix_gamma=True, use_global_stats=False,
                            output_mean_var=False, axis=1, act_type="relu",
                            cudnn_off=False, is_train=False):
    return batch_norm_add_relu(data, addend, gamma, beta, moving_mean,
                               moving_var, eps, momentum, fix_gamma,
                               use_global_stats, axis, act_type, is_train)


@register("Activation")
def _activation_op(data, act_type="relu"):
    return activation(data, act_type)


@register("Dropout", needs_rng=True)
def _dropout_op(data, p=0.5, mode="training", axes=(), cudnn_off=False,
                is_train=False, generator=None):
    return dropout(data, p, is_train or mode == "always", generator,
                   tuple(axes))


@register("Deconvolution")
def _deconvolution_op(data, weight, bias=None, kernel=(), stride=(),
                      dilate=(), pad=(), adj=(), target_shape=(),
                      num_filter=0, num_group=1, no_bias=True,
                      cudnn_tune=None, cudnn_off=False, workspace=1024,
                      layout=None):
    return deconvolution(data, weight, None if no_bias else bias, kernel,
                         stride, dilate, pad, adj, target_shape, num_group,
                         layout)


# --------------------------------------------------------------------------
# normalizations and activations of the reference's nn family
# (`mxnet_tpu/ops/nn.py` LayerNorm, InstanceNorm, L2Normalization, LRN,
# LeakyReLU)
# --------------------------------------------------------------------------

@register("LayerNorm")
def _layer_norm_op(data, gamma, beta, axis=-1, eps=1e-5,
                   output_mean_var=False):
    """`layer_norm` over ``axis`` (moved last and back for another axis)."""
    ax = axis % data.dim()
    if ax == data.dim() - 1:
        return layer_norm(data, gamma, beta, eps)
    return layer_norm(data.movedim(ax, -1), gamma, beta, eps).movedim(-1, ax)


@register("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    """Normalize each (sample, channel) over the spatial axes 2.. with its
    own mean and biased variance; gamma and beta per channel (axis 1)."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, keepdim=True, correction=0)
    out = (data - mean) * torch.rsqrt(var + eps)
    bshape = (1, data.shape[1]) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data^2) + eps)``, the sum over every axis but the
    batch ("instance"), over the channels ("channel", axis 1) or over the
    spatial axes ("spatial")."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    return data / torch.sqrt(data.square().sum(dim=red, keepdim=True) + eps)


@register("LRN")
def lrn(data, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across channels (axis 1):
    ``data / (knorm + alpha / nsize * s)^beta``, s the sum of squares over
    a window of ``nsize`` channels centred on each (zeros beyond the
    ends)."""
    half = nsize // 2
    sq = data.square()
    pad = [0, 0] * (data.dim() - 2) + [half, half]
    sqp = F.pad(sq, pad)
    n_out = sqp.shape[1] - nsize + 1
    s = sum(sqp[:, i:i + n_out] for i in range(nsize))
    return data / torch.pow(knorm + (alpha / nsize) * s, beta)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU")
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """leaky (``slope * x`` below 0), prelu (a learned ``gamma`` a channel,
    axis 1), elu (``slope * expm1(x)``), selu, gelu (erf) or rrelu. Each
    takes the ``x >= 0`` branch at 0, as the JAX package's ``jnp.where``
    does, gradient included. rrelu uses the mean slope ``(lower_bound +
    upper_bound) / 2`` in training too, as the JAX package does: it draws
    no random slope, so the op takes no generator."""
    pos = data >= 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        bshape = (1, -1) + (1,) * (data.dim() - 2) if data.dim() > 1 \
            else (-1,)
        return torch.where(pos, data, gamma.reshape(bshape) * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(pos, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return gelu(data)
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(pos, data, mid * data)
    raise MXNetError("LeakyReLU: unknown act_type %r" % (act_type,))


# --------------------------------------------------------------------------
# patches, resampling and the rest (`mxnet_tpu/ops/nn.py` im2col, col2im,
# softmax_cross_entropy, UpSampling, Correlation,
# IdentityAttachKLSparseReg)
# --------------------------------------------------------------------------

def _pair2(v, default):
    return tuple(int(i) for i in v) if v else (default, default)


@register("im2col")
def im2col(data, kernel=(), stride=(), dilate=(), pad=()):
    """Sliding 2-D windows of (N, C, H, W) as columns: (N, C * kh * kw, L),
    the channel slowest, L the windows in row-major order."""
    return F.unfold(data, tuple(int(k) for k in kernel),
                    dilation=_pair2(dilate, 1), padding=_pair2(pad, 0),
                    stride=_pair2(stride, 1))


@register("col2im")
def col2im(data, output_size=(), kernel=(), stride=(), dilate=(), pad=()):
    """`im2col`'s transpose: columns (N, C * kh * kw, L) summed back into
    an (N, C, H, W) image of ``output_size`` (H, W)."""
    return F.fold(data, tuple(int(s) for s in output_size),
                  tuple(int(k) for k in kernel), dilation=_pair2(dilate, 1),
                  padding=_pair2(pad, 0), stride=_pair2(stride, 1))


register("softmax_cross_entropy")(softmax_cross_entropy)


def _bilinear_upsample(data, scale):
    """``jax.image.resize(method="bilinear")`` to scale x the size: half-
    pixel centres, and at the borders the weights of the taps inside the
    image renormalised to 1 (PyTorch's align_corners=False clamps the
    coordinate instead; the two agree inside the image)."""
    n, c, h, w = data.shape
    out = data
    for axis, size in ((2, h), (3, w)):
        pos = (torch.arange(size * scale, dtype=torch.float64) + 0.5) \
            / scale - 0.5
        lo = torch.floor(pos)
        frac = pos - lo
        lo = lo.long()
        taps, weights = [], []
        for off, wt in ((0, 1.0 - frac), (1, frac)):
            idx = lo + off
            inside = (idx >= 0) & (idx < size)
            taps.append(idx.clamp(0, size - 1))
            weights.append(torch.where(inside, wt, torch.zeros_like(wt)))
        total = weights[0] + weights[1]
        shape = [1] * 4
        shape[axis] = -1
        acc = None
        for idx, wt in zip(taps, weights):
            wt = (wt / total).to(out.dtype).to(out.device).reshape(shape)
            term = out.index_select(axis, idx.to(out.device)) * wt
            acc = term if acc is None else acc + term
        out = acc
    return out


@register("UpSampling")
def upsampling(*args, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest-neighbour upsampling of (N, C, H, W) by ``scale`` (several
    inputs each brought to the first's size x scale, then concatenated on
    the channels or summed), or bilinear resizing of the first input."""
    data = args[0]
    scale = int(scale)
    if sample_type == "nearest":
        outs = []
        for d in args:
            s = scale if not outs else data.shape[2] * scale // d.shape[2]
            outs.append(d.repeat_interleave(s, dim=2)
                        .repeat_interleave(s, dim=3))
        if len(outs) == 1:
            return outs[0]
        if multi_input_mode == "sum":
            return sum(outs)
        return torch.cat(outs, dim=1)
    return _bilinear_upsample(data, scale)


@register("Correlation")
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation of two (N, C, H, W) maps: for each
    displacement (dy, dx) on the ``stride2`` grid within
    ``max_displacement``, the product (or absolute difference) of a
    ``kernel_size`` patch of ``data1`` with the displaced patch of
    ``data2``, averaged over the channels and the patch; channels
    dy-major."""
    b, c, h, w = data1.shape
    kr = (kernel_size - 1) // 2
    border = max_displacement + kr
    p1 = F.pad(data1, [pad_size] * 4)
    p2 = F.pad(data2, [pad_size] * 4)
    ph, pw = h + 2 * pad_size, w + 2 * pad_size
    out_h = -(-(ph - 2 * border) // stride1)
    out_w = -(-(pw - 2 * border) // stride1)
    rad = max_displacement // stride2
    md = max_displacement
    p2x = F.pad(p2, [md] * 4)
    norm = float(c * kernel_size * kernel_size)
    chans = []
    for dy in range(-rad, rad + 1):
        for dx in range(-rad, rad + 1):
            oy, ox = md + dy * stride2, md + dx * stride2
            shifted = p2x[:, :, oy:oy + ph, ox:ox + pw]
            prod = p1 * shifted if is_multiply else (p1 - shifted).abs()
            box = F.avg_pool2d(prod.sum(dim=1, keepdim=True), kernel_size,
                               1) * (kernel_size * kernel_size)
            y0 = border - kr
            chans.append(box[:, :, y0:y0 + (out_h - 1) * stride1 + 1:stride1,
                             y0:y0 + (out_w - 1) * stride1 + 1:stride1]
                         / norm)
    return torch.cat(chans, dim=1)


@register("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1, penalty=0.001,
                                  momentum=0.9):
    """The identity, as in the JAX package (which attaches no KL
    penalty)."""
    return data


# --------------------------------------------------------------------------
# loss heads: the forward is the prediction, the backward the loss's
# gradient, whatever head gradient arrives (the reference's loss-head
# convention; the JAX package's custom_vjp ops)
# --------------------------------------------------------------------------

class _SoftmaxOutput(torch.autograd.Function):
    """softmax forward; backward ``(p - onehot(label)) * grad_scale``, with
    label smoothing, ignored labels and the "batch" / "valid"
    normalizations of the JAX package's `softmax_output`."""

    @staticmethod
    def forward(ctx, data, label, axis, grad_scale, ignore_label,
                use_ignore, normalization, smooth_alpha):
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.attrs = (axis, grad_scale, ignore_label, use_ignore,
                     normalization, smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, _ct):
        out, lab = ctx.saved_tensors
        axis, grad_scale, ignore_label, use_ignore, normalization, \
            smooth_alpha = ctx.attrs
        depth = out.shape[axis]
        li = lab.long()
        # the class axis of out, where the label has none: last, or 1
        cls = li.dim() if axis == -1 else axis
        bshape = [1] * out.dim()
        bshape[cls] = depth
        pos = torch.arange(depth, device=out.device).reshape(bshape)
        onehot = (li.unsqueeze(cls) == pos).to(out.dtype)
        if smooth_alpha:
            onehot = onehot * (1 - smooth_alpha) \
                + smooth_alpha / (depth - 1) * (1 - onehot)
        grad = out - onehot
        valid = None
        if use_ignore:
            keep = (li != int(ignore_label)).to(out.dtype)
            grad = grad * keep.unsqueeze(cls)
            valid = keep.sum()
        if normalization == "batch":
            grad = grad / out.shape[0]
        elif normalization == "valid":
            grad = grad / (torch.clamp(valid, min=1.0) if valid is not None
                           else out.shape[0])
        return (grad * grad_scale,) + (None,) * 7


@register("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    """Softmax over the last axis (over axis 1 with ``multi_output``), whose
    gradient is the cross-entropy's: ``(p - onehot(label)) * grad_scale``,
    zero at ``ignore_label`` with ``use_ignore``, divided by the batch
    (``normalization="batch"``) or by the count of labels kept ("valid")."""
    return _SoftmaxOutput.apply(data, label, 1 if multi_output else -1,
                                float(grad_scale), ignore_label,
                                bool(use_ignore), normalization,
                                float(smooth_alpha))


class _RegressionOutput(torch.autograd.Function):
    """``fwd(data)``; backward ``grad_of(out, data, label) * grad_scale``."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad_of, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(data, out, label)
        ctx.grad_of, ctx.grad_scale = grad_of, grad_scale
        return out

    @staticmethod
    def backward(ctx, _ct):
        data, out, label = ctx.saved_tensors
        grad = ctx.grad_of(out, data, label.reshape(data.shape))
        return grad * ctx.grad_scale, None, None, None, None


@register("LinearRegressionOutput")
def linear_regression_output(data, label, grad_scale=1.0):
    """The identity; gradient ``(data - label) * grad_scale``."""
    return _RegressionOutput.apply(data, label, torch.clone,
                                   lambda o, d, l: d - l, float(grad_scale))


@register("LogisticRegressionOutput")
def logistic_regression_output(data, label, grad_scale=1.0):
    """sigmoid; gradient ``(sigmoid(data) - label) * grad_scale``."""
    return _RegressionOutput.apply(data, label, torch.sigmoid,
                                   lambda o, d, l: o - l, float(grad_scale))


@register("MAERegressionOutput")
def mae_regression_output(data, label, grad_scale=1.0):
    """The identity; gradient ``sign(data - label) * grad_scale``."""
    return _RegressionOutput.apply(data, label, torch.clone,
                                   lambda o, d, l: torch.sign(d - l),
                                   float(grad_scale))


class _MakeLoss(torch.autograd.Function):
    """The identity; backward ``grad_scale`` everywhere (over the batch with
    ``normalization="batch"``), in f32."""

    @staticmethod
    def forward(ctx, data, scale):
        ctx.shape, ctx.scale = data.shape, scale
        return data.clone()

    @staticmethod
    def backward(ctx, _ct):
        return torch.full(ctx.shape, ctx.scale, dtype=torch.float32,
                          device=_ct.device), None


@register("MakeLoss", aliases=("make_loss",))
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Mark ``data`` as a loss: its gradient is ``grad_scale`` (divided by
    the batch size under ``normalization="batch"``); ``valid_thresh`` and
    "valid" are accepted and ignored, as in the JAX package."""
    scale = float(grad_scale)
    if normalization == "batch":
        scale = scale / data.shape[0]
    return _MakeLoss.apply(data, scale)
