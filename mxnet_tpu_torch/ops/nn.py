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
           "convolution", "pooling",
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
                   pooling_convention, layout)


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
