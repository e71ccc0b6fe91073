"""INT8 quantization ops (counterpart of `mxnet_tpu/ops/quantization.py`).

The reference's quantization operator family (src/operator/quantization/**:
quantize_v2, dequantize, requantize, quantized_fully_connected,
quantized_conv, and the int8 pooling, activation, flatten and concat),
under the same registered names and aliases, on ``mx.nd.contrib`` /
``mx.sym.contrib``. The JAX package lowers its int8 products to XLA
``dot_general`` / ``conv_general_dilated`` with an int32 result; here both
are ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card's tensor cores, the
library's own int8 GEMM on the CPU), a convolution as an im2col gather into
an int8 (M, K) matrix first. The int32 accumulator is exact: no product
runs in float.

``_int_mm`` on CUDA wants more than 16 rows and inner and output widths
that are multiples of 8. Smaller shapes (the stem's K = 147, a one-row FC)
are padded with zeros, which is exact, on every device alike; a shape that
still does not fit raises. Nothing falls back to a float product.

Quantization scheme: the reference's symmetric int8 path
(quantization_utils.h): scale = 127 / max(|min|, |max|), zero-point-free.
The f32 arithmetic follows the JAX package's order so the bits match:
scales divide 127 by the range, ``out_scale = sd * sw``, a bias enters as
``round(bias * out_scale)`` in int32, dequantizing divides by the scale,
and ``round`` is half-to-even.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import register

_INT8_MAX = 127.0
# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
_MM_MIN_ROWS = 17
_MM_ALIGN = 8


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def _int8_max_over(x):
    """127 / x as a true division (a Python number over a tensor would be
    ``x.reciprocal() * 127`` in PyTorch, one rounding apart)."""
    return torch.full_like(x, _INT8_MAX) / x


def _range_scale(min_range, max_range):
    return _int8_max_over(torch.clamp_min(
        torch.maximum(min_range.abs(), max_range.abs()), 1e-20))


def _quantize(data, scale):
    return torch.clamp(torch.round(data * scale), -127, 127).to(torch.int8)


def _ranges(data, min_calib_range, max_calib_range):
    """(min, max) as f32 scalars: the calibrated range, else the data's."""
    if min_calib_range is None or max_calib_range is None:
        return data.min().float(), data.max().float()
    return (_f32(min_calib_range, data.device),
            _f32(max_calib_range, data.device))


@register("_contrib_quantize_v2", num_outputs=3,
          aliases=("quantize_v2", "_contrib_quantize", "quantize"))
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """fp32 -> int8 + (min, max) range outputs (reference:
    quantize_v2-inl.h). Without calibrated ranges the data min/max is used
    (the reference's runtime-minmax mode)."""
    mn, mx = _ranges(data, min_calib_range, max_calib_range)
    q = _quantize(data, _range_scale(mn, mx))
    return q, mn.reshape((1,)), mx.reshape((1,))


def dequantize_int32(data, mn, mx):
    """Quantized accumulator -> fp32 given its range (shared body for the
    dequantize op and requantize): a division by the scale."""
    return data.float() / _range_scale(mn, mx)


@register("_contrib_dequantize", num_outputs=1, aliases=("dequantize",))
def dequantize(data, min_range, max_range, out_type="float32"):
    """int8/int32 -> fp32 (reference: dequantize-inl.h)."""
    return dequantize_int32(data, min_range.reshape(()),
                            max_range.reshape(()))


@register("_contrib_requantize", num_outputs=3, aliases=("requantize",))
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 -> int8 with new ranges (reference: requantize-inl.h)."""
    f = dequantize_int32(data, min_range.reshape(()), max_range.reshape(()))
    mn, mx = _ranges(f, min_calib_range, max_calib_range)
    q = _quantize(f, _range_scale(mn, mx))
    return q, mn.reshape((1,)), mx.reshape((1,))


def _pad_to(v, m):
    return -(-v // m) * m


def int8_matmul(a, w, rows=None):
    """``a[:rows] @ w.T`` exactly, int8 x int8 -> int32, by
    ``torch._int_mm``: ``a`` (Mp, Kp) int8, ``w`` (N, K) int8 with K <= Kp.
    ``a`` may carry zero rows and columns past ``rows`` and K (the im2col
    gather writes them so); it is padded here to more than 16 rows and K to
    a multiple of 8, and ``w`` to N and K multiples of 8, with zeros."""
    rows = a.shape[0] if rows is None else rows
    n, k = w.shape
    kp = _pad_to(max(k, a.shape[1]), _MM_ALIGN)
    mp = max(a.shape[0], _MM_MIN_ROWS)
    if (mp, kp) != tuple(a.shape) or not a.is_contiguous():
        ap = a.new_zeros((mp, kp))
        ap[:a.shape[0], :a.shape[1]] = a
        a = ap
    np_ = _pad_to(n, _MM_ALIGN)
    if (np_, kp) != (n, k):
        wp = w.new_zeros((np_, kp))
        wp[:n, :k] = w
        w = wp
    return torch._int_mm(a, w.t())[:rows, :n]


def im2col_int8(x, kernel, stride, pad):
    """The im2col gather of an int8 (N, C, H, W) ``x`` (any strides): an
    int8 (max(M, 17), Kp) matrix whose row ``(n, oh, ow)`` holds the
    zero-padded window at that output position in (kh, kw, c) order, K =
    kh * kw * C padded with zero columns to a multiple of 8 and M = N * OH
    * OW with zero rows to 17. One strided copy: a padded view of ``x``
    read as (N, OH, OW, KH, KW, C) into the matrix. Returns (matrix, M,
    (N, OH, OW))."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, pad
    if ph or pw:
        x = torch.nn.functional.pad(x, (pw, pw, ph, ph))
    n, c, h, w = x.shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    s0, s1, s2, s3 = x.stride()
    win = x.as_strided((n, oh, ow, kh, kw, c),
                       (s0, s2 * sh, s3 * sw, s2, s3, s1),
                       x.storage_offset())
    m, k = n * oh * ow, kh * kw * c
    kp = _pad_to(k, _MM_ALIGN)
    a = x.new_empty((max(m, _MM_MIN_ROWS), kp))
    if kp != k:
        a[:, k:] = 0
    if a.shape[0] != m:
        a[m:] = 0
    a[:m, :k].view(n, oh, ow, kh, kw, c).copy_(win)
    return a, m, (n, oh, ow)


def _out_range(out_scale):
    # range chosen so dequantize(acc, -m, m) divides by exactly out_scale:
    # the int32 accumulator's value scale
    out_max = _int8_max_over(out_scale)
    return (-out_max).reshape((1,)), out_max.reshape((1,))


def _scales(min_data, max_data, min_weight, max_weight):
    sd = _range_scale(min_data.reshape(()), max_data.reshape(()))
    sw = _range_scale(min_weight.reshape(()), max_weight.reshape(()))
    return sd * sw


@register("_contrib_quantized_fully_connected", num_outputs=3,
          aliases=("quantized_fully_connected",))
def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias=None,
                              max_bias=None, num_hidden=0, no_bias=False,
                              flatten=True):
    """int8 FC: int8 x int8 -> int32 (reference:
    quantized_fully_connected.cc). Inputs carry their fp ranges; output is
    the int32 accumulator + its implied range. `flatten` matches the fp32
    FullyConnected semantics (>2-D data collapses to (N, -1))."""
    if flatten and data.dim() > 2:
        data = data.reshape((data.shape[0], -1))
    lead = data.shape[:-1]
    a = data.to(torch.int8).reshape(-1, data.shape[-1])
    acc = int8_matmul(a, weight.to(torch.int8))
    acc = acc.reshape(lead + (weight.shape[0],))
    out_scale = _scales(min_data, max_data, min_weight, max_weight)
    if not no_bias and bias is not None:
        acc = acc + torch.round(bias * out_scale).to(torch.int32)
    return (acc,) + _out_range(out_scale)


@register("_contrib_quantized_conv", num_outputs=3,
          aliases=("quantized_conv",))
def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, min_bias=None, max_bias=None, kernel=(),
                   stride=(1, 1), pad=(0, 0), num_filter=0, no_bias=False):
    """int8 NCHW convolution -> int32 accumulator (reference:
    quantized_conv.cc): `im2col_int8`, then `int8_matmul` against the
    (O, kh * kw * C) weight. The result is (N, O, OH, OW), channels-last in
    memory (the GEMM's (M, O) output viewed so)."""
    stride = tuple(int(s) for s in stride) or (1, 1)
    pad = tuple(int(p) for p in pad) or (0, 0)
    if data.dim() != 4:
        raise MXNetError("quantized_conv: NCHW data only, got shape %s"
                         % (tuple(data.shape),))
    w = weight.to(torch.int8)
    o, kh, kw = w.shape[0], w.shape[2], w.shape[3]
    a, m, (n, oh, ow) = im2col_int8(data.to(torch.int8), (kh, kw), stride,
                                    pad)
    acc = int8_matmul(a, w.permute(0, 2, 3, 1).reshape(o, -1), rows=m)
    acc = acc.reshape(n, oh, ow, o).permute(0, 3, 1, 2)
    out_scale = _scales(min_data, max_data, min_weight, max_weight)
    if not no_bias and bias is not None:
        acc = acc + torch.round(bias * out_scale).to(torch.int32) \
            .reshape((1, -1, 1, 1))
    return (acc,) + _out_range(out_scale)


@register("_contrib_quantized_pooling", num_outputs=3,
          aliases=("quantized_pooling",))
def quantized_pooling(data, min_data, max_data, kernel=(), pool_type="max",
                      global_pool=False, stride=(), pad=(),
                      pooling_convention="valid", count_include_pad=True,
                      layout=None):
    """int8 pooling (reference: quantized_pooling.cc) — pooling runs in
    the quantized domain and the input range passes through unchanged
    (max picks an existing int8 value; avg stays within [min, max])."""
    from .nn import pooling

    if pool_type == "max":
        out = pooling(data, kernel=kernel, pool_type="max",
                      global_pool=global_pool, stride=stride, pad=pad,
                      pooling_convention=pooling_convention)
    elif pool_type == "avg":
        # accumulate in float32 (exact for int8 sums), round back to the
        # quantized grid — the reference's integer-average behavior
        acc = pooling(data.float(), kernel=kernel, pool_type="avg",
                      global_pool=global_pool, stride=stride, pad=pad,
                      pooling_convention=pooling_convention,
                      count_include_pad=count_include_pad)
        out = torch.clamp(torch.round(acc), -127, 127).to(data.dtype)
    else:
        raise MXNetError("quantized_pooling: pool_type=%r not supported"
                         % pool_type)
    return out, min_data.reshape((1,)), max_data.reshape((1,))


@register("_contrib_quantized_act", num_outputs=3,
          aliases=("quantized_act", "_contrib_quantized_activation"))
def quantized_act(data, min_data, max_data, act_type="relu"):
    """int8 activation (reference: quantized_activation.cc — relu only).
    relu clamps int8 values at 0, which the existing symmetric scale
    represents exactly, so the thresholds pass through unchanged."""
    if act_type != "relu":
        raise MXNetError("_contrib_quantized_act only supports "
                         "act_type=relu (reference parity)")
    return (torch.clamp_min(data, 0), min_data.reshape((1,)),
            max_data.reshape((1,)))


@register("_contrib_quantized_flatten", num_outputs=3,
          aliases=("quantized_flatten",))
def quantized_flatten(data, min_data, max_data):
    """int8 flatten (reference: quantized_flatten-inl.h — identity values,
    thresholds pass through; only the shape collapses to (batch, -1))."""
    out = data.reshape((data.shape[0], -1))
    return out, min_data.reshape((1,)), max_data.reshape((1,))


@register("_contrib_quantized_concat", num_outputs=3,
          aliases=("quantized_concat",))
def quantized_concat(*args, num_args=None, dim=1):
    """int8 concat (reference: quantized_concat.cc) — inputs are n data
    arrays followed by (min_i, max_i) pairs; every input is rescaled to
    the widest [min, max] range, concatenated, and that range is the
    output's."""
    n = int(num_args) if num_args is not None else len(args) // 3
    datas = args[:n]
    mins = [args[n + 2 * i].reshape(()) for i in range(n)]
    maxs = [args[n + 2 * i + 1].reshape(()) for i in range(n)]
    out_min = torch.clamp_max(torch.stack(mins).min(), 0.0)
    out_max = torch.stack(maxs).max()
    out_scale = _range_scale(out_min, out_max)
    parts = []
    for d, mn, mx in zip(datas, mins, maxs):
        s = _range_scale(mn, mx)
        # value = q / s; requantized q' = round(value * out_scale)
        q = torch.round(d.float() * (out_scale / s))
        parts.append(torch.clamp(q, -127, 127).to(torch.int8))
    out = torch.cat(parts, dim=int(dim))
    return out, out_min.reshape((1,)), out_max.reshape((1,))
