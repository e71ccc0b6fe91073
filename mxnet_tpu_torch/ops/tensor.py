"""Tensor ops: elementwise, broadcast, reduction, shape, indexing, init.

Counterpart of `mxnet_tpu/ops/tensor.py`: every op it registers, under the
same names, aliases and attrs, as plain torch functions. The JAX package's
semantics hold where they differ from PyTorch's habits:

- a ``_*_scalar`` op casts the scalar to the array's dtype first, so an
  int32 array plus 0.7 stays int32 (PyTorch would promote to a float);
- ``argmax`` / ``argmin`` / ``argmax_channel`` return float32 positions
  (float64 for a 64-bit input, as the JAX package's large-tensor mode
  does), ``argsort`` / ``topk`` positions take their ``dtype`` attr;
- integer sums and products stay in 32 bits (64 for int64), as under JAX's
  default config, and a mean of integers is float32;
- reshape takes MXNet's magic codes (`mx_reshape_shape`), ``dot``
  contracts lhs's last axis with rhs's first, ``transpose`` with no axes
  reverses them all;
- ``take`` / ``pick`` / ``Embedding`` clip out-of-range positions and
  ``one_hot`` gives a zero row for one.

Index-valued outputs the reference types as int64 (``shape_array``,
``size_array``, ``histogram``'s counts) are int64 here, where the JAX
package narrows them to int32 (README, "int64").
"""
from __future__ import annotations

import builtins

import torch

from ..base import torch_dtype
from . import register


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _reduce_axes(ndim, axis, exclude=False):
    if axis is None:
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def mx_reshape_shape(ishape, spec, reverse=False):
    """MXNet reshape shape inference with magic codes
    (reference: src/operator/tensor/matrix_op-inl.h:InferReshapeShape)."""
    ishape = tuple(ishape)
    spec = tuple(int(s) for s in spec)
    if reverse:
        rs = mx_reshape_shape(ishape[::-1], spec[::-1], reverse=False)
        return tuple(rs[::-1])
    out = []
    i = 0
    j = 0
    while j < len(spec):
        k = spec[j]
        if k > 0:
            out.append(k)
            i += 1
        elif k == 0:
            out.append(ishape[i])
            i += 1
        elif k == -1:
            out.append(-1)
            i += 1
        elif k == -2:
            out.extend(ishape[i:])
            i = len(ishape)
        elif k == -3:
            out.append(ishape[i] * ishape[i + 1])
            i += 2
        elif k == -4:
            a, b = spec[j + 1], spec[j + 2]
            j += 2
            d = ishape[i]
            i += 1
            if a == -1 and b == -1:
                raise ValueError("reshape -4 cannot infer both factors")
            if a == -1:
                a = d // b
            if b == -1:
                b = d // a
            out.extend([a, b])
        else:
            raise ValueError("invalid reshape code %d" % k)
        j += 1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in ishape:
            total *= d
        out[out.index(-1)] = total // builtins.max(known, 1)
    return tuple(out)


def _scalar(data, value):
    """``value`` as a 0-d tensor of ``data``'s dtype (jnp.asarray(value,
    data.dtype)): the scalar-dtype rule of the ``_*_scalar`` ops."""
    return torch.as_tensor(value, dtype=data.dtype, device=data.device)


def _inexact(x):
    """jnp's promotion of an integer operand of a float-only function."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _int_acc(x):
    """Accumulator dtype of an integer sum or product under JAX's default
    config: 32 bits (64 for int64); None keeps a float dtype."""
    if x.is_floating_point():
        return None
    return torch.int64 if x.dtype == torch.int64 else torch.int32


def _mod(a, b):
    """``a mod b`` with the divisor's sign (jnp.mod); an integer divisor of
    0 gives 0, as jnp.mod does, where torch.remainder raises."""
    if a.is_floating_point() or b.is_floating_point():
        return torch.remainder(a, b)
    zero = b == 0
    return torch.where(zero, torch.zeros((), dtype=torch.result_type(a, b)),
                       torch.remainder(a, torch.where(zero, 1, b)))


def _same_type(fn):
    return lambda a, b: fn(a, b).to(torch.result_type(a, b))


# --------------------------------------------------------------------------
# elementwise binary (+ broadcast_ and _scalar variants)
# reference: src/operator/tensor/elemwise_binary_broadcast_op_basic.cc
# --------------------------------------------------------------------------

_BINARY_FNS = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "mod": _mod,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": lambda a, b: torch.hypot(_inexact(a), _inexact(b)),
    "equal": _same_type(torch.eq),
    "not_equal": _same_type(torch.ne),
    "greater": _same_type(torch.gt),
    "greater_equal": _same_type(torch.ge),
    "lesser": _same_type(torch.lt),
    "lesser_equal": _same_type(torch.le),
    "logical_and": _same_type(torch.logical_and),
    "logical_or": _same_type(torch.logical_or),
    "logical_xor": _same_type(torch.logical_xor),
}

for _n, _f in _BINARY_FNS.items():
    register("elemwise_" + _n, aliases=("_" + _n, "broadcast_" + _n, _n))(
        (lambda f: lambda lhs, rhs: f(lhs, rhs))(_f)
    )

# scalar variants (reference: elemwise_binary_scalar_op_basic.cc)
for _n, _f in _BINARY_FNS.items():
    register("_%s_scalar" % _n)(
        (lambda f: lambda data, scalar=0.0: f(data, _scalar(data, scalar)))(_f)
    )

register("_plus_scalar")(lambda data, scalar=0.0: data + _scalar(data, scalar))
register("_minus_scalar")(lambda data, scalar=0.0: data - _scalar(data, scalar))
register("_rminus_scalar")(lambda data, scalar=0.0: _scalar(data, scalar) - data)
register("_mul_scalar")(lambda data, scalar=1.0: data * _scalar(data, scalar))
register("_div_scalar")(lambda data, scalar=1.0: data / _scalar(data, scalar))
register("_rdiv_scalar")(lambda data, scalar=1.0: _scalar(data, scalar) / data)
register("_power_scalar")(lambda data, scalar=1.0: torch.pow(data, _scalar(data, scalar)))
register("_rpower_scalar")(lambda data, scalar=1.0: torch.pow(_scalar(data, scalar), data))
register("_mod_scalar")(lambda data, scalar=1.0: _mod(data, _scalar(data, scalar)))
register("_rmod_scalar")(lambda data, scalar=1.0: _mod(_scalar(data, scalar), data))


@register("add_n", aliases=("ElementWiseSum", "_sum"))
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# --------------------------------------------------------------------------
# elementwise unary (reference: elemwise_unary_op_basic.cc, _trig.cc, _pow.cc)
# --------------------------------------------------------------------------

def _cbrt(x):
    x = _inexact(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY_FNS = {
    "abs": torch.abs,
    "sign": torch.sign,
    "rint": lambda x: torch.round(_inexact(x)),
    "round": torch.round,       # half to even, as jnp.round
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: _inexact(x) / (1 + torch.abs(_inexact(x))),
    "relu": torch.relu,
    "reciprocal": torch.reciprocal,
    "negative": torch.neg,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "erf": torch.special.erf,
    "erfinv": torch.special.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(_inexact(x))),
    "gammaln": lambda x: torch.lgamma(_inexact(x)),
    "digamma": lambda x: torch.special.digamma(_inexact(x)),
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _n, _f in _UNARY_FNS.items():
    register(_n)((lambda f: lambda data: f(data))(_f))

register("identity", aliases=("_copy",))(lambda data: data)


@register("hard_sigmoid")
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    """reference: src/operator/tensor/elemwise_unary_op_basic.cc HardSigmoid"""
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("ravel_multi_index", aliases=("ravel_index",))
def ravel_multi_index(data, shape=()):
    """data: (ndim, N) indices -> (N,) flat ids (reference: ravel.cc)."""
    strides = []
    acc = 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    strides = torch.tensor(list(reversed(strides)), dtype=data.dtype,
                           device=data.device)
    return (data * strides[:, None]).sum(dim=0, dtype=data.dtype)


@register("unravel_index", aliases=("unravel",))
def unravel_index(data, shape=()):
    """(N,) flat ids -> (ndim, N) indices (reference: ravel.cc UnravelIndex)."""
    idx = data.reshape(-1)
    out = []
    for d in reversed(shape):
        out.append(idx % d)
        idx = idx // d
    return torch.stack(list(reversed(out))).to(data.dtype)


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(data):
    return data.detach()


@register("Cast", aliases=("cast",))
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("clip")
def clip(data, a_min=0.0, a_max=1.0):
    """``data`` clipped to [a_min, a_max]. A floating input is clipped as
    ``jnp.clip`` does, ``minimum(maximum(x, a_min), a_max)``, whose
    gradient is split in halves at a bound (0.5 there, as JAX's; `clamp`
    gives 1)."""
    if not data.is_floating_point():
        return torch.clamp(data, a_min, a_max)
    lo = torch.tensor(a_min, dtype=data.dtype, device=data.device)
    hi = torch.tensor(a_max, dtype=data.dtype, device=data.device)
    return torch.minimum(torch.maximum(data, lo), hi)


# --------------------------------------------------------------------------
# reductions (reference: broadcast_reduce_op_value.cc)
# --------------------------------------------------------------------------

def _sum(x, axes, keepdims):
    return torch.sum(x, dim=axes, keepdim=keepdims, dtype=_int_acc(x))


def _prod(x, axes, keepdims):
    # torch.prod takes one dim: reduce the highest first so lower dims
    # keep their index
    dt = _int_acc(x)
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims, dtype=dt)
    return x


def _mean(x, axes, keepdims):
    return torch.mean(_inexact(x), dim=axes, keepdim=keepdims)


def _max(x, axes, keepdims):
    return torch.amax(x, dim=axes, keepdim=keepdims)


def _min(x, axes, keepdims):
    return torch.amin(x, dim=axes, keepdim=keepdims)


def _nansum(x, axes, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return _sum(x, axes, keepdims)


def _nanprod(x, axes, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, axes, keepdims)


def _make_reduce(tfn, name):
    @register(name)
    def _red(data, axis=None, keepdims=False, exclude=False):
        axes = _reduce_axes(data.ndim, axis, exclude)
        if data.ndim == 0:
            return data
        if not axes:   # torch reads an empty dim list as "every dim"
            return tfn(data.unsqueeze(0), (0,), False)
        return tfn(data, axes, keepdims)

    return _red


_make_reduce(_sum, "sum")
_make_reduce(_mean, "mean")
_make_reduce(_prod, "prod")
_make_reduce(_max, "max")
_make_reduce(_min, "min")
_make_reduce(_nansum, "nansum")
_make_reduce(_nanprod, "nanprod")
register("sum_axis", aliases=("sum_axis",))(
    lambda data, axis=None, keepdims=False, exclude=False:
    _sum(data, _reduce_axes(data.ndim, axis, exclude), keepdims))


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    axes = _reduce_axes(data.ndim, axis)
    if ord == 1:
        return _sum(torch.abs(data), axes, keepdims)
    return torch.sqrt(_inexact(_sum(torch.square(data), axes, keepdims)))


def _arg_index_dtype(data):
    """Reference argmax/argmin emit float32 positions, exact to 2^24; the
    JAX package widens them to float64 where its large-tensor mode is on
    (a 64-bit input or more than 2^31 - 1 elements), and so does the port."""
    wide = data.dtype in (torch.float64, torch.int64) \
        or data.numel() > 2 ** 31 - 1
    return torch.float64 if wide else torch.float32


@register("argmax")
def argmax(data, axis=None, keepdims=False):
    out = torch.argmax(data, dim=axis)
    if keepdims and axis is not None:
        out = out.unsqueeze(axis)
    return out.to(_arg_index_dtype(data))


@register("argmin")
def argmin(data, axis=None, keepdims=False):
    out = torch.argmin(data, dim=axis)
    if keepdims and axis is not None:
        out = out.unsqueeze(axis)
    return out.to(_arg_index_dtype(data))


@register("argmax_channel")
def argmax_channel(data):
    return torch.argmax(data, dim=1).to(_arg_index_dtype(data))


# --------------------------------------------------------------------------
# dot products (reference: src/operator/tensor/dot-inl.h)
# --------------------------------------------------------------------------

def _reverse_axes(x):
    return x.permute(*reversed(range(x.ndim)))


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet dot: contract last axis of lhs with first axis of rhs; full-axis
    transposes applied first."""
    if transpose_a:
        lhs = _reverse_axes(lhs)
    if transpose_b:
        rhs = _reverse_axes(rhs)
    if lhs.ndim == 1 and rhs.ndim == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.ndim - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    if transpose_a:
        lhs = torch.swapaxes(lhs, -1, -2)
    if transpose_b:
        rhs = torch.swapaxes(rhs, -1, -2)
    return torch.matmul(lhs, rhs)


# --------------------------------------------------------------------------
# shape manipulation (reference: matrix_op.cc)
# --------------------------------------------------------------------------

@register("Reshape", aliases=("reshape",))
def reshape(data, shape=(), reverse=False):
    return torch.reshape(data, mx_reshape_shape(data.shape, shape, reverse))


@register("Flatten", aliases=("flatten",))
def flatten_op(data):
    return torch.reshape(data, (data.shape[0], -1))


@register("transpose")
def transpose(data, axes=None):
    if axes is None or len(axes) == 0:
        return _reverse_axes(data)
    return data.permute(*axes)


@register("expand_dims")
def expand_dims(data, axis=0):
    return torch.unsqueeze(data, axis)


@register("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return torch.squeeze(data)
    return torch.squeeze(data, dim=axis)


@register("SwapAxis", aliases=("swapaxes",))
def swapaxes(data, dim1=0, dim2=0):
    return torch.swapaxes(data, dim1, dim2)


@register("reverse", aliases=("flip",))
def reverse(data, axis=0):
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, dims=ax)


@register("tile")
def tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register("repeat")
def repeat(data, repeats=1, axis=None):
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("Pad", aliases=("pad",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    if mode != "constant":
        # torch pads only trailing dims in these modes: drop the leading
        # unpadded ones (MXNet pads only H, W (, D) there)
        while pw and pw[0] == (0, 0):
            pw = pw[1:]
    flat = [p for before_after in reversed(pw) for p in before_after]
    if mode == "constant":
        return torch.nn.functional.pad(data, flat, mode="constant",
                                       value=constant_value)
    return torch.nn.functional.pad(
        data, flat, mode={"edge": "replicate", "reflect": "reflect"}[mode])


@register("Concat", aliases=("concat",))
def concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=dim)


@register("stack")
def stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=axis)


@register("SliceChannel", aliases=("split",), num_outputs=-1,
          num_outputs_fn=lambda attrs: int(attrs.get("num_outputs", 1)))
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    if data.shape[axis] % num_outputs:
        raise ValueError("split: axis %d of size %d does not divide into %d"
                         % (axis, data.shape[axis], num_outputs))
    parts = torch.split(data, data.shape[axis] // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, dim=axis) for p in parts]
    return tuple(parts)


def _slice_dim(x, dim, begin, end, step):
    """``x`` sliced along ``dim`` as numpy would; torch refuses negative
    steps in basic indexing, so those gather their positions."""
    if step is None or step > 0:
        idx = [builtins.slice(None)] * x.ndim
        idx[dim] = builtins.slice(begin, end, step)
        return x[tuple(idx)]
    pos = range(*builtins.slice(begin, end, step).indices(x.shape[dim]))
    return torch.index_select(
        x, dim, torch.tensor(list(pos), dtype=torch.long, device=x.device))


@register("slice", aliases=("crop",))
def slice_op(data, begin=(), end=(), step=()):
    out = data
    for i in range(data.ndim):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = step[i] if i < len(step) and step[i] is not None and step[i] != 0 else None
        out = _slice_dim(out, i, b, e, s)
    return out


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    return _slice_dim(data, axis % data.ndim, begin, end, None)


@register("slice_like")
def slice_like(data, shape_like, axes=()):
    axes = tuple(axes) if axes else tuple(range(shape_like.ndim))
    idx = [builtins.slice(None)] * data.ndim
    for a in axes:
        idx[a] = builtins.slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("space_to_depth")
def space_to_depth(data, block_size=1, layout="NCHW"):
    """Reference space_to_depth (NCHW, depth order = row-parity-major:
    out channel = a·b·C + ß·C + c); layout="NHWC" is the JAX package's
    channels-last variant with the same depth order."""
    from .nn import _channels_last

    b = block_size
    if _channels_last(layout):
        n, h, w, c = data.shape
        x = torch.reshape(data, (n, h // b, b, w // b, b, c))
        x = x.permute(0, 1, 3, 2, 4, 5)
        return torch.reshape(x, (n, h // b, w // b, c * b * b))
    n, c, h, w = data.shape
    x = torch.reshape(data, (n, c, h // b, b, w // b, b))
    x = x.permute(0, 3, 5, 1, 2, 4)
    return torch.reshape(x, (n, c * b * b, h // b, w // b))


@register("depth_to_space")
def depth_to_space(data, block_size=1):
    n, c, h, w = data.shape
    b = block_size
    x = torch.reshape(data, (n, b, b, c // (b * b), h, w))
    x = x.permute(0, 3, 4, 1, 5, 2)
    return torch.reshape(x, (n, c // (b * b), h * b, w * b))


# --------------------------------------------------------------------------
# broadcasting (reference: broadcast_reduce_op_value.cc)
# --------------------------------------------------------------------------

@register("broadcast_to")
def broadcast_to(data, shape=()):
    tgt = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return torch.broadcast_to(data, tgt)


@register("broadcast_like")
def broadcast_like(data, like):
    return torch.broadcast_to(data, like.shape)


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return torch.broadcast_to(data, tuple(tgt))


# --------------------------------------------------------------------------
# indexing (reference: indexing_op.cc)
# --------------------------------------------------------------------------

@register("take")
def take(a, indices, axis=0, mode="clip"):
    axis %= a.ndim
    n = a.shape[axis]
    idx = indices.long()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("batch_take", aliases=("pick",))
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    ax = axis % data.ndim
    idx = index.long().clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, ax, idx.unsqueeze(ax))
    if not keepdims:
        out = torch.squeeze(out, dim=ax)
    return out


@register("Embedding", size_attrs=("input_dim",))
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32", sparse_grad=False):
    """reference: src/operator/tensor/indexing_op.cc (Embedding): gather
    rows of `weight`, positions clipped."""
    return weight[data.long().clamp(0, weight.shape[0] - 1)]


@register("one_hot", size_attrs=("depth",))
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    pos = torch.arange(depth, device=indices.device)
    oh = (indices.long().unsqueeze(-1) == pos).to(torch.float32)
    return (oh * (on_value - off_value) + off_value).to(torch_dtype(dtype))


@register("gather_nd")
def gather_nd(data, indices):
    return data[tuple(indices.long())]


@register("scatter_nd")
def scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    out[tuple(indices.long())] = data
    return out


@register("_scatter_set_nd")
def scatter_set_nd(lhs, rhs, indices, shape=()):
    out = lhs.clone()
    out[tuple(indices.long())] = rhs
    return out


@register("where")
def where(condition, x, y):
    if condition.shape != x.shape and condition.ndim == 1:
        cond = condition.reshape((-1,) + (1,) * (x.ndim - 1)).bool()
    else:
        cond = condition.bool()
    return torch.where(cond, x, y)


# --------------------------------------------------------------------------
# ordering (reference: ordering_op.cc)
# --------------------------------------------------------------------------

@register("sort")
def sort(data, axis=-1, is_ascend=True):
    if axis is None:   # the flattened array, as jnp.sort(axis=None)
        data, axis = data.reshape(-1), 0
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    if axis is None:
        data, axis = data.reshape(-1), 0
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out.to(torch_dtype(dtype))


@register("topk", num_outputs=-1)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False, dtype="float32"):
    """The k largest (smallest with ``is_ascend``) along ``axis``; among
    equal values the lower index comes first, as ``lax.top_k`` gives them.
    The mask marks what the JAX package's stable ascending argsort puts
    last (first with ``is_ascend``): among equal values, the higher
    indices for the largest."""
    ax = axis % data.ndim
    if ret_typ == "mask":
        order = torch.argsort(data, dim=ax, stable=True)
        n = data.shape[ax]
        pick = order.narrow(ax, 0, k) if is_ascend \
            else order.narrow(ax, n - k, k)
        return (torch.zeros_like(data).scatter_(ax, pick, 1),)
    vals, idxs = torch.sort(data, dim=ax, descending=not is_ascend,
                            stable=True)
    vals, idxs = vals.narrow(ax, 0, k), idxs.narrow(ax, 0, k)
    if ret_typ == "value":
        return (vals,)
    if ret_typ == "both":
        return (vals, idxs.to(torch_dtype(dtype)))
    return (idxs.to(torch_dtype(dtype)),)


# --------------------------------------------------------------------------
# init / creation ops (reference: init_op.cc)
# --------------------------------------------------------------------------

@register("shape_array")
def shape_array(data):
    return torch.tensor(data.shape, dtype=torch.int64, device=data.device)


@register("size_array")
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int64, device=data.device)


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("_zeros")
def _zeros(shape=(), dtype="float32"):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype))


@register("_ones")
def _ones(shape=(), dtype="float32"):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype))


@register("_full")
def _full(shape=(), value=0.0, dtype="float32"):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype))


@register("_arange", size_attrs=("start", "stop"))
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register("_linspace")
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32"):
    if endpoint:
        return torch.linspace(start, stop, num, dtype=torch_dtype(dtype))
    return torch.linspace(start, stop, num + 1,
                          dtype=torch_dtype(dtype))[:num]


@register("_eye")
def _eye(N=0, M=0, k=0, dtype="float32"):
    rows = torch.arange(N)[:, None]
    cols = torch.arange(M if M else N)[None, :]
    return (cols - rows == k).to(torch_dtype(dtype))


@register("diag")
def diag(data, k=0):
    if data.ndim == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


# --------------------------------------------------------------------------
# sequence ops (reference: src/operator/sequence_{mask,last,reverse}.cc)
# layout: (seq_len, batch, ...) when use_sequence_length
# --------------------------------------------------------------------------

@register("SequenceMask")
def sequence_mask(data, sequence_length=None, use_sequence_length=False, value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < sequence_length.long()[None, :]
    if axis == 1:
        mask = mask.T
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, _scalar(data, value))


@register("SequenceLast")
def sequence_last(data, sequence_length=None, use_sequence_length=False, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = sequence_length.long() - 1
    moved = torch.movedim(data, axis, 0)
    return moved[last, torch.arange(moved.shape[1], device=data.device)]


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False, axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    moved = torch.movedim(data, axis, 0)  # (T, B, ...)
    t = torch.arange(moved.shape[0], device=data.device)[:, None]
    lens = sequence_length.long()[None, :]
    idx = torch.where(t < lens, lens - 1 - t, t)          # (T, B)
    out = moved[idx, torch.arange(moved.shape[1], device=data.device)]
    return torch.movedim(out, 0, axis)


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------

@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2, 0.5 * s2 * torch.square(data),
                       torch.abs(data) - 0.5 / s2)


@register("khatri_rao")
def khatri_rao(*args):
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape((-1,) + out.shape[1:])
    return out


@register("histogram", num_outputs=2)
def histogram(data, bin_cnt=10, range=None):
    flat = data.reshape(-1)
    if range is not None:
        lo = _scalar(flat, range[0])
        hi = _scalar(flat, range[1])
    else:
        lo, hi = flat.min(), flat.max()
    edges = lo + (hi - lo) * torch.arange(bin_cnt + 1, dtype=flat.dtype,
                                          device=flat.device) / bin_cnt
    scaled = (flat - lo) / torch.maximum(hi - lo, _scalar(flat, 1e-12)) * bin_cnt
    idx = torch.clamp(scaled.to(torch.int32), 0, bin_cnt - 1)
    return torch.bincount(idx, minlength=bin_cnt), edges
