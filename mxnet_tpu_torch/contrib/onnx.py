"""ONNX import/export (counterpart of `mxnet_tpu/contrib/onnx.py`; reference:
python/mxnet/contrib/onnx/: onnx2mx/import_model.py:24,
mx2onnx/export_model.py:35 and their per-op translation tables).

The JAX package's tables over the port's `Symbol`: CNN ops (Conv incl.
groups/dilation, pooling variants, BatchNorm, Concat, Dropout,
clip/relu6), the BERT/transformer subset (LayerNormalization, Erf/GELU,
MatMul/batch_dot, Gather/Embedding, Transpose/Unsqueeze/Squeeze/Slice,
Where, reductions), elementwise/scalar/broadcast families, and the classic
extras (LRN, InstanceNorm, L2Normalization, Deconvolution/ConvTranspose,
Pad, Split, argmax/argmin, Cast, Expand/Tile). A file either package
writes, the other imports.

Uses the `onnx` pip package when importable (reference behavior,
contrib/onnx/__init__.py); otherwise the pure-Python protobuf shim
(`onnx_proto`), so interchange works without external dependencies; the
artifacts are standard .onnx protobufs either way.

Known model-level divergences (documented, reference-equivalent):
- SSD's MultiBox*/nms contrib ops have no ONNX mapping (the reference's
  tables don't cover them either); SSD deploys via StableHLO AOT
  (predict.py export_compiled).
- Fused RNN layers (word_lm LSTM) are not exported (no RNN/LSTM rows in
  the reference mx2onnx table either); use the AOT path.
- BERTModel's hybrid_forward is shape-specialized (reads concrete input
  shapes), so the full model cannot be traced to a Symbol for export; its
  building-block ops all translate (tested op-level) and whole-model
  deployment goes through export_compiled.

In the port, ``export_compiled`` (the AOT path named above) is not ported
yet (ROADMAP, order step 6). The channels-last zoo's fused
``BatchNormRelu`` / ``BatchNormAddRelu`` nodes have no row either, and
export refuses them by name; so does it a convolution or pooling with a
channels-last ``layout`` and a BatchNorm over another axis than 1, which
ONNX's NCHW operators would read wrongly.
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError

__all__ = ["import_model", "export_model", "get_model_metadata"]


def _onnx_impl():
    """(onnx_like, helper, numpy_helper, TensorProto): the real package if
    installed, else the in-tree protobuf shim."""
    try:
        import onnx
        from onnx import TensorProto, helper, numpy_helper

        return onnx, helper, numpy_helper, TensorProto
    except ImportError:
        from . import onnx_proto

        return (onnx_proto, onnx_proto.helper, onnx_proto.numpy_helper,
                onnx_proto.TensorProto)


# ===========================================================================
# import: ONNX graph -> Symbol
# ===========================================================================

_IMPORT_OPS = {}


def _imports(*names):
    def deco(fn):
        for n in names:
            _IMPORT_OPS[n] = fn
        return fn

    return deco


class _ImportCtx:
    """Carries the graph-wide state each import handler may need: the
    initializer dict (mutable — Constant nodes add to it) and the symbol
    module."""

    def __init__(self, sym_mod, params, opset):
        self.sym = sym_mod
        self.params = params
        self.opset = opset

    def const_value(self, sym_or_name):
        """Resolve an input that must be a constant initializer (shape /
        axes / pads arguments of opset>=10 ops)."""
        name = getattr(sym_or_name, "name", sym_or_name)
        if name not in self.params:
            raise MXNetError(
                "input '%s' must be a constant initializer (data-dependent "
                "dynamic values are not importable onto a static-shape "
                "compiler)" % name)
        return self.params[name]


def _symmetric_pads(attrs, what, spatial=2):
    """ONNX pads = (x1_begin.. xn_begin, x1_end.. xn_end); only symmetric
    padding maps onto the framework's `pad` attr — raise on the rest
    instead of silently importing wrong geometry."""
    pads = tuple(attrs.get("pads", (0,) * (2 * spatial)))
    if len(pads) == spatial:
        return pads
    if len(pads) == 2 * spatial:
        beg, end = pads[:spatial], pads[spatial:]
        if beg != end:
            raise MXNetError("%s: asymmetric ONNX pads %s are not supported"
                             % (what, (pads,)))
        return beg
    raise MXNetError("%s: unsupported pads rank %d" % (what, len(pads)))


@_imports("Gemm")
def _in_gemm(ctx, inputs, attrs):
    if attrs.get("transA", 0) != 0:
        raise MXNetError("Gemm with transA=1 is not supported")
    data, w = inputs[0], inputs[1]
    b = inputs[2] if len(inputs) > 2 else None
    params = ctx.params
    if w.name not in params:
        raise MXNetError("Gemm: weight '%s' must be a constant initializer"
                         % w.name)
    alpha, beta = attrs.get("alpha", 1.0), attrs.get("beta", 1.0)
    if alpha != 1.0:
        params[w.name] = params[w.name] * _np.float32(alpha)
    if beta != 1.0 and b is not None:
        if b.name not in params:
            raise MXNetError("Gemm with beta=%s needs a constant-"
                             "initializer bias (got computed tensor '%s')"
                             % (beta, b.name))
        params[b.name] = params[b.name] * _np.float32(beta)
    wshape = params[w.name].shape
    if not attrs.get("transB", 0):
        # ONNX default stores weight (K, N); FullyConnected wants (N, K) —
        # transpose the initializer once at import
        params[w.name] = _np.ascontiguousarray(params[w.name].T)
        wshape = params[w.name].shape
    return ctx.sym.FullyConnected(data=data, weight=w, bias=b,
                                  num_hidden=wshape[0], no_bias=b is None)


@_imports("Conv")
def _in_conv(ctx, inputs, attrs):
    kernel = tuple(attrs.get("kernel_shape", ()))
    nsp = len(kernel) or 2
    w = inputs[1]
    b = inputs[2] if len(inputs) > 2 else None
    return ctx.sym.Convolution(
        data=inputs[0], weight=w, bias=b,
        kernel=kernel, stride=tuple(attrs.get("strides", (1,) * nsp)),
        pad=_symmetric_pads(attrs, "Conv", nsp),
        dilate=tuple(attrs.get("dilations", (1,) * nsp)),
        num_group=int(attrs.get("group", 1)),
        num_filter=ctx.params[w.name].shape[0],
        no_bias=b is None)


@_imports("ConvTranspose")
def _in_convtranspose(ctx, inputs, attrs):
    kernel = tuple(attrs.get("kernel_shape", ()))
    nsp = len(kernel) or 2
    if attrs.get("output_padding") or attrs.get("output_shape"):
        raise MXNetError("ConvTranspose with output_padding/output_shape "
                         "is not supported")
    w = inputs[1]
    b = inputs[2] if len(inputs) > 2 else None
    return ctx.sym.Deconvolution(
        data=inputs[0], weight=w, bias=b,
        kernel=kernel, stride=tuple(attrs.get("strides", (1,) * nsp)),
        pad=_symmetric_pads(attrs, "ConvTranspose", nsp),
        dilate=tuple(attrs.get("dilations", (1,) * nsp)),
        num_group=int(attrs.get("group", 1)),
        num_filter=ctx.params[w.name].shape[1] * int(attrs.get("group", 1)),
        no_bias=b is None)


def _pool(ctx, inputs, attrs, pool_type, global_pool=False):
    if global_pool:
        return ctx.sym.Pooling(inputs[0], kernel=(1, 1), global_pool=True,
                               pool_type=pool_type)
    kernel = tuple(attrs["kernel_shape"])
    nsp = len(kernel)
    return ctx.sym.Pooling(
        inputs[0], kernel=kernel,
        stride=tuple(attrs.get("strides", (1,) * nsp)),
        pad=_symmetric_pads(attrs, "Pool", nsp), pool_type=pool_type,
        pooling_convention="full" if attrs.get("ceil_mode") else "valid",
        count_include_pad=bool(attrs.get("count_include_pad", 0)))


@_imports("MaxPool")
def _in_maxpool(ctx, inputs, attrs):
    return _pool(ctx, inputs, attrs, "max")


@_imports("AveragePool")
def _in_avgpool(ctx, inputs, attrs):
    return _pool(ctx, inputs, attrs, "avg")


@_imports("GlobalAveragePool")
def _in_gavgpool(ctx, inputs, attrs):
    return _pool(ctx, inputs, attrs, "avg", global_pool=True)


@_imports("GlobalMaxPool")
def _in_gmaxpool(ctx, inputs, attrs):
    return _pool(ctx, inputs, attrs, "max", global_pool=True)


@_imports("BatchNormalization", "SpatialBN")
def _in_bn(ctx, inputs, attrs):
    # fix_gamma=False is essential: the mx op DEFAULT (True) would silently
    # replace the imported scale tensor with ones — correct only for
    # untrained nets, which is exactly why a test on fresh weights can't
    # catch it (found by the trained-model drive)
    return ctx.sym.BatchNorm(data=inputs[0], gamma=inputs[1], beta=inputs[2],
                             moving_mean=inputs[3], moving_var=inputs[4],
                             eps=attrs.get("epsilon", 1e-5),
                             momentum=attrs.get("momentum", 0.9),
                             fix_gamma=False)


@_imports("LayerNormalization")
def _in_layernorm(ctx, inputs, attrs):
    return ctx.sym.LayerNorm(data=inputs[0], gamma=inputs[1], beta=inputs[2],
                             axis=int(attrs.get("axis", -1)),
                             eps=attrs.get("epsilon", 1e-5))


@_imports("InstanceNormalization")
def _in_instancenorm(ctx, inputs, attrs):
    return ctx.sym.InstanceNorm(data=inputs[0], gamma=inputs[1],
                                beta=inputs[2],
                                eps=attrs.get("epsilon", 1e-5))


@_imports("LRN")
def _in_lrn(ctx, inputs, attrs):
    return ctx.sym.LRN(inputs[0], nsize=int(attrs.get("size", 5)),
                       alpha=attrs.get("alpha", 1e-4),
                       beta=attrs.get("beta", 0.75),
                       knorm=attrs.get("bias", 1.0))


@_imports("LpNormalization")
def _in_lpnorm(ctx, inputs, attrs):
    if int(attrs.get("p", 2)) != 2:
        raise MXNetError("LpNormalization: only p=2 maps to "
                         "L2Normalization")
    # axis=1 is mx 'channel'; axis=-1 round-trips mx 'instance' (exact for
    # 2D inputs — the only rank where instance mode is a single-axis norm)
    axis = int(attrs.get("axis", -1))
    return ctx.sym.L2Normalization(
        inputs[0], mode="channel" if axis == 1 else "instance")


# -- activations / unary ----------------------------------------------------

_UNARY = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
          "Exp": "exp", "Log": "log", "Sqrt": "sqrt", "Abs": "abs",
          "Neg": "negative", "Erf": "erf", "Ceil": "ceil", "Floor": "floor",
          "Round": "round", "Reciprocal": "reciprocal", "Sin": "sin",
          "Cos": "cos", "Tan": "tan", "Asin": "arcsin", "Acos": "arccos",
          "Atan": "arctan", "Identity": "identity", "Sign": "sign"}


def _register_unary():
    for onnx_name, mx_name in _UNARY.items():
        @_imports(onnx_name)
        def _fn(ctx, inputs, attrs, _mx=mx_name):
            return getattr(ctx.sym, _mx)(inputs[0])


_register_unary()


@_imports("Softplus")
def _in_softplus(ctx, inputs, attrs):
    return ctx.sym.Activation(inputs[0], act_type="softrelu")


@_imports("LeakyRelu")
def _in_leakyrelu(ctx, inputs, attrs):
    return ctx.sym.LeakyReLU(inputs[0], act_type="leaky",
                             slope=attrs.get("alpha", 0.01))


@_imports("Elu")
def _in_elu(ctx, inputs, attrs):
    return ctx.sym.LeakyReLU(inputs[0], act_type="elu",
                             slope=attrs.get("alpha", 1.0))


@_imports("PRelu")
def _in_prelu(ctx, inputs, attrs):
    return ctx.sym.LeakyReLU(inputs[0], gamma=inputs[1], act_type="prelu")


@_imports("Gelu")
def _in_gelu(ctx, inputs, attrs):
    return ctx.sym.LeakyReLU(inputs[0], act_type="gelu")


@_imports("HardSigmoid")
def _in_hardsigmoid(ctx, inputs, attrs):
    return ctx.sym.hard_sigmoid(inputs[0],
                                alpha=attrs.get("alpha", 0.2),
                                beta=attrs.get("beta", 0.5))


@_imports("Clip")
def _in_clip(ctx, inputs, attrs):
    if "min" in attrs or "max" in attrs:      # opset < 11: attributes
        lo, hi = attrs.get("min", -3.4e38), attrs.get("max", 3.4e38)
    else:                                     # opset >= 11: inputs
        lo = float(ctx.const_value(inputs[1])) \
            if len(inputs) > 1 and inputs[1] is not None else -3.4e38
        hi = float(ctx.const_value(inputs[2])) \
            if len(inputs) > 2 and inputs[2] is not None else 3.4e38
    return ctx.sym.clip(inputs[0], a_min=lo, a_max=hi)


@_imports("Softmax")
def _in_softmax(ctx, inputs, attrs):
    return ctx.sym.softmax(inputs[0], axis=attrs.get("axis", -1))


@_imports("LogSoftmax")
def _in_logsoftmax(ctx, inputs, attrs):
    return ctx.sym.log_softmax(inputs[0], axis=attrs.get("axis", -1))


# -- binary / variadic ------------------------------------------------------

_BINARY = {"Add": "broadcast_add", "Sub": "broadcast_sub",
           "Mul": "broadcast_mul", "Div": "broadcast_div",
           "Pow": "broadcast_power", "Max": "broadcast_maximum",
           "Min": "broadcast_minimum"}


def _register_binary():
    for onnx_name, mx_name in _BINARY.items():
        @_imports(onnx_name)
        def _fn(ctx, inputs, attrs, _mx=mx_name):
            out = inputs[0]
            for other in inputs[1:]:          # Max/Min/Sum are variadic
                out = getattr(ctx.sym, _mx)(out, other)
            return out


_register_binary()


@_imports("Sum")
def _in_sum(ctx, inputs, attrs):
    if len(inputs) == 1:
        return ctx.sym.identity(inputs[0])
    return ctx.sym.add_n(*inputs)


@_imports("MatMul")
def _in_matmul(ctx, inputs, attrs):
    return ctx.sym.linalg_gemm2(inputs[0], inputs[1])


@_imports("Where")
def _in_where(ctx, inputs, attrs):
    return ctx.sym.where(inputs[0], inputs[1], inputs[2])


# -- shape / movement -------------------------------------------------------

@_imports("Reshape")
def _in_reshape(ctx, inputs, attrs):
    shape = attrs.get("shape")
    if shape is None:
        # opset >= 5: shape arrives as the 2nd input tensor (initializer)
        if len(inputs) < 2:
            raise MXNetError("Reshape: no shape attribute and no shape "
                             "input")
        shape = ctx.const_value(inputs[1])
    return ctx.sym.Reshape(inputs[0], shape=tuple(int(s) for s in shape))


@_imports("Flatten")
def _in_flatten(ctx, inputs, attrs):
    axis = int(attrs.get("axis", 1))
    if axis == 1:
        return ctx.sym.Flatten(inputs[0])
    raise MXNetError("Flatten with axis=%d is not supported" % axis)


@_imports("Transpose")
def _in_transpose(ctx, inputs, attrs):
    perm = attrs.get("perm")
    return ctx.sym.transpose(inputs[0],
                             axes=tuple(perm) if perm is not None else ())


def _axes_arg(ctx, inputs, attrs, idx=1):
    axes = attrs.get("axes")
    if axes is None and len(inputs) > idx and inputs[idx] is not None:
        axes = [int(a) for a in ctx.const_value(inputs[idx])]
    return axes


@_imports("Unsqueeze")
def _in_unsqueeze(ctx, inputs, attrs):
    axes = _axes_arg(ctx, inputs, attrs)
    out = inputs[0]
    for ax in sorted(int(a) for a in axes):
        out = ctx.sym.expand_dims(out, axis=ax)
    return out


@_imports("Squeeze")
def _in_squeeze(ctx, inputs, attrs):
    axes = _axes_arg(ctx, inputs, attrs)
    return ctx.sym.squeeze(inputs[0],
                           axis=tuple(int(a) for a in axes) if axes else None)


@_imports("Slice")
def _in_slice(ctx, inputs, attrs):
    if "starts" in attrs:                      # opset < 10: attributes
        starts = list(attrs["starts"])
        ends = list(attrs["ends"])
        axes = list(attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    else:                                      # opset >= 10: inputs
        starts = [int(v) for v in ctx.const_value(inputs[1])]
        ends = [int(v) for v in ctx.const_value(inputs[2])]
        axes = [int(v) for v in ctx.const_value(inputs[3])] \
            if len(inputs) > 3 and inputs[3] is not None \
            else list(range(len(starts)))
        steps = [int(v) for v in ctx.const_value(inputs[4])] \
            if len(inputs) > 4 and inputs[4] is not None \
            else [1] * len(starts)
    if any(s != 1 for s in steps):
        raise MXNetError("Slice with steps != 1 is not supported")
    out = inputs[0]
    for ax, b, e in zip(axes, starts, ends):
        # ONNX clamps out-of-range ends (INT_MAX idiom) — slice_axis
        # understands None as "to the end"
        out = ctx.sym.slice_axis(out, axis=int(ax), begin=int(b),
                                 end=None if e >= 2 ** 31 - 1 else int(e))
    return out


@_imports("Split")
def _in_split(ctx, inputs, attrs):
    axis = int(attrs.get("axis", 0))
    split = attrs.get("split")
    if split is None and len(inputs) > 1 and inputs[1] is not None:
        split = [int(v) for v in ctx.const_value(inputs[1])]
    if split is not None and len(set(split)) != 1:
        raise MXNetError("Split with unequal parts %s is not supported"
                         % (split,))
    if split is not None:
        n = len(split)
    elif "num_outputs" in attrs:              # opset >= 18 attribute
        n = int(attrs["num_outputs"])
    else:                                     # opset < 18: equal split
        n = int(attrs["_n_outputs"])          # across the node's outputs
    return list(ctx.sym.SliceChannel(inputs[0], num_outputs=n, axis=axis))


@_imports("Concat")
def _in_concat(ctx, inputs, attrs):
    return ctx.sym.Concat(*inputs, dim=int(attrs.get("axis", 1)))


@_imports("Gather")
def _in_gather(ctx, inputs, attrs):
    return ctx.sym.take(inputs[0], inputs[1],
                        axis=int(attrs.get("axis", 0)))


@_imports("Expand")
def _in_expand(ctx, inputs, attrs):
    shape = tuple(int(s) for s in ctx.const_value(inputs[1]))
    return ctx.sym.broadcast_to(inputs[0], shape=shape)


@_imports("Tile")
def _in_tile(ctx, inputs, attrs):
    reps = tuple(int(r) for r in ctx.const_value(inputs[1]))
    return ctx.sym.tile(inputs[0], reps=reps)


@_imports("Pad")
def _in_pad(ctx, inputs, attrs):
    mode = attrs.get("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    pads = attrs.get("pads")
    if pads is None:
        pads = [int(v) for v in ctx.const_value(inputs[1])]
    n = len(pads) // 2
    # ONNX layout (b1..bn, e1..en) -> mx pad_width (b1, e1, b2, e2, ...)
    pad_width = []
    for i in range(n):
        pad_width += [int(pads[i]), int(pads[i + n])]
    value = attrs.get("value", 0.0)
    if len(inputs) > 2 and inputs[2] is not None:
        value = float(ctx.const_value(inputs[2]))
    return ctx.sym.Pad(inputs[0], mode="edge" if mode == "edge" else mode,
                       pad_width=tuple(pad_width), constant_value=value)


@_imports("Cast")
def _in_cast(ctx, inputs, attrs):
    from .onnx_proto import _ONNX_TO_NP

    to = int(attrs["to"])
    if to not in _ONNX_TO_NP:
        raise MXNetError("Cast: unsupported ONNX dtype %d" % to)
    return ctx.sym.Cast(inputs[0], dtype=_ONNX_TO_NP[to].name)


@_imports("Constant")
def _in_constant(ctx, inputs, attrs, _counter=[0]):
    _, helper, numpy_helper, _TP = _onnx_impl()

    tensor = attrs.get("value")
    if tensor is None:
        raise MXNetError("Constant without a `value` tensor attribute is "
                         "not supported")
    arr = _np.asarray(numpy_helper.to_array(tensor))
    _counter[0] += 1
    name = "_onnx_const_%d" % _counter[0]
    ctx.params[name] = arr
    return ctx.sym.var(name)


# -- reductions -------------------------------------------------------------

_REDUCE = {"ReduceMean": "mean", "ReduceSum": "sum", "ReduceMax": "max",
           "ReduceMin": "min", "ReduceProd": "prod"}


def _register_reduce():
    for onnx_name, mx_name in _REDUCE.items():
        @_imports(onnx_name)
        def _fn(ctx, inputs, attrs, _mx=mx_name):
            axes = _axes_arg(ctx, inputs, attrs)
            return getattr(ctx.sym, _mx)(
                inputs[0],
                axis=tuple(int(a) for a in axes) if axes else None,
                keepdims=bool(attrs.get("keepdims", 1)))


_register_reduce()


@_imports("ArgMax")
def _in_argmax(ctx, inputs, attrs):
    return ctx.sym.argmax(inputs[0], axis=int(attrs.get("axis", 0)),
                          keepdims=bool(attrs.get("keepdims", 1)))


@_imports("ArgMin")
def _in_argmin(ctx, inputs, attrs):
    return ctx.sym.argmin(inputs[0], axis=int(attrs.get("axis", 0)),
                          keepdims=bool(attrs.get("keepdims", 1)))


@_imports("Dropout")
def _in_dropout(ctx, inputs, attrs):
    return ctx.sym.Dropout(inputs[0], p=attrs.get("ratio", 0.5))


def import_model(model_file):
    """ONNX file -> (sym, arg_params, aux_params) (reference:
    onnx2mx/import_model.py:24)."""
    onnx, helper, numpy_helper, _TP = _onnx_impl()

    from .. import ndarray as nd
    from .. import symbol as sym_mod

    model = onnx.load(model_file)
    graph = model.graph
    opset = max([o.version for o in model.opset_import] or [13])
    params = {init.name: _np.asarray(numpy_helper.to_array(init))
              for init in graph.initializer}
    ctx = _ImportCtx(sym_mod, params, opset)
    tensors = {}
    for inp in graph.input:
        if inp.name not in params:
            tensors[inp.name] = sym_mod.var(inp.name)

    def get_attrs(node):
        out = {}
        for a in node.attribute:
            out[a.name] = helper.get_attribute_value(a)
        return out

    for node in graph.node:
        if node.op_type not in _IMPORT_OPS:
            raise MXNetError("ONNX op '%s' is not supported by the importer"
                             % node.op_type)
        ins = []
        for i in node.input:
            if not i:
                # empty string = omitted optional input (ONNX idiom);
                # keep the positional slot as None so later inputs don't
                # shift into the wrong argument positions
                ins.append(None)
                continue
            if i not in tensors:
                tensors[i] = sym_mod.var(i)   # lazily materialize params
            ins.append(tensors[i])
        while ins and ins[-1] is None:
            ins.pop()
        attrs = get_attrs(node)
        attrs["_n_outputs"] = len(node.output)
        out = _IMPORT_OPS[node.op_type](ctx, ins, attrs)
        outs = [out] if not isinstance(out, (list, tuple)) else out
        for name, o in zip(node.output, outs):
            tensors[name] = o
    outputs = [tensors[o.name] for o in graph.output]
    final = outputs[0] if len(outputs) == 1 else sym_mod.Group(outputs)
    arg_names = set(final.list_arguments())
    aux_names = set(final.list_auxiliary_states())
    arg_params = {k: nd.array(v) for k, v in params.items() if k in arg_names}
    aux_params = {k: nd.array(v) for k, v in params.items() if k in aux_names}
    return final, arg_params, aux_params


def get_model_metadata(model_file):
    onnx, _h, _nh, _TP = _onnx_impl()

    model = onnx.load(model_file)
    init = {i.name for i in model.graph.initializer}
    return {
        "input_tensor_data": [(i.name, tuple(d.dim_value for d in
                                             i.type.tensor_type.shape.dim))
                              for i in model.graph.input if i.name not in init],
        "output_tensor_data": [(o.name, tuple(d.dim_value for d in
                                              o.type.tensor_type.shape.dim))
                               for o in model.graph.output],
    }


# ===========================================================================
# export: Symbol -> ONNX graph
# ===========================================================================

_EXPORT_OPS = {}


def _exports(*names):
    def deco(fn):
        for n in names:
            _EXPORT_OPS[n] = fn
        return fn

    return deco


class _ExportCtx:
    """Per-export state handed to each op converter: node emission,
    initializer registration, and fresh-name generation."""

    def __init__(self, helper, numpy_helper, TensorProto):
        self.helper = helper
        self.numpy_helper = numpy_helper
        self.TensorProto = TensorProto
        self.nodes = []
        self.initializers = []
        self._n = 0

    def add(self, op_type, ins, outs, **attrs):
        self.nodes.append(self.helper.make_node(op_type, ins, outs, **attrs))
        return outs[0]

    def init(self, base, arr):
        """Register a constant initializer, return its name."""
        self._n += 1
        name = "%s_c%d" % (base, self._n)
        self.initializers.append(
            self.numpy_helper.from_array(_np.asarray(arr), name))
        return name

    def tmp(self, base):
        self._n += 1
        return "%s_t%d" % (base, self._n)


def _t2(v, default=(1, 1)):
    return list(v) if v else list(default)


@_exports("FullyConnected")
def _ex_fc(ctx, name, ins, a):
    if a.get("flatten", True) in (True, "True", 1):
        gemm_ins = ins[:3] if not a.get("no_bias") else ins[:2]
        ctx.add("Gemm", gemm_ins, [name], transB=1)
    else:
        # 3D dense (transformer projections): MatMul against W^T (+ bias)
        wt = ctx.tmp(name)
        ctx.add("Transpose", [ins[1]], [wt], perm=[1, 0])
        if a.get("no_bias"):
            ctx.add("MatMul", [ins[0], wt], [name])
        else:
            mm = ctx.tmp(name)
            ctx.add("MatMul", [ins[0], wt], [mm])
            ctx.add("Add", [mm, ins[2]], [name])


@_exports("Convolution")
def _ex_conv(ctx, name, ins, a):
    ctx.add("Conv", ins[:3] if not a.get("no_bias") else ins[:2], [name],
            kernel_shape=list(a.get("kernel", ())),
            strides=_t2(a.get("stride")),
            pads=list(a.get("pad", (0, 0)) or (0, 0)) * 2,
            dilations=_t2(a.get("dilate")),
            group=int(a.get("num_group", 1) or 1))


@_exports("Deconvolution")
def _ex_deconv(ctx, name, ins, a):
    ctx.add("ConvTranspose", ins[:3] if not a.get("no_bias") else ins[:2],
            [name],
            kernel_shape=list(a.get("kernel", ())),
            strides=_t2(a.get("stride")),
            pads=list(a.get("pad", (0, 0)) or (0, 0)) * 2,
            dilations=_t2(a.get("dilate")),
            group=int(a.get("num_group", 1) or 1))


@_exports("Activation")
def _ex_activation(ctx, name, ins, a):
    kind = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
            "softrelu": "Softplus", "softsign": "Softsign"}.get(
                a.get("act_type", "relu"))
    if kind is None:
        raise MXNetError("ONNX export: Activation act_type=%r not supported"
                         % a.get("act_type"))
    ctx.add(kind, ins[:1], [name])


_EX_UNARY = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
             "exp": "Exp", "log": "Log", "sqrt": "Sqrt", "abs": "Abs",
             "negative": "Neg", "erf": "Erf", "ceil": "Ceil",
             "floor": "Floor", "round": "Round", "reciprocal": "Reciprocal",
             "sin": "Sin", "cos": "Cos", "tan": "Tan", "arcsin": "Asin",
             "arccos": "Acos", "arctan": "Atan", "identity": "Identity",
             "_copy": "Identity", "BlockGrad": "Identity",
             "stop_gradient": "Identity", "sign": "Sign"}


def _register_ex_unary():
    for mx_name, onnx_name in _EX_UNARY.items():
        @_exports(mx_name)
        def _fn(ctx, name, ins, a, _onnx=onnx_name):
            ctx.add(_onnx, ins[:1], [name])


_register_ex_unary()


@_exports("LeakyReLU")
def _ex_leakyrelu(ctx, name, ins, a):
    kind = a.get("act_type", "leaky")
    if kind == "leaky":
        ctx.add("LeakyRelu", ins[:1], [name],
                alpha=float(a.get("slope", 0.25)))
    elif kind == "elu":
        ctx.add("Elu", ins[:1], [name], alpha=float(a.get("slope", 1.0)))
    elif kind == "prelu":
        ctx.add("PRelu", ins[:2], [name])
    elif kind == "gelu":
        # exact GELU decomposition: 0.5 * x * (1 + erf(x / sqrt(2)))
        x = ins[0]
        div = ctx.add("Div", [x, ctx.init(name, _np.float32(_np.sqrt(2.0)))],
                      [ctx.tmp(name)])
        erf = ctx.add("Erf", [div], [ctx.tmp(name)])
        one = ctx.add("Add", [erf, ctx.init(name, _np.float32(1.0))],
                      [ctx.tmp(name)])
        half = ctx.add("Mul", [x, one], [ctx.tmp(name)])
        ctx.add("Mul", [half, ctx.init(name, _np.float32(0.5))], [name])
    else:
        raise MXNetError("ONNX export: LeakyReLU act_type=%r not supported"
                         % kind)


@_exports("square")
def _ex_square(ctx, name, ins, a):
    ctx.add("Mul", [ins[0], ins[0]], [name])


@_exports("clip")
def _ex_clip(ctx, name, ins, a):
    ctx.add("Clip",
            [ins[0], ctx.init(name, _np.float32(a.get("a_min", 0.0))),
             ctx.init(name, _np.float32(a.get("a_max", 1.0)))], [name])


@_exports("Pooling")
def _ex_pooling(ctx, name, ins, a):
    ptype = a.get("pool_type", "max")
    if ptype not in ("max", "avg"):
        raise MXNetError("ONNX export: pool_type=%r not supported" % ptype)
    if a.get("global_pool"):
        ctx.add("GlobalMaxPool" if ptype == "max" else "GlobalAveragePool",
                ins[:1], [name])
        return
    kw = dict(kernel_shape=list(a.get("kernel", ())),
              strides=_t2(a.get("stride")),
              pads=list(a.get("pad", (0, 0)) or (0, 0)) * 2)
    if a.get("pooling_convention") == "full":
        kw["ceil_mode"] = 1
    if ptype == "avg":
        kw["count_include_pad"] = 1 if a.get("count_include_pad", True) \
            else 0
    ctx.add("MaxPool" if ptype == "max" else "AveragePool", ins[:1],
            [name], **kw)


@_exports("BatchNorm")
def _ex_bn(ctx, name, ins, a):
    gamma = ins[1]
    if a.get("fix_gamma", True) in (True, "True", 1):
        # mx semantics: gamma forced to 1 regardless of the stored tensor;
        # ONNX has no such flag, so export a ones scale initializer
        gamma = ctx.add("Sub", [ins[1], ins[1]], [ctx.tmp(name)])
        gamma = ctx.add("Add",
                        [gamma, ctx.init(name, _np.float32(1.0))],
                        [ctx.tmp(name)])
    ctx.add("BatchNormalization", [ins[0], gamma] + ins[2:5], [name],
            # note: the mx BatchNorm op default eps is 1e-3 (reference
            # batch_norm.cc), not ONNX's 1e-5 — export must use the op's
            # default when the attr is absent
            epsilon=float(a.get("eps", 1e-3)),
            momentum=float(a.get("momentum", 0.9)))


@_exports("LayerNorm")
def _ex_layernorm(ctx, name, ins, a):
    ctx.add("LayerNormalization", ins[:3], [name],
            axis=int(a.get("axis", -1)), epsilon=float(a.get("eps", 1e-5)))


@_exports("InstanceNorm")
def _ex_instancenorm(ctx, name, ins, a):
    ctx.add("InstanceNormalization", ins[:3], [name],
            epsilon=float(a.get("eps", 1e-3)))


@_exports("LRN")
def _ex_lrn(ctx, name, ins, a):
    ctx.add("LRN", ins[:1], [name], size=int(a.get("nsize", 5)),
            alpha=float(a.get("alpha", 1e-4)),
            beta=float(a.get("beta", 0.75)),
            bias=float(a.get("knorm", 2.0)))


@_exports("L2Normalization")
def _ex_l2norm(ctx, name, ins, a):
    if a.get("mode", "instance") not in ("instance", "channel"):
        raise MXNetError("L2Normalization mode=%r not exportable"
                         % a.get("mode"))
    ctx.add("LpNormalization", ins[:1], [name], p=2,
            axis=1 if a.get("mode") == "channel" else -1)


@_exports("Flatten", "flatten")
def _ex_flatten(ctx, name, ins, a):
    ctx.add("Flatten", ins[:1], [name])


@_exports("softmax", "SoftmaxOutput", "SoftmaxActivation")
def _ex_softmax(ctx, name, ins, a):
    ctx.add("Softmax", ins[:1], [name], axis=int(a.get("axis", -1)))


@_exports("log_softmax")
def _ex_logsoftmax(ctx, name, ins, a):
    ctx.add("LogSoftmax", ins[:1], [name], axis=int(a.get("axis", -1)))


_EX_BINARY = {"elemwise_add": "Add", "elemwise_sub": "Sub",
              "elemwise_mul": "Mul", "elemwise_div": "Div",
              "broadcast_add": "Add", "broadcast_sub": "Sub",
              "broadcast_mul": "Mul", "broadcast_div": "Div",
              "broadcast_power": "Pow", "_power": "Pow",
              "broadcast_maximum": "Max", "broadcast_minimum": "Min",
              "maximum": "Max", "minimum": "Min", "dot": "MatMul"}


def _register_ex_binary():
    for mx_name, onnx_name in _EX_BINARY.items():
        @_exports(mx_name)
        def _fn(ctx, name, ins, a, _onnx=onnx_name):
            ctx.add(_onnx, ins[:2], [name])


_register_ex_binary()


@_exports("add_n")
def _ex_addn(ctx, name, ins, a):
    ctx.add("Sum", ins, [name])


_EX_SCALAR = {"_plus_scalar": ("Add", False), "_minus_scalar": ("Sub", False),
              "_rminus_scalar": ("Sub", True), "_mul_scalar": ("Mul", False),
              "_div_scalar": ("Div", False), "_rdiv_scalar": ("Div", True),
              "_power_scalar": ("Pow", False)}


def _register_ex_scalar():
    for mx_name, (onnx_name, rev) in _EX_SCALAR.items():
        @_exports(mx_name)
        def _fn(ctx, name, ins, a, _onnx=onnx_name, _rev=rev):
            c = ctx.init(name, _np.float32(a.get("scalar", 0.0)))
            pair = [c, ins[0]] if _rev else [ins[0], c]
            ctx.add(_onnx, pair, [name])


_register_ex_scalar()


@_exports("batch_dot")
def _ex_batchdot(ctx, name, ins, a):
    lhs, rhs = ins[0], ins[1]
    if a.get("transpose_a"):
        raise MXNetError("batch_dot transpose_a export is not supported")
    if a.get("transpose_b"):
        # rank known to be 3 for batch_dot
        rt = ctx.tmp(name)
        ctx.add("Transpose", [rhs], [rt], perm=[0, 2, 1])
        rhs = rt
    ctx.add("MatMul", [lhs, rhs], [name])


@_exports("linalg_gemm2", "_linalg_gemm2")
def _ex_gemm2(ctx, name, ins, a):
    if a.get("transpose_a") or a.get("transpose_b") or \
            a.get("alpha", 1.0) != 1.0:
        raise MXNetError("linalg_gemm2 with transpose/alpha is not "
                         "exportable")
    ctx.add("MatMul", ins[:2], [name])


@_exports("where")
def _ex_where(ctx, name, ins, a):
    cond = ctx.tmp(name)
    ctx.add("Cast", [ins[0]], [cond], to=9)   # BOOL
    ctx.add("Where", [cond, ins[1], ins[2]], [name])


@_exports("Reshape", "reshape")
def _ex_reshape(ctx, name, ins, a):
    # mx 0/-1 special values match ONNX Reshape semantics (allowzero=0)
    shape = ctx.init(name, _np.asarray(a.get("shape", ()), _np.int64))
    ctx.add("Reshape", [ins[0], shape], [name])


@_exports("transpose")
def _ex_transpose(ctx, name, ins, a):
    axes = a.get("axes")
    if axes:
        ctx.add("Transpose", ins[:1], [name], perm=list(axes))
    else:
        ctx.add("Transpose", ins[:1], [name])


@_exports("expand_dims")
def _ex_expanddims(ctx, name, ins, a):
    axes = ctx.init(name, _np.asarray([int(a.get("axis", 0))], _np.int64))
    ctx.add("Unsqueeze", [ins[0], axes], [name])


@_exports("squeeze")
def _ex_squeeze(ctx, name, ins, a):
    ax = a.get("axis")
    if ax is None:
        ctx.add("Squeeze", ins[:1], [name])
    else:
        ax = [ax] if isinstance(ax, int) else list(ax)
        axes = ctx.init(name, _np.asarray(ax, _np.int64))
        ctx.add("Squeeze", [ins[0], axes], [name])


@_exports("slice_axis")
def _ex_sliceaxis(ctx, name, ins, a):
    end = a.get("end")
    ctx.add("Slice",
            [ins[0],
             ctx.init(name, _np.asarray([int(a.get("begin", 0))], _np.int64)),
             ctx.init(name, _np.asarray(
                 [2 ** 31 - 1 if end is None else int(end)], _np.int64)),
             ctx.init(name, _np.asarray([int(a.get("axis", 0))], _np.int64))],
            [name])


@_exports("SliceChannel", "split")
def _ex_split(ctx, name, ins, a, outs=None):
    n = int(a.get("num_outputs", 1))
    outs = outs or [name] + ["%s_out%d" % (name, i) for i in range(1, n)]
    if a.get("squeeze_axis"):
        raise MXNetError("SliceChannel squeeze_axis export not supported")
    ctx.nodes.append(ctx.helper.make_node(
        "Split", [ins[0]], outs, axis=int(a.get("axis", 1))))


@_exports("Concat", "concat")
def _ex_concat(ctx, name, ins, a):
    ctx.add("Concat", ins, [name], axis=int(a.get("dim", 1)))


@_exports("Embedding")
def _ex_embedding(ctx, name, ins, a):
    # Gather(weight, indices): data-first argument order flips
    ctx.add("Gather", [ins[1], ins[0]], [name], axis=0)


@_exports("take")
def _ex_take(ctx, name, ins, a):
    if a.get("mode", "clip") not in ("clip", "raise"):
        raise MXNetError("take mode=%r not exportable" % a.get("mode"))
    ctx.add("Gather", ins[:2], [name], axis=int(a.get("axis", 0)))


@_exports("broadcast_to")
def _ex_broadcastto(ctx, name, ins, a):
    shape = ctx.init(name, _np.asarray(a.get("shape", ()), _np.int64))
    ctx.add("Expand", [ins[0], shape], [name])


@_exports("tile")
def _ex_tile(ctx, name, ins, a):
    reps = ctx.init(name, _np.asarray(a.get("reps", ()), _np.int64))
    ctx.add("Tile", [ins[0], reps], [name])


@_exports("Pad", "pad")
def _ex_pad(ctx, name, ins, a):
    pw = list(a.get("pad_width", ()))
    n = len(pw) // 2
    # mx (b1, e1, b2, e2, ...) -> ONNX (b1..bn, e1..en)
    pads = [pw[2 * i] for i in range(n)] + [pw[2 * i + 1] for i in range(n)]
    mode = a.get("mode", "constant")
    ctx.add("Pad",
            [ins[0], ctx.init(name, _np.asarray(pads, _np.int64)),
             ctx.init(name, _np.float32(a.get("constant_value", 0.0)))],
            [name], mode="edge" if mode == "edge" else mode)


@_exports("Cast")
def _ex_cast(ctx, name, ins, a):
    from .onnx_proto import _NP_TO_ONNX

    dt = _np.dtype(a.get("dtype", "float32"))
    if dt not in _NP_TO_ONNX:
        raise MXNetError("Cast dtype %s not exportable" % dt)
    ctx.add("Cast", ins[:1], [name], to=int(_NP_TO_ONNX[dt]))


@_exports("Dropout")
def _ex_dropout(ctx, name, ins, a):
    ctx.add("Dropout", ins[:1], [name])


def _register_ex_reduce():
    for mx_name, onnx_name in [("mean", "ReduceMean"), ("sum", "ReduceSum"),
                               ("max", "ReduceMax"), ("min", "ReduceMin"),
                               ("prod", "ReduceProd")]:
        @_exports(mx_name)
        def _fn(ctx, name, ins, a, _onnx=onnx_name):
            ax = a.get("axis")
            kw = {"keepdims": 1 if a.get("keepdims") else 0}
            if _onnx == "ReduceSum":
                # opset 13 moved ReduceSum axes to an input
                extra = [] if ax is None else \
                    [ctx.init(name, _np.asarray(
                        [ax] if isinstance(ax, int) else list(ax),
                        _np.int64))]
                ctx.add(_onnx, ins[:1] + extra, [name], **kw)
            else:
                if ax is not None:
                    kw["axes"] = [ax] if isinstance(ax, int) else list(ax)
                ctx.add(_onnx, ins[:1], [name], **kw)


_register_ex_reduce()


@_exports("argmax")
def _ex_argmax(ctx, name, ins, a):
    ctx.add("ArgMax", ins[:1], [name], axis=int(a.get("axis", 0) or 0),
            keepdims=1 if a.get("keepdims") else 0)


@_exports("zeros_like")
def _ex_zeroslike(ctx, name, ins, a):
    ctx.add("Sub", [ins[0], ins[0]], [name])


@_exports("ones_like")
def _ex_oneslike(ctx, name, ins, a):
    z = ctx.add("Sub", [ins[0], ins[0]], [ctx.tmp(name)])
    ctx.add("Add", [z, ctx.init(name, _np.float32(1.0))], [name])


@_exports("argmin")
def _ex_argmin(ctx, name, ins, a):
    ctx.add("ArgMin", ins[:1], [name], axis=int(a.get("axis", 0) or 0),
            keepdims=1 if a.get("keepdims") else 0)


def export_model(sym, params, input_shape, input_type=_np.float32,
                 onnx_file_path="model.onnx", verbose=False):
    """Symbol + params -> ONNX file (reference: mx2onnx/export_model.py:35).
    Op coverage mirrors the reference mx2onnx table over the in-tree model
    zoo (see module docstring for the documented divergences)."""
    onnx, helper, numpy_helper, TensorProto = _onnx_impl()

    params = {k.split(":", 1)[-1]: (v.asnumpy() if hasattr(v, "asnumpy")
                                    else _np.asarray(v))
              for k, v in params.items()}
    ctx = _ExportCtx(helper, numpy_helper, TensorProto)
    name_of = {}

    def edge_name(node, idx):
        base = name_of[id(node)]
        return base if idx == 0 else "%s_out%d" % (base, idx)

    topo = list(sym._topo())
    for node in topo:
        # an op without a row is named before any other refusal
        if not node.is_var and node.op not in _EXPORT_OPS:
            raise MXNetError(
                "ONNX export: op '%s' not supported (covered ops: %d; "
                "MultiBox*/nms and fused RNN have no ONNX mapping — use "
                "Predictor.export_compiled for those models)"
                % (node.op, len(_EXPORT_OPS)))
    inputs_proto = []
    for node in topo:
        if node.is_var:
            name_of[id(node)] = node.name
            if node.name in params:
                ctx.initializers.append(
                    numpy_helper.from_array(
                        _np.ascontiguousarray(params[node.name]), node.name))
            else:
                shape = list(input_shape) if not isinstance(input_shape, dict) \
                    else list(input_shape[node.name])
                from .onnx_proto import _NP_TO_ONNX

                elem = int(_NP_TO_ONNX.get(_np.dtype(input_type),
                                           TensorProto.FLOAT))
                inputs_proto.append(helper.make_tensor_value_info(
                    node.name, elem, shape))
            continue
        name_of[id(node)] = node.name
        ins = [edge_name(s, i) for s, i in node.inputs]
        _check_layout(node)
        _EXPORT_OPS[node.op](ctx, node.name, ins, node.attrs)

    out_names = [edge_name(n, i) for n, i in sym._outputs]
    graph = helper.make_graph(
        ctx.nodes, "mxnet_tpu_model", inputs_proto,
        [helper.make_tensor_value_info(n, TensorProto.FLOAT, None)
         for n in out_names],
        initializer=ctx.initializers)
    if _is_shim(onnx):
        model = helper.make_model(graph, opset_version=17)
    else:
        model = helper.make_model(
            graph, opset_imports=[helper.make_opsetid("", 17)])
    onnx.save(model, onnx_file_path)
    return onnx_file_path


def _check_layout(node):
    """ONNX's Conv, pooling and BatchNormalization read channels at axis 1:
    refuse a node that keeps them elsewhere instead of writing a file that
    computes something else."""
    layout = str(node.attrs.get("layout") or "")
    if node.op in ("Convolution", "Deconvolution", "Pooling") and \
            layout.endswith("C") and len(layout) > 2:
        raise MXNetError("ONNX export: op '%s' (%s) has layout %s; ONNX's "
                         "operator is channels-first (NC...): export the "
                         "channels-first graph" % (node.op, node.name,
                                                   layout))
    if node.op == "BatchNorm" and int(node.attrs.get("axis", 1)) != 1:
        raise MXNetError("ONNX export: op 'BatchNorm' (%s) normalizes axis "
                         "%s; ONNX's BatchNormalization takes axis 1"
                         % (node.name, node.attrs.get("axis")))


def _is_shim(onnx_mod):
    return getattr(onnx_mod, "__version__", "").startswith("shim")
