"""Custom operators defined in Python (counterpart of `mxnet_tpu/operator.py`;
reference: python/mxnet/operator.py: CustomOp :426, CustomOpProp :472,
register :692, with the C++ bridge of src/operator/custom/).

One registry op, ``Custom``, runs the user's `CustomOp` as a
`torch.autograd.Function`, so every consumer works unchanged: ``mx.nd.Custom``
under the autograd tape, ``mx.sym.Custom`` in a bound executor (and its
shape inference), and ``F.Custom`` in a `HybridBlock`.

The user's ``forward`` and ``backward`` run on NDArrays that wrap the
Function's own tensors, on the inputs' device: a card's inputs stay on the
card, and the op's output and gradient arrays are made there for the user
to write in place (a kernel of `rtc` may launch on them). This is the
reference's behaviour (src/operator/custom/custom-inl.h). The JAX package
copies them to host arrays instead, because its accelerator is blocked
while its callback runs; the port has no such constraint, and never moves
an input to the host behind the user's back.

The protocol is otherwise the JAX package's, so a user op sees the same
calls in both: the `CustomOpProp` is built from string keyword arguments
(once a set of them), props with auxiliary states are refused, ``is_train``
comes from the dispatch layer (autograd's training mode for ``mx.nd``, the
executor's for a bound symbol), every request is ``"write"``, the user's
calls are not recorded on the outer tape (`autograd.pause`), and the
backward recomputes the forward with ``is_train=True`` before it calls
``backward``. The gradients handed to ``backward`` are contiguous arrays
of their own (torch may pass an expanded one).
"""
from __future__ import annotations

import torch

from .base import MXNetError, np_dtype, torch_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered_operators"]

_CUSTOM_PROPS = {}


class CustomOp:
    """Base class for user ops (reference: operator.py:426)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` honoring ``req`` (reference:
        operator.py:447). ``src`` made on another device (``mx.nd.array``
        on the default context) is copied to ``dst``'s, as the reference's
        ``dst[:] = src`` does."""
        if req in ("null",):
            return
        if hasattr(src, "as_in_context"):
            src = src.as_in_context(dst.context)
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError("unknown req '%s'" % req)


class CustomOpProp:
    """Op metadata provider (reference: operator.py:472)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a CustomOpProp subclass under op_type ``reg_name``
    (reference: operator.py:692). Registering a name again replaces it,
    and the props built from the old class are dropped."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_PROPS[reg_name] = prop_cls
        _PROPS.pop(reg_name, None)
        return prop_cls

    return deco


def get_all_registered_operators():
    return sorted(_CUSTOM_PROPS)


# --------------------------------------------------------------------------
# the bridge: one registry op "Custom"
# --------------------------------------------------------------------------

# op_type -> {attr_key: prop}: one prop a set of keyword arguments, keyed by
# name first so re-registration drops exactly one op_type's props
_PROPS = {}


def _make_prop(op_type, attr_key):
    by_key = _PROPS.setdefault(op_type, {})
    prop = by_key.get(attr_key)
    if prop is not None:
        return prop
    if op_type not in _CUSTOM_PROPS:
        raise MXNetError("custom op '%s' is not registered (known: %s)"
                         % (op_type, sorted(_CUSTOM_PROPS)))
    # reference passes user kwargs to the Prop as strings (custom.cc attrs)
    prop = _CUSTOM_PROPS[op_type](**{k: str(v) for k, v in attr_key})
    if prop.list_auxiliary_states():
        raise MXNetError("custom ops with auxiliary states are not supported")
    by_key[attr_key] = prop
    return prop


def _infer(prop, tensors):
    """(output shapes, output dtypes as numpy dtypes or "bfloat16")."""
    in_shapes = [list(t.shape) for t in tensors]
    in_shapes, out_shapes, _ = prop.infer_shape(in_shapes)
    in_types = [np_dtype(t.dtype) for t in tensors]
    _, out_types, _ = prop.infer_type(in_types)
    return ([tuple(int(d) for d in s) for s in out_shapes],
            [np_dtype(t) for t in out_types])


def _wrap(tensors):
    from .ndarray.ndarray import NDArray

    return [NDArray(t.detach().contiguous()) for t in tensors]


def _run_forward(prop, tensors, is_train):
    """The user's forward on the inputs' device; returns (in_data,
    out_data, op). Shared by the forward and the backward's recompute."""
    from . import autograd
    from .context import Context

    device = tensors[0].device
    in_nd = _wrap(tensors)
    out_shapes, out_types = _infer(prop, tensors)
    from .ndarray.ndarray import NDArray

    out_nd = [NDArray(torch.zeros(s, dtype=torch_dtype(t), device=device))
              for s, t in zip(out_shapes, out_types)]
    op = prop.create_operator(Context(device),
                              [list(t.shape) for t in tensors],
                              [np_dtype(t.dtype) for t in tensors])
    with autograd.pause():
        op.forward(is_train=is_train, req=["write"] * len(out_nd),
                   in_data=in_nd, out_data=out_nd, aux=[])
    return in_nd, out_nd, op


class _CustomFunction(torch.autograd.Function):
    """A user op as a node of torch's graph."""

    @staticmethod
    def forward(ctx, prop, is_train, *tensors):
        _, out_nd, _ = _run_forward(prop, tensors, is_train)
        ctx.prop = prop
        ctx.save_for_backward(*tensors)
        outs = tuple(o._data for o in out_nd)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cots):
        from . import autograd
        from .ndarray.ndarray import NDArray

        tensors = ctx.saved_tensors
        in_nd, out_nd, op = _run_forward(ctx.prop, tensors, True)
        ograd_nd = [NDArray(torch.zeros_like(o._data) if g is None
                            else g.clone(memory_format=torch.contiguous_format))
                    for g, o in zip(cots, out_nd)]
        igrad_nd = [NDArray(torch.zeros_like(a._data)) for a in in_nd]
        with autograd.pause():
            op.backward(req=["write"] * len(in_nd), out_grad=ograd_nd,
                        in_data=in_nd, out_data=out_nd, in_grad=igrad_nd,
                        aux=[])
        grads = tuple(g._data if need else None
                      for g, need in zip(igrad_nd, ctx.needs_input_grad[2:]))
        return (None, None) + grads


def _custom_dispatch(*arrays, op_type=None, is_train=False, **kwargs):
    """The registry op function for 'Custom' (reference entry:
    nd.Custom(*data, op_type=...) -> custom.cc CustomOperator). On ``meta``
    tensors (shape inference) the outputs come from the prop's
    ``infer_shape`` / ``infer_type`` and no user code runs."""
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    attr_key = tuple(sorted((k, str(v)) for k, v in kwargs.items()))
    prop = _make_prop(op_type, attr_key)
    if any(t.device.type == "meta" for t in arrays):
        shapes, types = _infer(prop, arrays)
        out = tuple(torch.empty(s, dtype=torch_dtype(t), device="meta")
                    for s, t in zip(shapes, types))
    else:
        out = _CustomFunction.apply(prop, bool(is_train), *arrays)
    return out[0] if len(out) == 1 else tuple(out)


from . import ops as _ops  # noqa: E402

_ops.register("Custom", num_outputs=-1)(_custom_dispatch)

# install the generated front-end functions (``mx.nd`` and ``mx.sym`` were
# populated before this module registered the op)
from . import ndarray as _nd_mod  # noqa: E402
from . import symbol as _sym_mod  # noqa: E402
from .ndarray.register import _make_function  # noqa: E402
from .symbol.register import _make_symbol_function  # noqa: E402

_nd_mod.Custom = _nd_mod.op.Custom = _make_function(_ops.get("Custom"))
_sym_mod.Custom = _sym_mod.op.Custom = _make_symbol_function(
    _ops.get("Custom"))
_sym_mod._functions["Custom"] = _sym_mod.Custom
