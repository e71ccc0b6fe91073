"""Symbol: the declarative graph-building API (counterpart of
`mxnet_tpu/symbol/symbol.py`; reference: python/mxnet/symbol/symbol.py).

The graph is a small Python DAG of `_Node`s over the same op registry the
imperative path uses (`mxnet_tpu_torch.ops`). Binding a Symbol gives an
`Executor` that interprets the graph eagerly on torch tensors; gradients
come from torch.autograd over that interpretation. Shape inference runs
the same interpretation on ``meta`` tensors, where every kernel wrapper
takes its plain version and only shapes are computed. ``tojson`` writes
the JAX package's JSON, so a ``-symbol.json`` crosses between the two
packages either way.
"""
from __future__ import annotations

import json

import numpy as _np
import torch

from ..base import MXNetError
from .. import engine as _engine
from .. import ops as _ops

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "pow", "maximum", "minimum", "ones_like", "zeros_like"]

class _Node:
    """One graph node: a variable (op is None) or an op application."""

    __slots__ = ("op", "name", "attrs", "inputs", "aux_slots", "_shape", "_dtype")

    def __init__(self, op, name, attrs=None, inputs=None, aux_slots=()):
        self.op = op                     # op name in the registry, or None
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs or [])  # [(Node, out_index)]
        self.aux_slots = tuple(aux_slots)  # indices into `inputs` that are aux
        self._shape = None                # declared shape, for variables
        self._dtype = None

    @property
    def is_var(self):
        return self.op is None

    def num_outputs(self):
        if self.is_var:
            return 1
        od = _ops.get(self.op)
        if od.num_outputs > 0:
            return od.num_outputs
        if od.num_outputs_fn is not None:
            # variadic arity resolved from this node's attrs (e.g. Proposal
            # grows a score output under output_score=True)
            return max(1, od.num_outputs_fn(self.attrs))
        return 1

    def visible_outputs(self):
        if self.is_var:
            return 1
        od = _ops.get(self.op)
        if od.num_outputs > 0:
            return max(1, od.visible_outputs)
        return self.num_outputs()


class Symbol:
    """A handle on one or more graph outputs (reference: symbol.py Symbol)."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)    # [(Node, out_index)]

    # -- identity ----------------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        if len(self._outputs) == 1:
            return "<Symbol %s>" % self._outputs[0][0].name
        return "<Symbol group [%s]>" % ", ".join(n.name for n, _ in self._outputs)

    def __iter__(self):
        return (Symbol([o]) for o in self._outputs)

    def __len__(self):
        return len(self.list_outputs())

    def __getitem__(self, index):
        outs = self.list_outputs()
        if isinstance(index, str):
            if index not in outs:
                raise MXNetError("output '%s' not found in %s" % (index, outs))
            index = outs.index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        # graph nodes are immutable once composed; sharing them is safe
        return Symbol(list(self._outputs))

    # -- graph walking -----------------------------------------------------
    def _topo(self):
        # DFS post-order visiting inputs left-to-right: variables appear in
        # the order the graph consumes them (data before weights before the
        # next layer's weights), matching the reference's nnvm IndexedGraph
        # argument ordering
        order, seen = [], set()
        stack = [(n, False) for n, _ in reversed(self._outputs)]
        while stack:
            node, processed = stack.pop()
            if processed:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for m, _ in reversed(node.inputs):
                if id(m) not in seen:
                    stack.append((m, False))
        return order

    def list_arguments(self):
        """Variable names feeding the graph, minus aux states
        (reference: symbol.py list_arguments)."""
        aux = set(self._aux_nodes())
        return [n.name for n in self._topo() if n.is_var and id(n) not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_nodes()
        order = [id(n) for n in self._topo()]
        return [n.name for n in sorted(
            {i: n for i, n in aux.items()}.values(),
            key=lambda n: order.index(id(n)))]

    def _aux_nodes(self):
        """Vars wired into aux input slots (BatchNorm moving stats...)."""
        aux = {}
        for node in self._topo():
            for slot in node.aux_slots:
                src, _ = node.inputs[slot]
                if src.is_var:
                    aux[id(src)] = src
        return aux

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.is_var:
                names.append(node.name)
            elif node.visible_outputs() == 1:
                names.append(node.name + "_output")
            else:
                names.append("%s_output%d" % (node.name, idx))
        return names

    def list_inputs(self):
        return [n.name for n in self._topo() if n.is_var]

    def get_internals(self):
        """Every node output as a group (reference: symbol.py get_internals)."""
        outs = []
        for node in self._topo():
            for i in range(node.visible_outputs()):
                outs.append((node, i))
        return Symbol(outs)

    def get_children(self):
        kids = []
        for node, _ in self._outputs:
            kids.extend(node.inputs)
        return Symbol(kids) if kids else None

    @property
    def attrs(self):
        if len(self._outputs) == 1:
            return dict(self._outputs[0][0].attrs)
        return {}

    def attr(self, key):
        attrs = self._outputs[0][0].attrs
        if key in attrs:
            return attrs[key]
        return attrs.get("__%s__" % key.strip("_"))

    def attr_dict(self):
        return {n.name: {k: str(v) for k, v in n.attrs.items()}
                for n in self._topo() if n.attrs}

    # -- composition helpers ----------------------------------------------
    def _binop(self, other, opname, reverse=False):
        from . import _functions

        f = _functions[opname]
        if isinstance(other, Symbol):
            return f(other, self) if reverse else f(self, other)
        scalar_ops = {"broadcast_add": "_plus_scalar",
                      "broadcast_sub": "_rminus_scalar" if reverse else "_minus_scalar",
                      "broadcast_mul": "_mul_scalar",
                      "broadcast_div": "_rdiv_scalar" if reverse else "_div_scalar",
                      "broadcast_power": "_rpower_scalar" if reverse else "_power_scalar",
                      "broadcast_mod": "_rmod_scalar" if reverse else "_mod_scalar",
                      "broadcast_greater": "_lesser_scalar" if reverse else "_greater_scalar",
                      "broadcast_lesser": "_greater_scalar" if reverse else "_lesser_scalar",
                      "broadcast_greater_equal": "_lesser_equal_scalar" if reverse else "_greater_equal_scalar",
                      "broadcast_lesser_equal": "_greater_equal_scalar" if reverse else "_lesser_equal_scalar",
                      "broadcast_equal": "_equal_scalar",
                      "broadcast_not_equal": "_not_equal_scalar"}
        sop = scalar_ops.get(opname)
        if sop is None:
            raise MXNetError("unsupported scalar operand for %s" % opname)
        return _functions[sop](self, scalar=float(other))

    def __add__(self, other):
        return self._binop(other, "broadcast_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "broadcast_sub")

    def __rsub__(self, other):
        return self._binop(other, "broadcast_sub", reverse=True)

    def __mul__(self, other):
        return self._binop(other, "broadcast_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "broadcast_div")

    def __rtruediv__(self, other):
        return self._binop(other, "broadcast_div", reverse=True)

    def __mod__(self, other):
        return self._binop(other, "broadcast_mod")

    def __pow__(self, other):
        return self._binop(other, "broadcast_power")

    def __neg__(self):
        return self.__mul__(-1.0)

    def __eq__(self, other):  # noqa: comparison builds graph, like reference
        return self._binop(other, "broadcast_equal")

    def __ne__(self, other):
        return self._binop(other, "broadcast_not_equal")

    def __gt__(self, other):
        return self._binop(other, "broadcast_greater")

    def __ge__(self, other):
        return self._binop(other, "broadcast_greater_equal")

    def __lt__(self, other):
        return self._binop(other, "broadcast_lesser")

    def __le__(self, other):
        return self._binop(other, "broadcast_lesser_equal")

    def __hash__(self):
        return id(self)

    def __getattr__(self, name):
        # sym.reshape(...)-style method calls on single-output symbols
        from . import _functions

        if name.startswith("_"):
            raise AttributeError(name)
        f = _functions.get(name)
        if f is None:
            raise AttributeError("Symbol has no attribute/op '%s'" % name)

        def call(*args, **kwargs):
            return f(self, *args, **kwargs)

        return call

    # -- interpretation ----------------------------------------------------
    def _interpret(self, values, is_train=False, generator=None,
                   device=None):
        """Evaluate the graph on torch tensors, ``values`` {var name:
        tensor}; returns the output tensors. An op taking ``is_train`` gets
        ``is_train``; a random op draws from ``generator`` (default: this
        thread's generator for its first input's device); an op with no
        array input (``_zeros``, ``_arange``...) puts its outputs on
        ``device`` when given (the bound device), as the JAX package's land
        on the current context. BatchNorm writes its moving statistics into
        the aux tensors in place in training (the reference's in-place aux
        update; the JAX package returns them instead)."""
        computed = {}
        for node in self._topo():
            if node.is_var:
                if node.name not in values:
                    raise MXNetError("missing value for variable '%s'"
                                     % node.name)
                computed[id(node)] = (values[node.name],)
                continue
            opdef = _ops.get(node.op)
            in_arrays = tuple(computed[id(src)][idx]
                              for src, idx in node.inputs)
            # user/scope attributes (`__key__`) are graph metadata, not op
            # params
            attrs = {k: v for k, v in node.attrs.items()
                     if not (k.startswith("__") and k.endswith("__"))}
            if _ops.takes_is_train(opdef):
                attrs.setdefault("is_train", is_train)
            if opdef.needs_rng:
                attrs["generator"] = generator if generator is not None \
                    else _rng_for(in_arrays, device)
            # the generated caller records parameter names when inputs bind
            # to non-leading slots (optional array args skipped)
            bind_names = node.attrs.get("__input_names__")
            if bind_names is not None and len(bind_names) == len(in_arrays):
                out = opdef.fn(**dict(zip(bind_names, in_arrays)), **attrs)
            elif in_arrays or device is None:
                out = opdef.fn(*in_arrays, **attrs)
            else:
                with torch.device(device):   # factories make it there
                    out = opdef.fn(**attrs)
            first = out[0] if isinstance(out, (tuple, list)) else out
            if torch.is_tensor(first):
                _engine.op_done(first.device)
            computed[id(node)] = tuple(out) if isinstance(out, (tuple, list)) \
                else (out,)
        return [computed[id(node)][idx] for node, idx in self._outputs]

    # -- evaluation convenience -------------------------------------------
    def eval(self, ctx=None, **kwargs):
        """Evaluate with NDArray (or array-like) kwargs on ``ctx`` (default:
        the first NDArray's device, else `current_context`); a list of
        NDArrays (reference: symbol.py eval)."""
        from ..ndarray import NDArray, array

        if ctx is None:
            ctx = next((v.context for v in kwargs.values()
                        if isinstance(v, NDArray)), None)
        values = {k: (v if isinstance(v, NDArray) else array(v, ctx=ctx))
                  ._data for k, v in kwargs.items()}
        dev = next(iter(values.values())).device if values else None
        with torch.no_grad():
            outs = self._interpret(values, device=dev)
        return [NDArray(o.contiguous()) for o in outs]

    def eval_with(self, values):
        res = self.eval(**values)
        return res[0] if len(res) == 1 else res

    # -- shape/type inference ---------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) (reference: symbol.py
        infer_shape). Unknown weight shapes come from per-op rules
        (`register._ARG_SHAPE_RULES`), then shapes propagate forward by
        running the graph on ``meta`` tensors (the counterpart of the JAX
        package's ``jax.eval_shape``)."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        from .register import infer_var_shapes, meta_eval

        known = {}
        if args:
            for name, shape in zip(self.list_arguments(), args):
                if shape is not None:
                    known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})

        shapes = infer_var_shapes(self, known)   # fills weights from op rules

        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        missing = [n for n in arg_names + aux_names if n not in shapes]
        if missing and not partial:
            raise MXNetError("infer_shape: cannot infer shapes for %s"
                             % missing)
        try:
            out_shapes = [tuple(o.shape) for o in meta_eval(
                lambda vals: self._interpret(vals, is_train=True,
                                             generator=torch.Generator()),
                shapes)]
        except Exception:
            if partial:
                out_shapes = [None] * len(self._outputs)
            else:
                raise
        arg_shapes = [shapes.get(n) for n in arg_names]
        aux_shapes = [shapes.get(n) for n in aux_names]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """Every argument, output and aux state takes the first given
        dtype (float32 when none is), as in the JAX package."""
        dtype = _np.float32
        for a in list(args) + list(kwargs.values()):
            if a is not None:
                dtype = a
                break
        return ([dtype] * len(self.list_arguments()),
                [dtype] * len(self._outputs),
                [dtype] * len(self.list_auxiliary_states()))

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Allocate argument, gradient and aux arrays from the inferred
        shapes on ``ctx`` (default `current_context`) and bind (reference:
        graph_executor.cc:1694 SimpleBind). Arrays of ``shared_exec`` (or
        ``shared_buffer``) whose name and shape match are used as they are,
        gradient buffers included: one storage for both executors. An
        argument whose variable is declared int8 (the offline-quantized
        weights of `contrib.quantization.quantize_graph`) is allocated in
        int8, every other array in float32."""
        from .. import context as ctx_mod
        from ..executor import Executor
        from ..ndarray import zeros

        ctx = ctx_mod.resolve_device(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()

        shared, shared_grad = {}, {}
        if shared_exec is not None:
            shared = dict(shared_exec.arg_dict)
            shared_grad = {k: g for k, g in shared_exec.grad_dict.items()
                           if g is not None}
        if shared_buffer is not None:
            shared.update(shared_buffer)

        int8 = {n.name for n in self._topo() if n.is_var
                and n._dtype is not None and _np.dtype(n._dtype) == _np.int8}

        def take(pool, n, s, dtype="float32"):
            """pool[n] where its shape is s, else a new zero array."""
            a = pool.get(n)
            if a is not None and tuple(a.shape) == tuple(s):
                return a
            return zeros(s, ctx=ctx, dtype=dtype)

        args = []
        for n, s in zip(arg_names, arg_shapes):
            a = take(shared, n, s, "int8" if n in int8 else "float32")
            if shared_buffer is not None:
                shared_buffer.setdefault(n, a)
            args.append(a)
        req = grad_req if isinstance(grad_req, (str, dict)) else "write"
        args_grad = {}
        for n, s in zip(arg_names, arg_shapes):
            r = req if isinstance(req, str) else req.get(n, "write")
            if r != "null":
                args_grad[n] = take(shared_grad, n, s)
        shared_aux = shared_exec.aux_dict if shared_exec is not None else {}
        aux_states = [take(shared_aux, n, s)
                      for n, s in zip(aux_names, aux_shapes)]
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """reference: graph_executor.cc:1726 Bind."""
        from ..executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    # -- gradient ----------------------------------------------------------
    def gradient(self, wrt):
        raise MXNetError("symbolic gradient graphs are not materialized; "
                         "Executor.backward computes gradients with "
                         "torch.autograd")

    # -- serialization -----------------------------------------------------
    def tojson(self):
        """nnvm-style JSON (reference: symbol.py tojson; legacy_json_util.cc)."""
        nodes = self._topo()
        node_ids = {id(n): i for i, n in enumerate(nodes)}
        out = {
            "nodes": [
                {
                    "op": n.op or "null",
                    "name": n.name,
                    "attrs": {k: json.dumps(v) if not isinstance(v, str) else v
                              for k, v in n.attrs.items()},
                    "inputs": [[node_ids[id(src)], idx, 0] for src, idx in n.inputs],
                    "aux_slots": list(n.aux_slots),
                }
                for n in nodes
            ],
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_var],
            "heads": [[node_ids[id(node)], idx, 0] for node, idx in self._outputs],
            "mxnet_tpu_version": 1,
        }
        return json.dumps(out, indent=2)

    def save(self, fname):
        """Write `tojson` to ``fname`` atomically (temp + fsync + rename)."""
        from ..base import atomic_writer

        with atomic_writer(fname, "w") as f:
            f.write(self.tojson())

    # debugging
    def debug_str(self):
        lines = []
        for n in self._topo():
            if n.is_var:
                lines.append("Variable:%s" % n.name)
            else:
                ins = ", ".join("%s[%d]" % (s.name, i) for s, i in n.inputs)
                lines.append("Op:%s, Name=%s, Inputs=[%s]" % (n.op, n.name, ins))
        return "\n".join(lines)


def _rng_for(tensors, device=None):
    """This thread's generator for the device of ``tensors``' first, else
    of ``device`` (a fresh CPU generator for meta tensors: shape inference
    draws nothing it keeps)."""
    from .. import random as _random

    dev = tensors[0].device if tensors else torch.device(device or "cpu")
    return torch.Generator() if dev.type == "meta" \
        else _random.generator(dev)


def _wrap_attr_keys(attr):
    """User/scope attributes are stored `__key__`-wrapped so they can never
    collide with op parameters (reference keeps user attrs in the same nnvm
    dict under the raw key; op attrs feed the op functions as kwargs, hence the
    namespacing)."""
    return {(k if (k.startswith("__") and k.endswith("__")) else "__%s__" % k): v
            for k, v in attr.items()}


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """Create a variable symbol (reference: symbol.py var/Variable); merges
    the active AttrScope's attributes (reference: attribute.py:49)."""
    from .. import attribute

    node = _Node(None, name)
    node._shape = tuple(shape) if shape is not None else None
    node._dtype = dtype
    attr = attribute.current().get(attr)
    if attr:
        node.attrs.update(_wrap_attr_keys(attr))
    if lr_mult is not None:
        node.attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        node.attrs["__wd_mult__"] = wd_mult
    if init is not None:
        node.attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    node.attrs.update(kwargs)
    return Symbol([(node, 0)])


Variable = var


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    for nd_ in data["nodes"]:
        op = None if nd_["op"] == "null" else nd_["op"]
        attrs = {}
        for k, v in nd_.get("attrs", {}).items():
            try:
                attrs[k] = json.loads(v)
            except (json.JSONDecodeError, TypeError):
                attrs[k] = v
        node = _Node(op, nd_["name"], attrs,
                     [(nodes[i], oi) for i, oi, _ in nd_.get("inputs", [])],
                     tuple(nd_.get("aux_slots", [])))
        nodes.append(node)
    return Symbol([(nodes[i], oi) for i, oi, _ in data["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# a few free functions the reference exposes at mxnet.symbol level
def pow(base, exp):
    return base ** exp


def maximum(lhs, rhs):
    from . import _functions

    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return _functions["broadcast_maximum"](lhs, rhs)
    s, other = (lhs, rhs) if isinstance(lhs, Symbol) else (rhs, lhs)
    return _functions["_maximum_scalar"](s, scalar=float(other))


def minimum(lhs, rhs):
    from . import _functions

    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return _functions["broadcast_minimum"](lhs, rhs)
    s, other = (lhs, rhs) if isinstance(lhs, Symbol) else (rhs, lhs)
    return _functions["_minimum_scalar"](s, scalar=float(other))


def ones_like(data):
    from . import _functions

    return _functions["ones_like"](data)


def zeros_like(data):
    from . import _functions

    return _functions["zeros_like"](data)
