"""Symbol op-function codegen and argument-shape rules (counterpart of
`mxnet_tpu/symbol/register.py`; reference mechanism:
python/mxnet/symbol/register.py).

One function a registered op, composing a graph node instead of running
the op. A weight, bias or aux state left out is created as a variable
named ``<node>_<slot>`` (``fc1_weight``, ``bn0_moving_mean``), as the
reference's nnvm composition does, from the per-op input-slot table below.
"""
from __future__ import annotations

import inspect

import torch

from .. import ops as _ops
from ..base import MXNetError
from .symbol import Symbol, _Node, var

# op -> ordered array-input slot names, then the aux-state slots (BatchNorm
# moving statistics: the targets of its hidden outputs)
_INPUT_SLOTS = {
    "FullyConnected": (["data", "weight", "bias"], []),
    "Convolution": (["data", "weight", "bias"], []),
    "Deconvolution": (["data", "weight", "bias"], []),
    "BatchNorm": (["data", "gamma", "beta"], ["moving_mean", "moving_var"]),
    "BatchNormRelu": (["data", "gamma", "beta"],
                      ["moving_mean", "moving_var"]),
    "BatchNormAddRelu": (["data", "addend", "gamma", "beta"],
                         ["moving_mean", "moving_var"]),
    "LayerNorm": (["data", "gamma", "beta"], []),
    "InstanceNorm": (["data", "gamma", "beta"], []),
    "Embedding": (["data", "weight"], []),
    "LeakyReLU": (["data", "gamma"], []),
    "RNN": (["data", "parameters", "state", "state_cell"], []),
    "SoftmaxOutput": (["data", "label"], []),
    "LinearRegressionOutput": (["data", "label"], []),
    "LogisticRegressionOutput": (["data", "label"], []),
    "MAERegressionOutput": (["data", "label"], []),
    # quantized compute ops (quantize_graph output): weight/bias vars sit
    # behind _contrib_quantize_v2 nodes; min/max slots carry no var shapes
    "_contrib_quantized_conv": (
        ["data", "weight", "bias", "min_data", "max_data", "min_weight",
         "max_weight"], []),
    "_contrib_quantized_fully_connected": (
        ["data", "weight", "bias", "min_data", "max_data", "min_weight",
         "max_weight"], []),
}

# single-input ops whose output shape is their input's: shape assignment
# walks through them from a rule op to the variable behind them (quantized
# graphs put _contrib_quantize_v2 between a variable and its conv / FC)
_SHAPE_TRANSPARENT = {
    "_contrib_quantize_v2", "quantize_v2", "_contrib_quantize", "quantize",
    "Cast", "cast", "BlockGrad", "identity", "_copy"}

# ops whose optional trailing array inputs are dropped by a flag
_OPTIONAL_DROP = {
    "FullyConnected": ("no_bias", ["bias"]),
    "Convolution": ("no_bias", ["bias"]),
    "Deconvolution": ("no_bias", ["bias"]),
}

# op parameters the caller of an op fills, never a symbol attribute
_CALLER_PARAMS = ("is_train", "generator")


def _slot_names(opname, attrs):
    entry = _INPUT_SLOTS.get(opname)
    if entry is None:
        return None, ()
    slots, aux = entry
    drop = _OPTIONAL_DROP.get(opname)
    if drop is not None:
        flag, names = drop
        if attrs.get(flag):
            slots = [s for s in slots if s not in names]
    if opname == "LeakyReLU" and attrs.get("act_type", "leaky") != "prelu":
        slots = ["data"]
    if opname == "RNN" and str(attrs.get("mode", "lstm")) != "lstm":
        slots = [s for s in slots if s != "state_cell"]
    return list(slots), tuple(aux)


def _make_symbol_function(opdef):
    fn = opdef.fn
    try:
        params = [p for p in inspect.signature(fn).parameters.values()
                  if p.name not in _CALLER_PARAMS]
    except (TypeError, ValueError):
        params = []
    var_pos = any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params)
    pos_names = [p.name for p in params
                 if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                               inspect.Parameter.POSITIONAL_OR_KEYWORD)]

    def generated(*args, name=None, attr=None, **kwargs):
        inputs = []          # [(slot_name_or_None, Symbol)]
        attrs = {}
        if var_pos:
            for a in args:
                if not isinstance(a, Symbol):
                    raise TypeError("%s: positional args must be Symbol"
                                    % opdef.name)
                inputs.append((None, a))
            kwargs.pop("num_args", None)
            for k, v in kwargs.items():
                if isinstance(v, Symbol):
                    inputs.append((k, v))
                else:
                    attrs[k] = v
        else:
            consumed = set()
            for i, a in enumerate(args):
                pname = pos_names[i] if i < len(pos_names) else None
                if isinstance(a, Symbol):
                    inputs.append((pname, a))
                    consumed.add(pname)
                elif pname is not None:
                    attrs[pname] = a
                    consumed.add(pname)
            for pname in pos_names:
                if pname in consumed or pname not in kwargs:
                    continue
                if isinstance(kwargs[pname], Symbol):
                    inputs.append((pname, kwargs.pop(pname)))
            attrs.update({k: v for k, v in kwargs.items()
                          if not isinstance(v, Symbol)})
        attrs = {k: v for k, v in attrs.items()
                 if v is not None and k not in _CALLER_PARAMS}

        from .. import name as _name_mod

        node_name = _name_mod.current().get(name,
                                            opdef.name.lstrip("_").lower())
        slots, aux_names = _slot_names(opdef.name, attrs)
        if slots is None:
            # no table entry: inputs are the Symbols passed. When they bind
            # to non-leading parameters (an optional array slot skipped),
            # the parameter names are recorded (a dunder attr, not an op
            # param) so execution binds by keyword
            if inputs and all(nm is not None for nm, _ in inputs):
                pn_order = [nm for nm, _ in inputs]
                if pn_order != pos_names[:len(pn_order)]:
                    attrs["__input_names__"] = tuple(pn_order)
            edges = [s._outputs[0] for _, s in inputs]
            aux_slots = ()
            n_hidden = (opdef.num_outputs - opdef.visible_outputs
                        if opdef.num_outputs > 0 else 0)
            if n_hidden > 0:
                aux_slots = tuple(range(len(edges) - n_hidden, len(edges)))
        else:
            by_slot = {}
            unnamed = [s for nm, s in inputs if nm is None]
            for nm, s in inputs:
                if nm is not None:
                    by_slot[nm] = s
            edges = []
            full = slots + list(aux_names)
            for slot in full:
                if slot in by_slot:
                    edges.append(by_slot[slot]._outputs[0])
                elif unnamed:
                    edges.append(unnamed.pop(0)._outputs[0])
                else:
                    # auto-create the variable (reference nnvm behaviour)
                    edges.append(var("%s_%s" % (node_name, slot))._outputs[0])
            aux_slots = tuple(range(len(slots), len(full)))
        from .. import attribute as _attribute
        from .symbol import _wrap_attr_keys

        attr = _attribute.current().get(attr)
        if attr:
            attrs = dict(attrs, **_wrap_attr_keys(attr))
        node = _Node(opdef.name, node_name, attrs, edges, aux_slots)
        if opdef.num_outputs > 0:
            nvis = opdef.visible_outputs
        elif opdef.num_outputs_fn is not None:
            nvis = opdef.num_outputs_fn(attrs)
        else:
            nvis = 1
        return Symbol([(node, i) for i in range(max(1, nvis))])

    generated.__name__ = opdef.name
    sig_str = "(%s)" % ", ".join(
        [str(p) for p in params] + ["name=None", "attr=None"]) \
        if params else "(...)"
    generated.__doc__ = "%s%s\n\n%s\n(symbol function auto-generated " \
        "from op '%s')" % (opdef.name, sig_str,
                           (opdef.fn.__doc__ or "").strip(), opdef.name)
    return generated


class _OpNamespace(object):
    pass


def populate(target_module_dict):
    """Install a symbol function for every registered op at the top of
    ``mx.sym`` (but ``_contrib_*`` and ``_linalg_*``) and in ``mx.sym.op``,
    and the prefixed ones in their namespace, as ``mx.nd`` does
    (``mx.sym.contrib``, ``linalg``, ``random``, ``image``); returns them by
    op name."""
    from ..ndarray.register import _NAMESPACES

    spaces = {ns: _OpNamespace() for _, ns, _ in _NAMESPACES}
    op_ns = _OpNamespace()
    functions = {}
    for name in _ops.list_ops():
        f = _make_symbol_function(_ops.get(name))
        functions[name] = f
        for prefix, ns, renamed in _NAMESPACES:
            if name.startswith(prefix):
                setattr(spaces[ns], renamed + name[len(prefix):], f)
        if not name.startswith(("_contrib_", "_linalg_")):
            target_module_dict.setdefault(name, f)
        if name.isidentifier():
            setattr(op_ns, name, f)  # flat mx.sym.op.* (reference op.py)
    for ns, space in spaces.items():
        target_module_dict[ns] = space
    target_module_dict.setdefault("op", op_ns)
    return functions


# --------------------------------------------------------------------------
# arg-shape rules: unknown variable shapes from op attrs + the data shape
# (the forward half of the reference's InferShape pass,
# src/executor/infer_graph_attr_pass.cc)
# --------------------------------------------------------------------------

def _prod(xs):
    r = 1
    for x in xs:
        r *= x
    return r


def _fc_rule(attrs, in_shapes):
    data = in_shapes[0]
    nh = int(attrs.get("num_hidden", 0))
    in_dim = _prod(data[1:]) if attrs.get("flatten", True) else data[-1]
    return {"weight": (nh, in_dim), "bias": (nh,)}


def _conv_geometry(attrs, in_shapes):
    data = in_shapes[0]
    from ..ops.nn import _channels_last

    ch_last = _channels_last(attrs.get("layout"))
    return (data[-1] if ch_last else data[1], ch_last,
            int(attrs.get("num_filter", 0)),
            tuple(int(k) for k in attrs.get("kernel", ())),
            int(attrs.get("num_group", 1)))


def _conv_rule(attrs, in_shapes):
    """Weight (O, I/g, *k), or (O, *k, I/g) under a channels-last layout
    (the JAX package's rule reads the channels at axis 1 in either)."""
    c, ch_last, nf, kernel, ng = _conv_geometry(attrs, in_shapes)
    w = (nf,) + kernel + (c // ng,) if ch_last else (nf, c // ng) + kernel
    return {"weight": w, "bias": (nf,)}


def _deconv_rule(attrs, in_shapes):
    """Weight (I, O/g, *k), or (I, *k, O/g) under a channels-last layout."""
    c, ch_last, nf, kernel, ng = _conv_geometry(attrs, in_shapes)
    w = (c,) + kernel + (nf // ng,) if ch_last else (c, nf // ng) + kernel
    return {"weight": w, "bias": (nf,)}


def _bn_rule(attrs, in_shapes):
    c = in_shapes[0][int(attrs.get("axis", 1)) % len(in_shapes[0])]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


def _ln_rule(attrs, in_shapes):
    c = in_shapes[0][int(attrs.get("axis", -1)) % len(in_shapes[0])]
    return {"gamma": (c,), "beta": (c,)}


def _in_rule(attrs, in_shapes):
    return {"gamma": (in_shapes[0][1],), "beta": (in_shapes[0][1],)}


def _prelu_rule(attrs, in_shapes):
    if attrs.get("act_type") == "prelu":
        return {"gamma": (in_shapes[0][1],)}
    return {}


def _embed_rule(attrs, in_shapes):
    return {"weight": (int(attrs["input_dim"]), int(attrs["output_dim"]))}


def _rnn_rule(attrs, in_shapes):
    # data (T, N, C); parameters: the flat fused vector (ops/rnn.py layout)
    from ..ops.rnn import rnn_param_size

    data = in_shapes[0]
    sh = int(attrs["state_size"])
    nl = int(attrs.get("num_layers", 1))
    bi = bool(attrs.get("bidirectional", False))
    mode = str(attrs.get("mode", "lstm"))
    d = 2 if bi else 1
    out = {"parameters": (rnn_param_size(nl, data[2], sh, bi, mode),),
           "state": (nl * d, data[1], sh)}
    if mode == "lstm":
        out["state_cell"] = (nl * d, data[1], sh)
    return out


_ARG_SHAPE_RULES = {
    "FullyConnected": _fc_rule,
    "Convolution": _conv_rule,
    "Deconvolution": _deconv_rule,
    "BatchNorm": _bn_rule,
    "BatchNormRelu": _bn_rule,
    "BatchNormAddRelu": _bn_rule,
    "LayerNorm": _ln_rule,
    "InstanceNorm": _in_rule,
    "Embedding": _embed_rule,
    "LeakyReLU": _prelu_rule,
    "RNN": _rnn_rule,
    # quantized kernels keep the fp32 op's weight geometry (the int8 conv
    # consumes the same OIHW weight the fp32 conv would)
    "_contrib_quantized_conv": _conv_rule,
    "_contrib_quantized_fully_connected": _fc_rule,
}


def meta_eval(fn, shapes):
    """``fn({name: meta float32 tensor of shapes[name]})`` under no_grad:
    shapes only, nothing computed or launched."""
    with torch.no_grad():
        return fn({n: torch.empty(s, dtype=torch.float32, device="meta")
                   for n, s in shapes.items()})


def infer_var_shapes(sym, known):
    """Walk the graph forward, filling variable shapes: known shapes
    propagate through each op run on meta tensors; parameter variables of
    table ops take their shapes from the op's rule."""
    shapes = dict(known)
    out_shapes = {}   # id(node) -> tuple of output shapes

    def resolve_var(src):
        """Walk through shape-preserving ops to the variable behind them."""
        seen = 0
        while not src.is_var and src.op in _SHAPE_TRANSPARENT \
                and src.inputs and seen < 16:
            src = src.inputs[0][0]
            seen += 1
        return src if src.is_var else None

    # to a fixpoint: a rule can assign a variable whose consuming node
    # precedes the rule op in topological order
    topo = list(sym._topo())
    for _pass in range(max(2, len(topo))):
        progressed = False
        for node in topo:
            if node.is_var:
                if node.name not in shapes and node._shape is not None and \
                        not any(s == 0 for s in node._shape):
                    shapes[node.name] = tuple(node._shape)
                if node.name in shapes and id(node) not in out_shapes:
                    out_shapes[id(node)] = (shapes[node.name],)
                    progressed = True
                continue
            sub = getattr(_ops.get(node.op).fn, "subgraph", None)
            if sub is not None and id(node) not in out_shapes:
                # a fused node (`subgraph.partition`): its captured ops'
                # rules give the shapes of the variables it takes
                sub_sym, sub_names = sub
                sub_known = {n: out_shapes[id(src)][idx]
                             for n, (src, idx) in zip(sub_names, node.inputs)
                             if id(src) in out_shapes}
                try:
                    inner = infer_var_shapes(sub_sym, sub_known)
                except Exception:  # noqa: BLE001 - shapes not known yet
                    inner = {}
                for n, (src, _) in zip(sub_names, node.inputs):
                    v = src if src.is_var else resolve_var(src)
                    if n in inner and v is not None and v.name not in shapes:
                        shapes[v.name] = tuple(inner[n])
                        out_shapes[id(v)] = (shapes[v.name],)
                        progressed = True
            rule = _ARG_SHAPE_RULES.get(node.op)
            if rule is not None:
                first_src, first_idx = node.inputs[0]
                if id(first_src) in out_shapes:
                    data_shape = out_shapes[id(first_src)][first_idx]
                    try:
                        slot_shapes = rule(node.attrs, [data_shape])
                    except (KeyError, MXNetError):
                        slot_shapes = {}
                    slots, aux = _slot_names(node.op, node.attrs)
                    full = (slots or []) + list(aux)
                    for slot, (src, _) in zip(full, node.inputs):
                        if slot not in slot_shapes:
                            continue
                        v = src if src.is_var else resolve_var(src)
                        if v is not None and v.name not in shapes:
                            shapes[v.name] = tuple(slot_shapes[slot])
                            out_shapes[id(v)] = (shapes[v.name],)
                            progressed = True
            if id(node) in out_shapes:
                continue
            ready = all(id(src) in out_shapes
                        and len(out_shapes[id(src)]) > idx
                        for src, idx in node.inputs)
            if not ready:
                continue
            # the node alone, each input a variable of its known shape
            feed = {"__in%d__" % k: out_shapes[id(src)][idx]
                    for k, (src, idx) in enumerate(node.inputs)}
            proxy = _Node(node.op, node.name, node.attrs,
                          [(_Node(None, n), 0) for n in feed],
                          node.aux_slots)
            one = Symbol([(proxy, i) for i in range(node.num_outputs())])
            try:
                res = meta_eval(lambda vals: one._interpret(
                    vals, is_train=True, generator=torch.Generator()), feed)
            except Exception:
                continue
            out_shapes[id(node)] = tuple(tuple(r.shape) for r in res)
            progressed = True
        if not progressed:
            break
    return shapes
