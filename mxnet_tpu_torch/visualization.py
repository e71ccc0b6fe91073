"""Network visualization, ``mx.viz`` (counterpart of
`mxnet_tpu/visualization.py`; reference: python/mxnet/visualization.py):
`print_summary`, the layer table with output shapes and parameter counts
(reference :38), printing the JAX package's text; and `plot_network`, a
graphviz digraph (reference :204), which raises `ImportError` without the
`graphviz` package, checked at the call as the reference does.
"""
from __future__ import annotations

from .symbol.symbol import Symbol

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """Print a layer-by-layer summary table; ``shape`` (input name ->
    shape) adds the output shapes and parameter counts (reference:
    visualization.py:38)."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    show_shape = False
    shape_dict = {}
    arg_shapes = {}
    if shape is not None:
        show_shape = True
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        shape_dict = dict(zip(internals.list_outputs(), out_shapes))
        in_shapes, _, aux_sh = symbol.infer_shape(**shape)
        arg_shapes = dict(zip(symbol.list_arguments(), in_shapes))
        arg_shapes.update(zip(symbol.list_auxiliary_states(), aux_sh))
        arg_shapes = {k: v for k, v in arg_shapes.items() if k not in shape}

    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(f, pos):
        line = ""
        for i, field in enumerate(f):
            line += str(field)
            line = line[: pos[i]]
            line += " " * (pos[i] - len(line))
        print(line)  # allow-print

    print("_" * line_length)  # allow-print
    print_row(fields, positions)
    print("=" * line_length)  # allow-print
    total_params = 0

    def out_shape_of(name):
        for suffix in ("_output", ""):
            if name + suffix in shape_dict:
                return shape_dict[name + suffix]
        return None

    for node in symbol._topo():
        if node.is_var:
            continue
        pre = [s.name for s, _ in node.inputs if not s.is_var]
        cur_param = 0
        if show_shape:
            for src, _ in node.inputs:
                dims = arg_shapes.get(src.name) if src.is_var else None
                if dims:
                    n = 1
                    for d in dims:
                        n *= int(d)
                    cur_param += n
        total_params += cur_param
        out_shape = out_shape_of(node.name) if show_shape else None
        print_row(["%s (%s)" % (node.name, node.op), str(out_shape or ""),
                   str(cur_param), pre[0] if pre else ""], positions)
        for p in pre[1:]:
            print_row(["", "", "", p], positions)
        print("_" * line_length)  # allow-print
    print("Total params: %d" % total_params)  # allow-print
    print("_" * line_length)  # allow-print


_FILLS = (
    (("Convolution", "Deconvolution", "FullyConnected"), "#fb8072"),
    (("BatchNorm", "LayerNorm"), "#bebada"),
    (("Activation", "LeakyReLU", "relu", "sigmoid", "tanh"), "#ffffb3"),
    (("Pooling",), "#80b1d3"),
    (("Concat", "Flatten", "Reshape"), "#fdb462"),
    (("Softmax", "SoftmaxOutput", "softmax"), "#fccde5"),
)
_WEIGHT_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta", "_moving_mean",
                    "_moving_var", "_running_mean", "_running_var")


def _fill(op):
    """The node's colour by op family (the reference's scheme)."""
    if op is None:
        return "#8dd3c7"
    for ops, color in _FILLS:
        if op in ops:
            return color
    return "#b3de69"


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 dtype=None, node_attrs=None, hide_weights=True):
    """A graphviz `Digraph` of the network, weights hidden by default
    (reference: visualization.py:204). Needs the `graphviz` package, like
    the reference."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("plot_network requires the graphviz python package")
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs or {})
    dot = Digraph(name=title, format=save_format)
    drawn = set()
    for node in symbol._topo():
        if node.is_var and hide_weights and \
                node.name.endswith(_WEIGHT_SUFFIXES):
            continue
        label = node.name if node.is_var else "%s\n%s" % (node.op, node.name)
        dot.node(name=node.name, label=label,
                 **dict(node_attr, fillcolor=_fill(node.op)))
        drawn.add(node.name)
    for node in symbol._topo():
        if node.name not in drawn:
            continue
        for src, _ in node.inputs:
            if src.name in drawn:
                dot.edge(tail_name=src.name, head_name=node.name)
    return dot
