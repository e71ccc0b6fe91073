"""Subgraph partitioning (counterpart of `mxnet_tpu/subgraph.py`; reference:
src/operator/subgraph/subgraph_property.h:77 SubgraphSelector,
SubgraphProperty + MXNET_REGISTER_SUBGRAPH_PROPERTY; the partitioner of
build_subgraph.cc).

The structural API: a property selects a region of a `Symbol` and
replaces it with one node, whose op a backend may implement as it likes
(a hand-written kernel, a quantized block). The default implementation
registers a fused op that interprets the captured sub-symbol
(`Symbol._interpret`) as one unit, with the default ``is_train=False``,
as the JAX package's does: no op whose mode matters is ever captured
(`_fusable` keeps out random ops and ops with hidden aux outputs, so
BatchNorm and Dropout stay outside), so a fused region computes what its
ops computed, in the same order, in training too.

Partition strategy (the JAX package's): each property seeds at
``select()`` nodes, from the graph's last node backward, and grows
backward through ``select_input()`` edges whose producer has exactly one
consumer and is no graph output (regions stay convex, the conv + bn +
relu chain shape the reference's MKLDNN properties match). Fused ops are
named ``_subgraph_<property>_<n>`` and take the region's external inputs
in their first-encounter order.
"""
from __future__ import annotations

import itertools

from . import ops as _ops
from .base import MXNetError
from .symbol.symbol import Symbol, _Node

__all__ = ["SubgraphSelector", "SubgraphProperty", "register_subgraph_property",
           "partition", "DefaultSubgraphProperty", "list_subgraph_properties"]

_PROPERTIES = {}
_counter = itertools.count()


class SubgraphSelector:
    """Decides which nodes join a subgraph (reference:
    subgraph_property.h:77)."""

    def select(self, node):
        """Start a subgraph at this node?"""
        return False

    def select_input(self, node, input_node):
        """Grow the subgraph from `node` to its producer `input_node`?"""
        return False

    def select_output(self, node, output_node):
        """Grow from `node` to its consumer `output_node`?"""
        return False


class SubgraphProperty:
    """Creates replacement nodes for selected regions (reference:
    subgraph_property.h SubgraphProperty)."""

    def create_subgraph_selector(self):
        return SubgraphSelector()

    def subgraph_op_name(self, subgraph_id):
        return "_subgraph_%s_%d" % (type(self).__name__.lower(), subgraph_id)

    def create_subgraph_node(self, subgraph_sym, input_names, subgraph_id):
        """Register + return the op name implementing this subgraph. Override
        to substitute a custom implementation (a hand-written kernel, an
        int8 block)."""
        op_name = self.subgraph_op_name(subgraph_id)

        def fused(*arrays, **_ignored):
            values = dict(zip(input_names, arrays))
            outs = subgraph_sym._interpret(values)
            return tuple(outs) if len(outs) > 1 else outs[0]

        fused.__doc__ = ("fused subgraph op (%d nodes) created by %s"
                         % (sum(1 for n in subgraph_sym._topo()
                                if not n.is_var), type(self).__name__))
        # shape inference reads the captured ops' rules through this
        fused.subgraph = (subgraph_sym, list(input_names))
        _ops.register(op_name,
                      num_outputs=len(subgraph_sym._outputs))(fused)
        return op_name


def register_subgraph_property(name):
    """reference: MXNET_REGISTER_SUBGRAPH_PROPERTY."""

    def deco(cls):
        _PROPERTIES[name] = cls
        return cls

    return deco


def list_subgraph_properties():
    return sorted(_PROPERTIES)


class DefaultSubgraphProperty(SubgraphProperty):
    """Wraps every op node into one whole-graph subgraph (reference: the
    default property used by build_subgraph.cc tests)."""

    def create_subgraph_selector(self):
        class _All(SubgraphSelector):
            def select(self, node):
                return True

            def select_input(self, node, input_node):
                return True

        return _All()


register_subgraph_property("default")(DefaultSubgraphProperty)


def _fusable(node):
    """Ops with hidden aux outputs (BatchNorm moving stats) or per-call RNG
    (Dropout) cannot be captured — their side effects would be silently
    dropped by the fused interpreter (the reference's selectors skip
    stateful ops the same way)."""
    opdef = _ops.get(node.op)
    if opdef.needs_rng:
        return False
    return opdef.visible_outputs == max(1, opdef.num_outputs)


def _find_groups(sym, prop):
    """Greedy convex grouping; returns list of sets of node ids."""
    consumers = {}
    nodes = list(sym._topo())
    for n in nodes:
        for src, _ in n.inputs:
            consumers.setdefault(id(src), []).append(n)
    out_ids = {id(n) for n, _ in sym._outputs}

    assigned = set()
    groups = []
    for node in reversed(nodes):  # grow from late nodes backward
        if node.is_var or id(node) in assigned:
            continue
        selector = prop.create_subgraph_selector()
        if not _fusable(node) or not selector.select(node):
            continue
        group = {id(node)}
        frontier = [node]
        while frontier:
            cur = frontier.pop()
            for src, _ in cur.inputs:
                if src.is_var or id(src) in assigned or id(src) in group \
                        or not _fusable(src):
                    continue
                # convexity: producer must feed only into the group, and not
                # be a graph output itself
                cons = consumers.get(id(src), [])
                if id(src) in out_ids or \
                        not all(id(c) in group for c in cons):
                    continue
                if selector.select_input(cur, src):
                    group.add(id(src))
                    frontier.append(src)
        assigned |= group
        groups.append(group)
    return groups


def partition(sym, prop="default"):
    """Replace matched regions with fused subgraph nodes, returning the new
    Symbol (reference: build_subgraph.cc partitioner; Python surface
    build_subgraph/optimize_for)."""
    if isinstance(prop, str):
        if prop not in _PROPERTIES:
            raise MXNetError("unknown subgraph property '%s' (known: %s)"
                             % (prop, list_subgraph_properties()))
        prop = _PROPERTIES[prop]()
    groups = _find_groups(sym, prop)
    if not groups:
        return sym
    group_of = {}
    for gi, g in enumerate(groups):
        for nid in g:
            group_of[nid] = gi

    nodes = list(sym._topo())
    mapping = {}          # old node id -> (new_node, base_out_idx_offset fn)
    fused_nodes = {}      # group idx -> (fused _Node, {(old_nid, idx): out_idx})

    def new_edge(src, idx):
        nid = id(src)
        if nid in group_of and nid in fused_mapped:
            fnode, out_map = fused_nodes[group_of[nid]]
            return (fnode, out_map[(nid, idx)])
        return (mapping[nid], idx)

    fused_mapped = set()
    for gi, g in enumerate(groups):
        members = [n for n in nodes if id(n) in g]
        member_ids = set(g)
        # external edges -> subgraph var inputs
        ext_inputs = []   # [(src_node, idx)]
        sub_clone = {}

        def sub_edge(src, idx):
            if id(src) in member_ids:
                return (sub_clone[id(src)], idx)
            key = (id(src), idx)
            for i, k in enumerate(ext_inputs):
                if k == key:
                    return (sub_vars[i], 0)
            ext_inputs.append(key)
            v = _Node(None, "sub_in%d" % (len(ext_inputs) - 1))
            sub_vars.append(v)
            return (v, 0)

        sub_vars = []
        for n in members:
            clone = _Node(n.op, n.name, dict(n.attrs), [], n.aux_slots)
            sub_clone[id(n)] = clone
        for n in members:
            for src, idx in n.inputs:
                sub_clone[id(n)].inputs.append(sub_edge(src, idx))
        # region outputs: member outputs consumed outside the group (or graph outputs)
        out_edges = []
        consumed_outside = set()
        for n in nodes:
            if id(n) in member_ids:
                continue
            for src, idx in n.inputs:
                if id(src) in member_ids:
                    consumed_outside.add((id(src), idx))
        for n, idx in sym._outputs:
            if id(n) in member_ids:
                consumed_outside.add((id(n), idx))
        for n in members:
            for idx in range(max(1, n.visible_outputs())):
                if (id(n), idx) in consumed_outside:
                    out_edges.append((id(n), idx))
        sub_sym = Symbol([(sub_clone[nid], idx) for nid, idx in out_edges])
        input_names = ["sub_in%d" % i for i in range(len(ext_inputs))]
        op_name = prop.create_subgraph_node(sub_sym, input_names,
                                            next(_counter))
        fused = _Node(op_name, op_name, {}, [])
        out_map = {edge: i for i, edge in enumerate(out_edges)}
        fused_nodes[gi] = (fused, out_map)

    # rebuild the full graph (topo order: producers are mapped before use).
    # A group is wired at its LAST member's topo position — only then are
    # all its external producers guaranteed to be mapped (a group member
    # late in the graph may consume vars that appear after the first member)
    remaining = {gi: len(g) for gi, g in enumerate(groups)}
    for node in nodes:
        nid = id(node)
        if node.is_var:
            nv = _Node(None, node.name, dict(node.attrs))
            nv._shape, nv._dtype = node._shape, node._dtype
            mapping[nid] = nv
            continue
        if nid in group_of:
            gi = group_of[nid]
            remaining[gi] -= 1
            if remaining[gi] == 0:
                # wire the fused node's inputs in the SAME first-encounter
                # order the sub-Symbol's sub_in%d vars were created in
                fused, _ = fused_nodes[gi]
                g = groups[gi]
                members = [n for n in nodes if id(n) in g]
                member_ids = set(g)
                seen = []
                for n in members:
                    for src, idx in n.inputs:
                        if id(src) not in member_ids and \
                                (id(src), idx) not in seen:
                            seen.append((id(src), idx))
                            fused.inputs.append(new_edge(src, idx))
                fused_mapped |= member_ids
            continue
        mapping[nid] = _Node(node.op, node.name, dict(node.attrs),
                             [new_edge(s, i) for s, i in node.inputs],
                             node.aux_slots)

    outs = []
    for n, idx in sym._outputs:
        outs.append(new_edge(n, idx))
    return Symbol(outs)
