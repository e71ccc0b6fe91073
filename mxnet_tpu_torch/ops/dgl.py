"""DGL graph ops (counterpart of `mxnet_tpu/ops/dgl.py`; reference:
src/operator/contrib/dgl_graph.cc).

Graph-sampling preprocessing for DGL-style GNN training over csr arrays:
neighbor sampling (uniform and weighted), vertex-induced subgraphs,
subgraph compaction, edge-id lookup and adjacency. They are host ops, as
in the reference (CPU-only there, dgl_graph.cc:800, :1172) and the JAX
package: numpy over the components of a `CSRNDArray`, their results made
on the inputs' device. The samplers draw from a numpy ``Generator`` seeded
by one draw of the op's torch generator (``mx.random.seed``-reproducible);
their streams cannot match the JAX package's threefry keys, so their
samples are held to it by invariants (ROADMAP's RNG contract), and
`_neighbor_sample` itself, given the same numpy generator, to the JAX
package's exactly.

Layouts (the reference's docstrings):
- sampled vertex arrays are (max_num_vertices + 1,) int64, sorted ids
  packed at the front, the last element the count;
- sampled subgraphs are (max_num_vertices, max_num_vertices) csr: row i
  the sampled out-edges of the i-th sampled vertex, columns original
  vertex ids, values the parent's edge values;
- layer arrays give the hop at which each vertex entered the sample.
"""
from __future__ import annotations

import numpy as _np
import torch

from . import register

__all__ = []


def _np_csr(csr):
    return (csr.data.asnumpy(),
            csr.indices.asnumpy().astype(_np.int64),
            csr.indptr.asnumpy().astype(_np.int64),
            tuple(csr.shape))


def _mk_csr(data, indptr, indices, shape, like, dtype=None):
    from ..ndarray import sparse

    return sparse.csr_matrix(
        (data, indices, indptr), shape=shape, ctx=like.context,
        dtype=dtype if dtype is not None else data.dtype)


def _mk_nd(arr, like):
    from ..ndarray import array

    return array(arr, ctx=like.context, dtype=arr.dtype)


def _host_rng(generator):
    """A numpy Generator seeded by one draw of the op's torch generator."""
    seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device)
    return _np.random.default_rng(int(seed.item()))


def _neighbor_sample(rs, data, indices, indptr, seeds, prob, num_hops,
                     num_neighbor, max_num_vertices):
    """BFS from ``seeds``; each expanded vertex keeps ``num_neighbor``
    sampled out-edges. Returns (sorted vertex ids, {vid: hop},
    {vid: [(col, value)]})."""
    layer = {}
    for v in seeds:
        v = int(v)
        if len(layer) >= max_num_vertices:
            break
        layer.setdefault(v, 0)
    frontier = list(layer)
    edges = {}
    for hop in range(1, num_hops + 1):
        nxt = []
        for v in frontier:
            row = indices[indptr[v]:indptr[v + 1]]
            vals = data[indptr[v]:indptr[v + 1]]
            if row.size == 0:
                continue
            k = min(num_neighbor, row.size)
            if prob is None:
                pick = rs.choice(row.size, size=k, replace=False)
            else:
                p = _np.asarray(prob[row], dtype=_np.float64)
                s = p.sum()
                p = p / s if s > 0 else None
                pick = rs.choice(row.size, size=k, replace=False, p=p)
            chosen = []
            for j in sorted(int(i) for i in pick):
                u = int(row[j])
                if u not in layer and len(layer) >= max_num_vertices:
                    continue  # vertex budget spent: the edge is dropped
                chosen.append((u, vals[j]))
                if u not in layer:
                    layer[u] = hop
                    nxt.append(u)
            edges[v] = chosen
        frontier = nxt
    return sorted(layer), layer, edges


def _csr_rows(rows, cols, vals, n_rows, dtype):
    """(vals, indptr, cols) of the edges sorted by (row, col)."""
    order = _np.lexsort((cols, rows)) if rows else _np.array([], _np.int64)
    rows = _np.asarray(rows, _np.int64)[order]
    cols = _np.asarray(cols, _np.int64)[order]
    vals = _np.asarray(vals, dtype)[order]
    indptr = _np.zeros(n_rows + 1, _np.int64)
    _np.add.at(indptr[1:], rows, 1)
    return vals, _np.cumsum(indptr), cols


def _pack_sample(verts, layer, edges, parent_dtype, max_num_vertices,
                 like, prob=None):
    n = len(verts)
    out_verts = _np.zeros(max_num_vertices + 1, _np.int64)
    out_verts[:n] = verts
    out_verts[-1] = n
    pos = {v: i for i, v in enumerate(verts)}
    rows, cols, vals = [], [], []
    for v in verts:
        for (u, val) in edges.get(v, ()):
            rows.append(pos[v])
            cols.append(u)
            vals.append(val)
    vals, indptr, cols = _csr_rows(rows, cols, vals, max_num_vertices,
                                   parent_dtype)
    from ..ndarray.sparse import _check_columns

    _check_columns(cols, (max_num_vertices, max_num_vertices),
                   "a sampled subgraph")
    sub = _mk_csr(vals, indptr, cols,
                  (max_num_vertices, max_num_vertices), like)
    out_layer = _np.full(max_num_vertices, -1, _np.int64)
    out_layer[:n] = [layer[v] for v in verts]
    outs = [_mk_nd(out_verts, like), sub]
    if prob is not None:
        out_prob = _np.zeros(max_num_vertices, _np.float32)
        out_prob[:n] = prob[_np.asarray(verts, _np.int64)]
        outs.append(_mk_nd(out_prob, like))
    outs.append(_mk_nd(out_layer, like))
    return outs


def _sample(generator, csr, prob, seeds, num_hops, num_neighbor,
            max_num_vertices):
    rs = _host_rng(generator)
    data, indices, indptr, _ = _np_csr(csr)
    pv = None if prob is None else \
        prob.asnumpy().astype(_np.float64).ravel()
    outs = [[] for _ in range(3 if prob is None else 4)]
    for seed in seeds:
        sv = seed.asnumpy().astype(_np.int64).ravel()
        verts, layer, edges = _neighbor_sample(
            rs, data, indices, indptr, sv, pv, int(num_hops),
            int(num_neighbor), int(max_num_vertices))
        packed = _pack_sample(verts, layer, edges, data.dtype,
                              int(max_num_vertices), csr, prob=pv)
        for o, p in zip(outs, packed):
            o.append(p)
    return tuple(x for o in outs for x in o)


@register("_contrib_dgl_csr_neighbor_uniform_sample",
          aliases=("dgl_csr_neighbor_uniform_sample",), host=True,
          needs_rng=True, num_outputs=-1,
          num_outputs_fn=lambda attrs: 3 * (int(attrs.get("num_args", 2)) - 1))
def dgl_csr_neighbor_uniform_sample(csr, *seeds, generator=None,
                                    num_args=None, num_hops=1,
                                    num_neighbor=2, max_num_vertices=100):
    """reference: dgl_graph.cc:744 — for each seed array: (vertices,
    sampled csr, layer), grouped by kind."""
    return _sample(generator, csr, None, seeds, num_hops, num_neighbor,
                   max_num_vertices)


@register("_contrib_dgl_csr_neighbor_non_uniform_sample",
          aliases=("dgl_csr_neighbor_non_uniform_sample",), host=True,
          needs_rng=True, num_outputs=-1,
          num_outputs_fn=lambda attrs: 4 * (int(attrs.get("num_args", 3)) - 2))
def dgl_csr_neighbor_non_uniform_sample(csr, prob, *seeds, generator=None,
                                        num_args=None, num_hops=1,
                                        num_neighbor=2,
                                        max_num_vertices=100):
    """reference: dgl_graph.cc:838 — weighted by a vertex probability; adds
    the sampled vertices' probabilities as a third output kind."""
    return _sample(generator, csr, prob, seeds, num_hops, num_neighbor,
                   max_num_vertices)


def _flag(v):
    return v in (True, "True", 1)


def _induced(d, indices, indptr, row_vertices, pos):
    """Edges among ``pos``'s vertices, from each of ``row_vertices``'
    rows: (rows, cols, values) in position space."""
    rows, cols, vals = [], [], []
    for i, v in enumerate(row_vertices):
        for j in range(indptr[v], indptr[v + 1]):
            u = int(indices[j])
            if u in pos:
                rows.append(i)
                cols.append(pos[u])
                vals.append(d[j])
    return rows, cols, vals


@register("_contrib_dgl_subgraph", aliases=("dgl_subgraph",), host=True,
          num_outputs=-1,
          num_outputs_fn=lambda attrs: (
              (int(attrs.get("num_args", 2)) - 1)
              * (2 if _flag(attrs.get("return_mapping")) else 1)))
def dgl_subgraph(graph, *varrays, num_args=None, return_mapping=False):
    """reference: dgl_graph.cc:1115 — the vertex-induced subgraph of each
    vertex array, its edges numbered 1..nnz in row-major order; with
    ``return_mapping`` a second set holds the parent's edge ids."""
    data, indices, indptr, _ = _np_csr(graph)
    new_set, map_set = [], []
    for varr in varrays:
        vids = varr.asnumpy().astype(_np.int64).ravel()
        pos = {int(v): i for i, v in enumerate(vids)}
        n = len(vids)
        olds, indptr_out, cols = _csr_rows(
            *_induced(data, indices, indptr, [int(v) for v in vids], pos),
            n, data.dtype)
        news = _np.arange(1, len(cols) + 1, dtype=data.dtype)
        new_set.append(_mk_csr(news, indptr_out, cols, (n, n), graph))
        map_set.append(_mk_csr(olds, indptr_out, cols, (n, n), graph))
    return tuple(new_set + map_set) if _flag(return_mapping) \
        else tuple(new_set)


@register("_contrib_edge_id", aliases=("edge_id",), host=True)
def edge_id(data, u, v):
    """reference: dgl_graph.cc:1300 — out[i] = csr[u[i], v[i]], or -1 where
    there is no such edge."""
    d, indices, indptr, _ = _np_csr(data)
    uu = u.asnumpy().astype(_np.int64).ravel()
    vv = v.asnumpy().astype(_np.int64).ravel()
    out = _np.full(uu.shape, -1, _np.float32)
    for i, (a, b) in enumerate(zip(uu, vv)):
        hit = _np.nonzero(indices[indptr[a]:indptr[a + 1]] == b)[0]
        if hit.size:
            out[i] = d[indptr[a] + hit[0]]
    return _mk_nd(out, u)


@register("_contrib_dgl_adjacency", aliases=("dgl_adjacency",), host=True)
def dgl_adjacency(data):
    """reference: dgl_graph.cc:1376 — an edge-id csr as the adjacency csr
    of float32 ones."""
    d, indices, indptr, shape = _np_csr(data)
    return _mk_csr(_np.ones(d.shape, _np.float32), indptr, indices, shape,
                   data, dtype=_np.float32)


@register("_contrib_dgl_graph_compact", aliases=("dgl_graph_compact",),
          host=True, num_outputs=-1,
          num_outputs_fn=lambda attrs: (
              (int(attrs.get("num_args", 2)) // 2)
              * (2 if _flag(attrs.get("return_mapping")) else 1)))
def dgl_graph_compact(*args, num_args=None, return_mapping=False,
                      graph_sizes=()):
    """reference: dgl_graph.cc:1551 — drop a sampled subgraph's trailing
    empty rows and map its columns from original vertex ids to positions,
    with the vertex arrays the samplers gave."""
    if isinstance(graph_sizes, (int, float)):
        graph_sizes = (int(graph_sizes),)
    graph_sizes = tuple(int(s) for s in graph_sizes)
    n_graphs = len(args) // 2
    graphs, varrs = args[:n_graphs], args[n_graphs:]
    outs, maps = [], []
    for g, varr, size in zip(graphs, varrs, graph_sizes):
        d, indices, indptr, _ = _np_csr(g)
        verts = varr.asnumpy().astype(_np.int64).ravel()
        pos = {int(v): i for i, v in enumerate(verts[:size])}
        vals, indptr_out, cols = _csr_rows(
            *_induced(d, indices, indptr, range(size), pos), size, d.dtype)
        outs.append(_mk_csr(vals, indptr_out, cols, (size, size), g))
        maps.append(_mk_csr(vals.copy(), indptr_out, cols, (size, size), g))
    return tuple(outs + maps) if _flag(return_mapping) else tuple(outs)
