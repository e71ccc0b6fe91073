"""The DGL graph ops of `mxnet_tpu_torch.ops.dgl` against the JAX package's,
on the CPU.

Each case of the JAX package's ``tests/test_dgl.py`` runs through both
packages' ``nd.contrib`` on the same graphs. The deterministic ops
(``edge_id``, ``dgl_adjacency``, ``dgl_subgraph``, ``dgl_graph_compact``,
and the samplers where ``num_neighbor`` covers every degree) must give
the JAX package's outputs exactly, dtypes included (an int64 output stays
int64 where the JAX package narrows it to int32). The samplers' streams
differ (the port seeds numpy from its torch generator, the JAX package
from its threefry key), so their random cases are held by invariants:
every sampled edge is in the graph with the graph's value, at most
``num_neighbor`` edges a vertex, ``max_num_vertices`` holds, seeds at hop
0, and the same ``mx.random.seed`` gives the same sample. The sampling
itself, both packages' ``_neighbor_sample`` given the same
``np.random.default_rng(s)``, is compared exactly.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import dgl as jdgl
from mxnet_tpu_torch.ops import dgl as tdgl
from mxnet_tpu_torch.base import MXNetError

PKGS = (jmx, mx)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _np(a):
    return np.asarray(a.asnumpy())


def _same(got, want):
    got, want = _np(got), _np(want)
    # an int64 array stays int64 in the port, where the JAX package
    # narrows it to int32 (README, "int64")
    assert got.dtype == want.dtype or (got.dtype == np.int64
                                       and want.dtype == np.int32), \
        (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _k5(pkg):
    """The reference docstring graph: the complete K5 digraph, edge ids
    1..20."""
    data = np.arange(1, 21, dtype=np.int64)
    indices = np.array([1, 2, 3, 4, 0, 2, 3, 4, 0, 1, 3, 4,
                        0, 1, 2, 4, 0, 1, 2, 3], dtype=np.int64)
    indptr = np.array([0, 4, 8, 12, 16, 20], dtype=np.int64)
    return pkg.nd.sparse.csr_matrix((data, indices, indptr), shape=(5, 5))


def _csr_from_dense(pkg, x_dense):
    rows, cols = np.nonzero(x_dense)
    indptr = np.zeros(x_dense.shape[0] + 1, np.int64)
    np.add.at(indptr[1:], rows, 1)
    return pkg.nd.sparse.csr_matrix(
        (x_dense[rows, cols], cols.astype(np.int64), np.cumsum(indptr)),
        shape=x_dense.shape)


def _ids(pkg, ids):
    return pkg.nd.array(np.array(ids, np.int64), dtype=np.int64)


def test_registered():
    from mxnet_tpu_torch import ops

    names = {"_contrib_dgl_csr_neighbor_uniform_sample",
             "_contrib_dgl_csr_neighbor_non_uniform_sample",
             "_contrib_dgl_subgraph", "_contrib_edge_id",
             "_contrib_dgl_adjacency", "_contrib_dgl_graph_compact"}
    assert names <= set(ops.list_ops())
    assert all(ops.get(n).host for n in names)


def test_edge_id():
    def run(pkg):
        x = pkg.nd.sparse.csr_matrix(
            (np.array([1, 2, 3], np.int64), np.array([0, 1, 2], np.int64),
             np.array([0, 1, 2, 3], np.int64)), shape=(3, 3))
        return pkg.nd.contrib.edge_id(x, _ids(pkg, [0, 0, 1, 1, 2, 2]),
                                      _ids(pkg, [0, 1, 1, 2, 0, 2]))

    got = run(mx)
    _same(got, run(jmx))
    np.testing.assert_array_equal(_np(got), [1, -1, 2, -1, -1, 3])


def test_dgl_adjacency():
    outs = [pkg.nd.contrib.dgl_adjacency(_k5(pkg)) for pkg in PKGS]
    assert outs[1].stype == "csr"
    for part in ("indptr", "indices", "data"):
        _same(getattr(outs[1], part), getattr(outs[0], part))
    dense = _np(outs[1].tostype("default"))
    assert dense.dtype == np.float32
    np.testing.assert_array_equal(
        dense, (_np(_k5(mx).tostype("default")) != 0).astype(np.float32))


def test_dgl_subgraph_example():
    x_dense = np.array([[1, 0, 0, 2],
                        [3, 0, 4, 0],
                        [0, 5, 0, 0],
                        [0, 6, 7, 0]], np.int64)
    outs = [pkg.nd.contrib.dgl_subgraph(_csr_from_dense(pkg, x_dense),
                                        _ids(pkg, [0, 1, 2]), num_args=2,
                                        return_mapping=True)
            for pkg in PKGS]
    for j, t in zip(*outs):
        _same(t.tostype("default"), j.tostype("default"))
        _same(t.indptr, j.indptr)
    np.testing.assert_array_equal(_np(outs[1][0].tostype("default")),
                                  [[1, 0, 0], [2, 0, 3], [0, 4, 0]])
    np.testing.assert_array_equal(_np(outs[1][1].tostype("default")),
                                  [[1, 0, 0], [3, 0, 4], [0, 5, 0]])


def _check_sample(parent, verts, subg, layer, seeds, k, max_v):
    v = _np(verts)
    n = int(v[-1])
    assert len(seeds) <= n <= max_v
    ids = v[:n]
    assert sorted(ids) == list(ids)
    assert set(seeds) <= set(ids.tolist())
    lay = _np(layer)
    assert all(lay[list(ids).index(s)] == 0 for s in seeds)
    dense = _np(subg.tostype("default"))
    assert dense.shape == (max_v, max_v)
    for i in range(n):
        nz = np.nonzero(dense[i])[0]
        assert len(nz) <= k
        for c in nz:
            assert parent[ids[i], c] == dense[i, c]   # an edge of the graph
    assert not dense[n:].any()


def test_uniform_sample_structure():
    parent = _np(_k5(mx).tostype("default"))
    for seed in range(4):
        mx.random.seed(seed)
        verts, subg, layer = mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
            _k5(mx), _ids(mx, [0, 1]), num_args=2, num_hops=2,
            num_neighbor=2, max_num_vertices=5)
        _check_sample(parent, verts, subg, layer, [0, 1], 2, 5)
        assert set(_np(layer)[:int(_np(verts)[-1])]) <= {0, 1, 2}


def test_uniform_sample_deterministic_when_k_covers_degree():
    outs = [pkg.nd.contrib.dgl_csr_neighbor_uniform_sample(
        _k5(pkg), _ids(pkg, range(5)), num_args=2, num_hops=1,
        num_neighbor=4, max_num_vertices=5) for pkg in PKGS]
    for j, t in zip(*outs):
        if t.stype == "csr":
            t, j = t.tostype("default"), j.tostype("default")
        _same(t, j)
    np.testing.assert_array_equal(_np(outs[1][0]), [0, 1, 2, 3, 4, 5])


def test_non_uniform_sample_prob_output():
    mx.random.seed(3)
    prob = np.array([0.9, 0.8, 0.2, 0.4, 0.1], np.float32)
    outs = [pkg.nd.contrib.dgl_csr_neighbor_non_uniform_sample(
        _k5(pkg), pkg.nd.array(prob), _ids(pkg, range(5)), num_args=3,
        num_hops=1, num_neighbor=2, max_num_vertices=5) for pkg in PKGS]
    verts, subg, p_out, layer = outs[1]
    for i in (0, 2, 3):   # vertices, probabilities, layers: every vertex
        _same(outs[1][i], outs[0][i])
    np.testing.assert_array_equal(_np(verts), [0, 1, 2, 3, 4, 5])
    np.testing.assert_allclose(_np(p_out), prob, rtol=1e-6)
    dense = _np(subg.tostype("default"))
    assert (np.count_nonzero(dense, axis=1) == 2).all()
    _check_sample(_np(_k5(mx).tostype("default")), verts, subg, layer,
                  list(range(5)), 2, 5)


def test_graph_compact():
    outs = []
    for pkg in PKGS:
        verts, subg, _ = pkg.nd.contrib.dgl_csr_neighbor_uniform_sample(
            _k5(pkg), _ids(pkg, range(5)), num_args=2, num_hops=1,
            num_neighbor=4, max_num_vertices=6)
        n = int(_np(verts)[-1])
        assert n == 5 and subg.shape == (6, 6)
        outs.append(pkg.nd.contrib.dgl_graph_compact(
            subg, verts, num_args=2, return_mapping=True, graph_sizes=(n,)))
    for j, t in zip(*outs):
        assert t.shape == (5, 5)
        _same(t.tostype("default"), j.tostype("default"))
    np.testing.assert_array_equal(_np(outs[1][0].tostype("default")),
                                  _np(_k5(mx).tostype("default")))


def test_sampling_reproducible_under_seed():
    def run():
        mx.random.seed(42)
        _, subg, _ = mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
            _k5(mx), _ids(mx, [0]), num_args=2, num_hops=2, num_neighbor=2,
            max_num_vertices=5)
        return _np(subg.tostype("default"))

    np.testing.assert_array_equal(run(), run())


@pytest.mark.parametrize("weighted", [False, True])
def test_neighbor_sample_equals_jax_on_one_numpy_stream(weighted):
    """Both packages' BFS sampler given the same numpy generator: the same
    vertices, hops and edges, on a random 40-vertex graph."""
    rng = np.random.RandomState(1)
    dense = (rng.uniform(0, 1, (40, 40)) < 0.15) \
        * np.arange(1, 1601).reshape(40, 40)
    rows, cols = np.nonzero(dense)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=40))])
    prob = rng.uniform(0.05, 1, 40) if weighted else None
    args = (dense[rows, cols].astype(np.int64), cols.astype(np.int64),
            indptr.astype(np.int64), np.array([3, 17, 29]), prob, 3, 3, 25)
    got = tdgl._neighbor_sample(np.random.default_rng(5), *args)
    want = jdgl._neighbor_sample(np.random.default_rng(5), *args)
    assert got[0] == want[0] and got[1] == want[1]
    assert {k: [(u, int(v)) for u, v in e] for k, e in got[2].items()} == \
        {k: [(u, int(v)) for u, v in e] for k, e in want[2].items()}
    assert len(got[0]) <= 25


def test_sampled_csr_columns_beyond_its_shape_f5():
    """Queue 3 fault F5: a sampler's subgraph holds original vertex ids as
    columns in a (max_num_vertices, max_num_vertices) shape, so a sampled
    vertex id at or past max_num_vertices lies outside it. The JAX
    package's densify drops such an entry silently (an XLA scatter drops
    out-of-range indices); the port refuses it where it is made, while
    the column ids are on the host: `csr_matrix` raises an `MXNetError`
    naming the column and the shape. Input: the csr a sampler gives on K5
    with max_num_vertices=4 when vertex 4 is sampled."""
    args = (np.array([2, 9], np.int64), np.array([1, 4], np.int64),
            np.array([0, 1, 2, 2, 2], np.int64))
    want = jmx.nd.sparse.csr_matrix(args, shape=(4, 4))
    dense = _np(want.tostype("default"))
    assert dense[0, 1] == 2 and dense.sum() == 2     # the 9 at (1, 4) gone
    with pytest.raises(MXNetError, match=r"column index 4 .*\(4, 4\)"):
        mx.nd.sparse.csr_matrix(args, shape=(4, 4))
