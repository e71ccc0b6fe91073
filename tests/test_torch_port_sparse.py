"""`mxnet_tpu_torch.ndarray.sparse`, the row-sparse gradients and the lazy
updates against the JAX package's, on the CPU.

Every case of the JAX package's ``tests/test_sparse.py`` (the kvstore one
is in ``test_torch_port_kvstore.py``) runs through both packages on the
same seeded numpy inputs, and each output (dense values, ``indices``,
``indptr``, their dtypes) is held to the JAX package's: index components
exactly, values within rtol 1e-6 with an absolute floor of 1e-6 x the
largest magnitude (``TOL``; both packages compute in f32, the SpMM sums in
the same CSR order). Beside them: ``autograd.mark_variables`` with a
row_sparse buffer (the JAX ``test_autograd.py`` case), ``grad_req="add"``
into one, the lazy SGD / SGD-momentum / Adam / AdaGrad updates (weights
and states, the untouched rows' stale moments included) through
``sparse.*``, the optimizers and the registered ops, the f16 master-weight
path, ``Embedding(sparse_grad=True)`` and ``SparseEmbedding`` under a
gluon ``Trainer``, ``gluon.contrib.nn`` (``PixelShuffle1D/2D/3D`` on
NDArrays and as a Symbol, ``SyncBatchNorm``, ``Concurrent``,
``Identity``; SyncBatchNorm's output and input gradient within 1e-4, its
batch statistics summing in other orders), ``nd.save`` of sparse arrays,
and the first 20 steps of ``examples/sparse/linear_classification.py``'s
loop, whose losses agree within 1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import sparse

TOL = 1e-6

@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _close(got, want, what="", tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind in "iub" or want.dtype.kind in "iub":
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    floor = tol * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=floor, err_msg=what)


def _both(run, *args, tol=TOL):
    """run(pkg, *args) -> dict of numpy arrays, through both packages; the
    port's held to the JAX package's."""
    want, got = run(jmx, *args), run(mx, *args)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k, tol)
    return got


def _np(a):
    return np.asarray(a.asnumpy())


def _rand_dense_with_zero_rows(rng, shape, density=0.4):
    arr = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = rng.uniform(0, 1, (shape[0],)) < density
    return arr * mask.reshape((-1,) + (1,) * (len(shape) - 1))


# --------------------------------------------------------------------------
# the cases of tests/test_sparse.py
# --------------------------------------------------------------------------

def test_rsp_roundtrip():
    dense_np = _rand_dense_with_zero_rows(np.random.RandomState(0), (8, 3))

    def run(pkg):
        rsp = pkg.nd.array(dense_np).tostype("row_sparse")
        assert rsp.stype == "row_sparse" and rsp.shape == (8, 3)
        return {"dense": _np(rsp), "back": _np(rsp.tostype("default")),
                "indices": _np(rsp.indices), "data": _np(rsp.data)}

    got = _both(run)
    np.testing.assert_array_equal(
        got["indices"], np.where(np.any(dense_np != 0, axis=1))[0])
    np.testing.assert_array_equal(got["dense"], dense_np)


def test_csr_roundtrip():
    dense_np = np.array([[1, 0, 2], [0, 0, 0], [3, 4, 0]], dtype=np.float32)

    def run(pkg):
        csr = pkg.nd.array(dense_np).tostype("csr")
        assert csr.stype == "csr" and csr.nnz == 4
        return {"indptr": _np(csr.indptr), "indices": _np(csr.indices),
                "data": _np(csr.data), "dense": _np(csr)}

    got = _both(run)
    np.testing.assert_array_equal(got["indptr"], [0, 2, 2, 4])
    np.testing.assert_array_equal(got["dense"], dense_np)


def test_creation_functions():
    def run(pkg):
        sp = pkg.nd.sparse
        rsp = sp.row_sparse_array(([[1.0, 2.0], [3.0, 4.0]], [3, 1]),
                                  shape=(5, 2))
        csr = sp.csr_matrix(([1.0, 2.0, 3.0], [0, 2, 1], [0, 2, 3]),
                            shape=(2, 3))
        inferred = sp.row_sparse_array(([[5.0]], [2]))
        z, zc = sp.zeros("row_sparse", (4, 2)), sp.zeros("csr", (4, 2))
        assert rsp.shape == (5, 2) and inferred.shape == (3, 1)
        return {"rsp": _np(rsp), "rsp_idx": _np(rsp.indices),
                "csr": _np(csr), "inferred": _np(inferred),
                "z": _np(z), "zc": _np(zc), "zc_indptr": _np(zc.indptr),
                "from_dense": _np(sp.csr_matrix(np.eye(3, dtype=np.float32))
                                  .indices)}

    got = _both(run)
    np.testing.assert_array_equal(got["rsp"][[1, 3]], [[3, 4], [1, 2]])
    np.testing.assert_array_equal(got["csr"], [[1, 0, 2], [0, 3, 0]])


def test_sparse_array_from_scipy():
    sps = pytest.importorskip("scipy.sparse")
    m = sps.random(6, 5, density=0.4, format="csr", dtype=np.float32,
                   random_state=np.random.RandomState(1))

    def run(pkg):
        a = pkg.nd.sparse.array(m)
        assert a.stype == "csr"
        return {"dense": _np(a), "indptr": _np(a.indptr)}

    got = _both(run)
    np.testing.assert_array_equal(got["dense"], m.toarray())


def test_sparse_retain():
    dense_np = np.arange(12, dtype=np.float32).reshape(4, 3) + 1

    def run(pkg):
        rsp = pkg.nd.array(dense_np).tostype("row_sparse")
        kept = pkg.nd.sparse.sparse_retain(
            rsp, pkg.nd.array([0, 2], dtype="int64"))
        return {"kept": _np(kept), "idx": _np(kept.indices),
                "method": _np(rsp.retain(pkg.nd.array([3], dtype="int64")))}

    got = _both(run)
    expect = dense_np.copy()
    expect[[1, 3]] = 0
    np.testing.assert_array_equal(got["kept"], expect)


def test_csr_dot_vs_dense():
    rng = np.random.RandomState(0)
    dense_np = (rng.uniform(-1, 1, (5, 7))
                * (rng.uniform(0, 1, (5, 7)) < 0.3)).astype(np.float32)
    rhs_np = rng.uniform(-1, 1, (7, 4)).astype(np.float32)
    rhs2_np = rng.uniform(-1, 1, (5, 4)).astype(np.float32)
    vec_np = rng.uniform(-1, 1, (7,)).astype(np.float32)

    def run(pkg):
        csr = pkg.nd.array(dense_np).tostype("csr")
        sp = pkg.nd.sparse
        return {"dot": _np(sp.dot(csr, pkg.nd.array(rhs_np))),
                "dot_t": _np(sp.dot(csr, pkg.nd.array(rhs2_np),
                                    transpose_a=True)),
                "vec": _np(sp.dot(csr, pkg.nd.array(vec_np)))}

    got = _both(run)
    _close(got["dot"], dense_np @ rhs_np, "oracle", 1e-5)
    _close(got["dot_t"], dense_np.T @ rhs2_np, "oracle_t", 1e-5)


def test_square_sum():
    dense_np = _rand_dense_with_zero_rows(np.random.RandomState(2), (6, 3))

    def run(pkg):
        rsp = pkg.nd.array(dense_np).tostype("row_sparse")
        sp = pkg.nd.sparse
        row = sp.square_sum(rsp, axis=1)
        return {"all": _np(sp.square_sum(rsp)), "row": _np(row),
                "row_idx": _np(row.indices),
                "keep": _np(sp.square_sum(rsp, axis=1, keepdims=True)),
                "axis0": _np(sp.square_sum(rsp, axis=0))}

    got = _both(run)
    _close(got["row"], (dense_np ** 2).sum(axis=1), "oracle", 1e-5)


def test_sparse_add():
    def run(pkg):
        sp = pkg.nd.sparse
        a = sp.row_sparse_array(([[1.0]], [0]), shape=(4, 1))
        b = sp.row_sparse_array(([[2.0], [3.0]], [0, 2]), shape=(4, 1))
        c = sp.add(a, b)
        assert c.stype == "row_sparse"
        return {"c": _np(c), "idx": _np(c.indices),
                "dense": _np(sp.add(a, pkg.nd.ones((4, 1))))}

    got = _both(run)
    np.testing.assert_array_equal(got["c"].ravel(), [3, 0, 3, 0])


def test_lazy_sgd_update():
    def run(pkg):
        w = pkg.nd.array(np.ones((4, 2), dtype=np.float32))
        grad = pkg.nd.sparse.row_sparse_array(([[1.0, 1.0]], [2]),
                                              shape=(4, 2))
        pkg.nd.sparse.sgd_update(w, grad, lr=0.5, wd=0.1)
        return {"w": _np(w)}

    got = _both(run)
    np.testing.assert_array_equal(got["w"][[0, 1, 3]], 1.0)


def test_optimizer_sparse_path():
    def run(pkg):
        opt = pkg.optimizer.create("adam", learning_rate=0.1)
        w = pkg.nd.array(np.ones((5, 2), dtype=np.float32))
        state = opt.create_state(0, w)
        grad = pkg.nd.sparse.row_sparse_array(([[1.0, 1.0]], [1]),
                                              shape=(5, 2))
        opt.update(0, w, grad, state)
        return {"w": _np(w), "m": np.asarray(state[0].asnumpy()
                                             if hasattr(state[0], "asnumpy")
                                             else state[0])}

    got = _both(run)
    assert not np.allclose(got["w"][1], 1.0)
    np.testing.assert_array_equal(got["w"][[0, 2, 3, 4]], 1.0)


def test_rand_ndarray_sparse():
    """The JAX package's ``test_utils.rand_ndarray`` (sparse stypes), on
    the same numpy draws through both packages."""
    def rand(pkg, shape, stype, seed, density=0.5):
        rng = np.random.RandomState(seed)
        arr = rng.uniform(-1.0, 1.0, size=shape).astype(np.float32)
        mask = rng.uniform(0, 1, size=shape) < density
        if stype == "row_sparse":
            arr = arr * mask.reshape(shape[0], -1).any(axis=1)[:, None]
        else:
            arr = arr * mask
        return pkg.nd.array(arr).tostype(stype)

    def run(pkg):
        rsp, csr = rand(pkg, (6, 4), "row_sparse", 3), \
            rand(pkg, (6, 4), "csr", 4)
        assert rsp.stype == "row_sparse" and csr.stype == "csr"
        return {"rsp": _np(rsp), "csr": _np(csr), "nnz": np.int64(csr.nnz)}

    _both(run)


def test_embedding_sparse_grad_training():
    """Only the looked-up rows change, and they change as in the JAX
    package, from the JAX package's initial weight."""
    def run(pkg, w0):
        net = pkg.gluon.nn.Embedding(10, 4, sparse_grad=True)
        net.initialize(ctx=pkg.cpu())
        net.weight.set_data(pkg.nd.array(w0))
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 1.0, "wd": 0.1})
        x = pkg.nd.array([1, 3], dtype="int32")
        with pkg.autograd.record():
            loss = net(x).sum()
        loss.backward()
        trainer.step(1)
        return {"w": _np(net.weight.data())}

    w0 = np.random.RandomState(5).uniform(-1, 1, (10, 4)).astype(np.float32)
    got = _both(run, w0)
    changed = np.where(np.any(w0 != got["w"], axis=1))[0]
    np.testing.assert_array_equal(sorted(changed), [1, 3])


def test_csr_dot_backward():
    dns = np.array([[0, 1.5, 0, 2.0],
                    [3.0, 0, 0, 0],
                    [0, 0, -1.0, 4.0]], dtype=np.float32)

    def run(pkg):
        x = pkg.nd.sparse.csr_matrix(dns)
        w = pkg.nd.array(np.arange(8, dtype=np.float32).reshape(4, 2))
        w.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.sparse.dot(x, w)
            s = (out * out).sum()
        s.backward()
        return {"out": _np(out), "grad": _np(w.grad)}

    got = _both(run)
    w = np.arange(8, dtype=np.float32).reshape(4, 2)
    _close(got["grad"], dns.T @ (2 * (dns @ w)), "oracle", 1e-5)


def test_csr_dot_transpose_backward():
    dns = np.array([[0, 2.0, 0], [1.0, 0, 3.0]], dtype=np.float32)

    def run(pkg):
        x = pkg.nd.sparse.csr_matrix(dns)
        w = pkg.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        w.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.sparse.dot(x, w, transpose_a=True)
            s = out.sum()
        s.backward()
        return {"out": _np(out), "grad": _np(w.grad)}

    got = _both(run)
    _close(got["grad"], dns @ np.ones((3, 3), np.float32), "oracle")


def test_attach_grad_row_sparse_stype():
    dns = np.zeros((2, 6), np.float32)
    dns[0, 1] = 2.0
    dns[1, 4] = 3.0

    def run(pkg):
        w = pkg.nd.zeros((6, 2))
        w.attach_grad(stype="row_sparse")
        x = pkg.nd.sparse.csr_matrix(dns)
        with pkg.autograd.record():
            out = pkg.nd.sparse.dot(x, w + 1.0)
            out.sum().backward()
        g = w.grad
        assert g.stype == "row_sparse"
        return {"g": _np(g.tostype("default")), "idx": _np(g.indices)}

    got = _both(run)
    _close(got["g"], dns.T @ np.ones((2, 2), np.float32), "oracle")


def test_csr_row_ids_cache_invalidated_by_copyto():
    def run(pkg):
        sp = pkg.nd.sparse
        a = sp.csr_matrix(np.array([[1, 0], [0, 2]], np.float32))
        w = pkg.nd.array(np.eye(2, dtype=np.float32))
        sp.dot(a, w)                            # fills the caches
        sp.dot(a, w, transpose_a=True)
        b = sp.csr_matrix(np.array([[1, 2], [0, 0]], np.float32))
        b.copyto(a)
        return {"dot": _np(sp.dot(a, w)),
                "dot_t": _np(sp.dot(a, w, transpose_a=True))}

    got = _both(run)
    np.testing.assert_array_equal(got["dot"], [[1, 2], [0, 0]])


def test_row_sparse_grad_alias_preserved():
    dns = np.zeros((1, 4), np.float32)
    dns[0, 1] = 2.0

    def run(pkg):
        w = pkg.nd.zeros((4, 2))
        w.attach_grad(stype="row_sparse")
        g = w.grad
        assert g.stype == "row_sparse"
        x = pkg.nd.sparse.csr_matrix(dns)
        with pkg.autograd.record():
            pkg.nd.sparse.dot(x, w + 1.0).sum().backward()
        assert g is w.grad
        return {"g": _np(g.tostype("default"))}

    got = _both(run)
    np.testing.assert_array_equal(got["g"][1], [2.0, 2.0])


# --------------------------------------------------------------------------
# autograd: row_sparse buffers
# --------------------------------------------------------------------------

def test_mark_variables_row_sparse_buffer():
    """The JAX package's ``test_autograd.py`` case: a row_sparse buffer given
    to ``mark_variables`` takes the sparse write-back, in place."""
    def run(pkg):
        w = pkg.nd.array(np.ones((4, 2), dtype=np.float32))
        g = pkg.nd.sparse.zeros("row_sparse", (4, 2))
        pkg.autograd.mark_variables([w], [g])
        with pkg.autograd.record():
            (w * 2).sum().backward()
        assert w.grad is g and g.stype == "row_sparse"
        return {"g": _np(g.tostype("default")), "idx": _np(g.indices)}

    got = _both(run)
    np.testing.assert_array_equal(got["g"], 2 * np.ones((4, 2)))


def test_row_sparse_grad_req_add_sums_with_earlier_value():
    dns = [np.zeros((1, 5), np.float32) for _ in range(2)]
    dns[0][0, 1], dns[1][0, 3] = 2.0, -1.5

    def run(pkg):
        w = pkg.nd.array(np.arange(10, dtype=np.float32).reshape(5, 2))
        w.attach_grad(grad_req="add", stype="row_sparse")
        for d in dns:
            with pkg.autograd.record():
                out = pkg.nd.sparse.dot(pkg.nd.sparse.csr_matrix(d), w)
                (out * out).sum().backward()
        return {"g": _np(w.grad), "idx": _np(w.grad.indices)}

    got = _both(run)
    np.testing.assert_array_equal(got["idx"], [1, 3])


def test_attach_grad_refuses_csr():
    with pytest.raises(MXNetError, match="unsupported grad stype"):
        mx.nd.zeros((2, 2)).attach_grad(stype="csr")


# --------------------------------------------------------------------------
# the lazy updates
# --------------------------------------------------------------------------

_W = np.random.RandomState(11).uniform(-1, 1, (7, 3)).astype(np.float32)
_GRADS = [(np.random.RandomState(12 + i).uniform(-2, 2, (2, 3))
           .astype(np.float32), rows) for i, rows in
          enumerate(([1, 4], [4, 6], [0, 1]))]


def _rsp(pkg, i):
    vals, rows = _GRADS[i]
    return pkg.nd.sparse.row_sparse_array((vals, rows), shape=_W.shape)


def _state_np(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for y in s for x in _state_np(y)]
    return [np.asarray(s.asnumpy() if hasattr(s, "asnumpy")
                       else s.detach().cpu().numpy())]


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.2, wd=0.05)),
    ("sgd", dict(learning_rate=0.2, wd=0.05, momentum=0.9)),
    ("sgd", dict(learning_rate=0.2, momentum=0.9, lazy_update=False)),
    ("adam", dict(learning_rate=0.05, wd=0.01)),
    ("adam", dict(learning_rate=0.05, lazy_update=False)),
    ("adagrad", dict(learning_rate=0.3, wd=0.02, clip_gradient=1.5)),
])
def test_lazy_optimizer_updates_match_jax(name, kw):
    """Three steps over gradients on different rows: the weights and every
    state equal the JAX package's within 1e-6, the lazy runs leaving the
    rows no gradient held (and their moments) as they were."""
    def run(pkg):
        opt = pkg.optimizer.create(name, rescale_grad=0.5, **kw)
        w = pkg.nd.array(_W)
        state = opt.create_state(0, w)
        for i in range(len(_GRADS)):
            opt.update(0, w, _rsp(pkg, i), state)
        out = {"w": _np(w)}
        out.update(("s%d" % j, s) for j, s in enumerate(_state_np(state)))
        return out

    got = _both(run)
    if kw.get("lazy_update", True):
        untouched = [2, 3, 5]
        np.testing.assert_array_equal(got["w"][untouched], _W[untouched])
        for k in got:
            if k.startswith("s"):
                np.testing.assert_array_equal(got[k][untouched], 0.0)


@pytest.mark.parametrize("fn,states,kw", [
    ("sgd_update", 0, dict(lr=0.3, wd=0.1)),
    ("sgd_mom_update", 1, dict(lr=0.3, momentum=0.8, clip_gradient=0.5)),
    ("adam_update", 2, dict(lr=0.01, beta1=0.8, epsilon=1e-6, wd=0.02)),
    ("adagrad_update", 1, dict(lr=0.1, rescale_grad=2.0)),
])
def test_sparse_module_lazy_updates_match_jax(fn, states, kw):
    """``nd.sparse.<update>`` (the JAX signatures): two steps, weights and
    states within 1e-6 of the JAX package's; stale rows bit for bit."""
    s0 = np.random.RandomState(3).uniform(0, 1, (states,) + _W.shape) \
        .astype(np.float32)

    def run(pkg):
        w = pkg.nd.array(_W)
        st = [pkg.nd.array(s) for s in s0]
        for i in range(2):
            getattr(pkg.nd.sparse, fn)(w, _rsp(pkg, i), *st, **kw)
        out = {"w": _np(w)}
        out.update(("s%d" % j, _np(s)) for j, s in enumerate(st))
        return out

    got = _both(run)
    for j in range(states):
        np.testing.assert_array_equal(got["s%d" % j][[0, 2, 3, 5]],
                                      s0[j][[0, 2, 3, 5]])


@pytest.mark.parametrize("op,states,kw", [
    ("sgd_update", 0, dict(lr=0.3, wd=0.1)),
    ("sgd_mom_update", 1, dict(lr=0.3, momentum=0.8)),
    ("adam_update", 2, dict(lr=0.01, wd=0.02)),
    ("_sparse_adagrad_update", 1, dict(lr=0.1)),
])
def test_registered_updates_take_row_sparse_gradients(op, states, kw):
    """The registered ops given a row_sparse gradient: with
    ``lazy_update=True`` (AdaGrad always) the port's ``nd.sparse`` update;
    without it the dense update of the densified gradient, which the JAX
    op computes from the dense gradient. The inputs are left alone."""
    s0 = [np.full(_W.shape, 0.5, np.float32) for _ in range(states)]
    grad = _rsp(mx, 0)
    w = mx.nd.array(_W)
    st = [mx.nd.array(s) for s in s0]
    lazy_kw = kw if op == "_sparse_adagrad_update" \
        else dict(kw, lazy_update=True)
    outs = getattr(mx.nd, op)(w, grad, *st, **lazy_kw)
    outs = outs if isinstance(outs, list) else [outs]
    ref_w, ref_s = mx.nd.array(_W), [mx.nd.array(s) for s in s0]
    name = "adagrad_update" if op.startswith("_sparse") else op
    getattr(sparse, name)(ref_w, grad, *ref_s, **kw)
    for a, b in zip(outs, [ref_w] + ref_s):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(w), _W)   # inputs untouched
    if op == "_sparse_adagrad_update":
        return
    dense = getattr(mx.nd, op)(w, grad, *st, **kw)
    jdense = getattr(jmx.nd, op)(jmx.nd.array(_W),
                                 jmx.nd.array(_np(grad.tostype("default"))),
                                 *[jmx.nd.array(s) for s in s0], **kw)
    dense = dense if isinstance(dense, list) else [dense]
    jdense = jdense if isinstance(jdense, list) else [jdense]
    for a, b in zip(dense, jdense):
        _close(_np(a), _np(b), op)


def test_multi_precision_master_weight_takes_the_lazy_update():
    """f16 weight, f32 master copy: SGD with momentum on a row_sparse
    gradient updates the master's rows lazily and copies it into the
    weight, as the JAX package does."""
    def run(pkg):
        opt = pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                   multi_precision=True)
        w = pkg.nd.array(_W, dtype="float16")
        state = opt.create_state_multi_precision(0, w)
        for i in range(2):
            opt.update_multi_precision(0, w, _rsp(pkg, i).astype("float16"),
                                       state)
        return {"w": _np(w).astype(np.float32),
                "master": _state_np(state)[-1]}

    got = _both(run)
    w16 = _W.astype(np.float16).astype(np.float32)   # the master's start
    np.testing.assert_array_equal(got["master"][[0, 2, 3, 5]],
                                  w16[[0, 2, 3, 5]])


def test_optimizer_without_sparse_update_refuses_row_sparse():
    opt = mx.optimizer.create("rmsprop")
    w = mx.nd.array(_W)
    with pytest.raises(MXNetError, match="supports_sparse"):
        opt.update(0, w, _rsp(mx, 0), opt.create_state(0, w))


def test_trainer_lazy_adam_over_sparse_embedding_matches_jax():
    """SparseEmbedding under a gluon Trainer with Adam, three steps: the
    weight and both moments equal the JAX package's within 1e-6, and rows
    no batch looked up keep their weights and zero moments."""
    w0 = np.random.RandomState(6).uniform(-1, 1, (12, 5)).astype(np.float32)
    batches = [np.array([[1, 3], [3, 7]]), np.array([[0, 7]]),
               np.array([[1, 1]])]

    def run(pkg):
        emb = pkg.gluon.contrib.nn.SparseEmbedding(12, 5)
        emb.initialize(ctx=pkg.cpu())
        emb.weight.set_data(pkg.nd.array(w0))
        assert emb.weight._grad_stype == "row_sparse"
        tr = pkg.gluon.Trainer(emb.collect_params(), "adam",
                               {"learning_rate": 0.05})
        for b in batches:
            x = pkg.nd.array(b.astype(np.float32))
            with pkg.autograd.record():
                out = emb(x)
                (out * out).mean().backward()
            tr.step(b.size)
        states = tr._updaters[0].states if hasattr(tr, "_updaters") \
            else tr._updater.states
        m, v = _state_np(states[0])
        return {"w": _np(emb.weight.data()), "m": m, "v": v}

    got = _both(run)
    untouched = [2, 4, 5, 6, 8, 9, 10, 11]
    np.testing.assert_array_equal(got["w"][untouched], w0[untouched])
    np.testing.assert_array_equal(got["m"][untouched], 0.0)


def test_nd_save_writes_sparse_arrays_dense(tmp_path):
    dense_np = _rand_dense_with_zero_rows(np.random.RandomState(8), (5, 2))
    rsp = mx.nd.array(dense_np).tostype("row_sparse")
    csr = mx.nd.array(dense_np).tostype("csr")
    mx.nd.save(str(tmp_path / "s.params"), {"rsp": rsp, "csr": csr})
    back = jmx.nd.load(str(tmp_path / "s.params"))
    for k in ("rsp", "csr"):
        np.testing.assert_array_equal(np.asarray(back[k].asnumpy()),
                                      dense_np)


def test_sparse_arrays_move_between_devices_and_refuse_writes():
    rsp = mx.nd.array(_W).tostype("row_sparse")
    moved = rsp.copyto(mx.cpu())
    assert moved is not rsp and moved.stype == "row_sparse"
    np.testing.assert_array_equal(_np(moved), _W)
    np.testing.assert_array_equal(_np(rsp[2]), _W[2])
    dense = mx.nd.zeros(_W.shape)
    rsp.copyto(dense)
    np.testing.assert_array_equal(_np(dense), _W)
    with pytest.raises(MXNetError, match="item assignment"):
        rsp[0] = 1.0
    with pytest.raises(MXNetError, match="stype mismatch"):
        rsp.copyto(mx.nd.array(_W).tostype("csr"))
    assert rsp.astype("float16").stype == "row_sparse"
    np.testing.assert_array_equal(_np(rsp * 2), _W * 2)   # dense fallback


# --------------------------------------------------------------------------
# gluon.contrib.nn (tests/test_contrib_gluon.py's cases, and the rest)
# --------------------------------------------------------------------------

def test_sparse_embedding():
    x_np = np.array([[1, 3], [5, 1]], np.float32)
    w0 = np.random.RandomState(9).uniform(-0.1, 0.1, (20, 6)) \
        .astype(np.float32)

    def run(pkg):
        emb = pkg.gluon.contrib.nn.SparseEmbedding(20, 6)
        emb.initialize(pkg.init.Uniform(0.1))
        emb.weight.set_data(pkg.nd.array(w0))
        assert emb.weight._grad_stype == "row_sparse"
        with pkg.autograd.record():
            out = emb(pkg.nd.array(x_np))
            (out * out).mean().backward()
        assert out.shape == (2, 2, 6)
        g = emb.weight.grad()
        return {"out": _np(out), "g": _np(g)}

    got = _both(run)
    touched = set(np.nonzero(np.abs(got["g"]).sum(axis=1))[0].tolist())
    assert touched == {1, 3, 5}
    with pytest.raises(MXNetError, match="sparse_grad"):
        mx.gluon.contrib.nn.SparseEmbedding(4, 2, sparse_grad=False)


def test_pixel_shuffle_layers():
    f1, f2 = 2, 3
    x1 = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
    x2 = np.random.RandomState(5).normal(
        size=(2, 4 * f1 * f2, 3, 5)).astype(np.float32)
    x3 = np.random.RandomState(6).normal(
        size=(1, 2 * 8, 2, 2, 2)).astype(np.float32)

    def run(pkg):
        cnn = pkg.gluon.contrib.nn
        blk = cnn.PixelShuffle2D((f1, f2))
        blk.hybridize()
        s = blk(pkg.sym.var("data"))
        exe = s.bind(pkg.cpu(), {"data": pkg.nd.array(x2)})
        return {"1d": _np(cnn.PixelShuffle1D(2)(pkg.nd.array(x1))),
                "2d": _np(cnn.PixelShuffle2D((f1, f2))(pkg.nd.array(x2))),
                "3d": _np(cnn.PixelShuffle3D(2)(pkg.nd.array(x3))),
                "hybrid": _np(blk(pkg.nd.array(x2))),
                "symbol": _np(exe.forward()[0])}

    got = _both(run)
    np.testing.assert_array_equal(got["1d"], [[[0, 3, 1, 4, 2, 5]]])
    ref = x2.reshape(2, 4, f1, f2, 3, 5).transpose(0, 1, 4, 2, 5, 3) \
        .reshape(2, 4, 3 * f1, 5 * f2)
    np.testing.assert_array_equal(got["2d"], ref)
    np.testing.assert_array_equal(got["symbol"], ref)
    ref3 = x3.reshape(1, 2, 2, 2, 2, 2, 2, 2) \
        .transpose(0, 1, 5, 2, 6, 3, 7, 4).reshape(1, 2, 4, 4, 4)
    np.testing.assert_array_equal(got["3d"], ref3)


def test_concurrent_identity_and_sync_batchnorm():
    """Concurrent of a Dense layer and an Identity, and SyncBatchNorm (one
    device: BatchNorm over axis 1) in training, forward and input gradient
    against the JAX package's from the same weights, within 1e-4 (the
    batch statistics sum in other orders); with ``num_devices=2`` outside
    a trainer's step over a split batch it is the same layer in both
    packages (the cross-rank statistics are held in
    tests/test_torch_port_model_parallel.py)."""
    x_np = np.random.RandomState(4).uniform(-1, 1, (4, 3, 5, 5)) \
        .astype(np.float32)
    r_np = np.random.RandomState(7).uniform(-1, 1, x_np.shape) \
        .astype(np.float32)
    wd = np.random.RandomState(5).uniform(-1, 1, (2, 3)).astype(np.float32)

    def run(pkg, num_devices=None):
        cnn, nn = pkg.gluon.contrib.nn, pkg.gluon.nn
        net = cnn.HybridConcurrent(axis=1)
        net.add(nn.Dense(2, in_units=3), cnn.Identity())
        bn = cnn.SyncBatchNorm(in_channels=3, num_devices=num_devices)
        net.initialize(ctx=pkg.cpu())
        bn.initialize(ctx=pkg.cpu())
        dense = list(net._children.values())[0]
        dense.weight.set_data(pkg.nd.array(wd))
        x = pkg.nd.array(x_np)
        flat = pkg.nd.array(x_np[:, :, 0, 0])
        x.attach_grad()
        with pkg.autograd.record():
            y = bn(x)
            (y * pkg.nd.array(r_np)).sum().backward()
        return {"concat": _np(net(flat)), "bn": _np(y), "dx": _np(x.grad),
                "mean": _np(bn.running_mean.data())}

    got = _both(run, tol=1e-4)
    assert got["concat"].shape == (4, 5)
    two = _both(run, 2, tol=1e-4)
    np.testing.assert_array_equal(two["bn"], got["bn"])


# --------------------------------------------------------------------------
# the example's loop
# --------------------------------------------------------------------------

def _example_losses(pkg, steps):
    """`examples/sparse/linear_classification.py`'s training loop (its
    batches, AdaGrad on a row_sparse gradient, the kvstore push) for
    ``steps`` steps; the per-step losses."""
    dim, active, batch = 1000, 12, 32
    rng = np.random.RandomState(0)
    w_true = rng.randn(dim).astype(np.float32)
    weight = pkg.nd.zeros((dim, 1))
    weight.attach_grad(stype="row_sparse")
    opt = pkg.optimizer.create("adagrad", learning_rate=0.5)
    state = opt.create_state(0, weight)
    kv = pkg.kv.create("local")
    kv.init(0, weight)
    losses = []
    for _ in range(steps):
        data, indices, indptr, ys = [], [], [0], []
        for _ in range(batch):
            cols = rng.choice(dim, active, replace=False)
            vals = rng.randn(active).astype(np.float32)
            data.extend(vals)
            indices.extend(cols)
            indptr.append(len(data))
            ys.append(1.0 if vals @ w_true[cols] > 0 else 0.0)
        x = pkg.nd.sparse.csr_matrix(
            (np.array(data, np.float32), np.array(indices, np.int64),
             np.array(indptr, np.int64)), shape=(batch, dim))
        y = pkg.nd.array(np.array(ys, np.float32))
        with pkg.autograd.record():
            logits = pkg.nd.sparse.dot(x, weight).reshape((batch,))
            loss = pkg.nd.log(1 + pkg.nd.exp(-(2 * y - 1) * logits)).mean()
        loss.backward()
        assert weight.grad.stype == "row_sparse"
        opt.update(0, weight, weight.grad, state)
        kv.push(0, weight)
        losses.append(float(loss.asnumpy()))
    return np.array(losses), _np(weight)


def test_example_first_20_steps_match_jax():
    want, wj = _example_losses(jmx, 20)
    got, wt = _example_losses(mx, 20)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    _close(wt, wj, "weight", 1e-5)
