"""`mxnet_tpu_torch.kvstore` and `gradient_compression` against the JAX
package's single-process `KVStore`, on the CPU.

The same calls with the same seeded numpy values go to both packages'
stores: ``init``, ``push`` of dense and row_sparse values (a list a key,
summed), ``pull``, ``row_sparse_pull`` (into a dense output, as the JAX
package's test does, and into a row_sparse one, which holds the rows
asked for), ``pushpull``, ``set_updater``, ``set_optimizer`` with SGD
(momentum) and with AdaGrad on row_sparse gradients, the optimizer
states saved by one store and loaded by another (the port's own format),
2-bit compression with its residual over several pushes, and
``create``'s names. Values agree within
rtol 1e-6 with an absolute floor of 1e-6 x the largest magnitude (``TOL``):
the store's sums and updates are elementwise f32, so they are in fact
equal.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gradient_compression import GradientCompression

TOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = TOL * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=floor, err_msg=what)


def _both(run):
    want, got = run(jmx), run(mx)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    return got


def _np(a):
    return np.asarray(a.asnumpy())


_RNG = np.random.RandomState(0)
_W = _RNG.uniform(-1, 1, (6, 3)).astype(np.float32)
_G = [_RNG.uniform(-1, 1, (6, 3)).astype(np.float32) for _ in range(4)]


def test_kvstore_row_sparse():
    """The JAX package's ``test_sparse.py`` case: row_sparse pushes summed
    over the union of their rows, then pull and row_sparse_pull."""
    def run(pkg):
        sp = pkg.nd.sparse
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.zeros((4, 2)))
        g1 = sp.row_sparse_array(([[1.0, 1.0]], [0]), shape=(4, 2))
        g2 = sp.row_sparse_array(([[2.0, 2.0]], [3]), shape=(4, 2))
        kv.push("w", [g1, g2])
        out = pkg.nd.zeros((4, 2))
        kv.pull("w", out=out)
        buf = pkg.nd.zeros((1, 2))
        kv.row_sparse_pull("w", out=buf, row_ids=pkg.nd.array([3],
                                                              dtype="int64"))
        return {"pull": _np(out), "rsp_pull": _np(buf)}

    got = _both(run)
    np.testing.assert_array_equal(got["pull"], [[1, 1], [0, 0], [0, 0],
                                                [2, 2]])
    np.testing.assert_array_equal(got["rsp_pull"], [[2, 2]])


def test_init_push_pull_pushpull_dense():
    def run(pkg):
        kv = pkg.kv.create("device")
        kv.init([0, 1], [pkg.nd.array(_W), pkg.nd.array(_G[0])])
        kv.init(0, pkg.nd.array(_G[3]))      # a second init is ignored
        kv.push(0, [pkg.nd.array(_G[1]), pkg.nd.array(_G[2])])
        a, b = pkg.nd.zeros(_W.shape), pkg.nd.zeros(_W.shape)
        kv.pull([0, 1], out=[a, b])
        c = pkg.nd.array(_G[3])
        kv.pushpull(1, c)
        return {"a": _np(a), "b": _np(b), "c": _np(c)}

    got = _both(run)
    _close(got["a"], _G[1] + _G[2])
    np.testing.assert_array_equal(got["b"], _G[0])
    np.testing.assert_array_equal(got["c"], _G[3])


def test_row_sparse_pull_into_row_sparse_output_holds_the_rows():
    """The reference's form (the example's call): a row_sparse output gets
    the value's shape over the rows asked for, sorted, repeats dropped."""
    kv = mx.kv.create("local")
    kv.init(0, mx.nd.array(_W))
    out = mx.nd.zeros(_W.shape).tostype("row_sparse")
    kv.row_sparse_pull(0, out=out, row_ids=mx.nd.array([4, 1, 4]))
    assert out.stype == "row_sparse" and out.shape == _W.shape
    np.testing.assert_array_equal(_np(out.indices), [1, 4])
    np.testing.assert_array_equal(_np(out.data), _W[[1, 4]])
    with pytest.raises(MXNetError, match="row_sparse_pull"):
        kv.pull(0, out=out, ignore_sparse=False)
    kv.pull(0, out=out)                       # skipped, as in the reference
    np.testing.assert_array_equal(_np(out.indices), [1, 4])
    with pytest.raises(MXNetError, match="row_ids"):
        kv.row_sparse_pull(0, out=out)
    with pytest.raises(MXNetError, match="not been initialized"):
        kv.push(7, mx.nd.zeros((1,)))


def test_set_updater_sees_the_summed_push():
    def run(pkg):
        seen = []

        def updater(key, recv, stored):
            seen.append(_np(recv))
            stored._set_data((stored - 0.5 * recv)._data)

        kv = pkg.kv.create("local")
        kv.init("k", pkg.nd.array(_W))
        kv.set_updater(updater)
        kv.push("k", [pkg.nd.array(_G[0]), pkg.nd.array(_G[1])])
        out = pkg.nd.zeros(_W.shape)
        kv.pull("k", out=out)
        return {"recv": seen[0], "out": _np(out)}

    got = _both(run)
    _close(got["out"], _W - 0.5 * (_G[0] + _G[1]))


@pytest.mark.parametrize("name,kw,sparse_grads", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01), False),
    ("sgd", dict(learning_rate=0.1, momentum=0.9), True),
    ("adagrad", dict(learning_rate=0.5), True),
])
def test_set_optimizer_updates_on_push(name, kw, sparse_grads, tmp_path):
    """The optimizer runs inside the store at each push, dense or
    row_sparse (lazy); three pushes give the JAX package's weights. The
    states round-trip through save / load_optimizer_states."""
    rows = [[0, 2], [2, 5], [1, 2]]

    def grad(pkg, i):
        if not sparse_grads:
            return pkg.nd.array(_G[i])
        return pkg.nd.sparse.row_sparse_array((_G[i][rows[i]], rows[i]),
                                              shape=_W.shape)

    def run(pkg):
        kv = pkg.kv.create("local")
        kv.init(3, pkg.nd.array(_W))
        kv.set_optimizer(pkg.optimizer.create(name, **kw))
        for i in range(3):
            kv.push(3, grad(pkg, i))
        out = pkg.nd.zeros(_W.shape)
        kv.pull(3, out=out)
        return {"w": _np(out)}

    got = _both(run)
    if sparse_grads:
        np.testing.assert_array_equal(got["w"][[3, 4]], _W[[3, 4]])
    stores = []
    for _ in range(2):
        kv = mx.kv.create("local")
        kv.init(3, mx.nd.array(_W))
        kv.set_optimizer(mx.optimizer.create(name, **kw))
        stores.append(kv)
    stores[0].push(3, grad(mx, 0))
    path = str(tmp_path / "states")
    stores[0].save_optimizer_states(path)
    stores[0].pull(3, out=stores[1]._store[3])
    stores[1].load_optimizer_states(path)
    outs = []
    for kv in stores:
        kv.push(3, grad(mx, 1))
        outs.append(mx.nd.zeros(_W.shape))
        kv.pull(3, out=outs[-1])
    np.testing.assert_array_equal(_np(outs[1]), _np(outs[0]))


def test_gradient_compression_matches_jax():
    """2-bit compression with error feedback over four pushes of two
    values each (a residual a key and device): the stored sums equal the
    JAX package's, and the quantized values lie in {-t, 0, t}."""
    def run(pkg):
        kv = pkg.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.3})
        kv.init("g", pkg.nd.zeros(_W.shape))
        outs = {}
        for i in range(4):
            kv.push("g", [pkg.nd.array(_G[i]),
                          pkg.nd.array(_G[(i + 1) % 4])])
            out = pkg.nd.zeros(_W.shape)
            kv.pull("g", out=out)
            outs["push%d" % i] = _np(out)
        return outs

    got = _both(run)
    for v in got.values():
        assert {round(float(x), 6) for x in np.unique(v)} \
            <= {-0.6, -0.3, 0.0, 0.3, 0.6}
    gc = GradientCompression(threshold=0.3)
    q = gc.quantize("k", mx.nd.array(_G[0]))
    np.testing.assert_allclose(_np(q) + gc._residual["k"].numpy(), _G[0],
                               rtol=0, atol=1e-7)
    gc.reset("k")
    assert not gc._residual
    assert gc.get_params() == {"type": "2bit", "threshold": 0.3}
    with pytest.raises(MXNetError, match="2bit"):
        GradientCompression(type="1bit")
    with pytest.raises(MXNetError, match="threshold"):
        GradientCompression(threshold=0)


def test_create_names_and_single_process_info():
    for name in ("local", "device", "nccl", "local_allreduce_cpu",
                 "local_update_cpu", "local_allreduce_device", "LOCAL"):
        kv = mx.kv.create(name)
        assert isinstance(kv, mx.kvstore.KVStore)
        assert kv.type == name.lower() and kv.rank == 0 \
            and kv.num_workers == 1
    for name in ("dist_sync", "dist_device_sync", "dist_sync_device",
                 "horovod", "tpu"):
        # one process: the distributed store is rank 0 of 1, as the JAX
        # package's
        kv, jkv = mx.kv.create(name), jmx.kv.create(name)
        assert isinstance(kv, mx.kvstore._DistKVStore)
        assert (kv.type, kv.rank, kv.num_workers) == \
            (jkv.type, jkv.rank, jkv.num_workers) == (name, 0, 1)
    with pytest.raises(MXNetError, match="dist_async is not supported"):
        mx.kv.create("dist_async")
    with pytest.raises(MXNetError, match="unknown kvstore"):
        mx.kv.create("bogus")
    with pytest.raises(MXNetError, match="must be str"):
        mx.kv.create(3)


def test_trainer_accepts_compression_params_on_one_device():
    """As the JAX Trainer: on one device the kvstore and its compression
    are unused, and the step is the plain update."""
    def run(pkg, kvstore="local"):
        net = pkg.gluon.nn.Dense(2, in_units=3)
        net.initialize(ctx=pkg.cpu())
        net.weight.set_data(pkg.nd.array(_W[:2]))
        net.bias.set_data(pkg.nd.zeros((2,)))
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=kvstore,
                               compression_params={"type": "2bit",
                                                   "threshold": 0.5})
        with pkg.autograd.record():
            loss = net(pkg.nd.array(_G[0][:4])).sum()
        loss.backward()
        tr.step(4)
        return {"w": _np(net.weight.data())}

    _both(run)
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    mx.gluon.Trainer(net.collect_params(), "sgd",
                     kvstore=mx.kv.create("local"))
    # a dist store in one process (rank 0 of 1) takes the gradients
    # through the store, 2-bit compressed, in both packages
    _both(lambda pkg: run(pkg, "dist_sync"))
