"""The port's input pipeline against the JAX package's, on the CPU: the
prefetch core (`data.PrefetchBuffer`, `data.DecodePool`), the device
prefetcher's CPU path, sharded record streams and their cursor, the file
iterators of `io` (``CSVIter``, ``LibSVMIter``, ``MNISTIter``,
``PrefetchingIter``), the ``MXTPU_DATA_*`` / ``MXTPU_DATALOADER_*``
variables, and the two places the prefetcher is wired in
(``MXTPU_DATA_PREFETCH`` in `Module.fit`, `DistributedTrainer.prefetch`).

Every value compared with the JAX package is exact: both sides read the
same files into float32 numpy and copy. Threads: each test that starts a
pipeline holds that no ``mxtpu-`` thread it started outlives its close or
reset; the
waits are bounded (``MXTPU_DATA_JOIN_TIMEOUT_S``, queue timeouts).
"""
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import env as jenv
from mxnet_tpu.data import ShardedRecordStream as JStream
from mxnet_tpu.data import StreamDataIter as JStreamIter

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import env as tenv
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.data import (DecodePool, DevicePrefetcher,
                                  PrefetchBuffer, ShardedRecordStream,
                                  StreamDataIter, place_batch)


@pytest.fixture
def cpu():
    with tmx.context.scope(tmx.cpu()):
        yield


_BEFORE = set()


@pytest.fixture(autouse=True)
def _threads_before():
    """Threads alive before the test: another test file's run in this
    process may have left its own (serving batchers, JAX pipelines)."""
    _BEFORE.clear()
    _BEFORE.update(threading.enumerate())


def _live():
    """Names of the ``mxtpu-`` threads this test started that are alive."""
    return [t.name for t in threading.enumerate()
            if t.name.startswith("mxtpu-") and t not in _BEFORE]


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


# ---------------------------------------------------------------------------
# the core
# ---------------------------------------------------------------------------

def test_prefetch_buffer_order_end_errors_and_counters():
    it = iter(range(7))
    buf = PrefetchBuffer(lambda: next(it), depth=3, src="t_order")
    assert [buf.get() for _ in range(7)] == list(range(7))
    with pytest.raises(StopIteration):
        buf.get()
    with pytest.raises(StopIteration):   # stays ended
        buf.get()
    buf.close()
    snap = telemetry.snapshot()
    hits = snap['mxtpu_data_prefetch_hits_total{src="t_order"}']["value"]
    misses = snap['mxtpu_data_prefetch_misses_total{src="t_order"}'][
        "value"]
    assert hits + misses == 8

    def boom():
        raise ValueError("bad record")

    buf = PrefetchBuffer(boom)
    with pytest.raises(ValueError, match="bad record"):
        buf.get()
    buf.close()
    endless = PrefetchBuffer(lambda: 1)
    with pytest.raises(MXNetError, match="before close"):
        endless.restart()
    endless.close()
    assert "mxtpu-data-prefetch" not in _live()


def test_prefetch_buffer_close_joins_and_a_stale_worker_feeds_nothing(
        monkeypatch):
    """A producer stuck past the join timeout makes close() raise; once it
    wakes it puts into its own (dead) generation's queue, never the next
    one's."""
    monkeypatch.setenv("MXTPU_DATA_JOIN_TIMEOUT_S", "0.2")
    gate = threading.Event()
    calls = []

    def produce():
        calls.append(1)
        if len(calls) == 1:
            gate.wait(10)
            return "stale"
        return "fresh"

    buf = PrefetchBuffer(produce, depth=1, name="mxtpu-test-stale")
    time.sleep(0.05)
    with pytest.raises(MXNetError, match="did not stop"):
        buf.close()
    buf._thread = None
    buf.restart()
    gate.set()
    assert [buf.get() for _ in range(3)] == ["fresh"] * 3
    buf.close()
    deadline = time.monotonic() + 5
    while "mxtpu-test-stale" in _live() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert "mxtpu-test-stale" not in _live()


def test_decode_pool_keeps_source_order_under_contention():
    """16 workers, a shortened switch interval and random decode delays:
    delivery is the source order, errors surface at their position."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        rng = np.random.RandomState(0)
        delays = rng.uniform(0, 2e-3, 200)
        src = iter(range(200))

        def decode(i):
            time.sleep(delays[i])
            if i == 150:
                raise KeyError("record 150")
            return i * i

        pool = DecodePool(lambda: next(src), decode, workers=16, depth=4)
        got = [pool.get() for _ in range(150)]
        assert got == [i * i for i in range(150)]
        with pytest.raises(KeyError, match="record 150"):
            pool.get()
        pool.close()
    finally:
        sys.setswitchinterval(old)
    assert not [n for n in _live() if n.startswith("mxtpu-data-")]


def test_decode_pool_end_and_reset():
    items = list(range(5))
    pos = [0]

    def source():
        if pos[0] >= len(items):
            raise StopIteration
        pos[0] += 1
        return items[pos[0] - 1]

    pool = DecodePool(source, lambda r: -r, workers=3)
    assert [pool.get() for _ in range(5)] == [0, -1, -2, -3, -4]
    with pytest.raises(StopIteration):
        pool.get()
    pool.reset()
    pos[0] = 0
    assert pool.get() == 0   # a fresh generation over the rewound source
    pool.close()
    assert not [n for n in _live() if n.startswith("mxtpu-data-")]


# ---------------------------------------------------------------------------
# the device prefetcher's CPU path
# ---------------------------------------------------------------------------

class _Overwriting:
    def __init__(self, n):
        self.i = 0
        self.n = n
        self.buf = np.zeros((4, 3), np.float32)
        self.batch_size = 4

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= self.n:
            raise StopIteration
        self.buf[...] = self.i
        self.i += 1
        return {"x": self.buf, "y": [tmx.nd.array(self.buf[:, 0] * 2,
                                                  ctx="cpu")]}

    def reset(self):
        self.i = 0


def test_device_prefetcher_on_the_cpu_copies_each_batch(cpu):
    pf = DevicePrefetcher(_Overwriting(6), depth=2)
    got = list(pf)
    assert len(got) == 6
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor)
        assert isinstance(b["y"][0], tmx.nd.NDArray)
        np.testing.assert_array_equal(b["x"].numpy(), np.full((4, 3), i))
        np.testing.assert_array_equal(b["y"][0].asnumpy(),
                                      np.full(4, 2.0 * i))
    pf.reset()
    assert next(pf)["x"][0, 0].item() == 0
    pf.close()
    assert "mxtpu-data-device-prefetch" not in _live()
    placed = place_batch(tmx.io.DataBatch(data=[np.ones(3)], label=None,
                                          pad=1), mesh="cpu")
    assert placed.pad == 1 and placed.data[0].device.type == "cpu"
    with pytest.raises(MXNetError, match="mesh of 2"):
        DevicePrefetcher(iter([]), mesh=["cpu", "cpu"])
    with pytest.raises(MXNetError, match="no CUDA device"):
        with tmx.context.scope("cuda"):
            DevicePrefetcher(iter([]))


# ---------------------------------------------------------------------------
# sharded streams
# ---------------------------------------------------------------------------

def _shards(tmp_path, nfiles=3, per=7):
    files = []
    for f in range(nfiles):
        prefix = str(tmp_path / ("s%d" % f))
        w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
        for k in range(per):
            vec = np.full(4, f * 100 + k, np.float32)
            w.write_idx(k, trec.pack(trec.IRHeader(0, float(f * 100 + k), k,
                                                   0), vec.tobytes()))
        w.close()
        files.append(prefix + ".rec")
    return files


def _decode(rec):
    h, s = trec.unpack(rec)
    return np.frombuffer(s, np.float32).copy(), np.float32(h.label)


@pytest.mark.parametrize("world", [1, 2, 5])
def test_sharded_stream_order_and_resume_match_jax(tmp_path, world):
    files = _shards(tmp_path)
    for rank in range(world):
        t = ShardedRecordStream(files, rank, world, shuffle=True, seed=4)
        j = JStream(files, rank, world, shuffle=True, seed=4)
        for epoch in range(2):
            tr = [t.next_record() for _ in range(len(t))]
            jr = [j.next_record() for _ in range(len(j))]
            assert tr == jr
            with pytest.raises(StopIteration):
                t.next_record()
            t.advance_epoch()
            j.advance_epoch()
        st = t.state()
        assert st == j.state()
        mid = len(t) // 2
        for _ in range(mid):
            t.next_record()
        cursor = t.state()
        rest = [t.next_record() for _ in range(len(t) - mid)]
        t2 = ShardedRecordStream(files, rank, world, shuffle=True, seed=4)
        t2.set_state(cursor)
        assert [t2.next_record() for _ in range(len(t2) - mid)] == rest
        with pytest.raises(MXNetError, match="seed"):
            ShardedRecordStream(files, rank, world, shuffle=True,
                                seed=5).set_state(cursor)
        t.close()
        t2.close()
        j.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_stream_data_iter_matches_jax(tmp_path, cpu, workers):
    files = _shards(tmp_path, nfiles=2, per=5)
    t = StreamDataIter(ShardedRecordStream(files, shuffle=True, seed=1), 4,
                       _decode, (4,), workers=workers)
    j = JStreamIter(JStream(files, shuffle=True, seed=1), 4, _decode, (4,),
                    workers=workers)
    for epoch in range(2):
        t.reset()
        j.reset()
        tb, jb = list(t), list(j)
        assert [b.pad for b in tb] == [b.pad for b in jb] == [0, 0, 2]
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
        assert t.state() == j.state()
    t.close()
    j.close()
    assert not [n for n in _live() if n.startswith("mxtpu-data-")]


def test_device_prefetcher_cursor_is_what_the_consumer_saw(tmp_path, cpu):
    files = _shards(tmp_path, nfiles=1, per=12)
    inner = StreamDataIter(ShardedRecordStream(files), 2, _decode, (4,))
    pf = DevicePrefetcher(inner, depth=3)
    first = next(pf)
    time.sleep(0.05)   # the producer reads ahead meanwhile
    assert pf.state()["pos"] == 2
    second = next(pf)
    assert pf.state()["pos"] == 4
    np.testing.assert_array_equal(second.label[0].asnumpy(), [2, 3])
    st = pf.state()
    pf.set_state(st)
    np.testing.assert_array_equal(next(pf).label[0].asnumpy(), [4, 5])
    pf.close()
    assert first.data[0].shape == (2, 4)


# ---------------------------------------------------------------------------
# the io iterators
# ---------------------------------------------------------------------------

def _same_batches(t_it, j_it):
    tb, jb = list(t_it), list(j_it)
    assert len(tb) == len(jb) and len(tb) > 0
    for a, b in zip(tb, jb):
        assert a.pad == b.pad
        for x, y in zip(a.data + (a.label or []), b.data + (b.label or [])):
            np.testing.assert_array_equal(_np(x), _np(y))


def test_csv_and_libsvm_iters_match_jax(tmp_path, cpu):
    rng = np.random.RandomState(2)
    data = rng.rand(11, 6).astype(np.float32)
    label = rng.randint(0, 3, (11, 1)).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "l.csv"), batch_size=4)
    for round_batch in (True, False):
        _same_batches(tmx.io.CSVIter(round_batch=round_batch, **kw),
                      jmx.io.CSVIter(round_batch=round_batch, **kw))
    it = tmx.io.CSVIter(**kw)
    first = _np(it.next().data[0])
    it.reset()
    np.testing.assert_array_equal(_np(it.next().data[0]), first)
    with (tmp_path / "d.svm").open("w") as f:
        for i in range(9):
            cols = rng.choice(8, 3, replace=False)
            f.write("%d %s\n" % (i % 2, " ".join(
                "%d:%.4f" % (c, rng.rand()) for c in sorted(cols))))
    kw = dict(data_libsvm=str(tmp_path / "d.svm"), data_shape=(8,),
              batch_size=4)
    _same_batches(tmx.io.LibSVMIter(**kw), jmx.io.LibSVMIter(**kw))
    with pytest.raises(MXNetError, match="nope.csv"):
        tmx.io.CSVIter(data_csv=str(tmp_path / "nope.csv"), data_shape=(1,))
    with pytest.raises(MXNetError, match="nope.svm"):
        tmx.io.LibSVMIter(data_libsvm=str(tmp_path / "nope.svm"),
                          data_shape=(1,))


def _idx_files(tmp_path, n=13, gz=False):
    import gzip

    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (n, 5, 6)).astype(np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with op(str(tmp_path / ("img" + suffix)), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 5, 6) + img.tobytes())
    with op(str(tmp_path / ("lab" + suffix)), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())
    return str(tmp_path / "img"), str(tmp_path / "lab")


@pytest.mark.parametrize("flat,gz", [(False, False), (True, True)])
def test_mnist_iter_matches_jax(tmp_path, cpu, flat, gz):
    image, label = _idx_files(tmp_path, gz=gz)
    kw = dict(image=image, label=label, batch_size=5, flat=flat)
    np.random.seed(7)
    j = jmx.io.MNISTIter(**kw)
    np.random.seed(7)
    t = tmx.io.MNISTIter(**kw)
    assert t.provide_data[0].shape == j.provide_data[0].shape
    _same_batches(t, j)
    with pytest.raises(MXNetError, match="nope"):
        tmx.io.MNISTIter(image=str(tmp_path / "nope"), label=label)


def test_prefetching_iter_matches_jax(cpu):
    rng = np.random.RandomState(4)
    x, y = rng.rand(10, 3).astype(np.float32), np.arange(10.0)
    z = rng.rand(10, 2).astype(np.float32)
    t = tmx.io.PrefetchingIter(
        [tmx.io.NDArrayIter(x, y, batch_size=4),
         tmx.io.NDArrayIter(z, batch_size=4, data_name="z")],
        rename_data=[{"data": "a"}, {"z": "b"}])
    j = jmx.io.PrefetchingIter(
        [jmx.io.NDArrayIter(x, y, batch_size=4),
         jmx.io.NDArrayIter(z, batch_size=4, data_name="z")],
        rename_data=[{"data": "a"}, {"z": "b"}])
    assert [d.name for d in t.provide_data] == ["a", "b"]
    assert [d.name for d in t.provide_data] == [d.name for d in
                                                j.provide_data]
    for _ in range(2):
        _same_batches(t, j)
        t.reset()
        j.reset()
    t.close()
    j._buf.close()   # the JAX iterator has no close()
    assert "mxtpu-io-prefetch" not in _live()
    with pytest.raises(MXNetError, match="next"):
        t.iter_next()


def test_image_pipeline_threads_stop_at_close_and_reset(tmp_path, cpu):
    prefix = str(tmp_path / "im")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(5)
    for i in range(9):
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i), i, 0),
                                     rng.randint(0, 256, (12, 14, 3)),
                                     img_fmt=".png"))
    w.close()
    it = tmx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                data_shape=(3, 8, 8), batch_size=2,
                                preprocess_threads=3)
    it.next()
    assert _live()
    it.reset()
    assert _live() == []
    assert it.next().label[0].asnumpy().tolist() == [0.0, 1.0]
    it.close()
    assert _live() == []


# ---------------------------------------------------------------------------
# variables and wiring
# ---------------------------------------------------------------------------

DATA_VARS = ["MXTPU_DATALOADER_CTX", "MXTPU_DATALOADER_TIMEOUT",
             "MXTPU_DATALOADER_PROBE_TIMEOUT", "MXTPU_DATA_PREFETCH",
             "MXTPU_DATA_PREFETCH_DEPTH", "MXTPU_DATA_JOIN_TIMEOUT_S"]


def test_data_variables_have_the_jax_names_and_defaults(monkeypatch):
    treg, jreg = tenv.registry(), jenv.registry()
    for name in DATA_VARS:
        assert treg[name].vtype == jreg[name].vtype, name
        assert treg[name].default == jreg[name].default, name
        assert tenv.get(name) == jenv.get(name), name
    for value, want in (("1", True), ("0", False), ("off", False),
                        ("yes", True)):
        monkeypatch.setenv("MXTPU_DATA_PREFETCH", value)
        assert tenv.get("MXTPU_DATA_PREFETCH") is want
        assert jenv.get("MXTPU_DATA_PREFETCH") is want


def _mlp(m):
    with m.name.NameManager():
        net = m.sym.FullyConnected(m.sym.var("data"), num_hidden=8,
                                   name="fc1")
        net = m.sym.Activation(net, act_type="relu")
        net = m.sym.FullyConnected(net, num_hidden=3, name="fc2")
        return m.sym.SoftmaxOutput(net, name="softmax")


def test_module_fit_with_the_prefetch_variable_trains_alike(monkeypatch,
                                                            cpu):
    rng = np.random.RandomState(6)
    x = rng.randn(12, 5).astype(np.float32)
    y = rng.randint(0, 3, 12).astype(np.float32)
    params = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("MXTPU_DATA_PREFETCH", flag)
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        tmx.random.seed(0)
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=2,
                initializer=tmx.init.Uniform(0.1),
                optimizer_params={"learning_rate": 0.1})
        params[flag] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    assert _live() == []
    for k in params["0"]:
        np.testing.assert_array_equal(params["1"][k], params["0"][k])


def test_distributed_trainer_prefetch_places_on_its_device():
    from mxnet_tpu_torch.gluon import nn as tnn
    from mxnet_tpu_torch.parallel import DistributedTrainer

    net = tnn.Dense(2, in_units=3)
    net.initialize(ctx=tmx.cpu())
    tr = DistributedTrainer(net, "sgd", {"learning_rate": 0.1})
    pf = tr.prefetch(iter([np.ones((2, 3), np.float32)]), depth=1)
    assert isinstance(pf, DevicePrefetcher)
    (x,) = list(pf)
    assert x.device.type == "cpu" and x.shape == (2, 3)
