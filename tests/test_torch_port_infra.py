"""The small top-level modules of the PyTorch port against the JAX
package's, on the CPU: ``engine``, ``registry``, ``runtime`` (the feature
list and the bounded device dial), ``util``, ``misc``, ``ndarray_doc`` /
``symbol_doc``, ``test_utils`` and ``notebook``; each module's public
names, and the messages of the "not ported" notes this slice made false.

Values that do not depend on the backend are held equal (the legacy
schedulers, the doc layouts, the registries' lookups, the seeded random
data of `test_utils`); the oracles of `test_utils` agree within the JAX
package's tolerances (`_DTYPE_TOL`: rtol 1e-4 / atol 1e-5 in float32);
the feature list differs only where the port answers for itself (``PALLAS``
off, ``NATIVE_IO`` off until the C library is ported, and the
reference's ``CUDA`` / ``CUDNN`` / ``NCCL`` / ``CUDA_RTC`` as the host's
torch has them).
"""
import os
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.notebook.callback as jcallback
import mxnet_tpu.subgraph  # noqa: F401  (not among the JAX package's imports)
from mxnet_tpu import test_utils as jtu
from mxnet_tpu.base import MXNetError as JMXNetError

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine, registry, runtime, telemetry
from mxnet_tpu_torch import test_utils as tu
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.notebook import callback as tcallback


@pytest.fixture(autouse=True)
def cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _public(mod):
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and getattr(v, "__module__", None) == mod.__name__}


# names the port adds beside the JAX package's
_EXTRA = {"engine": {"op_done"}, "runtime": {"is_enabled"}}


@pytest.mark.parametrize("name", [
    "engine", "registry", "runtime", "util", "misc", "ndarray_doc",
    "symbol_doc", "test_utils", "operator", "subgraph", "notebook.callback",
    "contrib.onnx", "contrib.onnx_proto"])
def test_public_names_are_the_jax_packages(name):
    import importlib

    jmod = importlib.import_module("mxnet_tpu." + name)
    tmod = importlib.import_module("mxnet_tpu_torch." + name)
    assert _public(tmod) - _EXTRA.get(name, set()) == _public(jmod)
    top = name.split(".")[0]
    assert getattr(mx, top) is importlib.import_module(
        "mxnet_tpu_torch." + top)
    assert top in mx.__all__ or top == "contrib"


def test_not_ported_notes_are_gone():
    assert "not ported" not in runtime.__doc__
    assert "not ``onnx``" not in mx.__doc__
    for name in ("operator", "subgraph", "engine", "registry", "onnx",
                 "test_utils", "notebook"):
        assert name in mx.__doc__, name
    with pytest.raises(MXNetError) as e:
        mx.autograd.get_symbol(mx.nd.ones((1,)))
    with pytest.raises(JMXNetError) as je:
        jmx.autograd.get_symbol(jmx.nd.ones((1,)))
    assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def test_naive_mode_from_env_and_scope(monkeypatch):
    for m in (engine, jmx.engine):
        monkeypatch.delenv("MXNET_ENGINE_TYPE", raising=False)
        assert not m.is_naive()
        monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
        assert m.is_naive()
        with m.naive_engine(False):
            assert not m.is_naive()
            with m.naive_engine():
                assert m.is_naive()
            assert not m.is_naive()
        assert m.is_naive()
    monkeypatch.delenv("MXNET_ENGINE_TYPE")
    seen = []
    t = threading.Thread(target=lambda: seen.append(engine.is_naive()))
    with engine.naive_engine():
        t.start()
        t.join()
    assert seen == [False]   # the scope is the calling thread's


def test_bulk_size_values_match_jax():
    got = []
    for m in (jmx.engine, engine):
        vals = [m.set_bulk_size(4), m.set_bulk_size(8)]
        with m.bulk(2):
            vals.append(m.set_bulk_size(2))
        vals.append(m.set_bulk_size(15))
        got.append(vals)
    assert got[1] == got[0] == [15, 4, 2, 8]


def test_op_done_synchronizes_only_a_card_in_naive_mode(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    card = torch.device("cuda", 0)
    engine.op_done(card)
    engine.op_done(torch.device("cpu"))
    with engine.naive_engine():
        engine.op_done(torch.device("cpu"))
        engine.op_done(card)
        engine.op_done(None)
    assert calls == [card]


def test_every_op_dispatch_reaches_op_done(monkeypatch):
    """`ndarray.invoke` and the symbol interpreter call `op_done` once an
    op, on the op's device."""
    seen = []
    monkeypatch.setattr(engine, "op_done", seen.append)
    x = mx.nd.array([1.0, 4.0])
    (x + 1).sqrt()
    assert seen == [torch.device("cpu")] * 2
    seen.clear()
    s = mx.sym.sqrt(mx.sym.var("a") + 1)
    s.eval(a=x)
    assert seen == [torch.device("cpu")] * 2


def test_wait_all_without_a_card():
    engine.wait_all()
    mx.nd.waitall()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _registry_run(reg_mod, err):
    class Base:
        def __init__(self, x=1):
            self.x = x

    reg = reg_mod.get_register_func(Base, "thing")
    alias = reg_mod.get_alias_func(Base, "thing")
    create = reg_mod.get_create_func(Base, "thing")

    @alias("myalias")
    class Impl(Base):
        pass

    reg(Impl)
    inst = Impl()
    out = [type(create("impl")).__name__, create("myalias", x=5).x,
           create(("impl", {"x": 3})).x, create('["impl", {"x": 4}]').x,
           create('{"name": "impl", "params": {"x": 6}}').x,
           create(thing="impl", x=7).x, create(inst) is inst,
           sorted(reg_mod.get_registry(Base))]
    for bad in (lambda: reg(int), lambda: create(inst, 1),
                lambda: create(3), lambda: create("nope")):
        with pytest.raises(err) as e:
            bad()
        out.append(str(e.value).replace("mxnet_tpu_torch", "mxnet_tpu"))
    return out


def test_registry_module_matches_jax():
    assert _registry_run(registry, MXNetError) == \
        _registry_run(jmx.registry, JMXNetError)


@pytest.fixture
def fresh_stores(monkeypatch):
    """The subsystems' stores and the registry's cache, restored after."""
    for mod in (mx.optimizer, mx.metric, mx.initializer):
        monkeypatch.setattr(mod, "_REGISTRY", dict(mod._REGISTRY))
    monkeypatch.setattr(registry, "_REGISTRY", {})


def test_registry_shares_subsystem_storage(fresh_stores):
    create = registry.get_create_func(mx.optimizer.Optimizer, "optimizer")
    o = create("adam", learning_rate=1e-3)
    assert type(o).__name__ == "Adam" and o.lr == 1e-3
    assert type(create(optimizer="sgd", learning_rate=0.5)).__name__ == "SGD"
    assert registry.get_registry(mx.optimizer.Optimizer) == \
        mx.optimizer._REGISTRY
    assert sorted(registry.get_registry(mx.optimizer.Optimizer)) == sorted(
        jmx.registry.get_registry(jmx.optimizer.Optimizer))
    init = registry.get_create_func(mx.initializer.Initializer,
                                    "initializer")
    assert type(init("xavier")).__name__ == "Xavier"

    @registry.get_register_func(mx.optimizer.Optimizer, "optimizer")
    class MyOpt(mx.optimizer.SGD):
        pass

    assert isinstance(mx.optimizer.create("myopt"), MyOpt)


def test_registry_third_party_isolation(fresh_stores):
    class MyBase:
        pass

    create = registry.get_create_func(MyBase, "optimizer")
    with pytest.raises(MXNetError, match="Cannot find"):
        create("adam")
    reg = registry.get_register_func(MyBase, "optimizer")

    class Thing(MyBase):
        pass

    reg(Thing)
    assert isinstance(create("thing"), Thing)
    assert "thing" not in registry.get_registry(mx.optimizer.Optimizer)
    assert isinstance(mx.optimizer.create("adam"), mx.optimizer.Adam)


def test_get_registry_does_not_poison(fresh_stores):
    assert "accuracy" in registry.get_registry(mx.metric.EvalMetric)
    reg = registry.get_register_func(mx.metric.EvalMetric, "metric")

    class _ProbeMetric(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("probe")

    reg(_ProbeMetric, "probe_metric_xyz")
    assert "probe_metric_xyz" in registry.get_registry(mx.metric.EvalMetric)
    assert isinstance(mx.metric.create("probe_metric_xyz"), _ProbeMetric)

    class Unknown:
        pass

    assert registry.get_registry(Unknown) == {}
    assert Unknown not in registry._REGISTRY


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

_PORT_ANSWERS = {"PALLAS": False, "NATIVE_IO": False}


def test_features_match_jax_where_they_mean_the_same():
    feats, jfeats = runtime.Features(), jmx.runtime.Features()
    assert list(feats)[:len(jfeats)] == list(jfeats)
    for name, f in jfeats.items():
        want = _PORT_ANSWERS.get(name, f.enabled)
        assert feats[name] == runtime.Feature(name, want), name
    cuda = torch.cuda.is_available()
    assert not feats.is_enabled("tpu")
    assert feats.is_enabled("GPU") is cuda
    for name in ("CUDA", "CUDNN", "NCCL", "CUDA_RTC"):
        assert feats[name].enabled is (cuda and feats[name].enabled), name
    assert runtime.is_enabled("cpu")
    assert [f.name for f in runtime.feature_list()] == list(feats)
    with pytest.raises(RuntimeError, match="unknown"):
        feats.is_enabled("NOPE")
    assert repr(feats).startswith("[✖ TPU, ")


@pytest.fixture
def dial_state(monkeypatch):
    """A fresh dial slot and the flight recorder on; returns the dial
    events recorded since."""
    monkeypatch.setattr(runtime, "_DIAL_THREAD", [])
    monkeypatch.setattr(telemetry.core._STATE, "enabled", True)
    start = len(telemetry.events())

    def dial_events():
        return [(e["event"], e["fields"]) for e in telemetry.events()[start:]
                if e["event"].startswith("pjrt_dial")]

    return dial_events


def test_dial_on_the_host(dial_state, tmp_path, monkeypatch):
    cache = str(tmp_path / "topo.json")
    monkeypatch.setenv("MXTPU_TOPOLOGY_CACHE", cache)
    devs = runtime.dial_devices(timeout_s=30)
    assert devs == [torch.device("cpu")]
    kinds = [k for k, _ in dial_state()]
    assert kinds == ["pjrt_dial_start", "pjrt_dial_ok"]
    assert dial_state()[1][1]["platform"] == "cpu"
    assert not os.path.exists(cache)    # a host dial writes no cache
    assert runtime.cached_topology() is None


def test_dial_of_a_card_writes_the_cache(dial_state, tmp_path, monkeypatch):
    cache = str(tmp_path / "topo.json")
    monkeypatch.setenv("MXTPU_TOPOLOGY_CACHE", cache)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(runtime, "_enumerate", lambda: list(cards))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert runtime.dial_devices(timeout_s=30) == cards
    topo = runtime.cached_topology()
    assert topo["platform"] == "gpu" and topo["device_count"] == 2
    assert topo["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert runtime.cached_topology(cache) == topo
    assert dial_state()[-1][1]["device_count"] == 2


def test_dial_timeout_parks_the_thread_and_reuses_it(dial_state, tmp_path,
                                                     monkeypatch):
    cache = str(tmp_path / "topo.json")
    with open(cache, "w") as f:
        f.write('{"platform": "gpu", "device_kind": "H100", '
                '"device_count": 1}')
    monkeypatch.setenv("MXTPU_TOPOLOGY_CACHE", cache)
    gate, entered = threading.Event(), []

    def blocked():
        entered.append(1)
        gate.wait(30)
        return [torch.device("cpu")]

    monkeypatch.setattr(runtime, "_enumerate", blocked)
    for _ in range(2):
        with pytest.raises(MXNetError, match="still blocked.*H100"):
            runtime.dial_devices(timeout_s=0.05)
    assert entered == [1]                 # the second call waited on it
    gate.set()
    assert runtime.dial_devices(timeout_s=30) == [torch.device("cpu")]
    kinds = [k for k, _ in dial_state()]
    assert kinds == ["pjrt_dial_start", "pjrt_dial_timeout"] * 2 + [
        "pjrt_dial_start", "pjrt_dial_ok"]


def test_dial_error_is_redialed(dial_state, monkeypatch):
    tries = []

    def broken():
        tries.append(1)
        if len(tries) == 1:
            raise RuntimeError("driver gone")
        return [torch.device("cpu")]

    monkeypatch.setattr(runtime, "_enumerate", broken)
    with pytest.raises(MXNetError, match="driver gone"):
        runtime.dial_devices(timeout_s=30)
    assert runtime.dial_devices(timeout_s=30) == [torch.device("cpu")]
    assert [k for k, _ in dial_state()] == [
        "pjrt_dial_start", "pjrt_dial_error", "pjrt_dial_start",
        "pjrt_dial_ok"]


# ---------------------------------------------------------------------------
# util, misc, the doc modules
# ---------------------------------------------------------------------------

def test_util_matches_jax(tmp_path):
    assert mx.util.get_gpu_count() == torch.cuda.device_count() == \
        jmx.util.get_gpu_count()
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            mx.util.get_gpu_memory(0)
    d = str(tmp_path / "a" / "b")
    mx.util.makedirs(d)
    mx.util.makedirs(d)
    assert os.path.isdir(d)


def test_legacy_schedulers_match_jax():
    for name, args in (("FactorScheduler", (3, 0.5)),
                       ("MultiFactorScheduler", ([2, 5, 9], 0.1))):
        t, j = getattr(mx.misc, name)(*args), getattr(jmx.misc, name)(*args)
        t.base_lr = j.base_lr = 0.2
        assert [t(i) for i in range(12)] == [j(i) for i in range(12)]
    for bad in ((0,), (2, 1.5)):
        with pytest.raises(ValueError) as e:
            mx.misc.FactorScheduler(*bad)
        with pytest.raises(ValueError) as je:
            jmx.misc.FactorScheduler(*bad)
        assert str(e.value) == str(je.value)
    with pytest.raises(NotImplementedError):
        mx.misc.LearningRateScheduler()(0)


def test_doc_builders_match_jax():
    docs = []
    for m in (jmx, mx):
        class InteropDocOpDoc(m.ndarray_doc.NDArrayDoc):
            """Example: extra text."""

        class InteropDocOp2Doc(m.symbol_doc.SymbolDoc):
            """More text."""

        args = (["data", "k"], ["NDArray", "int"], ["input", ""])
        docs.append([m.ndarray_doc._build_doc("InteropDocOp", "Desc.", *args),
                     m.symbol_doc._build_doc("InteropDocOp2", "Desc.", *args),
                     m.ndarray_doc._build_doc("Other", "D.", [], [], [])])
    assert docs[1] == docs[0]
    assert docs[1][0].endswith("Example: extra text.")
    with mx.name.NameManager():
        fc = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=5,
                                   name="fc")
    with jmx.name.NameManager():
        jfc = jmx.sym.FullyConnected(jmx.sym.var("data"), num_hidden=5,
                                     name="fc")
    assert mx.symbol_doc.SymbolDoc.get_output_shape(fc, data=(2, 3)) == \
        jmx.symbol_doc.SymbolDoc.get_output_shape(jfc, data=(2, 3)) == \
        {"fc_output": (2, 5)}


# ---------------------------------------------------------------------------
# test_utils
# ---------------------------------------------------------------------------

def test_comparisons_match_jax():
    a = np.array([1.0, 2.0, 0.0])
    for m in (tu, jtu):
        m.assert_almost_equal(a, a + 1e-9)
        assert m.almost_equal(a, a + 1e-9)
        assert not m.almost_equal(a, a + 1.0)
        assert m.same(a, a.copy()) and not m.same(a, a + 1)
    msgs = []
    for m in (tu, jtu):
        with pytest.raises(AssertionError) as e:
            m.assert_almost_equal(a, a + [0.0, 1.0, 0.0], names=("x", "y"))
        msgs.append(str(e.value))
        with pytest.raises(AssertionError, match="shape mismatch"):
            m.assert_almost_equal(a, a[:2])
    assert msgs[0] == msgs[1]
    x = mx.nd.array([1, 2, 3])
    assert tu.same_array(x, x) and not tu.same_array(x, x.copy())
    assert tu.same_array(x, mx.nd.NDArray(x._data))


def _fc_tanh(m):
    with m.name.NameManager():
        out = m.sym.FullyConnected(data=m.sym.var("data"),
                                   weight=m.sym.var("w"), no_bias=True,
                                   num_hidden=3)
        return m.sym.tanh(out)


def test_numeric_gradient_oracle_matches_jax():
    rng = np.random.RandomState(42)
    loc = {"data": rng.uniform(-1, 1, (2, 4)), "w": rng.uniform(-1, 1, (3, 4))}
    for m in (tu, jtu):
        m.check_numeric_gradient(_fc_tanh(mx if m is tu else jmx), loc,
                                 rtol=1e-2, atol=1e-2)
    f = (lambda v: [np.tanh(v["data"] @ v["w"].T)])
    g, jg = tu.numeric_grad(f, loc), jtu.numeric_grad(f, loc)
    for k in loc:
        np.testing.assert_array_equal(g[k], jg[k])
    # a coarse difference (eps 0.3) is not within 1e-9 of the gradient
    with pytest.raises(AssertionError):
        tu.check_numeric_gradient(_fc_tanh(mx), loc, rtol=1e-9,
                                  atol=1e-12, numeric_eps=0.3)


def test_symbolic_forward_backward_match_jax():
    loc = {"x": np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)}
    res = []
    for m, t in ((mx, tu), (jmx, jtu)):
        y = m.sym.square(m.sym.var("x"))
        fwd = t.check_symbolic_forward(y, loc, [loc["x"] ** 2])
        bwd = t.check_symbolic_backward(
            y, loc, [np.ones((2, 2), np.float32)], {"x": 2 * loc["x"]})
        res.append((fwd, bwd))
        with pytest.raises(AssertionError):
            t.check_symbolic_forward(y, loc, [loc["x"] ** 3])
    np.testing.assert_allclose(res[0][0][0], res[1][0][0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res[0][1]["x"], res[1][1]["x"], rtol=1e-4,
                               atol=1e-5)


def test_check_consistency_runs_naive_and_agrees_with_jax(monkeypatch):
    """Each dtype runs once with every op synchronized (naive) and once
    without; the float64 naive run is the reference, and it agrees with
    the JAX package's reference within its float32 tolerance."""
    loc = {"x": np.random.RandomState(0).uniform(0.5, 2, (3, 3))}
    modes = []
    real = engine.op_done
    monkeypatch.setattr(engine, "op_done",
                        lambda d: (modes.append(engine.is_naive()),
                                   real(d)))
    y = mx.sym.exp(mx.sym.var("x")) + mx.sym.sqrt(mx.sym.abs(mx.sym.var("x")))
    ref = tu.check_consistency(y, loc)
    assert modes == ([True] * 4 + [False] * 4) * 3
    assert ref[0].dtype == np.float64
    jy = jmx.sym.exp(jmx.sym.var("x")) + jmx.sym.sqrt(
        jmx.sym.abs(jmx.sym.var("x")))
    jref = jtu.check_consistency(jy, loc)
    tol = jtu._DTYPE_TOL[np.dtype(np.float32)]
    np.testing.assert_allclose(ref[0], jref[0], rtol=tol[0], atol=tol[1])
    assert tu._DTYPE_TOL == jtu._DTYPE_TOL
    with pytest.raises(AssertionError):
        tu.check_consistency(y, loc, tol=1e-12)


def test_random_helpers_match_jax():
    out = []
    for m, t in ((jmx, jtu), (mx, tu)):
        np.random.seed(3)
        arrs = [t.rand_ndarray((4, 5)), t.rand_ndarray((6, 3),
                                                       stype="row_sparse"),
                t.rand_ndarray((5, 4), stype="csr", density=0.5),
                t.rand_ndarray((3,), distribution="normal")]
        out.append(([(a.stype, a.shape) for a in arrs],
                    [a.asnumpy() for a in arrs],
                    [t.rand_shape_2d(), t.rand_shape_3d(),
                     tuple(t.rand_shape_nd(4))],
                    t.random_arrays((2, 3), ())))
    assert out[1][0] == out[0][0] and out[1][2] == out[0][2]
    for a, b in zip(out[1][1] + list(out[1][3]), out[0][1] + list(out[0][3])):
        np.testing.assert_array_equal(a, b)


def test_simple_forward_and_default_context(monkeypatch):
    x = np.array([1.0, 4.0], np.float32)
    got = tu.simple_forward(mx.sym.sqrt(mx.sym.var("a")), a=x)
    np.testing.assert_array_equal(got, jtu.simple_forward(
        jmx.sym.sqrt(jmx.sym.var("a")), a=x))
    assert tu.default_context() == mx.cpu()
    monkeypatch.setenv("MXNET_TEST_DEVICE", "cpu:1")
    assert tu.default_context() == mx.cpu(1)
    monkeypatch.setattr(tu, "_DEFAULT_CTX", [mx.cpu(0)])
    assert tu.default_context() == mx.cpu(0)
    tu.set_default_context(mx.cpu(1))
    assert tu.default_context() == mx.cpu(1)


def test_with_seed_reproduces_and_names_the_seed(capsys, monkeypatch):
    @tu.with_seed(7)
    def draw():
        return mx.nd.random_uniform(shape=(4,)).asnumpy(), np.random.rand()

    a, b = draw(), draw()
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]

    monkeypatch.setenv("MXNET_TEST_SEED", "1234")

    @tu.with_seed()
    def fails():
        raise ValueError("x")

    with pytest.raises(ValueError):
        fails()
    assert "MXNET_TEST_SEED=1234" in capsys.readouterr().out


def test_assert_exception_and_discard_stderr():
    tu.assert_exception(lambda: 1 / 0, ZeroDivisionError)
    with pytest.raises(AssertionError, match="did not raise"):
        tu.assert_exception(lambda: 1, ZeroDivisionError)
    r, w = os.pipe()
    saved = os.dup(2)
    try:
        os.dup2(w, 2)
        with tu.discard_stderr():
            os.write(2, b"hidden")
        os.write(2, b"shown")
    finally:
        os.dup2(saved, 2)
        os.close(saved)
        os.close(w)
    with os.fdopen(r, "rb") as f:
        assert f.read() == b"shown"


# ---------------------------------------------------------------------------
# notebook
# ---------------------------------------------------------------------------

def _logger_frames(m, cb, base_module):
    lg = cb.PandasLogger(batch_size=4, frequent=1)
    metric = m.metric.Accuracy()
    for nbatch in range(3):
        metric.update([m.nd.array([0.0, 1.0])],
                      [m.nd.array(np.array([[0.9, 0.1], [0.2, 0.8]],
                                           np.float32))])
        lg.train_cb(base_module.BatchEndParam(epoch=0, nbatch=nbatch,
                                              eval_metric=metric,
                                              locals=None))
    lg.eval_cb(base_module.BatchEndParam(epoch=0, nbatch=3,
                                         eval_metric=None, locals=None))
    lg.epoch_cb()
    return {k: (sorted(df.columns), len(df), list(df.get("accuracy", [])))
            for k, df in lg.all_dataframes.items()}, lg


def test_pandas_logger_frames_match_jax(monkeypatch):
    from mxnet_tpu.module import base_module as jbm
    from mxnet_tpu_torch.module import base_module as tbm

    frames, lg = _logger_frames(mx, tcallback, tbm)
    jframes, _ = _logger_frames(jmx, jcallback, jbm)
    assert frames == jframes
    assert frames["train"][1] == 3 and frames["epoch"][1] == 1
    assert set(lg.callback_args()) == {"batch_end_callback",
                                       "eval_end_callback",
                                       "epoch_end_callback"}
    with pytest.raises(ImportError, match="bokeh"):
        tcallback.LiveLearningCurve()
    with pytest.raises(ImportError, match="bokeh"):
        tcallback.LiveBokehChart()
    monkeypatch.setattr(tcallback, "pd", None)
    with pytest.raises(ImportError, match="pandas"):
        tcallback.PandasLogger(batch_size=1)

