"""The port's profiler (`mxnet_tpu_torch/profiler.py`) on the CPU: the cases
of tests/test_profiler.py run on the port (the dispatch hooks of ``mx.nd``,
`Executor.forward` / `backward` and `autograd.backward`, category gating,
``profile_sync``, `dump` / `dumps` and their reset, stable thread ids and
metadata, tools/trace_merge.py over the port's dumps); one sequence of nd,
executor and autograd calls giving the same event names, categories and
phases in both packages; a Gluon layer called through the façade as one
event; the always-on dispatch counter; no backward hook on a node recorded
without profiling; and `start_xla_trace` /
`stop_xla_trace` writing a torch.profiler chrome trace.
"""
import importlib.util
import json
import os
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import profiler as jprofiler

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, profiler
from mxnet_tpu_torch.telemetry import core as telemetry

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset(p):
    p._events.clear()
    p._aggregate.clear()
    p._tids.clear()


@pytest.fixture
def clean_profiler(tmp_path):
    """Fresh profiler state on the CPU, config and state restored
    afterwards."""
    saved = dict(profiler._config)
    _reset(profiler)
    profiler.set_config(filename=str(tmp_path / "trace.json"),
                        profile_all=False, profile_imperative=True,
                        profile_symbolic=True, aggregate_stats=True,
                        profile_sync=False)
    with mx.context.scope(mx.cpu()):
        yield profiler
    profiler.set_state("stop")
    profiler._config.update(saved)
    _reset(profiler)


def _event_names(p):
    with p._lock:
        return [e["name"] for e in p._events]


def test_timed_call_records_nd_ops(clean_profiler):
    p = clean_profiler
    p.set_state("run")
    x = mx.nd.array([1.0, 2.0, 3.0])
    _ = (x * 2).asnumpy()
    p.set_state("stop")
    names = _event_names(p)
    assert any("mul" in n for n in names), names
    cats = {e["name"]: e["cat"] for e in p._events if e.get("ph") == "X"}
    assert any(c == "imperative" for c in cats.values()), cats


def test_timed_call_records_executor_forward_and_backward(clean_profiler):
    p = clean_profiler
    data = mx.sym.var("data")
    w = mx.sym.var("w")
    out = mx.sym.FullyConnected(data=data, weight=w, no_bias=True,
                                num_hidden=2)
    args = {"data": mx.nd.array(np.ones((2, 3), np.float32)),
            "w": mx.nd.array(np.ones((2, 3), np.float32))}
    grads = {"w": mx.nd.zeros((2, 3))}
    exe = out.bind(mx.cpu(), args=args, args_grad=grads, grad_req="write")
    p.set_state("run")
    exe.forward(is_train=True)
    exe.backward()
    p.set_state("stop")
    names = _event_names(p)
    assert "ExecutorForward" in names, names
    assert "ExecutorBackward" in names, names
    cats = {e["name"]: e["cat"] for e in p._events if e.get("ph") == "X"}
    assert cats["ExecutorForward"] == "symbolic"
    assert cats["ExecutorBackward"] == "symbolic"


def test_timed_call_records_autograd_backward(clean_profiler):
    p = clean_profiler
    p.set_state("run")
    x = mx.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x).sum()
    y.backward()
    p.set_state("stop")
    names = _event_names(p)
    backward = [n for n in names if n.startswith("_backward_")]
    assert backward, names  # one _backward_<op> event a recorded op
    np.testing.assert_allclose(x.grad.asnumpy(), [2.0, 4.0, 6.0])


def test_category_gating_imperative_vs_symbolic(clean_profiler):
    p = clean_profiler
    # imperative off: eager nd ops are NOT recorded, symbolic still is
    p.set_config(profile_imperative=False, profile_symbolic=True)
    p.set_state("run")
    x = mx.nd.array([1.0, 2.0])
    _ = (x + 1).asnumpy()
    data = mx.sym.var("data")
    exe = (data * 2).bind(mx.cpu(), args={"data": x})
    exe.forward()
    p.set_state("stop")
    names = _event_names(p)
    assert not any("plus" in n or "add" in n for n in names), names
    assert "ExecutorForward" in names

    # symbolic off: the reverse
    p._events.clear()
    p.set_config(profile_imperative=True, profile_symbolic=False)
    p.set_state("run")
    _ = (x + 1).asnumpy()
    exe.forward()
    p.set_state("stop")
    names = _event_names(p)
    assert any("plus" in n or "add" in n for n in names), names
    assert "ExecutorForward" not in names

    # profile_all overrides gating
    p._events.clear()
    p.set_config(profile_all=True, profile_imperative=False,
                 profile_symbolic=False)
    p.set_state("run")
    _ = (x + 1).asnumpy()
    p.set_state("stop")
    assert _event_names(p), "profile_all must re-enable every category"


def test_profile_sync_blocks_on_results(clean_profiler, monkeypatch):
    p = clean_profiler
    blocked = []
    real = p._block_results
    monkeypatch.setattr(p, "_block_results",
                        lambda results: (blocked.append(True),
                                         real(results))[1])
    p.set_config(profile_sync=True)
    p.set_state("run")
    x = mx.nd.array([1.0, 2.0])
    _ = (x * 3).asnumpy()
    p.set_state("stop")
    assert blocked, "profile_sync=True must block on op results"
    # and with profile_sync off the block helper is not consulted
    blocked.clear()
    p.set_config(profile_sync=False)
    p.set_state("run")
    _ = (x * 3).asnumpy()
    p.set_state("stop")
    assert not blocked


def test_dump_finished_resets_aggregate(clean_profiler, tmp_path):
    p = clean_profiler
    p.set_state("run")
    x = mx.nd.array([1.0])
    _ = (x * 2).asnumpy()
    p.set_state("stop")
    assert len(p.dumps().splitlines()) > 1  # header + >=1 row
    p.dump(finished=True)
    # aggregate reset: only the header remains (dump-finished semantics)
    assert len(p.dumps().splitlines()) == 1
    # a second run accumulates ONLY its own rows
    p.set_state("run")
    _ = (x + 5).asnumpy()
    p.set_state("stop")
    rows = p.dumps().splitlines()[1:]
    assert rows and not any("mul" in r for r in rows), rows


def test_dump_finished_false_keeps_state(clean_profiler):
    p = clean_profiler
    p.set_state("run")
    x = mx.nd.array([1.0])
    _ = (x * 2).asnumpy()
    p.set_state("stop")
    p.dump(finished=False)
    assert len(p.dumps().splitlines()) > 1
    assert _event_names(p)


def test_stable_tids_and_thread_metadata(clean_profiler, tmp_path):
    p = clean_profiler
    p.set_state("run")

    def work():
        y = mx.nd.array([4.0, 5.0], ctx=mx.cpu())
        _ = (y * 2).asnumpy()

    work()
    t = threading.Thread(target=work, name="worker-thread")
    t.start()
    t.join()
    p.set_state("stop")
    p.dump(finished=False)
    data = json.load(open(p._config["filename"]))
    evs = data["traceEvents"]
    # process metadata labels the rank lane
    procs = [e for e in evs if e.get("ph") == "M"
             and e["name"] == "process_name"]
    assert procs and procs[0]["args"]["name"].startswith("rank 0")
    # each thread got a small stable tid + a thread_name metadata event
    tmeta = {e["tid"]: e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert "MainThread" in tmeta.values()
    assert "worker-thread" in tmeta.values()
    op_tids = {e["tid"] for e in evs if e.get("ph") == "X"}
    assert op_tids <= set(tmeta), (op_tids, tmeta)
    assert len(op_tids) == 2  # two threads -> two distinct lanes
    assert all(isinstance(t_, int) and 0 < t_ < 1000 for t_ in op_tids)


# --------------------------------------------------------------------------
# the same calls through both packages
# --------------------------------------------------------------------------

def _sequence(m, ctx):
    """nd ops, an executor's forward and backward, a recorded autograd
    backward, a scoped Task and a Marker."""
    x = m.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=ctx)
    _ = (m.nd.relu(x - 1.0) * 2).asnumpy()
    data, w = m.sym.var("data"), m.sym.var("w")
    out = m.sym.FullyConnected(data=data, weight=w, no_bias=True,
                               num_hidden=2)
    exe = out.bind(ctx, args={"data": x, "w": m.nd.ones((2, 3), ctx=ctx)},
                   args_grad={"w": m.nd.zeros((2, 3), ctx=ctx)})
    exe.forward(is_train=True)
    exe.backward()
    v = m.nd.array([1.0, 2.0, 3.0], ctx=ctx)
    v.attach_grad()
    with m.profiler.Task("step"):
        m.profiler.Marker("begin").mark()
        with m.autograd.record():
            y = (m.nd.exp(v) * v).sum()
        y.backward()


def _run(m, p, path):
    saved = dict(p._config)
    _reset(p)
    p._rank_cache[0] = None
    p.set_config(filename=path, profile_all=True, aggregate_stats=True,
                 profile_sync=False)
    p.set_state("run")
    try:
        _sequence(m, m.cpu())
    finally:
        p.set_state("stop")
    p.dump(finished=True)
    p._config.update(saved)
    return json.load(open(path))["traceEvents"]


def test_event_sequence_equals_jax(tmp_path):
    want = _run(jmx, jprofiler, str(tmp_path / "jax.json"))
    got = _run(mx, profiler, str(tmp_path / "port.json"))

    def shape(evs):
        return [(e["name"], e.get("cat"), e["ph"], e.get("pid"),
                 e.get("tid"), sorted(e.get("args", {})) if e["ph"] == "M"
                 else None) for e in evs]

    assert shape(got) == shape(want)
    backward = [e["name"] for e in got if e["name"].startswith("_backward_")]
    assert backward == ["_backward_sum", "_backward_elemwise_mul",
                        "_backward_exp"], backward


def test_facade_layers_are_one_event_each(clean_profiler):
    """A Gluon layer called with NDArrays runs its torch module: a leaf
    layer is one imperative event named by its class, and its backward
    one ``_backward_<class>`` event; containers add none."""
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=4),
                nn.Dense(3, in_units=8))
    net.initialize(ctx=mx.cpu())
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x = mx.nd.array(np.ones((2, 4), np.float32))
    y = mx.nd.array([0.0, 2.0])
    p = clean_profiler
    p.set_state("run")
    with autograd.record():
        L = loss(net(x), y)
    L.backward()
    p.set_state("stop")
    evs = [(e["name"], e["cat"]) for e in p._events if e["ph"] == "X"]
    assert evs == [("Dense", "imperative"), ("Dense", "imperative"),
                   ("SoftmaxCrossEntropyLoss", "imperative"),
                   ("_backward_SoftmaxCrossEntropyLoss", "imperative"),
                   ("_backward_Dense", "imperative"),
                   ("_backward_Dense", "imperative")], evs


def test_dispatch_counter_counts_every_op(clean_profiler):
    c = telemetry.counter("mxtpu_op_dispatch_total", {"cat": "imperative"})
    s = telemetry.counter("mxtpu_op_dispatch_total", {"cat": "symbolic"})
    before, sym_before = c.value, s.value
    x = mx.nd.array([1.0, 2.0])    # profiler stopped: counted all the same
    _ = (x * 2 + 1).asnumpy()
    exe = (mx.sym.var("data") * 2).bind(mx.cpu(), args={"data": x})
    exe.forward()
    assert c.value - before == 2
    assert s.value - sym_before == 1


def test_no_backward_hook_without_profiling(clean_profiler, monkeypatch):
    hooked = []
    real = profiler.hook_backward
    monkeypatch.setattr(profiler, "hook_backward",
                        lambda name, outs: (hooked.append(name),
                                            real(name, outs))[1])
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x).sum()
    y.backward()
    assert hooked == [] and _event_names(profiler) == []
    profiler.set_state("run")
    with autograd.record():
        y = (x * x).sum()
    profiler.set_state("stop")
    y.backward()     # profiling stopped before the backward: no event
    assert hooked == ["elemwise_mul", "sum"]
    assert not [n for n in _event_names(profiler) if n.startswith("_back")]


def test_start_stop_xla_trace_writes_a_torch_profiler_trace(
        clean_profiler, tmp_path):
    d = str(tmp_path / "xtrace")
    assert profiler.start_xla_trace(d) == d
    x = mx.nd.array(np.ones((64, 64), np.float32))
    _ = mx.nd.dot(x, x).asnumpy()
    assert profiler.stop_xla_trace() == d
    files = os.listdir(d)
    assert files == ["trace_rank0.json"], files
    evs = json.load(open(os.path.join(d, files[0])))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in evs)
    with pytest.raises(mx.MXNetError):
        profiler.stop_xla_trace()


# --------------------------------------------------------------------------
# tools/trace_merge.py over the port's dumps
# --------------------------------------------------------------------------

def _load_trace_merge():
    spec = importlib.util.spec_from_file_location(
        "trace_merge", os.path.join(_ROOT, "tools", "trace_merge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_merge_real_profiler_dumps(tmp_path, clean_profiler):
    """Two of the port's dumps (two ranks) merge into one timeline with
    per-rank process lanes."""
    p = clean_profiler
    paths = []
    for r in (0, 1):
        p._events.clear()
        p._tids.clear()
        p._rank_cache[0] = r  # what a launched rank-r process would stamp
        fname = str(tmp_path / ("rank%d.json" % r))
        p.set_config(filename=fname)
        p.set_state("run")
        x = mx.nd.array([float(r + 1)])
        _ = (x * 2).asnumpy()
        p.set_state("stop")
        p.dump(finished=True)
        paths.append(fname)
    p._rank_cache[0] = None
    tm = _load_trace_merge()
    out = str(tmp_path / "merged.json")
    assert tm.main(paths + ["-o", out]) == 0
    merged = json.load(open(out))
    pids = {e["pid"] for e in merged["traceEvents"]}
    assert pids == {0, 1}
    names = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert set(names) == {0, 1}
    assert sum(1 for e in merged["traceEvents"] if e.get("ph") == "X") == 2


def test_rank_follows_the_launcher_env(monkeypatch):
    from mxnet_tpu.telemetry import core as jcore

    for env in ({}, {"MXTPU_PROCESS_ID": "3"}, {"DMLC_WORKER_ID": "2"},
                {"PMI_RANK": "x", "SLURM_PROCID": "5"}):
        for k in ("MXTPU_PROCESS_ID", "DMLC_WORKER_ID",
                  "OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert telemetry.rank() == jcore.rank(), env
