"""The replica pools' pieces that need no process, against the JAX package.

The wire frames (`supervisor.send_msg` / `recv_msg`), the respawn backoff,
the ``MXTPU_FAULT_INJECT`` grammar, tracing's header, wire and sampling
forms, `DynamicBatcher.requeue` and the pool's admission gate: the same
inputs through both packages give the same bytes, values, errors and
outcomes. The process tests are in `test_torch_port_replica_pool_e2e.py`
and `test_torch_port_replica_pool_chaos.py`.
"""
import socket
import threading
import time
import types

import numpy as np
import pytest

from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.parallel import resilience as jax_resilience
from mxnet_tpu.serving import DynamicBatcher as JaxBatcher
from mxnet_tpu.serving import replica_pool as jax_pool
from mxnet_tpu.serving import supervisor as jax_sup
from mxnet_tpu.telemetry import tracing as jax_tracing
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import resilience
from mxnet_tpu_torch.serving import DynamicBatcher, OverloadedError
from mxnet_tpu_torch.serving import replica_pool, supervisor
from mxnet_tpu_torch.telemetry import tracing

FRAMES = [
    {"kind": "hello", "replica": 1, "generation": 3, "pid": 4242},
    {"kind": "predict", "id": 7, "bucket": 4, "n": 3, "remaining": 1.5,
     "arrays": {"x": np.arange(12, dtype=np.float32).reshape(4, 3)},
     "traces": [("ab" * 8, "cd" * 4, True)]},
    {"kind": "generate", "id": 9, "tokens": [3, 5, 7], "max_new_tokens": 5,
     "temperature": 0.0, "top_k": 0, "top_p": 1.0, "remaining": None,
     "trace": None},
    {"kind": "stats_result", "id": 2,
     "stats": {"kv_pages_used": 0, "pending": 0, "jit_after_warm": 0}},
    {"kind": "shutdown"},
]


def _frame_bytes(send, obj):
    a, b = socket.socketpair()
    try:
        send(a, obj)
        a.close()
        out = bytearray()
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return bytes(out)
            out.extend(chunk)
    finally:
        b.close()


def _same(x, y):
    if isinstance(x, dict):
        return isinstance(y, dict) and set(x) == set(y) and all(
            _same(x[k], y[k]) for k in x)
    if isinstance(x, np.ndarray):
        return x.dtype == y.dtype and np.array_equal(x, y)
    return x == y


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_wire_frames_are_byte_identical_and_cross_read(i):
    obj = FRAMES[i]
    ours = _frame_bytes(supervisor.send_msg, obj)
    theirs = _frame_bytes(jax_sup.send_msg, obj)
    assert ours == theirs
    assert int.from_bytes(ours[:4], "big") == len(ours) - 4
    for send, recv in ((jax_sup.send_msg, supervisor.recv_msg),
                       (supervisor.send_msg, jax_sup.recv_msg)):
        a, b = socket.socketpair()
        try:
            send(a, obj)
            assert _same(obj, recv(b, first_timeout=5.0))
            a.close()
            assert recv(b, first_timeout=5.0) is None   # clean EOF
        finally:
            a.close()
            b.close()


def test_recv_msg_refuses_an_oversized_frame_in_both():
    for recv in (supervisor.recv_msg, jax_sup.recv_msg):
        a, b = socket.socketpair()
        try:
            a.sendall(((1 << 30) + 1).to_bytes(4, "big"))
            with pytest.raises(OSError, match="oversized"):
                recv(b, first_timeout=5.0)
        finally:
            a.close()
            b.close()
    assert supervisor.TOKEN_LEN == jax_sup.TOKEN_LEN == 32


@pytest.mark.parametrize("initial_ms", [None, 1.0, 50.0, 200.0, 40000.0])
def test_backoff_equals_jax(initial_ms):
    got = [supervisor.backoff_s(n, initial_ms) for n in range(-1, 12)]
    want = [jax_sup.backoff_s(n, initial_ms) for n in range(-1, 12)]
    assert got == want
    assert got[0] == got[1] == 0.0 and max(got) <= 60.0


FAULT_SPECS = [
    "kill@step=7,rank=1",
    "preempt@step=7,rank=1,grace=30 kill_during_ckpt@step=4,rank=0",
    "exc@step=3 corrupt_ckpt@step=5,dir=/tmp/x",
    "kill_replica@batch=3,replica=0 wedge_replica@batch=5,replica=1,gen=0 "
    "slow_reply@batch=2,ms=500",
    "kill_replica@batch=3,replica=0;wedge_replica@batch=5,replica=1",
    "load_surge@after=0,rps=200,duration=3 slow_batch@step=3,ms=200",
    "kill_replica@batch=1,code=7,gen=2",
    "hang@step=5,rank=1",
    "",
    "   ",
    # malformed: both raise
    "explode@step=1",
    "kill@rank=1",
    "kill_replica@step=3",
    "load_surge@rps=5",
    "kill@step=x",
    "kill@step",
    "kill@step=1,color=red",
    "kill@action=kill,step=1",
    "slow_reply@batch=2,ms=fast",
]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_spec_equals_jax(spec):
    try:
        want = jax_resilience.fault_spec(spec)
    except JaxMXNetError as e:
        with pytest.raises(MXNetError) as ei:
            resilience.fault_spec(spec)
        assert str(ei.value) == str(e)
        return
    assert resilience.fault_spec(spec) == want


def test_serving_fault_hook_gates_on_batch_replica_and_gen(monkeypatch):
    fired = []
    monkeypatch.setattr(resilience, "_fire_serving",
                        lambda e, b, r: fired.append((e["action"], b, r)))
    monkeypatch.setenv("MXTPU_FAULT_INJECT",
                       "kill_replica@batch=3,replica=0 slow_reply@batch=2")
    monkeypatch.setattr(resilience, "_fault_cache", resilience._UNPARSED)
    for batch in (1, 2, 3):
        for replica in (0, 1):
            resilience.maybe_inject_serving_fault(batch, replica)
    assert fired == [("slow_reply", 2, 0), ("slow_reply", 2, 1),
                     ("kill_replica", 3, 0)]
    # a respawned generation does not fire again
    monkeypatch.setenv("MXTPU_RESTART_GENERATION", "1")
    resilience.maybe_inject_serving_fault(3, 0)
    assert len(fired) == 3
    # inert without the variable (the load surge, the training-step and
    # data-stall hooks too; tests/test_torch_port_resilience.py fires them)
    monkeypatch.delenv("MXTPU_FAULT_INJECT")
    monkeypatch.setattr(resilience, "_fault_cache", resilience._UNPARSED)
    resilience.maybe_inject_serving_fault(3, 0)
    assert len(fired) == 3
    assert resilience.maybe_inject_load_surge(None) == []
    assert resilience.maybe_inject_fault(1) is None
    assert resilience.maybe_inject_data_stall(1) is None


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

@pytest.fixture
def both_tracings():
    mods = (tracing, jax_tracing)

    def reset():
        for t in mods:
            t.configure()
            t.set_collector(None)
            t.drain_pending()
            t._BUFFER.clear()

    reset()
    yield mods
    reset()


@pytest.mark.parametrize("ref", [("ab" * 8, "cd" * 4, True),
                                 ("ab" * 8, "cd" * 4, False),
                                 ("0123456789abcdef", None, True)])
def test_header_and_wire_forms_equal_jax(both_tracings, ref):
    ours = tracing.SpanRef(ref[0], ref[1], sampled=ref[2])
    theirs = jax_tracing.SpanRef(ref[0], ref[1], sampled=ref[2])
    assert tracing.header_value(ours) == jax_tracing.header_value(theirs)
    assert tracing.to_wire(ours) == jax_tracing.to_wire(theirs)
    h = tracing.header_value(ours)
    a, b = tracing.parse_header(h), jax_tracing.parse_header(h)
    assert (a.trace_id, a.span_id, a.sampled) == \
        (b.trace_id, b.span_id, b.sampled)
    w = tracing.from_wire(jax_tracing.to_wire(theirs))
    assert (w.trace_id, w.span_id, w.sampled) == (ref[0], ref[1], ref[2])
    assert tracing.HEADER == jax_tracing.HEADER == "x-mxtpu-trace"


@pytest.mark.parametrize("bad", [
    "", "garbage", "zz" * 8 + "-" + "cd" * 4 + "-01", "abc", "a-b", "--",
    "ab-cd", None, "AB" * 8 + "-" + "CD" * 4 + "-01", " ab-cd-1 ",
    "ab-cd-xx"])
def test_header_parsing_equals_jax(both_tracings, bad):
    a, b = tracing.parse_header(bad), jax_tracing.parse_header(bad)
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.trace_id, a.span_id, a.sampled) == \
            (b.trace_id, b.span_id, b.sampled)
    assert tracing.from_wire(None) is None and tracing.to_wire(None) is None


def _span_shape(t, sample=None, slow_ms=None, ref=None, sleep=0.0):
    """Names, parentage and flags of one root with a child, a captured
    cross-thread span and a pre-minted dispatch id, in tracing module
    ``t``."""
    t.configure(sample=sample, slow_ms=slow_ms)
    out = {}
    with t.root("unit.root", component="server", attrs={"step": 7},
                ref=None if ref is None else t.mint(ref)) as sp:
        out["recorded"] = sp.recorded
        with t.span("unit.child") as ch:
            out["child_component"] = ch.component if ch.recorded else None
            captured = t.capture()

            def other():
                with t.span("unit.other", parent=captured):
                    pass
                t.emit_span("unit.retro", time.time(), 0.001, captured)

            th = threading.Thread(target=other)
            th.start()
            th.join(10)
            pre = t.child_ref(sp)
            if pre is not None:
                t.emit_span("unit.dispatch", time.time(), 0.002, sp,
                            span_id=pre.span_id)
            time.sleep(sleep)
    recs = t.drain_pending()
    by = {r["name"]: r for r in recs}
    parent_of = {n: next((m for m, q in by.items()
                          if q["span"] == r["parent"]), None)
                 for n, r in by.items()}
    out["names"] = sorted(by)
    out["parents"] = parent_of
    out["slow"] = sorted(n for n, r in by.items() if r.get("slow"))
    out["one_trace"] = len({r["trace"] for r in recs}) <= 1
    if pre is not None and "unit.dispatch" in by:
        out["dispatch_id_kept"] = by["unit.dispatch"]["span"] == pre.span_id
    out["buffer_empty"] = t._BUFFER == {}
    out["capture_outside"] = t.capture()
    return out


@pytest.mark.parametrize("case", ["rate0", "rate1", "incoming", "slow_fast",
                                  "slow_slow"])
def test_sampling_cases_equal_jax(both_tracings, case):
    kw = {"rate0": dict(sample=0.0), "rate1": dict(sample=1.0),
          "incoming": dict(sample=0.0, ref=("ee" * 8, "ff" * 4)),
          "slow_fast": dict(slow_ms=1000.0),
          "slow_slow": dict(slow_ms=30.0, sleep=0.06)}[case]
    got = {}
    for t in both_tracings:
        args = dict(kw)
        if "ref" in args:
            args["ref"] = t.SpanRef(*args["ref"], sampled=True)
        got[t.__name__] = _span_shape(t, **args)
    ours, theirs = got[tracing.__name__], got[jax_tracing.__name__]
    assert ours == theirs
    if case in ("rate1", "incoming", "slow_slow"):
        assert ours["names"] == ["unit.child", "unit.dispatch",
                                 "unit.other", "unit.retro", "unit.root"]
        assert ours["parents"]["unit.other"] == "unit.child"
        assert ours["parents"]["unit.dispatch"] == "unit.root"
    else:
        assert ours["names"] == []


def test_active_spans_and_ids(both_tracings):
    for t in both_tracings:
        t.configure(sample=1.0)
        me = str(threading.get_ident())
        with t.root("unit.outer", component="server"):
            with t.span("unit.inner"):
                snap = t.active_spans()[me]
                assert [s["name"] for s in snap] == ["unit.outer",
                                                     "unit.inner"]
        assert me not in t.active_spans()
        ref = t.mint()
        assert len(ref.trace_id) == t.TRACE_ID_LEN == 16
        assert t.SPAN_ID_LEN == 8
        t.drain_pending()


# ---------------------------------------------------------------------------
# requeue and the admission gate
# ---------------------------------------------------------------------------

def _requeue_outcomes(batcher_cls, monkeypatch):
    """Three requests dispatched together; the batch is requeued (once a
    request), dispatched again and requeued again (a second failover),
    with one member expired on the way. Returns each request's outcome."""
    monkeypatch.setenv("MXTPU_SLO", "0")
    batches = []
    got = threading.Event()

    def dispatcher(batch, total):
        batches.append(list(batch))
        got.set()

    b = batcher_cls(None, [1, 2, 4], max_delay_ms=50, queue_depth=8,
                    name="requeue-%s" % batcher_cls.__module__,
                    dispatcher=dispatcher)
    try:
        now = time.monotonic()
        reqs = [b.submit({"x": np.zeros((1, 1), np.float32)},
                         deadline=now + d) for d in (30.0, 30.0, 0.4)]
        assert got.wait(10)
        first = batches[-1]
        assert len(first) == 3
        got.clear()
        assert b.requeue(first) == 3
        assert got.wait(10)
        second = batches[-1]
        assert [id(r) for r in second] == [id(r) for r in first]
        time.sleep(0.45)  # the third member's deadline passes
        n = b.requeue(second)
        outcomes = []
        for r in reqs:
            try:
                r.wait(1.0)
                outcomes.append("ok")
            except Exception as e:  # the typed serving error
                outcomes.append((type(e).__name__, e.status))
        return n, outcomes, b.pending()
    finally:
        b.abort_pending()
        b.close(drain=False, timeout=0)


def test_requeue_equals_jax(monkeypatch):
    ours = _requeue_outcomes(DynamicBatcher, monkeypatch)
    theirs = _requeue_outcomes(JaxBatcher, monkeypatch)
    assert ours == theirs
    assert ours == (0, [("OverloadedError", 503), ("OverloadedError", 503),
                        ("DeadlineExceededError", 504)], 0)


def test_admission_gate_sheds_and_rejects_as_the_batcher_says(monkeypatch):
    """A gate's error reaches the caller before the depth check and is
    counted as shed; the batcher admits when the gate says None."""
    verdict = [None]
    b = DynamicBatcher(lambda a, bkt, n: [a["x"]], [1, 2], max_delay_ms=1,
                       queue_depth=4, name="gate-unit",
                       admission_gate=lambda queued: verdict[0])
    try:
        assert b.submit({"x": np.ones((1, 1))}).wait(5)[0][0, 0] == 1.0
        verdict[0] = OverloadedError("degraded", retry_after=3)
        with pytest.raises(OverloadedError) as ei:
            b.submit({"x": np.ones((1, 1))})
        assert ei.value.retry_after == 3
        assert b._m_rej_shed.value == 1
    finally:
        b.close()


def _bare_pool(mod, size, healthy, depth, joining=0, restarts=0):
    """A pool object with its slots' states set, and no process: enough
    state for `admission_gate`."""
    pool = mod.ReplicaPool.__new__(mod.ReplicaPool)
    pool.model = "gate/1"
    pool.size = size
    pool._lock = threading.Lock()
    pool._backoff_ms = 200.0
    pool._batcher = types.SimpleNamespace(queue_depth=depth)
    slots = []
    for i in range(size):
        s = mod._Slot(i, None, joining=i >= size - joining)
        s.state = mod._READY if i < healthy else mod._DEAD
        s.consecutive_restarts = restarts
        slots.append(s)
    pool._slots = slots
    return pool


GATE_GRID = [(n, h, depth, q, j, r)
             for n in (1, 2, 3, 4) for h in range(n + 1)
             for depth in (1, 8, 30) for q in (0, 3, 7, 29)
             for j in (0, 1) for r in (0, 3) if j < n]


def test_admission_gate_equals_jax_over_the_grid():
    """Shed or admit, the message and ``Retry-After`` (ceil(N/h) when
    degraded, the respawn backoff horizon at h = 0) over (N, h, queue
    depth, queued, joining, restarts)."""
    shed = 0
    for n, h, depth, q, j, r in GATE_GRID:
        ours = _bare_pool(replica_pool, n, h, depth, j, r).admission_gate(q)
        theirs = _bare_pool(jax_pool, n, h, depth, j, r).admission_gate(q)
        assert (ours is None) == (theirs is None), (n, h, depth, q, j, r)
        if ours is not None:
            shed += 1
            assert (type(ours).__name__, str(ours), ours.retry_after,
                    ours.status) == (type(theirs).__name__, str(theirs),
                                     theirs.retry_after, theirs.status)
    assert 0 < shed < len(GATE_GRID)


def test_pool_needs_a_replica():
    with pytest.raises(MXNetError, match=">= 1 replicas"):
        replica_pool.ReplicaPool("x", ["--stub", "echo"], 0, device="cpu")


@pytest.mark.parametrize("flag", [["--min-replicas", "1"],
                                  ["--max-replicas", "3"], ["--pin"]])
def test_serving_module_autoscaler_flags_parse_and_raise(flag, monkeypatch):
    """``--min-replicas`` / ``--max-replicas`` / ``--pin`` parse as in
    ``tools/serve.py`` and reach `ModelRepository.load` as its autoscaling
    knobs (the stand-in load raises, so no pool starts)."""
    from mxnet_tpu_torch.serving import ModelRepository
    from mxnet_tpu_torch.serving.__main__ import main

    seen = []

    def load(self, name, path, **kw):
        seen.append(kw)
        raise MXNetError("stand-in load")

    monkeypatch.setattr(ModelRepository, "load", load)
    with pytest.raises(MXNetError, match="stand-in load"):
        main(["--model", "lm=/nowhere/lm@generate", "--device", "cpu",
              "--replicas", "2"] + flag)
    want = {"min_replicas": None, "max_replicas": None, "pinned": False}
    want.update({"--min-replicas": {"min_replicas": 1},
                 "--max-replicas": {"max_replicas": 3},
                 "--pin": {"pinned": True}}[flag[0]])
    assert [{k: kw[k] for k in want} for kw in seen] == [want]
    assert seen[0]["replicas"] == 2 and seen[0]["generate"]


@pytest.mark.parametrize("opts", [{}, {"kv_dtype": "bfloat16"},
                                  {"kv_dtype": "float32", "num_pages": 64,
                                   "max_batch": 4}])
def test_pooled_lm_forwards_engine_geometry_as_worker_argv(monkeypatch,
                                                           opts):
    """A pooled `ServedLM.load` hands the engine's keywords, the KV dtype
    among them, to its workers as argv, so router and replicas agree; a
    keyword no worker takes raises before any pool is built."""
    from mxnet_tpu_torch.serving.generate import ServedLM

    built = []

    class FakePool:
        def __init__(self, model, worker_args, replicas, **kw):
            built.append((model, list(worker_args), replicas))
            self.device = kw["device"]

        def wait_ready(self):
            return {"generate": {"kv_dtype": opts.get("kv_dtype",
                                                      "float32")},
                    "warm_seconds": 0.0}

    monkeypatch.setattr(replica_pool, "ReplicaPool", FakePool)
    lm = ServedLM.load("lm", 1, "/models/lm", replicas=2, device="cpu",
                       **opts)
    flags = {"kv_dtype": "--kv-dtype", "num_pages": "--kv-pages",
             "max_batch": "--max-batch"}
    want = ["--generate", "/models/lm"]
    for k, v in opts.items():
        want += [flags[k], str(v)]
    (model, argv, replicas), = built
    assert (model, replicas, argv[:2]) == ("lm/1", 2, want[:2])
    assert sorted(zip(argv[2::2], argv[3::2])) == \
        sorted(zip(want[2::2], want[3::2]))
    assert lm.generate_info["kv_dtype"] == opts.get("kv_dtype", "float32")
    with pytest.raises(MXNetError, match="in-process engine only"):
        ServedLM.load("lm", 1, "/models/lm", replicas=2, device="cpu",
                      eos_id=3, **opts)
    assert len(built) == 1
