"""The training side of the port's telemetry against the JAX package's.

The four trainers (`DistributedTrainer`, `gluon.Trainer` over two contexts,
`Module.fit`, `PipelineTrainer`) each take three steps of a tiny net in
both packages, with fresh registries, goodput and SLO state swapped into
both and every step traced into a collector. Then both must show the same
training metric names and labels, the same goodput phases (the JAX
package's ``compile``, which XLA's first call pays, aside: the port
compiles nothing) with the port's per-step phases summing to the
bracketed wall (the JAX package adds its compile seconds outside it),
the same ``train.step`` root spans and children with component "train",
and ``fit``'s data-wait and compute counters. Also: `set_step_flops` and
``MXTPU_STEP_FLOPS`` give ``mxtpu_step_mfu = flops / seconds / peak``
with the peak patched alike; the automatic count of a Dense net's step
equals its matrix products exactly, and lies below XLA's cost-analysis
figure by at most 8 FLOPs an element of the parameters and the layers'
outputs (XLA also counts the elementwise work); each flash
and LSTM kernel wrapper reports what `FlopCounterMode` counts of its
plain version, and a kernel on another thread (the autograd engine's)
reports to the call that started it; NDArray live accounting moves as
the JAX package's; the flight recorder's handler is installed at import
under ``MXTPU_TELEMETRY_DIR`` and its dump has the JAX dump's keys; and
the launcher tears a hung job down SIGUSR1 first and writes the
generation's trace span, as the JAX launcher does on the same job.
"""
import gc
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.telemetry import core as jcore
from mxnet_tpu.telemetry import flops as jflops
from mxnet_tpu.telemetry import goodput as jgoodput
from mxnet_tpu.telemetry import memory as jmemory
from mxnet_tpu.telemetry import recorder as jrecorder
from mxnet_tpu.telemetry import slo as jslo
from mxnet_tpu.telemetry import tracing as jtracing
from mxnet_tpu_torch import telemetry as ptel
from mxnet_tpu_torch.ops import pallas_kernels as pk
from mxnet_tpu_torch.telemetry import core as pcore
from mxnet_tpu_torch.telemetry import flops as pflops
from mxnet_tpu_torch.telemetry import goodput as pgoodput
from mxnet_tpu_torch.telemetry import memory as pmemory
from mxnet_tpu_torch.telemetry import slo as pslo
from mxnet_tpu_torch.telemetry import tracing as ptracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
# the training metrics both packages publish (everything else in the
# registries is each package's own dispatch, compile and device plumbing)
TRAIN_PREFIXES = ("mxtpu_step", "mxtpu_examples", "mxtpu_goodput",
                  "mxtpu_data_wait", "mxtpu_data_compute")
PACKAGES = {"jax": (jtel, jcore, jslo, jgoodput, jtracing, jmemory),
            "port": (ptel, pcore, pslo, pgoodput, ptracing, pmemory)}


@pytest.fixture
def fresh(monkeypatch):
    """Fresh registries, SLO, goodput and step-metric state in both
    packages, every step traced into a collector a package; no SLO
    evaluator thread, and no per-step memory probe (its histogram appears
    only when two probes land 0.1 s apart, a matter of each package's
    speed)."""
    monkeypatch.setenv("MXTPU_SLO_EVAL_MS", "1e9")
    monkeypatch.delenv("MXTPU_SLO_SPEC", raising=False)
    spans = {}
    for name, (tel, core, slo, goodput, tracing, memory) in \
            PACKAGES.items():
        slo.stop()
        monkeypatch.setattr(core, "_REGISTRY", core.Registry())
        monkeypatch.setattr(core, "_STATE", core._State())
        monkeypatch.setattr(slo, "_STATE", slo._SLOState())
        monkeypatch.setattr(tel, "_STEP_METRICS", {})
        monkeypatch.setattr(memory, "_STEP_PROBE_MIN_S", 1e12)
        goodput._reset_for_tests()
        spans[name] = []
        tracing.configure(sample=1.0)
        tracing.set_collector(spans[name].append)
    yield spans
    for tel, core, slo, goodput, tracing, memory in PACKAGES.values():
        tracing.set_collector(None)
        tracing.configure(None, None)
        slo.stop()
        goodput._reset_for_tests()


def _train_metrics(tel):
    return sorted(k for k in tel.snapshot() if k.startswith(TRAIN_PREFIXES))


def _phases(goodput):
    """(phase names, sum of the in-step phases, bracketed wall)."""
    tot = goodput.totals()
    inside = {k: v for k, v in tot["phases"].items() if k != "between_steps"}
    return set(inside), sum(inside.values()), tot["wall"]


def _span_shape(records):
    """The step spans as (name, component, is a root), in order, with the
    trace id of each root's children checked against the root's."""
    spans = [r for r in records if r.get("event", "span") == "span"
             and str(r.get("name", "")).startswith("train.")]
    roots = {r["span"]: r for r in spans if r["name"] == "train.step"}
    for r in spans:
        if r["name"] != "train.step":
            assert r.get("parent") in roots, r
            assert r["trace"] == roots[r["parent"]]["trace"]
    return sorted((r["name"], r.get("component"), r["name"] == "train.step")
                  for r in spans)


def _compare(spans, name_j="jax", name_p="port", kind=None):
    jm = _train_metrics(jtel)
    pm = _train_metrics(ptel)
    assert pm == jm
    j_names, j_sum, j_wall = _phases(jgoodput)
    p_names, p_sum, p_wall = _phases(pgoodput)
    assert p_names == j_names - {"compile"}, (p_names, j_names)
    assert p_wall > 0 and p_sum == pytest.approx(p_wall, rel=1e-9)
    assert j_wall > 0
    assert _span_shape(spans[name_p]) == _span_shape(spans[name_j])
    if kind is not None:
        for tel in (jtel, ptel):
            snap = tel.snapshot()
            assert snap['mxtpu_steps_total{kind="%s"}' % kind]["value"] \
                == STEPS
    return pm


# --------------------------------------------------------------------------
# the four trainers
# --------------------------------------------------------------------------

def _dense_weights(seed, sizes):
    rng = np.random.RandomState(seed)
    return [(rng.uniform(-0.5, 0.5, (o, i)).astype(np.float32),
             rng.uniform(-0.1, 0.1, (o,)).astype(np.float32))
            for i, o in zip(sizes[:-1], sizes[1:])]


def _mlp(pkg, weights, ctx=None):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        for k, (w, _) in enumerate(weights):
            net.add(pkg.gluon.nn.Dense(
                w.shape[0], in_units=w.shape[1],
                activation="relu" if k < len(weights) - 1 else None))
    net.initialize(ctx=ctx)
    for (w, b), layer in zip(weights, net):
        layer.weight.set_data(pkg.nd.array(w))
        layer.bias.set_data(pkg.nd.array(b))
    return net


def _batch(seed, n, d_in, d_out):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(n, d_in)).astype(np.float32),
            rng.normal(size=(n, d_out)).astype(np.float32))


def test_distributed_trainer_brackets_and_roots_match_jax(fresh):
    weights = _dense_weights(1, (6, 12, 3))
    x, y = _batch(2, 8, 6, 3)
    jtr = jmx.parallel.DistributedTrainer(
        _mlp(jmx, weights), "sgd", {"learning_rate": 0.1},
        loss=jmx.gluon.loss.L2Loss())
    with mx.cpu():
        ptr = mx.parallel.DistributedTrainer(
            _mlp(mx, weights), "sgd", {"learning_rate": 0.1},
            loss=mx.gluon.loss.L2Loss())
        for _ in range(STEPS):
            jl = float(jtr.step(x, y).asnumpy())
            pl = float(ptr.step(x, y).asnumpy())
            assert pl == pytest.approx(jl, rel=1e-5)
    names = _compare(fresh, kind="dist")
    assert 'mxtpu_step_mfu{kind="dist"}' in names
    assert 'mxtpu_step_flops_auto{kind="dist"}' in names
    roots = [r for r in fresh["port"] if r.get("name") == "train.step"]
    assert [r["attrs"]["kind"] for r in roots] == ["dist"] * STEPS
    assert [r["attrs"]["step"] for r in roots] == list(range(1, STEPS + 1))


def test_gluon_trainer_over_two_contexts_matches_jax(fresh):
    weights = _dense_weights(3, (5, 7, 2))
    x, y = _batch(4, 4, 5, 2)

    def run(pkg, net):
        ctxs = [pkg.cpu(0), pkg.cpu(1)]
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        loss_fn = pkg.gluon.loss.L2Loss()
        for _ in range(STEPS):
            xs = pkg.gluon.utils.split_and_load(pkg.nd.array(x), ctxs)
            ys = pkg.gluon.utils.split_and_load(pkg.nd.array(y), ctxs)
            with pkg.autograd.record():
                losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
            for ls in losses:
                ls.backward()
            tr.step(x.shape[0])
        return net[0].weight.data(ctxs[1]).asnumpy()

    want = run(jmx, _mlp(jmx, weights, ctx=[jmx.cpu(0), jmx.cpu(1)]))
    with mx.cpu():
        got = run(mx, _mlp(mx, weights, ctx=[mx.cpu(0), mx.cpu(1)]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    _compare(fresh, kind="train")
    p_names = _phases(pgoodput)[0]
    assert "collective" in p_names and "compute" in p_names
    children = {r["name"] for r in fresh["port"]
                if r.get("name") != "train.step"}
    assert children == {"train.allreduce", "train.optimizer"}


def _fit(pkg, weights, x, y, ctx):
    data = pkg.sym.var("data")
    h = pkg.sym.FullyConnected(data, num_hidden=weights[0][0].shape[0],
                               name="fc1")
    h = pkg.sym.Activation(h, act_type="relu")
    h = pkg.sym.FullyConnected(h, num_hidden=weights[1][0].shape[0],
                               name="fc2")
    net = pkg.sym.LinearRegressionOutput(h, name="lro")
    it = pkg.io.NDArrayIter(x, y, batch_size=4, label_name="lro_label")
    mod = pkg.mod.Module(net, data_names=["data"], label_names=["lro_label"],
                         context=ctx)
    args = {"fc1_weight": weights[0][0], "fc1_bias": weights[0][1],
            "fc2_weight": weights[1][0], "fc2_bias": weights[1][1]}
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.05),),
            arg_params={k: pkg.nd.array(v) for k, v in args.items()},
            eval_metric="mse")
    return mod.get_params()[0]["fc2_weight"].asnumpy()


def test_module_fit_brackets_roots_and_counters_match_jax(fresh):
    weights = _dense_weights(5, (4, 6, 2))
    x, y = _batch(6, 4 * STEPS, 4, 2)
    want = _fit(jmx, weights, x, y, jmx.cpu())
    with mx.cpu():
        got = _fit(mx, weights, x, y, mx.cpu())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    names = _compare(fresh, kind="fit")
    for counter in ('mxtpu_data_wait_seconds_total{src="fit"}',
                    'mxtpu_data_compute_seconds_total{src="fit"}'):
        assert counter in names
        assert ptel.snapshot()[counter]["value"] > 0
        assert jtel.snapshot()[counter]["value"] > 0
    children = sorted(r["name"] for r in fresh["port"]
                      if r.get("name") != "train.step")
    assert children == sorted(["train.data_wait", "train.fwd_bwd",
                               "train.optimizer"] * STEPS)


def test_pipeline_trainer_brackets_match_jax(fresh):
    import jax

    weights = _dense_weights(7, (8, 8, 8))
    x, y = _batch(8, 8, 8, 8)

    def run(pkg, mesh):
        cells = [pkg.gluon.nn.Dense(8, flatten=False, in_units=8,
                                    prefix="cell%d_" % i) for i in range(2)]
        host = pkg.gluon.nn.HybridSequential()
        for c, (w, b) in zip(cells, weights):
            c.initialize()
            c.weight.set_data(pkg.nd.array(w))
            c.bias.set_data(pkg.nd.array(b))
            host.add(c)
        tr = pkg.parallel.PipelineTrainer(
            host, "sgd", {"learning_rate": 0.1},
            loss=pkg.gluon.loss.L2Loss(), mesh=mesh, cells=cells,
            prelude=lambda a: a, postlude=lambda a: a, num_microbatches=2)
        return [float(tr.step(x, y).asnumpy()) for _ in range(STEPS)]

    want = run(jmx, jmx.parallel.make_mesh([("pp", 1)],
                                           devices=jax.devices()[:1]))
    with mx.cpu():
        got = run(mx, mx.parallel.make_mesh([("pp", 1)]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    names = _compare(fresh, kind="pipeline")
    assert 'mxtpu_step_mfu{kind="pipeline"}' in names
    assert not [r for r in fresh["port"] if r.get("name") == "train.step"]


# --------------------------------------------------------------------------
# MFU and FLOPs
# --------------------------------------------------------------------------

def test_set_step_flops_gives_the_mfu_gauge_as_jax(fresh, monkeypatch):
    for tel in (jtel, ptel):
        monkeypatch.setattr(tel, "_PEAK_FLOPS", [2.0e12])
        tel.set_step_flops(3.0e9)
        try:
            tel.observe_step(0.25, examples=8, step=1, kind="mfu")
        finally:
            tel.set_step_flops(None)
    want = 3.0e9 / 0.25 / 2.0e12
    for tel in (jtel, ptel):
        snap = tel.snapshot()
        assert snap['mxtpu_step_mfu{kind="mfu"}']["value"] == \
            pytest.approx(want, rel=1e-12)


def test_dense_step_auto_flops_exact_and_near_xla(fresh):
    sizes = (64, 256, 128, 16)
    weights = _dense_weights(9, sizes)
    n = 32
    x, y = _batch(10, n, sizes[0], sizes[-1])
    with mx.cpu():
        ptr = mx.parallel.DistributedTrainer(
            _mlp(mx, weights), "sgd", {"learning_rate": 0.1},
            loss=mx.gluon.loss.L2Loss())
        got = []
        for _ in range(STEPS):
            ptr.step(x, y)
            got.append(pflops.last_step_flops())
    # forward 2 n i o a layer; backward the weight's 2 n i o, and the
    # input's 2 n i o except at the first layer (x takes no gradient)
    layers = list(zip(sizes[:-1], sizes[1:]))
    want = sum(2 * n * i * o for i, o in layers) * 2 + \
        sum(2 * n * i * o for i, o in layers[1:])
    assert got == [want] * STEPS
    jtr = jmx.parallel.DistributedTrainer(
        _mlp(jmx, weights), "sgd", {"learning_rate": 0.1},
        loss=jmx.gluon.loss.L2Loss())
    for _ in range(STEPS):
        jtr.step(x, y)
    xla = jflops.last_step_flops()
    assert xla is not None and xla > 0
    # XLA's figure adds the elementwise work (ReLU and its gradient, the
    # loss, SGD's update) to the same products: at most 8 FLOPs an element
    # of the parameters and the layers' outputs (about 4.2 here)
    elements = sum(i * o + o for i, o in layers) + n * sum(sizes[1:])
    assert 0 < xla - want <= 8 * elements, (want, xla, elements)
    snap = ptel.snapshot()
    assert snap['mxtpu_step_flops_auto{kind="dist"}']["value"] == want


def _flash_case(causal, lq, lk):
    rng = np.random.RandomState(lq + lk)
    q, dout = (torch.from_numpy(rng.randn(3, lq, 8).astype(np.float32))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(3, lk, 8).astype(np.float32))
            for _ in range(2))
    out, lse = pk.flash_fwd_reference(q, k, v, causal, 0.3)
    delta = (dout * out).sum(-1)
    return q, k, v, dout, lse, delta


def _counted(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("causal,lq,lk", [(False, 5, 7), (True, 6, 6)])
@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
def test_flash_wrapper_reports_what_the_counter_counts(name, causal, lq, lk):
    q, k, v, dout, lse, delta = _flash_case(causal, lq, lk)
    args = {"flash_fwd": (q, k, v, causal, 0.3),
            "flash_bwd_dq": (q, k, v, dout, lse, delta, causal, 0.3),
            "flash_bwd_dkv": (q, k, v, dout, lse, delta, causal, 0.3)}[name]
    plain = getattr(pk, name + "_reference")
    assert pk.flash_flops(name, q, k) == _counted(plain, *args)


@pytest.mark.parametrize("t,b,h", [(4, 3, 5), (2, 1, 8)])
@pytest.mark.parametrize("name", ["lstm_infer", "lstm_fwd", "lstm_bwd"])
def test_lstm_wrapper_reports_what_the_counter_counts(name, t, b, h):
    rng = np.random.RandomState(t * b * h)

    def r(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    gx, wh, h0, c0 = r(t, b, 4 * h), r(4 * h, h), r(b, h), r(b, h)
    if name == "lstm_bwd":
        ys, c_all, gates = pk.lstm_fwd_reference(gx, wh, h0, c0)
        args = (r(t, b, h), gates, c_all, c0, r(b, h), wh)
    else:
        args = (gx, wh, h0, c0)
    plain = getattr(pk, name + "_reference")
    assert pk.lstm_flops(t, b, h) == _counted(plain, *args)


def test_kernel_flops_follow_their_call_across_threads():
    """A kernel's backward launches on the autograd engine's thread: the
    Functions hand it the forward's accumulator (`sink`), so the count is
    the counted call's, once; a priced call counts nothing again; with no
    call the figure goes to the total."""
    def body(report):
        pflops.kernel(7.0)
        s = pflops.sink()
        t = threading.Thread(target=lambda: report(s))
        t.start()
        t.join()

    def backward_on_thread(s):
        with pflops.reporting_to(s):
            pflops.kernel(11.0)

    _, n = pflops.counted_call(body, backward_on_thread)
    assert n == 18.0
    memo = pflops.PerShapeFlops(lambda a: body(backward_on_thread))
    before = pflops.total()
    a = torch.zeros(2)
    memo(a)
    memo(a)
    assert pflops.total() - before == 36.0
    before = pflops.total()
    body(backward_on_thread)
    assert pflops.total() - before == 18.0


# --------------------------------------------------------------------------
# NDArray live accounting, the recorder at import, the launcher
# --------------------------------------------------------------------------

def _live_deltas(nd, memory, ctx):
    gc.collect()
    count0, bytes0 = memory.ndarray_live()
    a = nd.zeros((256,), ctx=ctx, dtype="float32")
    b = nd.zeros((128,), ctx=ctx, dtype="float32")
    gc.collect()
    count1, bytes1 = memory.ndarray_live()
    a._set_data(b._data)
    gc.collect()
    count2, bytes2 = memory.ndarray_live()
    del a, b
    gc.collect()
    count3, bytes3 = memory.ndarray_live()
    return [(count1 - count0, bytes1 - bytes0),
            (count2 - count1, bytes2 - bytes1),
            (count3 - count2, bytes3 - bytes2)]


def test_ndarray_live_accounting_moves_as_jax():
    want = _live_deltas(jmx.nd, jmemory, jmx.cpu())
    got = _live_deltas(mx.nd, pmemory, mx.cpu())
    assert got == want == [(2, 1536), (0, -512), (-2, -1024)]
    assert pmemory.snapshot()["ndarray"]["live"] == \
        pmemory.ndarray_live()[0]


def test_ndarray_made_while_telemetry_is_off_is_never_counted():
    pcore.set_enabled(False)
    try:
        a = mx.nd.zeros((64,), ctx=mx.cpu())
    finally:
        pcore.set_enabled(True)
    gc.collect()
    before = pmemory.ndarray_live()
    del a
    gc.collect()
    assert pmemory.ndarray_live() == before


def _port_env(tmp_path):
    env = dict(os.environ, MXTPU_TELEMETRY_DIR=str(tmp_path),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    env.pop("JAX_PLATFORMS", None)
    return env


def _wait_for(pred, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_recorder_installed_at_import_survives_sigusr1(tmp_path):
    """Under ``MXTPU_TELEMETRY_DIR`` the import installs the dump handler:
    SIGUSR1 writes a dump with the JAX dump's keys and the process lives
    on; ``MXTPU_STEP_FLOPS`` is read at the same import."""
    code = ("import sys, time\nimport mxnet_tpu_torch as mx\n"
            "print(mx.telemetry._STEP_FLOPS[0], flush=True)\n"
            "time.sleep(60)\n")
    env = _port_env(tmp_path)
    env["MXTPU_STEP_FLOPS"] = "1.5e9"
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, text=True)
    try:
        assert float(p.stdout.readline()) == 1.5e9
        os.kill(p.pid, signal.SIGUSR1)
        assert _wait_for(lambda: [f for f in os.listdir(tmp_path)
                                  if f.startswith("flightrec-")], 30)
        time.sleep(0.3)
        assert p.poll() is None   # dumped and lives on
        name = [f for f in os.listdir(tmp_path)
                if f.startswith("flightrec-")][0]
        with open(os.path.join(tmp_path, name)) as f:
            got = json.load(f)
    finally:
        p.kill()
        p.wait(timeout=30)
    want_path = str(tmp_path / "jax-dump.json")
    jrecorder.dump("SIGUSR1", path=want_path)
    with open(want_path) as f:
        want = json.load(f)
    assert sorted(got) == sorted(want)
    assert got["reason"] == "SIGUSR1"
    assert got["memory"]["ndarray"] is not None


# rank 1 imports the port (which installs the dump handler) and hangs;
# rank 0 fails once rank 1 is up
_HUNG_JOB = """\
import os, sys, time
rank = int(os.environ["MXTPU_PROCESS_ID"])
marker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "up")
if rank == 0:
    deadline = time.time() + 60
    while not os.path.exists(marker) and time.time() < deadline:
        time.sleep(0.05)
    sys.exit(3)
import mxnet_tpu_torch
open(marker, "w").close()
time.sleep(120)
"""


@pytest.mark.parametrize("launcher", ["jax", "port"])
def test_launcher_dumps_before_tearing_down_a_hung_job(tmp_path, launcher):
    script = tmp_path / "job.py"
    script.write_text(_HUNG_JOB)
    tel = tmp_path / "tel"
    tel.mkdir()
    env = _port_env(tel)
    env.update(MXTPU_TEARDOWN_GRACE="5", MXTPU_DUMP_GRACE="1")
    head = [sys.executable, os.path.join(ROOT, "mxnet_tpu_torch",
                                         "launch.py")] \
        if launcher == "port" else [sys.executable,
                                    os.path.join(ROOT, "tools", "launch.py")]
    out = subprocess.run(head + ["-n", "2", "--", sys.executable,
                                 str(script)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 3, out.stderr[-3000:]
    with open(tel / "launcher-events.jsonl") as f:
        events = [json.loads(line) for line in f]
    teardown = [e for e in events if e["event"] == "launcher_teardown"]
    assert len(teardown) == 1
    fields = teardown[0]["fields"]
    assert fields["dump_first"] is True and fields["live"] == 1
    assert sorted(fields) == ["dump_first", "generation", "grace_s", "live"]
    dumps = [f for f in os.listdir(tel) if f.startswith("flightrec-rank1")]
    assert dumps, os.listdir(tel)
    spans = [e for e in events if e["event"] == "span"]
    assert [e["fields"]["name"] for e in spans] == ["launch.generation"]
    assert spans[0]["fields"]["attrs"] == {"generation": 0, "rc": 3}
