"""Training resilience of the PyTorch port (`parallel.resilience`,
`DistributedTrainer`'s checkpoints, `Module.fit(checkpoint_dir=,
resume=)`) against the JAX package's, on the CPU.

* The on-disk format: a `CheckpointManager` directory either package
  writes (a `Module`'s ``save_params`` as ``data.params``) is found by the
  other's `latest` and restored into its `Module` bit for bit; ``meta.json``
  has the same keys and version, and its crc32s equal a recomputation
  (the ``rng`` entry is each package's own generator state, so a
  cross-package restore passes ``restore_rng=False``).
* Retention, discovery, the corruption fallback, a partial write and the
  rank gating; the fault grammar, ``exc`` with its generation gating,
  ``corrupt_ckpt`` and ``slow_batch``; the async writer (its one named
  daemon thread, flush, an error re-raised, ``MXTPU_CKPT_ASYNC=0``); the
  sharded format (fast and elastic restore, and the refusals between the
  plain and sharded formats): each scenario runs through both packages
  and both must observe the same (the JAX package's
  ``tests/test_resilience.py`` and ``tests/test_preempt_elastic.py``).
* In subprocesses that import only the port: ``kill_during_ckpt`` leaves
  the previous step the newest (both formats) and the preemption handler's
  exit codes (83, and 84 when the emergency save fails).
* ``fit(checkpoint_dir=)`` for 2 epochs, then ``resume="auto"`` to 4,
  equals the port's uninterrupted 4 epochs bit for bit, and that run the
  JAX package's within the module tests' tolerance (rtol 1e-4, floor 1e-4
  x the largest magnitude). A `fit` over a shuffled `StreamDataIter`
  behind the device prefetcher, its producer stalled by ``slow_batch`` and
  preempted at update 5 through the port's launcher (this file is the
  worker), restarts for free, resumes at the exact data cursor and ends
  equal to the uninterrupted run.
* `DistributedTrainer`: `save_states` / `load_states` and the checkpoint
  directory round-trip to an equal next step; a states blob the JAX
  trainer writes (SGD with momentum) loads into the port, whose next step
  equals the JAX trainer's within the trainer parity tests' rtol 2e-4 /
  atol 2e-5 (the leaves are laid out alike: no difference to name); the
  sharded snapshot restores on the same mesh and elastically.
* Elastic resume over gloo (the JAX ``test_preempt_elastic_group_e2e``'s
  chain A): 2 CPU ranks of the port's launcher train through
  ``gluon.Trainer(kvstore="dist_sync")`` with sharded checkpoints; rank 1
  is preempted at step 7, its solo emergency checkpoint restarts the group
  for free, and both ranks resume elastically (1 shard -> 2 ranks) to step
  12 with every weight sum equal to the one-rank run's.

The subprocesses start together in a module fixture, so their imports
overlap the in-process tests. JAX is imported inside the tests only: the
file run as a worker (``--worker NAME``) imports the port alone.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import resilience as tres

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMEOUT = 240
TOL = 1e-4
RTOL, ATOL = 2e-4, 2e-5


def _jax():
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import resilience as jres

    return jmx, jres


def _both():
    jmx, jres = _jax()
    return (("jax", jmx, jres), ("port", mx, tres))


def _err(m):
    return m.base.MXNetError


@pytest.fixture(autouse=True)
def _clean_fault_env(monkeypatch):
    """The port's arrays on the host; no injection, rank or generation
    from the environment; both fault caches parsed afresh."""
    for k in ("MXTPU_FAULT_INJECT", "MXTPU_PROCESS_ID",
              "MXTPU_RESTART_GENERATION", "MXTPU_CKPT_ASYNC",
              "MXTPU_CKPT_DIR"):
        monkeypatch.delenv(k, raising=False)
    for _, _, res in _both():
        monkeypatch.setattr(res, "_fault_cache", res._UNPARSED)
    with mx.context.scope(mx.cpu()):
        yield


@pytest.fixture(autouse=True)
def _keep_sigterm():
    """A fit with checkpoints installs the preemption handler: this
    process's SIGTERM handler and the port's preemption state are put back
    after each test."""
    import signal

    before = signal.getsignal(signal.SIGTERM)
    state = dict(tres._PREEMPT)
    yield
    signal.signal(signal.SIGTERM, before)
    tres._PREEMPT.clear()
    tres._PREEMPT.update(state)


def _arm(monkeypatch, spec):
    monkeypatch.setenv("MXTPU_FAULT_INJECT", spec)
    for _, _, res in _both():
        monkeypatch.setattr(res, "_fault_cache", res._UNPARSED)


# ---------------------------------------------------------------------------
# subprocesses: started together, waited for by their tests
# ---------------------------------------------------------------------------

def _env(**extra):
    env = dict(os.environ)
    env.setdefault("MXTPU_RENDEZVOUS_TIMEOUT", "60")
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    for k in ("MXTPU_NUM_WORKERS", "MXTPU_PROCESS_ID", "MXTPU_COORDINATOR",
              "DMLC_ROLE", "WORLD_SIZE", "RANK", "MXTPU_FAULT_INJECT",
              "MXTPU_RESTART_GENERATION", "MXTPU_TELEMETRY_DIR",
              "MXTPU_DATA_PREFETCH"):
        env.pop(k, None)
    env.update(extra)
    return env


def _worker(name, *args):
    return [sys.executable, os.path.abspath(__file__), "--worker", name] \
        + [str(a) for a in args]


def _launch(args, command):
    return [sys.executable, "-m", "mxnet_tpu_torch.launch"] + args + ["--"] \
        + command


class _Job:
    """A subprocess whose output goes to a file (no pipe to fill)."""

    def __init__(self, argv, path, **env):
        self.path = path
        self._f = open(path, "w")
        self.proc = subprocess.Popen(argv, cwd=_ROOT, env=_env(**env),
                                     stdout=self._f,
                                     stderr=subprocess.STDOUT)

    def result(self):
        try:
            self.proc.wait(timeout=_TIMEOUT)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._f.close()
        with open(self.path) as f:
            return self.proc.returncode, f.read()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._f.close()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resilience_jobs")
    recs = str(tmp / "recs")
    _make_recs(recs)
    out = {"tmp": tmp, "recs": recs}
    started = {}
    for fmt in ("plain", "sharded"):
        started["kill_" + fmt] = _Job(
            _worker("kill_ckpt", fmt, tmp / ("kill_" + fmt)),
            str(tmp / ("kill_%s.log" % fmt)),
            MXTPU_FAULT_INJECT="kill_during_ckpt@step=2")
    for mode in ("ok", "boom"):
        started["preempt_" + mode] = _Job(
            _worker("preempt", mode, tmp / ("saved_" + mode)),
            str(tmp / ("preempt_%s.log" % mode)),
            MXTPU_PREEMPT_GRACE_S="7.5", MXTPU_PREEMPT_EXIT_CODE="83")
    started["fit"] = _Job(
        _launch(["-n", "1", "--max-restarts", "1", "--restart-backoff",
                 "0.1"], _worker("fit", tmp / "fit_ckpt", recs)),
        str(tmp / "fit.log"),
        MXTPU_FAULT_INJECT="slow_batch@step=3,ms=60;preempt@step=5,grace=30",
        MXTPU_DATA_PREFETCH="1")
    started["elastic"] = _Job(
        _launch(["-n", "2", "--max-restarts", "1", "--restart-backoff",
                 "0.2"], _worker("elastic", tmp / "elastic_ckpt")),
        str(tmp / "elastic.log"),
        MXTPU_FAULT_INJECT="preempt@step=7,rank=1,grace=30",
        MXTPU_TEARDOWN_GRACE="3", MXTPU_CKPT_SHARD_TIMEOUT_S="60")
    out.update(started)
    yield out
    for job in started.values():
        job.stop()


# ---------------------------------------------------------------------------
# the on-disk format, both ways
# ---------------------------------------------------------------------------

_X = np.random.RandomState(0).uniform(-1, 1, (128, 6)).astype(np.float32)
_Y = (_X.sum(axis=1) > 0).astype(np.float32)


def _mlp(m):
    with m.name.NameManager():
        h = m.sym.FullyConnected(m.sym.var("data"), num_hidden=8,
                                 name="fc1")
        h = m.sym.Activation(h, act_type="relu")
        h = m.sym.FullyConnected(h, num_hidden=2, name="fc2")
        return m.sym.SoftmaxOutput(h, name="softmax")


def _bound(m):
    it = m.io.NDArrayIter(_X, _Y, batch_size=32, label_name="softmax_label")
    mod = m.mod.Module(_mlp(m), context=m.cpu())
    mod.bind(it.provide_data, it.provide_label)
    return mod


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_directories_restore_across_packages(tmp_path, writer):
    pkgs = {name: (m, res) for name, m, res in _both()}
    (wm, wres), = [v for k, v in pkgs.items() if k == writer]
    (rm, rres), = [v for k, v in pkgs.items() if k != writer]
    np.random.seed(1)
    wm.random.seed(1)
    wmod = _bound(wm)
    wmod.init_params(wm.init.Xavier())
    d = str(tmp_path)
    path = wres.CheckpointManager(d).save(
        3, save_params=wmod.save_params,
        save_states=lambda f: open(f, "wb").write(b"opaque"),
        meta={"epoch": 3})
    rmgr = rres.CheckpointManager(d)
    assert rmgr.latest() == (3, path)
    header = rmgr.read_meta(path)
    assert sorted(header) == ["crc32", "meta", "rng", "step", "time",
                              "version"]
    assert header["version"] == wres.CKPT_FORMAT_VERSION \
        == rres.CKPT_FORMAT_VERSION
    assert header["step"] == 3 and header["meta"] == {"epoch": 3}
    for name, crc in header["crc32"].items():
        with open(os.path.join(path, name), "rb") as f:
            assert zlib.crc32(f.read()) & 0xFFFFFFFF == crc, name
    rmod = _bound(rm)
    rmod.init_params(rm.init.Uniform(0.5))
    got = rmgr.restore(load_params=rmod.load_params, restore_rng=False)
    assert got["step"] == 3
    want, have = wmod.get_params()[0], rmod.get_params()[0]
    assert sorted(want) == sorted(have)
    for k in want:
        np.testing.assert_array_equal(have[k].asnumpy(), want[k].asnumpy())


# ---------------------------------------------------------------------------
# retention, latest, the corruption fallback, partial writes, rank gating
# ---------------------------------------------------------------------------

def _save_step(m, mgr, step, val):
    return mgr.save(
        step,
        save_params=lambda f: m.nd.save(
            f, {"w": m.nd.array([val] * 4, ctx=m.cpu())}),
        save_states=lambda f: open(f, "wb").write(b"S%d" % step),
        meta={"epoch": step})


def _scenario(name, m, res, d, monkeypatch):
    """What one package observes in scenario ``name`` in directory ``d``."""
    seen = []
    if name == "retention":
        mgr = res.CheckpointManager(d, keep_last=2)
        for s in (1, 2, 3, 4, 5):
            seen.append(os.path.basename(_save_step(m, mgr, s, float(s))))
        seen.append(sorted(os.listdir(d)))
        step, path = mgr.latest()
        header = mgr.read_meta(path)
        assert header["rng"]["seed"] == m.random.current_seed()
        seen += [step, header["meta"]]
    elif name == "corruption":
        mgr = res.CheckpointManager(d, keep_last=3)
        for s in (2, 4):
            _save_step(m, mgr, s, float(s))
        _, newest = mgr.latest()
        pf = os.path.join(newest, "data.params")
        with open(pf, "r+b") as fh:
            fh.seek(os.path.getsize(pf) // 2)
            fh.write(b"\xde\xad")
        seen.append(mgr.latest()[0])
        seen.append(mgr._verify_reason(newest).split(" (")[0])
        with pytest.raises(_err(m), match="failed verification"):
            mgr.restore(step=4)
        got = {}
        header = mgr.restore(
            load_params=lambda f: got.update(
                w=m.nd.load(f)["w"].asnumpy()),
            load_states=lambda f: got.update(s=open(f, "rb").read()))
        seen += [header["step"], got["w"].tolist(), got["s"]]
    elif name == "partial":
        mgr = res.CheckpointManager(d, keep_last=3)
        _save_step(m, mgr, 1, 1.0)
        stale = os.path.join(d, ".tmp-ckpt-00000009-dead")
        os.makedirs(stale)
        open(os.path.join(stale, "data.params"), "wb").write(b"torn")
        seen.append(mgr.latest()[0])
        _save_step(m, mgr, 2, 2.0)
        seen += [os.path.exists(stale), mgr.latest()[0]]
    elif name == "rank":
        monkeypatch.setenv("MXTPU_PROCESS_ID", "1")
        mgr = res.CheckpointManager(d, keep_last=2)
        seen += [_save_step(m, mgr, 1, 1.0), os.listdir(d)]
        mgr2 = res.CheckpointManager(d, keep_last=2, rank0_only=False)
        seen.append(os.path.basename(_save_step(m, mgr2, 1, 1.0)))
        monkeypatch.delenv("MXTPU_PROCESS_ID")
    return seen


@pytest.mark.parametrize("name", ["retention", "corruption", "partial",
                                  "rank"])
def test_manager_scenarios_match_jax(tmp_path, monkeypatch, name):
    got = {}
    for pkg, m, res in _both():
        d = str(tmp_path / pkg)
        os.makedirs(d)
        got[pkg] = _scenario(name, m, res, d, monkeypatch)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

_SPECS = ["kill@step=7,rank=1",
          "preempt@step=7,rank=1,grace=30 kill_during_ckpt@step=4,rank=0",
          "exc@step=3 corrupt_ckpt@step=5,dir=/tmp/x",
          "slow_batch@step=3,ms=60;preempt@step=5,grace=30",
          "explode@step=1", "kill@rank=1", "kill_replica@step=3",
          "kill@step=x"]


def _fault_run(name, m, res, d, monkeypatch):
    seen = []
    if name == "spec":
        for spec in _SPECS:
            try:
                seen.append(res.fault_spec(spec))
            except _err(m) as e:
                seen.append(str(e))
    elif name == "exc_gen":
        _arm(monkeypatch, "exc@step=3,rank=0")
        seen.append(res.maybe_inject_fault(2))
        with pytest.raises(_err(m), match="injected fault") as ei:
            res.maybe_inject_fault(3)
        seen.append(str(ei.value))
        monkeypatch.setenv("MXTPU_RESTART_GENERATION", "1")
        seen.append(res.maybe_inject_fault(3))
        monkeypatch.setenv("MXTPU_RESTART_GENERATION", "0")
        monkeypatch.setenv("MXTPU_PROCESS_ID", "1")
        seen.append(res.maybe_inject_fault(3))
    elif name == "corrupt_ckpt":
        mgr = res.CheckpointManager(d, keep_last=3)
        for s in (1, 2):
            _save_step(m, mgr, s, float(s))
        _arm(monkeypatch, "corrupt_ckpt@step=9,dir=%s" % d)
        res.maybe_inject_fault(9)
        seen.append(mgr.latest()[0])
    elif name == "slow_batch":
        _arm(monkeypatch, "slow_batch@step=2,ms=200")
        for batch in (1, 2):
            t0 = time.perf_counter()
            res.maybe_inject_data_stall(batch)
            seen.append(time.perf_counter() - t0 >= 0.2)
    return seen


@pytest.mark.parametrize("name", ["spec", "exc_gen", "corrupt_ckpt",
                                  "slow_batch"])
def test_fault_injection_matches_jax(tmp_path, monkeypatch, name):
    got = {}
    for pkg, m, res in _both():
        d = str(tmp_path / pkg)
        os.makedirs(d)
        got[pkg] = _fault_run(name, m, res, d, monkeypatch)
        monkeypatch.delenv("MXTPU_PROCESS_ID", raising=False)
        monkeypatch.delenv("MXTPU_RESTART_GENERATION", raising=False)
    assert got["port"] == got["jax"]


def test_the_producer_stall_is_absorbed_by_a_deep_buffer(monkeypatch):
    """``slow_batch`` stalls the port's `PrefetchBuffer` producer at its
    third batch; batches already staged are delivered without waiting
    (the JAX ``test_data_pipeline`` case)."""
    from mxnet_tpu_torch.data import PrefetchBuffer

    _arm(monkeypatch, "slow_batch@step=3,ms=300")
    items = iter(range(6))
    buf = PrefetchBuffer(lambda: next(items), depth=3, name="mxtpu-data-t3")
    assert buf.get() == 0
    time.sleep(0.1)
    t0 = time.perf_counter()
    assert buf.get() == 1 and buf.get() == 2
    assert time.perf_counter() - t0 < 0.25
    assert [buf.get() for _ in range(3)] == [3, 4, 5]
    buf.close()


# ---------------------------------------------------------------------------
# the async writer and the sharded format
# ---------------------------------------------------------------------------

def _writer_run(m, res, d, monkeypatch):
    import threading

    seen = []
    mgr = res.CheckpointManager(os.path.join(d, "a"), keep_last=3)
    seen.append(mgr._async_writer is None)
    mgr.save_sharded_async(2, {"w": np.arange(4.0)}, rank=0, world_size=1,
                           topology={"world_size": 1})
    w = mgr._async_writer
    seen += [w._thread.name, w._thread.daemon, mgr.flush(timeout=30),
             mgr.latest()[0], mgr.close(), w._thread.is_alive(),
             [t.name for t in threading.enumerate()
              if t.name == "mxtpu-ckpt-writer" and t.is_alive()]]
    bad = res.CheckpointManager(os.path.join(d, "b"), keep_last=3)
    bad.save_sharded_async(1, {"bad": lambda: None}, rank=0, world_size=1)
    with pytest.raises(Exception) as ei:
        bad.flush(timeout=30)
    seen.append(type(ei.value).__name__)
    seen.append(bad.latest())
    bad.close()
    monkeypatch.setenv("MXTPU_CKPT_ASYNC", "0")
    sync = res.CheckpointManager(os.path.join(d, "c"), keep_last=3)
    sync.save_sharded_async(3, {"w": np.ones(2)}, rank=0, world_size=1)
    seen += [sync._async_writer is None, sync.latest()[0]]
    monkeypatch.delenv("MXTPU_CKPT_ASYNC")
    return seen


def _sharded_run(m, res, d):
    seen = []
    topo = {"world_size": 2}
    mgr1 = res.CheckpointManager(d, keep_last=3)
    seen.append(mgr1.save_sharded(4, {"rank": 1}, rank=1, world_size=2,
                                  topology=topo))
    mgr0 = res.CheckpointManager(d, keep_last=3)
    path = mgr0.save_sharded(4, {"rank": 0}, rank=0, world_size=2,
                             topology=topo)
    header = mgr0.read_meta(path)
    seen += [mgr0.latest()[0], header["format"], header["shards"],
             header["world_size"], header["topology"], sorted(header)]
    got = {}
    hdr = mgr0.restore_sharded(lambda p, h: got.update(p), rank=1,
                               world_size=2, topology=topo)
    seen += [hdr["step"], dict(got)]
    got.clear()
    hdr = mgr0.restore_sharded(lambda p, h: got.update(p), rank=0,
                               world_size=1, topology={"world_size": 1})
    seen += [hdr["step"], dict(got)]
    plain = res.CheckpointManager(os.path.join(d, "plain"), keep_last=3)
    plain.save(1, save_params=lambda p: open(p, "wb").write(b"x"))
    for call in (lambda: mgr0.restore(load_params=lambda p: None),
                 lambda: plain.restore_sharded(lambda p, h: None)):
        with pytest.raises(_err(m)) as ei:
            call()
        seen.append(re.sub(r"/\S+", "PATH", str(ei.value)))
    return seen


@pytest.mark.parametrize("what", ["async_writer", "sharded"])
def test_async_and_sharded_formats_match_jax(tmp_path, monkeypatch, what):
    got = {}
    for pkg, m, res in _both():
        d = str(tmp_path / pkg)
        os.makedirs(d)
        got[pkg] = _writer_run(m, res, d, monkeypatch) \
            if what == "async_writer" else _sharded_run(m, res, d)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# crash consistency and the preemption handler, in subprocesses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["plain", "sharded"])
def test_kill_during_ckpt_leaves_the_previous_step(jobs, fmt):
    rc, out = jobs["kill_" + fmt].result()
    assert rc == 42, out
    assert "UNREACHABLE" not in out
    d = str(jobs["tmp"] / ("kill_" + fmt))
    mgr = tres.CheckpointManager(d, keep_last=4)
    assert mgr.latest()[0] == 1
    if fmt == "sharded":
        mgr.save_sharded(2, {"v": 2}, rank=0, world_size=1)
        got = {}
        mgr.restore_sharded(lambda p, h: got.update(p))
        assert got == {0: {"v": 2}}
    else:
        mgr.save(2, save_params=lambda p: open(p, "wb").write(b"v2"))
        assert mgr.latest()[0] == 2


@pytest.mark.parametrize("mode,rc_delta", [("ok", 0), ("boom", 1)])
def test_preempt_handler_rc_contract(jobs, mode, rc_delta):
    rc, out = jobs["preempt_" + mode].result()
    assert rc == 83 + rc_delta, out
    assert "UNREACHABLE" not in out
    assert os.path.exists(jobs["tmp"] / ("saved_" + mode)) == (mode == "ok")


# ---------------------------------------------------------------------------
# Module.fit with checkpoints
# ---------------------------------------------------------------------------

def _init_params():
    """Xavier from the JAX package's module (numpy's generator seeded):
    the start of every fit below."""
    jmx, _ = _jax()
    np.random.seed(42)
    jmod = _bound(jmx)
    jmod.init_params(jmx.init.Xavier())
    return {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}


def _fit(m, init, num_epoch, ckpt=None, resume=None):
    train = m.io.NDArrayIter(_X, _Y, batch_size=32,
                             label_name="softmax_label")
    mod = m.mod.Module(_mlp(m), context=m.cpu())
    mod.fit(train, num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: m.nd.array(v, ctx=m.cpu())
                        for k, v in init.items()},
            checkpoint_dir=None if ckpt is None else str(ckpt),
            resume=resume)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_fit_resume_equals_the_uninterrupted_fit_and_jax(tmp_path):
    jmx, _ = _jax()
    init = _init_params()
    mx.random.seed(7)
    ref = _fit(mx, init, 4, tmp_path / "ref")
    _fit(mx, init, 2, tmp_path / "resume")
    mgr = tres.CheckpointManager(str(tmp_path / "resume"))
    assert mgr.latest()[0] == 1
    assert mgr.read_meta(mgr.latest()[1])["meta"] == {"epoch": 1}
    got = _fit(mx, init, 4, tmp_path / "resume", resume="auto")
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    want = _fit(jmx, init, 4)
    for k in ref:
        floor = TOL * float(np.abs(want[k]).max())
        np.testing.assert_allclose(ref[k], want[k], rtol=TOL, atol=floor,
                                   err_msg=k)
    # an explicit epoch that does not verify raises
    with pytest.raises(MXNetError, match="failed verification"):
        _fit(mx, init, 4, tmp_path / "resume", resume=9)


def _make_recs(dirname, counts=(16, 16, 16), feat=6):
    """Record files of (float32[feat] data, label), from the record id."""
    from mxnet_tpu_torch import recordio

    rng = np.random.RandomState(0)
    os.makedirs(dirname, exist_ok=True)
    gid = 0
    for f, n in enumerate(counts):
        w = recordio.MXIndexedRecordIO(
            os.path.join(dirname, "part%d.idx" % f),
            os.path.join(dirname, "part%d.rec" % f), "w")
        for k in range(n):
            data = rng.uniform(-1, 1, (feat,)).astype(np.float32)
            w.write_idx(k, recordio.pack(
                recordio.IRHeader(0, float(data.sum() > 0), gid, 0),
                data.tobytes()))
            gid += 1
        w.close()


def _decode_sample(raw):
    from mxnet_tpu_torch import recordio

    header, payload = recordio.unpack(raw)
    return np.frombuffer(payload, dtype=np.float32), np.float32(header.label)


def _run_stream_fit(ckpt_dir, rec_dir, resume=None):
    """A 2-epoch MLP fit over a shuffled `StreamDataIter` of 48 records in
    batches of 8 with checkpoints; the final absolute weight sum as a
    %.17g string."""
    from mxnet_tpu_torch.data import ShardedRecordStream, StreamDataIter

    paths = [os.path.join(rec_dir, "part%d.rec" % f) for f in range(3)]
    with mx.context.scope(mx.cpu()):
        mx.random.seed(42)
        np.random.seed(42)
        train = StreamDataIter(
            ShardedRecordStream(paths, shuffle=True, seed=5), batch_size=8,
            decode_fn=_decode_sample, data_shape=(6,))
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mod.fit(train, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                initializer=mx.init.Xavier(),
                checkpoint_dir=str(ckpt_dir), resume=resume)
        train.close()
        w = mod.get_params()[0]
    return "%.17g" % sum(float(np.abs(v.asnumpy()).sum()) for v in w.values())


def test_preempted_fit_resumes_at_the_exact_data_cursor(jobs, monkeypatch):
    """Generation 0 is preempted at update 5 (mid-epoch 0, its producer
    stalled at batch 3); its emergency checkpoint holds batches_done 5 and
    the cursor 40; the launcher restarts it for free, and generation 1
    resumes there and ends equal to the uninterrupted fit."""
    monkeypatch.setenv("MXTPU_DATA_PREFETCH", "1")
    ref = _run_stream_fit(jobs["tmp"] / "fit_ref", jobs["recs"])
    rc, out = jobs["fit"].result()
    assert rc == 0, out[-4000:]
    assert "group preempted (rc=83)" in out, out[-4000:]
    assert "restart budget untouched: 0/1 used" in out, out[-4000:]
    m = re.search(r"FIT_RESUME gen=1 step=0 preempt=True batches_done=5 "
                  r"cursor=(\{.*\})", out)
    assert m, out[-4000:]
    cursor = json.loads(m.group(1))
    assert cursor["epoch"] == 0 and cursor["pos"] == 5 * 8
    assert "FIT_DONE gen=0" not in out
    got = re.findall(r"FIT_DONE gen=1 wsum=(\S+)", out)
    assert got == [ref], (got, ref, out[-4000:])


# ---------------------------------------------------------------------------
# DistributedTrainer's states and checkpoints
# ---------------------------------------------------------------------------

def _dense_net(m, ctx):
    net = m.gluon.nn.HybridSequential(prefix="rz_")
    with net.name_scope():
        net.add(m.gluon.nn.Dense(8, in_units=5, activation="relu",
                                 prefix="d1_"))
        net.add(m.gluon.nn.Dense(3, in_units=8, prefix="d2_"))
    net.initialize(m.init.Xavier(), ctx=ctx)
    return net


def _dense_batch(step):
    rng = np.random.RandomState(100 + step)
    return (rng.randn(16, 5).astype(np.float32),
            rng.randint(0, 3, (16,)).astype(np.float32))


def _port_trainer(params_file):
    net = _dense_net(mx, mx.cpu())
    net.load_parameters(params_file, ctx=mx.cpu())
    tr = mx.parallel.DistributedTrainer(
        net, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
        loss=mx.gluon.loss.SoftmaxCrossEntropyLoss())
    return net, tr


def _port_step(tr, step):
    x, y = _dense_batch(step)
    return float(tr.step(mx.nd.array(x, ctx=mx.cpu()),
                         mx.nd.array(y, ctx=mx.cpu())).asnumpy())


def _weights(net):
    return {k: v.data().asnumpy() for k, v in
            sorted(net._collect_params_with_prefix().items())}


def test_distributed_trainer_states_round_trip(tmp_path):
    np.random.seed(3)
    mx.random.seed(3)
    with mx.context.scope(mx.cpu()):
        net0 = _dense_net(mx, mx.cpu())
        net0.save_parameters(str(tmp_path / "init.params"))
        net, tr = _port_trainer(str(tmp_path / "init.params"))
        for s in (1, 2, 3):
            _port_step(tr, s)
        tr.save_states(str(tmp_path / "t.states"))
        net.save_parameters(str(tmp_path / "t.params"))
        tr.save_checkpoint(str(tmp_path / "ck"), step=3)
        mgr = tres.CheckpointManager(str(tmp_path / "sharded"))
        tr.save_sharded_checkpoint(mgr, meta={"kind": "test"})
        assert mgr.flush(timeout=30)
        ref_loss = [_port_step(tr, s) for s in (4, 5)]
        ref = _weights(net)
        blob = __import__("pickle").load(open(tmp_path / "t.states", "rb"))
        assert sorted(blob) == ["num_update", "states", "step"]
        assert blob["step"] == blob["num_update"] == 3
        assert all(isinstance(s, np.ndarray) for s in blob["states"])

        def resumed(load):
            net2, tr2 = _port_trainer(str(tmp_path / "init.params"))
            load(net2, tr2)
            assert tr2.step_count == 3
            loss = [_port_step(tr2, s) for s in (4, 5)]
            return loss, _weights(net2)

        for load in (
                lambda n, t: (n.load_parameters(str(tmp_path / "t.params")),
                              t.load_states(str(tmp_path / "t.states"))),
                lambda n, t: t.load_checkpoint(str(tmp_path / "ck"), 3),
                lambda n, t: t.restore_sharded_checkpoint(mgr)):
            loss, got = resumed(load)
            assert loss == ref_loss
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        mgr.close()


def test_a_jax_states_blob_loads_into_the_port(tmp_path):
    """The JAX `DistributedTrainer` trains 2 steps and writes its params
    and states; the port's trainer loads both and takes step 3, as the JAX
    trainer does, within rtol 2e-4 / atol 2e-5."""
    jmx, _ = _jax()
    np.random.seed(5)
    jmx.random.seed(5)
    jnet = _dense_net(jmx, jmx.cpu())
    jtr = jmx.parallel.DistributedTrainer(
        jnet, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
        loss=jmx.gluon.loss.SoftmaxCrossEntropyLoss())
    for s in (1, 2):
        x, y = _dense_batch(s)
        jtr.step(jmx.nd.array(x), jmx.nd.array(y))
    jtr.save_states(str(tmp_path / "j.states"))
    jtr.sync_params()
    jnet.save_parameters(str(tmp_path / "j.params"))
    x, y = _dense_batch(3)
    jloss = float(jtr.step(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())
    jtr.sync_params()
    want = _weights(jnet)
    with mx.context.scope(mx.cpu()):
        net, tr = _port_trainer(str(tmp_path / "j.params"))
        tr.load_states(str(tmp_path / "j.states"))
        assert tr.step_count == 2 and tr.optimizer.num_update == 2
        loss = _port_step(tr, 3)
        got = _weights(net)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# elastic resume over gloo, through the port's launcher
# ---------------------------------------------------------------------------

def test_preempted_rank_restarts_free_and_resumes_elastically(jobs):
    with tempfile.TemporaryDirectory() as d:
        ref = _elastic_run(d, total_steps=12, preempt=False)[0]
    rc, out = jobs["elastic"].result()
    assert rc == 0, out[-4000:]
    assert "group preempted (rc=83)" in out, out[-4000:]
    assert "restart budget untouched: 0/1 used" in out, out[-4000:]
    assert "emergency checkpoint" in out, out[-4000:]
    resumed = [ln for ln in out.splitlines() if "ELASTIC_RESUMED" in ln]
    assert len(resumed) == 2, out[-4000:]
    for ln in resumed:
        assert "gen=1 from_step=7 elastic=1 shards=1" in ln, ln
    sums = re.findall(r"ELASTIC_OK rank=(\d/2) gen=1 steps=12 wsum=(\S+)",
                      out)
    assert sorted(r for r, _ in sums) == ["0/2", "1/2"], out[-4000:]
    assert all(s == ref for _, s in sums), (sums, ref)


# ---------------------------------------------------------------------------
# the workers (this file run as a script imports the port only)
# ---------------------------------------------------------------------------

def _elastic_run(ckpt_dir, total_steps=12, every=2, preempt=True):
    """The JAX package's tests/elastic_worker.py on the port: linear
    regression through `gluon.Trainer` over a ``dist_sync`` store, every
    rank on the full batch (so the trajectory is the same at every world
    size), sharded checkpoints every ``every`` steps, a solo emergency
    checkpoint on preemption, an elastic restore at start. Returns the
    weight sum as a %.17g string, the rank, the world size and the
    steps."""
    from mxnet_tpu_torch import autograd, gluon

    kv = mx.kv.create("dist_sync")
    r, n = kv.rank, kv.num_workers
    topology = {"world_size": n}
    with mx.context.scope(mx.cpu()):
        np.random.seed(77)
        net = gluon.nn.Dense(1, in_units=8, use_bias=False)
        net.initialize(mx.init.Normal(0.5), ctx=mx.cpu(), seed=77)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9},
                                kvstore=kv)
        mgr = tres.CheckpointManager(ckpt_dir, keep_last=3,
                                     save_every=every)
        if preempt:
            tres.install_preemption_handler()

        def payload():
            fd, tmp = tempfile.mkstemp(prefix="trainer-states-")
            os.close(fd)
            try:
                trainer.save_states(tmp)
                with open(tmp, "rb") as f:
                    blob = f.read()
            finally:
                os.unlink(tmp)
            return {"params": {k: v.data().asnumpy()
                               for k, v in net.collect_params().items()},
                    "states_blob": blob, "step": trainer.step_count}

        def load_shards(payloads, header):
            # replicated parameters: any one shard holds the whole model
            p = payloads[min(payloads)]
            for k, v in net.collect_params().items():
                v.set_data(mx.nd.array(p["params"][k], ctx=mx.cpu()))
            fd, tmp = tempfile.mkstemp(prefix="trainer-states-")
            os.close(fd)
            try:
                with open(tmp, "wb") as f:
                    f.write(p["states_blob"])
                trainer.load_states(tmp)
            finally:
                os.unlink(tmp)

        header = mgr.restore_sharded(load_shards, rank=r, world_size=n,
                                     topology=topology)
        start = trainer.step_count
        if header is not None:
            elastic = not (header.get("topology") == topology
                           and int(header.get("shards") or 0) == n)
            print("ELASTIC_RESUMED rank=%d/%d gen=%d from_step=%d "
                  "elastic=%d shards=%d"
                  % (r, n, tres.restart_generation(), start, int(elastic),
                     int(header.get("shards") or 0)), flush=True)

        def emergency():
            mgr.flush()
            mgr.save_sharded(trainer.step_count, payload(), rank=0,
                             world_size=1, topology={"world_size": 1},
                             meta={"preempt": True})

        l2 = gluon.loss.L2Loss()
        w_true = np.arange(1, 9, dtype=np.float32).reshape(8, 1) / 8
        for step in range(start + 1, total_steps + 1):
            rng = np.random.RandomState(10000 + step)
            x = rng.normal(size=(16, 8)).astype(np.float32)
            with autograd.record():
                loss = l2(net(mx.nd.array(x, ctx=mx.cpu())),
                          mx.nd.array(x @ w_true, ctx=mx.cpu()))
            loss.backward()
            trainer.step(16 * n)   # the preempt action fires in here
            if step % every == 0:
                mgr.save_sharded_async(step, payload(), rank=r,
                                       world_size=n, topology=topology)
            tres.maybe_preempt_exit(emergency_save=emergency, rank=r)
        mgr.close()
        w = net.weight.data().asnumpy()
    return "%.17g" % float(w.astype(np.float64).sum()), r, n, \
        trainer.step_count


_KILL_FORMATS = {
    "plain": lambda mgr, s: mgr.save(
        s, save_params=lambda p: open(p, "wb").write(b"v%d" % s)),
    "sharded": lambda mgr, s: mgr.save_sharded(s, {"v": s}, rank=0,
                                               world_size=1),
}


def _run_worker(name, args):
    import signal

    if name == "kill_ckpt":
        fmt, d = args
        mgr = tres.CheckpointManager(d, keep_last=4)
        _KILL_FORMATS[fmt](mgr, 1)
        _KILL_FORMATS[fmt](mgr, 2)
        print("UNREACHABLE past the step-2 save", flush=True)
    elif name == "preempt":
        mode, marker = args
        assert tres.install_preemption_handler()
        assert not tres.preemption_requested()
        tres.maybe_preempt_exit()   # nothing until SIGTERM lands
        os.kill(os.getpid(), signal.SIGTERM)
        assert tres.preemption_requested()
        assert tres.preempt_grace_s() == 7.5, tres.preempt_grace_s()

        def save_ok():
            open(marker, "w").write("saved")

        def save_boom():
            raise RuntimeError("disk gone")

        tres.maybe_preempt_exit(
            emergency_save=save_ok if mode == "ok" else save_boom)
        print("UNREACHABLE", flush=True)
    elif name == "fit":
        ckpt, recs = args
        gen = tres.restart_generation()
        found = tres.CheckpointManager(ckpt).latest()
        if found is not None:
            meta = tres.CheckpointManager(ckpt).read_meta(found[1])["meta"]
            print("FIT_RESUME gen=%d step=%d preempt=%s batches_done=%s "
                  "cursor=%s" % (gen, found[0], meta.get("preempt"),
                                 meta.get("batches_done"),
                                 json.dumps(meta.get("data_state"))),
                  flush=True)
        wsum = _run_stream_fit(ckpt, recs, resume="auto")
        print("FIT_DONE gen=%d wsum=%s" % (gen, wsum), flush=True)
    elif name == "elastic":
        wsum, r, n, steps = _elastic_run(args[0])
        print("ELASTIC_OK rank=%d/%d gen=%d steps=%d wsum=%s"
              % (r, n, tres.restart_generation(), steps, wsum), flush=True)
    else:
        raise SystemExit("unknown worker %r" % name)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        _run_worker(sys.argv[2], sys.argv[3:])
