"""Training resilience and fault injection (counterpart of
`mxnet_tpu/parallel/resilience.py`): crash-consistent checkpoints,
auto-resume, graceful preemption and deterministic fault injection.

Recovery rests on three pieces (docs/fault_tolerance.md):

  * the launcher (``python -m mxnet_tpu_torch.launch --max-restarts N``)
    tears the whole group down on the first failure and starts a fresh
    generation on a fresh rendezvous port; a worker that exits with the
    preemption code restarts the group without using the budget;
  * `CheckpointManager` keeps periodic crash-consistent checkpoints: a
    staged temp directory, fsync, one atomic rename, a crc32 a file and
    keep-last-N retention, holding the parameters, the optimizer or
    Trainer states, the random state and the step cursor. The on-disk
    format is the JAX package's: ``<prefix>-%08d/`` with ``data.params``
    (the ``nd.save`` container, which either package loads),
    ``trainer.states`` and ``meta.json`` written last. The ``rng`` entry of
    ``meta.json`` is this package's `random.get_state` (torch generator
    states), not the JAX package's threefry keys: each package restores
    its own;
  * auto-resume (`CheckpointManager.restore`, ``Module.fit(resume=
    "auto")``) continues from the newest COMPLETE checkpoint.

On top of that:

  * **async checkpoints**: `save_async` / `save_sharded_async` put the
    serialization, fsync and rename on ONE named background writer
    (``mxtpu-ckpt-writer``, at most one job queued behind the one in
    flight), so the training thread pays only the host snapshot;
  * **per-rank sharded checkpoints**: every rank stages its own
    ``shard-r<rank>.bin``, rank 0 publishes the manifest (``meta.json``,
    still last) with the mesh's `mesh_fingerprint` as ``topology``;
  * **graceful preemption**: `install_preemption_handler` +
    `maybe_preempt_exit` turn SIGTERM into: finish the step, an emergency
    checkpoint inside ``MXTPU_PREEMPT_GRACE_S``, exit
    ``MXTPU_PREEMPT_EXIT_CODE`` (83), which the launcher restarts for free;
  * **elastic resume**: `restore_sharded` hands the loader EVERY shard
    when the world size or topology changed, so the trainer reshards onto
    the new mesh (N -> M ranks).

``MXTPU_FAULT_INJECT`` fires each action the JAX package knows, at the
same boundaries: the training actions at a trainer's step boundary
(`maybe_inject_fault`), ``kill_during_ckpt`` inside the save paths,
``slow_batch`` in the input pipeline's producer
(`maybe_inject_data_stall`), the serving actions at a replica worker's
batch boundary (`maybe_inject_serving_fault`) and ``load_surge`` at a
model's publish (`maybe_inject_load_surge`):

    MXTPU_FAULT_INJECT="kill@step=7,rank=1"        hard exit of rank 1
    MXTPU_FAULT_INJECT="exc@step=3"                raise MXNetError
    MXTPU_FAULT_INJECT="hang@step=5,rank=1"        park the rank for good
    MXTPU_FAULT_INJECT="corrupt_ckpt@step=5,dir=D" flip a byte of the
                                                   newest checkpoint in D
    MXTPU_FAULT_INJECT="preempt@step=7,rank=1,grace=30"
                                                   SIGTERM at the boundary
    MXTPU_FAULT_INJECT="kill_during_ckpt@step=4"   die mid-save, before
                                                   the manifest publishes
    MXTPU_FAULT_INJECT="slow_batch@step=3,ms=200"  stall the producer
    MXTPU_FAULT_INJECT="kill_replica@batch=3,replica=0"
    MXTPU_FAULT_INJECT="wedge_replica@batch=5,replica=1"
    MXTPU_FAULT_INJECT="slow_reply@batch=2,ms=500"
    MXTPU_FAULT_INJECT="load_surge@after=0,rps=200,duration=3"

Conditions: ``step`` (training, checkpoint and data actions), ``batch``
(serving actions), ``after`` (``load_surge``), ``rank`` / ``replica``
(default any), ``gen`` (the supervision generation, default 0, so a
restarted run does not fire again), ``code`` (exit status of ``kill`` /
``kill_replica``, default 42), ``ms``, ``rps`` / ``duration``, ``dir``
(``corrupt_ckpt``'s directory, else ``MXTPU_CKPT_DIR``) and ``grace``
(``preempt``'s window, over ``MXTPU_PREEMPT_GRACE_S``).
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import zlib

from .. import env as _env
from .. import telemetry
from ..base import MXNetError, _fsync_dir, atomic_writer

__all__ = ["CheckpointManager", "maybe_inject_fault",
           "maybe_inject_serving_fault", "maybe_inject_load_surge",
           "fault_spec", "restart_generation",
           "install_preemption_handler", "preemption_requested",
           "maybe_preempt_exit", "preempt_exit_code", "preempt_grace_s"]

_LOG = logging.getLogger("mxnet_tpu_torch.resilience")

CKPT_FORMAT_VERSION = 1
_META = "meta.json"
_PARAMS = "data.params"
_STATES = "trainer.states"
_SHARD = "shard-r%05d.bin"
_SHARD_OK = "shard-r%05d.ok.json"
_WRITER_THREAD = "mxtpu-ckpt-writer"


def restart_generation():
    """Which supervision generation this process belongs to (0 = first
    launch); the launcher and the replica pools export
    ``MXTPU_RESTART_GENERATION`` on every respawn."""
    return _env.get("MXTPU_RESTART_GENERATION")


def _current_rank():
    """This process's rank from the launcher's environment (the fault
    hook runs every step, before any process group may exist)."""
    for name in ("MXTPU_PROCESS_ID", "DMLC_WORKER_ID", "OMPI_COMM_WORLD_RANK",
                 "PMI_RANK", "SLURM_PROCID"):
        v = _env.raw(name) if name.startswith("MXTPU_") \
            else os.environ.get(name)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


# ---------------------------------------------------------------------------
# the async checkpoint writer
# ---------------------------------------------------------------------------

class _AsyncCkptWriter:
    """One named daemon thread (``mxtpu-ckpt-writer``) that runs checkpoint
    jobs: at most one job queued behind the one in flight, and `submit`
    blocks while that slot is taken, so a slow disk slows the checkpoint
    cadence instead of piling up host snapshots. `close` flushes and
    joins it. A failed job's error is re-raised at the next `flush` or
    `submit`, so it never passes silently."""

    def __init__(self):
        self._cv = threading.Condition()
        self._job = None            # (fn, step) queued, not started
        self._busy = False          # a job is running
        self._closed = False
        self._error = None          # the first error a job raised
        self._submitted_step = None
        self._completed_step = None
        self._thread = threading.Thread(target=self._run,
                                        name=_WRITER_THREAD, daemon=True)
        self._thread.start()

    def submit(self, fn, step):
        with self._cv:
            if self._closed:
                raise MXNetError("async checkpoint writer is closed")
            self._raise_error_locked()
            while self._job is not None:   # at most one pending: block
                self._cv.wait()
                self._raise_error_locked()
            self._job = (fn, int(step))
            self._submitted_step = int(step)
            self._cv.notify_all()
        self._export_gauges()

    def flush(self, timeout=None):
        """Wait until every submitted job is written; False on timeout.
        Re-raises the first error a job hit."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._job is not None or self._busy:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
            self._raise_error_locked()
        return True

    def close(self, timeout=5.0):
        """`flush`, then stop and join the thread."""
        try:
            ok = self.flush(timeout)
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            self._thread.join(timeout)
        return ok and not self._thread.is_alive()

    def _raise_error_locked(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _run(self):
        while True:
            with self._cv:
                while self._job is None and not self._closed:
                    self._cv.wait()
                if self._job is None:
                    return  # closed and drained
                fn, step = self._job
                self._job = None
                self._busy = True
                self._cv.notify_all()
            try:
                fn()
            except BaseException as e:
                with self._cv:
                    self._error = e if isinstance(e, Exception) else \
                        MXNetError("async checkpoint writer died: %r" % (e,))
            finally:
                with self._cv:
                    self._busy = False
                    self._completed_step = step
                    self._cv.notify_all()
                self._export_gauges()
                telemetry.record_event("ckpt_async_complete", step=step)

    def _export_gauges(self):
        with self._cv:
            sub = self._submitted_step or 0
            done = self._completed_step or 0
            pending = (1 if self._job is not None else 0) + \
                (1 if self._busy else 0)
        # how far the newest durable checkpoint trails the newest snapshot
        telemetry.gauge("mxtpu_checkpoint_async_lag_steps").set(
            max(0, sub - done))
        telemetry.gauge("mxtpu_checkpoint_async_pending").set(pending)


def _file_crc(path, sync):
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
        if sync:
            os.fsync(f.fileno())
    return crc & 0xFFFFFFFF


def _dir_bytes(path, names=None):
    try:
        names = os.listdir(path) if names is None else names
        return sum(os.path.getsize(os.path.join(path, n)) for n in names
                   if os.path.exists(os.path.join(path, n)))
    except OSError:
        return 0


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Periodic crash-consistent checkpoints with discovery and retention.

    One directory a step under ``directory``::

        <directory>/<prefix>-00000006/
            data.params     parameters (the nd.save container; optional)
            trainer.states  the optimizer's or Trainer's states (optional)
            meta.json       written LAST: version, step, a crc32 a file,
                            the random state, the caller's metadata

    Everything is staged in a hidden temp directory on the same file
    system, every file is fsynced, ``meta.json`` is written last, and one
    atomic rename publishes the step: a process killed at any point leaves
    no trace (a stale temp directory, swept at the next save) or a
    complete checkpoint, never a torn one. `latest` verifies the checksums
    and skips incomplete or corrupt steps, so auto-resume lands on the
    newest complete state.

    The payloads are the caller's writers and loaders::

        gluon:  mgr.save(step, save_params=net.save_parameters,
                         save_states=trainer.save_states)
        module: Module.fit(checkpoint_dir=..., resume="auto")
        mesh:   mgr.save(step, save_states=distributed_trainer.save_states)

    Over several processes only rank 0 writes by default (``rank0_only``:
    data-parallel replicas are identical), and every rank restores from
    the shared directory. ``rng`` in ``meta.json`` is this package's
    `random.get_state` (the torch generators' states)."""

    def __init__(self, directory, keep_last=3, prefix="ckpt", save_every=None,
                 rank0_only=True):
        self._dir = os.path.abspath(os.fspath(directory))
        if keep_last is not None and keep_last < 1:
            raise MXNetError("keep_last must be >= 1 (or None for unlimited)")
        self._keep_last = keep_last
        self._prefix = prefix
        self._save_every = save_every
        self._rank0_only = rank0_only
        self._async_writer = None  # started at the first async save
        os.makedirs(self._dir, exist_ok=True)

    # -- naming ------------------------------------------------------------
    @property
    def directory(self):
        return self._dir

    def step_path(self, step):
        return os.path.join(self._dir, "%s-%08d" % (self._prefix, int(step)))

    def _step_of(self, name):
        tag = self._prefix + "-"
        if not name.startswith(tag):
            return None
        try:
            return int(name[len(tag):])
        except ValueError:
            return None

    def _all_steps(self):
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        steps = [(s, os.path.join(self._dir, n)) for n in names
                 for s in [self._step_of(n)] if s is not None]
        return sorted(steps, reverse=True)

    # -- save --------------------------------------------------------------
    def maybe_save(self, step, **kwargs):
        """`save` when ``step`` is a multiple of ``save_every``."""
        if self._save_every is None or step % self._save_every != 0:
            return None
        return self.save(step, **kwargs)

    def save(self, step, save_params=None, save_states=None, meta=None):
        """Write one crash-consistent checkpoint; returns its path (None on
        a rank other than 0 with ``rank0_only``)."""
        from .. import random as _random

        if self._rank0_only and _current_rank() != 0:
            return None
        t0 = time.perf_counter()
        self._sweep_stale_tmp()
        tmp = tempfile.mkdtemp(dir=self._dir,
                               prefix=".tmp-%s-%08d-" % (self._prefix, step))
        try:
            files = {}
            if save_params is not None:
                save_params(os.path.join(tmp, _PARAMS))
                files[_PARAMS] = None
            if save_states is not None:
                save_states(os.path.join(tmp, _STATES))
                files[_STATES] = None
            for name in files:
                files[name] = _file_crc(os.path.join(tmp, name), sync=True)
            # the chaos hook: payload staged, meta.json not written, the
            # window where a torn write would show if the format were not
            # crash-consistent
            _maybe_kill_during_ckpt(step)
            header = {
                "version": CKPT_FORMAT_VERSION,
                "step": int(step),
                "time": time.time(),
                "crc32": files,
                "rng": _random.get_state(),
                "meta": dict(meta or {}),
            }
            with atomic_writer(os.path.join(tmp, _META), "w") as f:
                json.dump(header, f, indent=1)
            _fsync_dir(tmp)
            final = self.step_path(step)
            if os.path.exists(final):
                # the same step saved again (a resumed run reaching a saved
                # step): the new one replaces it
                shutil.rmtree(final)
            os.replace(tmp, final)
            tmp = None
            _fsync_dir(self._dir)
        finally:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
        # measured before retention, which may delete the step just
        # published (a resume pinned before newer checkpoints)
        nbytes = _dir_bytes(final)
        self._retain()
        self._observe_save(step, final, nbytes, time.perf_counter() - t0)
        return final

    def _observe_save(self, step, final, nbytes, seconds, **extra):
        # inside a traced step or run, the save is a child span
        telemetry.tracing.emit_span(
            "train.checkpoint", time.time() - seconds, seconds,
            telemetry.tracing.current(), component="train",
            attrs=dict({"step": int(step), "bytes": nbytes},
                       **({"sharded": True} if extra else {})))
        telemetry.histogram("mxtpu_checkpoint_seconds",
                            {"what": "save"}).observe(seconds)
        telemetry.counter("mxtpu_checkpoint_bytes_total",
                          {"what": "save"}).inc(nbytes)
        self._observe_stall(seconds)
        telemetry.record_event("checkpoint_save", step=int(step),
                               seconds=round(seconds, 4), bytes=nbytes,
                               path=final, **extra)

    @staticmethod
    def _observe_stall(seconds):
        """A save on the background writer costs the training loop
        nothing: only the saves of other threads count as its stall."""
        if threading.current_thread().name != _WRITER_THREAD:
            telemetry.histogram("mxtpu_checkpoint_stall_seconds",
                                {"mode": "sync"}).observe(seconds)
            telemetry.goodput.add("checkpoint_stall", seconds)

    def _sweep_stale_tmp(self):
        """Remove the staging directories a killed generation left. The
        sharded staging directories carry their generation, and only other
        generations' are swept (this one's may be in flight on the
        writer), so a dead generation's half-staged shards never satisfy
        this one's manifest."""
        gen_tag = "-g%d" % restart_generation()
        for name in os.listdir(self._dir):
            if name.startswith(".tmp-%s-" % self._prefix) or (
                    name.startswith(".shards-%s-" % self._prefix)
                    and not name.endswith(gen_tag)):
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)

    def _retain(self):
        if self._keep_last is None:
            return
        kept = 0
        for _, path in self._all_steps():
            # only the cheap check (meta.json parses): a published
            # directory is complete by construction; latest() and restore()
            # still verify the checksums before anything is trusted
            if kept < self._keep_last and self._meta_ok(path):
                kept += 1
                continue
            # an incomplete entry counts for nothing, and goes only once a
            # newer complete checkpoint protects the history
            if kept > 0:
                shutil.rmtree(path, ignore_errors=True)

    def _meta_ok(self, path):
        try:
            with open(os.path.join(path, _META)) as f:
                return json.load(f).get("version") == CKPT_FORMAT_VERSION
        except (OSError, ValueError):
            return False

    # -- discovery and verification ----------------------------------------
    def verify(self, path):
        """True when ``path`` is a complete checkpoint whose files match
        the checksums recorded at save time."""
        return self._verify_reason(path) is None

    def _verify_reason(self, path):
        try:
            with open(os.path.join(path, _META)) as f:
                header = json.load(f)
        except (OSError, ValueError) as e:
            return "unreadable meta.json (%s)" % (e,)
        if header.get("version") != CKPT_FORMAT_VERSION:
            return "format version %r != %d" % (header.get("version"),
                                                CKPT_FORMAT_VERSION)
        for name, crc in (header.get("crc32") or {}).items():
            try:
                got = _file_crc(os.path.join(path, name), sync=False)
            except OSError as e:
                return "missing payload %s (%s)" % (name, e)
            if got != crc:
                return "checksum mismatch on %s (stored %d, got %d)" % (
                    name, crc, got)
        return None

    def latest(self):
        """(step, path) of the newest COMPLETE checkpoint, or None. Corrupt
        or partly written steps are skipped with a warning."""
        for step, path in self._all_steps():
            reason = self._verify_reason(path)
            if reason is None:
                return step, path
            _LOG.warning("skipping corrupt checkpoint %s: %s", path, reason)
        return None

    def read_meta(self, path):
        with open(os.path.join(path, _META)) as f:
            return json.load(f)

    def _resolve(self, step):
        """(step, path) to restore: the newest complete one for None (None
        when there is none), else ``step``, which must verify."""
        if step is None:
            return self.latest()
        path = self.step_path(step)
        reason = self._verify_reason(path)
        if reason is not None:
            raise MXNetError(
                "checkpoint %s failed verification: %s" % (path, reason))
        return step, path

    def _observe_restore(self, step, path, files, t0, **extra):
        seconds = time.perf_counter() - t0
        nbytes = _dir_bytes(path, list(files))
        telemetry.histogram("mxtpu_checkpoint_seconds",
                            {"what": "restore"}).observe(seconds)
        telemetry.counter("mxtpu_checkpoint_bytes_total",
                          {"what": "restore"}).inc(nbytes)
        telemetry.record_event("checkpoint_restore", step=int(step),
                               seconds=round(seconds, 4), bytes=nbytes,
                               generation=restart_generation(), **extra)

    # -- restore -----------------------------------------------------------
    def restore(self, load_params=None, load_states=None, step=None,
                restore_rng=True):
        """Load a checkpoint (default: the newest complete one) through the
        caller's loaders; returns its header (step, meta, rng), or None
        when no complete checkpoint exists. An explicit ``step`` that fails
        verification raises `MXNetError` instead of falling back."""
        from .. import random as _random

        t0 = time.perf_counter()
        found = self._resolve(step)
        if found is None:
            return None
        step, path = found
        header = self.read_meta(path)
        if header.get("format") == "sharded" and (load_params is not None
                                                 or load_states is not None):
            raise MXNetError(
                "checkpoint %s is sharded (per-rank shards + manifest); "
                "load it with restore_sharded()" % path)
        files = header.get("crc32") or {}
        if load_params is not None and _PARAMS in files:
            load_params(os.path.join(path, _PARAMS))
        if load_states is not None and _STATES in files:
            load_states(os.path.join(path, _STATES))
        if restore_rng and header.get("rng"):
            _random.set_state(header["rng"])
        self._observe_restore(step, path, files, t0)
        return header

    # -- the async façade --------------------------------------------------
    @staticmethod
    def _async_on():
        return bool(_env.get("MXTPU_CKPT_ASYNC"))

    def _writer(self):
        w = self._async_writer
        if w is None or not w._thread.is_alive():
            w = self._async_writer = _AsyncCkptWriter()
        return w

    def flush(self, timeout=None):
        """Wait until every async save submitted so far is durable. True
        when nothing is pending, False on timeout; re-raises the first
        error a background save hit."""
        w = self._async_writer
        return True if w is None else w.flush(timeout)

    def close(self, timeout=5.0):
        """`flush`, then join the background writer (idempotent)."""
        w, self._async_writer = self._async_writer, None
        return True if w is None else w.close(timeout)

    def maybe_save_async(self, step, **kwargs):
        """`save_async` when ``step`` is a multiple of ``save_every``."""
        if self._save_every is None or step % self._save_every != 0:
            return None
        return self.save_async(step, **kwargs)

    def _observe_submit(self, t0, step, **extra):
        stall = time.perf_counter() - t0
        telemetry.histogram("mxtpu_checkpoint_stall_seconds",
                            {"mode": "async"}).observe(stall)
        telemetry.goodput.add("checkpoint_stall", stall)
        telemetry.record_event("ckpt_async_submit", step=int(step),
                               stall_s=round(stall, 5), **extra)

    def save_async(self, step, snapshot_params=None, snapshot_states=None,
                   meta=None):
        """An asynchronous `save`: the ``snapshot_*`` callables run NOW on
        the calling thread (each takes a host copy of the live state and
        returns a `save`-style writer), then the serialization, fsync and
        rename run on the background writer. The training thread's stall
        is the snapshot and the submit. ``MXTPU_CKPT_ASYNC=0`` makes it a
        plain synchronous `save` of the same payload."""
        if self._rank0_only and _current_rank() != 0:
            return None
        t0 = time.perf_counter()
        wp = snapshot_params() if snapshot_params is not None else None
        ws = snapshot_states() if snapshot_states is not None else None
        if not self._async_on():
            return self.save(step, save_params=wp, save_states=ws, meta=meta)
        self._writer().submit(
            lambda: self.save(step, save_params=wp, save_states=ws,
                              meta=meta), step)
        self._observe_submit(t0, step)
        return None

    # -- the per-rank sharded format ---------------------------------------
    def _shard_stage_dir(self, step):
        return os.path.join(self._dir, ".shards-%s-%08d-g%d" % (
            self._prefix, int(step), restart_generation()))

    def save_sharded(self, step, payload, rank=0, world_size=1,
                     topology=None, meta=None, shard_timeout=None):
        """A per-rank sharded checkpoint: EVERY rank calls this with its
        own picklable ``payload``. Each rank stages ``shard-r<rank>.bin``
        and an ``.ok`` marker in a shared staging directory tagged with the
        generation; rank 0 waits (up to ``MXTPU_CKPT_SHARD_TIMEOUT_S``) for
        all ``world_size`` shards and publishes the manifest (``meta.json``
        last, one atomic rename), so discovery, retention and the
        corruption skip work on sharded steps unchanged. ``topology``
        (`parallel.mesh_fingerprint`) rides the manifest, so
        `restore_sharded` can tell an elastic resume. Returns the path on
        rank 0, None elsewhere; ``rank0_only`` does not apply."""
        from .. import random as _random

        t0 = time.perf_counter()
        self._sweep_stale_tmp()
        stage = self._shard_stage_dir(step)
        os.makedirs(stage, exist_ok=True)
        name = _SHARD % int(rank)
        with atomic_writer(os.path.join(stage, name), "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        crc = _file_crc(os.path.join(stage, name), sync=True)
        # the chaos hook: shard staged, no manifest (the torn window)
        _maybe_kill_during_ckpt(step)
        with atomic_writer(os.path.join(stage, _SHARD_OK % int(rank)),
                           "w") as f:
            json.dump({"rank": int(rank), "crc32": crc}, f)
        if int(rank) != 0:
            self._observe_stall(time.perf_counter() - t0)
            return None
        timeout = shard_timeout if shard_timeout is not None \
            else _env.get("MXTPU_CKPT_SHARD_TIMEOUT_S")
        deadline = time.monotonic() + timeout
        files = {}
        for r in range(int(world_size)):
            okp = os.path.join(stage, _SHARD_OK % r)
            while not os.path.exists(okp):
                if time.monotonic() >= deadline:
                    raise MXNetError(
                        "sharded checkpoint step %d: shard %d/%d never "
                        "arrived within %.0fs (%s) — a peer likely died "
                        "mid-save; the staging dir stays invisible to "
                        "latest()" % (step, r, world_size, timeout, stage))
                time.sleep(0.02)
            with open(okp) as f:
                files[_SHARD % r] = json.load(f)["crc32"]
        header = {
            "version": CKPT_FORMAT_VERSION,
            "format": "sharded",
            "step": int(step),
            "time": time.time(),
            "crc32": files,
            "shards": int(world_size),
            "world_size": int(world_size),
            "topology": topology,
            "rng": _random.get_state(),
            "meta": dict(meta or {}),
        }
        with atomic_writer(os.path.join(stage, _META), "w") as f:
            json.dump(header, f, indent=1)
        # the manifest's checksums are authoritative now: drop the markers
        for r in range(int(world_size)):
            try:
                os.unlink(os.path.join(stage, _SHARD_OK % r))
            except OSError:
                pass
        _fsync_dir(stage)
        final = self.step_path(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(stage, final)
        _fsync_dir(self._dir)
        nbytes = _dir_bytes(final)
        self._retain()
        self._observe_save(step, final, nbytes, time.perf_counter() - t0,
                           sharded=True, shards=int(world_size))
        return final

    def save_sharded_async(self, step, payload, rank=0, world_size=1,
                           topology=None, meta=None):
        """`save_sharded` with the staging and the publish on the
        background writer: the caller paid the only synchronous cost (the
        host snapshot in ``payload``), and rank 0's wait for its peers'
        shards runs on the writer too. ``MXTPU_CKPT_ASYNC=0`` makes it
        synchronous."""
        t0 = time.perf_counter()
        if not self._async_on():
            return self.save_sharded(step, payload, rank=rank,
                                     world_size=world_size,
                                     topology=topology, meta=meta)
        self._writer().submit(
            lambda: self.save_sharded(step, payload, rank=rank,
                                      world_size=world_size,
                                      topology=topology, meta=meta), step)
        self._observe_submit(t0, step, sharded=True)
        return None

    def restore_sharded(self, load_shards, step=None, rank=0, world_size=1,
                        topology=None, restore_rng=True):
        """Restore a sharded checkpoint through ``load_shards(payloads,
        header)``, ``payloads`` mapping a saved shard's rank to its
        unpickled payload.

        The fast path (the manifest's topology is ``topology`` and its
        shard count ``world_size``) reads only this rank's shard. The
        elastic path (anything else) reads EVERY shard and hands them all
        to the loader, which reassembles the global state and reshards it
        onto the new mesh. Returns the manifest, or None when no complete
        checkpoint exists; an explicit ``step`` that fails verification
        raises."""
        from .. import random as _random

        t0 = time.perf_counter()
        found = self._resolve(step)
        if found is None:
            return None
        step, path = found
        header = self.read_meta(path)
        if header.get("format") != "sharded":
            raise MXNetError(
                "checkpoint %s is not sharded — restore() is the loader "
                "for rank0-only checkpoints" % path)
        shards = int(header.get("shards") or 0)
        elastic = not (header.get("topology") == topology
                       and shards == int(world_size))
        payloads = {}
        for r in (range(shards) if elastic else [int(rank)]):
            with open(os.path.join(path, _SHARD % r), "rb") as f:
                payloads[r] = pickle.load(f)
        if elastic:
            _LOG.warning(
                "elastic resume: checkpoint step %d saved on %r (%d "
                "shard(s)) -> restoring onto %r (world %d); resharding",
                step, header.get("topology"), shards, topology,
                int(world_size))
            telemetry.record_event(
                "ckpt_reshard", step=int(step), from_shards=shards,
                to_world=int(world_size),
                from_topology=header.get("topology"), to_topology=topology)
        load_shards(payloads, header)
        if restore_rng and header.get("rng"):
            _random.set_state(header["rng"])
        self._observe_restore(step, path, header.get("crc32") or {}, t0,
                              sharded=True, elastic=elastic)
        return header


# ---------------------------------------------------------------------------
# fault injection (MXTPU_FAULT_INJECT)
# ---------------------------------------------------------------------------

_FAULT_EXIT_CODE = 42
_TRAIN_ACTIONS = ("kill", "exc", "hang", "corrupt_ckpt", "preempt")
_CKPT_ACTIONS = ("kill_during_ckpt",)
_SERVE_ACTIONS = ("kill_replica", "wedge_replica", "slow_reply")
_SURGE_ACTIONS = ("load_surge",)
_DATA_ACTIONS = ("slow_batch",)
_UNPARSED = object()
_fault_cache = _UNPARSED


def fault_spec(env=None):
    """Parse ``MXTPU_FAULT_INJECT`` (or ``env``) into a list of {action,
    step, rank, gen, code, dir, batch, replica, ms, after, rps, duration,
    grace} dicts. A malformed entry raises `MXNetError` at once: a typo'd
    injection that silently never fires would void the test using it."""
    raw = (_env.raw("MXTPU_FAULT_INJECT") or "") if env is None else env
    entries = []
    known = (_TRAIN_ACTIONS + _CKPT_ACTIONS + _SERVE_ACTIONS +
             _SURGE_ACTIONS + _DATA_ACTIONS)
    for part in raw.replace(";", " ").split():
        action, _, conds = part.partition("@")
        if action not in known:
            raise MXNetError("MXTPU_FAULT_INJECT: unknown action %r in %r "
                             "(%s)" % (action, part, "|".join(known)))
        entry = {"action": action, "step": None, "rank": None,
                 "gen": 0, "code": _FAULT_EXIT_CODE, "dir": None,
                 "batch": None, "replica": None, "ms": 1000,
                 "after": None, "rps": 100, "duration": 2, "grace": None}
        for cond in filter(None, conds.split(",")):
            k, eq, v = cond.partition("=")
            if not eq or k not in entry or k == "action":
                raise MXNetError("MXTPU_FAULT_INJECT: bad condition %r in %r"
                                 % (cond, part))
            try:
                entry[k] = v if k == "dir" else int(v)
            except ValueError:
                raise MXNetError(
                    "MXTPU_FAULT_INJECT: %s= wants an integer, got %r in %r"
                    % (k, v, part)) from None
        when = "after" if action in _SURGE_ACTIONS \
            else ("batch" if action in _SERVE_ACTIONS else "step")
        if entry[when] is None:
            raise MXNetError("MXTPU_FAULT_INJECT: %r needs a %s= condition"
                             % (part, when))
        entries.append(entry)
    return entries


def _entries():
    """The parsed spec, memoized: the no-op path stays one check."""
    global _fault_cache
    if _fault_cache is _UNPARSED:
        _fault_cache = fault_spec() if _env.raw("MXTPU_FAULT_INJECT") \
            else []
    return _fault_cache


def _matching(actions, when):
    """The entries of ``actions`` due at ``when`` (their step) in this
    generation and on this rank."""
    gen = restart_generation()
    rank = _current_rank()
    return [e for e in _entries()
            if e["action"] in actions and e["step"] == when
            and e["gen"] == gen and e["rank"] in (None, rank)]


def _exit_hard(code):
    """Hard death without cleanup handlers (the SIGKILL / OOM stand-in);
    stdio is flushed so the log ends at the right line."""
    for s in (sys.stdout, sys.stderr):
        try:
            s.flush()
        except Exception:
            pass
    os._exit(code)


def maybe_inject_fault(step):
    """The trainer's step-boundary hook, with the number of the update
    that just completed (`gluon.Trainer.step`, `DistributedTrainer.step`
    and ``Module.fit``'s batch loop call it). One cached check unless
    ``MXTPU_FAULT_INJECT`` is set."""
    if not _entries():
        return
    for e in _matching(_TRAIN_ACTIONS, step):
        _fire(e, step, _current_rank())


def maybe_inject_data_stall(batch):
    """The input pipeline's producer-side hook (``slow_batch@step=,ms=``),
    with the ordinal of the batch the producer just made
    (`data.PrefetchBuffer`): sleeps ``ms`` on a match. A prefetcher deep
    enough absorbs the stall; a shallow one shows it as data wait. One
    cached check unless ``MXTPU_FAULT_INJECT`` is set."""
    if not _entries():
        return
    for e in _matching(_DATA_ACTIONS, batch):
        _LOG.warning("MXTPU_FAULT_INJECT firing: slow_batch at batch=%d "
                     "rank=%d gen=%d (%dms producer stall)", batch,
                     _current_rank(), restart_generation(), e["ms"])
        time.sleep(e["ms"] / 1e3)


def maybe_inject_serving_fault(batch, replica):
    """Replica worker's batch-boundary hook (`serving.supervisor`): fires
    ``kill_replica`` / ``wedge_replica`` / ``slow_reply`` when this
    replica's batch sequence number matches. ``gen=`` matches the
    replica's respawn generation, default 0, so a respawned replica does
    not fire again and recovery is observable."""
    if not _entries():
        return
    gen = restart_generation()
    for e in _entries():
        if e["action"] not in _SERVE_ACTIONS:
            continue
        if e["batch"] != batch or e["gen"] != gen:
            continue
        if e["replica"] is not None and e["replica"] != replica:
            continue
        _fire_serving(e, batch, replica)


def _fire_serving(entry, batch, replica):
    action = entry["action"]
    _LOG.warning("MXTPU_FAULT_INJECT firing: %s at batch=%d replica=%d "
                 "gen=%d", action, batch, replica, restart_generation())
    if action == "kill_replica":
        _exit_hard(entry["code"])
    if action == "wedge_replica":
        # park mid-batch for good: the router must see the silence on its
        # heartbeat deadline, eject this replica (process-group teardown)
        # and fail the batch over; SIGKILL is the only way out
        while True:
            time.sleep(3600)
    if action == "slow_reply":
        time.sleep(entry["ms"] / 1e3)


def maybe_inject_load_surge(model):
    """Server-side chaos hook (`ModelRepository.add`): arm one synthetic
    open-loop burst thread (``mxtpu-fault-load-surge``) a matching
    ``load_surge@after=,rps=,duration=`` entry against the just-published
    model's admission queue. The burst submits fire-and-forget
    single-example requests at ``rps`` for ``duration`` s: real
    admissions, so the queue depth, ``mxtpu_serve_request_seconds`` and
    the SLO burn rates move as under real traffic. Sheds (429 / 503) are
    counted, not raised. Predict models only (a model without
    ``example_shapes`` is skipped). Returns the threads armed."""
    if not _entries():
        return []
    shapes = getattr(model, "example_shapes", None)
    if not shapes:
        return []
    gen = restart_generation()
    threads = []
    for e in _entries():
        if e["action"] not in _SURGE_ACTIONS or e["gen"] != gen:
            continue
        t = threading.Thread(target=_surge_worker, args=(model, dict(e)),
                             name="mxtpu-fault-load-surge", daemon=True)
        t.start()
        threads.append(t)
    return threads


def _surge_worker(model, entry):
    import numpy as _np

    from ..serving.batcher import DrainingError, ModelUnavailableError

    time.sleep(max(0, entry["after"]))
    rps = max(1, entry["rps"])
    duration = max(0, entry["duration"])
    timeout_s = _env.get("MXTPU_SERVE_TIMEOUT_MS") / 1e3
    dtypes = getattr(model, "input_dtypes", None) or {}
    arrays = {k: _np.zeros((1,) + tuple(s), dtype=dtypes.get(k, "float32"))
              for k, s in model.example_shapes.items()}
    telemetry.record_event("fault_load_surge", model=model.name,
                           version=model.version, rps=rps,
                           duration_s=duration)
    _LOG.warning("MXTPU_FAULT_INJECT firing: load_surge on %s/%s "
                 "(%d rps for %ds)", model.name, model.version, rps,
                 duration)
    fired = shed = 0
    period = 1.0 / rps
    end = time.monotonic() + duration
    next_t = time.monotonic()
    while time.monotonic() < end:
        try:
            # open loop: submit and walk away; the resolution (or 504)
            # lands on a request nobody waits on
            model._batcher.submit(arrays,
                                  deadline=time.monotonic() + timeout_s)
            fired += 1
        except (DrainingError, ModelUnavailableError):
            break  # the model is draining or gone: stop, so the shed and
            #        availability series the surge exercises stay clean
        except MXNetError:
            shed += 1  # a 429 / 503 shed: admission doing its job
        except Exception:
            break  # the model was torn down under the surge
        next_t += period
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
    telemetry.record_event("fault_load_surge_done", model=model.name,
                           version=model.version, fired=fired, shed=shed)


def _fire(entry, step, rank):
    action = entry["action"]
    _LOG.warning("MXTPU_FAULT_INJECT firing: %s at step=%d rank=%d gen=%d",
                 action, step, rank, restart_generation())
    if action == "kill":
        _exit_hard(entry["code"])
    if action == "exc":
        raise MXNetError("injected fault (MXTPU_FAULT_INJECT) at step %d "
                         "rank %d" % (step, rank))
    if action == "hang":
        # park at the step boundary for good, the stand-in for a wedged
        # collective: the hang watchdog and the launcher's teardown are
        # what end it
        while True:
            time.sleep(3600)
    if action == "corrupt_ckpt":
        directory = entry["dir"] or _env.raw("MXTPU_CKPT_DIR")
        if not directory:
            raise MXNetError("corrupt_ckpt needs dir=... or MXTPU_CKPT_DIR")
        _corrupt_latest(directory)
    if action == "preempt":
        # the cloud's preemption notice: a real SIGTERM to this process,
        # so the handler and the grace path run as in production
        import signal

        if entry["grace"] is not None:
            _PREEMPT["grace_override"] = float(entry["grace"])
        install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)


def _maybe_kill_during_ckpt(step):
    """The mid-save chaos hook, called inside `CheckpointManager.save` /
    `save_sharded` after the payload is staged and before the manifest
    publishes. On the async writer's thread, `os._exit` still takes the
    whole process down, as a real death mid-write would."""
    if not _entries():
        return
    for e in _matching(_CKPT_ACTIONS, step):
        _LOG.warning("MXTPU_FAULT_INJECT firing: kill_during_ckpt at "
                     "step=%d rank=%d gen=%d (mid-save, pre-publish)",
                     step, _current_rank(), restart_generation())
        _exit_hard(e["code"])


def _corrupt_latest(directory):
    """Flip one byte in the middle of the newest checkpoint's first
    payload, in place: verification must then route `latest` to the
    previous step."""
    mgr = CheckpointManager(directory, rank0_only=False)
    found = mgr.latest()
    if found is None:
        _LOG.warning("corrupt_ckpt: no complete checkpoint under %s",
                     directory)
        return
    _, path = found
    for name in (_PARAMS, _STATES, _META):
        fp = os.path.join(path, name)
        if os.path.exists(fp) and os.path.getsize(fp) > 0:
            with open(fp, "r+b") as f:
                f.seek(os.path.getsize(fp) // 2)
                b = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([b[0] ^ 0xFF]))
            _LOG.warning("corrupt_ckpt: flipped a byte in %s", fp)
            return


# ---------------------------------------------------------------------------
# graceful preemption (SIGTERM and a grace window)
# ---------------------------------------------------------------------------
#
# The preempting agent sends SIGTERM and waits MXTPU_PREEMPT_GRACE_S before
# its SIGKILL. The handler only records the arrival; the work happens at the
# next step boundary, in maybe_preempt_exit: the in-flight step is finished,
# an emergency checkpoint lands inside the rest of the grace, and the process
# exits MXTPU_PREEMPT_EXIT_CODE (83), which the launcher restarts without
# using --max-restarts and with its backoff reset. A failed emergency save
# exits code + 1 (84): that generation lost progress, so its restart uses the
# budget.

# one slot the signal handler writes and the step boundary reads (a signal
# handler cannot take locks; one dict store is atomic under the GIL)
_PREEMPT = {"requested_at": None, "grace_override": None, "installed": False,
            "prev_handler": None}


def install_preemption_handler(grace_s=None):
    """Arm the SIGTERM-with-grace contract for this process. Idempotent;
    True when the handler is installed. Main thread only: elsewhere
    `signal.signal` refuses, this returns False, and SIGTERM keeps its
    default (immediate death)."""
    import signal

    if grace_s is not None:
        _PREEMPT["grace_override"] = float(grace_s)
    if _PREEMPT["installed"]:
        return True
    try:
        _PREEMPT["prev_handler"] = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        return False
    _PREEMPT["installed"] = True
    return True


def _on_sigterm(signum, frame):
    # one store, nothing that allocates or locks: the work happens at the
    # next step boundary (maybe_preempt_exit)
    if _PREEMPT["requested_at"] is None:
        _PREEMPT["requested_at"] = time.monotonic()


def preemption_requested():
    """True once SIGTERM arrived (training loops check it at each step
    boundary; only the process's exit clears it)."""
    return _PREEMPT["requested_at"] is not None


def preempt_grace_s():
    """The grace window in seconds: a run's override (the installer's
    argument or the fault entry's ``grace=``) over
    ``MXTPU_PREEMPT_GRACE_S``."""
    ov = _PREEMPT["grace_override"]
    return float(ov) if ov is not None \
        else float(_env.get("MXTPU_PREEMPT_GRACE_S"))


def preempt_exit_code():
    return int(_env.get("MXTPU_PREEMPT_EXIT_CODE"))


def maybe_preempt_exit(emergency_save=None, rank=None):
    """The step-boundary preemption gate: nothing until SIGTERM arrived;
    then ``emergency_save()`` within the grace and an exit with the
    preemption code. ``emergency_save`` must be synchronous and whole
    (flush an async writer first, `CheckpointManager.flush`, so the
    emergency state lands after any periodic save in flight). When it
    fails the exit code is `preempt_exit_code` + 1: no checkpoint landed,
    so the launcher counts the restart against its budget."""
    if _PREEMPT["requested_at"] is None:
        return
    grace = preempt_grace_s()
    deadline = _PREEMPT["requested_at"] + grace
    rank = _current_rank() if rank is None else rank
    code = preempt_exit_code()
    _LOG.warning("preemption: SIGTERM received; emergency checkpoint within "
                 "%.1fs grace, then exit rc=%d (rank %d)", grace, code, rank)
    telemetry.record_event("preempt_begin", rank=rank, grace_s=grace,
                           generation=restart_generation())
    try:
        if emergency_save is not None:
            emergency_save()
        margin = deadline - time.monotonic()
        if margin < 0:
            _LOG.warning("preemption: emergency checkpoint overran the "
                         "grace window by %.1fs — raise "
                         "MXTPU_PREEMPT_GRACE_S or shrink the payload",
                         -margin)
        telemetry.record_event("preempt_checkpoint", rank=rank,
                               margin_s=round(margin, 3),
                               generation=restart_generation())
    except Exception:
        _LOG.exception("preemption: emergency checkpoint FAILED; exiting "
                       "rc=%d (budget-consuming)", code + 1)
        telemetry.record_event("preempt_checkpoint_failed", rank=rank,
                               generation=restart_generation())
        code = code + 1
    try:
        # os._exit skips atexit: flush the telemetry file now, so the
        # preemption's events reach the flight record
        telemetry.flush(reason="preempt")
    except Exception:
        pass
    _exit_hard(code)
