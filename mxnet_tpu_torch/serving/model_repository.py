"""Model repository: name/version -> served model, with hot load/unload.

Counterpart of `mxnet_tpu/serving/model_repository.py`. Two kinds load:

  * an export ``prefix`` (``prefix-symbol.json`` + the newest
    ``prefix-NNNN.params``, from `HybridBlock.export` or
    `model.save_checkpoint` of either package) as a `ServedModel`: one
    `Predictor` bound per power-of-two padding bucket, every clone over the
    prototype's weight tensors (one copy on the device), behind its own
    `DynamicBatcher`;
  * a generation LM (``generate=True``: a ``save_lm`` prefix) as a
    `ServedLM` over the continuous-batching decode scheduler.

With ``replicas=N`` either kind is served by a supervised
`replica_pool.ReplicaPool` of N worker processes instead
(`ServedModel.pooled`, `ServedLM.load`), on the device the caller's scope
names, else the card.

A load warms every bucket (one forward of zeros each) before it publishes,
so a half-warm model never serves (a pool's replicas warm before they
report ready), and prices each bucket's warm-up call: ``bucket_flops``
(`telemetry.flops`) and ``bucket_memory`` (`telemetry.memory.from_call`),
from which the model's single-copy footprint ``memory_bytes`` follows. An
unload drains queued and running work, then drops the model (and closes
its pool).

The repository admits every load against ``MXTPU_SERVE_MEMORY_BUDGET``
(each resident model's ``effective_memory_bytes``, one copy a replica):
a load that does not fit first reclaims room (`reclaim_memory`: cold pools
shrink toward their ``min_replicas``, then idle unpinned models are
evicted), and else answers `MemoryBudgetError` (507) with the footprint
breakdown. ``min_replicas`` / ``max_replicas`` bound the autoscaler
(`autoscaler.Autoscaler`) for a model; ``pinned`` exempts it from
eviction.

Not ported yet, and raising where asked for: compiled ``.mxc`` artifacts
(ROADMAP queue 1 items 2 and 13) and the compile manifest (item 13).
"""
from __future__ import annotations

import os
import re
import threading
import time

import numpy as _np

from .. import env as _env
from .. import telemetry
from ..base import MXNetError
from ..telemetry import flops as _tm_flops
from ..telemetry import memory as _tm_memory
from .batcher import (DynamicBatcher, MemoryBudgetError,
                      ModelUnavailableError, drain_timeout_s,
                      power_of_two_buckets)

__all__ = ["ServedModel", "ModelRepository", "build_runner", "warm_bucket"]


def _unported(what, item):
    return MXNetError("%s is not ported yet (ROADMAP queue 1 item %s)"
                      % (what, item))


def warm_bucket(runner, arrays, bucket, label=None):
    """One warm-up call of ``runner`` at ``bucket``, priced: returns
    ``(flops, figures)``, the call's FLOPs (`telemetry.flops.counted_call`)
    and its memory figures (`telemetry.memory.from_call`: the
    ``runner.param_bytes`` it reads, its outputs, its peak above the
    baseline on ``runner.device`` when that is a card). Shared by
    `ServedModel.warm` and the replica worker's warm-up."""
    counted = {}

    def call():
        out, counted["flops"] = _tm_flops.counted_call(runner, arrays,
                                                       bucket, bucket)
        return out

    _, figures = _tm_memory.from_call(
        call, getattr(runner, "param_bytes", 0),
        getattr(runner, "device", None), label=label)
    return counted["flops"], figures


class ServedModel:
    """One ``name/version`` of predict serving: a bucketed runner behind a
    dynamic batcher.

    ``runner(batch_arrays, bucket, n) -> [numpy outputs]`` owns the model;
    `from_path` builds it from a deployment artifact, and tests may inject
    a stub (the repository needs only this interface). With ``pool`` (a
    `ReplicaPool`), the batcher hands its batches to the pool's replica
    processes and admits through the pool's load-shedding gate.
    """

    def __init__(self, name, version, runner, buckets, example_shapes,
                 input_dtypes=None, meta=None, max_delay_ms=None,
                 queue_depth=None, pool=None):
        self.name = str(name)
        self.version = int(version)
        self.example_shapes = {k: tuple(v) for k, v in example_shapes.items()}
        self.input_dtypes = {k: _np.dtype(input_dtypes[k])
                             if input_dtypes and k in input_dtypes
                             else _np.dtype(_np.float32)
                             for k in self.example_shapes}
        self.meta = dict(meta or {})
        self.loaded_at = time.time()
        # autoscaling policy: None defers to the
        # MXTPU_AUTOSCALE_{MIN,MAX}_REPLICAS defaults; `pinned` exempts the
        # model from budget-pressure eviction
        self.min_replicas = None
        self.max_replicas = None
        self.pinned = False
        self.warmed = False
        self.warm_seconds = None
        self.bucket_flops = {}    # bucket -> FLOPs of one batch
        self.bucket_memory = {}   # bucket -> the warm-up call's figures
        self.memory_bytes = None  # single-copy footprint from the figures
        self._runner = runner
        self._pool = pool
        if pool is not None:
            self._batcher = DynamicBatcher(
                None, buckets, max_delay_ms=max_delay_ms,
                queue_depth=queue_depth,
                name="%s/%d" % (self.name, self.version),
                dispatcher=pool.dispatch_batch,
                admission_gate=pool.admission_gate)
            pool.bind(self._batcher)
        else:
            self._batcher = DynamicBatcher(
                runner, buckets, max_delay_ms=max_delay_ms,
                queue_depth=queue_depth,
                name="%s/%d" % (self.name, self.version))

    # -- construction from artifacts --------------------------------------
    @staticmethod
    def pooled(name, version, path, replicas, input_shapes=None,
               input_dtypes=None, max_batch=None, max_delay_ms=None,
               queue_depth=None, heartbeat_ms=None, backoff_ms=None,
               extra_env=None, spawn_timeout_s=120.0, teardown_grace=None,
               worker_args=None, wedge_timeout_ms=None, device=None):
        """Serve an export ``prefix`` through a supervised `ReplicaPool` of
        ``replicas`` worker processes on ``device`` (default: the calling
        thread's innermost `context.scope`, else the card).
        ``worker_args`` replaces the artifact argv (tests pass ``--stub``
        specs). Every replica loads and warms before the model returns: a
        half-warm pool never publishes."""
        from .replica_pool import ReplicaPool

        if worker_args is None:
            if path is None:
                raise MXNetError("pooled() needs an artifact path (or "
                                 "explicit worker_args)")
            worker_args = ["--artifact", os.fspath(path)]
            for iname, dims in (input_shapes or {}).items():
                spec = "%s=%s" % (iname, "x".join(str(d) for d in dims))
                if input_dtypes and iname in input_dtypes:
                    spec += ":%s" % input_dtypes[iname]
                worker_args += ["--input", spec]
            if max_batch is not None:
                worker_args += ["--max-batch", str(max_batch)]
        pool = ReplicaPool("%s/%d" % (name, int(version)), worker_args,
                           replicas, heartbeat_ms=heartbeat_ms,
                           backoff_ms=backoff_ms, extra_env=extra_env,
                           spawn_timeout_s=spawn_timeout_s,
                           teardown_grace=teardown_grace,
                           wedge_timeout_ms=wedge_timeout_ms, device=device)
        try:
            info = pool.wait_ready(spawn_timeout_s)
        except Exception:
            pool.close()
            raise
        model = ServedModel(
            name, version, None, info["buckets"], info["example_shapes"],
            input_dtypes=info.get("input_dtypes"),
            meta={"artifact": "pooled", "path": None if path is None
                  else os.fspath(path), "replicas": int(replicas),
                  "device": str(pool.device)},
            max_delay_ms=max_delay_ms, queue_depth=queue_depth, pool=pool)
        # every replica warmed its buckets before it reported ready, and
        # priced them in its own process (the ready frame)
        model.warmed = True
        model.warm_seconds = info.get("warm_seconds")
        if info.get("bucket_flops"):
            model.set_bucket_flops(info["bucket_flops"])
        if info.get("bucket_memory"):
            model.set_bucket_memory(info["bucket_memory"])
        return model

    @staticmethod
    def from_path(name, version, path, input_shapes=None, input_dtypes=None,
                  ctx=None, max_batch=None, max_delay_ms=None,
                  queue_depth=None):
        """Load an export ``prefix`` (or its ``-symbol.json``) with
        ``input_shapes`` per example, batch dim excluded, on ``ctx``
        (default: the calling thread's innermost `context.scope`, else the
        card)."""
        _, (symbol_file, param_file) = _resolve_artifact(path)
        return ServedModel._from_symbol(
            name, version, symbol_file, param_file, input_shapes,
            input_dtypes=input_dtypes, ctx=ctx, max_batch=max_batch,
            max_delay_ms=max_delay_ms, queue_depth=queue_depth)

    @staticmethod
    def _from_symbol(name, version, symbol_file, param_file, input_shapes,
                     input_dtypes=None, ctx=None, max_batch=None,
                     max_delay_ms=None, queue_depth=None):
        runner, buckets, example_shapes, dtypes, meta = _symbol_runner(
            symbol_file, param_file, input_shapes,
            input_dtypes=input_dtypes, ctx=ctx, max_batch=max_batch)
        return ServedModel(name, version, runner, buckets, example_shapes,
                           input_dtypes=dtypes, meta=meta,
                           max_delay_ms=max_delay_ms,
                           queue_depth=queue_depth)

    # -- serving surface ---------------------------------------------------
    @property
    def pool(self):
        """The model's `ReplicaPool` (None when served in-process)."""
        return self._pool

    @property
    def buckets(self):
        return list(self._batcher.buckets)

    @property
    def max_batch(self):
        return self._batcher.max_batch

    def validate(self, arrays):
        """Check names and per-example shapes against the signature and
        cast to the declared dtypes; returns the cast arrays. Raises
        MXNetError on a mismatch (HTTP 400)."""
        want = set(self.example_shapes)
        got = set(arrays)
        if want != got:
            raise MXNetError("inputs %s != model inputs %s"
                             % (sorted(got), sorted(want)))
        out = {}
        for k, a in arrays.items():
            a = _np.asarray(a, dtype=self.input_dtypes[k])
            if tuple(a.shape[1:]) != self.example_shapes[k]:
                raise MXNetError(
                    "input %r per-example shape %s != declared %s"
                    % (k, tuple(a.shape[1:]), self.example_shapes[k]))
            out[k] = a
        return out

    def predict(self, arrays, timeout_ms=None):
        """Validate, admit, and wait: returns the request's list of output
        arrays. Raises QueueFullError / DeadlineExceededError /
        DrainingError per the admission contract."""
        arrays = self.validate(arrays)
        if timeout_ms is None:
            timeout_ms = _env.get("MXTPU_SERVE_TIMEOUT_MS")
        deadline = None
        if timeout_ms and timeout_ms > 0:
            deadline = time.monotonic() + float(timeout_ms) / 1e3
        req = self._batcher.submit(arrays, deadline)
        timeout = None if deadline is None \
            else max(0.0, deadline - time.monotonic())
        return req.wait(timeout)

    def set_bucket_flops(self, bucket_flops):
        """Record the per-bucket FLOPs and publish them as
        ``mxtpu_serve_bucket_flops`` gauges."""
        self.bucket_flops = {int(b): f for b, f in bucket_flops.items() if f}
        for b, f in self.bucket_flops.items():
            telemetry.gauge("mxtpu_serve_bucket_flops",
                            {"model": "%s/%d" % (self.name, self.version),
                             "bucket": str(b)}).set(f)

    @property
    def resident_copies(self):
        """Full copies of the model resident: one a replica process, read
        live from the pool so the budget follows the autoscaler's
        resizes."""
        if self._pool is not None:
            return max(1, int(self._pool.size))
        try:
            return max(1, int(self.meta.get("replicas") or 1))
        except (TypeError, ValueError):
            return 1

    @property
    def effective_memory_bytes(self):
        """Single-copy footprint times the resident copies: what the
        ``MXTPU_SERVE_MEMORY_BUDGET`` admission charges."""
        if not self.memory_bytes:
            return None
        return self.memory_bytes * self.resident_copies

    def set_bucket_memory(self, bucket_memory):
        """Record the per-bucket figures, derive the single-copy footprint
        (`telemetry.memory.model_footprint`: the weights once, each
        bucket's outputs and temps) and publish the effective figure as
        ``mxtpu_serve_model_memory_bytes``."""
        self.bucket_memory = {int(b): dict(f)
                              for b, f in bucket_memory.items() if f}
        self.memory_bytes = _tm_memory.model_footprint(self.bucket_memory)
        if self.effective_memory_bytes:
            telemetry.gauge("mxtpu_serve_model_memory_bytes",
                            {"model": "%s/%d" % (self.name, self.version)}
                            ).set(self.effective_memory_bytes)

    def warm(self):
        """One forward of zeros per bucket before the model publishes, so
        the first request of each bucket pays no first-launch cost (kernel
        builds, allocator growth), each call priced (`warm_bucket`). Emits
        one ``serve_bucket_warm`` event per bucket; returns the seconds
        taken. A pooled model's replicas warmed and priced their buckets
        before they reported ready: nothing to do here."""
        if self._pool is not None:
            self.warmed = True
            return self.warm_seconds
        t_all = time.monotonic()
        bucket_flops = {}
        bucket_memory = {}
        for b in self._batcher.buckets:
            zeros = {k: _np.zeros((b,) + s, dtype=self.input_dtypes[k])
                     for k, s in self.example_shapes.items()}
            t0 = time.monotonic()
            bucket_flops[b], bucket_memory[b] = warm_bucket(
                self._runner, zeros, b,
                label="%s/%d:b%d" % (self.name, self.version, b))
            telemetry.record_event(
                "serve_bucket_warm", model=self.name, version=self.version,
                bucket=b, seconds=round(time.monotonic() - t0, 4),
                flops=bucket_flops[b] or None,
                memory_bytes=_tm_memory.footprint_bytes(bucket_memory[b])
                or None)
        self.set_bucket_flops(bucket_flops)
        self.set_bucket_memory(bucket_memory)
        self.warm_seconds = time.monotonic() - t_all
        self.warmed = True
        return self.warm_seconds

    def pending(self):
        return self._batcher.pending()

    def drain(self, timeout=None):
        return self._batcher.drain(timeout)

    def abort_pending(self, error=None):
        """Force-complete every queued and in-flight request; returns how
        many were force-resolved."""
        return self._batcher.abort_pending(error)

    def close(self, drain=True, timeout=None):
        drained = self._batcher.close(drain=drain, timeout=timeout)
        if self._pool is not None:
            self._pool.close()
        return drained

    def describe(self):
        out = {
            "name": self.name,
            "version": self.version,
            "kind": "predict",
            "buckets": self.buckets,
            "max_batch": self.max_batch,
            "inputs": {k: {"shape": list(s),
                           "dtype": self.input_dtypes[k].name}
                       for k, s in self.example_shapes.items()},
            "warmed": self.warmed,
            "warm_seconds": self.warm_seconds,
            "pending": self.pending(),
            "loaded_at": self.loaded_at,
            "meta": self.meta,
            "memory": {"total_bytes": self.memory_bytes,
                       "copies": self.resident_copies,
                       "effective_bytes": self.effective_memory_bytes,
                       "per_bucket": {str(b): f for b, f in
                                      sorted(self.bucket_memory.items())}},
        }
        if self._pool is not None:
            out["pool"] = self._pool.describe()
        return out


# ---------------------------------------------------------------------------
# artifact loading
# ---------------------------------------------------------------------------

def build_runner(path, input_shapes=None, input_dtypes=None, ctx=None,
                 max_batch=None):
    """Load a deployment artifact into a bucketed ``runner(arrays, bucket,
    n) -> [numpy outputs]``. Returns ``(runner, buckets, example_shapes,
    input_dtypes, meta)``."""
    _, (symbol_file, param_file) = _resolve_artifact(path)
    return _symbol_runner(symbol_file, param_file, input_shapes,
                          input_dtypes=input_dtypes, ctx=ctx,
                          max_batch=max_batch)


def _symbol_runner(symbol_file, param_file, input_shapes, input_dtypes=None,
                   ctx=None, max_batch=None):
    from ..predict import Predictor, _clone_with

    if not input_shapes:
        raise MXNetError(
            "symbol/params models need input_shapes (per-example, "
            "batch dim excluded), e.g. {'data': (8,)}")
    example_shapes = {k: tuple(v) for k, v in input_shapes.items()}
    if max_batch is None:
        max_batch = _env.get("MXTPU_SERVE_MAX_BATCH")
    buckets = power_of_two_buckets(max_batch)

    def shapes_at(b):
        return {k: (b,) + s for k, s in example_shapes.items()}

    # one Predictor per bucket, each binding the prototype's weight
    # tensors: N buckets hold one copy of the weights and N input buffers
    proto = Predictor(symbol_file, param_file, ctx=ctx,
                      input_shapes=shapes_at(buckets[-1]),
                      input_dtypes=input_dtypes)
    by_bucket = {buckets[-1]: proto}
    for b in buckets[:-1]:
        by_bucket[b] = _clone_with(proto, shapes_at(b), shared=proto)
    num_outputs = proto.num_outputs

    def runner(arrays, bucket, n):
        pred = by_bucket[bucket]
        pred.forward(**arrays)
        return [pred.get_output(i).asnumpy() for i in range(num_outputs)]

    runner.predictors = by_bucket   # for checks of the shared weights
    # what a bucket's call reads besides its inputs: the shared weights
    # and aux states (one copy), and where (`warm_bucket`)
    runner.param_bytes = sum(
        a._data.numel() * a._data.element_size()
        for a in list(proto._aux_bound.values())
        + [v for k, v in proto._args.items() if k not in example_shapes])
    runner.device = proto._ctx
    meta = {"artifact": "symbol", "symbol_file": str(symbol_file),
            "param_file": str(param_file), "device": str(proto._ctx)}
    return runner, buckets, example_shapes, input_dtypes, meta


_PARAMS_RE = re.compile(r"-(\d{4})\.params$")


def _resolve_artifact(path):
    """``('symbol', (symbol_json, params))`` for an export prefix (or its
    ``-symbol.json``), the params file the newest ``-NNNN.params``. A
    compiled ``.mxc`` artifact raises: not ported yet."""
    from ..predict import _MXC_MAGIC

    path = os.fspath(path)
    if os.path.isfile(path):
        with open(path, "rb") as f:
            magic = f.read(len(_MXC_MAGIC))
        if magic == _MXC_MAGIC or path.endswith(".mxc"):
            raise _unported("serving a compiled .mxc artifact", "2 and 13")
        if path.endswith("-symbol.json"):
            path = path[:-len("-symbol.json")]
        else:
            raise MXNetError("%r is not a *-symbol.json or an export prefix"
                             % path)
    symbol_file = path + "-symbol.json"
    if not os.path.exists(symbol_file):
        raise MXNetError("no artifact at %r (expected %s)"
                         % (path, symbol_file))
    directory, base = os.path.split(path)
    candidates = []
    for fn in os.listdir(directory or "."):
        m = _PARAMS_RE.search(fn)
        if m and fn == "%s-%s.params" % (base, m.group(1)):
            candidates.append((int(m.group(1)), fn))
    if not candidates:
        raise MXNetError("no %s-NNNN.params next to %s" % (base, symbol_file))
    _, newest = max(candidates)
    return "symbol", (symbol_file, os.path.join(directory, newest))


# ---------------------------------------------------------------------------
# the repository
# ---------------------------------------------------------------------------

class ModelRepository:
    """name/version -> `ServedModel` or `ServedLM`.

    A load warms before it publishes (a half-warm model never serves);
    an unload drains queued and running work, then drops the model. `get`
    resolves ``version=None`` to the highest published version.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._models = {}      # name -> {version: ServedLM}
        self._loading = set()  # (name, version) reservations mid-load
        self._m_loaded = telemetry.gauge("mxtpu_serve_models_loaded")

    def load(self, name, path, version=None, input_shapes=None,
             input_dtypes=None, ctx=None, max_batch=None, max_delay_ms=None,
             queue_depth=None, warm=True, replicas=0, generate=False,
             generate_opts=None, min_replicas=None, max_replicas=None,
             pinned=False, device=None, **pool_kwargs):
        """Load an artifact as ``name/version`` (auto-increment when
        ``version`` is None) and publish it after warm-up. The version is
        reserved for the whole load, and a failed load tears its half-built
        model (and batcher thread) down.

        A predict model: an export prefix with ``input_shapes`` per example
        (batch dim excluded) and ``input_dtypes`` of the inputs that are not
        float32, on ``ctx`` (default: the calling thread's innermost
        `context.scope`, else the card; ``device`` is the port's name for
        it), buckets the powers of two up to ``max_batch``.
        ``generate=True`` loads a ``save_lm`` prefix instead, its geometry
        through ``generate_opts`` (to `TransformerLMEngine`); the
        predict-only knobs raise there.

        ``replicas`` > 0 serves either kind through a supervised replica
        pool of that many worker processes (`ServedModel.pooled`,
        `ServedLM.load`) on ``ctx`` / ``device`` (default: the calling
        thread's innermost `context.scope`, else the card); ``pool_kwargs``
        (heartbeat_ms, backoff_ms, extra_env, spawn_timeout_s,
        teardown_grace, wedge_timeout_ms) pass through to the pool.

        ``min_replicas`` / ``max_replicas`` bound the autoscaler for this
        model (None: the ``MXTPU_AUTOSCALE_{MIN,MAX}_REPLICAS``
        defaults); ``pinned=True`` exempts it from budget-pressure
        eviction. A load that would overflow ``MXTPU_SERVE_MEMORY_BUDGET``
        first reclaims residency (`reclaim_memory`) and else raises
        `MemoryBudgetError` (507) with the footprint breakdown."""
        if pool_kwargs and not replicas:
            raise MXNetError("%s only apply to a replica pool (replicas > 0)"
                             % sorted(pool_kwargs))
        if ctx is not None and device is not None:
            raise MXNetError("pass the device as ctx or device, not both")
        if generate and (input_shapes or input_dtypes or ctx is not None
                         or max_delay_ms is not None or not warm):
            raise MXNetError(
                "generate=True loads take geometry through generate_opts "
                "(and always warm); input_shapes/input_dtypes/ctx/"
                "max_delay_ms/warm=False do not apply")
        with self._lock:
            have = self._models.get(name, {})
            reserved = [v for (n, v) in self._loading if n == name]
            if version is None:
                version = max(list(have) + reserved, default=0) + 1
            version = int(version)
            if version in have or (name, version) in self._loading:
                raise MXNetError("model %s/%d is already loaded"
                                 % (name, version))
            self._loading.add((name, version))
        try:
            if generate:
                from .generate import ServedLM

                opts = dict(generate_opts or {})
                if max_batch is not None:
                    opts.setdefault("max_batch", max_batch)
                model = ServedLM.load(name, version, path,
                                      replicas=int(replicas or 0),
                                      queue_depth=queue_depth,
                                      device=device, pool_kwargs=pool_kwargs,
                                      **opts)
            elif replicas and replicas > 0:
                model = ServedModel.pooled(
                    name, version, path, replicas,
                    input_shapes=input_shapes, input_dtypes=input_dtypes,
                    max_batch=max_batch, max_delay_ms=max_delay_ms,
                    queue_depth=queue_depth,
                    device=ctx if ctx is not None else device, **pool_kwargs)
            else:
                model = ServedModel.from_path(
                    name, version, path, input_shapes=input_shapes,
                    input_dtypes=input_dtypes,
                    ctx=ctx if ctx is not None else device,
                    max_batch=max_batch, max_delay_ms=max_delay_ms,
                    queue_depth=queue_depth)
            try:
                if warm and not generate:
                    model.warm()
                model.min_replicas = min_replicas
                model.max_replicas = max_replicas
                model.pinned = bool(pinned)
                # the memory-budget admission runs inside add(), under the
                # repository lock; a short load first reclaims cold
                # residency before the 507 stands
                return self._add_with_reclaim(model)
            except Exception:
                model.close(drain=False, timeout=0)  # no thread/weight leak
                raise
        finally:
            with self._lock:
                self._loading.discard((name, version))

    def _check_memory_budget_locked(self, model):
        """The ``MXTPU_SERVE_MEMORY_BUDGET`` admission check, under the
        repository lock so two concurrent loads cannot both pass against
        the same headroom: the published models' effective footprints
        plus this one's must fit. Returns the over-budget message in
        ``warn:`` mode, raises `MemoryBudgetError` (507) otherwise; an
        unknown footprint never blocks a load. The error carries the
        breakdown (requested bytes, each resident model's effective bytes,
        budget, headroom, shortfall) in its message and in ``details``."""
        limit, warn_only = _tm_memory.serve_memory_budget()
        needed = model.effective_memory_bytes  # N replicas = N copies
        if not limit or not needed:
            return None
        resident = 0
        resident_models = []
        for vs in self._models.values():
            for m in vs.values():
                eff = m.effective_memory_bytes or 0
                resident += eff
                resident_models.append({
                    "model": "%s/%d" % (m.name, m.version),
                    "effective_bytes": eff or None,
                    "copies": m.resident_copies,
                    "pinned": bool(getattr(m, "pinned", False)),
                })
        total = resident + needed
        if total <= limit:
            return None
        telemetry.record_event(
            "serve_memory_budget", model=model.name, version=model.version,
            footprint_bytes=needed, copies=model.resident_copies,
            resident_bytes=resident, budget_bytes=limit,
            action="warn" if warn_only else "reject")
        details = {
            "requested_bytes": needed,
            "per_copy_bytes": model.memory_bytes,
            "copies": model.resident_copies,
            "budget_bytes": limit,
            "resident_bytes": resident,
            "headroom_bytes": max(0, limit - resident),
            "shortfall_bytes": total - limit,
            "resident_models": resident_models,
        }
        msg = ("loading %s/%d needs %d bytes (%d bytes/copy x %d "
               "replica(s)); budget MXTPU_SERVE_MEMORY_BUDGET=%d has %d "
               "bytes headroom (%d resident), short %d bytes — resident: "
               "%s"
               % (model.name, model.version, needed, model.memory_bytes,
                  model.resident_copies, limit, details["headroom_bytes"],
                  resident, details["shortfall_bytes"],
                  ", ".join("%s=%s bytes (x%d%s)"
                            % (r["model"], r["effective_bytes"],
                               r["copies"],
                               ", pinned" if r["pinned"] else "")
                            for r in resident_models) or "nothing"))
        if not warn_only:
            raise MemoryBudgetError(msg, details=details)
        return msg

    def reclaim_memory(self, needed_bytes, exclude=None, reason="load",
                       now=None):
        """Budget-pressure bin-packing: try to free at least
        ``needed_bytes`` of budgeted residency so a load (or a scale-up)
        fits. Coldest first (the windowed staleness of each model's
        request counters), in two phases:

          1. **shrink** idle pooled models toward their ``min_replicas``
             (`ReplicaPool.remove_replica(drain=True)`: no request lost;
             each removal frees one ``memory_bytes`` copy);
          2. **evict** unpinned models idle beyond
             ``MXTPU_AUTOSCALE_EVICT_TTL_S`` (a drained `unload`).

        Records ``autoscale_down`` / ``autoscale_evict`` decisions; never
        touches ``exclude`` (the model being admitted) and never runs under
        the repository lock (drains block). Returns the bytes freed."""
        from . import autoscaler as _asc

        needed = int(needed_bytes or 0)
        if needed <= 0:
            return 0
        if now is None:
            now = time.time()
        idle_s = _env.get("MXTPU_AUTOSCALE_IDLE_S")
        ttl_s = _env.get("MXTPU_AUTOSCALE_EVICT_TTL_S")
        freed = 0
        candidates = [m for m in self.models()
                      if "%s/%d" % (m.name, m.version) != exclude]
        # coldest first: the model whose request counters have been still
        # the longest gives up residency first
        candidates.sort(key=lambda m: -_asc.idle_age_s(m, now))
        for m in candidates:
            if freed >= needed:
                break
            pool = getattr(m, "pool", None)
            per_copy = getattr(m, "memory_bytes", None)
            if pool is None or not per_copy:
                continue
            if _asc.idle_age_s(m, now) < idle_s:
                continue  # hot pools keep their replicas
            label = "%s/%d" % (m.name, m.version)
            floor = _asc.min_replicas(m)
            while pool.size > floor and freed < needed:
                try:
                    # the floor is re-checked inside remove_replica, under
                    # the pool's lock: a concurrent autoscaler drain must
                    # not take the pool below min_replicas
                    replica = pool.remove_replica(drain=True, floor=floor)
                except MXNetError:
                    break  # lost the race: this pool is done shrinking
                freed += per_copy
                _asc.record_decision(
                    "down", label, reason="budget_pressure",
                    trigger=reason, replica=replica, size=pool.size,
                    freed_bytes=per_copy)
        for m in candidates:
            if freed >= needed:
                break
            if getattr(m, "pinned", False):
                continue
            eff = getattr(m, "effective_memory_bytes", None)
            if not eff:
                continue
            age = _asc.idle_age_s(m, now)
            if age < ttl_s:
                continue
            label = "%s/%d" % (m.name, m.version)
            try:
                self.unload(m.name, m.version)
            except ModelUnavailableError:
                continue  # a concurrent unload beat us to it
            freed += eff
            _asc.record_decision(
                "evict", label, reason=reason, idle_s=round(age, 3),
                freed_bytes=eff)
        return freed

    def _add_with_reclaim(self, model):
        """Publish; on a budget rejection reclaim the shortfall once and
        retry (the retry's admission runs fresh under the lock). A load
        that still does not fit raises the 507 and records an
        ``autoscale_blocked`` decision."""
        from . import autoscaler as _asc

        label = "%s/%d" % (model.name, model.version)
        try:
            return self.add(model)
        except MemoryBudgetError as e:
            details = getattr(e, "details", None) or {}
            shortfall = details.get("shortfall_bytes") \
                or model.effective_memory_bytes or 0
            freed = self.reclaim_memory(shortfall, exclude=label,
                                        reason="load")
            if freed > 0:
                try:
                    return self.add(model)
                except MemoryBudgetError as e2:
                    _asc.record_decision(
                        "blocked", label, reason="load_budget",
                        freed_bytes=freed,
                        shortfall_bytes=(getattr(e2, "details", None)
                                         or {}).get("shortfall_bytes"))
                    raise
            _asc.record_decision(
                "blocked", label, reason="load_budget", freed_bytes=0,
                shortfall_bytes=shortfall)
            raise

    def add(self, model):
        """Publish an already-built served model. The memory-budget
        admission runs here, under the lock: a rejected model raises
        `MemoryBudgetError` and is never published."""
        with self._lock:
            if model.version in self._models.get(model.name, {}):
                raise MXNetError("model %s/%d is already loaded"
                                 % (model.name, model.version))
            # raises before any mutation: a rejected name never appears
            # half-registered
            over_budget = self._check_memory_budget_locked(model)
            self._models.setdefault(model.name, {})[model.version] = model
            self._m_loaded.set(sum(len(v) for v in self._models.values()))
        if over_budget:
            import logging

            logging.getLogger("mxnet_tpu_torch.serving").warning(
                "%s (warn-only budget: publishing anyway)", over_budget)
        telemetry.record_event("serve_model_load", model=model.name,
                               version=model.version)
        # chaos hook: a `load_surge@` MXTPU_FAULT_INJECT entry arms a
        # synthetic open-loop burst against this model's admission queue
        from ..parallel import resilience

        resilience.maybe_inject_load_surge(model)
        return model

    def get(self, name, version=None):
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelUnavailableError("no model named %r" % (name,))
            if version is None:
                return versions[max(versions)]
            model = versions.get(int(version))
            if model is None:
                raise ModelUnavailableError(
                    "model %r has no version %s (have %s)"
                    % (name, version, sorted(versions)))
            return model

    def unload(self, name, version=None, timeout=None):
        """Drain and drop ``name/version`` (newest when None). Returns True
        when the drain completed within ``timeout``."""
        model = self.get(name, version)
        with self._lock:
            versions = self._models.get(name, {})
            versions.pop(model.version, None)
            if not versions:
                self._models.pop(name, None)
            self._m_loaded.set(sum(len(v) for v in self._models.values()))
        if timeout is None:
            timeout = drain_timeout_s()
        drained = model.close(drain=True, timeout=timeout)
        telemetry.record_event("serve_model_unload", model=model.name,
                               version=model.version, drained=drained)
        return drained

    def names(self):
        with self._lock:
            return sorted(self._models)

    def models(self):
        """Flat list of every published model."""
        with self._lock:
            return [m for vs in self._models.values()
                    for _, m in sorted(vs.items())]

    def describe(self):
        return {"models": [m.describe() for m in self.models()]}

    def pending(self):
        return sum(m.pending() for m in self.models())

    def drain_all(self, timeout=None):
        """Drain every model. Returns True when everything finished in
        time."""
        if timeout is None:
            timeout = drain_timeout_s()
        deadline = time.monotonic() + timeout
        ok = True
        for m in self.models():
            ok = m.drain(max(0.0, deadline - time.monotonic())) and ok
        return ok

    def abort_pending(self):
        """Force-complete every model's stranded requests. Returns the
        total force-resolved."""
        return sum(m.abort_pending() for m in self.models())
