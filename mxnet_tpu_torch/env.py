"""Typed registry of the ``MXTPU_*`` environment variables the port reads.

Counterpart of `mxnet_tpu/env.py`, holding only the variables of the
paths ported so far (serving and its replica pools, tracing, ResNet
training, the input pipeline, the launcher), under the same
names and, but for the one noted at its entry, the same defaults, so one
deployment's settings mean the same thing to both packages. There is no kernel gate: a CUDA tensor always goes through
the port's kernel.

``get(name)`` takes registered names only (an unregistered name raises
``KeyError``) and returns the value parsed per the registered type, or the
default when the variable is unset or malformed.
"""
from __future__ import annotations

import os

__all__ = ["EnvVar", "registry", "names", "get", "raw"]


class EnvVar:
    """One registered variable: name, type, default, documentation."""

    __slots__ = ("name", "vtype", "default", "doc")

    def __init__(self, name, vtype, default, doc):
        self.name = name
        self.vtype = vtype
        self.default = default
        self.doc = doc

    def parse(self, value):
        if self.vtype == "bool":
            return value.strip().lower() not in _FALSY
        if self.vtype == "int":
            return int(value)
        if self.vtype == "float":
            return float(value)
        return value


_FALSY = ("", "0", "false", "no", "off")

_REGISTRY: dict = {}


def _var(name, vtype, default, doc):
    assert name.startswith("MXTPU_") and name not in _REGISTRY, name
    _REGISTRY[name] = EnvVar(name, vtype, default, doc)


def registry():
    return dict(_REGISTRY)


def names():
    return list(_REGISTRY)


def _check(name):
    var = _REGISTRY.get(name)
    if var is None:
        raise KeyError("environment variable %r is not in the "
                       "mxnet_tpu_torch.env registry" % (name,))
    return var


def get(name):
    var = _check(name)
    value = os.environ.get(name)
    if value is None:
        return var.default
    try:
        return var.parse(value)
    except ValueError:
        return var.default


def raw(name):
    """The variable's unparsed value, or None when it is unset (a
    registered name only)."""
    _check(name)
    return os.environ.get(name)


# -- training (same name as in mxnet_tpu/env.py) ------------------------------
# The JAX package's default `auto` picks its op layer's lowering, which the
# port does not have; the default here is unset, which builds the reference
# graph in both packages' zoos.
_var("MXTPU_PALLAS_CONV_EPILOGUE", "str", "",
     "ResNet zoo graph: set and not `0` builds the fused-epilogue graph "
     "(every BN->ReLU as one BatchNorm(act_type='relu'), each block tail as "
     "BN+add+ReLU); unset, empty or `0` builds the reference graph (plain "
     "BatchNorm and separate Activation layers). It picks the graph only: "
     "the conv epilogue kernels are never gated, and every training-mode "
     "BatchNorm on a CUDA tensor runs them in either graph.")

# -- serving (same names and defaults as mxnet_tpu/env.py) -------------------
_var("MXTPU_SERVE_MAX_BATCH", "int", 32,
     "serving: largest coalesced predict batch and largest decode batch; "
     "the padding buckets are the powers of two up to this value.")
_var("MXTPU_SERVE_MAX_DELAY_MS", "float", 5.0,
     "serving: longest the micro-batcher holds an admitted request open "
     "waiting for coalescing partners before dispatching a partial batch.")
_var("MXTPU_SERVE_QUEUE_DEPTH", "int", 256,
     "serving admission control: bounded per-model request queue; a submit "
     "beyond this depth is rejected immediately (HTTP 429).")
_var("MXTPU_SERVE_TIMEOUT_MS", "float", 2000.0,
     "serving: default per-request deadline (queue wait + compute); an "
     "expired request is answered HTTP 504. A request body may override it "
     "via its `timeout_ms` field.")
_var("MXTPU_SERVE_PORT", "int", 8500,
     "serving: default HTTP port of `ServingServer` (0 binds a free port).")
_var("MXTPU_SERVE_DRAIN_TIMEOUT_MS", "float", 30000.0,
     "serving: graceful-shutdown budget in ms; on expiry the drain "
     "force-completes every stranded request with a 503.")
_var("MXTPU_SERVE_KV_PAGES", "int", 256,
     "generation serving: KV-cache pages allocated per served LM, all at "
     "load.")
_var("MXTPU_SERVE_KV_PAGE_SIZE", "int", 16,
     "generation serving: tokens per KV-cache page.")
_var("MXTPU_SERVE_MAX_NEW_TOKENS", "int", 128,
     "generation serving: cap on a request's `max_new_tokens` (also the "
     "default when the body omits it).")
_var("MXTPU_SERVE_MAX_PROMPT", "int", 64,
     "generation serving: longest admissible prompt in tokens; prompts pad "
     "to power-of-two prefill buckets up to this length.")

# -- the replica pools (same names and defaults as mxnet_tpu/env.py) --------
_var("MXTPU_SERVE_REPLICAS", "int", 0,
     "serving: replica worker processes per served model (`python -m "
     "mxnet_tpu_torch.serving --replicas`). 0 runs the model in-process (no "
     "pool); N >= 1 runs N supervised replica processes with health-checked "
     "failover.")
_var("MXTPU_SERVE_HEARTBEAT_MS", "float", 1000.0,
     "serving replica pool: health-check heartbeat deadline. An idle "
     "replica that misses a ping/pong round trip by this much, or a busy "
     "one silent past its batch deadline plus this grace, is declared "
     "wedged, ejected (process-group teardown) and respawned.")
_var("MXTPU_SERVE_RESTART_BACKOFF_MS", "float", 200.0,
     "serving replica pool: initial delay before respawning an ejected "
     "replica (doubles per consecutive restart of the same replica, "
     "capped at 60s; resets once a generation serves a batch cleanly).")
_var("MXTPU_SERVE_WEDGE_TIMEOUT_MS", "float", 10000.0,
     "serving replica pool: compute-budget floor for busy-replica wedge "
     "detection. A busy replica is ejected only after staying silent past "
     "max(batch deadline budget, this floor) plus the heartbeat grace, so "
     "a forward that legitimately outlasts a request budget is not "
     "SIGKILLed mid-compute (deadline-less batches use the floor alone).")
_var("MXTPU_SERVE_POOL_TOKEN", "str", None,
     "serving replica pool: internal per-pool handshake secret. Set by the "
     "pool in each replica worker's environment; a connecting worker must "
     "present it before any pickled frame is read. Not meant to be set by "
     "operators.")
_var("MXTPU_TEARDOWN_GRACE", "float", 10.0,
     "escalation window of the launcher and the replica pools: seconds "
     "between a process group's SIGTERM and its SIGKILL.")
_var("MXTPU_FAULT_INJECT", "str", None,
     "deterministic fault injection. The port fires the serving actions at "
     "a replica worker's batch boundary: `kill_replica@batch=3,replica=0`, "
     "`wedge_replica@batch=5,replica=1`, `slow_reply@batch=1,ms=300`; the "
     "training, checkpoint, data and load-surge actions parse as in the "
     "JAX package and are not fired here.")
_var("MXTPU_RESTART_GENERATION", "int", 0,
     "set by a supervisor (the launcher's restarts, a replica pool's "
     "respawns): which generation this process belongs to; fault "
     "injection defaults to generation 0 only.")

# -- tracing and the telemetry files (same names and defaults) ----------------
_var("MXTPU_TRACE_SAMPLE", "float", 0.0,
     "distributed tracing: fraction of new root traces (serving requests) "
     "that record spans, 0.0..1.0. Default 0: spans cost nothing unless "
     "sampled in; an incoming `x-mxtpu-trace` header or wire context with "
     "the sampled flag is always honored.")
_var("MXTPU_TRACE_SLOW_MS", "float", None,
     "always-sample-on-slow escape hatch: when set, unsampled root spans "
     "are buffered locally and emitted after the fact if the root runs "
     "longer than this many milliseconds (local-process spans only).")
_var("MXTPU_TRACE_CONTEXT", "str", None,
     "inherited trace context, `<trace_id>-<span_id>-<flags>` (the "
     "`x-mxtpu-trace` header format), honored as the ambient parent of "
     "root spans minted in this process.")
_var("MXTPU_TELEMETRY_DIR", "str", None,
     "directory for the per-process `telemetry-rank<R>-pid<P>.jsonl` "
     "files (metrics snapshots, events, spans; `tools/trace_merge.py` reads "
     "them) and the launcher's `launcher-events.jsonl`. Read at first use.")
_var("MXTPU_TELEMETRY_FLUSH_S", "float", 10.0,
     "period of the JSONL flusher thread (a final flush always runs at "
     "exit).")
_var("MXTPU_TELEMETRY_PORT", "int", None,
     "base port of the Prometheus endpoint (not served by the port yet); a "
     "replica pool drops it from its workers' environment.")

# -- data loading (same names and defaults as mxnet_tpu/env.py) --------------
_var("MXTPU_DATALOADER_CTX", "str", "fork",
     "multiprocessing start method for DataLoader worker processes "
     "(`spawn` needs a `__main__` guard).")
_var("MXTPU_DATALOADER_TIMEOUT", "float", 300.0,
     "seconds to wait for a worker batch before raising (dead-worker "
     "detection); a DataLoader's `timeout` argument overrides it.")
_var("MXTPU_DATALOADER_PROBE_TIMEOUT", "float", 20.0,
     "seconds the DataLoader's worker-viability probe (one sample round-"
     "tripped through a real worker process) may take before the loader "
     "falls back to in-process threads.")
_var("MXTPU_DATA_PREFETCH", "bool", False,
     "`1` wraps the `module.fit` batch iterator in the "
     "mxnet_tpu_torch.data DevicePrefetcher: batch N+1's host decode and "
     "host->device copy overlap batch N's compute.")
_var("MXTPU_DATA_PREFETCH_DEPTH", "int", 2,
     "batches the DevicePrefetcher stages ahead (double-buffering). Depth "
     "d absorbs producer jitter up to d x step-time.")
_var("MXTPU_DATA_JOIN_TIMEOUT_S", "float", 30.0,
     "seconds the data pipeline's close()/reset() wait for producer and "
     "decode-worker threads to stop before raising (rewinding reader "
     "state under a live reader would corrupt the next epoch).")

# -- profiler and launcher (same names and defaults as mxnet_tpu/env.py) ----
_var("MXTPU_PROFILE_SYNC", "bool", False,
     "Profiler records true device time by synchronizing the card after "
     "each recorded op, instead of (async) dispatch time. Equivalent of the "
     "reference engine's profiling stamps.")
_var("MXTPU_PROCESS_ID", "int", None,
     "this process's rank in the rendezvous protocol (alias: "
     "`DMLC_WORKER_ID`); the profiler stamps it as its traces' pid.")

# -- the rendezvous (same names and defaults as mxnet_tpu/env.py) -------------
_var("MXTPU_COORDINATOR", "str", None,
     "rendezvous address (``host:port``) that `parallel.collectives."
     "init_process_group` dials over TCP.")
_var("MXTPU_NUM_WORKERS", "int", None,
     "process-group size for the rendezvous protocol (alias: "
     "`DMLC_NUM_WORKER`).")
_var("MXTPU_RENDEZVOUS_TIMEOUT", "int", 300,
     "seconds `init_process_group` waits for the group to assemble before "
     "raising a diagnosable `MXNetError`.")
_var("MXTPU_RENDEZVOUS_RETRIES", "int", 0,
     "redials (exponential backoff) of a failed rendezvous.")
