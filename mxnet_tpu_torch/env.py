"""Typed registry of the ``MXTPU_*`` environment variables the port reads.

Counterpart of `mxnet_tpu/env.py`, holding only the variables of the
paths ported so far (serving, its replica pools and their autoscaler,
telemetry with its SLO engine and flight recorder, tracing, ResNet
training, the input pipeline, the launcher, checkpoints and preemption),
under the same names and, but for the one noted at its entry, the same
defaults, so one deployment's settings mean the same thing to both
packages. There is no kernel gate: a CUDA tensor always goes through the
port's kernel.

``get(name)`` takes registered names only (an unregistered name raises
``KeyError``) and returns the value parsed per the registered type, or the
default when the variable is unset or malformed.
"""
from __future__ import annotations

import os

__all__ = ["EnvVar", "registry", "names", "get", "raw", "is_set"]


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


def is_set(name):
    """A registered name set to a non-empty string."""
    _check(name)
    return bool(os.environ.get(name))


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
     "deterministic fault injection at the trainer step boundary, e.g. "
     "`kill@step=7,rank=1`, `exc@step=3`, `hang@step=5,rank=1` (park the "
     "rank forever — watchdog/flight-recorder test vector), "
     "`corrupt_ckpt@step=5,dir=/ckpts`, `preempt@step=7,rank=1,grace=30` "
     "(SIGTERM-with-grace — the cloud preemption notice), "
     "`kill_during_ckpt@step=4,rank=0` (die mid-save, pre-publish — the "
     "torn-write window); at a replica worker's batch boundary "
     "`kill_replica@batch=3,replica=0`, `wedge_replica@batch=5,replica=1`, "
     "`slow_reply@batch=1,ms=300`; in the input pipeline's producer "
     "`slow_batch@step=3,ms=200`; at a model's publish "
     "`load_surge@after=0,rps=200,duration=3` (docs/fault_tolerance.md "
     "§5).")
_var("MXTPU_RESTART_GENERATION", "int", 0,
     "set by a supervisor (the launcher's restarts, a replica pool's "
     "respawns): which generation this process belongs to; fault "
     "injection defaults to generation 0 only.")
_var("MXTPU_CKPT_DIR", "str", None,
     "default checkpoint directory for the `corrupt_ckpt` injection "
     "action (tests' resilience workers also read it).")
_var("MXTPU_CKPT_ASYNC", "bool", True,
     "route `CheckpointManager.save_async`/`save_sharded_async` through "
     "the named background writer thread (`mxtpu-ckpt-writer`): the "
     "training thread pays only the host snapshot, serialize+fsync+"
     "atomic-rename happen off-thread (at-most-one in flight, honest "
     "backpressure). `0` degrades both to the synchronous save path — "
     "the escape hatch when the extra host copy is the scarcer resource "
     "(docs/fault_tolerance.md §Preemption & elastic resume).")
_var("MXTPU_CKPT_SHARD_TIMEOUT_S", "float", 120.0,
     "sharded checkpoints: how long rank 0 waits for every peer rank's "
     "staged shard before abandoning the manifest publish (the staging "
     "dir stays invisible to `latest()`, so a peer death mid-save can "
     "never tear a checkpoint).")
_var("MXTPU_PREEMPT_GRACE_S", "float", 15.0,
     "graceful-preemption budget: seconds between the SIGTERM notice and "
     "the expected SIGKILL. `maybe_preempt_exit` finishes the in-flight "
     "step and emergency-checkpoints inside this window; a fault entry's "
     "`grace=` or `install_preemption_handler(grace_s=)` overrides it.")
_var("MXTPU_PREEMPT_EXIT_CODE", "int", 83,
     "rc a gracefully-preempted worker exits with after its emergency "
     "checkpoint. `python -m mxnet_tpu_torch.launch` treats a generation "
     "where any rank exited with this rc as a preemption: free restart "
     "(no `--max-restarts` budget consumed) and backoff reset. rc+1 (84) "
     "means preempted WITHOUT a checkpoint — budget-consuming.")

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
     "base port of the Prometheus text endpoint: each rank serves "
     "`/metrics` and `/statusz` on `port + rank` (stdlib http.server; "
     "default off). A replica pool drops it from its workers' "
     "environment.")
_var("MXTPU_TELEMETRY", "bool", True,
     "master switch of the metrics and flight-recorder layer; `0` turns "
     "every counter, gauge, histogram and event into a no-op.")
_var("MXTPU_WATCHDOG_TIMEOUT", "float", None,
     "hang watchdog: seconds without a completed training step (armed by "
     "the first completed step) before the flight recorder dumps every "
     "thread's stack and the recent events.")
_var("MXTPU_WATCHDOG_ACTION", "str", "abort",
     "what follows a watchdog dump: `abort` exits the process (code "
     "`MXTPU_WATCHDOG_EXIT_CODE`) so the launcher tears the group down and "
     "restarts it; `dump` keeps the process alive and re-arms.")
_var("MXTPU_WATCHDOG_EXIT_CODE", "int", 43,
     "exit status of a watchdog abort (apart from the fault-injection "
     "code 42).")
_var("MXTPU_FLIGHTREC_EVENTS", "int", 512,
     "flight-recorder ring size: the recent telemetry events a process "
     "keeps for its dumps.")
_var("MXTPU_DUMP_GRACE", "float", 1.0,
     "launcher teardown: seconds between the SIGUSR1 (flight-recorder "
     "dump) broadcast and SIGTERM, when `MXTPU_TELEMETRY_DIR` is set.")
_var("MXTPU_MEMORY_POLL_MS", "float", None,
     "period of the background memory-gauge poller (`telemetry.memory."
     "sample`: the card's `torch.cuda` memory figures, process RSS / "
     "VmHWM). Default off: the gauges refresh at every JSONL flush, "
     "Prometheus scrape and training step anyway.")
_var("MXTPU_SERVE_MEMORY_BUDGET", "str", None,
     "serving memory budget in bytes (suffixes K/M/G/T, e.g. `24G`): "
     "`ModelRepository.load` prices each model's device footprint (its "
     "buckets' warm-up figures; a generation LM's weights plus KV pool; "
     "times its replicas) and rejects a load that would exceed the budget "
     "(`MemoryBudgetError`, HTTP 507) after trying to reclaim room from "
     "cold models. A `warn:` prefix logs and records an event instead. "
     "Unset disables the check; a load of unknown footprint is never "
     "rejected.")
_var("MXTPU_STEP_FLOPS", "float", None,
     "model FLOPs per training step, for the achieved-MFU gauge "
     "(`mxtpu_step_mfu`); overrides the automatic accounting "
     "(`MXTPU_TRACE_FLOPS`).")
_var("MXTPU_TRACE_FLOPS", "bool", True,
     "automatic FLOP accounting (`telemetry.flops`): a callable's FLOPs "
     "are counted once a shape signature by `torch.utils.flop_counter."
     "FlopCounterMode` over one call, plus the port's CUDA kernels by "
     "formula, and each later call adds them; the serving buckets are "
     "priced so at warm-up. `0` turns it off.")
_var("MXTPU_GOODPUT", "bool", True,
     "per-step goodput attribution: a step's wall time split into "
     "`data_wait` / `host_dispatch` / `compile` / `compute` / "
     "`checkpoint_stall` / `collective` / `other`, published as "
     "`mxtpu_step_phase_seconds{phase=}` and the rolling "
     "`mxtpu_goodput_fraction` gauge. `0` turns the accountant off.")
_var("MXTPU_GOODPUT_WINDOW_STEPS", "int", 128,
     "steps in the rolling window behind `mxtpu_goodput_fraction` and the "
     "`/statusz` `training` block.")

# -- the SLO engine (same names and defaults as mxnet_tpu/env.py) -------------
_var("MXTPU_SLO", "bool", True,
     "master switch of the SLO engine: objective registration, the "
     "burn-rate evaluator thread and the `mxtpu_slo_*` gauges. `0` keeps "
     "only the windowed views (their rings still roll at each flush).")
_var("MXTPU_SLO_SPEC", "str", None,
     "path of a JSON SLO spec file (`{\"objectives\": [...]}`) whose "
     "objectives register beside the built-in ones; malformed JSON, an "
     "unknown kind or an unknown metric raise `SLOSpecError` at once.")
_var("MXTPU_SLO_WINDOW_MS", "float", 5000.0,
     "resolution of the windowed-telemetry rings: how often "
     "`roll_windows` appends one snapshot a metric (at each flush and "
     "each evaluator lap, throttled to this period).")
_var("MXTPU_SLO_EVAL_MS", "float", None,
     "period of the SLO evaluator's laps. Default: "
     "`MXTPU_SLO_WINDOW_MS`.")
_var("MXTPU_SLO_FAST_WINDOWS", "str", "60,300",
     "comma-separated fast (page-level) burn-rate windows in seconds: an "
     "objective pages only when every fast window burns.")
_var("MXTPU_SLO_SLOW_WINDOW_S", "float", 1800.0,
     "slow (ticket-level) burn-rate window in seconds; it also sizes the "
     "rings (slow window / resolution, at most 4096 entries).")
_var("MXTPU_SLO_BURN_PAGE", "float", 1.0,
     "fast-window burn-rate threshold of the page-level (breaching) "
     "verdict.")
_var("MXTPU_SLO_BURN_TICKET", "float", 1.0,
     "slow-window burn-rate threshold of the ticket-level verdict.")
_var("MXTPU_SLO_ALERTS", "int", 64,
     "size of the alerts ring (the last `slo_breach` / `slo_recovered` "
     "transitions) that flight-recorder dumps and `/statusz` carry.")
_var("MXTPU_SLO_SERVE_P99_MS", "float", 1000.0,
     "built-in serving objective: p99 of `mxtpu_serve_request_seconds` "
     "(admission to resolution, a model) under this many ms.")
_var("MXTPU_SLO_SERVE_AVAILABILITY", "float", 0.999,
     "built-in serving objective: the fraction of requests not rejected "
     "(429 / 504 / 503 sheds) at or above this target.")
_var("MXTPU_SLO_SERVE_QUEUE_FRAC", "float", 0.8,
     "built-in serving objective: `mxtpu_serve_queue_depth` under this "
     "fraction of `MXTPU_SERVE_QUEUE_DEPTH`.")
_var("MXTPU_SLO_INTERTOKEN_P99_MS", "float", 250.0,
     "built-in generation objective: p99 of "
     "`mxtpu_serve_intertoken_seconds` under this many ms.")
_var("MXTPU_SLO_KV_OCCUPANCY", "float", 0.95,
     "built-in generation objective: the ceiling of "
     "`mxtpu_serve_kv_occupancy` (used / total KV pages).")
_var("MXTPU_SLO_STEP_SECONDS", "float", None,
     "optional training objective: p99 step time in seconds a trainer "
     "kind.")
_var("MXTPU_SLO_MFU_FLOOR", "float", None,
     "optional training objective: the floor of `mxtpu_step_mfu`, 0..1.")
_var("MXTPU_SLO_GOODPUT_FLOOR", "float", None,
     "optional training objective: the floor of "
     "`mxtpu_goodput_fraction`, 0..1.")
_var("MXTPU_SLO_STEP_STALENESS_S", "float", None,
     "optional training objective: seconds `mxtpu_steps_total` may sit "
     "still before the objective burns.")

# -- the autoscaler (same names and defaults as mxnet_tpu/env.py) -------------
_var("MXTPU_AUTOSCALE", "bool", False,
     "arm the autoscaler in `python -m mxnet_tpu_torch.serving`: one "
     "controller thread a server (`serving.Autoscaler`) that reads "
     "`slo.verdicts()` and resizes the replica pools in place: up on a "
     "sustained breach (within `MXTPU_SERVE_MEMORY_BUDGET`), down with a "
     "drain when idle.")
_var("MXTPU_AUTOSCALE_INTERVAL_MS", "float", 1000.0,
     "autoscaler lap period; a lap takes at most one action a model.")
_var("MXTPU_AUTOSCALE_UP_WINDOWS", "int", 2,
     "consecutive breached laps (any paging objective of the model) "
     "before a scale-up.")
_var("MXTPU_AUTOSCALE_IDLE_S", "float", 60.0,
     "seconds since the model's request counters last moved before the "
     "autoscaler drains one replica away (never below `min_replicas`); "
     "also the \"cold\" threshold of budget-pressure shrinking.")
_var("MXTPU_AUTOSCALE_COOLDOWN_S", "float", 5.0,
     "least seconds between two scaling actions on one model.")
_var("MXTPU_AUTOSCALE_MIN_REPLICAS", "int", 1,
     "default replica floor a model (`ModelRepository.load(min_replicas=)` "
     "overrides it).")
_var("MXTPU_AUTOSCALE_MAX_REPLICAS", "int", 8,
     "default replica ceiling a model (`ModelRepository.load("
     "max_replicas=)` overrides it); a breach at the ceiling records an "
     "`autoscale_blocked` decision.")
_var("MXTPU_AUTOSCALE_EVICT_TTL_S", "float", 300.0,
     "a model idle longer than this, and not `pinned`, may be unloaded by "
     "`ModelRepository.reclaim_memory` when a load or a scale-up needs "
     "room (after cold pools have shrunk to their floors).")

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

# -- the device dial and the test helpers (same names and defaults as
# mxnet_tpu/env.py) ------------------------------------------------------------
_var("MXTPU_DIAL_TIMEOUT_S", "float", 60.0,
     "`runtime.dial_devices`: seconds the device enumeration may block "
     "before the deadline probe raises a diagnosable MXNetError. "
     "Flight-recorder events bracket every dial.")
_var("MXTPU_TOPOLOGY_CACHE", "str", None,
     "path of the device-topology cache file `runtime.dial_devices` "
     "writes after a successful dial of the card (platform, device kind, "
     "count, timestamp JSON). A later failed dial reports the last known "
     "topology instead of nothing.")
_var("MXTPU_TEST_SEED", "int", None,
     "fixed seed for `test_utils.with_seed` (printed on failure for "
     "replay; `MXNET_TEST_SEED` is read first).")
_var("MXTPU_TEST_EXAMPLES_FULL", "bool", False,
     "`1` runs the slow model families of the ONNX round-trip tests too.")
