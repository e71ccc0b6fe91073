"""Memory observability: per-bucket attribution, live gauges, the dump's
memory block and the serving memory budget.

Counterpart of `mxnet_tpu/telemetry/memory.py`, under its names:

  * **attribution**: the JAX package reads XLA's ``memory_analysis()`` of
    each executable. The port measures a bucket's warm-up call instead
    (`from_call`): ``arguments`` the bytes of the weights it reads,
    ``outputs`` its outputs' bytes, ``temp`` the peak allocated above the
    baseline on a CUDA device (`torch.cuda.reset_peak_memory_stats` /
    `max_memory_allocated` around the call, a synchronisation each side,
    so at warm-up only, never on a request's path). On the host ``temp``
    is 0: the CPU allocator keeps no peak. The figures go into the same
    process table (`record_executable`, `recorded_mark` /
    `recorded_since`) and roll up with the JAX arithmetic
    (`sum_figures`, `bucket_figures`, `footprint_bytes`,
    `model_footprint`), which is what the ``MXTPU_SERVE_MEMORY_BUDGET``
    admission enforces (`parse_bytes`, `serve_memory_budget`).
  * **live gauges**: the card's allocator figures (`sample_devices`, each
    visible device the process already uses: `torch.cuda.memory_stats` and
    `mem_get_info`; none on the host, as the JAX package reports none on
    CPU), process RSS / VmHWM from ``/proc/self/status``, a per-step
    peak-delta histogram, and an optional poller thread
    (``MXTPU_MEMORY_POLL_MS``).
  * **forensics**: `snapshot()`, the flight recorder's memory block, is
    signal-safe (plain dict reads, one /proc read, the last device sample,
    no locks).

The NDArray live accounting: the port's `NDArray` calls
``ndarray_created`` / ``_freed`` / ``_resized`` from its constructor,
``__del__`` and a resizing `_set_data`; ``ndarray_live`` reads the count
and bytes, which `sample` publishes as ``mxtpu_ndarray_live`` /
``_live_bytes`` and the dump carries as its ``ndarray`` block. Not
ported, and queued: `verify_donation`, which checks XLA buffer donation
(the port updates in place; captured graphs are ROADMAP queue 1 item 2):
it raises.
"""
from __future__ import annotations

import collections
import os
import sys
import threading
import time

try:  # imported at module load, NOT from the signal path (import lock)
    import resource as _resource
except ImportError:  # non-POSIX
    _resource = None

from .. import env as _env
from . import core

__all__ = [
    "enabled", "from_call", "record_executable", "lookup_key",
    "recorded_mark", "recorded_since", "executables_top", "sum_figures",
    "bucket_figures", "footprint_bytes", "verify_donation",
    "last_donation_report", "read_process_memory", "sample_devices",
    "sample", "observe_step_delta", "snapshot", "ndarray_created",
    "ndarray_freed", "ndarray_resized", "ndarray_live", "parse_bytes",
    "serve_memory_budget", "model_footprint", "ensure_poller",
]

# the JAX package's figure keys (``memory_analysis`` attribute -> short
# key); the port's `from_call` fills arguments / outputs / temp
_FIGURES = (
    ("argument_size_in_bytes", "arguments"),
    ("output_size_in_bytes", "outputs"),
    ("temp_size_in_bytes", "temp"),
    ("generated_code_size_in_bytes", "generated_code"),
    ("alias_size_in_bytes", "alias"),
)


def enabled():
    """Memory accounting rides the master telemetry switch — there is no
    separate gate: every always-on path is a handful of plain adds."""
    return core._STATE.enabled


# ---------------------------------------------------------------------------
# per-bucket attribution (fed by `from_call` at warm-up)
# ---------------------------------------------------------------------------

class _MemState:
    def __init__(self):
        # executable table: insertion-ordered digest/label -> figures
        # (plain dict: GIL-atomic reads keep snapshot() signal-safe)
        self.executables = {}
        # PER-THREAD attribution log (same discipline as the registry's
        # per-thread fill log): a warm brackets its own thread's records
        # with recorded_mark/_since, so a concurrent load or live batcher
        # traffic on another thread never inflates a bucket's figures —
        # and each thread's log is a BOUNDED deque, so a long-lived
        # serving worker can't leak through its own telemetry
        self.log_local = threading.local()
        self.devices = None      # last sample_devices() result (cached
        #                          for the signal-safe snapshot)
        self.devices_ts = None
        self.caps = None         # does the backend report memory_stats?
        self.step_peak = None    # peak bytes at the last observe_step
        self.step_peak_ts = 0.0  # monotonic time of that probe
        self.last_donation = None
        self.poller = None
        self.poller_decided = False
        self.nd_live = [0, 0]    # [count, bytes]: the NDArray hooks


_STATE = _MemState()
_MAX_EXECUTABLES = 4096  # runaway-shape backstop, same order as the LRU
_MAX_LOG = 4096          # per-thread attribution-log bound
# serializes ensure_poller's cold path only (same double-checked shape as
# core._DECIDE_LOCK): an unlocked decided-flag race could start 2 pollers
_DECIDE_LOCK = threading.Lock()


def _reset_after_fork():
    st = _MemState()
    st.executables = dict(_STATE.executables)  # attribution is still true
    # the arrays a child inherits are alive there, and their __del__
    # takes them off: the counts carry over, or the gauges go negative
    st.nd_live = list(_STATE.nd_live)
    globals()["_STATE"] = st


def _thread_log():
    """(seq_counter_ref, entries deque) for the calling thread. Entries
    are (seq, entry_key) pairs; the deque bound means a cursor older than
    the window simply sees fewer entries, never wrong ones."""
    local = _STATE.log_local
    entries = getattr(local, "entries", None)
    if entries is None:
        entries = local.entries = collections.deque(maxlen=_MAX_LOG)
        local.seq = 0
    return local, entries


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_after_fork)


def _leaf_bytes(x):
    """Bytes of the arrays / tensors in a (nested) call result."""
    if isinstance(x, (list, tuple)):
        return sum(_leaf_bytes(e) for e in x)
    if isinstance(x, dict):
        return sum(_leaf_bytes(v) for v in x.values())
    nb = getattr(x, "nbytes", None)
    if nb is not None:
        return int(nb)
    if hasattr(x, "element_size"):
        return int(x.numel() * x.element_size())
    return 0


def from_call(fn, argument_bytes, device=None, label=None):
    """Run ``fn()`` once as a bucket's warm-up call and return ``(result,
    figures)``: ``arguments`` = ``argument_bytes`` (the weights the call
    reads), ``outputs`` = the bytes of its result's arrays, ``temp`` = the
    peak allocated above the baseline when ``device`` is a CUDA device
    (synchronised before and after: warm-up only), else 0. With a
    ``label`` the figures are recorded in the process table as a
    ``warm`` entry (the dump's top entries, `recorded_since`)."""
    cuda = device is not None and getattr(device, "type", None) == "cuda"
    if cuda:
        import torch

        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    out = fn()
    temp = 0
    if cuda:
        torch.cuda.synchronize(device)
        temp = max(0, torch.cuda.max_memory_allocated(device) - base)
    figures = {"arguments": int(argument_bytes), "outputs": _leaf_bytes(out),
               "temp": int(temp)}
    if label is not None:
        record_executable("warm", label, None, figures)
    return out, figures


def record_executable(kind, label, digest, figures, key=None):
    """Record one executable's memory figures into the process table (and
    the bracketing log). ``key`` (the registry's `ExecutableKey`) indexes
    the entry so later MEMORY-TIER HITS can still be attributed — a
    reload of an already-resident model fills nothing, but its warm still
    touches the keys (`lookup_key`). Safe with figures=None (no-op)."""
    if not figures or not enabled():
        return
    local, entries = _thread_log()
    entry_key = key if key is not None else (
        digest or "%s:%s:%d" % (kind, label, local.seq))
    entry = {"kind": kind, "label": label, "digest": digest}
    entry.update(figures)
    if len(_STATE.executables) >= _MAX_EXECUTABLES \
            and entry_key not in _STATE.executables:
        _STATE.executables.pop(next(iter(_STATE.executables)), None)
    _STATE.executables[entry_key] = entry
    local.seq += 1
    entries.append((local.seq, entry_key))


def lookup_key(key):
    """Figures entry recorded under a registry `ExecutableKey`, or None."""
    return _STATE.executables.get(key)


def recorded_mark():
    """Cursor into THIS THREAD's attribution log — bracket a load/warm
    with `recorded_mark()` / `recorded_since()` to learn which
    executables' figures it contributed (the serving per-bucket
    footprint). Fills on other threads never leak into the bracket."""
    local, _ = _thread_log()
    return local.seq


def recorded_since(cursor):
    """This thread's figure entries recorded since ``cursor``
    (deduplicated, in fill order)."""
    _, entries = _thread_log()
    seen, out = set(), []
    for seq, k in entries:
        if seq <= cursor or k in seen:
            continue
        seen.add(k)
        entry = _STATE.executables.get(k)
        if entry is not None:
            out.append(entry)
    return out


def executables_top(n=10, by="temp"):
    """Top-``n`` recorded executables by one figure (default temp bytes —
    the live-working-set contribution). Plain dict reads: signal-safe."""
    rows = [e for e in list(_STATE.executables.values()) if e.get(by)]
    rows.sort(key=lambda e: e.get(by, 0), reverse=True)
    return rows[:n]


def sum_figures(entries):
    """Combine several executables' figure dicts into one (the serving
    per-bucket roll-up: a bucket warm may fill forward + helper
    executables). {} when nothing was recorded."""
    out = {}
    for entry in entries:
        for _, name in _FIGURES:
            v = entry.get(name)
            if v is not None:
                out[name] = out.get(name, 0) + int(v)
    return out


def bucket_figures(touched_keys, recorded_entries):
    """One bucket warm's combined figures: the entries its FILLS recorded
    (`recorded_since`) plus table entries for the keys it merely TOUCHED
    (memory-tier hits on an already-resident executable — the reload
    path), each executable counted once."""
    seen, entries = set(), []
    for e in recorded_entries:
        if id(e) not in seen:
            seen.add(id(e))
            entries.append(e)
    for k in touched_keys:
        e = _STATE.executables.get(k)
        if e is not None and id(e) not in seen:
            seen.add(id(e))
            entries.append(e)
    return sum_figures(entries)


def footprint_bytes(figures):
    """One executable's device-footprint contribution: arguments +
    outputs + temps + generated code, minus aliased (donated) bytes that
    arguments and outputs double-count."""
    if not figures:
        return 0
    return max(0, figures.get("arguments", 0) + figures.get("outputs", 0)
               + figures.get("temp", 0) + figures.get("generated_code", 0)
               - figures.get("alias", 0))


def model_footprint(per_bucket):
    """Total footprint of a served model from its per-bucket figures
    (``{bucket: figures}``). Buckets SHARE weights (the argument bytes
    are dominated by one weight copy per model, `predict._clone_with`),
    so the total counts the largest bucket's argument bytes once plus
    every bucket's private outputs/temps/code."""
    if not per_bucket:
        return None
    args = max((f.get("arguments", 0) for f in per_bucket.values()),
               default=0)
    private = sum(f.get("outputs", 0) + f.get("temp", 0)
                  + f.get("generated_code", 0)
                  for f in per_bucket.values())
    return args + private


# ---------------------------------------------------------------------------
# donation verifier
# ---------------------------------------------------------------------------

def verify_donation(key, example_args, figures, threshold=0.5):
    """XLA buffer donation has no counterpart in the port (updates run in
    place); a check of captured graphs comes with them."""
    from ..base import MXNetError

    raise MXNetError("telemetry.memory.verify_donation checks XLA buffer "
                     "donation; the port has none (captured graphs: "
                     "ROADMAP queue 1 item 2)")


def last_donation_report():
    """The most recent `verify_donation` report (bench evidence reads
    this after one trainer step), or None."""
    return _STATE.last_donation


# ---------------------------------------------------------------------------
# live accounting: process / device / NDArray
# ---------------------------------------------------------------------------

def read_process_memory():
    """{'rss': bytes, 'vmhwm': bytes} from ``/proc/self/status`` (stdlib,
    ~50µs), or None off-Linux. Kernels that hide ``VmHWM`` (some
    containers) fall back to ``getrusage`` ru_maxrss for the high-water
    mark. Works where ``memory_stats()`` returns None — CPU boxes get
    real numbers. Signal-safe: one file read + one syscall."""
    out = {}
    try:
        with open("/proc/self/status") as f:
            text = f.read()
    except OSError:
        text = ""
    for line in text.splitlines():
        if line.startswith("VmRSS:"):
            out["rss"] = int(line.split()[1]) * 1024
        elif line.startswith("VmHWM:"):
            out["vmhwm"] = int(line.split()[1]) * 1024
    if "vmhwm" not in out and _resource is not None:
        try:
            out["vmhwm"] = _resource.getrusage(
                _resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:
            pass
    return out or None


def sample_devices():
    """Poll the caching allocator of every visible CUDA device this
    process already uses into per-device dicts (bytes_in_use /
    peak_bytes_in_use / bytes_reserved / bytes_limit) and the
    ``mxtpu_device_bytes_*`` gauges. None on the host (no CUDA, or torch
    not imported), gracefully. Never the first to touch the card: before
    CUDA is initialised it returns None, and a device without a CUDA
    context (nothing reserved) is skipped, so sampling creates none.
    Never called from the signal path (the dump reads the cached last
    sample)."""
    if _STATE.caps is False or not enabled():
        return _STATE.devices if _STATE.caps else None
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_available():
            _STATE.caps = False  # GIL-atomic: signal-safe cache
            return None
        if not torch.cuda.is_initialized():
            return None  # no context yet: do not make one from here
        count = torch.cuda.device_count()
    except Exception:
        return None
    out = {}
    for i in range(count):
        try:
            stats = torch.cuda.memory_stats(i)
            reserved = int(stats.get("reserved_bytes.all.current", 0))
            if not reserved:
                continue
            _, limit = torch.cuda.mem_get_info(i)
        except Exception:
            continue
        out[str(i)] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": reserved,
            "bytes_limit": int(limit)}
    if not out:
        return None
    # last-sample cache, lock-free by design: the flight recorder's
    # signal-context snapshot() reads these fields
    _STATE.caps = True  # GIL-atomic: signal-safe cache
    _STATE.devices = out  # GIL-atomic: signal-safe cache
    _STATE.devices_ts = time.time()  # GIL-atomic: signal-safe cache
    for dev_id, stats in out.items():
        labels = {"device": dev_id}
        core.gauge("mxtpu_device_bytes_in_use", labels).set(
            stats["bytes_in_use"])
        core.gauge("mxtpu_device_bytes_peak", labels).set(
            stats["peak_bytes_in_use"])
        core.gauge("mxtpu_device_bytes_limit", labels).set(
            stats["bytes_limit"])
    return out


def ndarray_created(nbytes):
    """NDArray constructor hook (ndarray.py): plain list adds, since this
    is the imperative hot path."""
    st = _STATE.nd_live
    st[0] += 1
    st[1] += nbytes


def ndarray_freed(nbytes):
    """NDArray ``__del__`` hook. Never raises: interpreter shutdown may
    have torn half the module down already."""
    try:
        st = _STATE.nd_live
        st[0] -= 1
        st[1] -= nbytes
    except Exception:
        pass


def ndarray_resized(delta):
    """`NDArray._set_data` swapped in a buffer of another size."""
    _STATE.nd_live[1] += delta


def ndarray_live():
    """(live_count, live_bytes) of the NDArray handles this process
    holds."""
    return _STATE.nd_live[0], _STATE.nd_live[1]


def sample(devices=True):
    """Refresh every memory gauge: process RSS/VmHWM and (``devices=True``)
    the per-device stats. Called from
    the JSONL flush, the Prometheus scrape, the optional poller thread
    (``MXTPU_MEMORY_POLL_MS``) and per-step. Cheap: one /proc read plus
    plain gauge stores."""
    if not enabled():
        return None
    proc = read_process_memory()
    if proc is not None:
        if "rss" in proc:
            core.gauge("mxtpu_process_rss_bytes").set(proc["rss"])
        if "vmhwm" in proc:
            core.gauge("mxtpu_process_vmhwm_bytes").set(proc["vmhwm"])
    live, live_bytes = ndarray_live()
    core.gauge("mxtpu_ndarray_live").set(live)
    core.gauge("mxtpu_ndarray_live_bytes").set(live_bytes)
    if devices:
        sample_devices()
    return proc


def _peak_bytes():
    """The process's best peak-memory signal: device peak when the
    backend reports one (HBM is what OOMs), else the RSS high-water
    mark. This sits on the per-step hot path, so the host fallback is
    ONE getrusage syscall — never a /proc read (~200µs on some container
    kernels, which a <2%-overhead budget cannot afford)."""
    if _STATE.caps is not False:
        devs = sample_devices()
        if devs:
            return sum(s.get("peak_bytes_in_use", 0) for s in devs.values())
    if _resource is not None:
        try:
            return _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:
            pass
    proc = read_process_memory()
    if proc is None:
        return None
    return proc.get("vmhwm") or proc.get("rss")


_STEP_PROBE_MIN_S = 0.1  # rate limit: the peak probe is a syscall (and
#                          some container kernels make getrusage ~15µs); steps
#                          faster than this share one probe window — the
#                          <2% per-step overhead contract stands, and
#                          fast steps barely move the peak anyway


def observe_step_delta(exemplar=None, force=False):
    """Per-step peak-memory growth: how much the peak (device, else
    VmHWM) moved since the previous probe, into the
    ``mxtpu_step_peak_bytes_delta`` histogram — with the step's trace id
    as exemplar, so the step that spiked memory names a renderable
    trace. Called from `telemetry.observe_step`; probed at most every
    ``_STEP_PROBE_MIN_S`` (``force=True`` bypasses — tests)."""
    if not enabled():
        return
    now = time.monotonic()
    if not force and now - _STATE.step_peak_ts < _STEP_PROBE_MIN_S:
        return
    _STATE.step_peak_ts = now
    peak = _peak_bytes()
    if peak is None:
        return
    prev = _STATE.step_peak
    _STATE.step_peak = peak
    if prev is None:
        return
    core.histogram("mxtpu_step_peak_bytes_delta",
                   bounds=core.BYTE_BOUNDS).observe(
        max(0, peak - prev), exemplar=exemplar)


# ---------------------------------------------------------------------------
# poller
# ---------------------------------------------------------------------------

def _poller_loop(period_s):
    while True:
        time.sleep(period_s)
        if os.getpid() != core._STATE.owner_pid:
            return
        sample()


def ensure_poller():
    """Start the background gauge poller once if ``MXTPU_MEMORY_POLL_MS``
    asks for one (default off — the flush/scrape/step sampling is enough
    for most runs; long forwards between steps are what the poller is
    for). Env decision cached, same discipline as the flusher."""
    if _STATE.poller_decided:
        return
    with _DECIDE_LOCK:  # double-checked: only the cold path locks
        if _STATE.poller_decided:
            return
        _STATE.poller_decided = True
        if not enabled():
            return
        period_ms = _env.get("MXTPU_MEMORY_POLL_MS")
        if not period_ms or period_ms <= 0:
            return
        t = threading.Thread(target=_poller_loop,
                             args=(max(0.01, period_ms / 1e3),),
                             name="mxtpu-memory-poll", daemon=True)
        _STATE.poller = t
        t.start()


# ---------------------------------------------------------------------------
# forensics snapshot (flight-recorder dump block — SIGNAL-SAFE)
# ---------------------------------------------------------------------------

def snapshot(top_n=10):
    """The flight recorder's memory block: process RSS/VmHWM (read fresh:
    one /proc read), the LAST polled device stats (never a fresh torch
    call from a signal context), the top-N recorded buckets by temp bytes
    and the last donation report (None in the port). Every hang or OOM
    dump says what was resident."""
    return {
        "process": read_process_memory(),
        "devices": _STATE.devices,
        "devices_sampled_ago_s":
            None if _STATE.devices_ts is None
            else round(time.time() - _STATE.devices_ts, 1),
        "ndarray": {"live": _STATE.nd_live[0],
                    "live_bytes": _STATE.nd_live[1]},
        "executables_by_temp": executables_top(top_n),
        "donation": _STATE.last_donation,
    }


# ---------------------------------------------------------------------------
# serving memory budget
# ---------------------------------------------------------------------------

_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_bytes(text):
    """``"1073741824"`` / ``"512M"`` / ``"1.5G"`` -> bytes (int), or None
    on a value that parses to nothing."""
    s = str(text).strip().lower()
    if not s:
        return None
    mult = 1
    if s[-1] in _SUFFIX:
        mult = _SUFFIX[s[-1]]
        s = s[:-1]
    try:
        return int(float(s) * mult)
    except ValueError:
        return None


def serve_memory_budget():
    """The serving memory budget from ``MXTPU_SERVE_MEMORY_BUDGET``:
    ``(limit_bytes, warn_only)`` or ``(None, False)`` when unset. A
    ``warn:`` prefix turns rejection into a logged warning (canary
    posture); a malformed value disables the check (never blocks a
    load)."""
    raw = _env.raw("MXTPU_SERVE_MEMORY_BUDGET") or ""
    warn = False
    if raw.lower().startswith("warn:"):
        warn = True
        raw = raw[5:]
    limit = parse_bytes(raw) if raw else None
    return limit, warn
