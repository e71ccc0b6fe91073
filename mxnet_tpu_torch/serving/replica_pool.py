"""Supervised replica pool: the serving resilience router.

Counterpart of `mxnet_tpu/serving/replica_pool.py`. `DynamicBatcher`
assembles batches; this pool routes them to N replica worker processes
(`supervisor.py`) and keeps the endpoint answering through their failures:

  * **health**: every replica is watched on a heartbeat deadline
    (``MXTPU_SERVE_HEARTBEAT_MS``). An idle replica is pinged; a busy one
    may stay silent until its batch deadline (at least
    ``MXTPU_SERVE_WEDGE_TIMEOUT_MS``) plus the heartbeat grace. A dead
    (process exit) or wedged (deadline missed) replica is EJECTED, its
    process group torn down, and respawned on a new generation with
    exponential backoff.
  * **failover**: the ejected replica's in-flight batch goes back to the
    front of the queue EXACTLY ONCE a request (`DynamicBatcher.requeue`;
    predict is idempotent). Expired members answer 504, twice-unlucky
    members a retryable 503. A generation request is requeued once and
    recomputed from its prompt on another replica.
  * **load shedding**: with h of N replicas healthy only ``h/N`` of the
    queue depth is admitted; beyond it (or at h = 0) clients get 503 with
    a ``Retry-After`` scaled to the healthy count.
  * **deadline propagation**: each dispatched batch carries its remaining
    deadline budget; the replica cancels (``expired``) instead of
    computing answers nobody is waiting for.

Pool state goes to telemetry under the JAX package's names (the
healthy-replica gauge, the failover / restart / shed counters, the
per-replica in-flight gauge) and every ejection records an event.

The workers run on the device the pool resolved when it was built
(`context.resolve_device`: the caller's `context.scope`, else the card);
the pool passes it as ``--device`` and a worker never picks the host on
its own. Within a replica the padding buckets share one copy of the
weights (`predict._clone_with`); across replica processes each loads its
own copy in its own CUDA context (co-located replicas share the card,
not the weights), as the JAX package's replicas do across PJRT clients.
"""
from __future__ import annotations

import collections
import hmac
import math
import queue
import secrets
import socket
import threading
import time

from .. import env as _env
from .. import telemetry
from ..base import MXNetError
from ..context import resolve_device
from ..telemetry import tracing as _tracing
from .batcher import (DeadlineExceededError, DrainingError, OverloadedError,
                      QueueFullError, ServingError, drain_timeout_s,
                      pad_batch)
from .supervisor import (TOKEN_LEN, ReplicaProcess, backoff_s, recv_msg,
                         send_msg)

__all__ = ["ReplicaPool"]

# replica slot states
_SPAWNING = "spawning"   # process launched, not yet ready
_READY = "ready"         # healthy, idle
_BUSY = "busy"           # healthy, running a batch
_DEAD = "dead"           # ejected, awaiting respawn backoff


class _Slot:
    """Mutable state for one replica slot (owned by its dispatch thread;
    `state`/`conn` transitions are published under the pool lock)."""

    def __init__(self, replica_id, proc, joining=False):
        self.id = replica_id
        self.proc = proc          # ReplicaProcess (generation counter)
        self.state = _DEAD
        self.conn = None
        self.conn_event = threading.Event()  # a connection arrived
        self.ready_info = None
        self.consecutive_restarts = 0
        self.msg_id = 0
        self.thread = None        # this slot's dispatch thread
        # resize protocol: `stop` asks the
        # dispatch thread to finish its in-flight work and exit (set under
        # the pool lock; the thread polls it between batches); `joining`
        # marks a scale-up member that has not reported ready yet — the
        # degraded-admission gate must not shed while a NEW replica warms
        # (only when an ESTABLISHED one is lost)
        self.stop = False
        self.joining = joining
        # generate mode: stats round trips requested by the api thread,
        # serviced by this slot's dispatch loop (deque append/popleft are
        # GIL-atomic; waiter events close the handoff)
        self.stats_requests = collections.deque()
        self.stats_pending = {}   # msg id -> waiter (dispatch thread only)


class ReplicaPool:
    """Router + supervisor for one served model's replica processes.

    Parameters
    ----------
    model : str
        Telemetry and event label (usually ``name/version``).
    worker_args : list of str
        Argv tail for ``python -m mxnet_tpu_torch.serving.replica_worker``:
        what to serve (``--artifact`` / ``--input`` / ``--stub`` /
        ``--generate`` flags). The pool adds ``--device``.
    replicas : int
        Pool size (>= 1).
    heartbeat_ms / backoff_ms / wedge_timeout_ms : float, optional
        Override ``MXTPU_SERVE_HEARTBEAT_MS`` /
        ``MXTPU_SERVE_RESTART_BACKOFF_MS`` /
        ``MXTPU_SERVE_WEDGE_TIMEOUT_MS``.
    extra_env : dict, optional
        Extra environment for replica processes only (tests inject
        ``MXTPU_FAULT_INJECT`` serving actions here so the router itself
        stays fault-free).
    spawn_timeout_s : float
        Budget for one replica spawn → ready (includes model load + full
        bucket warm; compiles can be slow).
    teardown_grace : float, optional
        Seconds between SIGTERM and SIGKILL at ejection (default
        ``MXTPU_TEARDOWN_GRACE``; tests shrink it).
    generate : bool
        Route generation requests one by one (each worker runs its own
        continuous-batching scheduler) instead of predict batches.
    device : Context, torch.device or str, optional
        Where the workers run; default the calling thread's innermost
        `context.scope`, else the card (raises without one).
    """

    def __init__(self, model, worker_args, replicas, heartbeat_ms=None,
                 backoff_ms=None, extra_env=None, spawn_timeout_s=120.0,
                 teardown_grace=None, wedge_timeout_ms=None, generate=False,
                 gen_queue_depth=None, gen_outstanding=None, device=None):
        if replicas < 1:
            raise MXNetError("replica pool needs >= 1 replicas, got %d"
                             % replicas)
        # resolved in the caller's thread (its scope), before any process
        # starts: without a card and without a CPU scope this raises
        self.device = resolve_device(device)
        self.model = str(model)
        self.size = int(replicas)
        if heartbeat_ms is None:
            heartbeat_ms = _env.get("MXTPU_SERVE_HEARTBEAT_MS")
        self.heartbeat_s = max(0.01, float(heartbeat_ms) / 1e3)
        if wedge_timeout_ms is None:
            wedge_timeout_ms = _env.get("MXTPU_SERVE_WEDGE_TIMEOUT_MS")
        self.wedge_timeout_s = max(0.05, float(wedge_timeout_ms) / 1e3)
        self._backoff_ms = backoff_ms
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._batcher = None
        self._stop = False
        self._lock = threading.Lock()
        # BOUNDED handoff (one buffered batch per replica): when every
        # replica is busy and the buffer is full, dispatch_batch blocks
        # the batcher worker, the request queue backs up, and the existing
        # 429/degraded-503 admission checks fire — an unbounded buffer
        # here would hide the backlog from admission control entirely
        self._work = queue.Queue(maxsize=max(1, self.size))
        # generate mode: requests route
        # individually — each replica worker runs its own continuous-
        # batching scheduler, so the router's job is request routing,
        # health and exactly-once failover, not batch assembly
        self._generate = bool(generate)
        if gen_queue_depth is None:
            gen_queue_depth = _env.get("MXTPU_SERVE_QUEUE_DEPTH")
        self._gen_queue_depth = max(1, int(gen_queue_depth))
        self._gen_outstanding = max(1, int(gen_outstanding)) \
            if gen_outstanding else 16
        self._gen_cv = threading.Condition()
        self._gen_pending = collections.deque()
        self._gen_live = set()    # admitted + unresolved (guarded: _gen_cv)

        labels = {"model": self.model}
        if self._generate:
            # router-side admission volume and end-to-end latency of a
            # pooled GENERATE model (a predict pool has its batcher's; the
            # LM schedulers' copies live in the workers under per-replica
            # labels)
            self._m_gen_reqs = telemetry.counter(
                "mxtpu_serve_requests_total", labels)
            self._m_gen_request_s = telemetry.histogram(
                "mxtpu_serve_request_seconds", labels)
            self._m_gen_shed = {
                reason: telemetry.counter(
                    "mxtpu_serve_rejected_total",
                    {"model": self.model, "reason": reason})
                for reason in ("queue_full", "shed")}
        self._m_healthy = telemetry.gauge("mxtpu_serve_pool_healthy", labels)
        self._m_size = telemetry.gauge("mxtpu_serve_pool_size", labels)
        # the replica-count gauge under the autoscaler's name (the same
        # value as pool_size)
        self._m_replicas = telemetry.gauge("mxtpu_serve_replicas", labels)
        self._m_size.set(self.size)
        self._m_replicas.set(self.size)
        self._m_failover = telemetry.counter("mxtpu_serve_failover_total",
                                             labels)
        self._m_requeued = telemetry.counter(
            "mxtpu_serve_failover_requeued_total", labels)
        self._m_restarts = telemetry.counter(
            "mxtpu_serve_replica_restart_total", labels)
        self._m_inflight = {}  # replica id -> per-replica in-flight gauge
        self._m_generation = {}  # replica id -> restart-generation gauge

        # per-pool handshake secret: a connection must present it before
        # the accept loop will unpickle a single frame (localhost TCP is
        # reachable by every local user; pickle is not)
        self._token = secrets.token_hex(TOKEN_LEN // 2)

        # one listener for every replica generation; workers CONNECT to it
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(max(8, replicas * 2))
        self._listener.settimeout(0.25)
        addr = self._listener.getsockname()

        # kept for in-place resize: add_replica spawns new slots with the
        # SAME serving spec the pool was built with
        self._addr = (addr[0], addr[1])
        self._worker_args = list(worker_args) + ["--device",
                                                 str(self.device)]
        self._extra_env = extra_env
        self._teardown_grace = teardown_grace
        self._next_id = 0

        # `_slots` is REPLACED wholesale (never mutated in place) under
        # the pool lock, so lock-free readers iterate a consistent
        # snapshot even while a resize is landing; slot/gauge creation
        # holds the lock for the same discipline add_replica follows
        self._slots = []
        with self._lock:
            for _ in range(replicas):
                self._slots = self._slots + [self._new_slot()]

        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="mxtpu-pool-accept-%s" % self.model)
        self._accept_thread.start()
        self._threads = []
        for slot in self._slots:
            self._start_slot_thread(slot)

    def _new_slot(self, joining=False):
        """Build one slot + its telemetry gauges (caller publishes it into
        `_slots` and starts its dispatch thread)."""
        k = self._next_id
        self._next_id += 1
        proc = ReplicaProcess(self.model, k, self._addr, self._worker_args,
                              extra_env=self._extra_env,
                              teardown_grace=self._teardown_grace,
                              token=self._token)
        slot = _Slot(k, proc, joining=joining)
        self._m_inflight[k] = telemetry.gauge(
            "mxtpu_serve_replica_inflight",
            {"model": self.model, "replica": str(k)})
        # restart generation per replica, as a gauge (read without the
        # pool's lock)
        self._m_generation[k] = telemetry.gauge(
            "mxtpu_serve_replica_generation",
            {"model": self.model, "replica": str(k)})
        return slot

    def _start_slot_thread(self, slot):
        t = threading.Thread(target=self._replica_loop, args=(slot,),
                             daemon=True,
                             name="mxtpu-pool-%s-r%d" % (self.model,
                                                         slot.id))
        slot.thread = t
        self._threads.append(t)  # mxlint: gil-atomic — append-only roster
        t.start()

    def _slot_by_id(self, replica_id):
        for s in self._slots:
            if s.id == replica_id:
                return s
        return None

    def _resize_work_queue(self):
        """Track the bounded dispatch handoff to the live pool size (one
        buffered batch per replica — the backpressure contract)."""
        with self._work.mutex:
            self._work.maxsize = max(1, self.size)
            self._work.not_full.notify_all()

    # -- batcher wiring ----------------------------------------------------
    def bind(self, batcher):
        """Attach the model's DynamicBatcher (its dispatcher hook feeds
        `dispatch_batch`; its admission gate is `admission_gate`)."""
        self._batcher = batcher

    def dispatch_batch(self, batch, total):
        """DynamicBatcher dispatcher hook (runs on the batcher worker
        thread): hand the assembled batch to the replica dispatch threads
        — N replicas run N batches concurrently. Blocks while the bounded
        handoff buffer is full so overload backpressure reaches the
        batcher's admission checks instead of piling up here; expired
        members are pruned replica-side at dispatch."""
        while not self._stop:
            try:
                self._work.put((batch, total), timeout=0.05)
                return
            except queue.Full:
                continue
        # pool shut down under the batch: resolve, don't strand
        self._batcher.fail_batch(batch, OverloadedError(
            "model %r replica pool shut down before dispatch" % self.model))

    def admission_gate(self, queued_len):
        """Deterministic load shedding, consulted under the batcher queue
        lock on every submit. Healthy pool: admit (the depth check still
        applies). Degraded pool: scale the admissible queue to the healthy
        fraction. Dead pool: shed everything, Retry-After = the respawn
        backoff horizon.

        `size`/`expected_count` are read LIVE on every call, so after an
        autoscaler resize the shed quota and the ``Retry-After =
        ceil(N/h)`` horizon are computed against the POST-resize pool —
        never a size captured before the resize landed. A scale-up member
        that has not warmed yet (`joining`) is excluded from `expected`:
        growing the pool must not trigger shedding while the new replica
        compiles."""
        with self._lock:  # ONE acquisition per admission (hot path)
            healthy = sum(1 for s in self._slots
                          if s.state in (_READY, _BUSY))
            expected = max(1, self.size - sum(1 for s in self._slots
                                              if s.joining))
        if healthy >= expected:
            return None
        if healthy == 0:
            slots = self._slots  # consistent snapshot (replaced wholesale)
            eta = max((backoff_s(s.consecutive_restarts, self._backoff_ms)
                       for s in slots), default=1.0)
            return OverloadedError(
                "model %r has no healthy replicas (respawn in progress)"
                % self.model, retry_after=max(1.0, eta))
        # max(1, ...): a degraded-but-alive pool must keep admitting —
        # small queue depths would otherwise floor the quota to 0 and turn
        # a single-replica loss into a total outage
        allowed = max(1, int(self._batcher.queue_depth * healthy
                             / expected)) \
            if self._batcher is not None else 0
        if queued_len >= allowed:
            return OverloadedError(
                "model %r is degraded (%d/%d replicas healthy; queue "
                "scaled to %d)" % (self.model, healthy, expected, allowed),
                retry_after=math.ceil(self.size / healthy))
        return None

    # -- in-place resize ---------------------------------------------------
    def add_replica(self):
        """Grow the pool by one replica IN PLACE: spawn a fresh worker
        (same serving spec, fresh id) and start its dispatch thread. The
        new member joins the rotation when its warm finishes; until then
        the admission gate treats the pool at its pre-grow capacity
        instead of shedding. Returns the new replica id."""
        with self._lock:
            if self._stop:
                raise MXNetError("replica pool %r is shut down" % self.model)
            slot = self._new_slot(joining=True)
            self._slots = self._slots + [slot]
            self.size += 1
            size = self.size
        self._resize_work_queue()
        self._m_size.set(size)
        self._m_replicas.set(size)
        self._start_slot_thread(slot)
        telemetry.record_event("serve_replica_add", model=self.model,
                               replica=slot.id, size=size)
        return slot.id

    def remove_replica(self, replica_id=None, drain=True, timeout=None,
                       floor=1):
        """Shrink the pool by one replica IN PLACE with zero request
        loss: the victim (default: the newest slot) stops taking new work
        immediately, finishes what it has in flight, and is then torn
        down. If the worker dies mid-drain its unresolved work rides the
        existing exactly-once failover re-enqueue instead of being lost.
        ``drain=False`` (or a drain past ``timeout``) forces teardown —
        in-flight work then fails over. ``floor`` is checked UNDER the
        pool lock, so concurrent removers (the autoscaler's idle drain
        racing a load's budget-pressure reclaim) cannot both pass a
        caller-side check and shrink below a model's ``min_replicas``.
        Returns the removed replica id."""
        if timeout is None:
            timeout = drain_timeout_s()
        floor = max(1, int(floor))
        with self._lock:
            if self.size <= floor:
                raise MXNetError(
                    "replica pool %r cannot shrink below %d replica(s)"
                    % (self.model, floor))
            slots = self._slots
            if replica_id is None:
                slot = slots[-1]
            else:
                slot = next((s for s in slots if s.id == replica_id), None)
                if slot is None:
                    raise MXNetError("replica pool %r has no replica %r"
                                     % (self.model, replica_id))
            # published BEFORE the drain: admission/quota math and the
            # healthy gauge see the post-resize pool immediately
            slot.stop = True
            self._slots = [s for s in slots if s is not slot]
            self.size -= 1
            size = self.size
        self._resize_work_queue()
        self._m_size.set(size)
        self._m_replicas.set(size)
        self._set_healthy_gauge()
        with self._gen_cv:
            self._gen_cv.notify_all()  # wake an idle generate dispatch wait
        t = slot.thread
        if not drain:
            # no-drain removal: tear the worker down now; the dispatch
            # thread ejects on the dead socket and fails in-flight work
            # over exactly once
            slot.proc.teardown()
        if t is not None:
            t.join(timeout=max(0.1, timeout))
            if t.is_alive():
                # drain overran its budget: force the worker out — the
                # dispatch thread sees the dead socket, ejects, and fails
                # any in-flight work over exactly once
                slot.proc.teardown()
                t.join(timeout=10.0)
        conn = slot.conn
        if conn is not None:
            try:
                send_msg(conn, {"kind": "shutdown"})
            except OSError:
                pass
        slot.proc.teardown()
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        # retire the removed slot's per-replica series — a gauge for a
        # replica that no longer exists would read as a ghost
        reg = telemetry.get_registry()
        for name in ("mxtpu_serve_replica_inflight",
                     "mxtpu_serve_replica_generation"):
            reg.remove(name, {"model": self.model, "replica": str(slot.id)})
        with self._lock:
            self._m_inflight.pop(slot.id, None)
            self._m_generation.pop(slot.id, None)
        telemetry.record_event("serve_replica_remove", model=self.model,
                               replica=slot.id, size=size,
                               drained=not (t is not None and t.is_alive()))
        return slot.id

    # -- generate-mode routing ----------------------------------------------
    def submit_generate(self, req):
        """Admit one `GenRequest` into the pool's routing queue. Healthy
        replicas' dispatch threads pull from it; admission sheds
        deterministically like predict (dead pool: 503 + backoff ETA,
        full queue: 429). `healthy_count` is read BEFORE the queue lock —
        the pool lock and the generate lock never nest."""
        healthy = self.healthy_count
        with self._gen_cv:
            if self._stop:
                raise DrainingError("model %r replica pool is shut down"
                                    % self.model)
            if healthy == 0:
                eta = max((backoff_s(s.consecutive_restarts,
                                     self._backoff_ms)
                           for s in self._slots), default=1.0)
                self._m_gen_shed["shed"].inc()
                raise OverloadedError(
                    "model %r has no healthy replicas (respawn in "
                    "progress)" % self.model, retry_after=max(1.0, eta))
            if len(self._gen_pending) >= self._gen_queue_depth:
                self._m_gen_shed["queue_full"].inc()
                raise QueueFullError(
                    "generation queue for %r is full (%d requests; "
                    "MXTPU_SERVE_QUEUE_DEPTH)"
                    % (self.model, self._gen_queue_depth))
            self._gen_pending.append(req)
            self._gen_live.add(req)
            self._m_gen_reqs.inc()
            self._gen_cv.notify()
        return req

    def generate_pending(self):
        """Admitted-and-unresolved generation requests (drain progress)."""
        with self._gen_cv:
            return len(self._gen_live)

    def drain_generate(self, timeout=None):
        if timeout is None:
            timeout = drain_timeout_s()
        deadline = time.monotonic() + timeout
        while self.generate_pending():
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return True

    def abort_generate(self, error=None):
        """Force-resolve every admitted generation request (bounded-drain
        escape hatch; first-resolution-wins makes the race with live
        replies benign). Returns how many were force-resolved."""
        if error is None:
            error = DrainingError(
                "model %r shut down before this generation completed"
                % self.model)
        with self._gen_cv:
            victims = list(self._gen_live)
            self._gen_pending.clear()
        n = 0
        for req in victims:
            if not req.done():
                req._resolve(error=error)
                n += 1
        with self._gen_cv:
            self._gen_live.difference_update(victims)
        return n

    def replica_stats(self, replica_id, timeout=5.0):
        """One stats round trip to a generation replica (KV-page occupancy,
        kernel builds after warm-up, the paged kernel's launches, peak
        device bytes). Returns the worker's stats dict, or None on timeout
        or ejection."""
        slot = self._slot_by_id(replica_id)
        if slot is None:
            return None
        waiter = {"event": threading.Event(), "result": None}
        slot.stats_requests.append(waiter)
        with self._gen_cv:
            self._gen_cv.notify_all()   # nudge an idle dispatch loop
        if not waiter["event"].wait(timeout):
            return None
        return waiter["result"]

    def _gen_wire_error(self, msg):
        """Map a worker ``gen_error`` frame back to the typed admission
        error the HTTP layer knows how to answer."""
        status = msg.get("status")
        text = str(msg.get("error") or "replica generation error")
        if status == 429:
            return QueueFullError(text)
        if status == 504:
            return DeadlineExceededError(text)
        if status == 503:
            return OverloadedError(text)
        if status == 400:
            return MXNetError(text)
        return ServingError(text)

    def _requeue_generate(self, reqs):
        """Failover: push a dead replica's unresolved generation requests
        back to the routing queue's front, EXACTLY ONCE per request (the
        decode prefix is recomputed on the new replica — generation from
        a fixed prompt is idempotent for greedy and harmlessly re-drawn
        for sampled requests). Expired members 504; twice-unlucky get a
        retryable 503."""
        now = time.monotonic()
        requeued = 0
        taken = set()
        with self._gen_cv:
            accept = not self._stop
            for req in reversed(reqs):
                if req.done():
                    continue
                if req.deadline is not None and now >= req.deadline:
                    continue   # resolved below, outside the lock
                if req.retried or not accept:
                    continue
                req.retried = True
                req.tag = None
                taken.add(req)
                self._gen_pending.appendleft(req)
                requeued += 1
            if requeued:
                self._gen_cv.notify_all()
        for req in reqs:
            if req in taken:
                continue
            # even already-resolved requests (router-side expiry fired
            # while the batch was in flight) must leave _gen_live, or a
            # dead replica's phantom entries pin generate_pending() > 0
            # and every later drain spins to its timeout
            with self._gen_cv:
                self._gen_live.discard(req)
            if req.done():
                continue
            if req.deadline is not None and now >= req.deadline:
                req._resolve(error=DeadlineExceededError(
                    "deadline expired during replica failover"))
            elif req.retried:
                req._resolve(error=OverloadedError(
                    "generation already failed over once on model %r"
                    % self.model))
            else:
                req._resolve(error=OverloadedError(
                    "model %r is draining; generation not retried"
                    % self.model))
        return requeued

    def _serve_generate(self, slot):
        """Generate-mode dispatch loop for one replica: pull requests
        from the routing queue (bounded outstanding window), ship them as
        ``generate`` frames, and resolve ``gen_result``/``gen_error``
        replies as they arrive — OUT OF ORDER, matched by id, because the
        worker's scheduler finishes sequences at different lengths. The
        worker's receive thread answers pings while its scheduler
        decodes, so liveness stays on the heartbeat clock even under
        long generations. Returns (reason, unresolved) for ejection, or
        None on clean shutdown."""
        conn = slot.conn
        outstanding = {}   # msg id -> (req, dispatch ref, t0, t0_wall)
        last_frame = time.monotonic()
        ping_pending = False

        def unresolved():
            return [e[0] for e in outstanding.values()]

        try:
            while not self._stop:
                # drain the routing queue up to the outstanding window
                # BEFORE blocking on the socket: a burst of admissions
                # must not pay one recv timeout per dispatched request.
                # A draining slot (removal in progress) admits nothing
                # new but keeps servicing replies for what it dispatched.
                while len(outstanding) < self._gen_outstanding \
                        and not slot.stop:
                    req = None
                    with self._gen_cv:
                        if self._gen_pending:
                            req = self._gen_pending.popleft()
                        elif not outstanding and not slot.stats_requests:
                            self._gen_cv.wait(0.05)
                    if req is None:
                        break
                    now = time.monotonic()
                    if req.done():
                        with self._gen_cv:
                            self._gen_live.discard(req)
                        continue
                    if req.deadline is not None and now >= req.deadline:
                        with self._gen_cv:
                            self._gen_live.discard(req)
                        req._resolve(error=DeadlineExceededError(
                            "deadline expired before dispatch"))
                        continue
                    slot.msg_id += 1
                    req.tag = slot.msg_id
                    ref = _tracing.child_ref(req.trace)
                    frame = {
                        "kind": "generate", "id": slot.msg_id,
                        "tokens": req.tokens,
                        "max_new_tokens": req.max_new_tokens,
                        "temperature": req.temperature,
                        "top_k": req.top_k, "top_p": req.top_p,
                        "remaining": None if req.deadline is None
                        else max(0.0, req.deadline - now),
                        "trace": _tracing.to_wire(ref)
                        if ref is not None and ref.sampled else None,
                    }
                    try:
                        send_msg(conn, frame)
                    except OSError:
                        return ("died_mid_batch", [req] + unresolved())
                    outstanding[slot.msg_id] = (req, ref, now, time.time())
                    self._m_inflight[slot.id].set(len(outstanding))
                while slot.stats_requests:
                    waiter = slot.stats_requests.popleft()
                    slot.msg_id += 1
                    slot.stats_pending[slot.msg_id] = waiter
                    try:
                        send_msg(conn, {"kind": "stats",
                                        "id": slot.msg_id})
                    except OSError:
                        return ("died_mid_batch", unresolved())
                if slot.stop and not outstanding:
                    return None  # removal drain complete: nothing in flight
                try:
                    msg = recv_msg(
                        conn,
                        first_timeout=0.01 if outstanding else 0.05,
                        rest_timeout=max(1.0, self.heartbeat_s))
                except socket.timeout:
                    now = time.monotonic()
                    if not slot.proc.alive():
                        return ("died", unresolved())
                    if now - last_frame > 2 * self.heartbeat_s \
                            and ping_pending:
                        return ("heartbeat_missed", unresolved())
                    if now - last_frame > self.heartbeat_s \
                            and not ping_pending:
                        slot.msg_id += 1
                        try:
                            send_msg(conn, {"kind": "ping",
                                            "id": slot.msg_id})
                        except OSError:
                            return ("died_mid_batch", unresolved())
                        ping_pending = True
                    # router-side expiry backstop (grace past the
                    # deadline: the worker's own expiry normally answers
                    # first; first-resolution-wins absorbs the race)
                    for r, _, _, _ in list(outstanding.values()):
                        if r.deadline is not None \
                                and now >= r.deadline + 1.0 \
                                and not r.done():
                            r._resolve(error=DeadlineExceededError(
                                "generation deadline expired"))
                    continue
                except OSError:
                    return ("died_mid_batch", unresolved())
                if msg is None:
                    return ("died", unresolved())
                last_frame = time.monotonic()
                kind = msg.get("kind")
                if kind == "pong":
                    ping_pending = False
                elif kind in ("gen_result", "gen_error"):
                    entry = outstanding.pop(msg.get("id"), None)
                    self._m_inflight[slot.id].set(len(outstanding))
                    if entry is None:
                        continue   # late reply for a resolved request
                    r, ref, t0, t0_wall = entry
                    with self._gen_cv:
                        self._gen_live.discard(r)
                    if kind == "gen_result":
                        if ref is not None:
                            _tracing.emit_span(
                                "serve.dispatch", t0_wall,
                                time.monotonic() - t0, r.trace,
                                component="router", span_id=ref.span_id,
                                attrs={"replica": slot.id,
                                       "tokens":
                                       len(msg.get("tokens") or ())})
                        # router-side end-to-end latency (admission to
                        # resolution)
                        self._m_gen_request_s.observe(
                            max(0.0, time.monotonic() - r._t_submit),
                            exemplar=r.trace.trace_id
                            if r.trace is not None and r.trace.recorded
                            else None)
                        r._resolve(outputs=list(msg.get("tokens") or []),
                                   finish_reason=msg.get("finish_reason"))
                        # the generation proved itself: reset backoff
                        if slot.consecutive_restarts:
                            with self._lock:
                                slot.consecutive_restarts = 0
                    else:
                        r._resolve(error=self._gen_wire_error(msg))
                elif kind == "stats_result":
                    waiter = slot.stats_pending.pop(msg.get("id"), None)
                    if waiter is not None:
                        waiter["result"] = msg.get("stats")
                        waiter["event"].set()
                else:
                    return ("protocol_desync", unresolved())
            return None
        finally:
            self._m_inflight[slot.id].set(0)
            for waiter in slot.stats_pending.values():
                waiter["event"].set()   # never park replica_stats callers
            slot.stats_pending.clear()

    # -- state -------------------------------------------------------------
    @property
    def healthy_count(self):
        with self._lock:
            return sum(1 for s in self._slots
                       if s.state in (_READY, _BUSY))

    @property
    def expected_count(self):
        """How many replicas the pool is SUPPOSED to have serving right
        now: the live size minus scale-up members still warming. The
        degraded-admission denominator — a joining replica must not
        count as a loss."""
        with self._lock:
            return max(1, self.size - sum(1 for s in self._slots
                                          if s.joining))

    def wait_ready(self, timeout=None):
        """Block until every replica reported ready once (load + warm).
        Returns the first replica's ready info (buckets, shapes, dtypes).
        Raises MXNetError on timeout."""
        if timeout is None:
            timeout = self._spawn_timeout_s
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                infos = [s.ready_info for s in self._slots]
            if all(i is not None for i in infos):
                return infos[0]
            time.sleep(0.01)
        raise MXNetError(
            "replica pool %r: %d/%d replicas ready within %.0fs"
            % (self.model, self.healthy_count, self.size, timeout))

    def describe(self):
        with self._lock:
            return {
                "replicas": self.size,
                "mode": "generate" if self._generate else "predict",
                "healthy": sum(1 for s in self._slots
                               if s.state in (_READY, _BUSY)),
                "states": {s.id: s.state for s in self._slots},
                "generations": {s.id: s.proc.generation
                                for s in self._slots},
            }

    def replica_pid(self, replica_id):
        """Pid of a replica's current process (the chaos runs' hook)."""
        slot = self._slot_by_id(replica_id)
        return slot.proc.pid if slot is not None else None

    def replica_ids(self):
        """Live replica ids (sparse after resizes — ids never recycle)."""
        with self._lock:
            return [s.id for s in self._slots]

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout=5.0):
        """Stop dispatching, shut every replica down (shutdown message,
        then escalating teardown) and join the pool threads."""
        self._stop = True
        for _ in self._slots:
            try:
                self._work.put_nowait(None)  # wake idle dispatch threads
            except queue.Full:
                break  # full buffer: threads notice _stop on get timeout
        with self._gen_cv:
            self._gen_cv.notify_all()        # wake generate dispatch waits
        for t in self._threads:
            t.join(timeout=timeout)
        if self._generate:
            # anything still unresolved gets a deterministic answer, not
            # a stranded waiter
            self.abort_generate()
        for slot in self._slots:
            conn = slot.conn
            if conn is not None:
                try:
                    send_msg(conn, {"kind": "shutdown"})
                except OSError:
                    pass
            slot.proc.teardown()
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._set_healthy_gauge()

    # -- accept loop -------------------------------------------------------
    def _read_token(self, conn, timeout=5.0):
        """Read the fixed-length handshake secret — raw bytes, never
        pickled — and constant-time compare it to the pool's. False on
        short read, timeout, or mismatch."""
        conn.settimeout(timeout)
        buf = bytearray()
        try:
            while len(buf) < TOKEN_LEN:
                chunk = conn.recv(TOKEN_LEN - len(buf))
                if not chunk:
                    return False
                buf.extend(chunk)
        except (OSError, socket.timeout):
            return False
        return hmac.compare_digest(bytes(buf), self._token.encode("ascii"))

    def _accept_loop(self):
        """Accept replica connections, require the pool handshake secret
        BEFORE unpickling anything, match the hello to a slot and the
        slot's CURRENT generation (a zombie from a torn-down generation is
        refused), then hand the socket to the slot's dispatch thread."""
        while not self._stop:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if not self._read_token(conn):
                    conn.close()
                    continue
                hello = recv_msg(conn, first_timeout=5.0)
            except (OSError, socket.timeout):
                conn.close()
                continue
            if not isinstance(hello, dict) or hello.get("kind") != "hello":
                conn.close()
                continue
            k = hello.get("replica")
            gen = hello.get("generation")
            with self._lock:
                # slots are found BY ID, not index: after resizes the id
                # space is sparse (removed ids are never reused)
                slot = self._slot_by_id(k) if isinstance(k, int) else None
                if slot is None or gen != slot.proc.generation \
                        or slot.conn is not None:
                    slot = None
                else:
                    slot.conn = conn
                    slot.conn_event.set()
            if slot is None:
                conn.close()

    # -- per-replica dispatch / health loop --------------------------------
    def _replica_loop(self, slot):
        """One thread per replica slot: spawn → wait ready → serve batches
        (with idle heartbeats) → on death/wedge: eject, fail over, respawn
        with backoff. The loop body is guarded: this thread IS the slot's
        supervision — an escaped exception would silently shrink the pool
        forever (no eject event, no respawn), so any surprise ejects and
        respawns like a replica death."""
        while not self._stop and not slot.stop:
            try:
                # spawn the next generation
                slot.conn_event.clear()
                with self._lock:
                    slot.conn = None
                    slot.state = _SPAWNING
                gen = slot.proc.spawn()
                telemetry.record_event(
                    "serve_replica_spawn", model=self.model,
                    replica=slot.id, generation=gen, pid=slot.proc.pid)
                if not self._await_ready(slot):
                    if self._stop or slot.stop:
                        return
                    self._eject(slot, "spawn_failed", batch=None)
                    continue
                # serve until ejection, removal drain, or shutdown
                reason = self._serve_generate(slot) if self._generate \
                    else self._serve_generation(slot)
                if self._stop or reason is None:
                    return
                # a removed slot's failure still fails its in-flight work
                # over (exactly-once), but never respawns
                self._eject(slot, reason[0], batch=reason[1])
                if slot.stop:
                    return
            except Exception as e:
                if self._stop:
                    return
                telemetry.record_event(
                    "serve_replica_loop_error", model=self.model,
                    replica=slot.id, error=repr(e))
                try:
                    self._eject(slot, "internal_error", batch=None)
                except Exception:
                    pass  # keep supervising even when ejection misfires

    def _await_ready(self, slot):
        """Wait for this generation's connection + ready message (load +
        warm happen replica-side first). True on success."""
        deadline = time.monotonic() + self._spawn_timeout_s
        while time.monotonic() < deadline and not self._stop \
                and not slot.stop:
            if slot.conn_event.wait(timeout=0.1):
                break
            if not slot.proc.alive():
                return False  # died before connecting (bad artifact, OOM)
        if self._stop or slot.stop or slot.conn is None:
            return False
        try:
            msg = recv_msg(slot.conn,
                           first_timeout=max(0.1,
                                             deadline - time.monotonic()),
                           rest_timeout=30.0)
        except (OSError, socket.timeout):
            return False
        if not isinstance(msg, dict) or msg.get("kind") != "ready":
            return False
        with self._lock:
            slot.ready_info = msg
            slot.state = _READY
            # a scale-up member is established from its first ready: it
            # now counts toward the degraded-admission denominator
            slot.joining = False
            # consecutive_restarts is NOT reset here: an artifact that
            # warms on zeros but crashes on real input would otherwise
            # respawn at the constant initial backoff forever — the reset
            # waits until the generation serves a batch cleanly
        self._set_healthy_gauge()
        self._m_generation[slot.id].set(slot.proc.generation)
        telemetry.record_event(
            "serve_replica_ready", model=self.model, replica=slot.id,
            generation=slot.proc.generation,
            warm_seconds=round(msg.get("warm_seconds") or 0.0, 3))
        return True

    def _serve_generation(self, slot):
        """Dispatch batches on this replica until it dies or wedges.
        Returns (reason, batch_or_None) for ejection, or None on clean
        pool shutdown — or on a removal drain (`slot.stop`): the slot
        finishes the batch it holds, takes nothing new, and exits with
        zero request loss."""
        while not self._stop and not slot.stop:
            try:
                item = self._work.get(timeout=self.heartbeat_s / 2)
            except queue.Empty:
                # idle: liveness first (cheap), then a ping/pong round trip
                # bounded by the heartbeat deadline
                if not slot.proc.alive():
                    return ("died", None)
                if not self._ping(slot):
                    return ("heartbeat_missed", None)
                continue
            if item is None:
                return None  # close() sentinel
            batch, total = item
            # the batch may have aged in the work queue while every
            # replica was busy — do not ship expired members
            batch = self._batcher._prune_expired(batch)
            total = sum(r.n for r in batch)
            if not batch:
                continue
            try:
                outcome = self._run_batch(slot, batch, total)
            except Exception as e:
                # unexpected (bad output shapes in resolve_batch, a
                # pad_batch surprise): eject WITH the batch so its live
                # members ride the exactly-once failover instead of
                # hanging until their own deadlines
                telemetry.record_event(
                    "serve_replica_error", model=self.model,
                    replica=slot.id, error=repr(e))
                return ("internal_error", batch)
            if outcome is not None:
                return (outcome, batch)
        return None

    def _ping(self, slot):
        slot.msg_id += 1
        try:
            send_msg(slot.conn, {"kind": "ping", "id": slot.msg_id})
            msg = recv_msg(slot.conn, first_timeout=self.heartbeat_s,
                           rest_timeout=self.heartbeat_s)
        except (OSError, socket.timeout):
            return False
        return isinstance(msg, dict) and msg.get("kind") == "pong"

    def _run_batch(self, slot, batch, total):
        """Ship one batch to the replica and wait (bounded) for the
        answer. Returns None when the batch resolved (success, expiry or
        model error), or an ejection reason string when the replica died
        or went silent past its deadline."""
        padded, bucket = pad_batch(batch, total, self._batcher.buckets)
        # remaining budget: the LATEST member deadline (a replica only
        # cancels when nobody is waiting anymore); None if any member has
        # no deadline at all
        now = time.monotonic()
        remaining = None
        deadlines = [r.deadline for r in batch]
        if all(d is not None for d in deadlines):
            remaining = max(0.0, max(deadlines) - now)
        slot.msg_id += 1
        msg_id = slot.msg_id
        # per-request dispatch spans: ids are minted BEFORE the send so
        # the replica's compute span can parent under them on the far side
        # of the wire ((trace_id, span_id, sampled) tuples on the frame)
        dispatch_refs = [(req, _tracing.child_ref(req.trace))
                         for req in batch]
        wire_traces = [_tracing.to_wire(ref) for _, ref in dispatch_refs
                       if ref is not None and ref.sampled]
        with self._lock:
            slot.state = _BUSY
        self._m_inflight[slot.id].set(total)
        t0 = time.monotonic()
        t0_wall = time.time()
        # silence bound: max(batch deadline budget, the wedge floor) plus
        # the heartbeat grace. The floor (`MXTPU_SERVE_WEDGE_TIMEOUT_MS`)
        # decouples wedge detection from client deadlines — a forward that
        # legitimately outlasts a request budget must not be SIGKILLed
        # mid-compute; deadline-less batches use the floor alone
        budget = self.wedge_timeout_s if remaining is None \
            else max(remaining, self.wedge_timeout_s)
        silence_deadline = t0 + budget + self.heartbeat_s
        try:
            send_msg(slot.conn, {
                "kind": "predict", "id": msg_id, "arrays": padded,
                "bucket": bucket, "n": total, "remaining": remaining,
                "traces": wire_traces})
            while True:
                try:
                    msg = recv_msg(slot.conn, first_timeout=0.1,
                                   rest_timeout=max(1.0, self.heartbeat_s))
                except socket.timeout:
                    if not slot.proc.alive():
                        return "died_mid_batch"
                    if time.monotonic() >= silence_deadline:
                        return "wedged"
                    continue
                if msg is None:
                    return "died_mid_batch"  # EOF under an in-flight batch
                break
        except OSError:
            return "died_mid_batch"
        finally:
            self._m_inflight[slot.id].set(0)
            with self._lock:
                if slot.state == _BUSY:
                    slot.state = _READY
        kind = msg.get("kind")
        if kind == "result" and msg.get("id") == msg_id:
            # dispatch span per traced request: the router-side window
            # around the wire round trip; `wire_s` (window minus the
            # replica's own compute) is the serialization + hop cost
            dispatch_s = time.monotonic() - t0
            compute_s = msg.get("seconds") or dispatch_s
            for req, ref in dispatch_refs:
                if ref is not None:
                    _tracing.emit_span(
                        "serve.dispatch", t0_wall, dispatch_s, req.trace,
                        component="router", span_id=ref.span_id,
                        attrs={"replica": slot.id,
                               "wire_s": max(0.0, dispatch_s - compute_s),
                               "compute_s": compute_s})
            self._batcher.resolve_batch(batch, msg["outputs"], bucket,
                                        total, compute_s)
            # the generation proved itself on real input: the exponential
            # respawn backoff resets only now, so a warm-but-crash-on-input
            # artifact still escalates toward the 60s cap
            if slot.consecutive_restarts:
                with self._lock:
                    slot.consecutive_restarts = 0
            return None
        if kind == "expired" and msg.get("id") == msg_id:
            # replica cancelled past-deadline work; expire what's expired,
            # anything still live gets a retryable 503 (clock skew) — a
            # 504 would blame a deadline that never actually passed
            live = self._batcher._prune_expired(batch)
            if live:
                self._batcher.fail_batch(live, OverloadedError(
                    "replica %d cancelled the batch as past-deadline but "
                    "%d member(s) are still live; retry"
                    % (slot.id, len(live)), retry_after=1.0))
            return None
        if kind == "error":
            self._batcher.fail_batch(batch, ServingError(
                "model %r replica %d failed: %s"
                % (self.model, slot.id, msg.get("error"))))
            return None
        # protocol desync (stale pong, wrong id): the socket's framing
        # can no longer be trusted — eject and fail over
        return "protocol_desync"

    # -- ejection / failover ----------------------------------------------
    def _eject(self, slot, reason, batch=None):
        """Tear the replica's process group down, fail its in-flight batch
        over (exactly-once re-enqueue), publish telemetry + the
        ejection event, and back off before the next spawn."""
        with self._lock:
            slot.state = _DEAD
            slot.ready_info = None
            conn, slot.conn = slot.conn, None
            slot.conn_event.clear()
            slot.consecutive_restarts += 1
            restarts = slot.consecutive_restarts
        self._set_healthy_gauge()
        exit_code = slot.proc.exit_code()
        slot.proc.teardown()
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        requeued = 0
        if batch:
            requeued = self._requeue_generate(batch) if self._generate \
                else self._batcher.requeue(batch)
            self._m_failover.inc()
            self._m_requeued.inc(requeued)
        self._m_restarts.inc()
        delay = backoff_s(restarts, self._backoff_ms)
        # the event every ejection must leave behind
        telemetry.record_event(
            "serve_replica_eject", model=self.model, replica=slot.id,
            generation=slot.proc.generation, reason=reason,
            exit_code=exit_code, requeued=requeued,
            backoff_s=round(delay, 3))
        if batch:
            telemetry.record_event(
                "serve_failover", model=self.model, replica=slot.id,
                requeued=requeued, dropped=len(batch) - requeued)
        deadline = time.monotonic() + delay
        while time.monotonic() < deadline and not self._stop \
                and not slot.stop:
            time.sleep(0.02)

    def _set_healthy_gauge(self):
        self._m_healthy.set(self.healthy_count)
