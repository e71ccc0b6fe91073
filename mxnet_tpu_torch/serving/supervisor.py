"""Replica process supervision and the replica worker's entry point.

Counterpart of `mxnet_tpu/serving/supervisor.py`. A pooled model runs as N
*replica worker processes*, so a wedged forward, a poisoned request or an
out-of-memory kills one process, not the endpoint. This module is the
process half of that design; the routing half is `replica_pool.ReplicaPool`.

Workers start as session leaders, so a teardown signals the whole process
GROUP (grandchildren die too); a teardown escalates SIGTERM -> SIGKILL over
``MXTPU_TEARDOWN_GRACE``; every respawn bumps a per-replica restart
*generation* exported as ``MXTPU_RESTART_GENERATION``, so
``MXTPU_FAULT_INJECT``'s ``gen=`` condition keeps a respawned replica from
firing its fault again; respawns back off exponentially
(``MXTPU_SERVE_RESTART_BACKOFF_MS``, doubling, capped at 60 s).

Worker side (``python -m mxnet_tpu_torch.serving.replica_worker``): loads an
artifact (or a test stub) on the device the pool resolved (``--device``:
the pool's caller's `context.scope`, else the card; a worker never picks
the host on its own), warms every padding bucket, CONNECTS to the pool's
localhost listener and serves length-prefixed pickled frames:

    router -> replica   {kind: predict, id, arrays, bucket, n, remaining,
                         traces}
                        {kind: generate, id, tokens, max_new_tokens,
                         temperature, top_k, top_p, remaining, trace}
                        {kind: ping, id} | {kind: stats, id}
                        {kind: shutdown}
    replica -> router   {kind: hello, replica, generation, pid}
                        {kind: ready, warm_seconds, bucket_flops,
                         bucket_memory, compile_digests, generate, ...}
                        {kind: result, id, outputs, seconds}
                        {kind: gen_result, id, tokens, finish_reason}
                        {kind: gen_error, id, status, error}
                        {kind: expired, id} | {kind: error, id, error}
                        {kind: pong, id} | {kind: stats_result, id, stats}

Generation workers (``--generate PREFIX``) run their own continuous-batching
scheduler: ``generate`` frames enqueue into it while the receive loop keeps
answering pings, so liveness stays on the heartbeat clock under long
generations; ``gen_result`` replies go out of order as sequences finish.
Their ``stats_result`` carries the JAX keys (``pending``, ``kv_pages_used``,
``jit_after_warm``: here the port's kernel builds after warm-up), the
``requests`` the replica took since it reported ready, the
paged-attention kernel's ``launches`` in this process since it reported
ready (``warm_launches`` are those of its warm-up), and
``max_memory_allocated`` on the card.

``remaining`` is the batch's deadline budget in seconds (deadlines are
process-local monotonic times, so the router converts them): a replica
that wakes past it answers ``expired`` instead of running the forward.
The ready frame carries each bucket's warm-up price, ``bucket_flops`` and
``bucket_memory`` (`model_repository.warm_bucket`; a generation worker's
are its decode buckets', `TransformerLMEngine.warm`), from which the
router prices the pool's footprint. The port has no compile cache
(``compile/``, ROADMAP queue 1 item 13): the ready frame carries
``compile_digests: None`` and ``compile_prefetched: 0``.

SIGTERM asks the worker to finish its current batch and exit 0; the
handler (`_on_term`) only sets a flag.
"""
from __future__ import annotations

import logging
import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

from .. import env as _env

_LOG = logging.getLogger("mxnet_tpu_torch.serving.supervisor")

_HDR = struct.Struct("!I")
_MAX_MSG = 1 << 30  # 1 GiB framing bound
TOKEN_LEN = 32      # hex chars of the per-pool handshake secret


# ---------------------------------------------------------------------------
# wire protocol (shared by router and worker)
# ---------------------------------------------------------------------------

def send_msg(sock, obj):
    """One frame: a 4-byte big-endian length, then a pickle. Pickle over a
    TCP socket is safe only because the router unpickles nothing from a
    connection that has not first presented the pool's handshake secret
    (``MXTPU_SERVE_POOL_TOKEN``, random per pool, handed to workers in
    their environment)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def recv_msg(sock, first_timeout=None, rest_timeout=30.0):
    """Receive one frame. ``first_timeout`` bounds the wait for the first
    byte (None = block); once a frame has started, ``rest_timeout`` bounds
    each later chunk, so a half-written frame from a dying peer cannot park
    the reader. Returns None on a clean EOF before a frame starts.
    `socket.timeout` is raised only before a frame starts (a retry is
    safe); a stall mid-frame raises plain `OSError`, because the framing
    can no longer be trusted."""
    sock.settimeout(first_timeout)
    first = sock.recv(_HDR.size)
    if not first:
        return None
    sock.settimeout(rest_timeout)
    buf = bytearray(first)
    try:
        while len(buf) < _HDR.size:
            chunk = sock.recv(_HDR.size - len(buf))
            if not chunk:
                raise OSError("peer closed mid-header")
            buf.extend(chunk)
        (length,) = _HDR.unpack(bytes(buf))
        if length > _MAX_MSG:
            raise OSError("oversized frame (%d bytes)" % length)
        data = bytearray()
        while len(data) < length:
            chunk = sock.recv(min(1 << 20, length - len(data)))
            if not chunk:
                raise OSError("peer closed mid-message")
            data.extend(chunk)
    except socket.timeout:
        raise OSError("peer stalled mid-frame (rest_timeout %.1fs)"
                      % rest_timeout) from None
    return pickle.loads(bytes(data))


# ---------------------------------------------------------------------------
# router side: one supervised replica process
# ---------------------------------------------------------------------------

def _signal_pg(proc, sig):
    """Signal the worker's process group (it was started a session
    leader), falling back to the single pid."""
    if proc.poll() is not None:
        return
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.send_signal(sig)
        except OSError:
            pass


def teardown(proc, grace=None):
    """SIGTERM the worker's process group, give it ``grace`` seconds
    (``MXTPU_TEARDOWN_GRACE``) to exit, then SIGKILL what is left: a
    replica wedged in a forward cannot hang its ejection."""
    if proc.poll() is not None:
        return
    if grace is None:
        grace = _env.get("MXTPU_TEARDOWN_GRACE")
    _signal_pg(proc, signal.SIGTERM)
    deadline = time.monotonic() + max(0.0, grace)
    while time.monotonic() < deadline and proc.poll() is None:
        time.sleep(0.02)
    if proc.poll() is None:
        _signal_pg(proc, signal.SIGKILL)
    try:
        proc.wait(timeout=10)
    except (subprocess.TimeoutExpired, OSError):
        pass


def _pump(stream, label):
    """Copy a replica's merged stdout/stderr to ours, each line prefixed
    with the replica's label."""
    prefix = ("[%s] " % label).encode()
    out = getattr(sys.stderr, "buffer", None)
    for line in iter(stream.readline, b""):
        if out is not None:
            out.write(prefix + line)
            out.flush()
        else:
            sys.stderr.write((prefix + line).decode("utf-8", "replace"))
            sys.stderr.flush()
    stream.close()


class ReplicaProcess:
    """Spawn and teardown state of one replica slot.

    ``worker_args`` is the argv tail saying WHAT to serve (artifact or stub
    flags, and the device); this class owns the generation count, the
    environment protocol and the process group. A `spawn` after `teardown`
    starts the next generation.
    """

    def __init__(self, model, replica_id, connect_addr, worker_args,
                 extra_env=None, teardown_grace=None, token=None):
        self.model = str(model)
        self.replica_id = int(replica_id)
        self.connect_addr = connect_addr
        self.worker_args = list(worker_args)
        self.extra_env = dict(extra_env or {})
        self.teardown_grace = teardown_grace
        self.token = token
        self.generation = -1  # no spawn yet
        self.proc = None
        self._pump_thread = None

    @property
    def pid(self):
        return self.proc.pid if self.proc is not None else None

    def alive(self):
        return self.proc is not None and self.proc.poll() is None

    def spawn(self):
        """Start the next generation of this replica (a session leader
        with line-prefixed output). Returns the generation."""
        self.generation += 1
        env = dict(os.environ)
        env.update(self.extra_env)
        # the generation gates fault injection in the worker
        env["MXTPU_RESTART_GENERATION"] = str(self.generation)
        if self.token:
            # the handshake secret goes in the environment: argv is
            # readable by every local user
            env["MXTPU_SERVE_POOL_TOKEN"] = self.token
        # a replica never inherits the parent's metrics endpoint port
        env.pop("MXTPU_TELEMETRY_PORT", None)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        argv = [sys.executable, "-m", "mxnet_tpu_torch.serving.replica_worker",
                "--connect", "%s:%d" % self.connect_addr,
                "--replica", str(self.replica_id),
                "--generation", str(self.generation)] + self.worker_args
        self.proc = subprocess.Popen(
            argv, env=env, start_new_session=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        self._pump_thread = threading.Thread(
            target=_pump, args=(self.proc.stdout,
                                "%s/r%d.g%d" % (self.model, self.replica_id,
                                                self.generation)),
            daemon=True,
            name="mxtpu-replica-pump-r%d" % self.replica_id)
        self._pump_thread.start()
        return self.generation

    def teardown(self):
        if self.proc is not None:
            teardown(self.proc, self.teardown_grace)

    def exit_code(self):
        return self.proc.poll() if self.proc is not None else None


def backoff_s(consecutive_restarts, initial_ms=None):
    """Exponential respawn backoff: initial * 2^(n-1), capped at 60 s."""
    if initial_ms is None:
        initial_ms = _env.get("MXTPU_SERVE_RESTART_BACKOFF_MS")
    if consecutive_restarts <= 0:
        return 0.0
    return min(60.0, (initial_ms / 1e3) * (2 ** (consecutive_restarts - 1)))


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

# SIGTERM flag: a one-slot list the handler stores into (no locks, no
# logging, no Event.set() in a signal handler)
_STOP = [False]


def _on_term(signum, frame):
    _STOP[0] = True


def _build_stub_runner(args):
    """Test stub (numpy only, no artifact): `echo` answers x * 2; a
    positive --stub-delay-ms sleeps a batch, holding batches in flight so
    tests can land faults deterministically."""
    import numpy as np

    delay = max(0.0, args.stub_delay_ms) / 1e3

    def runner(arrays, bucket, n):
        if delay:
            time.sleep(delay)
        name = sorted(arrays)[0]
        return [np.asarray(arrays[name]) * 2.0]

    return runner


def _parse_inputs(specs):
    shapes, dtypes = {}, {}
    for spec in specs or ():
        name, _, dims = spec.partition("=")
        if ":" in dims:
            dims, dtype = dims.split(":", 1)
            dtypes[name] = dtype
        shapes[name] = tuple(int(d) for d in dims.split("x") if d)
    return shapes, (dtypes or None)


def _connect_and_hello(args):
    """Dial the pool's listener, present the handshake secret, then the
    hello frame; returns the connected socket."""
    host, _, port = args.connect.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=30)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    # authenticate before the first pickled frame: the router unpickles
    # nothing from a connection that has not presented the secret
    token = (_env.raw("MXTPU_SERVE_POOL_TOKEN") or "").encode("ascii")
    sock.sendall(token.ljust(TOKEN_LEN, b"\0")[:TOKEN_LEN])
    send_msg(sock, {"kind": "hello", "replica": args.replica,
                    "generation": args.generation, "pid": os.getpid()})
    return sock


def _generate_worker_main(args, device):
    """Generation replica: build the LM decode engine on ``device``, warm
    every prefill and decode bucket, report ready with the KV geometry,
    then feed ``generate`` frames to the local continuous-batching
    scheduler; replies go out as sequences finish, while this receive loop
    keeps answering pings and stats."""
    import torch

    from ..ops import _build
    from ..ops import pallas_kernels as _pk
    from ..telemetry import tracing
    from .batcher import ServingError
    from .generate import GenerateScheduler, TransformerLMEngine, load_lm

    engine = TransformerLMEngine(
        lm=load_lm(args.generate, device=device), device=device,
        num_pages=args.kv_pages, page_size=args.kv_page_size,
        max_prompt=args.max_prompt, max_new_tokens=args.max_new_tokens,
        max_batch=args.max_batch,
        **({} if args.kv_dtype is None else {"kv_dtype": args.kv_dtype}))
    sched = GenerateScheduler(engine, name="replica%d" % args.replica,
                              warm=not args.no_warm)
    builds_at_warm = _build.builds()
    launches_at_warm = _pk.paged_attention.launches

    sock = _connect_and_hello(args)
    send_lock = threading.Lock()

    def _send(obj):
        with send_lock:     # the completion hook and this loop share it
            send_msg(sock, obj)

    served = [0]   # generate frames admitted since ready

    def stats():
        # seen from the router (pool.replica_stats): no kernel build after
        # warm-up, the KV pages reclaimed, the requests this replica took,
        # and the paged kernel launched in this process while serving,
        # apart from its warm-up
        return {"requests": served[0],
                "kv_pages_total": sched.allocator.num_pages,
                "kv_pages_used": sched.allocator.used_pages,
                "jit_after_warm": _build.builds() - builds_at_warm,
                "pending": sched.pending(),
                "launches": _pk.paged_attention.launches - launches_at_warm,
                "warm_launches": launches_at_warm,
                "max_memory_allocated":
                    torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else None}

    _send({"kind": "ready", "replica": args.replica,
           "generation": args.generation,
           "warm_seconds": sched.warm_seconds,
           "buckets": list(engine.buckets),
           "example_shapes": {}, "input_dtypes": None,
           "bucket_flops": dict(engine.bucket_flops) or None,
           "bucket_memory": dict(engine.bucket_memory) or None,
           "generate": engine.geometry(),
           "compile_digests": None, "compile_prefetched": 0})
    _LOG.info("generate replica %d gen %d ready on %s (warm %.2fs, buckets "
              "%s)", args.replica, args.generation, device,
              sched.warm_seconds or 0.0, list(engine.buckets))

    def on_complete(req):
        if req.tag is None:
            return
        if req.error is not None:
            _send({"kind": "gen_error", "id": req.tag,
                   "status": getattr(req.error, "status", 500),
                   "error": str(req.error)})
        else:
            _send({"kind": "gen_result", "id": req.tag,
                   "tokens": list(req.outputs or []),
                   "finish_reason": req.finish_reason})

    try:
        while not _STOP[0]:
            try:
                msg = recv_msg(sock, first_timeout=0.25)
            except socket.timeout:
                continue
            except OSError:
                break
            if msg is None or msg.get("kind") == "shutdown":
                break
            kind = msg.get("kind")
            if kind == "ping":
                _send({"kind": "pong", "id": msg.get("id")})
                continue
            if kind == "stats":
                _send({"kind": "stats_result", "id": msg.get("id"),
                       "stats": stats()})
                continue
            if kind != "generate":
                _LOG.warning("generate replica %d: unknown message "
                             "kind %r", args.replica, kind)
                continue
            served[0] += 1
            deadline = None if msg.get("remaining") is None \
                else time.monotonic() + float(msg["remaining"])
            ref = tracing.from_wire(msg["trace"]) \
                if msg.get("trace") else None
            try:
                req = sched.submit(
                    msg["tokens"],
                    max_new_tokens=msg.get("max_new_tokens"),
                    temperature=msg.get("temperature") or 0.0,
                    top_k=msg.get("top_k") or 0,
                    top_p=msg.get("top_p") if msg.get("top_p") is not None
                    else 1.0,
                    deadline=deadline, trace=ref, on_complete=on_complete)
                req.tag = msg["id"]
                if req.done():   # resolved before the tag landed
                    on_complete(req)
            except ServingError as e:
                _send({"kind": "gen_error", "id": msg["id"],
                       "status": e.status, "error": str(e)})
            except Exception as e:   # a malformed request: 400, never die
                _send({"kind": "gen_error", "id": msg["id"],
                       "status": 400,
                       "error": "%s: %s" % (type(e).__name__, e)})
    finally:
        sched.close(drain=False, timeout=0)
        try:
            sock.close()
        except OSError:
            pass
    _LOG.info("generate replica %d gen %d exiting after %d requests",
              args.replica, args.generation, served[0])
    return 0


def worker_main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="serving replica worker (spawned by ReplicaPool)")
    p.add_argument("--connect", required=True, metavar="HOST:PORT")
    p.add_argument("--replica", type=int, required=True)
    p.add_argument("--generation", type=int, default=0)
    p.add_argument("--device", required=True,
                   help="torch device the pool resolved (cuda:N or cpu)")
    p.add_argument("--artifact", default=None,
                   help="export prefix (`python -m mxnet_tpu_torch.serving` "
                        "spec)")
    p.add_argument("--input", action="append", default=[],
                   metavar="NAME=DIMS[:DTYPE]")
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--stub", choices=("echo",), default=None,
                   help="serve a numpy stub instead of an artifact (tests)")
    p.add_argument("--stub-delay-ms", type=float, default=0.0)
    p.add_argument("--no-warm", action="store_true")
    p.add_argument("--generate", default=None, metavar="PREFIX",
                   help="serve a generation LM artifact (save_lm prefix) "
                        "through the continuous-batching scheduler")
    p.add_argument("--kv-pages", type=int, default=None)
    p.add_argument("--kv-page-size", type=int, default=None)
    p.add_argument("--max-prompt", type=int, default=None)
    p.add_argument("--max-new-tokens", type=int, default=None)
    p.add_argument("--kv-dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="KV cache dtype (default float32)")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s", stream=sys.stderr)
    signal.signal(signal.SIGTERM, _on_term)

    from ..context import resolve_device

    device = resolve_device(args.device)
    if args.generate:
        return _generate_worker_main(args, device)

    from ..parallel.resilience import maybe_inject_serving_fault
    from ..telemetry import tracing
    from .batcher import power_of_two_buckets

    max_batch = args.max_batch
    if max_batch is None:
        max_batch = _env.get("MXTPU_SERVE_MAX_BATCH")
    if args.stub:
        runner = _build_stub_runner(args)
        example_shapes, input_dtypes = _parse_inputs(args.input)
        buckets = power_of_two_buckets(max_batch)
    elif args.artifact:
        from .model_repository import build_runner

        example_shapes, input_dtypes = _parse_inputs(args.input)
        runner, buckets, example_shapes, input_dtypes, _meta = build_runner(
            args.artifact, input_shapes=example_shapes or None,
            input_dtypes=input_dtypes, ctx=device, max_batch=max_batch)
    else:
        p.error("need --artifact, --stub or --generate")

    sock = _connect_and_hello(args)

    # warm every bucket before ready: a replica never joins the pool with
    # a first launch still ahead of it (the in-process publish-after-warm
    # rule)
    warm_s = 0.0
    bucket_flops = {}
    bucket_memory = {}
    if not args.no_warm:
        import numpy as np

        from .model_repository import warm_bucket

        t0 = time.monotonic()
        for b in buckets:
            zeros = {k: np.zeros((b,) + tuple(s),
                                 dtype=(input_dtypes or {}).get(k, "float32"))
                     for k, s in example_shapes.items()}
            # priced in this process: the router reads the pool's
            # footprint from the ready frame
            f, bucket_memory[int(b)] = warm_bucket(
                runner, zeros, b, label="replica%d:b%d" % (args.replica, b))
            if f:
                bucket_flops[int(b)] = f
        warm_s = time.monotonic() - t0
    send_msg(sock, {"kind": "ready", "replica": args.replica,
                    "generation": args.generation, "warm_seconds": warm_s,
                    "bucket_flops": bucket_flops or None,
                    "bucket_memory": bucket_memory or None,
                    "buckets": list(buckets),
                    "example_shapes": {k: tuple(v)
                                       for k, v in example_shapes.items()},
                    "input_dtypes": {k: str(v) for k, v in
                                     (input_dtypes or {}).items()} or None,
                    "compile_digests": None, "compile_prefetched": 0})
    _LOG.info("replica %d gen %d ready on %s (warm %.2fs, buckets %s)",
              args.replica, args.generation, device, warm_s, list(buckets))

    seq = 0
    while not _STOP[0]:
        try:
            msg = recv_msg(sock, first_timeout=0.25)
        except socket.timeout:
            continue
        except OSError:
            break  # the router went away: nothing to serve into
        if msg is None:
            break  # clean EOF
        kind = msg.get("kind")
        if kind == "shutdown":
            break
        if kind == "ping":
            send_msg(sock, {"kind": "pong", "id": msg.get("id")})
            continue
        if kind != "predict":
            _LOG.warning("replica %d: unknown message kind %r",
                         args.replica, kind)
            continue
        seq += 1
        t_batch = time.monotonic()
        deadline = None if msg.get("remaining") is None \
            else t_batch + float(msg["remaining"])
        # the fault hook at the batch boundary (kill_replica /
        # wedge_replica / slow_reply)
        maybe_inject_serving_fault(seq, args.replica)
        # a replica that wakes past the batch's budget cancels instead of
        # computing an answer nobody is waiting for
        if deadline is not None and time.monotonic() >= deadline:
            send_msg(sock, {"kind": "expired", "id": msg["id"]})
            continue
        t_run_wall = time.time()
        try:
            outs = runner(msg["arrays"], msg["bucket"], msg["n"])
        except Exception as e:  # a model failure answers, never dies
            try:
                send_msg(sock, {"kind": "error", "id": msg["id"],
                                "error": "%s: %s" % (type(e).__name__, e)})
            except OSError:
                break  # the router went away mid-reply
            continue
        compute_s = time.monotonic() - t_batch
        # one compute span a traced request, parented under the router's
        # dispatch span shipped on the frame: this process's JSONL carries
        # the worker lane of the merged timeline (tools/trace_merge.py)
        for wire_ctx in msg.get("traces") or ():
            ref = tracing.from_wire(wire_ctx)
            if ref is not None:
                tracing.emit_span(
                    "serve.compute", t_run_wall, compute_s, ref,
                    component="worker",
                    attrs={"replica": args.replica,
                           "generation": args.generation,
                           "bucket": msg["bucket"], "n": msg["n"]})
        try:
            send_msg(sock, {"kind": "result", "id": msg["id"],
                            "outputs": outs, "seconds": compute_s})
        except OSError:
            break  # the router went away: nothing to serve into
    try:
        sock.close()
    except OSError:
        pass
    _LOG.info("replica %d gen %d exiting after %d batches",
              args.replica, args.generation, seq)
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
