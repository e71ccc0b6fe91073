"""HTTP frontend over a `ModelRepository`.

Counterpart of `mxnet_tpu/serving/server.py`: a stdlib
`ThreadingHTTPServer`, one handler thread per connection, handler threads
blocking cheaply on their request while the model's batcher or decode
worker drives the card.

Routes:

  * ``POST /v1/models/<name>[/versions/<v>]:predict``
      body: ``{"inputs": {"<input>": <nested list>}, "timeout_ms": opt}``
      or ``{"instances": <nested list>}`` for single-input models; inputs
      are cast to the model's declared dtypes;
      reply: ``{"outputs": [...], "model": ..., "version": ...}``
  * ``POST /v1/models/<name>[/versions/<v>]:generate``
      body: ``{"tokens": [int...], "max_new_tokens": opt,
      "temperature": opt, "top_k": opt, "top_p": opt, "timeout_ms": opt}``
      reply: ``{"tokens": [generated ids], "num_generated": ...,
      "finish_reason": "eos"|"length", "model": ..., "version": ...}``
  * ``GET /v1/models``        repository listing (both kinds)
  * ``GET /v1/models/<name>`` one model (``?version=``)
  * ``GET /healthz``          200 ``ok`` / 503 ``draining``
  * ``GET /statusz``          the SLO verdicts, windowed rates, pool and
                              memory state and, with an attached
                              `Autoscaler`, its decision trail (JSON;
                              ``?format=text`` for a terminal)
  * ``GET|POST /drainz``      start draining (idempotent)

Admission is deterministic: a full queue answers 429, an expired deadline
504, draining 503, an unknown model 404, a malformed request (or the
other kind's verb) 400; a degraded replica pool sheds with 503 and a
``Retry-After`` scaled to its healthy replicas; a load over the memory
budget answers 507 with the footprint breakdown in ``details``. SIGTERM (via
`install_signal_handlers`) drains queued and running requests, then stops
the server.

Tracing: a predict or generate request is admitted under a
``serve.request`` root span (``component="server"``), its context read
from an incoming ``x-mxtpu-trace`` header or minted (sampled at
``MXTPU_TRACE_SAMPLE``); the reply always carries the header, so any
outcome names its trace.
"""
from __future__ import annotations

import contextlib
import json
import math
import signal
import threading
import time

import numpy as _np

from .. import env as _env
from .. import telemetry
from ..base import MXNetError
from ..telemetry import slo as _slo
from ..telemetry import tracing as _tracing
from .batcher import DrainingError, ServingError, drain_timeout_s

__all__ = ["ServingServer"]


def _int_version(raw):
    """URL version component -> int; malformed is the client's error."""
    try:
        return int(raw)
    except ValueError:
        raise MXNetError("version %r is not an integer" % (raw,))


def _finite(body, field, cast):
    """``cast(body[field])``, None when absent. A NaN/Infinity literal (or
    a non-number) is the client's error (400): it would poison a sampling
    mask or a deadline, and must never become a garbage 200 or a 500."""
    if body.get(field) is None:
        return None
    try:
        value = cast(body[field])
    except (TypeError, ValueError):
        value = None
    if value is None or not math.isfinite(value):
        raise MXNetError("%r must be a finite number, got %r"
                         % (field, body[field]))
    return value


class ServingServer:
    """The HTTP frontend over a `ModelRepository`."""

    def __init__(self, repository, port=None, addr="0.0.0.0"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.repository = repository
        self._autoscaler = None
        self._draining = False
        self._drain_failed = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._m_codes = {}
        # the drain waiter is pre-started so a signal handler only sets an
        # Event (starting a thread from a handler could deadlock on the
        # threading module's own locks)
        self._closed = False
        self._drain_shutdown = False
        self._drain_event = threading.Event()
        self._drain_waiter = threading.Thread(
            target=self._drain_when_signaled, name="mxtpu-serve-drain",
            daemon=True)
        self._drain_waiter.start()
        if port is None:
            port = _env.get("MXTPU_SERVE_PORT")

        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # keep-alive: every reply carries Content-Length
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY: a reply goes out as two writes (headers, body),
            # and Nagle would hold the body back until the client's
            # delayed ACK (Linux's 40 ms timer) on a keep-alive connection
            disable_nagle_algorithm = True

            def do_GET(self):
                outer._route(self, "GET")

            def do_POST(self):
                outer._route(self, "POST")

            def log_message(self, fmt, *args):  # no per-request stderr spam
                pass

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            # a burst of concurrent clients must not overflow the accept
            # queue (stdlib default backlog is 5)
            request_queue_size = 128

        self._http = _Server((addr, int(port)), _Handler)
        self.port = self._http.server_address[1]
        self._serve_thread = None

    # -- lifecycle ---------------------------------------------------------
    def serve_forever(self):
        """Block serving requests until `shutdown`."""
        self._http.serve_forever(poll_interval=0.1)

    def start(self):
        """Serve on a daemon thread. Returns self."""
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name="mxtpu-serve-http", daemon=True)
        self._serve_thread.start()
        return self

    def attach_autoscaler(self, autoscaler):
        """Adopt this server's autoscaling controller: its decision trail
        joins ``/statusz``, and `drain` / `shutdown` stop (and join) its
        thread. Returns the autoscaler."""
        self._autoscaler = autoscaler
        return autoscaler

    @property
    def autoscaler(self):
        return self._autoscaler

    def shutdown(self):
        self._closed = True
        self._drain_event.set()  # release an idle drain waiter
        if self._autoscaler is not None:
            # scaling decisions stop before models start dropping
            self._autoscaler.stop()
        self._http.shutdown()
        self._http.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)

    @property
    def draining(self):
        return self._draining

    @property
    def drain_failed(self):
        """True when a drain timed out and force-completed requests."""
        return self._drain_failed

    def drain(self, timeout=None, shutdown=False):
        """Stop admitting work and wait (bounded) for queued and running
        requests. On expiry every stranded request is force-completed with
        a 503 and `drain_failed` is set. Returns True when everything
        completed within ``timeout``."""
        self._draining = True
        if self._autoscaler is not None:
            # no replica is spawned into (or drained out of) a server that
            # is shutting down: stop() joins the controller, so no lap is
            # in flight when the drain starts
            self._autoscaler.stop()
        if timeout is None:
            timeout = drain_timeout_s()
        telemetry.record_event("serve_drain_start",
                               pending=self.repository.pending())
        deadline = time.monotonic() + timeout
        ok = self.repository.drain_all(timeout)
        while self._inflight and time.monotonic() < deadline:
            time.sleep(0.01)  # let handler threads finish writing replies
        ok = ok and not self._inflight
        if not ok:
            aborted = self.repository.abort_pending()
            self._drain_failed = True
            telemetry.record_event("serve_drain_forced", aborted=aborted,
                                   timeout_s=timeout)
            force_deadline = time.monotonic() + 2.0
            while self._inflight and time.monotonic() < force_deadline:
                time.sleep(0.01)
        telemetry.record_event("serve_drain_done", complete=ok)
        if shutdown:
            self.shutdown()
        return ok

    def _drain_when_signaled(self):
        """Parked on `_drain_event` until a signal or ``/drainz`` releases
        it, then runs the bounded drain (with shutdown after a signal)."""
        while True:
            self._drain_event.wait()
            if self._closed:
                return
            self._drain_event.clear()
            shutdown = self._drain_shutdown
            self.drain(shutdown=shutdown)
            if shutdown or self._closed:
                return

    def install_signal_handlers(self, signals=(signal.SIGTERM, signal.SIGINT)):
        """Graceful drain on SIGTERM/SIGINT: the handler only sets a flag
        and the Event the pre-started waiter parks on."""

        def _on_signal(signum, frame):
            self._drain_shutdown = True
            self._drain_event.set()

        for s in signals:
            signal.signal(s, _on_signal)

    # -- routing -----------------------------------------------------------
    def _route(self, handler, method):
        handler._mxtpu_trace = None  # a keep-alive handler serves many
        try:
            path = handler.path.split("?", 1)[0]
            query = handler.path[len(path) + 1:] if "?" in handler.path else ""
            if path.rstrip("/") == "/healthz" and method == "GET":
                if self._draining:
                    self._text(handler, 503, "draining\n")
                else:
                    self._text(handler, 200, "ok\n")
            elif path.rstrip("/") == "/statusz" and method == "GET":
                # lock-free snapshots only: the page answers while a
                # model's batcher is wedged and while draining
                extra = {"server": {"port": self.port,
                                    "draining": self._draining,
                                    "drain_failed": self._drain_failed,
                                    "inflight": self._inflight}}
                if self._autoscaler is not None:
                    extra["autoscaler"] = self._autoscaler.describe()
                ctype, body = _slo.render_statusz(
                    "text" if "format=text" in query else "json",
                    extra=extra)
                self._count(200)
                handler.send_response(200)
                handler.send_header("Content-Type", ctype)
                handler.send_header("Content-Length", str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)
            elif path.rstrip("/") == "/drainz":
                self._drain_event.set()  # idempotent: wakes the waiter
                self._json(handler, 200, {
                    "draining": True,
                    "pending": self.repository.pending(),
                    "inflight": self._inflight,
                })
            elif path == "/v1/models" and method == "GET":
                self._json(handler, 200, self.repository.describe())
            elif path.startswith("/v1/models/"):
                self._model_route(handler, method, path[len("/v1/models/"):],
                                  query)
            else:
                self._json(handler, 404, {"error": "no route %s %s"
                                          % (method, path)})
        except BrokenPipeError:
            pass  # client went away mid-reply
        except ServingError as e:
            payload = {"error": str(e)}
            details = getattr(e, "details", None)
            if details:
                # a 507 carries the footprint breakdown (what to evict)
                payload["details"] = details
            self._json(handler, e.status, payload,
                       retry_after=e.retry_after)
        except MXNetError as e:
            self._json(handler, 400, {"error": str(e)})
        except Exception as e:  # the server must answer, never unwind
            self._json(handler, 500, {"error": "%s: %s"
                                      % (type(e).__name__, e)})

    def _model_route(self, handler, method, rest, query):
        version = None
        if ":" in rest:
            rest, verb = rest.split(":", 1)
        else:
            verb = None
        if "/versions/" in rest:
            rest, v = rest.split("/versions/", 1)
            version = _int_version(v)
        name = rest.strip("/")
        if version is None and query.startswith("version="):
            version = _int_version(query.split("=", 1)[1].split("&")[0])
        if verb == "predict" and method == "POST":
            self._predict(handler, name, version)
        elif verb == "generate" and method == "POST":
            self._generate(handler, name, version)
        elif verb is None and method == "GET":
            model = self.repository.get(name, version)
            self._json(handler, 200, model.describe())
        else:
            self._json(handler, 404, {"error": "no route %s /v1/models/%s%s"
                                      % (method, name,
                                         ":" + verb if verb else "")})

    @staticmethod
    def _read_body(handler):
        # consume the body FIRST: replying before the read would desync a
        # keep-alive connection
        length = int(handler.headers.get("Content-Length") or 0)
        return handler.rfile.read(length) if length > 0 else b""

    def _body(self, handler, name, version, verb):
        """Read the body (before any reply: keep-alive), then the model
        (404), its kind (400 for the other kind's verb) and the JSON
        object."""
        raw_body = self._read_body(handler)
        if self._draining:
            raise DrainingError("server is draining")
        model = self.repository.get(name, version)
        if not hasattr(model, verb):
            raise MXNetError(
                "model %r is a generation model; use :generate" % name
                if verb == "predict" else
                "model %r does not serve :generate (it is a predict model; "
                "load an LM artifact with generate=True)" % name)
        if not raw_body:
            raise MXNetError("empty request body")
        try:
            body = json.loads(raw_body.decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise MXNetError("request body is not JSON: %s" % e)
        if not isinstance(body, dict):
            raise MXNetError("request body must be a JSON object")
        return model, body

    @contextlib.contextmanager
    def _in_flight(self):
        """Count a request in flight, its reply included (what `drain`
        waits on before it stops the server)."""
        with self._inflight_lock:
            self._inflight += 1
        try:
            yield
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    @staticmethod
    def _admit_trace(handler, name, verb):
        """The request's root span: the incoming ``x-mxtpu-trace`` context
        honored, else a minted one; the reply echoes its header."""
        ref = _tracing.mint(_tracing.parse_header(
            handler.headers.get(_tracing.HEADER) or ""))
        handler._mxtpu_trace = _tracing.header_value(ref)
        return _tracing.root("serve.request", component="server", ref=ref,
                             attrs={"model": name, "verb": verb})

    # -- predict -----------------------------------------------------------
    def _predict(self, handler, name, version):
        with self._admit_trace(handler, name, "predict"):
            self._predict_traced(handler, name, version)

    def _predict_traced(self, handler, name, version):
        model, body = self._body(handler, name, version, "predict")
        if "inputs" in body:
            raw = body["inputs"]
            if not isinstance(raw, dict):
                raise MXNetError("'inputs' must be an object of "
                                 "input-name -> array")
        elif "instances" in body:
            names = sorted(model.example_shapes)
            if len(names) != 1:
                raise MXNetError(
                    "'instances' shorthand needs a single-input model; "
                    "%r has inputs %s; use 'inputs'" % (name, names))
            raw = {names[0]: body["instances"]}
        else:
            raise MXNetError("request needs 'inputs' or 'instances'")
        try:
            arrays = {k: _np.asarray(v, dtype=model.input_dtypes.get(k))
                      for k, v in raw.items()}
        except (ValueError, TypeError, KeyError) as e:
            raise MXNetError("malformed input array: %s" % e)
        timeout_ms = _finite(body, "timeout_ms", float)
        with self._in_flight():
            outputs = model.predict(arrays, timeout_ms=timeout_ms)
            self._json(handler, 200, {
                "model": model.name,
                "version": model.version,
                "outputs": [o.tolist() for o in outputs],
            })

    # -- generate ----------------------------------------------------------
    def _generate(self, handler, name, version):
        with self._admit_trace(handler, name, "generate"):
            self._generate_traced(handler, name, version)

    def _generate_traced(self, handler, name, version):
        model, body = self._body(handler, name, version, "generate")
        tokens = body.get("tokens")
        if not isinstance(tokens, list) or not tokens \
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in tokens):
            raise MXNetError("'tokens' must be a non-empty list of int "
                             "token ids")
        kwargs = {}
        for field, cast in (("max_new_tokens", int), ("temperature", float),
                            ("top_k", int), ("top_p", float),
                            ("timeout_ms", float)):
            value = _finite(body, field, cast)
            if value is not None:
                kwargs[field] = value
        with self._in_flight():
            result = model.generate(tokens, **kwargs)
            self._json(handler, 200, {
                "model": model.name,
                "version": model.version,
                "tokens": result["tokens"],
                "num_generated": len(result["tokens"] or ()),
                "finish_reason": result.get("finish_reason"),
            })

    # -- replies -----------------------------------------------------------
    def _count(self, code):
        m = self._m_codes.get(code)
        if m is None:
            # racing handler threads store the SAME registry object
            m = telemetry.counter("mxtpu_serve_http_requests_total",
                                  {"code": str(code)})
            self._m_codes[code] = m
        m.inc()

    def _text(self, handler, code, text):
        body = text.encode()
        self._count(code)
        handler.send_response(code)
        handler.send_header("Content-Type", "text/plain; charset=utf-8")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _json(self, handler, code, payload, retry_after=None):
        body = (json.dumps(payload) + "\n").encode()
        self._count(code)
        if code >= 400:
            # error replies may precede a full body read: closing keeps the
            # keep-alive stream from desyncing
            handler.close_connection = True
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        trace = getattr(handler, "_mxtpu_trace", None)
        if trace is not None:
            handler.send_header(_tracing.HEADER, trace)
        if retry_after is None and code == 429:
            retry_after = 1
        if retry_after is not None:
            handler.send_header("Retry-After", str(int(retry_after)))
        handler.end_headers()
        handler.wfile.write(body)
