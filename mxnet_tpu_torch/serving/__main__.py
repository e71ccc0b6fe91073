"""Serve deployment artifacts over HTTP on the CUDA card.

Counterpart of the JAX package's ``tools/serve.py``. Loads each artifact
(either package's) into a `ModelRepository`, warms every padding bucket,
and serves the ``/v1/models`` routes until SIGTERM, which drains queued
and running requests before exiting 0.

Model specs (repeatable ``--model``):

  NAME=PREFIX@in=DIMS[:dtype][,in2=...]   export prefix (PREFIX-symbol.json
      + the newest PREFIX-NNNN.params; DIMS are the per-example dims,
      'x'-separated, batch dim excluded; dtype defaults to float32), served
      through the dynamic batcher at ``POST /v1/models/<name>:predict``
  NAME=PREFIX@generate                    generation LM artifact (``save_lm``),
      served through the continuous-batching decode scheduler at
      ``POST /v1/models/<name>:generate``

    python -m mxnet_tpu_torch.serving --model mlp=/models/mlp/model@data=8
    python -m mxnet_tpu_torch.serving \\
        --model lm=/models/lm/model@data=35:int32,label=35:int32 \\
        --model gen=/models/gen/model@generate --port 8500
    python -m mxnet_tpu_torch.serving --model lm=/models/lm/model@generate \\
        --replicas 2

Knobs default to the ``MXTPU_SERVE_*`` variables; flags override them.
``--device cpu`` serves on the host (there is no silent fallback to it).
``--replicas N`` (default ``MXTPU_SERVE_REPLICAS``) serves every model
through a supervised pool of N replica processes on that device; SIGTERM
drains the pools and tears every replica's process group down before the
server exits. ``--autoscale`` (default ``MXTPU_AUTOSCALE``) arms the
autoscaler over the pools, within ``--min-replicas`` / ``--max-replicas``
a model; ``--pin`` exempts the models from budget-pressure eviction
(``MXTPU_SERVE_MEMORY_BUDGET``). Not ported yet: compiled ``.mxc``
artifacts (ROADMAP queue 1 items 2 and 13).

    python -m mxnet_tpu_torch.serving --model lm=/models/lm/model@generate \\
        --replicas 1 --autoscale --min-replicas 1 --max-replicas 3
"""
from __future__ import annotations

import argparse
import logging
import sys


def parse_model_spec(spec):
    """``name=PREFIX@in=DIMS[:dtype][,in2=...]`` -> (name, prefix, shapes,
    dtypes), dtypes None when none is given; ``name=PREFIX@generate`` ->
    (name, prefix, "generate", None)."""
    if "=" not in spec:
        raise ValueError("model spec %r needs name=PREFIX@..." % spec)
    name, rest = spec.split("=", 1)
    if "@" not in rest:
        raise ValueError("model spec %r: compiled (.mxc) artifacts are not "
                         "ported; give PREFIX@in=DIMS or PREFIX@generate"
                         % spec)
    path, sig = rest.split("@", 1)
    if sig == "generate":
        return name, path, "generate", None
    shapes, dtypes = {}, {}
    for part in sig.split(","):
        if "=" not in part:
            raise ValueError("input spec %r needs input=DIMS" % part)
        iname, dims = part.split("=", 1)
        if ":" in dims:
            dims, dtype = dims.split(":", 1)
            dtypes[iname] = dtype
        shapes[iname] = tuple(int(d) for d in dims.split("x") if d)
    return name, path, shapes, (dtypes or None)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", action="append", required=True,
                   metavar="NAME=PREFIX@IN=DIMS[:DTYPE],...|@generate",
                   help="artifact to serve (repeatable)")
    p.add_argument("--port", type=int, default=None,
                   help="HTTP port (default MXTPU_SERVE_PORT; 0 = free port)")
    p.add_argument("--addr", default="0.0.0.0")
    p.add_argument("--max-batch", type=int, default=None,
                   help="override MXTPU_SERVE_MAX_BATCH")
    p.add_argument("--delay-ms", type=float, default=None,
                   help="override MXTPU_SERVE_MAX_DELAY_MS")
    p.add_argument("--queue-depth", type=int, default=None,
                   help="override MXTPU_SERVE_QUEUE_DEPTH")
    p.add_argument("--kv-dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="KV cache dtype of generation models")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    p.add_argument("--replicas", type=int, default=None,
                   help="replica worker processes per model (default "
                        "MXTPU_SERVE_REPLICAS; 0 = in-process, no pool). "
                        "N >= 1 serves through a supervised pool with "
                        "health-checked failover")
    p.add_argument("--autoscale", action="store_true", default=None,
                   help="arm the autoscaler (default MXTPU_AUTOSCALE): "
                        "SLO-breach scale-up and idle scale-down of every "
                        "pooled model, in place")
    p.add_argument("--min-replicas", type=int, default=None,
                   help="per-model autoscaling floor (default "
                        "MXTPU_AUTOSCALE_MIN_REPLICAS)")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="per-model autoscaling ceiling (default "
                        "MXTPU_AUTOSCALE_MAX_REPLICAS)")
    p.add_argument("--pin", action="store_true",
                   help="pin the loaded models: exempt from "
                        "budget-pressure eviction")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="[serve] %(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("mxnet_tpu_torch.serving")

    from .. import env as _env
    from . import Autoscaler, ModelRepository, ServingServer

    replicas = args.replicas
    if replicas is None:
        replicas = _env.get("MXTPU_SERVE_REPLICAS")
    scale_kw = dict(min_replicas=args.min_replicas,
                    max_replicas=args.max_replicas, pinned=args.pin)
    repo = ModelRepository()
    try:
        _load_all(repo, args, replicas, scale_kw, log)
        server = ServingServer(repo, port=args.port, addr=args.addr)
    except BaseException:
        _close_all(repo)
        raise
    autoscale = args.autoscale
    if autoscale is None:
        autoscale = _env.get("MXTPU_AUTOSCALE")
    if autoscale:
        server.attach_autoscaler(Autoscaler(repo))
        log.info("autoscaler armed (interval %.0fms, up after %d breached "
                 "windows, idle scale-down after %.0fs)",
                 _env.get("MXTPU_AUTOSCALE_INTERVAL_MS"),
                 _env.get("MXTPU_AUTOSCALE_UP_WINDOWS"),
                 _env.get("MXTPU_AUTOSCALE_IDLE_S"))
    server.install_signal_handlers()
    log.info("serving %s on %s:%d (SIGTERM drains and exits 0)",
             repo.names(), args.addr, server.port)
    try:
        server.serve_forever()  # returns after the SIGTERM drain
    finally:
        # no controller thread or replica process group outlives the
        # server
        if server.autoscaler is not None:
            server.autoscaler.stop()
        _close_all(repo)
    if server.drain_failed:
        log.error("drain timed out; stranded requests were 503ed")
        return 1
    log.info("drained; bye")
    return 0


def _close_all(repo):
    for model in repo.models():
        model.close(drain=False, timeout=0)


def _load_all(repo, args, replicas, scale_kw, log):
    for spec in args.model:
        name, prefix, shapes, dtypes = parse_model_spec(spec)
        log.info("loading %s from %s%s ...", name, prefix,
                 " (%d replicas)" % replicas if replicas else "")
        if shapes == "generate":
            model = repo.load(name, prefix, generate=True,
                              generate_opts={"kv_dtype": args.kv_dtype},
                              max_batch=args.max_batch,
                              queue_depth=args.queue_depth,
                              device=args.device, replicas=replicas,
                              **scale_kw)
            log.info("loaded %s/%d (generate) on %s buckets=%s warm=%.2fs",
                     model.name, model.version,
                     model.generate_info.get("device"),
                     model.generate_info.get("decode_buckets"),
                     model.warm_seconds or 0.0)
            continue
        model = repo.load(name, prefix, input_shapes=shapes,
                          input_dtypes=dtypes, max_batch=args.max_batch,
                          max_delay_ms=args.delay_ms,
                          queue_depth=args.queue_depth, device=args.device,
                          replicas=replicas, **scale_kw)
        log.info("loaded %s/%d (predict) on %s buckets=%s warm=%.2fs",
                 model.name, model.version, model.meta.get("device"),
                 model.buckets, model.warm_seconds or 0.0)


if __name__ == "__main__":
    sys.exit(main())
