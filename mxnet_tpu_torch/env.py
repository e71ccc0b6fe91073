"""Typed registry of the ``MXTPU_*`` environment variables the port reads.

Counterpart of `mxnet_tpu/env.py`, holding only the variables of the
paths ported so far (generation serving, ResNet training, the input
pipeline), under the same
names and, but for the one noted at its entry, the same defaults, so one
deployment's settings mean the same thing to both packages. There is no kernel gate: a CUDA tensor always goes through
the port's kernel.

``get(name)`` takes registered names only (an unregistered name raises
``KeyError``) and returns the value parsed per the registered type, or the
default when the variable is unset or malformed.
"""
from __future__ import annotations

import os

__all__ = ["EnvVar", "registry", "names", "get"]


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
