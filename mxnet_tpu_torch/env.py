"""Typed registry of the ``MXTPU_*`` environment variables the port reads.

Counterpart of `mxnet_tpu/env.py`, holding only the variables of the
paths ported so far (generation serving, ResNet training), under the same
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
        if self.vtype == "int":
            return int(value)
        if self.vtype == "float":
            return float(value)
        return value


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
     "generation serving: largest decode batch; the decode buckets are the "
     "powers of two up to this value.")
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
