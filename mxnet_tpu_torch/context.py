"""Devices.

Counterpart of `mxnet_tpu/context.py`. A device is a `torch.device`:
``gpu(i)`` is the i-th CUDA card and ``cpu()`` the host. Entry points take
an explicit ``device`` and default to the card; without a card they raise
instead of running on the host, so a CPU run is always one the caller asked
for. ``with scope(device):`` sets the default of `current_context` for the
calling thread, as ``with mx.cpu():`` does in the JAX package.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "resolve_device", "current_context", "scope",
           "in_scope_of"]

_scopes = threading.local()


def cpu():
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


def resolve_device(device=None):
    """``device`` as a `torch.device`; None means the first CUDA card.
    Raises `MXNetError` when a CUDA device is asked for (or defaulted to)
    and no card is present."""
    dev = gpu(0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host")
        if dev.index is None:
            dev = gpu(torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError("unsupported device %s (cuda or cpu)" % dev)
    return dev


class scope:
    """``with scope(device):`` makes ``device`` the calling thread's
    `current_context` until the block ends (reference: the Context stack,
    python/mxnet/context.py)."""

    def __init__(self, device):
        self._device = torch.device(device)

    def __enter__(self):
        if not hasattr(_scopes, "devices"):
            _scopes.devices = []
        _scopes.devices.append(self._device)
        return self._device

    def __exit__(self, *exc):
        _scopes.devices.pop()


def current_context():
    """The innermost `scope`'s device, else the first CUDA card; raises
    `MXNetError` when that is a card and none is present."""
    devices = getattr(_scopes, "devices", None)
    return resolve_device(devices[-1] if devices else None)


def in_scope_of(fn):
    """``fn`` wrapped to run under the calling thread's innermost `scope`
    (if any) on whatever thread calls it: a pipeline thread then makes its
    arrays where its consumer's ``with scope(...)`` asked."""
    devices = getattr(_scopes, "devices", None)
    if not devices:
        return fn
    device = devices[-1]

    def run(*args, **kwargs):
        with scope(device):
            return fn(*args, **kwargs)

    return run
