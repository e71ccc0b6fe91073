"""Devices.

Counterpart of `mxnet_tpu/context.py`. A device is a `torch.device`:
``gpu(i)`` is the i-th CUDA card and ``cpu()`` the host. Entry points take
an explicit ``device`` and default to the card; without a card they raise
instead of running on the host, so a CPU run is always one the caller asked
for. ``with scope(device):`` sets the default of `current_context` for the
calling thread, as ``with mx.cpu():`` does in the JAX package; so does
``with mx.cpu():`` or ``with mx.gpu(i):`` itself, which enters the device's
own torch context (torch's factories then default to it too), whichever of
the two blocks is the inner one.
"""
from __future__ import annotations

import threading

import torch
from torch.overrides import _get_current_function_mode_stack
from torch.utils._device import DeviceContext

from .base import MXNetError

__all__ = ["cpu", "gpu", "resolve_device", "current_context", "scope",
           "in_scope_of"]

_scopes = threading.local()


def cpu(device_id=0):
    """The host. ``device_id`` is the reference's argument; the host is
    one device, whatever its id."""
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
        # beside the device, the depth of torch's mode stack: a `with
        # torch.device(...)` block entered later is the inner one
        _scopes.devices.append((self._device,
                                len(_get_current_function_mode_stack())))
        return self._device

    def __exit__(self, *exc):
        _scopes.devices.pop()


def _torch_device_block():
    """(depth on torch's mode stack, device) of the innermost ``with
    torch.device(...)`` block (``with mx.cpu():``), or None."""
    stack = _get_current_function_mode_stack()
    for i in range(len(stack) - 1, -1, -1):
        if isinstance(stack[i], DeviceContext):
            return i, stack[i].device
    return None


def _innermost():
    """The device of the innermost `scope` or ``with torch.device(...)``
    block, or None."""
    devices = getattr(_scopes, "devices", None)
    block = _torch_device_block()
    if block is not None and (not devices or block[0] >= devices[-1][1]):
        return block[1]
    return devices[-1][0] if devices else None


def current_context():
    """The device of the innermost `scope` or ``with mx.cpu():`` / ``with
    mx.gpu(i):`` block, else the first CUDA card; raises `MXNetError` when
    that is a card and none is present."""
    return resolve_device(_innermost())


def in_scope_of(fn):
    """``fn`` wrapped to run under the calling thread's innermost `scope`
    (if any) on whatever thread calls it: a pipeline thread then makes its
    arrays where its consumer's ``with scope(...)`` asked."""
    device = _innermost()
    if device is None:
        return fn

    def run(*args, **kwargs):
        with scope(device):
            return fn(*args, **kwargs)

    return run
