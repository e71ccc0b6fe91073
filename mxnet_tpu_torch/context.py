"""Devices.

Counterpart of `mxnet_tpu/context.py` (reference:
python/mxnet/context.py). A `Context` is a small hashable handle, a
device type and an id, as in the JAX package: ``cpu(0)`` and ``cpu(1)``
are two contexts (a parameter holds one copy on each) and both run on the
host; ``gpu(i)`` (and ``tpu(i)``, the JAX package's accelerator) is the
i-th CUDA card. `resolve_device` is the one gate to torch: it takes a
`Context`, a `torch.device` or a string and gives the `torch.device`.

Entry points take an explicit ``device`` / ``ctx``; one left as None is
the calling thread's innermost ``with ctx:`` / ``with scope(device):``
block, else the card. Without a card they raise instead of running on the
host, so a CPU run is always one the caller asked for. ``with mx.cpu():``
(any `Context`) also enters the device's own torch context, so torch's
factories default to it too; a ``with torch.device(...)`` block entered
inside it is the inner one.
"""
from __future__ import annotations

import threading

import torch
from torch.overrides import _get_current_function_mode_stack
from torch.utils._device import DeviceContext

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "resolve_device",
           "current_context", "scope", "in_scope_of", "num_gpus", "num_tpus",
           "gpu_memory_info"]

_scopes = threading.local()
_HOST_TYPES = ("cpu", "cpu_pinned", "cpu_shared")


class Context:
    """A device context (reference: python/mxnet/context.py:23).

    Parameters
    ----------
    device_type : {'cpu', 'gpu', 'tpu', 'cpu_pinned', 'cpu_shared'}, a
        `Context`, a `torch.device` or a torch device string
    device_id : int
    """

    devtype2id = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5,
                  "tpu": 6}
    devid2type = {v: k for k, v in devtype2id.items()}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        elif isinstance(device_type, torch.device) or (
                isinstance(device_type, str)
                and device_type not in self.devtype2id):
            dev = _torch_device(device_type)
            if dev.type not in ("cpu", "cuda"):
                raise MXNetError("unknown device type %s" % (device_type,))
            device_type = "cpu" if dev.type == "cpu" else "gpu"
            device_id = dev.index or 0
        if device_type not in self.devtype2id:
            raise MXNetError("unknown device type %s" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)
        self._blocks = []

    @property
    def device_typeid(self):
        return self.devtype2id[self.device_type]

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def torch_device(self):
        """The `torch.device` this context runs on (the counterpart of the
        JAX package's ``jax_device``): the host for a host context, whatever
        its id; card ``device_id`` for ``gpu`` / ``tpu``, which raises
        `MXNetError` when no card is present."""
        if self.device_type in _HOST_TYPES:
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available for %s; pass device='cpu' (or "
                "ctx=mx.cpu()) to run on the host" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("device %s out of range: %d CUDA card(s)"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    # -- the with-block: the calling thread's default context
    def __enter__(self):
        block = DeviceContext(_unchecked_device(self))
        block.__enter__()
        _push(self)
        self._blocks.append(block)
        return self

    def __exit__(self, *exc):
        _scopes.contexts.pop()
        self._blocks.pop().__exit__(*exc)

    @classmethod
    def default_ctx(cls):
        """The calling thread's current context (`current_context`)."""
        return current_context()

    def empty_cache(self):
        """Release the card's cached blocks to the driver (reference:
        context.py:292); nothing to do for a host context."""
        if self.device_type not in _HOST_TYPES \
                and torch.cuda.is_initialized():
            with torch.cuda.device(self.torch_device()):
                torch.cuda.empty_cache()

    def memory_info(self):
        """(free, total) bytes of this context's device (reference:
        context.py gpu_memory_info, cudaMemGetInfo); (0, 0) for the host,
        which has no device pool."""
        if self.device_type in _HOST_TYPES:
            return (0, 0)
        free, total = torch.cuda.mem_get_info(self.torch_device())
        return int(free), int(total)


def _torch_device(device):
    """A `torch.device` from a `torch.device` or a torch device string."""
    try:
        return torch.device(device)
    except (RuntimeError, TypeError) as e:
        raise MXNetError("unknown device %r" % (device,)) from e


def _unchecked_device(ctx):
    """``ctx``'s torch device without the card check (a with-block on a
    card context is entered before any tensor is made)."""
    return torch.device("cpu") if ctx.device_type in _HOST_TYPES \
        else torch.device("cuda", ctx.device_id)


def as_context(device):
    """``device`` (a `Context`, a `torch.device` or a string) as a
    `Context`; None stays None."""
    if device is None or isinstance(device, Context):
        return device
    return Context(device)


def checked_context(device):
    """``device`` as a `Context` (None stays None), resolved once: a card
    context without a card raises here, as `resolve_device` does."""
    ctx = as_context(device)
    if ctx is not None:
        resolve_device(ctx)
    return ctx


def cpu(device_id=0):
    """A host context. Every id runs on the host; two ids are two contexts
    (a parameter keeps a copy on each)."""
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    """The host, for page-locked staging (reference: context.py
    cpu_pinned). The port pins where it stages (`data.DevicePrefetcher`),
    so this runs on the host device."""
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """CUDA card ``device_id``."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """The JAX package's accelerator context: in the port, CUDA card
    ``device_id`` (as `gpu`)."""
    return Context("tpu", device_id)


def num_gpus():
    """The number of CUDA cards (reference: context.py num_gpus)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


num_tpus = num_gpus


def gpu_memory_info(device_id=0):
    """(free, total) bytes of card ``device_id`` (reference: context.py
    gpu_memory_info, cudaMemGetInfo)."""
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device is available")
    return gpu(device_id).memory_info()


def resolve_device(device=None):
    """``device`` (a `Context`, a `torch.device` or a string) as a
    `torch.device`; None means the calling thread's innermost ``with
    ctx:`` / `scope` block, else the current CUDA card. Raises
    `MXNetError` when a card is asked for (or defaulted to) and none is
    present."""
    if device is None:
        device = _innermost()
        if device is None:
            if not torch.cuda.is_available():
                raise MXNetError(
                    "no CUDA device is available; pass device='cpu' to run "
                    "on the host")
            return torch.device("cuda", torch.cuda.current_device())
    if isinstance(device, Context):
        return device.torch_device()
    dev = _torch_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError("unsupported device %s (cuda or cpu)" % dev)
    return dev


def _push(ctx):
    if not hasattr(_scopes, "contexts"):
        _scopes.contexts = []
    # beside the context, the depth of torch's mode stack: a `with
    # torch.device(...)` block entered later is the inner one
    _scopes.contexts.append((ctx, len(_get_current_function_mode_stack())))


class scope:
    """``with scope(device):`` makes ``device`` (a `Context`, a
    `torch.device` or a string) the calling thread's `current_context`
    until the block ends, without entering torch's device block
    (reference: the Context stack, python/mxnet/context.py)."""

    def __init__(self, device):
        self._ctx = as_context(device)

    def __enter__(self):
        _push(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _scopes.contexts.pop()


def _torch_device_block():
    """(depth on torch's mode stack, device) of the innermost ``with
    torch.device(...)`` block, or None."""
    stack = _get_current_function_mode_stack()
    for i in range(len(stack) - 1, -1, -1):
        if isinstance(stack[i], DeviceContext):
            return i, stack[i].device
    return None


def _innermost():
    """The innermost ``with ctx:`` / `scope` context, or the device of an
    inner ``with torch.device(...)`` block, or None."""
    contexts = getattr(_scopes, "contexts", None)
    block = _torch_device_block()
    if block is not None and (not contexts or block[0] >= contexts[-1][1]):
        return block[1]
    return contexts[-1][0] if contexts else None


def current_context():
    """The `Context` of the innermost ``with ctx:`` / `scope` block (a
    ``with torch.device(...)`` block's device as a `Context`), else the
    current CUDA card; raises `MXNetError` when that is a card and none is
    present (reference: context.py:301)."""
    inner = _innermost()
    if inner is None:
        return Context(resolve_device(None))
    ctx = as_context(inner)
    resolve_device(ctx)
    return ctx


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
