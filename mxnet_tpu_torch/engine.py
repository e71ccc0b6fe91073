"""Execution engine control surface (counterpart of `mxnet_tpu/engine.py`;
reference: python/mxnet/engine.py and the dependency engine of
src/engine/).

PyTorch already orders work on a card by its streams: an op is enqueued
and Python returns, and the arrays carry the dependencies. What remains of
the reference's engine is its control surface:

- `wait_all`: ``Engine::WaitForAll``, a barrier on every card the process
  has touched;
- the naive engine (``MXNET_ENGINE_TYPE=NaiveEngine`` or the scoped
  `naive_engine`): ops run one by one, and each op's dispatch
  synchronizes its card (`op_done`, called where `ndarray.invoke` and the
  symbol interpreter run an op), so a device error surfaces at the op that
  caused it, which is the reference NaiveEngine's purpose. Off, it costs a
  thread-local read and an environment lookup an op;
- `set_bulk_size` / `bulk`: the reference's op bulking, kept for their
  values only (the JAX package's semantics).
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch

__all__ = ["is_naive", "naive_engine", "wait_all", "set_bulk_size", "bulk",
           "op_done"]

_local = threading.local()


def is_naive():
    """True when ops run one by one, each synchronized (reference env
    ``MXNET_ENGINE_TYPE=NaiveEngine``, src/engine/engine.cc:33); a
    `naive_engine` block overrides the environment on its thread."""
    naive = getattr(_local, "naive", None)
    if naive is not None:
        return naive
    return os.environ.get("MXNET_ENGINE_TYPE", "") == "NaiveEngine"


@contextlib.contextmanager
def naive_engine(enable=True):
    """Scoped naive mode on the calling thread."""
    prev = getattr(_local, "naive", None)
    _local.naive = enable
    try:
        yield
    finally:
        _local.naive = prev


def op_done(device):
    """Called after an op's dispatch on ``device``: in naive mode a CUDA
    card is synchronized, so the op's errors surface here."""
    if device is not None and device.type == "cuda" and is_naive():
        torch.cuda.synchronize(device)


def wait_all():
    """Block until every pending kernel on every card this process has
    touched is done (reference: Engine::WaitForAll,
    include/mxnet/engine.h:234)."""
    if not torch.cuda.is_initialized():
        return
    current = torch.cuda.current_device()
    for i in range(torch.cuda.device_count()):
        # a card with nothing allocated has run nothing of this process;
        # synchronizing it would only open a context there
        if i == current or torch.cuda.memory_reserved(i):
            torch.cuda.synchronize(i)


def set_bulk_size(size):
    """reference: python/mxnet/engine.py:26. PyTorch runs ops as they are
    dispatched, so the size is recorded and nothing else; returns the
    previous value."""
    prev = getattr(_local, "bulk", 15)
    _local.bulk = size
    return prev


@contextlib.contextmanager
def bulk(size):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
