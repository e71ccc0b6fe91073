"""Device meshes over a `torch.distributed` world (counterpart of
`mxnet_tpu/parallel/mesh.py`).

The JAX package runs one process over many devices and lays a
`jax.sharding.Mesh` over them. The port runs one process a device: a mesh
is the world of the process group, one device a rank, reshaped into named
axes in rank order (row-major, the last axis fastest). Rank r uses
``cuda:<local rank>`` over NCCL on the card and the host over gloo. A world
of one process needs no group.

Conventional axis names, as in the JAX package:

    dp — data parallel (batch dimension)
    fsdp — fully-sharded data parallel
    tp — tensor parallel
    pp — pipeline parallel
    sp — sequence parallel
    ep — expert parallel (MoE)

`parallel.DistributedTrainer` runs every axis (``sp`` and ``pp``
replicate there); `parallel.PipelineTrainer` runs ``pp`` and
`parallel.ring_attention` ``sp``.

A mesh over more than one rank builds, when it is made, one process group
for each (axis, coordinate of the other axes) with more than one and fewer
than all ranks (an axis over the whole world uses the world's group), and
one over ``dp`` x ``fsdp`` together when both are split (`DATA`, the
axes a batch splits over):
`torch.distributed.new_group` is collective, so every rank makes every
mesh in the same order, as every JAX process builds the same mesh.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
import weakref

import numpy as np
import torch

from ..base import MXNetError

__all__ = [
    "Device", "Mesh", "devices", "make_mesh", "default_mesh",
    "current_mesh", "use_mesh", "local_devices", "mesh_fingerprint",
    "DP", "FSDP", "TP", "PP", "SP", "EP", "DATA",
]

DP, FSDP, TP, PP, SP, EP = "dp", "fsdp", "tp", "pp", "sp", "ep"
# the axes a batch splits over, dp-major (`sharding.batch_spec`)
DATA = (DP, FSDP)

_state = threading.local()


class Device:
    """One rank's device: ``rank``, ``device`` (a `torch.device`),
    ``platform`` ("gpu" or "cpu"), ``id`` (the rank, as a JAX device's
    global id), ``device_kind`` and ``process_index`` (the rank: one
    process a device)."""

    __slots__ = ("rank", "device", "platform", "id", "device_kind",
                 "process_index")

    def __init__(self, rank, device):
        self.rank = self.id = self.process_index = int(rank)
        self.device = torch.device(device)
        self.platform = "gpu" if self.device.type == "cuda" else "cpu"
        if self.device.type == "cuda" and torch.cuda.is_available():
            self.device_kind = torch.cuda.get_device_name(self.device)
        else:
            self.device_kind = self.device.type

    def __repr__(self):
        return "Device(rank=%d, %s)" % (self.rank, self.device)


def _dist():
    """`torch.distributed` when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _local_rank(rank):
    v = os.environ.get("LOCAL_RANK")
    if v is not None and rank == _dist().get_rank():
        return int(v)
    n = torch.cuda.device_count() or 1
    return rank % n


def _rank_device(rank):
    """The device of ``rank`` in the current group: its card over NCCL,
    the host otherwise."""
    dist = _dist()
    if dist.get_backend() == "nccl":
        return torch.device("cuda", _local_rank(rank))
    return torch.device("cpu")


def local_device():
    """This process's device: its rank's (see `devices`), or with no
    process group the calling thread's `context.scope` device, else the
    card when there is one, else the host."""
    dist = _dist()
    if dist is not None:
        return _rank_device(dist.get_rank())
    from ..context import Context, _innermost, _unchecked_device

    dev = _innermost()
    if dev is not None:
        return _unchecked_device(dev) if isinstance(dev, Context) \
            else torch.device(dev)
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")


def devices():
    """Every rank's `Device`, in rank order: the counterpart of the
    ``jax.devices()`` the JAX package's callers use."""
    dist = _dist()
    if dist is None:
        return [Device(0, local_device())]
    return [Device(r, _rank_device(r)) for r in range(dist.get_world_size())]


def local_devices(platform=None):
    """The devices of THIS process (one), filtered by ``platform``."""
    dist = _dist()
    me = Device(dist.get_rank() if dist is not None else 0, local_device())
    return [me] if platform is None or me.platform == platform else []


class _Axis:
    """This rank's view of one mesh axis: ``size``, ``index`` (its
    coordinate) and ``group`` (None when no group is up or the axis holds
    one rank; else a process group over the ranks along the axis through
    this rank, whose group ranks follow the axis order)."""

    __slots__ = ("size", "index", "group")

    def __init__(self, size, index, group):
        self.size, self.index, self.group = size, index, group


class Mesh:
    """Named axes over ``devices``, a numpy object array of `Device`s of
    the mesh's shape, as a `jax.sharding.Mesh` holds them."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self._axes = {}

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def axis_size(self, name):
        return self.shape.get(name, 1)

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%s=%d" % kv
                                      for kv in self.shape.items())

    def _build_groups(self):
        """One group a (axis, coordinate of the other axes), and one a
        coordinate of the non-data axes over the data axes ``dp`` x
        ``fsdp`` when both hold more than one rank, made by every rank in
        the same order (`new_group` is collective)."""
        dist = _dist()
        world = dist.get_world_size() if dist is not None else 1
        ranks = np.vectorize(lambda d: d.rank, otypes=[int])(self.devices)
        if dist is not None and sorted(ranks.flat) != list(range(world)):
            raise MXNetError(
                "a mesh over %d of the world's %d ranks: a mesh spans the "
                "whole process group (ROADMAP queue 1 item 11 part 2)"
                % (ranks.size, world))
        me = dist.get_rank() if dist is not None else int(ranks.flat[0])
        lines = [(name, (name,)) for name in self.axis_names]
        sizes = self.shape
        if sizes.get(DP, 1) > 1 and sizes.get(FSDP, 1) > 1:
            lines.append((DATA, DATA))
        for key, names in lines:
            ax = [self.axis_names.index(n) for n in names]
            rest = [i for i in range(ranks.ndim) if i not in ax]
            n = math.prod(ranks.shape[i] for i in ax)
            mine = None
            # each row: the ranks that share every other coordinate, in
            # the named axes' row-major order
            for row in ranks.transpose(rest + ax).reshape(-1, n):
                line = [int(r) for r in row]
                if dist is None or len(line) == 1 and world > 1:
                    group = None
                elif len(line) == world:
                    group = dist.group.WORLD
                else:
                    group = dist.new_group(line)
                if me in line:
                    mine = _Axis(len(line), line.index(me), group)
            self._axes[key] = mine

    def axis(self, name):
        """This rank's `_Axis` of ``name`` (an axis the mesh lacks is one
        of size 1). A tuple of names is the axes taken together, in the
        tuple's row-major order: their axes of more than one rank, which
        may be at most one, or ``DATA`` (dp x fsdp)."""
        if not isinstance(name, str):
            names = tuple(n for n in name if self.axis_size(n) > 1)
            if not names:
                return _Axis(1, 0, None)
            if len(names) > 1 and names != DATA:
                raise MXNetError("mesh axes %s taken together: only dp x "
                                 "fsdp has a group" % (names,))
            name = names[0] if len(names) == 1 else DATA
        ax = self._axes.get(name)
        if ax is None:
            if name == DATA or name in self.axis_names:
                raise MXNetError("mesh axis %r: this mesh of %d devices was "
                                 "not made over the process group"
                                 % (name, self.size))
            return _Axis(1, 0, None)
        return ax


def make_mesh(axes=None, devices=None):
    """A `Mesh` over ``devices`` (default: every rank's, `devices()`).

    ``axes`` is an ordered dict / list of (name, size) pairs; a size of -1
    means "whatever is left" (at most one). With no axes the mesh is 1-D
    data-parallel over every device."""
    if devices is None:
        devices = globals()["devices"]()
    devices = list(devices)
    n = len(devices)
    if axes is None:
        axes = [(DP, n)]
    if isinstance(axes, dict):
        axes = list(axes.items())
    names = [a for a, _ in axes]
    sizes = [s for _, s in axes]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} devices, have {n}")
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices
    mesh = Mesh(dev_array.reshape(sizes), names)
    dist = _dist()
    if dist is not None and n == dist.get_world_size() \
            and all(isinstance(d, Device) for d in devices):
        mesh._build_groups()
    elif n == 1 and isinstance(devices[0], Device):
        mesh._build_groups()
    return mesh


def mesh_fingerprint(mesh):
    """The mesh's named axes x shape x sorted device kinds x process count
    as one string (e.g. ``dp=2,ep=2|NVIDIA H100 80GB HBM3|procs=4``)."""
    axes = ",".join("%s=%d" % (str(n), int(s))
                    for n, s in zip(mesh.axis_names, mesh.devices.shape))
    kinds = sorted({str(getattr(d, "device_kind", None) or d.platform)
                    for d in mesh.devices.flat})
    dist = _dist()
    procs = dist.get_world_size() if dist is not None else 1
    return "%s|%s|procs=%d" % (axes, "+".join(kinds), procs)


def default_mesh():
    """The process-wide default mesh (1-D data parallel over every rank).
    Made again when the process group changed since."""
    m = getattr(_state, "default", None)
    if m is None or m.size != len(devices()):
        m = make_mesh()
        _state.default = m
    return m


def current_mesh():
    return getattr(_state, "current", None) or default_mesh()


@contextlib.contextmanager
def use_mesh(mesh):
    """Scope a mesh as the current one (the reference's Context stack,
    context.py:87)."""
    prev = getattr(_state, "current", None)
    _state.current = mesh
    try:
        yield mesh
    finally:
        _state.current = prev


# -- the trainer's step

@contextlib.contextmanager
def step_scope(mesh):
    """Marks a `DistributedTrainer` step over ``mesh``: inside it each rank
    holds its ``dp`` shard of the global batch, and the ops that route
    over the global batch (`ops.contrib.topk_moe`) act over the mesh.
    Outside it they see the batch they are given, as an eager call in the
    JAX package does."""
    prev = getattr(_state, "step", None)
    _state.step = mesh
    try:
        with use_mesh(mesh):
            yield mesh
    finally:
        _state.step = prev


def step_mesh():
    """The mesh of the enclosing `step_scope`, or None."""
    return getattr(_state, "step", None)


# batches a mesh-bound `data.DevicePrefetcher` placed as this rank's shard
_SHARDS = weakref.WeakValueDictionary()


def mark_shard(t):
    _SHARDS[id(t)] = t
    return t


def is_shard(t):
    return _SHARDS.get(id(t)) is t
