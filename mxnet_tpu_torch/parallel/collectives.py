"""Collectives over `torch.distributed` (counterpart of
`mxnet_tpu/parallel/collectives.py`): NCCL between cards, gloo between
host processes.

Two call modes, as in the JAX package:

* the in-graph forms (`psum`, `pmean`, `pmax`, `pmin`, `all_gather`,
  `reduce_scatter`, `ppermute`, `all_to_all`, `axis_index`, `axis_size`,
  and `pbroadcast`) act over one axis of the current mesh
  (`mesh.current_mesh`): the group of the ranks that share this rank's
  coordinates on every other axis. They are differentiable the way
  ``shard_map`` differentiates them in JAX: `psum`'s result is replicated
  over the axis, so its backward passes the gradient through unchanged;
  `pbroadcast` (identity forward) is its conjugate, whose backward sums
  the gradient over the axis. `all_gather` and `reduce_scatter` are each
  other's transposes, `all_to_all` and `ppermute` are undone by their
  inverses, and `pmax` / `pmin` carry no gradient. With no process group
  (one process) every axis holds one rank and each form is the identity;
  with a group, even of one rank, each runs its collective;
* the eager forms `all_reduce_arrays` / `broadcast_arrays`, with the
  ``mxtpu_collective_*`` counters and histogram.

Sums run in rank order on every rank (an all-gather, then the parts added
in turn), so every rank of a group gets the same bits and a run repeats
them.

`init_process_group` is the rendezvous, from the same environment as the
JAX package's (plus the ``torch.distributed`` names).
"""
from __future__ import annotations

import datetime
import os
import time as _time_mod

import torch

from .. import env as _env
from .. import telemetry as _telemetry
from ..base import MXNetError
from .mesh import _Axis, _dist, current_mesh

__all__ = [
    "psum", "pmean", "pmax", "pmin", "all_gather", "reduce_scatter",
    "ppermute", "axis_index", "axis_size", "all_to_all", "pbroadcast",
    "all_reduce_arrays", "broadcast_arrays", "init_process_group", "barrier",
    "rank", "num_workers",
]


def _axis(axis_name, mesh=None):
    """The mesh's `_Axis` of ``axis_name``: one name, or a tuple of names
    taken together (`Mesh.axis`)."""
    mesh = mesh if mesh is not None else current_mesh()
    if not isinstance(axis_name, str):
        axis_name = tuple(axis_name)
        if len(axis_name) == 1:
            axis_name = axis_name[0]
    return mesh.axis(axis_name)


# -- the primitives (no autograd)

def _host_staged(x, ax):
    """Whether a collective over ``ax`` moves ``x`` through the host: gloo
    between processes that share a card takes host tensors, so a card
    tensor is copied out and back (chosen before the call, from the
    group's backend)."""
    return x.is_cuda and _dist().get_backend(ax.group) == "gloo"


def _gather(x, ax):
    """Every rank's ``x`` along the axis, in axis order."""
    if ax.group is None:
        return [x]
    if x.dtype == torch.bool:
        return [p.view(torch.bool) for p in _gather(x.view(torch.uint8),
                                                    ax)]
    if _host_staged(x, ax):
        return [p.to(x.device) for p in _gather(x.cpu(), ax)]
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    _dist().all_gather(parts, x.contiguous(), group=ax.group)
    return parts


def _sum(x, ax):
    parts = _gather(x, ax)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _scatter_slice(x, ax, dim):
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n)


def _all_to_all(x, ax, split_axis, concat_axis):
    """Tiled: chunk j of ``x`` along ``split_axis`` goes to axis rank j;
    what rank i sent lands as chunk i along ``concat_axis``."""
    n = ax.size
    if x.shape[split_axis] % n:
        raise MXNetError("all_to_all: dimension %d of size %d does not "
                         "split over %d ranks"
                         % (split_axis, x.shape[split_axis], n))
    send = x.movedim(split_axis, 0).contiguous()
    if ax.group is None:
        recv = send
    else:
        recv = torch.empty_like(send)
        _dist().all_to_all_single(recv, send, group=ax.group)
    blocks = recv.chunk(n, 0)
    return torch.cat([b.movedim(0, split_axis) for b in blocks],
                     dim=concat_axis)


def _ppermute(x, ax, perm):
    """``x`` sent along the (source, destination) pairs of ``perm``; a rank
    no pair sends to gets zeros. Point to point (`batch_isend_irecv`: each
    hop moves one shard) over NCCL and over gloo for host tensors; a card
    tensor over gloo, whose point to point takes host tensors only, takes
    the all-gather form (every rank's ``x`` gathered, the source's kept)."""
    me = ax.index
    src = [s for s, d in perm if d == me]
    dst = [d for s, d in perm if s == me]
    if ax.group is None or ax.size == 1:
        return x.view_as(x) if src else torch.zeros_like(x)
    if x.dtype == torch.bool:
        return _ppermute(x.view(torch.uint8), ax, perm).view(torch.bool)
    if _host_staged(x, ax):
        parts = _gather(x, ax)
        return parts[src[0]] if src else torch.zeros_like(x)
    dist = _dist()
    x = x.contiguous()
    out = torch.empty_like(x) if src else torch.zeros_like(x)
    ops = []
    for d in dst:
        if d == me:
            continue
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(ax.group, d), ax.group))
    for s in src:
        if s == me:
            out.copy_(x)
            continue
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(ax.group, s), ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


# -- autograd

def _fresh(out, x):
    """``out``, or a view of ``x`` when a one-rank form handed ``x`` back
    (a custom autograd function returns no input as is)."""
    return x.view_as(x) if out is x else out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _fresh(_sum(x, ax), x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.ax), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return torch.cat(_gather(x, ax), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_slice(_sum(g, ctx.ax), ctx.ax, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _fresh(_scatter_slice(_sum(x, ax), ax, dim).contiguous(), x)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather(g, ctx.ax), dim=ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.args = (ax, split_axis, concat_axis)
        return _fresh(_all_to_all(x, ax, split_axis, concat_axis), x)

    @staticmethod
    def backward(ctx, g):
        ax, split_axis, concat_axis = ctx.args
        return _all_to_all(g, ax, concat_axis, split_axis), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.inverse = ax, [(d, s) for s, d in perm]
        return _fresh(_ppermute(x, ax, perm), x)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.ax, ctx.inverse), None, None


# -- in-graph collectives

def psum(x, axis_name):
    """Sum over the axis; the gradient passes through (the sum is
    replicated over the axis)."""
    return _PSum.apply(x, _axis(axis_name))


def pbroadcast(x, axis_name):
    """Identity; the backward sums the gradient over the axis (the
    conjugate of `psum`: a replicated value feeding per-rank work)."""
    return _PBroadcast.apply(x, _axis(axis_name))


def pmean(x, axis_name):
    ax = _axis(axis_name)
    return _PSum.apply(x, ax) / ax.size


def pmax(x, axis_name):
    with torch.no_grad():
        return torch.stack(_gather(x, _axis(axis_name))).amax(0)


def pmin(x, axis_name):
    with torch.no_grad():
        return torch.stack(_gather(x, _axis(axis_name))).amin(0)


def all_gather(x, axis_name, axis=0, tiled=True):
    """Every rank's ``x`` concatenated along ``axis`` (``tiled``) or
    stacked on a new ``axis``."""
    ax = _axis(axis_name)
    if tiled:
        return _AllGather.apply(x, ax, axis)
    return _AllGather.apply(x.unsqueeze(axis), ax, axis)


def reduce_scatter(x, axis_name, scatter_dimension=0):
    """The sum over the axis, split along ``scatter_dimension``: rank i
    keeps part i (``jax.lax.psum_scatter(..., tiled=True)``)."""
    ax = _axis(axis_name)
    if x.shape[scatter_dimension] % ax.size:
        raise MXNetError("reduce_scatter: dimension %d of size %d does not "
                         "split over %d ranks"
                         % (scatter_dimension, x.shape[scatter_dimension],
                            ax.size))
    return _ReduceScatter.apply(x, ax, scatter_dimension)


def ppermute(x, axis_name, perm):
    """``x`` sent along the (source, destination) pairs of ``perm`` (axis
    indices); a rank no pair sends to gets zeros."""
    return _PPermute.apply(x, _axis(axis_name), list(perm))


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True):
    ax = _axis(axis_name)
    if tiled:
        return _AllToAll.apply(x, ax, split_axis, concat_axis)
    if x.shape[split_axis] != ax.size:
        raise MXNetError("all_to_all(tiled=False): dimension %d must be "
                         "the axis size %d" % (split_axis, ax.size))
    out = _AllToAll.apply(x, ax, split_axis, split_axis)
    return torch.stack(out.unbind(split_axis), dim=concat_axis)


def axis_index(axis_name):
    return _axis(axis_name).index


def axis_size(axis_name):
    return _axis(axis_name).size


# -- eager collectives

def _payload_bytes(arrays):
    return sum(int(a.numel()) * a.element_size() for a in arrays)


def _observe_collective(op, arrays, seconds):
    """One eager collective: call count, payload bytes and the host time
    of the call (the launch on the card, not its completion)."""
    labels = {"op": op}
    _telemetry.counter("mxtpu_collective_calls_total", labels).inc()
    _telemetry.counter("mxtpu_collective_bytes_total", labels).inc(
        _payload_bytes(arrays))
    _telemetry.histogram("mxtpu_collective_seconds", labels).observe(seconds)


def _data(a):
    return a._data if hasattr(a, "_data") else a


def all_reduce_arrays(arrays):
    """The sum of ``arrays`` (this process's same-shaped tensors or
    NDArrays), added in list order and then over the world's ranks in
    rank order, copied onto each array's device. With no process group it
    is the local sum, as the JAX package's reduce over one process's
    devices."""
    if not arrays:
        return []
    t0 = _time_mod.perf_counter()
    tensors = [_data(a) for a in arrays]
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(total.device)
    dist = _dist()
    if dist is not None:
        n = dist.get_world_size()
        total = _sum(total, _Axis(n, dist.get_rank(), dist.group.WORLD))
    out = [total.to(t.device, copy=True) for t in tensors]
    _observe_collective("all_reduce", tensors, _time_mod.perf_counter() - t0)
    if hasattr(arrays[0], "_data"):
        from ..ndarray import NDArray

        out = [NDArray(o) for o in out]
    return out


def broadcast_arrays(src, devices):
    """Rank 0's ``src`` on each of ``devices`` (torch devices or mesh
    `Device`s) of this process."""
    t0 = _time_mod.perf_counter()
    x = _data(src)
    dist = _dist()
    if dist is not None:
        # gloo between processes that share a card takes host tensors
        x = x.cpu() if x.is_cuda and dist.get_backend() == "gloo" \
            else x.clone()
        dist.broadcast(x, src=0)
    out = [x.to(getattr(d, "device", d), copy=True) for d in devices]
    _observe_collective("broadcast", [x] * len(out),
                        _time_mod.perf_counter() - t0)
    return out


# -- the rendezvous

def _env_int(*names):
    """The first set name's integer value (a malformed one falls through
    to the next name)."""
    for n in names:
        v = _env.raw(n) if n in _env.names() else os.environ.get(n)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                continue
    return None


_SIZE_NAMES = ("MXTPU_NUM_WORKERS", "MXNET_TPU_NUM_WORKERS",
               "DMLC_NUM_WORKER", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE",
               "SLURM_STEP_NUM_TASKS", "WORLD_SIZE")
_RANK_NAMES = ("MXTPU_PROCESS_ID", "DMLC_WORKER_ID", "OMPI_COMM_WORLD_RANK",
               "PMI_RANK", "SLURM_PROCID", "RANK")


def init_process_group(coordinator_address=None, num_processes=None,
                       process_id=None, timeout=None, retries=None,
                       init_method=None, backend=None):
    """Join the process group: NCCL when each of this host's ranks has a
    card of its own, gloo otherwise (ranks sharing a card, or no card; a
    card tensor then goes through the host), or ``backend``. A no-op in
    one process and when the group is already up.

    The size and rank come from the same environment as the JAX
    package's, in its order (``MXTPU_NUM_WORKERS``, ``DMLC_*``,
    ``OMPI_*``, ``PMI_*``, ``SLURM_STEP_NUM_TASKS`` / ``SLURM_PROCID``,
    ``MXTPU_PROCESS_ID``), then ``WORLD_SIZE`` / ``RANK``; the address
    from ``init_method``, else ``coordinator_address`` /
    ``MXTPU_COORDINATOR`` (``host:port``), else ``MASTER_ADDR`` /
    ``MASTER_PORT``. The rendezvous waits at most ``timeout`` seconds
    (``MXTPU_RENDEZVOUS_TIMEOUT``, 300) and redials ``retries`` times
    (``MXTPU_RENDEZVOUS_RETRIES``, 0) before it raises an `MXNetError`
    that names what failed. On the card, rank r takes ``cuda:<local
    rank>`` (``LOCAL_RANK``, else r modulo the cards). This host's ranks
    are ``LOCAL_WORLD_SIZE``, else the whole group."""
    import torch.distributed as dist

    if num_processes is None:
        num_processes = _env_int(*_SIZE_NAMES) or 1
    if num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if process_id is None:
        process_id = _env_int(*_RANK_NAMES)
    if process_id is None:
        raise MXNetError("init_process_group: a group of %d processes, but "
                         "this process's rank is not set (one of %s)"
                         % (num_processes, ", ".join(_RANK_NAMES)))
    if init_method is None:
        if coordinator_address is None:
            coordinator_address = _env.raw("MXTPU_COORDINATOR")
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = "%s:%s" % (
                os.environ["MASTER_ADDR"],
                os.environ.get("MASTER_PORT", "29500"))
        if coordinator_address is None:
            raise MXNetError("init_process_group: rank %d of %d has no "
                             "coordinator address (MXTPU_COORDINATOR, or "
                             "MASTER_ADDR / MASTER_PORT, or init_method)"
                             % (process_id, num_processes))
        init_method = "tcp://" + coordinator_address
    if timeout is None:
        timeout = _env.get("MXTPU_RENDEZVOUS_TIMEOUT")
    if retries is None:
        retries = _env.get("MXTPU_RENDEZVOUS_RETRIES")
    if backend is None:
        local = _env_int("LOCAL_WORLD_SIZE") or num_processes
        backend = "nccl" if torch.cuda.is_available() \
            and local <= torch.cuda.device_count() else "gloo"
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    backoff = 1.0
    t0 = _time_mod.perf_counter()
    for attempt in range(retries + 1):
        try:
            dist.init_process_group(
                backend, init_method=init_method, world_size=num_processes,
                rank=process_id, timeout=datetime.timedelta(seconds=timeout))
            _telemetry.counter("mxtpu_rendezvous_total",
                               {"outcome": "ok"}).inc()
            _telemetry.record_event(
                "rendezvous_ok", seconds=_time_mod.perf_counter() - t0,
                attempts=attempt + 1, backend=backend)
            return
        except Exception as e:  # the store's timeout, a refused dial
            if attempt >= retries:
                _telemetry.counter("mxtpu_rendezvous_total",
                                   {"outcome": "error"}).inc()
                raise MXNetError(
                    "distributed rendezvous failed (timeout %ds): rank %d "
                    "of %d dialing %s over %s — %s: %s (after %d "
                    "attempt(s)). A peer likely died before the rendezvous "
                    "or never launched; raise MXTPU_RENDEZVOUS_TIMEOUT for "
                    "slow fleets." % (timeout, process_id, num_processes,
                                      init_method, backend,
                                      type(e).__name__, e, attempt + 1)) \
                    from e
            _time_mod.sleep(backoff)
            backoff = min(backoff * 2, 30.0)


def rank():
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def num_workers():
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def barrier():
    """Every rank waits for every other (reference: KVStore::Barrier,
    kvstore.h:364). A no-op in one process."""
    dist = _dist()
    if dist is not None:
        dist.barrier()
