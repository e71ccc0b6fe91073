"""Parameter and data sharding (counterpart of
`mxnet_tpu/parallel/sharding.py`): the rules, and the placement that the
JAX package leaves to ``jax.device_put`` and GSPMD.

A `PartitionSpec` is a tuple with one entry a dimension: the mesh axis it
is split over, or None. `ShardingRules.spec_for` resolves a parameter's
spec in the JAX package's order:

  1. an explicit rule (``rules[name]``, exact or a regex fullmatch);
  2. an MoE expert table (a name holding "expert", dimension 0 divisible by
     ``ep``) over ``ep``;
  3. tensor-parallel heuristics when the mesh has a ``tp`` axis;
  4. fsdp: the largest divisible dimension over ``fsdp``;
  5. replicated.

One process holds one device, so a placed tensor is this rank's block of
the logical array: `shard_array` cuts it (each split dimension narrowed to
the rank's coordinate on its axis), `gather_array` puts the blocks back
together, and `unshard` does that inside an autograd graph, with the
conjugate each axis needs (`parallel.DistributedTrainer` holds a
``tp`` / ``fsdp`` parameter and its optimizer states as the rank's block,
and gathers the block in its forward).
"""
from __future__ import annotations

import re

import torch

from ..base import MXNetError
from . import collectives as _coll
from .mesh import DATA, DP, EP, FSDP, TP

__all__ = ["PartitionSpec", "ShardingRules", "NamedSharding",
           "named_sharding", "shard_array", "gather_array", "unshard",
           "batch_spec", "param_spec", "constraint"]


class PartitionSpec(tuple):
    """The mesh axis of each dimension (None: not split), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


class ShardingRules:
    """Maps parameter name → `PartitionSpec` over a given mesh.

    ``rules`` — ordered {pattern: spec-template} where pattern is a regex
    fullmatched against the parameter name and spec-template is a tuple of
    axis names / None / tuples, or the string "auto"."""

    def __init__(self, rules=None, fsdp_min_size=2 ** 10):
        self.rules = dict(rules or {})
        self.fsdp_min_size = fsdp_min_size

    def spec_for(self, name, shape, mesh):
        axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        for pat, spec in self.rules.items():
            if pat == name or re.fullmatch(pat, name):
                if spec == "auto":
                    break
                return PartitionSpec(*spec)
        shape = tuple(shape or ())
        if not shape:
            return PartitionSpec()
        parts = [None] * len(shape)
        if axis_sizes.get(EP, 1) > 1 and "expert" in name \
                and shape[0] % axis_sizes[EP] == 0:
            parts[0] = EP
        if axis_sizes.get(TP, 1) > 1 and parts[0] is None:
            if shape[0] % axis_sizes[TP] == 0 and shape[0] >= axis_sizes[TP]:
                parts[0] = TP
        if axis_sizes.get(FSDP, 1) > 1:
            size = 1
            for s in shape:
                size *= s
            if size >= self.fsdp_min_size:
                order = sorted(range(len(shape)), key=lambda i: -shape[i])
                for i in order:
                    if parts[i] is None and shape[i] % axis_sizes[FSDP] == 0:
                        parts[i] = FSDP
                        break
        while parts and parts[-1] is None:
            parts.pop()
        return PartitionSpec(*parts)


def param_spec(name, shape, mesh, rules=None):
    return (rules or ShardingRules()).spec_for(name, shape, mesh)


def batch_spec(mesh, ndim=None, axes=(DP, FSDP)):
    """`PartitionSpec` of a batch-leading array: the batch dimension over
    the data axes of the mesh with more than one device."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    present = [a for a in axes if sizes.get(a, 1) > 1]
    first = tuple(present) if len(present) > 1 else (
        present[0] if present else None)
    if ndim is None:
        return PartitionSpec(first)
    return PartitionSpec(*([first] + [None] * (ndim - 1)))


class NamedSharding:
    """A `PartitionSpec` over a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def named_sharding(mesh, spec):
    return NamedSharding(mesh, spec)


def _entry_axis(mesh, entry):
    """The `_Axis` of one spec entry: an axis name or a tuple of names."""
    return mesh.axis(entry if isinstance(entry, str) else tuple(entry))


def _coordinate(mesh, entry):
    """(index, size) of this rank along a spec entry, a tuple of names in
    its row-major order."""
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    index, size = 0, 1
    for n in names:
        ax = mesh.axis(n)
        index, size = index * ax.size + ax.index, size * ax.size
    return index, size


def shard_array(x, mesh, spec):
    """This rank's block of the full tensor ``x`` under ``spec`` over
    ``mesh`` (a view: each split dimension narrowed to the rank's
    part)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        index, size = _coordinate(mesh, entry)
        if x.shape[dim] % size:
            raise MXNetError("shard_array: dimension %d of size %d does not "
                             "split over %s=%d"
                             % (dim, x.shape[dim], entry, size))
        n = x.shape[dim] // size
        x = x.narrow(dim, index * n, n)
    return x


def gather_array(x, mesh, spec):
    """The full tensor from every rank's block ``x`` under ``spec`` (one
    all-gather a split dimension; no gradient)."""
    with torch.no_grad():
        for dim, entry in enumerate(spec):
            if entry is not None:
                x = torch.cat(_coll._gather(x.contiguous(),
                                            _entry_axis(mesh, entry)),
                              dim=dim)
    return x


class _Unshard(torch.autograd.Function):
    """All-gather along ``dim`` over ``ax``. Its conjugate: where the ranks
    of the axis hold different rows of the batch (``summed``: fsdp), the
    gradient summed over the axis in rank order, in f32, then the rank's
    block; where they compute the same thing on the same rows (tp), the
    rank's own block of its gradient, which every rank of the axis holds
    whole (summing it would count it once a rank)."""

    @staticmethod
    def forward(ctx, x, ax, dim, summed):
        ctx.ax, ctx.dim, ctx.summed = ax, dim, summed
        return torch.cat(_coll._gather(x.contiguous(), ax), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _coll._sum(g.float(), ctx.ax).to(g.dtype)
        return (_coll._scatter_slice(g, ctx.ax, ctx.dim).contiguous(), None,
                None, None)


def unshard(x, mesh, spec, axes=(TP, FSDP)):
    """The full tensor, in the autograd graph, from this rank's block ``x``
    under ``spec``: the dimensions split over ``axes`` are gathered (a
    dimension over another axis, such as an expert table's ``ep`` rows, is
    kept as the rank's block). The gradient of a dimension split over a
    data axis (dp, fsdp) is summed over it, that of another axis is the
    rank's block (`_Unshard`)."""
    for dim, entry in enumerate(spec):
        if entry is None or entry not in axes:
            continue
        ax = _entry_axis(mesh, entry)
        if ax.size > 1:
            x = _Unshard.apply(x, ax, dim, entry in DATA)
    return x


def constraint(x, spec, mesh=None):
    """``x`` laid out as ``spec``: each rank already holds the block its
    computation made, so the values pass unchanged (the JAX package's
    in-graph annotation changes only the layout)."""
    del spec, mesh
    return x
