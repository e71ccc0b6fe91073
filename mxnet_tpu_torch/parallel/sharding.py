"""Parameter and data sharding rules (counterpart of
`mxnet_tpu/parallel/sharding.py`): the rule logic, without the JAX
placement.

A `PartitionSpec` is a tuple with one entry a dimension: the mesh axis it
is split over, or None. `ShardingRules.spec_for` resolves a parameter's
spec in the JAX package's order:

  1. an explicit rule (``rules[name]``, exact or a regex fullmatch);
  2. an MoE expert table (a name holding "expert", dimension 0 divisible by
     ``ep``) over ``ep``;
  3. tensor-parallel heuristics when the mesh has a ``tp`` axis;
  4. fsdp: the largest divisible dimension over ``fsdp``;
  5. replicated.

`parallel.DistributedTrainer` places ``ep`` specs (an expert table's rows
on their rank) and replicated ones; ``tp`` and ``fsdp`` are ROADMAP queue 1
item 11 part 2.
"""
from __future__ import annotations

import re

from .mesh import DP, EP, FSDP, TP

__all__ = ["PartitionSpec", "ShardingRules", "batch_spec", "param_spec"]


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
