"""mxnet_tpu_torch.parallel — training over devices (counterpart of
`mxnet_tpu.parallel`), one process a device over `torch.distributed`:

  mesh        — named-axis meshes over the process group's ranks
                (dp/fsdp/tp/pp/sp/ep) and `devices()`, the counterpart of
                ``jax.devices()``
  sharding    — parameter / data PartitionSpec rules
  collectives — the in-graph collectives over one mesh axis, the eager
                reduce, and the rendezvous (NCCL on the card, gloo on the
                host)
  trainer     — DistributedTrainer over a dp x ep mesh
  (expert parallelism: gluon.contrib.moe.MoEFFN + the `ep` sharding rule)

The JAX package's ShardedTrainer, ring attention, the pipeline trainer,
resilience and tp / fsdp / pp / sp are ROADMAP queue 1 item 11 part 2.
"""
from .mesh import (make_mesh, default_mesh, current_mesh, use_mesh,
                   local_devices, devices, mesh_fingerprint, Mesh, Device,
                   DP, FSDP, TP, PP, SP, EP)
from .sharding import PartitionSpec, ShardingRules, batch_spec, param_spec
from . import collectives
from .collectives import (init_process_group, rank, num_workers, barrier,
                          all_reduce_arrays)
from .trainer import DistributedTrainer

__all__ = [
    "make_mesh", "default_mesh", "current_mesh", "use_mesh", "local_devices",
    "devices", "mesh_fingerprint", "Mesh", "Device",
    "DP", "FSDP", "TP", "PP", "SP", "EP",
    "PartitionSpec", "ShardingRules", "batch_spec", "param_spec",
    "collectives", "init_process_group", "rank", "num_workers", "barrier",
    "all_reduce_arrays", "DistributedTrainer",
]
