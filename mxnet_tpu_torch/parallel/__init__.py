"""Training over devices (counterpart of `mxnet_tpu.parallel`; one card
so far)."""
from .trainer import DistributedTrainer

__all__ = ["DistributedTrainer"]
