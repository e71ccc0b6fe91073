"""Gluon data API (counterpart of `mxnet_tpu.gluon.data`; reference:
python/mxnet/gluon/data)."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset  # noqa: F401
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler  # noqa: F401
from .dataloader import DataLoader  # noqa: F401
from . import vision  # noqa: F401
