"""General utilities (counterpart of `mxnet_tpu/util.py`; reference:
python/mxnet/util.py). The card counts and memory come from `torch.cuda`."""
from __future__ import annotations

import os

__all__ = ["makedirs", "get_gpu_count", "get_gpu_memory"]


def makedirs(d):
    """reference: util.py makedirs (exist_ok)."""
    os.makedirs(d, exist_ok=True)


def get_gpu_count():
    """Number of CUDA cards visible (reference: util.py get_gpu_count ->
    MXGetGPUCount); 0 without a card."""
    from .context import num_gpus

    return num_gpus()


def get_gpu_memory(dev_id=0):
    """(free, total) bytes of card ``dev_id`` (reference: util.py
    get_gpu_memory -> MXGetGPUMemoryInformation64); raises without a
    card."""
    from .context import gpu_memory_info

    return gpu_memory_info(dev_id)
