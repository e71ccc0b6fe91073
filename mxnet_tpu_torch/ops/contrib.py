"""Contrib ops (counterpart of `mxnet_tpu/ops/contrib.py`): flash attention
so far; the detection ops are not ported yet."""
from __future__ import annotations

from . import pallas_kernels

__all__ = ["flash_attention"]


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Flash attention over (..., L, D) inputs (`_contrib_flash_attention`):
    `pallas_kernels.flash_attention`, whose three CUDA kernels run for CUDA
    tensors."""
    return pallas_kernels.flash_attention(q, k, v, causal=causal,
                                          sm_scale=sm_scale)
