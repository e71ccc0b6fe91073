"""TensorRT integration surface (counterpart of `mxnet_tpu/contrib/
tensorrt.py`; reference: python/mxnet/contrib/tensorrt.py). The port binds
no TensorRT runtime: its deployment path is `predict.Predictor` (an eager
executor over the exported graph, int8 through
`contrib.quantization.quantize_model`). The reference names exist so
ported scripts fail with direction instead of AttributeError; the
use_tensorrt flag is accepted and always reports False."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["set_use_tensorrt", "get_use_tensorrt", "get_optimized_symbol",
           "tensorrt_bind"]

_MSG = ("TensorRT is not part of mxnet_tpu_torch; deploy with "
        "mxnet_tpu_torch.predict.Predictor over the exported graph (int8: "
        "contrib.quantization.quantize_model first)")


def set_use_tensorrt(status):
    """reference: tensorrt.py:30 — accepted for script compatibility;
    enabling it raises (there is no TRT runtime here)."""
    if status:
        raise MXNetError(_MSG)


def get_use_tensorrt():
    """reference: tensorrt.py:40 — always False here."""
    return False


def get_optimized_symbol(executor):
    """reference: tensorrt.py:50."""
    raise MXNetError(_MSG)


def tensorrt_bind(symbol, ctx, all_params, **kwargs):
    """reference: tensorrt.py:76."""
    raise MXNetError(_MSG)
