"""mxnet_tpu_torch: the PyTorch/CUDA port of `mxnet_tpu`, for NVIDIA Hopper.

A package of its own beside the JAX package, which stays the reference it
is held against. It imports `torch` and numpy, never JAX or `mxnet_tpu`.
Module paths mirror the JAX package (``mxnet_tpu/serving/generate.py`` ->
``mxnet_tpu_torch/serving/generate.py``).

Ported so far: generation serving of a `TransformerLM` (paged-KV
continuous batching over HTTP), with decode attention as the CUDA kernel
``csrc/paged_attention.cu``; ResNet v1 training, whose BatchNorms run the
conv-epilogue kernels of ``csrc/conv_epilogue.cu``; and BERT pretraining,
whose attention runs the flash-attention kernels of
``csrc/flash_attention.cu``. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; without a card they raise.
"""
from . import context, env, random, telemetry
from .base import MXNetError
from .context import cpu, gpu

__all__ = ["MXNetError", "cpu", "gpu", "context", "env", "random",
           "telemetry"]
