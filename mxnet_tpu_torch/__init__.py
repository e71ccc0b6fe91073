"""mxnet_tpu_torch: the PyTorch/CUDA port of `mxnet_tpu`, for NVIDIA Hopper.

A package of its own beside the JAX package, which stays the reference it
is held against. It imports `torch` and numpy, never JAX or `mxnet_tpu`.
Module paths mirror the JAX package (``mxnet_tpu/serving/generate.py`` ->
``mxnet_tpu_torch/serving/generate.py``).

Ported so far: generation serving of a `TransformerLM` (paged-KV
continuous batching over HTTP), with decode attention as the CUDA kernel
``csrc/paged_attention.cu``; ResNet v1 training, whose BatchNorms run the
conv-epilogue kernels of ``csrc/conv_epilogue.cu``; BERT pretraining,
whose attention runs the flash-attention kernels of
``csrc/flash_attention.cu``; word-LM training and evaluation, whose LSTM
layers run the kernels of ``csrc/lstm.cu``; and the array core: ``nd``
(`NDArray` over a torch tensor, written in place, and every op of the JAX
package's ``ops/tensor.py`` plus ``softmax`` / ``log_softmax``) with
``rtc`` (CUDA C++ compiled at run time by NVRTC and launched on NDArrays);
and the imperative Gluon training path: ``autograd`` (the tape over
torch.autograd), ``gluon`` (``Parameter``, ``Block``, ``HybridBlock``,
``Trainer``, the layers, losses and utilities), ``optimizer``,
``lr_scheduler``, ``init`` (``initializer``) and ``metric``; and the
symbolic training path: ``sym`` (``symbol``: the graph, its shape
inference and JSON), ``executor``, ``mod`` (``module``: ``Module`` and
``BucketingModule``), ``io``, ``rnn`` (the symbolic cells, ``FusedRNNCell``
over the ``RNN`` op, and ``BucketSentenceIter``), ``model`` and
``callback``; and predict serving: ``predict`` (``Predictor`` over an
exported or checkpointed graph) behind ``serving``'s dynamic batcher.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``ctx=mx.cpu()`` for ``nd``); without a card they raise.
"""
from . import context, env, random, telemetry
from . import ndarray
from . import ndarray as nd
from . import rtc
from . import autograd
from . import initializer
from . import initializer as init
from . import lr_scheduler, metric, optimizer
from . import gluon
from . import attribute, name
from . import symbol
from . import symbol as sym
from . import executor, io, model, callback
from . import module
from . import module as mod
from . import rnn
from . import predict
from .attribute import AttrScope
from .base import MXNetError
from .context import cpu, current_context, gpu
from .ndarray import NDArray

__all__ = ["MXNetError", "cpu", "gpu", "current_context", "context", "env",
           "random", "telemetry", "ndarray", "nd", "NDArray", "rtc",
           "autograd", "initializer", "init", "lr_scheduler", "metric",
           "optimizer", "gluon", "attribute", "name", "AttrScope", "symbol",
           "sym", "executor", "io", "model", "callback", "module", "mod",
           "rnn", "predict"]
