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
exported or checkpointed graph) behind ``serving``'s dynamic batcher;
and the input path: ``recordio``, ``image`` (PNG decode with numpy and
zlib, JPEG through Pillow where installed, the augmenters and the
threaded ``ImageRecordIterPy``), ``data`` (the prefetch core, the device
prefetcher and sharded record streams), the file iterators of ``io`` and
``gluon.data``; and the op namespaces ``nd.random`` / ``sym.random``
(the random ops, seeded by ``random.seed``), ``nd.linalg``,
``nd.contrib`` (``CTCLoss``, ``flash_attention``, and the control-flow
``foreach`` / ``while_loop`` / ``cond``) behind ``gluon.loss.CTCLoss``;
and ``profiler`` (chrome traces of the ``mx.nd``, executor and autograd
dispatch, torch.profiler traces of the card) and ``contrib`` (int8
``quantization`` over ``torch._int_mm``, ``text``, ``io``,
``svrg_optimization``, the legacy ``autograd``, ``onnx``); and sparse
storage: ``nd.sparse`` (row_sparse and csr arrays, row-sparse gradients,
the lazy updates of SGD, Adam and AdaGrad), ``kv`` (``kvstore``: the
single-process store, with ``gradient_compression``), ``gluon.contrib.nn``
and the DGL graph ops of ``nd.contrib``; and data parallelism the
reference's way: ``Context`` (``cpu(0)`` and ``cpu(1)`` are two
contexts), parameters, ``gluon.Trainer`` and ``Module`` over several
contexts, the ``dist_sync`` kvstore over ``torch.distributed`` with the
server roles (``kvstore_server``), ``executor_manager``, and the
launcher, ``python -m mxnet_tpu_torch.launch``; and training
resilience: ``parallel.resilience`` (crash-consistent, async and per-rank
sharded checkpoints, auto-resume, graceful preemption, fault injection)
behind ``DistributedTrainer``'s checkpoints and ``Module.fit(checkpoint_dir=,
resume=)``; and the rest of the symbolic façade: ``monitor`` (``Monitor``),
``log``, ``viz`` (``visualization``), ``mod.SequentialModule``,
``mod.PythonModule`` / ``PythonLossModule`` and ``model.FeedForward``;
and extension and interchange: ``operator`` (custom operators in Python,
``mx.nd.Custom`` / ``mx.sym.Custom``, run on the inputs' device),
``subgraph`` (partitioning into fused nodes), ``contrib.onnx`` (import and
export over a pure-Python protobuf shim), and the small top-level modules
``engine`` (``wait_all``, the naive engine), ``runtime`` (the feature
list and the bounded device dial), ``registry``, ``test_utils``,
``util``, ``misc``, ``ndarray_doc``, ``symbol_doc`` and ``notebook``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``ctx=mx.cpu()`` for ``nd``) or runs them in a ``with
context.scope(mx.cpu()):`` (or ``with mx.cpu():``) block; without a card
they raise.
"""
import os as _os

from . import context, env, random, telemetry
from . import ndarray
from . import ndarray as nd

# mx.random.<draw>: each mx.nd.random draw under its own name, multinomial
# (sample_multinomial) and shuffle (mx.nd.shuffle)
for _name, _fn in vars(nd.random).items():
    if not _name.startswith(("_", "sample_")):
        setattr(random, _name, _fn)
random.multinomial, random.shuffle = nd.random.sample_multinomial, nd.shuffle
del _name, _fn
from . import rtc
from . import autograd
from . import initializer
from . import initializer as init
from . import lr_scheduler, metric, optimizer
from . import gluon
from . import attribute, name
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import executor, io, model, callback
from . import module
from . import module as mod
from . import rnn
from . import predict
from . import recordio, image, data
from . import profiler
from . import contrib
from . import gradient_compression, kvstore, kvstore_server
from . import kvstore as kv
from . import parallel
from . import executor_manager
from . import log, monitor, visualization
from . import visualization as viz
from . import engine, registry, runtime, util, misc, ndarray_doc, symbol_doc
from . import operator, subgraph, test_utils, notebook
from .attribute import AttrScope
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_gpus, tpu)
from .ndarray import NDArray

__all__ = ["MXNetError", "Context", "cpu", "gpu", "tpu", "cpu_pinned",
           "num_gpus", "current_context", "context", "env",
           "random", "telemetry", "ndarray", "nd", "NDArray", "rtc",
           "autograd", "initializer", "init", "lr_scheduler", "metric",
           "optimizer", "gluon", "attribute", "name", "AttrScope", "symbol",
           "sym", "Symbol", "executor", "io", "model", "callback", "module", "mod",
           "rnn", "predict", "recordio", "image", "data", "profiler",
           "contrib", "kvstore", "kv", "kvstore_server",
           "gradient_compression", "parallel", "executor_manager", "log",
           "monitor", "visualization", "viz", "engine", "registry",
           "runtime", "util", "misc", "ndarray_doc", "symbol_doc",
           "operator", "subgraph", "test_utils", "notebook"]

# a process with telemetry output (MXTPU_TELEMETRY_DIR, as a launched
# job has) gets the flight recorder's SIGUSR1 dump handler at import, so a
# hang before the first step (rendezvous, the first kernel build) leaves
# a dump behind the launcher's SIGUSR1-then-SIGTERM teardown
if env.is_set("MXTPU_TELEMETRY_DIR"):
    telemetry.install_signal_handler()

if _os.environ.get("DMLC_ROLE") in ("server", "scheduler"):
    # a reference launch script's server and scheduler processes exit
    # here, as the reference's import runs the server loop, so the
    # workers' group keeps its size
    kvstore_server._maybe_exit_non_worker()
