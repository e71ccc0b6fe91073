"""mxnet_tpu_torch.module: the symbolic training loop (counterpart of
`mxnet_tpu.module`; reference: python/mxnet/module). `Module` binds a
Symbol to one device and trains it; `BucketingModule` keeps one `Module` a
bucket, all sharing the default bucket's parameters; `SequentialModule`
chains modules; `PythonModule` and `PythonLossModule` are modules written
in Python (a loss head for the chain)."""
from .base_module import BaseModule, BatchEndParam
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "BatchEndParam", "Module", "BucketingModule",
           "SequentialModule", "PythonModule", "PythonLossModule"]
