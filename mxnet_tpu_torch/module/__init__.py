"""mxnet_tpu_torch.module: the symbolic training loop (counterpart of
`mxnet_tpu.module`; reference: python/mxnet/module). `Module` binds a
Symbol to one device and trains it; `BucketingModule` keeps one `Module` a
bucket, all sharing the default bucket's parameters. ``PythonModule`` and
``SequentialModule`` are not ported yet (ROADMAP queue 1 item 8)."""
from .base_module import BaseModule, BatchEndParam
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "BatchEndParam", "Module", "BucketingModule"]
