"""Gluon contrib of the port (counterpart of `mxnet_tpu.gluon.contrib`;
reference: python/mxnet/gluon/contrib): ``nn`` (`SyncBatchNorm`,
`Concurrent`, `Identity`, `SparseEmbedding`, `PixelShuffle1D/2D/3D`).
The JAX package's ``contrib.rnn``, ``contrib.data`` and ``contrib.moe``
are not ported yet (ROADMAP queue 1 item 6)."""
from . import nn  # noqa: F401

__all__ = ["nn"]
