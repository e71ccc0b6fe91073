"""Gluon contrib of the port (counterpart of `mxnet_tpu.gluon.contrib`;
reference: python/mxnet/gluon/contrib): ``nn`` (`SyncBatchNorm`,
`Concurrent`, `Identity`, `SparseEmbedding`, `PixelShuffle1D/2D/3D`) and
``moe`` (`MoEFFN`). The JAX package's ``contrib.rnn`` and ``contrib.data``
are not ported yet (ROADMAP queue 1 item 6)."""
from . import moe, nn  # noqa: F401

__all__ = ["nn", "moe"]
