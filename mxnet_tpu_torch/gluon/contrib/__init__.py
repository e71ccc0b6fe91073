"""Gluon contrib of the port (counterpart of `mxnet_tpu.gluon.contrib`;
reference: python/mxnet/gluon/contrib): ``nn`` (`SyncBatchNorm`,
`Concurrent`, `Identity`, `SparseEmbedding`, `PixelShuffle1D/2D/3D`),
``rnn`` (`VariationalDropoutCell`, `LSTMPCell`, `dynamic_unroll`, the
convolutional cells), ``moe`` (`MoEFFN`) and ``data`` (`IntervalSampler`,
`WikiText2`, `WikiText103`)."""
from . import data, moe, nn, rnn  # noqa: F401

__all__ = ["nn", "rnn", "moe", "data"]
