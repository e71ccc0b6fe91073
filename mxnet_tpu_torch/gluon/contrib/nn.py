"""Contrib layers (counterpart of `mxnet_tpu/gluon/contrib/nn.py`;
reference: python/mxnet/gluon/contrib/nn/basic_layers.py).

`SyncBatchNorm` is `nn.BatchNorm` over axis 1, as the JAX package's is,
and so it runs the conv-epilogue kernels in training; inside a
`parallel.DistributedTrainer` step whose batch is split over ranks its
statistics are the global batch's (`ops.nn._bn_act`), as under the JAX
package's GSPMD step. `SparseEmbedding` is ``nn.Embedding`` with
``sparse_grad=True``. The pixel shuffles are written with the reshape
codes the JAX package uses, so the same ``hybrid_forward`` runs on
NDArrays, on tensors and on Symbols.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock
from ..nn.basic_layers import BatchNorm, Embedding

__all__ = ["SyncBatchNorm", "Concurrent", "HybridConcurrent", "Identity",
           "SparseEmbedding", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (reference: contrib sync_batch_norm.cc):
    `BatchNorm` over axis 1, whose statistics inside a
    `parallel.DistributedTrainer` step are those of the batch over every
    rank it is split over (``num_devices`` is the reference's and is not
    needed: the mesh names the ranks)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         in_channels=in_channels, **kwargs)


class Concurrent(HybridBlock):
    """Its children applied to the same input, their outputs concatenated
    along ``axis`` (reference: contrib basic_layers Concurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


HybridConcurrent = Concurrent


class Identity(HybridBlock):
    """The input as it is (reference: contrib basic_layers Identity)."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Embedding):
    """An Embedding whose weight gradient is row_sparse (reference: contrib
    basic_layers.py:118): ``nn.Embedding(sparse_grad=True)``."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        if not kwargs.pop("sparse_grad", True):
            raise MXNetError("SparseEmbedding is sparse_grad by definition; "
                             "use nn.Embedding for a dense gradient")
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, **kwargs)


def _pixel_shuffle(F, x, factors, dims):
    """(N, C * prod(f), *S) -> (N, C, *(s_i * f_i)): the factor axes split
    out of the channels, each interleaved after its spatial axis, then
    merged, with the reshape codes 0 (copy), -1 (infer), -4 (split) and -3
    (merge) of the reference (basic_layers.py:292)."""
    if dims == 1:
        (f,) = factors
        x = F.reshape(x, shape=(0, -4, -1, f, 0))         # (N, C, f, W)
        x = F.transpose(x, axes=(0, 1, 3, 2))             # (N, C, W, f)
        return F.reshape(x, shape=(0, 0, -3))             # (N, C, W*f)
    if dims == 2:
        f1, f2 = factors
        x = F.reshape(x, shape=(0, -4, -1, f1 * f2, 0, 0))
        x = F.reshape(x, shape=(0, 0, -4, f1, f2, 0, 0))  # (N,C,f1,f2,H,W)
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))       # (N,C,H,f1,W,f2)
        return F.reshape(x, shape=(0, 0, -3, -3))
    f1, f2, f3 = factors
    x = F.reshape(x, shape=(0, -4, -1, f1 * f2 * f3, 0, 0, 0))
    x = F.reshape(x, shape=(0, 0, -4, f1, f2 * f3, 0, 0, 0))
    x = F.reshape(x, shape=(0, 0, 0, -4, f2, f3, 0, 0, 0))
    x = F.transpose(x, axes=(0, 1, 5, 2, 6, 3, 7, 4))     # interleave
    return F.reshape(x, shape=(0, 0, -3, -3, -3))


def _factors(factor, n):
    f = factor if isinstance(factor, (tuple, list)) else (factor,) * n
    return tuple(int(v) for v in f)


class PixelShuffle1D(HybridBlock):
    """(N, C*f, W) -> (N, C, W*f) (reference: contrib
    basic_layers.py:244)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 1)

    def hybrid_forward(self, F, x):
        return _pixel_shuffle(F, x, self._factors, 1)


class PixelShuffle2D(HybridBlock):
    """(N, C*f1*f2, H, W) -> (N, C, H*f1, W*f2); a scalar or (f1, f2)
    factor (reference: contrib basic_layers.py:292). The channels split as
    (C, f1, f2), not as depth_to_space's (f1, f2, C)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 2)

    def hybrid_forward(self, F, x):
        return _pixel_shuffle(F, x, self._factors, 2)


class PixelShuffle3D(HybridBlock):
    """(N, C*f1*f2*f3, D, H, W) -> (N, C, D*f1, H*f2, W*f3) (reference:
    contrib basic_layers.py:354)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 3)

    def hybrid_forward(self, F, x):
        return _pixel_shuffle(F, x, self._factors, 3)
