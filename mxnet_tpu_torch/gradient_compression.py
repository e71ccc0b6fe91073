"""2-bit gradient compression with error feedback (counterpart of
`mxnet_tpu/gradient_compression.py`; reference:
src/kvstore/gradient_compression.h:52, the threshold quantize of :111-134,
and docs/faq/gradient_compression.md).

Each element of a gradient, plus what its key's residual holds, is sent as
one of {-threshold, 0, +threshold}: +threshold from threshold up,
-threshold from -threshold down, 0 between. What was not sent stays in
the residual and joins the next gradient (error feedback). The quantize
is elementwise torch on the gradient's device, so the card and the CPU
give the same bits.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["GradientCompression"]


class GradientCompression:
    """The '2bit' scheme with a residual a key (reference:
    gradient_compression.h:52, kvstore set_gradient_compression)."""

    def __init__(self, type="2bit", threshold=0.5):
        if type != "2bit":
            raise MXNetError("only '2bit' compression is supported "
                             "(as in the reference's kvstore)")
        if threshold <= 0:
            raise MXNetError("threshold must be > 0")
        self.type = type
        self.threshold = float(threshold)
        self._residual = {}  # key -> tensor

    def get_params(self):
        return {"type": self.type, "threshold": self.threshold}

    def reset(self, key=None):
        """Drop the residuals of ``key`` (on every device), or all of them
        when ``key`` is None; a kvstore key that is (re)initialized starts
        clean."""
        if key is None:
            self._residual.clear()
            return
        for rk in [rk for rk in self._residual
                   if rk == key or (isinstance(rk, tuple) and rk
                                    and rk[0] == key)]:
            del self._residual[rk]

    def quantize(self, key, grad):
        """``grad`` (an NDArray) as the ternary array sent for ``key``; the
        unsent remainder goes to the key's residual (reference:
        Quantize2BitKernelAll, gradient_compression.cc)."""
        from .ndarray.ndarray import NDArray

        g = grad._data.detach()
        res = self._residual.get(key)
        if res is not None:
            g = g + res
        t = self.threshold
        q = torch.where(g >= t, t, torch.where(g <= -t, -t, 0.0)).to(g.dtype)
        self._residual[key] = g - q
        return NDArray(q)

    def dequantize(self, compressed):
        """The values as they are: this in-memory form is already what the
        reference's 2-bit wire codes decode to."""
        return compressed
