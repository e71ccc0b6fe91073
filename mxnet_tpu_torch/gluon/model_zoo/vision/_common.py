"""The base of the port's vision nets."""
from __future__ import annotations

from ....base import MXNetError
from ....context import checked_context
from ...nn.basic_layers import _Layer

__all__ = []


def _factory(cls, pretrained, ctx, kwargs):
    """A zoo factory's net: ``cls(**kwargs)`` built for ``ctx`` (the
    reference's argument; ``device`` in ``kwargs`` means the same).
    Pretrained weights are never downloaded."""
    if pretrained:
        raise MXNetError("pretrained weights are not downloaded: load them "
                         "with net.load_parameters(path)")
    if ctx is not None:
        kwargs.setdefault("device", ctx[0] if isinstance(ctx, (list, tuple))
                          else ctx)
    return cls(**kwargs)


class _Net(_Layer):
    """A model-zoo net as a `HybridBlock` built as the JAX package builds
    it, so its prefixes and parameter names are the JAX net's
    (``save_parameters`` / ``load_parameters`` and ``export`` read and
    write the JAX package's files). Its forward runs ``hybrid_forward`` on
    tensors (`_Layer`). ``device``: where `initialize` puts the
    parameters when it is given no ``ctx`` (default: `current_context` at
    that call, as in the JAX package); a parameter of a deferred shape is
    made there at the first forward."""

    def __init__(self, device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._device = checked_context(device)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, seed=None):
        return super().initialize(init, self._device if ctx is None else ctx,
                                  verbose, force_reinit, seed)
