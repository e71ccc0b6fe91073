"""The base of the port's vision nets (the families beside ResNet v1)."""
from __future__ import annotations

from ....context import resolve_device
from ...nn.basic_layers import _Layer

__all__ = []


class _Net(_Layer):
    """A model-zoo net as a `HybridBlock` built as the JAX package builds
    it, so its prefixes and parameter names are the JAX net's
    (``save_parameters`` / ``load_parameters`` and ``export`` read and
    write the JAX package's files). Its forward runs ``hybrid_forward`` on
    tensors (`_Layer`). ``device``: where `initialize` puts the
    parameters when it is given no ``ctx`` (default: the card,
    `context.resolve_device`); a parameter of a deferred shape is made
    there at the first forward."""

    def __init__(self, device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._device = resolve_device(device)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, seed=None):
        return super().initialize(init, self._device if ctx is None else ctx,
                                  verbose, force_reinit, seed)
