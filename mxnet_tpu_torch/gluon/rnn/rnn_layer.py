"""Fused recurrent layers (counterpart of `mxnet_tpu/gluon/rnn/rnn_layer.py`).

`RNN`, `LSTM` and `GRU` as `HybridBlock`s that compute on tensors over
`ops.rnn`. The parameters keep the JAX package's names and shapes: for
layer i and direction ``l`` (left to right) or ``r`` (right to left),
``l0_i2h_weight`` (G*H, in), ``l0_h2h_weight`` (G*H, H), ``l0_i2h_bias``
and ``l0_h2h_bias`` (G*H,). The JAX layer packs them into the flat
cuDNN-layout vector at every forward; this one hands them to `ops.rnn.rnn_layers` as they are (the same
math, no concatenation a step). ``layout`` is "TNC" (sequence-major) or
"NTC"; states are (L * D, B, H). ``input_size`` left at 0 is taken from
the first input (deferred initialisation). Inter-layer dropout runs in
training mode (``autograd.is_training()`` in a call with NDArrays,
``train()`` in one with tensors), from this thread's generator for the
data's device.
"""
from __future__ import annotations

import torch

from ...autograd import layer_training
from ...base import MXNetError
from ...context import current_context, resolve_device
from ...ops import rnn as _rnn
from ..nn.basic_layers import _Layer, _materialize

__all__ = ["RNN", "LSTM", "GRU"]

_FIELDS = ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")


class _RNNLayer(_Layer):
    """A stack of ``num_layers`` fused recurrent layers of ``mode``. The
    ``*_initializer`` arguments are each parameter's own initializer (the
    weights' default is the one `initialize` is given, the biases' zeros).
    ``device``: where the parameters live (default: `current_context`, the
    card unless a `context.scope` says otherwise)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, device=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError("Invalid layout %s; must be TNC or NTC"
                             % (layout,))
        device = current_context() if device is None \
            else resolve_device(device)
        self._hidden_size = int(hidden_size)
        self._num_layers = int(num_layers)
        self._mode = mode
        self._layout = layout
        self._dropout = float(dropout)
        self._dir = 2 if bidirectional else 1
        self._input_size = int(input_size)
        ng, ni, nh = _rnn._gates(mode), self._input_size, self._hidden_size
        inits = (i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer)
        with self.name_scope():
            for i in range(self._num_layers):
                for j in "lr"[:self._dir]:
                    for field, shape, init in zip(
                            _FIELDS, ((ng * nh, ni), (ng * nh, nh),
                                      (ng * nh,), (ng * nh,)), inits):
                        self._param("%s%d_%s" % (j, i, field), device=device,
                                    shape=shape, init=init,
                                    allow_deferred_init=True)
                ni = nh * self._dir

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, device=None,
                    dtype=torch.float32, ctx=None):
        """Initial recurrent states, one for each entry of `state_info`: with
        ``ctx``, NDArrays ``func(shape=, ctx=)`` (default `nd.zeros`), as
        the JAX package's; else tensors ``func(shape, dtype=, device=)``
        (default `torch.zeros`) on the parameters' device unless
        ``device`` is given."""
        if ctx is not None:
            from ... import ndarray as nd

            func = func or nd.zeros
            return [func(shape=info["shape"], ctx=ctx)
                    for info in self.state_info(batch_size)]
        func = func or torch.zeros
        device = device if device is not None \
            else self._reg_params["l0_h2h_weight"].var.device
        return [func(info["shape"], dtype=dtype, device=device)
                for info in self.state_info(batch_size)]

    def _weights(self):
        return [[[self._held("%s%d_%s" % (j, i, f)) for f in _FIELDS]
                 for j in "lr"[:self._dir]]
                for i in range(self._num_layers)]

    def forward(self, inputs, states=None):
        """``inputs`` (T, B, in) or, under NTC, (B, T, in). Returns the
        output (T, B, D * H) (or (B, T, D * H)), and with ``states`` given
        (a tensor or a list of them) also the list of final states."""
        if self._held("l0_i2h_weight") is None:
            self._input_size = inputs.shape[-1]
            first = [self._reg_params["%s0_i2h_weight" % j]
                     for j in "lr"[:self._dir]]
            for p in first:
                p.shape = (p.shape[0], self._input_size)
            _materialize(*first)
        skip_states = states is None
        batch_axis = 1 if self._layout == "TNC" else 0
        if states is None:
            states = self.begin_state(inputs.shape[batch_axis],
                                      device=inputs.device,
                                      dtype=inputs.dtype)
        if isinstance(states, torch.Tensor):
            states = [states]
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        outs = _rnn.rnn_layers(
            inputs, self._weights(), states[0],
            states[1] if self._mode == "lstm" else None, mode=self._mode,
            p=self._dropout, state_outputs=True,
            is_train=layer_training(self))
        out = outs[0]
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        return out if skip_states else (out, list(outs[1:]))


class RNN(_RNNLayer):
    """Vanilla RNN layer (activation "relu" or "tanh")."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, device=None, prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation,
                         device=device, prefix=prefix, params=params)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """LSTM layer: states (h, c)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 device=None, prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", device=device,
                         prefix=prefix, params=params)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """GRU layer."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 device=None, prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", device=device,
                         prefix=prefix, params=params)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
