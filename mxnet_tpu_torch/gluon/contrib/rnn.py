"""Contrib recurrent cells (counterpart of `mxnet_tpu/gluon/contrib/rnn.py`;
reference: python/mxnet/gluon/contrib/rnn): `VariationalDropoutCell` and
`LSTMPCell`, `dynamic_unroll`, and the nine
``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``s, whose input-to-hidden and
hidden-to-hidden products are convolutions (the ``Convolution`` op:
``torch.nn.functional.conv1d`` / ``conv2d`` / ``conv3d``, channel-first;
the JAX package leaves them to XLA). The recurrence unrolls through the
base cells of `gluon.rnn`. Variational masks are drawn once a sequence by
the ``Dropout`` op (``mode="always"``) from this thread's generator for the
data's device; they match the JAX package's in distribution, not bit for
bit (ROADMAP's RNG contract).
"""
from __future__ import annotations

from ... import ndarray as nd
from ...base import MXNetError
from ..rnn.rnn_cell import ModifierCell, RecurrentCell

__all__ = ["VariationalDropoutCell", "LSTMPCell", "dynamic_unroll",
           "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


class VariationalDropoutCell(ModifierCell):
    """The same dropout masks at every step of a sequence (reference:
    contrib/rnn/rnn_cell.py)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _mask(self, p, like):
        return nd.Dropout(nd.ones_like(like), p=p, mode="always")

    def __call__(self, inputs, states):
        if self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask(self.drop_inputs, inputs)
            inputs = inputs * self._input_mask
        if self.drop_states:
            if self._state_mask is None:
                self._state_mask = self._mask(self.drop_states, states[0])
            states = [s * self._state_mask for s in states]
        out, next_states = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask(self.drop_outputs, out)
            out = out * self._output_mask
        return out, next_states


class LSTMPCell(RecurrentCell):
    """LSTM with a projected recurrent state (reference: contrib/rnn/
    rnn_cell.py:198, the LSTMP of arXiv:1402.1128): gates see the
    `projection_size` recurrent vector r instead of the full hidden h, and
    r = h2r(next_h) after every step — cuts h2h FLOPs/params for large
    hidden sizes. States: [r (B, proj), c (B, hidden)]."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = int(hidden_size)
        self._projection_size = int(projection_size)
        with self.name_scope():
            self._param("i2h_weight", shape=(4 * hidden_size, input_size),
                        init=i2h_weight_initializer,
                        allow_deferred_init=True)
            self._param("h2h_weight",
                        shape=(4 * hidden_size, projection_size),
                        init=h2h_weight_initializer)
            self._param("h2r_weight", shape=(projection_size, hidden_size),
                        init=h2r_weight_initializer)
            self._param("i2h_bias", shape=(4 * hidden_size,),
                        init=i2h_bias_initializer)
            self._param("h2h_bias", shape=(4 * hidden_size,),
                        init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def _shape_hook(self, x):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (self.i2h_weight.shape[0], x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        r, c = states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(r, h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        sg = F.split(gates, num_outputs=4, axis=1)
        i = F.sigmoid(sg[0])
        f = F.sigmoid(sg[1])
        g = F.tanh(sg[2])
        o = F.sigmoid(sg[3])
        next_c = f * c + i * g
        next_h = o * F.tanh(next_c)
        next_r = F.FullyConnected(next_h, h2r_weight, None, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]


def dynamic_unroll(cell, inputs, begin_state, drop_inputs=0, drop_outputs=0,
                   layout="TNC", valid_length=None):
    """Unroll `cell` over a sequence whose length is the DATA's time
    dimension (reference: contrib/rnn/rnn_cell.py:326 dynamic_unroll, which
    lowers to while_loop). Accepts merged (T,N,C)/(N,T,C) input, applies
    optional input/output dropout, masks outputs past `valid_length`, and
    returns (outputs merged in `layout`, final states at each sequence's
    valid end)."""
    axis = layout.find("T")
    if axis not in (0, 1):
        raise MXNetError("dynamic_unroll: layout must contain T in "
                         "position 0 or 1, got %r" % layout)
    if drop_inputs:
        inputs = nd.Dropout(inputs, p=drop_inputs,
                            axes=(axis,))  # same mask every step
    length = inputs.shape[axis]
    outputs, states = cell.unroll(length, inputs, begin_state=begin_state,
                                  layout=layout, merge_outputs=True,
                                  valid_length=valid_length)
    if drop_outputs:
        outputs = nd.Dropout(outputs, p=drop_outputs, axes=(axis,))
    return outputs, states


# ---------------------------------------------------------------------------
# Convolutional recurrent cells (reference: contrib/rnn/conv_rnn_cell.py).
# One base handles every spatial rank; subclasses pin rank + recurrence.
# ---------------------------------------------------------------------------

def _tuple(v, n):
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise MXNetError("expected %d values, got %s" % (n, v))
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _BaseConvRNNCell(RecurrentCell):
    """Shared conv-recurrence plumbing: an input conv (geometry from
    `input_shape`, user stride/pad/dilation) plus a 'same'-padded hidden
    conv, both emitting `num_gates * hidden_channels` feature maps."""

    _num_gates = None  # subclass

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None, conv_layout="NCHW"):
        super().__init__(prefix=prefix, params=params)
        dims = len(input_shape) - 1
        if conv_layout != "NC" + "DHW"[3 - dims:]:
            raise MXNetError("only channel-first conv_layout is supported "
                             "(got %r)" % conv_layout)
        self._dims = dims
        self._input_shape = tuple(input_shape)
        self._hc = int(hidden_channels)
        self._activation = activation
        self._i2h_kernel = _tuple(i2h_kernel, dims)
        self._h2h_kernel = _tuple(h2h_kernel, dims)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise MXNetError("h2h_kernel must be odd for 'same' "
                                 "padding, got %s" % (self._h2h_kernel,))
        self._i2h_pad = _tuple(i2h_pad, dims)
        self._i2h_dilate = _tuple(i2h_dilate, dims)
        self._h2h_dilate = _tuple(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for k, d in
                              zip(self._h2h_kernel, self._h2h_dilate))
        in_c = input_shape[0]
        ng = self._num_gates
        with self.name_scope():
            self._param("i2h_weight",
                        shape=(ng * self._hc, in_c) + self._i2h_kernel,
                        init=i2h_weight_initializer)
            self._param("h2h_weight",
                        shape=(ng * self._hc, self._hc) + self._h2h_kernel,
                        init=h2h_weight_initializer)
            self._param("i2h_bias", shape=(ng * self._hc,),
                        init=i2h_bias_initializer)
            self._param("h2h_bias", shape=(ng * self._hc,),
                        init=h2h_bias_initializer)

    def _state_shape(self, batch_size):
        spatial = self._input_shape[1:]
        out = tuple(
            (s + 2 * p - d * (k - 1) - 1) + 1
            for s, p, d, k in zip(spatial, self._i2h_pad, self._i2h_dilate,
                                  self._i2h_kernel))
        return (batch_size, self._hc) + out

    def state_info(self, batch_size=0):
        shape = self._state_shape(batch_size)
        layout = "NC" + "DHW"[3 - self._dims:]
        return [{"shape": shape, "__layout__": layout}
                for _ in range(len(self._state_names))]

    def _convs(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        ng = self._num_gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            dilate=self._i2h_dilate,
                            num_filter=ng * self._hc)
        h2h = F.Convolution(h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate,
                            num_filter=ng * self._hc)
        return i2h, h2h


class _ConvRNNCell(_BaseConvRNNCell):
    """out = act(conv(x) + conv(h)); states: [h]."""

    _num_gates = 1
    _state_names = ("h",)

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        out = self._get_activation(F, i2h + h2h, self._activation)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    """Shi et al. 2015 ConvLSTM; states: [h, c]."""

    _num_gates = 4
    _state_names = ("h", "c")

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        sg = F.split(i2h + h2h, num_outputs=4, axis=1)
        i = F.sigmoid(sg[0])
        f = F.sigmoid(sg[1])
        g = self._get_activation(F, sg[2], self._activation)
        o = F.sigmoid(sg[3])
        next_c = f * states[1] + i * g
        next_h = o * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    """Conv GRU; reset gate modulates the hidden conv's candidate chunk;
    states: [h]."""

    _num_gates = 3
    _state_names = ("h",)

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        ir, iz, inw = F.split(i2h, num_outputs=3, axis=1)
        hr, hz, hnw = F.split(h2h, num_outputs=3, axis=1)
        r = F.sigmoid(ir + hr)
        z = F.sigmoid(iz + hz)
        n = self._get_activation(F, inw + r * hnw, self._activation)
        next_h = (1.0 - z) * n + z * states[0]
        return next_h, [next_h]


def _make_cell(base, dims, name, doc):
    # positional order matches the reference cells exactly
    # (conv_rnn_cell.py Conv1DRNNCell.__init__ et al.), so reference-
    # positional construction binds every argument correctly
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout="NC" + "DHW"[3 - dims:], activation="tanh",
                 prefix=None, params=None):
        if len(input_shape) != dims + 1:
            raise MXNetError("%s expects input_shape (C%s), got %s"
                             % (name, ", " + ", ".join("DHW"[3 - dims:]),
                                input_shape))
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, i2h_pad=i2h_pad, i2h_dilate=i2h_dilate,
                      h2h_dilate=h2h_dilate, activation=activation,
                      i2h_weight_initializer=i2h_weight_initializer,
                      h2h_weight_initializer=h2h_weight_initializer,
                      i2h_bias_initializer=i2h_bias_initializer,
                      h2h_bias_initializer=h2h_bias_initializer,
                      conv_layout=conv_layout, prefix=prefix, params=params)

    return type(name, (base,), {"__init__": __init__, "__doc__": doc})


_DOC = ("%dD %s cell over feature maps (reference: contrib/rnn/"
        "conv_rnn_cell.py %s): recurrence where every dense matmul is a "
        "convolution, preserving spatial structure in the state.")

Conv1DRNNCell = _make_cell(_ConvRNNCell, 1, "Conv1DRNNCell",
                           _DOC % (1, "RNN", "Conv1DRNNCell"))
Conv2DRNNCell = _make_cell(_ConvRNNCell, 2, "Conv2DRNNCell",
                           _DOC % (2, "RNN", "Conv2DRNNCell"))
Conv3DRNNCell = _make_cell(_ConvRNNCell, 3, "Conv3DRNNCell",
                           _DOC % (3, "RNN", "Conv3DRNNCell"))
Conv1DLSTMCell = _make_cell(_ConvLSTMCell, 1, "Conv1DLSTMCell",
                            _DOC % (1, "LSTM", "Conv1DLSTMCell"))
Conv2DLSTMCell = _make_cell(_ConvLSTMCell, 2, "Conv2DLSTMCell",
                            _DOC % (2, "LSTM", "Conv2DLSTMCell"))
Conv3DLSTMCell = _make_cell(_ConvLSTMCell, 3, "Conv3DLSTMCell",
                            _DOC % (3, "LSTM", "Conv3DLSTMCell"))
Conv1DGRUCell = _make_cell(_ConvGRUCell, 1, "Conv1DGRUCell",
                           _DOC % (1, "GRU", "Conv1DGRUCell"))
Conv2DGRUCell = _make_cell(_ConvGRUCell, 2, "Conv2DGRUCell",
                           _DOC % (2, "GRU", "Conv2DGRUCell"))
Conv3DGRUCell = _make_cell(_ConvGRUCell, 3, "Conv3DGRUCell",
                           _DOC % (3, "GRU", "Conv3DGRUCell"))
