"""Recurrent cells and their explicit unroll (counterpart of
`mxnet_tpu/gluon/rnn/rnn_cell.py`; reference:
python/mxnet/gluon/rnn/rnn_cell.py).

A cell is a `HybridBlock` stepped as ``cell(inputs, states) -> (output,
new_states)`` on NDArrays (or tensors, which a trainer's call hands it) and
unrolled over a sequence by `unroll` (layouts "NTC" and "TNC", merged or
per-step outputs, ``valid_length`` masking). Its step is the JAX cell's,
op for op, through the port's `nd` (`FullyConnected`, `split`,
`sigmoid`, ...), so recording it with `autograd.record` differentiates it
as the tape does any op. The parameters are the JAX package's:
``i2h_weight`` (G*H, in), ``h2h_weight`` (G*H, H), ``i2h_bias`` and
``h2h_bias`` (G*H,), gates in the order i, f, g, o (LSTM) and r, z, n
(GRU), as the fused `gluon.rnn.LSTM` / `GRU` hold them a layer, so a
stack of cells and a fused layer share weights
(`convert.fused_rnn_params_from_cells`). ``input_size`` left at 0 is taken
from the first input (deferred initialisation).

`DropoutCell` and `ZoneoutCell` draw their masks with the ``Dropout`` op,
from this thread's generator for the data's device (`mx.random.seed`), in
training mode only (``autograd.is_training()``); their masks are not the
JAX package's bits (threefry against Philox), only their distribution.
`hybridize` records its flags and the step stays eager, as every port
block's does (the captured graph is ROADMAP queue 1 item 2).
"""
from __future__ import annotations

from ... import ndarray as nd
from ...base import MXNetError
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _format_sequence(length, inputs, layout, merge):
    """``inputs`` as a list of (N, C) steps (``merge`` False) or one merged
    array (``merge`` True), with the time axis and the batch size
    (reference: rnn_cell.py:46 _format_sequence)."""
    batch_axis = layout.find("N")
    axis = layout.find("T")
    if isinstance(inputs, NDArray):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            inputs = [x.squeeze(axis=axis) for x in _as_list(
                nd.split(inputs, num_outputs=inputs.shape[axis], axis=axis,
                         squeeze_axis=False))]
    else:
        batch_size = inputs[0].shape[0]
        if merge is True:
            inputs = nd.stack(*inputs, axis=axis)
    return inputs, axis, batch_size


class RecurrentCell(HybridBlock):
    """Base recurrent cell (reference: rnn_cell.py:120): `begin_state`,
    `unroll`, `reset`; a subclass gives `state_info` and
    ``hybrid_forward(F, inputs, states, **params)``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters before another sequence."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states, one a `state_info` entry: ``func(shape=...,
        **kwargs)`` (default `nd.zeros`; pass ``ctx=`` and ``dtype=``)."""
        assert not self._modified, \
            "a modified cell's begin_state is its modifier's"
        states = []
        func = func or nd.zeros
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            info.pop("__layout__", None)
            states.append(func(**dict(info, **kwargs)))
        return states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        if isinstance(inputs, NDArray):
            self._shape_hook(inputs)
        return super().forward(inputs, states)

    def _shape_hook(self, x):
        """Fill a deferred input width from the first input."""

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell ``length`` times over ``inputs`` (an array in
        ``layout``, or a list of (N, C) steps): returns (outputs, states),
        outputs merged into one array unless ``merge_outputs`` is False.
        With ``valid_length`` (N,) the outputs past each sequence's end are
        zero and the states are those at its last valid step."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=inputs[0].context,
                                           dtype=inputs[0].dtype)
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      valid_length, use_sequence_length=True,
                                      axis=0)
                      for ele_list in zip(*all_states)]
            merged = nd.SequenceMask(nd.stack(*outputs, axis=0),
                                     valid_length, use_sequence_length=True,
                                     axis=0)
            if merge_outputs is False:
                outputs = [o.squeeze(axis=0) for o in _as_list(
                    nd.split(merged, num_outputs=length, axis=0))]
            else:
                outputs = merged.swapaxes(0, 1) if layout == "NTC" \
                    else merged
            return outputs, states
        if merge_outputs is None or merge_outputs is True:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


HybridRecurrentCell = RecurrentCell


class _GatedCell(RecurrentCell):
    """A cell with the four parameters of ``gates`` x ``hidden_size``
    rows."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = int(hidden_size)
        self._input_size = int(input_size)
        rows = self._gates * self._hidden_size
        with self.name_scope():
            for name, shape, init in (
                    ("i2h_weight", (rows, self._input_size),
                     i2h_weight_initializer),
                    ("h2h_weight", (rows, self._hidden_size),
                     h2h_weight_initializer),
                    ("i2h_bias", (rows,), i2h_bias_initializer),
                    ("h2h_bias", (rows,), h2h_bias_initializer)):
                self._param(name, shape=shape, init=init,
                            allow_deferred_init=True)

    def _shape_hook(self, x):
        w = self.i2h_weight
        if w.shape and w.shape[1] == 0:
            w.shape = (w.shape[0], x.shape[-1])

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        n = self._gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))


class RNNCell(_GatedCell):
    """Elman cell: ``act(W x + b + U h + c)`` (reference: rnn_cell.py
    RNNCell); states [h]."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell, gates i, f, g, o (reference: rnn_cell.py LSTMCell);
    states [h, c]."""

    _gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        gates = F.split(i2h + h2h, num_outputs=4, axis=1)
        in_gate = F.sigmoid(gates[0])
        forget_gate = F.sigmoid(gates[1])
        in_transform = F.tanh(gates[2])
        out_gate = F.sigmoid(gates[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell, gates r, z, n (reference: rnn_cell.py GRUCell); states
    [h]."""

    _gates = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h, h2h = self._projections(F, inputs, prev_h, i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h + reset_gate * h2h)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells applied in order, a step at a time (reference: rnn_cell.py
    SequentialRNNCell); the states are the cells' in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return sum([c.state_info(batch_size)
                    for c in self._children.values()], [])

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return sum([c.begin_state(batch_size, **kwargs)
                    for c in self._children.values()], [])

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class DropoutCell(RecurrentCell):
    """Dropout of the inputs at each step, in training mode; no state
    (reference: rnn_cell.py DropoutCell)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(RecurrentCell):
    """Base of the cells that wrap another cell (reference: rnn_cell.py
    ModifierCell): the base cell's states and parameters are its own."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "the cell %s is modified already" % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout (reference: rnn_cell.py ZoneoutCell): in training mode each
    output and state unit keeps its previous value with probability
    ``zoneout_outputs`` / ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def __call__(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def mask(p, like):
            return nd.Dropout(nd.ones_like(like), p=p)

        prev_output = self._prev_output if self._prev_output is not None \
            else nd.zeros_like(next_output)
        output = nd.where(mask(self.zoneout_outputs, next_output),
                          next_output, prev_output) \
            if self.zoneout_outputs > 0.0 else next_output
        new_states = [nd.where(mask(self.zoneout_states, new_s), new_s,
                               old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if self.zoneout_states > 0.0 else next_states
        self._prev_output = output
        return output, new_states

    def reset(self):
        super().reset()
        self._prev_output = None


class ResidualCell(ModifierCell):
    """The base cell's output plus its input (reference: rnn_cell.py
    ResidualCell)."""

    def _alias(self):
        return "residual"

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """A left-to-right and a right-to-left cell over the sequence, outputs
    concatenated on the feature axis (reference: rnn_cell.py
    BidirectionalCell); only `unroll` steps it."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll()")

    def state_info(self, batch_size=0):
        return sum([c.state_info(batch_size)
                    for c in self._children.values()], [])

    def begin_state(self, batch_size=0, **kwargs):
        return sum([c.begin_state(batch_size, **kwargs)
                    for c in self._children.values()], [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=inputs[0].context,
                                           dtype=inputs[0].dtype)
        l_cell, r_cell = self._children["l_cell"], self._children["r_cell"]
        n_l = len(l_cell.state_info(batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, inputs, begin_state[:n_l], layout, merge_outputs=False,
            valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, list(reversed(inputs)), begin_state[n_l:], layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs = list(reversed(r_outputs))
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs is None or merge_outputs is True:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
