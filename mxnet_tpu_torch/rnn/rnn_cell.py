"""Symbolic RNN cells (counterpart of `mxnet_tpu/rnn/rnn_cell.py`;
reference: python/mxnet/rnn/rnn_cell.py).

Cell and parameter naming (i2h / h2h weights and biases, gate order i, f,
c, o for the LSTM and r, z, n for the GRU) is the reference's, so
checkpoints cross. A cell unrolls its recurrence into the graph; each
bucket length is its own graph over shared weights, which is what
`BucketingModule` binds. `FusedRNNCell` unrolls into one ``RNN`` op, whose
LSTM layers run the LSTM kernels on the card.

As in the JAX package, `begin_state`'s default zero state is a
``_rnn_state_zeros`` (``_rnn_fused_state_zeros``) node whose batch size
comes from the unroll input, so it needs `unroll`; ``func=symbol.var``
feeds the states as graph inputs instead. Not ported yet (ROADMAP queue 1
item 9): ``DropoutCell``, ``ModifierCell``, ``ZoneoutCell``,
``ResidualCell`` and ``BidirectionalCell``, so `FusedRNNCell.unfuse` of a
bidirectional cell or one with dropout raises.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .. import symbol

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell"]


def _cells_state_info(cells):
    return sum([c.state_info for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Split a merged (N,T,C)/(T,N,C) symbol into per-step symbols, or
    merge a step list back — the reference's input/output plumbing."""
    assert inputs is not None
    axis = layout.find("T")
    if isinstance(inputs, symbol.Symbol):
        in_axis = (in_layout or layout).find("T")
        if merge is False:
            steps = list(symbol.SliceChannel(inputs, num_outputs=length,
                                             axis=in_axis,
                                             squeeze_axis=True))
            return steps, axis
        if in_axis != axis:
            perm = [0, 1, 2]
            perm[in_axis], perm[axis] = perm[axis], perm[in_axis]
            inputs = symbol.transpose(inputs, axes=tuple(perm))
        return inputs, axis
    # list of (N, C) step symbols: merged ONLY when merge is True —
    # merge=None (the default) keeps the per-step list, the reference's
    # `outputs[-1]` last-hidden idiom depends on it
    if merge is True:
        steps = [symbol.expand_dims(s, axis=axis) for s in inputs]
        return symbol.Concat(*steps, dim=axis), axis
    return list(inputs), axis


class RNNParams(object):
    """Container for cell weights (reference: rnn_cell.py:78) — shared
    between cells by passing the same instance."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.var(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract symbolic RNN cell (reference: rnn_cell.py:108)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self._begin_ref = None   # data symbol the zero state derives from
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in getattr(self, "_cells", ()):
            cell.reset()

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [e["shape"] for e in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Initial states. Default: zero states whose batch dimension is
        derived from the unroll input (see module docstring); pass
        func=symbol.var to feed states as graph inputs instead."""
        assert not self._modified, (
            "After applying modifier cells the base cell cannot be called "
            "directly. Call the modifier cell instead.")
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is not None and func is not symbol.zeros:
                if func in (symbol.var, symbol.Variable):
                    states.append(func(name))
                else:
                    states.append(func(name=name, **dict(kwargs, **info)))
                continue
            ref = kwargs.get("_ref", self._begin_ref)
            if ref is None:
                raise MXNetError(
                    "begin_state(): default zero states need the unroll "
                    "input to derive the batch dimension — call unroll(), "
                    "or pass func=symbol.var to feed states explicitly")
            tail = tuple(info["shape"][1:])
            states.append(symbol._rnn_state_zeros(ref, state_shape=tail,
                                                  name=name))
        return states

    def unpack_weights(self, args):
        """Split fused i2h/h2h matrices into per-gate entries
        (reference: rnn_cell.py:225)."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            w = args.pop("%s%s_weight" % (self._prefix, group))
            b = args.pop("%s%s_bias" % (self._prefix, group))
            for j, gate in enumerate(self._gate_names):
                args["%s%s%s_weight" % (self._prefix, group, gate)] = \
                    w[j * h:(j + 1) * h].copy()
                args["%s%s%s_bias" % (self._prefix, group, gate)] = \
                    b[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights (reference: rnn_cell.py:265)."""
        from .. import ndarray as nd

        args = args.copy()
        if not self._gate_names:
            return args
        for group in ("i2h", "h2h"):
            ws, bs = [], []
            for gate in self._gate_names:
                ws.append(args.pop("%s%s%s_weight"
                                   % (self._prefix, group, gate)))
                bs.append(args.pop("%s%s%s_bias"
                                   % (self._prefix, group, gate)))
            args["%s%s_weight" % (self._prefix, group)] = nd.concat(
                *ws, dim=0) if len(ws) > 1 else ws[0]
            args["%s%s_bias" % (self._prefix, group)] = nd.concat(
                *bs, dim=0) if len(bs) > 1 else bs[0]
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll across `length` steps (reference: rnn_cell.py:296)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        self._set_begin_ref(inputs[0])
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _set_begin_ref(self, ref, batch_axis=0):
        self._begin_ref = ref
        self._begin_axis = batch_axis
        for cell in getattr(self, "_cells", ()):
            cell._set_begin_ref(ref, batch_axis)
        base = getattr(self, "base_cell", None)
        if base is not None:
            base._set_begin_ref(ref, batch_axis)

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell: act(W_i x + W_h h) (reference: rnn_cell.py:362)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference: rnn_cell.py:408; gate order i, f, c, o —
    the cuDNN/fused layout, matching ops/rnn.py)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        from .. import initializer as init

        self._iB = self.params.get(
            "i2h_bias", init=init.LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = list(symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                         name="%sslice" % name))
        in_gate = symbol.Activation(gates[0], act_type="sigmoid")
        forget_gate = symbol.Activation(gates[1], act_type="sigmoid")
        in_transform = symbol.Activation(gates[2], act_type="tanh")
        out_gate = symbol.Activation(gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, cuDNN formulation (reference: rnn_cell.py:469; gate
    order r, z, n matching ops/rnn.py)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%s_i2h" % name)
        h2h = symbol.FullyConnected(data=prev_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%s_h2h" % name)
        i2h_r, i2h_z, i2h_n = list(symbol.SliceChannel(
            i2h, num_outputs=3, name="%s_i2h_slice" % name))
        h2h_r, h2h_z, h2h_n = list(symbol.SliceChannel(
            h2h, num_outputs=3, name="%s_h2h_slice" % name))
        reset = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h_n + reset * h2h_n,
                                       act_type="tanh")
        next_h = (1.0 - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN over the ``RNN`` op (reference:
    rnn_cell.py:536, which wraps cuDNN; here the op of ``ops/rnn.py``, whose
    LSTM layers run the LSTM kernels on the card): one packed parameter
    vector, TNC compute layout."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        from .. import initializer as init

        self._parameter = self.params.get(
            "parameters",
            init=init.FusedRNN(None, num_hidden, num_layers, mode,
                               bidirectional, forget_bias))
        self._directions = 2 if bidirectional else 1

    @property
    def state_info(self):
        b = self._num_layers * self._directions
        info = [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append({"shape": (b, 0, self._num_hidden),
                         "__layout__": "LNC"})
        return info

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped — use unroll() "
                         "(reference behavior)")

    def begin_state(self, func=None, **kwargs):
        if func is not None:
            return super().begin_state(func=func, **kwargs)
        ref = self._begin_ref
        if ref is None:
            raise MXNetError("FusedRNNCell.begin_state needs unroll() "
                             "(batch derives from the data symbol)")
        n = self._num_layers * self._directions
        axis = getattr(self, "_begin_axis", 1)
        states = [symbol._rnn_fused_state_zeros(
            ref, num_directions_layers=n, state_size=self._num_hidden,
            batch_axis=axis)]
        if self._mode == "lstm":
            states.append(symbol._rnn_fused_state_zeros(
                ref, num_directions_layers=n,
                state_size=self._num_hidden, batch_axis=axis))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        # fused op computes in TNC
        inputs, _ = _normalize_sequence(length, inputs, layout, True,
                                        in_layout=layout)
        if layout == "NTC":
            inputs = symbol.transpose(inputs, axes=(1, 0, 2))
        self._set_begin_ref(inputs, batch_axis=1)
        if begin_state is None:
            begin_state = self.begin_state()
        outs = symbol.RNN(
            inputs, self._parameter, begin_state[0],
            *(begin_state[1:] if self._mode == "lstm" else []),
            state_size=self._num_hidden, num_layers=self._num_layers,
            bidirectional=self._bidirectional, mode=self._mode,
            p=self._dropout, state_outputs=self._get_next_state,
            name="%srnn" % self._prefix)
        outs = list(outs) if self._get_next_state else \
            [outs if isinstance(outs, symbol.Symbol) else outs[0]]
        output = outs[0]
        if layout == "NTC":
            output = symbol.transpose(output, axes=(1, 0, 2))
        states = outs[1:] if self._get_next_state else []
        if merge_outputs is False:
            output = list(symbol.SliceChannel(
                output, num_outputs=length, axis=layout.find("T"),
                squeeze_axis=True))
        return output, states

    def _prefixes(self, layer):
        return ["%s%s%d_" % (self._prefix, "l" if d == 0 else "r", layer)
                for d in range(self._directions)]

    def unpack_weights(self, args):
        """Flat parameter vector -> per-layer, per-gate matrices and biases
        (``<prefix>l0_i2h_i_weight`` ...; the layout of `ops.rnn._unpack`:
        every layer's and direction's wx and wh, then every bias), on the
        vector's device."""
        from .. import ndarray as nd
        from ..ops.rnn import _GATES

        args = args.copy()
        flat = args.pop(self._prefix + "parameters")
        arr, ctx = flat.asnumpy(), flat.context
        G, H = _GATES[self._mode], self._num_hidden

        def per_gate(pre, group, block, kind):
            for j, gate in enumerate(self._gate_names):
                args["%s%s%s_%s" % (pre, group, gate, kind)] = nd.array(
                    block[j * H:(j + 1) * H], ctx=ctx)

        off = 0
        for layer in range(self._num_layers):
            in_sz = self._infer_input_size(arr) if layer == 0 \
                else H * self._directions
            for pre in self._prefixes(layer):
                for group, width in (("i2h", in_sz), ("h2h", H)):
                    per_gate(pre, group, arr[off:off + G * H * width]
                             .reshape(G * H, width), "weight")
                    off += G * H * width
        for layer in range(self._num_layers):
            for pre in self._prefixes(layer):
                for group in ("i2h", "h2h"):
                    per_gate(pre, group, arr[off:off + G * H], "bias")
                    off += G * H
        return args

    def _infer_input_size(self, arr):
        """The layer-0 input width, solved from the flat size (the
        reference derives it the same way from the parameter count)."""
        from ..ops.rnn import _GATES, rnn_param_size

        rest = rnn_param_size(self._num_layers, 0, self._num_hidden,
                              self._bidirectional, self._mode)
        return (arr.size - rest) // (self._directions * _GATES[self._mode]
                                     * self._num_hidden)

    def pack_weights(self, args):
        """Per-gate matrices -> the flat parameter vector, inverting
        `unpack_weights`, on the first matrix's device."""
        from .. import ndarray as nd

        args = args.copy()
        ctx = []

        def pop_gates(pre, group, kind):
            parts = [args.pop("%s%s%s_%s" % (pre, group, gate, kind))
                     for gate in self._gate_names]
            ctx.append(parts[0].context)
            return np.concatenate([p.asnumpy().reshape(-1) for p in parts])

        chunks = []
        for kind in ("weight", "bias"):
            for layer in range(self._num_layers):
                for pre in self._prefixes(layer):
                    chunks.append(pop_gates(pre, "i2h", kind))
                    chunks.append(pop_gates(pre, "h2h", kind))
        args[self._prefix + "parameters"] = nd.array(
            np.concatenate(chunks).astype(np.float32), ctx=ctx[0])
        return args

    def unfuse(self):
        """The equivalent `SequentialRNNCell` of unfused cells (reference:
        rnn_cell.py unfuse); bidirectional or dropout stacks need cells not
        ported yet and raise."""
        if self._bidirectional or self._dropout > 0:
            raise MXNetError("FusedRNNCell.unfuse: BidirectionalCell and "
                             "DropoutCell are not ported yet (ROADMAP queue "
                             "1 item 9)")
        stack = SequentialRNNCell()
        make = {"rnn_relu": lambda p: RNNCell(self._num_hidden,
                                              activation="relu", prefix=p),
                "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                              activation="tanh", prefix=p),
                "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p,
                                           forget_bias=self._forget_bias),
                "gru": lambda p: GRUCell(self._num_hidden, prefix=p)}[
                    self._mode]
        for i in range(self._num_layers):
            stack.add(make("%sl%d_" % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order (reference: rnn_cell.py:748)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, (
                "Either specify params for SequentialRNNCell or child "
                "cells, not both.")
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Delegate to each child's unroll (reference behavior) so
        unroll-only children (FusedRNNCell, BidirectionalCell) compose."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        self._set_begin_ref(inputs[0])
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        num_cells = len(self._cells)
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states
