"""Fused RNN op (counterpart of `mxnet_tpu/ops/rnn.py`).

The reference's monolithic RNN operator (src/operator/rnn-inl.h): LSTM,
GRU and vanilla RNN layers, unidirectional or bidirectional, stacked, over
(T, B, I) sequence-major data with states (L * D, B, H). The flat parameter
vector keeps the reference / cuDNN layout, bit-compatible with the JAX
package's: every layer's and direction's weights (i2h, then h2h), then every
bias; gate order LSTM (i, f, g, o), GRU (r, z, n).

Each layer first computes the input projection of the whole sequence as one
matrix product. An LSTM layer then runs `pallas_kernels.lstm_layer` (the
kernels of ``csrc/lstm.cu`` for CUDA tensors) when
`pallas_kernels.lstm_layer_fits` takes its shape and dtype; every other
layer runs the step loop, the counterpart of the JAX package's
``lax.scan``. ``RNN``, ``_rnn_state_zeros``, ``_rnn_fused_state_zeros``
and ``CTCLoss`` are registered ops (``mx.nd`` / ``mx.sym``).
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError
from . import nn as _nn
from . import pallas_kernels, register

__all__ = ["rnn_param_size", "rnn", "rnn_layers", "rnn_state_zeros",
           "rnn_fused_state_zeros", "ctc_loss"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _gates(mode):
    if mode not in _GATES:
        raise MXNetError("RNN: unknown mode %r (lstm, gru, rnn_relu or "
                         "rnn_tanh)" % (mode,))
    return _GATES[mode]


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """Total flat parameter count (reference: rnn-inl.h GetParamSize)."""
    gates = _gates(mode)
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (in_sz + state_size + 2)
    return size


def _unpack(params, num_layers, input_size, state_size, bidirectional, mode):
    """Views of the flat vector: ``weights[layer][direction] = [wx (G*H,
    in), wh (G*H, H), bx (G*H,), bh (G*H,)]``."""
    gates = _gates(mode)
    dirs = 2 if bidirectional else 1
    h, g = state_size, gates
    want = rnn_param_size(num_layers, input_size, state_size, bidirectional,
                          mode)
    if params.dim() != 1 or params.numel() != want:
        raise MXNetError("RNN: parameters must be a flat vector of %d values, "
                         "got shape %s" % (want, tuple(params.shape)))
    weights = []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * dirs
        layer_w = []
        for _ in range(dirs):
            wx = params[off:off + g * h * in_sz].reshape(g * h, in_sz)
            off += g * h * in_sz
            wh = params[off:off + g * h * h].reshape(g * h, h)
            off += g * h * h
            layer_w.append([wx, wh, None, None])
        weights.append(layer_w)
    for layer in range(num_layers):
        for d in range(dirs):
            weights[layer][d][2] = params[off:off + g * h]
            off += g * h
            weights[layer][d][3] = params[off:off + g * h]
            off += g * h
    return weights


def _cell_step(mode):
    """One time step of ``mode``: ``step((h, c), gx, wh, bh) -> ((h, c),
    y)``, where gx is the step's input projection with the i2h bias."""
    if mode == "lstm":
        def step(carry, gx, wh, bh):
            h, c = carry
            g = gx + torch.matmul(h, wh.t()) + bh
            i, f, gg, o = g.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            new_c = f * c + i * torch.tanh(gg)
            new_h = o * torch.tanh(new_c)
            return (new_h, new_c), new_h
    elif mode == "gru":
        def step(carry, gx, wh, bh):
            h, _ = carry
            hh = torch.matmul(h, wh.t()) + bh
            xr, xz, xn = gx.chunk(3, dim=-1)
            hr, hz, hn = hh.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            new_h = (1 - z) * n + z * h
            return (new_h, new_h), new_h
    else:
        act = torch.relu if mode == "rnn_relu" else torch.tanh

        def step(carry, gx, wh, bh):
            h, _ = carry
            new_h = act(gx + torch.matmul(h, wh.t()) + bh)
            return (new_h, new_h), new_h
    return step


def _run_layer(x, wx, wh, bx, bh, h0, c0, mode, reverse=False):
    """x (T, B, I) -> (ys (T, B, H), hT, cT). The input projection of the
    whole sequence is one matrix product; the recurrence is the LSTM
    kernel route (both biases folded into gx, as the JAX package's Pallas
    path) where `lstm_layer_fits`, else the step loop (the ``lax.scan``
    path: the h2h bias added each step). ``reverse`` runs the sequence
    backwards (the second direction)."""
    h_units = h0.shape[-1]
    if mode == "lstm" and pallas_kernels.lstm_layer_fits(
            x.shape[1], h_units, x.dtype):
        gx_all = torch.matmul(x, wx.t()) + (bx + bh)
        if reverse:
            gx_all = gx_all.flip(0)
        ys, h_t, c_t = pallas_kernels.lstm_layer(gx_all, wh, h0, c0)
        if reverse:
            ys = ys.flip(0)
        return ys, h_t, c_t
    gx_all = torch.matmul(x, wx.t()) + bx
    step = _cell_step(mode)
    carry = (h0, c0)
    ys = [None] * x.shape[0]
    order = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for t in order:
        carry, ys[t] = step(carry, gx_all[t], wh, bh)
    return torch.stack(ys), carry[0], carry[1]


def rnn_layers(data, weights, state, state_cell=None, mode="lstm", p=0.0,
               state_outputs=False, lstm_state_clip_min=None,
               lstm_state_clip_max=None, is_train=False, generator=None):
    """The RNN op over per-layer weights (``weights[layer][direction] =
    (wx, wh, bx, bh)``, as `_unpack` cuts them from the flat vector): the
    form the gluon layers call with their own parameters. Between layers,
    in training, inverted dropout of rate ``p`` with keep masks from
    ``generator`` (default: this thread's generator for data's device).
    Returns ``(out,)``, or ``(out, hN)`` / ``(out, hN, cN)`` with
    ``state_outputs``; hN and cN are (L * D, B, H). The LSTM state clip
    applies to the final h states, as in the JAX package."""
    dirs = len(weights[0])
    x = data
    h_finals, c_finals = [], []
    for layer, layer_w in enumerate(weights):
        outs = []
        for d, (wx, wh, bx, bh) in enumerate(layer_w):
            idx = layer * dirs + d
            h0 = state[idx]
            c0 = state_cell[idx] if (mode == "lstm"
                                     and state_cell is not None) \
                else torch.zeros_like(h0)
            ys, h_t, c_t = _run_layer(x, wx, wh, bx, bh, h0, c0, mode,
                                      reverse=d == 1)
            outs.append(ys)
            h_finals.append(h_t)
            c_finals.append(c_t)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if is_train and p > 0.0 and layer < len(weights) - 1:
            gen = generator if generator is not None \
                else _random.generator(x.device)
            x = _nn.dropout(x, p, is_train=True, generator=gen)
    if mode == "lstm" and lstm_state_clip_min is not None:
        h_finals = [torch.clamp(h, lstm_state_clip_min, lstm_state_clip_max)
                    for h in h_finals]
    if not state_outputs:
        return (x,)
    if mode == "lstm":
        return x, torch.stack(h_finals), torch.stack(c_finals)
    return x, torch.stack(h_finals)


@register("RNN", num_outputs=-1, needs_rng=True)
def rnn(data, parameters, state, state_cell=None, state_size=0, num_layers=1,
        bidirectional=False, mode="lstm", p=0.0, state_outputs=False,
        projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False, is_train=False,
        generator=None):
    """The reference's RNN op over a flat parameter vector (the cuDNN
    layout): data (T, B, I), state (L * D, B, H), ``state_cell`` the LSTM
    cell state. See `rnn_layers` for the outputs. ``lstm_state_clip_nan`` is
    accepted and has no effect, as in the JAX package; a projection (LSTMP)
    is not supported."""
    if projection_size:
        raise MXNetError("RNN: projection_size (LSTMP) is not supported")
    if data.dim() != 3:
        raise MXNetError("RNN: data must be (T, B, I), got shape %s"
                         % (tuple(data.shape),))
    weights = _unpack(parameters, num_layers, data.shape[2], state_size,
                      bidirectional, mode)
    return rnn_layers(data, weights, state, state_cell, mode=mode, p=p,
                      state_outputs=state_outputs,
                      lstm_state_clip_min=lstm_state_clip_min,
                      lstm_state_clip_max=lstm_state_clip_max,
                      is_train=is_train, generator=generator)


@register("_rnn_state_zeros")
def rnn_state_zeros(data, state_shape=()):
    """Zero initial state with the batch dim taken from ``data``: shape
    ``(data.shape[0],) + state_shape``, data's dtype and device."""
    return torch.zeros((data.shape[0],) + tuple(state_shape),
                       dtype=data.dtype, device=data.device)


@register("_rnn_fused_state_zeros")
def rnn_fused_state_zeros(data, num_directions_layers=1, state_size=0,
                          batch_axis=1):
    """Zero fused-RNN state (L * D, B, H), B from ``data`` at
    ``batch_axis`` (1 for a (T, B, I) unroll input, 0 for a (B, C) step)."""
    return torch.zeros((num_directions_layers, data.shape[batch_axis],
                        state_size), dtype=data.dtype, device=data.device)


_CTC_NEG = -1e30   # the finite log-zero: a length-0 path never gives NaN


def _lse(a, b):
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


@register("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"))
def ctc_loss(pred, label, pred_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Connectionist temporal classification, one loss a sample (the JAX
    package's `ctc_loss`; reference: src/operator/contrib/ctc_loss.cc).

    pred (T, B, C) raw activations (log-softmax taken inside); label (B, L)
    class indices. ``blank_label="first"``: blank 0, labels 1-based, 0
    pads; ``"last"``: blank C - 1, labels 0-based, -1 pads. The alpha
    recursion runs over the 2L + 1 extended labels in log space, one step
    a frame, with -1e30 as log zero, so the gradient is autograd's through
    the same arithmetic. It runs in float64 and returns float32 (the JAX
    package's runs in f32): the alphas grow to about T log C, where f32's
    spacing (6e-5 at 600) would leave the card's and the host's gradients
    2e-5 apart at T 200; -1e30 absorbs every finite term in float64 too,
    so an unreachable label keeps the JAX op's loss and gradient.
    ``pred_lengths`` (with ``use_data_lengths``) picks each sample's last
    frame; ``label_lengths`` (with ``use_label_lengths``) its label
    length, else the non-padding count."""
    T, B, C = pred.shape
    L = label.shape[1]
    dev = pred.device
    blank = 0 if blank_label == "first" else C - 1
    lab_raw = label.to(torch.int64)
    lab = torch.where(lab_raw < 0, torch.full_like(lab_raw, blank), lab_raw)
    f64 = torch.float64
    logp = torch.log_softmax(pred.to(f64), dim=-1)
    S = 2 * L + 1
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    ext_logp = torch.gather(logp, 2, ext.unsqueeze(0).expand(T, B, S))
    same_as_prev2 = torch.cat(
        [torch.ones((B, 2), dtype=torch.bool, device=dev),
         ext[:, 2:] == ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & ~same_as_prev2
    neg1 = torch.full((B, 1), _CTC_NEG, dtype=f64, device=dev)
    neg2 = torch.full((B, 2), _CTC_NEG, dtype=f64, device=dev)

    alpha = torch.cat([ext_logp[0, :, :2],
                       torch.full((B, S - 2), _CTC_NEG, dtype=f64,
                                  device=dev)], dim=1)
    alphas = [alpha]
    for t in range(1, T):
        shift1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg2, alpha[:, :-2]], dim=1)
        acc = _lse(alpha, shift1)
        acc = torch.where(can_skip, _lse(acc, shift2), acc)
        alpha = acc + ext_logp[t]
        alphas.append(alpha)
    alphas = torch.stack(alphas)   # (T, B, S)

    if use_data_lengths and pred_lengths is not None:
        t_idx = pred_lengths.to(dev, torch.int64) - 1
    else:
        t_idx = torch.full((B,), T - 1, dtype=torch.int64, device=dev)
    if use_label_lengths and label_lengths is not None:
        l_len = label_lengths.to(dev, torch.int64)
    elif blank == 0:
        l_len = (lab_raw != 0).sum(dim=1)
    else:
        l_len = (lab_raw >= 0).sum(dim=1)
    final = alphas[t_idx, torch.arange(B, device=dev)]   # (B, S)
    end1 = torch.gather(final, 1, (2 * l_len).unsqueeze(1))[:, 0]
    end2 = torch.gather(final, 1, torch.clamp(2 * l_len - 1, min=0)
                        .unsqueeze(1))[:, 0]
    # an empty label's only path is all blanks (end1); the clamped end2
    # would count it twice
    end2 = torch.where(l_len == 0, torch.full_like(end2, _CTC_NEG), end2)
    return (-_lse(end1, end2)).float()
