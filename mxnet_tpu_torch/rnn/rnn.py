"""RNN checkpoint helpers (counterpart of `mxnet_tpu/rnn/rnn.py`;
reference: python/mxnet/rnn/rnn.py): checkpoints with the cells' weights
unpacked into per-gate entries, and the fit() callback that writes them."""
from __future__ import annotations

from ..model import load_checkpoint, save_checkpoint


def _as_cells(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """save_checkpoint with fused weights unpacked (reference: rnn.py:32)."""
    args = arg_params
    for cell in _as_cells(cells):
        args = cell.unpack_weights(args)
    save_checkpoint(prefix, epoch, symbol, args, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """load_checkpoint + pack_weights (reference: rnn.py:62)."""
    sym, args, auxs = load_checkpoint(prefix, epoch)
    for cell in _as_cells(cells):
        args = cell.pack_weights(args)
    return sym, args, auxs


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback checkpointing with unpacked weights (reference:
    rnn.py:97; analogue of mx.callback.do_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
