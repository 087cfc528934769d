"""RNN checkpoint helpers: the counterpart of ``mxnet_tpu/rnn/rnn.py``
(reference python/mxnet/rnn/rnn.py)."""
from .. import model
from .rnn_cell import BaseRNNCell

__all__ = ['rnn_unroll', 'save_rnn_checkpoint', 'load_rnn_checkpoint',
           'do_rnn_checkpoint']


def _in_cells(cells):
    if isinstance(cells, BaseRNNCell):
        cells = [cells]
    return cells


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Reference rnn/rnn.py:28 — unpacks fused weights before saving."""
    cells = _in_cells(cells)
    for cell in cells:
        arg_params = cell.unpack_weights(arg_params)
    model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Reference rnn/rnn.py:60."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    cells = _in_cells(cells)
    for cell in cells:
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Reference rnn/rnn.py:92."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix='', layout='NTC'):
    """Deprecated (reference rnn/rnn.py:26): use cell.unroll directly.
    With ``inputs=None`` the legacy form creates one
    ``<input_prefix>t%d_data`` Variable per step, as the reference's
    unroll did."""
    import warnings

    from .. import symbol
    warnings.warn('rnn_unroll is deprecated. '
                  'Please call cell.unroll directly.')
    if inputs is None:
        inputs = [symbol.Variable('%st%d_data' % (input_prefix, i))
                  for i in range(length)]
    outputs, states = cell.unroll(length=length, inputs=inputs,
                                  begin_state=begin_state, layout=layout)
    return outputs, states
