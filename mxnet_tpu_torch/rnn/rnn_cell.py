"""Symbolic RNN cells: the counterpart of ``mxnet_tpu/rnn/rnn_cell.py``
(reference python/mxnet/rnn/rnn_cell.py).

``BaseRNNCell`` with ``unroll`` and ``begin_state``, ``RNNCell``,
``LSTMCell`` and ``GRUCell`` over ``FullyConnected`` (gate order as the
fused op's: LSTM i, f, c, o; GRU r, z, n), ``FusedRNNCell`` over the
``RNN`` op with ``unfuse``, ``SequentialRNNCell``, ``DropoutCell``, the
modifiers ``ZoneoutCell`` and ``ResidualCell``, ``BidirectionalCell`` and
the convolutional cells. The cells build Symbols, so they are the JAX
package's code over the port's ``symbol`` namespace.

One difference: ``FusedRNNCell.unpack_weights`` and ``pack_weights`` map
the packed ``parameters`` vector to and from per-gate arrays named as
``unfuse()``'s cells name them unpacked (``<prefix>l0_i2h_i_weight``, ...;
``r`` for a reverse direction), as the reference's do
(rnn_cell.py:640-700). The JAX package's FusedRNNCell inherits
BaseRNNCell's and raises KeyError (ROADMAP.md §3).
"""
from .. import symbol
from ..symbol.symbol import Symbol

__all__ = ['BaseRNNCell', 'RNNCell', 'LSTMCell', 'GRUCell', 'FusedRNNCell',
           'SequentialRNNCell', 'BidirectionalCell', 'DropoutCell',
           'ModifierCell', 'ZoneoutCell', 'ResidualCell', 'RNNParams',
           'BaseConvRNNCell', 'ConvRNNCell', 'ConvLSTMCell', 'ConvGRUCell']


class RNNParams:
    """Container for holding variables (reference rnn_cell.py:39)."""

    def __init__(self, prefix=''):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Reference rnn_cell.py:108."""

    def __init__(self, prefix='', params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

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
        return [ele['shape'] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified, \
            'After applying modifier cells the base cell cannot be called directly. Call the modifier cell instead.'
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is None:
                state = func(name='%sbegin_state_%d' % (self._prefix,
                                                        self._init_counter),
                             **kwargs)
            else:
                kwargs.update(info)
                state = func(name='%sbegin_state_%d' % (self._prefix,
                                                        self._init_counter),
                             **kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Reference rnn_cell.py:247 — fused vector → per-gate matrices."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ['i2h', 'h2h']:
            weight = args.pop('%s%s_weight' % (self._prefix, group_name))
            bias = args.pop('%s%s_bias' % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = '%s%s%s_weight' % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = '%s%s%s_bias' % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        args = args.copy()
        if not self._gate_names:
            return args
        from .. import ndarray as nd
        for group_name in ['i2h', 'h2h']:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = '%s%s%s_weight' % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = '%s%s%s_bias' % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args['%s%s_weight' % (self._prefix, group_name)] = \
                nd.concatenate(weight)
            args['%s%s_bias' % (self._prefix, group_name)] = \
                nd.concatenate(bias)
        return args

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        """Reference rnn_cell.py:310."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = _batch_states(self, inputs[0], batch_axis=0)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states


def _batch_states(cell, ref_sym, batch_axis=0):
    """begin_state with batch taken from ``ref_sym`` via _state_zeros, so
    forward shape inference resolves the reference's 0-batch convention."""
    def func(name, shape=(), dtype='float32', **kwargs):
        return symbol._state_zeros(ref_sym, name=name, shape=tuple(shape),
                                   dtype=dtype, batch_axis=batch_axis)
    return cell.begin_state(func=func)


def _unroll_ref_input(length, inputs, layout):
    """A (symbol, batch_axis) pair naming where the batch dim lives."""
    if isinstance(inputs, Symbol):
        return inputs, layout.find('N')
    return inputs[0], 0


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    assert inputs is not None
    axis = layout.find('T')
    in_axis = in_layout.find('T') if in_layout is not None else axis
    if isinstance(inputs, Symbol):
        if merge is False:
            assert len(inputs.list_outputs()) == 1, \
                'unroll doesn\'t allow grouped symbol as input. Please convert ' \
                'to list with list(inputs) first or let unroll handle splitting.'
            inputs = list(symbol.SliceChannel(inputs, axis=in_axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        if merge is True:
            inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=axis)
            in_axis = axis
    if isinstance(inputs, Symbol) and axis != in_axis:
        inputs = symbol.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis


class RNNCell(BaseRNNCell):
    """Simple tanh/relu recurrent cell (reference rnn_cell.py:409)."""

    def __init__(self, num_hidden, activation='tanh', prefix='rnn_',
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get('i2h_weight')
        self._iB = self.params.get('i2h_bias')
        self._hW = self.params.get('h2h_weight')
        self._hB = self.params.get('h2h_bias')

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ('',)

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name='%si2h' % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name='%sh2h' % name)
        output = symbol.Activation(i2h + h2h, act_type=self._activation,
                                   name='%sout' % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """Reference rnn_cell.py:459. Gate order i,f,c,o (cuDNN convention)."""

    def __init__(self, num_hidden, prefix='lstm_', params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get('i2h_weight')
        self._hW = self.params.get('h2h_weight')
        self._iB = self.params.get('i2h_bias')
        self._hB = self.params.get('h2h_bias')
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'},
                {'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ['_i', '_f', '_c', '_o']

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name='%si2h' % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name='%sh2h' % name)
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4,
                                          name='%sslice' % name)
        in_gate = symbol.Activation(slice_gates[0], act_type='sigmoid',
                                    name='%si' % name)
        forget_gate = symbol.Activation(slice_gates[1], act_type='sigmoid',
                                        name='%sf' % name)
        in_transform = symbol.Activation(slice_gates[2], act_type='tanh',
                                         name='%sc' % name)
        out_gate = symbol.Activation(slice_gates[3], act_type='sigmoid',
                                     name='%so' % name)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type='tanh')
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """Reference rnn_cell.py:578. Gate order r,z,n (cuDNN convention)."""

    def __init__(self, num_hidden, prefix='gru_', params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get('i2h_weight')
        self._iB = self.params.get('i2h_bias')
        self._hW = self.params.get('h2h_weight')
        self._hB = self.params.get('h2h_bias')

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ['_r', '_z', '_o']

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name='%si2h' % name)
        h2h = symbol.FullyConnected(data=prev_state_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name='%sh2h' % name)
        i2h_r, i2h_z, i2h = symbol.SliceChannel(i2h, num_outputs=3,
                                                name='%si2h_slice' % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(h2h, num_outputs=3,
                                                name='%sh2h_slice' % name)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type='sigmoid',
                                       name='%sr_act' % name)
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type='sigmoid',
                                        name='%sz_act' % name)
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h,
                                       act_type='tanh', name='%sh_act' % name)
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Maps to the fused RNN op (reference rnn_cell.py:536)."""

    def __init__(self, num_hidden, num_layers=1, mode='lstm',
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = '%s_' % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._directions = 2 if bidirectional else 1
        # the flat parameter vector carries its own initializer as the
        # variable's __init__ attr (reference rnn_cell.py:578-580): a
        # global Xavier cannot init a 1-D vector, and the gate/bias
        # layout needs init.FusedRNN's unpack-init-repack
        from .. import initializer as _init
        self._parameter = self.params.get(
            'parameters', init=_init.FusedRNN(
                None, num_hidden, num_layers, mode,
                bidirectional=bidirectional, forget_bias=forget_bias))

    @property
    def state_info(self):
        b = self._directions
        n = (self._mode == 'lstm') + 1
        return [{'shape': (b * self._num_layers, 0, self._num_hidden),
                 '__layout__': 'LNC'} for _ in range(n)]

    @property
    def _gate_names(self):
        return {'rnn_relu': [''], 'rnn_tanh': [''],
                'lstm': ['_i', '_f', '_c', '_o'],
                'gru': ['_r', '_z', '_o']}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_names(self, num_input):
        """(name, shape) of each per-gate piece of the packed vector, in
        its order: (W gates, R gates) a layer and direction, then (bW
        gates, bR gates) in the same order."""
        h, dirs = self._num_hidden, 'lr'[:self._directions]
        out = []
        for layer in range(self._num_layers):
            isz = num_input if layer == 0 else self._directions * h
            for d in dirs:
                for group, cols in (('i2h', isz), ('h2h', h)):
                    for gate in self._gate_names:
                        out.append(('%s%s%d_%s%s_weight' % (
                            self._prefix, d, layer, group, gate), (h, cols)))
        for layer in range(self._num_layers):
            for d in dirs:
                for group in ('i2h', 'h2h'):
                    for gate in self._gate_names:
                        out.append(('%s%s%d_%s%s_bias' % (
                            self._prefix, d, layer, group, gate), (h,)))
        return out

    def unpack_weights(self, args):
        """The packed ``parameters`` -> per-gate arrays (reference
        rnn_cell.py:672)."""
        args = args.copy()
        arr = args.pop(self._parameter.name)
        b, m, h = self._directions, self._num_gates, self._num_hidden
        num_input = arr.size // b // h // m \
            - (self._num_layers - 1) * (h + b * h + 2) - h - 2
        p = 0
        for name, shape in self._slice_names(num_input):
            size = 1
            for s in shape:
                size *= s
            args[name] = arr[p:p + size].reshape(shape).copy()
            p += size
        assert p == arr.size, 'Invalid parameters size for FusedRNNCell'
        return args

    def pack_weights(self, args):
        """Per-gate arrays -> the packed ``parameters`` (reference
        rnn_cell.py:684)."""
        from .. import ndarray as nd
        args = args.copy()
        w0 = args['%sl0_i2h%s_weight' % (self._prefix, self._gate_names[0])]
        pieces = [args.pop(name).reshape((-1,))
                  for name, _ in self._slice_names(w0.shape[1])]
        args[self._parameter.name] = nd.concatenate(pieces)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError('FusedRNNCell cannot be stepped. Please use unroll')

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = _batch_states(self, inputs, batch_axis=1)
        states = begin_state

        if self._mode == 'lstm':
            states = {'state': states[0], 'state_cell': states[1]}
        else:
            states = {'state': states[0]}

        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state, mode=self._mode,
                         name=self._prefix + 'rnn', **states)

        attr = {}
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == 'lstm':
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol.SliceChannel(outputs, axis=axis,
                                               num_outputs=length,
                                               squeeze_axis=1))
        return outputs, states

    def unfuse(self):
        """Reference rnn_cell.py:706 — explicit-cell equivalent stack."""
        stack = SequentialRNNCell()
        get_cell = {'rnn_relu': lambda cell_prefix: RNNCell(self._num_hidden,
                                                            activation='relu',
                                                            prefix=cell_prefix),
                    'rnn_tanh': lambda cell_prefix: RNNCell(self._num_hidden,
                                                            activation='tanh',
                                                            prefix=cell_prefix),
                    'lstm': lambda cell_prefix: LSTMCell(self._num_hidden,
                                                         prefix=cell_prefix),
                    'gru': lambda cell_prefix: GRUCell(self._num_hidden,
                                                       prefix=cell_prefix)}[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell('%sl%d_' % (self._prefix, i)),
                    get_cell('%sr%d_' % (self._prefix, i)),
                    output_prefix='%sbi_l%d_' % (self._prefix, i)))
            else:
                stack.add(get_cell('%sl%d_' % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix='%s_dropout%d_' % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Reference rnn_cell.py:760."""

    def __init__(self, params=None):
        super().__init__(prefix='', params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                'Either specify params for SequentialRNNCell or child cells, not both.'
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
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            ref, b_axis = _unroll_ref_input(length, inputs, layout)
            begin_state = _batch_states(self, ref, batch_axis=b_axis)
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Reference rnn_cell.py:844."""

    def __init__(self, dropout, prefix='dropout_', params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Reference rnn_cell.py:878."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError()


class ZoneoutCell(ModifierCell):
    """Reference rnn_cell.py:929."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            'FusedRNNCell doesn\'t support zoneout. Please unfuse first.'
        assert not isinstance(base_cell, BidirectionalCell), \
            'BidirectionalCell doesn\'t support zoneout since it doesn\'t support step. ' \
            'Please add ZoneoutCell to the cells underneath instead.'
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = self.base_cell, self.zoneout_outputs, \
            self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(like * 0 + 1, p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else next_output * 0
        output = symbol.where(mask(p_outputs, next_output), next_output,
                              prev_output) if p_outputs != 0. else next_output
        states = [symbol.where(mask(p_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Reference rnn_cell.py:997."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, Symbol) if merge_outputs is None \
            else merge_outputs
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [i + j for i, j in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Reference rnn_cell.py:1034."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix='bi_'):
        super().__init__('', params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params, \
                'Either specify params for BidirectionalCell or child cells, not both.'
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise NotImplementedError('Bidirectional cannot be stepped. Please use unroll')

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            ref, b_axis = _unroll_ref_input(length, inputs, layout)
            begin_state = _batch_states(self, ref, batch_axis=b_axis)
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info)], layout=layout,
            merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info):], layout=layout,
            merge_outputs=merge_outputs)
        if merge_outputs is None:
            merge_outputs = isinstance(l_outputs, Symbol) and \
                isinstance(r_outputs, Symbol)
            if not merge_outputs:
                if isinstance(l_outputs, Symbol):
                    l_outputs = list(symbol.SliceChannel(
                        l_outputs, axis=axis, num_outputs=length,
                        squeeze_axis=1))
                if isinstance(r_outputs, Symbol):
                    r_outputs = list(symbol.SliceChannel(
                        r_outputs, axis=axis, num_outputs=length,
                        squeeze_axis=1))
        if merge_outputs:
            r_outputs = symbol.reverse(r_outputs, axis=axis)
            outputs = symbol.Concat(l_outputs, r_outputs, dim=2,
                                    name='%sout' % self._output_prefix)
        else:
            outputs = [symbol.Concat(l_o, r_o, dim=1,
                                     name='%st%d' % (self._output_prefix, i))
                       for i, (l_o, r_o) in
                       enumerate(zip(l_outputs, reversed(r_outputs)))]
        states = l_states + r_states
        return outputs, states


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


class BaseConvRNNCell(BaseRNNCell):
    """Convolutional RNN cell base (reference rnn_cell.py BaseConvRNNCell):
    i2h and h2h are Convolutions over NCHW feature maps instead of
    FullyConnected over vectors; states are feature maps."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation='tanh',
                 prefix='', params=None, conv_layout='NCHW'):
        super().__init__(prefix=prefix, params=params)
        assert h2h_kernel[0] % 2 == 1 and h2h_kernel[1] % 2 == 1, \
            'h2h_kernel must be odd, got %s' % str(h2h_kernel)
        self._h2h_kernel = h2h_kernel
        self._h2h_pad = (h2h_dilate[0] * (h2h_kernel[0] - 1) // 2,
                         h2h_dilate[1] * (h2h_kernel[1] - 1) // 2)
        self._h2h_dilate = h2h_dilate
        self._i2h_kernel = i2h_kernel
        self._i2h_stride = i2h_stride
        self._i2h_pad = i2h_pad
        self._i2h_dilate = i2h_dilate
        self._num_hidden = num_hidden
        self._input_shape = input_shape
        self._activation = activation

        # state shape = the i2h conv's output shape at batch 0
        probe = symbol.Convolution(
            symbol.Variable('data'), num_filter=num_hidden,
            kernel=i2h_kernel, stride=i2h_stride, pad=i2h_pad,
            dilate=i2h_dilate)
        _, out_shapes, _ = probe.infer_shape(data=input_shape)
        self._state_shape = (0,) + tuple(out_shapes[0][1:])

        self._iW = self.params.get('i2h_weight')
        self._hW = self.params.get('h2h_weight')
        self._iB = self.params.get('i2h_bias')
        self._hB = self.params.get('h2h_bias')

    @property
    def _num_gates(self):
        return len(self._gate_names)

    @property
    def state_info(self):
        return [{'shape': self._state_shape, '__layout__': 'NCHW'}]

    def _conv_forward(self, inputs, states, name):
        i2h = symbol.Convolution(
            inputs, weight=self._iW, bias=self._iB,
            num_filter=self._num_hidden * self._num_gates,
            kernel=self._i2h_kernel, stride=self._i2h_stride,
            pad=self._i2h_pad, dilate=self._i2h_dilate,
            name='%si2h' % name)
        h2h = symbol.Convolution(
            states[0], weight=self._hW, bias=self._hB,
            num_filter=self._num_hidden * self._num_gates,
            kernel=self._h2h_kernel, pad=self._h2h_pad,
            dilate=self._h2h_dilate, name='%sh2h' % name)
        return i2h, h2h


class ConvRNNCell(BaseConvRNNCell):
    """Plain convolutional RNN (reference rnn_cell.py ConvRNNCell)."""

    def __init__(self, input_shape, num_hidden, prefix='ConvRNN_', **kw):
        super().__init__(input_shape, num_hidden, prefix=prefix, **kw)

    @property
    def _gate_names(self):
        return ('',)

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        out = symbol.Activation(i2h + h2h, act_type=self._activation,
                                name='%sout' % name)
        return out, [out]


class ConvLSTMCell(BaseConvRNNCell):
    """Convolutional LSTM (reference rnn_cell.py ConvLSTMCell,
    Shi et al. 2015): LSTM gating over feature maps."""

    def __init__(self, input_shape, num_hidden, prefix='ConvLSTM_',
                 forget_bias=1.0, **kw):
        super().__init__(input_shape, num_hidden, prefix=prefix, **kw)
        self._forget_bias = forget_bias

    @property
    def _gate_names(self):
        return ('_i', '_f', '_c', '_o')

    @property
    def state_info(self):
        return [{'shape': self._state_shape, '__layout__': 'NCHW'},
                {'shape': self._state_shape, '__layout__': 'NCHW'}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        gates = i2h + h2h
        sliced = symbol.SliceChannel(gates, num_outputs=4,
                                     name='%sslice' % name)
        in_gate = symbol.Activation(sliced[0], act_type='sigmoid')
        forget_gate = symbol.Activation(sliced[1] + self._forget_bias,
                                        act_type='sigmoid')
        in_transform = symbol.Activation(sliced[2],
                                         act_type=self._activation)
        out_gate = symbol.Activation(sliced[3], act_type='sigmoid')
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c,
                                              act_type=self._activation)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """Convolutional GRU (reference rnn_cell.py ConvGRUCell)."""

    def __init__(self, input_shape, num_hidden, prefix='ConvGRU_', **kw):
        super().__init__(input_shape, num_hidden, prefix=prefix, **kw)

    @property
    def _gate_names(self):
        return ('_r', '_z', '_o')

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        i2h_s = symbol.SliceChannel(i2h, num_outputs=3,
                                    name='%si2h_slice' % name)
        h2h_s = symbol.SliceChannel(h2h, num_outputs=3,
                                    name='%sh2h_slice' % name)
        reset = symbol.Activation(i2h_s[0] + h2h_s[0], act_type='sigmoid',
                                  name='%sr' % name)
        update = symbol.Activation(i2h_s[1] + h2h_s[1], act_type='sigmoid',
                                   name='%sz' % name)
        cand = symbol.Activation(i2h_s[2] + reset * h2h_s[2],
                                 act_type=self._activation,
                                 name='%sh' % name)
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]
