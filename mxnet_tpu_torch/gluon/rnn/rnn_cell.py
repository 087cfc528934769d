"""Gluon recurrent cells: the counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference
python/mxnet/gluon/rnn/rnn_cell.py): the RecurrentCell base,
RNNCell/LSTMCell/GRUCell, SequentialRNNCell, DropoutCell, the Zoneout and
Residual modifiers and BidirectionalCell. The cells are written against
``F`` (``nd`` imperatively, ``symbol`` when hybridized or composed), so
they are the JAX package's code over the port's namespaces.

One repair: ``ModifierCell.begin_state`` takes ``batch_size`` first, as
every other cell's does, so a Zoneout or Residual cell unrolls without
explicit begin states; the JAX package's takes the batch size for
``func`` and raises TypeError (ROADMAP.md §3).
"""
from ... import ndarray as nd
from ..block import Block, HybridBlock

__all__ = ['RecurrentCell', 'HybridRecurrentCell', 'RNNCell', 'LSTMCell',
           'GRUCell', 'SequentialRNNCell', 'DropoutCell', 'ModifierCell',
           'ZoneoutCell', 'ResidualCell', 'BidirectionalCell']


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    from ...ndarray import NDArray
    from ... import symbol
    assert inputs is not None
    axis = layout.find('T')
    batch_axis = layout.find('N')
    batch_size = 0
    in_axis = in_layout.find('T') if in_layout is not None else axis
    if isinstance(inputs, NDArray):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            assert length is None or length == inputs.shape[in_axis]
            inputs = list(nd.split(inputs, axis=in_axis,
                                   num_outputs=inputs.shape[in_axis],
                                   squeeze_axis=1))
    elif isinstance(inputs, symbol.Symbol):
        if merge is False:
            assert len(inputs.list_outputs()) == 1
            inputs = list(symbol.split(inputs, axis=in_axis,
                                       num_outputs=length, squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        if isinstance(inputs[0], symbol.Symbol):
            F = symbol
        else:
            F = nd
            batch_size = inputs[0].shape[batch_axis - 1] if batch_axis > 0 \
                else inputs[0].shape[0]
        if merge is True:
            inputs = [F.expand_dims(i, axis=axis) for i in inputs]
            inputs = F.Concat(*inputs, dim=axis) if F is symbol else \
                nd.concatenate(inputs, axis=axis)
    if isinstance(inputs, tuple([type(None)])) is False and \
            not isinstance(inputs, list) and axis != in_axis:
        inputs = (symbol if isinstance(inputs, symbol.Symbol) else nd).swapaxes(
            inputs, dim1=axis, dim2=in_axis)
    return inputs, axis, (symbol if not isinstance(inputs, (NDArray, list)) or
                          (isinstance(inputs, list) and
                           isinstance(inputs[0], symbol.Symbol)) else nd), \
        batch_size


class RecurrentCell(Block):
    """Reference gluon/rnn/rnn_cell.py:33."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            'After applying modifier cells the base cell cannot be called directly. Call the modifier cell instead.'
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            shape = info.pop('shape', ())
            info.pop('__layout__', None)
            state = func(shape=shape,
                         **{k: v for k, v in info.items() if k in
                            ('ctx', 'dtype')})
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        inputs, _, F, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _, _, _ = _format_sequence(length, outputs, layout,
                                            merge_outputs)
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()


class RNNCell(HybridRecurrentCell):
    """Reference gluon/rnn/rnn_cell.py:224."""

    def __init__(self, hidden_size, activation='tanh', i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer='zeros',
                 h2h_bias_initializer='zeros', input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get('i2h_weight',
                                          shape=(hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get('h2h_weight',
                                          shape=(hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        from .basic_init import init_by_name
        self.i2h_bias = self.params.get('i2h_bias', shape=(hidden_size,),
                                        init=init_by_name(i2h_bias_initializer),
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get('h2h_bias', shape=(hidden_size,),
                                        init=init_by_name(h2h_bias_initializer),
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size), '__layout__': 'NC'}]

    def _alias(self):
        return 'rnn'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """Reference gluon/rnn/rnn_cell.py:302. Gate order i,f,c,o."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer='zeros',
                 h2h_bias_initializer='zeros', input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get('i2h_weight',
                                          shape=(4 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get('h2h_weight',
                                          shape=(4 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        from .basic_init import init_by_name
        self.i2h_bias = self.params.get('i2h_bias', shape=(4 * hidden_size,),
                                        init=init_by_name(i2h_bias_initializer),
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get('h2h_bias', shape=(4 * hidden_size,),
                                        init=init_by_name(h2h_bias_initializer),
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size), '__layout__': 'NC'},
                {'shape': (batch_size, self._hidden_size), '__layout__': 'NC'}]

    def _alias(self):
        return 'lstm'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * 4)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * 4)
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4)
        in_gate = F.Activation(slice_gates[0], act_type='sigmoid')
        forget_gate = F.Activation(slice_gates[1], act_type='sigmoid')
        in_transform = F.Activation(slice_gates[2], act_type='tanh')
        out_gate = F.Activation(slice_gates[3], act_type='sigmoid')
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type='tanh')
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """Reference gluon/rnn/rnn_cell.py:426. Gate order r,z,n."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer='zeros',
                 h2h_bias_initializer='zeros', input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get('i2h_weight',
                                          shape=(3 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get('h2h_weight',
                                          shape=(3 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        from .basic_init import init_by_name
        self.i2h_bias = self.params.get('i2h_bias', shape=(3 * hidden_size,),
                                        init=init_by_name(i2h_bias_initializer),
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get('h2h_bias', shape=(3 * hidden_size,),
                                        init=init_by_name(h2h_bias_initializer),
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size), '__layout__': 'NC'}]

    def _alias(self):
        return 'gru'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * 3)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * 3)
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3)
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type='sigmoid')
        update_gate = F.Activation(i2h_z + h2h_z, act_type='sigmoid')
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type='tanh')
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Reference gluon/rnn/rnn_cell.py:540."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        num_cells = len(self._children)
        _, _, _, batch_size = _format_sequence(length, inputs, layout, None)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError()


class DropoutCell(HybridRecurrentCell):
    """Reference gluon/rnn/rnn_cell.py:624."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float))
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return 'dropout'

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Reference gluon/rnn/rnn_cell.py:672."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            'Cell %s is already modified. One cell cannot be modified twice' \
            % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        # batch_size first, as RecurrentCell's: unroll passes it by
        # position (the JAX package's takes it for ``func``)
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError()


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell), \
            'BidirectionalCell doesn\'t support zoneout. ' \
            'Please add ZoneoutCell to the cells underneath instead.'
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def _alias(self):
        return 'zoneout'

    def reset(self):
        super().reset()
        self.prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = self.base_cell, self.zoneout_outputs, \
            self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self.prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0. else next_output
        states = [F.where(mask(p_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return 'residual'

    def hybrid_forward(self, F, inputs, states):
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
        from ...ndarray import NDArray
        merge_outputs = isinstance(outputs, NDArray) if merge_outputs is None \
            else merge_outputs
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [i + j for i, j in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Reference gluon/rnn/rnn_cell.py:805."""

    def __init__(self, l_cell, r_cell, output_prefix='bi_'):
        super().__init__(prefix='', params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError('Bidirectional cannot be stepped. Please use unroll')

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs, layout,
                                                       False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        states = begin_state
        l_cell, r_cell = self._children
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info(batch_size))],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info(batch_size)):],
            layout=layout, merge_outputs=False)
        if F is nd:
            concat = lambda a, b: nd.Concat(a, b, dim=1)
        else:
            from ... import symbol
            concat = lambda a, b: symbol.Concat(a, b, dim=1)
        outputs = [concat(l_o, r_o) for l_o, r_o in
                   zip(l_outputs, reversed(r_outputs))]
        outputs, _, _, _ = _format_sequence(length, outputs, layout,
                                            merge_outputs)
        states = l_states + r_states
        return outputs, states

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()
