"""Gluon fused recurrent layers (RNN, LSTM, GRU): the counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference
python/mxnet/gluon/rnn/rnn_layer.py). ``_RNNLayer`` holds one flat
``parameters`` vector in the fused op's packed layout and calls
``nd.RNN`` (cuDNN on the card), with ``begin_state`` and the NTC/TNC
layouts.
"""
from ... import ndarray as nd
from ...ops.rnn_ops import rnn_param_size, _gates
from ..block import Block
from .basic_init import init_by_name

__all__ = ['RNN', 'LSTM', 'GRU']


class _RNNLayer(Block):
    """Reference rnn_layer.py:33."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout == 'TNC' or layout == 'NTC', \
            'Invalid layout %s; must be one of ["TNC" or "NTC"]' % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        self._gates = _gates(mode)
        ng, ni, nh = self._gates, input_size, hidden_size
        # flat cuDNN-layout parameter vector (matches the fused RNN op)
        size = rnn_param_size(num_layers, hidden_size, input_size,
                              bidirectional, mode) if input_size else 0
        from ...initializer import Uniform
        self.parameters = self.params.get(
            'parameters', shape=(size,) if size else (0,),
            init=i2h_weight_initializer or Uniform(0.1),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def __repr__(self):
        s = '{name}({mapping}, {_layout}'
        if self._num_layers != 1:
            s += ', num_layers={_num_layers}'
        if self._dropout != 0:
            s += ', dropout={_dropout}'
        if self._dir == 2:
            s += ', bidirectional'
        s += ')'
        mapping = ('{_input_size} -> {_hidden_size}'.format(**self.__dict__)
                   if self._input_size else self._hidden_size)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Reference rnn_layer.py:136."""
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            shape = info.pop('shape', ())
            info.pop('__layout__', None)
            states.append(func(shape=shape, **{k: v for k, v in info.items()
                                               if k in ('ctx', 'dtype')}))
        return states

    def forward(self, inputs, states=None):
        batch_size = inputs.shape[self._layout.find('N')]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, nd.NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info['shape']:
                raise ValueError(
                    'Invalid recurrent state shape. Expecting %s, got %s.' % (
                        str(info['shape']), str(state.shape)))
        if self._input_size == 0:
            self._input_size = inputs.shape[2] if self._layout == 'TNC' else \
                inputs.shape[2]
            size = rnn_param_size(self._num_layers, self._hidden_size,
                                  self._input_size, self._dir == 2, self._mode)
            self.parameters.shape = (size,)
            self.parameters._finish_deferred_init()
        if self._layout == 'NTC':
            inputs = inputs.swapaxes(0, 1)
        out = nd.RNN(inputs, self.parameters.data(inputs.context), *states,
                     state_size=self._hidden_size,
                     num_layers=self._num_layers,
                     bidirectional=self._dir == 2, p=self._dropout,
                     state_outputs=True, mode=self._mode)
        outputs = out[0]
        out_states = list(out[1:])
        if self._layout == 'NTC':
            outputs = outputs.swapaxes(0, 1)
        if skip_states:
            return outputs
        return outputs, out_states


class RNN(_RNNLayer):
    """Reference rnn_layer.py:240."""

    def __init__(self, hidden_size, num_layers=1, activation='relu',
                 layout='TNC', dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer,
                         init_by_name(i2h_bias_initializer),
                         init_by_name(h2h_bias_initializer),
                         'rnn_' + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]


class LSTM(_RNNLayer):
    """Reference rnn_layer.py:334."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer,
                         init_by_name(i2h_bias_initializer),
                         init_by_name(h2h_bias_initializer), 'lstm', **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'},
                {'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]


class GRU(_RNNLayer):
    """Reference rnn_layer.py:439."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer,
                         init_by_name(i2h_bias_initializer),
                         init_by_name(h2h_bias_initializer), 'gru', **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]
