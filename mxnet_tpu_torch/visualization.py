"""Network summary and drawing: the counterpart of
``mxnet_tpu/visualization.py`` (MXNet's python/mxnet/visualization.py).

:func:`print_summary` prints a symbol's layers with their output shapes
and parameter counts; :func:`plot_network` draws it with graphviz, where
graphviz is installed (it raises ImportError otherwise, as in the JAX
package).
"""
import ast
import json

import numpy as np

__all__ = ['print_summary', 'plot_network']


def _literal(v):
    return ast.literal_eval(v) if isinstance(v, str) else v


def print_summary(symbol, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """Print each layer: name (type), output shape, parameter count and
    the layers it takes. ``shape`` maps input names to shapes."""
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError('Input shape is incomplete')
        shape_dict = dict(zip(internals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf['nodes']
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]
    to_display = ['Layer (type)', 'Output Shape', 'Param #', 'Previous Layer']

    def print_row(fields, positions):
        line = ''
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += ' ' * (positions[i] - len(line))
        print(line)

    print('_' * line_length)
    print_row(to_display, positions)
    print('=' * line_length)

    def print_layer_summary(node, out_shape):
        op = node['op']
        pre_node = []
        pre_filter = 0
        if op != 'null':
            for item in node['inputs']:
                input_node = nodes[item[0]]
                input_name = input_node['name']
                if input_node['op'] != 'null' or item[0] in heads:
                    pre_node.append(input_name)
                    if show_shape:
                        key = input_name + '_output' \
                            if input_node['op'] != 'null' else input_name
                        if key in shape_dict:
                            in_shape = shape_dict[key][1:]
                            pre_filter = pre_filter + int(in_shape[0]) \
                                if in_shape else 0
        cur_param = 0
        attrs = node.get('attrs', {})
        if op == 'Convolution':
            num_group = int(attrs.get('num_group', '1'))
            kernel = _literal(attrs.get('kernel', ()))
            cur_param = pre_filter * int(attrs['num_filter']) // num_group * \
                int(np.prod(kernel))
            if attrs.get('no_bias') not in ('True', True):
                cur_param += int(attrs['num_filter'])
        elif op == 'FullyConnected':
            if attrs.get('no_bias') in ('True', True):
                cur_param = pre_filter * int(attrs['num_hidden'])
            else:
                cur_param = (pre_filter + 1) * int(attrs['num_hidden'])
        elif op == 'BatchNorm':
            key = node['name'] + '_output'
            if show_shape and key in shape_dict:
                cur_param = int(shape_dict[key][1]) * 2
        first_connection = '' if not pre_node else pre_node[0]
        fields = [node['name'] + '(' + op + ')',
                  'x'.join([str(x) for x in out_shape]),
                  cur_param, first_connection]
        print_row(fields, positions)
        for name in pre_node[1:]:
            print_row(['', '', '', name], positions)
        return cur_param

    heads = set(conf['arg_nodes'])
    total_params = 0
    for i, node in enumerate(nodes):
        out_shape = []
        op = node['op']
        if op == 'null' and i > 0:
            continue
        if op != 'null' or i in heads:
            if show_shape:
                key = node['name'] + '_output' if op != 'null' \
                    else node['name']
                if key in shape_dict:
                    out_shape = shape_dict[key][1:]
        total_params += print_layer_summary(node, out_shape)
        if i == len(nodes) - 1:
            print('=' * line_length)
        else:
            print('_' * line_length)
    print('Total params: {params}'.format(params=total_params))
    print('_' * line_length)


_WEIGHT_SUFFIXES = ('_weight', '_bias', '_gamma', '_beta', 'moving_mean',
                    'moving_var')


def plot_network(symbol, title='plot', save_format='pdf', shape=None,
                 node_attrs=None, hide_weights=True):
    """The symbol's graph as a graphviz Digraph (parameters hidden by
    default). Raises ImportError without graphviz."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError('plot_network requires graphviz; '
                          'use print_summary instead')
    conf = json.loads(symbol.tojson())
    nodes = conf['nodes']
    dot = Digraph(name=title)
    for node in nodes:
        name = node['name']
        if node['op'] == 'null':
            if hide_weights and name.endswith(_WEIGHT_SUFFIXES):
                continue
            dot.node(name=name, label=name, shape='oval')
        else:
            dot.node(name=name, label='%s\n%s' % (name, node['op']),
                     shape='box')
        for item in node.get('inputs', []):
            input_node = nodes[item[0]]
            if input_node['op'] == 'null' and hide_weights and (
                    input_node['name'].endswith(_WEIGHT_SUFFIXES[:4]) or
                    'moving' in input_node['name']):
                continue
            dot.edge(input_node['name'], name)
    return dot
