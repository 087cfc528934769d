"""The port's visualization and small modules against the JAX package's,
on the CPU.

- ``print_summary``: the printed text equal to the JAX package's for
  resnet18_v1 (hybridized Gluon net, 64 x 64 input) and a small MLP,
  with and without shapes; ``plot_network`` gated on graphviz as in the
  JAX package;
- ``executor_manager._split_input_slice``: the same slices (or the same
  error) for several batches and workloads, and
  ``DataParallelExecutorManager`` training a batch;
- ``misc``, ``libinfo``, ``log``, the generic ``registry`` and the doc
  modules: the same behaviour as the JAX package's.
All comparisons are exact.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import executor_manager as jem
from mxnet_tpu_torch import executor_manager as tem


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mt.cpu():
        yield


def _resnet18(lib):
    from importlib import import_module
    vision = import_module(lib.__name__ + '.gluon.model_zoo.vision')
    with lib.name.NameManager():
        net = vision.get_model('resnet18_v1', classes=10)
        return net(lib.sym.var('data'))


def _mlp(lib):
    S = lib.sym
    x = S.var('data')
    h = S.Activation(S.FullyConnected(x, num_hidden=16, name='fc1'),
                     act_type='relu', name='relu1')
    h = S.BatchNorm(h, name='bn')
    h = S.FullyConnected(h, num_hidden=4, no_bias=True, name='fc2')
    return S.SoftmaxOutput(h, name='softmax')


@pytest.mark.parametrize('net,shape', [
    ('mlp', None), ('mlp', {'data': (2, 8)}),
    ('resnet18_v1', {'data': (1, 3, 64, 64)})])
def test_print_summary_matches_jax(capsys, net, shape):
    make = _mlp if net == 'mlp' else _resnet18
    out = {}
    for lib in (mx, mt):
        lib.viz.print_summary(make(lib), shape=shape)
        out[lib] = capsys.readouterr().out
    assert out[mt] == out[mx]
    assert 'Total params:' in out[mt]
    if shape is not None:
        total = int(out[mt].split('Total params: ')[1].split()[0])
        assert total > 0


def test_plot_network_is_gated_like_jax():
    try:
        import graphviz  # noqa: F401
    except ImportError:
        for lib in (mx, mt):
            with pytest.raises(ImportError, match='graphviz'):
                lib.viz.plot_network(_mlp(lib))
        return
    assert mt.viz.plot_network(_mlp(mt)).source == \
        mx.viz.plot_network(_mlp(mx)).source


@pytest.mark.parametrize('batch,work', [(10, [1, 1]), (7, [1, 2, 3]),
                                        (32, [3, 1]), (5, [1, 1, 1, 1, 1]),
                                        (2, [1, 1, 1])])
def test_split_input_slice_matches_jax(batch, work):
    try:
        want = jem._split_input_slice(batch, work)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tem._split_input_slice(batch, work)
        return
    assert tem._split_input_slice(batch, work) == want


def test_executor_manager_trains_a_batch_like_jax():
    r = np.random.RandomState(0)
    X = r.randn(8, 8).astype(np.float32)
    Y = r.randint(0, 4, 8).astype(np.float32)
    params = None
    res = {}
    for lib in (mx, mt):
        sym = _mlp(lib)
        it = lib.io.NDArrayIter(X, Y, batch_size=8,
                                label_name='softmax_label')
        arg_names = sym.list_arguments()
        pnames = [n for n in arg_names if n not in ('data', 'softmax_label')]
        man = lib.DataParallelExecutorManager(
            sym, [lib.cpu()], it, arg_names, pnames,
            sym.list_auxiliary_states())
        if params is None:
            params = {n: (0.3 * r.randn(*a[0].shape)).astype(np.float32)
                      for n, a in zip(pnames, man.param_arrays)}
        aux = {n: lib.nd.array(np.ones(a[0].shape, np.float32))
               for n, a in zip(sym.list_auxiliary_states(), man.aux_arrays)}
        man.set_params({n: lib.nd.array(v) for n, v in params.items()}, aux)
        man.load_data_batch(next(iter(it)))
        man.forward(is_train=True)
        man.backward()
        res[lib] = [g[0].asnumpy() for g in man.grad_arrays]
    for t, j in zip(res[mt], res[mx]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_misc_libinfo_and_log_match_jax(tmp_path):
    assert mt.__version__ == mx.__version__
    from mxnet_tpu_torch import misc, libinfo, _native
    from mxnet_tpu import misc as jmisc
    assert misc.LearningRateScheduler is mt.lr_scheduler.LRScheduler
    assert jmisc.LearningRateScheduler is mx.lr_scheduler.LRScheduler
    assert misc.FactorScheduler is mt.lr_scheduler.FactorScheduler
    _native.get_lib()
    assert str(_native.library_path()) in libinfo.find_lib_path()
    path = tmp_path / 'x.log'
    for lib, name in ((mx, 'jax_logger'), (mt, 'port_logger')):
        logger = lib.log.get_logger(name, filename=str(path),
                                    level=logging.INFO)
        assert lib.log.get_logger(name, level=logging.DEBUG) is logger
        assert logger.level == logging.DEBUG and len(logger.handlers) == 1
        logger.info('hello %s', name)
        logger.handlers[0].flush()
    lines = path.read_text().splitlines()
    assert [line.split('] ', 1)[1] for line in lines] == [
        'jax_logger: hello jax_logger', 'port_logger: hello port_logger']
    assert [line.split(' ', 2)[2][:4] for line in lines] == ['[I] '] * 2


def test_registry_matches_jax():
    out = {}
    for lib in (mx, mt):
        reg = lib.registry

        class Base:
            def __init__(self, k=1):
                self.k = k

        register = reg.get_register_func(Base, 'thing')
        alias = reg.get_alias_func(Base, 'thing')
        create = reg.get_create_func(Base, 'thing')

        @alias('other', 'third')
        @register
        class Widget(Base):
            pass
        made = [create('widget', k=2).k, create('OTHER').k,
                create({'thing': 'third', 'k': 5}).k,
                create('["widget", {"k": 7}]').k]
        inst = Widget(3)
        assert create(inst) is inst
        with pytest.raises(AssertionError, match='not registered'):
            create('nothing')
        out[lib] = (made, Widget.__registered_name__)
    assert out[mt] == out[mx] == ([2, 1, 5, 7], 'third')


def test_doc_modules_match_jax():
    from mxnet_tpu import ndarray_doc as jnd, symbol_doc as jsd
    from mxnet_tpu_torch import ndarray_doc as tnd, symbol_doc as tsd
    args = ('Reshape', 'Reshapes.', ['data', 'shape'], ['NDArray', 'tuple'],
            ['the input', ''])
    assert tnd._build_doc(*args, key_var_num_args='num_args',
                          ret_type='NDArray') == jnd._build_doc(
        *args, key_var_num_args='num_args', ret_type='NDArray')
    args = ('Dropout', 'Drops.', ['data', 'p'], ['Symbol', 'float'],
            ['', 'the rate'])
    assert tsd._build_doc(*args) == jsd._build_doc(*args)
    for lib, sd in ((mx, jsd), (mt, tsd)):
        s = lib.sym.FullyConnected(lib.sym.var('data'), num_hidden=3,
                                   name='fc')
        assert sd.SymbolDoc.get_output_shape(s, data=(2, 5)) == \
            {'fc_output': (2, 3)}
