"""``nd.save``/``nd.load`` of the port (``mxnet_tpu_torch.ndarray.utils``)
against the JAX package's, in both formats (the npz container and the
reference's binary list format): each package loads the other's files,
lists and dicts, in f32, f16, int32, int8, uint8 and bf16 (written as
f32), equal to the values saved. Then the stubs that waited for them:
``ParameterDict.save``/``load``, ``Block.save_params``/``load_params`` and
``initializer.Load`` from a file, each across the packages.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

FORMATS = ('npz', 'mxnet')
DTYPES = ('float32', 'float16', 'int32', 'int8', 'uint8', 'bfloat16')


def _values(seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = [(2, 3), (4,), (1, 2, 2), (5,), (3, 1), (2, 2)][i]
        v = rng.standard_normal(shape) * 50
        out['v_' + dt] = v.astype(np.float32 if dt == 'bfloat16' else dt)
    return out


def _arrays(pkg, values):
    return {k: pkg.nd.array(v, ctx=pkg.cpu(),
                            dtype='bfloat16' if k.endswith('bfloat16') else None)
            for k, v in values.items()}


def _numpy(loaded):
    if isinstance(loaded, dict):
        return {k: v.asnumpy() for k, v in loaded.items()}
    return [v.asnumpy() for v in loaded]


@pytest.mark.parametrize('fmt', FORMATS)
@pytest.mark.parametrize('writer,reader', [(mx, mt), (mt, mx), (mt, mt)],
                         ids=['jax-to-port', 'port-to-jax', 'port-to-port'])
def test_files_cross_between_the_packages(tmp_path, fmt, writer, reader):
    values = _values()
    arrays = _arrays(writer, values)
    as_saved = {k: v.asnumpy() for k, v in arrays.items()}
    fd, fl = str(tmp_path / 'd.bin'), str(tmp_path / 'l.bin')
    writer.nd.save(fd, arrays, fmt=fmt)
    writer.nd.save(fl, list(arrays.values()), fmt=fmt)
    got_d = _numpy(reader.nd.load(fd))
    got_l = _numpy(reader.nd.load(fl))
    assert sorted(got_d) == sorted(values)
    for (k, want), got in zip(as_saved.items(), got_l):
        for g in (got_d[k], got):
            assert g.dtype == want.dtype and g.shape == want.shape
            np.testing.assert_array_equal(g, want)


def test_load_places_on_the_host_and_narrows_64_bits(tmp_path):
    f = str(tmp_path / 'x.params')
    mx.nd.save(f, {'i': mx.nd.array(np.arange(3, dtype=np.int32), ctx=mx.cpu())},
               fmt='mxnet')
    got = mt.nd.load(f)['i']
    assert got.context == mt.cpu() and got.dtype == np.int32
    np.savez(open(str(tmp_path / 'y'), 'wb'), __format__='list',
             **{'__mxtpu_list__0': np.arange(4, dtype=np.int64)})
    assert mt.nd.load(str(tmp_path / 'y'))[0].dtype == np.int32
    with pytest.raises(ValueError, match='npz|mxnet'):
        mt.nd.save(f, [], fmt='pickle')


def _dense_net(pkg):
    with pkg.name.NameManager():
        net = pkg.gluon.nn.HybridSequential(prefix='net_')
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(4, in_units=3))
            net.add(pkg.gluon.nn.Dense(2, in_units=4))
    net.initialize(ctx=pkg.cpu())
    return net


def _set(pkg, net, seed):
    rng = np.random.RandomState(seed)
    vals = {}
    for name, p in net.collect_params().items():
        vals[name] = rng.standard_normal(p.shape).astype(np.float32)
        p.set_data(pkg.nd.array(vals[name], ctx=pkg.cpu()))
    return vals


def _read(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


@pytest.mark.parametrize('writer,reader', [(mx, mt), (mt, mx)],
                         ids=['jax-to-port', 'port-to-jax'])
def test_parameter_files_cross_between_the_packages(tmp_path, writer, reader):
    src, dst = _dense_net(writer), _dense_net(reader)
    vals = _set(writer, src, 1)
    f1, f2 = str(tmp_path / 'p.params'), str(tmp_path / 'b.params')
    src.collect_params().save(f1)
    dst.collect_params().load(f1, reader.cpu())
    for n, v in _read(dst).items():
        np.testing.assert_array_equal(v, vals[n])
    vals = _set(writer, src, 2)
    src.save_params(f2)                 # names without the 'net_' prefix
    assert all(not k.startswith('net_') for k in reader.nd.load(f2))
    dst.load_params(f2, ctx=reader.cpu())
    for n, v in _read(dst).items():
        np.testing.assert_array_equal(v, vals[n])


@pytest.mark.parametrize('writer', [mx, mt], ids=['jax-file', 'port-file'])
def test_initializer_load_from_a_file(tmp_path, writer):
    rng = np.random.RandomState(3)
    w = rng.standard_normal((2, 3)).astype(np.float32)
    f = str(tmp_path / 'init.params')
    writer.nd.save(f, {'arg:fc_weight': writer.nd.array(w, ctx=writer.cpu())})
    init = mt.init.Load(f, default_init=mt.init.Zero())
    a, b = mt.nd.zeros((2, 3), ctx=mt.cpu()), mt.nd.ones((4,), ctx=mt.cpu())
    init('fc_weight', a)
    init('fc_bias', b)
    np.testing.assert_array_equal(a.asnumpy(), w)
    np.testing.assert_array_equal(b.asnumpy(), np.zeros(4, np.float32))
