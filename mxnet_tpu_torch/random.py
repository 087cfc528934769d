"""Random number streams: the counterpart of ``mxnet_tpu/random.py``.

The JAX package keeps one process-global threefry key and splits a subkey
off it for every random op. Here each torch device has an explicit
``torch.Generator`` (Philox on the card), created at first use and handed
to a ``needs_rng`` op as its last argument, so the op draws on its own
device without touching torch's global generators. :func:`seed` seeds
every stream: each device's generator, the host numpy stream that the
initializers draw from (a ``RandomState``, as in the JAX package, so that
``seed(s)`` followed by the same initializers gives the same weights in
both packages), the host stdlib stream, and the stream of per-run seeds
that the Symbol executor folds with each node's index (:func:`next_seed`,
:func:`node_generator`). ``MXTPU_SEED`` seeds them all at import.

The device streams cannot match the JAX package's (Philox against
threefry): samplers are held to it by distribution, and to themselves by
seed.
"""
import os as _os
import random as _pyrandom
import threading

import numpy as _np
import torch

__all__ = ['seed', 'generator', 'next_seed', 'node_generator', 'get_state',
           'set_state', 'host_rng', 'host_pyrng', 'uniform', 'normal',
           'gamma', 'exponential', 'poisson', 'negative_binomial',
           'generalized_negative_binomial']

_lock = threading.Lock()
_env_seed = None
_env_raw = _os.environ.get('MXTPU_SEED', '').strip()
if _env_raw:
    try:
        _env_seed = int(_env_raw)
    except ValueError:
        import warnings as _warnings
        _warnings.warn('MXTPU_SEED=%r is not an integer; ignoring it'
                       % _env_raw)
_host_rng = _np.random.RandomState(
    _env_seed % (2 ** 32) if _env_seed is not None else None)
_host_pyrng = _pyrandom.Random(_env_seed)
# the seed every device generator starts from: set by seed() or
# MXTPU_SEED, else drawn from the host stream at the first use
_base = _env_seed
_gens = {}                      # torch.device -> torch.Generator
_run_rng = _pyrandom.Random(_env_seed)


def host_rng():
    """The framework's host-side numpy stream (initializers, shuffles)."""
    return _host_rng


def host_pyrng():
    """The framework's host-side stdlib stream."""
    return _host_pyrng


def seed(seed_state):
    """Seed every framework stream: each device's generator (those made
    later too), the host numpy and stdlib streams and the per-run seeds."""
    global _base
    s = int(seed_state)
    with _lock:
        _base = s
        for g in _gens.values():
            g.manual_seed(s)
        _host_rng.seed(s % (2 ** 32))
        _host_pyrng.seed(s)
        _run_rng.seed(s)


def _base_seed():
    global _base
    if _base is None:
        _base = int(_host_rng.randint(0, 2 ** 31 - 1))
        _run_rng.seed(_base)
    return _base


def generator(device):
    """The generator of ``device`` (a torch.device or its name)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    with _lock:
        g = _gens.get(device)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed(_base_seed())
            _gens[device] = g
        return g


def next_seed():
    """A fresh seed for one run of a graph (the executor's step key)."""
    with _lock:
        _base_seed()
        return _run_rng.getrandbits(62)


def node_generator(device, run_seed, index):
    """The generator of node ``index`` in a run seeded ``run_seed``, as the
    JAX executor folds the node's index into the step's key: the same run
    seed and index give the same draws, a recompute included."""
    g = torch.Generator(device=device)
    g.manual_seed((run_seed * 0x9E3779B97F4A7C15 + index) % (2 ** 63))
    return g


def get_state():
    """Snapshot every stream: each device generator's state (a uint8
    array), the base seed, the per-run seed stream, and the host numpy and
    stdlib streams as JSON-serializable lists."""
    with _lock:
        gens = {str(d): g.get_state().numpy().copy() for d, g in _gens.items()}
        base = _base
        run = _run_rng.getstate()
    st = _host_rng.get_state()
    np_state = [st[0], _np.asarray(st[1]).tolist(), int(st[2]), int(st[3]),
                float(st[4])]

    def _listify(obj):
        if isinstance(obj, tuple):
            return [_listify(x) for x in obj]
        return obj

    return {'generators': gens, 'base': base, 'run': _listify(run),
            'numpy': np_state, 'python': _listify(_host_pyrng.getstate())}


def set_state(state):
    """Restore a :func:`get_state` snapshot: the streams continue exactly
    where the saved run left them."""
    global _base

    def _tupleize(obj):
        if isinstance(obj, list):
            return tuple(_tupleize(x) for x in obj)
        return obj

    with _lock:
        _base = state.get('base')
        for name, arr in (state.get('generators') or {}).items():
            dev = torch.device(name)
            g = _gens.get(dev)
            if g is None:
                g = _gens[dev] = torch.Generator(device=dev)
            g.set_state(torch.from_numpy(_np.asarray(arr, _np.uint8)))
        if state.get('run') is not None:
            _run_rng.setstate(_tupleize(state['run']))
    np_state = state.get('numpy')
    if np_state is not None:
        _host_rng.set_state((np_state[0], _np.asarray(np_state[1], _np.uint32),
                             int(np_state[2]), int(np_state[3]),
                             float(np_state[4])))
    py_state = state.get('python')
    if py_state is not None:
        _host_pyrng.setstate(_tupleize(py_state))


def _sampler(op_name):
    def fn(*args, **kwargs):
        from . import ndarray as _nd
        return getattr(_nd, op_name)(*args, **kwargs)
    fn.__name__ = op_name
    fn.__doc__ = 'mx.random.%s: the op nd.%s' % (op_name, op_name)
    return fn


uniform = _sampler('uniform')
normal = _sampler('normal')
gamma = _sampler('random_gamma')
exponential = _sampler('random_exponential')
poisson = _sampler('random_poisson')
negative_binomial = _sampler('random_negative_binomial')
generalized_negative_binomial = _sampler(
    'random_generalized_negative_binomial')
