"""The port's fused fit window (``mxnet_tpu_torch/module/fused_fit.py``)
against the JAX package's (``mxnet_tpu/module/fused_fit.py``) and against
the port's own per-batch loop.

Each case fits the same net from the same parameters (drawn with numpy
from a seed) over the same NDArrayIter batches for 2 epochs, W = 4 on both
sides: the port's ``Module.fit`` with the window (its default), the JAX
package's with its window (its default on the CPU), and the port's with
``MXTPU_FUSED_FIT=0``. The parameters and aux states after the fit, and
the metric at every batch end, are held to 1e-5 (absolute and relative)
in f32. The net is an MLP with a BatchNorm (10 -> 16 without a bias -> BN
-> relu -> 6 classes under SoftmaxOutput), batch 8. Each JAX fit is run
once and shared between the tests through a module-scoped cache.

The cases port those of the JAX package's ``tests/unittest/
test_fused_fit.py`` that need no mesh: one window and a tail, exactly one
window, the kvstore modes, the optimizers with a plan, ``grad_req='add'``,
a composite metric, a custom metric in host-metric mode, a FactorScheduler
boundary inside a window (the sampled lr exact), an iterator that reuses
its buffers, the loop's reuse across fit calls and its rebuild, each
eligibility gate, the exhausted iterator, and ``chip_smoke.py`` phase
(m2)'s head at narrow widths through windowed fit and score with and
without ``MXTPU_FORCE_PALLAS``. bf16 weights without multi-precision (the
JAX window's f32 lr promotes their update to f32) are held on one layer
over integer inputs to a bf16 ulp of the JAX window, and each update op's
promotion beside an f32 tensor lr to the jnp op's. Also: the serial
upload and the timing log, and an error inside a window.
"""
import contextlib
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.module import window_pipeline
from mxnet_tpu_torch.module.fused_fit import FusedFitLoop

TOL = 1e-5
BATCH, FEATURES, CLASSES = 8, 10, 6
# the window's flags, the flags that make fit raise and the resilience
# tier's: cleared for every test (tests of the JAX package elsewhere may
# leave one set)
WINDOW_FLAGS = ('MXTPU_FUSED_FIT', 'MXTPU_FUSED_EVAL',
                'MXTPU_FIT_STEPS_PER_CALL', 'MXTPU_EVAL_STEPS_PER_CALL',
                'MXTPU_FUSED_FIT_PREFETCH', 'MXTPU_FUSED_EVAL_PREFETCH',
                'MXTPU_FORCE_PALLAS', 'MXTPU_SHARDED_UPDATE',
                'MXTPU_GRAD_COMPRESS', 'MXTPU_HEALTH', 'MXTPU_DYNAMICS',
                'MXTPU_TELEMETRY', 'MXTPU_CKPT_DIR', 'MXTPU_FAULT_INJECT',
                'MXTPU_HEALTH_ACTION', 'MXTPU_CKPT_EVERY', 'MXTPU_CKPT_ASYNC',
                'MXTPU_CKPT_RESUME', 'MXTPU_CKPT_KEEP', 'MXTPU_FAULT_HOST')


@pytest.fixture(autouse=True)
def _clean_flags(monkeypatch):
    for name in WINDOW_FLAGS:
        monkeypatch.delenv(name, raising=False)
    mt.config.flags.reload()
    yield
    mt.config.flags.reload()


@contextlib.contextmanager
def _env(**values):
    """Set (a str) or unset (None) environment flags for both packages,
    restoring them after."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        mt.config.flags.reload()
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        mt.config.flags.reload()


def _symbol(pkg, net):
    S = pkg.sym
    x = S.var('data')
    if net == 'fc_bf16':
        # bf16 weights (the Cast makes the layer's weight and bias infer
        # bf16) over small integer inputs: every product and sum of the
        # forward and backward is exact, so both packages compute the same
        # gradients and differ only where their updates would
        out = S.Cast(S.FullyConnected(S.Cast(x, dtype='bfloat16'),
                                      num_hidden=CLASSES, name='fc'),
                     dtype='float32')
    else:
        # no bias before the BatchNorm, which would leave it a gradient of
        # rounding noise that Adam and RMSProp scale up to a step
        h = S.FullyConnected(x, num_hidden=16, no_bias=True, name='fc1')
        h = S.Activation(S.BatchNorm(h, name='bn1'), act_type='relu')
        out = S.FullyConnected(h, num_hidden=CLASSES, name='fc2')
    return S.SoftmaxOutput(out, name='softmax')


def _data(n, seed=0, integer=False):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, FEATURES)).astype(np.float32)
    if integer:
        X = np.round(X)
    y = rng.randint(0, CLASSES, n).astype(np.float32)
    return X, y


def _iter(pkg, n, seed=0, integer=False):
    X, y = _data(n, seed, integer)
    return pkg.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=False,
                              label_name='softmax_label')


def _values(sym, seed=1):
    """Parameters and aux states drawn with numpy for the net: weights
    N(0, 0.3), biases and betas 0, gammas and variances 1."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(BATCH, FEATURES))
    a, x = {}, {}
    for k, shape in sorted(zip(sym.list_arguments(), arg_shapes)):
        if k in ('data', 'softmax_label'):
            continue
        if k.endswith('_weight'):
            a[k] = (0.3 * rng.standard_normal(shape)).astype(np.float32)
        else:
            a[k] = np.full(shape, 1.0 if k.endswith('_gamma') else 0.0,
                           np.float32)
    for k, shape in sorted(zip(sym.list_auxiliary_states(), aux_shapes)):
        x[k] = np.full(shape, 1.0 if k.endswith('_var') else 0.0,
                       np.float32)
    return a, x


def _feval(label, pred):
    return float(np.mean(np.abs(pred[np.arange(len(label)),
                                     label.astype(int)] - 1.0)))


def _metric(pkg, key):
    if key == 'comp':
        m = pkg.metric.CompositeEvalMetric()
        m.add('acc')
        m.add(pkg.metric.TopKAccuracy(top_k=3))
        m.add('ce')
        return m
    if key == 'custom':
        return pkg.metric.CustomMetric(_feval, name='dist')
    return pkg.metric.create(key)


def _opt_params(pkg, cfg):
    params = dict(cfg['opt_params'])
    if cfg.get('sched'):
        params['lr_scheduler'] = pkg.lr_scheduler.FactorScheduler(
            step=cfg['sched'], factor=0.5)
    return params


def _module(pkg, cfg, it):
    sym = _symbol(pkg, cfg['net'])
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label,
             grad_req=cfg['grad_req'])
    vals = _values(sym)
    dtype = 'bfloat16' if cfg['net'] == 'fc_bf16' else None
    mod.init_params(
        arg_params={k: pkg.nd.array(v, ctx=pkg.cpu(), dtype=dtype)
                    for k, v in vals[0].items()},
        aux_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                    for k, v in vals[1].items()})
    return mod


def _state(mod):
    args, aux = mod.get_params()
    return {k: v.asnumpy().astype(np.float32)
            for k, v in list(args.items()) + list(aux.items())}


DEFAULT = dict(net='mlp_bn', n=56, optimizer='sgd',
               opt_params=(('learning_rate', 0.1), ('momentum', 0.9),
                           ('wd', 1e-4)),
               grad_req='write', metric='acc', kvstore='local', sched=None)


def _cfg(**kw):
    cfg = dict(DEFAULT)
    cfg.update(kw)
    return cfg


def _key(cfg):
    return tuple(sorted(cfg.items()))


def _fit(pkg, cfg, fused, it=None, epochs=2):
    """(state after the fit, [(epoch, nbatch, metric values)] at each batch
    end, the module)."""
    with _env(MXTPU_FUSED_FIT='1' if fused else '0'):
        it = it or _iter(pkg, cfg['n'], integer=cfg['net'] == 'fc_bf16')
        mod = _module(pkg, cfg, it)
        kv = cfg['kvstore']
        if kv == 'kvobj':
            kv = pkg.kv.create('local')
        seen = []
        mod.fit(it, num_epoch=epochs, optimizer=cfg['optimizer'],
                optimizer_params=_opt_params(pkg, cfg), kvstore=kv,
                eval_metric=_metric(pkg, cfg['metric']),
                batch_end_callback=lambda p: seen.append(
                    (p.epoch, p.nbatch,
                     tuple(v for _, v in p.eval_metric.get_name_value()))))
        return _state(mod), seen, mod


@pytest.fixture(scope='module')
def jax_fits():
    """The JAX package's windowed fits, each run once in this module."""
    memo = {}

    def get(cfg):
        k = _key(cfg)
        if k not in memo:
            memo[k] = _fit(mx, cfg, True)
        return memo[k]
    return get


def _assert_close(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


def _assert_traj(got, want, tol=TOL):
    assert [s[:2] for s in got] == [s[:2] for s in want]
    np.testing.assert_allclose(np.array([s[2] for s in got], np.float64),
                               np.array([s[2] for s in want], np.float64),
                               rtol=tol, atol=1e-7)


def _check(cfg, jax_fits, windows):
    """The port's window against the JAX window and the port's per-batch
    loop; ``windows`` the windows the port's fit must have run."""
    jstate, jseen, jmod = jax_fits(cfg)
    assert '_fused_fit_cache' in jmod.__dict__     # the JAX side's window
    state, seen, mod = _fit(mt, cfg, True)
    loop = mod.__dict__['_fused_fit_cache'][1]
    assert loop.windows == windows
    ref, ref_seen, ref_mod = _fit(mt, cfg, False)
    assert '_fused_fit_cache' not in ref_mod.__dict__
    _assert_close(state, jstate)
    _assert_close(state, ref)
    _assert_traj(seen, jseen)
    _assert_traj(seen, ref_seen)
    return state, seen, mod


@pytest.mark.parametrize('n,windows,tail', [(56, 2, 3), (32, 2, 0)],
                         ids=['window_and_tail', 'exactly_one_window'])
def test_window_matches_jax_window_and_per_batch_loop(jax_fits, n, windows,
                                                      tail):
    """7 batches an epoch (one window and a tail of 3 through the per-batch
    loop) and exactly W batches (the results of the only window applied
    after the loop, one window late)."""
    _, seen, mod = _check(_cfg(n=n), jax_fits, windows)
    assert mod.__dict__['_fused_fit_cache'][1].tail_batches == 2 * tail
    assert [s[:2] for s in seen] == \
        [(e, b) for e in range(2) for b in range(n // BATCH)]


@pytest.mark.parametrize('kvstore', ['device', None, 'kvobj'])
def test_kvstore_modes(jax_fits, kvstore):
    """'device' and None give no store on one device; a KVStore object
    updates on the store (the window keeps the store's copy)."""
    _, _, mod = _check(_cfg(kvstore=kvstore), jax_fits, 2)
    assert bool(mod._update_on_kvstore) == (kvstore == 'kvobj')


@pytest.mark.parametrize('opt,params', [
    ('sgd', (('learning_rate', 0.1),)),
    ('nag', (('learning_rate', 0.05), ('momentum', 0.9))),
    ('adam', (('learning_rate', 0.01),)),
    ('rmsprop', (('learning_rate', 0.01),)),
    ('rmsprop', (('learning_rate', 0.01), ('centered', True))),
    ('ftrl', (('learning_rate', 0.1),)),
], ids=['sgd_plain', 'nag', 'adam', 'rmsprop', 'rmsprop_centered', 'ftrl'])
def test_other_optimizers(jax_fits, opt, params):
    """Each optimizer plan's op, attrs and state order, and Adam's bias
    correction folded into each step's lr."""
    _check(_cfg(optimizer=opt, opt_params=params + (('wd', 1e-4),)),
           jax_fits, 2)


def test_grad_req_add(jax_fits):
    """grad_req='add' carries the accumulators through the window and
    writes them back: the gradient arrays equal too."""
    cfg = _cfg(grad_req='add')
    _, _, mod = _check(cfg, jax_fits, 2)
    _, _, ref = _fit(mt, cfg, False)
    _, _, jmod = jax_fits(cfg)
    grads = [{n: g.asnumpy() for n, g in m._exec_group.execs[0].grad_dict
              .items() if g is not None} for m in (mod, ref, jmod)]
    _assert_close(grads[0], grads[2])
    _assert_close(grads[0], grads[1])


def test_composite_metric(jax_fits):
    """acc, top-3 and ce as statistics on the device: each child's value
    at every batch end."""
    _check(_cfg(metric='comp'), jax_fits, 2)


@pytest.mark.parametrize('metric', ['custom', 'mse'])
def test_host_metric_mode(jax_fits, metric):
    """A metric without a plan: the window stacks the outputs, fetched once
    a window, and the metric's own update replays them on the host."""
    _, _, mod = _check(_cfg(metric=metric), jax_fits, 2)
    loop = mod.__dict__['_fused_fit_cache'][1]
    assert loop.stat_fns is None
    assert loop.fetches == loop.windows     # one output a window


def test_scheduler_boundary_inside_a_window(jax_fits, monkeypatch):
    """FactorScheduler(step=3) halves lr inside the first window: each
    step's sampled lr is the scheduler's at that update count, exactly,
    and one program serves every window."""
    rows = []
    orig = FusedFitLoop._sample_window_lr

    def sample(self):
        lr, wd = orig(self)
        rows.append(lr.copy())
        return lr, wd
    monkeypatch.setattr(FusedFitLoop, '_sample_window_lr', sample)
    cfg = _cfg(sched=3, opt_params=(('learning_rate', 0.2),
                                    ('momentum', 0.9)))
    _, _, mod = _check(cfg, jax_fits, 2)
    sched = mt.lr_scheduler.FactorScheduler(step=3, factor=0.5)
    sched.base_lr = 0.2
    # the windows run updates 1-4 (epoch 1) and 8-11 (epoch 2)
    want = [np.float32(sched(u)) for u in list(range(1, 5)) +
            list(range(8, 12))]
    got = [row[0] for lr in rows for row in lr]
    assert got == want, (got, want)
    # the lr halves inside both windows (at updates 4 and 10)
    assert want[2] != want[3] and want[5] != want[6]
    assert all((lr == lr[:, :1]).all() for lr in rows)
    assert len(mod.__dict__['_fused_fit_cache'][1]._programs) == 1


def test_bf16_weights_without_multi_precision(jax_fits):
    """SGD with momentum on bf16 weights and states, no master copy. The
    JAX window's traced lr and wd are f32, so each update computes in f32
    and is cast back to bf16; the port's window does the same, and its
    weights and momentum states stay bf16. XLA keeps more precision inside
    its fused bf16 arithmetic than torch's per-op rounding, so the two
    windows agree to one bf16 ulp of each array's largest value."""
    cfg = _cfg(net='fc_bf16', n=32)
    jstate, _, jmod = jax_fits(cfg)
    assert '_fused_fit_cache' in jmod.__dict__
    state, _, mod = _fit(mt, cfg, True)
    assert mod.__dict__['_fused_fit_cache'][1].windows == 2
    args = mod.get_params()[0]
    moms = mod._updater.states
    assert {str(a.dtype) for a in args.values()} == {'bfloat16'}
    assert {str(m.dtype) for m in moms.values()} == {'bfloat16'}
    assert sorted(state) == sorted(jstate)
    for k, want in jstate.items():
        np.testing.assert_allclose(state[k], want, rtol=0,
                                   atol=2.0 ** -7 * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize('op', ['sgd_update', 'sgd_mom_update',
                                'nag_mom_update', 'adam_update',
                                'rmsprop_update', 'rmspropalex_update',
                                'ftrl_update'])
def test_window_lr_promotes_as_jnp(op):
    """The window hands each update op its lr and wd as f32 0-d tensors,
    the strong f32 scalars of the JAX window: beside bf16 weights, grads
    and states each op then computes in f32 as jnp does (eagerly, one
    rounding an op), where a Python lr would keep it in bf16."""
    import jax.numpy as jnp
    import torch
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg
    n_in = len(treg.get(op).input_names)
    rng = np.random.RandomState(3)
    ins = [rng.standard_normal((4, 5)).astype(np.float32)
           for _ in range(n_in)]
    # the states (means of squares among them) nonnegative
    ins = ins[:2] + [np.abs(a) for a in ins[2:]]
    attrs = {'momentum': 0.9, 'rescale_grad': 0.125, 'clip_gradient': -1.0}
    tin = [torch.from_numpy(a).to(torch.bfloat16) for a in ins]
    jin = [jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in tin]
    got = treg.get(op).fn(dict(attrs, lr=torch.tensor(0.1),
                               wd=torch.tensor(1e-3)), *tin)
    want = jreg.get(op).fn(dict(attrs, lr=jnp.float32(0.1),
                                wd=jnp.float32(1e-3)), *jin)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).split('.')[-1] == str(w.dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-6,
                                   atol=1e-7)
    # and the weight's result is f32 beside bf16 inputs
    assert got[0].dtype == torch.float32


class _ReusingIter:
    """Yields the same DataBatch and NDArrays every batch, writing each
    batch into them: by ``[:] =`` (which rebinds the NDArray's tensor) or in
    place into the tensor (``handle.copy_``, which a jax array cannot do)."""

    def __init__(self, X, Y, write):
        self.X, self.Y, self.write = X, Y, write
        self._data = mt.nd.zeros((BATCH, X.shape[1]), ctx=mt.cpu())
        self._label = mt.nd.zeros((BATCH,), ctx=mt.cpu())
        self._b = mt.io.DataBatch(data=[self._data], label=[self._label],
                                  pad=0)
        self.provide_data = [mt.io.DataDesc('data', (BATCH, X.shape[1]))]
        self.provide_label = [mt.io.DataDesc('softmax_label', (BATCH,))]
        self.batch_size = BATCH
        self._i = 0

    def __iter__(self):
        return self

    def reset(self):
        self._i = 0

    def __next__(self):
        if (self._i + 1) * BATCH > len(self.X):
            raise StopIteration
        sl = slice(self._i * BATCH, (self._i + 1) * BATCH)
        for arr, src in ((self._data, self.X[sl]), (self._label, self.Y[sl])):
            if self.write == 'inplace':
                arr.handle.copy_(mt.nd.array(src, ctx=mt.cpu()).handle)
            else:
                arr[:] = src
        self._i += 1
        return self._b

    next = __next__


@pytest.mark.parametrize('write', ['setitem', 'inplace'])
@pytest.mark.parametrize('metric', ['acc', 'mse'])
def test_buffer_reusing_iterator(write, metric):
    """The window copies each batch at draw time: the data, the labels,
    the tail and host-metric mode's deferred update each see the batch's
    own values. The reference is the per-batch loop on a fresh-buffer
    iterator over the same data (the per-batch loop on the reusing iterator
    reads the labels after its draw of the next batch overwrote them, as
    the reference loop does)."""
    cfg = _cfg(metric=metric)
    X, y = _data(cfg['n'])
    state, seen, mod = _fit(mt, cfg, True, it=_ReusingIter(X, y, write))
    assert mod.__dict__['_fused_fit_cache'][1].windows == 2
    ref, ref_seen, _ = _fit(mt, cfg, False)
    _assert_close(state, ref)
    _assert_traj(seen, ref_seen)


def test_identity_cache_keys_on_versions():
    """The upload's cache: the same unchanged tensors drawn again give the
    cached stacks; an in-place write into them misses."""
    from mxnet_tpu_torch.module.window_pipeline import WindowPipeline
    import torch
    x = torch.arange(6.0).reshape(2, 3)
    lab = torch.zeros(2)
    b = mt.io.DataBatch(data=[mt.nd.from_torch(x)],
                        label=[mt.nd.from_torch(lab)])
    pipe = WindowPipeline(2, lambda: torch.device('cpu'))

    def window():
        snaps, drawn = pipe.collect(iter([b, b]))
        return pipe.device_batches(snaps, drawn)
    first = window()
    assert window() is first
    x.add_(1.0)
    third = window()
    assert third is not first
    assert torch.equal(third[0][0][1], x)


def test_loop_reused_across_fit_calls_and_rebuilt():
    """An epoch at a time: the same loop and program on each call, and the
    trajectory of one fit over both epochs; an equal-config fresh metric
    reuses the loop and takes its statistics; another metric configuration
    or another optimizer builds a new loop; the flag off drops it."""
    cfg = _cfg(n=64)
    it = _iter(mt, cfg['n'])
    mod = _module(mt, cfg, it)
    fit = dict(optimizer='sgd', optimizer_params=_opt_params(mt, cfg),
               kvstore='local')
    first = None
    for epoch in range(2):
        mod.fit(it, num_epoch=epoch + 1, begin_epoch=epoch,
                eval_metric='acc', **fit)
        _, loop = mod.__dict__['_fused_fit_cache']
        progs = [id(p) for p in loop._programs.values()]
        if first is None:
            first = (loop, progs)
            assert len(progs) == 1
        else:
            assert loop is first[0] and progs == first[1]
    whole, _, _ = _fit(mt, cfg, True)
    _assert_close(_state(mod), whole)
    m2 = mt.metric.create('acc')
    mod.fit(it, num_epoch=1, eval_metric=m2, **fit)
    assert mod.__dict__['_fused_fit_cache'][1] is first[0]
    assert first[0].children == [m2] and m2.num_inst == 64
    mod.fit(it, num_epoch=1, eval_metric=mt.metric.TopKAccuracy(top_k=3),
            **fit)
    loop_c = mod.__dict__['_fused_fit_cache'][1]
    assert loop_c is not first[0]
    mod.init_optimizer(optimizer='sgd', optimizer_params=(
        ('learning_rate', 0.05),), force_init=True)
    mod.fit(it, num_epoch=1, eval_metric=mt.metric.TopKAccuracy(top_k=3),
            **fit)
    assert mod.__dict__['_fused_fit_cache'][1] is not loop_c
    with _env(MXTPU_FUSED_FIT='0'):
        mod.fit(it, num_epoch=1, eval_metric='acc', **fit)
    assert '_fused_fit_cache' not in mod.__dict__


def _gated(gate, monkeypatch):
    """A module bound and given an optimizer as ``gate`` says, and the
    metric to build with."""
    cfg = _cfg()
    it = _iter(mt, cfg['n'])
    metric = mt.metric.create('acc')
    ctx = [mt.cpu(0), mt.cpu(1)] if gate == 'two_contexts' else mt.cpu()
    cls = mt.mod.Module
    if gate == 'subclass':
        class MyModule(mt.mod.Module):
            pass
        cls = MyModule
    sym = _symbol(mt, 'fc_bf16' if gate == 'adam_multi_precision'
                  else 'mlp_bn')
    mod = cls(sym, context=ctx)
    mod.bind(it.provide_data, it.provide_label,
             inputs_need_grad=(gate == 'inputs_need_grad'),
             grad_req='null' if gate == 'grad_req_null' else 'write')
    mod.init_params()
    kv, opt, params = 'local', 'sgd', {'learning_rate': 0.1}
    if gate == 'adadelta':
        opt, params = 'adadelta', {}
    if gate == 'adam_multi_precision':
        opt, params = 'adam', {'multi_precision': True}
    if gate == 'dist_kvstore':
        kv = mt.kv.create('local')
        kv.type = 'dist_async'
    mod.init_optimizer(kvstore=kv, optimizer=opt, optimizer_params=params)
    if gate == 'stack_cap':
        monkeypatch.setattr(window_pipeline, 'OUT_STACK_CAP', 1)
        metric = mt.metric.create('mse')
    return mod, metric


@pytest.mark.parametrize('gate', [
    'flag_off', 'subclass', 'two_contexts', 'inputs_need_grad',
    'grad_req_null', 'adadelta', 'adam_multi_precision', 'dist_kvstore',
    'stack_cap'])
def test_eligibility_gates(monkeypatch, gate):
    """Each gate makes build() decline, and fit runs the per-batch loop."""
    mod, metric = _gated(gate, monkeypatch)
    if gate == 'flag_off':
        monkeypatch.setenv('MXTPU_FUSED_FIT', '0')
    assert FusedFitLoop.build(mod, metric) is None
    assert FusedFitLoop.build_cached(mod, metric) is None
    assert '_fused_fit_cache' not in mod.__dict__


def test_eligible_module_builds(monkeypatch):
    """The same set-up without a gate builds the window, in stats mode for
    acc and in host-metric mode for mse."""
    mod, _ = _gated('none', monkeypatch)
    assert FusedFitLoop.build(mod, mt.metric.create('acc')).stat_fns
    assert FusedFitLoop.build(mod, mt.metric.create('mse')).stat_fns is None


def test_exhausted_iterator_raises():
    """An iterator left drained raises StopIteration out of the windowed
    fit, as the per-batch loop's first next() does."""
    cfg = _cfg(n=64)
    it = _iter(mt, cfg['n'])
    mod = _module(mt, cfg, it)
    mod.fit(it, num_epoch=1, optimizer_params=_opt_params(mt, cfg))
    for _ in it:
        pass
    with pytest.raises(StopIteration):
        mod.fit(it, num_epoch=2, begin_epoch=1,
                optimizer_params=_opt_params(mt, cfg))


def _head(pkg):
    S = pkg.sym
    logits = S.Cast(S.FullyConnected(S.LayerNorm(S.var('x'), name='ln'),
                                     num_hidden=64, no_bias=True,
                                     name='head'), dtype='float32')
    return S.MakeLoss(S.softmax_cross_entropy(logits, S.var('label')))


@pytest.mark.parametrize('kernels', ['plain', 'force_pallas'])
def test_kernel_head_through_windowed_fit_and_score(kernels):
    """chip_smoke.py phase (m2)'s head at narrow widths (16 rows of 32, 64
    classes, 4 batches: one fit window and one score window, 'loss' in
    host-metric mode). With MXTPU_FORCE_PALLAS the JAX side runs its Pallas
    kernels in interpret mode and the port the kernels' plain versions."""
    rng = np.random.RandomState(5)
    X = rng.standard_normal((64, 32)).astype(np.float32)
    y = rng.randint(0, 64, 64).astype(np.int32)
    out = []
    with _env(MXTPU_FORCE_PALLAS='1' if kernels == 'force_pallas' else None):
        for pkg in (mx, mt):
            it = pkg.io.NDArrayIter({'x': X}, {'label': y}, batch_size=16)
            mod = pkg.mod.Module(_head(pkg), data_names=('x',),
                                 label_names=('label',), context=pkg.cpu())
            mod.bind(it.provide_data, it.provide_label)
            w = np.random.RandomState(9).standard_normal((64, 32)) * 0.2
            mod.init_params(arg_params={
                'ln_gamma': pkg.nd.ones((32,), ctx=pkg.cpu()),
                'ln_beta': pkg.nd.zeros((32,), ctx=pkg.cpu()),
                'head_weight': pkg.nd.array(w.astype(np.float32),
                                            ctx=pkg.cpu())})
            losses = []
            mod.fit(it, num_epoch=1, optimizer='sgd',
                    optimizer_params={'learning_rate': 0.1, 'momentum': 0.9,
                                      'wd': 1e-4},
                    eval_metric='loss', batch_end_callback=lambda p:
                    losses.append(p.eval_metric.get()[1]))
            scored = []
            score = mod.score(it, 'loss', batch_end_callback=lambda p:
                              scored.append(p.eval_metric.get()[1]))[0][1]
            assert '_fused_fit_cache' in mod.__dict__
            assert 'score' in mod.__dict__['_fused_eval_cache']
            out.append((losses, scored, score, _state(mod)))
    (jl, jsc, js, jp), (tl, tsc, ts, tp) = out
    assert len(tl) == len(tsc) == 4
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    np.testing.assert_allclose(tsc, jsc, rtol=TOL)
    np.testing.assert_allclose(ts, js, rtol=TOL)
    _assert_close(tp, jp)


@pytest.mark.parametrize('prefetch', ['0', '1'])
def test_serial_upload_and_timing_log(caplog, prefetch):
    """MXTPU_FUSED_FIT_PREFETCH=0 uploads each window in turn on the main
    thread, with the same result; MXTPU_FUSED_FIT_TIMING=1 logs each
    epoch's host stages."""
    import logging
    cfg = _cfg()
    ref, ref_seen, _ = _fit(mt, cfg, True)
    with _env(MXTPU_FUSED_FIT_PREFETCH=prefetch, MXTPU_FUSED_FIT_TIMING='1'):
        with caplog.at_level(logging.INFO):
            state, seen, mod = _fit(mt, cfg, True)
    assert (mod.__dict__['_fused_fit_cache'][1]._pipe._pool_obj is None) \
        == (prefetch == '0')
    _assert_close(state, ref, tol=0)
    _assert_traj(seen, ref_seen, tol=0)
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith('fused_fit timing')]
    assert [l.split()[2] for l in lines] == ['epoch=0', 'epoch=1']


def test_error_inside_a_window_raises(monkeypatch):
    """An error inside a built window raises out of fit; its batches are
    not rerun one at a time."""
    def broken(self, static_attrs):
        def window_fn(*args):
            raise RuntimeError('a step of the window failed')
        return window_fn
    monkeypatch.setattr(FusedFitLoop, '_build_program', broken)
    cfg = _cfg()
    it = _iter(mt, cfg['n'])
    mod = _module(mt, cfg, it)
    seen = []
    with pytest.raises(RuntimeError, match='a step of the window failed'):
        mod.fit(it, num_epoch=1, optimizer_params=_opt_params(mt, cfg),
                batch_end_callback=lambda p: seen.append(p.nbatch))
    assert seen == []
