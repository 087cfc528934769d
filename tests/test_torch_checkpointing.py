"""The port's checkpoint store, checkpointer and restart loop
(``mxnet_tpu_torch/parallel/checkpoint.py``, ``module/checkpointing.py``,
``module/resilient_fit.py``) against the JAX package's.

The net is the JAX resilience tests' MLP (``tests/unittest/
test_resilience.py``: 10 -> 16 -> relu -> 4 under SoftmaxOutput, 32 rows
of 10, batch 8, sgd 0.1), from the same numpy parameters in both packages,
with telemetry, health (action raise) and checkpoints every 2 steps into
a ``tmp_path`` directory, and no backoff.

- the store: a round trip bit for bit onto the template's dtypes,
  ``max_to_keep``, the meta sidecar, ``delete_step``, a truncated or
  missing data file raising, and ``template_shapes``/``validate_shapes``
  equal to the JAX package's;
- kill and resume on the fused window and on the per-batch loop (nan-grad
  under health's raise, dispatch-exception at the window's, the
  executor's and the kvstore's seams): within the port the faulted run
  ends bit for bit on its own uninterrupted run; against the JAX
  package's same faulted run the final parameters agree within 1e-5 of
  the largest |value|, with the same restart count, last-good step,
  restore step and incident step;
- a corrupt checkpoint falls back to the older step; a fresh fit resumes
  from the last good one; the warn action never certifies a capture taken
  after the incident; resume off starts fresh; a fused capture's metric
  covers the steps it claims;
- the restart budget is exhausted, and a non-retryable error raises at
  once.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import faults as jfaults
from mxnet_tpu import telemetry as jtele
from mxnet_tpu.module.resilient_fit import resilient_fit as jresilient
from mxnet_tpu.parallel import checkpoint as jstore
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch import telemetry as ttele
from mxnet_tpu_torch.module import checkpointing as tckpt
from mxnet_tpu_torch.module.resilient_fit import (is_retryable,
                                                  resilient_fit as tresilient)
from mxnet_tpu_torch.parallel import checkpoint as tstore

JAX_TOL = 1e-5      # of the largest |value|: two summation orders of f32
FLAGS = ('MXTPU_TELEMETRY', 'MXTPU_TELEMETRY_PATH', 'MXTPU_HEALTH',
         'MXTPU_HEALTH_ACTION', 'MXTPU_CKPT_DIR', 'MXTPU_CKPT_EVERY',
         'MXTPU_CKPT_KEEP', 'MXTPU_CKPT_ASYNC', 'MXTPU_CKPT_RESUME',
         'MXTPU_RESTART_MAX', 'MXTPU_RESTART_BACKOFF', 'MXTPU_FAULT_INJECT',
         'MXTPU_FUSED_FIT', 'MXTPU_FIT_STEPS_PER_CALL', 'MXTPU_DYNAMICS')


def _reset():
    for pkg in (mx, mt):
        pkg.config.flags.reload()
    jtele._reset_for_tests()
    ttele._reset_for_tests()
    jfaults._reset_for_tests()
    tfaults._reset_for_tests()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    _reset()
    yield
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    _reset()


@pytest.fixture
def res_env(tmp_path, monkeypatch):
    """Telemetry, health (raise) and checkpoints every 2 steps; each
    package checkpoints into its own directory."""
    env = {'MXTPU_TELEMETRY': '1', 'MXTPU_HEALTH': '1',
           'MXTPU_HEALTH_ACTION': 'raise', 'MXTPU_CKPT_EVERY': '2',
           'MXTPU_RESTART_BACKOFF': '0'}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _reset()
    return {'tmp': tmp_path, 'mp': monkeypatch}


def _set(env, **values):
    for k, v in values.items():
        if v is None:
            env['mp'].delenv(k, raising=False)
        else:
            env['mp'].setenv(k, str(v))
    _reset()


def _data(n=32):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 10).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.float32)
    init = {k: (0.3 * rng.randn(*s)).astype(np.float32) for k, s in
            (('fc1_weight', (16, 10)), ('fc1_bias', (16,)),
             ('fc2_weight', (4, 16)), ('fc2_bias', (4,)))}
    return X, y, init


def _sym(pkg):
    d = pkg.sym.Variable('data')
    h = pkg.sym.Activation(pkg.sym.FullyConnected(d, num_hidden=16,
                                                  name='fc1'),
                           act_type='relu')
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(h, num_hidden=4,
                                                        name='fc2'),
                                 name='softmax')


def _run(pkg, env, num_epoch=4, resilient=False, ckpt=True, kvstore='local',
         n=32, callback=None):
    """One fit of the MLP; (module, restarts). ``ckpt`` names the
    package's own checkpoint directory (off: no checkpoints)."""
    tag = 'jax' if pkg is mx else 'torch'
    os.environ['MXTPU_TELEMETRY_PATH'] = str(env['tmp'] / ('%s.jsonl' % tag))
    if ckpt:
        os.environ['MXTPU_CKPT_DIR'] = str(env['tmp'] / ('ckpt_' + tag))
    else:
        os.environ.pop('MXTPU_CKPT_DIR', None)
    pkg.config.flags.reload()
    X, y, init = _data(n)
    ctx = pkg.cpu()
    pkg.random.seed(0)
    mod = pkg.mod.Module(_sym(pkg), context=ctx)
    it = pkg.io.NDArrayIter(X, y, batch_size=8, label_name='softmax_label')
    if kvstore == 'instance':
        kvstore = pkg.kv.create('local')
    kw = dict(num_epoch=num_epoch, optimizer='sgd', kvstore=kvstore,
              optimizer_params=(('learning_rate', 0.1),),
              arg_params={k: pkg.nd.array(v, ctx=ctx)
                          for k, v in init.items()},
              batch_end_callback=callback)
    if resilient:
        fit = jresilient if pkg is mx else tresilient
        return mod, fit(mod, it, **kw)
    mod.fit(it, **kw)
    return mod, 0


def _params(mod):
    args, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in list(args.items()) + list(aux.items())}


def _reference(env, num_epoch=4, pkg=mt, **kw):
    """The uninterrupted run: no fault, no checkpoints."""
    old = os.environ.pop('MXTPU_FAULT_INJECT', None)
    _reset()
    try:
        mod, _ = _run(pkg, env, num_epoch=num_epoch, ckpt=False, **kw)
    finally:
        if old is not None:
            os.environ['MXTPU_FAULT_INJECT'] = old
    return _params(mod)


def _bitwise(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _near_jax(got, want):
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=JAX_TOL * scale, err_msg=k)


def _outcome(pkg, mod, restarts):
    tele = jtele if pkg is mx else ttele
    ck = mod.__dict__.get('_mxtpu_ckpt')
    hs = tele.health.snapshot_health() or {}
    inc = (hs.get('incidents') or [{}])[0]
    return {'restarts': restarts,
            'last_good': None if ck is None else ck.last_good,
            'restored_step': None if ck is None else ck.restored_step,
            'incident_step': inc.get('step'),
            'first_bad_layer': inc.get('first_bad_layer')}


def _faulted_parity(env, fault, **kw):
    """The faulted resilient run in both packages: the port's against its
    own uninterrupted run (bit for bit) and the JAX package's (1e-5, same
    outcome). Returns the port's outcome. The saves are synchronous here:
    an async writer drops a save while it is busy, and which ones it drops
    depends on each package's write time (orbax's is longer), not on the
    contract."""
    env['mp'].setenv('MXTPU_CKPT_ASYNC', '0')
    _set(env, MXTPU_FAULT_INJECT=fault)
    tmod, tres = _run(mt, env, resilient=True, **kw)
    tout = _outcome(mt, tmod, tres)
    got = _params(tmod)
    _set(env, MXTPU_FAULT_INJECT=fault)
    jmod, jres = _run(mx, env, resilient=True, **kw)
    jout = _outcome(mx, jmod, jres)
    assert tout == jout
    _near_jax(got, _params(jmod))
    _bitwise(got, _reference(env, **kw))
    return tout


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {'params': {'w': torch.randn(4, 3, generator=g),
                       'b': torch.randn(3, generator=g).to(torch.bfloat16)},
            'aux': {'mean': torch.randn(3, generator=g)},
            'opt': {'opt.0': torch.randn(4, 3, generator=g),
                    'opt.1': torch.arange(5, dtype=torch.int64)}}


def test_store_round_trip_keep_meta_delete(tmp_path):
    mngr = tstore.manager(tmp_path / 'c', max_to_keep=2)
    for step in (2, 4, 6):
        assert tstore.save(mngr, step, _tree(step), meta={'step': step})
    assert tstore.all_steps(mngr) == [4, 6] and tstore.latest_step(mngr) == 6
    assert tstore.read_meta(mngr, 4) == {'step': 4}
    template = {k: {n: torch.zeros_like(t) for n, t in v.items()}
                for k, v in _tree(0).items()}
    state, meta = tstore.restore_with_meta(mngr, template, 4)
    want = _tree(4)
    for k in want:
        for n in want[k]:
            assert state[k][n].dtype == want[k][n].dtype
            assert torch.equal(state[k][n], want[k][n])
    latest = tstore.restore(mngr, template)
    assert torch.equal(latest['params']['w'], _tree(6)['params']['w'])
    # a replayed step replaces the committed one in one rename
    tstore.save(mngr, 6, _tree(7), meta={'step': 7})
    assert tstore.read_meta(mngr, 6) == {'step': 7}
    tstore.delete_step(mngr, 4)
    assert tstore.all_steps(mngr) == [6]
    assert not [n for n in os.listdir(mngr.directory) if n.startswith('.')]


@pytest.mark.parametrize('damage', ['truncate', 'remove', 'meta'])
def test_store_damaged_step_raises(tmp_path, damage):
    mngr = tstore.manager(tmp_path / 'c')
    tstore.save(mngr, 3, _tree(3), meta={'a': 1})
    d = mngr.step_dir(3)
    if damage == 'truncate':
        with open(os.path.join(d, 'state.pt'), 'r+b') as f:
            f.truncate(2)
    elif damage == 'remove':
        os.remove(os.path.join(d, 'state.pt'))
    else:
        with open(os.path.join(d, 'meta.json'), 'r+b') as f:
            f.truncate(2)
    with pytest.raises(Exception):
        tstore.restore_with_meta(mngr, _tree(0), 3)


def test_template_shapes_and_validation_match_jax():
    tree = {k: {n: t.numpy() if t.dtype != torch.bfloat16
                else t.float().numpy() for n, t in v.items()}
            for k, v in _tree(1).items()}
    saved = jstore.template_shapes(tree)
    assert tstore.template_shapes(_tree(1)) == saved
    tstore.validate_shapes(saved, _tree(2))
    live = _tree(2)
    live['params']['w'] = torch.zeros(5, 3)
    del live['aux']['mean']
    live['aux']['var'] = torch.zeros(3)
    jlive = dict(tree, params=dict(tree['params'], w=np.zeros((5, 3))),
                 aux={'var': np.zeros(3)})
    errs = []
    for mod, t in ((jstore, jlive), (tstore, live)):
        with pytest.raises(ValueError) as e:
            mod.validate_shapes(saved, t)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

def test_kill_and_resume_parity_fused(res_env):
    """nan-grad at batch 5 (mid-window): health raises one window late,
    resilient_fit restores step 4 and resumes; the bisect names the
    input."""
    out = _faulted_parity(res_env, 'nan-grad:5')
    assert out == {'restarts': 1, 'last_good': 16, 'restored_step': 4,
                   'incident_step': 1, 'first_bad_layer': 'data'}


def test_kill_and_resume_parity_per_batch(res_env):
    """The same on the per-batch loop: the executor's sentinel raises
    before the update, so the restore lands on a step the NaN never
    touched."""
    _set(res_env, MXTPU_FUSED_FIT='0', MXTPU_CKPT_EVERY='3')
    out = _faulted_parity(res_env, 'nan-grad:5')
    assert out['restarts'] == 1 and out['restored_step'] == 3
    assert out['incident_step'] == 1 and out['first_bad_layer'] == 'data'


@pytest.mark.parametrize('fault,fused,kvstore', [
    ('dispatch-exception:5:dispatch', '1', 'local'),
    ('dispatch-exception:3:executor', '0', 'local'),
    ('dispatch-exception:6:kvstore', '0', 'instance')])
def test_dispatch_seams_restart(res_env, fault, fused, kvstore):
    _set(res_env, MXTPU_FUSED_FIT=fused)
    out = _faulted_parity(res_env, fault, kvstore=kvstore)
    assert out['restarts'] == 1 and out['incident_step'] is None


def test_corrupt_checkpoint_falls_back_to_older(res_env):
    """checkpoint-corrupt:8 truncates the newest committed step: the next
    fit falls back to step 4 and still reaches the uninterrupted run."""
    for pkg in (mt, mx):
        _set(res_env, MXTPU_FAULT_INJECT='checkpoint-corrupt:8')
        _run(pkg, res_env, num_epoch=2)       # saves at 4 and 8
        _set(res_env, MXTPU_FAULT_INJECT=None)
        mod, _ = _run(pkg, res_env, num_epoch=4)
        assert mod.__dict__['_mxtpu_ckpt'].restored_step == 4
        if pkg is mt:
            got = _params(mod)
            _bitwise(got, _reference(res_env))
        else:
            _near_jax(got, _params(mod))


def test_fresh_fit_resumes_from_last_good(res_env):
    _run(mt, res_env, num_epoch=2)
    ttele._reset_for_tests()
    mod, _ = _run(mt, res_env, num_epoch=4)
    ck = mod.__dict__['_mxtpu_ckpt']
    assert ck.restored_step == 8 and ck.last_good == 16
    _bitwise(_params(mod), _reference(res_env))


def test_resume_off_starts_fresh(res_env):
    _run(mt, res_env, num_epoch=2)
    _set(res_env, MXTPU_CKPT_RESUME='0')
    mod, _ = _run(mt, res_env, num_epoch=2)
    assert mod.__dict__['_mxtpu_ckpt'].restored_step is None
    _bitwise(_params(mod), _reference(res_env, num_epoch=2))


def test_warn_action_never_certifies_poisoned_capture(res_env):
    """Under warn the NaN trains into the parameters: every capture after
    the incident is tainted, and the pointer freezes at step 4."""
    outs = []
    for pkg in (mt, mx):
        _set(res_env, MXTPU_HEALTH_ACTION='warn',
             MXTPU_FAULT_INJECT='nan-grad:5')
        mod, _ = _run(pkg, res_env, num_epoch=4)
        tele = jtele if pkg is mx else ttele
        outs.append((mod.__dict__['_mxtpu_ckpt'].last_good,
                     tele.get_registry().counter('ckpt.uncertified').value
                     >= 1))
    assert outs[0] == outs[1] == (4, True)


def test_fused_capture_metric_covers_saved_steps(res_env, monkeypatch):
    metas = []
    real = tckpt.TrainCheckpointer._do_save

    def spy(self, step, copy, meta):
        metas.append((step, meta['metric']))
        return real(self, step, copy, meta)

    monkeypatch.setattr(tckpt.TrainCheckpointer, '_do_save', spy)
    _run(mt, res_env, num_epoch=2)
    assert metas
    for step, metric in metas:
        assert sum(n for _, _, n in metric) == (step % 4 or 4) * 8


# ---------------------------------------------------------------------------
# the restart budget
# ---------------------------------------------------------------------------

class _Failing:
    """A module whose fit fails ``n`` times with ``exc`` first."""

    def __init__(self, n, exc):
        self.n = n
        self.exc = exc
        self.calls = 0

    def fit(self, data, **kw):
        self.calls += 1
        if self.calls <= self.n:
            raise self.exc


class _Data:
    def reset(self):
        pass


@pytest.mark.parametrize('n,budget,raises', [(2, 3, False), (3, 3, False),
                                             (4, 3, True), (1, 0, True)])
def test_restart_budget(n, budget, raises):
    for fit in (tresilient, jresilient):
        mod = _Failing(n, RuntimeError('device lost'))
        if raises:
            with pytest.raises(RuntimeError, match='device lost'):
                fit(mod, _Data(), restart_max=budget, restart_backoff=0)
            assert mod.calls == budget + 1
        else:
            assert fit(mod, _Data(), restart_max=budget,
                       restart_backoff=0) == n


@pytest.mark.parametrize('exc', [ValueError('shape'), TypeError('x'),
                                 AssertionError('y'), KeyboardInterrupt()])
def test_non_retryable_raises_at_once(exc):
    assert not is_retryable(exc)
    mod = _Failing(1, exc)
    with pytest.raises(type(exc)):
        tresilient(mod, _Data(), restart_max=5, restart_backoff=0)
    assert mod.calls == 1
    assert is_retryable(tfaults.FaultInjected('x'))
    assert is_retryable(ttele.health.TrainingHealthError('x'))
