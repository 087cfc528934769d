"""The port's fault injection (``mxnet_tpu_torch/faults.py``) against the
JAX package's (``mxnet_tpu/faults.py``).

The same ``MXTPU_FAULT_INJECT`` (and ``MXTPU_FAULT_HOST`` /
``MXTPU_HOST_ID``) environment drives both modules:

- the parse of every kind, and the same ValueError for garbage (which
  leaves the fault disarmed in both);
- the poisoned element of a batch: the first float array's origin, the
  label when the data holds no float (the deferred augment's uint8), and
  the fused window's draw-time slot written in place;
- the host guard: armed only in the named host;
- each seam firing once at its step: dispatch-exception at the window's
  and the per-batch seams (and only at its named seam), hang sleeping in
  place once, host-loss exiting 113 (in a subprocess), checkpoint-corrupt
  truncating the first step at or past its own, clock-skew and slow-host
  from their step on, mem-hog's retained allocation.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import faults as jfaults
from mxnet_tpu_torch import faults as tfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ('MXTPU_FAULT_INJECT', 'MXTPU_FAULT_HOST', 'MXTPU_HOST_ID')


def _arm(monkeypatch, value, **extra):
    """Set the fault flags for both packages and reset both modules."""
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    if value is not None:
        monkeypatch.setenv('MXTPU_FAULT_INJECT', value)
    for k, v in extra.items():
        monkeypatch.setenv(k, str(v))
    mx.config.flags.reload()
    mt.config.flags.reload()
    jfaults._reset_for_tests()
    tfaults._reset_for_tests()
    # decided here, as each fit loop decides before it reaches a seam
    return jfaults.enabled(), tfaults.enabled()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    _arm(monkeypatch, None)
    yield
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    mx.config.flags.reload()
    mt.config.flags.reload()
    jfaults._reset_for_tests()
    tfaults._reset_for_tests()


@pytest.mark.parametrize('raw', ['%s:3' % k for k in jfaults.KINDS]
                         + ['%s:7:x' % k for k in jfaults.KINDS]
                         + ['nan-grad:0', 'dispatch-exception:5:executor'])
def test_parse_every_kind(monkeypatch, raw):
    assert tfaults.KINDS == jfaults.KINDS
    assert tfaults._parse(raw) == jfaults._parse(raw)
    _arm(monkeypatch, raw)
    assert tfaults.enabled() and jfaults.enabled()
    assert tfaults.spec() == jfaults.spec()


@pytest.mark.parametrize('raw', ['nope:1', 'nan-grad', 'nan-grad:x',
                                 ':3', 'hang'])
def test_garbage_raises_the_same_error_and_disarms(monkeypatch, raw):
    errs = []
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError) as e:
            mod._parse(raw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    _arm(monkeypatch, raw)
    assert not tfaults.enabled() and not jfaults.enabled()
    assert tfaults.spec() is None and jfaults.spec() is None


@pytest.mark.parametrize('fault_host,host_id,armed', [
    (1, 0, False), (0, 0, True), (2, 2, True), (-1, 3, True)])
def test_host_guard(monkeypatch, fault_host, host_id, armed):
    _arm(monkeypatch, 'host-loss:4', MXTPU_FAULT_HOST=fault_host,
         MXTPU_HOST_ID=host_id)
    assert jfaults.enabled() == tfaults.enabled() == armed


def _batch(pkg, data, label):
    ctx = pkg.cpu()
    return pkg.io.DataBatch(
        data=[pkg.nd.array(d, ctx=ctx, dtype=d.dtype) for d in data],
        label=[pkg.nd.array(l, ctx=ctx, dtype=l.dtype) for l in label])


@pytest.mark.parametrize('case', ['float_data', 'uint8_data', 'no_float'])
def test_poisoned_element_of_a_batch(monkeypatch, case):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3).astype(np.float32)
    lab = rng.randint(0, 3, 4).astype(np.float32)
    if case == 'uint8_data':
        x = rng.randint(0, 255, (4, 3)).astype(np.uint8)
    if case == 'no_float':
        x = rng.randint(0, 255, (4, 3)).astype(np.uint8)
        lab = lab.astype(np.int32)
    _arm(monkeypatch, 'nan-grad:1')
    got = {}
    for name, pkg, mod in (('jax', mx, jfaults), ('torch', mt, tfaults)):
        out = []
        for i in range(3):
            b = mod.maybe_poison_batch(_batch(pkg, [x], [lab]))
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        got[name] = out
    for (jd, jl), (td, tl) in zip(got['jax'], got['torch']):
        np.testing.assert_array_equal(jd, td)
        np.testing.assert_array_equal(jl, tl)
    poisoned = got['torch'][1]
    if case == 'float_data':
        assert np.isnan(poisoned[0][0, 0]) and np.isnan(poisoned[0]).sum() == 1
    elif case == 'uint8_data':
        assert np.isnan(poisoned[1][0]) and np.isnan(poisoned[1]).sum() == 1
    else:
        assert not np.isnan(poisoned[1].astype(np.float64)).any()
    # the draws before and after the armed one are untouched
    for i in (0, 2):
        np.testing.assert_array_equal(got['torch'][i][0], x)


def test_window_snapshot_is_poisoned_in_its_slot(monkeypatch):
    _arm(monkeypatch, 'nan-grad:1')
    stack = torch.arange(12, dtype=torch.float32).reshape(2, 2, 3)
    snaps = [((stack[i],), (torch.zeros(2),), 0, None) for i in range(2)]
    out = [tfaults.maybe_poison_snap(s) for s in snaps]
    assert out[0] is snaps[0] and out[1] is not snaps[1]
    # written into the window's own stack: the upload carries the NaN
    assert torch.isnan(stack[1, 0, 0]) and int(torch.isnan(stack).sum()) == 1
    assert out[1][0][0].data_ptr() == stack[1].data_ptr()


def _fire_sequence(mod, seam_calls):
    """For each (seam, upcoming, steps_after) call: whether the seam raised,
    then note the steps."""
    fired = []
    for seam, upcoming, steps in seam_calls:
        try:
            mod.maybe_raise(seam, upcoming=upcoming)
            fired.append(None)
        except mod.FaultInjected as e:
            fired.append((e.seam, e.step))
        mod.note_steps(steps)
    return fired


@pytest.mark.parametrize('raw,calls', [
    # the window seam, W = 4: fires before the window that holds step 5
    ('dispatch-exception:5', [('dispatch', 4, 4)] * 4),
    ('dispatch-exception:5:dispatch', [('executor', 1, 1)] * 8
     + [('dispatch', 4, 4)] * 2),
    ('dispatch-exception:3:executor', [('dispatch', 1, 0), ('executor', 1, 1),
                                       ('kvstore', 1, 0)] * 6),
    ('dispatch-exception:2:kvstore', [('executor', 1, 0), ('kvstore', 1, 1)]
     * 5),
    ('dispatch-exception:0', [('executor', 1, 1)] * 3),
    ('nan-grad:1', [('dispatch', 4, 4)] * 2),
])
def test_each_seam_fires_once_at_its_step(monkeypatch, raw, calls):
    _arm(monkeypatch, raw)
    jseq = _fire_sequence(jfaults, calls)
    tseq = _fire_sequence(tfaults, calls)
    assert tseq == jseq
    if raw.startswith('dispatch-exception'):
        assert sum(f is not None for f in tseq) == 1


def test_hang_sleeps_at_the_seam_once(monkeypatch):
    _arm(monkeypatch, 'hang:2:0.2')
    tfaults.maybe_raise('dispatch', upcoming=1)    # step 1: not yet
    tfaults.note_steps(2)
    t0 = time.time()
    tfaults.maybe_raise('dispatch', upcoming=1)
    assert time.time() - t0 >= 0.15
    t0 = time.time()
    tfaults.maybe_raise('dispatch', upcoming=1)    # fired once
    assert time.time() - t0 < 0.1


def test_host_loss_exits_113():
    code = ("import os\nos.environ['MXTPU_FAULT_INJECT'] = 'host-loss:0'\n"
            "from mxnet_tpu_torch import faults\n"
            "faults.maybe_raise('dispatch', upcoming=1)\n"
            "raise SystemExit('host-loss did not fire')\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == tfaults.HOST_LOSS_EXIT_CODE == \
        jfaults.HOST_LOSS_EXIT_CODE == 113, proc.stderr


def test_checkpoint_corrupt_truncates_the_first_step_at_or_past_its_own(
        monkeypatch, tmp_path):
    _arm(monkeypatch, 'checkpoint-corrupt:4')
    for pkg_dir, mod in (('jax', jfaults), ('torch', tfaults)):
        d = tmp_path / pkg_dir
        for step in (2, 6, 8):
            (d / str(step)).mkdir(parents=True)
            (d / str(step) / 'state.pt').write_bytes(b'x' * 100)
            (d / str(step) / 'meta.json').write_bytes(b'{"a": 1}')
        assert [mod.maybe_corrupt_checkpoint(str(d), s)
                for s in (2, 6, 8)] == [False, True, False]
        sizes = {s: sorted(os.path.getsize(d / str(s) / n)
                           for n in ('state.pt', 'meta.json'))
                 for s in (2, 6, 8)}
        assert sizes == {2: [8, 100], 6: [2, 2], 8: [8, 100]}


@pytest.mark.parametrize('raw', ['clock-skew:3', 'clock-skew:0:25',
                                 'clock-skew:2:abc'])
def test_clock_skew_from_its_step_on(monkeypatch, raw):
    _arm(monkeypatch, raw)
    seq = {}
    for name, mod in (('jax', jfaults), ('torch', tfaults)):
        out = []
        for _ in range(5):
            out.append(mod.clock_skew_ms())
            mod.note_steps(1)
        seq[name] = out
    assert seq['torch'] == seq['jax']
    assert seq['torch'][-1] > 0


def test_slow_host_and_mem_hog_persist(monkeypatch):
    _arm(monkeypatch, 'slow-host:1:30')
    tfaults.note_steps(1)                 # step 1: not past it yet
    t0 = time.time()
    tfaults.note_steps(1)
    tfaults.note_steps(1)
    assert time.time() - t0 >= 0.05
    _arm(monkeypatch, 'mem-hog:0:1')
    tfaults.note_steps(2, device='cpu')
    tfaults.note_steps(1, device='cpu')
    assert [int(t.numel()) for t in tfaults._hog] == [2 * 2 ** 18, 2 ** 18]
    assert all(t.device.type == 'cpu' for t in tfaults._hog)


def test_off_is_inert():
    assert not tfaults.enabled() and tfaults.spec() is None
    tfaults.maybe_raise('dispatch', upcoming=100)
    tfaults.note_steps(100)
    assert tfaults.clock_skew_ms() == 0.0
    assert not tfaults.maybe_corrupt_checkpoint('/nonexistent', 10)
