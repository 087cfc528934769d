"""The process tier of the port's resilience: ``python -m
mxnet_tpu_torch.train_supervisor`` over a training child on the CPU.

The child fits the JAX resilience tests' MLP (64 rows of 10, batch 8,
3 epochs through the fused window, sgd 0.1) with checkpoints every 2 steps
and saves its parameters; on a relaunch it clears the one-shot fault from
its own environment, as the JAX package's chaos child does (the launcher's
environment reaches every attempt).

- ``host-loss``: the child vanishes with exit code 113 mid-run; the
  supervisor relaunches it, the relaunch restores the last certified step,
  and the saved parameters are bit for bit those of the uninterrupted
  child;
- ``hang``: the child wedges at its dispatch seam; the watchdog
  (``MXTPU_WATCHDOG_ACTION=abort``) runs the checkpointer's abort hook,
  which drains the writer and certifies the save in flight, and exits 85;
  the relaunch restores that step and ends bit for bit on the
  uninterrupted run;
- a child that fails twice and then exits cleanly is relaunched twice,
  with the supervisor's restart records.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = '''
import os
marker = os.environ['CHILD_MARKER']
first = not os.path.exists(marker)
open(marker, 'a').write('x\\n')
if not first:
    os.environ.pop('MXTPU_FAULT_INJECT', None)
import numpy as np
import mxnet_tpu_torch as mt
d = mt.sym.Variable('data')
h = mt.sym.Activation(mt.sym.FullyConnected(d, num_hidden=16, name='fc1'),
                      act_type='relu')
sym = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(h, num_hidden=4,
                                                 name='fc2'), name='softmax')
rng = np.random.RandomState(0)
X = rng.randn(64, 10).astype(np.float32)
y = rng.randint(0, 4, 64).astype(np.float32)
mt.random.seed(0)
mod = mt.mod.Module(sym, context=mt.cpu())
it = mt.io.NDArrayIter(X, y, batch_size=8, label_name='softmax_label')
mod.fit(it, num_epoch=3, optimizer='sgd',
        optimizer_params=(('learning_rate', 0.1),))
mod.save_params(os.environ['CHILD_OUT'])
'''

_CLEARED = ('MXTPU_FAULT_INJECT', 'MXTPU_CKPT_DIR', 'MXTPU_CKPT_EVERY',
            'MXTPU_WATCHDOG_SECS', 'MXTPU_WATCHDOG_ACTION', 'MXTPU_TELEMETRY',
            'MXTPU_TELEMETRY_PATH', 'MXTPU_HEALTH', 'MXTPU_FUSED_FIT',
            'MXTPU_CKPT_ASYNC', 'MXTPU_CKPT_RESUME', 'MXTPU_RESTART_MAX')


def _env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items() if k not in _CLEARED}
    env.update({'PYTHONPATH': ROOT,
                'CHILD_MARKER': str(tmp_path / 'marker'),
                'CHILD_OUT': str(tmp_path / 'params')})
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _chaos_env(tmp_path, **extra):
    return _env(tmp_path, MXTPU_TELEMETRY='1',
                MXTPU_TELEMETRY_PATH=str(tmp_path / 'tele.jsonl'),
                MXTPU_CKPT_DIR=str(tmp_path / 'ckpts'), MXTPU_CKPT_EVERY='2',
                **extra)


def _params(path):
    import mxnet_tpu_torch as mt
    return {k: v.asnumpy() for k, v in mt.nd.load(str(path)).items()}


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _supervise(tmp_path, env):
    child = tmp_path / 'child.py'
    child.write_text(CHILD)
    return subprocess.run(
        [sys.executable, '-m', 'mxnet_tpu_torch.train_supervisor',
         '--backoff', '0', '--', sys.executable, str(child)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """The uninterrupted child's parameters (no fault, no checkpoints)."""
    ref = tmp_path_factory.mktemp('ref')
    child = ref / 'child.py'
    child.write_text(CHILD)
    proc = subprocess.run([sys.executable, str(child)], cwd=ROOT,
                          env=_env(ref), capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return _params(ref / 'params')


def _resumed_bit_for_bit(tmp_path, proc, exit_code, want):
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(open(tmp_path / 'marker').read().split()) == 2
    recs = _records(tmp_path / 'tele.jsonl')
    restarts = [r for r in recs if r['type'] == 'restart'
                and not r.get('final')]
    assert len(restarts) == 1 and restarts[0]['exit_code'] == exit_code
    assert recs[-1]['type'] == 'restart' and recs[-1]['final'] and \
        recs[-1]['reason'] == 'clean_exit'
    # the relaunch restored a certified step instead of starting afresh
    resumes = [r for r in recs if r.get('name') == 'ckpt.resume']
    assert len(resumes) == 1 and resumes[0]['restored_step'] >= 4
    got = _params(tmp_path / 'params')
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return resumes[0]['restored_step']


def test_host_loss_child_is_relaunched_and_resumes(tmp_path, reference):
    # synchronous saves: the step before the loss is certified at the
    # next step's note, not whenever an async write happens to land
    proc = _supervise(tmp_path, _chaos_env(
        tmp_path, MXTPU_FAULT_INJECT='host-loss:13', MXTPU_CKPT_ASYNC='0'))
    assert 'exit code 113 (host loss)' in proc.stderr
    # saves at 4, 8 and 12; 12 was noted but not certified when window 4's
    # dispatch lost the host
    assert _resumed_bit_for_bit(tmp_path, proc, 113, reference) == 8


def test_hang_child_aborts_85_after_its_hook_drains_the_writer(tmp_path,
                                                              reference):
    proc = _supervise(tmp_path, _chaos_env(
        tmp_path, MXTPU_FAULT_INJECT='hang:13:600', MXTPU_WATCHDOG_SECS='2',
        MXTPU_WATCHDOG_ACTION='abort'))
    assert 'hang watchdog abort' in proc.stderr
    # the abort hook drained the writer and certified the newest save,
    # which was in flight (or committed but not yet certified) at the
    # hang: step 12, or 8 when the writer was still busy with it as
    # window 3 ended (a busy writer skips a save)
    drained = re.findall(r'abort drain certified step (\d+)', proc.stderr)
    assert len(drained) == 1 and int(drained[0]) in (8, 12)
    hangs = [r for r in _records(tmp_path / 'tele.jsonl')
             if r['type'] == 'hang']
    assert len(hangs) == 1 and hangs[0]['action'] == 'abort'
    assert _resumed_bit_for_bit(tmp_path, proc, 85, reference) == \
        int(drained[0])


def test_supervisor_relaunches_until_a_clean_exit(tmp_path):
    state = tmp_path / 'attempts'
    log = tmp_path / 'sup.jsonl'
    child = tmp_path / 'flaky.py'
    child.write_text(
        "import os, sys\n"
        "p = %r\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        "sys.exit(0 if n >= 2 else 1)\n" % str(state))
    # the module imports nothing of the framework: run as a file, the
    # supervisor starts without torch
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'mxnet_tpu_torch',
                                      'train_supervisor.py'),
         '--backoff', '0', '--log', str(log), '--',
         sys.executable, str(child)],
        cwd=ROOT, env=_env(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    recs = _records(log)
    mid = [r for r in recs if not r.get('final')]
    assert len(mid) == 2 and all(r['reason'] == 'process_exit'
                                 for r in mid)
    assert recs[-1]['final'] and recs[-1]['reason'] == 'clean_exit'
    assert 'MXTPU_CKPT_DIR is not set' in proc.stderr
