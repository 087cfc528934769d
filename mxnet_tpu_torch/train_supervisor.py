"""Whole-process training supervision, the port's copy of the JAX
package's ``tools/train_supervisor.py``: restart a dying run from the
outside.

``module/resilient_fit.py`` restarts a run that fails *inside* the
process (a TrainingHealthError, a dispatch exception). This wrapper covers
the failures it cannot: host loss, a wedged device that takes the
interpreter down, a sticky CUDA error that poisons the context, an OOM
kill, a crashing runtime. It launches any training command as a child
process and, while the restart budget lasts, relaunches it after an
unclean exit::

    python -m mxnet_tpu_torch.train_supervisor -- python train.py --epochs 90
    MXTPU_RESTART_MAX=5 MXTPU_RESTART_BACKOFF=10 \
        python -m mxnet_tpu_torch.train_supervisor --log sup.jsonl -- \
        python train.py

Liveness tier (``--liveness`` / MXTPU_SUPERVISOR_LIVENESS): a child can
hang without dying. The in-process watchdog (MXTPU_WATCHDOG_SECS,
``telemetry/watchdog.py``) aborts most of those with the distinct exit
code 85; for a child too wedged even for that, the supervisor watches the
child's telemetry JSONL for growth and SIGTERM/SIGKILLs and relaunches it
when it stalls past the threshold, against the same restart budget.

Restart from the last good checkpoint comes for free: the child is
expected to run with ``MXTPU_CKPT_DIR``/``MXTPU_CKPT_EVERY`` set (the
supervisor warns when they are not), so each relaunch resumes from the
newest health-certified checkpoint through the module's own
MXTPU_CKPT_RESUME path; the supervisor never reads or writes training
state itself.

Every restart is a ``restart`` JSONL record (appended to ``--log``, or to
the child's MXTPU_TELEMETRY_PATH so that the run's own log carries its
restart history), and the final record gives the outcome. Exit code: the
child's last exit code.

Budget and backoff share the in-process restart loop's flags:
MXTPU_RESTART_MAX attempts, MXTPU_RESTART_BACKOFF * 2^(k-1) seconds between
them (capped at 60 s). A clean exit (code 0) or SIGINT stops the loop at
once.

This module imports nothing of the framework (it reads its flags from the
environment itself): a supervisor must outlive whatever kills its child.
It supervises ONE process; the multi-process gang supervisor waits for
ROADMAP.md §1 item 11.
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import time

_BACKOFF_CAP_S = 60.0

# exit codes that restarting cannot help: misuse of the CLI itself
_NO_RETRY_CODES = (2,)


def backoff_delay(attempt, backoff):
    """Delay before restart ``attempt`` (1-based): backoff * 2^(k-1),
    capped."""
    return min(_BACKOFF_CAP_S, backoff * (2.0 ** (attempt - 1)))

# the in-process hang watchdog's distinct abort code
# (telemetry/watchdog.py HANG_EXIT_CODE, mirrored here because the
# supervisor never imports the framework), and fault injection's host-loss
# code (faults.py HOST_LOSS_EXIT_CODE)
_HANG_EXIT = 85
_HOST_LOSS_EXIT = 113

_LIVENESS_POLL_S = 2.0
_TERM_GRACE_S = 15.0


def _env_int(name, default):
    try:
        return int(os.environ.get(name, '') or default)
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, '') or default)
    except ValueError:
        return default


def _record(path, rec):
    if not path:
        return
    try:
        with open(path, 'a') as f:
            f.write(json.dumps(rec) + '\n')
    except OSError as e:
        print('train_supervisor: cannot append to %s (%s)' % (path, e),
              file=sys.stderr)


def lost_work_secs(attempt_elapsed, ckpt_dir=None, now=None):
    """Wall seconds a dead attempt loses to the goodput ledger:
    everything since the last-good checkpoint pointer was certified
    (the ``last_good.step`` file's mtime — the framework-free mirror of
    module/checkpointing.py's pointer contract), clamped to the
    attempt's own elapsed; the FULL attempt when no pointer exists
    (nothing to resume from — every second re-trains)."""
    if ckpt_dir is None:
        ckpt_dir = os.environ.get('MXTPU_CKPT_DIR', '')
    if now is None:
        now = time.time()
    if ckpt_dir:
        try:
            mtime = os.stat(
                os.path.join(ckpt_dir, 'last_good.step')).st_mtime
            return max(0.0, min(float(attempt_elapsed), now - mtime))
        except OSError:
            pass
    return max(0.0, float(attempt_elapsed))


def _describe(code):
    if code is None:
        return 'running'
    if code < 0:
        try:
            return 'killed by signal %s' % signal.Signals(-code).name
        except ValueError:
            return 'killed by signal %d' % -code
    if code == _HANG_EXIT:
        return 'exit code %d (hang watchdog abort)' % code
    if code == _HOST_LOSS_EXIT:
        return 'exit code %d (host loss)' % code
    return 'exit code %d' % code


def _kill_child(proc):
    """SIGTERM, a grace period, then SIGKILL; returns the exit code."""
    proc.terminate()
    try:
        return proc.wait(timeout=_TERM_GRACE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait()


class FileStallWatch:
    """The liveness stall rule over ONE file:

    - the stat is (size, mtime), not size alone: a sink that hit its
      MXTPU_TELEMETRY_MAX_MB cap stops GROWING for good but keeps
      touching the file's mtime at the flush cadence, so a
      healthy-but-capped child never reads as a hang;
    - arm at the FIRST observed change (the in-process watchdog's
      arm-at-first-mark rule): a child that never writes the file at
      all — telemetry accidentally off, path misconfigured — degrades
      to plain restart-on-exit supervision instead of a
      kill-and-relaunch loop of healthy children. The long quiet
      stretch AFTER the start record (the first kernel builds) is still
      on the operator: the threshold must exceed it."""

    def __init__(self, path, secs):
        self.path = path
        self.secs = secs
        self.last = self._stat()
        self.changed = time.time()
        self.armed = False

    def _stat(self):
        try:
            st = os.stat(self.path)
            return st.st_size, st.st_mtime
        except OSError:
            return None   # not created yet

    def stalled(self):
        """Seconds past the last change when armed + over threshold,
        else None (also refreshes the watch)."""
        now = time.time()
        cur = self._stat()
        if cur != self.last:
            self.last = cur
            self.changed = now
            self.armed = True
            return None
        if self.armed and now - self.changed > self.secs:
            return now - self.changed
        return None


def _wait_with_liveness(proc, path, secs, quiet=False):
    """Wait for the child, additionally requiring its telemetry JSONL
    at ``path`` to GROW at least every ``secs`` seconds — the
    supervisor-side liveness tier for a child too wedged to run its own
    in-process watchdog (a stuck collective blocks every thread that
    could observe a timer; file growth stops, and only an outside
    process can act). Returns (exit_code, timed_out). The child's sink
    flushes at least every few seconds (telemetry/export.py
    _FLUSH_SECS), so buffering cannot masquerade as a hang; the stall
    rule itself lives in :class:`FileStallWatch`."""
    watch = FileStallWatch(path, secs)
    while True:
        try:
            return proc.wait(timeout=_LIVENESS_POLL_S), False
        except subprocess.TimeoutExpired:
            pass
        stalled = watch.stalled()
        if stalled is not None:
            if not quiet:
                print('train_supervisor: child wrote no telemetry '
                      'records for %.0fs (liveness %.0fs) — killing the '
                      'wedged child' % (stalled, secs), file=sys.stderr)
            return _kill_child(proc), True


def run(cmd, restart_max, backoff, log_path, quiet=False,
        liveness=0.0, liveness_path=None):
    """Supervise one training command; returns its final exit code.
    ``liveness`` > 0 additionally kills + relaunches a child whose
    telemetry JSONL (``liveness_path``) stops growing for that many
    seconds — the tier for a child too wedged to self-abort."""
    attempts = 0
    # cumulative lost-work seconds across relaunches, seeded from the
    # environment so chained supervisors keep one running total; each
    # child reads it back as MXTPU_GOODPUT_LOST_S and reports
    # prior_lost_s / job_goodput_pct in its goodput record
    lost_total = _env_float('MXTPU_GOODPUT_LOST_S', 0.0)
    while True:
        t0 = time.time()
        timed_out = False
        env = dict(os.environ)
        env['MXTPU_GOODPUT_LOST_S'] = '%.3f' % lost_total
        try:
            proc = subprocess.Popen(cmd, env=env)
        except OSError as e:
            print('train_supervisor: cannot launch %r (%s)'
                  % (cmd[0], e), file=sys.stderr)
            return 127
        try:
            if liveness > 0 and liveness_path:
                code, timed_out = _wait_with_liveness(
                    proc, liveness_path, liveness, quiet=quiet)
            else:
                code = proc.wait()
        except KeyboardInterrupt:
            # the operator wants the run down: forward and stop —
            # an interactive stop is never a fault to retry
            proc.send_signal(signal.SIGINT)
            try:
                code = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                code = proc.wait()
            _record(log_path, {'type': 'restart', 'attempt': attempts,
                               'final': True, 'reason': 'KeyboardInterrupt',
                               'exit_code': code})
            return code
        elapsed = time.time() - t0
        if code == 0 and not timed_out:
            if attempts and not quiet:
                print('train_supervisor: run completed after %d restart(s)'
                      % attempts, file=sys.stderr)
            _record(log_path, {'type': 'restart', 'attempt': attempts,
                               'final': True, 'reason': 'clean_exit',
                               'exit_code': 0})
            return 0
        # a liveness kill is NEVER a clean exit, whatever code the
        # child's SIGTERM handler chose (save-and-exit-0 is common):
        # the run was wedged mid-training and must relaunch
        if (code in _NO_RETRY_CODES and not timed_out) \
                or attempts >= restart_max:
            _record(log_path, {'type': 'restart', 'attempt': attempts,
                               'final': True, 'reason': 'budget_exhausted'
                               if code not in _NO_RETRY_CODES else 'usage',
                               'exit_code': code})
            if not quiet:
                print('train_supervisor: giving up after %d attempt(s) '
                      '(%s)' % (attempts + 1, _describe(code)),
                      file=sys.stderr)
            # never report success for a run abandoned mid-training
            return code if not (timed_out and code == 0) else 1
        attempts += 1
        delay = backoff_delay(attempts, backoff)
        lost = lost_work_secs(elapsed)
        lost_total += lost
        _record(log_path, {'type': 'restart', 'attempt': attempts,
                           'reason': 'liveness_timeout' if timed_out
                           else 'process_exit',
                           'message': _describe(code), 'exit_code': code,
                           'elapsed_s': round(elapsed, 1),
                           'lost_s': round(lost, 1),
                           'lost_total_s': round(lost_total, 1),
                           'backoff_s': delay})
        if not quiet:
            print('train_supervisor: attempt %d/%d died (%s after %.0fs) '
                  '— relaunching in %.1fs'
                  % (attempts, restart_max, _describe(code), elapsed,
                     delay), file=sys.stderr)
        if delay:
            try:
                time.sleep(delay)
            except KeyboardInterrupt:
                # operator stop between attempts: no child to forward
                # to — close the record stream with the same terminal
                # record the mid-run Ctrl-C path writes
                _record(log_path, {'type': 'restart', 'attempt': attempts,
                                   'final': True,
                                   'reason': 'KeyboardInterrupt',
                                   'exit_code': code})
                return code


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Run a training command under restart supervision '
                    '(relaunch after unclean exits, restart budget + '
                    'exponential backoff from MXTPU_RESTART_*).')
    p.add_argument('--restart-max', type=int, default=None,
                   help='restart budget (default: MXTPU_RESTART_MAX or 3)')
    p.add_argument('--backoff', type=float, default=None,
                   help='base backoff seconds '
                        '(default: MXTPU_RESTART_BACKOFF or 2)')
    p.add_argument('--log', default=None,
                   help='JSONL file for restart records (default: the '
                        "child's MXTPU_TELEMETRY_PATH when set)")
    p.add_argument('--liveness', type=float, default=None,
                   help='kill + relaunch the child when its telemetry '
                        'JSONL stops growing for this many seconds — '
                        'the tier for a child too wedged to self-abort '
                        '(default: MXTPU_SUPERVISOR_LIVENESS or 0 = off; '
                        'needs the child run with MXTPU_TELEMETRY=1)')
    p.add_argument('--quiet', action='store_true',
                   help='suppress supervisor stderr chatter')
    p.add_argument('cmd', nargs=argparse.REMAINDER,
                   help='training command (prefix with -- )')
    args = p.parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == '--':
        cmd = cmd[1:]
    if not cmd:
        p.error('no training command given (append: -- python train.py ...)')
    restart_max = args.restart_max if args.restart_max is not None \
        else _env_int('MXTPU_RESTART_MAX', 3)
    backoff = args.backoff if args.backoff is not None \
        else _env_float('MXTPU_RESTART_BACKOFF', 2.0)
    log_path = args.log or os.environ.get('MXTPU_TELEMETRY_PATH')
    liveness = args.liveness if args.liveness is not None \
        else _env_float('MXTPU_SUPERVISOR_LIVENESS', 0.0)
    liveness_path = os.environ.get('MXTPU_TELEMETRY_PATH')
    if liveness > 0 and not liveness_path:
        print('train_supervisor: --liveness needs the child run with '
              'MXTPU_TELEMETRY=1 and MXTPU_TELEMETRY_PATH set (the '
              'liveness signal is that file growing) — liveness '
              'disabled', file=sys.stderr)
        liveness = 0.0
    if not args.quiet and not os.environ.get('MXTPU_CKPT_DIR'):
        print('train_supervisor: MXTPU_CKPT_DIR is not set — restarts '
              'will rerun from epoch 0 (set MXTPU_CKPT_DIR and '
              'MXTPU_CKPT_EVERY so relaunches resume from the last-good '
              'checkpoint)', file=sys.stderr)
    return run(cmd, restart_max, backoff, log_path, quiet=args.quiet,
               liveness=liveness, liveness_path=liveness_path)


if __name__ == '__main__':
    sys.exit(main())
