"""The engine: the counterpart of ``mxnet_tpu/engine.py`` (MXNet's
include/mxnet/engine.h), on the native dependency engine.

:class:`Engine` wraps ``src/engine.cc`` (built by :mod:`._native`): ops
pushed with the vars they read (``const_vars``) and write
(``mutable_vars``) run on a worker pool; per var, writers run in the order
they were pushed and the readers pushed between two writers run after the
first and before the second. It schedules host work (decode, prefetch,
checkpoint writes). Work on the card is ordered by its CUDA stream, as
PyTorch queues it; :func:`wait_for_var` and :func:`wait_for_all` wait for
that too. While the profiler runs, the engine records each op's span,
which ``profiler.dump_profile`` merges into its trace.

``MXTPU_ENGINE_TYPE=NaiveEngine`` (or ``MXNET_ENGINE_TYPE``) makes the
engine run each op inline, at its push (:func:`naive`); the flag is read
when the module is imported, as in the JAX package. Without the native
library (``MXTPU_NO_NATIVE=1``, no ``g++``) :func:`push` runs its tasks
on one Python worker thread, in order.
"""
import ctypes
import itertools
import os
import queue
import threading
import traceback

from . import _native
from .config import flags as _flags

__all__ = ['push', 'wait_for_var', 'wait_for_all', 'engine_type', 'naive',
           'set_bulk_size', 'Engine', 'get_engine']

_engine_type = _flags.get('MXTPU_ENGINE_TYPE')


class Engine:
    """The native dependency engine.

    >>> eng = Engine()
    >>> v = eng.new_var()
    >>> eng.push(task, mutable_vars=[v], priority=1, name='decode')
    >>> eng.wait_for_var(v)
    """

    def __init__(self, num_workers=None):
        lib = _native.get_lib()
        if lib is None:
            raise RuntimeError('the native runtime is unavailable (no g++, '
                               'or MXTPU_NO_NATIVE set)')
        if num_workers is None:
            num_workers = _flags.get('MXTPU_ENGINE_WORKERS')
        if naive():
            num_workers = 0     # each op runs inline, at its push
        self._lib = lib
        self._h = ctypes.c_void_p()
        _native.check_call(lib.MXTEngineCreate(num_workers,
                                               ctypes.byref(self._h)), lib)
        self._cb_lock = threading.Lock()
        self._callbacks = {}
        self._ids = itertools.count(1)

        def _run(param):
            key = param or 0
            with self._cb_lock:
                fn = self._callbacks.pop(key, None)
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 -- never into the C worker
                traceback.print_exc()

        # the ctypes callback must live as long as the engine
        self._trampoline = _native.SYNC_FN(_run)
        self._tramp_ptr = ctypes.cast(self._trampoline, ctypes.c_void_p)
        # ops pushed while the profiler already runs are recorded too
        from . import profiler
        lib.MXTProfilerSetState(1 if profiler.is_running() else 0)

    def new_var(self):
        v = ctypes.c_void_p()
        _native.check_call(self._lib.MXTEngineNewVar(self._h,
                                                     ctypes.byref(v)),
                           self._lib)
        return v

    def delete_var(self, var):
        """Delete ``var`` once the ops pushed on it have run."""
        _native.check_call(self._lib.MXTEngineDeleteVar(self._h, var),
                           self._lib)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             name='host_op'):
        """Run ``fn()`` once the vars allow: after the earlier writers of
        every var it names, and, for a var it writes, after the earlier
        readers too. Higher ``priority`` runs first among ready ops."""
        key = next(self._ids)
        with self._cb_lock:
            self._callbacks[key] = fn
        cv = (ctypes.c_void_p * max(1, len(const_vars)))(*const_vars)
        mv = (ctypes.c_void_p * max(1, len(mutable_vars)))(*mutable_vars)
        _native.check_call(self._lib.MXTEnginePushSync(
            self._h, self._tramp_ptr, key,
            cv, len(const_vars), mv, len(mutable_vars),
            priority, name.encode()), self._lib)

    def wait_for_var(self, var):
        _native.check_call(self._lib.MXTEngineWaitForVar(self._h, var),
                           self._lib)

    def wait_for_all(self):
        _native.check_call(self._lib.MXTEngineWaitForAll(self._h), self._lib)

    def pending_ops(self):
        n = ctypes.c_int64()
        _native.check_call(self._lib.MXTEnginePendingOps(self._h,
                                                         ctypes.byref(n)),
                           self._lib)
        return n.value

    def close(self):
        """Wait for the pushed ops, then stop the workers."""
        if self._h:
            self._lib.MXTEngineFree(self._h)
            self._h = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter shutdown
            pass


_global_engine = None
_global_engine_lock = threading.Lock()


def get_engine():
    """The process's engine, made at the first call; None without the
    native runtime."""
    global _global_engine
    if _global_engine is None and _native.get_lib() is not None:
        with _global_engine_lock:
            if _global_engine is None:
                _global_engine = Engine()
    return _global_engine


def engine_type():
    return _engine_type


def naive():
    """True under MXTPU_ENGINE_TYPE=NaiveEngine: every op runs at its
    push, for debugging."""
    return _engine_type == 'NaiveEngine'


class _HostWorker:
    """One background thread running host tasks in order: :func:`push`
    without the native runtime."""

    def __init__(self):
        self._q = None
        self._thread = None
        self._lock = threading.Lock()

    def _ensure(self):
        with self._lock:
            if self._thread is None:
                self._q = queue.Queue()
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

    def _loop(self):
        while True:
            fn, done = self._q.get()
            try:
                fn()
            except Exception:  # noqa: BLE001 -- keep serving the queue
                traceback.print_exc()
            finally:
                done.set()

    def push(self, fn):
        done = threading.Event()
        if naive():
            try:
                fn()
            finally:
                done.set()
            return done
        self._ensure()
        self._q.put((fn, done))
        return done


_worker = _HostWorker()
_host_serial_var = None


def push(fn, sync=False):
    """Push a host task; returns an Event set when it has run. Tasks run
    in the order pushed (they all write one var of the engine). With
    ``sync`` the call waits for it."""
    global _host_serial_var
    eng = get_engine()
    if eng is not None:
        if _host_serial_var is None:
            with _global_engine_lock:
                if _host_serial_var is None:
                    _host_serial_var = eng.new_var()
        ev = threading.Event()

        def task():
            try:
                fn()
            finally:
                ev.set()

        eng.push(task, mutable_vars=[_host_serial_var], name='host_task')
    else:
        ev = _worker.push(fn)
    if sync:
        ev.wait()
    return ev


def wait_for_var(arr):
    """Wait until the work queued on ``arr``'s device has finished."""
    arr.wait_to_read()


def wait_for_all():
    """Wait for every op pushed to the engine, then for every card."""
    if _global_engine is not None:
        _global_engine.wait_for_all()
    from .ndarray.ndarray import waitall
    waitall()


_bulk_size = int(os.environ.get('MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN', 15))


def set_bulk_size(size):
    """Set the bulk segment size and return the previous one. The port runs
    a graph op by op, so the size changes nothing; it is kept for the
    reference's API."""
    global _bulk_size
    prev = _bulk_size
    _bulk_size = size
    return prev
