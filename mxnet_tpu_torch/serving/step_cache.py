"""O(1) autoregressive serving, per-session state kept on the device: the
counterpart of ``mxnet_tpu/serving/step_cache.py``.

A recurrent decode served naively re-runs the whole prefix per token. The
step cache keeps each session's carried state on the device between steps
instead, so serving runs one fixed-shape step per token batch.

- :class:`StepCache` — the session table: session id -> slot of the
  state ring, on the host, evicted least recently used. Slot
  ``capacity`` is a scratch row that pad rows write into, so padding never
  touches a live session.
- :class:`DecodeEngine` — the step dispatcher over a bound Module whose
  graph is ONE recurrent step (the states among its data inputs, the new
  states its trailing outputs, the ``mx.rnn`` cell ``__call__`` shape).
  The ring is one preallocated tensor a state, ``(capacity + 1,) +
  state_shape`` on the engine's device; a step gathers the batch's rows
  (``index_select``), runs the graph, and writes the new states back in
  place with ``index_copy_`` under ``inference_mode`` (the JAX package
  donates the ring to its step program instead). Fresh sessions (a first
  token, or back after an LRU eviction) start from zero state through a
  mask on the device: the host never touches state bytes. One step
  program is kept a batch bucket.

The step-symbol contract: ``state_names`` are data inputs of the bound
module (build it with ``data_names=('data', 'state_h', ...)``), and the
graph's LAST ``len(state_names)`` outputs are the new states in the same
order — what ``mx.sym.Group([out] + new_states)`` over an rnn/lstm cell
gives (docs/serving.md).
"""
import collections
import logging
import threading
import time

import numpy as np
import torch

from .. import random as _random
from .. import telemetry as _tele
from ..base import torch_dtype
from .engine import _SingleExecutorEngine, _to_host, bucket_ladder

__all__ = ['StepCache', 'DecodeEngine']


def _serve_sessions():
    from ..config import flags
    flags.reload('MXTPU_SERVE_SESSIONS')
    return flags.get('MXTPU_SERVE_SESSIONS')


class StepCache:
    """Session-id -> ring-slot table with LRU eviction.

    The ring itself belongs to :class:`DecodeEngine`; this class owns only
    the host-side mapping, so it is cheap to test in isolation.
    """

    def __init__(self, capacity):
        self.capacity = int(capacity)
        assert self.capacity >= 1
        self._slots = collections.OrderedDict()   # session -> slot (LRU)
        self._free = list(range(self.capacity - 1, -1, -1))
        self.evictions = 0
        self._lock = threading.Lock()

    def lookup(self, session_ids):
        """(slots, fresh) for a batch of session ids: ``slots`` the int32
        ring rows, ``fresh`` True where the session has no cached state
        (new, or LRU-evicted since its last step — it restarts from zero
        state). Touch order is LRU."""
        slots = np.empty(len(session_ids), np.int32)
        fresh = np.zeros(len(session_ids), bool)
        with self._lock:
            if len(set(session_ids)) != len(session_ids):
                raise ValueError('duplicate session ids in one batch')
            for i, sid in enumerate(session_ids):
                slot = self._slots.pop(sid, None)
                if slot is None:
                    fresh[i] = True
                    if self._free:
                        slot = self._free.pop()
                    else:
                        _, slot = self._slots.popitem(last=False)
                        _tele.counter('serve.session_evictions').inc()
                        self.evictions += 1
                self._slots[sid] = slot        # most-recently-used end
                slots[i] = slot
            _tele.gauge('serve.sessions_live').set(len(self._slots))
            _tele.gauge('serve.sessions').set(len(self._slots))
            _tele.gauge('serve.evictions').set(self.evictions)
        return slots, fresh

    def drop(self, session_id):
        """Explicitly end a session (its slot frees immediately)."""
        with self._lock:
            slot = self._slots.pop(session_id, None)
            if slot is not None:
                self._free.append(slot)
            _tele.gauge('serve.sessions_live').set(len(self._slots))
            _tele.gauge('serve.sessions').set(len(self._slots))
        return slot is not None

    def sessions(self):
        with self._lock:
            return list(self._slots)


class DecodeEngine(_SingleExecutorEngine):
    """Fixed-shape recurrent decode steps over a StepCache ring."""

    _default_name = 'decoder'

    def __init__(self, module, state_names, capacity=None, max_batch=None,
                 logger=logging, name=None):
        super().__init__(module, logger=logger, name=name)
        self._descs = {d.name: d for d in module.data_shapes}
        self.state_names = list(state_names)
        missing = [n for n in self.state_names if n not in self._descs]
        if missing:
            raise ValueError('state inputs %s are not data inputs of the '
                             'bound module' % missing)
        self._token_names = [n for n in module.data_names
                             if n not in self.state_names]
        n_out = len(module.output_names)
        if n_out <= len(self.state_names):
            raise ValueError('the step graph must output its payload '
                             'plus one new state per state input (last '
                             '%d outputs)' % len(self.state_names))
        self.n_payload = n_out - len(self.state_names)
        self.capacity = int(capacity) if capacity else _serve_sessions()
        max_b = int(max_batch) if max_batch else min(self.capacity, 32)
        self.buckets = [b for b in bucket_ladder(max_b)
                        if b <= self.capacity] or [1]
        self._lock = threading.Lock()    # decode serializes on the ring
        self._reset_ring()

    def _desc_dtype(self, n):
        return np.dtype(getattr(self._descs[n], 'dtype', None) or np.float32)

    def _reset_ring(self):
        """(Re)build the state ring: one slot a session and the scratch
        row ``capacity`` for pad rows, zeros on the engine's device, with a
        fresh session table. Also called after a failed step, whose
        in-place writes may have stopped part way: every session restarts
        from zero state, the eviction semantics."""
        with self._on_device():
            self._store = [
                torch.zeros((self.capacity + 1,)
                            + tuple(self._descs[n].shape[1:]),
                            dtype=torch_dtype(self._desc_dtype(n)),
                            device=self.device)
                for n in self.state_names]
        self.cache = StepCache(self.capacity)
        # the ring's standing claim on the card's memory
        _tele.gauge('serve.ring_bytes').set(
            int(sum(s.numel() * s.element_size() for s in self._store)))

    # -- program -----------------------------------------------------------
    def _build_program(self, bucket):
        run = self._exec._prog.make_runner()
        arg_pos = {n: i for i, n in enumerate(self._arg_names)}
        token_names, state_names = self._token_names, self.state_names
        io_names = set(token_names + state_names)
        fixed_names = [n for n in self._arg_names if n not in io_names]
        n_payload = self.n_payload

        def step(slots, fresh, tokens):
            fixed, aux = self._snapshot(fixed_names)
            full = [None] * len(arg_pos)
            for n, v in zip(fixed_names, fixed):
                full[arg_pos[n]] = v
            for n, v in zip(token_names, tokens):
                full[arg_pos[n]] = v
            for n, s in zip(state_names, self._store):
                st = s.index_select(0, slots)
                mask = fresh.reshape((-1,) + (1,) * (st.dim() - 1))
                full[arg_pos[n]] = torch.where(mask, torch.zeros_like(st),
                                               st)
            outs, _ = run(tuple(full), aux, _random.next_seed(), False)
            # the new states back into the ring, in place; pad rows all
            # write the scratch slot, whose value is dead
            for s, ns in zip(self._store, outs[n_payload:]):
                s.index_copy_(0, slots, ns.to(s.dtype))
            return tuple(outs[:n_payload])
        return step

    # -- the decode step ---------------------------------------------------
    def decode(self, session_ids, arrays, reset=False, timings=None):
        """One recurrent step for a batch of sessions: ``arrays`` are the
        token inputs (row i belongs to ``session_ids[i]``); the carried
        state comes from, and returns to, the ring. Returns the payload
        outputs as host arrays, one row per session. ``reset=True``
        restarts every named session from zero state. ``timings`` (a dict,
        optional) accumulates the host-measured ``pad_ms``,
        ``dispatch_ms`` and ``fetch_ms``, as
        :meth:`ServingEngine.dispatch_rows` does."""
        if not isinstance(arrays, (list, tuple)):
            arrays = [arrays]
        rows = len(session_ids)
        if rows == 0:
            raise ValueError('empty session batch')
        if rows > self.buckets[-1]:
            raise ValueError('decode batch %d exceeds the largest bucket '
                             '%d' % (rows, self.buckets[-1]))
        if len(arrays) != len(self._token_names):
            raise ValueError('expected %d token inputs (%s)'
                             % (len(self._token_names),
                                ', '.join(self._token_names)))
        # validate and pad the token arrays BEFORE the session table is
        # touched: a rejected call must not register or evict sessions
        bucket = next(b for b in self.buckets if b >= rows)
        pad = bucket - rows
        t_pad0 = time.perf_counter()
        host_tokens = []
        for n, a in zip(self._token_names, arrays):
            desc = self._descs[n]
            a = np.asarray(a, dtype=self._desc_dtype(n))
            if a.shape[0] != rows or \
                    tuple(a.shape[1:]) != tuple(desc.shape[1:]):
                raise ValueError('token input %r: shape %s does not '
                                 'match %d rows of %s'
                                 % (n, a.shape, rows,
                                    tuple(desc.shape[1:])))
            if pad:
                a = np.concatenate(
                    [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
            host_tokens.append(a)
        if timings is not None:
            timings['pad_ms'] = timings.get('pad_ms', 0.0) \
                + (time.perf_counter() - t_pad0) * 1e3
        with self._lock:
            slots, fresh = self.cache.lookup(session_ids)
            # the table is mutated now: any later failure rebuilds ring
            # and table together, or a retried session would find
            # fresh=False and read an evicted session's leftover state
            try:
                if reset:
                    fresh[:] = True
                prog = self._program(bucket)
                if pad:
                    slots = np.concatenate(
                        [slots, np.full(pad, self.capacity, np.int32)])
                    fresh = np.concatenate([fresh, np.ones(pad, bool)])
                t_disp0 = time.perf_counter()
                with self._on_device(), torch.inference_mode(), \
                        _tele.span('serve.decode', 'serve'):
                    payload = prog(
                        torch.from_numpy(slots.astype(np.int64))
                        .to(self.device),
                        torch.from_numpy(fresh).to(self.device),
                        [torch.from_numpy(np.ascontiguousarray(a))
                         .to(self.device) for a in host_tokens])
                if timings is not None:
                    timings['dispatch_ms'] = timings.get('dispatch_ms', 0.0) \
                        + (time.perf_counter() - t_disp0) * 1e3
            except Exception:
                self._reset_ring()
                _tele.counter('serve.errors').inc()
                self.logger.warning(
                    'decode step failed — session state ring reset '
                    '(all sessions restart from zero state)')
                raise
            _tele.counter('serve.decode_steps').inc()
        t_fetch0 = time.perf_counter()
        with self._on_device():
            outs = [_to_host(p[:rows]) for p in payload]
        if timings is not None:
            timings['fetch_ms'] = timings.get('fetch_ms', 0.0) \
                + (time.perf_counter() - t_fetch0) * 1e3
        return outs

    def warmup(self):
        """Build and run every bucket's step once (against throwaway
        sessions, dropped afterwards so the table starts empty)."""
        for b in self.buckets:
            sids = ['__warmup_%d_%d' % (b, i) for i in range(b)]
            tokens = [np.zeros((b,) + tuple(self._descs[n].shape[1:]),
                               self._desc_dtype(n))
                      for n in self._token_names]
            self.decode(sids, tokens)
            for s in sids:
                self.cache.drop(s)
        self.logger.info('decode engine %s: %d step programs warm '
                         '(buckets %s, %d sessions)',
                         self.name, len(self.buckets), self.buckets,
                         self.capacity)
        return len(self.buckets)
