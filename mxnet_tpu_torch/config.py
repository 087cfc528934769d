"""Typed environment flags: the counterpart of the flag registry of
``mxnet_tpu/config.py`` (``Flag``, ``FlagRegistry``, ``flags``), with its
``flags.get``/``flags.reload`` surface and its parsing and validation
(the JAX registry's catalog text is not ported).

Only the flags that the ported modules read are declared. Their names are
the JAX package's, so one environment drives both packages:

- ``MXTPU_SERVE_MAX_BATCH``: the serving engine's largest batch bucket;
- ``MXTPU_FORCE_PALLAS``: take the kernel branch of the registry ops for
  CPU tensors too (their plain versions there), as the JAX package takes
  its Pallas kernels in interpret mode off the TPU;
- ``MXTPU_BN_ONEPASS``: BatchNorm's training statistics in one pass
  (shifted moments) or two (mean, then centred squares);
- ``MXTPU_BACKWARD_DO_MIRROR`` (alias ``MXNET_BACKWARD_DO_MIRROR``): the
  executor's and hybridized blocks' recompute of the forward in the
  backward (``torch.utils.checkpoint``);
- ``MXTPU_CONV_STEM_S2D`` and ``MXTPU_CONV_BWD_PATCHES``: the JAX
  package's two TPU lowerings of Convolution (space-to-depth for the stem,
  an im2col matmul for the weight gradient). Both compute the same
  function as the plain convolution; the port declares them so that one
  environment drives both packages, and they change nothing here: every
  Convolution is one ``F.conv1d/2d/3d`` call (cuDNN on the card);
- ``MXTPU_FUSED_FIT``, ``MXTPU_FUSED_EVAL`` and the window's other flags
  (``MXTPU_FIT_STEPS_PER_CALL``, ``MXTPU_EVAL_STEPS_PER_CALL``,
  ``MXTPU_FUSED_FIT_PREFETCH``, ``MXTPU_FUSED_EVAL_PREFETCH``,
  ``MXTPU_FUSED_FIT_TIMING``, ``MXTPU_FUSED_DONATE``): the W-step windows of
  ``Module.fit``, ``score``, ``predict`` and ``iter_predict``
  (``module/fused_fit.py``, ``fused_eval.py``, ``window_pipeline.py``),
  with the JAX package's defaults: both windows on, W automatic;
- ``MXTPU_TELEMETRY`` and the telemetry core's flags
  (``MXTPU_TELEMETRY_PATH``, ``_MAX_MB``, ``_PORT``, ``_BIND``,
  ``MXTPU_HOST_ID``, ``MXTPU_FLIGHT_RECORDER``, ``MXTPU_SLO_LATENCY_MS``,
  ``_ERROR_PCT``, ``_WINDOW``, ``MXTPU_WATCHDOG_SECS``, ``_ACTION``):
  the registry, the JSONL sink, the live endpoint, the flight recorder,
  the SLO plane and the hang watchdog (:mod:`.telemetry`), which the
  training and eval loops report to as the serving plane does;
- ``MXTPU_GOODPUT`` and ``MXTPU_GOODPUT_LOST_S``, ``MXTPU_TIMELINE``: the
  goodput and step-timeline planes (``telemetry/goodput.py``,
  ``telemetry/timeline.py``);
- ``MXTPU_XPROF``, ``MXTPU_XPROF_DIR`` and ``MXTPU_PROFILER_XLA_TRACE``:
  the profiler's step-windowed device trace and whether the profiler
  attaches one (:mod:`.profiler`; the last keeps the JAX package's name,
  and ``auto`` attaches it);
- ``MXTPU_SERVE_BIND`` and ``MXTPU_SERVE_MAX_WAIT_MS``: the serving HTTP
  front end's bind address and the batcher's coalescing deadline
  (:mod:`.serving`); ``MXTPU_SERVE_SESSIONS``: the decode step cache's
  session slots;
- ``MXTPU_NO_NATIVE``: the record files' pure-Python reader and writer
  in place of the native ones (:mod:`._native`);
- ``MXTPU_DEVICE_AUGMENT`` and ``MXTPU_HOST_CROP``: ImageRecordIter's
  augment on the card, and whether its workers crop on the host first
  (:mod:`.io`);
- the resilience tier: ``MXTPU_CKPT_DIR``, ``_EVERY``, ``_KEEP``,
  ``_ASYNC`` and ``_RESUME`` (periodic checkpoints and restart from the
  last good one, ``module/checkpointing.py``), ``MXTPU_RESTART_MAX`` and
  ``_BACKOFF`` (``module/resilient_fit.py``, ``train_supervisor.py``),
  ``MXTPU_FAULT_INJECT`` and ``MXTPU_FAULT_HOST`` (:mod:`.faults`),
  ``MXTPU_SUPERVISOR_LIVENESS`` (``train_supervisor.py``);
- the training-health planes: ``MXTPU_HEALTH``, ``_ACTION``, ``_K`` and
  ``_WINDOW`` (``telemetry/health.py``), ``MXTPU_DYNAMICS`` and
  ``MXTPU_SCALARS_EVERY``, its publication cadence
  (``telemetry/dynamics.py``);
- ``MXTPU_SHARDED_UPDATE`` and ``MXTPU_GRAD_COMPRESS``: paths of the JAX
  package's ``Module.fit`` that the port does not have yet (ROADMAP.md §1
  item 11); set, each makes fit, score and predict raise
  NotImplementedError (``module/base_module.py``).

A flag may name aliases (the reference's ``MXNET_*`` spellings), read when
the flag's own name is unset.
"""
import os
import threading

__all__ = ['Flag', 'FlagRegistry', 'flags']


class Flag:
    def __init__(self, name, type_, default, doc, min_value=None,
                 max_value=None, aliases=(), choices=None):
        self.name = name
        self.aliases = tuple(aliases)
        self.type = type_
        self.default = default
        self.doc = doc
        self.choices = choices
        self.min_value = min_value
        self.max_value = max_value

    def parse(self, raw):
        if raw is None:
            return self.default
        try:
            if self.type is bool:
                val = raw.strip().lower() not in ('', '0', 'false', 'no')
            else:
                val = self.type(raw)
        except (TypeError, ValueError):
            raise ValueError(
                'env %s=%r: expected %s' % (self.name, raw,
                                            self.type.__name__))
        if self.choices is not None and val not in self.choices:
            raise ValueError('env %s=%r: must be one of %s'
                             % (self.name, raw, sorted(self.choices)))
        if self.min_value is not None and val < self.min_value:
            raise ValueError('env %s=%r: must be >= %s'
                             % (self.name, raw, self.min_value))
        if self.max_value is not None and val > self.max_value:
            raise ValueError('env %s=%r: must be <= %s'
                             % (self.name, raw, self.max_value))
        return val


class FlagRegistry:
    def __init__(self):
        self._flags = {}
        self._cache = {}
        self._lock = threading.Lock()

    def declare(self, name, type_, default, doc, **kwargs):
        flag = Flag(name, type_, default, doc, **kwargs)
        self._flags[name] = flag
        return flag

    def get(self, name):
        """Parsed + validated value of a declared flag (cached)."""
        with self._lock:
            if name in self._cache:
                return self._cache[name]
            flag = self._flags[name]  # KeyError = undeclared flag: a bug
            raw = os.environ.get(flag.name)
            for alias in flag.aliases:
                if raw is not None:
                    break
                raw = os.environ.get(alias)
            val = flag.parse(raw)
            self._cache[name] = val
            return val

    def reload(self, name=None):
        """Drop cached values (tests mutate os.environ)."""
        with self._lock:
            if name is None:
                self._cache.clear()
            else:
                self._cache.pop(name, None)


flags = FlagRegistry()

flags.declare('MXTPU_FORCE_PALLAS', bool, False,
              'Dispatch LayerNorm/softmax/softmax_cross_entropy to their '
              'kernel branch for CPU tensors too, where the kernel wrappers '
              'run their plain versions (exercises that branch in CPU '
              'tests). CUDA tensors always take the kernels.')
flags.declare('MXTPU_SERVE_MAX_BATCH', int, 32,
              'Largest serving batch bucket (mxnet_tpu_torch/serving): the '
              'engine keeps one bucket per power of two up to this size, '
              'and requests pad up to the smallest covering bucket or are '
              'cut into chunks of the largest',
              min_value=1, max_value=65536)
flags.declare('MXTPU_BN_ONEPASS', bool, True,
              'BatchNorm training statistics by one-pass shifted moments '
              '(sum and sum of squares of x - pivot, the variance clamped '
              'at 0) instead of the two-pass mean, then mean of centred '
              'squares')
flags.declare('MXTPU_BACKWARD_DO_MIRROR', str, '0',
              "Recompute the forward in the backward: '1' (any truthy "
              "value) the whole forward, 'dots' all but the convolution "
              "and matmul results, '0'/''/'false' off",
              aliases=('MXNET_BACKWARD_DO_MIRROR',))
flags.declare('MXTPU_CONV_BWD_PATCHES', bool, False,
              'Declared for the JAX package, where it computes conv2d weight '
              'gradients as an im2col matmul; the same function, so it '
              'changes nothing in the port')
flags.declare('MXTPU_CONV_STEM_S2D', bool, False,
              'Declared for the JAX package, where it rewrites thin-input '
              'strided convolutions as space-to-depth; the same function, '
              'so it changes nothing in the port')
# The W-step windows of fit and eval (module/fused_fit.py, fused_eval.py),
# with the JAX package's defaults.
flags.declare('MXTPU_FUSED_FIT', bool, True,
              'Let Module.fit run a window of W training steps from one host '
              'call, with one fetch of the metric statistics a window, when '
              'the module is eligible (module/fused_fit.py); 0 forces the '
              'per-batch loop')
flags.declare('MXTPU_FIT_STEPS_PER_CALL', int, 0,
              'Window size W of the fused Module.fit; 0 = auto (32 on a TPU, '
              '4 elsewhere, so 4 on the card)', min_value=0)
flags.declare('MXTPU_FUSED_EVAL', bool, True,
              'Let score, predict and iter_predict run a window of W '
              'forwards from one host call, with the metric statistics '
              'on the device or the outputs stacked, fetched once a window '
              '(module/fused_eval.py); 0 forces the per-batch loop')
flags.declare('MXTPU_EVAL_STEPS_PER_CALL', int, 0,
              'Window size W of the fused eval; 0 = auto (32 on a TPU, 4 '
              'elsewhere)', min_value=0)
flags.declare('MXTPU_FUSED_FIT_PREFETCH', bool, True,
              'Upload the next fit window\'s stacked batches on a side '
              'thread (a side CUDA stream on the card) while this window '
              'runs; 0 uploads them in turn on the main thread')
flags.declare('MXTPU_FUSED_EVAL_PREFETCH', bool, True,
              'The same side-thread upload for the eval window; 0 uploads in '
              'turn')
flags.declare('MXTPU_FUSED_FIT_TIMING', bool, False,
              'Log each epoch\'s host stages of the fused fit (draw, stack '
              'and upload, dispatch, fetch)')
flags.declare('MXTPU_FUSED_DONATE', bool, True,
              'Declared for the JAX package, where it donates the window\'s '
              'inputs to XLA so that the update runs in place. XLA\'s '
              'donation has no counterpart here: the port\'s window rebinds '
              'each parameter and state to the new tensor its update op '
              'returns, and the old one goes back to the caching allocator '
              'once nothing holds it; the flag changes nothing in the port')
# The resilience tier and the training-health planes, with the JAX
# package's names and defaults.
flags.declare('MXTPU_CKPT_DIR', str, '',
              'Root directory of the periodic training checkpoints '
              '(module/checkpointing.py over parallel/checkpoint.py): one '
              'directory a saved step, committed by an atomic rename, and the '
              'last-good pointer. Empty (default) = checkpointing off')
flags.declare('MXTPU_CKPT_EVERY', int, 0,
              'Save a training checkpoint every N trained steps (at window '
              'boundaries on the fused fit): parameters, aux states, '
              'optimizer states and update counts, the RNG streams, the '
              'epoch/step cursor and the metric\'s sums. The copy to the host '
              'and the write run off the step loop. 0 (default) = off '
              '(MXTPU_CKPT_DIR must also be set)', min_value=0)
flags.declare('MXTPU_CKPT_KEEP', int, 3,
              'How many checkpoint steps to keep; older steps are deleted as '
              'new ones commit', min_value=1)
flags.declare('MXTPU_CKPT_ASYNC', bool, True,
              'Write checkpoints on a background thread (the step loop only '
              'captures device copies and moves on). If the writer dies, '
              'saves fall back to synchronous ones, and if those fail too, '
              'training continues without checkpoints (a warning, never a '
              'crash). 0 saves synchronously from the start')
flags.declare('MXTPU_CKPT_RESUME', bool, True,
              'At fit() start, restore from the newest health-certified '
              'checkpoint (the last-good pointer) when MXTPU_CKPT_DIR holds '
              'one, and skip the data iterator to the restored step. 0 always '
              'starts fresh (existing checkpoints are left alone)')
flags.declare('MXTPU_RESTART_MAX', int, 3,
              'Restart budget of the supervised training loops '
              '(module/resilient_fit.py, train_supervisor.py): how many '
              'times a failed run is restored from last-good and resumed '
              'before the failure is re-raised', min_value=0)
flags.declare('MXTPU_RESTART_BACKOFF', float, 2.0,
              'Base backoff (seconds) between supervised restarts; attempt k '
              'waits backoff * 2^(k-1), capped at 60s', min_value=0.0)
flags.declare('MXTPU_FAULT_INJECT', str, '',
              "Deterministic fault injection (mxnet_tpu_torch/faults.py): "
              "'<kind>:<step>[:<arg>]' with kind one of nan-grad, "
              'checkpoint-corrupt, dispatch-exception, backend-probe-timeout, '
              'slow-host, hang, host-loss, mem-hog, clock-skew: one real '
              'fault at a deterministic training step. Empty (default) = '
              'off: every seam is one cached-bool check')
flags.declare('MXTPU_FAULT_HOST', int, -1,
              'Restrict the MXTPU_FAULT_INJECT fault to the process whose '
              'MXTPU_HOST_ID matches. -1 (default) = arm wherever the '
              'environment reaches', min_value=-1)
flags.declare('MXTPU_SUPERVISOR_LIVENESS', float, 0.0,
              'train_supervisor.py\'s liveness tier: kill and relaunch a '
              'child whose telemetry JSONL stops growing for this many '
              'seconds. 0 (default) = off', min_value=0.0)
flags.declare('MXTPU_HEALTH', bool, False,
              'Training-health sentinels (telemetry/health.py, requires '
              'MXTPU_TELEMETRY=1): per-step NaN/Inf flags and norms computed '
              'on the step\'s device, with exact-step attribution through the '
              'fused windows, a first-bad-layer bisect, rolling-baseline '
              'spike detectors over step time, loss and grad-norm, and a '
              '"run health" block in the telemetry summary. Off = no-op')
flags.declare('MXTPU_HEALTH_ACTION', str, 'warn',
              "What a non-finite incident does: 'warn' logs it (rate-"
              "limited), 'record' only appends the health JSONL record, "
              "'raise' raises telemetry.health.TrainingHealthError with the "
              'diagnostic (step, window step, first bad layer) attached. '
              'Spike anomalies never raise',
              choices={'warn', 'record', 'raise'})
flags.declare('MXTPU_HEALTH_K', float, 8.0,
              'Spike threshold of the health anomaly detectors: an '
              'observation more than K robust deviations (MAD) from the '
              'rolling median is an anomaly', min_value=1.0)
flags.declare('MXTPU_HEALTH_WINDOW', int, 64,
              'Trailing-window length (observations) of the health anomaly '
              "detectors' rolling median/MAD baseline", min_value=4)
flags.declare('MXTPU_DYNAMICS', bool, False,
              'Per-layer training dynamics (telemetry/dynamics.py, requires '
              'MXTPU_TELEMETRY=1): per-parameter gradient norm, parameter '
              'norm and update ratio, and an activation zero-fraction per '
              'graph output, computed on the step\'s device and brought home '
              'in the window\'s existing fetch')
flags.declare('MXTPU_SCALARS_EVERY', int, 25,
              'Cadence (trained steps) at which the dynamics plane publishes '
              'its per-layer gauges and JSONL record (the JAX package\'s run '
              'ledger shares it). 0 = the plane\'s default of 25',
              min_value=0)
# The JAX package's flags for paths of its fit that the port does not have
# yet. Set, each makes Module.fit, score and predict raise
# NotImplementedError naming where it waits (module/base_module.py).
flags.declare('MXTPU_SHARDED_UPDATE', bool, True,
              'Declared for the JAX package\'s sharded weight update in its '
              'SPMD fit window (on by default there, where it engages only '
              'with a data-parallel mesh); set explicitly to a true value it '
              'raises here')
flags.declare('MXTPU_GRAD_COMPRESS', str, 'off',
              'Declared for the JAX package\'s quantized gradient '
              'collectives (off, int8, bf16, auto); any value but off raises '
              'here')

# The telemetry core (mxnet_tpu_torch/telemetry) and the serving front end,
# with the JAX package's names and defaults.
flags.declare('MXTPU_TELEMETRY', bool, False,
              'Runtime telemetry (mxnet_tpu_torch/telemetry): the counter, '
              'gauge and histogram registry, spans, the JSONL log and the '
              'end-of-run summary table, the live endpoint, the flight '
              'recorder, the SLO plane, the spans and counters of '
              'Module.fit, score and predict and their windows. Off = every '
              'entry point is a shared no-op')
flags.declare('MXTPU_TELEMETRY_PATH', str, 'telemetry.jsonl',
              'Append-only JSONL metrics log written while MXTPU_TELEMETRY=1 '
              '(one JSON record per line: spans, traces, events, the '
              'end-of-run summary)')
flags.declare('MXTPU_TELEMETRY_MAX_MB', float, 0.0,
              'Size cap (MB) of the JSONL log: once the file would exceed it, '
              'records are dropped (counted under telemetry.dropped_records, '
              'warned once). 0 = unlimited', min_value=0.0)
flags.declare('MXTPU_TELEMETRY_PORT', int, -1,
              'Live telemetry endpoint (telemetry/serve.py, requires '
              'MXTPU_TELEMETRY=1): /metrics (Prometheus text), /healthz and '
              '/summary from a stdlib HTTP server on a daemon thread. 0 binds '
              'an OS-assigned port; -1 (default) = off: no thread, no socket',
              min_value=-1, max_value=65535)
flags.declare('MXTPU_TELEMETRY_BIND', str, '127.0.0.1',
              'Bind address of the live telemetry endpoint; loopback by '
              "default, '0.0.0.0' (or empty) for all interfaces")
flags.declare('MXTPU_HOST_ID', int, 0,
              'This process\'s host index, stamped on every telemetry record '
              'and /metrics sample', min_value=0)
flags.declare('MXTPU_FLIGHT_RECORDER', int, 2048,
              'Incident flight recorder (telemetry/flight.py, requires '
              'MXTPU_TELEMETRY=1): a ring of the last N telemetry records, '
              'dumped to flight-<reason>.jsonl beside the telemetry log by '
              'each incident path (watchdog stall, SLO burn). 0 = off',
              min_value=0, max_value=1 << 20)
flags.declare('MXTPU_SLO_LATENCY_MS', float, 0.0,
              'Serving latency objective (telemetry/slo.py, requires '
              'MXTPU_TELEMETRY=1): a request slower than this counts against '
              'the error budget like a server-side error. 0 = none',
              min_value=0.0)
flags.declare('MXTPU_SLO_ERROR_PCT', float, 0.0,
              'Serving error budget (telemetry/slo.py): the allowed share (%) '
              'of bad requests; a burn rate >= 1 over MXTPU_SLO_WINDOW flips '
              '/healthz to slo_degraded. 0 = none (1% when only the latency '
              'objective is set)', min_value=0.0, max_value=100.0)
flags.declare('MXTPU_SLO_WINDOW', int, 128,
              'Rolling request window (count) of the SLO burn rate',
              min_value=8)
flags.declare('MXTPU_WATCHDOG_SECS', float, 0.0,
              'Hang watchdog (telemetry/watchdog.py): after the first '
              'progress mark, a daemon thread expects marks at least this '
              'often; a stall records a hang incident and flips /healthz to '
              '503 hung. 0 (default) = off: no thread', min_value=0.0)
flags.declare('MXTPU_WATCHDOG_ACTION', str, 'warn',
              "What the watchdog does on a stall: 'warn' records it and keeps "
              "waiting, 'abort' also exits the process with code 85",
              choices={'warn', 'abort'})
flags.declare('MXTPU_GOODPUT', bool, True,
              'Goodput accounting (telemetry/goodput.py, requires '
              'MXTPU_TELEMETRY=1): every second of the run\'s wall clock in '
              'a named bucket (step, compile, input_wait, checkpoint, eval, '
              'comm, rework) from the loops\' leaf spans, and the remainder '
              'as overhead, so that the buckets sum to the wall clock; the '
              'goodput.* gauges, a goodput JSONL record and the "where the '
              'time went" summary block. 0 = off')
flags.declare('MXTPU_GOODPUT_LOST_S', float, 0.0,
              'Lost-work seconds of earlier supervised attempts, which a '
              'supervisor stamps into a relaunched child\'s environment; the '
              'goodput record reports them as prior_lost_s with job_wall_s '
              'and job_goodput_pct beside the process\'s own buckets',
              min_value=0.0)
flags.declare('MXTPU_TIMELINE', bool, False,
              'Step timeline (telemetry/timeline.py, requires '
              'MXTPU_TELEMETRY=1): the fit loops\' phase spans (draw, put, '
              'dispatch, fetch, checkpoint, kvstore) summed per phase and '
              'divided by the steps, the step decomposed into compute, io '
              'and host-side time with the largest phase named; the '
              'timeline.* gauges, a timeline JSONL record and the "step '
              'timeline" summary block. 0 = off')
flags.declare('MXTPU_XPROF', str, '',
              "One-shot step-windowed device trace: 'start:stop' (training "
              "step counts) starts a torch.profiler capture (CPU and CUDA "
              "activity) once `start` steps have completed and stops it at "
              "`stop`, writing its chrome trace into MXTPU_XPROF_DIR. The "
              "fused fit advances a whole window of steps a call, so the "
              "boundaries fall on window multiples there. Empty = off")
flags.declare('MXTPU_XPROF_DIR', str, 'xprof_trace',
              'Output directory of the MXTPU_XPROF device trace')
flags.declare('MXTPU_PROFILER_XLA_TRACE', str, 'auto',
              "Attach the device trace (torch.profiler, into "
              "<profile stem>_cuda/) to the profiler's host-span trace while "
              "it runs: '1' or 'auto' attach it, '0' never. The JAX "
              "package's name, kept so that one environment drives both",
              choices={'0', '1', 'auto'})
flags.declare('MXTPU_SERVE_BIND', str, '127.0.0.1',
              'Bind address of the serving HTTP front end '
              '(mxnet_tpu_torch/serving/http.py, serving.serve_model); '
              "loopback by default, '0.0.0.0' (or empty) for all interfaces")
flags.declare('MXTPU_SERVE_SESSIONS', int, 64,
              'Session capacity of the decode step cache '
              '(mxnet_tpu_torch/serving/step_cache.py): each session\'s '
              'carried state lives in a ring of this many slots on the '
              'device, evicted least recently used', min_value=1)
flags.declare('MXTPU_SERVE_MAX_WAIT_MS', float, 5.0,
              'Longest time (ms) the serving batcher holds the oldest queued '
              'request while more arrivals coalesce into one padded '
              'dispatch; a dispatch fires as soon as the largest bucket is '
              'full or this deadline passes. 0 dispatches each poll at once',
              min_value=0.0)
flags.declare('MXTPU_NO_NATIVE', bool, False,
              'Skip building and loading the native runtime (src/engine.cc, '
              'profiler.cc, recordio.cc): the pure-Python RecordIO reads and '
              'writes record files, and engine.push runs its tasks on one '
              'Python thread')
flags.declare('MXTPU_ENGINE_WORKERS', int, 4,
              'Worker threads of the native dependency engine',
              aliases=('MXNET_CPU_WORKER_NTHREADS',), min_value=1,
              max_value=512)
flags.declare('MXTPU_ENGINE_TYPE', str, 'ThreadedEngine',
              'Engine scheduling mode; NaiveEngine runs each op at its push '
              '(synchronous, for debugging). Read when engine.py is imported',
              aliases=('MXNET_ENGINE_TYPE',),
              choices={'NaiveEngine', 'ThreadedEngine',
                       'ThreadedEnginePerDevice'})
flags.declare('MXTPU_DEVICE_AUGMENT', bool, False,
              'ImageRecordIter ships fixed-size uint8 batches and runs the '
              'crop, mirror and normalize on the batch\'s device (for hosts '
              'whose cores cannot feed the card from the host augment)')
flags.declare('MXTPU_HOST_CROP', bool, True,
              'In ImageRecordIter\'s device-augment mode, the workers crop '
              '(random or centre) to the target H x W before the handover, '
              'so the upload carries H*W/S^2 of the source bytes; mirror '
              'and normalize stay on the device. 0 ships the whole '
              'fixed-size source and crops on the device')
