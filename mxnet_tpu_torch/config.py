"""Typed environment flags: the counterpart of the flag registry of
``mxnet_tpu/config.py`` (``Flag``, ``FlagRegistry``, ``flags``), with its
``flags.get``/``flags.reload`` surface and its parsing and validation
(the JAX registry's MXNET_* aliases, enum choices and catalog text are
not ported: no ported flag uses them).

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
- ``MXTPU_CKPT_DIR``, ``MXTPU_FAULT_INJECT``, ``MXTPU_TELEMETRY``,
  ``MXTPU_HEALTH``, ``MXTPU_DYNAMICS``, ``MXTPU_SHARDED_UPDATE`` and
  ``MXTPU_GRAD_COMPRESS``: paths of the JAX package's ``Module.fit`` and
  eval that the port does not have yet; set, each makes them raise
  NotImplementedError (``module/base_module.py``).

A flag may name aliases (the reference's ``MXNET_*`` spellings), read when
the flag's own name is unset.
"""
import os
import threading

__all__ = ['Flag', 'FlagRegistry', 'flags']


class Flag:
    def __init__(self, name, type_, default, doc, min_value=None,
                 max_value=None, aliases=()):
        self.name = name
        self.aliases = tuple(aliases)
        self.type = type_
        self.default = default
        self.doc = doc
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
# The JAX package's flags for paths of its fit and eval that the port does
# not have yet. Set, each makes Module.fit, score and predict raise
# NotImplementedError naming where it waits (module/base_module.py).
flags.declare('MXTPU_CKPT_DIR', str, '',
              'Declared for the JAX package\'s periodic training '
              'checkpoints; setting it raises here')
flags.declare('MXTPU_FAULT_INJECT', str, '',
              'Declared for the JAX package\'s fault injection; setting it '
              'raises here')
flags.declare('MXTPU_TELEMETRY', bool, False,
              'Declared for the JAX package\'s telemetry; setting it raises '
              'here')
flags.declare('MXTPU_HEALTH', bool, False,
              'Declared for the JAX package\'s training-health sentinels; '
              'setting it raises here')
flags.declare('MXTPU_DYNAMICS', bool, False,
              'Declared for the JAX package\'s per-layer training dynamics; '
              'setting it raises here')
flags.declare('MXTPU_SHARDED_UPDATE', bool, True,
              'Declared for the JAX package\'s sharded weight update in its '
              'SPMD fit window (on by default there, where it engages only '
              'with a data-parallel mesh); set explicitly to a true value it '
              'raises here')
flags.declare('MXTPU_GRAD_COMPRESS', str, 'off',
              'Declared for the JAX package\'s quantized gradient '
              'collectives (off, int8, bf16, auto); any value but off raises '
              'here')
