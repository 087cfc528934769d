"""Inference serving plane over the port's models, the counterpart of
``mxnet_tpu/serving``: from a checkpoint (or a torch forward) to a
request/response loop.

- :mod:`.engine` — :class:`ServingEngine`: a bound Module
  (``ServingEngine(module)``, ``ServingEngine.from_checkpoint``) or a
  torch forward (``ServingEngine.from_forward``) behind a ladder of
  bucketed batch shapes (pad to the bucket, strip the pad rows);
- :mod:`.batcher` — :class:`DynamicBatcher`: a thread-safe request queue
  that coalesces waiting requests up to the largest bucket or
  ``MXTPU_SERVE_MAX_WAIT_MS``, dispatches one padded device call and
  splits the answers per request, with the fetch on a side thread;
- :mod:`.http` — ``/predict``, ``/models``, ``/metrics`` and ``/healthz``
  on a ThreadingHTTPServer, fronted by :mod:`.serve_model`
  (``python -m mxnet_tpu_torch.serving.serve_model``);
- :mod:`.step_cache` — :class:`DecodeEngine`: recurrent decode steps
  with each session's state kept on the device in a ring
  (:class:`StepCache`, LRU), one step program a batch bucket.

The serving metrics (``serve.*``) report through
:mod:`mxnet_tpu_torch.telemetry`.
"""
from .engine import ServingEngine, bucket_ladder
from .batcher import DynamicBatcher
from .step_cache import StepCache, DecodeEngine

__all__ = ['ServingEngine', 'DynamicBatcher', 'bucket_ladder', 'StepCache',
           'DecodeEngine']
