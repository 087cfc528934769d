"""Inference serving over the port's models: the bucketed batching
contract of ``mxnet_tpu/serving`` (:mod:`.engine`). The dynamic batcher,
the decode step cache and the HTTP front end are later slices."""
from .engine import ServingEngine, bucket_ladder

__all__ = ['ServingEngine', 'bucket_ladder']
