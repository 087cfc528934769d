"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference it is held
against, and imports nothing of it (nor JAX). Each kernel that the JAX
package wrote in Pallas is a kernel written by hand for sm_90a here.
Entry points run on the card (``gpu(0)``) unless the caller passes
``device='cpu'``; there is no quiet fallback from one to the other.

Ported so far:

- serving the decoder that ``bench.py`` measures (:mod:`.transformer`,
  :mod:`.serving`) through the flash-attention kernel;
- the NDArray operator path: the op registry (:mod:`.ops.registry`), the
  ``nd`` namespace generated from it (:mod:`.ndarray`), and the registry
  ops LayerNorm, softmax and softmax_cross_entropy (:mod:`.ops.nn`) on the
  row kernels; ``fused_rmsnorm`` is exported beside them;
- the imperative NDArray surface: the elementwise, reduce and shape ops
  (:mod:`.ops.elemwise`, :mod:`.ops.reduce_ops`, :mod:`.ops.shape_ops`),
  NDArray arithmetic, comparison and indexing, and ``mx.rtc`` (:mod:`.rtc`):
  CUDA C kernel bodies compiled at run time by NVRTC (:mod:`.ops.nvrtc`);
- bench's training step (:func:`.transformer.make_train_step`) and the
  optimizer stack under it: the fused update ops
  (:mod:`.ops.optimizer_ops`), :mod:`.optimizer` and :mod:`.lr_scheduler`;
- bench's default ResNet-50 step (:func:`.graph_train.make_train_step`)
  through the layers under it: :mod:`.random` (a torch.Generator per
  device) and the samplers (:mod:`.ops.random_ops`, ``nd.random``),
  :mod:`.autograd` (torch's graph as the tape), the ResNet op set of
  :mod:`.ops.nn`, :mod:`.initializer`, :mod:`.symbol` with its shape and
  type inference, :mod:`.executor`, and :mod:`.gluon` (parameters, blocks,
  the ``nn`` layers and the ResNets of ``model_zoo.vision``);
- the training loop of MXNet 0.11 above the executor: ``mod.Module``
  (:mod:`.module`: BaseModule's per-batch ``fit``, ``score`` and
  ``predict``, the DataParallelExecutorGroup), :mod:`.io` (NDArrayIter),
  :mod:`.metric`, :mod:`.callback`, the local :mod:`.kvstore`,
  :mod:`.model` (checkpoints, the update paths), ``nd.save``/``nd.load``
  in both the JAX package's formats, and Gluon's Trainer and losses;
- the serving plane (:mod:`.serving`: ``ServingEngine`` over a Module or
  a forward, ``from_checkpoint``, ``DynamicBatcher``, the HTTP front end,
  ``python -m mxnet_tpu_torch.serving.serve_model``) and the telemetry
  core it reports to (:mod:`.telemetry`);
- the training loop's telemetry (the spans and counters of fit, score and
  the windows, goodput, the step timeline) and :mod:`.profiler`
  (``mx.profiler``: the host-span chrome trace with a ``torch.profiler``
  device trace beside it);
- the data plane: :mod:`.recordio` (on a native reader built from
  ``src/recordio.cc``, :mod:`._native`), the record, MNIST, CSV and
  detection iterators of :mod:`.io` with ``ImageRecordIter``'s augment on
  the card (deferred into the fit window), :mod:`.image`, ``gluon.data``
  and ``gluon.utils``;
- the RNN stack: the ``RNN`` op (:mod:`.ops.rnn_ops`, cuDNN on the card)
  and the CTC loss (:mod:`.ops.contrib_ops`), :mod:`.rnn` (the symbolic
  cells, ``BucketSentenceIter``), ``mod.BucketingModule``,
  ``SequentialModule``, ``PythonModule``, ``gluon.rnn``,
  ``gluon.loss.CTCLoss`` and the decode step cache
  (``serving.DecodeEngine``);
- the staged executor path (``group2ctx``, host ops, ``partial_forward``,
  ``first_nonfinite_node``, monitor callbacks) with :mod:`.operator` (the
  ``Custom`` op and the legacy Python operators), :mod:`.monitor`
  (``mx.mon``), :mod:`.engine` on the native dependency engine,
  :mod:`.visualization` (``mx.viz``), :mod:`.executor_manager`,
  :mod:`.log`, :mod:`.misc`, :mod:`.registry`, the docstring modules and
  :mod:`.libinfo`.

The kernels and their plain versions are in :mod:`.ops.cuda_kernels`.
"""
from .libinfo import __version__  # noqa: F401  (the one version source)
from . import base
from . import libinfo
from . import log
from .base import MXNetError
from . import config
from . import context
from .context import Context, cpu, gpu, current_context
from . import ops
from .ops import fused_rmsnorm
from . import ndarray
from . import ndarray as nd
from . import rtc
from . import lr_scheduler
from . import optimizer
from . import transformer
from . import profiler
from . import telemetry
from . import serving
from . import random
from . import autograd
from . import attribute
from . import name
from . import initializer
from . import initializer as init
from . import symbol
from . import symbol as sym
from . import executor
from . import io
from . import recordio
from . import image
from . import metric
from . import callback
from . import kvstore
from . import kvstore as kv
from . import model
from .model import save_checkpoint, load_checkpoint
from . import module
from . import module as mod
from . import gluon
from . import rnn
from . import graph_train
from .attribute import AttrScope
from . import engine
from . import monitor
from . import monitor as mon
from .monitor import Monitor
from . import visualization
from . import visualization as viz
from . import registry
from .executor_manager import DataParallelExecutorManager  # noqa: F401
from . import operator
from .operator import CustomOp, CustomOpProp

__all__ = ['MXNetError', 'Context', 'cpu', 'gpu', 'current_context', 'base',
           'config', 'context', 'ops', 'fused_rmsnorm', 'ndarray', 'nd',
           'rtc', 'lr_scheduler', 'optimizer', 'transformer', 'profiler',
           'telemetry',
           'serving',
           'random', 'autograd', 'attribute', 'name', 'initializer', 'init',
           'symbol', 'sym', 'executor', 'io', 'recordio', 'image', 'metric', 'callback',
           'kvstore', 'kv', 'model', 'save_checkpoint', 'load_checkpoint',
           'module', 'mod', 'gluon', 'rnn', 'graph_train', 'AttrScope',
           'libinfo', 'log', 'engine', 'monitor', 'mon', 'Monitor',
           'visualization', 'viz', 'registry', 'DataParallelExecutorManager',
           'operator', 'CustomOp', 'CustomOpProp']
