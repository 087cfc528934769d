"""Operators of the port. Importing this package registers the ops.

:mod:`.registry` holds them; :mod:`.nn` registers LayerNorm, softmax,
softmax_cross_entropy, the ResNet op set (FullyConnected, Convolution,
Deconvolution, Pooling, Activation, LeakyReLU, BatchNorm, Dropout,
SoftmaxOutput) and the other layer ops and heads, :mod:`.random_ops` the
samplers, :mod:`.elemwise` the elementwise unary, binary, scalar and
comparison ops and ``add_n``, :mod:`.reduce_ops` the reductions and
broadcasts, :mod:`.shape_ops` the shape, indexing and init ops,
:mod:`.optimizer_ops` the fused optimizer updates, :mod:`.linalg_sort` the
products, factorizations and orderings, :mod:`.rnn_ops` the fused RNN,
:mod:`.contrib_ops` the CTC loss and the detection, vision and signal
ops, :mod:`.sparse_ops` the graph forms of the sparse ops, and
:mod:`.legacy_ops` the legacy names. :mod:`.cuda_kernels` holds the hand-written CUDA kernels (built from
``csrc/`` at first use) beside their plain versions, and :mod:`.nvrtc`
compiles CUDA C at run time for :mod:`..rtc`.
"""
from . import registry
from . import nn                  # noqa: F401  (registers its ops)
from . import elemwise            # noqa: F401  (registers its ops)
from . import reduce_ops          # noqa: F401  (registers its ops)
from . import shape_ops           # noqa: F401  (registers its ops)
from . import optimizer_ops       # noqa: F401  (registers its ops)
from . import random_ops          # noqa: F401  (registers its ops)
from . import linalg_sort         # noqa: F401  (registers its ops)
from . import rnn_ops             # noqa: F401  (registers its ops)
from . import contrib_ops         # noqa: F401  (registers its ops)
from . import sparse_ops          # noqa: F401  (registers its ops)
from . import legacy_ops          # noqa: F401  (aliases the ops above)
from .registry import register, get, list_ops, exists
from .cuda_kernels import (flash_attention, flash_attention_lse,
                           fused_rmsnorm, fused_layernorm, fused_softmax,
                           softmax_xent)

__all__ = ['registry', 'register', 'get', 'list_ops', 'exists',
           'flash_attention', 'flash_attention_lse', 'fused_rmsnorm',
           'fused_layernorm', 'fused_softmax', 'softmax_xent']
