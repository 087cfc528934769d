"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference it is held
against, and imports nothing of it (nor JAX). Each kernel that the JAX
package wrote in Pallas is a kernel written by hand for sm_90a here.
Entry points run on the card (``gpu(0)``) unless the caller passes
``device='cpu'``; there is no quiet fallback from one to the other.

Ported so far: serving the decoder that ``bench.py`` measures
(:mod:`.transformer`, :mod:`.serving`) through the flash-attention kernel
(:mod:`.ops.cuda_kernels`).
"""
from . import context
from .context import Context, cpu, gpu, current_context
from . import ops
from . import transformer
from . import serving

__all__ = ['Context', 'cpu', 'gpu', 'current_context', 'context', 'ops',
           'transformer', 'serving']
