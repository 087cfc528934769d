"""Operators of the port. :mod:`.cuda_kernels` holds the hand-written CUDA
kernels (built from ``csrc/`` at first use) beside their plain versions."""
from .cuda_kernels import flash_attention, flash_attention_lse

__all__ = ['flash_attention', 'flash_attention_lse']
