"""Gluon: the imperative/hybrid neural-network API, the counterpart of
``mxnet_tpu/gluon/`` for Parameter, ParameterDict, Block, HybridBlock,
SymbolBlock, ``nn`` (the basic and convolution layers) and
``model_zoo.vision`` (ResNet v1 and v2). The Trainer, losses, utils, data
and rnn are not ported yet."""
from .parameter import (Parameter, ParameterDict, DeferredInitializationError,
                        params_from_numpy)
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import model_zoo
