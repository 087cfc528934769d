"""Gluon: the imperative/hybrid neural-network API, the counterpart of
``mxnet_tpu/gluon/`` for Parameter, ParameterDict, Block, HybridBlock,
SymbolBlock, ``nn`` (the basic and convolution layers),
``model_zoo.vision`` (ResNet v1 and v2), the Trainer and the losses. The
utils, data and rnn are not ported yet."""
from .parameter import (Parameter, ParameterDict, DeferredInitializationError,
                        params_from_numpy)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import model_zoo
