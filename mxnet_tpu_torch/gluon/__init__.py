"""Gluon: the imperative/hybrid neural-network API, the counterpart of
``mxnet_tpu/gluon/`` for Parameter, ParameterDict, Block, HybridBlock,
SymbolBlock, ``nn`` (the basic and convolution layers), ``model_zoo``
(every vision family), the Trainer, the losses, ``data`` (datasets,
samplers, the DataLoader, the vision datasets), ``utils``
(``split_and_load`` and the rest) and ``rnn`` (the recurrent cells and
the fused RNN, LSTM and GRU layers)."""
from .parameter import (Parameter, ParameterDict, DeferredInitializationError,
                        params_from_numpy)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import data
from . import utils
from . import model_zoo
from . import rnn
from .utils import split_and_load, split_data  # noqa: F401
