"""Gluon: the imperative/hybrid neural-network API, the counterpart of
``mxnet_tpu/gluon/`` for Parameter, ParameterDict, Block, HybridBlock,
SymbolBlock, ``nn`` (the basic and convolution layers), ``model_zoo``
(every vision family), the Trainer, the losses, ``data`` (datasets,
samplers, the DataLoader, the vision datasets) and ``utils``
(``split_and_load`` and the rest). The rnn package is not ported yet
(ROADMAP.md §1 item 10)."""
from .parameter import (Parameter, ParameterDict, DeferredInitializationError,
                        params_from_numpy)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import data
from . import utils
from . import model_zoo
from .utils import split_and_load, split_data  # noqa: F401
