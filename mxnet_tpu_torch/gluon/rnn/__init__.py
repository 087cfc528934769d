"""gluon.rnn, the recurrent cells and layers: the counterpart of
``mxnet_tpu/gluon/rnn/``."""
from .rnn_cell import *   # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
