"""mx.rnn, the symbolic RNN API: the counterpart of
``mxnet_tpu/rnn/__init__.py`` (the cells, the rnn checkpoints and
``BucketSentenceIter``)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn import *       # noqa: F401,F403
from .io import *        # noqa: F401,F403
