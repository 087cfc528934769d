"""Custom layers of the model zoo: the counterpart of
``mxnet_tpu/gluon/model_zoo/custom_layers.py`` (``HybridConcurrent`` and
``Identity``)."""
from ..block import HybridBlock

__all__ = ['HybridConcurrent', 'Identity']


class HybridConcurrent(HybridBlock):
    """Runs its children on the same input and concatenates their outputs
    along ``concat_dim``.

    Example::

        net = HybridConcurrent(concat_dim=1)
        with net.name_scope():
            net.add(nn.Dense(10, activation='relu'))
            net.add(nn.Dense(20))
            net.add(Identity())
    """

    def __init__(self, concat_dim, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.concat_dim = concat_dim

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children]
        return F.concat(*out, dim=self.concat_dim)

    def __repr__(self):
        modstr = '\n'.join('  (%d): %s' % (k, b)
                           for k, b in enumerate(self._children))
        return '%s(\n%s\n)' % (type(self).__name__, modstr)


class Identity(HybridBlock):
    """Passes the input through unchanged: the residual branch beside a
    ``HybridConcurrent``'s others."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x
