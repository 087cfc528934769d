"""Inception V3: the counterpart of ``mxnet_tpu/gluon/model_zoo/vision/
inception.py``, built from the same table of conv specs (``"192x7.1s2p3.0"``
= 192 channels, a 7 x 1 kernel, stride 2, pad (3, 0)) with the same cell
prefixes (A1_ ... E2_) and child order, so that the parameter names match
the JAX package's. It ends in an 8 x 8 average pool: 299 x 299 input.
"""
from ....context import cpu
from ...block import HybridBlock
from ... import nn

__all__ = ['Inception3', 'inception_v3']


def _parse_conv(tok):
    """'CHxK[.K2][sS][pP[.P2]]' -> Conv2D kwargs (BN+relu added by
    _unit). Examples: '64x1', '96x3p1', '384x3s2', '192x1.7p0.3'."""
    ch, rest = tok.split('x', 1)
    kw = {'channels': int(ch), 'use_bias': False}

    def grab(marker):
        nonlocal rest
        if marker in rest:
            rest, val = rest.split(marker, 1)
            return val
        return None

    pad = grab('p')
    stride = grab('s')

    def pair(v):
        if v is None:
            return None
        return tuple(int(x) for x in v.split('.')) if '.' in v else int(v)

    kw['kernel_size'] = pair(rest)
    if stride is not None:
        kw['strides'] = pair(stride)
    if pad is not None:
        kw['padding'] = pair(pad)
    return kw


def _unit(tok):
    """One conv-BN-relu unit from a spec token."""
    seq = nn.HybridSequential(prefix='')
    seq.add(nn.Conv2D(**_parse_conv(tok)))
    seq.add(nn.BatchNorm(epsilon=0.001))
    seq.add(nn.Activation('relu'))
    return seq


class _Fanout(HybridBlock):
    """Run every child on the same input and concat on channels."""

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.Concat(*[c(x) for c in self._children], dim=1)


def _branch(spec):
    """Build one branch from a comma-joined spec: optional leading
    'avg'/'max' pool, conv tokens, and an optional trailing fanout
    'a|b' (the E-cell 1x3 / 3x1 split)."""
    seq = nn.HybridSequential(prefix='')
    for tok in spec.split(','):
        if tok == 'avg':
            seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
        elif tok == 'max':
            seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        elif '|' in tok:
            fan = _Fanout(prefix='')
            for sub in tok.split('|'):
                fan.add(_unit(sub))
            seq.add(fan)
        else:
            seq.add(_unit(tok))
    return seq


def _cell(prefix, branch_specs):
    cell = _Fanout(prefix=prefix)
    with cell.name_scope():
        for spec in branch_specs:
            cell.add(_branch(spec))
    return cell


# the stem's tokens ('M' = a 3x3/2 max pool) and the table of grid cells:
# the published Inception-v3 architecture
_STEM = ('32x3s2', '32x3', '64x3p1', 'M', '80x1', '192x3', 'M')


def _a_cell(pool_ch):
    return ('64x1',
            '48x1,64x5p2',
            '64x1,96x3p1,96x3p1',
            'avg,%dx1' % pool_ch)


def _c_cell(c7):
    d = {'c': c7}
    return ('192x1',
            '%(c)dx1,%(c)dx1.7p0.3,192x7.1p3.0' % d,
            '%(c)dx1,%(c)dx7.1p3.0,%(c)dx1.7p0.3,%(c)dx7.1p3.0,'
            '192x1.7p0.3' % d,
            'avg,192x1')


_E_SPLIT = '384x1.3p0.1|384x3.1p1.0'
_CELLS = (
    ('A1_', _a_cell(32)),
    ('A2_', _a_cell(64)),
    ('A3_', _a_cell(64)),
    ('B_', ('384x3s2', '64x1,96x3p1,96x3s2', 'max')),
    ('C1_', _c_cell(128)),
    ('C2_', _c_cell(160)),
    ('C3_', _c_cell(160)),
    ('C4_', _c_cell(192)),
    ('D_', ('192x1,320x3s2',
            '192x1,192x1.7p0.3,192x7.1p3.0,192x3s2', 'max')),
    ('E1_', ('320x1', '384x1,' + _E_SPLIT, '448x1,384x3p1,' + _E_SPLIT,
             'avg,192x1')),
    ('E2_', ('320x1', '384x1,' + _E_SPLIT, '448x1,384x3p1,' + _E_SPLIT,
             'avg,192x1')),
)


def make_aux(classes):
    """The auxiliary classifier head."""
    out = nn.HybridSequential(prefix='')
    out.add(nn.AvgPool2D(pool_size=5, strides=3))
    out.add(_unit('128x1'))
    out.add(_unit('768x5'))
    out.add(nn.Flatten())
    out.add(nn.Dense(classes))
    return out


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix='')
            for tok in _STEM:
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2)
                                  if tok == 'M' else _unit(tok))
            for prefix, branches in _CELLS:
                self.features.add(_cell(prefix, branches))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=cpu(), **kwargs):
    """Inception V3; there are no pretrained weights."""
    if pretrained:
        raise ValueError('no pretrained weights are available')
    return Inception3(**kwargs)
