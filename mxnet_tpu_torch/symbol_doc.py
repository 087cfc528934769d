"""Docstring addenda for the sym namespace: the counterpart of
``mxnet_tpu/symbol_doc.py`` (MXNet's python/mxnet/symbol_doc.py). A
subclass of SymbolDoc named ``<op>Doc`` adds its docstring to
:func:`_build_doc`'s text for ``sym.<op>``."""
from .base import build_param_doc as _build_param_doc

__all__ = ['SymbolDoc']


class SymbolDoc(object):
    """Base class: subclasses named ``<op>Doc`` add their docstring to the
    op's. Also holds the reference's doc-test helper."""

    @staticmethod
    def get_output_shape(sym, **input_shapes):
        """The output shapes, by output name."""
        _, s_outputs, _ = sym.infer_shape(**input_shapes)
        return dict(zip(sym.list_outputs(), s_outputs))


class ActivationDoc(SymbolDoc):
    """
    Examples
    --------
    >>> relu = mx.sym.Activation(data, act_type='relu')
    """


class DropoutDoc(SymbolDoc):
    """
    Examples
    --------
    >>> out = mx.sym.Dropout(data, p=0.5)
    """


class EmbeddingDoc(SymbolDoc):
    """
    Examples
    --------
    >>> emb = mx.sym.Embedding(data, input_dim=1000, output_dim=16)
    """


class FlattenDoc(SymbolDoc):
    """
    Examples
    --------
    >>> flat = mx.sym.Flatten(data)
    """


class FullyConnectedDoc(SymbolDoc):
    """
    Examples
    --------
    >>> fc = mx.sym.FullyConnected(data, num_hidden=128)
    """


class ConcatDoc(SymbolDoc):
    """
    Examples
    --------
    >>> out = mx.sym.Concat(a, b, dim=1)
    """


class BroadcastPlusDoc(SymbolDoc):
    """
    Examples
    --------
    >>> c = mx.sym.broadcast_plus(a, b)
    """


def _build_doc(func_name, desc, arg_names, arg_types, arg_desc,
               key_var_num_args=None, ret_type=None):
    """A generated composer's docstring: the description, the parameters
    and the op's addendum."""
    doc_str = desc + '\n\n' + _build_param_doc(arg_names, arg_types,
                                               arg_desc)
    if key_var_num_args:
        doc_str += '\nThis function supports variable length of '
        doc_str += 'positional input.\n'
    if ret_type:
        doc_str += '\nReturns\n-------\n%s\n    The result.' % ret_type
    hook = globals().get('%sDoc' % func_name)
    if hook and hook.__doc__:
        doc_str += hook.__doc__
    return doc_str
