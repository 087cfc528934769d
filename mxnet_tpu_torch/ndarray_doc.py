"""Docstring addenda for the nd namespace: the counterpart of
``mxnet_tpu/ndarray_doc.py`` (MXNet's python/mxnet/ndarray_doc.py). A
subclass of NDArrayDoc named ``<op>Doc`` adds its docstring to
:func:`_build_doc`'s text for ``nd.<op>``."""
from .base import build_param_doc as _build_param_doc

__all__ = ['NDArrayDoc']


class NDArrayDoc(object):
    """Base class: subclasses named ``<op>Doc`` add their docstring to the
    op's."""


class ReshapeDoc(NDArrayDoc):
    """
    Examples
    --------
    >>> x = mx.nd.arange(6).reshape((2, 3))
    >>> x.shape
    (2, 3)
    """


class elemwise_addDoc(NDArrayDoc):
    """
    Example
    -------
    >>> (mx.nd.ones((2,)) + mx.nd.ones((2,))).asnumpy()
    array([ 2.,  2.], dtype=float32)
    """


class BroadcastToDoc(NDArrayDoc):
    """
    Examples
    --------
    >>> mx.nd.ones((1, 3)).broadcast_to((2, 3)).shape
    (2, 3)
    """


class CustomDoc(NDArrayDoc):
    """
    Example
    -------
    >>> mx.nd.Custom(x, label, op_type='my_softmax')
    """


def _build_doc(func_name, desc, arg_names, arg_types, arg_desc,
               key_var_num_args=None, ret_type=None):
    """A generated function's docstring: the description, the parameters
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
