"""Gluon's utilities: the counterpart of ``mxnet_tpu/gluon/utils.py``
(``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``,
``download``)."""
import math

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ['split_data', 'split_and_load', 'clip_global_norm',
           'download', 'check_sha1']


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut into ``num_slice`` slices along ``batch_axis`` (the
    last takes the remainder unless ``even_split``)."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            'Too many slices for data with shape %s. Arguments are '
            'num_slice=%d and batch_axis=%d.' % (str(data.shape), num_slice,
                                                 batch_axis))
    if even_split and size % num_slice != 0:
        raise ValueError(
            'data with shape %s cannot be evenly split into %d slices along '
            'axis %d. Use a batch size that\'s multiple of %d or set '
            'even_split=False to allow uneven partitioning of data.' % (
                str(data.shape), num_slice, batch_axis, num_slice))

    step = size // num_slice
    if batch_axis == 0:
        slices = [data[i * step:(i + 1) * step] if i < num_slice - 1
                  else data[i * step:size]
                  for i in range(num_slice)]
    elif even_split:
        slices = nd.split(data, num_outputs=num_slice, axis=batch_axis)
    else:
        slices = [nd.slice_axis(data, batch_axis, i * step, (i + 1) * step)
                  if i < num_slice - 1 else
                  nd.slice_axis(data, batch_axis, i * step, size)
                  for i in range(num_slice)]
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis`` and each slice loaded into
    one context of ``ctx_list`` (a numpy array is loaded first)."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [i.as_in_context(ctx) for i, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Rescale ``arrays`` in place so that their joint 2-norm is at most
    ``max_norm``; returns the norm before."""
    assert len(arrays) > 0
    total_norm = 0
    for arr in arrays:
        arr = arr.reshape((-1,))
        norm = nd.dot(arr, arr)
        total_norm += norm.asscalar()
    total_norm = math.sqrt(total_norm)
    ratio = max_norm / (total_norm + 1e-8)
    if ratio < 1:
        for arr in arrays:
            arr *= ratio
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's sha1 matches."""
    import hashlib
    sha1 = hashlib.sha1()
    with open(filename, 'rb') as f:
        while True:
            data = f.read(1 << 20)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """Download a file to ``path``. An offline host raises OSError
    instead of hanging; a file:// url is copied, and a file already
    there (with the right sha1, if given) is returned as it is."""
    import os
    import shutil
    import urllib.request

    fname = url.split('/')[-1]
    assert fname, ('cannot derive a file name from %r; provide path= '
                   'with a file name' % url)
    if path is None:
        path = fname
    elif os.path.isdir(path):
        path = os.path.join(path, fname)
    if os.path.exists(path) and not overwrite and \
            (sha1_hash is None or check_sha1(path, sha1_hash)):
        return path
    dirname = os.path.dirname(os.path.abspath(path))
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    # write to a temp name and move into place only on success, so a
    # dropped connection never leaves a truncated file that later calls
    # would return as a valid cached download
    tmp = path + '.part'
    if url.startswith('file://'):
        shutil.copyfile(url[len('file://'):], tmp)
    else:
        try:
            r = urllib.request.urlopen(url, timeout=30)
        except OSError as e:
            raise OSError('download of %s failed (offline environment?): '
                          '%s' % (url, e))
        try:
            with r, open(tmp, 'wb') as f:
                shutil.copyfileobj(r, f)
        except OSError:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
    if sha1_hash and not check_sha1(tmp, sha1_hash):
        os.remove(tmp)
        raise OSError('downloaded file %s sha1 mismatch' % path)
    os.replace(tmp, path)
    return path
