"""Pre-trained parameter files: the counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``. Files are read from a local
directory only; nothing is downloaded. A missing file raises with where to
put it."""
import os

__all__ = ['get_model_file', 'purge']

# name -> sha1 of a published .params file; empty, since nothing is fetched
# (local files are trusted as they are)
_model_sha1 = {}


def short_hash(name):
    if name not in _model_sha1:
        raise ValueError('Pretrained model for %s is not available.' % name)
    return _model_sha1[name][:8]


def get_model_file(name, local_dir=os.path.expanduser('~/.mxnet/models/')):
    """The path of the local parameter file ``<local_dir>/<name>.params``;
    IOError if it is not there."""
    file_path = os.path.join(local_dir, '%s.params' % name)
    if os.path.exists(file_path):
        return file_path
    raise IOError(
        'Pretrained model file %s is not present and nothing is downloaded. '
        'Place the .params file at that path (checkpoints of either package '
        'load), or train from scratch with pretrained=False.' % file_path)


def purge(local_dir=os.path.expanduser('~/.mxnet/models/')):
    """Remove every ``.params`` file of ``local_dir``."""
    if not os.path.isdir(local_dir):
        return
    for f in os.listdir(local_dir):
        if f.endswith('.params'):
            os.remove(os.path.join(local_dir, f))
