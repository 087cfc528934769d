"""Logging helper: the counterpart of ``mxnet_tpu/log.py`` (MXNet's
python/mxnet/log.py ``get_logger``): a logger with the reference's
level-letter and timestamp format, to stderr or a file."""
import logging
import sys

__all__ = ['get_logger', 'getLogger']

_FORMAT = '%(asctime)s [%(levelname).1s] %(name)s: %(message)s'
_DATEFMT = '%m%d %H:%M:%S'


def get_logger(name=None, filename=None, filemode=None,
               level=logging.WARNING):
    """A configured logger: to ``filename`` (mode ``filemode``, default
    'a') or to stderr. A second call for the same name sets the level
    only."""
    logger = logging.getLogger(name)
    if getattr(logger, '_mxtt_init', False):
        logger.setLevel(level)
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode or 'a')
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger._mxtt_init = True
    return logger


# the reference exports the camelCase name as well
getLogger = get_logger
