"""The port's version and the libraries it builds: the counterpart of
``mxnet_tpu/libinfo.py`` (MXNet's python/mxnet/libinfo.py)."""
__all__ = ['find_lib_path', '__version__']

__version__ = '0.1.0'


def find_lib_path():
    """The libraries the port has built for the sources in this checkout:
    the native runtime (``_native.library_path()``, built by g++) and the
    CUDA kernels (``ops/build/*.so``, built by nvcc on a machine with a
    card), those that exist. Raises RuntimeError when none does: they are
    built at their first use."""
    from . import _native
    from .ops import _build
    found = [p for p in [_native.library_path()] +
             [_build._library_path(p.stem) for p in
              sorted(_build._CSRC.glob('*.cu'))] if p.is_file()]
    if not found:
        raise RuntimeError(
            'no native library built yet: _native.get_lib() builds the '
            'runtime and ops._build.load(name) the CUDA kernels at their '
            'first use')
    return [str(p) for p in found]
