"""The port's RecordIO (``mxnet_tpu_torch.recordio`` on its native reader,
``mxnet_tpu_torch._native``) against the JAX package's
(``mxnet_tpu.recordio``).

- A file written by either package, on either of its writers (the native
  one built from ``src/recordio.cc`` or the pure-Python framing), reads back
  byte for byte in the other package on either reader: whole records and
  multi-part ones (a payload holding the magic word at 4-aligned offsets is
  split there and joined again), the empty record included, in order and
  by key through the ``.idx`` sidecar. The two packages' files and
  sidecars are byte-identical.
- ``pack``/``unpack``/``pack_img``/``unpack_img`` give the JAX package's
  bytes and values (scalar and multi-label headers, ``.raw`` images, and
  JPEG/PNG through Pillow).
- The native reader is live wherever ``g++`` is (``MXTPU_NO_NATIVE=1``
  selects the Python one), its errors carry the native message, and its
  build writes only into the port's git-ignored build directory: nothing
  under ``mxnet_tpu/`` or ``src/``.
"""
import ctypes
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest

import mxnet_tpu._native as jnative
import mxnet_tpu.recordio as jrec
import mxnet_tpu_torch._native as tnative
import mxnet_tpu_torch.recordio as trec
from mxnet_tpu_torch.config import flags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGIC = struct.pack('<I', 0xced7230a)


def _payloads():
    """Records of every framing case: empty, odd lengths, the magic word at
    the start, in the middle, twice in a row and at the end (each at a
    4-aligned offset: a multi-part record), and one that holds the magic
    bytes at an unaligned offset (a whole record)."""
    rng = np.random.RandomState(0)
    out = [b'', b'x', b'abc', rng.bytes(37), MAGIC, MAGIC + b'tail',
           b'head' + MAGIC + b'mid' + b'\0' + MAGIC + MAGIC + b'end',
           rng.bytes(16) + MAGIC, b'ab' + MAGIC + b'cd', rng.bytes(4096)]
    return out


JAX_GET_LIB = jnative.get_lib


@pytest.fixture
def backend(monkeypatch):
    """``set(pkg, reader)``: pick the native or the Python reader of the
    JAX package ('jax') or the port ('torch') for what follows."""
    def set_(pkg, reader):
        if pkg == 'jax':
            monkeypatch.setattr(jnative, 'get_lib', (lambda: None)
                                if reader == 'python' else JAX_GET_LIB)
            if reader == 'native':
                assert jnative.available()
        else:
            monkeypatch.setenv('MXTPU_NO_NATIVE',
                               '1' if reader == 'python' else '0')
            flags.reload('MXTPU_NO_NATIVE')
            assert tnative.backend() == reader
    yield set_
    monkeypatch.undo()
    flags.reload('MXTPU_NO_NATIVE')


MODULES = {'jax': jrec, 'torch': trec}
SIDES = [(pkg, reader) for pkg in ('jax', 'torch')
         for reader in ('native', 'python')]


@pytest.mark.parametrize('reader', SIDES, ids=lambda s: '%s-%s' % s)
@pytest.mark.parametrize('writer', SIDES, ids=lambda s: '%s-%s' % s)
def test_files_cross_read_byte_for_byte(tmp_path, backend, writer, reader):
    recs = _payloads()
    rec, idx = str(tmp_path / 'a.rec'), str(tmp_path / 'a.idx')
    backend(*writer)
    w = MODULES[writer[0]].MXIndexedRecordIO(idx, rec, 'w')
    for i, r in enumerate(recs):
        w.write_idx(i, r)
    w.close()
    backend(*reader)
    r = MODULES[reader[0]].MXRecordIO(rec, 'r')
    got = []
    while True:
        item = r.read()
        if item is None:
            break
        got.append(item)
    r.close()
    assert got == recs
    keyed = MODULES[reader[0]].MXIndexedRecordIO(idx, rec, 'r')
    assert keyed.keys == list(range(len(recs)))
    for k in (9, 0, 6, 4, 6):
        assert keyed.read_idx(k) == recs[k]
    keyed.close()


@pytest.mark.parametrize('reader', ['native', 'python'])
def test_files_and_sidecars_are_the_jax_packages(tmp_path, backend, reader):
    recs = _payloads()
    paths = {}
    for pkg in ('jax', 'torch'):
        backend(pkg, reader)
        rec, idx = str(tmp_path / (pkg + '.rec')), str(tmp_path / (pkg + '.idx'))
        w = MODULES[pkg].MXIndexedRecordIO(idx, rec, 'w')
        for i, r in enumerate(recs):
            w.write_idx(i, r)
        w.close()
        paths[pkg] = (rec, idx)
    for a, b in zip(*paths.values()):
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize('reader', ['native', 'python'])
def test_tell_seek_and_reset(tmp_path, backend, reader):
    backend('torch', reader)
    path = str(tmp_path / 'a.rec')
    w = trec.MXRecordIO(path, 'w')
    pos = []
    for r in _payloads():
        pos.append(w.tell())
        w.write(r)
    w.close()
    r = trec.MXRecordIO(path, 'r')
    r.seek_pos(pos[6])
    assert r.read() == _payloads()[6]
    assert r.tell() == pos[7]
    r.reset()
    assert r.read() == b''
    r.close()


def test_truncated_and_corrupt_files_raise(tmp_path, backend):
    path = str(tmp_path / 'a.rec')
    w = trec.MXRecordIO(path, 'w')
    w.write(b'0123456789abcdef')
    w.close()
    with open(path, 'rb') as f:
        whole = f.read()
    cases = {'short': whole[:-6], 'magic': b'\0' * 8 + whole[8:]}
    for reader in ('native', 'python'):
        backend('torch', reader)
        for what, data in cases.items():
            with open(path, 'wb') as f:
                f.write(data)
            r = trec.MXRecordIO(path, 'r')
            with pytest.raises((IOError, tnative.NativeError),
                               match='(?i)truncated|magic'):
                r.read()
            r.close()
        with open(path, 'wb') as f:     # a header cut short: a clean end
            f.write(whole[:5])
        r = trec.MXRecordIO(path, 'r')
        assert r.read() is None
        r.close()


def test_native_errors_carry_the_native_message(tmp_path, backend):
    backend('torch', 'native')
    with pytest.raises(tnative.NativeError, match='cannot open'):
        trec.MXRecordIO(str(tmp_path / 'missing' / 'a.rec'), 'r')


@pytest.mark.parametrize('label', [3.0, [1.0, 2.5, -4.0], np.arange(6)],
                         ids=['scalar', 'list', 'array'])
def test_pack_and_unpack_match_jax(label):
    header = (0, label, 17, 3)
    packed = trec.pack(header, b'payload')
    assert packed == jrec.pack(header, b'payload')
    th, ts = trec.unpack(packed)
    jh, js = jrec.unpack(packed)
    assert ts == js == b'payload'
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


@pytest.mark.parametrize('fmt', ['.raw', '.png', '.jpg'])
@pytest.mark.parametrize('shape', [(12, 10, 3), (9, 7)],
                         ids=['rgb', 'gray'])
def test_pack_img_and_unpack_img_match_jax(fmt, shape):
    if fmt != '.raw':
        pytest.importorskip('PIL')
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    header = trec.IRHeader(0, 4.0, 2, 0)
    packed = trec.pack_img(header, img, quality=90, img_fmt=fmt)
    assert packed == jrec.pack_img(header, img, quality=90, img_fmt=fmt)
    (th, ti), (jh, ji) = trec.unpack_img(packed), jrec.unpack_img(packed)
    assert th == jh
    np.testing.assert_array_equal(ti, ji)
    if fmt != '.jpg':
        want = img if fmt == '.raw' or img.ndim == 2 else img.transpose(2, 0, 1)
        np.testing.assert_array_equal(ti, want)


def test_native_reader_is_live_where_gxx_is(backend):
    if shutil.which('g++') is None:
        assert tnative.backend() == 'python'
        return
    assert tnative.backend() == 'native'
    backend('torch', 'python')
    assert tnative.get_lib() is None
    backend('torch', 'native')
    assert tnative.get_lib() is not None


def _tree(root):
    """Every file under ``root`` with its size and mtime, less the
    interpreter's caches and the JAX package's own library (which its tests
    build into it)."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != '__pycache__']
        for f in files:
            if f == 'libmxtpu.so' or '.so.tmp' in f:
                continue
            p = os.path.join(d, f)
            st = os.stat(p)
            out[p] = (st.st_size, st.st_mtime_ns)
    return out


def test_native_build_writes_only_into_the_ignored_build_dir(tmp_path,
                                                             monkeypatch):
    cxx = shutil.which('g++')
    if cxx is None:
        pytest.skip('no g++ on this host: the Python reader is live')
    roots = [os.path.join(ROOT, 'mxnet_tpu'), os.path.join(ROOT, 'src')]
    before = [_tree(r) for r in roots]
    monkeypatch.setattr(tnative, 'BUILD_DIR', tmp_path / 'build')
    out = tnative.library_path()
    assert out.parent == tmp_path / 'build'
    tnative._build(cxx, out)
    lib = tnative._bind(ctypes.CDLL(str(out)))
    assert lib.MXTGetLastError() == b''
    assert [_tree(r) for r in roots] == before
    assert [p.name for p in (tmp_path / 'build').iterdir()] == [out.name]
    # the default directory is the port's, and git ignores it
    monkeypatch.undo()
    default = tnative.library_path()
    assert os.path.dirname(default) == os.path.join(
        ROOT, 'mxnet_tpu_torch', 'ops', 'build')
    rel = os.path.relpath(default, ROOT)
    res = subprocess.run(['git', 'check-ignore', '-q', rel], cwd=ROOT)
    assert res.returncode == 0, '%s is not ignored by git' % rel
