"""RecordIO, the packed record format and the image pack and unpack
helpers: the counterpart of ``mxnet_tpu/recordio.py`` (``MXRecordIO``,
``MXIndexedRecordIO`` with its ``.idx`` sidecar, ``IRHeader``, ``pack``,
``unpack``, ``pack_img``, ``unpack_img``). A file written by either
package reads back byte for byte in the other, on either reader.

The native reader and writer (``src/recordio.cc``, :mod:`._native`) serve
every file they can; ``MXTPU_NO_NATIVE=1`` or a host without ``g++``
takes the pure-Python framing below, which writes the same bytes.

Binary layout per record (dmlc recordio): uint32 magic 0xced7230a,
uint32 lrecord (upper 3 bits cflag, lower 29 bits length), payload,
padded to 4-byte boundary. Image records carry an IRHeader
(uint32 flag, float32 label, uint64 id, uint64 id2) before the payload.
"""
import ctypes
import os
import struct
from collections import namedtuple

import numpy as np

from . import _native

__all__ = ['MXRecordIO', 'MXIndexedRecordIO', 'IRHeader', 'pack', 'unpack',
           'pack_img', 'unpack_img']

_kMagic = 0xced7230a

IRHeader = namedtuple('HeaderType', ['flag', 'label', 'id', 'id2'])
_IR_FORMAT = 'IfQQ'
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential record reader ('r') or writer ('w') of one file."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.is_open = False
        self.open()

    def open(self):
        lib = _native.get_lib()
        if self.flag == 'w':
            self.writable = True
        elif self.flag == 'r':
            self.writable = False
        else:
            raise ValueError('Invalid flag %s' % self.flag)
        if lib is not None:
            # native reader/writer (src/recordio.cc)
            self._lib = lib
            self._nh = ctypes.c_void_p()
            create = (lib.MXTRecordIOWriterCreate if self.writable
                      else lib.MXTRecordIOReaderCreate)
            _native.check_call(create(self.uri.encode(),
                                      ctypes.byref(self._nh)), lib)
            self.handle = None
        else:
            self._lib = None
            self._nh = None
            self.handle = open(self.uri, 'wb' if self.writable else 'rb')
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if self.is_open:
            if self._nh is not None:
                free = (self._lib.MXTRecordIOWriterFree if self.writable
                        else self._lib.MXTRecordIOReaderFree)
                _native.check_call(free(self._nh), self._lib)
                self._nh = None
            else:
                self.handle.close()
            self.is_open = False
            self.pid = None

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d['handle'] = None
        d['_lib'] = None
        d['_nh'] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if self.is_open:
            self.is_open = False
            self.open()

    def write(self, buf):
        assert self.writable
        if self._nh is not None:
            _native.check_call(self._lib.MXTRecordIOWriterWrite(
                self._nh, bytes(buf), len(buf)), self._lib)
            return
        length = len(buf)
        if length >= 1 << 29:
            raise ValueError('RecordIO only accepts records < 2^29 bytes')
        buf = bytes(buf)
        # dmlc magic-escape: the payload is split at 4-aligned occurrences
        # of the magic word (dropped on write, re-inserted on read) so a
        # reader can always resync on magic. cflag: 0=whole, 1=begin,
        # 2=middle, 3=end (upper 3 bits of lrecord).
        lower = (length >> 2) << 2
        hits = np.flatnonzero(
            np.frombuffer(buf[:lower], dtype='<u4') == _kMagic) * 4
        if len(hits) == 0:
            self._write_chunk(0, buf)
            return
        dptr = 0
        for j, i in enumerate(hits):
            self._write_chunk(1 if j == 0 else 2, buf[dptr:i])
            dptr = int(i) + 4
        self._write_chunk(3, buf[dptr:])

    def _write_chunk(self, cflag, data):
        self.handle.write(struct.pack(
            '<II', _kMagic, (cflag << 29) | (len(data) & 0x1fffffff)))
        self.handle.write(data)
        pad = (4 - len(data) % 4) % 4
        if pad:
            self.handle.write(b'\x00' * pad)

    def read(self):
        assert not self.writable
        if self._nh is not None:
            out = ctypes.c_void_p()
            ln = ctypes.c_size_t()
            _native.check_call(self._lib.MXTRecordIOReaderNext(
                self._nh, ctypes.byref(out), ctypes.byref(ln)), self._lib)
            if ln.value == ctypes.c_size_t(-1).value:
                return None
            return ctypes.string_at(out, ln.value) if ln.value else b''
        got = self._read_chunk()
        if got is None:
            return None
        cflag, buf = got
        if cflag == 0:
            return buf
        if cflag != 1:
            raise IOError('RecordIO stream begins mid multi-part record')
        out = bytearray(buf)
        magic_bytes = struct.pack('<I', _kMagic)
        while True:
            got = self._read_chunk()
            if got is None:
                raise IOError('truncated multi-part RecordIO record')
            cflag, buf = got
            if cflag not in (2, 3):
                raise IOError('bad continuation flag %d' % cflag)
            out += magic_bytes + buf
            if cflag == 3:
                return bytes(out)

    def _read_chunk(self):
        head = self.handle.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack('<II', head)
        if magic != _kMagic:
            raise IOError('Invalid RecordIO magic number')
        length = lrec & 0x1fffffff
        buf = self.handle.read(length)
        if len(buf) < length:
            # full header but short payload (writer killed mid-record):
            # corrupt, not clean EOF — match the native reader's error
            raise IOError('truncated RecordIO record')
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        return lrec >> 29, buf

    def tell(self):
        if self._nh is not None:
            out = ctypes.c_size_t()
            fn = (self._lib.MXTRecordIOWriterTell if self.writable
                  else self._lib.MXTRecordIOReaderTell)
            _native.check_call(fn(self._nh, ctypes.byref(out)), self._lib)
            return out.value
        return self.handle.tell()

    def seek_pos(self, pos):
        assert not self.writable
        if self._nh is not None:
            _native.check_call(self._lib.MXTRecordIOReaderSeek(self._nh, pos),
                               self._lib)
        else:
            self.handle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Keyed random access through a ``.idx`` sidecar of ``key\tpos``
    lines, written at close."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == 'r' and os.path.exists(self.idx_path):
            with open(self.idx_path) as fidx:
                for line in fidx:
                    parts = line.strip().split('\t')
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable and self.idx:
            with open(self.idx_path, 'w') as fidx:
                for key in self.keys:
                    fidx.write('%s\t%d\n' % (str(key), self.idx[key]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.seek_pos(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """A header and a byte payload as one record: a scalar label in the
    header, a multi-label as ``flag`` f32 values after it."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id, header.id2)
        return hdr + s
    label = np.asarray(header.label, dtype=np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """``(header, payload)`` of a record; a multi-label comes back as an
    f32 array in ``header.label``."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt='.raw'):
    """Pack an image array. '.raw' stores uint8 CHW pixels + shape prefix
    (hermetic, no codec dependency); '.jpg'/'.png' require pillow."""
    img = np.asarray(img)
    if img_fmt == '.raw':
        shape = np.asarray(img.shape, dtype=np.int32)
        payload = b'RAW0' + struct.pack('<I', len(shape)) + shape.tobytes() + \
            img.astype(np.uint8).tobytes()
        return pack(header, payload)
    try:
        from PIL import Image
        import io as _io
    except ImportError:
        raise ImportError('pack_img with %s requires pillow; use .raw' % img_fmt)
    buf = _io.BytesIO()
    fmt = img_fmt.lstrip('.').upper()
    if fmt == 'JPG':
        fmt = 'JPEG'  # PIL registers only the long name
    Image.fromarray(img).save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1, data_shape=None):
    header, payload = unpack(s)
    if payload[:4] == b'RAW0':
        ndim = struct.unpack('<I', payload[4:8])[0]
        shape = np.frombuffer(payload[8:8 + 4 * ndim], dtype=np.int32)
        img = np.frombuffer(payload[8 + 4 * ndim:], dtype=np.uint8)
        img = img.reshape(tuple(shape))
    else:
        try:
            from PIL import Image
            import io as _io
            img = np.asarray(Image.open(_io.BytesIO(payload)))
            if img.ndim == 3:
                img = img.transpose(2, 0, 1)
        except ImportError:
            raise ImportError('JPEG/PNG decode requires pillow; '
                              'use .raw packed records')
    if data_shape is not None and tuple(img.shape) != tuple(data_shape):
        if img.ndim == 2 and len(data_shape) == 3 and data_shape[0] == 1:
            img = img[None]
        elif img.size == int(np.prod(data_shape)):
            img = img.reshape(data_shape)
    return header, img
