"""The streaming RecordIO image pipeline: the counterpart of
``mxnet_tpu/io/image_record.py``.

One framing-only offset scan at construction (no decode); then each epoch
a producer thread walks the offset order (shuffled and cut into
``num_parts`` shards as asked), a ThreadPoolExecutor of
``preprocess_threads`` workers decodes and augments the records one each
(PIL's decode and numpy release the GIL), and the numpy batches flow
through a queue of at most ``prefetch_buffer`` batches. Memory is
O(batch_size x prefetch_buffer) whatever the file's size. The workers
stay in numpy (and PIL where it is installed): torch tensors are made
only on the consumer's thread.

The augmentation is per image (each draws its own crop offset and mirror
coin) from one ``RandomState`` a batch, seeded from the epoch's seed,
which is drawn from the port's host stream (``random.host_rng()``): after
``random.seed(s)`` the order and every draw are the JAX package's. The
augmenters that the pipeline does not apply (rotate, shear, HSL, aspect)
are accepted and warned about once. In device-augment mode the workers
stop at a fixed-size uint8 HWC image (cropped on the host with
``host_crop``), and the iterator finishes it on the card (``io``'s
``ImageRecordIter.device_aug_pure``). An error raised in a worker reaches
the consumer.
"""
import logging
import queue as _queue
import struct
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import random as _random
from ..recordio import MXRecordIO, _kMagic, unpack

__all__ = ['StreamingImageRecordIter']

_UNSUPPORTED_AUG = ('max_rotate_angle', 'max_shear_ratio', 'random_h',
                    'random_s', 'random_l', 'max_aspect_ratio',
                    'random_resized_crop', 'brightness', 'contrast',
                    'saturation', 'pca_noise')


def scan_record_offsets(path):
    """One framing-only pass over a .rec: byte offsets of record STARTS
    (cflag 0 = whole record, 1 = first part of a multi-part record;
    continuation parts 2/3 are skipped). No payload is decoded, so a
    multi-GB file scans at sequential-read speed."""
    offsets = []
    with open(path, 'rb') as f:
        while True:
            pos = f.tell()
            head = f.read(8)
            if len(head) < 8:
                break
            magic, lrec = struct.unpack('<II', head)
            if magic != _kMagic:
                raise IOError('invalid RecordIO magic at offset %d' % pos)
            cflag = lrec >> 29
            length = lrec & 0x1fffffff
            if cflag in (0, 1):
                offsets.append(pos)
            f.seek(length + (4 - length % 4) % 4, 1)
    return offsets


def _decode_hwc(payload):
    """Decode one packed image payload to HWC uint8 (RAW0 or codec)."""
    if payload[:4] == b'RAW0':
        ndim = struct.unpack('<I', payload[4:8])[0]
        shape = tuple(np.frombuffer(payload[8:8 + 4 * ndim],
                                    dtype=np.int32))
        img = np.frombuffer(payload[8 + 4 * ndim:],
                            dtype=np.uint8).reshape(shape)
        if img.ndim == 3 and img.shape[0] in (1, 3) \
                and img.shape[2] not in (1, 3):
            img = img.transpose(1, 2, 0)       # stored CHW
        elif img.ndim == 2:
            img = img[:, :, None]
        return img
    try:
        from PIL import Image
        import io as _io
    except ImportError:
        raise ImportError('JPEG/PNG decode requires pillow; '
                          'use .raw packed records')
    img = np.asarray(Image.open(_io.BytesIO(payload)))
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def _resize_short(img, size):
    """Resize so the SHORT side equals ``size`` (MXNet's default resize
    augmenter)."""
    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    if h < w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    return _resize(img, nh, nw)


def _resize(img, nh, nw):
    from PIL import Image
    squeeze = img.shape[2] == 1
    pil = Image.fromarray(img[:, :, 0] if squeeze else img)
    out = np.asarray(pil.resize((nw, nh), Image.BILINEAR))
    return out[:, :, None] if squeeze else out


class StreamingImageRecordIter:
    """Backend shared by ImageRecordIter: yields (data, label, pad)
    numpy batches from a bounded prefetch queue."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, mean=(0, 0, 0), std=(1, 1, 1), scale=1.0,
                 rand_crop=False, rand_mirror=False, preprocess_threads=4,
                 prefetch_buffer=4, round_batch=True, resize=-1, pad=0,
                 fill_value=127, max_random_scale=1.0, min_random_scale=1.0,
                 num_parts=1, part_index=0, aug_kwargs=None,
                 device_augment=False, host_crop=False):
        self.path = path_imgrec
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self.shuffle = shuffle
        self.scale = scale
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)
        self.rand_crop = bool(int(rand_crop))
        self.rand_mirror = bool(int(rand_mirror))
        self.threads = max(1, int(preprocess_threads))
        self.prefetch = max(1, int(prefetch_buffer))
        self.round_batch = round_batch
        self.resize = int(resize)
        self.pad = int(pad)
        self.fill_value = int(fill_value)
        self.max_random_scale = float(max_random_scale)
        self.min_random_scale = float(min_random_scale)
        for k, v in (aug_kwargs or {}).items():
            if k in _UNSUPPORTED_AUG and v:
                warnings.warn(
                    'ImageRecordIter: augmenter %r is not applied by this '
                    'pipeline (MXNet\'s image_aug_default.cc supports it)'
                    % k, stacklevel=3)
        # device-augment mode: the workers stop at a FIXED-SIZE uint8 HWC
        # image, and the crop, mirror and normalize run on the batch's
        # device (io/__init__.py ImageRecordIter.device_aug_pure): the
        # float conversion and the crop leave the host's decode-bound
        # path, and the upload carries uint8, a quarter of the f32 bytes
        self.device_augment = bool(int(device_augment))
        # host crop: the workers crop (random or centre) to the target
        # H x W BEFORE the handover, so the upload carries H*W/S^2 of the
        # source bytes (23% fewer for 224^2 crops of 256^2 sources): a
        # per-image uint8 slice against a smaller copy. Mirror and
        # normalize stay on the device.
        self.host_crop = bool(int(host_crop)) and self.device_augment
        self._src_hw = None
        if self.device_augment:
            C, H, W = self.data_shape
            if self.resize > 0:
                side = self.resize + 2 * self.pad
                if side < max(H, W):
                    raise ValueError(
                        'device_augment: resize+2*pad (%d) must cover the '
                        'crop %dx%d' % (side, H, W))
                self._src_hw = (side, side)
            if self.max_random_scale != 1.0 or self.min_random_scale != 1.0:
                warnings.warn('device_augment: random scale jitter is not '
                              'applied on-device; ignoring', stacklevel=3)
            if self.resize > 0 and self.rand_crop:
                warnings.warn(
                    'device_augment: random crops sample from the CENTER '
                    'square of the resized image (the host path samples '
                    'the full resize-short rectangle) — the augmentation '
                    'distribution differs on non-square sources',
                    stacklevel=3)
        # fused normalize: chw*scale, -mean, /std as ONE uint8->f32 table
        # a channel, one lookup a pixel in place of three float passes
        lut = (np.arange(256, dtype=np.float32)[None, :] * self.scale
               - self.mean.reshape(-1, 1)) / self.std.reshape(-1, 1)
        self._lut = lut.astype(np.float32)
        offsets = scan_record_offsets(path_imgrec)
        if not offsets:
            raise ValueError('empty record file %s' % path_imgrec)
        # the full offset list is kept: set_shard re-slices it without a
        # re-scan; the slice applies at the next start_epoch
        self._all_offsets = offsets
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        self._offsets = offsets[part_index::num_parts]
        logging.getLogger(__name__).debug(
            'ImageRecordIter: %d records (%d after sharding %d/%d)',
            len(offsets), len(self._offsets), part_index, num_parts)
        self._producer = None
        self._stop = None
        self._q = None

    def set_shard(self, part_index):
        """Move this reader onto shard ``part_index`` of the same
        ``num_parts`` partition. The live producer (if any) keeps its
        epoch; the new slice applies at the next start_epoch."""
        self.part_index = int(part_index) % max(1, self.num_parts)
        self._offsets = self._all_offsets[self.part_index::self.num_parts]

    # -- epoch lifecycle ---------------------------------------------------
    def start_epoch(self):
        self.stop()
        # the epoch's seed is drawn on the caller's thread from the host
        # stream, so random.seed() makes epochs reproducible
        seed = int(_random.host_rng().randint(0, 2 ** 31 - 1))
        order = np.array(self._offsets)
        if self.shuffle:
            np.random.RandomState(seed).shuffle(order)
        self._stop = threading.Event()
        self._q = _queue.Queue(maxsize=self.prefetch)
        self._producer = threading.Thread(
            target=self._produce, args=(order, seed, self._q, self._stop),
            daemon=True)
        self._producer.start()

    def stop(self):
        if self._producer is not None:
            self._stop.set()
            while True:     # unblock a producer waiting on a full queue
                try:
                    self._q.get_nowait()
                except _queue.Empty:
                    break
            self._producer.join(timeout=10)
            self._producer = None

    def next_batch(self):
        """(data, label, pad) or None at epoch end."""
        if self._producer is None:
            self.start_epoch()
        item = self._q.get()
        if item is None:
            self._producer.join(timeout=10)
            self._producer = None
            return None
        if isinstance(item, BaseException):
            self._producer = None
            raise item
        return item

    # -- producer ----------------------------------------------------------
    def _produce(self, order, seed, q, stop):
        try:
            reader = MXRecordIO(self.path, 'r')
            pool = ThreadPoolExecutor(self.threads)
            try:
                B = self.batch_size
                n = len(order)
                if self.device_augment and self._src_hw is None and n:
                    # infer the uniform source size on THIS thread before
                    # the pool fans out (avoids a first-batch write race)
                    reader.seek_pos(int(order[0]))
                    self._decode_fixed(reader.read())
                for start in range(0, n, B):
                    if stop.is_set():
                        return
                    idxs = list(range(start, min(start + B, n)))
                    npad = 0
                    if len(idxs) < B:
                        if not self.round_batch:
                            break
                        npad = B - len(idxs)
                        # wrap cyclically (round_batch): modulo handles
                        # shards smaller than one batch
                        idxs += [i % n for i in range(npad)]
                    raws = []
                    for i in idxs:
                        reader.seek_pos(int(order[i]))
                        raws.append(reader.read())
                    # all augmentation randomness drawn HERE in bulk
                    # (one RandomState per batch, seeded from the epoch
                    # seed) — workers stay rng-free and cheap
                    if self.device_augment and self.host_crop:
                        brng = np.random.RandomState(
                            (seed + start) & 0x7fffffff)
                        draws = brng.uniform(size=(len(idxs), 2))
                        recs = list(pool.map(
                            self._decode_fixed_crop, raws, draws))
                    elif self.device_augment:
                        recs = list(pool.map(self._decode_fixed, raws))
                    else:
                        brng = np.random.RandomState(
                            (seed + start) & 0x7fffffff)
                        draws = brng.uniform(size=(len(idxs), 4))
                        recs = list(pool.map(
                            self._decode_augment, raws, draws))
                    data = np.stack([r[0] for r in recs])
                    label = np.stack([r[1] for r in recs])
                    if self.label_width == 1:
                        label = label.reshape(B)
                    while not stop.is_set():
                        try:
                            q.put((data, label, npad), timeout=0.1)
                            break
                        except _queue.Full:
                            continue
                    else:
                        return
            finally:
                pool.shutdown(wait=False)
                reader.close()
            q.put(None)
        except BaseException as e:  # noqa: BLE001 — surface in consumer
            # the queue may be full for a long time (consumer inside a
            # multi-second device call): make room by discarding a
            # buffered batch and retry, so the error ALWAYS reaches the
            # consumer instead of leaving it blocked on get() forever
            while not stop.is_set():
                try:
                    q.put(e, timeout=0.1)
                    return
                except _queue.Full:
                    try:
                        q.get_nowait()
                    except _queue.Empty:
                        pass

    # -- per-image work (worker threads; numpy and PIL only, no torch) ---
    def _label_of(self, header):
        lab = np.atleast_1d(np.asarray(header.label, np.float32))
        if self.label_width == 1:
            return lab[:1]
        return np.pad(lab[:self.label_width],
                      (0, max(0, self.label_width - lab.size)))

    def _coerce_channels(self, img):
        C = self.data_shape[0]
        if img.shape[2] != C:
            if C == 3 and img.shape[2] == 1:
                img = np.repeat(img, 3, axis=2)
            elif C == 1:
                img = img.mean(axis=2, keepdims=True).astype(img.dtype)
        return img

    def _decode_fixed(self, raw):
        """device_augment worker: decode to a FIXED-SIZE uint8 HWC image
        (resize-short + pad + center-crop-to-square when `resize` is
        set; fixed-size records pass through, padded up to the crop
        size if needed). All randomness and all float math happen on
        device."""
        header, payload = unpack(raw)
        img = self._coerce_channels(_decode_hwc(payload))
        _, H, W = self.data_shape
        if self.resize > 0:
            img = _resize_short(img, self.resize)
            if self.pad > 0:
                img = np.pad(img, ((self.pad, self.pad),
                                   (self.pad, self.pad), (0, 0)),
                             constant_values=self.fill_value)
            S = self._src_hw[0]
            ih, iw = img.shape[:2]
            # place the square so the device's later center crop lands
            # exactly where the host path's single (long-crop)//2 crop
            # would (the naive (long-S)//2 is off by 1 px when both
            # parities are odd)
            y = min(max(0, (ih - H) // 2 - (S - H) // 2), max(0, ih - S))
            x = min(max(0, (iw - W) // 2 - (S - W) // 2), max(0, iw - S))
            img = img[y:y + S, x:x + S]
            if img.shape[0] < S or img.shape[1] < S:
                img = np.pad(img, ((0, S - img.shape[0]),
                                   (0, S - img.shape[1]), (0, 0)),
                             constant_values=self.fill_value)
        else:
            # same semantics as the host path: `pad` always applies,
            # and undersized records are padded up to the crop size
            if self.pad > 0:
                img = np.pad(img, ((self.pad, self.pad),
                                   (self.pad, self.pad), (0, 0)),
                             constant_values=self.fill_value)
            ih, iw = img.shape[:2]
            if ih < H or iw < W:
                img = np.pad(img, ((0, max(0, H - ih)),
                                   (0, max(0, W - iw)), (0, 0)),
                             constant_values=self.fill_value)
            if self._src_hw is None:
                self._src_hw = img.shape[:2]
            if img.shape[:2] != self._src_hw:
                raise ValueError(
                    'device_augment without resize needs uniform record '
                    'sizes: got %s after %s — set resize=<short side>'
                    % (img.shape[:2], self._src_hw))
        return img, self._label_of(header)

    def _decode_fixed_crop(self, raw, draws):
        """host-crop worker: the fixed-size image of _decode_fixed,
        then the crop applied HOST-side with the producer's per-image
        uniforms — (H, W, C) uint8 out. Offsets use the host-augment
        path's exact formulas (center: (S-H)//2; random:
        int(u * (S-H+1))), so randomness-off pixels match the
        device-crop path bit-for-bit."""
        u_y, u_x = draws
        img, lab = self._decode_fixed(raw)
        _, H, W = self.data_shape
        ih, iw = img.shape[:2]
        if self.rand_crop:
            y = int(u_y * (ih - H + 1))
            x = int(u_x * (iw - W + 1))
        else:
            y, x = (ih - H) // 2, (iw - W) // 2
        return img[y:y + H, x:x + W], lab

    def _decode_augment(self, raw, draws):
        """``draws`` = 4 uniforms from the producer's per-batch stream:
        (scale jitter, crop-y, crop-x, mirror coin)."""
        u_scale, u_y, u_x, u_flip = draws
        header, payload = unpack(raw)
        img = _decode_hwc(payload)
        C, H, W = self.data_shape
        if self.resize > 0:
            img = _resize_short(img, self.resize)
        if self.pad > 0:
            img = np.pad(img, ((self.pad, self.pad), (self.pad, self.pad),
                               (0, 0)), constant_values=self.fill_value)
        # random scale jitter: resample the crop SOURCE size, so the
        # crop covers a larger/smaller field of view at fixed output
        if self.max_random_scale > self.min_random_scale:
            s = self.min_random_scale + u_scale * \
                (self.max_random_scale - self.min_random_scale)
        else:
            s = self.max_random_scale
        if s != 1.0:
            img = _resize(img, max(H, int(round(img.shape[0] * s))),
                          max(W, int(round(img.shape[1] * s))))
        ih, iw = img.shape[:2]
        if ih < H or iw < W:
            img = np.pad(img, ((0, max(0, H - ih)), (0, max(0, W - iw)),
                               (0, 0)), constant_values=self.fill_value)
            ih, iw = img.shape[:2]
        if self.rand_crop:           # per-image random crop offset
            y = int(u_y * (ih - H + 1))
            x = int(u_x * (iw - W + 1))
        else:                        # centre crop (MXNet's default)
            y, x = (ih - H) // 2, (iw - W) // 2
        img = img[y:y + H, x:x + W]
        if self.rand_mirror and u_flip < 0.5:       # per-image coin
            img = img[:, ::-1]
        img = self._coerce_channels(img)
        # fused scale/mean/std via the per-channel uint8 LUT
        chw = np.empty((C, H, W), np.float32)
        for c in range(C):
            np.take(self._lut[c], img[:, :, c], out=chw[c])

        return chw, self._label_of(header)
