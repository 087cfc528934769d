"""The image pipeline: the counterpart of ``mxnet_tpu/image/image.py``
(``imdecode``, ``imread``, ``imresize``, ``copyMakeBorder``, the crop and
normalise helpers, every ``Augmenter``, ``CreateAugmenter`` and
``ImageIter``).

Decode and resize run in numpy (bilinear; PIL for JPEG and PNG where it
is installed), the augmenters compose as in MXNet's image.py, and batches
come out as CPU NDArrays in NCHW, as the port's iterators give. Images
are HWC f32 through the augmenters, transposed to CHW at batching. The
random augmenters draw from the port's host streams
(``random.host_pyrng()``, ``random.host_rng()``), so ``random.seed(s)``
gives the JAX package's draws.
"""
import os

import numpy as np

from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc
from .. import random as _random
from ..ndarray.ndarray import array as _nd_array
from .. import recordio

# the framework's stdlib-style stream: random.seed() seeds it, and the
# user's global `random` state is untouched
random = _random.host_pyrng()


def nd_array(a):
    """A numpy batch as a CPU NDArray."""
    return _nd_array(a, ctx=cpu())

__all__ = ['ImageIter', 'Augmenter', 'CreateAugmenter']


def imdecode(buf, to_rgb=True, flag=1):
    """Decode an image buffer to HWC f32. JPEG and PNG need pillow; a
    square raw uint8 HWC buffer decodes without it."""
    try:
        from PIL import Image
        import io as _io
        img = np.asarray(Image.open(_io.BytesIO(buf)).convert('RGB'))
        return img.astype(np.float32)
    except Exception:
        arr = np.frombuffer(buf, dtype=np.uint8)
        side = int(round((arr.size // 3) ** 0.5))
        if side * side * 3 == arr.size:
            return arr.reshape(side, side, 3).astype(np.float32)
        raise ValueError('cannot decode image buffer (pillow unavailable '
                         'and not a square raw buffer)')


def imresize(src, w, h, interp=1):
    """Bilinear resize of an HWC numpy image to ``w`` x ``h`` (f32)."""
    sh, sw = src.shape[:2]
    if (sh, sw) == (h, w):
        return src
    ys = (np.arange(h) + 0.5) * sh / h - 0.5
    xs = (np.arange(w) + 0.5) * sw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, sh - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, sw - 1)
    y1 = np.clip(y0 + 1, 0, sh - 1)
    x1 = np.clip(x0 + 1, 0, sw - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    img = src.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def copyMakeBorder(src, top, bot, left, right, type=0, values=0.0):  # noqa: A002
    """Pad an HWC image with a border (MXNet's _cvcopyMakeBorder op, with
    its keyword names).
    ``type`` follows the cv2 codes: 0 constant, 1 replicate edge,
    2 reflect (edge pixel doubled), 3 wrap, 4 reflect_101 (edge pixel
    not doubled)."""
    pad = ((top, bot), (left, right)) + ((0, 0),) * (src.ndim - 2)
    modes = {1: 'edge', 2: 'symmetric', 3: 'wrap', 4: 'reflect'}
    if type == 0:
        return np.pad(src, pad, mode='constant', constant_values=values)
    if type not in modes:
        raise ValueError('unsupported border type %r' % (type,))
    return np.pad(src, pad, mode=modes[type])


def resize_short(src, size, interp=1):
    """Resize so that the shorter side equals ``size``."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=1):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = random.randint(0, max(0, w - new_w))
    y0 = random.randint(0, max(0, h - new_h))
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=1):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src - mean
    if std is not None:
        src = src / std
    return src


def imread(filename, to_rgb=True, flag=1):
    """Read an image file to an HWC uint8 array (PIL in place of MXNet's
    cv2.imread; ``to_rgb=False`` gives cv2's BGR order)."""
    from PIL import Image
    img = Image.open(filename)
    img = img.convert('RGB' if flag else 'L')
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if flag and not to_rgb:
        arr = arr[:, :, ::-1]  # BGR, cv2's default in MXNet
    return arr


def random_size_crop(src, size, min_area, ratio, interp=2):
    """A random area and aspect-ratio crop; the centre crop after 10
    failed draws."""
    h, w = src.shape[0], src.shape[1]
    area = h * w
    for _ in range(10):
        target_area = random.uniform(min_area, 1.0) * area
        new_ratio = random.uniform(*ratio)
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if random.random() < 0.5:
            new_h, new_w = new_w, new_h
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def scale_down(src_size, size):
    """Scale size down to fit within src_size keeping the ratio."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = w * sh // h, sh
    if sw < w:
        w, h = sw, h * sw // w
    return w, h


class Augmenter:
    """An image augmenter: ``__call__(src) -> src``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            return src[:, ::-1]
        return src


class CastAug(Augmenter):
    def __call__(self, src):
        return src.astype(np.float32)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        gray = (src * self.coef).sum() * 3.0 / src.size
        return src * alpha + gray * (1.0 - alpha)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        gray = (src * self.coef).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


class HueJitterAug(Augmenter):
    """Rotate the hue in YIQ space."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], np.float32)

    def __call__(self, src):
        alpha = random.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]], np.float32)
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        return np.asarray(src, np.float32) @ t


# ImageNet's RGB PCA decomposition (AlexNet's lighting noise)
IMAGENET_PCA_EIGVAL = np.array([55.46, 4.794, 1.148])
IMAGENET_PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                                [-0.5808, -0.0045, -0.8140],
                                [-0.5836, -0.6948, 0.4203]])


class LightingAug(Augmenter):
    """AlexNet's PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = _random.host_rng().normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return np.asarray(src, np.float32) + rgb


class RandomGrayAug(Augmenter):
    """Convert to 3-channel gray with probability ``p``."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = np.array([[0.21, 0.21, 0.21],
                             [0.72, 0.72, 0.72],
                             [0.07, 0.07, 0.07]], np.float32)

    def __call__(self, src):
        if random.random() < self.p:
            src = np.asarray(src, np.float32) @ self.mat
        return src


class RandomSizedCropAug(Augmenter):
    """A random area and aspect-ratio crop (:func:`random_size_crop`)."""

    def __init__(self, size, min_area, ratio, interp=2):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp)
        self.size = size
        self.min_area = min_area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.min_area, self.ratio,
                                self.interp)[0]


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean if self.mean is not None else 0,
                               self.std)


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        random.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ColorJitterAug(RandomOrderAug):
    """Brightness, contrast and saturation jitter in a random order."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmenter list of MXNet's CreateAugmenter."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3.0 / 4.0,
                                                            4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    jitters = []
    if brightness:
        jitters.append(BrightnessJitterAug(brightness))
    if contrast:
        jitters.append(ContrastJitterAug(contrast))
    if saturation:
        jitters.append(SaturationJitterAug(saturation))
    if jitters:
        auglist.append(RandomOrderAug(jitters))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, IMAGENET_PCA_EIGVAL,
                                   IMAGENET_PCA_EIGVEC))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], np.float32)
    if std is True:
        std = np.array([58.395, 57.12, 57.375], np.float32)
    if mean is not None and np.any(np.asarray(mean) > 0):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """An image iterator over a .rec or an image list, through the
    augmenter list (``CreateAugmenter(data_shape, **kwargs)`` by default).

    >>> it = ImageIter(32, (3, 224, 224), path_imgrec='train.rec',
    ...                rand_crop=True, rand_mirror=True)
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root='',
                 shuffle=False, aug_list=None, imglist=None,
                 data_name='data', label_name='softmax_label', **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or imglist is not None, \
            'one of path_imgrec / path_imglist / imglist is required'
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self._records = []  # (label, raw-buffer or path)

        if path_imgrec:
            rec = recordio.MXRecordIO(path_imgrec, 'r')
            while True:
                item = rec.read()
                if item is None:
                    break
                header, buf = recordio.unpack(item)
                self._records.append((np.float32(header.label), buf))
            rec.close()
        else:
            entries = imglist
            if path_imglist:
                entries = []
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split('\t')
                        entries.append([float(x) for x in parts[1:-1]] +
                                       [parts[-1]])
            for e in entries:
                label, fname = (np.float32(e[0]) if len(e) == 2
                                else np.asarray(e[:-1], np.float32)), e[-1]
                self._records.append((label, os.path.join(path_root, fname)))

        if aug_list is None:
            aug_list = CreateAugmenter(data_shape, **kwargs)
        self.auglist = aug_list
        self.data_name = data_name
        self.label_name = label_name
        self._order = list(range(len(self._records)))
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, (self.batch_size,))]

    def reset(self):
        if self.shuffle:
            random.shuffle(self._order)
        self._cursor = 0

    def _load(self, rec):
        label, src = rec
        if isinstance(src, bytes):
            img = imdecode(src)
        else:
            img = imdecode(open(src, 'rb').read())
        return label, img

    def next(self):
        if self._cursor + self.batch_size > len(self._records):
            raise StopIteration
        data = np.empty((self.batch_size,) + self.data_shape, np.float32)
        label = np.empty((self.batch_size,), np.float32)
        for i in range(self.batch_size):
            lab, img = self._load(
                self._records[self._order[self._cursor + i]])
            for aug in self.auglist:
                img = aug(img)
            c, h, w = self.data_shape
            if img.shape[:2] != (h, w):
                img = imresize(img, w, h)
            data[i] = img.transpose(2, 0, 1)[:c]
            label[i] = np.float32(lab) if np.ndim(lab) == 0 else lab[0]
        self._cursor += self.batch_size
        return DataBatch(data=[nd_array(data)], label=[nd_array(label)],
                         pad=0, index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
