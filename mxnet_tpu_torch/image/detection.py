"""The detection augmenters and iterator: the counterpart of
``mxnet_tpu/image/detection.py`` (the ``Det*Aug`` augmenters,
``CreateDetAugmenter``, ``ImageDetIter``, ``CreateMultiRandCropAugmenter``).

Labels are [N, 5]: (cls, xmin, ymin, xmax, ymax) normalised to [0, 1],
with -1 rows as padding (MultiBoxTarget's convention). The random
augmenters draw from ``random.host_pyrng()``."""
import numpy as np

from .. import random as _random

from ..io import DataIter, DataBatch, DataDesc
from .image import imresize, ImageIter, nd_array

# the framework's stdlib-style stream: random.seed() seeds it
random = _random.host_pyrng()

__all__ = ['DetAugmenter', 'DetBorrowAug', 'DetRandomSelectAug',
           'DetHorizontalFlipAug', 'DetRandomCropAug', 'DetRandomPadAug',
           'DetBorderAug', 'CreateDetAugmenter', 'ImageDetIter',
           'CreateMultiRandCropAugmenter']


class DetAugmenter:
    """Detection augmenter: __call__(src, label) -> (src, label)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """A plain (image-only) Augmenter in a detection pipeline: colour
    jitters and the like move no box."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Apply one of the augmenters at random, or none with
    ``skip_prob``."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if random.random() < self.skip_prob or not self.aug_list:
            return src, label
        return random.choice(self.aug_list)(src, label)


class DetRandomPadAug(DetAugmenter):
    """A random expansion pad: the image inside a larger canvas of
    ``pad_val``, with its boxes rescaled."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            ratio = random.uniform(*self.aspect_ratio_range)
            area = random.uniform(*self.area_range)
            if area < 1.0:
                continue
            nh = int(round(np.sqrt(area * h * w / ratio)))
            nw = int(round(nh * ratio))
            if nh < h or nw < w:
                continue
            y0 = random.randint(0, nh - h)
            x0 = random.randint(0, nw - w)
            canvas = np.empty((nh, nw, src.shape[2]), src.dtype)
            canvas[:] = np.asarray(self.pad_val, src.dtype)[:src.shape[2]]
            canvas[y0:y0 + h, x0:x0 + w] = src
            out = label.copy()
            valid = out[:, 0] >= 0
            out[valid, 1] = (out[valid, 1] * w + x0) / nw
            out[valid, 3] = (out[valid, 3] * w + x0) / nw
            out[valid, 2] = (out[valid, 2] * h + y0) / nh
            out[valid, 4] = (out[valid, 4] * h + y0) / nh
            return canvas, out
        return src, label


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            src = src[:, ::-1]
            valid = label[:, 0] >= 0
            x0 = label[:, 1].copy()
            label[:, 1] = np.where(valid, 1.0 - label[:, 3], label[:, 1])
            label[:, 3] = np.where(valid, 1.0 - x0, label[:, 3])
        return src, label


class DetRandomCropAug(DetAugmenter):
    """A random crop that keeps the boxes whose centre lies inside it."""

    def __init__(self, min_scale=0.5, max_trials=10):
        self.min_scale = min_scale
        self.max_trials = max_trials

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_trials):
            s = random.uniform(self.min_scale, 1.0)
            cw, ch = int(w * s), int(h * s)
            x0 = random.randint(0, w - cw)
            y0 = random.randint(0, h - ch)
            nx0, ny0 = x0 / w, y0 / h
            valid = label[:, 0] >= 0
            cx = (label[:, 1] + label[:, 3]) / 2
            cy = (label[:, 2] + label[:, 4]) / 2
            keep = valid & (cx > nx0) & (cx < nx0 + s) & \
                (cy > ny0) & (cy < ny0 + s)
            if not keep.any():
                continue
            out = label.copy()
            out[~keep] = -1
            for col, off, scale in ((1, nx0, s), (3, nx0, s),
                                    (2, ny0, s), (4, ny0, s)):
                out[keep, col] = np.clip((out[keep, col] - off) / scale, 0, 1)
            return src[y0:y0 + ch, x0:x0 + cw], out
        return src, label


class DetBorderAug(DetAugmenter):
    """Pad to square with value fill, rescaling boxes."""

    def __init__(self, fill=127):
        self.fill = fill

    def __call__(self, src, label):
        h, w = src.shape[:2]
        side = max(h, w)
        out = np.full((side, side, src.shape[2]), self.fill, src.dtype)
        out[:h, :w] = src
        valid = label[:, 0] >= 0
        label[valid, 1] *= w / side
        label[valid, 3] *= w / side
        label[valid, 2] *= h / side
        label[valid, 4] *= h / side
        return out, label


def CreateDetAugmenter(data_shape, rand_crop=0, rand_mirror=False,
                       rand_pad=0, rand_gray=0, brightness=0, contrast=0,
                       saturation=0, hue=0, pca_noise=0, **kwargs):
    """MXNet's CreateDetAugmenter: the colour augmenters borrowed from
    the classification set, the geometric ones box-aware; ``rand_crop``
    and ``rand_pad`` are probabilities."""
    from .image import (BrightnessJitterAug, ContrastJitterAug,
                        SaturationJitterAug, HueJitterAug, LightingAug,
                        RandomGrayAug, IMAGENET_PCA_EIGVAL,
                        IMAGENET_PCA_EIGVEC)
    augs = []
    jitters = []
    if brightness:
        jitters.append(BrightnessJitterAug(brightness))
    if contrast:
        jitters.append(ContrastJitterAug(contrast))
    if saturation:
        jitters.append(SaturationJitterAug(saturation))
    if hue:
        jitters.append(HueJitterAug(hue))
    for j in jitters:
        augs.append(DetBorrowAug(j))
    if pca_noise > 0:
        augs.append(DetBorrowAug(LightingAug(
            pca_noise, IMAGENET_PCA_EIGVAL, IMAGENET_PCA_EIGVEC)))
    if rand_gray > 0:
        augs.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if rand_pad > 0:
        augs.append(DetRandomSelectAug([DetRandomPadAug()],
                                       skip_prob=1 - rand_pad))
    if rand_crop > 0:
        augs.append(DetRandomSelectAug([DetRandomCropAug()],
                                       skip_prob=1 - rand_crop))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5))
    return augs


class ImageDetIter(ImageIter):
    """A detection iterator over in-memory images ([N, H, W, C]) and
    labels ([N, max_objs, 5]): batches of (data, [B, max_objs, 5])."""

    def __init__(self, batch_size, data_shape, images, labels,
                 aug_list=None, data_name='data', label_name='label',
                 shuffle=False, **kwargs):
        # images: [N, H, W, C] float; labels: [N, max_objs, 5]
        self._images = images
        self._labels = labels
        DataIter.__init__(self, batch_size)
        self.data_shape = tuple(data_shape)
        self.shuffle = shuffle
        self.data_name = data_name
        self.label_name = label_name
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **kwargs)
        self._order = list(range(len(images)))
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size,) + self._labels.shape[1:])]

    def reset(self):
        if self.shuffle:
            random.shuffle(self._order)
        self._cursor = 0

    def next(self):
        if self._cursor + self.batch_size > len(self._order):
            raise StopIteration
        c, h, w = self.data_shape
        data = np.empty((self.batch_size, c, h, w), np.float32)
        label = np.empty((self.batch_size,) + self._labels.shape[1:],
                         np.float32)
        for i in range(self.batch_size):
            j = self._order[self._cursor + i]
            img = np.asarray(self._images[j], np.float32)
            lab = np.array(self._labels[j], np.float32)
            for aug in self.auglist:
                img, lab = aug(img, lab)
            if img.shape[:2] != (h, w):
                img = imresize(img, w, h)
            data[i] = img.transpose(2, 0, 1)[:c]
            label[i] = lab
        self._cursor += self.batch_size
        return DataBatch(data=[nd_array(data)], label=[nd_array(label)],
                         pad=0, index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """Several random-crop augmenters, one chosen a sample. List-valued
    parameters align pairwise and scalars broadcast. Each entry is a
    DetRandomCropAug (area_range -> the crop's scale, max_attempts -> its
    trials); the coverage thresholds are the centre-in-crop rule's."""
    def listify(p):
        return p if isinstance(p, list) else [p]

    params = [listify(min_object_covered), listify(aspect_ratio_range),
              listify(area_range), listify(min_eject_coverage),
              listify(max_attempts)]
    num = max(len(p) for p in params)
    for i, p in enumerate(params):
        if len(p) != num:
            assert len(p) == 1, 'parameter lists must align or be scalar'
            params[i] = p * num
    augs = []
    for _, _, area, _, attempts in zip(*params):
        lo = float(area[0]) if isinstance(area, (tuple, list)) else 0.05
        augs.append(DetRandomCropAug(min_scale=max(lo, 0.05) ** 0.5,
                                     max_trials=int(attempts)))
    return DetRandomSelectAug(augs, skip_prob=skip_prob)
