"""The image API: the counterpart of ``mxnet_tpu/image/``
(:mod:`.image` and :mod:`.detection`)."""
from .image import (Augmenter, ResizeAug, ForceResizeAug, RandomCropAug,
                    RandomSizedCropAug, CenterCropAug, HorizontalFlipAug,
                    CastAug, ColorNormalizeAug, BrightnessJitterAug,
                    ContrastJitterAug, SaturationJitterAug, HueJitterAug,
                    ColorJitterAug, LightingAug, RandomGrayAug,
                    RandomOrderAug, CreateAugmenter, ImageIter, imread,
                    imresize, imdecode, resize_short, fixed_crop,
                    random_crop, random_size_crop, center_crop,
                    color_normalize, scale_down, copyMakeBorder)
from . import detection  # noqa: F401
from .detection import (DetAugmenter, DetBorrowAug, DetRandomSelectAug,
                        DetHorizontalFlipAug, DetRandomCropAug,
                        DetRandomPadAug, CreateDetAugmenter, ImageDetIter)

__all__ = ['Augmenter', 'ResizeAug', 'ForceResizeAug', 'RandomCropAug',
           'RandomSizedCropAug', 'CenterCropAug', 'HorizontalFlipAug',
           'CastAug', 'ColorNormalizeAug', 'BrightnessJitterAug',
           'ContrastJitterAug', 'SaturationJitterAug', 'HueJitterAug',
           'ColorJitterAug', 'LightingAug', 'RandomGrayAug',
           'RandomOrderAug', 'CreateAugmenter', 'ImageIter', 'imread',
           'imresize', 'imdecode', 'resize_short', 'fixed_crop',
           'random_crop', 'random_size_crop', 'center_crop',
           'color_normalize', 'scale_down', 'copyMakeBorder',
           'detection', 'DetAugmenter',
           'DetBorrowAug', 'DetRandomSelectAug', 'DetHorizontalFlipAug',
           'DetRandomCropAug', 'DetRandomPadAug', 'CreateDetAugmenter',
           'ImageDetIter']
