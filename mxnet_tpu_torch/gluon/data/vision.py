"""Gluon's vision datasets: the counterpart of
``mxnet_tpu/gluon/data/vision.py`` (``MNIST``, ``FashionMNIST``,
``CIFAR10``, ``ImageFolderDataset``, ``ImageRecordDataset``).

They read the standard files under ``root`` when they are there, and
local files only: without them, the JAX package's synthetic sets
(``io.synthetic_mnist`` for MNIST, ``RandomState(99)`` prototypes and
``RandomState(0|1)`` draws for CIFAR-10), so both packages give identical
arrays. Each sample is a CPU NDArray.
"""
import os
import gzip
import struct

import numpy as np

import torch

from ...context import cpu
from ...io import synthetic_mnist
from ...ndarray import NDArray
from .dataset import Dataset, RecordFileDataset

__all__ = ['MNIST', 'FashionMNIST', 'CIFAR10', 'ImageFolderDataset',
           'ImageRecordDataset']


def _samples(data):
    """An (N, ...) uint8 array as N CPU NDArrays (views of one tensor)."""
    return [NDArray(t, cpu()) for t in torch.tensor(data).unbind(0)]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError()


class MNIST(_DownloadedDataset):
    """MNIST's gzipped idx files: (28, 28, 1) uint8 images, int32
    labels; 6,000 (train) or 1,000 synthetic images without them."""

    _base = 'train'

    def _get_data(self):
        if self._train:
            data_file = os.path.join(self._root, 'train-images-idx3-ubyte.gz')
            label_file = os.path.join(self._root, 'train-labels-idx1-ubyte.gz')
        else:
            data_file = os.path.join(self._root, 't10k-images-idx3-ubyte.gz')
            label_file = os.path.join(self._root, 't10k-labels-idx1-ubyte.gz')
        if os.path.exists(data_file) and os.path.exists(label_file):
            with gzip.open(label_file, 'rb') as fin:
                struct.unpack('>II', fin.read(8))
                label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
            with gzip.open(data_file, 'rb') as fin:
                struct.unpack('>IIII', fin.read(16))
                data = np.frombuffer(fin.read(), dtype=np.uint8)
                data = data.reshape(len(label), 28, 28, 1)
        else:
            imgs, labels = synthetic_mnist(6000 if self._train else 1000,
                                           seed=0 if self._train else 1)
            data = (imgs * 255).astype(np.uint8).reshape(-1, 28, 28, 1)
            label = labels.astype(np.int32)
        self._data = _samples(data)
        self._label = label

    def __init__(self, root='~/.mxnet/datasets/mnist', train=True,
                 transform=None):
        super().__init__(root, train, transform)


class FashionMNIST(MNIST):
    """Fashion-MNIST, in MNIST's files and layout."""

    def __init__(self, root='~/.mxnet/datasets/fashion-mnist', train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10's binary batches: (32, 32, 3) uint8 images, int32 labels;
    5,000 (train) or 1,000 synthetic images without them."""

    def __init__(self, root='~/.mxnet/datasets/cifar10', train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, 'rb') as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(-1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        if self._train:
            files = [os.path.join(self._root, 'data_batch_%d.bin' % i)
                     for i in range(1, 6)]
        else:
            files = [os.path.join(self._root, 'test_batch.bin')]
        if all(os.path.exists(f) for f in files):
            data, label = zip(*(self._read_batch(f) for f in files))
            data = np.concatenate(data)
            label = np.concatenate(label)
        else:
            protos = np.random.RandomState(99).rand(10, 32, 32, 3).astype(np.float32)
            rng = np.random.RandomState(0 if self._train else 1)
            n = 5000 if self._train else 1000
            label = rng.randint(0, 10, n).astype(np.int32)
            data = np.clip(protos[label] + 0.25 * rng.randn(n, 32, 32, 3), 0, 1)
            data = (data * 255).astype(np.uint8)
        self._data = _samples(data)
        self._label = label


class ImageFolderDataset(Dataset):
    """Images stored as ``root/<class>/<file>.jpg``: the class names come
    from the sorted folder names.

    ``transform`` receives ``(data, label)`` and returns the same pair.
    """

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = ['.jpg', '.jpeg', '.png']
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                ext = os.path.splitext(filename)[1].lower()
                if ext not in self._exts:
                    continue
                self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ... import image
        img = image.imread(self.items[idx][0], flag=self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageRecordDataset(RecordFileDataset):
    """Images packed in a RecordIO file: each record an image-record
    header and an encoded image, as im2rec writes them."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ... import image, recordio
        record = super().__getitem__(idx)
        header, img_bytes = recordio.unpack(record)
        img = image.imdecode(img_bytes, flag=self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
