"""The port's image API (``mxnet_tpu_torch.image``: the helpers, every
augmenter, ``CreateAugmenter``, ``ImageIter``, the detection augmenters,
``ImageDetIter``), its ``ImageDetRecordIter`` and the ``_cv*`` codecs of
``ops/legacy_ops.py`` against the JAX package's, on 16-48 pixel images
made with numpy from a seed.

The augmenters are numpy on the host in both packages and draw from the
framework's host streams (``random.host_pyrng()``, ``random.host_rng()``):
after ``random.seed(s)`` in both, each gives the JAX package's output
exactly, call after call. JPEG and PNG go through Pillow, as here.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import image as jimg
from mxnet_tpu.image import detection as jdet
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch.image import detection as tdet
from mxnet_tpu_torch.recordio import IRHeader, MXRecordIO, pack_img

PKGS = ((mx, jimg, jdet), (mt, timg, tdet))


def _src(h=32, w=48, seed=0):
    return np.random.RandomState(seed).randint(
        0, 255, (h, w, 3)).astype(np.float32)


def _both(fn, seed=3):
    """``fn(image_module, detection_module)`` in each package after
    ``random.seed(seed)``: (JAX's result, the port's)."""
    out = []
    for pkg, img, det in PKGS:
        pkg.random.seed(seed)
        out.append(fn(img, det))
    return out


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


HELPERS = {
    'imresize': lambda m: m.imresize(_src(), 20, 13),
    'imresize_same': lambda m: m.imresize(_src(), 48, 32),
    'resize_short': lambda m: m.resize_short(_src(32, 48), 16),
    'resize_short_tall': lambda m: m.resize_short(_src(40, 24), 12),
    'fixed_crop': lambda m: m.fixed_crop(_src(), 4, 2, 10, 8),
    'fixed_crop_resized': lambda m: m.fixed_crop(_src(), 4, 2, 10, 8, (5, 7)),
    'center_crop': lambda m: m.center_crop(_src(), (20, 16)),
    'random_crop': lambda m: [m.random_crop(_src(), (20, 16))
                              for _ in range(4)],
    'random_size_crop': lambda m: [m.random_size_crop(
        _src(), (20, 16), 0.3, (0.75, 1.333)) for _ in range(4)],
    'color_normalize': lambda m: m.color_normalize(
        _src(), np.array([1., 2., 3.], np.float32),
        np.array([2., 3., 4.], np.float32)),
    'scale_down': lambda m: m.scale_down((30, 20), (40, 30)),
    'border_constant': lambda m: m.copyMakeBorder(_src(8, 6), 1, 2, 3, 0,
                                                  values=5.0),
    'border_types': lambda m: [m.copyMakeBorder(_src(8, 6), 2, 1, 1, 2,
                                                type=t) for t in (1, 2, 3, 4)],
}


@pytest.mark.parametrize('name', sorted(HELPERS))
def test_helpers_match_jax(name):
    want, got = _both(lambda img, det: HELPERS[name](img))
    _eq(got, want)


def test_imdecode_and_imread_match_jax(tmp_path):
    pytest.importorskip('PIL')
    from PIL import Image
    import io
    arr = np.random.RandomState(0).randint(0, 255, (8, 10, 3), np.uint8)
    path = str(tmp_path / 'x.png')
    Image.fromarray(arr).save(path)
    for fmt in ('PNG', 'JPEG'):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt)
        want, got = (m.imdecode(buf.getvalue()) for m in (jimg, timg))
        _eq(got, want)
    np.testing.assert_array_equal(timg.imdecode(open(path, 'rb').read()), arr)
    # a square raw HWC buffer decodes without a codec
    raw = arr[:8, :8].tobytes()
    _eq(timg.imdecode(raw), jimg.imdecode(raw))
    with pytest.raises(ValueError):
        timg.imdecode(b'\x01\x02')
    for kw in ({}, {'flag': 0}, {'to_rgb': False}):
        _eq(timg.imread(path, **kw), jimg.imread(path, **kw))


def _augmenters(img):
    return {
        'resize': img.ResizeAug(20),
        'force_resize': img.ForceResizeAug((9, 7)),
        'random_crop': img.RandomCropAug((20, 16)),
        'random_sized_crop': img.RandomSizedCropAug((20, 16), 0.3,
                                                    (0.75, 1.33)),
        'center_crop': img.CenterCropAug((20, 16)),
        'flip': img.HorizontalFlipAug(0.5),
        'cast': img.CastAug(),
        'normalize': img.ColorNormalizeAug([1., 2., 3.], [2., 3., 4.]),
        'brightness': img.BrightnessJitterAug(0.3),
        'contrast': img.ContrastJitterAug(0.3),
        'saturation': img.SaturationJitterAug(0.3),
        'hue': img.HueJitterAug(0.3),
        'color_jitter': img.ColorJitterAug(0.2, 0.2, 0.2),
        'lighting': img.LightingAug(0.1, img.image.IMAGENET_PCA_EIGVAL,
                                    img.image.IMAGENET_PCA_EIGVEC),
        'gray': img.RandomGrayAug(0.5),
        'random_order': img.RandomOrderAug([img.BrightnessJitterAug(0.2),
                                            img.CenterCropAug((24, 20))]),
    }


@pytest.mark.parametrize('name', sorted(_augmenters(timg)))
def test_augmenters_match_jax(name):
    """Six calls on one image after the same seed: the same draws, the same
    output; and the same dumps()."""
    want, got = _both(lambda img, det: [
        _augmenters(img)[name](_src()) for _ in range(6)])
    _eq(got, want)
    assert _augmenters(timg)[name].dumps() == _augmenters(jimg)[name].dumps()


@pytest.mark.parametrize('kw', [
    dict(resize=40, rand_crop=True, rand_mirror=True, mean=True, std=True,
         brightness=0.1, contrast=0.1, saturation=0.1, hue=0.1,
         pca_noise=0.1, rand_gray=0.2),
    dict(rand_crop=True, rand_resize=True, mean=[1., 2., 3.]),
    dict()], ids=['full', 'rand_resize', 'default'])
def test_create_augmenter_matches_jax(kw):
    def run(img, det):
        augs = img.CreateAugmenter((3, 16, 16), **kw)
        outs = []
        for s in range(3):
            x = _src(seed=s)
            for a in augs:
                x = a(x)
            outs.append(x)
        return [type(a).__name__ for a in augs], outs
    want, got = _both(run)
    _eq(got, want)


def _png_records(tmp_path, n=10):
    pytest.importorskip('PIL')
    from PIL import Image
    rng = np.random.RandomState(5)
    rec_path = str(tmp_path / 'i.rec')
    rec = MXRecordIO(rec_path, 'w')
    lines = []
    for i in range(n):
        arr = rng.randint(0, 255, (20, 24, 3)).astype(np.uint8)
        rec.write(pack_img(IRHeader(0, float(i % 3), i, 0), arr,
                           img_fmt='.png'))
        name = 'im%d.png' % i
        Image.fromarray(arr).save(str(tmp_path / name))
        lines.append('%d\t%d\t%s' % (i, i % 3, name))
    rec.close()
    lst = str(tmp_path / 'i.lst')
    with open(lst, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return rec_path, lst


@pytest.mark.parametrize('source', ['rec', 'imglist'])
def test_image_iter_matches_jax(tmp_path, source):
    rec, lst = _png_records(tmp_path)
    kw = dict(path_imgrec=rec) if source == 'rec' else \
        dict(path_imglist=lst, path_root=str(tmp_path))

    def run(img, det):
        it = img.ImageIter(4, (3, 16, 16), shuffle=True, rand_crop=True,
                           rand_mirror=True, mean=True, **kw)
        out = []
        for _ in range(2):
            for b in it:
                assert b.data[0].context.device_type == 'cpu'
                out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
            it.reset()
        return out, [tuple(d) for d in it.provide_data]
    want, got = _both(run)
    _eq(got, want)


def _label():
    return np.array([[0, 0.2, 0.2, 0.4, 0.4],
                     [1, 0.5, 0.5, 0.9, 0.8],
                     [-1, -1, -1, -1, -1]], np.float32)


def _det_augmenters(img, det):
    return {
        'borrow': det.DetBorrowAug(img.BrightnessJitterAug(0.5)),
        'flip': det.DetHorizontalFlipAug(0.5),
        'crop': det.DetRandomCropAug(min_scale=0.5),
        'pad': det.DetRandomPadAug(area_range=(1.2, 2.0)),
        'border': det.DetBorderAug(fill=7),
        'select': det.DetRandomSelectAug([det.DetHorizontalFlipAug(1.0),
                                          det.DetBorderAug()], skip_prob=0.3),
        'multi_rand_crop': det.CreateMultiRandCropAugmenter(
            area_range=[(0.1, 1.0), (0.5, 1.0)], max_attempts=[10, 20],
            skip_prob=0.2),
    }


@pytest.mark.parametrize('name', sorted(_det_augmenters(timg, tdet)))
def test_detection_augmenters_match_jax(name):
    want, got = _both(lambda img, det: [
        _det_augmenters(img, det)[name](_src(), _label()) for _ in range(6)])
    _eq(got, want)


def test_create_det_augmenter_and_image_det_iter_match_jax():
    rng = np.random.RandomState(0)
    images = rng.rand(8, 16, 16, 3).astype(np.float32)
    labels = np.tile(_label(), (8, 1, 1))

    def run(img, det):
        augs = det.CreateDetAugmenter((3, 32, 32), rand_crop=0.5,
                                      rand_pad=0.5, rand_mirror=True,
                                      brightness=0.1, hue=0.1, rand_gray=0.05,
                                      pca_noise=0.05)
        src, lab = _src(), _label()
        for a in augs:
            src, lab = a(src, lab)
        it = det.ImageDetIter(4, (3, 16, 16), images, labels,
                              rand_mirror=True, shuffle=True)
        batches = []
        for _ in range(2):
            for b in it:
                batches.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
            it.reset()
        return (src, lab), batches, [tuple(d) for d in it.provide_label]
    want, got = _both(run)
    _eq(got, want)


def _det_records(path, n=6):
    """Records with packed detection labels [2, 5, objects...] (a varying
    number of objects) of 3 x 8 x 8 '.raw' images."""
    rng = np.random.RandomState(2)
    rec = MXRecordIO(path, 'w')
    for i in range(n):
        objs = [[i % 3, 0.1, 0.2, 0.5, 0.6]] * (1 + i % 3)
        lab = [2.0, 5.0] + [v for o in objs for v in o]
        img = rng.randint(0, 255, (3, 8, 8)).astype(np.uint8)
        rec.write(pack_img(IRHeader(0, lab, i, 0), img, img_fmt='.raw'))
    rec.close()


@pytest.mark.parametrize('kw', [dict(rand_mirror=True, shuffle=True),
                                dict(label_pad_width=30, mean_r=3, std_g=2)],
                         ids=['mirror', 'pad_width'])
def test_image_det_record_iter_matches_jax(tmp_path, kw):
    p = str(tmp_path / 'd.rec')
    _det_records(p)

    def run(img, det):
        pkg = mx if img is jimg else mt
        it = pkg.io.ImageDetRecordIter(p, (3, 8, 8), 4, **kw)
        out = []
        for _ in range(2):
            for b in it:
                out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
            it.reset()
        return out, it.label_object_width, it.max_objects
    want, got = _both(run)
    _eq(got, want)


def test_cv_codecs_match_jax(tmp_path):
    pytest.importorskip('PIL')
    from PIL import Image
    import io
    arr = np.random.RandomState(0).randint(0, 255, (8, 10, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    raw = np.frombuffer(buf.getvalue(), np.uint8)
    path = str(tmp_path / 'x.png')
    Image.fromarray(arr).save(path)
    cases = [
        ('_cvimdecode', lambda nd, c: nd._cvimdecode(
            nd.array(raw, dtype='uint8', **c))),
        ('_cvimread', lambda nd, c: nd._cvimread(filename=path, **c)),
        ('_cvimresize u8', lambda nd, c: nd._cvimresize(
            nd.array(arr, dtype='uint8', **c), w=5, h=7)),
        ('_cvimresize f32', lambda nd, c: nd._cvimresize(
            nd.array(arr.astype(np.float32), **c), w=13, h=4)),
        ('_cvcopyMakeBorder', lambda nd, c: nd._cvcopyMakeBorder(
            nd.array(arr, dtype='uint8', **c), top=1, bot=2, left=0,
            right=3, value=9.0)),
    ]
    for name, fn in cases:
        want = fn(mx.nd, {}).asnumpy()
        got = fn(mt.nd, {'ctx': mt.cpu()})
        assert got.context == mt.cpu(), name
        got = got.asnumpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
