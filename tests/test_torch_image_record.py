"""The port's ImageRecordIter (``mxnet_tpu_torch.io``, the streaming
pipeline of ``mxnet_tpu_torch.io.image_record``) against the JAX
package's, on record files of 6-21 pixel images made with numpy from a
seed.

- The host path gives the JAX package's batches exactly after
  ``random.seed(s)`` in both packages (one per-batch ``RandomState`` drawn
  from the host stream): shuffle, per-image crop and mirror, pad and
  fill, round_batch and its discard, num_parts shards, resize and scale
  jitter (Pillow), multi-label headers, grayscale targets and JPEG records,
  over two epochs, and after a reset mid-epoch. The worker count changes
  nothing, and a worker's error reaches the consumer.
- The device augment, with the randomness off, gives the host path's
  values bit for bit (the same f32 operations) and the JAX device
  augment's; with it on (Philox against threefry) it is held by
  distribution: each crop offset in its range, both ends reached, a mirror
  share of 0.5 +- 0.15 over 400 images, and the same batches from the same
  seed. It runs on the current context's device: off the CPU without a
  card it raises.
- The fused fit window's deferred augment trains bit for bit as the
  per-batch loop on the eager augment (both crop modes, two epochs with
  tail batches), keys its window by ``device_aug_signature()`` and gives
  the iterator back switched off.
"""
import os
import struct

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.io.image_record import scan_record_offsets as jscan
from mxnet_tpu_torch.config import flags
from mxnet_tpu_torch.io.image_record import scan_record_offsets as tscan
from mxnet_tpu_torch.recordio import IRHeader, MXRecordIO, pack_img


def _write_rec(path, n, hw=12, seed=0, encode='.raw', labeler=None,
               multi=0):
    """``n`` random uint8 images (``hw`` an int for a square, else (h, w))
    packed with the port's writer; label i % 7 (or ``labeler(i)``), or
    ``multi`` labels a record."""
    h, w = (hw, hw) if np.isscalar(hw) else hw
    rng = np.random.RandomState(seed)
    rec = MXRecordIO(path, 'w')
    imgs = []
    for i in range(n):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        imgs.append(img)
        lab = float(labeler(i) if labeler else i % 7)
        if multi:
            lab = [lab + k for k in range(multi)]
        rec.write(pack_img(IRHeader(0, lab, i, 0), img, img_fmt=encode))
    rec.close()
    return imgs


def _drain(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        assert gd.dtype == wd.dtype and gd.shape == wd.shape
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_offset_scan_matches_jax(tmp_path):
    """Record starts only: a multi-part record (the magic word inside its
    payload) counts once."""
    p = str(tmp_path / 'a.rec')
    rng = np.random.RandomState(0)
    rec = MXRecordIO(p, 'w')
    for i in range(17):
        img = (rng.rand(6, 6, 3) * 255).astype(np.uint8)
        rec.write(pack_img(IRHeader(0, 1.0, i, 0), img, img_fmt='.raw'))
        if i == 5:
            rec.write(struct.pack('<I', 0xced7230a) * 3 + b'xy')
    rec.close()
    assert tscan(p) == jscan(p)
    assert len(tscan(p)) == 18


HOST_CASES = {
    'plain': dict(n=8, hw=6, kw=dict(data_shape=(3, 6, 6), batch_size=4,
                                     scale=1.0 / 255)),
    'augment': dict(n=20, hw=12, kw=dict(
        data_shape=(3, 8, 8), batch_size=5, shuffle=True, rand_crop=1,
        rand_mirror=1, pad=1, fill_value=9, mean_r=11, mean_g=17, mean_b=23,
        std_r=2, std_g=3, std_b=4, scale=0.7)),
    'round_batch': dict(n=10, hw=6, kw=dict(data_shape=(3, 6, 6),
                                            batch_size=4, shuffle=True)),
    'discard': dict(n=10, hw=6, kw=dict(data_shape=(3, 6, 6), batch_size=4,
                                        round_batch=False)),
    'shard': dict(n=13, hw=6, kw=dict(data_shape=(3, 6, 6), batch_size=2,
                                      num_parts=3, part_index=1,
                                      shuffle=True)),
    'undersized': dict(n=6, hw=5, kw=dict(data_shape=(3, 7, 7),
                                          batch_size=3, rand_crop=1)),
    'resize': dict(n=8, hw=(12, 16), pil=True, kw=dict(
        data_shape=(3, 8, 8), batch_size=4, resize=10, rand_crop=1,
        rand_mirror=1, shuffle=True)),
    'scale_jitter': dict(n=8, hw=10, pil=True, kw=dict(
        data_shape=(3, 8, 8), batch_size=4, max_random_scale=1.5,
        min_random_scale=0.9, rand_crop=1)),
    'multilabel': dict(n=9, hw=6, multi=3, kw=dict(
        data_shape=(3, 6, 6), batch_size=3, label_width=3)),
    'gray': dict(n=8, hw=7, kw=dict(data_shape=(1, 6, 6), batch_size=4,
                                    mean_r=7, std_r=3, rand_crop=1)),
    'jpeg': dict(n=6, hw=8, pil=True, encode='.jpg',
                 kw=dict(data_shape=(3, 8, 8), batch_size=3)),
}


@pytest.mark.parametrize('case', sorted(HOST_CASES))
def test_host_path_matches_jax(tmp_path, case):
    c = HOST_CASES[case]
    if c.get('pil'):
        pytest.importorskip('PIL')
    p = str(tmp_path / 'a.rec')
    _write_rec(p, c['n'], c['hw'], encode=c.get('encode', '.raw'),
               multi=c.get('multi', 0))
    out = []
    for pkg in (mx, mt):
        pkg.random.seed(4)
        it = pkg.io.ImageRecordIter(p, preprocess_threads=2,
                                    prefetch_buffer=2, **c['kw'])
        out.append((_drain(it), it.provide_data, it.provide_label))
    (want, wd, wl), (got, gd, gl) = out
    _same(got, want)
    assert [tuple(d) for d in gd] == [tuple(d) for d in wd]
    assert [tuple(d) for d in gl] == [tuple(d) for d in wl]


def test_reset_mid_epoch_and_shard_move_match_jax(tmp_path):
    p = str(tmp_path / 'a.rec')
    _write_rec(p, 16, 8, labeler=lambda i: i)
    out = []
    for pkg in (mx, mt):
        pkg.random.seed(2)
        it = pkg.io.ImageRecordIter(p, data_shape=(3, 6, 6), batch_size=4,
                                    shuffle=True, rand_crop=1,
                                    num_parts=2, part_index=0)
        first = it.next().label[0].asnumpy()
        it.reset()      # abandon the producer mid-epoch
        epoch = _drain(it, 1)
        it.set_shard(1)
        assert it.shard_info() == (2, 1)
        it.reset()
        out.append((first, epoch, _drain(it, 1)))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    _same(out[1][1], out[0][1])
    _same(out[1][2], out[0][2])


def test_preprocess_threads_change_nothing(tmp_path):
    p = str(tmp_path / 'a.rec')
    _write_rec(p, 20, 10)
    outs = []
    for t in (1, 4):
        mt.random.seed(6)
        it = mt.io.ImageRecordIter(p, data_shape=(3, 8, 8), batch_size=5,
                                   rand_crop=1, rand_mirror=1, shuffle=True,
                                   preprocess_threads=t)
        outs.append(_drain(it, 1))
    _same(outs[1], outs[0])


def test_worker_error_reaches_the_consumer(tmp_path):
    p = str(tmp_path / 'a.rec')
    rec = MXRecordIO(p, 'w')
    rec.write(b'not-an-image-record')
    rec.close()
    errors = []
    for pkg in (mx, mt):
        it = pkg.io.ImageRecordIter(p, data_shape=(3, 6, 6), batch_size=1)
        with pytest.raises(Exception) as e:
            it.next()
        errors.append(type(e.value))
    assert errors[1] is errors[0]


def test_unsupported_augmenter_warns(tmp_path):
    p = str(tmp_path / 'a.rec')
    _write_rec(p, 4, 6)
    with pytest.warns(UserWarning, match='max_rotate_angle'):
        mt.io.ImageRecordIter(p, data_shape=(3, 6, 6), batch_size=4,
                              max_rotate_angle=10)


def test_empty_file_raises(tmp_path):
    p = str(tmp_path / 'a.rec')
    MXRecordIO(p, 'w').close()
    with pytest.raises(ValueError, match='empty record file'):
        mt.io.ImageRecordIter(p, data_shape=(3, 6, 6), batch_size=1)


# ---- the device augment ---------------------------------------------------

DEVICE_CASES = {
    'resize': dict(hw=10, pil=True, kw=dict(
        data_shape=(3, 6, 6), resize=8, mean_r=11, mean_g=17, mean_b=23,
        std_r=2, std_g=3, std_b=4, scale=0.7)),
    'fixed': dict(hw=9, kw=dict(data_shape=(3, 7, 7), pad=1, fill_value=3)),
    'nonsquare': dict(hw=(8, 12), kw=dict(data_shape=(3, 7, 7))),
    'undersized': dict(hw=5, kw=dict(data_shape=(3, 7, 7))),
    'odd_parity': dict(hw=(15, 21), pil=True, kw=dict(
        data_shape=(3, 10, 10), resize=13, mean_r=3, std_r=2)),
    'gray': dict(hw=9, kw=dict(data_shape=(1, 8, 8), mean_r=7, std_r=3)),
}


@pytest.mark.parametrize('host_crop', [0, 1])
@pytest.mark.parametrize('case', sorted(DEVICE_CASES))
def test_device_augment_is_the_host_path_with_randomness_off(
        tmp_path, case, host_crop):
    c = DEVICE_CASES[case]
    if c.get('pil'):
        pytest.importorskip('PIL')
    p = str(tmp_path / 'a.rec')
    _write_rec(p, 8, c['hw'])
    kw = dict(batch_size=4, preprocess_threads=2, **c['kw'])
    host = mt.io.ImageRecordIter(p, device_augment=0, **kw)
    dev = mt.io.ImageRecordIter(p, device_augment=1, host_crop=host_crop,
                                **kw)
    with mt.cpu():
        got, want = _drain(dev), _drain(host)
    _same(got, want)


def test_device_augment_matches_the_jax_device_augment(tmp_path):
    p = str(tmp_path / 'a.rec')
    _write_rec(p, 8, 10)
    kw = dict(data_shape=(3, 6, 6), batch_size=4, mean_r=11, mean_g=17,
              mean_b=23, std_r=2, std_g=3, std_b=4, scale=0.7,
              device_augment=1, host_crop=0)
    with mt.cpu():
        got = _drain(mt.io.ImageRecordIter(p, **kw), 1)
    want = _drain(mx.io.ImageRecordIter(p, **kw), 1)
    # XLA fuses (x * scale - mean) / std and may round once fewer than
    # torch's three ops: a few f32 ulps apart, the JAX package's own
    # tolerance for its device augment (1e-5)
    for (gd, gl, _), (wd, wl, _) in zip(got, want):
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(gl, wl)


def _ramp_rec(path, n, side=16):
    """Images whose channel 0 is 10 x column and channel 1 10 x row: a
    crop's first pixel gives its offsets, and channel 0's order along a
    row whether it was mirrored."""
    rec = MXRecordIO(path, 'w')
    cols = np.arange(side, dtype=np.uint8)[None, :] * 10
    rows = np.arange(side, dtype=np.uint8)[:, None] * 10
    img = np.stack([np.broadcast_to(cols, (side, side)),
                    np.broadcast_to(rows, (side, side)),
                    np.zeros((side, side), np.uint8)], axis=2)
    for i in range(n):
        rec.write(pack_img(IRHeader(0, float(i), i, 0), img, img_fmt='.raw'))
    rec.close()


@pytest.mark.parametrize('pkg', [mx, mt], ids=['jax', 'torch'])
def test_device_augment_by_distribution(tmp_path, pkg):
    """400 images of a 16 x 16 ramp cropped to 8 x 8 on the device: every
    offset in [0, 8], both ends of both axes reached, and a mirror share
    of 0.5 +- 0.15, in both packages."""
    p = str(tmp_path / 'ramp.rec')
    _ramp_rec(p, 40)
    pkg.random.seed(13)
    it = pkg.io.ImageRecordIter(p, data_shape=(3, 8, 8), batch_size=40,
                                rand_crop=1, rand_mirror=1,
                                device_augment=1, host_crop=0)
    ys, xs, flips = [], [], []
    with mt.cpu():
        for _ in range(10):
            it.reset()
            d = it.next().data[0].asnumpy()
            for im in d:
                row = im[0, 0]
                flipped = row[0] > row[-1]
                flips.append(flipped)
                xs.append(int(round(row.min() / 10)))
                ys.append(int(round(im[1, 0, 0] / 10)))
                want = np.arange(8) * 10 + row.min()
                np.testing.assert_array_equal(
                    row, want[::-1] if flipped else want)
    assert len(flips) == 400
    assert min(xs) == 0 and max(xs) == 8 and min(ys) == 0 and max(ys) == 8
    assert abs(np.mean(flips) - 0.5) <= 0.15


def test_device_augment_is_seeded_and_runs_on_the_current_context(tmp_path):
    p = str(tmp_path / 'a.rec')
    _write_rec(p, 16, 12)

    def run(seed):
        mt.random.seed(seed)
        it = mt.io.ImageRecordIter(p, data_shape=(3, 8, 8), batch_size=8,
                                   rand_crop=1, rand_mirror=1,
                                   device_augment=1, host_crop=0)
        with mt.cpu():
            b = it.next().data[0]
        assert b.context == mt.cpu() and str(b.dtype) == 'float32'
        return b.asnumpy()

    a, b, c = run(5), run(5), run(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert len({x.tobytes() for x in a}) > 1
    # the default context is the card: without one the augment raises
    # rather than running on the host
    if not __import__('torch').cuda.is_available():
        it = mt.io.ImageRecordIter(p, data_shape=(3, 8, 8), batch_size=8,
                                   device_augment=1)
        with pytest.raises(RuntimeError):
            it.next()


def test_device_augment_flag_and_signature(tmp_path, monkeypatch):
    p = str(tmp_path / 'a.rec')
    _write_rec(p, 4, 10)
    kw = dict(data_shape=(3, 6, 6), batch_size=4)
    monkeypatch.setenv('MXTPU_DEVICE_AUGMENT', '1')
    monkeypatch.setenv('MXTPU_HOST_CROP', '0')
    flags.reload()
    try:
        on = mt.io.ImageRecordIter(p, **kw)
    finally:
        monkeypatch.undo()
        flags.reload()
    off = mt.io.ImageRecordIter(p, **kw)
    assert on._device_augment and not on._host_crop
    assert not off._device_augment and not off.defer_device_aug(True)
    sigs = {mt.io.ImageRecordIter(p, device_augment=1, **dict(kw, **extra))
            .device_aug_signature()
            for extra in ({}, {'mean_r': 1}, {'std_b': 2}, {'scale': 0.5},
                          {'rand_crop': 1}, {'rand_mirror': 1},
                          {'host_crop': 0})}
    assert len(sigs) == 7
    assert on.device_aug_signature() == mt.io.ImageRecordIter(
        p, device_augment=1, host_crop=0, **kw).device_aug_signature()


@pytest.mark.parametrize('host_crop', [1, 0])
def test_deferred_batches_are_raw_uint8(tmp_path, host_crop):
    p = str(tmp_path / 'a.rec')
    _write_rec(p, 8, 10)
    it = mt.io.ImageRecordIter(p, data_shape=(3, 6, 6), batch_size=4,
                               device_augment=1, host_crop=host_crop)
    assert it.defer_device_aug(True)
    try:
        d = it.next().data[0]
    finally:
        it.defer_device_aug(False)
    assert str(d.dtype) == 'uint8' and d.context == mt.cpu()
    assert d.shape == ((4, 6, 6, 3) if host_crop else (4, 10, 10, 3))
    import torch
    out = it.device_aug_pure()(d.handle, torch.Generator().manual_seed(0))
    assert tuple(out.shape) == (4, 3, 6, 6) and out.dtype == torch.float32


# ---- the deferred augment in the fit window ------------------------------

def _mlp():
    data = mt.sym.Variable('data')
    net = mt.sym.Convolution(data, num_filter=4, kernel=(3, 3), name='c')
    net = mt.sym.Flatten(mt.sym.Activation(net, act_type='relu'))
    net = mt.sym.FullyConnected(net, num_hidden=4, name='fc')
    return mt.sym.SoftmaxOutput(net, name='softmax')


def _fit(p, fused, host_crop, epochs=2, **kw):
    os.environ['MXTPU_FUSED_FIT'] = '1' if fused else '0'
    flags.reload('MXTPU_FUSED_FIT')
    try:
        mt.random.seed(11)
        it = mt.io.ImageRecordIter(
            p, data_shape=(3, 8, 8), batch_size=4, rand_crop=1,
            rand_mirror=1, shuffle=True, device_augment=1,
            host_crop=host_crop, scale=1.0 / 255, preprocess_threads=2, **kw)
        mod = mt.mod.Module(_mlp(), context=mt.cpu())
        with mt.cpu():
            mod.fit(it, num_epoch=epochs, optimizer='sgd',
                    optimizer_params=(('learning_rate', 0.1),),
                    kvstore='local', eval_metric='acc')
    finally:
        os.environ.pop('MXTPU_FUSED_FIT', None)
        flags.reload('MXTPU_FUSED_FIT')
    return mod, it


@pytest.mark.parametrize('host_crop', [0, 1])
def test_deferred_window_matches_the_per_batch_loop(tmp_path, host_crop):
    """40 images, batch 4: two windows and two tail batches an epoch, the
    parameters after two epochs bit for bit."""
    p = str(tmp_path / 'a.rec')
    _write_rec(p, 40, 10, labeler=lambda i: i % 4)
    mod_w, it = _fit(p, True, host_crop)
    loop = mod_w.__dict__['_fused_fit_cache'][1]
    assert (loop.windows, loop.tail_batches) == (4, 4)
    assert len(loop._programs) == 1
    assert list(loop._programs)[0][2] == it.device_aug_signature()
    assert it._defer_aug is False
    it.reset()
    with mt.cpu():
        b = it.next().data[0]
    assert str(b.dtype) == 'float32' and b.shape == (4, 3, 8, 8)
    mod_b, _ = _fit(p, False, host_crop)
    assert '_fused_fit_cache' not in mod_b.__dict__
    got = {k: v.asnumpy() for k, v in mod_w.get_params()[0].items()}
    want = {k: v.asnumpy() for k, v in mod_b.get_params()[0].items()}
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_deferred_window_is_keyed_by_the_augment(tmp_path):
    p = str(tmp_path / 'a.rec')
    _write_rec(p, 32, 8, labeler=lambda i: i % 4)
    os.environ['MXTPU_FUSED_FIT'] = '1'
    flags.reload('MXTPU_FUSED_FIT')
    try:
        mod = mt.mod.Module(_mlp(), context=mt.cpu())
        kw = dict(data_shape=(3, 8, 8), batch_size=8, device_augment=1,
                  scale=1.0 / 255)
        it_a = mt.io.ImageRecordIter(p, **kw)
        it_b = mt.io.ImageRecordIter(p, mean_r=100., std_r=7., **kw)
        fit_kw = dict(optimizer='sgd',
                      optimizer_params=(('learning_rate', 0.1),),
                      kvstore='local', eval_metric='acc')
        with mt.cpu():
            mod.fit(it_a, num_epoch=1, **fit_kw)
            loop = mod.__dict__['_fused_fit_cache'][1]
            assert len(loop._programs) == 1
            mod.fit(it_b, num_epoch=2, begin_epoch=1, **fit_kw)
        assert mod.__dict__['_fused_fit_cache'][1] is loop
        keys = list(loop._programs)
        assert len(keys) == 2 and keys[0][2] != keys[1][2]
        assert {k[2] for k in keys} == {it_a.device_aug_signature(),
                                        it_b.device_aug_signature()}
    finally:
        os.environ.pop('MXTPU_FUSED_FIT', None)
        flags.reload('MXTPU_FUSED_FIT')
