"""Checkpoint store for training state: the one-process half of
``mxnet_tpu/parallel/checkpoint.py``, with its function names and
contracts.

The JAX package writes through orbax, which the card's machine does not
have, so the files here are the port's own::

    <directory>/<step>/state.pt     every array leaf, by its '/'-joined path
    <directory>/<step>/meta.json    the JSON meta sidecar (when given)

A step is written into a hidden temporary directory beside the others and
committed by one atomic rename, so a step directory (and its meta sidecar,
which rides the same commit) appears whole or not at all; a crashed
half-written save never lists. ``max_to_keep`` prunes the oldest committed
steps after each commit. Restoring a step whose data file is missing or
truncated raises, which is what lets the checkpointer fall back to an
older step. Reading the JAX package's orbax checkpoints is out of scope:
the two packages' checkpoint directories are not interchangeable (a
Module's ``save_checkpoint``/``load`` files are, ``model.py``).

    from mxnet_tpu_torch.parallel import checkpoint as ckpt
    mngr = ckpt.manager('/path/ckpts', max_to_keep=3)
    ckpt.save(mngr, step, {'params': {...}, 'opt': {...}}, meta={...})
    state = ckpt.restore(mngr, template=train_state)  # template's devices
    step = ckpt.latest_step(mngr)

The multi-process half (each host writing its own shards, the commit
barrier, restoring onto another mesh) waits for ROADMAP.md §1 item 11.
"""
import json
import os
import shutil
import threading

import torch

__all__ = ['manager', 'save', 'restore', 'restore_with_meta', 'read_meta',
           'restore_state', 'latest_step', 'all_steps', 'delete_step',
           'wait', 'template_shapes', 'validate_shapes']

_STATE = 'state.pt'
_META = 'meta.json'


class CheckpointManager:
    """A checkpoint directory and its pruning policy."""

    def __init__(self, directory, max_to_keep=None):
        self.directory = os.path.abspath(str(directory))
        self.max_to_keep = max_to_keep
        self._lock = threading.Lock()
        self._seq = 0
        os.makedirs(self.directory, exist_ok=True)

    def step_dir(self, step):
        return os.path.join(self.directory, str(int(step)))


def manager(directory, max_to_keep=None, save_interval_steps=1):
    """A manager rooted at ``directory`` (created if needed).
    ``save_interval_steps`` is accepted for the JAX signature; the
    checkpointer decides the cadence itself."""
    return CheckpointManager(directory, max_to_keep=max_to_keep)


def _flatten(tree, prefix=''):
    """[(path, leaf)] of a nested dict/list/tuple tree, paths '/'-joined
    (dict keys, list indices), in a deterministic order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=str):
            out.extend(_flatten(tree[k], '%s%s/' % (prefix, k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, '%s%d/' % (prefix, i)))
        return out
    return [(prefix[:-1], tree)]


def _unflatten_like(template, leaves, prefix=''):
    """``template``'s structure with each leaf taken from ``leaves`` by
    its path."""
    if isinstance(template, dict):
        return {k: _unflatten_like(v, leaves, '%s%s/' % (prefix, k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_like(v, leaves, '%s%d/' % (prefix, i))
            for i, v in enumerate(template))
    return leaves[prefix[:-1]]


def template_shapes(template):
    """{'/'-joined leaf path: list(shape)} for a tree: recorded in the
    checkpoint meta at save, so that a restore validates the shapes against
    the live state and names the offending leaf."""
    return {path: list(getattr(leaf, 'shape', ()))
            for path, leaf in _flatten(template)}


def validate_shapes(saved_shapes, template):
    """Raise ValueError naming every leaf whose shape differs between the
    checkpoint meta (``saved_shapes``, :func:`template_shapes` at save) and
    the live ``template``, before any array is read. Leaves added or
    removed count as mismatches too."""
    live = template_shapes(template)
    bad = []
    for key in sorted(set(saved_shapes) | set(live)):
        s = saved_shapes.get(key)
        l = live.get(key)
        if s is None:
            bad.append('%s: not in the checkpoint (live %s)'
                       % (key, tuple(l)))
        elif l is None:
            bad.append('%s: not in the live state (saved %s)'
                       % (key, tuple(s)))
        elif list(s) != list(l):
            bad.append('%s: saved global shape %s vs live %s'
                       % (key, tuple(s), tuple(l)))
    if bad:
        raise ValueError('checkpoint/live global-shape mismatch — '
                         + '; '.join(bad))


def _host(t):
    t = t.detach() if isinstance(t, torch.Tensor) else torch.as_tensor(t)
    return t.cpu() if t.device.type != 'cpu' else t


def save(mngr, step, state, wait=True, meta=None):
    """Write ``state`` (a tree of tensors; device tensors are copied to the
    host here) at ``step``, with ``meta`` (a JSON-serializable dict) in the
    same commit. Returns True once the step is committed. A step that is
    already committed is replaced. ``wait`` is accepted for the JAX
    signature: the write is synchronous (the checkpointer's writer thread
    is what runs it off the step loop)."""
    step = int(step)
    with mngr._lock:
        mngr._seq += 1
        seq = mngr._seq
    tmp = os.path.join(mngr.directory, '.tmp-%d-%d-%d'
                       % (step, os.getpid(), seq))
    os.makedirs(tmp)
    try:
        flat = {path: _host(leaf) for path, leaf in _flatten(state)}
        torch.save(flat, os.path.join(tmp, _STATE))
        if meta is not None:
            with open(os.path.join(tmp, _META), 'w') as f:
                json.dump(meta, f)
        final = mngr.step_dir(step)
        with mngr._lock:
            if os.path.exists(final):
                # a replayed step after a restore: the old one goes aside
                # first, so the commit stays one rename
                old = final + '.old-%d' % seq
                os.replace(final, old)
                shutil.rmtree(old, ignore_errors=True)
            os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(mngr)
    return True


def _prune(mngr):
    keep = mngr.max_to_keep
    if not keep:
        return
    steps = all_steps(mngr)
    for s in steps[:max(0, len(steps) - int(keep))]:
        delete_step(mngr, s)


def _load(mngr, step):
    path = os.path.join(mngr.step_dir(step), _STATE)
    if not os.path.exists(path):
        raise FileNotFoundError('checkpoint step %d has no data file (%s)'
                                % (step, path))
    return torch.load(path, map_location='cpu', weights_only=True)


def _onto(template, flat):
    """Each saved leaf onto its template leaf's device and dtype, shape
    checked."""
    leaves = {}
    for path, live in _flatten(template):
        if path not in flat:
            raise KeyError('checkpoint has no leaf %s' % path)
        saved = flat[path]
        if tuple(saved.shape) != tuple(live.shape):
            raise ValueError('checkpoint leaf %s has shape %s, live %s'
                             % (path, tuple(saved.shape), tuple(live.shape)))
        leaves[path] = saved.to(device=live.device, dtype=live.dtype)
    return _unflatten_like(template, leaves)


def restore(mngr, template, step=None):
    """Restore onto ``template``'s devices and dtypes (typically the live
    train state). ``step=None`` = the newest committed step."""
    if step is None:
        step = latest_step(mngr)
    if step is None:
        raise FileNotFoundError('no checkpoint found in %s'
                                % mngr.directory)
    return _onto(template, _load(mngr, int(step)))


def restore_with_meta(mngr, template, step):
    """Restore a save-with-``meta`` step: ``(state, meta)``."""
    return restore(mngr, template, step), read_meta(mngr, step)


def restore_state(mngr, template, step):
    """Restore only the array state of a save-with-``meta`` step (the
    companion of :func:`read_meta` for callers that validated the meta
    first)."""
    return restore(mngr, template, step)


def read_meta(mngr, step):
    """The JSON meta sidecar of one committed step, without reading any
    array; a missing or truncated sidecar raises."""
    path = os.path.join(mngr.step_dir(step), _META)
    with open(path) as f:
        return json.load(f)


def latest_step(mngr):
    steps = all_steps(mngr)
    return steps[-1] if steps else None


def all_steps(mngr):
    """Committed step ids, ascending (a step directory appears only at the
    commit rename)."""
    try:
        names = os.listdir(mngr.directory)
    except OSError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isdir(os.path.join(
                      mngr.directory, n)))


def delete_step(mngr, step):
    """Remove one committed step."""
    shutil.rmtree(mngr.step_dir(step), ignore_errors=True)


def wait(mngr):
    """Block until every in-flight save has committed: the store's saves
    are synchronous, so nothing is ever in flight here."""
    return None
