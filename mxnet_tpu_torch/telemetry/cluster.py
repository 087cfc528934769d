"""This process's host index and the layout of the cluster's sync vector:
the port's copies of ``host_index``, ``SYNC_KEYS`` and ``_host_ids`` from
``mxnet_tpu/telemetry/cluster.py``. ``host_index`` stamps every telemetry
record and /metrics sample; ``SYNC_KEYS`` and ``_host_ids`` are the columns
and rows that the step timeline's attribution reads
(``telemetry/timeline.py``). The rest of that module, the cluster
aggregation (the off-graph allgather of each host's gauges, the straggler
classification), is not ported: reaching it raises NotImplementedError
naming ROADMAP.md §1 item 13.
"""
import numpy as np

__all__ = ['host_index', 'SYNC_KEYS']

# the slots of each host's sync vector, in order (the JAX package's): the
# step-timeline plane's eight slots are the tail
SYNC_KEYS = ('step_time_ms', 'io_wait_pct', 'dispatch_ms', 'live_bytes',
             'comm_pct', 'proc_index', 'goodput_pct', 'badput_top',
             'comm_src', 'mem_headroom_pct',
             'clock_wall_s', 'clock_mono_s', 'tl_draw_ms', 'tl_put_ms',
             'tl_dispatch_ms', 'tl_fetch_ms', 'tl_ckpt_ms', 'tl_kv_ms')

_host = None


def host_index():
    """This process's host id, read once from MXTPU_HOST_ID (the launcher's
    environment)."""
    global _host
    if _host is None:
        from ..config import flags
        _host = int(flags.get('MXTPU_HOST_ID'))
    return _host


def _host_ids(mat):
    """Row index -> host id of one matrix of sync vectors: the proc_index
    slot where the sender carried it, else the row's position."""
    mat = np.asarray(mat, np.float64)
    idx = SYNC_KEYS.index('proc_index')
    ids = []
    for i in range(mat.shape[0]):
        v = float(mat[i, idx]) if idx < mat.shape[1] else float('nan')
        ids.append(int(v) if np.isfinite(v) else i)
    return ids


def __getattr__(name):
    if name.startswith('__'):
        raise AttributeError(name)
    raise NotImplementedError(
        'telemetry.cluster.%s: cluster aggregation is not ported yet '
        '(ROADMAP.md §1 item 13)' % name)
