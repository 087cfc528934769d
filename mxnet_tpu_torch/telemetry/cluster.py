"""This process's host index: the port's copy of ``host_index`` from
``mxnet_tpu/telemetry/cluster.py``, which stamps every telemetry record
and /metrics sample. The rest of that module, the cluster aggregation
(the off-graph allgather of each host's gauges, the straggler
classification), is not ported: reaching it raises NotImplementedError
naming ROADMAP.md §1 item 13.
"""
__all__ = ['host_index']

_host = None


def host_index():
    """This process's host id, read once from MXTPU_HOST_ID (the launcher's
    environment)."""
    global _host
    if _host is None:
        from ..config import flags
        _host = int(flags.get('MXTPU_HOST_ID'))
    return _host


def __getattr__(name):
    if name.startswith('__'):
        raise AttributeError(name)
    raise NotImplementedError(
        'telemetry.cluster.%s: cluster aggregation is not ported yet '
        '(ROADMAP.md §1 item 13)' % name)
