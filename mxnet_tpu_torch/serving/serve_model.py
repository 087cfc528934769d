"""Serve a saved checkpoint over HTTP with continuous batching: the
command-line front end of the serving plane, the counterpart of
``tools/serve_model.py``::

    python -m mxnet_tpu_torch.serving.serve_model mymodel --epoch 3 \\
        --data-shape 3,224,224
    python -m mxnet_tpu_torch.serving.serve_model mymodel --epoch 3 \\
        --data-shape 10 --port 8500 --max-batch 64 --max-wait-ms 3 \\
        --context cpu

Loads ``<prefix>-symbol.json`` + ``<prefix>-<epoch>.params``
(``Module.save_checkpoint`` artifacts of either package) through
``ServingEngine.from_checkpoint``, binds for inference on the card
(``--context gpu``, the default) or the host (``--context cpu``), runs
every bucket of the ladder once (power-of-two batch sizes up to
--max-batch), and serves:

- ``POST /predict`` — JSON ``{"data": [[...], ...]}`` (or
  ``{"inputs": {...}}`` for multi-input graphs, or a raw .npy body);
  concurrent requests coalesce into shared padded device dispatches;
- ``GET /models`` / ``/healthz`` / ``/metrics`` — signature, probe, and
  the Prometheus ``serve.*`` family (with MXTPU_TELEMETRY=1).

It prints ``serving <name> on port <p> (buckets [...])`` once it answers,
and stops on SIGTERM or Ctrl-C.
"""
import argparse
import logging
import signal
import sys
import threading


def _parse_shape(text):
    try:
        return tuple(int(d) for d in text.split(',') if d.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(
            'shape must be comma-separated ints, e.g. 3,224,224')


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m mxnet_tpu_torch.serving.serve_model',
        description='Serve a Module checkpoint over HTTP with dynamic '
                    'batching over bucketed batch shapes.')
    ap.add_argument('prefix', help='checkpoint prefix '
                    '(<prefix>-symbol.json, <prefix>-NNNN.params)')
    ap.add_argument('--epoch', type=int, default=0,
                    help='checkpoint epoch to load (default 0)')
    ap.add_argument('--data-shape', type=_parse_shape, required=True,
                    action='append', dest='data_shapes',
                    help='per-example input shape WITHOUT the batch dim, '
                         'e.g. 3,224,224 (repeat for multi-input graphs, '
                         'in --data-name order)')
    ap.add_argument('--data-name', action='append', dest='data_names',
                    help='input name(s), default "data"')
    ap.add_argument('--port', type=int, default=8500,
                    help='HTTP port (0 = OS-assigned ephemeral, printed '
                         'at startup; default 8500)')
    ap.add_argument('--max-batch', type=int, default=None,
                    help='largest batch bucket (default '
                         'MXTPU_SERVE_MAX_BATCH)')
    ap.add_argument('--max-wait-ms', type=float, default=None,
                    help='batcher coalescing deadline (default '
                         'MXTPU_SERVE_MAX_WAIT_MS)')
    ap.add_argument('--context', default='gpu', choices=['gpu', 'cpu'],
                    help='device to serve from (default gpu: the card)')
    ap.add_argument('--no-warmup', action='store_true',
                    help='skip running each bucket once before traffic')
    args = ap.parse_args(argv)

    names = args.data_names or ['data']
    if len(names) != len(args.data_shapes):
        ap.error('--data-name count (%d) must match --data-shape count '
                 '(%d)' % (len(names), len(args.data_shapes)))

    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(message)s')
    from .. import context as ctx_mod
    from .batcher import DynamicBatcher
    from .engine import ServingEngine
    from .http import start_server

    ctx = ctx_mod.gpu(0) if args.context == 'gpu' else ctx_mod.cpu()
    engine = ServingEngine.from_checkpoint(
        args.prefix, args.epoch,
        data_shapes=list(zip(names, args.data_shapes)),
        context=ctx, max_batch=args.max_batch)
    if not args.no_warmup:
        engine.warmup()
    server = start_server(engine,
                          DynamicBatcher(engine,
                                         max_wait_ms=args.max_wait_ms),
                          port=args.port)
    print('serving %s on port %d (buckets %s)'
          % (engine.name, server.port, engine.buckets), flush=True)

    # an Event has no check-then-wait window: a SIGTERM landing at any
    # point sets it and wait() returns
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == '__main__':
    sys.exit(main())
