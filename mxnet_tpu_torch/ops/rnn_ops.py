"""The fused multi-layer RNN op: the counterpart of
``mxnet_tpu/ops/rnn_ops.py``.

The parameter vector keeps the JAX package's (and cuDNN's canonical)
packed layout: every layer's and direction's input weights ``W`` and
recurrent weights ``R`` first, ``(W, R)`` per layer and direction, then
all the biases ``(bW, bR)`` in the same order. Gate order: LSTM
``[i, f, g, o]``, GRU ``[r, z, n]``.

The body (:func:`_rnn`) runs one call a layer to torch's fused recurrent
entries (``torch.lstm``, ``torch.gru``, ``torch.rnn_tanh``,
``torch.rnn_relu``), with the parameter list ``[W, R, bW, bR]`` a
direction as views into the packed vector. On the card they run on cuDNN,
as MXNet 0.11's only real RNN did (``cudnn_rnn-inl.h``); the JAX package
leaves the op to XLA (a ``lax.scan`` a layer and direction), not to a
Pallas kernel. Dropout between layers draws on the op's generator, as the
port's ``Dropout`` does; torch's entries get ``dropout=0``.

:func:`_rnn_plain` is the same function as a loop over the time steps,
written from the JAX package's step functions: the tests hold the body to
it on the CPU and ``chip_smoke.py`` on the card. The op never hands a
tensor to it.

``lstm_state_clip_min``/``lstm_state_clip_max`` are registered, and, as
in the JAX package, not read.
"""
import torch

from .registry import register

__all__ = ['rnn_param_size']


def _gates(mode):
    return {'rnn_relu': 1, 'rnn_tanh': 1, 'lstm': 4, 'gru': 3}[mode]


def rnn_param_size(num_layers, state_size, input_size, bidirectional, mode):
    """Total flat parameter count (reference rnn-inl.h GetParamSize)."""
    g = _gates(mode)
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        size += dirs * g * state_size * (isz + state_size)   # W + R
    size += num_layers * dirs * g * state_size * 2           # biases
    return size


def _unpack(params, num_layers, state_size, input_size, dirs, mode):
    """Views ``[[(W, R), ...] a layer]`` and ``[[(bW, bR), ...]]`` into the
    packed vector."""
    g = _gates(mode)
    H = state_size
    ws, offset = [], 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else H * dirs
        layer_ws = []
        for _ in range(dirs):
            W = params[offset:offset + g * H * isz].reshape(g * H, isz)
            offset += g * H * isz
            R = params[offset:offset + g * H * H].reshape(g * H, H)
            offset += g * H * H
            layer_ws.append((W, R))
        ws.append(layer_ws)
    bs = []
    for layer in range(num_layers):
        layer_bs = []
        for _ in range(dirs):
            bW = params[offset:offset + g * H]
            offset += g * H
            bR = params[offset:offset + g * H]
            offset += g * H
            layer_bs.append((bW, bR))
        bs.append(layer_bs)
    return ws, bs


def _rnn_arg_names(attrs):
    mode = attrs.get('mode', 'lstm')
    return ['data', 'parameters', 'state'] + \
        (['state_cell'] if mode == 'lstm' else [])


def _setup(attrs, data, parameters, state, rest):
    mode = attrs.get('mode', 'lstm')
    gen = rest[-1]
    state_cell = rest[0] if (mode == 'lstm' and len(rest) > 1) else None
    H = int(attrs['state_size'])
    L = int(attrs.get('num_layers', 1))
    dirs = 2 if attrs.get('bidirectional', False) else 1
    ws, bs = _unpack(parameters, L, H, data.shape[2], dirs, mode)
    return mode, gen, state_cell, H, L, dirs, ws, bs


def _between_layers(attrs, x, gen, layer, L):
    """Dropout on a layer's output before the next layer (training only),
    on the op's generator."""
    p = float(attrs.get('p', 0.0))
    if p > 0 and attrs.get('__is_train__', False) and layer < L - 1 \
            and gen is not None:
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1 - p
        x = torch.where(keep, x / (1 - p), torch.zeros_like(x))
    return x


def _outputs(attrs, mode, x, h_out, c_out):
    if not attrs.get('state_outputs', False):
        return x
    outputs = [x, torch.cat(h_out)]
    if mode == 'lstm':
        outputs.append(torch.cat(c_out))
    return tuple(outputs)


_FUSED = {'lstm': torch.lstm, 'gru': torch.gru, 'rnn_tanh': torch.rnn_tanh,
          'rnn_relu': torch.rnn_relu}


@register('RNN', input_names=['data', 'parameters', 'state', 'state_cell'],
          param_defaults={'state_size': 0, 'num_layers': 1,
                          'bidirectional': False, 'mode': 'lstm', 'p': 0.0,
                          'state_outputs': False, 'lstm_state_clip_min': None,
                          'lstm_state_clip_max': None},
          num_outputs=lambda attrs: (3 if attrs.get('mode') == 'lstm' else 2)
          if attrs.get('state_outputs', False) else 1,
          needs_rng=True, train_aware=True, arg_names_fn=_rnn_arg_names)
def _rnn(attrs, data, parameters, state, *rest):
    """data (T, N, I), the packed parameters, state (L * dirs, N, H) and,
    for LSTM, state_cell; the generator last. Returns the output
    (T, N, dirs * H) and, with ``state_outputs``, the final h (and c)."""
    mode, gen, state_cell, H, L, dirs, ws, bs = _setup(
        attrs, data, parameters, state, rest)
    fused = _FUSED[mode]
    # cuDNN keeps its reserve space for the backward only in training mode
    train = torch.is_grad_enabled()
    x = data
    h_out, c_out = [], []
    for layer in range(L):
        params = []
        for d in range(dirs):
            params += [ws[layer][d][0], ws[layer][d][1],
                       bs[layer][d][0], bs[layer][d][1]]
        h0 = state[layer * dirs:(layer + 1) * dirs]
        if mode == 'lstm':
            c0 = state_cell[layer * dirs:(layer + 1) * dirs] \
                if state_cell is not None else torch.zeros_like(h0)
            x, hT, cT = fused(x, (h0, c0), params, True, 1, 0.0, train,
                              dirs == 2, False)
            c_out.append(cT)
        else:
            x, hT = fused(x, h0, params, True, 1, 0.0, train, dirs == 2,
                          False)
        h_out.append(hT)
        x = _between_layers(attrs, x, gen, layer, L)
    return _outputs(attrs, mode, x, h_out, c_out)


def _step_fn(mode, H):
    """One time step ``(h, c), gates_x, R, bR -> (h, c)``, as the JAX
    package's ``_cell_step``."""
    if mode == 'lstm':
        def step(h, c, gx, R, bR):
            gates = gx + h @ R.t() + bR
            i = torch.sigmoid(gates[:, 0 * H:1 * H])
            f = torch.sigmoid(gates[:, 1 * H:2 * H])
            g = torch.tanh(gates[:, 2 * H:3 * H])
            o = torch.sigmoid(gates[:, 3 * H:4 * H])
            c = f * c + i * g
            return o * torch.tanh(c), c
        return step
    if mode == 'gru':
        def step(h, c, gx, R, bR):
            rz_h = h @ R[:2 * H].t() + bR[:2 * H]
            r = torch.sigmoid(gx[:, :H] + rz_h[:, :H])
            z = torch.sigmoid(gx[:, H:2 * H] + rz_h[:, H:])
            n = torch.tanh(gx[:, 2 * H:] + r * (h @ R[2 * H:].t()
                                                 + bR[2 * H:]))
            h = (1 - z) * n + z * h
            return h, h
        return step
    act = torch.relu if mode == 'rnn_relu' else torch.tanh

    def step(h, c, gx, R, bR):
        h = act(gx + h @ R.t() + bR)
        return h, h
    return step


def _rnn_plain(attrs, data, parameters, state, *rest):
    """The RNN op as a loop over the time steps (the plain version of
    :func:`_rnn`, the same arguments and results)."""
    mode, gen, state_cell, H, L, dirs, ws, bs = _setup(
        attrs, data, parameters, state, rest)
    step = _step_fn(mode, H)
    T = data.shape[0]
    x = data
    h_out, c_out = [], []
    for layer in range(L):
        outs = []
        for d in range(dirs):
            (W, R), (bW, bR) = ws[layer][d], bs[layer][d]
            idx = layer * dirs + d
            h = state[idx]
            c = state_cell[idx] if state_cell is not None \
                else torch.zeros_like(h)
            gates_x = torch.einsum('tni,gi->tng', x, W) + bW
            ys = [None] * T
            for t in (range(T - 1, -1, -1) if d == 1 else range(T)):
                h, c = step(h, c, gates_x[t], R, bR)
                ys[t] = h
            outs.append(torch.stack(ys))
            h_out.append(h[None])
            c_out.append(c[None])
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        x = _between_layers(attrs, x, gen, layer, L)
    return _outputs(attrs, mode, x, h_out, c_out)
