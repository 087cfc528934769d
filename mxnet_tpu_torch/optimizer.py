"""Optimizers: the counterpart of ``mxnet_tpu/optimizer.py`` (the
reference's python/mxnet/optimizer.py): the Optimizer base with its
registry and lr/wd multipliers, SGD (momentum, and f32 master weights of a
half-precision weight under ``multi_precision``), NAG, DCASGD, ccSGD, Adam,
AdaGrad, RMSProp, AdaDelta, Ftrl, Adamax, Nadam, SGLD, Test, Updater and
get_updater, over the port's NDArrays.

The fast paths call the fused update ops (:mod:`.ops.optimizer_ops`); the
others compose ``nd`` ops, as in the JAX package. SGLD draws its noise
from ``nd.random.normal`` on the weight's device.
"""
import math
import pickle

from . import ndarray as nd
from .ndarray import zeros


def _is_half(dtype):
    """True for the half-precision dtypes multi_precision applies to:
    float16 and bfloat16, the type bench's mixed-precision step trains
    in."""
    return str(dtype) in ('float16', 'bfloat16')


__all__ = ['Optimizer', 'SGD', 'NAG', 'SGLD', 'DCASGD', 'ccSGD', 'Adam',
           'AdaGrad', 'RMSProp', 'AdaDelta', 'Ftrl', 'Adamax', 'Nadam',
           'Test', 'Updater', 'get_updater', 'register', 'create']


class Optimizer:
    """Base optimizer: a registry of subclasses by lower-case name, the
    learning rate (or a scheduler's), weight decay, their per-parameter
    multipliers and the update counts."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError('Cannot find optimizer %s' % name)

    def __init__(self, rescale_grad=1., param_idx2name=None, wd=0.,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict), \
            'param_idx2name should be a dict of param indexes to names.'
        self.idx2name = param_idx2name.copy()
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) if sym is not None else ()
        self.param_dict = param_dict or {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and _is_half(weight.dtype):
            weight_master_copy = weight.astype('float32')
            return (weight_master_copy, self.create_state(index, weight_master_copy))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _is_half(weight.dtype):
            weight_master, orig_state = state
            grad32 = grad.astype('float32')
            self.update(index, weight_master, grad32, orig_state)
            weight._data = weight_master._data.to(weight._data.dtype)
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning('LRScheduler of the optimizer has already been '
                              'defined. Note that set_learning_rate can mutate '
                              'the value of the learning rate of the optimizer '
                              'only when the LRScheduler of the optimizer is '
                              'undefined.')
        self.lr = lr

    def set_lr_scale(self, args_lrscale):
        raise DeprecationWarning('Use set_lr_mult instead.')

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and '__lr_mult__' in attr[name]:
                    self.lr_mult[name] = float(attr[name]['__lr_mult__'])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith('_weight') or n.endswith('_gamma')):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and '__wd_mult__' in attr[name]:
                    self.wd_mult[name] = float(attr[name]['__wd_mult__'])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def __getstate__(self):
        ret = self.__dict__.copy()
        return ret


register = Optimizer.register
create = Optimizer.create_optimizer


def _as_clip(v):
    return -1.0 if v is None else float(v)


@register
class SGD(Optimizer):
    """SGD with momentum, and an f32 master copy of a float16 or bfloat16
    weight under ``multi_precision`` (mp_sgd_update, mp_sgd_mom_update)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=_as_clip(self.clip_gradient))
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, out=weight,
                              momentum=self.momentum, **kwargs)
        else:
            nd.sgd_update(weight, grad, out=weight, **kwargs)

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _is_half(weight.dtype):
            self._update_count(index)
            lr = self._get_lr(index)
            wd = self._get_wd(index)
            weight32, mom = state
            kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                          clip_gradient=_as_clip(self.clip_gradient))
            if mom is not None:
                nd.mp_sgd_mom_update(weight, grad, mom, weight32, out=weight,
                                     momentum=self.momentum, **kwargs)
            else:
                nd.mp_sgd_update(weight, grad, weight32, out=weight, **kwargs)
        else:
            self.update(index, weight, grad, state)


@register
class NAG(SGD):
    """Nesterov accelerated SGD through the fused nag_mom_update op."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=_as_clip(self.clip_gradient))
        if state is not None:
            nd.nag_mom_update(weight, grad, state, out=weight,
                              momentum=self.momentum, **kwargs)
        else:
            nd.sgd_update(weight, grad, out=weight, **kwargs)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half a gradient step plus
    Gaussian noise of variance lr."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, -self.clip_gradient, self.clip_gradient)
        weight += -lr / 2 * (grad + wd * weight) + \
            nd.random.normal(0, math.sqrt(lr), weight.shape,
                             dtype=weight.dtype, ctx=weight.context)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (zeros(weight.shape, weight.context), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, -self.clip_gradient, self.clip_gradient)
        mon, previous_weight = state
        if mon:
            mon *= self.momentum
            mon += -lr * (grad + wd * weight + self.lamda *
                          grad * grad * (weight - previous_weight))
        else:
            mon = -lr * (grad + wd * weight + self.lamda *
                         grad * grad * (weight - previous_weight))
            state = (mon, previous_weight)
        previous_weight._data = weight._data
        weight += mon


@register
class ccSGD(SGD):
    """Deprecated alias of SGD."""


@register
class Adam(Optimizer):
    """Adam through the fused adam_update op, its bias correction folded
    into lr."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context, dtype=weight.dtype),
                zeros(weight.shape, weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        mean, var = state
        nd.adam_update(weight, grad, mean, var, out=weight, lr=lr, wd=wd,
                       beta1=self.beta1, beta2=self.beta2,
                       epsilon=self.epsilon, rescale_grad=self.rescale_grad,
                       clip_gradient=_as_clip(self.clip_gradient))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, -self.clip_gradient, self.clip_gradient)
        history = state
        history += grad * grad
        weight += -lr * (grad / nd.sqrt(history + self.float_stable_eps) +
                         wd * weight)


@register
class RMSProp(Optimizer):
    """RMSProp: rmsprop_update, or rmspropalex_update when centered."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (zeros(weight.shape, weight.context),
                    zeros(weight.shape, weight.context),
                    zeros(weight.shape, weight.context))
        return (zeros(weight.shape, weight.context),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      gamma1=self.gamma1, epsilon=self.epsilon,
                      clip_gradient=_as_clip(self.clip_gradient),
                      clip_weights=_as_clip(self.clip_weights))
        if not self.centered:
            (n,) = state
            nd.rmsprop_update(weight, grad, n, out=weight, **kwargs)
        else:
            n, g, delta = state
            nd.rmspropalex_update(weight, grad, n, g, delta, out=weight,
                                  gamma2=self.gamma2, **kwargs)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, -self.clip_gradient, self.clip_gradient)
        acc_g, acc_delta = state
        acc_g._data = (self.rho * acc_g + (1. - self.rho) * grad * grad)._data
        current_delta = (nd.sqrt(acc_delta + self.epsilon) /
                         nd.sqrt(acc_g + self.epsilon)) * grad
        acc_delta._data = (self.rho * acc_delta +
                           (1. - self.rho) * current_delta * current_delta)._data
        weight._data = (weight - current_delta - wd * weight)._data


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),   # z
                zeros(weight.shape, weight.context))   # n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        lr = self._get_lr(index)
        z, n = state
        nd.ftrl_update(weight, grad, z, n, out=weight, lr=lr,
                       lamda1=self.lamda1, beta=self.beta, wd=wd,
                       rescale_grad=self.rescale_grad,
                       clip_gradient=_as_clip(self.clip_gradient))


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        lr /= (1. - self.beta1 ** t)
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = nd.clip(grad, -self.clip_gradient, self.clip_gradient)
        m_t, u_t = state
        m_t._data = (self.beta1 * m_t + (1. - self.beta1) * grad)._data
        u_t._data = nd.maximum(self.beta2 * u_t, nd.abs(grad))._data
        weight += -lr * m_t / u_t


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = nd.clip(grad, -self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1. - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1. - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        m_t._data = (self.beta1 * m_t + (1. - self.beta1) * grad)._data
        v_t._data = (self.beta2 * v_t + (1. - self.beta2) * grad * grad)._data
        grad_prime = grad / (1. - self.m_schedule)
        m_t_prime = m_t / (1. - m_schedule_next)
        v_t_prime = v_t / (1. - self.beta2 ** t)
        m_t_bar = (1. - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        weight += -lr * m_t_bar / (nd.sqrt(v_t_prime) + self.epsilon)


@register
class Test(Optimizer):
    """Deterministic test optimizer: weight += grad * rescale_grad."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state._data = weight._data


class Updater:
    """Wraps an optimizer for kvstore use: one state per index, made at
    its first update; ``get_states``/``set_states`` pickle them (with the
    optimizer under ``dump_optimizer``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)


def get_updater(optimizer):
    return Updater(optimizer)
