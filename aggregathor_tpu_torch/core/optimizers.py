"""Optimizer registry: the optax update rules, written out in PyTorch.

Counterpart of ``aggregathor_tpu/core/optimizers.py``, with the same five
names, key:value tunables and defaults.  The formulas are optax's (where eps
sits, adagrad's initial accumulator of 0.1, rmsprop's eps inside the square
root), not ``torch.optim``'s.  With ``u`` the transformed gradient and
``lr = schedule(count)`` (count starting at 0), every rule applies
``p <- p + (-lr) * u`` in place, then increments ``count``.

- sgd:      t <- g + momentum * t;  u = t (nesterov: g + momentum * t)
- adam:     m <- (1-b1) g + b1 m;  v <- (1-b2) g^2 + b2 v;
            u = m/(1-b1^k) / (sqrt(v/(1-b2^k)) + eps), k = count + 1
- adadelta: e_g <- (1-rho) g^2 + rho e_g;  u = sqrt(e_x + eps)/sqrt(e_g + eps) g;
            e_x <- (1-rho) u^2 + rho e_x
- adagrad:  s <- s + g^2;  u = g / sqrt(s + eps) where s > 0, else 0
- rmsprop:  v <- (1-decay) g^2 + decay v;  u = g / sqrt(v + eps), then
            momentum applied after the rate, as optax chains it
"""

import numpy as np
import torch

from ..utils import ClassRegister, parse_keyval

optimizers = ClassRegister("optimizer")


def _bias_correction(decay, count):
    # float32 like optax's ``1 - decay**count`` on an int32 count
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """Base: ``init(params)`` builds the state, ``apply`` updates in place.

    ``buffers`` maps each per-parameter buffer the rule keeps to its
    initial value."""

    def __init__(self, schedule, buffers=None):
        self.schedule = schedule
        self.buffers = dict(buffers or {})

    def init(self, params):
        state = {"count": 0}
        for buf, value in self.buffers.items():
            state[buf] = {name: torch.full_like(p, value) for name, p in params.items()}
        return state

    @torch.no_grad()
    def apply(self, params, grads, state):
        """p <- p - lr * u for every parameter, ``state`` updated in place."""
        lr = float(np.float32(self.schedule(state["count"])))
        count = state["count"] + 1
        for name, p in params.items():
            u = self.transform(grads[name], {buf: state[buf][name] for buf in self.buffers}, count)
            p.add_(self.post_rate(-lr * u, name, state))
        state["count"] = count

    def transform(self, g, bufs, count):
        raise NotImplementedError

    def post_rate(self, update, name, state):
        return update


class SGD(Optimizer):
    def __init__(self, schedule, momentum, nesterov):
        super().__init__(schedule, {"trace": 0.0} if momentum > 0.0 else None)
        self.momentum, self.nesterov = momentum, nesterov

    def transform(self, g, bufs, count):
        if not self.momentum > 0.0:
            return g
        t = bufs["trace"]
        t.mul_(self.momentum).add_(g)
        return g + self.momentum * t if self.nesterov else t


class Adam(Optimizer):
    def __init__(self, schedule, b1, b2, eps):
        super().__init__(schedule, {"mu": 0.0, "nu": 0.0})
        self.b1, self.b2, self.eps = b1, b2, eps

    def transform(self, g, bufs, count):
        mu, nu = bufs["mu"], bufs["nu"]
        mu.copy_((1 - self.b1) * g + self.b1 * mu)
        nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
        mu_hat = mu / _bias_correction(self.b1, count)
        nu_hat = nu / _bias_correction(self.b2, count)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps)


class AdaDelta(Optimizer):
    def __init__(self, schedule, rho, eps):
        super().__init__(schedule, {"e_g": 0.0, "e_x": 0.0})
        self.rho, self.eps = rho, eps

    def transform(self, g, bufs, count):
        e_g, e_x = bufs["e_g"], bufs["e_x"]
        e_g.copy_((1 - self.rho) * (g * g) + self.rho * e_g)
        u = torch.sqrt(e_x + self.eps) / torch.sqrt(e_g + self.eps) * g
        e_x.copy_((1 - self.rho) * (u * u) + self.rho * e_x)
        return u


class AdaGrad(Optimizer):
    def __init__(self, schedule, initial_accumulator, eps):
        super().__init__(schedule, {"sum_of_squares": initial_accumulator})
        self.eps = eps

    def transform(self, g, bufs, count):
        s = bufs["sum_of_squares"]
        s.add_(g * g)
        return torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0) * g


class RMSProp(Optimizer):
    def __init__(self, schedule, decay, momentum, eps):
        super().__init__(schedule, {"nu": 0.0, "trace": 0.0} if momentum > 0.0 else {"nu": 0.0})
        self.decay, self.momentum, self.eps = decay, momentum, eps

    def transform(self, g, bufs, count):
        nu = bufs["nu"]
        nu.copy_((1 - self.decay) * (g * g) + self.decay * nu)
        return g * torch.rsqrt(nu + self.eps)

    def post_rate(self, update, name, state):
        if not self.momentum > 0.0:
            return update
        t = state["trace"][name]
        t.mul_(self.momentum).add_(update)
        return t


def _sgd(schedule, args):
    kv = parse_keyval(args, {"momentum": 0.0, "nesterov": False})
    return SGD(schedule, kv["momentum"], kv["nesterov"])


def _adam(schedule, args):
    kv = parse_keyval(args, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
    return Adam(schedule, kv["beta1"], kv["beta2"], kv["epsilon"])


def _adadelta(schedule, args):
    kv = parse_keyval(args, {"rho": 0.95, "epsilon": 1e-8})
    return AdaDelta(schedule, kv["rho"], kv["epsilon"])


def _adagrad(schedule, args):
    kv = parse_keyval(args, {"initial-accumulator": 0.1, "epsilon": 1e-7})
    return AdaGrad(schedule, kv["initial-accumulator"], kv["epsilon"])


def _rmsprop(schedule, args):
    kv = parse_keyval(args, {"decay": 0.9, "momentum": 0.0, "epsilon": 1e-10})
    return RMSProp(schedule, kv["decay"], kv["momentum"], kv["epsilon"])


optimizers.register("sgd", _sgd)
optimizers.register("adam", _adam)
optimizers.register("adadelta", _adadelta)
optimizers.register("adagrad", _adagrad)
optimizers.register("rmsprop", _rmsprop)


def build_optimizer(name, schedule, args=None):
    """Build an optimizer from a registered name, schedule and key:value args."""
    return optimizers.get(name)(schedule, args or [])
