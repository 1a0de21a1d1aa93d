"""Byzantine gradient attacks.

Counterpart of ``aggregathor_tpu/parallel/attacks.py``.  The first ``r``
worker slots are Byzantine.  Two families:

- **local** attacks read only the attacker's own (d,) gradient (signflip,
  zero, gaussian, inf);
- **omniscient** attacks see the whole (n, d) matrix and coordinate the
  coalition (empire: Fall of Empires; little: A Little Is Enough).

Randomness comes from an explicit ``torch.Generator`` the engine derives per
(seed, step, worker); its draws cannot match the JAX package's threefry
streams, so the gaussian attack matches it in distribution only.
"""

import math

import torch

from ..utils import ClassRegister, parse_keyval

attacks = ClassRegister("attack")


def register(name, cls):
    return attacks.register(name, cls)


def itemize():
    return attacks.itemize()


def instantiate(name, nb_workers, nb_byz_workers, args=None):
    return attacks.get(name)(nb_workers, nb_byz_workers, args or [])


class Attack:
    """Base attack. ``omniscient`` selects which hook the engine calls."""

    omniscient = False
    #: typed key:value argument defaults, parsed strictly
    ARG_DEFAULTS = {}

    def __init__(self, nb_workers, nb_byz_workers, args):
        self.nb_workers = int(nb_workers)
        self.nb_byz_workers = int(nb_byz_workers)
        self.args = parse_keyval(args, self.ARG_DEFAULTS, strict=True)

    def apply_local(self, grad, generator):
        """Transform one Byzantine worker's own (d,) gradient."""
        raise NotImplementedError

    def apply_matrix(self, matrix, byz_mask):
        """Transform the (n, d) matrix; rows where ``byz_mask`` is True belong
        to the coalition (omniscient attacks only)."""
        raise NotImplementedError


class SignFlipAttack(Attack):
    """Submit -scale times the true gradient."""

    ARG_DEFAULTS = {"scale": 1.0}

    def __init__(self, nb_workers, nb_byz_workers, args):
        super().__init__(nb_workers, nb_byz_workers, args)
        self.scale = self.args["scale"]

    def apply_local(self, grad, generator):
        return -self.scale * grad


class ZeroAttack(Attack):
    """Submit the zero vector."""

    def apply_local(self, grad, generator):
        return torch.zeros_like(grad)


class GaussianAttack(Attack):
    """Submit pure Gaussian noise of tunable deviation."""

    ARG_DEFAULTS = {"deviation": 100.0}

    def __init__(self, nb_workers, nb_byz_workers, args):
        super().__init__(nb_workers, nb_byz_workers, args)
        self.deviation = self.args["deviation"]

    def apply_local(self, grad, generator):
        noise = torch.randn(grad.shape, dtype=grad.dtype, device=grad.device, generator=generator)
        return self.deviation * noise


class InfAttack(Attack):
    """Submit non-finite values (what a crashed or lossy worker degenerates to)."""

    def apply_local(self, grad, generator):
        return torch.full_like(grad, math.nan)


def _honest_mean(matrix, honest):
    count = torch.clamp(torch.sum(honest), min=1).to(matrix.dtype)
    return torch.sum(torch.where(honest[:, None], matrix, 0.0), dim=0) / count, count


class EmpireAttack(Attack):
    """'Fall of Empires' (Xie et al. 2019): the coalition submits
    -epsilon x mean(honest gradients)."""

    omniscient = True
    ARG_DEFAULTS = {"epsilon": 1.1}

    def __init__(self, nb_workers, nb_byz_workers, args):
        super().__init__(nb_workers, nb_byz_workers, args)
        self.epsilon = self.args["epsilon"]

    def apply_matrix(self, matrix, byz_mask):
        mean, _ = _honest_mean(matrix, ~byz_mask)
        forged = -self.epsilon * mean
        return torch.where(byz_mask[:, None], forged[None, :], matrix)


class LittleAttack(Attack):
    """'A Little Is Enough' (Baruch et al. 2019): the coalition shifts the
    honest mean by z standard deviations per coordinate; ``z`` defaults to
    the paper's quantile formula from (n, f)."""

    omniscient = True
    ARG_DEFAULTS = {"z": 0.0, "negative": True}

    def __init__(self, nb_workers, nb_byz_workers, args):
        super().__init__(nb_workers, nb_byz_workers, args)
        kv = self.args
        if kv["z"] > 0.0:
            self.z = kv["z"]
        else:
            n, f = self.nb_workers, self.nb_byz_workers
            s = n // 2 + 1 - f  # supporters needed for majority
            phi = max(min((n - f - s) / max(n - f, 1), 1.0 - 1e-6), 1e-6)
            # float32, like the JAX package's erfinv
            self.z = math.sqrt(2.0) * float(torch.special.erfinv(torch.tensor(2.0 * phi - 1.0)))
        self.sign = -1.0 if kv["negative"] else 1.0

    def apply_matrix(self, matrix, byz_mask):
        honest = ~byz_mask
        mean, count = _honest_mean(matrix, honest)
        var = torch.sum(torch.where(honest[:, None], (matrix - mean[None, :]) ** 2, 0.0), dim=0) / count
        forged = mean + self.sign * self.z * torch.sqrt(var)
        return torch.where(byz_mask[:, None], forged[None, :], matrix)


register("signflip", SignFlipAttack)
register("zero", ZeroAttack)
register("gaussian", GaussianAttack)
register("inf", InfAttack)
register("empire", EmpireAttack)
register("little", LittleAttack)
