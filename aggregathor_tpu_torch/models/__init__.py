"""Experiments: model + dataset plugins.

Counterpart of ``aggregathor_tpu/models``, with the same functional contract
so the engine can treat both packages alike:

- ``init(seed)``                 -> parameter dict (name -> tensor, torch
                                    layout), made on the CPU from the seed
- ``loss(params, batch)``        -> scalar (one worker's batch)
- ``metrics(params, batch)``     -> dict name -> (sum, count) accumulators
- ``make_train_iterator(...)``   -> infinite worker-major numpy batch iterator
- ``make_eval_iterator(...)``    -> finite epoch over the held-out split

Images enter the models in the JAX package's NHWC layout.  The registry
imports the experiments this package ports (``cnnet``, ``mnist``,
``digits``, ``digits-conv``, ``mnistAttack``, ``digitsAttack``) by name.
"""

import torch
from torch.func import functional_call

from ..utils import ClassRegister

experiments = ClassRegister("experiment")


def register(name, cls):
    return experiments.register(name, cls)


def itemize():
    return experiments.itemize()


def get(name):
    """The experiment class registered under ``name`` (not instantiated)."""
    return experiments.get(name)


def instantiate(name, args=None):
    """Build the experiment registered under ``name`` from key:value args."""
    return experiments.get(name)(args or [])


class Experiment:
    """Base experiment around one ``nn.Module`` (``self.model``) whose
    parameters the caller owns: ``loss`` and ``metrics`` run the module
    functionally on the given parameter dict."""

    def __init__(self, args):
        self.args = args

    def init(self, seed):
        """A fresh parameter dict from ``seed`` (CPU tensors, float32)."""
        from .common import init_params

        return init_params(self.model, torch.Generator().manual_seed(int(seed)))

    def logits(self, params, images):
        return functional_call(self.model, params, (images,))

    def loss(self, params, batch):
        logits = self.logits(params, batch["image"])
        return torch.nn.functional.cross_entropy(logits, batch["label"].long())

    def metrics(self, params, batch):
        logits = self.logits(params, batch["image"])
        hit = (torch.argmax(logits, dim=-1) == batch["label"]).to(torch.float32)
        valid = batch.get("valid")
        if valid is not None:
            valid = valid.to(torch.float32)
            return {"accuracy": (torch.sum(hit * valid), torch.sum(valid))}
        return {"accuracy": (torch.sum(hit), torch.full((), float(hit.shape[0]), device=hit.device))}

    def make_train_iterator(self, nb_workers, seed=0):
        raise NotImplementedError

    def make_eval_iterator(self, nb_workers):
        raise NotImplementedError


from . import cnnet, digits, mnist, mnist_attack  # noqa: E402,F401  (self-registering experiments)
