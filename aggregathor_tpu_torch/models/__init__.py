"""Experiments: model + dataset plugins.

Counterpart of ``aggregathor_tpu/models``, with the same functional contract
so the engine can treat both packages alike:

- ``init(seed)``                 -> parameter dict (name -> tensor, torch
                                    layout), made on the CPU from the seed
- ``loss(params, batch)``        -> scalar (one worker's batch)
- ``metrics(params, batch)``     -> dict name -> (sum, count) accumulators
- ``predict_logits(params, x)``  -> (B, classes) logits, the serving path
- ``make_train_iterator(...)``   -> infinite worker-major numpy batch iterator
- ``make_eval_iterator(...)``    -> finite epoch over the held-out split

Images enter the models in the JAX package's NHWC layout.  The registry
imports the experiments this package ports (``cnnet``, ``mnist``,
``digits``, ``digits-conv``, ``mnistAttack``, ``digitsAttack``,
``transformer`` and the zoo's ``slim-<model>-<dataset>``) by name.
"""

import copy
import threading
import weakref

import torch
from torch.func import functional_call

from ..utils import ClassRegister

experiments = ClassRegister("experiment")

#: each thread's copies of the experiments' modules (module -> copy)
_THREAD_MODULES = threading.local()


def thread_module(module):
    """``module`` on the main thread, else this thread's own copy of it:
    ``functional_call`` swaps a module's parameters in place while it runs,
    so threads that run one experiment's loss at once (bounded-wait's
    submissions) must not share the module.  The copy's own parameters are
    never read (the caller's are swapped in)."""
    if threading.current_thread() is threading.main_thread():
        return module
    copies = getattr(_THREAD_MODULES, "copies", None)
    if copies is None:
        copies = _THREAD_MODULES.copies = weakref.WeakKeyDictionary()
    replica = copies.get(module)
    if replica is None:
        replica = copies[module] = copy.deepcopy(module)
    return replica


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
        return functional_call(thread_module(self.model), params, (images,))

    def predict_logits(self, params, x):
        """The serving apply path (JAX ``Experiment.predict_logits``): ``(B,
        *sample_shape)`` NHWC float32 -> ``(B, classes)`` logits, the bare
        model with no training-only head (aux logits, label smoothing and
        weight decay live in ``loss``).  ``serve/engine.py`` calls it once a
        replica and bucket; an experiment whose forward differs overrides it."""
        if getattr(self, "model", None) is None:
            raise NotImplementedError("Experiment %r keeps no .model; override predict_logits()"
                                      % type(self).__name__)
        return self.logits(params, x)

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

    def device_transform(self):
        """The in-step augmentation (``preprocessing.device_transform``) when
        the experiment augments on the device (``self.augment == "device"``,
        the cnnet convention), else None; its host iterator is then
        transform-free and the engine applies this per worker."""
        if getattr(self, "augment", "host") != "device":
            return None
        from .preprocessing import device_transform

        return device_transform(self.preprocessing)

    def train_arrays(self):
        """The train split as ``{"image", "label"}`` arrays for device-side
        sampling (``RobustEngine.build_sampled_multi_step``, the runner's
        ``--input-source device``), when a uniform row gather reproduces the
        host stream: augmentation moved in-step (``augment:device``) or a
        host tier that is the identity.  None otherwise: a stateful host
        transform (augmentation streams, poisoning) must see every batch."""
        augment = getattr(self, "augment", None)
        if augment == "device":
            eligible = True
        elif augment == "host":
            from .preprocessing import PREPROCESSING, none_preprocessing

            eligible = PREPROCESSING.get(getattr(self, "preprocessing", None)) is none_preprocessing
        else:
            eligible = False
        dataset = getattr(self, "dataset", None)
        if not eligible or dataset is None:
            return None
        return {"image": dataset.x_train, "label": dataset.y_train}

    def route_augmentation_to_device(self):
        """Move a host-tier augmentation to its in-step twin
        (``preprocessing.DEVICE_PREPROCESSING``), so device-side sampling can
        serve augmented training too.  True when the experiment now augments
        in-step (or already did); False when it has no augmentation to move
        (a poisoning transform stays on the host).  The augmentation's
        draws change (per-worker numpy streams -> the engine's (seed, step,
        worker) streams): the same distribution, other draws."""
        if getattr(self, "augment", None) == "device":
            return True
        name = getattr(self, "preprocessing", None)
        if getattr(self, "augment", None) != "host" or name is None:
            return False
        from .preprocessing import DEVICE_PREPROCESSING

        if name not in DEVICE_PREPROCESSING:
            return False
        self.augment = "device"
        return True


from . import cnnet, digits, mnist, mnist_attack, transformer, zoo  # noqa: E402,F401  (self-registering experiments)
