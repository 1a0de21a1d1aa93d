"""Train-time input preprocessing (augmentation) registry, host tier.

Copy of the numpy host tier of ``aggregathor_tpu/models/preprocessing.py``
(the in-step device tier is not ported yet): experiments accept
``preprocessing:<name>`` and apply the named augmentation to training
batches only.  Each worker's augmentation stream draws from its own
generator keyed by ``(seed, tag, worker)``, so both packages augment the
same batches identically.

- ``none`` / ``lenet``: identity.
- ``cifarnet``: 4-pixel reflect pad, random crop back to size, random
  horizontal flip.
- ``inception`` / ``vgg``: random horizontal flip.
"""

import numpy as np

from ..utils import UserException


class _PerWorkerRng:
    """Lazy per-worker generators: worker w's stream is f(seed, tag, w) only."""

    def __init__(self, seed, tag):
        self.seed = int(seed)
        self.tag = int(tag)
        self._rngs = {}

    def get(self, worker):
        if worker not in self._rngs:
            self._rngs[worker] = np.random.default_rng([self.seed, self.tag, worker])
        return self._rngs[worker]


def stateless(transform):
    """Declare ``transform`` stateless: its output depends only on its
    inputs (no generator draws, no call-count state), so
    ``WorkerBatchIterator.skip`` advances only the index streams and never
    calls it.  Stateful transforms (the per-worker augmentation streams
    below) must not be marked."""
    transform.stateless = True
    return transform


def none_preprocessing(seed=0):
    return stateless(lambda bx, by: (bx, by))


def cifarnet_preprocessing(seed=0, pad=4):
    rngs = _PerWorkerRng(seed, 0xC1FA)

    def transform(bx, by):
        bx = np.asarray(bx)
        nb_workers, batch, height, width = bx.shape[:4]
        out = np.empty_like(bx)
        for w in range(nb_workers):
            rng = rngs.get(w)
            padded = np.pad(bx[w], ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect")
            ox = rng.integers(0, 2 * pad + 1, size=batch)
            oy = rng.integers(0, 2 * pad + 1, size=batch)
            rows = ox[:, None, None] + np.arange(height)[None, :, None]
            cols = oy[:, None, None] + np.arange(width)[None, None, :]
            images = padded[np.arange(batch)[:, None, None], rows, cols, :]
            mask = rng.random(batch) < 0.5
            images[mask] = images[mask, :, ::-1]
            out[w] = images
        return out, by

    return transform


def flip_preprocessing(seed=0):
    rngs = _PerWorkerRng(seed, 0xF11B)

    def transform(bx, by):
        bx = np.asarray(bx)
        for w in range(bx.shape[0]):
            mask = rngs.get(w).random(bx.shape[1]) < 0.5
            bx[w, mask] = bx[w, mask][:, :, ::-1]
        return bx, by

    return transform


PREPROCESSING = {
    "none": none_preprocessing,
    "cifarnet": cifarnet_preprocessing,
    "inception": flip_preprocessing,
    "vgg": flip_preprocessing,
    "lenet": none_preprocessing,
}


def check(name):
    """Validate a preprocessing name at arg-parse time (fail fast)."""
    if name not in PREPROCESSING:
        raise UserException(
            "Unknown preprocessing %r (accepted: %s)" % (name, ", ".join(sorted(PREPROCESSING)))
        )
    return name


def instantiate(name, seed=0):
    return PREPROCESSING[check(name)](seed)
