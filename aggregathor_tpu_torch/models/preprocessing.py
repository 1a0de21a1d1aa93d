"""Train-time input preprocessing (augmentation) registry: host and device tiers.

Counterpart of ``aggregathor_tpu/models/preprocessing.py``: experiments
accept ``preprocessing:<name>`` and apply the named augmentation to
training batches only.

The host tier is a copy of the JAX package's numpy tier: each worker's
augmentation stream draws from its own generator keyed by ``(seed, tag,
worker)``, so both packages augment the same batches identically.

The device tier (``device_transform``) is the same augmentation on tensors,
run inside the engine's step (``RobustEngine(batch_transform=...)``), so the
host input path is a plain gather.  Each transform is split in two: a
``draw`` of its random choices for one worker's batch from an explicit
``torch.Generator`` (the engine's (seed, step, worker, 3) stream), and an
``apply`` of drawn choices, which is pure data movement and equals the JAX
transform bit for bit given the same offsets and flips.

- ``none`` / ``lenet``: identity.
- ``cifarnet``: 4-pixel reflect pad, random crop back to size, random
  horizontal flip.
- ``inception`` / ``vgg``: random horizontal flip.
"""

import numpy as np
import torch

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


# --------------------------------------------------------------------- #
# Device tier


def _reflect(index, size):
    """``jnp.pad(mode="reflect")``'s source index of padded position
    ``index`` (already shifted by the pad): the edge is not repeated."""
    index = torch.where(index < 0, -index, index)
    return torch.where(index > size - 1, 2 * (size - 1) - index, index)


class DeviceCifarnet:
    """cifarnet on tensors: ``pad``-pixel reflect pad, a random crop back to
    size, a random width flip (JAX ``_device_cifarnet``).  The draw per image:
    the crop's (row, column) offset in [0, 2 pad] and a flip at p = 0.5."""

    def __init__(self, pad=4):
        self.pad = int(pad)

    def draw(self, batch_size, generator):
        offsets = torch.randint(0, 2 * self.pad + 1, (batch_size, 2), generator=generator)
        flips = torch.rand(batch_size, generator=generator) < 0.5
        return {"offsets": offsets, "flips": flips}

    def apply(self, images, offsets, flips):
        """``images`` (..., H, W, C) NHWC, ``offsets`` (..., 2), ``flips`` (...,):
        each image cropped from its reflect-padded self, then flipped along
        its width where drawn, as one gather (no padded copy is made)."""
        height, width = images.shape[-3], images.shape[-2]
        flat = images.reshape((-1,) + tuple(images.shape[-3:]))
        offsets = offsets.reshape(-1, 2).to(images.device)
        flips = flips.reshape(-1).to(images.device)
        rows = torch.arange(height, device=images.device)
        cols = torch.arange(width, device=images.device)
        # output column j reads crop column W-1-j where flipped
        cols = torch.where(flips[:, None], width - 1 - cols[None, :], cols[None, :])
        src_rows = _reflect(offsets[:, :1] - self.pad + rows[None, :], height)
        src_cols = _reflect(offsets[:, 1:] - self.pad + cols, width)
        picked = flat[torch.arange(flat.shape[0], device=images.device)[:, None, None],
                      src_rows[:, :, None], src_cols[:, None, :]]
        return picked.reshape(images.shape)

    def __call__(self, batch, draws):
        return dict(batch, image=self.apply(batch["image"], **draws))


class DeviceFlip:
    """A random width flip at p = 0.5 on tensors (JAX ``_device_flip``)."""

    def draw(self, batch_size, generator):
        return {"flips": torch.rand(batch_size, generator=generator) < 0.5}

    def apply(self, images, flips):
        """``images`` (..., H, W, C), ``flips`` (...,)."""
        flips = flips.to(images.device).reshape(flips.shape + (1, 1, 1))
        return torch.where(flips, images.flip(-2), images)

    def __call__(self, batch, draws):
        return dict(batch, image=self.apply(batch["image"], **draws))


DEVICE_PREPROCESSING = {
    "none": lambda: None,
    "lenet": lambda: None,
    "cifarnet": DeviceCifarnet,
    "inception": DeviceFlip,
    "vgg": DeviceFlip,
}


def device_transform(name):
    """The in-step transform for ``name`` (None when it is the identity)."""
    if name not in DEVICE_PREPROCESSING:
        raise UserException(
            "Unknown preprocessing %r (accepted: %s)" % (name, ", ".join(sorted(DEVICE_PREPROCESSING)))
        )
    return DEVICE_PREPROCESSING[name]()


def check(name):
    """Validate a preprocessing name at arg-parse time (fail fast)."""
    if name not in PREPROCESSING:
        raise UserException(
            "Unknown preprocessing %r (accepted: %s)" % (name, ", ".join(sorted(PREPROCESSING)))
        )
    return name


def instantiate(name, seed=0):
    return PREPROCESSING[check(name)](seed)
