"""Input pipelines: real data when present, deterministic synthetic otherwise.

Copies of the numpy loaders of ``aggregathor_tpu/models/datasets.py`` (the
npz, sklearn-digits and synthetic branches; the CIFAR-10 TFRecord reader is
not ported yet), so both packages see the same batches, bit for bit, with
``WorkerBatchIterator.next_many`` (k batches as one chunk) and the
``DevicePrefetcher`` thread.  The JAX package's chunk pipeline (sharded
gather into ping-pong buffers, sliced transfers) is not ported yet.  Each
loader first looks for a local ``.npz`` file (search order: the
``AGGREGATHOR_DATA`` env dir, ``~/.aggregathor/data``, ``./data``) and
otherwise derives a deterministic synthetic stand-in: class-conditional
Gaussians around fixed random templates, flagged by ``.synthetic``.  The
digits loader tries scikit-learn's bundled corpus between the two.

File formats accepted: ``mnist.npz`` / ``cifar10.npz`` / ``digits.npz`` with
x_train/y_train/x_test/y_test (the keras layout).  The port ships the real
digits corpus as ``DIGITS_DIR/digits.npz`` (already shuffled and split as
``load_digits8x8`` does, pixels as uint8 0..16); point ``AGGREGATHOR_DATA``
at ``DIGITS_DIR`` to read it where scikit-learn is not installed.
"""

import os

import numpy as np

from ..utils import UserException, info, warning

#: the directory of the port's own copy of the digits corpus (``digits.npz``)
DIGITS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def transform_is_stateless(transform):
    """True when ``transform`` declared itself stateless (``.stateless``,
    see ``preprocessing.stateless``): its output depends only on its
    inputs, so skipping batches never needs to call it."""
    return transform is None or bool(getattr(transform, "stateless", False))


def _data_dirs():
    dirs = []
    env = os.environ.get("AGGREGATHOR_DATA")
    if env:
        dirs.append(env)
    dirs.append(os.path.expanduser("~/.aggregathor/data"))
    dirs.append(os.path.join(os.getcwd(), "data"))
    return dirs


def _find_npz(basename, subdirs=None):
    """Probe <data>/<basename> plus <data>/<subdir>/<basename> for each
    candidate subdir (default: the basename's stem)."""
    stem = basename.split(".")[0]
    subdirs = (stem,) if subdirs is None else tuple(subdirs)
    for dirname in _data_dirs():
        for path in [os.path.join(dirname, basename)] + [
            os.path.join(dirname, sub, basename) for sub in subdirs
        ]:
            if os.path.isfile(path):
                return path
    return None


class ArrayDataset:
    """An in-memory labeled dataset split into train/test."""

    def __init__(self, x_train, y_train, x_test, y_test, nb_classes, synthetic):
        self.x_train = x_train
        self.y_train = y_train
        self.x_test = x_test
        self.y_test = y_test
        self.nb_classes = nb_classes
        self.synthetic = synthetic


def _synthetic_classification(name, shape, nb_classes, nb_train, nb_test, seed, separation=2.0):
    """Class-conditional Gaussians around fixed random unit templates."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(nb_classes,) + shape).astype(np.float32)
    templates /= np.linalg.norm(templates.reshape(nb_classes, -1), axis=1).reshape((-1,) + (1,) * len(shape))

    def make(count, split_seed):
        r = np.random.default_rng(split_seed)
        labels = r.integers(0, nb_classes, size=count)
        noise = r.normal(size=(count,) + shape).astype(np.float32)
        images = separation * templates[labels] + noise
        return images.astype(np.float32), labels.astype(np.int32)

    x_train, y_train = make(nb_train, seed + 1)
    x_test, y_test = make(nb_test, seed + 2)
    warning(
        "Dataset %r not found on disk; using a deterministic synthetic stand-in "
        "(drop an %s.npz under $AGGREGATHOR_DATA to use real data)" % (name, name)
    )
    return ArrayDataset(x_train, y_train, x_test, y_test, nb_classes, synthetic=True)


def _head_size(requested, y_train, y_test, name):
    """Class count for the model head: covers both the requested class count
    and every label actually observed (train and test)."""
    seen = max(
        [int(np.max(y)) + 1 for y in (y_train, y_test) if np.size(y)] or [1]
    )
    if requested and seen < requested:
        warning(
            "%s labels only cover %d of the requested %d classes; keeping the "
            "%d-way head (subset accuracy is not full-dataset accuracy)"
            % (name, seen, requested, requested)
        )
    return max(int(requested or 0), seen)


def _load_npz(path, shape, scale, nb_classes=None):
    import zipfile

    try:
        data = np.load(path)
    except (OSError, ValueError, zipfile.BadZipFile) as exc:
        raise UserException("Cannot load dataset %r: %s" % (path, exc))

    def prep(x):
        x = x.astype(np.float32) / scale
        return x.reshape((x.shape[0],) + shape)

    info("Loaded dataset from %s" % path)
    y_train = data["y_train"].astype(np.int32).ravel()
    y_test = data["y_test"].astype(np.int32).ravel()
    return ArrayDataset(
        prep(data["x_train"]), y_train, prep(data["x_test"]), y_test,
        nb_classes=_head_size(nb_classes, y_train, y_test, os.path.basename(path)),
        synthetic=False,
    )


def load_mnist():
    """28x28x1 digits in [0, 1]; real file or synthetic stand-in."""
    path = _find_npz("mnist.npz")
    if path:
        return _load_npz(path, (28, 28, 1), 255.0, nb_classes=10)
    return _synthetic_classification("mnist", (28, 28, 1), 10, nb_train=8192, nb_test=2048, seed=7)


def load_cifar10():
    """32x32x3 images in [0, 1]; a cifar10.npz or the synthetic stand-in."""
    path = _find_npz("cifar10.npz")
    if path:
        return _load_npz(path, (32, 32, 3), 255.0, nb_classes=10)
    return _synthetic_classification("cifar10", (32, 32, 3), 10, nb_train=8192, nb_test=2048, seed=11)


def load_digits8x8(train_fraction=0.8, seed=11):
    """The real UCI hand-written digits (1797 8x8 grayscale images, 10
    classes) in [0, 1], after a seeded shuffle and an 80/20 split.
    Resolution order: a ``digits.npz`` on the data path, then the corpus
    bundled in scikit-learn (imported here, lazily), then a synthetic
    stand-in of the same size flagged ``.synthetic``."""
    path = _find_npz("digits.npz")
    if path:
        return _load_npz(path, (8, 8, 1), 16.0, nb_classes=10)
    nb_train = int(1797 * train_fraction)
    try:
        from sklearn.datasets import load_digits as _sk_load_digits
    except ImportError:
        return _synthetic_classification(
            "digits", (8, 8, 1), 10, nb_train=nb_train, nb_test=1797 - nb_train, seed=seed)
    bunch = _sk_load_digits()
    images = (bunch.images.astype(np.float32) / 16.0).reshape(-1, 8, 8, 1)
    labels = bunch.target.astype(np.int32)
    order = np.random.default_rng(seed).permutation(len(labels))
    images, labels = images[order], labels[order]
    split = int(len(labels) * train_fraction)
    info("Loaded REAL sklearn digits: %d train / %d test" % (split, len(labels) - split))
    return ArrayDataset(
        images[:split], labels[:split], images[split:], labels[split:],
        nb_classes=10, synthetic=False,
    )


def load_digits_upscaled(size=32, train_fraction=0.8, seed=11):
    """The digits corpus upscaled to ``size`` x ``size`` by repeating each
    pixel (an integer factor): the conv stack's input on real data."""
    base = load_digits8x8(train_fraction=train_fraction, seed=seed)
    if size % 8:
        raise ValueError("size must be a multiple of 8 (got %d)" % size)
    k = size // 8

    def up(x):
        return np.repeat(np.repeat(x, k, axis=1), k, axis=2)

    return ArrayDataset(
        up(base.x_train), base.y_train, up(base.x_test), base.y_test,
        nb_classes=base.nb_classes, synthetic=base.synthetic,
    )


class WorkerBatchIterator:
    """Infinite iterator of worker-major numpy batches [n_workers, batch, ...].

    Worker w's sample stream is ``default_rng([seed, w])`` alone,
    independent of nb_workers and of the other workers."""

    def __init__(self, x, y, nb_workers, batch_size, seed=0, transform=None):
        self.x, self.y = x, y
        self.nb_workers = nb_workers
        self.batch_size = batch_size
        self.rngs = [np.random.default_rng([seed, w]) for w in range(nb_workers)]
        self.transform = transform

    def __iter__(self):
        return self

    def _draw_indices(self):
        """The (nb_workers, batch) indices of the next batch; ``skip``
        draws through here too, so both advance the streams alike."""
        idx = np.empty((self.nb_workers, self.batch_size), dtype=np.int64)
        for w, rng in enumerate(self.rngs):
            idx[w] = rng.integers(0, self.x.shape[0], size=self.batch_size)
        return idx

    def __next__(self):
        flat = self._draw_indices().reshape(-1)
        bx = self.x[flat].reshape((self.nb_workers, self.batch_size) + self.x.shape[1:])
        by = self.y[flat].reshape(self.nb_workers, self.batch_size)
        if self.transform is not None:
            bx, by = self.transform(bx, by)
        return {"image": bx, "label": by}

    def next_many(self, k):
        """``k`` successive batches as one (k, nb_workers, batch, ...) chunk,
        bit-identical to ``k`` calls of ``next`` (and advancing the streams
        alike).  A stateful transform sees every batch in order; otherwise the
        chunk is one gather and a stateless transform runs on each step."""
        k = int(k)
        if not transform_is_stateless(self.transform):
            batches = [next(self) for _ in range(k)]
            return {name: np.stack([batch[name] for batch in batches]) for name in batches[0]}
        flat = np.stack([self._draw_indices() for _ in range(k)]).reshape(-1)
        bx = self.x[flat].reshape((k, self.nb_workers, self.batch_size) + self.x.shape[1:])
        by = self.y[flat].reshape(k, self.nb_workers, self.batch_size)
        if self.transform is not None:
            steps = [self.transform(bx[step], by[step]) for step in range(k)]
            bx, by = np.stack([x for x, _ in steps]), np.stack([y for _, y in steps])
        return {"image": bx, "label": by}

    def skip(self, k):
        """Advance every stream by ``k`` batches: the resume fast-forward,
        after which the next batch is the one an uninterrupted run would
        draw.  A stateful transform (per-worker augmentation streams) must
        advance in step, so it takes the full path; under a stateless one
        only the index streams advance."""
        if not transform_is_stateless(self.transform):
            for _ in range(int(k)):
                next(self)
            return
        for _ in range(int(k)):
            self._draw_indices()


def eval_batches(x, y, nb_workers, batch_size):
    """Finite worker-major pass over an eval split (pads by wrapping; the
    wrapped duplicates are marked invalid so metric counts stay exact)."""
    per_step = nb_workers * batch_size
    total = x.shape[0]
    for start in range(0, total, per_step):
        idx = np.arange(start, start + per_step) % total
        valid = (np.arange(start, start + per_step) < total)
        bx = x[idx].reshape((nb_workers, batch_size) + x.shape[1:])
        by = y[idx].reshape(nb_workers, batch_size)
        yield {"image": bx, "label": by, "valid": valid.reshape(nb_workers, batch_size)}


class _PrefetchError:
    def __init__(self, exc):
        self.exc = exc


class DevicePrefetcher:
    """A daemon thread that keeps up to ``depth`` device batches ready:
    it pulls host batches from ``iterator`` and applies ``put`` (for example
    ``RobustEngine.put_batch``), overlapping batch production and the
    transfer with the step.  JAX ``datasets.py:541-622``.

    On a CUDA ``device`` the thread runs ``put`` on a side stream of its own
    (the engine copies from pinned memory there) and records an event after
    it; the consumer's stream waits on that event before the step reads the
    batch, and each tensor is recorded on the consumer's stream, so the
    caching allocator does not hand its memory to the side stream while the
    step still reads it.  A producer error surfaces on the consumer side;
    ``close()`` stops the thread and joins it.
    """

    def __init__(self, iterator, put, depth=2, device=None):
        import queue
        import threading

        import torch

        self._queue = queue.Queue(maxsize=max(1, int(depth)))
        self._iterator = iterator
        self._put = put
        self._device = torch.device(device) if device is not None else None
        self._stream = None
        if self._device is not None and self._device.type == "cuda":
            if self._device.index is None:
                self._device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self._device)
        self._stop = threading.Event()
        self._terminal = None  # remembered end of stream / producer error
        self._thread = threading.Thread(target=self._run, daemon=True, name="prefetch")
        self._thread.start()

    def _run(self):
        import torch

        try:
            if self._stream is not None:
                torch.cuda.set_device(self._device)
            for batch in self._iterator:
                if self._stop.is_set():
                    return
                event = None
                if self._stream is None:
                    device_batch = self._put(batch)
                else:
                    with torch.cuda.stream(self._stream):
                        device_batch = self._put(batch)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                if self._stop.is_set():
                    return
                self._queue.put((device_batch, event))
            self._queue.put(_PrefetchError(StopIteration()))
        except BaseException as exc:  # surfaced on the consumer side
            self._queue.put(_PrefetchError(exc))

    def __iter__(self):
        return self

    def __next__(self):
        import torch

        if self._terminal is not None:  # iterator protocol: stay terminal
            raise self._terminal
        item = self._queue.get()
        if isinstance(item, _PrefetchError):
            self._terminal = item.exc
            raise item.exc
        device_batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for tensor in device_batch.values():
                tensor.record_stream(consumer)
        return device_batch

    def close(self):
        """Stop the thread and join it; no batch stays queued afterwards.
        The queue is drained while the producer winds down (it may finish
        one last ``put``); a producer stuck inside the wrapped iterator is a
        daemon and dies with the process."""
        import queue
        import time

        self._stop.set()
        self._terminal = StopIteration()
        deadline = time.monotonic() + 5.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
