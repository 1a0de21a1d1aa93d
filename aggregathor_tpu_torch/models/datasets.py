"""Input pipelines: real data when present, deterministic synthetic otherwise.

Copies of the numpy loaders of ``aggregathor_tpu/models/datasets.py`` (the
npz, sklearn-digits and synthetic branches; the CIFAR-10 TFRecord reader is
not ported yet), so both packages see the same batches, bit for bit, with
``WorkerBatchIterator.next_many`` (k batches as one chunk, gathered into a
caller's buffer with ``out=``), the ``DevicePrefetcher`` thread and the
``ChunkPipeline`` of the ``--unroll`` path (a gather sharded over a small
thread pool into two ping-pong buffers, pinned on CUDA, and sliced
transfers assembled on the card).  Each loader first looks for a local
``.npz`` file (search order: the ``AGGREGATHOR_DATA`` env dir,
``~/.aggregathor/data``, ``./data``) and otherwise derives a deterministic
synthetic stand-in: class-conditional
Gaussians around fixed random templates, flagged by ``.synthetic``.  The
digits loader tries scikit-learn's bundled corpus between the two.

File formats accepted: ``mnist.npz`` / ``cifar10.npz`` / ``digits.npz`` with
x_train/y_train/x_test/y_test (the keras layout).  The port ships the real
digits corpus as ``DIGITS_DIR/digits.npz`` (already shuffled and split as
``load_digits8x8`` does, pixels as uint8 0..16); point ``AGGREGATHOR_DATA``
at ``DIGITS_DIR`` to read it where scikit-learn is not installed.
"""

import os
import threading

import numpy as np

from ..utils import UserException, info, warning

#: the directory of the port's own copy of the digits corpus (``digits.npz``)
DIGITS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

# Sharded host gather (JAX ``datasets.py:29-106``): the fancy-index gather of
# ``WorkerBatchIterator.next_many`` split into contiguous row ranges written
# concurrently by ``np.take(..., out=...)``, into the caller's buffer.

#: rows below this skip the pool (thread dispatch costs more than the copy)
_GATHER_POOL_MIN_ROWS = 4096

_gather_pool = None
_gather_pool_lock = threading.Lock()


def gather_threads():
    """Worker count of the sharded gather pool: ``AGGREGATHOR_GATHER_THREADS``
    or min(4, cpu_count).  0/1 disables the pool (one single-shot gather)."""
    env = os.environ.get("AGGREGATHOR_GATHER_THREADS")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            raise UserException("AGGREGATHOR_GATHER_THREADS must be an integer (got %r)" % env)
    return min(4, os.cpu_count() or 1)


def _pool():
    global _gather_pool
    if _gather_pool is None:
        with _gather_pool_lock:
            if _gather_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                _gather_pool = ThreadPoolExecutor(max_workers=gather_threads(), thread_name_prefix="gather")
    return _gather_pool


def sharded_take(src, indices, out):
    """``out[:] = src[indices]`` with the row copies sharded over the gather
    pool: bit-identical to the fancy index (``np.take`` writes the same rows;
    the shards are disjoint contiguous ranges of ``out``).  One single-shot
    ``np.take`` for small gathers or when the pool is disabled."""
    nb = gather_threads()
    rows = indices.shape[0]
    if nb <= 1 or rows < _GATHER_POOL_MIN_ROWS:
        np.take(src, indices, axis=0, out=out)
        return out
    bounds = np.linspace(0, rows, nb + 1).astype(np.int64)
    futures = [
        _pool().submit(np.take, src, indices[lo:hi], 0, out[lo:hi])
        for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo
    ]
    for future in futures:
        future.result()  # re-raises a shard's failure
    return out


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

    def alloc_chunk(self, k, pin_memory=False):
        """A preallocated (k, nb_workers, batch, ...) chunk for
        ``next_many(k, out=...)``: the ping-pong buffers of the input
        pipeline are two of these.  With ``pin_memory`` (the pipeline on
        CUDA) the arrays are numpy views of page-locked tensors (each view's
        ``base`` keeps its tensor alive), so the gather writes straight into
        memory the card's copy engine reads, with no second host copy."""
        k = int(k)
        shapes = {"image": ((k, self.nb_workers, self.batch_size) + self.x.shape[1:], self.x.dtype),
                  "label": ((k, self.nb_workers, self.batch_size), self.y.dtype)}
        if not pin_memory:
            return {name: np.empty(shape, dtype) for name, (shape, dtype) in shapes.items()}
        import torch

        return {name: torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype, pin_memory=True).numpy()
                for name, (shape, dtype) in shapes.items()}

    def next_many(self, k, out=None):
        """``k`` successive batches as one (k, nb_workers, batch, ...) chunk,
        bit-identical to ``k`` calls of ``next`` (and advancing the streams
        alike).  A stateful transform sees every batch in order (the
        sequential path); otherwise the chunk is one gather sharded over the
        gather pool (``sharded_take``) and a stateless transform runs on each
        step.  With ``out`` (an ``alloc_chunk(k)`` buffer) the chunk refills
        that buffer, which is returned; without, a fresh chunk."""
        k = int(k)
        if not transform_is_stateless(self.transform):
            batches = [next(self) for _ in range(k)]
            stack = {name: np.stack([batch[name] for batch in batches]) for name in batches[0]}
            if out is None:
                return stack
            for name, value in stack.items():
                out[name][...] = value
            return out
        flat = np.stack([self._draw_indices() for _ in range(k)]).reshape(-1)
        if out is None:
            out = self.alloc_chunk(k)
        sharded_take(self.x, flat, out["image"].reshape((-1,) + self.x.shape[1:]))
        sharded_take(self.y, flat, out["label"].reshape(-1))
        if self.transform is not None:
            # stateless: one step at a time equals the sequential path
            for step in range(k):
                image, label = out["image"][step], out["label"][step]
                bx, by = self.transform(image, label)
                if bx is not image:
                    image[...] = bx
                if by is not label:
                    label[...] = by
        return out

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


def split_chunk(chunk, nb_slices):
    """Split a (K, ...) host chunk into ``nb_slices`` contiguous step-axis
    slices (views, no copy), on ``np.array_split``'s boundaries, so the
    slices' shapes are a function of (K, nb_slices) alone."""
    leaves = list(chunk.values())
    k = leaves[0].shape[0]
    nb_slices = max(1, min(int(nb_slices), k))
    bounds = [k * i // nb_slices for i in range(nb_slices + 1)]
    return [
        {name: value[lo:hi] for name, value in chunk.items()}
        for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo
    ]


class _NullCounter:
    value = 0.0

    def inc(self, amount=1.0):
        pass


class ChunkPipeline:
    """Three-stage pipelined host-to-device input of the unrolled trainer
    (JAX ``datasets.py:640-836``), in place of the whole-chunk
    ``DevicePrefetcher``:

    1. **sharded gather**: ``iterator.next_many(unroll, out=...)`` refills
       one of two preallocated ping-pong host buffers, the row copies
       sharded over the gather pool (``sharded_take``); on CUDA the buffers
       are pinned (``alloc_chunk(pin_memory=True)``), so no second host copy
       is made before the transfer;
    2. **sliced transfer**: the chunk is split into ``slices`` step-axis
       slices (``split_chunk``), each transferred as soon as it is issued
       (``put`` = ``RobustEngine.put_batches``);
    3. **assembly**: ``assemble`` (``RobustEngine.assemble_batches``) joins
       the slices into the one (K, n, ...) chunk ``build_multi_step``
       consumes, a fresh buffer on the device.

    On a CUDA ``device`` the transfers and the assembly run on a side stream
    of the pipeline's own, and an event is recorded after the assembly.
    Aliasing: buffer ``i % 2`` is gathered again for chunk ``i + 2`` only
    after chunk ``i``'s event has completed (its copies have read the
    buffer); the consumer's stream waits on the event before the step reads
    the chunk, and each tensor is recorded on the consumer's stream, as
    ``DevicePrefetcher`` does.

    The producer is finite (``nb_chunks``): it shares ``iterator`` with the
    caller's per-step tail, so it draws exactly the chunks the loop consumes
    and exits; after exhaustion or ``close()`` the iterator is the caller's
    again.  A producer error surfaces on the consumer side.  With a
    ``registry`` (``obs/metrics.py``) it exports ``input_gather_seconds_total``
    and ``input_put_seconds_total`` (the producer's busy time; on CUDA the put
    is the host's time issuing the copies and the assembly),
    ``input_wait_seconds_total`` (the consumer blocked in ``__next__``),
    ``input_chunks_total``, a live ``input_queue_depth`` and the derived
    ``input_overlap_fraction`` (1 - wait/busy); the producer's stages emit
    ``input.gather`` / ``input.put`` trace spans.
    """

    def __init__(self, iterator, unroll, nb_chunks, put, assemble, depth=2, slices=4, registry=None,
                 device=None):
        import queue

        import torch

        self._iterator = iterator
        self._unroll = int(unroll)
        self._nb_chunks = int(nb_chunks)
        self._put = put
        self._assemble = assemble
        self._slices = max(1, int(slices))
        self._queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._terminal = None
        self._device = torch.device(device) if device is not None else None
        self._stream = None
        if self._device is not None and self._device.type == "cuda":
            if self._device.index is None:
                self._device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self._device)
        self._buffers = [None, None]  # ping-pong host chunks
        self._retire = [None, None]   # per buffer: the event after its chunk's assembly (CUDA)
        self._wait_s = 0.0
        self._gauge_depth = None
        if registry is not None:
            self._c_gather = registry.counter("input_gather_seconds_total", "Producer time in the sharded host gather")
            self._c_put = registry.counter("input_put_seconds_total",
                                           "Producer time issuing slice transfers + assemble")
            self._c_wait = registry.counter("input_wait_seconds_total",
                                            "Consumer time blocked waiting for an input chunk")
            self._c_chunks = registry.counter("input_chunks_total", "Chunks produced by the input pipeline")
            self._gauge_depth = registry.gauge("input_queue_depth", "Device-ready input chunks queued")
            self._gauge_depth.set_function(self._queue.qsize)
            gather, put_c, wait = self._c_gather, self._c_put, self._c_wait

            def overlap_fraction():
                busy = gather.value + put_c.value
                if busy <= 0.0:
                    return 0.0
                return max(0.0, min(1.0, 1.0 - wait.value / busy))

            registry.gauge(
                "input_overlap_fraction",
                "Fraction of input-pipeline work hidden under device compute (1 - wait/busy)",
            ).set_function(overlap_fraction)
        else:
            self._c_gather = self._c_put = self._c_wait = self._c_chunks = _NullCounter()
        self._thread = threading.Thread(target=self._run, daemon=True, name="input-pipeline")
        self._thread.start()

    # producer ---------------------------------------------------------- #

    def _transfer(self, host):
        """The slices' transfers and their assembly; on CUDA on the side
        stream, returning the event recorded after them (else None)."""
        import torch

        if self._stream is None:
            return self._assemble([self._put(part) for part in split_chunk(host, self._slices)]), None
        with torch.cuda.stream(self._stream):
            device_chunk = self._assemble([self._put(part) for part in split_chunk(host, self._slices)])
            event = torch.cuda.Event()
            event.record(self._stream)
        return device_chunk, event

    def _run(self):
        import time

        import torch

        from ..obs import trace

        try:
            if self._stream is not None:
                torch.cuda.set_device(self._device)
            for index in range(self._nb_chunks):
                if self._stop.is_set():
                    return
                slot = index % 2
                if self._retire[slot] is not None:
                    # aliasing: chunk index - 2's copies must have read this
                    # buffer before it is gathered again
                    self._retire[slot].synchronize()
                if self._buffers[slot] is None and self._stream is not None and hasattr(self._iterator, "alloc_chunk"):
                    self._buffers[slot] = self._iterator.alloc_chunk(self._unroll, pin_memory=True)
                t0 = time.perf_counter()
                with trace.span("input.gather", cat="input"):
                    host = self._iterator.next_many(self._unroll, out=self._buffers[slot])
                self._buffers[slot] = host
                self._c_gather.inc(time.perf_counter() - t0)
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                with trace.span("input.put", cat="input"):
                    device_chunk, event = self._transfer(host)
                self._c_put.inc(time.perf_counter() - t0)
                self._retire[slot] = event
                self._c_chunks.inc()
                self._queue.put((device_chunk, event))
            self._queue.put(_PrefetchError(StopIteration()))
        except BaseException as exc:  # surfaced on the consumer side
            self._queue.put(_PrefetchError(exc))

    # consumer ---------------------------------------------------------- #

    def __iter__(self):
        return self

    def __next__(self):
        import time

        import torch

        if self._terminal is not None:  # iterator protocol: stay terminal
            raise self._terminal
        t0 = time.perf_counter()
        item = self._queue.get()
        waited = time.perf_counter() - t0
        self._c_wait.inc(waited)
        self._wait_s += waited
        if isinstance(item, _PrefetchError):
            self._terminal = item.exc
            raise item.exc
        device_chunk, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for tensor in device_chunk.values():
                tensor.record_stream(consumer)
        return device_chunk

    @property
    def wait_seconds(self):
        """Time this consumer spent blocked in ``__next__`` (the registry
        counter is cumulative over the process's pipelines)."""
        return self._wait_s

    def close(self):
        """Stop and join the producer; afterwards the shared ``iterator`` is
        the caller's alone.  The drain-and-join of ``DevicePrefetcher.close``
        (bounded at 5 s); the copies still reading a buffer are waited for
        before the buffers are dropped.  Idempotent."""
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
        if self._gauge_depth is not None:
            self._gauge_depth.set(0.0)  # drop the qsize closure pinning us
            self._gauge_depth = None
        for event in self._retire:
            if event is not None:
                event.synchronize()
        self._buffers = [None, None]
        self._retire = [None, None]
