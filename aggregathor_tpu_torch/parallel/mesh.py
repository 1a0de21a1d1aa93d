"""The worker axis over ``torch.distributed``.

Counterpart of ``aggregathor_tpu/parallel/mesh.py``.  The JAX package lays
its n logical workers over a ``worker`` mesh axis of W devices, k = n/W
workers a device, and the flat engine's collectives run over that axis
(``parallel/engine.py:1-31``).  Here the axis is W processes, one rank a
device, joined in one ``torch.distributed`` process group:
:class:`WorkerAxis` holds the axis size W, this process's rank, k, the
group, its backend and the device, and the four collectives the engine
uses: ``all_to_all`` (``all_to_all_single``), ``all_reduce_sum``,
``all_gather`` and ``broadcast``.  At W = 1 there is no group, and no
collective is ever called: the engine guards each one by ``size > 1``, as
the JAX engine guards each by ``nb_devices > 1``.

The backend is chosen explicitly and logged, never swapped after a
failure: NCCL when every rank owns its own card, gloo on the CPU.  Under
gloo a CUDA tensor crosses through an explicit pinned host copy (copied
out, the collective on the copy, copied back): a staging of bytes, not a
move of the work, which stays on the card.  W ranks on CUDA need W cards
(JAX ``mesh.py:41-48`` refuses a mesh larger than the devices) unless the
caller asks for a shared-card gloo axis (``shared_card=True``), which
only a test harness does: NCCL refuses two ranks on one card.

bfloat16 and bool tensors cross the data-moving collectives as their bytes
(gloo moves no 16-bit integer type).
Each collective adds its wall time (staging included, and the wait for the
slowest rank) and the bytes it sends to ``stats``.
"""

import datetime
import os
import socket
import time

import torch
import torch.distributed as dist

from ..utils import UserException, info, resolve_device

#: dtypes the data-moving collectives send as their bytes
BYTE_VIEWED = (torch.bfloat16, torch.bool)

#: rendezvous and collective timeout of a process group (seconds)
DEFAULT_TIMEOUT = 300.0


def free_port(host="127.0.0.1"):
    """A TCP port on ``host`` that was free a moment ago (the rendezvous's)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind((host, 0))
        return sock.getsockname()[1]


def choose_backend(device, size, shared_card=False):
    """The backend of a W-rank axis on ``device``: gloo on the CPU or on a
    shared card, NCCL when every rank owns its card.  W ranks need W cards
    unless ``shared_card``."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    if shared_card:
        return "gloo"
    available = torch.cuda.device_count()
    if size > available:
        raise UserException(
            "The worker axis needs %d cards (one a rank) but only %d are available; "
            "pass --nb-devices <= %d (or --device cpu)" % (size, available, available))
    return "nccl"


class WorkerAxis:
    """W ranks of ``nb_workers`` logical workers, k = n/W a rank, worker
    w = rank * k + j on rank ``rank``.  ``group`` is None at W = 1."""

    def __init__(self, nb_workers, size=1, rank=0, device="cuda", group=None, backend=None):
        self.nb_workers = int(nb_workers)
        self.size = int(size)
        self.rank = int(rank)
        if self.size < 1 or not 0 <= self.rank < self.size:
            raise UserException("worker axis: rank %d of %d is out of range" % (self.rank, self.size))
        if self.nb_workers % self.size:
            raise UserException("the worker axis W=%d must divide --nb-workers %d (k = n/W workers a device)"
                                % (self.size, self.nb_workers))
        self.workers_per_device = self.nb_workers // self.size
        self.device = resolve_device(device)
        self.group = group
        self.backend = backend
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.stats = {"calls": 0, "seconds": 0.0, "bytes": 0}

    @property
    def lead(self):
        return self.rank == 0

    def with_workers(self, nb_workers):
        """This axis's ranks, group and device over ``nb_workers`` workers
        (one process group serves engines of several n)."""
        if int(nb_workers) == self.nb_workers:
            return self
        axis = WorkerAxis(nb_workers, self.size, self.rank, self.device, group=self.group, backend=self.backend)
        axis.stats = self.stats
        return axis

    def worker_index(self, j):
        """The global index of local worker ``j``."""
        return self.rank * self.workers_per_device + j

    # ------------------------------------------------------------------ #

    def _wire(self, tensor):
        """(the tensor the collective runs on, its bits' view): a pinned
        host copy under staging, the bytes of a ``BYTE_VIEWED`` tensor."""
        wire = tensor
        if self.staged:
            wire = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            wire.copy_(tensor)
        return wire, (wire.view(torch.uint8) if wire.dtype in BYTE_VIEWED else wire)

    def _back(self, wire, like):
        return wire.to(like.device) if self.staged else wire

    def _timed(self, fn, nbytes):
        begin = time.perf_counter()
        out = fn()
        self.stats["calls"] += 1
        self.stats["seconds"] += time.perf_counter() - begin
        self.stats["bytes"] += int(nbytes)
        return out

    def all_to_all(self, pieces):
        """``pieces`` (W, ...): piece i goes to rank i; returns (W, ...)
        whose entry i came from rank i (``jax.lax.all_to_all`` with
        split_axis = concat_axis = 0, tiled)."""
        pieces = pieces.contiguous()

        def run():
            wire, bits = self._wire(pieces)
            out = torch.empty_like(wire)
            out_bits = out.view(torch.uint8) if out.dtype in BYTE_VIEWED else out
            dist.all_to_all_single(out_bits, bits, group=self.group)
            return self._back(out, pieces)

        return self._timed(run, pieces.numel() * pieces.element_size())

    def all_reduce_sum(self, tensor):
        """The sum of ``tensor`` over the ranks (a new tensor)."""
        tensor = tensor.contiguous()

        def run():
            wire = tensor.clone() if not self.staged else self._wire(tensor)[0]
            dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.group)
            return self._back(wire, tensor)

        return self._timed(run, tensor.numel() * tensor.element_size())

    def all_gather(self, tensor):
        """(W, *shape): every rank's ``tensor``, in rank order."""
        tensor = tensor.contiguous()

        def run():
            wire, bits = self._wire(tensor)
            out = torch.empty((self.size,) + tuple(wire.shape), dtype=wire.dtype, device=wire.device,
                              pin_memory=self.staged)
            out_bits = out.view(torch.uint8) if out.dtype in BYTE_VIEWED else out
            dist.all_gather(list(out_bits.unbind(0)), bits, group=self.group)
            return self._back(out, tensor)

        return self._timed(run, tensor.numel() * tensor.element_size())

    def broadcast(self, tensor, src=0):
        """Rank ``src``'s ``tensor`` on every rank (a new tensor)."""
        tensor = tensor.contiguous()

        def run():
            wire, bits = self._wire(tensor) if self.staged else (tensor.clone(), None)
            if bits is None:
                bits = wire.view(torch.uint8) if wire.dtype in BYTE_VIEWED else wire
            dist.broadcast(bits, src=src, group=self.group)
            return self._back(wire, tensor)

        return self._timed(run, tensor.numel() * tensor.element_size())

    def close(self):
        """Leave the process group (a W = 1 axis has none)."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.group = None


def join(nb_workers, size, rank, init_method, device="cuda", shared_card=False, backend=None,
         timeout=DEFAULT_TIMEOUT):
    """Join (or, at W = 1, skip) the W-rank process group at
    ``init_method`` (``tcp://host:port``); returns this rank's
    :class:`WorkerAxis`.  On CUDA rank i takes card i, or card 0 under
    ``shared_card``."""
    size, rank = int(size), int(rank)
    device = torch.device(device)
    if size == 1:
        return WorkerAxis(nb_workers, 1, 0, device)
    backend = backend or choose_backend(device, size, shared_card)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", 0 if shared_card else rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    if rank == 0:
        info("Worker axis: %d ranks over %s (%s%s), %d worker(s) a rank"
             % (size, backend, device, ", staged through pinned host memory" if backend == "gloo"
                and device.type == "cuda" else "", int(nb_workers) // size))
    return WorkerAxis(nb_workers, size, rank, device, group=dist.group.WORLD, backend=backend)


def environment_rank():
    """``(rank, size, init_method)`` from ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT`` (what ``cli/deploy`` and torchrun
    export), or None when they are not all set."""
    if not all(name in os.environ for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return None
    address = "%s:%s" % (os.environ["MASTER_ADDR"], os.environ.get("MASTER_PORT", "29500"))
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "tcp://" + address


def _spawned(target, nb_workers, size, rank, init_method, device, shared_card, args, queue):
    """A spawned rank of :func:`spawn`: join, run ``target(axis, *args)``,
    put ``(rank, result or traceback)`` on the queue."""
    import traceback

    axis = None
    try:
        # the ranks share the host's cores: one intra-op pool each
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        axis = join(nb_workers, size, rank, init_method, device=device, shared_card=shared_card)
        queue.put((rank, True, target(axis, *args)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if axis is not None:
            axis.close()


def spawn(target, size, nb_workers, args=(), device="cpu", shared_card=False, timeout=DEFAULT_TIMEOUT):
    """Run ``target(axis, *args)`` on W spawned ranks (start method
    ``spawn``; ``target`` must be importable without the caller's module)
    and return their results in rank order; raises when a rank fails.  The
    calling process is none of the ranks."""
    import multiprocessing

    context = multiprocessing.get_context("spawn")
    queue = context.Queue()
    init_method = "tcp://127.0.0.1:%d" % free_port()
    procs = [context.Process(target=_spawned, daemon=True,
                             args=(target, nb_workers, size, rank, init_method, str(device), shared_card, args,
                                   queue))
             for rank in range(size)]
    for proc in procs:
        proc.start()
    results, failures = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(failures) < size:
            try:
                rank, ok, value = queue.get(timeout=1.0)
            except Exception:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in results]
                if dead and not failures:
                    failures.extend("rank %d exited with code %s" % item for item in dead)
                    break
                if time.monotonic() > deadline:
                    failures.append("the ranks did not finish within %.0f s" % timeout)
                    break
                continue
            if ok:
                results[rank] = value
            else:
                failures.append("rank %d failed:\n%s" % (rank, value))
    finally:
        for proc in procs:
            proc.join(timeout=30 if not failures else 5)
            if proc.is_alive():
                proc.terminate()
                proc.join()
    if failures:
        raise RuntimeError("\n".join(failures))
    return [results[rank] for rank in range(size)]


def factor_devices(n_devices):
    """Split ``n_devices`` into (workers, pipe, model) axis sizes (a copy of
    JAX ``mesh.py:56-77``): the odd part widens the worker axis, then the
    factors of two go round-robin to the axes still at 1. 8 -> (2, 2, 2),
    4 -> (2, 2, 1), 6 -> (3, 2, 1), 12 -> (3, 2, 2), 2 -> (2, 1, 1)."""
    sizes = [1, 1, 1]
    remaining = int(n_devices)
    while remaining % 2 == 0:
        remaining //= 2
        sizes[0] *= 2
    odd, twos = remaining, sizes[0]
    sizes = [odd, 1, 1]
    slot = 1 if odd > 1 else 0
    while twos > 1:
        sizes[slot] *= 2
        twos //= 2
        slot = (slot + 1) % 3
    return tuple(sizes)
