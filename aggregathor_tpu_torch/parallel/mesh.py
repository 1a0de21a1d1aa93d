"""The worker axis over ``torch.distributed``, and the (worker, pipe, model)
grid of the sharded engine (``make_mesh``, ``DeviceGrid``).

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

    def __init__(self, nb_workers, size=1, rank=0, device="cuda", group=None, backend=None, ranks=None):
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
        #: the process-group ranks of the axis's members, in axis order (the
        #: point-to-point peers of ``ppermute``); None: the world's 0..W-1
        self.ranks = None if ranks is None else [int(r) for r in ranks]

    @property
    def lead(self):
        return self.rank == 0

    def with_workers(self, nb_workers):
        """This axis's ranks, group and device over ``nb_workers`` workers
        (one process group serves engines of several n)."""
        if int(nb_workers) == self.nb_workers:
            return self
        axis = WorkerAxis(nb_workers, self.size, self.rank, self.device, group=self.group, backend=self.backend,
                          ranks=self.ranks)
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

    def ppermute(self, tensor, shift=1):
        """Rank i's ``tensor`` on rank (i + shift) mod W: one
        ``batch_isend_irecv`` of a send to that rank and a receive from rank
        (i - shift) mod W (``jax.lax.ppermute`` on a ring); returns what
        arrived."""
        tensor = tensor.contiguous()

        def peer(index):
            index %= self.size
            return self.ranks[index] if self.ranks is not None else index

        def run():
            wire, bits = self._wire(tensor)
            out = torch.empty_like(wire)
            out_bits = out.view(torch.uint8) if out.dtype in BYTE_VIEWED else out
            ops = [dist.P2POp(dist.isend, bits, peer(self.rank + shift), group=self.group),
                   dist.P2POp(dist.irecv, out_bits, peer(self.rank - shift), group=self.group)]
            for request in dist.batch_isend_irecv(ops):
                request.wait()
            return self._back(out, tensor)

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


def host_threads():
    """The intra-op threads this process's ranks split between them:
    ``OMP_NUM_THREADS`` where it is set, else every core."""
    return int(os.environ.get("OMP_NUM_THREADS") or 0) or os.cpu_count() or 1


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
        # the ranks share the host's cores, or the OMP_NUM_THREADS the
        # spawning process was given: one intra-op pool each
        torch.set_num_threads(max(1, host_threads() // size))
        axis = join(nb_workers, size, rank, init_method, device=device, shared_card=shared_card)
        queue.put((rank, True, target(axis, *args)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if axis is not None:
            axis.close()


def spawn(target, size, nb_workers, args=(), device="cuda", shared_card=False, timeout=DEFAULT_TIMEOUT):
    """Run ``target(axis, *args)`` on W spawned ranks (start method
    ``spawn``; ``target`` must be importable without the caller's module)
    and return their results in rank order; raises when a rank fails.  The
    calling process is none of the ranks.  The ranks run on the card unless
    ``device="cpu"``: a CUDA request without a GPU raises here, before any
    rank starts (``utils.resolve_device``); rank i takes card i, or card 0
    under ``shared_card``."""
    import multiprocessing

    device = torch.device(device)
    resolve_device(device)  # raises without a GPU; the ranks pick their cards in join()
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


#: the grid's axis names, in JAX's mesh order (``config.worker_axis``,
#: ``pipe_axis``, ``model_axis``)
worker_axis, pipe_axis, model_axis = "worker", "pipe", "model"
GRID_AXES = (worker_axis, pipe_axis, model_axis)


class DeviceGrid:
    """A (worker, pipe, model) grid of W PP TP ranks, laid out as
    ``jax.make_mesh((W, PP, TP))``: rank = (w PP + p) TP + m.

    ``worker``, ``pipe`` and ``model`` are this rank's three axes, each a
    :class:`WorkerAxis` over its own group: the ranks of the same (p, m),
    of the same (w, m) (the pipeline ring) and of the same (w, p) (the
    tensor-, sequence- and expert-parallel axis).  ``group`` is the
    (pipe, model) submesh of this rank's logical worker (the ranks of the
    same w), ``world`` every rank.  An axis of size 1 has no group and runs
    no collective.  ``shape`` maps each name to its size."""

    def __init__(self, shape, rank, device, world, worker, pipe, model, group):
        self.shape = dict(zip(GRID_AXES, shape))
        self.rank = int(rank)
        self.device = torch.device(device)
        self.world, self.worker, self.pipe, self.model, self.group = world, worker, pipe, model, group

    @property
    def size(self):
        return self.shape[worker_axis] * self.shape[pipe_axis] * self.shape[model_axis]

    @property
    def in_group_size(self):
        return self.shape[pipe_axis] * self.shape[model_axis]

    def axis(self, name):
        return {worker_axis: self.worker, pipe_axis: self.pipe, model_axis: self.model}[name]

    def psum(self, tensor, names):
        """``tensor`` summed over the in-group axes ``names`` (a subset of
        pipe and model; both: one collective over ``group``); axes of size 1
        are skipped."""
        names = tuple(name for name in names if self.shape[name] > 1)
        if not names:
            return tensor
        if len(names) == 2:
            return self.group.all_reduce_sum(tensor)
        return self.axis(names[0]).all_reduce_sum(tensor)


def _grid_axes(shape, rank, device, backend, worker=True):
    """This rank's ``(worker, pipe, model, group)`` axes of a (W, PP, TP)
    grid, each over a new group (``worker`` False: no worker axis, None).
    Every rank makes every group, in the same order (``dist.new_group``)."""
    W, PP, TP = shape

    def rank_of(w, p, m):
        return (w * PP + p) * TP + m

    def axis_over(members_of, size, index):
        """The WorkerAxis of this rank's group among the groups
        ``members_of(c)`` for every c; every rank makes every group."""
        mine = None
        if size > 1:
            for members in members_of():
                group = dist.new_group(members)
                if rank in members:
                    mine = (group, members)
        if mine is None:
            return WorkerAxis(1, 1, 0, device)
        return WorkerAxis(size, size, index, device, group=mine[0], backend=backend, ranks=mine[1])

    w0, p0, m0 = rank // (PP * TP), (rank // TP) % PP, rank % TP
    worker = axis_over(lambda: [[rank_of(w, p, m) for w in range(W)] for p in range(PP) for m in range(TP)], W,
                       w0) if worker else None
    pipe = axis_over(lambda: [[rank_of(w, p, m) for p in range(PP)] for w in range(W) for m in range(TP)], PP, p0)
    model = axis_over(lambda: [[rank_of(w, p, m) for m in range(TP)] for w in range(W) for p in range(PP)], TP, m0)
    group = axis_over(lambda: [[rank_of(w, p, m) for p in range(PP) for m in range(TP)] for w in range(W)],
                      PP * TP, p0 * TP + m0)
    return worker, pipe, model, group


def make_mesh(nb_workers=1, model_parallelism=1, pipeline_parallelism=1, device="cuda"):
    """This process's :class:`DeviceGrid` of ``nb_workers`` x
    ``pipeline_parallelism`` x ``model_parallelism`` ranks (JAX
    ``make_mesh``, ``mesh.py:25-53``, whose ``nb_workers`` is the worker
    axis's size too).  The grid spans the process group already joined
    (``join``/``spawn``), whose world size must be the product; without a
    group it is the one-rank (1, 1, 1) grid.  Every rank calls it, in the
    same order: each axis's groups are made with ``dist.new_group``, which
    every rank enters for every group."""
    shape = (int(nb_workers), int(pipeline_parallelism), int(model_parallelism))
    if min(shape) < 1:
        raise UserException("the mesh's axes must be positive (got W,PP,TP = %d,%d,%d)" % shape)
    need = shape[0] * shape[1] * shape[2]
    joined = dist.is_available() and dist.is_initialized()
    world_size = dist.get_world_size() if joined else 1
    if world_size != need:
        raise UserException("Mesh needs %d ranks (%d workers x %d pipe x %d model) but the process group holds %d"
                            % (need, shape[0], shape[1], shape[2], world_size))
    rank = dist.get_rank() if joined else 0
    backend = dist.get_backend() if joined else None
    device = resolve_device(device)
    worker, pipe, model, group = _grid_axes(shape, rank, device, backend)
    world = WorkerAxis(need, need, rank, device, group=dist.group.WORLD if need > 1 else None,
                       backend=backend if need > 1 else None)
    return DeviceGrid(shape, rank, device, world, worker, pipe, model, group)


def submission_grid(grid):
    """A grid of ``grid``'s shape and rank whose in-group axes (pipe, model
    and the (pipe x model) submesh) run on process groups of their own, made
    here on every rank in the same order: a bounded-wait submission's
    collectives (``RobustEngine.build_submesh_grad``) then never meet the
    aggregate's, the verdicts' or the fused step's, which run on ``grid``'s.
    Its worker axis and world are ``grid``'s (a submission calls neither)."""
    backend = dist.get_backend() if grid.size > 1 else None
    _, pipe, model, group = _grid_axes(tuple(grid.shape[name] for name in GRID_AXES), grid.rank, grid.device,
                                       backend, worker=False)
    return DeviceGrid(tuple(grid.shape[name] for name in GRID_AXES), grid.rank, grid.device, grid.world, grid.worker,
                      pipe, model, group)
