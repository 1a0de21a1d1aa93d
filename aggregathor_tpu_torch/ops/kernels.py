"""The GAR hot-path kernels: hand-written CUDA beside plain PyTorch versions.

Counterpart of ``aggregathor_tpu/ops/pallas_kernels.py``, with its public
names.  Each wrapper takes an (n, d) float32, contiguous matrix:

- a tensor on the CPU goes through the plain PyTorch version below it (the
  CPU tests, and the reference ``chip_smoke.py`` holds each kernel against);
- a tensor on a CUDA device launches the kernel of ``ops/csrc`` on the
  current stream, or raises.  There is no fallback to the plain version.

Every wrapper counts its launches (``KERNELS[name].launches``, incremented
where the kernel is launched and nowhere else), so a run can show that its
main path went through the kernels.

Each wrapper is a ``torch.library.custom_op`` (namespace ``aggregathor_torch``)
with a batching rule, the port's counterpart of Pallas' batching rule over
``pl.pallas_call``: called inside ``torch.func.vmap`` (the flat engine's
bucketed granularity:leaf path, one rule call over a stack of same-sized
parameter leaves), it runs the kernel's batched form once on the (L, n, d)
stack, the batch dimension moved first (``*_batched``): the batched plain
version on the CPU, one launch of the batched kernel on CUDA, counted in
``KERNELS[name].batched_launches``, or a raise.  Integer arguments (beta,
trim, keep) are never batched.  A batched plain version is the unbatched
plain code over a leading dimension (``BATCHED_PLAIN``), and gives the bits
of L unbatched calls.

Conventions (identical to the TPU kernels and the jnp tier): a non-finite
value keys as +inf; ties go to the lower row index; the median returns the
original value, NaN included; a NaN row of the distance input makes its row
and column NaN.  The plain versions use a stable ``torch.sort`` on the
inf-mapped keys, never ``torch.median``/``nanmedian``/``kthvalue``, whose NaN
and even-count rules differ.

Distances switch form at ``DISTANCE_MAX_ROWS`` rows, as the JAX wrapper does
(pallas_kernels.py:280-290): up to 64 rows the difference form (K1), beyond
it the Gram form (K2) on rows centred by their NaN-ignoring column median
(``nanmedian_columns``, numpy's even-count rule, served by the rank-selection
kernels' sort path), clamped at 0.  K2 takes the raw rows and the centre and
subtracts it as it loads, so no centred (n, d) copy is made.
"""

import functools
import math

import torch

from . import build


class Kernel:
    """Book-keeping of one kernel: where it lives, what it replaces, its
    launches and its batched form's."""

    def __init__(self, label, source, replaces):
        self.label = label
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.batched_launches = 0


KERNELS = {
    "pairwise_sq_distances": Kernel(
        "K1", "aggregathor_tpu_torch/ops/csrc/distances.cu",
        "aggregathor_tpu/ops/pallas_kernels.py:237"),
    "coordinate_median": Kernel(
        "K3", "aggregathor_tpu_torch/ops/csrc/coordinate.cu",
        "aggregathor_tpu/ops/pallas_kernels.py:143"),
    "coordinate_averaged_median": Kernel(
        "K4", "aggregathor_tpu_torch/ops/csrc/coordinate.cu",
        "aggregathor_tpu/ops/pallas_kernels.py:148"),
    "coordinate_trimmed_mean": Kernel(
        "K5", "aggregathor_tpu_torch/ops/csrc/coordinate.cu",
        "aggregathor_tpu/ops/pallas_kernels.py:156"),
    "pairwise_sq_distances_gram": Kernel(
        "K2", "aggregathor_tpu_torch/ops/csrc/gram.cu",
        "aggregathor_tpu/ops/pallas_kernels.py:248"),
    "average_nan_columns": Kernel(
        "K6", "aggregathor_tpu_torch/ops/csrc/coordinate.cu",
        "aggregathor_tpu/ops/pallas_kernels.py:218"),
    "nanmedian_columns": Kernel(
        "centring", "aggregathor_tpu_torch/ops/csrc/coordinate.cu",
        "aggregathor_tpu/ops/pallas_kernels.py:289"),
}

#: largest worker count K1 serves; beyond it the Gram form K2 takes over, as
#: the JAX wrapper switches at ``n > 64`` (pallas_kernels.py:280-281)
DISTANCE_MAX_ROWS = 64

#: K2's row tile and column slab (the kernel's compile-time tile edge and
#: ring stage): at n <= 128 one block per column chunk covers every row pair
GRAM_TILE = 128
GRAM_SLAB = 32
#: K2 blocks to aim for: one wave on the H100's 132 SMs, one block an SM (a
#: block fills its ring once, so one long wave beats two short ones)
GRAM_TARGET_BLOCKS = 132

#: rows the rank kernels serve with a sort (beyond: re-reading each column)
SORT_MAX_ROWS = 1024
#: threads of coordinate.cu's sort block, which refuses a layout whose lanes
#: times columns differ
SORT_BLOCK_THREADS = 256


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def batched_launch_counts():
    """{kernel name: batched launches (one a vmapped call) since the last reset}."""
    return {name: kernel.batched_launches for name, kernel in KERNELS.items()}


def reset_launch_counts():
    for kernel in KERNELS.values():
        kernel.launches = 0
        kernel.batched_launches = 0


def _check(x, batched=False):
    """Whether ``x`` lies on a card, after checking it is what the kernel
    takes: a contiguous, non-empty float32 (n, d) matrix, or (L, n, d) stack
    of them for a batched form."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("expected a torch.Tensor, got %s" % type(x).__name__)
    if x.dtype != torch.float32:
        raise TypeError("expected float32, got %s" % x.dtype)
    rank, what = (3, "(L, n, d) stack") if batched else (2, "(n, d) matrix")
    if x.dim() != rank or min(x.shape) < 1:
        raise ValueError("expected a non-empty %s, got shape %s" % (what, tuple(x.shape)))
    if not x.is_contiguous():
        raise ValueError("expected a contiguous %s" % what)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s (cpu or cuda)" % x.device)
    return x.device.type == "cuda"


def _launch(name, source, symbol, x, *args, stream=None, batched=False):
    """Run C entry ``symbol`` of ``source`` on x's device and ``stream`` (by
    default the device's current stream); count it as a launch of ``name``,
    or of its batched form."""
    fn = getattr(build.library(source), symbol)
    with torch.cuda.device(x.device):
        if stream is None:
            stream = torch.cuda.current_stream(x.device)
        status = fn(*args, stream.cuda_stream)
    if status != 0:
        raise RuntimeError("CUDA error %d launching %s (%s)" % (status, name, symbol))
    if batched:
        KERNELS[name].batched_launches += 1
    else:
        KERNELS[name].launches += 1


def _leading(value, dim, size):
    """A vmapped argument as the (L, ...) stack its batched form takes: its
    batch dimension moved first (contiguous), or repeated L times where it
    is not batched; None and non-tensors pass through."""
    if not isinstance(value, torch.Tensor):
        return value
    if dim is None:
        return value.expand(size, *value.shape).contiguous()
    return value.movedim(dim, 0).contiguous()


def _custom_op(name, schema, unbatched, batched, fake):
    """``unbatched`` as the custom op ``aggregathor_torch::<name>``, whose
    batching rule calls ``batched`` once on the arguments moved to a
    leading dimension (``_leading``)."""
    op = torch.library.custom_op("aggregathor_torch::" + name, unbatched, mutates_args=(), schema=schema)
    op.register_fake(fake)

    def rule(info, in_dims, *args):
        return batched(*(_leading(arg, dim, info.batch_size) for arg, dim in zip(args, in_dims))), 0

    op.register_vmap(rule)
    return op


def _inf_key(x):
    return torch.where(torch.isfinite(x), x, torch.inf)


# --------------------------------------------------------------------------- #
# K1: pairwise squared distances

@functools.lru_cache(maxsize=None)
def _distance_grid(leaves, n, d, device_index):
    """(K1's blocks a leaf, the card's SMs) for ``leaves`` stacked (n, d)
    matrices on card ``device_index``: distances.cu lays the kernel out from
    the leaves, n, d and the SM count (distances_layout.h), and the blocks
    size the scratch."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return build.library("distances").agg_pairwise_sq_distances_blocks(leaves, n, d, sms), sms


_counters = {}


def _arrival_counters(device, stream, leaves):
    """K1's arrival counters for ``stream`` of ``device``: at least
    ``leaves`` zeroed int32, one a leaf, which each leaf's last block resets,
    shared by no two streams (grown, never shrunk, for a larger bucket)."""
    key = (device.index, stream.cuda_stream)
    counters = _counters.get(key)
    if counters is None or counters.numel() < leaves:
        size = leaves if counters is None else max(leaves, 2 * counters.numel())
        counters = _counters[key] = torch.zeros(size, dtype=torch.int32, device=device)
    return counters


def pairwise_sq_distances_plain(x):
    """(n, n) all-pairs squared L2 distances of the rows of (n, d) (or (L,
    n, n) of an (L, n, d) stack, the batched plain version): the difference
    form, one pass per row, up to ``DISTANCE_MAX_ROWS`` rows; beyond, the
    centred Gram form of K2 (``pairwise_sq_distances_gram_plain``)."""
    n = x.shape[-2]
    if n > DISTANCE_MAX_ROWS:
        return pairwise_sq_distances_gram_plain(x, nanmedian_columns_plain(x))
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32, device=x.device)
    for i in range(n):
        diff = x - x[..., i:i + 1, :]
        out[..., i, :] = torch.sum(diff * diff, dim=-1)
    return out


def _k1_launch(x, leaves, batched):
    """One K1 launch over ``leaves`` stacked (n, d) matrices of ``x``."""
    n, d = x.shape[-2:]
    blocks, sms = _distance_grid(leaves, n, d, x.device.index)
    stream = torch.cuda.current_stream(x.device)
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32, device=x.device)
    scratch = torch.empty((leaves * blocks, n * (n + 1) // 2), dtype=torch.float32, device=x.device)
    _launch("pairwise_sq_distances", "distances", "agg_pairwise_sq_distances",
            x, x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            _arrival_counters(x.device, stream, leaves).data_ptr(), leaves, n, d, sms, stream=stream,
            batched=batched)
    return out


def _pairwise_sq_distances(x):
    return pairwise_sq_distances_plain(x) if x.device.type != "cuda" else _k1_launch(x, 1, False)


def pairwise_sq_distances_batched(x):
    """(L, n, n) distances of each (n, d) leaf of an (L, n, d) stack: one
    batched K1 launch for n <= ``DISTANCE_MAX_ROWS``, else the batched
    centring and one batched K2 launch."""
    on_cuda = _check(x, batched=True)
    if x.shape[1] > DISTANCE_MAX_ROWS:
        return pairwise_sq_distances_gram_batched(x, nanmedian_columns_batched(x))
    if not on_cuda:
        return pairwise_sq_distances_plain(x)
    return _k1_launch(x, x.shape[0], True)


_k1_op = _custom_op("pairwise_sq_distances", "(Tensor x) -> Tensor", _pairwise_sq_distances,
                    pairwise_sq_distances_batched, lambda x: x.new_empty((x.shape[0], x.shape[0])))


def pairwise_sq_distances(x):
    """(n, n) all-pairs squared L2 distances of the rows of (n, d): K1 for
    n <= ``DISTANCE_MAX_ROWS``, else median centring and K2."""
    _check(x)
    if x.shape[0] > DISTANCE_MAX_ROWS:
        return pairwise_sq_distances_gram(x, nanmedian_columns(x))
    return _k1_op(x)


# --------------------------------------------------------------------------- #
# K2: Gram-form distances of median-centred rows

def nanmedian_columns_plain(x):
    """(d,) per-column median of the finite entries of (n, d) (or (L, d) of
    an (L, n, d) stack), numpy's rule: an even count averages its two middle
    values; a column with nothing finite gives 0 (``jnp.nan_to_num(
    jnp.nanmedian(...))``, pallas_kernels.py:289).

    A stable sort of the inf-mapped keys puts each column's k finite values
    first, in ascending order; the median is read at ranks (k-1)//2 and k//2."""
    n = x.shape[-2]
    ordered = torch.sort(_inf_key(x), dim=-2, stable=True).values
    count = torch.sum(torch.isfinite(x), dim=-2, keepdim=True)
    low = torch.gather(ordered, -2, torch.clamp((count - 1) // 2, 0, n - 1))[..., 0, :]
    high = torch.gather(ordered, -2, torch.clamp(count // 2, 0, n - 1))[..., 0, :]
    count = count[..., 0, :]
    median = torch.where(count % 2 == 1, low, (low + high) / 2)
    return torch.nan_to_num(torch.where(count > 0, median, 0.0))


def _rank_launch(name, symbol, x, leaves, *args, batched):
    """One launch of a coordinate.cu entry over ``leaves`` stacked (n, d)
    matrices of ``x``: the (..., d) output, the entry's own arguments, then
    the sort layout."""
    n, d = x.shape[-2:]
    out = torch.empty(x.shape[:-2] + (d,), dtype=torch.float32, device=x.device)
    _launch(name, "coordinate", symbol, x, x.data_ptr(), out.data_ptr(), leaves, n, d, *args,
            batched=batched)
    return out


def _nanmedian_columns(x):
    if x.device.type != "cuda":
        return nanmedian_columns_plain(x)
    return _rank_launch("nanmedian_columns", "agg_nanmedian_columns", x, 1, *sort_shape(x.shape[0]), batched=False)


def nanmedian_columns_batched(x):
    """(L, d) centring medians of an (L, n, d) stack: one batched launch."""
    if not _check(x, batched=True):
        return nanmedian_columns_plain(x)
    return _rank_launch("nanmedian_columns", "agg_nanmedian_columns", x, x.shape[0], *sort_shape(x.shape[1]),
                        batched=True)


_nanmedian_op = _custom_op("nanmedian_columns", "(Tensor x) -> Tensor", _nanmedian_columns, nanmedian_columns_batched,
                           lambda x: x.new_empty(x.shape[1]))


def nanmedian_columns(x):
    """(d,) per-column median of the finite entries (numpy's even-count rule,
    0 where nothing is finite): the centring in front of K2, at any n."""
    _check(x)
    return _nanmedian_op(x)


def gram_chunk(n, d, leaves=1):
    """Columns per K2 block: a multiple of the slab, wide enough that the
    (tile pairs x chunks) grid of a bucket of ``leaves`` comes near
    ``GRAM_TARGET_BLOCKS``."""
    tiles = -(-n // GRAM_TILE)
    pairs = tiles * (tiles + 1) // 2
    chunks = max(1, -(-GRAM_TARGET_BLOCKS // (pairs * leaves)))
    chunk = -(-d // chunks)
    return -(-chunk // GRAM_SLAB) * GRAM_SLAB


def pairwise_sq_distances_gram_plain(x, centre=None):
    """(n, n) |a|^2 + |b|^2 - 2 a.b of the rows of ``x - centre`` (``centre``
    a (d,) vector, None for 0), clamped at 0: the Gram matrix first (one
    (n, d) pass per row), the norms from its diagonal (so the diagonal is
    exactly 0), as K2 orders it.  Over an (L, n, d) stack with (L, d)
    centres: the (L, n, n) batched plain version."""
    if centre is not None:
        x = x - centre[..., None, :]
    n = x.shape[-2]
    gram = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32, device=x.device)
    for i in range(n):
        gram[..., i, :] = torch.sum(x * x[..., i:i + 1, :], dim=-1)
    norms = torch.diagonal(gram, dim1=-2, dim2=-1)
    return torch.clamp_min(norms[..., :, None] + norms[..., None, :] - 2.0 * gram, 0.0)


def _check_centre(centre, x):
    if centre is None:
        return
    if not isinstance(centre, torch.Tensor) or centre.dtype != torch.float32:
        raise TypeError("expected a float32 torch.Tensor centre")
    if centre.shape != x.shape[:-2] + x.shape[-1:] or not centre.is_contiguous() or centre.device != x.device:
        raise ValueError("expected a contiguous %s centre on %s, got %s on %s"
                         % (tuple(x.shape[:-2] + x.shape[-1:]), x.device, tuple(centre.shape), centre.device))


def _k2_launch(x, centre, leaves, batched):
    """One K2 launch (its partial and finish kernels) over ``leaves`` stacked
    (n, d) matrices of ``x``, centred by ``centre`` (None: 0)."""
    n, d = x.shape[-2:]
    tiles = -(-n // GRAM_TILE)
    chunk = gram_chunk(n, d, leaves)
    nb_chunks = -(-d // chunk)
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32, device=x.device)
    scratch = torch.empty((leaves * tiles * (tiles + 1) // 2, nb_chunks, GRAM_TILE, GRAM_TILE),
                          dtype=torch.float32, device=x.device)
    _launch("pairwise_sq_distances_gram", "gram", "agg_gram_sq_distances",
            x, x.data_ptr(), None if centre is None else centre.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), leaves, n, d, chunk, batched=batched)
    return out


def _pairwise_sq_distances_gram(x, centre):
    if x.device.type != "cuda":
        return pairwise_sq_distances_gram_plain(x, centre)
    return _k2_launch(x, centre, 1, False)


def pairwise_sq_distances_gram_batched(x, centre=None):
    """(L, n, n) clamped Gram-form distances of each leaf of an (L, n, d)
    stack centred by its row of the (L, d) ``centre`` (None: 0): one
    batched K2 launch, the chunks sized over the whole bucket."""
    on_cuda = _check(x, batched=True)
    _check_centre(centre, x)
    if not on_cuda:
        return pairwise_sq_distances_gram_plain(x, centre)
    return _k2_launch(x, centre, x.shape[0], True)


_gram_op = _custom_op("pairwise_sq_distances_gram", "(Tensor x, Tensor? centre) -> Tensor",
                      _pairwise_sq_distances_gram, pairwise_sq_distances_gram_batched,
                      lambda x, centre: x.new_empty((x.shape[0], x.shape[0])))


def pairwise_sq_distances_gram(x, centre=None):
    """(n, n) clamped Gram-form squared distances of the rows of ``x -
    centre`` (K2; ``centre`` a (d,) vector, None for 0), centred as the
    kernel loads x.

    A non-finite value in row i makes row and column i non-finite.  The
    kernel writes NaN for every one of them (diagonal included): its 3xTF32
    split turns an inf into hi = inf and lo = inf - inf = NaN, so it cannot
    keep float32's mix of +inf and NaN, which the plain version keeps.  The
    two agree on which entries are non-finite; every caller maps a
    non-finite distance to +inf before scoring, so no selection changes."""
    _check(x)
    _check_centre(centre, x)
    return _gram_op(x, centre)


# --------------------------------------------------------------------------- #
# K3-K5: coordinate-wise rank selection

def sort_shape(n):
    """The rank kernels' sort layout for n rows, which the wrappers pass to
    coordinate.cu: (padded rows P, lanes a column, columns a block, row
    stride of the staged (n, columns) tile in floats), or zeros beyond
    ``SORT_MAX_ROWS`` rows (the re-reading path).  The kernel refuses a
    layout that is not exactly that of its instance for P.  P is the next power of two >= n, at least 128; 8, 16
    or 32 lanes sort a column (more lanes for more rows, at most a warp); the
    stride, columns + 32 / lanes, puts a warp's reads of the tile on 32
    distinct banks, and the tile stays within the 48 KB of dynamic shared
    memory a block may take without opting in."""
    if n > SORT_MAX_ROWS:
        return 0, 0, 0, 0
    p = max(128, 1 << (n - 1).bit_length())
    lanes = 8 if p <= 128 else (16 if p <= 256 else 32)
    columns = SORT_BLOCK_THREADS // lanes
    return p, lanes, columns, columns + 32 // lanes


def _ranks(key):
    """rank[i, c] = #{j : key[j, c] < key[i, c], ties to the lower j}: the
    inverse of the stable ascending sort's permutation (over the rows, dim -2)."""
    return torch.argsort(torch.argsort(key, dim=-2, stable=True), dim=-2)


def coordinate_median_plain(x):
    """(d,) per-column value at ascending rank n//2 (keys: non-finite -> +inf);
    (L, d) of an (L, n, d) stack."""
    order = torch.argsort(_inf_key(x), dim=-2, stable=True)
    mid = x.shape[-2] // 2
    return torch.gather(x, -2, order[..., mid:mid + 1, :])[..., 0, :]


def _coordinate_median(x):
    if x.device.type != "cuda":
        return coordinate_median_plain(x)
    return _rank_launch("coordinate_median", "agg_coordinate_median", x, 1, *sort_shape(x.shape[0]), batched=False)


def coordinate_median_batched(x):
    """(L, d) upper medians of each leaf of an (L, n, d) stack: one batched K3 launch."""
    if not _check(x, batched=True):
        return coordinate_median_plain(x)
    return _rank_launch("coordinate_median", "agg_coordinate_median", x, x.shape[0], *sort_shape(x.shape[1]),
                        batched=True)


_median_op = _custom_op("coordinate_median", "(Tensor x) -> Tensor", _coordinate_median, coordinate_median_batched,
                        lambda x: x.new_empty(x.shape[1]))


def coordinate_median(x):
    """(d,) upper median per column of an (n, d) matrix, non-finite last (K3)."""
    _check(x)
    return _median_op(x)


def coordinate_averaged_median_plain(x, beta):
    """(d,) per-column mean of the ``beta`` values closest to the median,
    summed in row order like the kernel; (L, d) of an (L, n, d) stack."""
    med = coordinate_median_plain(x)
    chosen = _ranks(_inf_key(torch.abs(x - med[..., None, :]))) < beta
    return torch.sum(torch.where(chosen, x, 0.0), dim=-2) / beta


def _check_beta(x, beta):
    beta, n = int(beta), x.shape[-2]
    if not 1 <= beta <= n:
        raise ValueError("beta must lie in [1, n=%d], got %d" % (n, beta))
    return beta


def _coordinate_averaged_median(x, beta):
    if x.device.type != "cuda":
        return coordinate_averaged_median_plain(x, beta)
    return _rank_launch("coordinate_averaged_median", "agg_coordinate_averaged_median", x, 1, beta,
                        *sort_shape(x.shape[0]), batched=False)


def coordinate_averaged_median_batched(x, beta):
    """(L, d) averaged medians of each leaf of an (L, n, d) stack: one batched K4 launch."""
    on_cuda = _check(x, batched=True)
    beta = _check_beta(x, beta)
    if not on_cuda:
        return coordinate_averaged_median_plain(x, beta)
    return _rank_launch("coordinate_averaged_median", "agg_coordinate_averaged_median", x, x.shape[0], beta,
                        *sort_shape(x.shape[1]), batched=True)


_averaged_median_op = _custom_op("coordinate_averaged_median", "(Tensor x, int beta) -> Tensor",
                                 _coordinate_averaged_median, coordinate_averaged_median_batched,
                                 lambda x, beta: x.new_empty(x.shape[1]))


def coordinate_averaged_median(x, beta):
    """(d,) per-column mean of the ``beta`` values closest to the median (K4)."""
    _check(x)
    return _averaged_median_op(x, _check_beta(x, beta))


def coordinate_trimmed_mean_plain(x, trim, keep):
    """(d,) per-column mean of the inf-mapped values at ranks [trim, trim+keep),
    summed in row order like the kernel; (L, d) of an (L, n, d) stack."""
    key = _inf_key(x)
    ranks = _ranks(key)
    band = (ranks >= trim) & (ranks < trim + keep)
    mean = torch.sum(torch.where(band, key, 0.0), dim=-2) / keep
    return torch.where(torch.isfinite(mean), mean, math.nan)


def _check_band(x, trim, keep):
    trim, keep, n = int(trim), int(keep), x.shape[-2]
    if trim < 0 or keep < 1 or trim + keep > n:
        raise ValueError("need 0 <= trim, 1 <= keep, trim + keep <= n=%d (got %d, %d)" % (n, trim, keep))
    return trim, keep


def _coordinate_trimmed_mean(x, trim, keep):
    if x.device.type != "cuda":
        return coordinate_trimmed_mean_plain(x, trim, keep)
    return _rank_launch("coordinate_trimmed_mean", "agg_coordinate_trimmed_mean", x, 1, trim, keep,
                        *sort_shape(x.shape[0]), batched=False)


def coordinate_trimmed_mean_batched(x, trim, keep):
    """(L, d) trimmed means of each leaf of an (L, n, d) stack: one batched K5 launch."""
    on_cuda = _check(x, batched=True)
    trim, keep = _check_band(x, trim, keep)
    if not on_cuda:
        return coordinate_trimmed_mean_plain(x, trim, keep)
    return _rank_launch("coordinate_trimmed_mean", "agg_coordinate_trimmed_mean", x, x.shape[0], trim, keep,
                        *sort_shape(x.shape[1]), batched=True)


_trimmed_mean_op = _custom_op("coordinate_trimmed_mean", "(Tensor x, int trim, int keep) -> Tensor",
                              _coordinate_trimmed_mean, coordinate_trimmed_mean_batched,
                              lambda x, trim, keep: x.new_empty(x.shape[1]))


def coordinate_trimmed_mean(x, trim, keep):
    """(d,) per-column mean of the values at sorted ranks [trim, trim+keep)
    with non-finite mapped to +inf; NaN where the kept band is poisoned (K5)."""
    _check(x)
    return _trimmed_mean_op(x, *_check_band(x, trim, keep))


# --------------------------------------------------------------------------- #
# K6: finite-only column mean

def average_nan_columns_plain(x):
    """(d,) per-column mean of the finite entries, 0 where there is none,
    summed in row order like the kernel; (L, d) of an (L, n, d) stack."""
    finite = torch.isfinite(x)
    total = torch.sum(torch.where(finite, x, 0.0), dim=-2)
    count = torch.sum(finite, dim=-2).to(torch.float32)
    return torch.where(count > 0, total / torch.clamp_min(count, 1.0), 0.0)


def _average_nan_columns(x):
    if x.device.type != "cuda":
        return average_nan_columns_plain(x)
    return _rank_launch("average_nan_columns", "agg_average_nan_columns", x, 1, batched=False)


def average_nan_columns_batched(x):
    """(L, d) finite means of each leaf of an (L, n, d) stack: one batched K6 launch."""
    if not _check(x, batched=True):
        return average_nan_columns_plain(x)
    return _rank_launch("average_nan_columns", "agg_average_nan_columns", x, x.shape[0], batched=True)


_average_nan_op = _custom_op("average_nan_columns", "(Tensor x) -> Tensor", _average_nan_columns,
                             average_nan_columns_batched, lambda x: x.new_empty(x.shape[1]))


def average_nan_columns(x):
    """(d,) per-column mean of the finite entries; 0 where a column has none (K6)."""
    _check(x)
    return _average_nan_op(x)


#: kernel name -> its plain version, for the checks that hold one against the other
PLAIN = {
    "pairwise_sq_distances": pairwise_sq_distances_plain,
    "pairwise_sq_distances_gram": pairwise_sq_distances_gram_plain,
    "coordinate_median": coordinate_median_plain,
    "coordinate_averaged_median": coordinate_averaged_median_plain,
    "coordinate_trimmed_mean": coordinate_trimmed_mean_plain,
    "average_nan_columns": average_nan_columns_plain,
    "nanmedian_columns": nanmedian_columns_plain,
}

#: kernel name -> (its batched wrapper, its batched plain version: the plain
#: code over a leading dimension), the forms a ``torch.func.vmap`` call runs
BATCHED = {name: (globals()[name + "_batched"], plain) for name, plain in PLAIN.items()}
