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
    """Book-keeping of one kernel: where it lives, what it replaces, launches."""

    def __init__(self, label, source, replaces):
        self.label = label
        self.source = source
        self.replaces = replaces
        self.launches = 0


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


def reset_launch_counts():
    for kernel in KERNELS.values():
        kernel.launches = 0


def _check(x):
    if not isinstance(x, torch.Tensor):
        raise TypeError("expected a torch.Tensor, got %s" % type(x).__name__)
    if x.dtype != torch.float32:
        raise TypeError("expected float32, got %s" % x.dtype)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError("expected a non-empty (n, d) matrix, got shape %s" % (tuple(x.shape),))
    if not x.is_contiguous():
        raise ValueError("expected a contiguous matrix")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s (cpu or cuda)" % x.device)
    return x.device.type == "cuda"


def _launch(name, source, symbol, x, *args, stream=None):
    """Run C entry ``symbol`` of ``source`` on x's device and ``stream`` (by
    default the device's current stream)."""
    fn = getattr(build.library(source), symbol)
    with torch.cuda.device(x.device):
        if stream is None:
            stream = torch.cuda.current_stream(x.device)
        status = fn(*args, stream.cuda_stream)
    if status != 0:
        raise RuntimeError("CUDA error %d launching %s (%s)" % (status, name, symbol))
    KERNELS[name].launches += 1


def _inf_key(x):
    return torch.where(torch.isfinite(x), x, torch.inf)


# --------------------------------------------------------------------------- #
# K1: pairwise squared distances

@functools.lru_cache(maxsize=None)
def _distance_grid(n, d, device_index):
    """(K1's blocks, the card's SMs) for an (n, d) matrix on card
    ``device_index``: distances.cu lays the kernel out from n, d and the SM
    count (distances_layout.h), and the blocks size the scratch."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return build.library("distances").agg_pairwise_sq_distances_blocks(n, d, sms), sms


_counters = {}


def _arrival_counter(device, stream):
    """K1's arrival counter for ``stream`` of ``device``: one zeroed int32,
    which the kernel's last block resets, shared by no two streams."""
    key = (device.index, stream.cuda_stream)
    counter = _counters.get(key)
    if counter is None:
        counter = _counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return counter


def pairwise_sq_distances_plain(x):
    """(n, n) all-pairs squared L2 distances: the difference form, one (n, d)
    pass per row, up to ``DISTANCE_MAX_ROWS`` rows; beyond, the centred Gram
    form of K2 (``pairwise_sq_distances_gram_plain``)."""
    n = x.shape[0]
    if n > DISTANCE_MAX_ROWS:
        return pairwise_sq_distances_gram_plain(x, nanmedian_columns_plain(x))
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    for i in range(n):
        diff = x - x[i]
        out[i] = torch.sum(diff * diff, dim=1)
    return out


def pairwise_sq_distances(x):
    """(n, n) all-pairs squared L2 distances of the rows of (n, d): K1 for
    n <= ``DISTANCE_MAX_ROWS``, else median centring and K2."""
    if not _check(x):
        return pairwise_sq_distances_plain(x)
    n, d = x.shape
    if n > DISTANCE_MAX_ROWS:
        return pairwise_sq_distances_gram(x, nanmedian_columns(x))
    blocks, sms = _distance_grid(n, d, x.device.index)
    stream = torch.cuda.current_stream(x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty((blocks, n * (n + 1) // 2), dtype=torch.float32, device=x.device)
    _launch("pairwise_sq_distances", "distances", "agg_pairwise_sq_distances",
            x, x.data_ptr(), out.data_ptr(), scratch.data_ptr(), _arrival_counter(x.device, stream).data_ptr(),
            n, d, sms, stream=stream)
    return out


# --------------------------------------------------------------------------- #
# K2: Gram-form distances of median-centred rows

def nanmedian_columns_plain(x):
    """(d,) per-column median of the finite entries, numpy's rule: an even
    count averages its two middle values; a column with nothing finite gives
    0 (``jnp.nan_to_num(jnp.nanmedian(...))``, pallas_kernels.py:289).

    A stable sort of the inf-mapped keys puts each column's k finite values
    first, in ascending order; the median is read at ranks (k-1)//2 and k//2."""
    n = x.shape[0]
    ordered = torch.sort(_inf_key(x), dim=0, stable=True).values
    count = torch.sum(torch.isfinite(x), dim=0, keepdim=True)
    low = torch.gather(ordered, 0, torch.clamp((count - 1) // 2, 0, n - 1))[0]
    high = torch.gather(ordered, 0, torch.clamp(count // 2, 0, n - 1))[0]
    count = count[0]
    median = torch.where(count % 2 == 1, low, (low + high) / 2)
    return torch.nan_to_num(torch.where(count > 0, median, 0.0))


def nanmedian_columns(x):
    """(d,) per-column median of the finite entries (numpy's even-count rule,
    0 where nothing is finite): the centring in front of K2, at any n."""
    if not _check(x):
        return nanmedian_columns_plain(x)
    n, d = x.shape
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    _launch("nanmedian_columns", "coordinate", "agg_nanmedian_columns",
            x, x.data_ptr(), out.data_ptr(), n, d, *sort_shape(n))
    return out


def gram_chunk(n, d):
    """Columns per K2 block: a multiple of the slab, wide enough that the
    (tile pairs x chunks) grid comes near ``GRAM_TARGET_BLOCKS``."""
    tiles = -(-n // GRAM_TILE)
    pairs = tiles * (tiles + 1) // 2
    chunks = max(1, -(-GRAM_TARGET_BLOCKS // pairs))
    chunk = -(-d // chunks)
    return -(-chunk // GRAM_SLAB) * GRAM_SLAB


def pairwise_sq_distances_gram_plain(x, centre=None):
    """(n, n) |a|^2 + |b|^2 - 2 a.b of the rows of ``x - centre`` (``centre``
    a (d,) vector, None for 0), clamped at 0: the Gram matrix first (one
    (n, d) pass per row), the norms from its diagonal (so the diagonal is
    exactly 0), as K2 orders it."""
    if centre is not None:
        x = x - centre[None, :]
    n = x.shape[0]
    gram = torch.empty((n, n), dtype=torch.float32, device=x.device)
    for i in range(n):
        gram[i] = torch.sum(x * x[i], dim=1)
    norms = torch.diagonal(gram)
    return torch.clamp_min(norms[:, None] + norms[None, :] - 2.0 * gram, 0.0)


def _check_centre(centre, x):
    if centre is None:
        return
    if not isinstance(centre, torch.Tensor) or centre.dtype != torch.float32:
        raise TypeError("expected a float32 torch.Tensor centre")
    if centre.shape != (x.shape[1],) or not centre.is_contiguous() or centre.device != x.device:
        raise ValueError("expected a contiguous (%d,) centre on %s, got %s on %s"
                         % (x.shape[1], x.device, tuple(centre.shape), centre.device))


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
    on_cuda = _check(x)
    _check_centre(centre, x)
    if not on_cuda:
        return pairwise_sq_distances_gram_plain(x, centre)
    n, d = x.shape
    tiles = -(-n // GRAM_TILE)
    chunk = gram_chunk(n, d)
    nb_chunks = -(-d // chunk)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty((tiles * (tiles + 1) // 2, nb_chunks, GRAM_TILE, GRAM_TILE),
                          dtype=torch.float32, device=x.device)
    _launch("pairwise_sq_distances_gram", "gram", "agg_gram_sq_distances",
            x, x.data_ptr(), None if centre is None else centre.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, d, chunk)
    return out


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
    inverse of the stable ascending sort's permutation."""
    return torch.argsort(torch.argsort(key, dim=0, stable=True), dim=0)


def coordinate_median_plain(x):
    """(d,) per-column value at ascending rank n//2 (keys: non-finite -> +inf)."""
    order = torch.argsort(_inf_key(x), dim=0, stable=True)
    mid = x.shape[0] // 2
    return torch.gather(x, 0, order[mid:mid + 1])[0]


def coordinate_median(x):
    """(d,) upper median per column of an (n, d) matrix, non-finite last (K3)."""
    if not _check(x):
        return coordinate_median_plain(x)
    n, d = x.shape
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    _launch("coordinate_median", "coordinate", "agg_coordinate_median",
            x, x.data_ptr(), out.data_ptr(), n, d, *sort_shape(n))
    return out


def coordinate_averaged_median_plain(x, beta):
    """(d,) per-column mean of the ``beta`` values closest to the median,
    summed in row order like the kernel."""
    med = coordinate_median_plain(x)
    chosen = _ranks(_inf_key(torch.abs(x - med[None, :]))) < beta
    return torch.sum(torch.where(chosen, x, 0.0), dim=0) / beta


def coordinate_averaged_median(x, beta):
    """(d,) per-column mean of the ``beta`` values closest to the median (K4)."""
    beta = int(beta)
    on_cuda = _check(x)
    n, d = x.shape
    if not 1 <= beta <= n:
        raise ValueError("beta must lie in [1, n=%d], got %d" % (n, beta))
    if not on_cuda:
        return coordinate_averaged_median_plain(x, beta)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    _launch("coordinate_averaged_median", "coordinate", "agg_coordinate_averaged_median",
            x, x.data_ptr(), out.data_ptr(), n, d, beta, *sort_shape(n))
    return out


def coordinate_trimmed_mean_plain(x, trim, keep):
    """(d,) per-column mean of the inf-mapped values at ranks [trim, trim+keep),
    summed in row order like the kernel."""
    key = _inf_key(x)
    ranks = _ranks(key)
    band = (ranks >= trim) & (ranks < trim + keep)
    mean = torch.sum(torch.where(band, key, 0.0), dim=0) / keep
    return torch.where(torch.isfinite(mean), mean, math.nan)


def coordinate_trimmed_mean(x, trim, keep):
    """(d,) per-column mean of the values at sorted ranks [trim, trim+keep)
    with non-finite mapped to +inf; NaN where the kept band is poisoned (K5)."""
    trim, keep = int(trim), int(keep)
    on_cuda = _check(x)
    n, d = x.shape
    if trim < 0 or keep < 1 or trim + keep > n:
        raise ValueError("need 0 <= trim, 1 <= keep, trim + keep <= n=%d (got %d, %d)" % (n, trim, keep))
    if not on_cuda:
        return coordinate_trimmed_mean_plain(x, trim, keep)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    _launch("coordinate_trimmed_mean", "coordinate", "agg_coordinate_trimmed_mean",
            x, x.data_ptr(), out.data_ptr(), n, d, trim, keep, *sort_shape(n))
    return out


# --------------------------------------------------------------------------- #
# K6: finite-only column mean

def average_nan_columns_plain(x):
    """(d,) per-column mean of the finite entries, 0 where there is none,
    summed in row order like the kernel."""
    finite = torch.isfinite(x)
    total = torch.sum(torch.where(finite, x, 0.0), dim=0)
    count = torch.sum(finite, dim=0).to(torch.float32)
    return torch.where(count > 0, total / torch.clamp_min(count, 1.0), 0.0)


def average_nan_columns(x):
    """(d,) per-column mean of the finite entries; 0 where a column has none (K6)."""
    if not _check(x):
        return average_nan_columns_plain(x)
    n, d = x.shape
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    _launch("average_nan_columns", "coordinate", "agg_average_nan_columns",
            x, x.data_ptr(), out.data_ptr(), n, d)
    return out


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
