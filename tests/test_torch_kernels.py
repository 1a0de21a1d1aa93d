"""The port's kernel module against the JAX package's kernels.

On the CPU every wrapper of ``aggregathor_tpu_torch.ops.kernels`` runs its
plain PyTorch version; it is held against ``pallas_kernels.<fn>`` run the
way tests/test_pallas.py runs it (interpret mode on the CPU) and against the
jnp tier, on the same numpy inputs: NaN/inf-poisoned matrices, ties, and
widths on both sides of the Pallas tiles (127, 128, 129, 1025).

Tolerances, each from the order of summation:
- median (K3): exact — it returns one of the original values;
- averaged-median, trimmed-mean (K4, K5): rtol 1e-6 plus atol 1e-6 on
  unit-scale inputs — means of up to n float32 values summed in another
  order (XLA may sum the padded rows as a tree), which costs a few ulps of
  the largest summand where terms cancel;
- distances (K1): rtol 1e-5 — d squares summed per column block;
- Gram-form distances (K2, n > 64): rtol and atol 1e-4, as
  tests/test_pallas.py allows the Gram form — |a|^2 + |b|^2 - 2a.b cancels
  to a few ulps of the squared norms;
- finite-only mean (K6): rtol 1e-5, atol 1e-6 against the Pallas kernel and
  the float64 oracle, as tests/test_pallas.py holds the Pallas kernel;
- the centring median: within 1 ulp of ``np.nanmedian``.
The CUDA kernels themselves run only on the GPU: ``chip_smoke.py`` and
tests/test_torch_gpu.py hold them against these plain versions there.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from aggregathor_tpu.gars import oracle
from aggregathor_tpu.gars.averaged_median import averaged_median_columns
from aggregathor_tpu.gars.common import pairwise_sq_distances as jnp_pairwise_sq_distances
from aggregathor_tpu.gars.median import median_columns
from aggregathor_tpu.gars.trimmed_mean import trimmed_mean_columns
from aggregathor_tpu.ops import pallas_kernels as pk
from aggregathor_tpu_torch.ops import kernels

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

RTOL_MEAN, ATOL_MEAN = 1e-6, 1e-6
RTOL_DIST = 1e-5


def _matrix(n, d, seed, kind):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, d)).astype(np.float32)
    if kind == "ties":
        g = np.round(g, 1)  # many equal values in every column
        g[n - 1] = g[0]
    elif kind == "poison":
        g[n // 2, :] = np.nan
        g[:, 1] = np.nan
        g[:, 2] = np.inf
        g[:, 3] = -np.inf
        g[rng.random(size=g.shape) < 0.05] = np.nan
        g[rng.random(size=g.shape) < 0.03] = np.inf
        g[rng.random(size=g.shape) < 0.03] = -np.inf
        g[:, 4] = 0.25
    return g


CASES = [
    (8, 127, 0, "poison"),
    (8, 128, 1, "ties"),
    (11, 129, 2, "poison"),
    (5, 1025, 3, "poison"),
    (16, 129, 4, "ties"),
    (3, 128, 5, "clean"),
]
CASE_IDS = ["n%d-d%d-%s" % (n, d, kind) for n, d, _, kind in CASES]
# beyond 64 rows the Pallas kernels rank with their ``fori_loop`` tier, and
# the CUDA kernels with a sort (chip_smoke.py holds those against these plain
# versions on the card)
RANK_CASES = CASES + [
    (65, 129, 6, "poison"),
    (110, 257, 7, "ties"),
    (128, 129, 8, "poison"),
    (128, 200, 9, "ties"),
    (129, 257, 10, "poison"),
    (129, 130, 11, "ties"),
]
RANK_CASE_IDS = ["n%d-d%d-%s" % (n, d, kind) for n, d, _, kind in RANK_CASES]


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", RANK_CASES, ids=RANK_CASE_IDS)
def test_median_matches_pallas_and_jnp_exactly(case):
    n, d, seed, kind = case
    g = _matrix(n, d, seed, kind)
    got = kernels.coordinate_median(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, np.asarray(pk.coordinate_median(g)))
    np.testing.assert_array_equal(got, np.asarray(median_columns(g, n)))


@pytest.mark.parametrize("case", RANK_CASES, ids=RANK_CASE_IDS)
def test_averaged_median_matches_pallas_and_jnp(case):
    n, d, seed, kind = case
    g = _matrix(n, d, seed, kind)
    for beta in sorted({1, max(1, n - 2), n}):
        got = kernels.coordinate_averaged_median(torch.from_numpy(g), beta).numpy()
        _close(got, np.asarray(pk.coordinate_averaged_median(g, beta)), RTOL_MEAN, ATOL_MEAN)
        _close(got, np.asarray(averaged_median_columns(g, n, beta)), RTOL_MEAN, ATOL_MEAN)


@pytest.mark.parametrize("case", RANK_CASES, ids=RANK_CASE_IDS)
def test_trimmed_mean_matches_pallas_and_jnp(case):
    n, d, seed, kind = case
    g = _matrix(n, d, seed, kind)
    for trim in sorted({0, (n - 1) // 2, min(2, (n - 1) // 2)}):
        keep = n - 2 * trim
        got = kernels.coordinate_trimmed_mean(torch.from_numpy(g), trim, keep).numpy()
        _close(got, np.asarray(pk.coordinate_trimmed_mean(g, trim, keep)), RTOL_MEAN, ATOL_MEAN)
        _close(got, np.asarray(trimmed_mean_columns(g, n, trim)), RTOL_MEAN, ATOL_MEAN)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_pairwise_distances_match_pallas_and_jnp(case):
    n, d, seed, kind = case
    g = _matrix(n, d, seed, kind)
    if kind == "poison":
        g[:, 1:4] = 0.5  # whole non-finite columns would make every distance NaN
    got = kernels.pairwise_sq_distances(torch.from_numpy(g)).numpy()
    _close(got, np.asarray(pk.pairwise_sq_distances(g, use_mxu=False)), RTOL_DIST)
    _close(got, np.asarray(jnp_pairwise_sq_distances(g)), RTOL_DIST)
    finite_rows = np.all(np.isfinite(g), axis=1)
    assert np.all(np.diag(got)[finite_rows] == 0.0)
    assert not np.isfinite(got[~finite_rows]).any()  # a non-finite row poisons its
    assert not np.isfinite(got[:, ~finite_rows]).any()  # row and column, diagonal included


def test_nan_row_poisons_its_row_and_column():
    g = _matrix(6, 300, 9, "clean")
    g[2, 17] = np.nan
    got = kernels.pairwise_sq_distances(torch.from_numpy(g)).numpy()
    assert np.all(np.isnan(got[2])) and np.all(np.isnan(got[:, 2]))
    others = np.delete(np.delete(got, 2, axis=0), 2, axis=1)
    assert np.all(np.isfinite(others))


def test_cpu_calls_use_plain_versions_and_count_no_launch():
    before = kernels.launch_counts()
    g = torch.from_numpy(_matrix(8, 129, 11, "poison"))
    for name, plain in kernels.PLAIN.items():
        args = {"coordinate_averaged_median": (6,), "coordinate_trimmed_mean": (2, 4)}.get(name, ())
        x = g.clone()
        if name == "pairwise_sq_distances":
            x[:, 1:4] = 0.5
        got, want = getattr(kernels, name)(x, *args), plain(x, *args)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("bad, error", [
    (torch.zeros((4, 8), dtype=torch.float64), TypeError),
    (torch.zeros(8), ValueError),
    (torch.zeros((4, 0)), ValueError),
    (torch.zeros((8, 4)).t(), ValueError),
    (torch.zeros((4, 8), device="meta"), ValueError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad, error):
    for name in kernels.PLAIN:
        args = {"coordinate_averaged_median": (1,), "coordinate_trimmed_mean": (0, 1)}.get(name, ())
        with pytest.raises(error):
            getattr(kernels, name)(bad, *args)


def test_selection_arguments_are_checked():
    x = torch.zeros((4, 8))
    for beta in (0, 5):
        with pytest.raises(ValueError):
            kernels.coordinate_averaged_median(x, beta)
    for trim, keep in ((-1, 2), (0, 0), (3, 2)):
        with pytest.raises(ValueError):
            kernels.coordinate_trimmed_mean(x, trim, keep)


def test_sort_shape_pads_to_a_power_of_two_and_fits_shared_memory():
    # the (P, lanes, stride) instances of coordinate.cu's sort, which refuses any other layout
    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc", "coordinate.cu")) as fd:
        instances = {tuple(map(int, m)) for m in re.findall(r"launch_sort<(\d+), (\d+), (\d+)>", fd.read())}
    assert {p for p, _, _ in instances} == {128, 256, 512, 1024}
    for n in range(1, kernels.SORT_MAX_ROWS + 1):
        p, lanes, columns, stride = kernels.sort_shape(n)
        assert p & (p - 1) == 0 and p >= n and (p == 128 or p < 2 * n)  # the next power of two >= n
        assert (p, lanes, stride) in instances
        assert lanes * columns == kernels.SORT_BLOCK_THREADS and 32 % lanes == 0  # whole groups in every warp
        assert stride >= columns
        # the dynamic (n, stride) tile, within both the 48 KB that needs no
        # opt-in attribute and the H100's 227 KB a block
        assert n * stride * 4 <= 48 * 1024
        # a warp's (row, column) reads of the staged tile land on 32 distinct banks
        banks = {(row * stride + col) % 32 for row in range(lanes) for col in range(32 // lanes)}
        assert len(banks) == 32
    assert kernels.sort_shape(kernels.SORT_MAX_ROWS + 1) == (0, 0, 0, 0)  # the re-reading path


_LAYOUT_SHIM = r"""
#include "distances_layout.h"
extern "C" void layout(int n, long long d, int sms, long long* out) {
  const k1::Layout l = k1::distance_layout(n, d, sms);
  out[0] = l.rows; out[1] = l.threads; out[2] = l.blocks; out[3] = l.chunk; out[4] = l.smem;
  out[5] = k1::first_cover(n, k1::RegisterRows{});
}
"""


@pytest.fixture(scope="module")
def distance_layout(tmp_path_factory):
    """K1's launch layout (ops/csrc/distances_layout.h, the one distances.cu
    launches with), built by the host C++ compiler: (n, d, sms) -> (rows of
    the instance, threads, blocks, chunk, shared bytes, the register
    instance's rows or 0)."""
    compiler = shutil.which("c++") or shutil.which("g++")
    if compiler is None:
        pytest.skip("no host C++ compiler to build distances_layout.h")
    tmp = tmp_path_factory.mktemp("distances_layout")
    (tmp / "shim.cpp").write_text(_LAYOUT_SHIM)
    subprocess.run([compiler, "-std=c++17", "-shared", "-fPIC", "-I", os.path.join(os.path.dirname(kernels.__file__),
                    "csrc"), "-o", str(tmp / "liblayout.so"), str(tmp / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(tmp / "liblayout.so"))
    lib.layout.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]

    def layout(n, d, sms):
        out = (ctypes.c_longlong * 6)()
        lib.layout(n, d, sms, out)
        return tuple(out)

    return layout


@pytest.mark.parametrize("d", [1, 129, 4098, 4099, 1756682])
def test_distance_layout_fits_the_kernel_and_covers_d(distance_layout, d):
    """For every n K1 serves, on the H100 SXM's 132 SMs and the PCIe card's
    114: an instance whose rows cover n, whole warps, shared memory within
    the block's attribute (and the SM's, for the blocks an SM the grid
    assumes), a grid that covers d in whole units, one wave."""
    for sms in (132, 114):
        for n in range(1, kernels.DISTANCE_MAX_ROWS + 1):
            rows, threads, blocks, chunk, smem, register_rows = distance_layout(n, d, sms)
            assert rows >= n
            if register_rows:  # one instance per n
                assert rows == register_rows == n <= 20 and threads == 256
                assert 4 * threads // 32 * rows * (rows + 1) // 2 <= smem <= 48 * 1024  # the warps' sums, no opt-in
                unit, per_sm = 2, 2 if n <= 11 else 1  # registers for two blocks an SM up to 11 rows
            else:
                assert rows in (32, 64) and rows < 2 * n and n > 20
                assert smem <= 232448  # the H100's most a block may opt in to
                # the two blocks an SM the grid assumes, each ring and its 1 KB
                # of reserve within the SM's 228 KB of shared memory
                assert 2 * (smem + 1024) <= 233472
                unit, per_sm = 128, 2
            assert threads % 32 == 0 and threads <= 256
            assert smem >= 4 * threads  # the last block's slices of the final sum
            assert chunk % unit == 0
            assert (blocks - 1) * chunk < d <= blocks * chunk
            assert blocks <= sms * per_sm


@pytest.mark.parametrize("n", [65, 72, 127, 128, 129, 130, 256, 512])
def test_gram_chunk_covers_the_card_with_whole_slabs(n):
    tiles = -(-n // kernels.GRAM_TILE)
    pairs = tiles * (tiles + 1) // 2
    assert tiles == (1 if n <= 128 else -(-n // 128))  # n <= 128: one block a chunk covers every pair
    for d in (1, 31, 129, 4099, 1756682):
        chunk = kernels.gram_chunk(n, d)
        nb_chunks = -(-d // chunk)
        assert chunk % kernels.GRAM_SLAB == 0 and chunk >= kernels.GRAM_SLAB
        assert (nb_chunks - 1) * chunk < d <= nb_chunks * chunk
        if d >= kernels.GRAM_TARGET_BLOCKS * kernels.GRAM_SLAB:
            assert pairs * nb_chunks >= kernels.GRAM_TARGET_BLOCKS


# --------------------------------------------------------------------------- #
# K6: the finite-only column mean

def _lossy_matrix(n, d, seed):
    g = _matrix(n, d, seed, "poison")  # NaN row, NaN/+-inf columns and entries
    g[:, 6] = np.nan
    g[1::2, 6] = np.inf  # an all-non-finite column of both kinds
    g[:, 7] = np.nan
    g[n - 1, 7] = 3.5  # a single finite survivor
    return g


@pytest.mark.parametrize("n, d", [(8, 128), (11, 129), (5, 384)])
def test_average_nan_matches_pallas_and_the_oracle(n, d):
    g = _lossy_matrix(n, d, d)
    got = kernels.average_nan_columns(torch.from_numpy(g)).numpy()
    assert got.shape == (d,) and np.all(np.isfinite(got))
    assert got[2] == 0.0 and got[6] == 0.0 and got[7] == 3.5
    np.testing.assert_allclose(got, np.asarray(pk.average_nan_columns(g, block_d=128)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle.average_nan(g), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# The centring median (trap a: numpy averages an even count's middle pair)

def test_nanmedian_columns_is_numpys_rule():
    x = np.array([[1.0, 5.0, np.nan, np.nan, 2.0],
                  [2.0, np.inf, np.nan, 7.0, -np.inf],
                  [3.0, 1.0, np.inf, np.nan, 4.0],
                  [4.0, 3.0, -np.inf, np.nan, np.nan]], np.float32)
    got = kernels.nanmedian_columns(torch.from_numpy(x)).numpy()
    # [1,2,3,4] -> 2.5 (torch.nanmedian would give 2); inf ignored; nothing finite -> 0
    np.testing.assert_array_equal(got, np.array([2.5, 3.0, 0.0, 7.0, 3.0], np.float32))


@pytest.mark.parametrize("n, d, seed", [(65, 257, 0), (72, 129, 1), (8, 1000, 2), (7, 300, 3),
                                         (110, 129, 4), (128, 257, 5), (129, 200, 6)])
def test_nanmedian_columns_matches_numpy_within_one_ulp(n, d, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, d)).astype(np.float32)
    g[rng.random(size=g.shape) < 0.2] = np.nan
    g[rng.random(size=g.shape) < 0.05] = np.inf
    g[rng.random(size=g.shape) < 0.05] = -np.inf
    g[:, 0] = np.nan  # nothing finite
    g[:, 1] = np.round(g[:, 1], 1)  # ties
    g[1:, 2] = np.nan  # one finite value
    g[2:, 3] = np.inf  # two finite values: their mean
    got = kernels.nanmedian_columns(torch.from_numpy(g)).numpy()
    want = np.nan_to_num(np.nanmedian(np.where(np.isfinite(g), g, np.nan), axis=0)).astype(np.float32)
    assert got[0] == 0.0
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()


# --------------------------------------------------------------------------- #
# K2: Gram-form distances beyond 64 rows

def _gram_input(n, d, seed):
    g = _matrix(n, d, seed, "clean")
    g[n // 3] = np.nan  # a dead worker
    g[1, 5:d:7] = np.nan  # scattered NaN in another row
    g[0:(n // 2 + 1), 10] = np.nan  # a majority-NaN column
    g[4:8] += 3.0  # a shifted group: distances of several scales
    return g


@pytest.mark.parametrize("d", [128, 129, 700])
@pytest.mark.parametrize("n", [65, 72, 130])
def test_gram_distances_match_pallas_and_the_oracle(n, d):
    g = _gram_input(n, d, n + d)
    got = kernels.pairwise_sq_distances(torch.from_numpy(g)).numpy()
    want = np.array(pk.pairwise_sq_distances(g, block_d=128))  # n > 64: the Gram kernel
    finite_rows = np.all(np.isfinite(g), axis=1)
    rows = np.flatnonzero(finite_rows)
    want[rows, rows] = 0.0  # as tests/test_pallas.py: the Pallas diagonal is only ~0
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _close(got, want, 1e-4, 1e-4)
    assert finite_rows.sum() >= n // 3  # the rows outside the majority-NaN column's NaN run
    clean = np.ix_(finite_rows, finite_rows)
    assert np.all(np.isfinite(got[clean]))  # the majority-NaN column poisons only its rows
    assert np.all(np.isnan(got[~finite_rows])) and np.all(np.isnan(got[:, ~finite_rows]))
    assert np.all(np.diag(got)[finite_rows] == 0.0) and np.all(got[clean] >= 0.0)
    np.testing.assert_array_equal(got, got.T)
    ref = oracle._pairwise_sq_distances(g[finite_rows].astype(np.float64))
    np.testing.assert_allclose(got[clean], ref, rtol=1e-4, atol=1e-4)


def test_gram_plain_is_the_centred_form_clamped():
    g = _gram_input(70, 300, 4)
    x = torch.from_numpy(g)
    centred = x - kernels.nanmedian_columns(x)[None, :]
    got = kernels.pairwise_sq_distances_gram(centred)
    assert torch.equal(torch.isnan(got), torch.isnan(kernels.pairwise_sq_distances(x)))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(kernels.pairwise_sq_distances(x)))
    # distances are translation-invariant: the raw rows give the same matrix within the Gram tolerance
    raw = kernels.pairwise_sq_distances_gram(x).numpy()
    _close(raw, got.numpy(), 1e-4, 1e-3)


@pytest.mark.parametrize("n, d, seed", [(65, 129, 0), (70, 300, 1), (128, 257, 2), (130, 128, 3)])
def test_gram_plain_takes_the_centre_bit_for_bit(n, d, seed):
    """K2's plain version with a centre is the old route on ``x - centre``,
    and the CPU distances beyond 64 rows are unchanged bit for bit."""
    x = torch.from_numpy(_gram_input(n, d, seed))
    centre = kernels.nanmedian_columns_plain(x)
    want = kernels.pairwise_sq_distances_gram_plain(x - centre[None, :])
    for got in (kernels.pairwise_sq_distances_gram_plain(x, centre), kernels.pairwise_sq_distances_gram(x, centre),
                kernels.pairwise_sq_distances(x), kernels.pairwise_sq_distances_plain(x)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("centre, error", [
    (torch.zeros(299), ValueError),
    (torch.zeros((1, 300)), ValueError),
    (torch.zeros(300, dtype=torch.float64), TypeError),
    (torch.zeros(600)[::2], ValueError),
    (np.zeros(300, np.float32), TypeError),
])
def test_gram_refuses_a_centre_it_does_not_take(centre, error):
    with pytest.raises(error):
        kernels.pairwise_sq_distances_gram(torch.zeros((70, 300)), centre)


def _tf32_rna(v):
    """cvt.rna.tf32.f32 on float32 values: the 13 low mantissa bits rounded to
    nearest, ties away from zero (on the magnitude), for finite values."""
    rounded = ((v.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return np.where(np.isfinite(v), rounded, v)


def _k2_emulated(x, centre, chunk):
    """K2's arithmetic in numpy: centre, split v = hi + lo in TF32, per slab
    of 32 columns lo.hi + hi.lo + hi.hi from zero (TF32 products are exact in
    float32), slabs folded in float32 per chunk, chunks summed in order, then
    (G_ii + G_jj) - 2 G_ij clamped at 0.  The tensor cores' own accumulation
    inside a slab is not emulated (float32 BLAS stands in for it), so the
    card's check against the plain version stays the judge."""
    v = (x - centre[None, :]).astype(np.float32)
    hi = _tf32_rna(v)
    lo = _tf32_rna((v - hi).astype(np.float32))
    n, d = v.shape
    gram = np.zeros((n, n), np.float32)
    for c0 in range(0, d, chunk):
        acc = np.zeros((n, n), np.float32)
        for s0 in range(c0, min(c0 + chunk, d), kernels.GRAM_SLAB):
            h, l = hi[:, s0:s0 + kernels.GRAM_SLAB], lo[:, s0:s0 + kernels.GRAM_SLAB]
            acc += (l @ h.T + h @ l.T) + h @ h.T
        gram += acc
    norms = np.diag(gram)
    dist = (norms[:, None] + norms[None, :]) - np.float32(2.0) * gram
    return np.maximum(dist, np.float32(0.0))


def test_k2_tf32_split_arithmetic_keeps_the_tolerance_and_krums_choice():
    """The design's error on the CPU, before the card sees it: mixed row
    scales and a separated attacker group at (128, 65,536)."""
    from aggregathor_tpu_torch import gars

    n, d, f = 128, 65536, 8
    rng = np.random.default_rng(17)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x *= (1.0 + 0.01 * np.arange(n, dtype=np.float32))[:, None]  # row scales 1 to 2.27
    x[:f] += np.float32(25.0)  # the attackers, off to one side
    x *= np.exp(rng.normal(scale=1.0, size=d)).astype(np.float32)[None, :]  # column scales
    x += np.float32(10.0)  # an offset the centring removes
    xt = torch.from_numpy(x)
    centre = kernels.nanmedian_columns_plain(xt).numpy()
    got = _k2_emulated(x, centre, kernels.gram_chunk(n, d))
    rows = x.astype(np.float64) - centre.astype(np.float64)[None, :]
    norms = np.sum(rows * rows, axis=1)
    exact = np.maximum(norms[:, None] + norms[None, :] - 2.0 * rows @ rows.T, 0.0)
    scale = norms[:, None] + norms[None, :]
    err = np.abs(got.astype(np.float64) - exact)
    assert np.all(np.diag(got) == 0.0) and np.array_equal(got, got.T)
    assert np.max(err / scale) <= 1e-5, np.max(err / scale)
    gar = gars.instantiate("krum", n, f)
    plain = gar.selection_weights(kernels.pairwise_sq_distances_plain(xt))
    assert torch.equal(gar.selection_weights(torch.from_numpy(got)), plain)
    assert torch.all(plain[:f] == 0)  # the attackers are not selected
