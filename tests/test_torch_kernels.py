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
- distances (K1): rtol 1e-5 — d squares summed per column block.
The CUDA kernels themselves run only on the GPU: ``chip_smoke.py`` and
tests/test_torch_gpu.py hold them against these plain versions there.
"""

import numpy as np
import pytest
import torch

from aggregathor_tpu.gars.averaged_median import averaged_median_columns
from aggregathor_tpu.gars.common import pairwise_sq_distances as jnp_pairwise_sq_distances
from aggregathor_tpu.gars.median import median_columns
from aggregathor_tpu.gars.trimmed_mean import trimmed_mean_columns
from aggregathor_tpu.ops import pallas_kernels as pk
from aggregathor_tpu_torch.ops import kernels

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


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_median_matches_pallas_and_jnp_exactly(case):
    n, d, seed, kind = case
    g = _matrix(n, d, seed, kind)
    got = kernels.coordinate_median(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, np.asarray(pk.coordinate_median(g)))
    np.testing.assert_array_equal(got, np.asarray(median_columns(g, n)))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_averaged_median_matches_pallas_and_jnp(case):
    n, d, seed, kind = case
    g = _matrix(n, d, seed, kind)
    for beta in sorted({1, max(1, n - 2), n}):
        got = kernels.coordinate_averaged_median(torch.from_numpy(g), beta).numpy()
        _close(got, np.asarray(pk.coordinate_averaged_median(g, beta)), RTOL_MEAN, ATOL_MEAN)
        _close(got, np.asarray(averaged_median_columns(g, n, beta)), RTOL_MEAN, ATOL_MEAN)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
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


def test_distance_chunk_fits_shared_memory():
    for n in range(1, kernels.DISTANCE_MAX_ROWS + 1):
        chunk = kernels.distance_chunk(n)
        assert chunk & (chunk - 1) == 0 and 32 <= chunk <= 1024
        assert n * chunk * 4 <= 65536
