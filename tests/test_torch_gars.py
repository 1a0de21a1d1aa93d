"""The port's GARs against the JAX package's rules, on the same numpy inputs.

Each ported rule aggregates the same (n, d) matrix in both packages (the
port on the CPU, i.e. through its kernels' plain versions; the JAX package
through its default jnp tier).  Krum's and Bulyan's selection weights must
be identical, both from one shared distance matrix and from each package's
own, also beyond 64 workers where both take the median-centred Gram form;
aggregates match within rtol 1e-5 / atol 1e-6 (float32 sums of up to n
rows in another order, and distances summed in another order); NaN/inf
patterns match exactly.  Infeasible (n, f) raise UserException in both.
"""

import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch.gars.common import smallest_k_mask
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

RULES = ["average", "average-nan", "krum", "median", "averaged-median", "bulyan", "trimmed-mean"]


def _rows(n, d, seed, kind):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, d)).astype(np.float32)
    if kind == "nan-row":
        g[1, :] = np.nan  # a dead worker
        g[n - 1, rng.random(d) < 0.2] = np.inf
    elif kind == "outliers":
        g[:2] *= -50.0  # two loud attackers
        g[:, 3] = 0.5   # a column of ties
    elif kind == "ties":
        g = np.round(g, 1)
        g[n - 1] = g[n - 2]
    return g


def _close(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-6)


CASES = [(11, 2, 300, 0, "clean"), (11, 2, 257, 1, "nan-row"), (15, 3, 130, 2, "outliers"), (8, 1, 129, 3, "ties")]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("case", CASES, ids=[c[4] for c in CASES])
def test_rule_matches_jax(rule, case):
    n, f, d, seed, kind = case
    g = _rows(n, d, seed, kind)
    want = np.asarray(jgars.instantiate(rule, n, f).aggregate(g))
    got = tgars.instantiate(rule, n, f).aggregate(torch.from_numpy(g)).numpy()
    assert got.shape == (d,) and got.dtype == np.float32
    _close(got, want)


@pytest.mark.parametrize("rule", ["krum", "bulyan"])
@pytest.mark.parametrize("case", CASES, ids=[c[4] for c in CASES])
def test_selection_weights_identical(rule, case):
    from aggregathor_tpu.gars.common import pairwise_sq_distances as jnp_distances
    from aggregathor_tpu_torch.ops import kernels

    n, f, d, seed, kind = case
    g = _rows(n, d, seed, kind)
    jgar, tgar = jgars.instantiate(rule, n, f), tgars.instantiate(rule, n, f)
    jdist = np.asarray(jnp_distances(g))
    # one shared distance matrix: the selection logic alone
    want = np.asarray(jgar.selection_weights(jdist))
    jgar._drop_memos()
    np.testing.assert_array_equal(tgar.selection_weights(torch.tensor(jdist)).numpy(), want)
    # each package's own distances: the selection end to end
    tdist = torch.clamp_min(kernels.pairwise_sq_distances(torch.from_numpy(g)), 0.0)
    np.testing.assert_array_equal(tgar.selection_weights(tdist).numpy(), want)


@pytest.mark.parametrize("rule", ["krum", "bulyan"])
@pytest.mark.parametrize("n", [72, 96])
def test_selections_beyond_64_workers_identical(rule, n):
    """n > 64: the port's Gram form (K2's plain version) and the JAX rule's
    centred Gram form pick the same rows; attackers are a separated set."""
    from aggregathor_tpu.gars.common import pairwise_sq_distances as jnp_distances
    from aggregathor_tpu_torch.ops import kernels

    f, d = 8, 1000  # n^2 d > 2^22: the JAX rule takes its Gram form too
    rng = np.random.default_rng(n)
    g = rng.normal(size=(n, d)).astype(np.float32)
    g *= (1.0 + 0.02 * np.arange(n, dtype=np.float32))[:, None]  # honest rows at distinct scales
    g[:f] += 25.0  # the attackers, far from everyone
    g[n - 5] = np.nan  # a dead worker
    jgar, tgar = jgars.instantiate(rule, n, f), tgars.instantiate(rule, n, f)
    want = np.asarray(jgar.selection_weights(np.asarray(jnp_distances(g))))
    jgar._drop_memos()
    tdist = kernels.pairwise_sq_distances(torch.from_numpy(g))
    got = tgar.selection_weights(tdist).numpy()
    np.testing.assert_array_equal(got, want)
    chosen = np.flatnonzero(got.reshape(-1, n).sum(axis=0))
    assert chosen.min() >= f and n - 5 not in chosen
    _close(tgar.aggregate(torch.from_numpy(g)).numpy(), np.asarray(jgar.aggregate(g)))


def test_selection_weights_identical_on_tied_and_poisoned_distances():
    rng = np.random.default_rng(7)
    for trial, n in enumerate((7, 11, 15, 7, 11, 15)):
        dist = np.round(rng.random((n, n)) * 4.0).astype(np.float32)  # many ties
        dist = (dist + dist.T) / 2
        np.fill_diagonal(dist, 0.0)
        dist[rng.random((n, n)) < 0.1] = np.nan
        dist[rng.random((n, n)) < 0.1] = np.inf
        for rule, f in (("krum", (n - 3) // 2), ("bulyan", (n - 3) // 4)):
            jgar, tgar = jgars.instantiate(rule, n, f), tgars.instantiate(rule, n, f)
            want = np.asarray(jgar.selection_weights(dist))
            jgar._drop_memos()
            got = tgar.selection_weights(torch.tensor(dist)).numpy()
            np.testing.assert_array_equal(got, want, err_msg="%s trial %d" % (rule, trial))


def test_smallest_k_mask_breaks_ties_to_the_lower_index():
    from aggregathor_tpu.gars.common import smallest_k_mask as jax_mask

    scores = np.array([3.0, 1.0, np.nan, 1.0, np.inf, 0.5, 1.0], np.float32)
    for k in range(len(scores) + 1):
        np.testing.assert_array_equal(
            smallest_k_mask(torch.from_numpy(scores), k).numpy(), np.asarray(jax_mask(scores, k))
        )


@pytest.mark.parametrize("rule, n, f", [
    ("krum", 4, 2), ("krum", 2, 0), ("bulyan", 10, 2), ("bulyan", 6, 1),
    ("trimmed-mean", 4, 2), ("median", 3, 3), ("average", 2, 2), ("averaged-median", 0, 0),
    ("average-nan", 3, 3),
])
def test_infeasible_configurations_raise_like_jax(rule, n, f):
    with pytest.raises(JaxUserException):
        jgars.instantiate(rule, n, f)
    with pytest.raises(UserException):
        tgars.instantiate(rule, n, f)


def test_trimmed_mean_trim_argument_and_spec_forms():
    g = _rows(9, 100, 4, "outliers")
    for spec, args in (("trimmed-mean:trim=1", None), ("trimmed-mean(trim=1)", None), ("trimmed-mean", ["trim:1"])):
        want = np.asarray(jgars.instantiate(spec, 9, 3, args).aggregate(g))
        got = tgars.instantiate(spec, 9, 3, args).aggregate(torch.from_numpy(g)).numpy()
        _close(got, want)
    with pytest.raises(UserException):
        tgars.instantiate("trimmed-mean", 9, 3, ["trimm:1"])


def test_registry_names_exist_in_the_jax_package():
    names = tgars.itemize()
    assert set(RULES) <= set(names)
    assert set(names) <= set(jgars.itemize())
    for name in ("krum-py", "krum-tf", "krum-co", "bulyan-py", "bulyan-co", "median-pallas",
                 "averaged-median-pallas", "trimmed-mean-pallas", "krum-pallas", "bulyan-pallas"):
        assert name in names
    assert "average-nan-pallas" in names  # K6 serves it, as it serves average-nan
    assert type(tgars.instantiate("average-nan-pallas", 8, 2)) is type(tgars.instantiate("average-nan", 8, 2))
    with pytest.raises(UserException):
        tgars.instantiate("no-such-rule", 8, 2)


@pytest.mark.parametrize("alias, rule", [("krum-pallas", "krum"), ("bulyan-pallas", "bulyan"),
                                          ("median-pallas", "median"), ("trimmed-mean-pallas", "trimmed-mean"),
                                          ("averaged-median-pallas", "averaged-median"),
                                          ("average-nan-pallas", "average-nan")])
def test_pallas_names_match_the_jax_kernel_tier(alias, rule):
    g = _rows(11, 160, 5, "nan-row")
    want = np.asarray(jgars.instantiate(alias, 11, 2).aggregate(g))
    got = tgars.instantiate(alias, 11, 2).aggregate(torch.from_numpy(g)).numpy()
    assert type(tgars.instantiate(alias, 11, 2)) is type(tgars.instantiate(rule, 11, 2))
    _close(got, want)
