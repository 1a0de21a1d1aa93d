"""The port's CUDA kernels and its main path on the GPU.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
module imports nothing of JAX, so on a machine with the card and without JAX
it runs alone, skipping the suite's conftest (which configures JAX)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances, each from the order of summation: K3 and the centring median
bit-exact (each returns original values, or the mean of two, as its plain
version computes it); K4, K5, K6 rtol 1e-6 plus atol 1e-6 on unit-scale
inputs (means of up to n float32 values summed in another order); K1 rtol
1e-5 (d squares summed per column chunk, then across chunks); K2, off the
diagonal, |a - b| <= 1e-5 (|x_i|^2 + |x_j|^2), the error scale of a Gram
form, whose terms are as large as the squared norms, with the same
non-finite pattern.
"""

import numpy as np
import pytest
import torch

from aggregathor_tpu_torch import gars, models
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.ops import kernels
from aggregathor_tpu_torch.parallel import RobustEngine, attacks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU (chip_smoke.py)")
    return torch.device("cuda")


def _poisoned(n, d, seed, distances):
    """Unit normals with a NaN row, scattered NaN/+-inf, a column of ties and
    two equal rows; whole non-finite columns only where ``distances`` is
    False (they would make every pairwise distance NaN)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, d)).astype(np.float32)
    g[n // 2, :] = np.nan
    g[rng.random(size=g.shape) < 0.02] = np.nan
    g[rng.random(size=g.shape) < 0.02] = np.inf
    g[rng.random(size=g.shape) < 0.02] = -np.inf
    if not distances:
        g[:, 1] = np.nan
        g[:, 2] = np.inf
    g[:, 4] = 0.25
    g[n - 1] = g[n - 2]
    return g


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=atol)


def _gram_close(got, want, x):
    """K2 against its plain version on the rows x (already centred)."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    norms = np.sum(np.square(x.astype(np.float64)), axis=1)
    scale = norms[:, None] + norms[None, :]
    finite = np.isfinite(want) & ~np.eye(len(x), dtype=bool)
    assert np.all(np.abs(got - want)[finite] <= 1e-5 * scale[finite])
    diagonal = np.isfinite(np.diag(want))
    assert np.all(np.diag(got)[diagonal] == 0.0) and np.array_equal(got, got.T, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n, d", [(11, 5001), (8, 1023), (64, 2049), (3, 129)])
@pytest.mark.parametrize("name", sorted(kernels.PLAIN))
def test_cuda_kernels_match_plain(cuda_device, name, n, d):
    x = torch.from_numpy(_poisoned(n, d, 13, name.startswith("pairwise"))).to(cuda_device)
    trim = (n - 1) // 4
    args = {"coordinate_averaged_median": (max(1, n - 4),),
            "coordinate_trimmed_mean": (trim, n - 2 * trim)}.get(name, ())
    before = kernels.launch_counts()[name]
    got = getattr(kernels, name)(x, *args).cpu().numpy()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    want = kernels.PLAIN[name](x, *args).cpu().numpy()
    if name in ("coordinate_median", "nanmedian_columns"):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    elif name == "pairwise_sq_distances":
        _close(got, want, 1e-5)
    elif name == "pairwise_sq_distances_gram":
        _gram_close(got, want, x.cpu().numpy())
    else:
        _close(got, want, 1e-6, 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65, 127, 128, 129, 256, 1000, 1030])
def test_rank_kernels_beyond_64_rows(cuda_device, n):
    """The sort path (64 < n <= 1024) and the re-reading path beyond it."""
    g = _poisoned(n, 3001, 5, False)
    g[: n // 2 + 1, 7] = np.nan  # a majority-NaN column
    g[::3, 8] = -0.0  # signed zeros tie with +0 and keep their sign
    g[:, 9] = np.round(g[:, 9], 0)  # heavy ties
    x = torch.from_numpy(g).to(cuda_device)
    for name in ("coordinate_median", "nanmedian_columns"):
        got = getattr(kernels, name)(x).cpu().numpy()
        np.testing.assert_array_equal(got.view(np.int32), kernels.PLAIN[name](x).cpu().numpy().view(np.int32))
    _close(kernels.coordinate_averaged_median(x, n - 10).cpu().numpy(),
           kernels.coordinate_averaged_median_plain(x, n - 10).cpu().numpy(), 1e-6, 1e-6)
    _close(kernels.coordinate_averaged_median(x, 1).cpu().numpy(),
           kernels.coordinate_averaged_median_plain(x, 1).cpu().numpy(), 1e-6, 1e-6)
    _close(kernels.coordinate_trimmed_mean(x, 10, n - 20).cpu().numpy(),
           kernels.coordinate_trimmed_mean_plain(x, 10, n - 20).cpu().numpy(), 1e-6, 1e-6)
    _close(kernels.coordinate_trimmed_mean(x, 0, n).cpu().numpy(),
           kernels.coordinate_trimmed_mean_plain(x, 0, n).cpu().numpy(), 1e-6, 1e-6)
    _close(kernels.average_nan_columns(x).cpu().numpy(),
           kernels.average_nan_columns_plain(x).cpu().numpy(), 1e-6, 1e-6)
    # beyond 64 rows the distances are K2's, on median-centred rows
    rows = torch.from_numpy(_poisoned(n, 3001, 6, True)).to(cuda_device)
    centred = rows - kernels.nanmedian_columns(rows)[None, :]
    got = kernels.pairwise_sq_distances(rows).cpu().numpy()
    _gram_close(got, kernels.pairwise_sq_distances_plain(rows).cpu().numpy(), centred.cpu().numpy())
    _gram_close(kernels.pairwise_sq_distances_gram(centred).cpu().numpy(), got, centred.cpu().numpy())


@pytest.mark.gpu
def test_distances_switch_from_k1_to_k2_past_64_rows(cuda_device):
    for n, launched in ((64, {"pairwise_sq_distances"}), (65, {"pairwise_sq_distances_gram", "nanmedian_columns"})):
        x = torch.randn((n, 1000), device=cuda_device)
        before = kernels.launch_counts()
        kernels.pairwise_sq_distances(x)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after} == {k: int(k in launched) for k in after}


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    before = kernels.launch_counts()
    for bad, error in ((torch.zeros((4, 8), dtype=torch.float64, device=cuda_device), TypeError),
                       (torch.zeros((8, 4), device=cuda_device).t(), ValueError)):
        for name in kernels.PLAIN:
            args = {"coordinate_averaged_median": (1,), "coordinate_trimmed_mean": (0, 1)}.get(name, ())
            with pytest.raises(error):
                getattr(kernels, name)(bad, *args)
    assert kernels.launch_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("rule, n, f, expected", [
    ("krum", 8, 2, {"pairwise_sq_distances"}),
    ("bulyan", 11, 2, {"pairwise_sq_distances", "coordinate_averaged_median"}),
    ("median", 8, 2, {"coordinate_median"}),
    ("trimmed-mean", 8, 2, {"coordinate_trimmed_mean"}),
    ("averaged-median", 8, 2, {"coordinate_averaged_median"}),
    ("average-nan", 8, 2, {"average_nan_columns"}),
    ("krum", 72, 8, {"pairwise_sq_distances_gram", "nanmedian_columns"}),
    ("bulyan", 80, 2, {"pairwise_sq_distances_gram", "nanmedian_columns", "coordinate_averaged_median"}),
    ("median", 72, 8, {"coordinate_median"}),
    ("trimmed-mean", 72, 8, {"coordinate_trimmed_mean"}),
])
def test_engine_steps_launch_the_kernels_and_match_the_cpu(cuda_device, rule, n, f, expected):
    finals = []
    for device in (cuda_device, torch.device("cpu")):
        exp = models.instantiate("mnist", ["hidden:16", "batch-size:16"])
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        engine = RobustEngine(gars.instantiate(rule, n, f), n, nb_real_byz=2,
                              attack=attacks.instantiate("signflip", n, 2), device=device)
        state = engine.init_state(exp.init(3), tx, seed=3)
        step = engine.build_step(exp.loss, tx)
        it = exp.make_train_iterator(n, seed=4)
        before = kernels.launch_counts()
        for _ in range(3):
            state, _ = step(state, engine.put_batch(next(it)))
        launched = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        want = {k: (3 if k in expected and device.type == "cuda" else 0) for k in launched}
        assert launched == want
        finals.append(torch.cat([p.detach().cpu().reshape(-1) for p in state.params.values()]))
    torch.testing.assert_close(finals[0], finals[1], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("rule, expected", [("average-nan", {"average_nan_columns"}),
                                            ("krum", {"pairwise_sq_distances"}), ("average", set())])
def test_lossy_steps_drop_the_same_packets_as_the_cpu(cuda_device, rule, expected):
    from aggregathor_tpu_torch.parallel.lossy import LossyLink

    finals = []
    for device in (cuda_device, torch.device("cpu")):
        exp = models.instantiate("mnist", ["hidden:16", "batch-size:16"])
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        args = ["drop-rate:0.3", "packet-coords:1024", "min-coords:0"] + (["clever:true"] if rule == "average" else [])
        engine = RobustEngine(gars.instantiate(rule, 8, 2), 8, lossy_link=LossyLink(2, args), device=device)
        state = engine.init_state(exp.init(3), tx, seed=3)
        step = engine.build_step(exp.loss, tx)
        it = exp.make_train_iterator(8, seed=4)
        before = kernels.launch_counts()
        for _ in range(3):
            state, metrics = step(state, engine.put_batch(next(it)))
        launched = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        assert launched == {k: (3 if k in expected and device.type == "cuda" else 0) for k in launched}
        assert bool(torch.isfinite(metrics["total_loss"]))
        finals.append(torch.cat([p.detach().cpu().reshape(-1) for p in state.params.values()]))
    torch.testing.assert_close(finals[0], finals[1], rtol=1e-4, atol=1e-5)
