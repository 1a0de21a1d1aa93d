"""The port's CUDA kernels and its main path on the GPU.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
module imports nothing of JAX, so on a machine with the card and without JAX
it runs alone, skipping the suite's conftest (which configures JAX)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances, each from the order of summation: K3 bit-exact (it returns one
of the original values); K4, K5 rtol 1e-6 plus atol 1e-6 on unit-scale
inputs (means of up to n float32 values summed in another order); K1 rtol
1e-5 (d squares summed per column chunk, then across chunks).
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


@pytest.mark.gpu
@pytest.mark.parametrize("n, d", [(11, 5001), (8, 1023), (64, 2049), (3, 129)])
@pytest.mark.parametrize("name", sorted(kernels.PLAIN))
def test_cuda_kernels_match_plain(cuda_device, name, n, d):
    x = torch.from_numpy(_poisoned(n, d, 13, name == "pairwise_sq_distances")).to(cuda_device)
    trim = (n - 1) // 4
    args = {"coordinate_averaged_median": (max(1, n - 4),),
            "coordinate_trimmed_mean": (trim, n - 2 * trim)}.get(name, ())
    before = kernels.launch_counts()[name]
    got = getattr(kernels, name)(x, *args).cpu().numpy()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    want = kernels.PLAIN[name](x, *args).cpu().numpy()
    if name == "coordinate_median":
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    elif name == "pairwise_sq_distances":
        _close(got, want, 1e-5)
    else:
        _close(got, want, 1e-6, 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65, 256])
def test_rank_kernels_beyond_64_rows(cuda_device, n):
    x = torch.from_numpy(_poisoned(n, 3001, 5, False)).to(cuda_device)
    median = kernels.coordinate_median(x).cpu().numpy()
    np.testing.assert_array_equal(median.view(np.int32),
                                  kernels.coordinate_median_plain(x).cpu().numpy().view(np.int32))
    _close(kernels.coordinate_averaged_median(x, n - 10).cpu().numpy(),
           kernels.coordinate_averaged_median_plain(x, n - 10).cpu().numpy(), 1e-6, 1e-6)
    _close(kernels.coordinate_trimmed_mean(x, 10, n - 20).cpu().numpy(),
           kernels.coordinate_trimmed_mean_plain(x, 10, n - 20).cpu().numpy(), 1e-6, 1e-6)
    with pytest.raises(NotImplementedError, match="K2"):
        kernels.pairwise_sq_distances(x)


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
