"""The port's CUDA kernels and its main path on the GPU.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
module imports nothing of JAX, so on a machine with the card and without JAX
it runs alone, skipping the suite's conftest (which configures JAX)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances, each from the order of summation: K3 and the centring median
bit-exact (each returns original values, or the mean of two, as its plain
version computes it); K4, K5, K6 rtol 1e-6 plus atol 1e-6 on unit-scale
inputs (means of up to n float32 values summed in another order); K1 rtol
1e-5 (d squares summed per thread, then by warp, block and across blocks);
K2, off the
diagonal, |a - b| <= 1e-5 (|x_i|^2 + |x_j|^2) on the centred rows, the
error scale of a Gram form, whose terms are as large as the squared norms,
with the same non-finite pattern, every non-finite entry NaN (a 3xTF32
split cannot keep float32's mix of +inf and NaN), the diagonal 0 and the
output symmetric bit for bit.  The rules on the card are also held against
the port's own copy of the numpy oracle (rtol 1e-4, atol 1e-5, as the JAX
package's tests hold its rules), K1 at the digits widths, three digits
steps against the CPU, and a checkpoint of a card state round trip.  The
input path: the vmapped worker gradients against a per-worker loop on the
card (each row within 1e-4 of its largest magnitude: batched and
per-worker convolutions sum in other orders), the prefetcher's hand-over
from its copy stream, and device-sampled, augmented steps against the CPU;
the chunk pipeline on the card (pinned ping-pong buffers, no second pin,
the sequential stream with every chunk held) and the GAR probe against the
CPU's on the same rows.  The guardian: a rollback restores its pinned
snapshot's parameters on the card bit for bit, and after each rebuild of
the engine the card holds, at the same point of the loop, what it held
before the first, within one cnnet state.  Secure submission: the row
digests and the masked group means are the CPU's bits on the card, and a
forge/tamper schedule rejects the same workers there as on the CPU.  The
transformer (config 5's widths): a bucket of each width through the
centring, K2 and Krum against the CPU, the switch MoE and the dense ring
attention, and the vmapped gradient with every warning an error.  Serving:
the median vote over a NaN replica is the clean replica's logits bit for
bit with one K3 launch a bucket call, no kernel library is built after the
warmup, and each vote rule's engine on the card matches the CPU's.
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
    """K2's output against ``want`` on the centred rows x: the same entries
    non-finite, each of them NaN in K2's output; the tolerance off the
    diagonal; the diagonal 0; symmetric bit for bit."""
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.all(np.isnan(got[~np.isfinite(got)]))
    norms = np.sum(np.square(x.astype(np.float64)), axis=1)
    scale = norms[:, None] + norms[None, :]
    finite = np.isfinite(want) & ~np.eye(len(x), dtype=bool)
    assert np.all(np.abs(got - want)[finite] <= 1e-5 * scale[finite])
    diagonal = np.isfinite(np.diag(want))
    assert np.all(np.diag(got)[diagonal] == 0.0)
    np.testing.assert_array_equal(got.view(np.int32), got.T.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n, d", [(11, 5001), (8, 1023), (64, 2049), (3, 129), (1, 129), (2, 4098), (16, 4099),
                                  (16, 2050), (17, 4098), (17, 1023), (20, 4099), (21, 4098), (33, 2049),
                                  (33, 4098)])
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
    centre = kernels.nanmedian_columns(rows)
    centred = (rows - centre[None, :]).cpu().numpy()
    got = kernels.pairwise_sq_distances(rows).cpu().numpy()
    _gram_close(got, kernels.pairwise_sq_distances_plain(rows).cpu().numpy(), centred)
    _gram_close(kernels.pairwise_sq_distances_gram(rows, centre).cpu().numpy(), got, centred)


@pytest.mark.gpu
@pytest.mark.parametrize("with_centre", [True, False])
@pytest.mark.parametrize("d", [4096, 4097, 4098, 4099])
@pytest.mark.parametrize("n", [65, 127, 128, 129, 256])
def test_gram_kernel_matches_plain_on_poisoned_rows(cuda_device, n, d, with_centre):
    """K2 on the raw rows, centred as it loads, at every width residue mod 4
    (its 8-byte copies for even widths, 4-byte for odd)."""
    g = _poisoned(n, d, n + d, True)
    g[: n // 2 + 1, 7] = np.nan  # a majority-NaN column
    x = torch.from_numpy(g).to(cuda_device)
    centre = kernels.nanmedian_columns(x) if with_centre else None
    before = kernels.launch_counts()["pairwise_sq_distances_gram"]
    got = kernels.pairwise_sq_distances_gram(x, centre).cpu().numpy()
    assert kernels.launch_counts()["pairwise_sq_distances_gram"] == before + 1
    rows = x if centre is None else x - centre[None, :]
    _gram_close(got, kernels.pairwise_sq_distances_gram_plain(x, centre).cpu().numpy(), rows.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 8, 11, 16, 17, 20, 21, 33, 64])
def test_distances_on_a_start_only_4_byte_aligned(cuda_device, n):
    """An even width on a start that is only 4-byte aligned: K1 takes its
    4-byte loads (register path) or copies (staged path)."""
    g = _poisoned(n, 4098, 17 + n, True)
    buffer = torch.empty(1 + n * 4098, device=cuda_device)
    buffer[1:] = torch.from_numpy(g.reshape(-1)).to(cuda_device)
    x = buffer[1:].view(n, 4098)
    assert x.data_ptr() % 8 == 4
    _close(kernels.pairwise_sq_distances(x).cpu().numpy(), kernels.pairwise_sq_distances_plain(x).cpu().numpy(), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 11, 64])
def test_distances_repeat_bit_for_bit(cuda_device, n):
    """Two calls on the cnnet-width matrix give the same bits: K1 adds no
    float atomics, and its last block sums the blocks' partials in order."""
    from chip_smoke import CNNET_D

    x = torch.randn((n, CNNET_D), device=cuda_device, generator=torch.Generator(device=cuda_device).manual_seed(n))
    first, second = kernels.pairwise_sq_distances(x), kernels.pairwise_sq_distances(x)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(3))
def test_krums_selection_near_a_tie_matches_the_cpu(cuda_device, case):
    """Multi-Krum's selection on the card equals the CPU plain path's when the
    two scores at the selection's boundary differ by a margin just above the
    distance kernels' measured error (``chip_smoke.NEAR_TIES``):

    - n = 8, f = 2 at d = 1,756,682 (K1): margin 2e-7 of the score; K1's
      scores were within 7.9e-8 of float64 there (the CPU's 7.5e-8);
    - n = 72 and 128, f = 8 at d = 100,003 (the centring and K2): margin
      1.5e-6; K2's scores were within 5.4e-7 (the CPU's 1.8e-7; K2's
      largest distance error 5.3 there, 2.5 at the (128, 1,756,682) main
      shape).
    Both selections must also equal the float64 one the rows were built for."""
    from chip_smoke import NEAR_TIES, krum_near_tie

    n, f, d, margin = NEAR_TIES[case]
    x, selected = krum_near_tie(torch, n, f, d, margin, n)
    gar = gars.instantiate("krum", n, f)
    on_card = gar.selection_weights(kernels.pairwise_sq_distances(x.to(cuda_device))).cpu() > 0
    on_cpu = gar.selection_weights(kernels.pairwise_sq_distances(x)) > 0
    assert torch.equal(on_card, on_cpu) and torch.equal(on_cpu, selected)


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


#: the rules against the port's numpy oracle, (rule, n, f): the main path's
#: sizes up to 64 workers, and beyond (K2, the sort path)
ORACLE_CASES = [("average", 11, 3), ("average-nan", 11, 3), ("krum", 11, 3), ("median", 11, 3),
                ("averaged-median", 11, 3), ("bulyan", 11, 2), ("trimmed-mean", 11, 3),
                ("krum", 72, 8), ("bulyan", 72, 8), ("median", 72, 8), ("trimmed-mean", 72, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("rule, n, f", ORACLE_CASES)
def test_rules_on_the_card_match_the_numpy_oracle(cuda_device, rule, n, f):
    """Each rule on a CUDA matrix against ``gars/oracle.py`` in float64:
    rtol 1e-4, atol 1e-5 (the JAX package's own tolerance against it,
    tests/test_gars.py), on unit normals with f rows 50 times louder."""
    from aggregathor_tpu_torch.gars import oracle

    rng = np.random.default_rng(n * 31 + f)
    g = rng.normal(size=(n, 4099 if n < 64 else 1025)).astype(np.float32)
    g[:f] *= 50.0
    oracles = {"average": oracle.average, "average-nan": oracle.average_nan, "krum": oracle.krum,
               "median": oracle.median, "averaged-median": oracle.averaged_median, "bulyan": oracle.bulyan,
               "trimmed-mean": oracle.trimmed_mean}
    got = gars.instantiate(rule, n, f).aggregate(torch.from_numpy(g).to(cuda_device)).cpu().numpy()
    np.testing.assert_allclose(got, oracles[rule](g, f), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [7510, 7511, 7509, 1753482])
def test_distances_at_the_digits_widths(cuda_device, d):
    """K1 at the digits MLP's width (8, 7,510) and odd widths beside it,
    where its grid is a few blocks and the last block sums few partials, and
    at digits-conv's (8, 1,753,482); rtol 1e-5, the same bits twice."""
    x = torch.from_numpy(_poisoned(8, d, d, True)).to(cuda_device)
    before = kernels.launch_counts()["pairwise_sq_distances"]
    got = kernels.pairwise_sq_distances(x)
    assert kernels.launch_counts()["pairwise_sq_distances"] == before + 1
    _close(got.cpu().numpy(), kernels.pairwise_sq_distances_plain(x).cpu().numpy(), 1e-5)
    assert torch.equal(got.view(torch.int32), kernels.pairwise_sq_distances(x).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("experiment, args", [("digits", []), ("digits-conv", ["batch-size:4"])])
def test_digits_steps_on_the_card_match_the_cpu(cuda_device, monkeypatch, experiment, args):
    """Three krum steps (n = 8, f = 2, r = 2 signflip) launch K1 once each
    and end where the same steps on the CPU end: rtol 1e-4, atol 1e-5, with
    TF32 off as the runner has it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    finals = []
    for device in (cuda_device, torch.device("cpu")):
        exp = models.instantiate(experiment, args)
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        engine = RobustEngine(gars.instantiate("krum", 8, 2), 8, nb_real_byz=2,
                              attack=attacks.instantiate("signflip", 8, 2), device=device)
        state = engine.init_state(exp.init(3), tx, seed=3)
        step = engine.build_step(exp.loss, tx)
        it = exp.make_train_iterator(8, seed=4)
        before = kernels.launch_counts()["pairwise_sq_distances"]
        for _ in range(3):
            state, _ = step(state, engine.put_batch(next(it)))
        assert kernels.launch_counts()["pairwise_sq_distances"] - before == (3 if device.type == "cuda" else 0)
        finals.append(torch.cat([p.detach().cpu().reshape(-1) for p in state.params.values()]))
    torch.testing.assert_close(finals[0], finals[1], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_checkpoints_of_a_card_state_round_trip(cuda_device, tmp_path):
    from aggregathor_tpu_torch.obs.checkpoint import Checkpoints

    exp = models.instantiate("digits", [])
    tx = build_optimizer("adam", build_schedule("fixed", []))
    engine = RobustEngine(gars.instantiate("krum", 8, 2), 8, device=cuda_device)
    state = engine.init_state(exp.init(1), tx, seed=1)
    step = engine.build_step(exp.loss, tx)
    it = exp.make_train_iterator(8, seed=2)
    for _ in range(2):
        state, _ = step(state, engine.put_batch(next(it)))
    ckpts = Checkpoints(str(tmp_path), background=True)
    ckpts.save(state, 2)
    saved = {k: v.detach().clone() for k, v in state.params.items()}
    state, _ = step(state, engine.put_batch(next(it)))  # updates the parameters in place after the save
    ckpts.wait(shutdown=True)
    fresh = engine.init_state(exp.init(9), tx, seed=9)
    restored, at = Checkpoints(str(tmp_path)).restore(fresh)
    assert at == 2 and restored.step == 2 and restored.opt_state["count"] == 2
    for name, value in restored.params.items():
        assert value.device.type == "cuda" and torch.equal(value, saved[name])


@pytest.mark.gpu
@pytest.mark.parametrize("experiment, args, n", [("cnnet", ["batch-size:8"], 4), ("digits", [], 8)])
def test_vmapped_gradients_match_the_loop_on_the_card(cuda_device, monkeypatch, experiment, args, n):
    """The engine's one vmapped forward and backward against a per-worker
    loop on the card: each row within 1e-4 of its largest magnitude (the
    batched and the per-worker convolutions sum in other orders), TF32 off."""
    import warnings

    from aggregathor_tpu_torch.core import FlatMap

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    exp = models.instantiate(experiment, args)
    engine = RobustEngine(gars.instantiate("average", n, 0), n, device=cuda_device)
    params = {name: value.to(cuda_device) for name, value in exp.init(1).items()}
    flatmap = FlatMap(params)
    batch = engine.put_batch(next(exp.make_train_iterator(n, seed=2)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        losses, rows = engine._worker_gradients(params, batch, exp.loss, flatmap)
    leaves = {name: value.clone().requires_grad_(True) for name, value in params.items()}
    for w in range(n):
        loss = exp.loss(leaves, {key: value[w] for key, value in batch.items()})
        want = flatmap.flatten(dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))))
        assert float(torch.max(torch.abs(rows[w] - want))) <= 1e-4 * float(torch.max(torch.abs(want)))
        assert abs(float(losses[w]) - float(loss)) <= 1e-4 * abs(float(loss))


@pytest.mark.gpu
def test_prefetcher_hands_batches_over_from_its_stream(cuda_device):
    """The prefetch thread copies on a side stream; each batch the consumer
    reads, after a long computation queued on its own stream, holds exactly
    the host batch, and the tensors arrive recorded on the consumer's stream."""
    from aggregathor_tpu_torch.models.datasets import DevicePrefetcher

    exp = models.instantiate("digits", [])
    engine = RobustEngine(gars.instantiate("average", 8, 0), 8, device=cuda_device)
    want = exp.make_train_iterator(8, seed=5)
    prefetcher = DevicePrefetcher(exp.make_train_iterator(8, seed=5), engine.put_batch, depth=2, device=cuda_device)
    big = torch.randn((2048, 2048), device=cuda_device)
    try:
        for _ in range(20):
            for _ in range(5):
                big = torch.tanh(big @ big)  # keep the consumer's stream busy
            batch = next(prefetcher)
            host = next(want)
            assert batch["image"].device.type == "cuda"
            assert torch.equal(batch["image"].cpu(), torch.as_tensor(host["image"]))
            assert torch.equal(batch["label"].cpu(), torch.as_tensor(host["label"]))
    finally:
        prefetcher.close()
    assert not prefetcher._thread.is_alive()


@pytest.mark.gpu
def test_sampled_and_augmented_steps_on_the_card_match_the_cpu(cuda_device, monkeypatch):
    """Three device-sampled krum steps of digits-conv with the cifarnet
    augmentation in the step (pad 4 on 32x32x1): the index and augmentation
    draws come from CPU generators, so the card trains on the CPU's batches;
    the parameters end within rtol 1e-4, atol 1e-5 of the CPU's, and the
    augmentation itself is the same bits on both."""
    from aggregathor_tpu_torch.models.preprocessing import DeviceCifarnet

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    finals, augmented = [], []
    for device in (cuda_device, torch.device("cpu")):
        exp = models.instantiate("digits-conv", ["batch-size:4"])
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        engine = RobustEngine(gars.instantiate("krum", 8, 2), 8, device=device, batch_transform=DeviceCifarnet(4))
        state = engine.init_state(exp.init(3), tx, seed=3)
        data = engine.replicate(exp.train_arrays())
        augmented.append(engine._augment({"image": data["image"][:32].reshape(8, 4, 32, 32, 1)}, 3, 7)["image"].cpu())
        state, metrics = engine.build_sampled_multi_step(exp.loss, tx, 3, exp.batch_size)(state, data)
        assert metrics["total_loss"].shape == (3,)
        finals.append(torch.cat([p.detach().cpu().reshape(-1) for p in state.params.values()]))
    assert torch.equal(augmented[0], augmented[1])
    torch.testing.assert_close(finals[0], finals[1], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("channels, size", [(64, 16), (3, 32)], ids=["conv2", "conv1"])
def test_conv_weight_gradient_on_the_card_is_float32_exact(cuda_device, monkeypatch, channels, size):
    """cnnet's convolutions (stride 1, 5x5, 64 outputs) on the card, 8
    workers of 32 images vmapped: the weight gradient within 1e-5 of its
    largest entry of the float64 one (cuDNN's float32 one errs by ~5e-3
    there at the 64-channel layer; ``models.cnnet.conv_weight_grad`` computes
    it in float64), the input gradient within 1e-5 too."""
    from torch.func import grad, vmap

    from aggregathor_tpu_torch.models.common import ConvF64WeightGrad

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 32, channels, size, size), generator=gen).to(cuda_device)
    probe = torch.randn((8, 32, 64, size, size), generator=gen).to(cuda_device)
    weight = torch.randn((64, channels, 5, 5), generator=gen).to(cuda_device)
    bias = torch.randn(64, generator=gen).to(cuda_device)

    def loss(w, b, xi, pi):
        return torch.sum(ConvF64WeightGrad.apply(xi, w, b, (1, 1), (2, 2), 1) * pi)

    got = vmap(grad(loss, argnums=(0, 1, 2)), in_dims=(None, None, 0, 0))(weight, bias, x, probe)
    want = vmap(grad(loss, argnums=(0, 1, 2)), in_dims=(None, None, 0, 0))(
        weight.double(), bias.double(), x.double(), probe.double())
    for g, w in zip(got, want):
        assert float(torch.max(torch.abs(g.double() - w))) <= 1e-5 * float(torch.max(torch.abs(w)))


@pytest.mark.gpu
@pytest.mark.parametrize("n, f, launched", [(8, 2, ("pairwise_sq_distances",)),
                                            (72, 8, ("pairwise_sq_distances_gram", "nanmedian_columns"))])
def test_engine_options_on_the_card_match_the_cpu(cuda_device, monkeypatch, n, f, launched):
    """Three MLP steps with worker momentum, reputation, quarantine (the
    signflip x10 coalition is masked from step 3), worker metrics, the bf16
    wire and granularity:leaf: the distance kernels launch once a leaf a
    step, the participation, reputations and quarantine count are identical
    to the CPU's (K2's all-NaN distances of a quarantined row included), the
    parameters within rtol 1e-4, atol 1e-5."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        exp = models.instantiate("mnist", ["hidden:16", "batch-size:16"])
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        engine = RobustEngine(gars.instantiate("krum", n, f), n, nb_real_byz=f,
                              attack=attacks.instantiate("signflip", n, f, ["scale:10.0"]), worker_momentum=0.9,
                              worker_metrics=True, reputation_decay=0.5, quarantine_threshold=0.4,
                              exchange_dtype="bfloat16", granularity="leaf", device=device)
        state = engine.init_state(exp.init(3), tx, seed=3)
        step = engine.build_step(exp.loss, tx)
        it = exp.make_train_iterator(n, seed=4)
        before = kernels.launch_counts()
        trail = []
        for _ in range(3):
            state, metrics = step(state, engine.put_batch(next(it)))
            trail.append([metrics[name].cpu() for name in ("worker_participation", "worker_reputation",
                                                           "nb_quarantined")])
        launches = {name: count - before[name] for name, count in kernels.launch_counts().items()}
        if device.type == "cuda":
            assert launches == {name: 3 * 4 * (name in launched) for name in launches}
        runs.append((trail, torch.cat([p.detach().cpu().reshape(-1) for p in state.params.values()])))
    for card, cpu in zip(runs[0][0], runs[1][0]):
        for a, b in zip(card, cpu):
            assert torch.equal(a, b)
    assert int(runs[0][0][-1][2]) == f
    torch.testing.assert_close(runs[0][1], runs[1][1], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_wire_roundtrip_on_the_card_is_the_cpus(cuda_device):
    """The bf16 round trip on the card keeps the CPU's bits on every value
    but NaN (a NaN of its own payload on each device)."""
    from aggregathor_tpu_torch.parallel.compress import wire_roundtrip

    gen = torch.Generator().manual_seed(2)
    x = torch.cat([torch.randn(4096, generator=gen), torch.randn(256, generator=gen) * 1e-39,
                   torch.tensor([float("inf"), -float("inf"), float("nan"), 1.0 + 2.0 ** -8, -0.0, 3.4e38])])
    got, want = wire_roundtrip(x.to(cuda_device), torch.bfloat16).cpu(), wire_roundtrip(x, torch.bfloat16)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.gpu
def test_probe_and_flight_ring_on_the_card(cuda_device):
    """Under --UDP 1 at drop rate 1 (a NaN row each step) with average-nan,
    the probe flags row 0 every step and the ring on the card holds the
    step metrics bit for bit."""
    from aggregathor_tpu_torch.obs.flight import FlightRecorder
    from aggregathor_tpu_torch.parallel.lossy import LossyLink

    exp = models.instantiate("mnist", ["hidden:16", "batch-size:16"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(gars.instantiate("average-nan", 8, 0), 8, device=cuda_device,
                          lossy_link=LossyLink(1, ["drop-rate:1.0", "packet-coords:64", "min-coords:0"]),
                          flight=FlightRecorder(4, 8))
    state = engine.init_state(exp.init(3), tx, seed=3)
    state, metrics = engine.build_multi_step(exp.loss, tx, repeat_steps=6)(
        state, engine.put_batch(next(exp.make_train_iterator(8, seed=4))))
    probe = metrics["probe"]
    assert bool(torch.all(probe["worker_nan_rows"][:, 0] == 1)) and int(probe["worker_nan_rows"][:, 1:].sum()) == 0
    window = engine.flight.fetch(state.flight)
    assert window["step"].tolist() == [2, 3, 4, 5]
    assert np.array_equal(window["loss"].view(np.int32), metrics["total_loss"][2:].cpu().numpy().view(np.int32))
    assert np.array_equal(window["worker_nan"], probe["worker_nan_rows"][2:].cpu().numpy())


@pytest.mark.gpu
def test_chunk_pipeline_on_the_card_is_the_sequential_stream_without_a_second_pin(cuda_device, monkeypatch):
    """The pipeline's ping-pong buffers are pinned, so the transfer pins
    nothing again; every chunk, all held while the buffers are refilled
    under them, is the sequential stream's; its slices are pinned."""
    from aggregathor_tpu_torch.models.datasets import ChunkPipeline, WorkerBatchIterator

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2048, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=2048).astype(np.int32)
    buffer = WorkerBatchIterator(x, y, 8, 128).alloc_chunk(10, pin_memory=True)
    assert torch.as_tensor(buffer["image"][3:6]).is_pinned() and torch.as_tensor(buffer["label"][9:]).is_pinned()
    pins = []
    pin = torch.Tensor.pin_memory
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self, *a: pins.append(self.shape) or pin(self, *a))
    engine = RobustEngine(gars.instantiate("krum", 8, 2), 8, device="cuda")
    pipe = ChunkPipeline(WorkerBatchIterator(x, y, 8, 128, seed=4), 10, 5, put=engine.put_batches,
                         assemble=engine.assemble_batches, depth=2, slices=3, device=cuda_device)
    try:
        held = [next(pipe) for _ in range(5)]
    finally:
        pipe.close()
    assert pins == []
    reference = WorkerBatchIterator(x, y, 8, 128, seed=4)
    for chunk in held:
        want = reference.next_many(10)
        for name in want:
            assert chunk[name].device.type == "cuda"
            np.testing.assert_array_equal(chunk[name].cpu().numpy(), want[name])


@pytest.mark.gpu
@pytest.mark.parametrize("rule, n, f, kernel", [("krum", 8, 2, "pairwise_sq_distances"),
                                                 ("median", 8, 2, "coordinate_median")])
def test_gar_probe_on_the_card_matches_the_cpu(cuda_device, rule, n, f, kernel):
    card = RobustEngine(gars.instantiate(rule, n, f), n, device="cuda").build_gar_probe(100_003, seed=2)
    cpu = RobustEngine(gars.instantiate(rule, n, f), n, device="cpu").build_gar_probe(100_003)
    cpu.rows = card.rows.cpu()
    kernels.reset_launch_counts()
    got = card(7)
    assert kernels.launch_counts()[kernel] == 1
    np.testing.assert_allclose(got.cpu().numpy(), cpu(7).numpy(), rtol=1e-6, atol=1e-6)


def _guardian_argv(tmp_path, experiment_args):
    return ["--experiment", "mnist" if experiment_args else "cnnet", *(
        ["--experiment-args", *experiment_args] if experiment_args else []),
        "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--prefetch", "0", "--evaluation-delta", "-1",
        "--evaluation-period", "-1", "--checkpoint-period", "-1", "--checkpoint-dir", str(tmp_path / "ckpt")]


@pytest.mark.gpu
def test_rollback_restores_the_pinned_snapshot_bit_for_bit(cuda_device, tmp_path, monkeypatch):
    """A healthy median run's snapshot at step 6, then a resume into average
    under an inf coalition with --guardian: the rollback's restore puts the
    snapshot's parameters on the card bit for bit."""
    from aggregathor_tpu_torch.cli import runner
    from aggregathor_tpu_torch.obs.checkpoint import Checkpoints

    argv = _guardian_argv(tmp_path, ["batch-size:16", "hidden:16"])
    runner.main(argv + ["--aggregator", "median", "--max-step", "6"])
    restored, restore = [], Checkpoints.restore

    def recording(self, state, step=None):
        state, at = restore(self, state, step=step)
        restored.append((at, {name: value.detach().clone() for name, value in state.params.items()}))
        return state, at

    monkeypatch.setattr(Checkpoints, "restore", recording)
    result = runner.main(argv + ["--aggregator", "average", "--nb-real-byz-workers", "2", "--attack", "inf",
                                 "--max-step", "12", "--guardian", "--guardian-args", "ladder:gar=median",
                                 "recover:4", "--checkpoint-delta", "100"])
    assert [r["to_step"] for r in result["rollbacks"]] == [6] and result["rollbacks"][0]["restored_snapshot"]
    assert [at for at, _ in restored] == [6, 6]  # the auto-restore, then the rollback's
    saved = torch.load(str(tmp_path / "ckpt" / "model-6.ckpt"), map_location="cpu", weights_only=True)["params"]
    for name, value in restored[1][1].items():
        assert value.device.type == "cuda" and torch.equal(value.cpu(), saved[name]), name


@pytest.mark.gpu
def test_a_rebuild_releases_the_old_engines_memory(cuda_device, tmp_path, monkeypatch):
    """cnnet under average and an inf coalition climbs two rungs (f+1, then
    median): at the same point of the loop (the watchdog's first
    observation, step 1) the card holds as much after each rebuild as
    before the first, within one cnnet state (its parameters' bytes)."""
    from aggregathor_tpu_torch.cli import runner
    from aggregathor_tpu_torch.guardian import Watchdog

    seen, observe = {}, Watchdog.observe

    def recording(self, step, *args):
        seen.setdefault((self.attempts, step), torch.cuda.memory_allocated())
        return observe(self, step, *args)

    monkeypatch.setattr(Watchdog, "observe", recording)
    result = runner.main(_guardian_argv(tmp_path, None) + [
        "--aggregator", "average", "--nb-real-byz-workers", "2", "--attack", "inf", "--max-step", "8",
        "--guardian", "--guardian-args", "recover:5", "--checkpoint-delta", "100"])
    assert result["escalations"] == ["f+1", "gar=median"]
    state_bytes = 4 * 1_756_682
    for attempt in (1, 2):
        assert abs(seen[(attempt, 1)] - seen[(0, 1)]) <= state_bytes, seen


def _codec_rows(seed=4, n=8, d=200_003):
    """Unit normals with a NaN row, +-inf values, half-way int8 quotients
    (scale 0.25) in row 5 and a 30,000-long run of tied largest magnitudes
    in row 3 (more than top-k's k)."""
    rows = torch.from_numpy(_poisoned(n, d, seed, distances=True))
    index = torch.arange(d)
    rows[5] = ((index % 254).to(torch.float32) - 126.5) * 0.25
    rows[5, 0] = 127.0 * 0.25
    rows[3] = torch.randn(d, generator=torch.Generator().manual_seed(seed))
    rows[3, 1000:31000] = torch.where(index[1000:31000] % 2 == 0, 10.0, -10.0)
    return rows


def _same_bits(got, want):
    """The same values bit for bit, NaN at the same places (a NaN's payload
    is the device's own: CUDA's arithmetic makes 0x7fffffff where the CPU
    keeps its operand's, as for the bf16 wire)."""
    got = got.cpu()
    if not got.is_floating_point():
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan].view(torch.int32),
                                                               want[~nan].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["int8:ef", "topk:k=20000,ef", "topk:frac=0.01"])
def test_wire_codecs_on_the_card_are_the_cpus_bits(cuda_device, spec):
    """int8's payload and image, top-k's kept indices (in their order) and
    values on tied magnitudes and NaN, and the error-feedback residual: the
    card's bits are the CPU's (a true division and a stable sort on both),
    NaN payloads aside (``_same_bits``)."""
    from aggregathor_tpu_torch.parallel.compress import parse_exchange_spec

    codec = parse_exchange_spec(spec)[1]
    rows = _codec_rows()
    residual = torch.randn(rows.shape, generator=torch.Generator().manual_seed(5)) * 0.01
    card, cpu = codec.encode(rows.to(cuda_device)), codec.encode(rows)
    for key in cpu:
        assert _same_bits(card[key], cpu[key]), key
    image, new = codec.ef_roundtrip(rows.to(cuda_device), residual.to(cuda_device))
    want_image, want_new = codec.ef_roundtrip(rows, residual)
    assert _same_bits(image, want_image) and _same_bits(new, want_new)
    if spec.startswith("topk"):
        k = codec._k_for(rows.shape[1])
        assert card["i"][3].cpu().tolist()[:k] == list(range(1000, 1000 + k))  # ties keep the lower index
    else:
        q = card["q"][5, 1:254].cpu()
        assert torch.equal(q, torch.round(torch.arange(1, 254, dtype=torch.float32) - 126.5).to(torch.int8))


@pytest.mark.gpu
def test_chaos_steps_on_the_card_match_the_cpu(cuda_device, monkeypatch):
    """Eight MLP steps of average-nan under drop storms, an empire coalition
    and stale stragglers: the drops and lateness come from CPU generators,
    so the card and the CPU lose the same packets and workers; the regimes
    and NaN rows are identical, the losses within rtol 1e-5, the parameters
    within rtol 1e-4, atol 1e-5.  (With a codec, a rounding difference of
    the gradients may move an int8 quantum: the codecs' bits are held on
    the same rows above.)"""
    from aggregathor_tpu_torch.chaos import ChaosSchedule

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    spec = "0:drop=0.3 3:attack=empire,epsilon=4.0 5:straggle=0.5,straggle-mode=stale"
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        exp = models.instantiate("mnist", ["hidden:16", "batch-size:16"])
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        chaos = ChaosSchedule(spec, 8, nb_real_byz=2, args=["packet-coords:1024"])
        engine = RobustEngine(gars.instantiate("average-nan", 8, 2), 8, nb_real_byz=2, chaos=chaos,
                              device=device)
        state = engine.init_state(exp.init(3), tx, seed=3)
        step = engine.build_step(exp.loss, tx)
        it = exp.make_train_iterator(8, seed=4)
        out = {"loss": [], "regime": [], "nan": []}
        for _ in range(8):
            state, metrics = step(state, engine.put_batch(next(it)))
            out["loss"].append(float(metrics["total_loss"]))
            out["regime"].append(int(metrics["chaos_regime"]))
            out["nan"].append(metrics["probe"]["worker_nan_rows"].cpu().tolist())
        out["params"] = torch.cat([p.detach().cpu().reshape(-1) for p in state.params.values()])
        runs.append(out)
    card, cpu = runs
    assert card["regime"] == cpu["regime"] == [0, 0, 0, 1, 1, 2, 2, 2] and card["nan"] == cpu["nan"]
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-5)
    torch.testing.assert_close(card["params"], cpu["params"], rtol=1e-4, atol=1e-5)


def _bounded_engines(rule, device, **kw):
    from aggregathor_tpu_torch.parallel import RobustEngine as Engine

    exp = models.instantiate("mnist", ["hidden:16", "batch-size:16"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    return exp, tx, Engine(gars.instantiate(rule, 8, 2), 8, device=device, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("rule, kernel", [("krum", "pairwise_sq_distances"), ("median", "coordinate_median"),
                                          ("trimmed-mean", "coordinate_trimmed_mean"),
                                          ("average-nan", "average_nan_columns")])
def test_bounded_aggregate_on_the_card_matches_the_cpu(cuda_device, rule, kernel):
    """The bounded aggregate on injected rows, workers 0-1 timed out, then
    stale at ages 3 and 1 (reweighted): the card's masks, counts and
    coefficients are the CPU's, krum's selection identical, the parameters
    within rtol 1e-5, atol 1e-6 (the rules' sums in another order), and the
    rule's kernel launched once a call."""
    n = 8
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        exp, tx, engine = _bounded_engines(rule, device, worker_metrics=True)
        template = exp.init(3)
        d = sum(v.numel() for v in template.values())
        rows = torch.randn((n, d), generator=torch.Generator().manual_seed(9)) * torch.linspace(0.1, 2.0, n)[:, None]
        arrived = torch.tensor([False, False] + [True] * 6)
        cases = ((False, torch.zeros(n, dtype=torch.bool), {}),
                 (True, torch.tensor([True, True] + [False] * 6),
                  {"stale_age": torch.tensor([3, 1, 0, 0, 0, 0, 0, 0], dtype=torch.int32)}))
        out = []
        for reweight, stale, extras in cases:
            agg = engine.build_bounded_aggregate(tx, template, stale_reweight=reweight)
            state = engine.init_state(template, tx, seed=1)
            kernels.reset_launch_counts()
            state, m = agg(state, rows.to(device), torch.ones(n, device=device), arrived.to(device),
                           stale.to(device), {k: v.to(device) for k, v in extras.items()})
            counts = kernels.launch_counts()
            if device.type == "cuda":
                assert {k: c for k, c in counts.items() if c} == {kernel: 1}
            out.append(({k: v.cpu() for k, v in m.items() if k != "probe"},
                        torch.cat([p.detach().cpu().reshape(-1) for p in state.params.values()])))
        runs.append(out)
    for (card_m, card_p), (cpu_m, cpu_p) in zip(*runs):
        for key in ("straggler_timeout", "stale_infill", "nb_timeouts", "nb_stale", "stale_reweight_coeff"):
            if key in cpu_m:
                assert torch.equal(card_m[key], cpu_m[key]), key
        if "worker_participation" in cpu_m and rule == "krum":
            assert torch.equal(card_m["worker_participation"], cpu_m["worker_participation"])
        torch.testing.assert_close(card_p, cpu_p, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_concurrent_submissions_on_the_card_equal_sequential_ones(cuda_device):
    """Three synchronous bounded-wait rounds (a CUDA stream a worker) against
    the same submissions run one at a time on the caller's stream, then
    aggregated: the parameters and momenta bit for bit."""
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep

    n = 8
    exp, tx, engine = _bounded_engines("krum", cuda_device, worker_momentum=0.9)
    template = exp.init(3)
    batches = [engine.put_batch(b) for b in (lambda it: [next(it) for _ in range(3)])(exp.make_train_iterator(n, 4))]
    state = engine.init_state(template, tx, seed=1)
    step = BoundedWaitStep(engine, exp.loss, tx, template)
    try:
        for batch in batches:
            state, _ = step(state, batch)
    finally:
        step.close()
    ref = engine.init_state(template, tx, seed=1)
    grad_fn, agg_fn = engine.build_worker_grad(exp.loss), engine.build_bounded_aggregate(tx, template)
    for batch in batches:
        params = {k: v.detach().clone() for k, v in ref.params.items()}
        outs = [grad_fn(params, {k: v[w] for k, v in batch.items()}, ref.seed, ref.step, w, momentum=ref.momentum,
                        momentum_steps=ref.momentum_steps) for w in range(n)]
        ref, _ = agg_fn(ref, torch.stack([o["row"] for o in outs]), torch.stack([o["loss"] for o in outs]),
                        torch.ones(n, dtype=torch.bool, device=cuda_device),
                        torch.zeros(n, dtype=torch.bool, device=cuda_device),
                        {"momentum": torch.stack([o["momentum"] for o in outs])})
    for key, value in ref.params.items():
        assert torch.equal(state.params[key], value), key
    assert torch.equal(state.momentum, ref.momentum)


@pytest.mark.gpu
def test_a_deadline_below_the_compute_on_the_card(cuda_device):
    """A 2 ms deadline under average-nan: late submissions still run on their
    streams while the aggregate updates the parameters; no exception, every
    worker arrives or times out each round, the skipped units are counted,
    and close() returns within its bound."""
    import time

    from aggregathor_tpu_torch.obs.metrics import MetricsRegistry
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep

    n = 8
    exp = models.instantiate("cnnet", ["batch-size:32"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(gars.instantiate("average-nan", n, 2), n, device=cuda_device)
    template = exp.init(3)
    registry = MetricsRegistry()
    step = BoundedWaitStep(engine, exp.loss, tx, template, deadline=0.002, registry=registry)
    state = engine.init_state(template, tx, seed=1)
    it = exp.make_train_iterator(n, 4)
    timeouts = 0
    try:
        for _ in range(8):
            state, m = step(state, engine.put_batch(next(it)))
            late = m["straggler_timeout"].cpu()
            assert int(m["nb_timeouts"]) == int(late.sum())
            timeouts += int(late.sum())
    finally:
        begin = time.monotonic()
        step.close()
        closed_in = time.monotonic() - begin
    torch.cuda.synchronize()
    snapshot = registry.snapshot()
    assert closed_in < 5.5 and timeouts > 0
    assert sum(snapshot["straggler_timeouts_total"].values()) == timeouts
    assert sum(snapshot.get("straggler_skipped_rounds_total", {}).values()) > 0
    assert snapshot["bounded_wait_rounds_total"] == 8


@pytest.mark.gpu
def test_secure_digests_and_masked_means_on_the_card_are_the_cpus_bits(cuda_device):
    """``row_digest`` of poisoned rows (NaN, +-inf, -0.0, subnormals) and
    ``masked_group_mean`` masked and unmasked (a NaN row, values past the
    fixed point's range): the card's bits are the CPU's, and masked equals
    unmasked."""
    from aggregathor_tpu_torch.secure import GroupMasking, masked_group_mean, row_digest

    rows = torch.randn((8, 100_003), generator=torch.Generator().manual_seed(3)) * 10.0
    rows[1] = float("nan")
    rows[2, ::7], rows[3, 1::7], rows[4, ::3], rows[5, ::11] = float("inf"), float("-inf"), -0.0, 1e-40
    for salt in (0, 5):
        assert torch.equal(row_digest(rows.to(cuda_device), salt=salt).cpu(), row_digest(rows, salt=salt))
    grouped = rows.view(4, 2, -1).clone()
    grouped[2, 0, :3] = torch.tensor([2.0 ** 31, 2.0 ** 32, -3.4e38])
    want = masked_group_mean(grouped, 17, GroupMasking.from_secret(b"s"))
    for enabled in (True, False):
        got = masked_group_mean(grouped.to(cuda_device), 17, GroupMasking.from_secret(b"s", enabled=enabled))
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), enabled


@pytest.mark.gpu
def test_secure_steps_on_the_card_match_the_cpu(cuda_device):
    """Six MLP steps of median under a forge/tamper schedule with secure
    submission: the forged and rejected workers and the NaN rows are the
    CPU's (the verdicts come from CPU generators), the losses within rtol
    1e-5."""
    from aggregathor_tpu_torch.chaos import ChaosSchedule

    out = {}
    for device in ("cpu", cuda_device):
        exp = models.instantiate("mnist", ["hidden:16", "batch-size:16"])
        engine = RobustEngine(gars.instantiate("median", 8, 2), 8, nb_real_byz=2, secure=True, device=device,
                              chaos=ChaosSchedule("0:calm 2:forge=0.5 4:tamper=0.5", 8, nb_real_byz=2))
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        step, state = engine.build_step(exp.loss, tx), engine.init_state(exp.init(1), tx, seed=1)
        it = exp.make_train_iterator(8, seed=2)
        runs = []
        for _ in range(6):
            state, metrics = step(state, engine.put_batch(next(it)))
            runs.append((float(metrics["total_loss"]), metrics["secure"]["forged"].cpu().tolist(),
                         metrics["secure"]["rejected"].cpu().tolist(),
                         metrics["probe"]["worker_nan_rows"].cpu().tolist()))
        out[str(device)] = runs
    cpu, card = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose([r[0] for r in card], [r[0] for r in cpu], rtol=1e-5)
    assert [r[1:] for r in card] == [r[1:] for r in cpu]
    assert any(any(r[2]) for r in cpu)


# --------------------------------------------------------------------------- #
# the model zoo's layers on the card


def _zoo_ops():
    from aggregathor_tpu_torch.models import common

    return {
        "conv 3x3/1": lambda x, w: common.conv2d(x, w[0], None, (1, 1), "SAME"),
        "conv 3x3/2": lambda x, w: common.conv2d(x, w[0], None, (2, 2), "SAME"),
        "conv 1x1/2": lambda x, w: common.conv2d(x, w[1], None, (2, 2), "SAME"),
        "conv 7x7/2 pad 3": lambda x, w: common.conv2d(x, w[2], None, (2, 2), ((3, 3), (3, 3))),
        "depthwise 3x3/2": lambda x, w: common.conv2d(x, w[3], None, (2, 2), "SAME", groups=8),
        "max pool 3x3/2": lambda x, w: common.max_pool(x, 3, 2, "SAME"),
        "avg pool 3x3/1": lambda x, w: common.avg_pool(x, 3, 1, "SAME"),
        "avg pool 5x5/3": lambda x, w: common.avg_pool(x, 5, 3, "SAME"),
        "resize to 64": lambda x, w: common.resize_min(x, 64),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("size", [31, 32])
@pytest.mark.parametrize("op", list(_zoo_ops()))
def test_zoo_same_layers_on_the_card_match_the_cpu(cuda_device, monkeypatch, op, size):
    """XLA's "SAME" padding (asymmetric at stride 2 on even sizes), the
    -inf and count-including pools and the bilinear upsample on the card:
    forward and input gradient within 1e-5 of the largest entry of the CPU's
    (float32 sums in another order)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator().manual_seed(size)
    x = torch.randn((4, 8, size, size), generator=gen)
    weights = [torch.randn(shape, generator=gen) / shape[1:].numel() ** 0.5
               for shape in (torch.Size((6, 8, 3, 3)), torch.Size((6, 8, 1, 1)), torch.Size((6, 8, 7, 7)),
                             torch.Size((16, 1, 3, 3)))]
    fn = _zoo_ops()[op]
    probe = torch.randn(fn(x, weights).shape, generator=gen)
    results = []
    for device in ("cpu", cuda_device):
        xi = x.to(device).requires_grad_(True)
        out = fn(xi, [w.to(device) for w in weights])
        (grad,) = torch.autograd.grad(torch.sum(out * probe.to(device)), xi)
        results.append((out.detach().cpu(), grad.cpu()))
    for got, want in zip(results[1], results[0]):
        assert got.shape == want.shape
        assert float(torch.max(torch.abs(got - want))) <= 1e-5 * float(torch.max(torch.abs(want)))


@pytest.mark.gpu
def test_zoo_bottleneck_gradient_under_vmap_on_the_card(cuda_device):
    """One ResNet bottleneck (stride 2, the projection) vmapped over 4
    workers on the card with the batching-rule fallback an error: in
    float64 its parameter and input gradients equal the CPU's within 1e-10
    of the largest entry (in float32 a ReLU whose input lies within rounding
    of 0 may flip between the two)."""
    import warnings

    from torch.func import functional_call, grad, vmap

    from aggregathor_tpu_torch.models.resnet import BottleneckBlock

    block = BottleneckBlock(64, 32, 2)
    params = models.common.init_params(block, torch.Generator().manual_seed(1))
    x = torch.randn((4, 2, 64, 16, 16), generator=torch.Generator().manual_seed(2), dtype=torch.float64)

    def loss(p, xb):
        return torch.sum(torch.sin(functional_call(block, p, (xb,))))

    grads = {}
    for device in ("cpu", cuda_device):
        block.to(device, torch.float64)
        on = {k: v.to(device, torch.float64) for k, v in params.items()}
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            grads[str(device)] = vmap(grad(loss, argnums=(0, 1)), in_dims=(None, 0))(on, x.to(device))
            block.float()
            vmap(grad(loss), in_dims=(None, 0))({k: v.float() for k, v in on.items()}, x.to(device).float())
    (cpu_p, cpu_x), (card_p, card_x) = grads["cpu"], grads[str(cuda_device)]
    for want, got in [(cpu_p[k], card_p[k]) for k in cpu_p] + [(cpu_x, card_x)]:
        assert float(torch.max(torch.abs(got.cpu() - want))) <= 1e-10 * float(torch.max(torch.abs(want)))


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout, k, stride, size", [(64, 64, 3, 1, 32), (128, 128, 3, 1, 16), (256, 256, 3, 1, 8),
                                                        (64, 256, 1, 1, 32), (128, 128, 3, 2, 32)])
def test_zoo_weight_gradient_choice_holds_on_the_card(cuda_device, monkeypatch, cin, cout, k, stride, size):
    """The zoo's conv weight gradient on the card, as the engine runs it (32
    workers of 16 images vmapped, ResNet-50's shapes on digits32): within
    1e-5 of its largest entry of the float64 one, through cuDNN's float32
    path, or the float64 path where ``common.F64_WEIGHT_GRAD_SHAPES`` lists
    the shape (cuDNN's float32 errs there by 2.8e-5 and 1.3e-5)."""
    from torch.func import functional_call, grad, vmap

    from aggregathor_tpu_torch.models.common import F64_WEIGHT_GRAD_SHAPES, Conv

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    conv = Conv(cin, cout, k, stride, bias=False).to(cuda_device)
    assert conv.f64_weight_grad == (((k, k), (stride, stride), cin, cout) in F64_WEIGHT_GRAD_SHAPES)
    gen = torch.Generator().manual_seed(cin + k)
    weight = (torch.randn((cout, cin, k, k), generator=gen) / (cin * k * k) ** 0.5).to(cuda_device)
    x = torch.randn((32, 16, cin, size, size), generator=gen).to(cuda_device)
    out = -(-size // stride)
    probe = torch.randn((32, 16, cout, out, out), generator=gen).to(cuda_device)

    def wgrad(w, xb, pb):
        return grad(lambda v: torch.sum(functional_call(conv, {"weight": v}, (xb,)) * pb))(w)

    got = vmap(wgrad, in_dims=(None, 0, 0))(weight, x, probe)
    conv.double()
    want = vmap(wgrad, in_dims=(None, 0, 0))(weight.double(), x.double(), probe.double())
    err = (got.double() - want).abs().flatten(1).max(dim=1).values / want.abs().flatten(1).max(dim=1).values
    assert float(err.max()) <= 1e-5


# --------------------------------------------------------------------------- #
# the transformer and the sharded engine (config 5's widths)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [256, 65536, 262144])
def test_transformer_bucket_distances_and_krum_on_the_card_match_the_cpu(cuda_device, d):
    """One (8, d) bucket of the sharded layer path at config 5's bucket
    widths (a norm, an attention layer, an MLP layer) through the centring,
    K2 and Krum on the card: the distances within K2's Gram bound of the
    CPU's, Krum's selection identical, the aggregate within rtol 1e-6."""
    from aggregathor_tpu_torch.gars.common import centered_gram_sq_distances

    rows = torch.from_numpy(np.random.default_rng(d).normal(size=(8, d)).astype(np.float32))
    gar = gars.instantiate("krum", 8, 2)
    got = {}
    for device in ("cpu", cuda_device):
        x = rows.to(device)
        dist2 = centered_gram_sq_distances(x)
        got[str(device)] = (dist2.cpu(), (gar.selection_weights(dist2) > 0).cpu(), gar.aggregate_block(x, dist2).cpu())
    (dc, sc, ac), (dg, sg, ag) = got["cpu"], got[str(cuda_device)]
    norms = torch.sum(rows.double() ** 2, dim=1)
    assert bool(torch.all(torch.abs(dg.double() - dc.double()) <= 1e-5 * (norms[:, None] + norms[None, :])))
    assert torch.equal(sg, sc)
    torch.testing.assert_close(ag, ac, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_transformer_moe_and_ring_attention_on_the_card_match_the_cpu(cuda_device):
    """``moe_block`` (capacity overflow included) and the dense
    ``ring_attention`` on the card against the CPU (rtol 1e-5: float32
    products summed in another order)."""
    from aggregathor_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(vocab_size=64, d_model=64, n_heads=4, n_layers=2, n_experts=4, capacity_factor=0.5)
    p = tfm.init_params(cfg, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    h = torch.randn((2, 32, 64), generator=gen)
    q, k, v = (torch.randn((2, 64, 4, 16), generator=gen) for _ in range(3))
    out = {}
    for device in ("cpu", cuda_device):
        args = [p[name][0, 0].to(device) for name in ("router", "we_gate", "we_up", "we_down")]
        moe, aux = tfm.moe_block(h.to(device), *args, cfg, None)
        ring = tfm.ring_attention(q.to(device), k.to(device), v.to(device), torch.arange(64, device=device), None)
        out[str(device)] = (moe.cpu(), aux.cpu(), ring.cpu())
    for want, got in zip(out["cpu"], out[str(cuda_device)]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bool(torch.any(torch.all(out["cpu"][0].reshape(64, 64) == 0.0, dim=1)))  # tokens over capacity


@pytest.mark.gpu
def test_transformer_gradient_under_vmap_on_the_card(cuda_device):
    """The flat engine's vmapped transformer gradient (dense and MoE) on the
    card with every warning an error (no batching-rule fallback): each
    worker's row within 1e-4 of its largest magnitude of the CPU's."""
    import warnings

    from aggregathor_tpu_torch.core import FlatMap

    for experts in ("0", "4"):
        exp = models.instantiate("transformer", ["vocab:64", "d-model:32", "heads:2", "layers:2", "seq:16",
                                                 "batch-size:4", "experts:" + experts, "corpus:4096"])
        batch = next(exp.make_train_iterator(4, seed=1))
        rows = {}
        for device in ("cpu", cuda_device):
            engine = RobustEngine(gars.instantiate("average", 4, 0), 4, device=device)
            params = {k: v.to(device) for k, v in exp.init(2).items()}
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                _, r = engine._worker_gradients(params, engine.put_batch(batch), exp.loss, FlatMap(params))
            rows[str(device)] = r.cpu()
        want, got = rows["cpu"], rows[str(cuda_device)]
        assert bool(torch.all(torch.abs(got - want).max(dim=1).values <= 1e-4 * torch.abs(want).max(dim=1).values))


# --------------------------------------------------------------------- #
# serving: the replicated vote on the card's rank kernels


def _serve_engine(cuda_device, rule="median", nb_replicas=3, poisoned=(1,), max_batch=16):
    from aggregathor_tpu_torch.chaos.replica_faults import corrupt_params
    from aggregathor_tpu_torch.serve import InferenceEngine

    exp = models.instantiate("cnnet", ["batch-size:4"])
    params = exp.init(7)
    replicas = [corrupt_params(params, "nan") if r in poisoned else params for r in range(nb_replicas)]
    vote = gars.instantiate(rule, nb_replicas, (nb_replicas - 1) // 2)
    return exp, params, InferenceEngine(exp, replicas, gar=vote, max_batch=max_batch, device="cuda")


@pytest.mark.gpu
def test_serve_vote_on_the_card_is_the_clean_replica_bit_for_bit(cuda_device):
    """Median of two identical replicas and a NaN one returns the clean
    replica's logits, bit for bit, at every bucket (K3 returns an original
    value; each replica's forward is a lone forward at the bucket), with one
    K3 launch a bucket call and disagreement [0, inf, 0]."""
    from aggregathor_tpu_torch.serve import choose_bucket

    exp, params, engine = _serve_engine(cuda_device)
    engine.warmup()
    on_card = {k: v.to(cuda_device) for k, v in params.items()}
    rng = np.random.default_rng(5)
    for rows in (1, 3, 16, 21):
        x = rng.random((rows, 32, 32, 3), np.float32)
        before = kernels.launch_counts()["coordinate_median"]
        out = engine.predict(x)
        chunks = -(-rows // 16)
        assert kernels.launch_counts()["coordinate_median"] - before == chunks
        want = []
        for start in range(0, rows, 16):
            part = x[start:start + 16]
            bucket = choose_bucket(len(part), engine.buckets)
            pad = np.zeros((bucket, 32, 32, 3), np.float32)
            pad[:len(part)] = part
            with torch.no_grad():
                want.append(exp.predict_logits(on_card, torch.from_numpy(pad).to(cuda_device))[:len(part)].cpu())
        want = torch.cat(want).numpy()
        assert np.array_equal(out["logits"].view(np.int32), want.view(np.int32)), rows
        np.testing.assert_array_equal(out["predictions"], np.argmax(want, axis=-1))
        assert out["disagreement"][0] == 0.0 and out["disagreement"][2] == 0.0
        assert np.isposinf(out["disagreement"][1])


@pytest.mark.gpu
def test_serve_builds_no_kernel_library_after_warmup_on_the_card(cuda_device):
    """After warmup, serving every bucket, a hot swap and a pool resize build
    no kernel library and run no new bucket shape."""
    from aggregathor_tpu_torch.ops import build

    built = []

    def listener(*args):
        built.append(args)

    exp, params, engine = _serve_engine(cuda_device, rule="average-nan", poisoned=())
    assert engine.warmup() == len(engine.buckets)
    build.add_build_listener(listener)
    try:
        rng = np.random.default_rng(6)
        for rows in (1, 2, 5, 16, 40):
            engine.predict(rng.random((rows, 32, 32, 3), np.float32))
        engine.swap_replicas([exp.init(8)] * 3, step=2)
        engine.set_active_replicas([0, 2])
        assert engine.predict(rng.random((3, 32, 32, 3), np.float32))["active_replicas"] == [0, 2]
        assert built == [] and engine.compile_count == len(engine.buckets)
    finally:
        build.remove_build_listener(listener)


@pytest.mark.gpu
@pytest.mark.parametrize("rule, nb_replicas", [("median", 3), ("averaged-median", 5), ("trimmed-mean", 5),
                                               ("average-nan", 5), ("krum", 5), ("average", 3)])
def test_serve_vote_on_the_card_matches_the_cpu(cuda_device, monkeypatch, rule, nb_replicas):
    """Each vote rule's engine on the card against the same engine on the
    CPU, on NaN- and scale-poisoned replicas, TF32 off: predictions equal,
    voted logits within 1e-4 of the largest (the forwards' convolutions sum
    in other orders), the same non-finite disagreement pattern."""
    from aggregathor_tpu_torch.chaos.replica_faults import corrupt_params
    from aggregathor_tpu_torch.serve import InferenceEngine

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    exp = models.instantiate("cnnet", ["batch-size:4"])
    params = exp.init(9)
    faulty = [corrupt_params(params, "nan"), corrupt_params(params, "scale", 100.0)][: (nb_replicas - 1) // 2]
    replicas = [params] * (nb_replicas - len(faulty)) + faulty
    vote = gars.instantiate(rule, nb_replicas, (nb_replicas - 1) // 2)
    x = np.random.default_rng(10).random((6, 32, 32, 3), np.float32)
    card = InferenceEngine(exp, replicas, gar=vote, max_batch=8, device="cuda").predict(x)
    cpu = InferenceEngine(exp, replicas, gar=vote, max_batch=8, device="cpu").predict(x)
    assert np.array_equal(np.isnan(card["logits"]), np.isnan(cpu["logits"]))
    finite = np.isfinite(cpu["logits"])
    scale = float(np.abs(cpu["logits"][finite]).max()) if finite.any() else 0.0
    np.testing.assert_allclose(card["logits"][finite], cpu["logits"][finite], rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_array_equal(card["predictions"], cpu["predictions"])
    assert np.array_equal(np.isfinite(card["disagreement"]), np.isfinite(cpu["disagreement"]))


@pytest.mark.gpu
def test_tree_emissions_on_the_card_match_the_cpu(cuda_device):
    """The tree's emissions (``chip_smoke.py`` F2 at a small width): krum
    units of 8 rows, two leaf timeouts; the card's summaries within 1e-5 of
    the CPU's, equal digests wherever the summaries are bit-equal, the
    centring and K2 once a unit, and no new shape after the first round."""
    from aggregathor_tpu_torch.topology import TreeAggregator, parse_topology_spec

    n, d, key = 64, 4099, 7
    rows = torch.from_numpy(np.random.default_rng(21).normal(size=(n, d)).astype(np.float32))
    valid = np.ones(n, bool)
    valid[[3, 17]] = False
    trees = {device: TreeAggregator(parse_topology_spec("tree:g=8,rules=krum>median", n, 1)) for device in ("cuda",
                                                                                                          "cpu")}
    for tree in trees.values():
        tree.bind(n, d)
    kernels.reset_launch_counts()
    card = trees["cuda"].emissions(rows.to(cuda_device), valid, key)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {"nanmedian_columns": 8,
                                                                      "pairwise_sq_distances_gram": 8}
    cpu = trees["cpu"].emissions(rows, valid, key)
    for (got, digests, _), (want, want_digests, _) in zip(card, cpu):
        got = got.cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        finite = torch.isfinite(want)
        assert torch.all(torch.abs(got[finite] - want[finite]) <= 1e-5 * (1.0 + torch.abs(want[finite])))
        for unit in range(got.shape[0]):
            if torch.equal(got[unit].view(torch.int32), want[unit].view(torch.int32)):
                np.testing.assert_array_equal(digests[unit], want_digests[unit])
    trees["cuda"].emissions(rows.to(cuda_device), valid, key)
    assert trees["cuda"].cache_size() == 1


@pytest.mark.gpu
def test_tree_protocol_on_the_card_reconstructs_like_the_cpu(cuda_device):
    """The tree's protocol (``chip_smoke.py`` F1 on injected rows): unit 1.1
    forged, then unit 2.1 late, each served by a shadow; the card's masks,
    journal records and custody chain (median levels: K3 returns an original
    value, so the digests are the CPU's) equal the CPU's."""
    from aggregathor_tpu_torch.chaos import ChaosSchedule
    from aggregathor_tpu_torch.obs.forensics import ForensicsLedger
    from aggregathor_tpu_torch.topology import TreeAggregator, parse_topology_spec

    n, d, spec, schedule = 32, 4099, "tree:g=4x2,rules=median>median>krum,redundancy=2", "0:corrupt-agg=1.1 " \
        "3:straggle-agg=2.1"
    rng = np.random.default_rng(22)
    batches = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(5)]
    out = {}
    for device in ("cuda", "cpu"):
        tree = TreeAggregator(parse_topology_spec(spec, n, 1))
        tree.schedule = ChaosSchedule(schedule, n, allow_topology_faults=True)
        tree.ledger = ForensicsLedger(n)
        tree.bind(n, d)
        masks = [tree.process_round(step, np.ones(n, bool), np.zeros(n, bool), np.full(n, 0.01),
                                    torch.from_numpy(rows).to(device)) for step, rows in enumerate(batches)]
        out[device] = ([(a.tolist(), s.tolist()) for a, s in masks], tree.ledger.report()["sub_aggregators"],
                       tree.chain())
    assert out["cuda"] == out["cpu"]
    assert all(all(a) for a, _ in out["cuda"][0])
    assert [(r["level"], r["unit"], r["evidence"]) for r in out["cuda"][1]] == [
        (1, 1, {"forgery": 3, "reconstructed": 3}), (2, 1, {"timeout": 2, "reconstructed": 2})]
