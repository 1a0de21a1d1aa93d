"""The port's wire codecs (``parallel/compress.py``) against the JAX package's.

- ``parse_exchange_spec``: the same codecs, specs and refusals.
- int8: the round trip and the payload bit for bit on rows with half-way
  quotients, zeros, NaN and +-inf (a non-finite magnitude decodes to a NaN
  row); top-k: the same kept indices, in the same order, and values on rows
  with tied magnitudes (zeros, repeated values) and several NaN (ranked as
  +inf, ties to the lower index); the error-feedback image and residual bit
  for bit (0 where the image is not finite).
- ``bytes_per_row``, ``compression_ratio``, ``describe`` and the top-k budget
  checks equal JAX's.
- Engine steps: from the same weights and batches, 3 krum steps under each
  codec, with and without error feedback (and int8:ef under the empire
  coalition, whose forged matrix crosses the codec again), end within rtol
  1e-5 / atol 1e-5 of the JAX engine's parameters.
- Persistence: the residuals are saved in the checkpoint and restored bit
  for bit, and a resumed run continues to the uninterrupted one's bits; a
  guardian rollback (the runner under ``--chaos "0:calm 6:attack=inf"`` and
  ``--exchange int8:ef``) restores the pinned snapshot's residuals bit for
  bit.
- The runner's ``--exchange``: refusals as JAX's, ``bytes_on_wire_total`` and
  ``exchange_compression_ratio`` with the codec.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import attacks as jattacks
from aggregathor_tpu.parallel import compress as jcompress
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.obs import metrics as obs_metrics
from aggregathor_tpu_torch.obs.checkpoint import Checkpoints
from aggregathor_tpu_torch.parallel import RobustEngine, attacks
from aggregathor_tpu_torch.parallel import compress
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)


def _rows(seed=0, n=8, d=1000):
    """Rows at several scales, with half-way int8 quotients, a zero row,
    NaN and +-inf, runs of tied magnitudes and several NaN in one row."""
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(n, d)) * rng.uniform(0.01, 100, size=(n, 1))).astype(np.float32)
    rows[0] = np.clip(rows[0], -60.0, 60.0)
    rows[0, :40] = (np.arange(40, dtype=np.float32) - 19.5) * 0.5  # quotients at k + 1/2 ...
    rows[0, 40] = 127.0 * 0.5  # ... of the scale 0.5
    rows[1, 5] = np.nan
    rows[2, 7] = np.inf
    rows[2, 9] = -np.inf
    rows[3] = 0.0
    rows[4, ::3] = rows[4, 0]  # a third of the row ties in magnitude
    rows[4, 1::3] = -rows[4, 0]
    rows[5] = 0.0
    rows[5, 100:400:2], rows[5, 101:400:2] = 1.0, -1.0  # 300 tied magnitudes among zeros
    rows[6, 10:20] = np.nan
    rows[6, 500:600] = -2.5
    return rows


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


CODEC_SPECS = ["int8", "int8:ef", "topk:k=50", "topk:frac=0.0625,ef", "bf16", "f32"]


@pytest.mark.parametrize("spec", CODEC_SPECS)
def test_parse_exchange_spec_matches_jax(spec):
    (dtype, codec), (jdtype, jcodec) = compress.parse_exchange_spec(spec), jcompress.parse_exchange_spec(spec)
    assert (dtype is None) == (jdtype is None) and (codec is None) == (jcodec is None)
    for d in (1000, 1_756_682):
        assert compress.bytes_per_row(d, dtype, codec) == jcompress.bytes_per_row(d, jdtype, jcodec)
        assert compress.compression_ratio(d, dtype, codec) == jcompress.compression_ratio(d, jdtype, jcodec)
    if codec is not None:
        assert codec.spec() == jcodec.spec() and codec.uses_ef == jcodec.uses_ef


@pytest.mark.parametrize("spec", ["int8:ef=1", "int8:k=2", "topk", "topk:k=2,frac=0.1", "topk:k=0",
                                  "topk:frac=1.5", "topk:k=x", "f32:ef", "bf16:x", "int4", 3])
def test_bad_exchange_specs_refuse_like_jax(spec):
    with pytest.raises(UserException):
        compress.parse_exchange_spec(spec)
    with pytest.raises(JaxUserException):
        jcompress.parse_exchange_spec(spec)


def test_topk_budget_checks_like_jax():
    for spec, d in (("topk:k=600", 1000), ("topk:k=1001", 1000), ("topk:frac=0.6", 1000)):
        with pytest.raises(UserException):
            compress.parse_exchange_spec(spec)[1].validate_d(d)
        with pytest.raises(JaxUserException):
            jcompress.parse_exchange_spec(spec)[1].validate_d(d)
    codec = compress.parse_exchange_spec("topk:frac=0.01")[1]
    assert codec.bytes_per_row(1_756_682) == 8 * 17_567  # k = round(0.01 d), the card's leg


def test_int8_roundtrip_and_payload_are_bit_identical_to_jax():
    rows = _rows()
    codec, jcodec = compress.Int8Codec(), jcompress.Int8Codec()
    # compiled, as the JAX engine runs the codec (XLA turns the scale's
    # division by 127 into a multiply by its reciprocal)
    jencode = jax.jit(jcodec.encode)
    got = codec.roundtrip(torch.from_numpy(rows)).numpy()
    want = np.asarray(jax.jit(jcodec.roundtrip_rows)(jnp.asarray(rows)))
    assert np.array_equal(_bits(got), _bits(want))
    assert np.isnan(got[1]).all() and np.isnan(got[2]).all() and not np.isnan(got[0]).any()
    for i in range(rows.shape[0]):
        payload, jpayload = codec.encode(torch.from_numpy(rows[i])), jencode(jnp.asarray(rows[i]))
        assert np.array_equal(payload["q"].numpy(), np.asarray(jpayload["q"])), i
        assert np.array_equal(_bits(payload["scale"].numpy()), _bits(jpayload["scale"])), i
    # the half-way quotients round to even, as jnp.round does
    q = codec.encode(torch.from_numpy(rows[0]))["q"].numpy()[:40]
    assert np.array_equal(q, np.round(np.arange(40) - 19.5).astype(np.int8)) and q[0] == -20 and q[1] == -18


def test_topk_keeps_the_jax_index_set_and_order_on_ties_and_nans():
    rows = _rows(1)
    for k in (1, 50, 300, 500):
        codec, jcodec = compress.TopKCodec(k=k), jcompress.TopKCodec(k=k)
        batched = codec.encode(torch.from_numpy(rows))
        for i in range(rows.shape[0]):
            payload, jpayload = codec.encode(torch.from_numpy(rows[i])), jcodec.encode(jnp.asarray(rows[i]))
            assert np.array_equal(payload["i"].numpy(), np.asarray(jpayload["i"])), (k, i)
            assert np.array_equal(_bits(payload["v"].numpy()), _bits(jpayload["v"])), (k, i)
            assert np.array_equal(batched["i"][i].numpy(), payload["i"].numpy()), (k, i)
        got = codec.roundtrip(torch.from_numpy(rows)).numpy()
        assert np.array_equal(_bits(got), _bits(jcodec.roundtrip_rows(jnp.asarray(rows))))
    # several NaN rank first, lowest index first; a tie run keeps its lowest indices
    kept = compress.TopKCodec(k=12).encode(torch.from_numpy(rows[6]))["i"].numpy()
    assert kept[:10].tolist() == list(range(10, 20))
    kept = compress.TopKCodec(k=50).encode(torch.from_numpy(rows[5]))["i"].numpy()
    assert kept.tolist() == list(range(100, 150))
    kept = compress.TopKCodec(k=400).encode(torch.from_numpy(rows[5]))["i"].numpy()
    assert kept.tolist() == list(range(100, 400)) + list(range(100))  # then the zeros, from index 0


@pytest.mark.parametrize("spec", ["int8:ef", "topk:k=50,ef"])
def test_error_feedback_is_bit_identical_to_jax(spec):
    rows = _rows(2)
    residual = (np.random.default_rng(3).normal(size=rows.shape) * 0.1).astype(np.float32)
    codec, jcodec = compress.parse_exchange_spec(spec)[1], jcompress.parse_exchange_spec(spec)[1]
    image, new = codec.ef_roundtrip(torch.from_numpy(rows), torch.from_numpy(residual))
    for i in range(rows.shape[0]):
        want_image, want_new = jcodec.ef_roundtrip(jnp.asarray(rows[i]), jnp.asarray(residual[i]))
        assert np.array_equal(_bits(image[i].numpy()), _bits(want_image)), i
        assert np.array_equal(_bits(new[i].numpy()), _bits(want_new)), i
    # a non-finite image resets the residual: no NaN carries into later sends
    assert torch.all(torch.isfinite(new)) and torch.all(new[~torch.isfinite(image)] == 0)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inject_jax_rows(monkeypatch, tengine, r):
    """A test-only seam: each port step's gradient rows become the float32
    rows the JAX engine produced that step, captured where they meet its
    codec (``WireCodec.ef_encode``, through ordered debug callbacks, as
    ``tests/trace_int8_ef_parity.py`` does), so the codec, its residual,
    the attack and krum see the same bits in both packages.  The captured
    rows are post-attack: the signflip rows (w < r) are negated back, which
    is exact, and the port's signflip negates them again.  The port's losses
    stay its own.  Returns the {package: [payload of each step]} record."""
    seen = {"jax_rows": [], "jax": [], "port": []}
    jax_ef, port_ef = jcompress.WireCodec.ef_encode, compress.WireCodec.ef_encode

    def jax_wrapped(self, row, ef_row):
        payload, decoded, new_ef = jax_ef(self, row, ef_row)
        jax.debug.callback(lambda g, p: (seen["jax_rows"].append(np.array(g)), seen["jax"].append(
            {k: np.array(v) for k, v in p.items()})), row, payload, ordered=True)
        return payload, decoded, new_ef

    def port_wrapped(self, row, ef_row):
        payload, decoded, new_ef = port_ef(self, row, ef_row)
        seen["port"].append({k: v.detach().clone().numpy() for k, v in payload.items()})
        return payload, decoded, new_ef

    original = tengine._worker_gradients

    def injected(params, batch, loss_fn, flatmap):
        losses, _ = original(params, batch, loss_fn, flatmap)
        jax.effects_barrier()
        n = tengine.nb_workers
        rows = np.stack(seen["jax_rows"][-n:]).astype(np.float32)
        rows[:r] = -rows[:r]
        return losses, torch.from_numpy(rows)

    monkeypatch.setattr(jcompress.WireCodec, "ef_encode", jax_wrapped)
    monkeypatch.setattr(compress.WireCodec, "ef_encode", port_wrapped)
    monkeypatch.setattr(tengine, "_worker_gradients", injected)
    return seen


def _run_both(spec, attack=None, steps=3, n=8, f=2, r=2, monkeypatch=None):
    exp_args = ["hidden:16", "batch-size:16"]
    jexp, texp = jmodels.instantiate("mnist", exp_args), tmodels.instantiate("mnist", exp_args)
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate("krum", n, f), nb_workers=n, nb_real_byz=r,
                        attack=jattacks.instantiate(attack, n, r), exchange=spec)
    tengine = RobustEngine(tgars.instantiate("krum", n, f), n, nb_real_byz=r, attack=attacks.instantiate(attack, n, r),
                           exchange=spec, device="cpu")
    seen = _inject_jax_rows(monkeypatch, tengine, r) if monkeypatch is not None else None
    init = jexp.init(jax.random.PRNGKey(11))
    jstep, tstep = jengine.build_step(jexp.loss, jtx), tengine.build_step(texp.loss, ttx)
    jstate = jengine.init_state(init, jtx, seed=1)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    it = jexp.make_train_iterator(n, seed=2)
    for _ in range(steps):
        batch = next(it)
        jstate, jm = jstep(jstate, jengine.shard_batch(batch))
        tstate, tm = tstep(tstate, tengine.put_batch(batch))
        np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=1e-5)
    if seen is not None:
        # the int8 payloads, bit for bit, at every step: JAX encodes row by
        # row (n calls a step), the port the (n, d) rows at once
        jax.effects_barrier()
        assert len(seen["port"]) == steps and len(seen["jax"]) == steps * n
        for step, payload in enumerate(seen["port"]):
            for key, value in payload.items():
                want = np.stack([p[key] for p in seen["jax"][step * n:(step + 1) * n]]).reshape(value.shape)
                assert value.dtype == want.dtype and np.array_equal(
                    value.view(np.uint8), want.view(np.uint8)), (step, key)
    return tengine, tstate, jstate


@pytest.mark.parametrize("spec, attack", [("int8", "signflip"), ("int8:ef", "signflip"), ("topk:frac=0.05", "signflip"),
                                          ("topk:frac=0.05,ef", "signflip"), ("int8:ef", "empire")],
                         ids=["int8", "int8-ef", "topk", "topk-ef", "int8-ef-empire"])
def test_codec_steps_match_the_jax_engine(spec, attack, request, monkeypatch):
    # [int8-ef] runs on the JAX engine's own gradient rows: the two packages'
    # float32 gradients differ in their last bits (another summation order
    # in the backward), and through the residual that can tip a half-way
    # int8 quotient by one quantum, so on raw gradients the case compared
    # runs whose codec inputs were not the same bits
    inject = request.node.callspec.id == "int8-ef"
    engine, tstate, jstate = _run_both(spec, attack, monkeypatch=monkeypatch if inject else None)
    want = params_from_jax(_host(jstate.params))
    for key in want:
        np.testing.assert_allclose(tstate.params[key].detach().numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert engine.carries_ef == (jstate.ef is not None)
    if jstate.ef is not None:
        assert tuple(tstate.ef.shape) == tuple(jstate.ef.shape)
        np.testing.assert_allclose(tstate.ef.numpy(), np.asarray(jstate.ef), rtol=1e-4, atol=1e-4)


def test_engine_refuses_codec_compositions_like_jax():
    gar = tgars.instantiate("krum", 8, 2)
    with pytest.raises(UserException):  # both wires
        RobustEngine(gar, 8, exchange="int8", exchange_dtype="bfloat16", device="cpu")
    with pytest.raises(UserException):  # topk budget beyond d/2 at init
        exp = tmodels.instantiate("mnist", ["hidden:4"])
        engine = RobustEngine(gar, 8, exchange="topk:k=100000", device="cpu")
        engine.init_state(exp.init(1), build_optimizer("sgd", build_schedule("fixed", [])))
    engine = RobustEngine(gar, 8, exchange="bf16", device="cpu")
    assert engine.codec is None and engine.exchange_dtype == torch.bfloat16 and not engine.carries_ef


def _ef_run(steps, checkpoints=None, resume=False, save_at=None):
    """``steps`` topk:ef krum steps from one init, the batches of one stream;
    ``resume`` restores the latest snapshot of ``checkpoints`` first (into a
    state made from other weights), ``save_at`` saves there at that step."""
    exp = tmodels.instantiate("mnist", ["hidden:16", "batch-size:16"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(tgars.instantiate("krum", 8, 2), 8, exchange="topk:frac=0.05,ef", device="cpu")
    state = engine.init_state(exp.init(9 if resume else 4), tx, seed=1)
    step = engine.build_step(exp.loss, tx)
    it = exp.make_train_iterator(8, seed=2)
    if resume:
        state.ef.fill_(7.0)  # overwritten by the restore
        state, at = checkpoints.restore(state)
        it.skip(at)
    while state.step < steps:
        state, _ = step(state, engine.put_batch(next(it)))
        if state.step == save_at:
            checkpoints.save(state)
    return state


def test_error_feedback_survives_checkpoint_restore_bit_for_bit(tmp_path):
    straight = _ef_run(5)
    checkpoints = Checkpoints(str(tmp_path / "ck"), "ef")
    mid = _ef_run(3, checkpoints, save_at=3)
    saved = torch.load(str(tmp_path / "ck" / "ef-3.ckpt"), weights_only=True)
    assert sorted(saved) == ["ef", "opt_state", "params", "seed", "step"]
    assert torch.equal(saved["ef"].view(torch.int32), mid.ef.view(torch.int32)) and bool(torch.any(mid.ef != 0))
    resumed = _ef_run(5, checkpoints, resume=True)
    assert torch.equal(resumed.ef.view(torch.int32), straight.ef.view(torch.int32))
    for name, value in straight.params.items():
        assert torch.equal(resumed.params[name], value), name
    # a snapshot without residuals restores into an EF run zeroed (JAX's template)
    exp = tmodels.instantiate("mnist", ["hidden:16", "batch-size:16"])
    tx = build_optimizer("sgd", build_schedule("fixed", []))
    plain = RobustEngine(tgars.instantiate("krum", 8, 2), 8, device="cpu")
    Checkpoints(str(tmp_path / "plain"), "p").save(plain.init_state(exp.init(4), tx, seed=1))
    resumed.ef.fill_(1.0)
    resumed, _ = Checkpoints(str(tmp_path / "plain"), "p").restore(resumed)
    assert bool(torch.all(resumed.ef == 0))


def test_error_feedback_snapshot_of_another_worker_count_is_refused(tmp_path):
    exp = tmodels.instantiate("mnist", ["hidden:16", "batch-size:16"])
    tx = build_optimizer("sgd", build_schedule("fixed", []))

    def state_of(n):
        engine = RobustEngine(tgars.instantiate("average", n, 0), n, exchange="int8:ef", device="cpu")
        return engine.init_state(exp.init(4), tx, seed=1)

    Checkpoints(str(tmp_path / "eight"), "ef").save(state_of(8))
    for checkpoints in (Checkpoints(str(tmp_path / "eight"), "ef"),
                        Checkpoints(str(tmp_path / "eight"), "ef", nb_workers=16)):
        with pytest.raises(UserException, match="error-feedback residuals"):
            checkpoints.restore(state_of(4))
        with pytest.raises(UserException, match="error-feedback residuals"):
            checkpoints.restore(state_of(16))
    # a rank's (k, d) rows take every worker's (n, d) rows of its run's n
    restored, _ = Checkpoints(str(tmp_path / "eight"), "ef", nb_workers=8).restore(state_of(4))
    assert tuple(restored.ef.shape) == (8, restored.ef.shape[1])


RUN = ["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:16", "--nb-workers", "8",
       "--nb-decl-byz-workers", "2", "--evaluation-delta", "-1", "--evaluation-period", "-1", "--prefetch", "0",
       "--device", "cpu"]


def test_guardian_rollback_restores_the_residuals_bit_for_bit(tmp_path, monkeypatch):
    from aggregathor_tpu_torch.cli import runner

    monkeypatch.setattr(obs_metrics, "REGISTRY", obs_metrics.MetricsRegistry())
    restored, restore = [], Checkpoints.restore

    def recording(self, state, step=None):
        state, at = restore(self, state, step=step)
        restored.append((at, state.ef.clone()))
        return state, at

    monkeypatch.setattr(Checkpoints, "restore", recording)
    result = runner.main(RUN + [
        "--aggregator", "average", "--nb-real-byz-workers", "2", "--chaos", "0:calm 6:attack=inf",
        "--exchange", "int8:ef", "--max-step", "10", "--guardian", "--guardian-args", "recover:3",
        "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-delta", "4", "--checkpoint-period", "-1"])
    assert result["rollbacks"] and result["rollbacks"][0]["restored_snapshot"]
    at, ef = restored[0]
    saved = torch.load(str(tmp_path / "ck" / ("model-%d.ckpt" % at)), weights_only=True)["ef"]
    assert at == 5 and bool(torch.any(saved != 0))  # the cadence fires at steps 1 and 5
    assert torch.equal(ef.view(torch.int32), saved.view(torch.int32))


def test_runner_exchange_refusals_and_wire_accounting(tmp_path, monkeypatch):
    from aggregathor_tpu.cli import runner as jrunner
    from aggregathor_tpu_torch.cli import runner

    for argv in (["--exchange", "int8", "--exchange-dtype", "bfloat16"], ["--exchange", "int4"],
                 ["--exchange", "topk:k=100000"]):
        with pytest.raises(UserException):
            runner.main(RUN + ["--aggregator", "krum", "--max-step", "1"] + argv)
        with pytest.raises(JaxUserException):
            jrunner.main(RUN[:-2] + ["--aggregator", "krum", "--max-step", "1", "--nb-devices", "1"] + argv)
    registry = obs_metrics.MetricsRegistry()
    monkeypatch.setattr(obs_metrics, "REGISTRY", registry)
    runner.main(RUN + ["--aggregator", "krum", "--max-step", "3", "--exchange", "int8:ef",
                       "--metrics-file", str(tmp_path / "m.prom")])
    families = obs_metrics.parse_prometheus(open(tmp_path / "m.prom").read())
    d = 784 * 16 + 16 + 16 * 10 + 10
    assert families["bytes_on_wire_total"]["samples"][0][2] == 3 * 8 * (d + 4)
    assert families["exchange_compression_ratio"]["samples"][0][2] == pytest.approx(4 * d / (d + 4))
    # a resume with another --nb-workers refuses the snapshot's residuals
    argv = RUN + ["--aggregator", "average", "--exchange", "int8:ef", "--checkpoint-dir", str(tmp_path / "ck"),
                  "--checkpoint-delta", "2", "--checkpoint-period", "-1"]
    runner.main(argv + ["--max-step", "2"])
    with pytest.raises(UserException, match="error-feedback residuals"):
        runner.main([a if a != "8" else "4" for a in argv] + ["--max-step", "4"])
    # bf16 lands on the dtype twin
    monkeypatch.setattr(obs_metrics, "REGISTRY", obs_metrics.MetricsRegistry())
    runner.main(RUN + ["--aggregator", "krum", "--max-step", "1", "--exchange", "bf16",
                       "--metrics-file", str(tmp_path / "b.prom")])
    families = obs_metrics.parse_prometheus(open(tmp_path / "b.prom").read())
    assert families["exchange_compression_ratio"]["samples"][0][2] == 2.0
