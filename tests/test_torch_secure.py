"""The port's secure submission (``secure/``), its engine, bounded-wait and
runner hooks, against the JAX package.

Bit for bit (tolerance: none):

- ``row_digest`` on rows with NaN, +-inf, -0.0 and subnormals, at several
  salts, d up to 2^20; ``tamper_row`` given JAX's coordinate;
- ``SubmissionAuthenticator``: tags, verdicts, the chain head, the
  ``secure_*`` counters and the ``forgery_verdict`` events over 5 steps;
- ``masked_group_mean`` masked and unmasked, with NaN rows, negative
  values, -0.0 and values past 2^31 (trap u); masked equals unmasked;
  with JAX's pads injected the padded rows equal JAX's;
- the custody manifest (``created_at`` patched) and its signature, and
  ``data_digest_for`` (trap v).

The engine (mnist hidden:16, n = 8, f = 2, r = 2) under a forge/tamper
schedule with JAX's masks injected: the same ``forged``, ``rejected`` and
NaN rows every step and the losses within rtol 1e-5, the flight
recorder's ``secure_rejected`` lane equal to JAX's; without ``secure`` the
forger's row is N(0, FORGE_SCALE^2) noise (a distribution test); trap s:
at forge = lateness = 0.5, late <=> forged in both packages.  Bounded
wait: the drop row's and a stale carry's digests, and no false verdict.
The runner against the JAX runner (``--nb-devices 1``): ``--secure`` with
a forge/tamper schedule and checkpoints (eval TSV within rtol 1e-5, the
same forgery evidence), ``--secure-mask`` with bucketing (losses within
rtol 1e-5, JAX's permutations injected), the refusals with JAX's
messages, and an ``--encrypt-checkpoints`` resume bit-identical to the
plain one.  W = 2 over gloo, in one spawn: the handshake (equal secrets
pass, a wrong secret and diverged parameters raise naming rank 1 on both
ranks) and the secure engine and masked bucketing against W = 1.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu import secure as jsecure
from aggregathor_tpu.chaos import ChaosSchedule as JaxSchedule
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.obs import flight as jflight
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu.secure import masking as jmasking
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.chaos import ChaosSchedule
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.obs import events as obs_events
from aggregathor_tpu_torch.obs import metrics as obs_metrics
from aggregathor_tpu_torch.obs.checkpoint import Checkpoints
from aggregathor_tpu_torch.obs.flight import FlightRecorder
from aggregathor_tpu_torch.parallel import RobustEngine, mesh
from aggregathor_tpu_torch.secure import (ChainOfCustody, GroupMasking, SubmissionAuthenticator, enable_masking,
                                          manifest_path, masked_group_mean, row_digest, tamper_row)
from aggregathor_tpu_torch.secure import custody as tcustody
from aggregathor_tpu_torch.secure import masking as tmasking
from aggregathor_tpu_torch.secure.submit import FORGE_SCALE
from aggregathor_tpu_torch.utils import UserException

import torch_rank_cases as cases_module

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


# --------------------------------------------------------------------------- #
# digests and tampering

def _poisoned_rows(d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(3, d)) * 100).astype(np.float32)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 1e-40, -3e-42, 0.0], np.float32)
    x[0, :min(d, specials.size)] = specials[:min(d, specials.size)]
    x[1, ::5] = -0.0
    return x


@pytest.mark.parametrize("d", [1, 7, 1000, 2 ** 20])
def test_row_digest_equals_jax(d):
    x = _poisoned_rows(d, d)
    for salt in (0, 1, 3 * 0x9E3779B1, 2 ** 32 + 5):
        want = np.stack([np.asarray(jsecure.row_digest(jnp.asarray(row), salt=salt)) for row in x])
        got = row_digest(torch.from_numpy(x), salt=salt)
        assert got.dtype == torch.uint32 and got.shape == (3, 4)
        assert np.array_equal(got.numpy(), want), salt
        assert np.array_equal(row_digest(torch.from_numpy(x[1]), salt=salt).numpy(), want[1])


def test_row_digest_sensitivity_and_tamper_like_jax():
    row = torch.arange(64, dtype=torch.float32)
    base = row_digest(row)
    assert torch.equal(row_digest(row), base)
    assert not torch.equal(row_digest(row.flip(0)), base)  # position-sensitive
    assert not torch.equal(row_digest(row, salt=1), base)  # salt-separated
    x = _poisoned_rows(257, 3)[1]
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        coord = int(jax.random.randint(key, (), 0, x.size))
        want = np.asarray(jsecure.tamper_row(jnp.asarray(x), key))
        got = tamper_row(torch.from_numpy(x), coord)
        assert np.array_equal(_bits(got), _bits(want))
        assert (_bits(got) != _bits(x)).sum() == 1 and not torch.equal(row_digest(got), row_digest(torch.from_numpy(x)))
    out = tamper_row(torch.ones(32), 5)
    assert out[5].item() in (0.5, 2.0) and int((out != 1.0).sum()) == 1


def test_submission_authenticator_equals_jax(tmp_path):
    from aggregathor_tpu.obs import events as jevents
    from aggregathor_tpu.obs import metrics as jmetrics

    n = 5
    registries = (obs_metrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    mine = SubmissionAuthenticator(b"secret", n, registry=registries[0])
    theirs = jsecure.SubmissionAuthenticator(b"secret", n, registry=registries[1])
    obs_events.install(str(tmp_path / "port.jsonl"), run_id="r")
    jevents.install(str(tmp_path / "jax.jsonl"), run_id="r")
    rng = np.random.default_rng(0)
    try:
        for step in range(5):
            sent = rng.integers(0, 2 ** 32, size=(n, 4), dtype=np.uint64).astype(np.uint32)
            recv = sent.copy()
            if step % 2:
                recv[3, step % 4] ^= 1  # a tampered submission
            forged = np.arange(n) == step % n
            tags = mine.sign_step(step, torch.from_numpy(sent.astype(np.int64)).to(torch.uint32), forged=forged)
            assert np.array_equal(tags, theirs.sign_step(step, sent, forged=forged))
            ok = mine.verify_step(step, recv, tags)
            assert np.array_equal(ok, theirs.verify_step(step, recv, tags))
            assert np.array_equal(~ok, forged | ((np.arange(n) == 3) & bool(step % 2)))
    finally:
        obs_events.uninstall()
        jevents.uninstall()
    assert mine.chain() == theirs.chain() and mine.chain()["steps"] == 5

    def samples(registry, parse):
        families = parse(registry.render_prometheus())
        return {(name, tuple(sorted(labels.items()))): value
                for family in ("secure_submissions_total", "secure_forgeries_total")
                for name, labels, value in families[family]["samples"]}

    assert samples(registries[0], obs_metrics.parse_prometheus) == samples(registries[1], jmetrics.parse_prometheus)

    def verdicts(path):
        return [(r["step"], r["workers"], r["nb_rejected"]) for r in map(json.loads, open(path))
                if r["type"] == "forgery_verdict"]

    assert verdicts(tmp_path / "port.jsonl") == verdicts(tmp_path / "jax.jsonl") != []


# --------------------------------------------------------------------------- #
# masking

def _grouped(shape, seed):
    x = (np.random.default_rng(seed).normal(size=shape) * 5).astype(np.float32)
    x[0, 1, 3] = np.nan             # a dropped row NaNs its group
    x[1, 0, :4] = -0.0
    x[1, 1, 5], x[1, 3 % shape[1], 6] = 2.0 ** 31, 2.0 ** 32   # past the encode's range (trap u)
    x[2, 2 % shape[1], 2], x[2, 3 % shape[1], 4] = 1e10, -3.4e38
    x[2, 0, 7] = -1.0
    return x


@pytest.mark.parametrize("shape", [(3, 4, 33), (4, 2, 257)])
def test_masked_group_mean_equals_jax(shape):
    x = _grouped(shape, shape[-1])
    key = jax.random.PRNGKey(0)
    out = {}
    for enabled in (True, False):
        want = np.asarray(jsecure.masked_group_mean(jnp.asarray(x), key, jsecure.GroupMasking.from_secret(
            b"a", enabled=enabled)))
        got = masked_group_mean(torch.from_numpy(x), 123, GroupMasking.from_secret(b"a", enabled=enabled)).numpy()
        assert np.array_equal(_bits(got), _bits(want)), enabled
        out[enabled] = got
    assert np.isnan(out[True][0]).all() and np.isfinite(out[True][1:]).all()
    # masked equals unmasked, and does not depend on the secret or the key
    other = masked_group_mean(torch.from_numpy(x), 7, GroupMasking.from_secret(b"b")).numpy()
    assert np.array_equal(_bits(out[True]), _bits(out[False])) and np.array_equal(_bits(other), _bits(out[True]))
    # in range, the plain mean to the fixed point's quantum
    np.testing.assert_allclose(masked_group_mean(torch.from_numpy(x[:, :, 8:]), 1, GroupMasking(0)).numpy()[1:],
                               x[1:, :, 8:].mean(axis=1), rtol=0, atol=1e-6)


def test_padded_rows_equal_jax_with_its_pads_injected():
    key = jax.random.PRNGKey(0)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 4, 8)), np.float32)
    masking = jsecure.GroupMasking.from_secret(b"a")
    salt = jax.random.bits(jax.random.fold_in(key, jmasking.MASK_KEY_TAG), (), jnp.uint32)
    pad_key = jax.random.fold_in(masking.base_key, salt)
    mh = jax.random.bits(jax.random.fold_in(pad_key, 0), x.shape, jnp.uint32)
    ml = jax.random.bits(jax.random.fold_in(pad_key, 1), x.shape, jnp.uint32)
    hi, lo = jmasking._encode64(jnp.asarray(x))
    rh, rl = jmasking._sub64(mh, ml, jnp.roll(mh, -1, axis=1), jnp.roll(ml, -1, axis=1))
    want = jmasking._add64(hi, lo, rh, rl)
    pads = tuple(torch.from_numpy(np.asarray(p).astype(np.int64)) for p in (mh, ml))
    thi, tlo = tmasking._encode64(torch.from_numpy(x))
    trh, trl = tmasking._sub64(*pads, torch.roll(pads[0], -1, dims=1), torch.roll(pads[1], -1, dims=1))
    got = tmasking._add64(thi, tlo, trh, trl)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    assert (got[0] != thi).float().mean() > 0.9  # the rows are padded
    mean = masked_group_mean(torch.from_numpy(x), 5, GroupMasking.from_secret(b"a"), pads=pads)
    assert np.array_equal(_bits(mean), _bits(jsecure.masked_group_mean(jnp.asarray(x), key, masking)))
    with pytest.raises(UserException):
        masked_group_mean(torch.ones(2, 2, 4), None, GroupMasking.from_secret(b"a"))


def test_mask_seed_is_jaxs():
    for secret in (b"a", b"hunter2"):
        want = jax.random.PRNGKey(GroupMasking.from_secret(secret).base_seed)
        assert np.array_equal(np.asarray(want), np.asarray(jsecure.GroupMasking.from_secret(secret).base_key))


@pytest.mark.parametrize("spec", ["bucketing:s=2,inner=median", "hier:g=2,inner=average,outer=median", "krum",
                                  "median", "hier:g=4,inner=median,outer=median", "bucketing:s=1,inner=average-nan"])
def test_enable_masking_accepts_and_refuses_like_jax(spec):
    mine, theirs = GroupMasking.from_secret(b"a"), jsecure.GroupMasking.from_secret(b"a")
    try:
        enable_masking(tgars.instantiate(spec, 8, 2), mine)
        refused = None
    except UserException as exc:
        refused = str(exc)
    try:
        jsecure.enable_masking(jgars.instantiate(spec, 8, 2), theirs)
        want = None
    except JaxUserException as exc:
        want = str(exc)
    assert refused == want
    assert (refused is None) == spec.startswith(("bucketing:s=2", "hier:g=2"))


def _masked_run(spec, masking, steps=3, lossy=None):
    exp = tmodels.instantiate("digits", ["batch-size:8"])
    gar = tgars.instantiate(spec, 8, 2)
    if masking is not None:
        enable_masking(gar, masking)
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(gar, 8, lossy_link=lossy, device="cpu")
    step = engine.build_step(exp.loss, tx)
    state = engine.init_state(exp.init(42), tx, seed=1)
    it = exp.make_train_iterator(8, seed=3)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, engine.put_batch(next(it)))
        losses.append(float(metrics["total_loss"]))
    return torch.cat([value.detach().reshape(-1) for value in state.params.values()]), losses, metrics


@pytest.mark.parametrize("spec", ["bucketing:s=2,inner=median", "hier:g=2,inner=average,outer=median"])
def test_masked_training_is_bit_identical_to_unmasked(spec):
    a, _, _ = _masked_run(spec, GroupMasking.from_secret(b"secret-a"))
    b, _, _ = _masked_run(spec, GroupMasking.from_secret(b"secret-b"))
    plain, _, _ = _masked_run(spec, GroupMasking.from_secret(b"secret-a", enabled=False))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)) and torch.equal(a.view(torch.int32),
                                                                                   plain.view(torch.int32))


def test_masked_dropped_worker_nans_its_bucket_and_the_run_survives():
    from aggregathor_tpu_torch.parallel.lossy import LossyLink

    params, losses, metrics = _masked_run("bucketing:s=2,inner=median", GroupMasking.from_secret(b"a"), steps=4,
                                          lossy=LossyLink(1, ["drop-rate:1.0", "min-coords:0"]))
    assert bool(metrics["probe"]["worker_nan_rows"][0]) and np.isfinite(losses).all()
    assert bool(torch.isfinite(params).all())


# --------------------------------------------------------------------------- #
# custody

def _state(step, value):
    from aggregathor_tpu_torch.core.train_state import TrainState

    params = {"dense.bias": torch.arange(4, dtype=torch.float32) * value}
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
    return TrainState(params=params, opt_state=tx.init(params), step=step, seed=3)


def test_custody_manifest_and_signature_equal_jax(tmp_path, monkeypatch):
    from aggregathor_tpu.secure import custody as jcustody

    monkeypatch.setattr(tcustody.time, "time", lambda: 1234.5)
    monkeypatch.setattr(jcustody.time, "time", lambda: 1234.5)
    digests = np.arange(24, dtype=np.uint32).reshape(6, 4)
    subs = (SubmissionAuthenticator(b"s", 6), jsecure.SubmissionAuthenticator(b"s", 6))
    for auth in subs:
        auth.process_step(3, digests, digests, forged=np.arange(6) == 1)
    lineage = dict(run_id="r", experiment="digits", gar_spec="median", data_digest="ab" * 32)
    mine = ChainOfCustody(b"s", submission=subs[0], **lineage)
    theirs = jcustody.ChainOfCustody(b"s", submission=subs[1], **lineage)
    data = bytes(range(256)) * 3
    paths = mine.write(str(tmp_path / "p.ckpt"), 7, data), theirs.write(str(tmp_path / "j.ckpt"), 7, data)
    docs = [json.load(open(path)) for path in paths]
    assert docs[0] == docs[1] and docs[0]["tag_chain"]["steps"] == 1
    assert open(paths[0]).read() == open(paths[1]).read()
    # each verifies the other's manifest
    assert ChainOfCustody(b"s").verify(str(tmp_path / "j.ckpt"), 7, data)
    assert jcustody.ChainOfCustody(b"s").verify(str(tmp_path / "p.ckpt"), 7, data)


def test_custody_refuses_forgeries(tmp_path):
    custody = ChainOfCustody(b"secret", run_id="r", experiment="toy", gar_spec="median")
    ckpt = Checkpoints(str(tmp_path), custody=custody, max_to_keep=2)
    path = ckpt.save(_state(7, 1.0))
    doc = json.load(open(manifest_path(path)))
    assert doc["schema"] == "aggregathor.secure.custody.v1" and doc["gar"] == "median" and doc["run_id"] == "r"
    restored, step = ckpt.restore(_state(0, 0.0))
    assert step == 7 and custody.verified == 1 and custody.all_verified
    # a verifier-only instance accepts it; another secret refuses
    assert Checkpoints(str(tmp_path), custody=ChainOfCustody(b"secret")).restore(_state(0, 0.0))[1] == 7
    with pytest.raises(UserException, match="signature"):
        Checkpoints(str(tmp_path), custody=ChainOfCustody(b"wrong")).restore(_state(0, 0.0))
    # a forged field
    forged = dict(doc, gar="average")
    json.dump(forged, open(manifest_path(path), "w"))
    with pytest.raises(UserException, match="signature"):
        ckpt.restore(_state(0, 0.0))
    json.dump(doc, open(manifest_path(path), "w"))
    # a manifest copied to another step's snapshot
    path8 = ckpt.save(_state(8, 1.0))
    os.replace(manifest_path(path), manifest_path(path8))
    with pytest.raises(UserException, match="signature|signs step"):
        ckpt.restore(_state(0, 0.0), step=8)
    # one flipped snapshot byte
    path9 = ckpt.save(_state(9, 1.0))
    with open(path9, "r+b") as fd:
        fd.seek(50)
        byte = fd.read(1)
        fd.seek(50)
        fd.write(bytes([byte[0] ^ 1]))
    with pytest.raises(UserException, match="digest mismatch"):
        ckpt.restore(_state(0, 0.0), step=9)
    # pruning and discard_after take the manifests along
    assert not os.path.exists(manifest_path(path)) and not os.path.exists(path)
    ckpt.discard_after(8)
    assert not os.path.exists(manifest_path(path9))
    # a missing manifest refuses, unless --allow-unsigned
    os.remove(manifest_path(path8))
    with pytest.raises(UserException, match="custody manifest"):
        ckpt.restore(_state(0, 0.0), step=8)
    lenient = ChainOfCustody(b"secret", allow_unsigned=True)
    assert Checkpoints(str(tmp_path), custody=lenient).restore(_state(0, 0.0), step=8)[1] == 8
    assert lenient.unsigned == 1 and not lenient.all_verified


def test_custody_signs_encrypted_bytes_and_the_chain_of_the_save(tmp_path):
    from aggregathor_tpu_torch.parallel.auth import GradientAuthenticator
    from aggregathor_tpu_torch.parallel.crypto import SnapshotCipher

    sub = SubmissionAuthenticator(b"secret", 4)
    custody = ChainOfCustody(b"secret", submission=sub)
    ckpt = Checkpoints(str(tmp_path), authenticator=GradientAuthenticator(b"secret", 1, context=b"ckpt"),
                       cipher=SnapshotCipher(b"secret"), custody=custody, background=True)
    sub.process_step(1, np.zeros((4, 4), np.uint32), np.zeros((4, 4), np.uint32))
    path = ckpt.save(_state(1, 1.0))
    head = sub.chain()["head"]
    sub.process_step(2, np.zeros((4, 4), np.uint32), np.zeros((4, 4), np.uint32))  # after the save
    ckpt.wait()
    doc = json.load(open(manifest_path(path)))
    assert doc["tag_chain"]["head"] == head and doc["tag_chain"]["steps"] == 1
    import hashlib

    assert doc["snapshot_digest"] == hashlib.sha256(open(path, "rb").read()).hexdigest()
    assert ckpt.restore(_state(0, 0.0))[1] == 1
    ckpt.wait(shutdown=True)


@pytest.mark.parametrize("experiment, args", [("digits", []), ("mnist", ["hidden:16"]), ("mnistAttack", [])])
def test_data_digest_equals_jax(experiment, args):
    from aggregathor_tpu.secure.custody import data_digest_for as jdigest

    mine = tcustody.data_digest_for(tmodels.instantiate(experiment, args), "identity")
    assert mine == jdigest(jmodels.instantiate(experiment, args), "identity")
    assert len(mine) == 64


# --------------------------------------------------------------------------- #
# the engine

SCHEDULE = "0:calm 2:forge=0.5 4:tamper=0.5 6:forge=1.0,tamper=1.0"


def _wkey(seed, step, w):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), step), w)


def _inject_jax_forgery(engine, seed):
    """The port's forge, tamper and coordinate draws from the JAX engine's
    threefry keys (its fold tags 5, 6 and fold(6, 1))."""
    def forge(_seed, step, w, rate):
        return bool(jax.random.bernoulli(jax.random.fold_in(_wkey(seed, step, w), 5), np.float32(rate)))

    def tamper(_seed, step, w, rate):
        return bool(jax.random.bernoulli(jax.random.fold_in(_wkey(seed, step, w), 6), np.float32(rate)))

    def coord(_seed, step, w, d):
        return int(jax.random.randint(jax.random.fold_in(jax.random.fold_in(_wkey(seed, step, w), 6), 1), (), 0, d))

    engine.draw_forge, engine.draw_tamper, engine.draw_tamper_coord = forge, tamper, coord


def _secure_run_both(rule, spec=SCHEDULE, steps=8, n=8, f=2, r=2, secure=True):
    exp_args = ["hidden:16", "batch-size:16"]
    jexp, texp = jmodels.instantiate("mnist", exp_args), tmodels.instantiate("mnist", exp_args)
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    jflight_rec = jflight.FlightRecorder(16, n, secure=secure)
    tflight_rec = FlightRecorder(16, n, secure=secure)
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate(rule, n, f), nb_workers=n, nb_real_byz=r,
                        chaos=JaxSchedule(spec, n, nb_real_byz=r), secure=secure, flight=jflight_rec)
    tengine = RobustEngine(tgars.instantiate(rule, n, f), n, nb_real_byz=r, chaos=ChaosSchedule(spec, n, nb_real_byz=r),
                           secure=secure, flight=tflight_rec, device="cpu")
    _inject_jax_forgery(tengine, seed=1)
    init = jexp.init(jax.random.PRNGKey(42))
    jstep, tstep = jengine.build_step(jexp.loss, jtx), tengine.build_step(texp.loss, ttx)
    jstate = jengine.init_state(init, jtx, seed=1)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    it = jexp.make_train_iterator(n, seed=3)
    out = {"jax": [], "port": [], "jsec": [], "sec": [], "jnan": [], "nan": []}
    for _ in range(steps):
        batch = next(it)
        jstate, jm = jstep(jstate, jengine.shard_batch(batch))
        tstate, tm = tstep(tstate, tengine.put_batch(batch))
        out["jax"].append(float(jm["total_loss"]))
        out["port"].append(float(tm["total_loss"]))
        out["jnan"].append(np.asarray(jm["probe"]["worker_nan_rows"]) != 0)
        out["nan"].append(tm["probe"]["worker_nan_rows"].numpy() != 0)
        if secure:
            out["jsec"].append({k: np.asarray(v) for k, v in jm["secure"].items()})
            out["sec"].append({k: v.numpy() for k, v in tm["secure"].items()})
    out["flight"] = (jflight_rec.fetch(jstate.flight), tflight_rec.fetch(tstate.flight))
    return out


@pytest.mark.parametrize("rule", ["median", "krum"])
def test_secure_steps_match_the_jax_engine_with_its_masks(rule):
    out = _secure_run_both(rule)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5)
    auth = SubmissionAuthenticator(b"secret", 8)
    for step, (want, got) in enumerate(zip(out["jsec"], out["sec"])):
        for name in ("forged", "rejected"):
            assert np.array_equal(got[name], want[name]), (step, name)
        assert got["digest_sent"].dtype == np.uint32 and got["digest_sent"].shape == (8, 4)
        # sent == received except where a row was tampered, in both packages
        assert np.array_equal((got["digest_sent"] == got["digest_recv"]).all(1),
                              (want["digest_sent"] == want["digest_recv"]).all(1))
        ok = auth.process_step(step, got["digest_sent"], got["digest_recv"], forged=got["forged"])
        assert np.array_equal(~ok, got["rejected"])
    assert np.array_equal(np.stack(out["nan"]), np.stack(out["jnan"]))
    rejected = np.stack([sec["rejected"] for sec in out["sec"]])
    assert not rejected[:2].any() and rejected[6:, :2].all() and not rejected[:, 2:].any()
    assert 0 < rejected[2:6].sum() < 8  # the half rates hit some coalition rows
    want, got = out["flight"]
    assert np.array_equal(got["secure_rejected"], want["secure_rejected"])
    assert np.array_equal(got["secure_rejected"], rejected.astype(np.int32))


def test_without_secure_a_forgers_row_is_noise_of_forge_scale():
    chaos = ChaosSchedule("0:forge=1.0", 6, nb_real_byz=1)
    exp = tmodels.instantiate("digits", ["batch-size:8"])
    engine = RobustEngine(tgars.instantiate("median", 6, 1), 6, nb_real_byz=1, chaos=chaos, worker_metrics=True,
                          device="cpu")
    drawn = []
    impostor = engine.draw_impostor
    engine.draw_impostor = lambda *a: drawn.append(impostor(*a)) or drawn[-1]
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    step = engine.build_step(exp.loss, tx)
    state = engine.init_state(exp.init(42), tx, seed=1)
    it = exp.make_train_iterator(6, seed=3)
    for _ in range(3):
        state, metrics = step(state, engine.put_batch(next(it)))
        assert "secure" not in metrics and not metrics["probe"]["worker_nan_rows"].any()
        assert int(torch.argmax(metrics["worker_sq_dist"])) == 0  # the forger's noise is the outlier
    noise = torch.cat(drawn).numpy() / FORGE_SCALE
    import scipy.stats

    assert len(drawn) == 3 and not np.array_equal(drawn[0].numpy(), drawn[1].numpy())
    assert scipy.stats.kstest(noise, "norm").pvalue > 1e-3
    assert abs(noise.std() - 1.0) < 0.03 and abs(noise.mean()) < 0.05


def test_forge_and_lateness_share_one_uniform_in_both_packages():
    from aggregathor_tpu.chaos.stragglers import StragglerModel as JaxStragglers

    schedule = ChaosSchedule("0:forge=0.5,straggle=0.5", 8, nb_real_byz=8)
    engine = RobustEngine(tgars.instantiate("average-nan", 8, 2), 8, nb_real_byz=8, chaos=schedule, secure=True,
                          device="cpu")
    jstragglers = JaxStragglers(8, 0)
    late_port, late_jax = [], []
    for step in range(40):
        for w in range(8):
            late = schedule.stragglers.draw_late(1, step, w, 0.5)
            assert engine.draw_forge(1, step, w, 0.5) == late
            late_port.append(late)
            wkey = _wkey(1, step, w)
            jlate = bool(jstragglers.is_late(wkey, w, np.float32(0.5)))
            assert bool(jax.random.bernoulli(jax.random.fold_in(wkey, 5), np.float32(0.5))) == jlate
            late_jax.append(jlate)
    assert 0.35 < np.mean(late_port) < 0.65 and 0.35 < np.mean(late_jax) < 0.65
    # in a step: the forged workers are exactly the late ones (each NaN either way)
    exp = tmodels.instantiate("digits", ["batch-size:8"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    step_fn = engine.build_step(exp.loss, tx)
    state = engine.init_state(exp.init(42), tx, seed=1)
    it = exp.make_train_iterator(8, seed=3)
    for s in range(3):
        state, metrics = step_fn(state, engine.put_batch(next(it)))
        late = [schedule.stragglers.draw_late(1, s, w, 0.5) for w in range(8)]
        assert metrics["secure"]["forged"].tolist() == late
        assert metrics["probe"]["worker_nan_rows"].bool().tolist() == late


def test_secure_multi_step_and_refusals():
    exp = tmodels.instantiate("digits", ["batch-size:8"])
    engine = RobustEngine(tgars.instantiate("median", 4, 1), 4, secure=True, device="cpu")
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    multi = engine.build_multi_step(exp.loss, tx)
    state = engine.init_state(exp.init(42), tx, seed=1)
    it = exp.make_train_iterator(4, seed=3)
    chunk = {key: np.stack([batch[key] for batch in (next(it), next(it))]) for key in ("image", "label")}
    state, many = multi(state, engine.put_batches(chunk))
    assert tuple(many["secure"]["digest_sent"].shape) == (2, 4, 4) and tuple(many["secure"]["rejected"].shape) == (2, 4)
    assert torch.equal(many["secure"]["digest_sent"], many["secure"]["digest_recv"])  # no forgery regime
    from aggregathor_tpu_torch.parallel import engine as engine_module

    assert engine_module.UNPORTED_OPTIONS == ()
    with pytest.raises(UserException):  # a forge regime needs its coalition
        RobustEngine(tgars.instantiate("median", 4, 1), 4, chaos=ChaosSchedule("0:forge=0.5", 4, nb_real_byz=1),
                     device="cpu")
    with pytest.raises(UserException):  # the secure lane needs secure submission
        RobustEngine(tgars.instantiate("median", 4, 1), 4, flight=FlightRecorder(4, 4, secure=True), device="cpu")


# --------------------------------------------------------------------------- #
# bounded wait

def test_bounded_digests_of_drops_and_stale_carries():
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep, HostStragglerModel

    n, d = 6, None
    exp = tmodels.instantiate("digits", ["batch-size:8"])
    engine = RobustEngine(tgars.instantiate("median", n, 2), n, secure=True, device="cpu")
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    model = HostStragglerModel(n, 2.0, chaos=ChaosSchedule("0:calm 1:straggle=1.0", n, args=["straggle-workers:2"]))
    step = BoundedWaitStep(engine, exp.loss, tx, exp.init(42), deadline=0.25, straggler_model=model,
                           stale_infill=True, stale_max_age=1)
    state = engine.init_state(exp.init(42), tx, seed=1)
    it = exp.make_train_iterator(n, seed=3)
    auth = SubmissionAuthenticator(b"secret", n)
    seen = []
    try:
        for s in range(3):
            state, metrics = step(state, engine.put_batch(next(it)))
            sec = {name: value.numpy() for name, value in metrics["secure"].items()}
            assert np.array_equal(sec["digest_sent"], sec["digest_recv"]) and not sec["rejected"].any()
            assert auth.process_step(s, sec["digest_sent"], sec["digest_recv"], forged=sec["forged"]).all()
            seen.append((sec["digest_recv"], metrics["stale_infill"].numpy(), metrics["straggler_timeout"].numpy()))
    finally:
        step.close()
    d = sum(value.numel() for value in state.params.values())
    nan_digest = np.asarray(jsecure.row_digest(jnp.full((d,), jnp.nan, jnp.float32)))
    assert not seen[0][2].any()
    # round 1: the stale carries re-enter with the digests of their rows
    assert seen[1][1][:2].all() and np.array_equal(seen[1][0][:2], seen[0][0][:2])
    # round 2: past the carry's age, a NaN drop with the drop row's digest
    assert not seen[2][1].any() and seen[2][2][:2].all()
    assert np.array_equal(seen[2][0][:2], np.stack([nan_digest, nan_digest]))
    assert not np.array_equal(seen[2][0][2:], seen[1][0][2:])  # the punctual rows are fresh


# --------------------------------------------------------------------------- #
# the runner

RUN = ["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:16", "--nb-workers", "8",
       "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--learning-rate-args", "initial-rate:0.05",
       "--evaluation-period", "-1", "--summary-period", "-1", "--checkpoint-period", "-1", "--prefetch", "0"]


@pytest.fixture
def jax_weights(monkeypatch):
    """Both runners from the JAX package's initial weights, on fresh registries."""
    from aggregathor_tpu.obs import metrics as jmetrics
    from aggregathor_tpu_torch.models import mnist

    jexp = jmodels.instantiate("mnist", ["hidden:16", "batch-size:16"])
    monkeypatch.setattr(mnist.MNISTExperiment, "init", lambda self, seed: params_from_jax(
        _host(jexp.init(jax.random.PRNGKey(seed)))))
    monkeypatch.setattr(jmetrics, "REGISTRY", jmetrics.MetricsRegistry())
    monkeypatch.setattr(obs_metrics, "REGISTRY", obs_metrics.MetricsRegistry())


def _tsv(path):
    rows = {}
    for line in open(path):
        fields = line.rstrip("\n").split("\t")
        rows[int(fields[1])] = {k: float(v) for k, v in (f.split(":", 1) for f in fields[2:]) if k != "chaos_regime"}
    return rows


def _losses(directory):
    events = [json.loads(line) for name in sorted(os.listdir(directory))
              for line in open(os.path.join(directory, name))]
    return {e["step"]: e["total_loss"] for e in events if "total_loss" in e}


def test_runner_secure_matches_the_jax_runner(tmp_path, jax_weights):
    from aggregathor_tpu.cli import runner as jrunner

    argv = RUN + ["--aggregator", "krum", "--chaos", "0:calm 2:forge=1.0 5:tamper=1.0", "--max-step", "8",
                  "--evaluation-delta", "2", "--checkpoint-delta", "4", "--summary-delta", "-1", "--secure",
                  "--session-secret", "s"]

    def run(main, tag, extra):
        main(argv + ["--evaluation-file", str(tmp_path / (tag + ".tsv")), "--checkpoint-dir", str(tmp_path / tag),
                     "--forensics", str(tmp_path / (tag + ".json"))] + extra)
        return _tsv(tmp_path / (tag + ".tsv")), json.load(open(tmp_path / (tag + ".json")))

    (jrows, jreport), (rows, report) = run(jrunner.main, "jax", ["--nb-devices", "1"]), run(
        runner.main, "port", ["--device", "cpu"])
    assert sorted(rows) == sorted(jrows) == [1, 3, 5, 7, 8]
    for step in rows:
        for name in jrows[step]:
            np.testing.assert_allclose(rows[step][name], jrows[step][name], rtol=1e-5, err_msg=name)
    forgery = [entry["evidence"].get("forgery") for entry in report["workers"]]
    assert forgery == [entry["evidence"].get("forgery") for entry in jreport["workers"]]
    assert forgery[:2] == [6, 6] and report["suspects"] == jreport["suspects"] == [0, 1]
    manifests = sorted(name for name in os.listdir(tmp_path / "port") if name.endswith(".manifest.json"))
    assert manifests and len(manifests) == len([n for n in os.listdir(tmp_path / "port") if n.endswith(".ckpt")])
    doc = json.load(open(tmp_path / "port" / manifests[-1]))
    assert doc["tag_chain"]["nb_workers"] == 8 and doc["tag_chain"]["steps"] == 8 and doc["gar"] == "f=2 gar=krum"
    families = obs_metrics.parse_prometheus(obs_metrics.REGISTRY.render_prometheus())
    assert {labels["worker"]: value for _, labels, value in families["secure_forgeries_total"]["samples"]} == {
        "0": 6.0, "1": 6.0}


@pytest.mark.parametrize("extra", [
    ["--secure"], ["--secure-mask"], ["--encrypt-checkpoints", "--checkpoint-dir", "{tmp}"],
    ["--secure-mask", "--session-secret", "s", "--exchange", "int8"],
    ["--secure-mask", "--session-secret", "s", "--step-deadline", "1.0"],
], ids=["secure", "mask", "encrypt", "mask-codec", "mask-deadline"])
def test_runner_secure_refusals_like_jax(extra, tmp_path, jax_weights):
    from aggregathor_tpu.cli import runner as jrunner

    extra = [arg.replace("{tmp}", str(tmp_path)) for arg in extra]
    argv = RUN + ["--aggregator", "bucketing:s=2,inner=median", "--max-step", "1"] + extra
    with pytest.raises(UserException) as mine:
        runner.main(argv + ["--device", "cpu"])
    with pytest.raises(JaxUserException) as theirs:
        jrunner.main(argv + ["--nb-devices", "1"])
    assert str(mine.value) == str(theirs.value)


def test_encrypted_resume_is_bit_identical_to_the_plain_resume(tmp_path):
    from aggregathor_tpu_torch.parallel.auth import GradientAuthenticator
    from aggregathor_tpu_torch.parallel.crypto import SnapshotCipher

    argv = ["--experiment", "digits", "--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
            "--evaluation-period", "-1", "--checkpoint-period", "-1", "--checkpoint-delta", "3", "--device", "cpu"]
    secure = ["--session-secret", "s", "--encrypt-checkpoints", "--secure"]
    finals = {}
    for name, extra in (("plain", []), ("encrypted", secure)):
        directory = str(tmp_path / name)
        for max_step in ("5", "10"):
            result = runner.main(argv + ["--max-step", max_step, "--checkpoint-dir", directory] + extra)
        assert result["restored_step"] == 5
        ckpt = Checkpoints(directory)
        if extra:
            assert open(os.path.join(directory, "model-10.ckpt"), "rb").read().startswith(b"ATPC1")
            ckpt = Checkpoints(directory, authenticator=GradientAuthenticator(b"s", 1, context=b"ckpt"),
                               cipher=SnapshotCipher(b"s"), custody=ChainOfCustody(b"s"))
        finals[name] = ckpt.restore(_template_state(directory))[0].params
    for key, value in finals["plain"].items():
        assert torch.equal(value.view(torch.int32), finals["encrypted"][key].view(torch.int32)), key


def _template_state(directory):
    exp = tmodels.instantiate("digits", [])
    engine = RobustEngine(tgars.instantiate("krum", 8, 2), 8, device="cpu")
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    return engine.init_state(exp.init(0), tx)


def test_runner_secure_mask_bucketing_matches_the_jax_runner(tmp_path, jax_weights, monkeypatch):
    from aggregathor_tpu.cli import runner as jrunner
    from aggregathor_tpu.gars import GAR_KEY_TAG
    from aggregathor_tpu_torch.gars import bucketing
    from aggregathor_tpu_torch.parallel.engine import gar_key

    # the port's bucket permutations are the JAX runner's (its step key, seed 0)
    step_of = {gar_key(0, step): step for step in range(8)}

    def jax_permutation(key, n, device):
        step_key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), step_of[key]), GAR_KEY_TAG)
        return torch.from_numpy(np.asarray(jax.random.permutation(step_key, n)).astype(np.int64))

    monkeypatch.setattr(bucketing, "key_permutation", jax_permutation)
    argv = RUN + ["--aggregator", "bucketing:s=2,inner=krum", "--nb-decl-byz-workers", "1", "--nb-real-byz-workers",
                  "1", "--attack", "signflip", "--max-step", "6",
                  "--evaluation-delta", "-1", "--summary-delta", "1", "--secure-mask", "--session-secret", "s"]
    jrunner.main(argv + ["--summary-dir", str(tmp_path / "jax"), "--nb-devices", "1"])
    runner.main(argv + ["--summary-dir", str(tmp_path / "port"), "--device", "cpu"])
    want, got = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert sorted(got) == sorted(want) == list(range(1, 7))
    np.testing.assert_allclose([got[k] for k in sorted(got)], [want[k] for k in sorted(got)], rtol=1e-5)


# --------------------------------------------------------------------------- #
# W = 2 over gloo: one spawn

def _rank_case(case_id, rule, f, r, options=None, chaos=None, mask_secret=None):
    jexp = jmodels.instantiate("mnist", ["hidden:16", "batch-size:16"])
    weights = {k: v.numpy() for k, v in params_from_jax(_host(jexp.init(jax.random.PRNGKey(5)))).items()}
    it = jexp.make_train_iterator(8, seed=2)
    case = {"id": case_id, "experiment": "mnist", "exp_args": ["hidden:16", "batch-size:16"], "rule": rule, "n": 8,
            "f": f, "r": r, "chaos": chaos, "options": options or {}, "mask_secret": mask_secret}
    return case, weights, [next(it) for _ in range(8)]


RANK_CASES = [_rank_case("secure", "median", 2, 2, {"secure": True}, chaos=SCHEDULE),
              _rank_case("masked", "bucketing:s=2,inner=krum", 1, 0, mask_secret=b"s")]


@pytest.fixture(scope="module")
def two_ranks():
    """Every rank's handshake outcomes and case runs, and the cases at W = 1."""
    weights = RANK_CASES[0][1]
    jobs = [("handshakes", (weights,))] + [("run_case", case) for case in RANK_CASES]
    ranks = mesh.spawn(cases_module.run_jobs, 2, 8, (jobs,), device="cpu")
    one = mesh.WorkerAxis(8, 1, 0, "cpu")
    return ranks, [cases_module.run_case(one, *case) for case in RANK_CASES]


def test_handshake_at_two_ranks(two_ranks):
    ranks, _ = two_ranks
    for index, rank in enumerate(ranks):
        outcome, other = rank[0], 1 - index  # each rank names the rank whose payload it refuses
        assert outcome["equal"] == 2
        assert "Host authentication FAILED for process(es) %d:" % other in outcome["wrong_secret"]
        assert "Host state DIVERGED at bring-up: process(es) %d hold different parameter bytes than process %d" % (
            other, index) in outcome["diverged"]


def test_secure_engine_at_two_ranks_follows_one(two_ranks):
    ranks, ones = two_ranks
    for index in (1, 2):
        got, want = ranks[0][index], ones[index - 1]
        assert ranks[1][index]["loss"] == got["loss"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert np.array_equal(np.stack(got["worker_nan"]), np.stack(want["worker_nan"]))
        for mine, theirs in zip(got["secure"], want["secure"]):
            for name in ("forged", "rejected"):
                assert np.array_equal(mine[name], theirs[name])
            assert mine["digest_sent"].shape == (8, 4)
            assert np.array_equal((mine["digest_sent"] == mine["digest_recv"]).all(1),
                                  (theirs["digest_sent"] == theirs["digest_recv"]).all(1))
    rejected = np.stack([sec["rejected"] for sec in ranks[0][1]["secure"]])
    assert rejected[6:, :2].all() and not rejected[:, 2:].any() and 0 < rejected[2:6].sum() < 8


def test_runner_secure_at_two_ranks_follows_one(tmp_path):
    """--secure at --nb-devices 2 (a subprocess whose lead spawns rank 1):
    the handshake passes on both ranks, the forgery evidence and the
    custody manifests are the one-rank run's."""
    import subprocess
    import sys

    argv = ["--experiment", "digits", "--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
            "--nb-real-byz-workers", "2", "--max-step", "6", "--chaos", "0:calm 2:forge=1.0 4:tamper=1.0",
            "--secure", "--session-secret", "s", "--evaluation-period", "-1", "--checkpoint-delta", "3",
            "--checkpoint-period", "-1", "--prefetch", "0", "--device", "cpu"]
    reports, files = {}, {}
    for width in (1, 2):
        where = tmp_path / str(width)
        extra = ["--forensics", str(where / "f.json"), "--checkpoint-dir", str(where / "ckpt"),
                 "--nb-devices", str(width)]
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env.pop("XLA_FLAGS", None)
        proc = subprocess.run([sys.executable, "-m", "aggregathor_tpu_torch.cli.runner"] + argv + extra, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert proc.stdout.count("Host handshake OK: %d process(es) authenticated" % width) == width
        reports[width] = json.load(open(where / "f.json"))
        files[width] = sorted(os.listdir(where / "ckpt"))
        snapshots = [name for name in files[width] if name.endswith(".ckpt")]
        assert snapshots and files[width] == sorted(
            snapshot + suffix for snapshot in snapshots for suffix in ("", ".manifest.json", ".tag"))
    assert files[1] == files[2]
    evidence = [[entry["evidence"].get("forgery", 0) for entry in reports[width]["workers"]] for width in (1, 2)]
    assert evidence[0] == evidence[1] == [4, 4, 0, 0, 0, 0, 0, 0]
