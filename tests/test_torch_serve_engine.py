"""The port's serving engine against the JAX package's, on ``digits``.

``serve/engine.py``'s ``InferenceEngine`` at buckets (1, 2, 4), R in {1, 3,
5}, the vote rules median, averaged-median, trimmed-mean, average-nan,
average and krum, each poison mode of ``--poison-replica`` (nan, scale,
zero, noise, stale) on the last f replicas, requests of 1, 3 and 7 rows (7
is chunked 4 + 3): predictions, voted logits, disagreement (NaN and +inf
patterns identical), bucket, weights step and active replicas against the
JAX engine on the same replicas (``serve_parity.py`` states the
tolerances).  Then the mutators' verdicts (``vote_absorbs_retired`` and
``set_active_replicas`` at every retired count, ``swap_replicas``'s
refusals), the live tuple's lock and atomicity, and the engine's own
contracts.
"""

import threading

import numpy as np
import pytest
import torch

from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch.serve import InferenceEngine, bucket_ladder, choose_bucket, restore_params
from aggregathor_tpu_torch.utils import UserException
from serve_parity import (  # noqa: F401  (two_threads is a fixture)
    BUCKETS,
    RULES,
    Pair,
    close,
    feasible,
    raises_in_both,
    run_matrix,
    same_response,
    two_threads,
)

pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def pair():
    return Pair("digits")


CASES = [(1, None)] + [(r, rule) for r in (3, 5) for rule in RULES if feasible(rule, r)]


@pytest.mark.parametrize("nb_replicas, rule", CASES, ids=["R%d-%s" % (r, g) for r, g in CASES])
def test_engine_matches_the_jax_engine_under_every_poison(pair, nb_replicas, rule):
    left, rows = run_matrix(pair, nb_replicas, rule)
    assert left * 100 <= rows, (left, rows)  # the rows the GAP rule left out


def test_krum_is_refused_at_three_replicas_in_both():
    from aggregathor_tpu import gars as jgars

    assert raises_in_both(lambda: jgars.instantiate("krum", 3, 1), lambda: tgars.instantiate("krum", 3, 1))


@pytest.mark.parametrize("nb_replicas, rule", CASES[1:], ids=["R%d-%s" % case for case in CASES[1:]])
def test_mutators_reach_the_jax_verdicts(pair, nb_replicas, rule):
    """``vote_absorbs_retired`` and ``set_active_replicas`` for every retired
    count 0..R-1 give JAX's verdicts, and an accepted retirement serves
    JAX's vote (the retired replicas' disagreement NaN)."""
    jeng, teng = pair.engines(nb_replicas, rule)
    jreps, treps = pair.replicas(nb_replicas, 0, None, None)
    jeng.swap_replicas(jreps, step=None)
    teng.swap_replicas(treps, step=None)
    x = pair.requests(seed=11)[1]
    everyone = list(range(nb_replicas))
    for retired in range(nb_replicas):
        assert teng.vote_absorbs_retired(retired) == jeng.vote_absorbs_retired(retired), retired
        keep = everyone[retired:]  # the first ``retired`` replicas leave
        refused = raises_in_both(lambda: jeng.set_active_replicas(keep), lambda: teng.set_active_replicas(keep))
        assert refused == (not teng.vote_absorbs_retired(retired)), retired
        if not refused:
            assert teng.active_replicas == jeng.active_replicas == keep
            got, want = teng.predict(x), jeng.predict(x)
            same_response(got, want, "%s R=%d retired %d" % (rule, nb_replicas, retired))
            assert np.all(np.isnan(got["disagreement"][:retired]))
        jeng.set_active_replicas(everyone)
        teng.set_active_replicas(everyone)
    for bad in ([], [0, nb_replicas]):
        assert raises_in_both(lambda: jeng.set_active_replicas(bad), lambda: teng.set_active_replicas(bad))
    assert teng.compile_count == len(BUCKETS)


def test_unvoted_engines_refuse_retirement_as_jax_does(pair):
    jsolo, tsolo = pair.engines(1, None)
    assert tsolo.set_active_replicas([0]) == jsolo.set_active_replicas([0]) == [0]
    assert raises_in_both(lambda: jsolo.set_active_replicas([]), lambda: tsolo.set_active_replicas([]))
    from aggregathor_tpu.serve import InferenceEngine as JaxEngine

    jpair = JaxEngine(pair.jexp, [pair.jparams] * 2, buckets=BUCKETS)
    tpair = InferenceEngine(pair.texp, [pair.tparams] * 2, buckets=BUCKETS, device="cpu")
    assert raises_in_both(lambda: jpair.set_active_replicas([0]), lambda: tpair.set_active_replicas([0]))
    assert tpair.vote_absorbs_retired(0) == jpair.vote_absorbs_retired(0) is True
    assert tpair.vote_absorbs_retired(1) == jpair.vote_absorbs_retired(1) is False


def test_swap_replicas_refuses_exactly_what_jax_refuses(pair):
    import jax

    jeng, teng = pair.engines(3, "median")
    jreps, treps = pair.replicas(3, 0, None, None)
    # a replica-count change
    assert raises_in_both(lambda: jeng.swap_replicas(jreps[:2], step=1), lambda: teng.swap_replicas(treps[:2], step=1))
    # a leaf-shape change
    jbad = jax.tree_util.tree_map(lambda leaf: np.zeros((3, 3), np.float32), pair.jparams)
    tbad = {name: torch.zeros((3, 3)) for name in pair.tparams}
    assert raises_in_both(lambda: jeng.swap_replicas([jbad] * 3, step=1), lambda: teng.swap_replicas([tbad] * 3, step=1))
    # a leaf-dtype change
    jbad = jax.tree_util.tree_map(lambda leaf: leaf.astype(np.float64), pair.jparams)
    tbad = {name: value.double() for name, value in pair.tparams.items()}
    with jax.enable_x64(True):
        assert raises_in_both(lambda: jeng.swap_replicas([jbad] * 3, step=1),
                              lambda: teng.swap_replicas([tbad] * 3, step=1))
    # the same topology is accepted, and the refused swaps left the step alone
    assert not raises_in_both(lambda: jeng.swap_replicas(jreps, step=7), lambda: teng.swap_replicas(treps, step=7))
    assert teng.weights_step == jeng.weights_step == 7
    # the port refuses replicas whose parameter names differ from each other
    renamed = dict(treps[0])
    renamed["extra"] = torch.zeros(1)
    with pytest.raises(UserException):
        teng.swap_replicas([treps[0], treps[1], renamed])
    assert teng.weights_step == 7


def test_engine_validates_shapes_and_gar_arity_as_jax(pair):
    from aggregathor_tpu import gars as jgars
    from aggregathor_tpu.serve import InferenceEngine as JaxEngine

    assert raises_in_both(lambda: JaxEngine(pair.jexp, []), lambda: InferenceEngine(pair.texp, [], device="cpu"))
    assert raises_in_both(
        lambda: JaxEngine(pair.jexp, [pair.jparams] * 2, gar=jgars.instantiate("median", 3, 1)),
        lambda: InferenceEngine(pair.texp, [pair.tparams] * 2, gar=tgars.instantiate("median", 3, 1), device="cpu"))
    jeng, teng = pair.engines(1, None)
    for bad in (np.zeros((2, 5, 5, 1), np.float32), np.zeros((0, 8, 8, 1), np.float32)):
        assert raises_in_both(lambda: jeng.predict(bad), lambda: teng.predict(bad))
    one = np.random.default_rng(3).random((8, 8, 1), np.float32)  # one sample, no batch axis
    same_response(teng.predict(one), jeng.predict(one), "one sample")
    assert teng.predict(one)["predictions"].shape == (1,)


def test_ladder_and_bucket_choice_are_jax_s():
    from aggregathor_tpu.serve import bucket_ladder as jladder
    from aggregathor_tpu.serve import choose_bucket as jchoose

    for max_batch, min_bucket in ((1, 1), (5, 1), (64, 1), (64, 4), (100, 3), (128, 128)):
        assert bucket_ladder(max_batch, min_bucket) == jladder(max_batch, min_bucket)
    for rows in range(0, 70):
        assert choose_bucket(rows, (1, 2, 4, 8, 64)) == jchoose(rows, (1, 2, 4, 8, 64))
    with pytest.raises(UserException):
        bucket_ladder(0)


def test_argmax_agrees_with_jax_on_ties_and_nan():
    """The vote's argmax: ties go to the lower index and a row holding NaN
    answers its first NaN, in both packages (``--gar average`` poisoned by a
    NaN replica serves such rows)."""
    import jax.numpy as jnp

    rows = np.array([[1.0, 3.0, 3.0, 0.0], [np.nan, 1.0, np.nan, 2.0], [0.0, np.nan, 5.0, 5.0],
                     [np.nan] * 4, [-np.inf, -np.inf, -np.inf, -np.inf], [2.0, np.inf, np.inf, 1.0]], np.float32)
    got = torch.argmax(torch.from_numpy(rows), dim=-1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(jnp.asarray(rows), axis=-1)))


def test_hot_swap_is_atomic_tagged_and_builds_nothing(pair, monkeypatch):
    """The counterpart of JAX's ``test_engine_hot_swap_is_atomic_tagged_and_recompile_free``:
    predictions flip to the new weights, every response reports the step it
    served from, the retired mask survives, ``compile_count`` stays, and no
    kernel library is built after the warmup; a predict already holding the
    live tuple finishes on the old weights."""
    from aggregathor_tpu_torch.ops import build

    built = []
    build.add_build_listener(lambda *args: built.append(args))
    vote = tgars.instantiate("median", 3, 1)
    engine = InferenceEngine(pair.texp, [pair.tparams] * 3, gar=vote, buckets=BUCKETS, weights_step=10, device="cpu")
    assert engine.warmup() == len(BUCKETS)
    x = pair.requests(seed=5)[2]
    before = engine.predict(x)
    assert before["weights_step"] == 10
    engine.set_active_replicas([0, 2])
    engine.swap_replicas([pair.tstale] * 3, step=20)
    after = engine.predict(x)
    assert after["weights_step"] == 20 and after["active_replicas"] == [0, 2]
    fresh = InferenceEngine(pair.texp, [pair.tstale], buckets=BUCKETS, device="cpu").predict(x)
    np.testing.assert_array_equal(after["logits"], fresh["logits"])
    np.testing.assert_array_equal(after["predictions"], fresh["predictions"])
    assert engine.compile_count == len(BUCKETS)

    # an in-flight predict keeps the stack it read: hold a forward inside
    # the first replica's logits while a swap lands, then let it finish
    entered, release = threading.Event(), threading.Event()
    inner = pair.texp.predict_logits

    def held(params, images):
        if not entered.is_set():
            entered.set()
            release.wait(10.0)
        return inner(params, images)

    monkeypatch.setattr(pair.texp, "predict_logits", held)
    result = {}
    worker = threading.Thread(target=lambda: result.update(engine.predict(x)))
    worker.start()
    assert entered.wait(10.0)
    engine.swap_replicas([pair.tparams] * 3, step=30)
    release.set()
    worker.join(10.0)
    assert result["weights_step"] == 20
    np.testing.assert_array_equal(result["logits"], after["logits"])
    monkeypatch.undo()
    assert engine.predict(x)["weights_step"] == 30
    np.testing.assert_array_equal(engine.predict(x)["logits"], before["logits"])
    assert engine.compile_count == len(BUCKETS) and built == []


def test_live_mutators_are_serialized(pair):
    """The counterpart of JAX's ``test_engine_live_mutators_are_serialized``:
    both mutators hold the live lock, so neither undoes the other."""
    vote = tgars.instantiate("median", 3, 1)
    engine = InferenceEngine(pair.texp, [pair.tparams] * 3, gar=vote, max_batch=4, buckets=(4,), weights_step=1,
                             device="cpu")
    done = {"swap": False, "mask": False}

    def swap():
        engine.swap_replicas([pair.tparams] * 3, step=2)
        done["swap"] = True

    def mask():
        engine.set_active_replicas([0, 2])
        done["mask"] = True

    for name, fn in (("swap", swap), ("mask", mask)):
        engine._live_lock.acquire()
        thread = threading.Thread(target=fn, daemon=True)
        thread.start()
        thread.join(0.3)
        assert not done[name], "%s mutated _live without the live lock" % name
        engine._live_lock.release()
        thread.join(5.0)
        assert done[name]
    assert engine.weights_step == 2
    assert engine.active_replicas == [0, 2]


def test_chunked_request_weights_the_disagreement_by_rows(pair):
    """Above the ladder top a request is cut into top-sized chunks and its
    disagreement is each chunk's weighted by its rows, as in JAX."""
    jeng, teng = pair.engines(3, "average")
    jreps, treps = pair.replicas(3, 1, "noise", 0.1)
    jeng.swap_replicas(jreps, step=3)
    teng.swap_replicas(treps, step=3)
    x = np.random.default_rng(9).random((11, 8, 8, 1), np.float32)  # chunks 4, 4, 3
    got = teng.predict(x)
    same_response(got, jeng.predict(x), "11 rows")
    parts = [teng.predict(x[i:i + 4]) for i in (0, 4, 8)]
    want = sum(p["disagreement"] * (len(p["predictions"]) / 11.0) for p in parts)
    close(got["disagreement"], want, "weighted disagreement", atol=0.0)
    assert got["bucket"] == 4 and got["predictions"].shape == (11,)


def test_restore_params_refuses_a_wrong_optimizer(tmp_path):
    from aggregathor_tpu_torch import models
    from aggregathor_tpu_torch.core import TrainState, build_optimizer, build_schedule
    from aggregathor_tpu_torch.obs.checkpoint import Checkpoints

    exp = models.instantiate("digits", [])
    adam = build_optimizer("adam", build_schedule("fixed", ["initial-rate:0.01"]))
    params = exp.init(0)
    Checkpoints(str(tmp_path)).save(TrainState(params=params, opt_state=adam.init(params), step=4))
    restored, step = restore_params(exp, str(tmp_path), adam)
    assert step == 4 and all(torch.equal(restored[k], params[k]) for k in params)
    sgd = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.01"]))
    with pytest.raises(UserException):
        restore_params(exp, str(tmp_path), sgd)


def test_the_engine_raises_without_a_gpu_unless_asked_for_the_cpu(pair):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(UserException, match="CUDA"):
        InferenceEngine(pair.texp, [pair.tparams])
