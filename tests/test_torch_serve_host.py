"""The port's serving host plane: the counterparts of the JAX package's
``tests/test_serve_sched.py`` (the continuous-batching policy and runtime,
the autoscale hysteresis policy, capacity ladder and feasibility floor, and
the checkpoint watcher, on a synthetic clock), run on
``aggregathor_tpu_torch.serve``'s copies, and the two packages' policies
fed the same synthetic traces."""

import threading
import time

import numpy as np
import pytest

from aggregathor_tpu_torch.serve.autoscale import (
    AutoscaleConfig,
    AutoscalePolicy,
    CapacityLadder,
)
from aggregathor_tpu_torch.serve.continuous import (
    ContinuousBatcher,
    ContinuousPolicy,
    LoadShed,
)
from aggregathor_tpu_torch.serve.weights import CheckpointWatcher
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)


# --------------------------------------------------------------------- #
# ContinuousPolicy: pure batch formation on synthetic time


def test_policy_admit_empty_queue_always_admits():
    policy = ContinuousPolicy((1, 2, 4, 8), queue_bound=4)
    # an empty queue admits ANY request up to the ladder top, even over
    # the bound: the bound caps WAITING work only
    assert policy.admit(0, 8)
    assert policy.admit(0, 5)
    # queued work over the bound sheds
    assert policy.admit(2, 2)
    assert not policy.admit(3, 2)
    assert not policy.admit(4, 1)


def test_policy_admit_rejects_degenerate_requests():
    policy = ContinuousPolicy((1, 2, 4), queue_bound=16)
    with pytest.raises(UserException):
        policy.admit(0, 0)  # empty request
    with pytest.raises(UserException):
        policy.admit(0, 5)  # beyond the ladder top: split client-side


def test_policy_plan_takes_fifo_prefix_to_smallest_bucket():
    policy = ContinuousPolicy((1, 2, 4, 8), queue_bound=64)
    assert policy.plan([], now=0.0) == ("idle", None)
    # 3+2 rows fit the top; the smallest covering bucket is 8
    kind, (take, bucket) = policy.plan([(3, 0.0), (2, 0.0), (8, 0.0)], now=0.0)
    assert kind == "dispatch" and take == 2 and bucket == 8
    # an 8-row head takes the whole top alone
    kind, (take, bucket) = policy.plan([(8, 0.0), (1, 0.0)], now=0.0)
    assert kind == "dispatch" and take == 1 and bucket == 8
    # formation always starts at the HEAD: the oldest request is in every
    # dispatched batch (starvation-freedom is structural)
    kind, (take, bucket) = policy.plan([(1, 0.0), (8, 1.0)], now=5.0)
    assert kind == "dispatch" and take == 1 and bucket == 1


def test_policy_linger_delays_only_subtop_batches():
    policy = ContinuousPolicy((1, 2, 4, 8), queue_bound=64, linger_s=0.5)
    # sub-top batch inside the window: wait until oldest arrival + linger
    kind, due = policy.plan([(2, 10.0)], now=10.1)
    assert kind == "wait" and due == pytest.approx(10.5)
    # window expired: dispatch
    kind, _ = policy.plan([(2, 10.0)], now=10.5)
    assert kind == "dispatch"
    # a FULL top bucket never lingers
    kind, (take, bucket) = policy.plan([(8, 10.0)], now=10.0)
    assert kind == "dispatch" and bucket == 8
    # linger 0 is pure continuous batching: immediate dispatch
    eager = ContinuousPolicy((1, 2, 4, 8), queue_bound=64)
    assert eager.plan([(2, 10.0)], now=10.0)[0] == "dispatch"


def test_policy_validation_rejects_bad_configs():
    with pytest.raises(UserException):
        ContinuousPolicy(())
    with pytest.raises(UserException):
        ContinuousPolicy((4, 2, 1))  # unsorted
    with pytest.raises(UserException):
        ContinuousPolicy((0, 2))
    with pytest.raises(UserException):
        ContinuousPolicy((1, 2), queue_bound=0)
    with pytest.raises(UserException):
        ContinuousPolicy((1, 2), linger_s=-1.0)


# --------------------------------------------------------------------- #
# ContinuousBatcher runtime (fake runners; wall clock only as a timeout
# guard, never as the asserted signal)


def _wedge_runner(sizes, entered, release):
    """A runner that parks inside its first call until released."""

    def run(rows):
        entered.set()
        assert release.wait(10.0), "test forgot to release the runner"
        sizes.append(int(rows.shape[0]))
        return {"predictions": np.arange(rows.shape[0])}

    return run


def test_batcher_dispatches_immediately_when_idle():
    """Continuous batching's defining property vs the retired deadline
    batcher: a lone request on an idle lane is dispatched at once."""
    sizes = []

    def run(rows):
        sizes.append(int(rows.shape[0]))
        return {"predictions": np.arange(rows.shape[0])}

    batcher = ContinuousBatcher(run, buckets=(1, 2, 4, 8), queue_bound=64)
    try:
        result = batcher.submit(np.zeros((2, 4))).wait(10.0)
        assert sizes == [2]
        assert list(result["predictions"]) == [0, 1]
    finally:
        batcher.close()


def test_batcher_slot_reuse_coalesces_backlog():
    """While the one lane is busy, arrivals accumulate; the freed slot
    takes the WHOLE backlog as one batch (in-flight time is the batching
    window)."""
    sizes, entered, release = [], threading.Event(), threading.Event()
    batcher = ContinuousBatcher(_wedge_runner(sizes, entered, release),
                                buckets=(1, 2, 4, 8), queue_bound=64)
    try:
        first = batcher.submit(np.zeros((1, 4)))
        assert entered.wait(5.0)  # the lane is wedged inside batch 1
        backlog = [batcher.submit(np.zeros((1, 4))) for _ in range(3)]
        assert batcher.queue_depth == 3
        release.set()
        for ticket in [first] + backlog:
            ticket.wait(10.0)
        assert sizes == [1, 3], "backlog did not coalesce into one dispatch"
        assert batcher.queue_depth == 0
        assert batcher.batch_count == 2
        assert batcher.served_rows == 4
    finally:
        release.set()
        batcher.close()


def test_batcher_starvation_freedom_under_sustained_arrivals():
    """The oldest queued request rides the FIRST dispatch after a lane
    frees — younger arrivals cannot jump it (FIFO formation)."""
    batches, entered, release = [], threading.Event(), threading.Event()

    def run(rows):
        entered.set()
        assert release.wait(10.0)
        batches.append([int(v) for v in rows[:, 0]])
        return {"predictions": np.arange(rows.shape[0])}

    batcher = ContinuousBatcher(run, buckets=(1, 2), queue_bound=64)
    try:
        first = batcher.submit(np.zeros((1, 4)))
        assert entered.wait(5.0)
        # tagged rows: the value identifies the submission order
        tagged = [batcher.submit(np.full((1, 4), tag)) for tag in (1, 2, 3, 4)]
        release.set()
        for ticket in [first] + tagged:
            ticket.wait(10.0)
        flat = [tag for batch in batches for tag in batch]
        assert flat == sorted(flat), "a younger request overtook an older one"
    finally:
        release.set()
        batcher.close()


def test_batcher_sheds_under_saturation_and_recovers():
    sizes, entered, release = [], threading.Event(), threading.Event()
    batcher = ContinuousBatcher(_wedge_runner(sizes, entered, release),
                                buckets=(1, 2, 4), queue_bound=4)
    try:
        first = batcher.submit(np.zeros((1, 4)))
        assert entered.wait(5.0)
        held = [batcher.submit(np.zeros((1, 4))) for _ in range(4)]
        with pytest.raises(LoadShed):
            batcher.submit(np.zeros((1, 4)))
        assert batcher.shed_count == 1
        release.set()
        for ticket in [first] + held:
            ticket.wait(10.0)
        assert batcher.queue_depth == 0
        # drained: the next submit admits again
        assert batcher.submit(np.zeros((1, 4))).wait(10.0) is not None
    finally:
        release.set()
        batcher.close()


def test_batcher_timeout_cancels_queued_rows():
    """A timed-out ticket's rows leave the queue: lanes never run dead
    work for a caller that already got its 504."""
    sizes, entered, release = [], threading.Event(), threading.Event()
    batcher = ContinuousBatcher(_wedge_runner(sizes, entered, release),
                                buckets=(1, 2, 4), queue_bound=16)
    try:
        first = batcher.submit(np.zeros((1, 4)))
        assert entered.wait(5.0)
        doomed = batcher.submit(np.zeros((2, 4)))
        with pytest.raises(TimeoutError):
            doomed.wait(0.05)
        assert batcher.queue_depth == 0
        assert batcher.cancelled_count == 1
        survivor = batcher.submit(np.zeros((1, 4)))
        release.set()
        first.wait(10.0)
        survivor.wait(10.0)
        assert sizes == [1, 1], "cancelled rows were still dispatched"
    finally:
        release.set()
        batcher.close()


def test_batcher_scales_lanes_up_and_down_live():
    entered, release = threading.Event(), threading.Event()
    in_flight_peak = []

    def run(rows):
        entered.set()
        assert release.wait(10.0)
        return {"predictions": np.arange(rows.shape[0])}

    batcher = ContinuousBatcher(run, buckets=(1,), queue_bound=64,
                                nb_lanes=1, max_lanes=3)
    try:
        tickets = [batcher.submit(np.zeros((1, 4))) for _ in range(3)]
        assert entered.wait(5.0)
        assert batcher.in_flight == 1  # one lane, one in-flight batch
        batcher.set_lanes(3)
        deadline = time.monotonic() + 5.0
        while batcher.in_flight < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert batcher.in_flight == 3, "scale-up did not open new lanes"
        # scale DOWN below the in-flight count: running batches finish,
        # excess lanes exit only after their current work completes
        batcher.set_lanes(1)
        release.set()
        for ticket in tickets:
            ticket.wait(10.0)
        deadline = time.monotonic() + 5.0
        while len(batcher._lane_threads) > 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert batcher.nb_lanes == 1
        assert len(batcher._lane_threads) == 1, "excess lanes never exited"
        # the surviving lane still serves
        assert batcher.submit(np.zeros((1, 4))).wait(10.0) is not None
    finally:
        release.set()
        batcher.close()
    with pytest.raises(UserException):
        ContinuousBatcher(run, buckets=(1,), nb_lanes=2, max_lanes=1)


def test_lane_deregistration_is_identity_checked():
    """After a shrink/expand cycle an index can belong to a FRESH lane
    thread before the old one has finished unwinding — the old thread's
    exit path must not evict the new thread's pool registration."""
    batcher = ContinuousBatcher(
        lambda rows: {"predictions": np.arange(rows.shape[0])},
        buckets=(1,), queue_bound=16,
    )
    try:
        sentinel = threading.Thread(target=lambda: None)  # "the new lane"
        with batcher._cond:
            batcher._lane_threads[7] = sentinel
            batcher._deregister_lane(7)  # caller is NOT thread 7's owner
            assert batcher._lane_threads[7] is sentinel, (
                "an exiting lane evicted its successor's registration"
            )
            del batcher._lane_threads[7]
    finally:
        batcher.close()


def test_batcher_survives_rapid_shrink_expand_cycles():
    """set_lanes(1); set_lanes(2) back-to-back must always leave TWO live
    lanes: the exit decision and the pool deregistration are one atomic
    step, so a scale-up can never be skipped against a zombie entry."""
    batcher = ContinuousBatcher(
        lambda rows: {"predictions": np.arange(rows.shape[0])},
        buckets=(1,), queue_bound=64, nb_lanes=2, max_lanes=2,
    )
    try:
        for _ in range(20):
            batcher.set_lanes(1)
            batcher.set_lanes(2)
        deadline = time.monotonic() + 5.0
        while len(batcher._lane_threads) != 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert batcher.nb_lanes == 2
        assert len(batcher._lane_threads) == 2, (
            "a scale-up was skipped against an exiting lane's stale entry"
        )
        assert batcher.submit(np.zeros((1, 4))).wait(10.0) is not None
    finally:
        batcher.close()


def test_batcher_runner_error_surfaces_and_lane_survives():
    calls = []

    def run(rows):
        calls.append(int(rows.shape[0]))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return {"predictions": np.arange(rows.shape[0])}

    batcher = ContinuousBatcher(run, buckets=(1, 2), queue_bound=16)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            batcher.submit(np.zeros((1, 4))).wait(10.0)
        # the lane survived the failure and serves the next request
        assert batcher.submit(np.zeros((1, 4))).wait(10.0) is not None
    finally:
        batcher.close()


def test_batcher_close_is_idempotent_and_fails_queued():
    entered, release = threading.Event(), threading.Event()
    batcher = ContinuousBatcher(_wedge_runner([], entered, release),
                                buckets=(1,), queue_bound=16)
    first = batcher.submit(np.zeros((1, 4)))
    assert entered.wait(5.0)
    doomed = batcher.submit(np.zeros((1, 4)))
    release.set()
    batcher.close()
    batcher.close()  # idempotent
    first.wait(10.0)  # in-flight work finished
    with pytest.raises(RuntimeError):
        doomed.wait(10.0)  # queued work failed, not served
    with pytest.raises(RuntimeError):
        batcher.submit(np.zeros((1, 4)))


# --------------------------------------------------------------------- #
# AutoscalePolicy: hysteresis on synthetic ticks


def _config(**overrides):
    pairs = {"up-patience": 2, "down-patience": 3, "cooldown": 5,
             "high-queue": 10, "low-queue": 1, "high-p99": 0.5,
             "low-p99": 0.1, "high-shed": 0.5, "low-shed": 0.0}
    pairs.update(overrides)
    return AutoscaleConfig(["%s:%s" % (k, v) for k, v in pairs.items()])


def test_autoscale_policy_expand_needs_sustained_pressure():
    policy = AutoscalePolicy(_config())
    assert policy.observe(0.0, queue_rows=50, p99_s=None, shed_rate=0.0) is None
    assert policy.observe(1.0, queue_rows=50, p99_s=None, shed_rate=0.0) == "expand"
    # cooldown suppresses the next move even under continued pressure
    assert policy.observe(2.0, queue_rows=50, p99_s=None, shed_rate=0.0) is None
    assert policy.observe(3.0, queue_rows=50, p99_s=None, shed_rate=0.0) is None
    # past the cooldown the streak has rebuilt: expand again
    assert policy.observe(7.0, queue_rows=50, p99_s=None, shed_rate=0.0) == "expand"


def test_autoscale_policy_any_watermark_is_pressure():
    for signal in ({"queue_rows": 50, "p99_s": 0.0, "shed_rate": 0.0},
                   {"queue_rows": 0, "p99_s": 1.0, "shed_rate": 0.0},
                   {"queue_rows": 0, "p99_s": 0.0, "shed_rate": 2.0}):
        policy = AutoscalePolicy(_config())
        policy.observe(0.0, **signal)
        assert policy.observe(1.0, **signal) == "expand", signal


def test_autoscale_policy_shrink_needs_sustained_calm_everywhere():
    policy = AutoscalePolicy(_config())
    for tick in range(2):
        assert policy.observe(float(tick), 0, 0.01, 0.0) is None
    assert policy.observe(2.0, 0, 0.01, 0.0) == "shrink"
    # the hysteresis band (neither pressured nor calm) RESETS both streaks
    policy = AutoscalePolicy(_config())
    policy.observe(0.0, 0, 0.01, 0.0)
    policy.observe(1.0, 0, 0.01, 0.0)
    policy.observe(2.0, 5, 0.3, 0.0)  # inside the band
    assert policy.observe(3.0, 0, 0.01, 0.0) is None  # streak restarted
    # an unmeasured p99 is calm-compatible, never pressure
    policy = AutoscalePolicy(_config())
    for tick in range(2):
        policy.observe(float(tick), 0, None, 0.0)
    assert policy.observe(2.0, 0, None, 0.0) == "shrink"


def test_autoscale_config_rejects_bad_values():
    with pytest.raises(UserException):
        AutoscaleConfig(["interval:0"])
    with pytest.raises(UserException):
        AutoscaleConfig(["high-queue:1", "low-queue:5"])  # low > high
    with pytest.raises(UserException):
        AutoscaleConfig(["up-patience:0"])
    with pytest.raises(UserException):
        AutoscaleConfig(["cooldown:-1"])
    with pytest.raises(UserException):
        AutoscaleConfig(["fault-reserve:-1"])
    with pytest.raises(UserException):
        AutoscaleConfig(["min-lanes:0"])
    with pytest.raises(UserException):
        AutoscaleConfig(["bogus-knob:1"])


def test_capacity_ladder_orders_lanes_before_retirement():
    ladder = CapacityLadder(min_lanes=1, max_lanes=3, max_retire=2)
    assert ladder.rungs == ((1, 0), (2, 0), (3, 0), (3, 1), (3, 2))
    assert ladder.rung(0) == (1, 0)
    assert ladder.index_of(2, 0) == 1
    assert ladder.index_of(3, 2) == 4
    # retirement never exists below the lane ceiling
    assert all(lanes == 3 for lanes, retired in ladder.rungs if retired)
    # max_retire 0: the f floor in ladder form — no retirement rung at all
    flat = CapacityLadder(1, 2, 0)
    assert flat.rungs == ((1, 0), (2, 0))
    with pytest.raises(UserException):
        CapacityLadder(3, 2, 0)


# --------------------------------------------------------------------- #
# CheckpointWatcher: the weight pipeline on synthetic steps


def test_watcher_swaps_newer_keeps_older_and_counts_failures():
    from aggregathor_tpu_torch.obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    available = [10]
    swapped = []
    fail_next = []

    def reload(step):
        if fail_next:
            raise RuntimeError(fail_next.pop())
        swapped.append(step)

    watcher = CheckpointWatcher(lambda: list(available), reload,
                                served_step=10, registry=registry)
    try:
        assert watcher.check_once() is None  # nothing newer
        available.append(20)
        assert watcher.check_once() == 20
        assert watcher.served_step == 20 and swapped == [20]
        # a FAILED reload keeps the previous step serving and is counted
        available.append(30)
        fail_next.append("torn snapshot")
        assert watcher.check_once() is None
        assert watcher.served_step == 20
        families = {f.name: f for f in registry.families()}
        assert families["serve_weight_swap_failures_total"].value == 1
        # the next poll retries and succeeds
        assert watcher.check_once() == 30
        assert watcher.served_step == 30
        # force=True re-restores even with nothing newer (the SIGHUP path)
        assert watcher.check_once(force=True) == 30
        assert swapped == [20, 30, 30]
        assert families["serve_weight_swaps_total"].value == 3
    finally:
        watcher.close()


def test_watcher_poll_failure_is_not_fatal():
    from aggregathor_tpu_torch.obs.metrics import MetricsRegistry

    registry = MetricsRegistry()

    def bad_poll():
        raise OSError("mount vanished")

    watcher = CheckpointWatcher(bad_poll, lambda step: None, served_step=5,
                                registry=registry)
    try:
        assert watcher.check_once() is None
        assert watcher.served_step == 5
        families = {f.name: f for f in registry.families()}
        assert families["serve_weight_swap_failures_total"].value == 1
    finally:
        watcher.close()
    with pytest.raises(UserException):
        CheckpointWatcher(lambda: [], lambda step: None, interval_s=0.0)


# --------------------------------------------------------------------- #
# the two packages' policies on the same synthetic traces


def test_policies_decide_as_the_jax_package_on_random_traces():
    """``ContinuousPolicy.admit``/``plan`` and ``AutoscalePolicy.observe``
    give the JAX package's decisions, step for step, on random queues and
    signal traces."""
    from aggregathor_tpu.serve import autoscale as jautoscale
    from aggregathor_tpu.serve import continuous as jcontinuous

    rng = np.random.default_rng(20261018)
    for linger in (0.0, 0.005):
        jpolicy = jcontinuous.ContinuousPolicy((1, 2, 4, 8), queue_bound=12, linger_s=linger)
        tpolicy = ContinuousPolicy((1, 2, 4, 8), queue_bound=12, linger_s=linger)
        for _ in range(400):
            queue = [(int(rng.integers(1, 9)), float(rng.random() * 0.01)) for _ in range(rng.integers(0, 6))]
            queue.sort(key=lambda item: item[1])
            now = float(rng.random() * 0.02)
            assert tpolicy.plan(queue, now) == jpolicy.plan(queue, now)
            queued, new = int(rng.integers(0, 16)), int(rng.integers(1, 9))
            assert tpolicy.admit(queued, new) == jpolicy.admit(queued, new)
    args = ["up-patience:2", "down-patience:3", "cooldown:0.5", "high-queue:8", "low-queue:2",
            "high-p99:0.2", "low-p99:0.05", "high-shed:1", "low-shed:0"]
    jscale = jautoscale.AutoscalePolicy(jautoscale.AutoscaleConfig(args))
    tscale = AutoscalePolicy(AutoscaleConfig(args))
    now = 0.0
    for _ in range(600):
        now += float(rng.random() * 0.3)
        queue = float(rng.choice([0.0, 1.0, 5.0, 20.0]))
        p99 = None if rng.random() < 0.2 else float(rng.choice([0.01, 0.1, 0.5]))
        shed = float(rng.choice([0.0, 0.0, 0.5, 3.0]))
        assert tscale.observe(now, queue, p99, shed) == jscale.observe(now, queue, p99, shed)
        assert (tscale.pressure_streak, tscale.calm_streak) == (jscale.pressure_streak, jscale.calm_streak)
    for lanes in ((1, 1, 0), (1, 4, 2), (2, 3, 1)):
        assert CapacityLadder(*lanes).rungs == jautoscale.CapacityLadder(*lanes).rungs
