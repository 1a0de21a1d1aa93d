"""Shared cases of the serving parity tests: the JAX package's
``InferenceEngine`` and the port's on the same replicas and requests.

The replicas are the JAX experiment's initial weights (``PRNGKey(0)``),
carried into the port with ``params_from_jax``; a faulty replica is each
package's own ``corrupt_params`` of them (bit for bit the same draws), and a
``stale`` one the weights of ``PRNGKey(1)``.  Requests are numpy draws from
a fixed seed.
"""

import jax
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.chaos import corrupt_params as jcorrupt
from aggregathor_tpu.serve import InferenceEngine as JaxEngine
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.chaos.replica_faults import corrupt_params as tcorrupt
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.serve import InferenceEngine
from aggregathor_tpu_torch.utils import UserException

BUCKETS = (1, 2, 4)
#: request sizes: buckets 1 and 2, and one above the top (chunks of 4 and 3
#: rows, the second padded, the disagreement weighted by their rows)
REQUESTS = (1, 2, 7)
#: (label, mode, value); ``stale`` serves another checkpoint's weights
POISONS = (("clean", None, None), ("nan", "nan", None), ("scale", "scale", 100.0), ("zero", "zero", None),
           ("noise", "noise", 0.1), ("stale", "stale", None))
#: a row's prediction is compared when its top two voted logits (JAX's) are
#: further apart than this; the rows left out may be at most 1 in 100
GAP = 1e-4
#: logits and disagreement: the packages' float32 forwards sum in other
#: orders (XLA's against torch's matmul and convolution), a few ulps a layer
RTOL, ATOL_SCALE = 1e-5, 1e-6
#: the vote rules held at R = 3 and 5 (f = (R - 1) // 2, the serve CLI's
#: default); krum needs R >= f + 3, so it votes at R = 5 only
RULES = ("median", "averaged-median", "trimmed-mean", "average-nan", "average", "krum")


def feasible(rule, nb_replicas):
    return not (rule == "krum" and nb_replicas < 5)


@pytest.fixture
def two_threads():
    """Two intra-op threads: the small forwards stall on a full pool when
    the suite's workers share the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cnnet_in_float64():
    """(JAX, port) cnnet experiments computing in float64, built without
    their datasets (serving needs the model alone).  The weights stay
    float32; the logits layer computes in float32 in both, as in their bf16
    mode, and the port's norms in float32 (1e-7 off flax's float64 ones).
    In float32 the two packages' convolutions of 1,600 terms differ by ~2e-5
    relative; in float64 the logits agree to float32 rounding.  The vote is
    float32 either way (both engines cast the logits).  Run the JAX side
    under ``jax.enable_x64(True)``."""
    import jax.numpy as jnp

    from aggregathor_tpu.models.cnnet import CNNet as JaxCNNet
    from aggregathor_tpu_torch.models.cnnet import CNNet

    jcls, tcls = jmodels.get("cnnet"), tmodels.get("cnnet")
    jexp, texp = jcls.__new__(jcls), tcls.__new__(tcls)
    jexp.args = texp.args = []
    jexp.model = JaxCNNet(classes=10, dtype=jnp.float64)
    texp.model = CNNet(classes=10, dtype=torch.float64)
    # JAX's cnnet keeps no sample shape (its serving engine needs one)
    jexp.sample_shape = texp.sample_shape
    return jexp, texp


class Pair:
    """One experiment in both packages (``name`` and its ``args``, or the
    prebuilt ``experiments``) with its replicas' weights."""

    def __init__(self, name=None, args=(), experiments=None, requests=REQUESTS):
        if experiments is None:
            experiments = jmodels.instantiate(name, list(args)), tmodels.instantiate(name, list(args))
        self.jexp, self.texp = experiments
        self.sample_shape = tuple(self.texp.sample_shape)
        self.request_rows = tuple(requests)
        init = jax.jit(self.jexp.init)
        self.jparams = _host(init(jax.random.PRNGKey(0)))
        self.jstale = _host(init(jax.random.PRNGKey(1)))
        self.tparams = params_from_jax(self.jparams)
        self.tstale = params_from_jax(self.jstale)
        self._engines = {}

    def replicas(self, nb_replicas, nb_faulty, mode, value, seed=0):
        """(JAX replicas, port replicas): the clean weights, then
        ``nb_faulty`` faulty ones at the last indices."""
        jreps = [self.jparams] * (nb_replicas - nb_faulty)
        treps = [self.tparams] * (nb_replicas - nb_faulty)
        for k in range(nb_faulty):
            if mode == "stale":
                jreps.append(self.jstale)
                treps.append(self.tstale)
            else:
                jreps.append(jcorrupt(self.jparams, mode, value, seed=seed + 17 * (k + 1)))
                treps.append(tcorrupt(self.tparams, mode, value, seed=seed + 17 * (k + 1)))
        return jreps, treps

    def engines(self, nb_replicas, rule):
        """(JAX engine, port engine) over the clean replicas, warmed up; one
        pair a (R, rule), shared by the tests of a module."""
        key = (nb_replicas, rule)
        if key not in self._engines:
            f = (nb_replicas - 1) // 2
            jgar = jgars.instantiate(rule, nb_replicas, f) if rule else None
            tgar = tgars.instantiate(rule, nb_replicas, f) if rule else None
            jreps, treps = self.replicas(nb_replicas, 0, None, None)
            jeng = JaxEngine(self.jexp, jreps, gar=jgar, buckets=BUCKETS)
            teng = InferenceEngine(self.texp, treps, gar=tgar, buckets=BUCKETS, device="cpu")
            assert jeng.warmup() == teng.warmup() == len(BUCKETS)
            self._engines[key] = (jeng, teng)
        return self._engines[key]

    def requests(self, seed=0):
        rng = np.random.default_rng(seed)
        return [rng.random((k,) + self.sample_shape, np.float32) for k in self.request_rows]


def scale_of(values):
    """The largest finite magnitude of ``values`` (0 when none is finite)."""
    values = np.asarray(values, np.float64)
    finite = np.isfinite(values)
    return float(np.max(np.abs(values[finite]))) if finite.any() else 0.0


def close(got, want, label, atol=None):
    """Non-finite patterns identical; finite values within RTOL and ``atol``
    (default ATOL_SCALE times the largest finite magnitude of ``want``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    for pattern in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(pattern(got), pattern(want)), "%s: %s pattern differs" % (label, pattern.__name__)
    finite = np.isfinite(want)
    if atol is None:
        atol = ATOL_SCALE * scale_of(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL, atol=atol, err_msg=label)


def same_predictions(got, want, logits, label):
    """Predictions identical on every row whose top two voted logits lie
    more than GAP apart (rows holding NaN included: both argmaxes return the
    first NaN); returns (rows left out, rows)."""
    logits = np.asarray(logits, np.float64)
    top2 = np.sort(np.where(np.isnan(logits), np.inf, logits), axis=-1)[:, -2:]
    with np.errstate(invalid="ignore"):
        gap = top2[:, 1] - top2[:, 0]
    decided = np.isnan(logits).any(axis=-1) | ~(gap <= GAP)
    np.testing.assert_array_equal(np.asarray(got)[decided], np.asarray(want)[decided], err_msg=label)
    return int((~decided).sum()), int(len(decided))


def same_response(got, want, label):
    """One predict's response in both packages; returns (left out, rows)."""
    close(got["logits"], want["logits"], label + " logits")
    # the disagreement is a mean squared deviation of the logits: the same
    # tolerance carried to squares, so a vote that rounds one ulp off a
    # clean replica's logits (a mean of equal values) reads ~1e-16 against 0
    close(got["disagreement"], want["disagreement"], label + " disagreement",
          atol=(ATOL_SCALE * scale_of(want["logits"])) ** 2)
    assert got["bucket"] == want["bucket"], label
    assert got["weights_step"] == want["weights_step"], label
    assert got["active_replicas"] == want["active_replicas"], label
    return same_predictions(got["predictions"], want["predictions"], want["logits"], label + " predictions")


def run_matrix(pair, nb_replicas, rule, modes=None):
    """The clean weights, then each poison mode (``modes``: their labels,
    default all) at the last f indices, through one engine pair by hot
    swaps; returns (left out, rows) over the requests."""
    jeng, teng = pair.engines(nb_replicas, rule)
    f = (nb_replicas - 1) // 2 if rule else 0
    left = rows = 0
    poisons = [p for p in POISONS if p[1] is None or (f and (modes is None or p[0] in modes))]
    for step, (label, mode, value) in enumerate(poisons):
        jreps, treps = pair.replicas(nb_replicas, f if mode else 0, mode, value)
        jeng.swap_replicas(jreps, step=step)
        assert teng.swap_replicas(treps, step=step) == len(BUCKETS)
        for x in pair.requests(seed=step):
            what = "R=%d %s %s %d rows" % (nb_replicas, rule, label, len(x))
            a, b = same_response(teng.predict(x), jeng.predict(x), what)
            left, rows = left + a, rows + b
    assert teng.compile_count == len(BUCKETS)
    return left, rows


def raises_in_both(jcall, tcall):
    """True when both raise their package's UserException, False when
    neither does; anything else fails."""
    try:
        jcall()
        jraised = False
    except JaxUserException:
        jraised = True
    try:
        tcall()
        traised = False
    except UserException:
        traised = True
    assert jraised == traised, (jraised, traised)
    return traised
