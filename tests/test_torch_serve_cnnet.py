"""The port's serving engine against the JAX package's, on ``cnnet``.

The convolutional counterpart of ``test_torch_serve_engine.py`` (which
holds every rule at R = 3 and 5 on digits): cnnet at buckets (1, 2, 4),
unvoted at R = 1, median (the serve CLI's default) at R = 3 under every
poison mode, krum and average-nan at R = 5 under the modes in turn, with
requests of 1, 2 and 5 rows (5 is chunked 4 + 1), against the JAX engine
on the same replicas and requests (``serve_parity.py`` states the
tolerances).  Both cnnets compute in float64
(``serve_parity.cnnet_in_float64``: in float32 their convolutions differ by
~2e-5 relative, beyond the vote's tolerance); the vote stays float32.
"""

import jax
import pytest

from serve_parity import Pair, cnnet_in_float64, run_matrix, two_threads  # noqa: F401  (a fixture)

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

pytestmark = pytest.mark.usefixtures("two_threads", "x64")

#: R = 1 unvoted; median under every mode at R = 3; the distance rule and
#: the NaN-excluding mean at R = 5, the modes between them
CASES = [(1, None, ()), (3, "median", None), (5, "krum", ("nan", "zero", "stale")),
         (5, "average-nan", ("scale", "noise"))]


@pytest.fixture(scope="module")
def x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(scope="module")
def pair(x64):
    return Pair(experiments=cnnet_in_float64(), requests=(1, 2, 5))


@pytest.mark.parametrize("nb_replicas, rule, modes", CASES, ids=["R%d-%s" % case[:2] for case in CASES])
def test_cnnet_engine_matches_the_jax_engine_under_every_poison(pair, nb_replicas, rule, modes):
    left, rows = run_matrix(pair, nb_replicas, rule, modes)
    assert left * 100 <= rows, (left, rows)
