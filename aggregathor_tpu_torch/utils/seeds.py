"""Integer seeds derived from integer seeds: the port's ``jax.random.fold_in``.

The JAX package threads PRNG keys and folds data into them; the port
threads int seeds and derives children with :func:`fold_in_seed`.  It lives
here, below both ``gars`` (the meta-rules fold their children's keys) and
``parallel`` (the engine's per-step streams, the guardian's perturbation),
so neither imports the other for it.
"""

import numpy as np


def fold_in_seed(seed, data):
    """A new seed drawn from ``SeedSequence([seed, data])``: the port's
    ``jax.random.fold_in``.  The guardian replaces a restored state's seed
    with ``fold_in_seed(seed, RNG_PERTURB_TAG + attempt)``, which moves every
    (seed, step, worker, tag) stream of the retry; the engine's per-step GAR
    key is ``fold_in_seed(fold_in_seed(seed, step), GAR_KEY_TAG)``."""
    return int(np.random.SeedSequence([int(seed), int(data)]).generate_state(1, np.uint64)[0] >> np.uint64(1))
