"""Trace where the port's ``int8:ef`` steps leave the JAX engine's.

    JAX_PLATFORMS=cpu python tests/trace_int8_ef_parity.py

The setup of ``tests/test_torch_codec.py::test_codec_steps_match_the_jax_engine``
(mnist hidden:16, krum n = 8, f = 2, r = 2 signflip, three steps).  Both
codecs' inputs are captured each step (JAX's through ordered debug
callbacks, the port's by wrapping its methods at run time; neither package
is edited): the gradient row, the residual it is added to, and their sum.
For each coordinate whose int8 quotient differs it prints the two sums,
the quotients, and which of the gradient, the residual and the scale
differ; then whether each package's residual is the unfused
``target - q * scale`` or a fused multiply-add.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from aggregathor_tpu import gars as jgars, models as jmodels  # noqa: E402
from aggregathor_tpu.core import build_optimizer as jax_optimizer, build_schedule as jax_schedule  # noqa: E402
from aggregathor_tpu.parallel import RobustEngine as JaxEngine, attacks as jattacks, make_mesh  # noqa: E402
from aggregathor_tpu.parallel import compress as jcompress  # noqa: E402
from aggregathor_tpu_torch import gars as tgars, models as tmodels  # noqa: E402
from aggregathor_tpu_torch.core import build_optimizer, build_schedule  # noqa: E402
from aggregathor_tpu_torch.models.common import params_from_jax  # noqa: E402
from aggregathor_tpu_torch.parallel import RobustEngine, attacks  # noqa: E402
from aggregathor_tpu_torch.parallel import compress as tcompress  # noqa: E402

N, F, R, STEPS = 8, 2, 2, 3


def capture():
    """Wrap both packages' ``ef_encode``: {package: [(gradient, residual)] a step}."""
    seen = {"jax": [], "port": []}
    jax_ef, port_ef = jcompress.WireCodec.ef_encode, tcompress.WireCodec.ef_encode

    def jax_wrapped(self, row, ef_row):
        jax.debug.callback(lambda r, e: seen["jax"].append((np.array(r), np.array(e))), row, ef_row, ordered=True)
        return jax_ef(self, row, ef_row)

    def port_wrapped(self, row, ef_row):
        seen["port"].append((row.detach().clone().numpy(), ef_row.detach().clone().numpy()))
        return port_ef(self, row, ef_row)

    jcompress.WireCodec.ef_encode, tcompress.WireCodec.ef_encode = jax_wrapped, port_wrapped
    return seen


def quotients(target):
    scale = np.abs(target).max(axis=1, keepdims=True) / np.float32(127.0)
    return scale, np.clip(np.round(target / scale), -127, 127).astype(np.float32)


def main():
    seen = capture()
    exp_args = ["hidden:16", "batch-size:16"]
    jexp, texp = jmodels.instantiate("mnist", exp_args), tmodels.instantiate("mnist", exp_args)
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate("krum", N, F), nb_workers=N, nb_real_byz=R,
                        attack=jattacks.instantiate("signflip", N, R), exchange="int8:ef")
    tengine = RobustEngine(tgars.instantiate("krum", N, F), N, nb_real_byz=R,
                           attack=attacks.instantiate("signflip", N, R), exchange="int8:ef", device="cpu")
    init = jexp.init(jax.random.PRNGKey(11))
    jstep, tstep = jengine.build_step(jexp.loss, jtx), tengine.build_step(texp.loss, ttx)
    jstate = jengine.init_state(init, jtx, seed=1)
    tstate = tengine.init_state(params_from_jax(jax.tree_util.tree_map(np.asarray, init)), ttx, seed=1)
    it = jexp.make_train_iterator(N, seed=2)
    for step in range(STEPS):
        batch = next(it)
        jstate, _ = jstep(jstate, jengine.shard_batch(batch))
        tstate, _ = tstep(tstate, tengine.put_batch(batch))
        jax.effects_barrier()
        jg = np.stack([g for g, _ in seen["jax"][step * N:(step + 1) * N]])
        je = np.stack([e for _, e in seen["jax"][step * N:(step + 1) * N]])
        tg, te = seen["port"][step]
        jt, tt = jg + je, tg + te
        (js, jq), (ts, tq) = quotients(jt), quotients(tt)
        print("step %d: gradient bits differ at %d of %d coordinates" % (step, (jg.view(np.uint32) != tg.view(
            np.uint32)).sum(), jg.size))
        for w, c in np.argwhere(jq != tq)[:5]:
            print("  worker %d coordinate %d: target %.9g / %.9g, quotient %.9g / %.9g (JAX / port); differ: %s"
                  % (w, c, jt[w, c], tt[w, c], jt[w, c] / js[w, 0], tt[w, c] / ts[w, 0], ", ".join(
                      name for name, a, b in (("gradient", jg[w, c], tg[w, c]), ("residual", je[w, c], te[w, c]),
                                              ("scale", js[w, 0], ts[w, 0])) if a != b) or "nothing"))
        if step == 0:
            continue
        # was the residual carried into this step unfused, in each package?
        for name, (g0, e0, e1) in (("JAX", (np.stack([g for g, _ in seen["jax"][(step - 1) * N:step * N]]) + np.stack(
                [e for _, e in seen["jax"][(step - 1) * N:step * N]]), None, je)),
                                   ("port", (seen["port"][step - 1][0] + seen["port"][step - 1][1], None, te))):
            scale, q = quotients(g0)
            unfused = (g0 - (q * scale).astype(np.float32)).astype(np.float32)
            fused = (g0.astype(np.float64) - q.astype(np.float64) * scale.astype(np.float64)).astype(np.float32)
            print("  %s residual equals the unfused value at %.4f, the fused at %.4f of its coordinates"
                  % (name, (unfused.view(np.uint32) == e1.view(np.uint32)).mean(),
                     (fused.view(np.uint32) == e1.view(np.uint32)).mean()))


if __name__ == "__main__":
    main()
