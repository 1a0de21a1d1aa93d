"""The port's host C++ tier (``aggregathor_tpu_torch/ops/native``) and its
six ``*-native`` rule names, against the JAX package.

- the library builds with ``c++`` from the port's own copy of the sources
  into ``ops/native/.build-<hash>/`` (once, then loaded), and a process that
  runs every ``*-native`` rule of the port maps that library and never the
  JAX package's;
- each ``*-native`` rule's dense ``aggregate`` equals the JAX package's
  ``*-native`` rule (the same C++, float64 accumulation) and the numpy
  oracle within 1e-6, and the port's card tier on the CPU (the rule's
  plain-version path) within rtol/atol 1e-5, with the same NaN pattern;
  torch rows come back as float32 on their device, numpy rows as numpy;
- in the engine the names inherit the card tier's block path, as the JAX
  classes inherit the jnp tier: a ``krum-native`` step equals a ``krum``
  step bit for bit;
- the library's distances equal the oracle's, its thread pool is sized,
  and a missing compiler is a UserException at construction.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch.gars import oracle
from aggregathor_tpu_torch.ops import native
from aggregathor_tpu_torch.utils import UserException

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name -> (oracle, the card-tier rule it extends)
NATIVE = {
    "average-native": (oracle.average, "average"),
    "average-nan-native": (oracle.average_nan, "average-nan"),
    "median-native": (oracle.median, "median"),
    "averaged-median-native": (oracle.averaged_median, "averaged-median"),
    "krum-native": (oracle.krum, "krum"),
    "bulyan-native": (oracle.bulyan, "bulyan"),
}


def _rows(n, d, seed, poisoned):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, d)).astype(np.float32)
    if poisoned:
        g[2] = np.nan              # a dead worker
        g[n - 1, 4::9] = np.inf    # +-inf coordinates
        g[n - 1, 6::9] = -np.inf
        g[0] *= 30.0               # a loud one
    return g


def test_library_builds_into_the_ports_own_directory():
    lib = native.load()
    path = native.library_path()
    assert os.path.exists(path) and os.path.dirname(os.path.dirname(path)) == os.path.dirname(native.__file__)
    assert os.path.basename(os.path.dirname(path)).startswith(".build-")
    assert lib is native.load() and native.num_threads() >= 1
    for name in native.SOURCES:
        with open(os.path.join(os.path.dirname(native.__file__), name), "rb") as mine, \
                open(os.path.join(REPO, "aggregathor_tpu", "ops", "native", name), "rb") as theirs:
            assert mine.read() == theirs.read(), name


def test_the_port_never_loads_the_jax_library():
    script = ("import numpy as np, torch\n"
              "from aggregathor_tpu_torch import gars\n"
              "x = torch.randn(11, 40)\n"
              "for name in %r:\n"
              "    gars.instantiate(name, 11, 2).aggregate(x)\n"
              "print('\\n'.join(sorted({line.split()[-1] for line in open('/proc/self/maps') if '.so' in line})))\n"
              % sorted(NATIVE))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    mapped = proc.stdout.split()
    assert native.library_path() in mapped
    assert not any(os.sep + os.path.join("aggregathor_tpu", "ops", "native") + os.sep in path for path in mapped)
    assert not any("libagtpu_host" in path for path in mapped)


@pytest.mark.parametrize("poisoned", [False, True], ids=["clean", "poisoned"])
@pytest.mark.parametrize("name", sorted(NATIVE))
def test_native_rule_matches_jax_the_oracle_and_the_card_tier(name, poisoned):
    n, f, d = 11, 2, 133
    g = _rows(n, d, len(name), poisoned)
    oracle_fn, card_name = NATIVE[name]
    gar = tgars.instantiate(name, n, f)
    got = gar.aggregate(torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.device.type == "cpu" and got.shape == (d,)
    got = got.numpy()
    want = np.asarray(jgars.instantiate(name, n, f).aggregate(g))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if not poisoned:
        np.testing.assert_allclose(got, oracle_fn(g, f), rtol=1e-6, atol=1e-6)
    card = tgars.instantiate(card_name, n, f).aggregate(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(card))
    finite = np.isfinite(card)
    np.testing.assert_allclose(got[finite], card[finite], rtol=1e-5, atol=1e-5)
    # numpy rows stay numpy (and float64 stays float64), as in JAX
    assert isinstance(gar.aggregate(g), np.ndarray)
    assert gar.aggregate(g.astype(np.float64)).dtype == np.float64


@pytest.mark.parametrize("name", sorted(NATIVE))
def test_native_names_inherit_the_card_tier_in_the_engine(name):
    _, card_name = NATIVE[name]
    native_rule, card_rule = tgars.instantiate(name, 11, 2), tgars.instantiate(card_name, 11, 2)
    assert isinstance(native_rule, type(card_rule))
    assert type(native_rule).aggregate_block is type(card_rule).aggregate_block
    x = torch.from_numpy(_rows(11, 64, 1, True))
    dist2 = torch.clamp_min(torch.cdist(x, x) ** 2, 0.0) if card_rule.needs_distances else None
    a, b = native_rule._call_aggregate(x, dist2), card_rule._call_aggregate(x, dist2)
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_krum_native_step_is_the_krum_step():
    from aggregathor_tpu_torch import models
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine

    finals = []
    for name in ("krum", "krum-native"):
        exp = models.instantiate("mnist", ["hidden:8", "batch-size:4"])
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        engine = RobustEngine(tgars.instantiate(name, 8, 2), 8, device="cpu")
        state = engine.init_state(exp.init(1), tx, seed=1)
        step = engine.build_step(exp.loss, tx)
        it = exp.make_train_iterator(8, seed=2)
        for _ in range(2):
            state, _ = step(state, engine.put_batch(next(it)))
        finals.append(torch.cat([p.detach().reshape(-1) for p in state.params.values()]))
    assert torch.equal(finals[0], finals[1])


def test_distances_and_arguments_match_the_oracle():
    g = _rows(9, 50, 3, False)
    np.testing.assert_allclose(native.pairwise_sq_distances(g), oracle._pairwise_sq_distances(g.astype(np.float64)),
                               rtol=1e-12)
    np.testing.assert_allclose(native.krum(g, 2, m=3), np.mean(g[np.argsort(oracle.krum_scores(g, 2),
                                                                            kind="stable")[:3]], axis=0),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        native.krum(g, 2, m=0)
    with pytest.raises(ValueError):
        native.median(g[0])


def test_a_missing_compiler_refuses_at_construction(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / ".build-x" / "libagg_host.so"))
    monkeypatch.setenv("AGTPU_NATIVE_CXX", "no-such-compiler-here")
    with pytest.raises(UserException, match="requires the native GAR library"):
        tgars.instantiate("krum-native", 8, 2)
    assert not (tmp_path / ".build-x" / "libagg_host.so").exists()
