"""The port's resilience campaign (``chaos/campaign.py``) against the JAX package's.

- The JAX micro matrix (``tests/test_chaos.py:482-512``): mnist, average and
  median x calm and ``empire,epsilon=4.0``, 25 steps, through
  ``campaign.main`` on the CPU; the schema and ``CELL_KEYS`` are JAX's, and
  from the JAX weights (injected into ``MNISTExperiment.init``) the port's
  four verdicts equal the JAX campaign's, the losses within rtol 1e-4.
  ``compile_count`` is 0 on the CPU (no kernel builds).
- ``--guardian --forensics`` cells (average, calm and a late inf coalition)
  roll back, escalate and end as the JAX campaign's cells do, with the same
  attribution; a ``--breakdown`` probe; the refusals of ambiguous grids, as
  JAX's.
"""

import json

import jax
import numpy as np
import pytest

from aggregathor_tpu import models as jmodels
from aggregathor_tpu.chaos import campaign as jcampaign
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch.chaos import campaign
from aggregathor_tpu_torch.models import mnist
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.utils import UserException

GRID = ["--experiment", "mnist", "--experiment-args", "batch-size:16", "--nb-workers", "8",
        "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2"]


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's mnist experiment starts from the JAX package's weights."""
    jexp = jmodels.instantiate("mnist", ["batch-size:16"])
    monkeypatch.setattr(mnist.MNISTExperiment, "init", lambda self, seed: params_from_jax(
        jax.tree_util.tree_map(np.asarray, jexp.init(jax.random.PRNGKey(seed)))))


def test_micro_matrix_verdicts_equal_the_jax_campaign(tmp_path, jax_weights):
    argv = GRID + ["--gars", "average", "median", "--attacks", "empire,epsilon=4.0", "--nb-steps", "25"]
    assert 0 == campaign.main(argv + ["--device", "cpu", "--output", str(tmp_path / "m.json"),
                                      "--report", str(tmp_path / "r.md")])
    assert 0 == jcampaign.main(argv + ["--output", str(tmp_path / "j.json")])
    matrix, jmatrix = json.load(open(tmp_path / "m.json")), json.load(open(tmp_path / "j.json"))
    assert campaign.SCHEMA == jcampaign.SCHEMA == matrix["schema"] and campaign.CELL_KEYS == jcampaign.CELL_KEYS
    assert len(matrix["cells"]) == 4
    assert set(matrix) == set(jmatrix)
    for mine, theirs in zip(matrix["cells"], jmatrix["cells"]):
        assert set(mine) == set(theirs) and set(campaign.CELL_KEYS) <= set(mine)
        for key in ("gar", "scenario", "schedule", "nb_real_byz", "declared_byz", "converged", "diverged"):
            assert mine[key] == theirs[key], (key, mine["gar"], mine["scenario"])
        np.testing.assert_allclose(mine["losses"], theirs["losses"], rtol=1e-4)
        assert mine["compile_count"] == 0
    by = {(c["gar"], c["scenario"]): c for c in matrix["cells"]}
    assert by[("average", "calm")]["converged"] and by[("median", "calm")]["converged"]
    assert by[("median", "empire")]["converged"] and not by[("average", "empire")]["converged"]
    assert by[("average", "calm")]["nb_real_byz"] == 0 and by[("median", "empire")]["nb_real_byz"] == 2
    text = open(tmp_path / "r.md").read()
    assert text == jcampaign.render_report(matrix) == campaign.render_report(matrix)
    assert "| GAR |" in text and "median" in text and "empire" in text


def test_guardian_forensics_cells_and_breakdown_follow_jax(jax_weights):
    argv = GRID + ["--gars", "average", "--schedules", "late=0:calm 6:attack=inf", "--nb-steps", "12",
                   "--guardian", "--guardian-args", "recover:3", "--forensics"]
    matrix = campaign.run_campaign(campaign.build_parser().parse_args(argv + ["--device", "cpu"]))
    jmatrix = jcampaign.run_campaign(jcampaign.build_parser().parse_args(argv))
    for mine, theirs in zip(matrix["cells"], jmatrix["cells"]):
        for key in ("scenario", "guardian", "rollbacks", "escalations", "recovered", "converged", "diverged"):
            assert mine[key] == theirs[key], (key, mine["scenario"])
        for key in ("suspects", "expected", "attack_steps", "attribution_correct"):
            assert mine["forensics"][key] == theirs["forensics"][key], (key, mine["scenario"])
        assert len(mine["losses"]) == len(theirs["losses"])
    late = matrix["cells"][1]
    assert late["rollbacks"] >= 1 and late["escalations"][:2] == ["f+1", "gar=median"]
    assert late["forensics"]["expected"] == [0, 1] and late["forensics"]["attack_steps"] == [7, 12]
    probe = campaign.run_campaign(campaign.build_parser().parse_args(GRID + [
        "--gars", "average", "median", "--attacks", "signflip,scale=4.0", "--nb-steps", "8", "--breakdown",
        "--device", "cpu"]))
    (entry,) = probe["breakdown"]
    assert entry["gar"] == "median" and entry["r_within"] == 2 and entry["r_beyond"] == 5
    assert "within_converged" in entry and "beyond_converged" in entry and "bound_holds" in entry


@pytest.mark.parametrize("argv", [
    ["--gars", "median", "--nb-steps", "1", "--attacks", "empire", "--schedules", "empire=0:attack=little"],
    ["--gars", "median", "--nb-steps", "1", "--breakdown", "--schedules", "storm=0:drop=0.3"],
    ["--gars", "median", "--nb-steps", "1", "--schedules", "nospec"],
    ["--gars", "median", "--nb-steps", "1", "--nb-real-byz-workers", "9"],
], ids=["duplicate", "breakdown-no-attack", "bad-schedule", "too-many"])
def test_campaign_refuses_ambiguous_grids_like_jax(argv):
    with pytest.raises(UserException):
        campaign.main(argv + ["--device", "cpu"])
    with pytest.raises(JaxUserException):
        jcampaign.main(argv)
