#!/usr/bin/env bash
# The port's static-analysis gate: graftcheck over aggregathor_tpu_torch/
# (retrace, prng, concurrency, gar-contract, events) with a machine-readable
# report, the counterpart of scripts/run_analysis.sh (which checks the JAX
# package and stays as it is).
#
#   scripts/run_torch_analysis.sh            # run everything, report, exit status
#   scripts/run_torch_analysis.sh --check    # explicit gate mode (same exit contract)
#   DEVICE=cuda scripts/run_torch_analysis.sh   # the GAR sweep on the card
#   REPORT=path.json scripts/run_torch_analysis.sh   # choose the report path
#
# The GAR contract sweep runs on the CPU here by default (--device cpu,
# the kernels' plain versions), as scripts/run_analysis.sh exports
# JAX_PLATFORMS=cpu; the CLI's own default is the card, which raises on a
# machine without a GPU.  Exit nonzero on any unbaselined finding, any stale
# or unjustified baseline entry (aggregathor_tpu_torch/analysis/baseline.json).

set -euo pipefail
cd "$(dirname "$0")/.."

REPORT="${REPORT:-$(mktemp "${TMPDIR:-/tmp}/graftcheck_torch_report.XXXXXX.json")}"
DEVICE="${DEVICE:-cpu}"

echo "== graftcheck (port): retrace + prng + concurrency + gar-contract + events, sweep on ${DEVICE} =="
python -m aggregathor_tpu_torch.analysis --device "$DEVICE" --check --json "$REPORT" "$@"

echo "== report schema round-trip (aggregathor.analysis.report.v1) =="
python - "$REPORT" <<'PYEOF'
import json, sys

from aggregathor_tpu_torch.analysis.report import validate_report

doc = validate_report(json.load(open(sys.argv[1])))
print("report ok: %s -- %d finding(s), clean=%s, root %s -> %s"
      % (doc["schema"], doc["counts"]["total"], doc["clean"], doc["root"], sys.argv[1]))
PYEOF
