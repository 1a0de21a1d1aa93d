"""Observability of the training loop: the evaluation TSV (``evalfile``),
cadence triggers (``cadence``), checkpoints (``checkpoint``), JSONL scalar
summaries (``summaries``), the performance report (``perf``), the flight
recorder (``flight``), the metrics registry with its Prometheus exposition
(``metrics``), the span tracer (``trace``), the live exporter (``live``),
the causal run journal (``events``), the fleet collector (``fleet``) and
the journals' causal merge (``causal``)."""

from . import events  # noqa: F401
