"""Observability of the training loop: the evaluation TSV (``evalfile``),
cadence triggers (``cadence``), checkpoints (``checkpoint``), JSONL scalar
summaries (``summaries``), the performance report (``perf``), the flight
recorder (``flight``), the metrics registry with its Prometheus exposition
(``metrics``), the span tracer (``trace``), the live exporter (``live``)
and the causal run journal (``events``)."""

from . import events  # noqa: F401
