"""Observability of the training loop: the evaluation TSV (``evalfile``),
cadence triggers (``cadence``), checkpoints (``checkpoint``), JSONL scalar
summaries (``summaries``), the performance report (``perf``), the flight
recorder (``flight``), the metrics registry with its Prometheus exposition
(``metrics``), the span tracer (``trace``) and the live exporter
(``live``)."""
