"""Observability of the training loop: the evaluation TSV (``evalfile``),
cadence triggers (``cadence``), checkpoints (``checkpoint``), JSONL scalar
summaries (``summaries``) and the performance report (``perf``)."""
