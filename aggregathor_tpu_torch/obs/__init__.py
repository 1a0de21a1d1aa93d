"""Observability of the main path: the evaluation TSV (``evalfile``)."""
