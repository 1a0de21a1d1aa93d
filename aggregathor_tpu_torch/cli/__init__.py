"""Command-line entry points: the training runner (``python -m aggregathor_tpu_torch.cli.runner``)."""
