"""Digits experiments: the real-data accuracy anchor.

Counterpart of ``aggregathor_tpu/models/digits.py``.  ``digits`` is the
MNIST experiment's MLP (64-100-10, d = 7,510) on the real UCI hand-written
digits (``datasets.load_digits8x8``); ``digits-conv`` is cnnet's conv stack
on the same corpus upscaled to 32x32x1 (d = 1,753,482).  Loss, metrics and
iterators are the MNIST experiment's: only the corpus, the input shape and,
for ``digits-conv``, the model differ.
"""

from . import register
from .datasets import load_digits8x8, load_digits_upscaled
from .mnist import MNISTExperiment


class DigitsExperiment(MNISTExperiment):
    sample_shape = (8, 8, 1)
    load_dataset = staticmethod(load_digits8x8)


class DigitsConvExperiment(DigitsExperiment):
    """cnnet (two conv5x5-64 + 3x3/2 max-pool stages, dense 384/192) on
    the digits upscaled to 32x32x1."""

    sample_shape = (32, 32, 1)
    load_dataset = staticmethod(load_digits_upscaled)

    def __init__(self, args):
        super().__init__(args)
        from .cnnet import CNNet

        self.model = CNNet(classes=self.dataset.nb_classes, channels=self.sample_shape[-1])


register("digits", DigitsExperiment)
register("digits-conv", DigitsConvExperiment)
