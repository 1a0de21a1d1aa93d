"""Data-poisoning experiments: ``mnistAttack`` and ``digitsAttack``.

Counterpart of ``aggregathor_tpu/models/mnist_attack.py``: the training
stream is malformed (severity 1 multiplies the inputs by -100; severity 2,
the default, multiplies them by -1e12 and permutes inputs and labels
independently, breaking their correspondence), while evaluation stays
clean, so accuracy measures what the poisoned workers did to the model.
The poison is a numpy transform of the batch; severity 2's generator is
keyed off the batch's own labels, so it is stateless and resume skips it.
"""

import numpy as np

from ..utils import parse_keyval
from . import register
from .datasets import WorkerBatchIterator, load_digits8x8
from .mnist import MNISTExperiment


class MNISTAttackExperiment(MNISTExperiment):
    def __init__(self, args):
        super().__init__(args)
        self.severity = parse_keyval(args, {"severity": 2})["severity"]

    def _poison(self, images, labels):
        if self.severity <= 1:
            return images * np.float32(-100.0), labels
        flat_img = images.reshape(-1, *images.shape[2:])
        flat_lab = labels.reshape(-1)
        rng = np.random.default_rng(int(flat_lab.sum()) % (2**31))
        img_perm = rng.permutation(flat_img.shape[0])
        lab_perm = rng.permutation(flat_lab.shape[0])
        poisoned = (flat_img[img_perm] * np.float32(-1e12)).reshape(images.shape)
        shuffled = flat_lab[lab_perm].reshape(labels.shape)
        return poisoned, shuffled

    def make_train_iterator(self, nb_workers, seed=0):
        from .preprocessing import stateless

        return WorkerBatchIterator(
            self.dataset.x_train, self.dataset.y_train, nb_workers, self.batch_size,
            seed=seed, transform=stateless(lambda bx, by: self._poison(bx, by)),
        )

    def train_arrays(self):
        # the poisoning is a host batch transform: a plain device-side row
        # gather would train on clean data
        return None


register("mnistAttack", MNISTAttackExperiment)


class DigitsAttackExperiment(MNISTAttackExperiment):
    """The same poisoned stream over the real digits."""

    sample_shape = (8, 8, 1)
    load_dataset = staticmethod(load_digits8x8)


register("digitsAttack", DigitsAttackExperiment)
