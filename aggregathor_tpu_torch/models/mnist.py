"""MNIST MLP experiment: 784-100-10 dense ReLU classifier.

Counterpart of ``aggregathor_tpu/models/mnist.py``: one hidden layer of 100
ReLU units (``hidden:<k>`` narrows it), mean softmax CE loss, top-1 accuracy
and cross-entropy on the test split, default batch 32.  Subclasses swap the
corpus through the same hooks as the JAX experiment: ``sample_shape`` (one
image, NHWC, which also sets the MLP's input width) and ``load_dataset``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import parse_keyval
from . import Experiment, register
from .datasets import WorkerBatchIterator, eval_batches, load_mnist


class MLP(nn.Module):
    def __init__(self, inputs=784, hidden=100, classes=10):
        super().__init__()
        self.hidden = nn.Linear(inputs, hidden)
        self.logits = nn.Linear(hidden, classes)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.logits(F.relu(self.hidden(x)))


class MNISTExperiment(Experiment):
    sample_shape = (28, 28, 1)
    load_dataset = staticmethod(load_mnist)

    def __init__(self, args):
        super().__init__(args)
        kv = parse_keyval(args, {"batch-size": 32, "eval-batch-size": 256, "hidden": 100})
        self.batch_size = kv["batch-size"]
        self.eval_batch_size = kv["eval-batch-size"]
        self.model = MLP(inputs=math.prod(self.sample_shape), hidden=kv["hidden"])
        self.dataset = self.load_dataset()

    def metrics(self, params, batch):
        out = super().metrics(params, batch)
        logits = self.logits(params, batch["image"])
        xent = F.cross_entropy(logits, batch["label"].long(), reduction="none")
        valid = batch.get("valid")
        if valid is not None:
            xent = xent * valid.to(torch.float32)
        out["cross-entropy"] = (torch.sum(xent), out["accuracy"][1])
        return out

    def make_train_iterator(self, nb_workers, seed=0):
        return WorkerBatchIterator(
            self.dataset.x_train, self.dataset.y_train, nb_workers, self.batch_size, seed=seed
        )

    def make_eval_iterator(self, nb_workers):
        return eval_batches(self.dataset.x_test, self.dataset.y_test, nb_workers, self.eval_batch_size)

    def train_arrays(self):
        # a transform-free iterator: a uniform row gather is the same stream
        return {"image": self.dataset.x_train, "label": self.dataset.y_train}


register("mnist", MNISTExperiment)
