"""CIFAR-10 CNN experiment.

Counterpart of ``aggregathor_tpu/models/cnnet.py`` at its published width:
two conv5x5-64 + 3x3/2 max-pool stages with GroupNorm(8), dense 384, dense
192, linear 10 (d = 1,756,682).  Default batch 128, mean softmax CE loss,
top-1 accuracy on the eval split.  The layer-by-layer match with flax:

- inputs arrive NHWC (the JAX layout) and are permuted to NCHW inside;
- flax ``max_pool(padding="SAME")`` 3x3/2 pads 0 before and 1 after with
  -inf (32 -> 16 -> 8), so the pool pads explicitly instead of torch's
  symmetric padding;
- flax ``GroupNorm`` has eps 1e-6 (torch's default is 1e-5);
- the features are flattened in NHWC order before ``dense1``, so its rows
  line up with the flax kernel's;
- on CUDA the convolutions take their weight gradient in float64
  (``conv_weight_grad``): cuDNN's float32 weight gradient at the 64 -> 64
  5x5 layer errs by up to ~2e-2 of its largest entry on the H100 with TF32
  off (``chip_smoke.py``'s vmap phase prints it).

``dtype:bfloat16`` computes the conv and dense stack in bfloat16 as flax
does with ``dtype=bfloat16``: inputs, kernels and biases cast to bfloat16,
each GroupNorm's statistics and normalization in float32 with a bfloat16
result; the parameters stay float32 and the logits layer runs in float32.
On CUDA that path takes cuDNN's bfloat16 convolutions (the float64 weight
gradient is the float32 path's).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import UserException, parse_keyval
from . import Experiment, register
from .common import ConvF64WeightGrad, check_dtype, conv_weight_grad_f64, max_pool
from .datasets import WorkerBatchIterator, eval_batches, load_cifar10


def max_pool_same(x):
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding="SAME")`` on NCHW
    input: on even sizes pad 0 before, 1 after, with -inf."""
    return max_pool(x, 3, 2, "SAME")


def conv_weight_grad(x, grad_out, weight):
    """The weight gradient of a stride-1 convolution with ``weight``'s
    square kernel and "same" padding, computed in float64 from the float32
    operands and rounded to float32."""
    padding = weight.shape[-1] // 2
    return conv_weight_grad_f64(x, grad_out, weight, (1, 1), (padding, padding))


def conv2d(x, conv):
    """``conv`` (a stride-1 ``nn.Conv2d`` whose parameters ``functional_call``
    may have swapped) on ``x``: on CUDA with its weight gradient in float64
    (``common.ConvF64WeightGrad``, whose float64 gradient is
    ``conv_weight_grad``'s)."""
    if x.device.type == "cuda":
        return ConvF64WeightGrad.apply(x, conv.weight, conv.bias, (1, 1), conv.padding, 1)
    return conv(x)


class CNNet(nn.Module):
    """``channels``: the input's channels, which flax infers from the first
    input (3 for CIFAR-10, 1 for ``digits-conv``); ``dtype``: the compute
    dtype of the conv and dense stack."""

    def __init__(self, classes=10, channels=3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(channels, 64, 5, padding=2)
        self.norm1 = nn.GroupNorm(8, 64, eps=1e-6)
        self.conv2 = nn.Conv2d(64, 64, 5, padding=2)
        self.norm2 = nn.GroupNorm(8, 64, eps=1e-6)
        self.dense1 = nn.Linear(8 * 8 * 64, 384)
        self.dense2 = nn.Linear(384, 192)
        self.logits = nn.Linear(192, classes)

    def _conv(self, x, conv):
        if self.dtype == torch.float32:
            return conv2d(x, conv)
        return F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype), padding=conv.padding)

    def _norm(self, x, norm):
        if self.dtype == torch.float32:
            return norm(x)
        return F.group_norm(x.to(torch.float32), norm.num_groups, norm.weight, norm.bias, norm.eps).to(self.dtype)

    def _dense(self, x, dense):
        if self.dtype == torch.float32:
            return dense(x)
        return F.linear(x, dense.weight.to(self.dtype), dense.bias.to(self.dtype))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        if self.dtype != torch.float32:
            x = x.to(self.dtype)
        x = max_pool_same(F.relu(self._conv(x, self.conv1)))
        x = self._norm(x, self.norm1)
        x = self._norm(F.relu(self._conv(x, self.conv2)), self.norm2)
        x = max_pool_same(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
        x = F.relu(self._dense(x, self.dense1))
        x = F.relu(self._dense(x, self.dense2))
        if self.dtype != torch.float32:
            x = x.to(torch.float32)  # logits in float32: the softmax cross-entropy is touchy in bfloat16
        return self.logits(x)


class CNNetExperiment(Experiment):
    #: one image's shape, which serving validates requests against (the JAX
    #: experiment has none, so its serving engine cannot take cnnet)
    sample_shape = (32, 32, 3)

    def __init__(self, args):
        super().__init__(args)
        kv = parse_keyval(args, {
            "batch-size": 128,
            "eval-batch-size": 256,
            "preprocessing": "cifarnet",
            # the same arg surface as the JAX experiment
            "augment": "host",
            "dtype": "float32",
            "nb-fetcher-threads": 0,
            "nb-batcher-threads": 0,
        })
        from .preprocessing import check as check_preprocessing

        if kv["augment"] not in ("host", "device"):
            raise UserException("augment must be host|device, got %r" % kv["augment"])
        dtype = check_dtype(kv["dtype"])
        self.batch_size = kv["batch-size"]
        self.eval_batch_size = kv["eval-batch-size"]
        self.preprocessing = check_preprocessing(kv["preprocessing"])
        self.augment = kv["augment"]
        self.dataset = load_cifar10()
        self.model = CNNet(classes=self.dataset.nb_classes, dtype=dtype)

    def make_train_iterator(self, nb_workers, seed=0):
        from .preprocessing import instantiate as make_preprocessing

        return WorkerBatchIterator(
            self.dataset.x_train, self.dataset.y_train, nb_workers, self.batch_size, seed=seed,
            transform=(None if self.augment == "device"
                       else make_preprocessing(self.preprocessing, seed=seed)),
        )

    # device_transform / train_arrays: the Experiment defaults, keyed off
    # self.augment, self.preprocessing and self.dataset

    def make_eval_iterator(self, nb_workers):
        return eval_batches(self.dataset.x_test, self.dataset.y_test, nb_workers, self.eval_batch_size)


register("cnnet", CNNetExperiment)
