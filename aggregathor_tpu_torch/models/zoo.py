"""The model zoo: ``slim-<model>-<dataset>`` experiments.

Counterpart of ``aggregathor_tpu/models/zoo.py``: every network of
``MODEL_FACTORY`` (the ResNet v1/v2, VGG, classic, MobileNet, Inception and
NASNet families) crossed with every dataset of ``DATASETS`` (``cifar10``,
``imagenet``, ``digits32``), with JAX's argument surface and defaults:
``batch-size`` (32), ``eval-batch-size`` (64), ``weight-decay``,
``label-smoothing``, ``labels-offset``, ``image-size`` (224, ImageNet),
``dtype`` (float32 | bfloat16 compute), ``aux-weight`` (0.4, the
Inception nets of ``AUX_CAPABLE``), ``preprocessing`` (default by model
name, ``preprocessing.default_for``), ``nb-fetcher-threads``,
``nb-batcher-threads`` and ``augment`` (host | device).

A factory entry takes ``(classes, small, dtype, shape, aux)``: ``shape``
is the images' ``(H, W, C)``, which flax infers at init and torch needs
at construction (the input channels, and the dense widths after a flatten
or NASNet's cell alignment); ``aux`` builds the auxiliary head, so the
parameters match flax's ``init(..., with_aux=True)``.  The loss is the
mean softmax cross-entropy, with labels smoothed as optax's
``smooth_labels``, plus ``aux-weight`` times the aux head's, plus
``weight-decay`` times the squared norm of the rank > 1 leaves (conv and
dense kernels, never norm scales or biases).
"""

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..utils import UserException, parse_keyval
from . import Experiment, register, thread_module
from .classic import AlexNetV2, CifarNet, LeNet, OverFeat
from .datasets import WorkerBatchIterator, eval_batches, load_cifar10, load_digits_upscaled, load_imagenet
from .inception import InceptionResNetV2, InceptionV1, InceptionV2, InceptionV3, InceptionV4
from .mobilenet import MOBILENET_MULTIPLIERS, MOBILENET_V2_MULTIPLIERS, MobileNetV1, MobileNetV2
from .nasnet import NASNET_VARIANTS, NASNet
from .resnet import RESNET_DEPTHS, RESNET_V2_DEPTHS, ResNet
from .vgg import VGG_STAGES, VGG


def _make_factory():
    factory = {}
    for depth in RESNET_DEPTHS:
        factory["resnet_v1_%d" % depth] = (
            lambda classes, small, dtype, shape, aux, depth=depth: ResNet(
                depth, classes, small_inputs=small, channels=shape[2], dtype=dtype))
    for depth in RESNET_V2_DEPTHS:
        factory["resnet_v2_%d" % depth] = (
            lambda classes, small, dtype, shape, aux, depth=depth: ResNet(
                depth, classes, small_inputs=small, preact=True, channels=shape[2], dtype=dtype))
    for variant in VGG_STAGES:
        factory[variant] = (
            lambda classes, small, dtype, shape, aux, variant=variant: VGG(
                variant, classes, dense_units=512 if small else 4096, shape=shape, dtype=dtype))
    for name, cls in (("inception_v1", InceptionV1), ("inception_v3", InceptionV3), ("inception_v4", InceptionV4),
                      ("inception_resnet_v2", InceptionResNetV2)):
        factory[name] = (lambda classes, small, dtype, shape, aux, cls=cls: cls(
            classes, channels=shape[2], dtype=dtype, aux=aux))
    factory["inception_v2"] = lambda classes, small, dtype, shape, aux: InceptionV2(
        classes, channels=shape[2], dtype=dtype)
    for name, mult in MOBILENET_MULTIPLIERS.items():
        factory[name] = (lambda classes, small, dtype, shape, aux, mult=mult: MobileNetV1(
            classes, mult, channels=shape[2], dtype=dtype))
    for name, mult in MOBILENET_V2_MULTIPLIERS.items():
        factory[name] = (lambda classes, small, dtype, shape, aux, mult=mult: MobileNetV2(
            classes, mult, channels=shape[2], dtype=dtype))
    for variant in NASNET_VARIANTS:
        factory[variant] = (lambda classes, small, dtype, shape, aux, variant=variant: NASNet(
            variant, classes, size=shape[0], channels=shape[2], dtype=dtype))
    factory["lenet"] = lambda classes, small, dtype, shape, aux: LeNet(classes, shape=shape, dtype=dtype)
    factory["cifarnet"] = lambda classes, small, dtype, shape, aux: CifarNet(classes, shape=shape, dtype=dtype)
    factory["alexnet_v2"] = lambda classes, small, dtype, shape, aux: AlexNetV2(
        classes, dense_units=512 if small else 4096, channels=shape[2], dtype=dtype)
    factory["overfeat"] = lambda classes, small, dtype, shape, aux: OverFeat(
        classes, dense_units=512 if small else 3072, channels=shape[2], dtype=dtype)
    return factory


MODEL_FACTORY = _make_factory()

#: the nets with an auxiliary training head (v2 has none, as in slim)
AUX_CAPABLE = {"inception_v1", "inception_v3", "inception_v4", "inception_resnet_v2"}

DATASETS = {
    "cifar10": lambda kv: load_cifar10(),
    "imagenet": lambda kv: load_imagenet(image_size=kv["image-size"]),
    # the real digits corpus at 32x32: the zoo's accuracy anchor where
    # CIFAR-10 and ImageNet fall back to synthetic stand-ins
    "digits32": lambda kv: load_digits_upscaled(32),
}


class ZooExperiment(Experiment):
    """One (model, dataset) pair from the factory."""

    model_name = None
    dataset_name = None

    def __init__(self, args):
        super().__init__(args)
        kv = parse_keyval(args, {
            "batch-size": 32,
            "eval-batch-size": 64,
            "weight-decay": 0.0,
            "label-smoothing": 0.0,
            "labels-offset": 0,
            "image-size": 224,
            "dtype": "float32",
            "aux-weight": 0.4,
            "preprocessing": "",
            "nb-fetcher-threads": 0,
            "nb-batcher-threads": 0,
            "augment": "host",
        })
        from .common import check_dtype
        from .preprocessing import check as check_preprocessing, default_for

        self.batch_size = kv["batch-size"]
        self.eval_batch_size = kv["eval-batch-size"]
        self.weight_decay = kv["weight-decay"]
        self.label_smoothing = kv["label-smoothing"]
        self.labels_offset = kv["labels-offset"]
        self.preprocessing = check_preprocessing(kv["preprocessing"] or default_for(self.model_name))
        self.augment = kv["augment"]
        if self.augment not in ("host", "device"):
            raise UserException("augment must be host|device, got %r" % (self.augment,))
        self.aux_weight = kv["aux-weight"] if self.model_name in AUX_CAPABLE else 0.0
        dtype = check_dtype(kv["dtype"])
        self.dataset = DATASETS[self.dataset_name](kv)
        classes = self.dataset.nb_classes - self.labels_offset
        shape = tuple(self.dataset.x_train.shape[1:])
        small = shape[0] <= 64
        self.model = MODEL_FACTORY[self.model_name](classes, small, dtype, shape, self.aux_weight > 0.0)
        self.sample_shape = shape

    def _ce(self, logits, labels):
        if self.label_smoothing > 0.0:
            classes = logits.shape[-1]
            # optax.smooth_labels: (1 - a) one_hot + a / classes
            soft = F.one_hot(labels, classes).to(logits.dtype) * (1.0 - self.label_smoothing)
            soft = soft + self.label_smoothing / classes
            return torch.mean(torch.sum(-soft * F.log_softmax(logits, dim=-1), dim=-1))
        return F.cross_entropy(logits, labels)

    def loss(self, params, batch):
        labels = batch["label"].long() - self.labels_offset
        module = thread_module(self.model)
        if self.aux_weight > 0.0:
            logits, aux_logits = functional_call(module, params, (batch["image"],), {"with_aux": True})
            loss = self._ce(logits, labels) + self.aux_weight * self._ce(aux_logits, labels)
        else:
            loss = self._ce(functional_call(module, params, (batch["image"],)), labels)
        if self.weight_decay > 0.0:
            loss = loss + self.weight_decay * sum(
                torch.sum(p.to(torch.float32) ** 2) for p in params.values() if p.dim() > 1)
        return loss

    def metrics(self, params, batch):
        labels = batch["label"].long() - self.labels_offset
        hit = (torch.argmax(self.logits(params, batch["image"]), dim=-1) == labels).to(torch.float32)
        valid = batch.get("valid")
        if valid is not None:
            valid = valid.to(torch.float32)
            return {"accuracy": (torch.sum(hit * valid), torch.sum(valid))}
        return {"accuracy": (torch.sum(hit), torch.full((), float(hit.shape[0]), device=hit.device))}

    def make_train_iterator(self, nb_workers, seed=0):
        from .preprocessing import instantiate as make_preprocessing

        return WorkerBatchIterator(
            self.dataset.x_train, self.dataset.y_train, nb_workers, self.batch_size, seed=seed,
            transform=(None if self.augment == "device" else make_preprocessing(self.preprocessing, seed=seed)),
        )

    def make_eval_iterator(self, nb_workers):
        return eval_batches(self.dataset.x_test, self.dataset.y_test, nb_workers, self.eval_batch_size)


def _register_all():
    for model_name in MODEL_FACTORY:
        for dataset_name in DATASETS:
            cls = type("Zoo_%s_%s" % (model_name, dataset_name), (ZooExperiment,),
                       {"model_name": model_name, "dataset_name": dataset_name})
            register("slim-%s-%s" % (model_name, dataset_name), cls)


_register_all()
