"""The port's model zoo (``models/zoo.py``) against the JAX package's.

- the registry: the port's experiment names are JAX's, all 109 (the gap
  test holds the empty gap);
- the factory's 34 names, ``AUX_CAPABLE``, ``DATASETS`` and each name's
  preprocessing default (``preprocessing.default_for``) equal JAX's;
- the ``dtype``, ``preprocessing`` and ``augment`` refusals are JAX's;
- the loss pieces (label smoothing, weight decay over the rank > 1 leaves,
  ``labels-offset``) on lenet and cifarnet, and the aux head's loss on
  inception_v1, equal JAX's ``ZooExperiment.loss`` from the same weights
  and batch within rtol 1e-5 (float32 convolutions summed in another
  order); ``metrics`` honours ``valid`` as JAX's does;
- ``load_imagenet_standin`` and ``load_imagenet`` without shards are
  bit-identical to JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from aggregathor_tpu import models as jmodels
from aggregathor_tpu.models import datasets as jdatasets
from aggregathor_tpu.models import preprocessing as jpreprocessing
from aggregathor_tpu.models import zoo as jzoo
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.models import datasets as tdatasets
from aggregathor_tpu_torch.models import preprocessing as tpreprocessing
from aggregathor_tpu_torch.models import zoo
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.utils import UserException

#: the JAX experiments the port does not register: none since the
#: transformer (ROADMAP queue 1, item 8b) came across
EXPERIMENT_GAP = set()


def test_the_experiment_gap_is_the_known_list():
    ours, theirs = set(tmodels.itemize()), set(jmodels.itemize())
    assert theirs - ours == EXPERIMENT_GAP
    assert ours - theirs == set()
    assert sum(name.startswith("slim-") for name in ours) == 102
    assert len(ours) == 109


def test_factory_datasets_aux_and_preprocessing_defaults_match_jax():
    assert sorted(zoo.MODEL_FACTORY) == sorted(jzoo.MODEL_FACTORY) and len(zoo.MODEL_FACTORY) == 34
    assert zoo.AUX_CAPABLE == jzoo.AUX_CAPABLE
    assert sorted(zoo.DATASETS) == sorted(jzoo.DATASETS) == ["cifar10", "digits32", "imagenet"]
    for name in zoo.MODEL_FACTORY:
        assert tpreprocessing.default_for(name) == jpreprocessing.default_for(name), name
        jexp = jmodels.get("slim-%s-digits32" % name)
        assert (jexp.model_name, jexp.dataset_name) == (name, "digits32")


@pytest.mark.parametrize("args", [["dtype:bf16"], ["dtype:int32"], ["preprocessing:nope"], ["augment:card"],
                                  ["batch-size:x"]], ids=["bf16", "int32", "preprocessing", "augment", "batch"])
def test_refusals_match_jax(args):
    with pytest.raises(JaxUserException):
        jmodels.instantiate("slim-lenet-digits32", args)
    with pytest.raises(UserException):
        tmodels.instantiate("slim-lenet-digits32", args)


def test_defaults_and_surface_match_jax():
    jexp, texp = jmodels.instantiate("slim-cifarnet-digits32", []), tmodels.instantiate("slim-cifarnet-digits32", [])
    for attr in ("batch_size", "eval_batch_size", "weight_decay", "label_smoothing", "labels_offset",
                 "preprocessing", "augment", "aux_weight"):
        assert getattr(texp, attr) == getattr(jexp, attr), attr
    assert tuple(texp.sample_shape) == tuple(jexp.sample_shape) == (32, 32, 1)
    assert tmodels.instantiate("slim-inception_v3-digits32", ["aux-weight:0.2"]).aux_weight == 0.2
    assert tmodels.instantiate("slim-vgg_a-digits32", ["aux-weight:0.2"]).aux_weight == 0.0


def _pair(name, args):
    jexp = jmodels.instantiate("slim-%s-digits32" % name, args)
    texp = tmodels.instantiate("slim-%s-digits32" % name, args)
    jparams = jexp.init(jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    batch = jax.tree_util.tree_map(lambda x: x[0], next(jexp.make_train_iterator(1, seed=3)))
    return jexp, texp, jparams, tparams, batch


def _torch_batch(batch):
    return {key: torch.from_numpy(np.asarray(value)) for key, value in batch.items()}


LOSS_ARGS = [["label-smoothing:0.1"], ["weight-decay:0.001"], ["labels-offset:1"],
             ["label-smoothing:0.2", "weight-decay:0.0005", "labels-offset:1"]]


@pytest.mark.parametrize("name", ["lenet", "cifarnet"])
@pytest.mark.parametrize("args", LOSS_ARGS, ids=["smoothing", "decay", "offset", "all"])
def test_loss_pieces_match_jax(name, args):
    jexp, texp, jparams, tparams, batch = _pair(name, ["batch-size:4", "preprocessing:none"] + args)
    if texp.labels_offset:
        batch = dict(batch, label=np.maximum(batch["label"], texp.labels_offset))
    want = float(jexp.loss(jparams, batch))
    got = float(texp.loss(tparams, _torch_batch(batch)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if texp.labels_offset == 0:  # the piece moves the loss
        plain = tmodels.instantiate("slim-%s-digits32" % name, ["batch-size:4"])
        assert got != float(plain.loss(tparams, _torch_batch(batch)))


def test_weight_decay_covers_the_rank_two_and_four_leaves_only():
    texp = tmodels.instantiate("slim-cifarnet-digits32", ["weight-decay:1.0"])
    params = texp.init(0)
    kernels = sum(float(torch.sum(p ** 2)) for p in params.values() if p.dim() > 1)
    batch = {"image": torch.zeros((2, 32, 32, 1)), "label": torch.zeros(2, dtype=torch.int32)}
    plain = tmodels.instantiate("slim-cifarnet-digits32", [])
    np.testing.assert_allclose(float(texp.loss(params, batch)) - float(plain.loss(params, batch)), kernels, rtol=1e-5)
    assert any(p.dim() == 1 for p in params.values())  # norm scales and biases exist and are left out


def test_aux_loss_matches_jax():
    jexp, texp, jparams, tparams, batch = _pair("inception_v1", ["batch-size:1", "preprocessing:none",
                                                                 "aux-weight:0.4"])
    assert any(name.startswith("aux_logits.") for name in tparams)
    want = float(jexp.loss(jparams, batch))
    got = float(texp.loss(tparams, _torch_batch(batch)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    logits = texp.logits(tparams, torch.from_numpy(np.asarray(batch["image"])))
    plain = float(torch.nn.functional.cross_entropy(logits, torch.from_numpy(np.asarray(batch["label"])).long()))
    assert got > plain  # the aux head adds 0.4 of its cross-entropy


def test_metrics_honour_valid_like_jax():
    jexp, texp, jparams, tparams, batch = _pair("lenet", ["batch-size:4", "preprocessing:none"])
    valid = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    for extra in ({}, {"valid": valid}):
        want = jexp.metrics(jparams, dict(batch, **extra))["accuracy"]
        got = texp.metrics(tparams, _torch_batch(dict(batch, **extra)))["accuracy"]
        assert [float(v) for v in got] == [float(v) for v in want]


def test_imagenet_standin_is_bit_identical_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("AGGREGATHOR_DATA", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    for load in (lambda m: m.load_imagenet_standin(image_size=32, nb_classes=1000),
                 lambda m: m.load_imagenet(image_size=24, nb_classes=10)):
        jdata, tdata = load(jdatasets), load(tdatasets)
        assert jdata.synthetic and tdata.synthetic and jdata.nb_classes == tdata.nb_classes
        for split in ("x_train", "y_train", "x_test", "y_test"):
            a, b = getattr(jdata, split), getattr(tdata, split)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), split
    assert tdata.x_train.shape == (512, 24, 24, 3)
