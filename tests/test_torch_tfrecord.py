"""The port's TFRecord reader (``models/tfrecord.py``, ``ops/native/io.cpp``)
and shard loaders against the JAX package's.

- crc32c's known vectors, in Python and in the native library;
- the framing: files written by each package are byte-identical and read by
  the other; ``tf.Example`` build and parse;
- the CIFAR-10 (PNG) and ImageNet (JPEG) shard round trips, and a flipped
  byte refused by both walkers;
- the native scanner's index against the Python walker's records;
- ``load_cifar10`` and ``load_imagenet`` on shards under
  ``AGGREGATHOR_DATA`` give JAX's arrays bit for bit and cache them under
  JAX's names; a machine without PIL refuses a shard read by name.
"""

import os
import sys

import numpy as np
import pytest

from aggregathor_tpu.models import datasets as jdatasets
from aggregathor_tpu.models import tfrecord as jtfrecord
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch.models import datasets as tdatasets
from aggregathor_tpu_torch.models import tfrecord
from aggregathor_tpu_torch.ops import native
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

#: (data, CRC32C): RFC 3720's check vectors and the common "123456789"
CRC_VECTORS = [(b"", 0), (b"123456789", 0xE3069283), (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
               (bytes(range(32)), 0x46DD794E), (bytes(range(31, -1, -1)), 0x113FDB5C)]


@pytest.mark.parametrize("data, want", CRC_VECTORS)
def test_crc32c_known_vectors(data, want):
    assert tfrecord.crc32c(data) == want == jtfrecord.crc32c(data)
    assert native.crc32c(data) == want


def _payloads():
    rng = np.random.default_rng(0)
    return [b"", b"x", bytes(rng.integers(0, 256, size=5000, dtype=np.uint8))] + [
        bytes(rng.integers(0, 256, size=int(n), dtype=np.uint8)) for n in rng.integers(1, 300, size=20)]


def test_framing_is_shared_both_ways(tmp_path):
    payloads = _payloads()
    ours, theirs = str(tmp_path / "ours.tfrecord"), str(tmp_path / "theirs.tfrecord")
    tfrecord.write_tfrecords(ours, payloads)
    jtfrecord.write_tfrecords(theirs, payloads)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert list(tfrecord.iter_tfrecords(theirs)) == payloads == list(jtfrecord.iter_tfrecords(ours))


def test_example_build_and_parse_match_jax():
    features = {"image/encoded": b"\x89PNG...", "image/format": b"png", "image/class/label": 7,
                "image/height": 32, "image/width": 32, "ids": [3, 300, 70000]}
    built = tfrecord.build_example(features)
    assert built == jtfrecord.build_example(features)
    parsed, jparsed = tfrecord.parse_example(built), jtfrecord.parse_example(built)
    assert parsed == jparsed
    assert parsed["image/class/label"] == [7] and parsed["image/encoded"] == [b"\x89PNG..."]
    assert parsed["ids"] == [3, 300, 70000]


def test_native_index_matches_the_python_walker(tmp_path, monkeypatch):
    payloads = _payloads()
    path = str(tmp_path / "shard.tfrecord")
    tfrecord.write_tfrecords(path, payloads)
    buf = open(path, "rb").read()
    offsets, lengths = native.tfrecord_index(buf)
    assert [buf[o:o + n] for o, n in zip(offsets, lengths)] == payloads
    monkeypatch.setattr(native, "available", lambda: False)  # the Python walker
    assert list(tfrecord.iter_tfrecords(path)) == payloads


def _images(n, size, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8), rng.integers(0, 10, size=n).astype(np.int32)


@pytest.mark.parametrize("walker", ["native", "python"])
def test_corruption_is_refused(tmp_path, monkeypatch, walker):
    if walker == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    images, labels = _images(4, 8, 1)
    path = tfrecord.write_cifar10_split(str(tmp_path), "train", images, labels)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x40
    open(path, "wb").write(bytes(data))
    with pytest.raises(UserException):
        list(tfrecord.iter_tfrecords(path))
    with pytest.raises(JaxUserException):
        list(jtfrecord.iter_tfrecords(path))


def test_cifar10_and_imagenet_shards_round_trip_across_packages(tmp_path):
    images, labels = _images(6, 32, 2)
    tfrecord.write_cifar10_split(str(tmp_path / "c"), "train", images, labels)
    jtfrecord.write_cifar10_split(str(tmp_path / "j"), "train", images, labels)
    for directory in ("c", "j"):
        for reader in (tfrecord, jtfrecord):
            x, y = reader.read_cifar10_split(str(tmp_path / directory), "train")
            assert np.array_equal(x, images) and np.array_equal(y, labels)
    tfrecord.write_imagenet_split(str(tmp_path / "i"), "train", images, labels + 1, nb_shards=2)
    assert tfrecord.imagenet_shards(str(tmp_path / "i"), "train") == jtfrecord.imagenet_shards(
        str(tmp_path / "i"), "train")
    x, y = tfrecord.read_imagenet_split(str(tmp_path / "i"), "train", 24, limit=5)
    jx, jy = jtfrecord.read_imagenet_split(str(tmp_path / "i"), "train", 24, limit=5)
    assert x.shape == (5, 24, 24, 3) and np.array_equal(x, jx) and np.array_equal(y, jy)


def _shards(root):
    images, labels = _images(12, 32, 3)
    tfrecord.write_cifar10_split(os.path.join(root, "cifar10"), "train", images[:8], labels[:8])
    tfrecord.write_cifar10_split(os.path.join(root, "cifar10"), "test", images[8:], labels[8:])
    for split, part in (("train", slice(0, 8)), ("validation", slice(8, 12))):
        tfrecord.write_imagenet_split(os.path.join(root, "imagenet"), split, images[part], labels[part] + 1)


def _same(a, b):
    assert a.synthetic == b.synthetic is False and a.nb_classes == b.nb_classes
    for split in ("x_train", "y_train", "x_test", "y_test"):
        x, y = getattr(a, split), getattr(b, split)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), split


def test_loaders_read_shards_like_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for package in ("jax", "port"):
        _shards(str(tmp_path / package))
    loads = {"cifar10": lambda m: m.load_cifar10(),
             "imagenet": lambda m: m.load_imagenet(image_size=24, nb_classes=10, limit_train=6, limit_test=3)}
    for name, load in loads.items():
        monkeypatch.setenv("AGGREGATHOR_DATA", str(tmp_path / "jax"))
        want = load(jdatasets)
        monkeypatch.setenv("AGGREGATHOR_DATA", str(tmp_path / "port"))
        got = load(tdatasets)
        _same(got, want)
        assert got.x_train.shape[1:] == ((32, 32, 3) if name == "cifar10" else (24, 24, 3))
    # each cached its decode under JAX's names; the port reads the cache next
    for package in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / package / "imagenet"))[0] == "imagenet24-t6-v3.npz"
        assert "cifar10.npz" in os.listdir(tmp_path / package / "cifar10")
    os.remove(tmp_path / "port" / "cifar10" / "cifar10_train.tfrecord")  # the cache alone now
    _same(tdatasets.load_cifar10(), jdatasets.load_cifar10())


def test_a_machine_without_pil_refuses_by_name(tmp_path, monkeypatch):
    images, labels = _images(2, 8, 4)
    tfrecord.write_cifar10_split(str(tmp_path), "train", images, labels)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(UserException, match="Pillow"):
        tfrecord.read_cifar10_split(str(tmp_path), "train")
