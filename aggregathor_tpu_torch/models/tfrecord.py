"""Minimal TFRecord + tf.Example codec for the reference's CIFAR-10 layout.

The reference reads CIFAR-10 from TF-Slim TFRecord shards on local disk
(reference: experiments/cnnet.py:115-146, expecting the layout written by
slim's ``download_and_convert_cifar10.py``: ``cifar10_train.tfrecord`` /
``cifar10_test.tfrecord``, each record a ``tf.Example`` with PNG-encoded
``image/encoded``, ``image/format`` and ``image/class/label`` features).
This module reads — and, for fixtures/conversion, writes — that exact
on-disk format without TensorFlow:

- TFRecord framing: ``uint64 length | masked crc32c(length) | payload |
  masked crc32c(payload)`` with the Castagnoli CRC and TF's rotation mask.
- tf.Example: a hand-rolled protobuf wire-format walker for the fixed
  3-level shape Example > Features(map<string, Feature>) >
  bytes_list/float_list/int64_list.  No generated code, no proto dep.
- PNG and JPEG: PIL, imported where an image is decoded or encoded; a
  machine without PIL reads no shard (a UserException names the package).

The port's copy of ``aggregathor_tpu/models/tfrecord.py`` (which imports no
JAX), reading through the port's ``ops/native`` scanner;
``datasets.load_cifar10`` and ``datasets.load_imagenet`` read the shards
and cache them as the npz files the loaders prefer.
"""

import os
import struct

import numpy as np

from ..utils import UserException

def _pil_image():
    """PIL's ``Image`` module, imported at first use."""
    try:
        from PIL import Image
    except ImportError:
        raise UserException("Reading or writing TFRecord images needs the Pillow package (PIL), which is not "
                            "installed")
    return Image


# ---------------------------------------------------------------- crc32c --

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            _CRC_TABLE.append(crc)
    return _CRC_TABLE


def crc32c(data):
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------- TFRecord framing --


def iter_tfrecords(path):
    """Yield the payload bytes of every record in a TFRecord file.

    Uses the native scanner when the C++ library is available (slice-by-8
    CRC32C + parallel payload verification over a memory-mapped shard,
    ops/native/io.cpp — the counterpart of the reference's multi-threaded
    fetchers); otherwise the pure-Python walker below.
    """
    from ..ops import native

    use_native = False
    try:
        use_native = native.available()
    except Exception:
        pass
    if use_native:
        import mmap

        with open(path, "rb") as fd:
            if os.fstat(fd.fileno()).st_size == 0:
                return
            buf = mmap.mmap(fd.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            # Lifetime care: every numpy view over the mmap must be dropped
            # before close() or it raises BufferError — including views
            # pinned by exception tracebacks, so the ValueError is fully
            # handled (its frames released) before a fresh error is raised.
            view = np.frombuffer(buf, dtype=np.uint8)
            error = None
            try:
                offsets, lengths = native.tfrecord_index(view)
            except ValueError as exc:
                error = "%s in %r" % (exc, path)
            finally:
                del view
            if error is not None:
                raise UserException(error)
            for offset, length in zip(offsets, lengths):
                yield bytes(buf[offset:offset + length])
        finally:
            buf.close()
        return
    with open(path, "rb") as fd:
        while True:
            header = fd.read(12)
            if not header:
                return
            if len(header) != 12:
                raise UserException("Truncated TFRecord header in %r" % path)
            (length,), (length_crc,) = struct.unpack("<Q", header[:8]), struct.unpack("<I", header[8:])
            if _masked_crc(header[:8]) != length_crc:
                raise UserException("Corrupt TFRecord length CRC in %r" % path)
            payload = fd.read(length)
            (payload_crc,) = struct.unpack("<I", fd.read(4))
            if len(payload) != length or _masked_crc(payload) != payload_crc:
                raise UserException("Corrupt TFRecord payload in %r" % path)
            yield payload


def write_tfrecords(path, payloads):
    """Write an iterable of payload bytes as a TFRecord file."""
    with open(path, "wb") as fd:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            fd.write(header)
            fd.write(struct.pack("<I", _masked_crc(header)))
            fd.write(payload)
            fd.write(struct.pack("<I", _masked_crc(payload)))


# ------------------------------------------------- protobuf wire walking --


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _write_varint(value):
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _iter_fields(buf):
    """Yield (field_number, wire_type, value) over a protobuf message.

    Length-delimited fields (wire type 2) yield their raw bytes; varints
    (type 0) the int; 64/32-bit (types 1/5) the raw 8/4 bytes.
    """
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + length], pos + length
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise UserException("Unsupported protobuf wire type %d" % wire)
        yield field, wire, value


def parse_example(buf):
    """Parse a serialized tf.Example into {name: list-of-values}.

    bytes_list values come back as ``bytes``, int64_list as ``int``,
    float_list as ``float``.
    """
    features = {}
    for field, _, value in _iter_fields(buf):  # Example
        if field != 1:  # Example.features
            continue
        for ffield, _, entry in _iter_fields(value):  # Features
            if ffield != 1:  # Features.feature (map entry)
                continue
            name, feature = None, b""
            for mfield, _, mvalue in _iter_fields(entry):  # MapEntry
                if mfield == 1:
                    name = mvalue.decode("utf-8")
                elif mfield == 2:
                    feature = mvalue
            values = []
            for kfield, _, kvalue in _iter_fields(feature):  # Feature oneof
                for _, wire, item in _iter_fields(kvalue):
                    if kfield == 1:  # BytesList
                        values.append(item)
                    elif kfield == 2:  # FloatList (packed or not)
                        if wire == 2:
                            values.extend(struct.unpack("<%df" % (len(item) // 4), item))
                        else:
                            values.append(struct.unpack("<f", item)[0])
                    elif kfield == 3:  # Int64List (packed or not)
                        if wire == 2:
                            pos = 0
                            while pos < len(item):
                                v, pos = _read_varint(item, pos)
                                values.append(v)
                        else:
                            values.append(item)
            if name is not None:
                features[name] = values
    return features


def _delimited(field, payload):
    return _write_varint(field << 3 | 2) + _write_varint(len(payload)) + payload


def build_example(features):
    """Serialize {name: bytes | int | list-of-ints} as a tf.Example."""
    entries = b""
    for name, value in sorted(features.items()):
        if isinstance(value, bytes):
            feature = _delimited(1, _delimited(1, value))  # BytesList
        else:
            items = value if isinstance(value, (list, tuple)) else [value]
            packed = b"".join(_write_varint(int(v)) for v in items)
            feature = _delimited(3, _delimited(1, packed))  # Int64List (packed)
        entry = _delimited(1, name.encode("utf-8")) + _delimited(2, feature)
        entries += _delimited(1, entry)
    return _delimited(1, entries)  # Example.features


# ----------------------------------------------------------- PNG via PIL --


def png_decode(data):
    """PNG bytes -> (h, w, 3) uint8 array."""
    import io

    Image = _pil_image()

    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def png_encode(array):
    """(h, w, 3) uint8 array -> PNG bytes."""
    import io

    Image = _pil_image()

    out = io.BytesIO()
    Image.fromarray(np.asarray(array, dtype=np.uint8)).save(out, format="PNG")
    return out.getvalue()


# ------------------------------------------------------- CIFAR-10 layout --

#: shard names written by slim's download_and_convert_cifar10.py
CIFAR10_SHARDS = {"train": "cifar10_train.tfrecord", "test": "cifar10_test.tfrecord"}


def read_cifar10_split(directory, split):
    """Read one slim CIFAR-10 shard -> (images uint8 (n, 32, 32, 3), labels int32)."""
    path = os.path.join(directory, CIFAR10_SHARDS[split])
    images, labels = [], []
    for payload in iter_tfrecords(path):
        example = parse_example(payload)
        encoded = example["image/encoded"][0]
        fmt = example.get("image/format", [b"png"])[0]
        if fmt not in (b"png", b"PNG"):
            raise UserException("Expected png-encoded CIFAR-10, got %r" % fmt)
        images.append(png_decode(encoded))
        labels.append(int(example["image/class/label"][0]))
    return np.stack(images), np.asarray(labels, dtype=np.int32)


def write_cifar10_split(directory, split, images, labels):
    """Write images/labels in the exact slim shard layout (fixtures, tests)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CIFAR10_SHARDS[split])

    def payloads():
        for image, label in zip(images, labels):
            yield build_example({
                "image/encoded": png_encode(image),
                "image/format": b"png",
                "image/class/label": int(label),
                "image/height": int(image.shape[0]),
                "image/width": int(image.shape[1]),
            })

    write_tfrecords(path, payloads())
    return path


def has_cifar10_tfrecords(directory):
    return all(
        os.path.isfile(os.path.join(directory, name)) for name in CIFAR10_SHARDS.values()
    )


# ------------------------------------------------------- ImageNet layout --
#
# The reference trains slims models on TFRecord ImageNet built by slim's
# build_imagenet_data.py (experiments/slims.py:98-111): sharded files named
# ``train-00000-of-01024`` / ``validation-00000-of-00128`` (no extension),
# each example carrying a JPEG under ``image/encoded`` and a 1-based label
# (0 = background, hence the reference's ``--labels-offset`` knob) under
# ``image/class/label``.  Decode is PIL (TF-free), like the PNG codec above.

import re as _re

_IMAGENET_SHARD = {"train": _re.compile(r"^train-\d{5}-of-\d{5}$"),
                   "validation": _re.compile(r"^validation-\d{5}-of-\d{5}$")}


def jpeg_decode(data, image_size=None):
    """JPEG bytes -> (h, w, 3) uint8; optionally resized to a square."""
    import io

    Image = _pil_image()

    with Image.open(io.BytesIO(data)) as img:
        img = img.convert("RGB")
        if image_size is not None and img.size != (image_size, image_size):
            img = img.resize((image_size, image_size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


def jpeg_encode(array, quality=90):
    """(h, w, 3) uint8 -> JPEG bytes (fixture writer)."""
    import io

    Image = _pil_image()

    out = io.BytesIO()
    Image.fromarray(np.asarray(array, dtype=np.uint8)).save(out, format="JPEG", quality=quality)
    return out.getvalue()


def imagenet_shards(directory, split):
    """Sorted shard paths of one split under the slim naming convention."""
    pattern = _IMAGENET_SHARD[split]
    try:
        names = sorted(n for n in os.listdir(directory) if pattern.match(n))
    except OSError:
        return []
    return [os.path.join(directory, n) for n in names]


def has_imagenet_tfrecords(directory):
    return bool(imagenet_shards(directory, "train")) and bool(
        imagenet_shards(directory, "validation")
    )


def read_imagenet_split(directory, split, image_size, limit=None):
    """Stream slim ImageNet shards -> (uint8 (n, s, s, 3), int32 labels).

    ``limit`` caps the example count (full ImageNet does not fit host RAM as
    a dense array; the capped subset is REAL data — decoded, resized — and
    the loader states the cap).  Shards are consumed in name order so the
    subset is deterministic."""
    images, labels = [], []
    for path in imagenet_shards(directory, split):
        for payload in iter_tfrecords(path):
            example = parse_example(payload)
            fmt = example.get("image/format", [b"JPEG"])[0]
            encoded = example["image/encoded"][0]
            if fmt in (b"png", b"PNG"):
                image = png_decode(encoded)
                if image.shape[:2] != (image_size, image_size):
                    image = jpeg_decode(png_encode(image), image_size)  # resize path
            else:
                image = jpeg_decode(encoded, image_size)
            images.append(image)
            labels.append(int(example["image/class/label"][0]))
            if limit is not None and len(images) >= limit:
                return np.stack(images), np.asarray(labels, dtype=np.int32)
    if not images:
        raise UserException(
            "No %s examples under %r (expected slim-layout shards like "
            "train-00000-of-01024)" % (split, directory)
        )
    return np.stack(images), np.asarray(labels, dtype=np.int32)


def write_imagenet_split(directory, split, images, labels, nb_shards=2):
    """Write slim-layout ImageNet shards (fixtures, tests)."""
    os.makedirs(directory, exist_ok=True)
    chunks = np.array_split(np.arange(len(images)), nb_shards)
    paths = []
    for shard_index, chunk in enumerate(chunks):
        path = os.path.join(
            directory, "%s-%05d-of-%05d" % (split, shard_index, nb_shards)
        )

        def payloads(chunk=chunk):
            for i in chunk:
                yield build_example({
                    "image/encoded": jpeg_encode(images[i]),
                    "image/format": b"JPEG",
                    "image/class/label": int(labels[i]),
                    "image/height": int(images[i].shape[0]),
                    "image/width": int(images[i].shape[1]),
                })

        write_tfrecords(path, payloads())
        paths.append(path)
    return paths
