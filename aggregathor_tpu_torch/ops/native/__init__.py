"""The host C++ library (GARs and HMAC), built at first use and loaded with ctypes.

The port's copy of ``aggregathor_tpu/ops/native`` without its TFRecord
reader: the sources ``kernels.cpp``, ``auth.cpp`` and ``threadpool.hpp``
in this directory (copies of the JAX package's) compile, the two units in
one run of ``c++ -std=c++17 -O3 -fPIC -shared -pthread``, into
``.build-<hash>/libagg_host.so`` here, the hash covering the sources and
the flags (``.gitignore`` lists ``.build-*``), so an edited source rebuilds
and an unchanged one loads at once.  The JAX package's library is never
loaded.  ``AGTPU_NATIVE_CXX`` names another compiler.

The ``*-native`` rules (``gars/native_host.py``) call :func:`load` at
construction: a missing compiler is their UserException.  This is host
code, not a TPU kernel's port: it is the reference's host tier.

Public API (numpy arrays in and out, float32 or float64, row-major):
``average(g)  average_nan(g)  median(g)  averaged_median(g, f)
pairwise_sq_distances(g)  krum(g, f, m=None)  bulyan(g, f)``, and
``num_threads()``, ``load()``, ``library_path()``.  ``AGTPU_NUM_THREADS``
bounds the pool.  The host authentication of ``parallel/auth.py``
(``auth.cpp``, SHA-256 and HMAC-SHA256 after RFC 6234/2104): ``sha256(data)``,
``hmac_sha256(key, data)`` and ``hmac_verify(key, data, tag)`` on bytes or
uint8 arrays.  The TFRecord reader (``io.cpp``) of the JAX library is not
ported.
"""

import ctypes
import os
import shutil
import threading

import numpy as np

from .. import build

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("kernels.cpp", "auth.cpp", "threadpool.hpp")
#: the units compiled into the one library
COMPILE_UNITS = ("kernels.cpp", "auth.cpp")
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None


def _compiler():
    compiler = os.environ.get("AGTPU_NATIVE_CXX", "c++")
    path = shutil.which(compiler)
    if path is None:
        raise RuntimeError("no C++ compiler %r on this machine" % compiler)
    return path


def library_path():
    """Where the current sources and flags build to."""
    return os.path.join(build.hashed_dir(_DIR, CXX_FLAGS, [os.path.join(_DIR, name) for name in SOURCES]),
                        "libagg_host.so")


def _build(target):
    compiler = _compiler()
    code, _, err = build.start_build(compiler, CXX_FLAGS, [os.path.join(_DIR, name) for name in COMPILE_UNITS],
                                     target)()
    if code != 0:
        raise RuntimeError("native build failed (%s %s):\n%s" % (compiler, " ".join(CXX_FLAGS), err.strip()))


def _declare(lib):
    i64 = ctypes.c_int64
    lib.agtpu_num_threads.restype = i64
    lib.agtpu_num_threads.argtypes = []
    for suffix, ctype in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        ptr = ctypes.POINTER(ctype)
        for name, extra in (("average", ()), ("average_nan", ()), ("median", ()),
                            ("averaged_median", (i64,)), ("krum", (i64, i64)), ("bulyan", (i64,))):
            fn = getattr(lib, "agtpu_%s_%s" % (name, suffix))
            fn.restype = None
            fn.argtypes = [ptr, i64, i64, *extra, ptr]
        fn = getattr(lib, "agtpu_pairwise_sqdist_%s" % suffix)
        fn.restype = None
        fn.argtypes = [ptr, i64, i64, ctypes.POINTER(ctypes.c_double)]
    u8p, size = ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t
    lib.agtpu_sha256.restype = None
    lib.agtpu_sha256.argtypes = [u8p, size, u8p]
    lib.agtpu_hmac_sha256.restype = None
    lib.agtpu_hmac_sha256.argtypes = [u8p, size, u8p, size, u8p]
    lib.agtpu_hmac_verify.restype = ctypes.c_int
    lib.agtpu_hmac_verify.argtypes = [u8p, size, u8p, size, u8p]


def load():
    """Build (once, if the sources changed) and load the library; raises
    RuntimeError when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not os.path.exists(target):
                _build(target)
            lib = ctypes.CDLL(target)
            _declare(lib)
            _lib = lib
        return _lib


def num_threads():
    return int(load().agtpu_num_threads())


def _prepare(grads):
    """A contiguous 2-D float32/float64 array and its (suffix, ctype)."""
    g = np.asarray(grads)
    if g.ndim != 2:
        raise ValueError("expected an (n, d) gradient matrix, got shape %r" % (g.shape,))
    if g.dtype == np.float32:
        return np.ascontiguousarray(g), "f32", ctypes.c_float
    return np.ascontiguousarray(g, dtype=np.float64), "f64", ctypes.c_double


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _rowwise(name, grads, *extra):
    lib = load()
    g, suffix, ctype = _prepare(grads)
    n, d = g.shape
    out = np.empty(d, dtype=g.dtype)
    getattr(lib, "agtpu_%s_%s" % (name, suffix))(
        _ptr(g, ctype), n, d, *[ctypes.c_int64(int(e)) for e in extra], _ptr(out, ctype))
    return out


def average(grads):
    return _rowwise("average", grads)


def average_nan(grads):
    return _rowwise("average_nan", grads)


def median(grads):
    return _rowwise("median", grads)


def averaged_median(grads, f):
    return _rowwise("averaged_median", grads, f)


def krum(grads, f, m=None):
    n = np.asarray(grads).shape[0]
    if m is None:
        m = n - int(f) - 2
    if not 1 <= int(m) <= n:
        raise ValueError("krum selection size m=%d out of range [1, n=%d] (f=%d)" % (m, n, f))
    return _rowwise("krum", grads, f, m)


def bulyan(grads, f):
    return _rowwise("bulyan", grads, f)


def pairwise_sq_distances(grads):
    """(n, n) float64 all-pairs squared distances (non-finite -> +inf)."""
    lib = load()
    g, suffix, ctype = _prepare(grads)
    n, d = g.shape
    out = np.empty((n, n), dtype=np.float64)
    getattr(lib, "agtpu_pairwise_sqdist_%s" % suffix)(_ptr(g, ctype), n, d, _ptr(out, ctypes.c_double))
    return out


# --------------------------------------------------------------------------- #
# host authentication (auth.cpp; parallel/auth.py is the policy layer)

def _u8(buf):
    arr = buf if isinstance(buf, np.ndarray) else np.frombuffer(bytes(buf), dtype=np.uint8)
    arr = np.ascontiguousarray(arr, dtype=np.uint8).ravel()
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size


def sha256(data):
    """The 32-byte SHA-256 digest of ``data`` (bytes or a uint8 array)."""
    lib = load()
    _, dptr, dlen = _u8(data)
    out = np.empty(32, dtype=np.uint8)
    lib.agtpu_sha256(dptr, dlen, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.tobytes()


def hmac_sha256(key, data):
    """The 32-byte HMAC-SHA256 tag of ``data`` under ``key``."""
    lib = load()
    _, kptr, klen = _u8(key)
    _, dptr, dlen = _u8(data)
    out = np.empty(32, dtype=np.uint8)
    lib.agtpu_hmac_sha256(kptr, klen, dptr, dlen, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.tobytes()


def hmac_verify(key, data, tag):
    """Constant-time check of a 32-byte tag (a tag of another length is False)."""
    if len(tag) != 32:
        return False
    lib = load()
    _, kptr, klen = _u8(key)
    _, dptr, dlen = _u8(data)
    _, tptr, _ = _u8(tag)
    return bool(lib.agtpu_hmac_verify(kptr, klen, dptr, dlen, tptr))
