"""Build and load the CUDA kernels of ``ops/csrc`` at first use.

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface (no PyTorch headers: a build takes seconds, not minutes), loaded
with ``ctypes``.  All sources build in parallel, one ``nvcc`` process each.
The libraries land in ``ops/.build-<hash>/``, keyed by the sources' bytes and
the compiler flags, so an edited source rebuilds and an unchanged one loads
at once; ``.gitignore`` lists the directory.

A failed build raises with nvcc's stderr.  Nothing falls back to the plain
PyTorch versions: on a CUDA tensor the kernel runs or the call raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

#: the sources, each built into lib<name>.so
SOURCES = ("distances", "gram", "coordinate")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")
    return path


def build_dir():
    """The directory the current sources and flags build into."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name + ".cu"), "rb") as fd:
            digest.update(name.encode() + b"\0" + fd.read())
    return os.path.join(os.path.dirname(CSRC), ".build-" + digest.hexdigest()[:16])


def _library_path(name):
    return os.path.join(build_dir(), "lib%s.so" % name)


def build_all():
    """Compile every source not yet built, all ``nvcc`` runs started together.

    Returns {name: ptxas report (stderr of the build)} for the sources built
    now.  Raises RuntimeError carrying nvcc's stderr when a build fails."""
    target = build_dir()
    os.makedirs(target, exist_ok=True)
    pending = {}
    for name in SOURCES:
        if os.path.exists(_library_path(name)):
            continue
        tmp = _library_path(name) + ".%d.tmp" % os.getpid()
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        pending[name] = (proc, tmp)
    reports, failures = {}, []
    for name, (proc, tmp) in pending.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append("nvcc failed on %s.cu (exit %d):\n%s%s" % (name, proc.returncode, out, err))
            continue
        os.replace(tmp, _library_path(name))  # atomic: a reader never sees half a library
        reports[name] = err
        with open(os.path.join(target, name + ".ptxas.txt"), "w") as fd:
            fd.write(err)
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def library(name):
    """The loaded ``ctypes`` library for source ``name``, built on first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            if not os.path.exists(_library_path(name)):
                build_all()
            lib = ctypes.CDLL(_library_path(name))
            _declare(name, lib)
            _libraries[name] = lib
        return lib


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: C signatures: every pointer and the stream as c_void_p, so ctypes never
#: narrows a 64-bit address to a 32-bit int
_SIGNATURES = {
    "distances": {
        "agg_pairwise_sq_distances": (_P, _P, _P, _I, _LL, _I, _P),
    },
    "coordinate": {
        # the rank entries end with the sort layout: rows, lanes, columns, stride
        "agg_coordinate_median": (_P, _P, _I, _LL, _I, _I, _I, _I, _P),
        "agg_coordinate_averaged_median": (_P, _P, _I, _LL, _I, _I, _I, _I, _I, _P),
        "agg_coordinate_trimmed_mean": (_P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _P),
        "agg_average_nan_columns": (_P, _P, _I, _LL, _P),
        "agg_nanmedian_columns": (_P, _P, _I, _LL, _I, _I, _I, _I, _P),
    },
    "gram": {
        "agg_gram_sq_distances": (_P, _P, _P, _I, _LL, _I, _P),
    },
}


def _declare(name, lib):
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
