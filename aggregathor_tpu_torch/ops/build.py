"""Build and load the CUDA kernels of ``ops/csrc`` at first use.

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface (no PyTorch headers: a build takes seconds, not minutes), loaded
with ``ctypes``.  All sources build in parallel, one ``nvcc`` process each.
The libraries land in ``ops/.build-<hash>/``, keyed by the bytes of every
file in ``ops/csrc`` (sources and headers) and the compiler flags, so an
edited source rebuilds and an unchanged one loads at once; ``.gitignore`` lists the directory.

The host C++ tier (``ops/native``) builds with the same two helpers,
``hashed_dir`` and ``start_build``.

A failed build raises with nvcc's stderr.  Nothing falls back to the plain
PyTorch versions: on a CUDA tensor the kernel runs or the call raises.

Every compiler run that ``start_build`` starts is a miss of this build
cache: ``BUILD_STATS`` counts the finished builds and their wall time, and
each one is handed to the functions of ``add_build_listener`` (the
``compile_*`` families of ``obs/profiler.py``) with its source, its build
directory's hash, its seconds and its exit code.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

#: the sources, each built into lib<name>.so
SOURCES = ("distances", "gram", "coordinate")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries = {}

#: compiler runs of this process: the finished ones and their wall seconds
BUILD_STATS = {"builds": 0, "seconds": 0.0}
_listeners = []
_stats_lock = threading.Lock()


def add_build_listener(fn):
    """Call ``fn(source, digest, seconds, code)`` after every compiler run
    (``source`` the path relative to the package, ``digest`` the hash of
    its build directory); a function added twice is called once."""
    with _stats_lock:
        if fn not in _listeners:
            _listeners.append(fn)


def remove_build_listener(fn):
    with _stats_lock:
        if fn in _listeners:
            _listeners.remove(fn)


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")
    return path


def hashed_dir(parent, flags, paths):
    """``parent/.build-<hash>``, the hash covering the flags and each file's
    name and bytes: an edited file or flag builds into a new directory."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        with open(path, "rb") as fd:
            digest.update(os.path.basename(path).encode() + b"\0" + fd.read())
    return os.path.join(parent, ".build-" + digest.hexdigest()[:16])


def start_build(compiler, flags, source, target):
    """Start ``compiler flags -o <tmp> source`` for the shared library
    ``target``; returns ``wait()``, which waits for the compiler and, when
    it succeeded, moves the library into place (atomic: a reader never sees
    half a library).  ``wait()`` returns (exit code, stdout, stderr)."""
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = "%s.%d.tmp" % (target, os.getpid())
    begin = time.perf_counter()
    proc = subprocess.Popen([compiler, *flags, "-o", tmp, source], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        out, err = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)
        seconds = time.perf_counter() - begin
        package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        name = os.path.relpath(os.path.abspath(source), os.path.dirname(package))
        digest = os.path.basename(os.path.dirname(target)).replace(".build-", "")
        with _stats_lock:
            if proc.returncode == 0:
                BUILD_STATS["builds"] += 1
                BUILD_STATS["seconds"] += seconds
            listeners = list(_listeners)
        for listener in listeners:
            listener(name, digest, seconds, proc.returncode)
        return proc.returncode, out, err

    return wait


def build_dir():
    """The directory the current sources, their headers and the flags build into."""
    return hashed_dir(os.path.dirname(CSRC), NVCC_FLAGS,
                      [os.path.join(CSRC, name) for name in sorted(os.listdir(CSRC))])


def _library_path(name):
    return os.path.join(build_dir(), "lib%s.so" % name)


def build_all():
    """Compile every source not yet built, all ``nvcc`` runs started together.

    Returns {name: ptxas report (stderr of the build)} for the sources built
    now.  Raises RuntimeError carrying nvcc's stderr when a build fails."""
    target = build_dir()
    pending = {name: start_build(_nvcc(), NVCC_FLAGS, os.path.join(CSRC, name + ".cu"), _library_path(name))
               for name in SOURCES if not os.path.exists(_library_path(name))}
    reports, failures = {}, []
    for name, wait in pending.items():
        code, out, err = wait()
        if code != 0:
            failures.append("nvcc failed on %s.cu (exit %d):\n%s%s" % (name, code, out, err))
            continue
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
        # n, d, the card's SMs -> the grid's blocks (the scratch's rows)
        "agg_pairwise_sq_distances_blocks": (_I, _LL, _I),
        # x, out, scratch, counter, n, d, the card's SMs, stream
        "agg_pairwise_sq_distances": (_P, _P, _P, _P, _I, _LL, _I, _P),
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
        # x, centre (None: a zero centre), out, scratch, n, d, chunk, stream
        "agg_gram_sq_distances": (_P, _P, _P, _P, _I, _LL, _I, _P),
    },
}


def _declare(name, lib):
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
