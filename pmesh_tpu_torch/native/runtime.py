"""ctypes bindings to the port's C++ host runtime (``native/src``).

The library holds the two host-side parts of the package: the
Gadget/N-GenIC white noise (ranlxd1 and the seed-table scheme,
OpenMP-parallel over columns) and the scale-invariant inside-out mode
index.  Its sources are this package's own copy of the JAX package's
C++ runtime, so the two produce the same bits.

The library is compiled with g++ at first use into the git-ignored
``_build/`` directory of the package, and loaded with ctypes.  Its name
carries a hash of the sources and flags, so an edited source is
rebuilt.  A failed build raises with g++'s output.

Importing this module needs no compiler.
"""
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["build", "whitenoise_fill", "ranlxd", "invariant_index",
           "SRC", "CXX_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SOURCES = ["ranlxd.cc", "whitenoise.cc", "invariant.cc"]
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _lib_path():
    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for name in _SOURCES + ["ranlxd.h"]:
        with open(os.path.join(SRC, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(_BUILD_DIR, "librt-%s.so" % digest.hexdigest()[:16])


def build():
    """Compile the runtime with g++; returns the library's path."""
    path = _lib_path()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp%d.so" % (path[:-len(".so")], os.getpid())
    proc = subprocess.run(["g++"] + CXX_FLAGS + ["-o", tmp]
                          + [os.path.join(SRC, s) for s in _SOURCES],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("g++ failed (exit %d) building the host "
                           "runtime:\n%s%s" % (proc.returncode, proc.stdout,
                                               proc.stderr))
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.exists(path):
            build()
        lib = ctypes.CDLL(path)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.pmesh_rt_whitenoise_fill.argtypes = [
            i64p, i64p, i64p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.pmesh_rt_ranlxd_fill.argtypes = [
            ctypes.c_uint32, ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
        lib.pmesh_rt_invariant_index.argtypes = [
            ctypes.c_int, ctypes.c_int64, i64p, i64p, ctypes.c_int,
            ctypes.c_int64, i64p]
        _lib = lib
        return lib


def _i64(arr):
    a = np.ascontiguousarray(arr, dtype=np.int64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def whitenoise_fill(Nmesh, shape, start, seed, unitary, dtype='complex128'):
    """The (start, shape) block of the global hermitian mode cube of a
    3-d mesh, filled with Gadget-compatible white noise: a numpy complex
    array of ``dtype`` (complex64 or complex128)."""
    lib = _load()
    if len(Nmesh) != 3:
        raise ValueError("the gadget generator is 3-d only")
    is_f32 = np.dtype(dtype) == np.dtype('complex64')
    out = np.zeros(tuple(int(n) for n in shape), dtype=np.dtype(dtype))
    _, Np = _i64(Nmesh)
    _, sp = _i64(start)
    _, zp = _i64(shape)
    lib.pmesh_rt_whitenoise_fill(Np, sp, zp, int(seed) & 0xFFFFFFFF,
                                 int(bool(unitary)), int(is_f32),
                                 out.ctypes.data)
    return out


def ranlxd(seed, n):
    """n doubles from a ranlxd1 stream."""
    lib = _load()
    out = np.zeros(n, dtype='f8')
    lib.pmesh_rt_ranlxd_fill(seed, n, out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_double)))
    return out


def invariant_index(x, Nmesh, compressed=True, maxlength=None):
    """Scale-invariant inside-out index of integer mode vectors ``x``
    (..., d); -1 where out of range (see ``invariant.get_index``)."""
    lib = _load()
    x = np.asarray(x)
    ndim = x.shape[-1]
    xf, xp = _i64(x.reshape(-1, ndim))
    _, Np = _i64(np.broadcast_to(np.asarray(Nmesh), (ndim,)))
    out = np.zeros(xf.shape[0], dtype=np.int64)
    lib.pmesh_rt_invariant_index(
        ndim, xf.shape[0], xp, Np, int(bool(compressed)),
        -1 if maxlength is None else int(maxlength),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out.reshape(x.shape[:-1])
