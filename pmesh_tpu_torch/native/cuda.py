"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, into the
git-ignored ``_build/`` directory of the package, and loaded with
ctypes.  The library's name carries a hash of its source, the sources
it includes and the flags, so an edited source is rebuilt.  A failed
build raises with nvcc's output; nothing falls back to another
implementation.

Importing this module needs neither nvcc nor a GPU.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["find_nvcc", "build", "load", "CSRC", "BUILD_DIR", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}


def find_nvcc():
    """Path of nvcc: on PATH, else under $CUDA_HOME (default
    /usr/local/cuda)/bin; raises RuntimeError when there is none."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or in %s/bin: the CUDA kernels of "
        "pmesh_tpu_torch need the CUDA toolkit (set CUDA_HOME)"
        % cuda_home)


def _sources(src):
    """the bytes of ``src`` and of the sources of ``csrc/`` it includes
    by ``#include "name"``, recursively"""
    with open(src, "rb") as f:
        text = f.read()
    out = [text]
    for inc in re.findall(rb'^#include "([^"]+)"', text, re.M):
        out += _sources(os.path.join(os.path.dirname(src), inc.decode()))
    return out


def _lib_path(name):
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha1(b"".join(_sources(src))
                          + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, "lib%s-%s.so"
                             % (name, digest.hexdigest()[:16]))


def build(name):
    """Compile ``csrc/<name>.cu``; returns a dict with the library
    ``path``, the build ``seconds`` and nvcc's ``log`` (ptxas reports
    each kernel's registers and spills there)."""
    nvcc = find_nvcc()
    src, path = _lib_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp%d.so" % (path[:-len(".so")], os.getpid())
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc] + NVCC_FLAGS + ["-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("nvcc failed (exit %d) building %s:\n%s%s"
                           % (proc.returncode, src, proc.stdout,
                              proc.stderr))
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _, path = _lib_path(name)
            if not os.path.exists(path):
                build(name)
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]
