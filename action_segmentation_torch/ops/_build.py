"""Build and bind the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``. The library lands in the
package's ``build/`` directory under a name keyed on a hash of the
source, every shared header (``csrc/*.cuh``) and the compiler flags, so
the first use after a change to any of them rebuilds it and later uses
load it. The host C++ sources (``csrc/<name>.cpp``, the edit distance)
build the same way with ``g++`` (``load_host_library``). A library is
written to a temporary file and renamed into place, so processes that
build it at once never load half a file. Nothing builds at import time.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
            "needed to build the kernels in {}".format(CSRC)
        )
    return path


def library_path(name):
    """Content-keyed path of the built library for csrc/<name>.cu: the
    key covers the source, every csrc/*.cuh header (by name and bytes,
    whether or not this source includes it) and the flags."""
    digest = hashlib.sha256((CSRC / "{}.cu".format(name)).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / "lib{}-{}.so".format(name, digest.hexdigest()[:16])


def _start(name):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (process or None, temporary output, final path)."""
    so = library_path(name)
    if so.exists():
        return None, None, so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name("{}.{}.tmp".format(so.name, os.getpid()))
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "{}.cu".format(name))]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, so


def build(names):
    """Build csrc/<name>.cu for every name, all nvcc processes at once.

    Returns {name: compiler log} ('-Xptxas -v' register, shared-memory
    and spill lines, kept beside each library). Raises if any build
    fails, after every started compiler has exited.
    """
    started = {name: _start(name) for name in names}
    logs, failed = {}, []
    for name, (proc, tmp, so) in started.items():
        if proc is None:
            log = so.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            continue
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append("{} (exit {}):\n{}".format(name, proc.returncode, out))
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)  # atomic: a concurrent reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.cache
def load_library(name):
    """The ctypes handle of csrc/<name>.cu, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def _gxx():
    found = shutil.which("g++")
    if not found:
        raise RuntimeError(
            "g++ not found on PATH; it builds the host library sources in {}".format(CSRC)
        )
    return found


def host_library_path(name):
    """Content-keyed path of the built library for csrc/<name>.cpp: the
    key covers the source and the flags."""
    digest = hashlib.sha256((CSRC / "{}.cpp".format(name)).read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD / "lib{}-{}.so".format(name, digest.hexdigest()[:16])


@functools.cache
def load_host_library(name):
    """The ctypes handle of csrc/<name>.cpp, built with g++ first if
    needed. Raises if the compiler is missing or the build fails."""
    so = host_library_path(name)
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name("{}.{}.tmp".format(so.name, os.getpid()))
        cmd = [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(CSRC / "{}.cpp".format(name))]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed for {} (exit {}):\n{}".format(
                name, proc.returncode, proc.stdout))
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
