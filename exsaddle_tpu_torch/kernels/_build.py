"""Build and load the port's CUDA kernels.

Every `*.cu` file under exsaddle_tpu_torch/csrc/ is compiled by nvcc into ONE
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ctypes. The library is built at first use into
exsaddle_tpu_torch/_build/ (listed in .gitignore) under a name that carries
the hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs at import time: the CPU tests
import every module of the port on machines without nvcc.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# sm_90a keeps wgmma/setmaxnreg available to later kernels; -Xptxas -v
# records registers, shared memory and spills of every kernel in build.log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "exsaddle_tpu_torch need the CUDA toolkit")
    return path


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs, hdrs


def library_path():
    """Path of the library the current sources and flags build to."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs + hdrs:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"libexsaddle_kernels-{h.hexdigest()[:16]}.so")


def build():
    """Compile the kernels if the library for the current sources is
    missing. Returns (path, built_now, log)."""
    out = library_path()
    log_path = out[:-3] + ".log"
    if os.path.exists(out):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return out, False, log
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs, _ = _sources()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + srcs
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(log_path, "w") as fh:
        fh.write(log)
    os.replace(tmp, out)
    return out, True, log


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            _lib = ctypes.CDLL(path)
        return _lib
